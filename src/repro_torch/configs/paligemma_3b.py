"""paligemma-3b [vlm] — SigLIP stub + gemma decoder (arXiv:2407.07726)."""
from repro_torch.configs import ArchSpec, SKIP_QUADRATIC
from repro_torch.models.transformer import LMConfig
from repro_torch.models.vlm import VLMConfig

LM = LMConfig(name="paligemma-3b-lm", n_layers=18, d_model=2048, n_heads=8,
              n_kv=1, d_ff=16384, vocab=257216, head_dim=256)
CFG = VLMConfig(name="paligemma-3b", lm=LM, n_patches=256, d_vision=1152)
SPEC = ArchSpec(name="paligemma-3b", family="vlm", cfg=CFG,
                skips={"long_500k": SKIP_QUADRATIC},
                source="arXiv:2407.07726")
