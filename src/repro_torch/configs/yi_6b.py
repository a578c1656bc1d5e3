"""yi-6b [dense] — llama-arch GQA kv=4 (arXiv:2403.04652)."""
from repro_torch.configs import ArchSpec, SKIP_QUADRATIC
from repro_torch.models.transformer import LMConfig

CFG = LMConfig(name="yi-6b", n_layers=32, d_model=4096, n_heads=32,
               n_kv=4, d_ff=11008, vocab=64000, rope_theta=5e6)
SPEC = ArchSpec(name="yi-6b", family="dense", cfg=CFG,
                skips={"long_500k": SKIP_QUADRATIC},
                source="arXiv:2403.04652")
