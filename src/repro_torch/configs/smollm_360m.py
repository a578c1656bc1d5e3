"""smollm-360m [dense] — llama-arch small (hf:HuggingFaceTB/SmolLM)."""
from repro_torch.configs import ArchSpec, SKIP_QUADRATIC
from repro_torch.models.transformer import LMConfig

CFG = LMConfig(name="smollm-360m", n_layers=32, d_model=960, n_heads=15,
               n_kv=5, d_ff=2560, vocab=49152)
SPEC = ArchSpec(name="smollm-360m", family="dense", cfg=CFG,
                skips={"long_500k": SKIP_QUADRATIC},
                source="hf:HuggingFaceTB/SmolLM-360M")
