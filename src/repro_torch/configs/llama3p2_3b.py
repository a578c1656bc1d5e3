"""llama3.2-3b [dense] — small llama3 (meta-llama/Llama-3.2-3B)."""
from repro_torch.configs import ArchSpec, SKIP_QUADRATIC
from repro_torch.models.transformer import LMConfig

CFG = LMConfig(name="llama3.2-3b", n_layers=28, d_model=3072, n_heads=24,
               n_kv=8, d_ff=8192, vocab=128256, rope_theta=5e5)
SPEC = ArchSpec(name="llama3.2-3b", family="dense", cfg=CFG,
                skips={"long_500k": SKIP_QUADRATIC},
                source="arXiv:2407.21783")
