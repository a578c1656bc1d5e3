"""zamba2-1.2b [hybrid] — Mamba2 + shared attention (arXiv:2411.15242)."""
from repro_torch.configs import ArchSpec
from repro_torch.models.hybrid import HybridConfig

CFG = HybridConfig(name="zamba2-1.2b", n_layers=38, d_model=2048,
                   vocab=32000, n_heads=32, n_kv=32, d_ff=8192,
                   d_state=64, attn_every=6)
SPEC = ArchSpec(name="zamba2-1.2b", family="hybrid", cfg=CFG,
                source="arXiv:2411.15242")
