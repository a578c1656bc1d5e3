"""qwen3-0.6b [dense] — qk_norm, GQA, head_dim 128 (hf:Qwen/Qwen3)."""
from repro_torch.configs import ArchSpec, SKIP_QUADRATIC
from repro_torch.models.transformer import LMConfig

CFG = LMConfig(name="qwen3-0.6b", n_layers=28, d_model=1024, n_heads=16,
               n_kv=8, d_ff=3072, vocab=151936, head_dim=128,
               qk_norm=True, rope_theta=1e6)
SPEC = ArchSpec(name="qwen3-0.6b", family="dense", cfg=CFG,
                skips={"long_500k": SKIP_QUADRATIC},
                source="hf:Qwen/Qwen3-0.6B")
