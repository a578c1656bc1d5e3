"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8."""
from repro_torch.configs import ArchSpec, SKIP_QUADRATIC
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

MOE = MoEConfig(n_experts=384, top_k=8, d_model=7168, d_ff=2048,
                capacity_factor=1.25, dispatch="onehot")
CFG = LMConfig(name="kimi-k2-1t-a32b", n_layers=61, d_model=7168,
               n_heads=64, n_kv=8, d_ff=0, vocab=163840, head_dim=128,
               moe=MOE)
SPEC = ArchSpec(name="kimi-k2-1t-a32b", family="moe", cfg=CFG,
                skips={"long_500k": SKIP_QUADRATIC},
                source="arXiv:2501.kimi2 (paper-table)")
