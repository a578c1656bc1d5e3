"""dbrx-132b [moe] — 16 experts top-4, fine-grained (databricks/dbrx)."""
from repro_torch.configs import ArchSpec, SKIP_QUADRATIC
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

MOE = MoEConfig(n_experts=16, top_k=4, d_model=6144, d_ff=10752,
                capacity_factor=1.25, dispatch="onehot")
CFG = LMConfig(name="dbrx-132b", n_layers=40, d_model=6144, n_heads=48,
               n_kv=8, d_ff=0, vocab=100352, moe=MOE)
SPEC = ArchSpec(name="dbrx-132b", family="moe", cfg=CFG,
                skips={"long_500k": SKIP_QUADRATIC},
                source="hf:databricks/dbrx-base")
