"""zamba2-7b-instruct [hybrid] — Zyphra's Zamba2-7B-Instruct, the
published block (``hybrid.Zamba2Config``), cut by depth to the first of
four pipeline stages: layers 0-23 of 81, whose hybrid layers 6, 11, 17 and
23 call shared blocks 0, 1, 0, 1 with adapters 0-3.  Every width is the
published one (hf:Zyphra/Zamba2-7B-Instruct, config.json)."""
from repro_torch.configs import ArchSpec
from repro_torch.models.hybrid import Zamba2Config

#: the published ``hybrid_layer_ids``; the stage keeps those below 24
PUBLISHED_HYBRID_LAYER_IDS = (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71,
                              77)
PUBLISHED_LAYERS = 81
STAGE_LAYERS = 24

CFG = Zamba2Config(
    name="zamba2-7b-instruct", n_layers=STAGE_LAYERS, d_model=3584,
    vocab=32000, n_heads=32, n_kv=32, head_dim=224, d_ff=14336,
    hybrid_layer_ids=tuple(i for i in PUBLISHED_HYBRID_LAYER_IDS
                           if i < STAGE_LAYERS),
    num_mem_blocks=2, adapter_rank=128, d_state=64, mamba_head_dim=64,
    n_groups=2, expand=2, conv_width=4, chunk=256, rope_theta=10000.0,
    norm_eps=1e-5, dt_min=0.001)
SPEC = ArchSpec(name="zamba2-7b-instruct", family="hybrid", cfg=CFG,
                source="hf:Zyphra/Zamba2-7B-Instruct")
