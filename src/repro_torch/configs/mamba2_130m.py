"""mamba2-130m [ssm] — SSD, attention-free (arXiv:2405.21060)."""
from repro_torch.configs import ArchSpec
from repro_torch.models.mamba2 import Mamba2Config

CFG = Mamba2Config(name="mamba2-130m", n_layers=24, d_model=768,
                   vocab=50280, d_state=128, head_dim=64, expand=2,
                   n_groups=1)
SPEC = ArchSpec(name="mamba2-130m", family="ssm", cfg=CFG,
                source="arXiv:2405.21060")
