"""whisper-medium [audio] — enc-dec, conv frontend STUB (arXiv:2212.04356)."""
from repro_torch.configs import ArchSpec, SKIP_QUADRATIC
from repro_torch.models.encdec import EncDecConfig

CFG = EncDecConfig(name="whisper-medium", n_layers=24, d_model=1024,
                   n_heads=16, n_kv=16, d_ff=4096, vocab=51865,
                   enc_len=1500)
SPEC = ArchSpec(name="whisper-medium", family="audio", cfg=CFG,
                skips={"long_500k": SKIP_QUADRATIC},
                source="arXiv:2212.04356")
