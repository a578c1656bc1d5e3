"""Architecture registry of the port (a copy of ``repro.configs``).

Each module exposes ``SPEC: ArchSpec``.  ``get(name)`` returns it;
``reduced(spec)`` builds the same-family small config for CPU tests.
Every architecture of ``ARCH_IDS`` is ported: the dense decoders
qwen3-0.6b, smollm-360m (the training CLI's default architecture),
llama3.2-3b and yi-6b; the mixtures of experts dbrx-132b and kimi-k2
(moe); mamba2-130m (ssm); zamba2-1.2b (hybrid); whisper-medium (audio,
an encoder-decoder); paligemma-3b (vlm, a decoder behind an image
prefix); and flexgrip, the paper's overlay configuration (a
``MachineConfig``).  ``EXTRA`` are the port's own architectures, which
the JAX package does not have: zamba2-7b-instruct (hybrid, the published
Zamba2 block, cut to one pipeline stage).  ``get`` of any other name
raises ``KeyError``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

ARCH_IDS = (
    "mamba2_130m", "zamba2_1p2b", "smollm_360m", "qwen3_0p6b",
    "llama3p2_3b", "yi_6b", "paligemma_3b", "kimi_k2", "dbrx_132b",
    "whisper_medium", "flexgrip",
)
#: architectures of the port alone (not in ``ARCH_IDS``, which matches the
#: JAX package's)
EXTRA = ("zamba2_7b_instruct",)
#: the architectures whose modules the port has: all of them, and EXTRA
PORTED = ARCH_IDS + EXTRA

# assigned input shapes (LM family): name -> (seq_len, global_batch, kind)
SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str              # dense | moe | ssm | hybrid | vlm | audio | overlay
    cfg: object
    # shape-name -> None (runnable) or a skip reason string
    skips: Optional[Dict[str, str]] = None
    source: str = ""

    def skip_reason(self, shape: str) -> Optional[str]:
        return (self.skips or {}).get(shape)


_cache: Dict[str, ArchSpec] = {}


def get(name: str) -> ArchSpec:
    key = name.replace("-", "_").replace(".", "p")
    if key not in PORTED:
        raise KeyError(f"unknown architecture {name!r}")
    if key not in _cache:
        mod = importlib.import_module(f"repro_torch.configs.{key}")
        _cache[key] = mod.SPEC
    return _cache[key]


def all_archs():
    """Every language-model architecture's spec (``ARCH_IDS`` but the
    overlay's ``flexgrip``)."""
    return [get(a) for a in ARCH_IDS if a != "flexgrip"]


# Shared skip reasons
SKIP_QUADRATIC = ("pure full-attention arch: a 524k dense-attention decode "
                  "is O(S^2) prefill / O(S) per-step KV with no "
                  "sub-quadratic path; run for SSM/hybrid only "
                  "(DESIGN.md §5)")


def reduced(spec: ArchSpec) -> ArchSpec:
    """Same-family tiny config for CPU tests; a spec of a family without
    one (the overlay's ``flexgrip``) is returned unchanged."""
    from repro_torch.models.encdec import EncDecConfig
    from repro_torch.models.hybrid import HybridConfig, Zamba2Config
    from repro_torch.models.mamba2 import Mamba2Config
    from repro_torch.models.moe import MoEConfig
    from repro_torch.models.transformer import LMConfig
    from repro_torch.models.vlm import VLMConfig

    c = spec.cfg
    if spec.family in ("dense", "moe"):
        moe = None
        if c.moe is not None:
            moe = MoEConfig(n_experts=4, top_k=2, d_model=64, d_ff=96,
                            capacity_factor=c.moe.capacity_factor,
                            dispatch=c.moe.dispatch)
        small = LMConfig(name=c.name + "-smoke", n_layers=2, d_model=64,
                         n_heads=4, n_kv=max(1, c.n_kv * 4 // c.n_heads),
                         d_ff=128, vocab=256, head_dim=16,
                         qk_norm=c.qk_norm, moe=moe)
    elif spec.family == "ssm":
        small = Mamba2Config(name=c.name + "-smoke", n_layers=2,
                             d_model=64, vocab=256, d_state=16,
                             head_dim=16, chunk=8)
    elif isinstance(c, Zamba2Config):
        small = Zamba2Config(name=c.name + "-smoke", n_layers=6,
                             d_model=64, vocab=256, n_heads=4, n_kv=4,
                             head_dim=32, d_ff=96, hybrid_layer_ids=(2, 5),
                             adapter_rank=8, d_state=16, mamba_head_dim=16,
                             chunk=8)
    elif spec.family == "hybrid":
        small = HybridConfig(name=c.name + "-smoke", n_layers=4,
                             d_model=64, vocab=256, n_heads=4, n_kv=4,
                             d_ff=128, d_state=16, head_dim=16,
                             attn_every=2)
    elif spec.family == "audio":
        small = EncDecConfig(name=c.name + "-smoke", n_layers=2,
                             d_model=64, n_heads=4, n_kv=4, d_ff=128,
                             vocab=256, enc_len=32)
    elif spec.family == "vlm":
        lm = LMConfig(name=c.name + "-smoke-lm", n_layers=2, d_model=64,
                      n_heads=4, n_kv=1, d_ff=128, vocab=256, head_dim=16)
        small = VLMConfig(name=c.name + "-smoke", lm=lm, n_patches=8,
                          d_vision=48)
    else:
        return spec
    return dataclasses.replace(spec, cfg=small)
