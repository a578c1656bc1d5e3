"""PaliGemma-style VLM backbone (port of ``repro.models.vlm``): a SigLIP
patch-embedding STUB and a gemma decoder.

The vision frontend is a stub, as in the JAX package: the model takes
precomputed patch embeddings (B, P, d_vision), which a learned projection
``vision_proj`` maps into the LM's embedding space and prepends to the
token embeddings (``transformer.forward``'s ``prefix_embed``).  The JAX
docstring calls this "prefix-LM style", but its attention is causal over
the image prefix too, and so is the port's: one causal flash call a layer
over the P + S positions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import layers as L
from . import transformer as T
from .layers import _he


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    name: str
    lm: T.LMConfig
    n_patches: int = 256
    d_vision: int = 1152     # SigLIP-So400m width

    def param_count(self) -> int:
        return self.lm.param_count() + self.d_vision * self.lm.d_model

    def active_param_count(self) -> int:
        return self.param_count()


def init(gen: torch.Generator, cfg: VLMConfig, device=None):
    """``transformer.init`` of the LM and ``"vision_proj"`` (d_vision,
    d_model) bf16, on ``device`` (default: ``gen``'s; ``"meta"`` gives the
    shapes without storage)."""
    p = T.init(gen, cfg.lm, device=device)
    p["vision_proj"] = _he(gen, (cfg.d_vision, cfg.lm.d_model),
                           device=device)
    return p


def project(params, patches):
    """The image prefix: patches (B, P, d_vision) in the compute dtype,
    times ``vision_proj`` -> (B, P, d_model)."""
    return patches.to(L.COMPUTE_DTYPE) @ params["vision_proj"]


def forward(params, cfg: VLMConfig, tokens, patches: Optional[torch.Tensor],
            *, kv_caches=None, cache_index: Optional[int] = None,
            constrain=lambda t, *a: t):
    """tokens (B, S_text); patches (B, P, d_vision) stub embeddings, or
    None -> logits (B, P + S_text, V) fp32 (and the caches with
    ``kv_caches``).  The logits cover the image prefix's positions too, as
    in the JAX function.  Decode passes ``patches=None``: the prefix is
    already in the KV cache."""
    prefix = None if patches is None else project(params, patches)
    return T.forward(params, cfg.lm, tokens, constrain=constrain,
                     kv_caches=kv_caches, cache_index=cache_index,
                     prefix_embed=prefix)
