"""Family-dispatched model API (port of ``repro.models.api``).

``init``, ``param_shapes``, ``apply_train``, ``decode_state`` and
``apply_decode`` for the dense, ssm (mamba2) and hybrid (zamba2)
families; the other families of the JAX package (moe, audio, vlm) raise
"not yet ported".  Decode state is the stacked KV caches (dense,
hybrid) and SSD + conv states (ssm, hybrid), written in place by each
step.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs import ArchSpec
from ..core.pipeline.state import resolve_device
from . import hybrid, layers as L, mamba2, transformer

#: the model module of each ported family
_MODELS = {"dense": transformer, "ssm": mamba2, "hybrid": hybrid}


def _model(spec: ArchSpec):
    if spec.family not in _MODELS:
        raise NotImplementedError(
            f"the {spec.family!r} family ({spec.name}) is not yet ported to "
            "repro_torch")
    return _MODELS[spec.family]


def init(gen: torch.Generator, spec: ArchSpec):
    """Random parameters on ``gen``'s device."""
    return _model(spec).init(gen, spec.cfg)


def param_shapes(spec: ArchSpec):
    """The parameter tree as tensors on the ``meta`` device: shapes and
    dtypes, no storage (the JAX package's ``eval_shape`` stand-ins)."""
    return _model(spec).init(torch.Generator(), spec.cfg, device="meta")


def apply_train(params, spec: ArchSpec, batch) -> torch.Tensor:
    """The token-mean loss of one batch ({"tokens", "labels"}, each (B, S)
    integer).  The ssm and hybrid families take the full logits and
    ``softmax_xent``, as the JAX package does."""
    model = _model(spec)
    tokens, labels = batch["tokens"], batch["labels"]
    if spec.family == "dense":
        return transformer.loss(params, spec.cfg, tokens, labels)
    return L.softmax_xent(model.forward(params, spec.cfg, tokens), labels)


def decode_state(spec: ArchSpec, batch: int, max_seq: int, *,
                 device="cuda"):
    """Zeroed decode state for ``serve_step``: dense {"kv": (k, v)}, each
    (L, B, max_seq, K, dh) bf16; ssm {"ssm": {"conv", "ssm"}}; hybrid
    {"ssm": ..., "kv": (k, v)} with the KV caches (n_apps, B, max_seq, K,
    dh)."""
    _model(spec)
    cfg, device = spec.cfg, resolve_device(device)
    if spec.family == "ssm":
        return {"ssm": mamba2.init_decode_state(cfg, batch, device=device)}
    if spec.family == "hybrid":
        m, kv = hybrid.init_decode_state(cfg, batch, max_seq, device=device)
        return {"ssm": m, "kv": kv}
    kd = (cfg.n_layers, batch, max_seq, cfg.n_kv, cfg.dh)
    return {"kv": (torch.zeros(kd, dtype=L.COMPUTE_DTYPE, device=device),
                   torch.zeros(kd, dtype=L.COMPUTE_DTYPE, device=device))}


def apply_decode(params, spec: ArchSpec, tokens, state,
                 cache_index: Optional[int]):
    """One serving step: tokens (B, S) -> (logits (B, S, V), new state).
    S = 1 decodes; S > 1 at ``cache_index`` 0 is the prefill.  The ssm
    family ignores ``cache_index``, as in the JAX package."""
    _model(spec)
    if spec.family == "ssm":
        logits, st = mamba2.forward(params, spec.cfg, tokens,
                                    states=state["ssm"])
        return logits, {"ssm": st}
    if spec.family == "hybrid":
        logits, st, kv = hybrid.forward(
            params, spec.cfg, tokens, states=state["ssm"],
            kv_caches=state["kv"], cache_index=cache_index)
        return logits, {"ssm": st, "kv": kv}
    logits, kv = transformer.forward(
        params, spec.cfg, tokens, kv_caches=state["kv"],
        cache_index=cache_index)
    return logits, {"kv": kv}
