"""Family-dispatched model API (port of ``repro.models.api``).

``init``, ``param_shapes``, ``apply_train``, ``decode_state`` and
``apply_decode`` for the dense family; the other families of the JAX
package raise "not yet ported".  Decode state is the stacked KV caches,
written in place by each step.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs import ArchSpec
from ..core.pipeline.state import resolve_device
from . import layers as L, transformer


def _dense(spec: ArchSpec):
    if spec.family != "dense":
        raise NotImplementedError(
            f"the {spec.family!r} family ({spec.name}) is not yet ported to "
            "repro_torch")
    return spec.cfg


def init(gen: torch.Generator, spec: ArchSpec):
    """Random parameters on ``gen``'s device (``transformer.init``)."""
    return transformer.init(gen, _dense(spec))


def param_shapes(spec: ArchSpec):
    """The parameter tree as tensors on the ``meta`` device: shapes and
    dtypes, no storage (the JAX package's ``eval_shape`` stand-ins)."""
    return transformer.init(torch.Generator(), _dense(spec), device="meta")


def apply_train(params, spec: ArchSpec, batch) -> torch.Tensor:
    """The token-mean loss of one batch ({"tokens", "labels"}, each (B, S)
    integer)."""
    return transformer.loss(params, _dense(spec), batch["tokens"],
                            batch["labels"])


def decode_state(spec: ArchSpec, batch: int, max_seq: int, *,
                 device="cuda"):
    """Zeroed decode state for ``serve_step``: {"kv": (k, v)}, each
    (L, B, max_seq, K, dh) bf16."""
    cfg = _dense(spec)
    device = resolve_device(device)
    kd = (cfg.n_layers, batch, max_seq, cfg.n_kv, cfg.dh)
    return {"kv": (torch.zeros(kd, dtype=L.COMPUTE_DTYPE, device=device),
                   torch.zeros(kd, dtype=L.COMPUTE_DTYPE, device=device))}


def apply_decode(params, spec: ArchSpec, tokens, state,
                 cache_index: Optional[int]):
    """One serving step: tokens (B, S) -> (logits (B, S, V), new state).
    S = 1 decodes; S > 1 at ``cache_index`` 0 is the prefill."""
    logits, kv = transformer.forward(
        params, _dense(spec), tokens, kv_caches=state["kv"],
        cache_index=cache_index)
    return logits, {"kv": kv}
