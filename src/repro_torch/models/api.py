"""Family-dispatched model API (port of ``repro.models.api``).

``init``, ``param_shapes``, ``apply_train``, ``decode_state``,
``apply_decode`` and ``input_specs`` for the dense and moe (``transformer``), ssm (mamba2),
hybrid (zamba2), audio (``encdec``, whisper) and vlm (``vlm``,
paligemma) families; an unknown family raises ``ValueError``, as in the
JAX package.  Decode state is the stacked KV caches (dense, moe, vlm,
hybrid, audio), SSD + conv states (ssm, hybrid), written in place by each
step, and the audio family's cross K/V, which a step returns unchanged.
``apply_train`` and ``apply_decode`` pass the JAX package's ``constrain``
hook into every model (the identity by default; a mesh's from
``launch.mesh.make_constrain``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs import SHAPES, ArchSpec
from ..core.pipeline.state import resolve_device
from . import encdec, hybrid, layers as L, mamba2, transformer, vlm

#: the model module of each ported family
_MODELS = {"dense": transformer, "moe": transformer, "ssm": mamba2,
           "hybrid": hybrid, "audio": encdec, "vlm": vlm}


def _model(spec: ArchSpec):
    if spec.family not in _MODELS:
        raise ValueError(spec.family)
    return _MODELS[spec.family]


def init(gen: torch.Generator, spec: ArchSpec):
    """Random parameters on ``gen``'s device."""
    return _model(spec).init(gen, spec.cfg)


def param_shapes(spec: ArchSpec):
    """The parameter tree as tensors on the ``meta`` device: shapes and
    dtypes, no storage (the JAX package's ``eval_shape`` stand-ins)."""
    return _model(spec).init(torch.Generator(), spec.cfg, device="meta")


def apply_train(params, spec: ArchSpec, batch,
                constrain=lambda t, *a: t) -> torch.Tensor:
    """The token-mean loss of one batch ({"tokens", "labels"}, each (B, S)
    integer; the audio family also ``"frames"``, (B, enc_len, D), and the
    vlm family ``"patches"``, (B, n_patches, d_vision), whose positions
    the loss drops).  The ssm, hybrid and audio families take the full
    logits and ``softmax_xent``, as the JAX package does."""
    model = _model(spec)
    tokens, labels = batch["tokens"], batch["labels"]
    if spec.family in ("dense", "moe"):
        return transformer.loss(params, spec.cfg, tokens, labels,
                                constrain=constrain)
    if spec.family == "vlm":
        return transformer.loss(
            params, spec.cfg.lm, tokens, labels, constrain=constrain,
            prefix_embed=vlm.project(params, batch["patches"]),
            prefix_drop=spec.cfg.n_patches)
    if spec.family == "audio":
        logits = encdec.forward(params, spec.cfg, batch["frames"], tokens,
                                constrain)
    else:
        logits = model.forward(params, spec.cfg, tokens, constrain=constrain)
    return L.softmax_xent(logits, labels)


def decode_state(spec: ArchSpec, batch: int, max_seq: int, *,
                 device="cuda"):
    """Zeroed decode state for ``serve_step``: dense and moe {"kv": (k,
    v)}, each (L, B, max_seq, K, dh) bf16; ssm {"ssm": {"conv", "ssm"}};
    hybrid {"ssm": ..., "kv": (k, v)} with the KV caches (n_apps, B,
    max_seq, K, dh); audio {"kv": ..., "cross": (k, v)} with the cross K/V
    each (L, B, enc_len, K, dh), zeroed too (serving decodes against it as
    the JAX CLI does; ``encdec.cross_kv`` gives the real one); vlm as
    dense, sized by its LM (``cfg.lm``)."""
    _model(spec)
    cfg, device = spec.cfg, resolve_device(device)
    if spec.family == "vlm":
        cfg = cfg.lm
    if spec.family == "ssm":
        return {"ssm": mamba2.init_decode_state(cfg, batch, device=device)}
    if spec.family == "hybrid":
        m, kv = hybrid.init_decode_state(cfg, batch, max_seq, device=device)
        return {"ssm": m, "kv": kv}

    def zeros(length, dh):
        kd = (cfg.n_layers, batch, length, cfg.n_kv, dh)
        return (torch.zeros(kd, dtype=L.COMPUTE_DTYPE, device=device),
                torch.zeros(kd, dtype=L.COMPUTE_DTYPE, device=device))

    if spec.family == "audio":
        dh = cfg.d_model // cfg.n_heads
        return {"kv": zeros(max_seq, dh), "cross": zeros(cfg.enc_len, dh)}
    return {"kv": zeros(max_seq, cfg.dh)}


def apply_decode(params, spec: ArchSpec, tokens, state,
                 cache_index: Optional[int], constrain=lambda t, *a: t):
    """One serving step: tokens (B, S) -> (logits (B, S, V), new state).
    S = 1 decodes; S > 1 at ``cache_index`` 0 is the prefill.  The ssm
    family ignores ``cache_index``, as in the JAX package; the vlm family
    serves text alone (no patches), as the JAX package's step does."""
    _model(spec)
    if spec.family == "ssm":
        logits, st = mamba2.forward(params, spec.cfg, tokens,
                                    states=state["ssm"], constrain=constrain)
        return logits, {"ssm": st}
    if spec.family == "hybrid":
        logits, st, kv = hybrid.forward(
            params, spec.cfg, tokens, states=state["ssm"],
            kv_caches=state["kv"], cache_index=cache_index,
            constrain=constrain)
        return logits, {"ssm": st, "kv": kv}
    if spec.family == "audio":
        logits, kv = encdec.decode(
            params, spec.cfg, tokens, cross=state["cross"],
            kv_caches=state["kv"], cache_index=cache_index,
            constrain=constrain)
        return logits, {"kv": kv, "cross": state["cross"]}
    if spec.family == "vlm":
        logits, kv = vlm.forward(params, spec.cfg, tokens, None,
                                 kv_caches=state["kv"],
                                 cache_index=cache_index,
                                 constrain=constrain)
        return logits, {"kv": kv}
    logits, kv = transformer.forward(
        params, spec.cfg, tokens, constrain=constrain, kv_caches=state["kv"],
        cache_index=cache_index)
    return logits, {"kv": kv}


def input_specs(spec: ArchSpec, shape_name: str):
    """The model inputs of one cell (``configs.SHAPES``) as tensors on the
    ``meta`` device, with the JAX package's shapes and dtypes: train and
    prefill {"tokens", "labels"} int32 (B, S) (the vlm family's S less
    its patches, and "patches" fp32 (B, n_patches, d_vision); the audio
    family's "frames" fp32 (B, enc_len, d_model)); decode {"tokens"} (B,
    1)."""
    seq, batch, kind = SHAPES[shape_name]

    def sd(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    if kind == "decode":
        return {"tokens": sd((batch, 1))}
    text = seq - spec.cfg.n_patches if spec.family == "vlm" else seq
    out = {"tokens": sd((batch, text)), "labels": sd((batch, text))}
    if spec.family == "vlm":
        out["patches"] = sd((batch, spec.cfg.n_patches, spec.cfg.d_vision),
                            torch.float32)
    if spec.family == "audio":
        out["frames"] = sd((batch, spec.cfg.enc_len, spec.cfg.d_model),
                           torch.float32)
    return out
