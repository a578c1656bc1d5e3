"""AdamW with the memory-scaled variant and int8 gradient compression
(port of ``repro.optim.adamw``).

Modes, as in the JAX package:

* ``adamw``: fp32 m and v;
* ``adamw_lite``: bf16 m and an Adafactor-style factored v (row and column
  second moments for matrices).

The warmup schedule, global-norm clipping and decoupled weight decay on
tensors of two or more dimensions are the JAX package's, with the same
float32 arithmetic (``b1 ** t`` in float32, Python constants rounded to
float32 where JAX's weak types round them).  The state is a dict
``{"step": 0-d int32, "m": tree, "v": tree}`` of the parameters' tree; the
update is functional (new trees), as in JAX, or with ``donate=True``
written into the old leaves' storage as each is made (JAX's donated
buffers).  The global norm sums the leaves in JAX's order
(``repro_torch.tree``).  The leaves may be DTensors: a donated leaf keeps
its placements.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import tree as T


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    mode: str = "adamw"          # "adamw" | "adamw_lite"
    warmup: int = 100


def _factored_shape(shape):
    """v is factored for >=2-D params: keep row & col moments."""
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def init(params, cfg: OptConfig):
    f32 = torch.float32

    def m_like(p):
        dt = f32 if cfg.mode == "adamw" else torch.bfloat16
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    def v_like(p):
        if cfg.mode == "adamw" or not _factored_shape(p.shape):
            return torch.zeros(p.shape, dtype=f32, device=p.device)
        return {"row": torch.zeros(p.shape[:-1], dtype=f32, device=p.device),
                "col": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=f32,
                                   device=p.device)}

    dev = T.leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": T.tree_map(m_like, params),
            "v": T.tree_map(v_like, params)}


def _is_factored(x):
    return isinstance(x, dict) and set(x.keys()) == {"row", "col"}


def _schedule(cfg: OptConfig, step):
    warm = torch.clamp((step + 1).float() / max(cfg.warmup, 1), max=1.0)
    return cfg.lr * warm


def _vhat_update(v, g2, b2):
    if isinstance(v, dict):  # factored
        row = b2 * v["row"] + (1 - b2) * g2.mean(-1)
        col = b2 * v["col"] + (1 - b2) * g2.mean(-2)
        denom = torch.clamp(row.mean(-1, keepdim=True), min=1e-30)
        vhat = (row[..., None] * col[..., None, :]) / denom[..., None]
        return {"row": row, "col": col}, vhat
    new_v = b2 * v + (1 - b2) * g2
    return new_v, new_v


#: a plain leaf of more elements than this, stacked on a leading axis
#: whose every entry holds at least ``MIN_SLICE_NUMEL``, is updated one
#: entry at a time: the update's fp32 temporaries are then an entry's,
#: not the leaf's (Zamba2-7B's stacked in_proj, 1.26 G elements, would
#: hold about 30 GB of them), and every value is bit-equal, each step
#: being element-wise.  A long leaf of short rows (an embedding of 257216
#: rows) stays whole: a launch a row would cost more than the step
SLICE_NUMEL, MIN_SLICE_NUMEL = 1 << 28, 1 << 24


def _leaf_update(p, g, m, v, cfg: OptConfig, scale, lr, bc1, bc2,
                 decay: bool):
    """(p_new, m_new, v_new) of one leaf, or one slice of it."""
    g32 = g.float() * scale
    m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
    v_new, vhat = _vhat_update(v, g32.square(), cfg.b2)
    update = (m32 / bc1) / (torch.sqrt(vhat / bc2) + cfg.eps)
    if decay:  # decoupled weight decay on matrices only
        update = update + cfg.weight_decay * p.float()
    return (p.float() - lr * update).to(p.dtype), m32.to(m.dtype), v_new


def _sliced(p, v) -> bool:
    return (p.numel() > SLICE_NUMEL and p.ndim >= 2 and
            p.numel() // p.shape[0] >= MIN_SLICE_NUMEL and
            not hasattr(p, "placements") and not isinstance(v, dict))


def _into(old, new):
    """``new`` written into ``old``'s storage (``old``'s placements when a
    DTensor); returns ``old``."""
    if hasattr(old, "placements") and \
            tuple(new.placements) != tuple(old.placements):
        new = new.redistribute(old.device_mesh, old.placements)
    with torch.no_grad():
        old.copy_(new)
    return old


def step(params, opt_state, grads, cfg: OptConfig, donate: bool = False):
    """One AdamW update; params stay in their storage dtype (bf16).
    Returns (params, opt_state, {"grad_norm", "lr"}).

    ``donate``: each new parameter, m and v is written into its old
    storage as soon as it is made, so that the peak holds one leaf's
    temporaries and not a second tree; the returned trees are the old
    ones, updated (the caller's old trees are the new ones, as a donated
    JAX buffer is gone).  The values are bit-equal either way."""
    t = opt_state["step"] + 1
    flat_g = T.leaves(grads)
    gnorm = torch.sqrt(sum(g.float().square().sum() for g in flat_g))
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = _schedule(cfg, t)
    tf = t.float()
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=tf.device), tf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=tf.device), tf)

    flat_p = T.leaves(params)
    flat_m = T.leaves(opt_state["m"])
    flat_v = T.leaves(opt_state["v"], is_leaf=_is_factored)

    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        if _sliced(p, v):
            outs = (p, m, v) if donate else tuple(
                torch.empty_like(x) for x in (p, m, v))
            for i in range(p.shape[0]):
                for o, x in zip(outs, _leaf_update(p[i], g[i], m[i], v[i],
                                                   cfg, scale, lr, bc1, bc2,
                                                   True)):
                    o[i].copy_(x)
            new_p.append(outs[0])
            new_m.append(outs[1])
            new_v.append(outs[2])
            continue
        p_new, m_new, v_new = _leaf_update(p, g, m, v, cfg, scale, lr, bc1,
                                           bc2, p.ndim >= 2)
        if donate:
            p_new, m_new = _into(p, p_new), _into(m, m_new)
            v_new = ({k: _into(v[k], v_new[k]) for k in v}
                     if isinstance(v, dict) else _into(v, v_new))
        new_p.append(p_new)
        new_m.append(m_new)
        new_v.append(v_new)
    if donate:
        t = _into(opt_state["step"], t)

    return (T.unflatten(params, new_p),
            {"step": t, "m": T.unflatten(opt_state["m"], new_m),
             "v": T.unflatten(opt_state["v"], new_v, is_leaf=_is_factored)},
            {"grad_norm": gnorm, "lr": lr})


# ----------------------------------------------------- int8 compression
def quantize_grads_int8(grads):
    """Per-tensor symmetric int8: returns (q_tree, scale_tree), each scale
    a 0-d float32 tensor."""
    def q(g):
        g32 = g.float()
        s = torch.clamp(g32.abs().max(), min=1e-20) / 127.0
        return torch.clamp(torch.round(g32 / s), -127, 127).to(torch.int8), s

    pairs = [q(g) for g in T.leaves(grads)]
    return (T.unflatten(grads, [qi for qi, _ in pairs]),
            T.unflatten(grads, [s for _, s in pairs]))


def dequantize_grads_int8(q, scales):
    return T.tree_map(lambda qi, s: qi.float() * s, q, scales)
