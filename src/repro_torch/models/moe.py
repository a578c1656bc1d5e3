"""Token-choice top-k Mixture-of-Experts (port of ``repro.models.moe``).

Tokens are routed within fixed-size *groups* (GShard style): capacity is
per group, so the dispatch tensors are O(group · E · C_g).  Three
dispatches compute the same function:

* ``"onehot"``: GShard's (g, E, C) one-hot dispatch and combine einsums;
* ``"sort"``: a stable sort of the (token, choice) pairs by expert, their
  capacity-bounded ranks scattered into (E, C) buffers;
* ``"scatter"``: GShard's cumulative-sum ranks, the tokens scattered
  straight into the (E, C) buffers.

Every dispatch keeps a token's slot in the order (token, choice) and
drops the same pairs past an expert's capacity.  The JAX package maps its
per-group functions over the groups with ``vmap``; here they are batched
tensor operations over the group axis.  Each dispatch calls the JAX
package's ``constrain(x, "moe_expert")`` hook on the expert inputs and
outputs (G, E, C, D).

The JAX package computes all of it in plain ``jnp``, with no Pallas
kernel, and so does the port: the expert products are ``torch.einsum``
(batched products, ``aten.bmm``), which the ``"dots"`` remat recomputes,
as ``checkpoint_dots_with_no_batch_dims`` does; the router product
(G, g, D) @ (D, E) is a 2-D ``aten.mm`` and is kept.  Where the port
departs from the JAX arithmetic, a comment says why.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..launch.mesh import local_call
# bound at import, as the JAX module binds it: the one-hot dispatch and
# combine tensors stay bf16 when a caller switches the activations to fp32
from .layers import COMPUTE_DTYPE, PARAM_DTYPE, _he


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int                    # per-expert FFN width
    capacity_factor: float = 1.25
    group_size: int = 512        # routing-group tokens (GShard groups)
    dispatch: str = "onehot"     # "onehot" | "sort" | "scatter"


#: the most fp32 elements drawn at once when filling expert weights (2 GiB)
_FILL_ELEMS = 2 ** 29
#: the most experts drawn at once
_FILL_EXPERTS = 64


def _he_experts(gen: torch.Generator, shape, device):
    """He-scaled bf16 weights (*lead, E, a, b), fan-in ``a``, drawn one
    layer and at most :data:`_FILL_EXPERTS` experts (and
    :data:`_FILL_ELEMS` fp32 elements) at a time.  ``layers._he`` draws
    the whole fp32 tensor before the cast: at full width one stacked
    expert weight would be a 33.8 GB temporary (dbrx-132b at 8 layers)."""
    if torch.device(device).type == "meta":
        return _he(gen, shape, device=device)
    out = torch.empty(shape, dtype=PARAM_DTYPE, device=device)
    E, a, b = shape[-3:]
    step = max(1, min(_FILL_EXPERTS, _FILL_ELEMS // (a * b)))
    scale = (1.0 / a) ** 0.5
    for layer in out.view(-1, E, a, b):
        for e in range(0, E, step):
            n = min(step, E - e)
            x = torch.randn((n, a, b), generator=gen, device=device,
                            dtype=torch.float32)
            layer[e:e + n] = x.mul_(scale)
    return out


def moe_init(gen: torch.Generator, cfg: MoEConfig, lead=(), device=None):
    """The router fp32 (*lead, D, E); ``wi``, ``wg`` (*lead, E, D, F) and
    ``wo`` (*lead, E, F, D) bf16.  ``lead`` prepends axes (the stacked
    ``L``); ``device="meta"`` gives the shapes without storage."""
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
    dev = device or gen.device
    return {
        "router": _he(gen, (*lead, D, E), dtype=torch.float32, device=dev),
        "wi": _he_experts(gen, (*lead, E, D, Fd), dev),
        "wg": _he_experts(gen, (*lead, E, D, Fd), dev),
        "wo": _he_experts(gen, (*lead, E, Fd, D), dev),
    }


def _capacity(cfg: MoEConfig, g: int) -> int:
    cap = int(cfg.capacity_factor * g * cfg.top_k / cfg.n_experts)
    return max(4, (cap + 3) // 4 * 4)


def _group(x, cfg: MoEConfig):
    B, S, D = x.shape
    g = min(cfg.group_size, S)
    assert (B * S) % g == 0, (B, S, g)
    return x.reshape(B * S // g, g, D), g


def _einsum(eq: str, a, b):
    """``torch.einsum`` with the operands promoted to one dtype, as
    ``jnp.einsum`` promotes (bf16 with fp32 computes in fp32); a no-op
    cast when they already agree."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _top_k(logits, k: int):
    """(values, indices) of the ``k`` largest along the last axis, ties to
    the lower index: ``jax.lax.top_k``'s order, which ``torch.topk`` does
    not promise, so a stable descending sort."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p, cfg: MoEConfig, xg):
    """xg: (G, g, D) -> gates (G, g, k) fp32, experts (G, g, k)."""
    logits = xg.float() @ p["router"]
    topv, topi = _top_k(logits, cfg.top_k)
    return torch.softmax(topv, dim=-1), topi


def _expert_swiglu(xe, wg, wi, wo):
    h = F.silu(_einsum("...ecd,edf->...ecf", xe, wg)) * \
        _einsum("...ecd,edf->...ecf", xe, wi)
    return _einsum("...ecf,efd->...ecd", h, wo)


def _expert_ffn(p, xe):
    """xe: (..., E, C, D) -> (..., E, C, D) (runs every expert's SwiGLU).

    On a DTensor xe (G, E, C, D) it runs on each rank's shards
    (``launch.mesh.local_call``): xe keeps its sharding of the groups and
    the experts and gathers C and D; each weight (E, ., .) is sharded on
    the experts as xe is and gathered on the rest (the FSDP gather of the
    weights), so no product sums partial results."""
    if not isinstance(xe, DTensor):
        return _expert_swiglu(xe, p["wg"], p["wi"], p["wo"])
    xpl = tuple(pl if isinstance(pl, Shard) and pl.dim in (0, 1)
                else Replicate() for pl in xe.placements)
    wpl = tuple(Shard(0) if isinstance(pl, Shard) and pl.dim == 1
                else Replicate() for pl in xpl)
    return local_call(_expert_swiglu, (xe, p["wg"], p["wi"], p["wo"]),
                      (xpl, wpl, wpl, wpl), xpl, xe.device_mesh)


def _dispatch(xg, disp):
    """The one-hot dispatch ``gsd,gsec->gecd``: (G, E, C, D).  On DTensors
    each rank dispatches its groups to every expert (the groups' sharding
    kept, the rest gathered; ``constrain`` then keeps its experts):
    DTensor cannot place the product's flattened (E, C) axis."""
    if not isinstance(xg, DTensor):
        return _einsum("gsd,gsec->gecd", xg, disp)
    pl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
               for p in xg.placements)
    return local_call(functools.partial(_einsum, "gsd,gsec->gecd"),
                      (xg, disp), (pl, pl), pl, xg.device_mesh)


def _combine(ye, comb):
    """The one-hot combine ``gecd,gsec->gsd``: (G, g, D).  On DTensors
    each rank combines its own experts' outputs (ye's sharding of the
    groups and the experts kept, comb's matched) and the results are
    summed over the expert shards."""
    if not isinstance(ye, DTensor):
        return _einsum("gecd,gsec->gsd", ye, comb)
    ypl = tuple(p if isinstance(p, Shard) and p.dim in (0, 1) else
                Replicate() for p in ye.placements)
    cpl = tuple(Shard(2) if p == Shard(1) else p for p in ypl)
    opl = tuple(Partial() if p == Shard(1) else p for p in ypl)
    out = local_call(functools.partial(_einsum, "gecd,gsec->gsd"),
                     (ye, comb), (ypl, cpl), opl, ye.device_mesh)
    # summed here (an all-reduce): DTensor would otherwise reduce-scatter
    # the sum along the groups, which the reshape to (B, S, D) that
    # follows cannot take when they do not divide
    summed = tuple(Replicate() if isinstance(p, Partial) else p
                   for p in opl)
    return out if summed == opl else out.redistribute(ye.device_mesh,
                                                      summed)


def _onehot_ranks(topi, E: int):
    """Each (token, choice)'s rank among its expert's pairs in the group,
    in the order (token, choice): (onehot (G, g, k, E) int32, rank (G, g,
    k, E) with -1 where the pair is not the expert's).  An integer
    ``cumsum``, exact and deterministic on the card."""
    G, g, k = topi.shape
    onehot = F.one_hot(topi, E).to(torch.int32)
    rank = onehot.reshape(G, g * k, E).cumsum(1, dtype=torch.int32) - 1
    return onehot, rank.reshape(G, g, k, E)


def moe_apply_onehot(p, cfg: MoEConfig, x, constrain=lambda t, *a: t):
    """GShard one-hot dispatch.  x: (B, S, D) -> (B, S, D)."""
    B, S, D = x.shape
    xg, g = _group(x, cfg)
    E, C, k = cfg.n_experts, _capacity(cfg, g), cfg.top_k
    gates, topi = _route(p, cfg, xg)

    # capacity position of each (token, choice); accumulate over k to keep
    # the peak intermediate at (G, g, E, C) rather than (G, g, k, E, C)
    onehot_e, pos = _onehot_ranks(topi, E)
    keep = (pos < C) & (onehot_e > 0)
    pos = pos.clamp(0, C - 1).long()
    disp = comb = 0
    for kk in range(k):
        # bf16 one-hots, and the gates rounded to bf16 before the combine,
        # as in the JAX package
        oh = F.one_hot(pos[:, :, kk], C).to(COMPUTE_DTYPE) * \
            keep[:, :, kk, :, None].to(COMPUTE_DTYPE)
        disp = disp + oh
        comb = comb + oh * gates[:, :, kk, None, None].to(COMPUTE_DTYPE)

    xe = _dispatch(xg, disp)                                 # (G, E, C, D)
    xe = constrain(xe, "moe_expert")
    ye = constrain(_expert_ffn(p, xe), "moe_expert")
    out = _combine(ye, comb)
    return out.reshape(B, S, D).to(x.dtype)


def _scatter_rows(xg, slot, token, rows: int):
    """(G, rows + 1, D) zeros with ``xg[g, token[g, i]]`` written to row
    ``slot[g, i]``; row ``rows`` is the sink of every dropped pair.  Its
    duplicate indices leave it any one of their values, which the caller
    discards (``index_put`` is deterministic on the card)."""
    G, _, D = xg.shape
    gi = torch.arange(G, device=xg.device)[:, None]
    xe = xg.new_zeros((G, rows + 1, D))
    return xe.index_put((gi.expand_as(slot), slot), xg[gi, token])


def _gather_rows(ye, slot):
    """ye (G, E, C, D) with a zero sink row appended, gathered at ``slot``
    (G, n): (G, n, D)."""
    G, E, C, D = ye.shape
    flat = torch.cat([ye.reshape(G, E * C, D), ye.new_zeros((G, 1, D))], 1)
    gi = torch.arange(G, device=ye.device)[:, None]
    return flat[gi, slot]


def moe_apply_sorted(p, cfg: MoEConfig, x, constrain=lambda t, *a: t):
    """Sort-based dispatch (beyond-paper): per-group stable sort by expert,
    capacity-sliced scatter into (E, C) buffers, gather-combine back."""
    B, S, D = x.shape
    xg, g = _group(x, cfg)
    G = xg.shape[0]
    E, C, k = cfg.n_experts, _capacity(cfg, g), cfg.top_k
    gates, topi = _route(p, cfg, xg)
    dev = x.device

    flat_e = topi.reshape(G, g * k)
    flat_g = gates.reshape(G, g * k)
    flat_t = torch.arange(g, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se, st = flat_e.gather(1, order), flat_t[order]
    sg = flat_g.gather(1, order)
    experts = torch.arange(E, device=dev).expand(G, E).contiguous()
    seg_start = torch.searchsorted(se, experts, side="left")
    rank = torch.arange(g * k, device=dev) - seg_start.gather(1, se)
    keep = rank < C
    slot = torch.where(keep, se * C + rank.clamp(0, C - 1), E * C)
    xe = _scatter_rows(xg, slot, st, E * C)[:, :-1].reshape(G, E, C, D)
    xe = constrain(xe, "moe_expert")
    ye = constrain(_expert_ffn(p, xe), "moe_expert")

    contrib = _gather_rows(ye, slot) * (sg * keep).to(ye.dtype)[..., None]
    gi = torch.arange(G, device=dev)[:, None].expand_as(st)
    # the JAX ``.at[st].add``: an accumulating index_put, deterministic on
    # the card (a sort, then a fixed order of the additions)
    out = ye.new_zeros((G, g, D)).index_put((gi, st), contrib,
                                            accumulate=True)
    return out.reshape(B, S, D).to(x.dtype)


def moe_apply_scatter(p, cfg: MoEConfig, x, constrain=lambda t, *a: t):
    """Scatter dispatch (beyond-paper): GShard's cumsum capacity ranks,
    but tokens are scattered straight into (E, C) buffers — no (g, E, C)
    one-hot einsum and no argsort."""
    B, S, D = x.shape
    xg, g = _group(x, cfg)
    G = xg.shape[0]
    E, C, k = cfg.n_experts, _capacity(cfg, g), cfg.top_k
    gates, topi = _route(p, cfg, xg)

    _, rank_all = _onehot_ranks(topi, E)
    rank = rank_all.gather(-1, topi[..., None])[..., 0]       # (G, g, k)
    keep = rank < C
    slot = torch.where(keep, topi * C + rank.clamp(0, C - 1),
                       E * C).reshape(G, g * k)
    token = torch.arange(g, device=x.device).repeat_interleave(k)
    xe = _scatter_rows(xg, slot, token.expand(G, -1), E * C)
    xe = constrain(xe[:, :-1].reshape(G, E, C, D), "moe_expert")
    ye = constrain(_expert_ffn(p, xe), "moe_expert")

    contrib = _gather_rows(ye, slot).reshape(G, g, k, D)
    w = (gates * keep).to(contrib.dtype)[..., None]
    out = (contrib * w).sum(2)
    return out.reshape(B, S, D).to(x.dtype)


_DISPATCH = {"onehot": moe_apply_onehot, "sort": moe_apply_sorted,
             "scatter": moe_apply_scatter}


def moe_apply(p, cfg: MoEConfig, x, constrain=lambda t, *a: t):
    if cfg.dispatch not in _DISPATCH:
        raise ValueError(cfg.dispatch)
    return _DISPATCH[cfg.dispatch](p, cfg, x, constrain)


def aux_load_balance_loss(p, cfg: MoEConfig, x) -> torch.Tensor:
    """Switch-style load-balance loss: E * sum_e f_e * P_e."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D).float()
    logits = xt @ p["router"]
    probs = torch.softmax(logits, -1)
    _, topi = _top_k(logits, cfg.top_k)
    # the JAX ``.at[topi].add(1 / (B S k))`` as a count of each expert's
    # picks (a sum of one-hots: no float atomics on the card) times 1 / (B
    # S k)
    counts = F.one_hot(topi.reshape(-1), cfg.n_experts).sum(0)
    frac = counts.float() * (1.0 / (B * S * cfg.top_k))
    return cfg.n_experts * torch.sum(frac * probs.mean(0))
