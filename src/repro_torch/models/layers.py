"""Shared layers of the dense decoder (port of ``repro.models.layers``).

Conventions, as in the JAX package:

* parameters are plain dicts of tensors; layer-stacked weights carry a
  leading ``L`` axis (``transformer.forward`` indexes it layer by layer);
* compute and parameters are bf16, sums fp32, and bf16 rounds where the
  JAX package rounds: ``rmsnorm`` casts back before the gain, RoPE runs in
  fp32 on split halves, attention sums in fp32 and casts at the end, and
  the unembedding runs in fp32;
* initialisation takes an explicit ``torch.Generator``; tensors are made
  on its device.

Every function that takes ``constrain`` calls it where the JAX package
does: ``constrain(x, kind)`` is the identity off a mesh, and under one
(``launch.mesh.make_constrain``) redistributes a DTensor to the kind's
placements.  The attentions take DTensors through :func:`attend`, which
runs them on each rank's shards (the flash kernels take plain tensors),
and :func:`write_cache` writes a step into a sharded KV cache shard by
shard.

Prefill and training attention go through
:func:`repro_torch.kernels.ops.mha`, the flash kernel on the card (its
forward, and under autograd its backward kernel; :func:`attn_apply` says
which shapes), and the encoder-decoder's full attention through
:func:`full_attention`.  :func:`chunked_attention` is the JAX package's
memory-efficient schedule in plain torch, each query chunk recomputed in
the backward pass (``torch.utils.checkpoint``), as ``jax.checkpoint`` does
there; :func:`softmax_xent_chunked` does the same for the big-vocabulary
cross-entropy.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import ClassVar, Optional

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..kernels import flash_attention as _fa
from ..kernels import ops
from ..launch.mesh import local_call, pin_grad, shard_range

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.bfloat16


def _he(gen: torch.Generator, shape, scale: float = 1.0,
        dtype=PARAM_DTYPE, device=None) -> torch.Tensor:
    """He-scaled normal weights on ``device`` (default: ``gen``'s; "meta"
    gives shapes without storage)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    x = torch.randn(shape, generator=gen, device=device or gen.device,
                    dtype=torch.float32)
    return (x * (scale / fan_in) ** 0.5).to(dtype)


def layer_params(stacked, i: int):
    """Layer ``i`` of a tree of stacked weights (views, no copy)."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


# ----------------------------------------------------------------- remat
def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``"dots"``: keep what the weight
    products (2-D ``aten.mm``) return, recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(policy: str, fn):
    """``fn`` (a layer's body) under a remat policy: ``"none"`` keeps
    every activation; ``"full"`` checkpoints the whole body (non-reentrant:
    only its inputs are kept and it runs again in the backward pass);
    ``"dots"`` keeps what the weight products (``aten.mm``, the 2-D
    products a (B, S, D) @ (D, F) projection lowers to) return and
    recomputes the rest: the counterpart of JAX's
    ``checkpoint_dots_with_no_batch_dims``, which saves no product with
    batch dimensions (``aten.bmm``)."""
    if policy == "none":
        return fn
    if policy == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False, context_fn=functools.partial(
                create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"unknown remat policy {policy!r}")


# ----------------------------------------------------------------- norms
def rmsnorm_init(d: int, *, device=None, lead=()) -> torch.Tensor:
    return torch.ones((*lead, d), dtype=PARAM_DTYPE, device=device)


def rmsnorm(g, x, eps: float = 1e-6):
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * g


# ------------------------------------------------------------------ rope
def rope_freqs(dh: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exps = torch.arange(0, dh, 2, dtype=torch.float32, device=device) / dh
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, dh); positions: (..., S)."""
    dh = x.shape[-1]
    inv = rope_freqs(dh, theta, x.device)                  # (dh/2,)
    ang = positions[..., :, None].float() * inv            # (..., S, dh/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ------------------------------------------------------------- attention
def causal_attention(q, k, v, *, scale: Optional[float] = None,
                     causal: bool = True, q_offset: Optional[int] = None,
                     softmax_dtype: str = "f32"):
    """Reference attention.  q: (B,S,H,dh)  k/v: (B,T,K,dh) with H % K == 0.

    ``q_offset``: position of q[0] within the KV timeline — decode and
    chunked prefill use it for within-chunk causality.  (The JAX
    function's ``kv_len`` has no caller and is not ported.)
    """
    B, S, H, dh = q.shape
    T, K = k.shape[1], k.shape[2]
    scale = scale if scale is not None else dh ** -0.5
    rep = H // K
    bf16 = softmax_dtype == "bf16"
    cdt = torch.bfloat16 if bf16 else torch.float32
    neg = -3e4 if bf16 else -1e30
    qg = q.reshape(B, S, K, rep, dh)
    # products summed in fp32, the logits rounded to cdt, then scaled by
    # the scale rounded to cdt
    logits = torch.einsum("bskrd,btkd->bkrst", qg.to(cdt).float(),
                          k.to(cdt).float()).to(cdt) \
        * torch.tensor(scale, dtype=cdt)
    dev = q.device
    if causal and S == T and q_offset is None:
        mask = torch.ones((S, T), dtype=torch.bool, device=dev).tril()
        logits = logits.masked_fill(~mask, neg)
    if q_offset is not None:
        qpos = q_offset + torch.arange(S, device=dev)
        mask = qpos[:, None] >= torch.arange(T, device=dev)[None, :]
        logits = logits.masked_fill(~mask, neg)
    if bf16:
        # bf16 buffers, fp32 row statistics (max/sum) only
        m = logits.amax(-1, keepdim=True)
        e = torch.exp(logits - m)                                  # bf16
        s = e.float().sum(-1, keepdim=True)
        p = (e.float() / s).to(torch.bfloat16)
    else:
        p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrst,btkd->bskrd", p.float(), v.to(p.dtype).float())
    return out.reshape(B, S, H, dh).to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool = True, q_chunk: int = 512):
    """Memory-efficient attention: q in chunks of ``q_chunk`` rows, logits
    never materialised at (S, S); each chunk is recomputed in the backward
    pass (``torch.utils.checkpoint``), so activation memory per head drops
    from O(S^2) to O(S * q_chunk).  Plain torch, no kernel, as the JAX
    function is plain XLA.  q (B, S, H, dh), k/v (B, T, K, dh); the causal
    mask aligns query i with key i.  (The JAX function's ``kv_len`` has no
    caller and is not ported.)"""
    B, S, H, dh = q.shape
    T, K = k.shape[1], k.shape[2]
    rep, scale = H // K, dh ** -0.5
    q_chunk = min(q_chunk, S)
    if S % q_chunk:
        raise ValueError(f"chunked_attention: q_chunk {q_chunk} does not "
                         f"divide S={S}")
    qg = q.reshape(B, S // q_chunk, q_chunk, K, rep, dh)
    keys = torch.arange(T, device=q.device)

    def one_chunk(qc, qpos0: int):                  # (B, C, K, rep, dh)
        logits = torch.einsum("bckrd,btkd->bkrct", qc.float(),
                              k.float()) * scale
        if causal:
            qi = qpos0 + torch.arange(q_chunk, device=q.device)
            logits = logits.masked_fill(qi[:, None] < keys[None, :], -1e30)
        p = torch.softmax(logits, dim=-1)
        out = torch.einsum("bkrct,btkd->bckrd", p, v.float())
        return out.to(q.dtype)

    outs = [checkpoint(one_chunk, qg[:, i], i * q_chunk, use_reentrant=False)
            for i in range(S // q_chunk)]
    return torch.stack(outs, 1).reshape(B, S, H, dh)


def split_last(x, *shape):
    """``x`` (..., n) reshaped to (..., *shape).  A DTensor sharded on its
    last axis over mesh dims that do not divide ``shape[0]`` (8 KV heads
    over a 16-way ``model`` axis) is first gathered on those dims:
    DTensor does not unflatten an uneven shard."""
    if isinstance(x, DTensor):
        last, mesh = x.ndim - 1, x.device_mesh
        n, pl = shape[0], list(x.placements)
        for i, p in enumerate(pl):
            if isinstance(p, Shard) and p.dim in (last, -1):
                if n % mesh.size(i):
                    pl[i] = Replicate()
                else:
                    n //= mesh.size(i)
        if pl != list(x.placements):
            x = x.redistribute(mesh, pl)
    return x.reshape(*x.shape[:-1], *shape)


def _counting() -> bool:
    """Whether a dispatch mode that reads region names (``launch.
    hloanalysis.CostMode``, ``reads_scopes``) is active."""
    return any(getattr(m, "reads_scopes", False)
               for m in _get_current_dispatch_mode_stack())


def _attn_scope():
    """The region ``"flashable_attn"`` (``torch.profiler.
    record_function``) while a cost analysis counts, else nothing: a
    name costs microseconds."""
    return torch.profiler.record_function("flashable_attn") \
        if _counting() else contextlib.nullcontext()


def attend(fn, q, k, v):
    """``fn(q, k, v)``, an attention over q (B, S, H, dh) and k/v (B, T,
    K, dh) with H % K == 0, returning (B, S, H, dh).  Plain tensors go
    straight to ``fn``.  A DTensor q runs ``fn`` on each rank's shards
    (``launch.mesh.local_call``): the batch keeps q's sharding and so do
    the heads; the sequence, the head dim and anything ``Partial`` are
    gathered (``profile="seq"`` shards q's sequence, and the causal kernel
    masks from the top-left of the rows it is given).  k and v follow q's
    batch, and its heads where the mesh dim divides K; otherwise each rank
    gets every KV head and picks, for its own query heads, the group each
    reads (head h reads group h // (H // K)), so that GQA groups stay
    whole.  The call is the region ``"flashable_attn"`` of a cost
    analysis."""
    if not isinstance(q, DTensor) and not _counting():
        return fn(q, k, v)
    with _attn_scope():
        return _attend(fn, q, k, v)


def _attend(fn, q, k, v, time_fn=None):
    """:func:`attend`'s body.  With ``time_fn``, the mesh dims that shard
    k's time axis keep it sharded (q is gathered there) and ``time_fn(q,
    k, v, mesh, dims, t0)`` runs in ``fn``'s place, given those dims and
    the shard's first key position."""
    if not isinstance(q, DTensor):
        return fn(q, k, v)
    mesh = q.device_mesh
    H, K = q.shape[2], k.shape[2]
    tdims = [i for i, p in enumerate(k.placements) if time_fn is not None
             and isinstance(p, Shard) and p.dim == 1]
    qpl, kpl, split = [], [], False
    for i, p in enumerate(q.placements):
        if i in tdims:
            qpl.append(Replicate())
            kpl.append(Shard(1))
        elif isinstance(p, Shard) and p.dim == 0:
            qpl.append(p)
            kpl.append(p)
        elif isinstance(p, Shard) and p.dim == 2:
            qpl.append(p)
            whole = K % mesh.size(i) == 0 and H % mesh.size(i) == 0
            kpl.append(p if whole else Replicate())
            split = split or not whole
        else:
            qpl.append(Replicate())
            kpl.append(Replicate())
    h0, hn = shard_range(H, mesh, qpl, 2)
    heads = torch.arange(h0, h0 + hn, device=q.to_local().device)
    t0 = shard_range(k.shape[1], mesh, kpl, 1)[0]

    def run(ql, kl, vl):
        if split:
            groups = heads // (H // K)
            kl, vl = kl.index_select(2, groups), vl.index_select(2, groups)
        if tdims:
            return time_fn(ql, kl, vl, mesh, tdims, t0)
        return fn(ql, kl, vl)

    return local_call(run, (q, k, v), (qpl, kpl, kpl), tuple(qpl), mesh)


def _decode_time_split(q, k, v, mesh, dims, t0, *, q_offset: int,
                       scale: Optional[float] = None):
    """:func:`causal_attention` (``causal=False``, fp32 softmax) of the
    whole cache from this rank's shard of its time axis (keys ``t0`` on):
    each shard's row maximum, exponential sums and weighted values, made
    global by all-reduces over the mesh ``dims`` that split the time
    (max, then sums), so that no shard of the cache moves.  Exact in
    value; its sums run in another order than the plain function's."""
    B, S, H, dh = q.shape
    T, K = k.shape[1], k.shape[2]
    rep = H // K
    qg = q.reshape(B, S, K, rep, dh)
    logits = torch.einsum("bskrd,btkd->bkrst", qg.float(), k.float()) \
        * torch.tensor(dh ** -0.5 if scale is None else scale,
                       dtype=torch.float32)
    qpos = q_offset + torch.arange(S, device=q.device)
    kpos = t0 + torch.arange(T, device=q.device)
    logits = logits.masked_fill(qpos[:, None] < kpos[None, :], -1e30)
    m = logits.amax(-1, keepdim=True)
    for i in dims:
        m = funcol.all_reduce(m, "max", (mesh, i))
    e = torch.exp(logits - m)
    den = e.sum(-1)                                        # (B, K, rep, S)
    num = torch.einsum("bkrst,btkd->bskrd", e, v.float())
    for i in dims:
        den = funcol.all_reduce(den, "sum", (mesh, i))
        num = funcol.all_reduce(num, "sum", (mesh, i))
    out = num / den.permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, S, H, dh).to(q.dtype)


def attend_cache(q, ck, cv, q_offset: int, scale: Optional[float] = None):
    """A decode step's attention over the KV cache: the plain
    :func:`causal_attention` (``causal=False``, ``q_offset``, ``scale``;
    None is dh ** -0.5), placed as
    :func:`attend` places it, but a DTensor cache sharded on its time axis
    (``decode_state_spec`` at batch 1, or where the KV heads do not divide
    the ``model`` axis) is read where it lies (:func:`_decode_time_split`).
    """
    if not isinstance(q, DTensor) and not _counting():
        return causal_attention(q, ck, cv, causal=False, q_offset=q_offset,
                                scale=scale)
    with _attn_scope():
        return _attend(
            functools.partial(causal_attention, causal=False,
                              q_offset=q_offset, scale=scale), q, ck, cv,
            time_fn=functools.partial(_decode_time_split,
                                      q_offset=q_offset, scale=scale))


def write_cache(cache, new, index: int):
    """``cache[:, index:index + S] = new`` in place: cache (B, T, K, dh),
    new (B, S, K, dh).  On a DTensor cache each rank writes the part of
    ``new`` that falls in its own shard of T (the batch and the heads of
    ``new`` are first redistributed to the cache's), so a cache sharded on
    T is written where it lies and never gathered."""
    S = new.shape[1]
    if not isinstance(cache, DTensor):
        cache[:, index:index + S] = new
        return
    mesh = cache.device_mesh
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
               for p in cache.placements)
    if not isinstance(new, DTensor):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim)
    if tuple(new.placements) != pl:
        new = new.redistribute(mesh, pl)
    t0, tn = shard_range(cache.shape[1], mesh, cache.placements, 1)
    lo, hi = max(index, t0), min(index + S, t0 + tn)
    if lo < hi:
        cache.to_local()[:, lo - t0:hi - t0] = \
            new.to_local()[:, lo - index:hi - index]


#: the longest query that :func:`full_attention` gives the plain version
#: (decode steps)
FULL_ATTENTION_PLAIN_MAX_SQ = 8


def full_attention(q, k, v):
    """Full (non-causal) attention, the encoder-decoder's encoder
    self-attention and decoder cross-attention: ``causal_attention(q, k,
    v, causal=False)`` in the JAX package.  q (B, Sq, H, dh), k/v (B, Sk,
    K, dh).

    With Sq > :data:`FULL_ATTENTION_PLAIN_MAX_SQ` it is the flash kernel,
    ``flash_attention_gqa(causal=False)`` (``FlashAttention`` under
    autograd); a decode step's few queries take the plain
    :func:`causal_attention`.  It does not go through ``ops.tile_ok``:
    that rule (the TPU kernel's blocks must divide both lengths) rejects
    whisper's 1500 encoder frames, while the port's kernels mask a ragged
    last tile, forward and backward; and full attention has no mask to
    align, so the kernel computes the plain version's function at every
    length.  On CPU tensors the flash wrapper takes its plain version."""
    if q.shape[1] > FULL_ATTENTION_PLAIN_MAX_SQ:
        return attend(functools.partial(_fa.flash_attention_gqa,
                                        causal=False), q, k, v)
    return attend(functools.partial(causal_attention, causal=False),
                  q, k, v)


# -------------------------------------------------------------- attention block
@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    qk_norm: bool = False
    rope_theta: float = 10000.0
    impl: str = "reference"    # "reference" | "chunked"
    q_chunk: int = 512
    softmax_dtype: str = "f32"  # "f32" | "bf16"
    #: the scores' scale; None is head_dim ** -0.5 (a class default, so
    #: that the JAX package's configurations keep their fields;
    #: :class:`ScaledAttnConfig` makes it a field)
    scale: ClassVar[Optional[float]] = None


@dataclasses.dataclass(frozen=True)
class ScaledAttnConfig(AttnConfig):
    """:class:`AttnConfig` with the scores' scale as a field (Zamba2's
    shared attention: (head_dim / 2) ** -0.5)."""
    scale: Optional[float] = None


def attn_init(gen: torch.Generator, cfg: AttnConfig, lead=(), device=None):
    """Attention weights; ``lead`` prepends axes (the stacked ``L``)."""
    D, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    device = device or gen.device
    p = {
        "wq": _he(gen, (*lead, D, H * dh), device=device),
        "wk": _he(gen, (*lead, D, K * dh), device=device),
        "wv": _he(gen, (*lead, D, K * dh), device=device),
        "wo": _he(gen, (*lead, H * dh, D), device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(dh, device=device, lead=lead)
        p["k_norm"] = rmsnorm_init(dh, device=device, lead=lead)
    return p


def attn_apply(p, cfg: AttnConfig, x, positions, *, kv_cache=None,
               cache_index: Optional[int] = None,
               constrain=lambda t, *a: t):
    """Returns (out, new_kv_cache).  kv_cache: (k, v) each (B, T, K, dh).

    The cache is written in place (the JAX package donates it) and
    returned.  Which attention runs:

    The kernel and the decode step scale the scores by ``cfg.scale``
    (None: dh ** -0.5); the chunked and bf16-softmax paths by dh ** -0.5.

    * no cache, ``impl="reference"``, f32 softmax: ``ops.mha`` (causal);
      the bf16 softmax: the plain :func:`causal_attention`;
      ``impl="chunked"``: :func:`chunked_attention` (causal, ``q_chunk``);
    * cache, ``cache_index == 0`` and S > 1 (the prefill step):
      ``ops.mha`` over the live prefix, the step's own k and v in the
      cache's dtype (what the cache holds there), causal — the same
      function as the masked f32 attention over the whole cache that the
      JAX package computes there, whose entries past S get weight
      exactly 0;
    * cache otherwise (decode, ``cache_index > 0``): the plain
      :func:`causal_attention`, f32 softmax whatever ``softmax_dtype``
      says, as in the JAX package.
    """
    B, S, D = x.shape
    H, K, dh = cfg.n_heads, cfg.n_kv, cfg.head_dim
    wq = constrain(p["wq"], "param:attn/wq")
    wk = constrain(p["wk"], "param:attn/wk")
    wv = constrain(p["wv"], "param:attn/wv")
    wo = constrain(p["wo"], "param:attn/wo")
    q = split_last(x @ wq, H, dh)
    k = split_last(x @ wk, K, dh)
    v = split_last(x @ wv, K, dh)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = constrain(q, "act_heads")
    k = constrain(k, "act_kv")
    mha = functools.partial(ops.mha, causal=True) if cfg.scale is None else \
        functools.partial(ops.mha, causal=True, scale=cfg.scale)
    if kv_cache is None:
        if cfg.impl == "chunked":
            fn = functools.partial(chunked_attention, causal=True,
                                   q_chunk=cfg.q_chunk)
        elif cfg.softmax_dtype == "f32":
            fn = mha
        else:
            fn = functools.partial(causal_attention,
                                   softmax_dtype=cfg.softmax_dtype)
        out = attend(fn, q, k, v)
        new_cache = None
    else:
        ck, cv = kv_cache
        ci = int(cache_index)
        if ci < 0 or ci + S > ck.shape[1]:
            raise ValueError(f"attn_apply: {S} tokens at cache index {ci} "
                             f"do not fit a cache of {ck.shape[1]}")
        write_cache(ck, k, ci)
        write_cache(cv, v, ci)
        if ci == 0 and S > 1:
            out = attend(mha, q, k.to(ck.dtype), v.to(cv.dtype))
        else:
            # position-based mask: causal within the new chunk AND only
            # the first cache_index + S cache entries are live
            out = attend_cache(q, ck, cv, ci, cfg.scale)
        new_cache = (ck, cv)
    out = merge_last(out) @ wo
    return constrain(out, "act_resid"), new_cache


# ------------------------------------------------------------------- ffn
def ffn_init(gen: torch.Generator, d: int, f: int, lead=(), device=None):
    return {"wi": _he(gen, (*lead, d, f), device=device),
            "wg": _he(gen, (*lead, d, f), device=device),
            "wo": _he(gen, (*lead, f, d), device=device)}


def ffn_apply(p, x, constrain=lambda t, *a: t):
    wi = constrain(p["wi"], "param:ffn/wi")
    wg = constrain(p["wg"], "param:ffn/wg")
    wo = constrain(p["wo"], "param:ffn/wo")
    h = F.silu(x @ wg) * (x @ wi)
    h = constrain(h, "act_ffn")
    return constrain(h @ wo, "act_resid")


def gelu_ffn_lora_apply(p, x, lora_a, lora_b):
    """The GELU-gated feed-forward with a low-rank term on its fused
    gate-up product (Zamba2's shared MLP): ``gu = x @ gate_up + (x @
    lora_a) @ lora_b``, its halves gate and up, then ``(gelu(gate) * up)
    @ down``; GELU exact (erf).  x (..., D), gate_up (D, 2F), lora_a (D,
    r), lora_b (r, 2F), down (F, D)."""
    gu = x @ p["gate_up"] + (x @ lora_a) @ lora_b
    gate, up = gu.chunk(2, dim=-1)
    return (F.gelu(gate) * up) @ p["down"]


# ------------------------------------------------------------- embedding
def embed_init(gen: torch.Generator, vocab: int, d: int,
               device=None) -> torch.Tensor:
    x = torch.randn((vocab, d), generator=gen, device=device or gen.device,
                    dtype=torch.float32)
    return (x * 0.02).to(PARAM_DTYPE)


def embed_apply(table, tokens):
    if isinstance(table, DTensor):
        return _embed_sharded(table, tokens).to(COMPUTE_DTYPE)
    return table[tokens].to(COMPUTE_DTYPE)


def _embed_sharded(table, tokens):
    """``table[tokens]`` on a DTensor table, on each rank's shards
    (``launch.mesh.local_call``; DTensor's rule for the gradient's
    ``index_put`` fails on some torch releases): where the vocabulary is
    sharded each rank looks up the tokens its rows hold and zeros
    elsewhere, and the result is their sum (``Partial``, exact: one term
    is not zero); where the width is sharded the rows come out sharded;
    the tokens keep their own sharding on the other mesh dims."""
    mesh = table.device_mesh
    tpl = tuple(Replicate() if isinstance(p, Partial) else p
                for p in table.placements)
    vocab = {i for i, p in enumerate(tpl)
             if isinstance(p, Shard) and p.dim == 0}
    width = {i for i, p in enumerate(tpl)
             if isinstance(p, Shard) and p.dim == 1}
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim)
    ipl = tuple(Replicate() if i in vocab or i in width or
                not isinstance(p, Shard) else p
                for i, p in enumerate(tokens.placements))
    opl = tuple(Partial() if i in vocab else
                Shard(tokens.ndim) if i in width else p
                for i, p in enumerate(ipl))
    lo, n = shard_range(table.shape[0], mesh, tpl, 0)

    def run(t, ix):
        ix = ix - lo
        ok = (ix >= 0) & (ix < n)
        return torch.where(ok[..., None], t[ix.clamp(0, max(n - 1, 0))], 0)

    return local_call(run, (table, tokens), (tpl, ipl), opl, mesh)


def unembed_apply(table, x):
    """Tied unembedding: logits in fp32 for a stable softmax (on a mesh
    their gradient pinned to their placements, ``mesh.pin_grad``)."""
    return pin_grad(torch.einsum("bsd,vd->bsv", x.float(), table.float()))


# ---------------------------------------------------------------- losses
def take_last(x, idx):
    """``x.gather(-1, idx)``.  On a DTensor it runs on each rank's shards
    (``launch.mesh.local_call``; DTensor's own rule for a gather fails
    here): where the last axis (the vocabulary of the logits) is sharded,
    each rank gathers the indices its shard holds and zeros elsewhere, and
    the result is their sum (``Partial``), exact since one term is not
    zero; the gradient goes to the rank that holds the index."""
    if not isinstance(x, DTensor):
        return x.gather(-1, idx)
    last, mesh = x.ndim - 1, x.device_mesh
    pl = tuple(Replicate() if isinstance(p, Partial) else p
               for p in x.placements)
    split = {i for i, p in enumerate(pl)
             if isinstance(p, Shard) and p.dim in (last, -1)}
    ipl = tuple(Replicate() if i in split else p for i, p in enumerate(pl))
    if not isinstance(idx, DTensor):
        idx = DTensor.from_local(idx, mesh, [Replicate()] * mesh.ndim)
    lo, n = shard_range(x.shape[last], mesh, pl, last)

    def run(xl, il):
        il = il - lo
        ok = (il >= 0) & (il < n)
        return torch.where(ok, xl.gather(-1, il.clamp(0, max(n - 1, 0))), 0)

    opl = tuple(Partial() if i in split else p for i, p in enumerate(pl))
    return local_call(run, (x, idx), (pl, ipl), opl, mesh)


def merge_last(x):
    """``x`` (..., a, b) reshaped to (..., a * b).  On a DTensor the
    reshape runs on each rank's shard, so that its gradient arrives
    placed as ``x`` is (``a`` sharded where ``x`` is, ``b`` whole): DTensor
    cannot unflatten a gradient sharded unevenly over ``a`` (24 heads over
    a 16-way axis)."""
    if not isinstance(x, DTensor):
        return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    a = x.ndim - 2
    pl = tuple(Replicate() if isinstance(p, Partial) or
               (isinstance(p, Shard) and p.dim in (a + 1, -1)) else p
               for p in x.placements)
    return local_call(lambda t: t.reshape(*t.shape[:-2], -1), (x,), (pl,),
                      pl, x.device_mesh)


def _nll(logits, labels, z_loss: float):
    """Per-position loss and mask: ``lse - gold + z_loss * lse^2``; labels
    < 0 are padding (their loss is computed at label 0 and masked)."""
    mask = labels >= 0
    gold_idx = labels.clamp(min=0).long()[..., None]
    lse = torch.logsumexp(logits, dim=-1)
    gold = take_last(logits, gold_idx)[..., 0]
    return lse - gold + z_loss * lse ** 2, mask


def softmax_xent_chunked(head, x, labels, *, chunk: int = 512,
                         z_loss: float = 1e-4):
    """Cross-entropy without materialising (B, S, V) logits: each
    sequence chunk is projected (fp32, as :func:`unembed_apply`), reduced,
    and recomputed in the backward pass (``torch.utils.checkpoint``).
    x (B, S, D), head (V, D), labels (B, S) with < 0 as padding."""
    B, S, D = x.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"softmax_xent_chunked: chunk {chunk} does not "
                         f"divide S={S}")

    def one(xi, li):
        logits = torch.einsum("bsd,vd->bsv", xi.float(), head.float())
        nll, mask = _nll(logits, li, z_loss)
        return (nll * mask).sum(), mask.sum()

    sums = [checkpoint(one, x[:, i:i + chunk], labels[:, i:i + chunk],
                       use_reentrant=False) for i in range(0, S, chunk)]
    nll = torch.stack([n for n, _ in sums]).sum()
    count = torch.stack([c for _, c in sums]).sum()
    return nll / count.clamp(min=1)


def softmax_xent(logits, labels, *, z_loss: float = 1e-4):
    """Cross-entropy with z-loss over (..., V) fp32 logits; labels < 0
    are padding."""
    nll, mask = _nll(logits, labels, z_loss)
    return (nll * mask).sum() / mask.sum().clamp(min=1)
