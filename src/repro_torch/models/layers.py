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

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..kernels import flash_attention as _fa
from ..kernels import ops

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
        return _fa.flash_attention_gqa(q, k, v, causal=False)
    return causal_attention(q, k, v, causal=False)


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
               cache_index: Optional[int] = None):
    """Returns (out, new_kv_cache).  kv_cache: (k, v) each (B, T, K, dh).

    The cache is written in place (the JAX package donates it) and
    returned.  Which attention runs:

    * no cache, ``impl="reference"``, f32 softmax: ``ops.mha`` (causal);
      the bf16 softmax: the plain :func:`causal_attention`;
      ``impl="chunked"``: :func:`chunked_attention` (causal, ``q_chunk``);
    * cache, ``cache_index == 0`` and S > 1 (the prefill step):
      ``ops.mha`` over the live prefix ``ck[:, :S]``, causal — the same
      function as the masked f32 attention over the whole cache that the
      JAX package computes there, whose entries past S get weight
      exactly 0;
    * cache otherwise (decode, ``cache_index > 0``): the plain
      :func:`causal_attention`, f32 softmax whatever ``softmax_dtype``
      says, as in the JAX package.
    """
    B, S, D = x.shape
    H, K, dh = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, dh)
    k = (x @ p["wk"]).reshape(B, S, K, dh)
    v = (x @ p["wv"]).reshape(B, S, K, dh)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if kv_cache is None:
        if cfg.impl == "chunked":
            out = chunked_attention(q, k, v, causal=True,
                                    q_chunk=cfg.q_chunk)
        elif cfg.softmax_dtype == "f32":
            out = ops.mha(q, k, v, causal=True)
        else:
            out = causal_attention(q, k, v, softmax_dtype=cfg.softmax_dtype)
        new_cache = None
    else:
        ck, cv = kv_cache
        ci = int(cache_index)
        if ci < 0 or ci + S > ck.shape[1]:
            raise ValueError(f"attn_apply: {S} tokens at cache index {ci} "
                             f"do not fit a cache of {ck.shape[1]}")
        ck[:, ci:ci + S] = k
        cv[:, ci:ci + S] = v
        if ci == 0 and S > 1:
            out = ops.mha(q, ck[:, :S], cv[:, :S], causal=True)
        else:
            # position-based mask: causal within the new chunk AND only
            # the first cache_index + S cache entries are live
            out = causal_attention(q, ck, cv, causal=False, q_offset=ci)
        new_cache = (ck, cv)
    out = out.reshape(B, S, H * dh) @ p["wo"]
    return out, new_cache


# ------------------------------------------------------------------- ffn
def ffn_init(gen: torch.Generator, d: int, f: int, lead=(), device=None):
    return {"wi": _he(gen, (*lead, d, f), device=device),
            "wg": _he(gen, (*lead, d, f), device=device),
            "wo": _he(gen, (*lead, f, d), device=device)}


def ffn_apply(p, x):
    h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    return h @ p["wo"]


# ------------------------------------------------------------- embedding
def embed_init(gen: torch.Generator, vocab: int, d: int,
               device=None) -> torch.Tensor:
    x = torch.randn((vocab, d), generator=gen, device=device or gen.device,
                    dtype=torch.float32)
    return (x * 0.02).to(PARAM_DTYPE)


def embed_apply(table, tokens):
    return table[tokens].to(COMPUTE_DTYPE)


def unembed_apply(table, x):
    """Tied unembedding: logits in fp32 for a stable softmax."""
    return torch.einsum("bsd,vd->bsv", x.float(), table.float())


# ---------------------------------------------------------------- losses
def _nll(logits, labels, z_loss: float):
    """Per-position loss and mask: ``lse - gold + z_loss * lse^2``; labels
    < 0 are padding (their loss is computed at label 0 and masked)."""
    mask = labels >= 0
    gold_idx = labels.clamp(min=0).long()[..., None]
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, gold_idx)[..., 0]
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
