"""The flash-attention kernel (port of
``repro.kernels.flash_attention.flash_attention``).

Replaces the Pallas kernel ``flash_attention`` (body ``_flash_kernel``):
causal or full attention with an online softmax, the causal mask
``qi >= ki`` aligned top-left.  On the card it is
``csrc/flash_attention.cu`` in two variants, one CTA per 64-query tile of
one head each (see the source's header for the designs and what bounds
them):

* ``"tc"``: bf16 on the tensor cores (``mma.sync`` fed by ``cp.async``
  copies of K/V tiles), for dh 64, 128, 224 or 256 with 16-byte aligned
  rows: what every prefill of the model paths runs (at dh 224,
  Zamba2-7B's shared attention, and 256, paligemma's, Q stays in shared
  memory and K and V move in turn);
* ``"simt"``: fp32 FMAs from shared memory, for float32 (never TF32),
  other head widths and unaligned strides.

:func:`variant` is the rule that picks one, from dtypes, shapes, pointers
and strides alone; ``variant=`` forces the SIMT one (a card test holds
both against the plain version).  Every entry takes the scores' ``scale``
(None: dh ** -0.5; Zamba2's shared attention scales by (dh / 2) ** -0.5),
forward and backward alike.

* :func:`flash_attention` has the TPU kernel's signature, (BH, S, dh)
  with the KV heads already repeated, and refuses the block sizes it
  refuses; its own tiles are 64 and ragged tails are masked, so ``bq``
  and ``bk`` only decide which shapes are accepted.
* :func:`flash_attention_gqa` takes the model's layout, q (B, Sq, H, dh)
  and k/v (B, Sk, KH, dh), each with any strides but a contiguous last
  axis, and reads KV head ``h // (H // KH)`` for query head ``h``: what
  ``ops.mha`` computes, without the repeated copies.

Training: :class:`FlashAttention` is the kernel as a
``torch.autograd.Function``.  Its forward launches the kernel with the
row log-sum-exp output (``lse``, fp32 (B, H, Sq)) and saves q, k, v, o and
lse; its backward launches :func:`flash_attention_bwd`
(``csrc/flash_attention_bwd.cu``: dQ, dK, dV without float atomics, so
two calls give equal bits), in the same two variants by the same rule
over q, k, v, o and dO, the forward's forced variant passed through.  :func:`flash_attention_gqa` takes the Function
when autograd records (grad enabled and an input that requires grad) and
the plain launch otherwise, so serving writes no lse.  The JAX package
has no backward kernel: ``jax.grad`` differentiates its plain attention.

CPU tensors take the plain versions (:mod:`.ref`: ``mha_ref``,
``mha_lse_ref``, ``mha_bwd_ref``); CUDA tensors launch the kernels or
raise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import flash_attention_ref, mha_bwd_ref, mha_lse_ref, mha_ref

#: head widths the kernel takes (its accumulator is 4 rows x dh per lane
#: group, in registers)
MAX_HEAD_DIM = 256
#: head widths the backward kernel takes (its SIMT variant uses 32-row
#: tiles above dh 128, where 64-row ones overflow shared memory)
MAX_BWD_HEAD_DIM = MAX_HEAD_DIM
#: head widths the tensor-core variants (forward and backward) are built
#: for; dh 224 and 256 have kernels of their own design in both sources
TC_HEAD_DIMS = (64, 128, 224, 256)
_GRID_MAX = 65535                    # gridDim.y and .z
_QTILE = 64                          # query rows per CTA


def variant(q, k, v, *more) -> str:
    """The kernel variant the rule gives q, k, v (and ``more``: the
    backward's o and dO): ``"tc"`` for bfloat16 with dh in
    :data:`TC_HEAD_DIMS` (64, 128, 224, 256), every data pointer 16-byte
    aligned and every stride but the last (contiguous) one a multiple of 8
    elements, so that each row is whole 16-byte copies; else ``"simt"``
    (float32 at any width, which the tensor cores would round to TF32;
    other widths; unaligned rows)."""
    if q.shape[-1] not in TC_HEAD_DIMS:
        return "simt"
    for x in (q, k, v, *more):
        if x.dtype != torch.bfloat16 or x.data_ptr() % 16 or \
                x.stride(-1) != 1 or any(
                st % 8 for st in x.stride()[:-1]):
            return "simt"
    return "tc"


def bwd_split(B: int, H: int, KH: int, Sk: int, dh: int, n_sm: int) -> int:
    """The tensor-core backward's split of each GQA group's H // KH query
    heads at dh 224 and 256, where one CTA of ``csrc/flash_attention_bwd.cu``
    (``dkv_tc_wide_kernel``) owns a 64-key tile's dK and dV for one
    split and writes fp32 partials that one small kernel sums in split
    order: the smallest divisor d of H // KH whose d * KH * B * ceil(Sk /
    64) CTAs outnumber the card's ``n_sm`` SMs, else H // KH.  1 at dh
    128 and below.  paligemma's training call (B 8, Sk 512, 8/1 heads) on 132
    SMs: 4, so 256 CTAs where one KV head alone gives 64."""
    if dh <= 128:
        return 1
    rep = H // KH
    tiles = KH * B * -(-Sk // _QTILE)
    return next((d for d in range(1, rep + 1)
                 if rep % d == 0 and tiles * d > n_sm), rep)


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_blocks(Sq: int, Sk: int, bq: int, bk: int) -> None:
    """The TPU kernel's rule: ``min(bq, Sq)`` divides Sq and ``min(bk,
    Sk)`` divides Sk."""
    if Sq % min(bq, Sq) or Sk % min(bk, Sk):
        raise ValueError(f"flash_attention: blocks ({bq}, {bk}) do not tile "
                         f"Sq={Sq}, Sk={Sk}")


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError("flash_attention: q must be (B, Sq, H, dh) and k, v "
                         "one (B, Sk, KH, dh) shape")
    B, Sq, H, dh = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != dh or KH < 1 or H % KH:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} do not match (H % KH == 0)")
    if not 1 <= dh <= MAX_HEAD_DIM or Sk < 1:
        raise ValueError(f"flash_attention: needs 1 <= dh <= {MAX_HEAD_DIM} "
                         f"and Sk >= 1, got dh={dh}, Sk={Sk}")
    if q.dtype not in _build.DTYPES or not k.dtype == v.dtype == q.dtype:
        raise ValueError("flash_attention: q, k, v must all be float32 or "
                         "all bfloat16")


def _check_variant(forced) -> None:
    if forced not in (None, "simt"):
        raise ValueError(f"flash_attention: variant must be None (the "
                         f"rule's choice) or 'simt', got {forced!r}")


def flash_attention(q, k, v, *, causal: bool = True, bq: int = 256,
                    bk: int = 256, variant=None, scale=None):
    """q (BH, Sq, dh), k/v (BH, Sk, dh) -> (BH, Sq, dh) in q's dtype.
    ``variant``: None for the rule's choice, or ``"simt"`` to force the
    SIMT kernel; ``scale`` None is dh ** -0.5."""
    if q.ndim != 3 or k.ndim != 3:
        raise ValueError("flash_attention: q, k, v must be (BH, S, dh)")
    _check(q[:, :, None], k[:, :, None], v[:, :, None])
    check_blocks(q.shape[1], k.shape[1], bq, bk)
    _check_variant(variant)
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, causal=causal, scale=scale)
    return flash_attention_gqa(q[:, :, None], k[:, :, None], v[:, :, None],
                               causal=causal, variant=variant,
                               scale=scale)[:, :, 0]


def flash_attention_gqa(q, k, v, *, causal: bool = True, variant=None,
                        scale=None):
    """q (B, Sq, H, dh), k/v (B, Sk, KH, dh) -> (B, Sq, H, dh) in q's
    dtype; query head h attends with KV head h // (H // KH).
    ``variant``: None for the rule's choice, or ``"simt"`` to force the
    SIMT kernel; ``scale`` None is dh ** -0.5."""
    _check(q, k, v)
    _check_variant(variant)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        # the scale only when one is set: the Function's arguments at
        # dh ** -0.5 are what they were before it existed
        args = () if scale is None else (scale,)
        return FlashAttention.apply(q, k, v, causal, variant, *args)
    if not q.is_cuda:
        return mha_ref(q, k, v, causal=causal, scale=scale)
    return _launch(q, k, v, causal, variant, scale=scale)[0]


class FlashAttention(torch.autograd.Function):
    """The flash kernel under autograd: ``apply(q, k, v, causal,
    variant, scale)`` -> o, in :func:`flash_attention_gqa`'s layout.  The
    forward saves q, k, v, o and the row log-sum-exp; the backward returns
    dq, dk, dv (None for an input that needs no gradient) from
    :func:`flash_attention_bwd`.  On CPU tensors both are the plain
    versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, variant, scale=None):
        if q.is_cuda:
            o, lse = _launch(q, k, v, causal, variant, want_lse=True,
                             scale=scale)
        else:
            o, lse = mha_lse_ref(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.variant, ctx.scale = causal, variant, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        grads = flash_attention_bwd(q, k, v, o, do, lse, causal=ctx.causal,
                                    variant=ctx.variant, scale=ctx.scale)
        return tuple(g if need else None for g, need in
                     zip(grads, ctx.needs_input_grad[:3])) + (None,) * 3


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                        variant=None, scale=None):
    """The flash kernel's gradient: q, o, do (B, Sq, H, dh), k, v (B, Sk,
    KH, dh), lse (B, H, Sq) float32 from the forward -> (dq, dk, dv), dq
    in q's dtype and dk, dv in k's.  ``variant``: None for the rule's
    choice (:func:`variant` over q, k, v, o and do), or ``"simt"`` to
    force the SIMT kernels; ``scale`` None is dh ** -0.5, the forward's.
    CPU tensors take :func:`.ref.mha_bwd_ref`; CUDA tensors launch
    ``csrc/flash_attention_bwd.cu`` (1 <= dh <= 256; at dh 224 and 256
    ``"tc"`` with fp32 scratch for :func:`bwd_split`'s partials) or
    raise."""
    _check(q, k, v)
    if o.shape != q.shape or do.shape != q.shape or \
            lse.shape != (q.shape[0], q.shape[2], q.shape[1]):
        raise ValueError("flash_attention_bwd: o and do must be q's shape "
                         "and lse (B, H, Sq)")
    _check_variant(variant)
    if not q.is_cuda:
        return mha_bwd_ref(q, k, v, o, do, lse, causal=causal, scale=scale)
    return _launch_bwd(q, k, v, o, do, lse, causal, variant, scale=scale)


def _launch_bwd(q, k, v, o, do, lse, causal: bool, forced, split=None,
                scale=None):
    """The backward kernels on CUDA tensors: (dq, dk, dv).  ``split``:
    None for :func:`bwd_split`'s choice, or a divisor of H // KH for the
    tensor-core kernels at dh 224 and 256 (1 elsewhere), to time each
    split."""
    B, Sq, H, dh = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    if any(not x.is_cuda or x.device != q.device for x in (k, v, o, do, lse)):
        raise ValueError("flash_attention_bwd: every input must be on q's "
                         "device")
    if max(B, H, -(-Sq // _QTILE), -(-Sk // _QTILE)) > _GRID_MAX:
        raise ValueError(f"flash_attention_bwd: B, H and S / {_QTILE} must "
                         f"be <= {_GRID_MAX}")
    q, k, v, o, do = (x if x.stride(-1) == 1 else x.contiguous()
                      for x in (q, k, v, o, do))
    o, do = o.to(q.dtype), do.to(q.dtype)
    lse = lse.float().contiguous()
    chosen = forced or variant(q, k, v, o, do)
    gq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    gk, gv = (torch.empty(k.shape, dtype=k.dtype, device=k.device)
              for _ in range(2))
    if q.numel() == 0:
        return gq, gk, gv
    delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    if split is None:
        split = bwd_split(B, H, KH, Sk, dh, _n_sm(q.get_device())) \
            if chosen == "tc" else 1
    elif split < 1 or (H // KH) % split or \
            (split > 1 and (chosen != "tc" or dh <= 128)):
        raise ValueError(f"flash_attention_bwd: split {split} must divide "
                         f"H // KH = {H // KH}, and be 1 unless the "
                         f"tensor-core kernels run at dh 224 or 256")
    part = torch.empty((2, split, B, Sk, KH, dh), dtype=torch.float32,
                       device=q.device) if split > 1 else None
    strides = (ctypes.c_longlong * 24)(
        *(s for x in (q, k, v, o, do, gq, gk, gv) for s in x.stride()[:3]))
    lib = _build.load()
    rc = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), gq.data_ptr(),
        gk.data_ptr(), gv.data_ptr(), strides, B, H, KH, Sq, Sk, dh,
        dh ** -0.5 if scale is None else scale, int(causal),
        _build.DTYPES[q.dtype], int(chosen == "tc"), split,
        None if part is None else part.data_ptr(), _build.stream_ptr(q))
    _build.check(rc, "flash_attention_bwd")
    _build.LAUNCHES["flash_attention_bwd"] += 1
    _build.VARIANTS[("flash_attention_bwd", chosen)] += 1
    _build.observe("flash_attention_bwd", B, H, KH, Sq, Sk, dh, causal,
                   q.element_size())
    return gq, gk, gv


def _launch(q, k, v, causal: bool, forced, want_lse: bool = False,
            scale=None):
    """The forward kernel: (o, lse), lse None unless ``want_lse``;
    ``scale`` None is dh ** -0.5."""
    if any(not x.is_cuda or x.device != q.device for x in (k, v)):
        raise ValueError("flash_attention: q, k, v must be on one device")
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    B, Sq, H, dh = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    if max(B, H, -(-Sq // _QTILE)) > _GRID_MAX:
        raise ValueError(f"flash_attention: B, H and Sq / {_QTILE} must be "
                         f"<= {_GRID_MAX}")
    chosen = forced or variant(q, k, v)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if want_lse else None
    if o.numel() == 0:
        return o, lse
    strides = (ctypes.c_longlong * 12)(
        *(s for x in (q, k, v, o) for s in x.stride()[:3]))
    lib = _build.load()
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if want_lse else None, strides, B, H, KH, Sq, Sk, dh,
        dh ** -0.5 if scale is None else scale, int(causal),
        _build.DTYPES[q.dtype], int(chosen == "tc"), _build.stream_ptr(q))
    _build.check(rc, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    _build.VARIANTS[("flash_attention", chosen)] += 1
    _build.observe("flash_attention", B, H, KH, Sq, Sk, dh, causal,
                   q.element_size())
    return o, lse
