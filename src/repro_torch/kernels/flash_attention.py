"""The flash-attention kernel (port of
``repro.kernels.flash_attention.flash_attention``).

Replaces the Pallas kernel ``flash_attention`` (body ``_flash_kernel``):
causal or full attention with an online softmax, the causal mask
``qi >= ki`` aligned top-left.  On the card it is
``csrc/flash_attention.cu`` in two variants, one CTA per 64-query tile of
one head each (see the source's header for the designs and what bounds
them):

* ``"tc"``: bf16 on the tensor cores (``mma.sync`` fed by a ``cp.async``
  ring of K/V tiles), for dh 64 or 128 with 16-byte aligned rows: what
  the serving path's prefill runs;
* ``"simt"``: fp32 FMAs from shared memory, for float32 (never TF32),
  other head widths and unaligned strides.

:func:`variant` is the rule that picks one, from dtypes, shapes, pointers
and strides alone; ``variant=`` forces the SIMT one (a card test holds
both against the plain version).

* :func:`flash_attention` has the TPU kernel's signature, (BH, S, dh)
  with the KV heads already repeated, and refuses the block sizes it
  refuses; its own tiles are 64 and ragged tails are masked, so ``bq``
  and ``bk`` only decide which shapes are accepted.
* :func:`flash_attention_gqa` takes the model's layout, q (B, Sq, H, dh)
  and k/v (B, Sk, KH, dh), each with any strides but a contiguous last
  axis, and reads KV head ``h // (H // KH)`` for query head ``h``: what
  ``ops.mha`` computes, without the repeated copies.

CPU tensors take the plain version (:mod:`.ref`); CUDA tensors launch the
kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import flash_attention_ref, mha_ref

#: head widths the kernel takes (its accumulator is 4 rows x dh per lane
#: group, in registers)
MAX_HEAD_DIM = 256
#: head widths the tensor-core variant is built for
TC_HEAD_DIMS = (64, 128)
_GRID_MAX = 65535                    # gridDim.y and .z
_QTILE = 64                          # query rows per CTA


def variant(q, k, v) -> str:
    """The kernel variant the rule gives q, k, v: ``"tc"`` for bfloat16
    with dh in :data:`TC_HEAD_DIMS`, every data pointer 16-byte aligned
    and every stride but the last (contiguous) one a multiple of 8
    elements, so that each row is whole 16-byte copies; else ``"simt"``."""
    if q.dtype != torch.bfloat16 or q.shape[-1] not in TC_HEAD_DIMS:
        return "simt"
    for x in (q, k, v):
        if x.data_ptr() % 16 or x.stride(-1) != 1 or any(
                st % 8 for st in x.stride()[:-1]):
            return "simt"
    return "tc"


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
                    bk: int = 256, variant=None):
    """q (BH, Sq, dh), k/v (BH, Sk, dh) -> (BH, Sq, dh) in q's dtype.
    ``variant``: None for the rule's choice, or ``"simt"`` to force the
    SIMT kernel."""
    if q.ndim != 3 or k.ndim != 3:
        raise ValueError("flash_attention: q, k, v must be (BH, S, dh)")
    _check(q[:, :, None], k[:, :, None], v[:, :, None])
    check_blocks(q.shape[1], k.shape[1], bq, bk)
    _check_variant(variant)
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, causal=causal)
    return _launch(q[:, :, None], k[:, :, None], v[:, :, None], causal,
                   variant)[:, :, 0]


def flash_attention_gqa(q, k, v, *, causal: bool = True, variant=None):
    """q (B, Sq, H, dh), k/v (B, Sk, KH, dh) -> (B, Sq, H, dh) in q's
    dtype; query head h attends with KV head h // (H // KH).
    ``variant``: None for the rule's choice, or ``"simt"`` to force the
    SIMT kernel."""
    _check(q, k, v)
    _check_variant(variant)
    if not q.is_cuda:
        return mha_ref(q, k, v, causal=causal)
    return _launch(q, k, v, causal, variant)


def _launch(q, k, v, causal: bool, forced):
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
    if o.numel() == 0:
        return o
    strides = (ctypes.c_longlong * 12)(
        *(s for x in (q, k, v, o) for s in x.stride()[:3]))
    lib = _build.load()
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), strides, B,
        H, KH, Sq, Sk, dh, dh ** -0.5, int(causal),
        _build.DTYPES[q.dtype], int(chosen == "tc"), _build.stream_ptr(q))
    _build.check(rc, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    _build.VARIANTS[("flash_attention", chosen)] += 1
    return o
