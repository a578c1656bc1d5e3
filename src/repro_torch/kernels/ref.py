"""Plain-PyTorch versions of the port's kernels (port of
``repro.kernels.ref``).

``simt_alu_ref`` is the plain version of the CUDA ``simt_alu`` kernel
(and of the datapath inside the fused SM kernel): the CPU path of every
execute backend, and what ``chip_smoke.py`` holds the kernels against on
the card.  Arithmetic is carried in int64 and wrapped to int32, so the
two's-complement overflow of IADD/ISUB/IMUL/IMAD and of the ISETP
difference is exact on every device.

``matmul_ref`` and ``flash_attention_ref`` are the plain versions of the
CUDA ``matmul`` and ``flash_attention`` kernels, in float32.
``mha_lse_ref`` adds the row log-sum-exp that the kernel writes for
training, and ``mha_bwd_ref`` is the plain version of the backward kernel
(``flash_attention_bwd``): the explicit formulas in float32.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import isa


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """Reduce an int64 tensor modulo 2**32 into int32 two's complement."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def simt_alu_ref(op, s1, s2, s3, cond, s2r, mask, *,
                 enable_mul: bool = True, num_read_operands: int = 3):
    """op (..., W) per warp row; s1/s2/s3/cond/s2r/mask (..., W, L) int32,
    any leading dimensions (the staged pipeline gives (P, W, 32), one row
    per warp of each position).

    Returns (result, isetp nibble), both (..., W, L) int32 and zero
    outside ``mask``; the nibble is also zero outside ISETP rows."""
    opb = op[..., None]
    condb = cond != 0
    a, b = s1.to(torch.int64), s2.to(torch.int64)
    u1, u2 = a & 0xFFFFFFFF, b & 0xFFFFFFFF
    sh = b & 31
    zero = torch.zeros_like(a)
    mul = a * b if enable_mul else zero
    # IMAD needs both the multiplier and the third read port (§4.2)
    mad = a * b + s3.to(torch.int64) \
        if (enable_mul and num_read_operands >= 3) else zero
    table = (
        (isa.MOV, b), (isa.IADD, a + b), (isa.ISUB, a - b), (isa.IMUL, mul),
        (isa.IMAD, mad), (isa.IMIN, torch.minimum(a, b)),
        (isa.IMAX, torch.maximum(a, b)), (isa.IABS, a.abs()),
        (isa.AND, a & b), (isa.OR, a | b), (isa.XOR, a ^ b), (isa.NOT, ~a),
        (isa.SHL, u1 << sh), (isa.SHR, u1 >> sh), (isa.SAR, a >> sh),
        (isa.ISET, condb.to(torch.int64)),
        (isa.SELP, torch.where(condb, a, b)),
        (isa.S2R, s2r.to(torch.int64)))
    res = zero
    for code, val in table:
        res = torch.where(opb == code, val, res)
    res = wrap32(res)                 # IABS(INT_MIN) wraps to INT_MIN

    # ISETP flag nibble (sign, zero, carry, overflow) of s1 - s2
    d = wrap32(a - b).to(torch.int64)
    nib = ((d < 0).to(torch.int32)
           | ((d == 0).to(torch.int32) << 1)
           | ((u1 < u2).to(torch.int32) << 2)
           | ((((a ^ b) & (a ^ d)) < 0).to(torch.int32) << 3))
    m = mask != 0
    return (torch.where(m, res, 0).to(torch.int32),
            torch.where(m & (opb == isa.ISETP), nib, 0).to(torch.int32))


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) with a float32 accumulator; dtype follows ``a``.
    bf16 products are exact in float32, so this is bf16-in, fp32-sum."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True, q_offset: int = 0,
                        scale: Optional[float] = None):
    """Plain version of the flash-attention kernel (float32 softmax).

    q (BH, Sq, dh), k/v (BH, Sk, dh) -> (BH, Sq, dh) in q's dtype; the
    scores scaled by ``scale`` (None: dh ** -0.5).  Under
    ``causal``, query i sees key j when ``i + q_offset >= j``: the
    Pallas kernel and the CUDA kernel align top-left (``q_offset=0``);
    the JAX package's oracle aligns bottom-right (``q_offset=Sk-Sq``),
    which is what ``ops.mha`` gives the shapes that do not tile.  The two
    agree when ``Sq == Sk``.
    """
    Sq, dh = q.shape[1], q.shape[2]
    Sk = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * \
        (dh ** -0.5 if scale is None else scale)
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
        mask = qi >= torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(mask[None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def mha_ref(q, k, v, *, causal: bool = True, q_offset: int = 0,
            scale: Optional[float] = None):
    """Plain GQA attention in the model's layout: q (B, Sq, H, dh), k/v
    (B, Sk, KH, dh) -> (B, Sq, H, dh).  Folds (B, H) into one axis and
    repeats each KV head H // KH times, as the JAX package's ``ops.mha``
    does, then :func:`flash_attention_ref`."""
    B, Sq, H, dh = q.shape
    Sk, rep = k.shape[1], H // k.shape[2]

    def fold(x, n):
        return x.transpose(1, 2).repeat_interleave(rep, dim=1) \
            .reshape(B * H, n, dh)

    of = flash_attention_ref(q.transpose(1, 2).reshape(B * H, Sq, dh),
                             fold(k, Sk), fold(v, Sk), causal=causal,
                             q_offset=q_offset, scale=scale)
    return of.reshape(B, H, Sq, dh).transpose(1, 2)


def _heads(x, rep: int):
    """(B, S, KH, dh) -> (B, KH * rep, S, dh) float32, each KV head
    repeated ``rep`` times in place (head h reads KV head h // rep)."""
    return x.float().transpose(1, 2).repeat_interleave(rep, dim=1)


def _scale(q, scale: Optional[float]) -> float:
    """The scores' scale: ``scale``, or dh ** -0.5 where it is None."""
    return q.shape[-1] ** -0.5 if scale is None else scale


def _scores(q, k, causal: bool, scale: Optional[float] = None):
    """S * scale, (B, H, Sq, Sk) float32, -1e30 where query i may not see
    key j (``i < j`` under ``causal``, top-left as the kernel)."""
    H = q.shape[2]
    s = _heads(q, 1) @ _heads(k, H // k.shape[2]).transpose(-1, -2) \
        * _scale(q, scale)
    if causal:
        Sq, Sk = s.shape[-2:]
        qi = torch.arange(Sq, device=q.device)[:, None]
        s = s.masked_fill(qi < torch.arange(Sk, device=q.device), -1e30)
    return s


def mha_lse_ref(q, k, v, *, causal: bool = True,
                scale: Optional[float] = None):
    """:func:`mha_ref` (top-left mask) and the row log-sum-exp the kernel
    writes for training: (o (B, Sq, H, dh) in q's dtype, lse (B, H, Sq)
    float32, natural log of the scaled scores' row sums)."""
    lse = torch.logsumexp(_scores(q, k, causal, scale), dim=-1)
    return mha_ref(q, k, v, causal=causal, scale=scale), lse


def mha_bwd_ref(q, k, v, o, do, lse, *, causal: bool = True,
                scale: Optional[float] = None):
    """Plain backward of the flash kernel, in float32.

    q, o, do (B, Sq, H, dh); k, v (B, Sk, KH, dh); lse (B, H, Sq) from the
    forward.  With ``P = exp(S scale - lse)`` (exactly 0 where masked) and
    ``D = rowsum(dO o O)``:
    ``dV = P^T dO``, ``dP = dO V^T``, ``dS = P o (dP - D)``, ``dQ = dS K
    scale``, ``dK = dS^T Q scale``, dK and dV summed over the query heads
    that share a KV head; ``scale`` None is dh ** -0.5.  Returns (dq in
    q's dtype, dk, dv in k's dtype) in the inputs' layouts."""
    B, Sq, H, dh = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    rep, scale = H // KH, _scale(q, scale)
    p = torch.exp(_scores(q, k, causal, scale) - lse[..., None])
    g, qh, kh, vh = _heads(do, 1), _heads(q, 1), _heads(k, rep), \
        _heads(v, rep)
    delta = (g * _heads(o, 1)).sum(-1, keepdim=True)
    dv = p.transpose(-1, -2) @ g
    ds = p * (g @ vh.transpose(-1, -2) - delta)
    dq = ds @ kh * scale
    dk = ds.transpose(-1, -2) @ qh * scale

    def kv_layout(x):
        return x.reshape(B, KH, rep, Sk, dh).sum(2).transpose(1, 2) \
            .to(k.dtype)

    return dq.transpose(1, 2).to(q.dtype), kv_layout(dk), kv_layout(dv)
