"""Plain-PyTorch versions of the port's kernels (port of
``repro.kernels.ref``).

``simt_alu_ref`` is the plain version of the CUDA ``simt_alu`` kernel
(and of the datapath inside the fused SM kernel): the CPU path of every
execute backend, and what ``chip_smoke.py`` holds the kernels against on
the card.  Arithmetic is carried in int64 and wrapped to int32, so the
two's-complement overflow of IADD/ISUB/IMUL/IMAD and of the ISETP
difference is exact on every device.
"""
from __future__ import annotations

import torch

from ..core import isa


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """Reduce an int64 tensor modulo 2**32 into int32 two's complement."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def simt_alu_ref(op, s1, s2, s3, cond, s2r, mask, *,
                 enable_mul: bool = True, num_read_operands: int = 3):
    """op (W,) per warp; s1/s2/s3/cond/s2r/mask (W, L) int32.

    Returns (result, isetp nibble), both (W, L) int32 and zero outside
    ``mask``; the nibble is also zero outside ISETP rows."""
    opb = op[:, None]
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
