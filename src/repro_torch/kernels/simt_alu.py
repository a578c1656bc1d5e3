"""The execute-stage kernel ``simt_alu`` (port of
``repro.kernels.simt_alu.simt_alu``).

Replaces the Pallas VPU kernel ``simt_alu`` (``repro/kernels/simt_alu.py``,
body ``_alu_kernel``, datapath ``alu_datapath``): one decoded integer
instruction per warp applied across that warp's lanes under the active
mask, plus the ISETP sign/zero/carry/overflow nibble of ``s1 - s2``.

On the card it is ``csrc/simt_alu.cu``: one thread per lane, the opcode
read per warp row, the datapath shared with the fused SM kernel through
``csrc/alu_datapath.cuh``.  ``enable_mul`` and ``num_read_operands`` are
template parameters, so a variant without the multiplier or the third
read port has no multiply in its code, as in the paper's §4.2.  The TPU
kernel's (8, 128) padding is gone: lanes are read where they lie.  The
kernel is bound by memory traffic (seven int32 inputs and two outputs per
lane, a few integer operations each).

CPU tensors take the plain version
:func:`repro_torch.kernels.ref.simt_alu_ref`; CUDA tensors launch the
kernel or raise.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import simt_alu_ref


def simt_alu(op, s1, s2, s3, cond, s2r, mask, *, enable_mul: bool = True,
             num_read_operands: int = 3):
    """op (W,) int32; s1/s2/s3/cond/s2r/mask (W, L) int32.

    Returns (result, isetp nibble), both (W, L) int32, zero outside
    ``mask``."""
    if not s1.is_cuda:
        return simt_alu_ref(op, s1, s2, s3, cond, s2r, mask,
                            enable_mul=enable_mul,
                            num_read_operands=num_read_operands)
    lanes = (s1, s2, s3, cond, s2r, mask)
    W, L = s1.shape
    if op.shape != (W,) or any(x.shape != (W, L) for x in lanes):
        raise ValueError(f"simt_alu: op must be ({W},) and every lane "
                         f"operand ({W}, {L})")
    if any(x.dtype != torch.int32 or x.device != s1.device
           for x in (op,) + lanes):
        raise ValueError("simt_alu: every input must be int32 on one device")
    op, *lanes = (x.contiguous() for x in (op,) + lanes)
    out = torch.empty((W, L), dtype=torch.int32, device=s1.device)
    nib = torch.empty_like(out)
    if out.numel() == 0:
        return out, nib
    lib = _build.load()
    rc = lib.simt_alu_launch(
        op.data_ptr(), *(x.data_ptr() for x in lanes), out.data_ptr(),
        nib.data_ptr(), W, L, int(enable_mul),
        3 if num_read_operands >= 3 else 2, _build.stream_ptr(s1))
    _build.check(rc, "simt_alu")
    _build.LAUNCHES["simt_alu"] += 1
    return out, nib
