"""The execute-stage kernel ``simt_alu`` (port of
``repro.kernels.simt_alu.simt_alu``).

Replaces the Pallas VPU kernel ``simt_alu`` (``repro/kernels/simt_alu.py``,
body ``_alu_kernel``, datapath ``alu_datapath``): one decoded integer
instruction per warp row applied across that row's lanes under the active
mask, plus the ISETP sign/zero/carry/overflow nibble of ``s1 - s2``.
Under the JAX executor's ``vmap`` the Pallas kernel sees (P, W, 32); here
any leading dimensions fold into the rows of one launch, so the staged
pipeline makes one call a step for a whole dispatch group.

On the card it is ``csrc/simt_alu.cu``, bound by memory traffic (six int32
operands in and two out a lane, no word used twice), with the datapath
shared with the fused SM kernel through ``csrc/alu_datapath.cuh``; one
thread a lane.  ``enable_mul`` and ``num_read_operands`` are template
parameters, so a variant without the multiplier or the third read port has
no multiply in its code, as in the paper's §4.2.  The TPU kernel's (8, 128)
padding is gone: lanes are read where they lie.

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
    """op (..., W) int32; s1/s2/s3/cond/s2r/mask (..., W, L) int32, any
    leading dimensions.

    Returns (result, isetp nibble), both (..., W, L) int32, zero outside
    ``mask``."""
    if not s1.is_cuda:
        return simt_alu_ref(op, s1, s2, s3, cond, s2r, mask,
                            enable_mul=enable_mul,
                            num_read_operands=num_read_operands)
    shape = s1.shape
    if (op.shape != shape[:-1] or (s2.shape, s3.shape, cond.shape,
                                   s2r.shape, mask.shape) != (shape,) * 5):
        raise ValueError(f"simt_alu: op must be {tuple(shape[:-1])} and "
                         f"every lane operand {tuple(shape)}")
    ins = (op.contiguous(), s1.contiguous(), s2.contiguous(),
           s3.contiguous(), cond.contiguous(), s2r.contiguous(),
           mask.contiguous())
    dev = s1.get_device()
    if {(x.dtype, x.get_device()) for x in ins} != {(torch.int32, dev)}:
        raise ValueError("simt_alu: every input must be int32 on one device")
    # one allocation: the results, then the nibbles
    both = s1.new_empty((2, *shape))
    if both.numel() == 0:
        return torch.unbind(both)
    L = shape[-1]
    lib = _build.load()
    rc = lib.simt_alu_launch(
        *(x.data_ptr() for x in ins), both.data_ptr(), s1.numel() // L, L,
        int(enable_mul), 3 if num_read_operands >= 3 else 2,
        _build.stream_ptr(s1))
    _build.check(rc, "simt_alu")
    _build.LAUNCHES["simt_alu"] += 1
    return torch.unbind(both)
