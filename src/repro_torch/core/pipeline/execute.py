"""Execute stage of the all-warp pipeline — the pluggable SP array (port of
``repro.core.pipeline.execute``).

A backend is a pure function of decoded operands: the per-warp opcode
vector plus the pre-gathered (W, 32) lane operands in, the ALU result and
the ISETP flag nibble for every lane out.

* ``"torch"`` — :func:`repro_torch.kernels.ref.simt_alu_ref`, plain torch
  on any device;
* ``"cuda"``  — the CUDA :func:`repro_torch.kernels.simt_alu.simt_alu`
  kernel; on CPU tensors it runs the same plain version.

``"cuda_fused"`` runs whole blocks in one kernel (:mod:`.fused`); on CPU
it runs this staged pipeline with the ``"cuda"`` execute stage.  Memory
loads are not part of the backend contract: LDG/LDS data comes from the
Read stage and merges here by opcode.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import isa
from ...kernels.ref import simt_alu_ref
from ...kernels.simt_alu import simt_alu
from .state import MachineConfig
from .fetch_decode import Decoded
from .read import Operands


def execute(cfg: MachineConfig, dec: Decoded,
            ops: Operands) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the configured backend and merge the memory read ports."""
    alu = simt_alu_ref if cfg.execute_backend == "torch" else simt_alu
    result, nib = alu(
        dec.op, ops.s1, ops.s2, ops.s3, ops.cond_val.to(torch.int32),
        ops.s2r_val, ops.exec_mask.to(torch.int32),
        enable_mul=cfg.enable_mul, num_read_operands=cfg.num_read_operands)
    opb = dec.op[:, None]
    result = torch.where(opb == isa.LDG, ops.ld_g,
                         torch.where(opb == isa.LDS, ops.ld_s, result))
    return result, nib
