"""Read stage of the all-warp pipeline (port of
``repro.core.pipeline.read``).

The parallel source-operand units of §4.2 over the full (W, 32) lane
grid: register-file gathers for up to three source operands per warp
(the third gated by ``num_read_operands``), guard-predicate LUT
evaluation, special-register values for S2R, and the memory read ports
(global and shared loads are issued here so the execute stage is a pure
function of operands).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import isa
from .state import MachineConfig, SMState, clamp_index, take_lanes, wrap32
from .fetch_decode import Decoded


class Operands(NamedTuple):
    """Per-lane operands (each with a leading P axis for a state of P
    blocks)."""
    cond_val: torch.Tensor   # (W, 32) bool — guard LUT output per lane
    exec_mask: torch.Tensor  # (W, 32) bool — lanes that execute
    s1: torch.Tensor         # (W, 32) int32
    s2: torch.Tensor         # (W, 32) int32
    s3: torch.Tensor         # (W, 32) int32
    s2r_val: torch.Tensor    # (W, 32) int32 — selected special register
    gaddr: torch.Tensor      # (W, 32) int64 — clipped global address
    saddr: torch.Tensor      # (W, 32) int64 — clipped shared address
    ld_g: torch.Tensor       # (W, 32) int32 — global load data
    ld_s: torch.Tensor       # (W, 32) int32 — shared load data


def _xy(v, device):
    """An (x, y) pair of ints, or a (..., 2) tensor of them per position ->
    x, y as int64 tensors (..., 1, 1), to broadcast over (W, 32) lanes."""
    t = torch.as_tensor(v, device=device).to(torch.int64)
    return t[..., 0, None, None], t[..., 1, None, None]


def read_operands(cfg: MachineConfig, lut: torch.Tensor,
                  block_dim_xy, block_xy, grid_xy, st: SMState,
                  dec: Decoded) -> Operands:
    """``lut`` is the (16, 16) bool condition table; the three geometry
    arguments are (x, y) pairs of ints for one block, or (P, 2) tensors
    (one row per position) for a state of P blocks."""
    W = st.pc.shape[-1]
    G = st.gmem.shape[-1] - 1
    dev = st.pc.device

    # ---- guard / condition evaluation (predicate LUT of Fig. 2) -------
    nib = take_lanes(st.pred, dec.gpred)                 # (..., W, 32)
    cond_val = lut[clamp_index(dec.gcond, 16)[..., None],
                   clamp_index(nib, 16)]
    gm = torch.where(dec.guarded[..., None], cond_val, True)
    exec_mask = dec.active & st.alive & gm & dec.exec_this[..., None]

    # ---- register-file read ports --------------------------------------
    imm_col = dec.imm[..., None]
    flags = dec.flags[..., None]
    s1 = torch.where((flags & isa.FLAG_SRC1_IMM) != 0, imm_col,
                     take_lanes(st.regs, dec.src1))
    s2 = torch.where((flags & isa.FLAG_SRC2_IMM) != 0, imm_col,
                     take_lanes(st.regs, dec.src2))
    s3 = take_lanes(st.regs, dec.src3) if cfg.num_read_operands >= 3 \
        else torch.zeros_like(s1)

    # ---- special-register values for S2R -------------------------------
    tid_flat = torch.arange(W * isa.WARP_SIZE, dtype=torch.int64,
                            device=dev).reshape(W, isa.WARP_SIZE)
    (bdx, bdy), (bx, by), (gx, gy) = (_xy(v, dev) for v in
                                      (block_dim_xy, block_xy, grid_xy))
    srs = torch.stack(torch.broadcast_tensors(
        tid_flat % bdx, tid_flat // bdx, bx, by, bdx, bdy, gx, gy,
        tid_flat, by * gx + bx, bdx * bdy), -1)          # (..., W, 32, 11)
    sel = dec.imm.clamp(0, srs.shape[-1] - 1).to(torch.int64)
    s2r_val = wrap32(torch.take_along_dim(srs, sel[..., None, None],
                                          dim=-1)[..., 0])

    # ---- memory read ports ----------------------------------------------
    addr = wrap32(s1.to(torch.int64) + imm_col)
    gaddr = addr.clamp(0, G - 1).to(torch.int64)
    saddr = addr.clamp(0, cfg.smem_words - 1).to(torch.int64)

    def load(mem, a):
        return torch.gather(mem, -1, a.flatten(-2)).view(a.shape)

    return Operands(cond_val=cond_val, exec_mask=exec_mask, s1=s1, s2=s2,
                    s3=s3, s2r_val=s2r_val, gaddr=gaddr, saddr=saddr,
                    ld_g=load(st.gmem, gaddr), ld_s=load(st.smem, saddr))
