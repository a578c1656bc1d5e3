"""Fetch/Decode stage of the all-warp pipeline (port of
``repro.core.pipeline.fetch_decode``).

One lockstep step fetches the instruction at every warp's PC in a single
gather from the program tensor and decodes all field slots as (W,)
vectors.  Barrier release is folded in front of the fetch: when no warp
is READY, every BAR-waiting warp wakes in the same step.  The ``.S``
reconvergence pop (paper §4.1 / Fig. 2) is part of decode: a popped TAKEN
entry redirects the warp and suppresses execution for this issue; a
popped RECONV entry restores the pre-divergence mask and executes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import isa
from .state import READY, WAIT, SMState, _unpack, clamp_index


class Decoded(NamedTuple):
    """Per-warp decoded issue bundle; every field is a (W,) vector except
    the (W, 32) ``active`` lane mask updated by the sync pop (each with a
    leading P axis for a state of P blocks)."""
    issued: torch.Tensor      # (W,) bool — warp issues this step
    wstate: torch.Tensor      # (W,) int32 — after barrier release
    op: torch.Tensor
    dst: torch.Tensor
    src1: torch.Tensor
    src2: torch.Tensor
    src3: torch.Tensor
    imm: torch.Tensor
    flags: torch.Tensor
    gpred: torch.Tensor
    gcond: torch.Tensor
    pdst: torch.Tensor
    guarded: torch.Tensor     # (W,) bool
    active: torch.Tensor      # (W, 32) bool — after reconvergence pop
    sp: torch.Tensor          # (W,) int32 — after reconvergence pop
    exec_this: torch.Tensor   # (W,) bool — instruction actually executes
    pop_taken: torch.Tensor   # (W,) bool — TAKEN pop consumed the issue
    do_pop: torch.Tensor      # (W,) bool
    top_addr: torch.Tensor    # (W,) int32 — popped entry's address


def fetch_decode(code: torch.Tensor, st: SMState) -> Decoded:
    """``code`` (C, NUM_FIELDS) for one block, or (P, C, NUM_FIELDS), each
    position's own program, for a state of P blocks."""
    D = st.stack_addr.shape[-1]

    # ---- barrier release: if nothing is ready, wake all BAR waiters
    none_ready = ~(st.wstate == READY).any(-1, keepdim=True)
    wstate = torch.where(none_ready & (st.wstate == WAIT), READY,
                         st.wstate).to(torch.int32)
    issued = wstate == READY

    # ---- Fetch: one clamped gather for every warp's PC
    pc = clamp_index(st.pc, code.shape[-2])[..., None]
    instr = torch.take_along_dim(code, pc, dim=-2)      # (..., W, FIELDS)
    op = instr[..., isa.F_OP]
    flags = instr[..., isa.F_FLAGS]

    # ---- reconvergence-point pop (.S), §4.1 / Fig. 2 ------------------
    top = clamp_index(torch.clamp(st.sp - 1, min=0), D)[..., None]

    def at_top(stack):
        return torch.take_along_dim(stack, top, dim=-1)[..., 0]

    top_addr = at_top(st.stack_addr)
    top_type = at_top(st.stack_type)
    top_mask = _unpack(at_top(st.stack_mask))           # (..., W, 32)
    do_pop = issued & ((flags & isa.FLAG_SYNC) != 0) & (st.sp > 0)
    pop_taken = do_pop & (top_type == isa.STACK_TAKEN)
    active = torch.where(do_pop[..., None], top_mask, st.active)
    sp = (st.sp - do_pop.to(torch.int32)).to(torch.int32)
    exec_this = issued & ~pop_taken

    return Decoded(
        issued=issued, wstate=wstate, op=op,
        dst=instr[..., isa.F_DST], src1=instr[..., isa.F_SRC1],
        src2=instr[..., isa.F_SRC2], src3=instr[..., isa.F_SRC3],
        imm=instr[..., isa.F_IMM], flags=flags,
        gpred=instr[..., isa.F_GPRED], gcond=instr[..., isa.F_GCOND],
        pdst=instr[..., isa.F_PDST],
        guarded=(flags & isa.FLAG_GUARD) != 0,
        active=active, sp=sp, exec_this=exec_this, pop_taken=pop_taken,
        do_pop=do_pop, top_addr=top_addr)
