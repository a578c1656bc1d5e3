"""Control stage of the all-warp pipeline (port of
``repro.core.pipeline.control``).

Per-warp control flow, vectorized over the warp axis: divergent-branch
bookkeeping on the warp stack (SSY pushes a reconvergence entry, a
divergent BRA pushes the taken path and runs not-taken first — Fig. 2),
EXIT retirement with pending-path resume, block barriers, next-PC
selection, and the cycle/issue counters.

Cycle accounting is the seed's serialized-issue model: each issuing warp
is charged ``rows_per_warp`` (+ memory latency) as if it issued alone, so
every paper timing result is unchanged by the lockstep discipline.
"""
from __future__ import annotations

import torch

from .. import isa
from .state import (FINISHED, WAIT, Counters, MachineConfig, SMState, _pack,
                    _unpack, drop_index, opcode_in)
from .fetch_decode import Decoded
from .read import Operands


def control(cfg: MachineConfig, st: SMState, dec: Decoded, ops: Operands):
    """Returns (pc, alive, active, wstate, stack_addr, stack_type,
    stack_mask, sp, counters) — the post-issue control state."""
    W, D = st.stack_addr.shape
    arange_w = torch.arange(W, device=st.pc.device)
    i32 = torch.int32

    part = dec.active & st.alive & dec.exec_this[:, None]
    # BRA condition comes from the guard LUT; an unguarded BRA is taken by
    # every participating lane.
    taken = torch.where(dec.guarded[:, None], part & ops.cond_val, part)
    ntk = part & ~taken
    any_t = taken.any(1)
    any_n = ntk.any(1)

    is_bra = (dec.op == isa.BRA) & dec.exec_this
    is_ssy = (dec.op == isa.SSY) & dec.exec_this
    diverge = is_bra & any_t & any_n
    uni_taken = is_bra & any_t & ~any_n

    # pushes: SSY pushes (RECONV, reconv_addr, current mask);
    # a divergent BRA pushes (TAKEN, target, taken mask) — not-taken first.
    do_push = diverge | is_ssy
    push_type = torch.where(is_ssy, isa.STACK_RECONV, isa.STACK_TAKEN)
    push_mask = _pack(torch.where(is_ssy[:, None], part, taken))
    slot = dec.sp.clamp(0, D - 1).to(torch.int64)

    def push(stack, val):
        out = stack.clone()
        out[arange_w, slot] = torch.where(do_push, val,
                                          stack[arange_w, slot]).to(i32)
        return out

    stack_addr = push(st.stack_addr, dec.imm)
    stack_type = push(st.stack_type, push_type)
    stack_mask = push(st.stack_mask, push_mask)
    overflow_now = do_push & (dec.sp >= D)
    sp_new = dec.sp + do_push.to(i32)

    # ---- EXIT ------------------------------------------------------------
    is_exit = (dec.op == isa.EXIT) & dec.exec_this
    alive_new = torch.where(is_exit[:, None], st.alive & ~ops.exec_mask,
                            st.alive)
    warp_done = is_exit & ~alive_new.any(1)
    # EXIT with survivors resumes a pending path from the stack
    exit_resume = is_exit & ~warp_done & (sp_new > 0)
    etop = (sp_new - 1).clamp(0, D - 1).to(torch.int64)
    e_addr = stack_addr[arange_w, etop]
    e_type = stack_type[arange_w, etop]
    e_mask = _unpack(stack_mask[arange_w, etop])
    sp_new = (sp_new - exit_resume.to(i32)).to(i32)
    active_new = torch.where(
        exit_resume[:, None], e_mask & alive_new,
        torch.where(diverge[:, None], ntk,
                    torch.where(is_exit[:, None], alive_new, dec.active)))

    # ---- next PC ----------------------------------------------------------
    resume_jump = exit_resume & (e_type == isa.STACK_TAKEN)
    pc_next = torch.where(
        dec.pop_taken, dec.top_addr,
        torch.where(uni_taken, dec.imm,
                    torch.where(resume_jump, e_addr,
                                st.pc.to(torch.int64) + 1)))
    pc = torch.where(dec.issued, pc_next, st.pc)
    pc = torch.where(pc >= 2 ** 31, pc - 2 ** 32, pc).to(i32)
    # BAR: wait at the *next* instruction
    is_bar = (dec.op == isa.BAR) & dec.exec_this
    wstate = torch.where(warp_done, FINISHED,
                         torch.where(is_bar, WAIT, dec.wstate)).to(i32)

    # ---- counters / cycle cost -------------------------------------------
    is_gmem = opcode_in(isa.IS_GMEM_MASK, dec.op)
    is_smem = opcode_in(isa.IS_SMEM_MASK, dec.op)
    exec_cost = (cfg.rows_per_warp
                 + torch.where(is_gmem, cfg.mem_latency_global, 0)
                 + torch.where(is_smem, cfg.mem_latency_shared, 0))
    # a TAKEN pop costs one cycle; non-issued warps are idle
    cost = torch.where(dec.issued,
                       torch.where(dec.exec_this, exec_cost, 1), 0)
    c = st.counters
    op_c, ok = drop_index(torch.where(dec.exec_this, dec.op, isa.NOP),
                          isa.NUM_OPCODES)
    issues = (dec.exec_this & ok).to(i32)
    lanes = torch.where(ok, ops.exec_mask.sum(1), 0).to(i32)
    counters = Counters(
        op_issues=c.op_issues.index_add(0, op_c, issues),
        op_lanes=c.op_lanes.index_add(0, op_c, lanes),
        cycles=(c.cycles + cost.sum()).to(i32),
        stack_ops=(c.stack_ops + (do_push.to(i32) + dec.do_pop.to(i32)
                                  + exit_resume.to(i32)).sum()).to(i32),
        max_sp=torch.maximum(c.max_sp, sp_new.max()),
        overflow=c.overflow | overflow_now.any().to(i32))

    return (pc, alive_new, active_new, wstate, stack_addr, stack_type,
            stack_mask, sp_new, counters)
