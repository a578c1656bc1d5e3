"""The seed one-warp-per-issue interpreter (port of
``repro.core.pipeline.reference``), ``execute_backend="reference"``.

Each call of :func:`issue_one_warp` performs ONE scheduler issue: the
round-robin pick of a single ready warp and its full Fetch/Decode/Read/
Execute/Write pass, with an ALU of its own.  It is the semantic oracle the
lockstep all-warp pipeline and the fused kernel are held to (same final
gmem, same per-opcode issue/lane counters, same cycles), and the faithful
model of the paper's single-issue-path SM.

It is rank-generic over a leading position axis, as the stages are: a
state of P blocks (:func:`init_state` with a (P, G) gmem) issues one warp
of every position per call, so :func:`block_loop` and
:func:`fused.staged_run` run a whole dispatch group through it, one issue
per position per loop turn.

Index semantics are the JAX package's (see :mod:`.state`): the plain
gathers here (code fetch, stack reads, register, predicate and LUT reads,
the ``WRITES_REG`` table) clamp, and the ``.at[]`` scatters (register,
predicate and counter writes) drop an out-of-range index.  One difference,
in a case with no defined result: lanes that do not store to shared memory
write the spare sentinel word ``smem_words``, where the JAX interpreter has
them rewrite word ``smem_words - 1`` with its old value, which races with a
real store to that word in the same issue.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import isa
from ...kernels.ref import wrap32
from .state import (FINISHED, READY, WAIT, Counters, MachineConfig, SMState,
                    _pack, _unpack, clamp_index, drop_index)
from .write import _set_column, _store

#: the ALU's results in the order of :data:`_ALU_OPS`; any other opcode
#: gives 0, the extra last slot
_ALU_OPS = (isa.MOV, isa.IADD, isa.ISUB, isa.IMUL, isa.IMAD, isa.IMIN,
            isa.IMAX, isa.IABS, isa.AND, isa.OR, isa.XOR, isa.NOT, isa.SHL,
            isa.SHR, isa.SAR, isa.ISET, isa.SELP, isa.S2R, isa.LDG, isa.LDS)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """(opcode -> ALU slot, ``WRITES_REG``), each (NUM_OPCODES,), on
    ``device`` once, not copied from the host every issue."""
    slot = np.full(isa.NUM_OPCODES, len(_ALU_OPS))
    slot[list(_ALU_OPS)] = np.arange(len(_ALU_OPS))
    return (torch.as_tensor(slot, device=device),
            torch.as_tensor(isa.WRITES_REG, device=device))


def issue_one_warp(cfg: MachineConfig, code: torch.Tensor,
                   lut: torch.Tensor, block_dim_xy, block_xy, grid_xy,
                   st: SMState) -> SMState:
    """One scheduler issue — the whole 5-stage pipeline for one warp.  For
    one block the geometry arguments are (x, y) pairs and ``code`` is
    (C, NUM_FIELDS); for a state of P blocks they are (P, 2) tensors and
    (P, C, NUM_FIELDS), and every position issues one warp."""
    if st.pc.dim() == 1:                     # one block: a position axis of 1
        nxt = issue_one_warp(cfg, code[None], lut, block_dim_xy, block_xy,
                             grid_xy, _lead(st, lambda x: x[None]))
        return _lead(nxt, lambda x: x[0])
    P, W = st.pc.shape
    G = st.gmem.shape[-1] - 1
    D = st.stack_addr.shape[-1]
    dev = st.pc.device
    i32, i64 = torch.int32, torch.int64
    pi = torch.arange(P, device=dev)

    # ---- barrier release: if nothing is ready, wake all BAR waiters
    none_ready = ~(st.wstate == READY).any(-1, keepdim=True)
    wstate = torch.where(none_ready & (st.wstate == WAIT), READY,
                         st.wstate).to(i32)
    ready = wstate == READY

    # ---- warp scheduler: round-robin pick of the next ready warp
    order = (st.last_warp[:, None].to(i64) + 1
             + torch.arange(W, device=dev)) % W               # (P, W)
    first = torch.take_along_dim(ready, order, 1).to(i32).argmax(
        1, keepdim=True)
    w = torch.take_along_dim(order, first, 1)[:, 0]            # (P,)

    # ---- Fetch / Decode
    pc_w = st.pc[pi, w]
    instr = code[pi, clamp_index(pc_w, code.shape[-2])]       # (P, FIELDS)
    op, dst, src1, src2, src3, imm, flags, gpred, gcond, pdst = (
        instr[:, f] for f in (isa.F_OP, isa.F_DST, isa.F_SRC1, isa.F_SRC2,
                              isa.F_SRC3, isa.F_IMM, isa.F_FLAGS,
                              isa.F_GPRED, isa.F_GCOND, isa.F_PDST))
    alive_w, active_w, sp_w = st.alive[pi, w], st.active[pi, w], st.sp[pi, w]

    # ---- reconvergence-point pop (.S), §4.1 / Fig. 2 ------------------
    top = clamp_index((sp_w - 1).clamp(min=0), D)
    top_addr = st.stack_addr[pi, w, top]
    top_type = st.stack_type[pi, w, top]
    top_mask = _unpack(st.stack_mask[pi, w, top])
    do_pop = ((flags & isa.FLAG_SYNC) != 0) & (sp_w > 0)
    pop_taken = do_pop & (top_type == isa.STACK_TAKEN)
    # TAKEN pop: jump to the stored taken address with the stored mask and
    # spend this cycle on the jump.  RECONV pop: restore the pre-divergence
    # mask and execute this instruction in the same issue.
    active_w = torch.where(do_pop[:, None], top_mask, active_w)
    sp_w = (sp_w - do_pop.to(i32)).to(i32)
    exec_this = ~pop_taken

    # ---- guard / condition evaluation (predicate LUT of Fig. 2) -------
    pred_w, regs_w = st.pred[pi, w], st.regs[pi, w]   # (P, 32, 4), (P, 32, R)

    def column(x, idx):                      # plain gather: clamped index
        i = clamp_index(idx, x.shape[-1])[:, None, None]
        return torch.take_along_dim(x, i, -1)[..., 0]

    cond_val = lut[clamp_index(gcond, 16)[:, None],
                   clamp_index(column(pred_w, gpred), 16)]    # (P, 32)
    guarded = (flags & isa.FLAG_GUARD) != 0
    gm = torch.where(guarded[:, None], cond_val, True)
    exec_mask = active_w & alive_w & gm & exec_this[:, None]

    # ---- Read stage: parallel source-operand units (§4.2) -------------
    imm_col = imm[:, None]
    s1 = torch.where((flags[:, None] & isa.FLAG_SRC1_IMM) != 0, imm_col,
                     column(regs_w, src1))
    s2 = torch.where((flags[:, None] & isa.FLAG_SRC2_IMM) != 0, imm_col,
                     column(regs_w, src2))
    s3 = column(regs_w, src3) if cfg.num_read_operands >= 3 \
        else torch.zeros_like(s1)

    # ---- special-register values for S2R -------------------------------
    tid = w[:, None] * isa.WARP_SIZE + torch.arange(isa.WARP_SIZE,
                                                    device=dev)
    (bdx, bdy), (bx, by), (gx, gy) = (
        torch.as_tensor(v, device=dev).to(i64).reshape(-1, 2).unbind(-1)
        for v in (block_dim_xy, block_xy, grid_xy))
    bdx, bdy, bx, by, gx, gy = (v[:, None] for v in (bdx, bdy, bx, by, gx,
                                                     gy))
    srs = torch.stack(torch.broadcast_tensors(
        tid % bdx, tid // bdx, bx, by, bdx, bdy, gx, gy, tid, by * gx + bx,
        bdx * bdy), -1)                                        # (P, 32, 11)
    sel = imm.clamp(0, srs.shape[-1] - 1).to(i64)[:, None, None]
    s2r_val = torch.take_along_dim(srs, sel.expand(P, isa.WARP_SIZE, 1),
                                   -1)[..., 0]

    # ---- Execute stage: the vector ALU (compute all, select by opcode) --
    a, b, c = s1.to(i64), s2.to(i64), s3.to(i64)
    u1, u2, sh = a & 0xFFFFFFFF, b & 0xFFFFFFFF, b & 31
    zero = torch.zeros_like(a)
    mul_lo = a * b if cfg.enable_mul else zero
    mad = a * b + c if (cfg.enable_mul and cfg.num_read_operands >= 3) \
        else zero
    addr = wrap32(a + imm_col)                                 # memory address
    gaddr = addr.clamp(0, G - 1).to(i64)
    saddr = addr.clamp(0, cfg.smem_words - 1).to(i64)

    # ISETP flags of (s1 - s2): sign, zero, carry(borrow), overflow
    diff = wrap32(a - b).to(i64)
    nib_new = ((diff < 0).to(i32) | (diff == 0).to(i32) << 1
               | (u1 < u2).to(i32) << 2
               | (((a ^ b) & (a ^ diff)) < 0).to(i32) << 3)
    values = torch.stack([                       # in the order of _ALU_OPS
        b, a + b, a - b, mul_lo, mad, torch.minimum(a, b),
        torch.maximum(a, b), a.abs(), a & b, a | b, a ^ b, ~a, u1 << sh,
        u1 >> sh, a >> sh, cond_val.to(i64), torch.where(cond_val, a, b),
        s2r_val, st.gmem.gather(1, gaddr).to(i64),
        st.smem.gather(1, saddr).to(i64), zero])  # (21, P, 32)
    alu_slot, writes_reg = _tables(dev)
    op_ok = (op >= 0) & (op < isa.NUM_OPCODES)
    sel = torch.where(op_ok, alu_slot[op.clamp(0, isa.NUM_OPCODES - 1)],
                      len(_ALU_OPS))
    result = wrap32(values.gather(0, sel.view(1, P, 1).expand(
        1, P, isa.WARP_SIZE))[0])

    # ---- Write stage ----------------------------------------------------
    wr = exec_mask & writes_reg[clamp_index(op, isa.NUM_OPCODES)][:, None]
    regs = st.regs.clone()
    regs[pi, w] = _set_column(regs_w, dst, wr, result)
    pred = st.pred.clone()
    pred[pi, w] = _set_column(pred_w, pdst, exec_mask & (op == isa.ISETP)
                              [:, None], nib_new)

    # global / shared stores (inactive lanes write the sentinel word)
    st_g = exec_mask & (op == isa.STG)[:, None]
    gmem, gidx = _store(st.gmem, st_g[:, None], gaddr[:, None], s2[:, None])
    gw = st.gw.clone()
    gw.view(-1)[gidx] = st.gw.view(-1)[gidx] | st_g.ravel()
    st_s = exec_mask & (op == isa.STS)[:, None]
    smem, _ = _store(st.smem, st_s[:, None], saddr[:, None], s2[:, None])

    # ---- control flow ----------------------------------------------------
    part = active_w & alive_w & exec_this[:, None]  # lanes in a BRA
    # BRA condition comes from the guard LUT; an unguarded BRA is taken by
    # every participating lane.
    taken = torch.where(guarded[:, None], part & cond_val, part)
    ntk = part & ~taken
    any_t, any_n = taken.any(-1), ntk.any(-1)
    is_bra = (op == isa.BRA) & exec_this
    is_ssy = (op == isa.SSY) & exec_this
    diverge = is_bra & any_t & any_n
    uni_taken = is_bra & any_t & ~any_n

    # pushes: SSY pushes (RECONV, reconv_addr, current mask);
    # a divergent BRA pushes (TAKEN, target, taken mask) — not-taken first.
    do_push = diverge | is_ssy
    slot = sp_w.clamp(0, D - 1).to(i64)

    def push(stack, val):
        out = stack.clone()
        out[pi, w, slot] = torch.where(do_push, val, stack[pi, w, slot]
                                       ).to(i32)
        return out

    stack_addr = push(st.stack_addr, imm)
    stack_type = push(st.stack_type, torch.where(
        is_ssy, isa.STACK_RECONV, isa.STACK_TAKEN))
    stack_mask = push(st.stack_mask, _pack(torch.where(
        is_ssy[:, None], part, taken)))
    overflow_now = do_push & (sp_w >= D)
    sp_new = sp_w + do_push.to(i32)

    # ---- EXIT ------------------------------------------------------------
    is_exit = (op == isa.EXIT) & exec_this
    alive_new = torch.where(is_exit[:, None], alive_w & ~exec_mask, alive_w)
    warp_done = is_exit & ~alive_new.any(-1)
    # EXIT with survivors resumes a pending path from the stack
    exit_resume = is_exit & ~warp_done & (sp_new > 0)
    etop = clamp_index((sp_new - 1).clamp(min=0), D)
    e_addr = stack_addr[pi, w, etop]
    e_type = stack_type[pi, w, etop]
    e_mask = _unpack(stack_mask[pi, w, etop])
    sp_new = (sp_new - exit_resume.to(i32)).to(i32)
    active_new = torch.where(
        exit_resume[:, None], e_mask & alive_new,
        torch.where(diverge[:, None], ntk,
                    torch.where(is_exit[:, None], alive_new, active_w)))

    # ---- next PC ----------------------------------------------------------
    resume_jump = exit_resume & (e_type == isa.STACK_TAKEN)
    pc_next = torch.where(
        pop_taken, top_addr,
        torch.where(uni_taken, imm,
                    torch.where(resume_jump, e_addr,
                                wrap32(pc_w.to(i64) + 1))))
    # BAR: wait at the *next* instruction
    is_bar = (op == isa.BAR) & exec_this
    wstate_w = torch.where(warp_done, FINISHED,
                           torch.where(is_bar, WAIT, wstate[pi, w]))

    # ---- counters / cycle cost -------------------------------------------
    is_gmem = (op == isa.LDG) | (op == isa.STG)
    is_smem = (op == isa.LDS) | (op == isa.STS)
    cost = torch.where(
        exec_this,
        cfg.rows_per_warp
        + torch.where(is_gmem, cfg.mem_latency_global, 0)
        + torch.where(is_smem, cfg.mem_latency_shared, 0),
        1)                                   # a TAKEN pop costs one cycle
    ctr = st.counters
    op_c, ok = drop_index(torch.where(exec_this, op, isa.NOP),
                          isa.NUM_OPCODES)
    counters = Counters(
        op_issues=ctr.op_issues.scatter_add(
            1, op_c[:, None], (exec_this & ok).to(i32)[:, None]),
        op_lanes=ctr.op_lanes.scatter_add(
            1, op_c[:, None],
            torch.where(ok, exec_mask.sum(-1), 0).to(i32)[:, None]),
        cycles=(ctr.cycles + cost).to(i32),
        stack_ops=(ctr.stack_ops + do_push.to(i32) + do_pop.to(i32)
                   + exit_resume.to(i32)).to(i32),
        max_sp=torch.maximum(ctr.max_sp, sp_new),
        overflow=ctr.overflow | overflow_now.to(i32))

    def warp_set(x, val):
        out = x.clone()
        out[pi, w] = val.to(x.dtype)
        return out

    return SMState(
        pc=warp_set(st.pc, pc_next), alive=warp_set(st.alive, alive_new),
        active=warp_set(st.active, active_new),
        wstate=warp_set(wstate, wstate_w),
        stack_addr=stack_addr, stack_type=stack_type, stack_mask=stack_mask,
        sp=warp_set(st.sp, sp_new), pred=pred, regs=regs, smem=smem,
        gmem=gmem, gw=gw, last_warp=w.to(i32), counters=counters)


def _lead(st: SMState, fn) -> SMState:
    """``fn`` applied to every field and counter of ``st``."""
    return SMState(*map(fn, st[:-1]), counters=Counters(*map(fn,
                                                             st.counters)))
