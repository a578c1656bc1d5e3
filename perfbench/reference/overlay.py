"""Plain reference of the FlexGrip overlay: the one-warp-per-issue
interpreter, in plain PyTorch, written for the benchmark alone.

It imports nothing of the program under test.  The semantics are those
of the paper's single-issue SM (arXiv:1606.06454, section 4) as the
program's seed interpreter states them: each issue picks the next ready
warp round-robin and runs its whole Fetch/Decode/Read/Execute/Write pass;
a warp stack of SSY reconvergence and divergent-branch entries; the
predicate LUT of Fig. 2; a cycle cost of ``32 / n_sp`` rows a warp plus
the memory latencies; blocks run round-robin over ``n_sm`` SMs with a
fixed scheduling overhead a block.

Every block of a batch runs at once, one issue of each block a loop turn
(a leading position axis on every field).  A block that has finished
keeps its state: each write is gated by whether the block is live, so
the loop checks for the end only every ``CHECK_EVERY`` turns.

``run_batch`` returns, for each launch, its final global memory (the
blocks' writes merged in block order), the six counters summed over its
blocks and the cycles of each block, and the cycles of each SM.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

# ---------------------------------------------------------------- the ISA
NOP, EXIT, MOV, IADD, ISUB, IMUL, IMAD, IMIN, IMAX, IABS = range(10)
AND, OR, XOR, NOT, SHL, SHR, SAR, ISETP, ISET, SELP = range(10, 20)
S2R, LDG, STG, LDS, STS, BRA, SSY, BAR = range(20, 28)
NUM_OPCODES = 28
F_OP, F_DST, F_SRC1, F_SRC2, F_SRC3, F_IMM, F_FLAGS, F_GPRED, F_GCOND, \
    F_PDST = range(10)
FLAG_SRC2_IMM, FLAG_SYNC, FLAG_GUARD, FLAG_SRC1_IMM = 1, 2, 4, 8
STACK_RECONV, STACK_TAKEN = 0, 1
WARP_SIZE = 32
READY, WAIT, FINISHED = 0, 1, 2
#: cycles the block scheduler adds to each block on its SM
BLOCK_SCHED_OVERHEAD = 24
#: the opcodes whose result is written to the destination register
WRITES_REG = (MOV, IADD, ISUB, IMIN, IMAX, IABS, AND, OR, XOR, NOT, SHL,
              SHR, SAR, ISET, SELP, S2R, IMUL, IMAD, LDG, LDS)
#: loop turns between two checks for the end of every block (on the
#: card: issues in one CUDA graph)
CHECK_EVERY = 64

COUNTERS = ("op_issues", "op_lanes", "cycles", "stack_ops", "max_sp",
            "overflow")


def cond_lut() -> np.ndarray:
    """(16, 16) bool: [condition code, SZCO nibble] -> the lane's bit."""
    lut = np.zeros((16, 16), dtype=bool)
    for f in range(16):
        s, z, c, o = bool(f & 1), bool(f & 2), bool(f & 4), bool(f & 8)
        lt = s ^ o
        lut[:, f] = [False, lt, z, lt or z, not (lt or z), not z, not lt,
                     True, c, c or z, not (c or z), not c,
                     True, True, True, True]
    return lut


class Machine(NamedTuple):
    """The architecture the configuration states."""
    n_sp: int = 8
    n_regs: int = 16
    warp_stack_depth: int = 32
    enable_mul: bool = True
    num_read_operands: int = 3
    smem_words: int = 4096
    mem_latency_global: int = 8
    mem_latency_shared: int = 2
    max_cycles: int = 4_000_000

    @property
    def rows_per_warp(self) -> int:
        return max(1, WARP_SIZE // self.n_sp)


class Launch(NamedTuple):
    code: np.ndarray            # (C, 10) int32
    grid: tuple                 # (gx, gy)
    block_dim: tuple            # (bdx, bdy)
    gmem: np.ndarray            # (G,) int32


class LaunchResult(NamedTuple):
    gmem: np.ndarray            # final global memory (G,) int32
    cycles_per_block: np.ndarray
    op_issues: np.ndarray       # (NUM_OPCODES,) summed over blocks
    op_lanes: np.ndarray
    stack_ops: int
    max_sp: int
    overflow: bool


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 modulo 2**32 as int32 two's complement."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def _clamp(i: torch.Tensor, n: int) -> torch.Tensor:
    """A plain gather's index: negative wraps once, then clamps."""
    i = torch.where(i < 0, i + n, i)
    return i.clamp(0, n - 1).to(torch.int64)


def _drop(i: torch.Tensor, n: int):
    """A scatter's index: negative wraps once; out of range drops."""
    i = torch.where(i < 0, i + n, i)
    ok = (i >= 0) & (i < n)
    return torch.where(ok, i, 0).to(torch.int64), ok


def _unpack(m: torch.Tensor) -> torch.Tensor:
    lanes = torch.arange(WARP_SIZE, device=m.device)
    return ((m.to(torch.int64)[..., None] >> lanes) & 1) != 0


def _pack(b: torch.Tensor) -> torch.Tensor:
    bits = torch.ones((), dtype=torch.int64, device=b.device) << \
        torch.arange(WARP_SIZE, device=b.device)
    return wrap32(torch.where(b, bits, 0).sum(-1))


def _set_col(x, idx, wr, val):
    """x (P, 32, K): column ``idx`` (P,) set to ``val`` (P, 32) where
    ``wr``; an index out of range drops the write."""
    i, ok = _drop(idx, x.shape[-1])
    i = i[:, None, None].expand(*x.shape[:-1], 1)
    old = torch.gather(x, -1, i)[..., 0]
    return x.scatter(-1, i, torch.where(wr & ok[:, None], val, old)[..., None])


class State:
    """The blocks' state, every field with a leading position axis P."""

    def __init__(self, m: Machine, n_warps: int, block_dim: torch.Tensor,
                 gmem: torch.Tensor):
        dev = gmem.device
        P = gmem.shape[0]
        W, D, R = n_warps, m.warp_stack_depth, m.n_regs
        i32 = dict(dtype=torch.int32, device=dev)
        tid = torch.arange(W * WARP_SIZE, **i32).reshape(W, WARP_SIZE)
        exists = tid < block_dim[:, None, None]
        self.pc = torch.zeros((P, W), **i32)
        self.alive = exists
        self.active = exists.clone()
        self.wstate = torch.where(exists.any(-1), READY, FINISHED).to(
            torch.int32)
        self.stack_addr = torch.zeros((P, W, D), **i32)
        self.stack_type = torch.zeros((P, W, D), **i32)
        self.stack_mask = torch.zeros((P, W, D), **i32)
        self.sp = torch.zeros((P, W), **i32)
        self.pred = torch.zeros((P, W, WARP_SIZE, 4), **i32)
        self.regs = torch.zeros((P, W, WARP_SIZE, R), **i32)
        # one extra word: where lanes that do not store write
        self.smem = torch.zeros((P, m.smem_words + 1), **i32)
        self.gmem = torch.cat([gmem, torch.zeros((P, 1), **i32)], -1)
        self.gw = torch.zeros(self.gmem.shape, dtype=torch.bool, device=dev)
        self.last_warp = torch.full((P,), W - 1, **i32)
        self.op_issues = torch.zeros((P, NUM_OPCODES), **i32)
        self.op_lanes = torch.zeros((P, NUM_OPCODES), **i32)
        self.cycles = torch.zeros((P,), **i32)
        self.stack_ops = torch.zeros((P,), **i32)
        self.max_sp = torch.zeros((P,), **i32)
        self.overflow = torch.zeros((P,), **i32)

    def live(self, m: Machine) -> torch.Tensor:
        return (self.wstate != FINISHED).any(-1) & (self.cycles < m.max_cycles)


def _store(mem, hit, addr, val):
    """In place: ``val`` (P, 32) at ``addr`` where ``hit``; other lanes
    write the spare last word its own value.  Returns the flat indices."""
    n = mem.shape[-1]
    base = torch.arange(mem.shape[0], device=mem.device)[:, None] * n
    idx = (base + torch.where(hit, addr, n - 1)).ravel()
    val = torch.where(hit, val, mem[:, n - 1, None]).ravel()
    mem.view(-1)[idx] = val.to(mem.dtype)
    return idx


def issue(m: Machine, code, lut, slot, writes_reg, geom, st: State) -> None:
    """One issue of one warp in every live block, in place.  ``geom``:
    (bdx, bdy, bx, by, gx, gy), each (P,) int64."""
    P, W = st.pc.shape
    G = st.gmem.shape[-1] - 1
    D = st.stack_addr.shape[-1]
    dev = st.pc.device
    i32, i64 = torch.int32, torch.int64
    pi = torch.arange(P, device=dev)
    live = st.live(m)

    # barrier release, then the round-robin pick of a ready warp
    none_ready = ~(st.wstate == READY).any(-1, keepdim=True)
    wstate = torch.where(none_ready & (st.wstate == WAIT), READY, st.wstate)
    ready = wstate == READY
    order = (st.last_warp[:, None].to(i64) + 1
             + torch.arange(W, device=dev)) % W
    first = torch.take_along_dim(ready, order, 1).to(i32).argmax(
        1, keepdim=True)
    w = torch.take_along_dim(order, first, 1)[:, 0]

    # fetch, decode
    pc_w = st.pc[pi, w]
    ins = code[pi, _clamp(pc_w, code.shape[-2])]
    op, dst, src1, src2, src3, imm, flags, gpred, gcond, pdst = (
        ins[:, f] for f in range(10))
    alive_w, active_w, sp_w = st.alive[pi, w], st.active[pi, w], st.sp[pi, w]

    # reconvergence pop
    top = _clamp((sp_w - 1).clamp(min=0), D)
    top_addr = st.stack_addr[pi, w, top]
    top_type = st.stack_type[pi, w, top]
    top_mask = _unpack(st.stack_mask[pi, w, top])
    do_pop = ((flags & FLAG_SYNC) != 0) & (sp_w > 0)
    pop_taken = do_pop & (top_type == STACK_TAKEN)
    active_w = torch.where(do_pop[:, None], top_mask, active_w)
    sp_w = sp_w - do_pop.to(i32)
    exec_this = ~pop_taken

    # guard through the predicate LUT
    pred_w, regs_w = st.pred[pi, w], st.regs[pi, w]

    def column(x, idx):
        i = _clamp(idx, x.shape[-1])[:, None, None]
        return torch.take_along_dim(x, i, -1)[..., 0]

    cond_val = lut[_clamp(gcond, 16)[:, None],
                   _clamp(column(pred_w, gpred), 16)]
    guarded = (flags & FLAG_GUARD) != 0
    gm = torch.where(guarded[:, None], cond_val, True)
    exec_mask = active_w & alive_w & gm & exec_this[:, None]

    # read
    imm_col = imm[:, None]
    s1 = torch.where((flags[:, None] & FLAG_SRC1_IMM) != 0, imm_col,
                     column(regs_w, src1))
    s2 = torch.where((flags[:, None] & FLAG_SRC2_IMM) != 0, imm_col,
                     column(regs_w, src2))
    s3 = column(regs_w, src3) if m.num_read_operands >= 3 \
        else torch.zeros_like(s1)

    # special registers
    bdx, bdy, bx, by, gx, gy = (g[:, None] for g in geom)
    tid = w[:, None] * WARP_SIZE + torch.arange(WARP_SIZE, device=dev)
    srs = torch.stack(torch.broadcast_tensors(
        tid % bdx, tid // bdx, bx, by, bdx, bdy, gx, gy, tid, by * gx + bx,
        bdx * bdy), -1)
    sel = imm.clamp(0, srs.shape[-1] - 1).to(i64)[:, None, None]
    s2r_val = torch.take_along_dim(srs, sel.expand(P, WARP_SIZE, 1),
                                   -1)[..., 0]

    # execute: every result, then the opcode's
    a, b, c = s1.to(i64), s2.to(i64), s3.to(i64)
    u1, u2, sh = a & 0xFFFFFFFF, b & 0xFFFFFFFF, b & 31
    zero = torch.zeros_like(a)
    mul_lo = a * b if m.enable_mul else zero
    mad = a * b + c if (m.enable_mul and m.num_read_operands >= 3) else zero
    addr = wrap32(a + imm_col)
    gaddr = addr.clamp(0, G - 1).to(i64)
    saddr = addr.clamp(0, m.smem_words - 1).to(i64)
    diff = wrap32(a - b).to(i64)
    nib = ((diff < 0).to(i32) | (diff == 0).to(i32) << 1
           | (u1 < u2).to(i32) << 2
           | (((a ^ b) & (a ^ diff)) < 0).to(i32) << 3)
    values = torch.stack([
        b, a + b, a - b, mul_lo, mad, torch.minimum(a, b),
        torch.maximum(a, b), a.abs(), a & b, a | b, a ^ b, ~a, u1 << sh,
        u1 >> sh, a >> sh, cond_val.to(i64), torch.where(cond_val, a, b),
        s2r_val, st.gmem.gather(1, gaddr).to(i64),
        st.smem.gather(1, saddr).to(i64), zero])
    op_ok = (op >= 0) & (op < NUM_OPCODES)
    sel = torch.where(op_ok, slot[op.clamp(0, NUM_OPCODES - 1)],
                      values.shape[0] - 1)
    result = wrap32(values.gather(0, sel.view(1, P, 1).expand(
        1, P, WARP_SIZE))[0])

    # write back: a block that is no longer live writes nothing
    exec_mask = exec_mask & live[:, None]
    wr = exec_mask & writes_reg[_clamp(op, NUM_OPCODES)][:, None]
    st.regs[pi, w] = _set_col(regs_w, dst, wr, result)
    st.pred[pi, w] = _set_col(pred_w, pdst, exec_mask & (op == ISETP)[:, None],
                              nib)
    st_g = exec_mask & (op == STG)[:, None]
    gidx = _store(st.gmem, st_g, gaddr, s2)
    st.gw.view(-1)[gidx] = st.gw.view(-1)[gidx] | st_g.ravel()
    _store(st.smem, exec_mask & (op == STS)[:, None], saddr, s2)

    # control flow
    part = active_w & alive_w & exec_this[:, None]
    taken = torch.where(guarded[:, None], part & cond_val, part)
    ntk = part & ~taken
    any_t, any_n = taken.any(-1), ntk.any(-1)
    is_bra = (op == BRA) & exec_this
    is_ssy = (op == SSY) & exec_this
    diverge = is_bra & any_t & any_n
    uni_taken = is_bra & any_t & ~any_n
    do_push = diverge | is_ssy
    push_slot = sp_w.clamp(0, D - 1).to(i64)
    push_ok = do_push & live

    def push(stack, val):
        old = stack[pi, w, push_slot]
        stack[pi, w, push_slot] = torch.where(push_ok, val, old).to(i32)

    push(st.stack_addr, imm)
    push(st.stack_type, torch.where(is_ssy, STACK_RECONV, STACK_TAKEN))
    push(st.stack_mask, _pack(torch.where(is_ssy[:, None], part, taken)))
    overflow_now = do_push & (sp_w >= D)
    sp_new = sp_w + do_push.to(i32)

    # exit
    is_exit = (op == EXIT) & exec_this
    alive_new = torch.where(is_exit[:, None], alive_w & ~exec_mask, alive_w)
    warp_done = is_exit & ~alive_new.any(-1)
    exit_resume = is_exit & ~warp_done & (sp_new > 0)
    etop = _clamp((sp_new - 1).clamp(min=0), D)
    e_addr = st.stack_addr[pi, w, etop]
    e_type = st.stack_type[pi, w, etop]
    e_mask = _unpack(st.stack_mask[pi, w, etop])
    sp_new = sp_new - exit_resume.to(i32)
    active_new = torch.where(
        exit_resume[:, None], e_mask & alive_new,
        torch.where(diverge[:, None], ntk,
                    torch.where(is_exit[:, None], alive_new, active_w)))

    # next pc, barrier
    resume_jump = exit_resume & (e_type == STACK_TAKEN)
    pc_next = torch.where(
        pop_taken, top_addr,
        torch.where(uni_taken, imm,
                    torch.where(resume_jump, e_addr,
                                wrap32(pc_w.to(i64) + 1))))
    is_bar = (op == BAR) & exec_this
    wstate_w = torch.where(warp_done, FINISHED,
                           torch.where(is_bar, WAIT, wstate[pi, w]))

    # counters and cycles
    is_gmem = (op == LDG) | (op == STG)
    is_smem = (op == LDS) | (op == STS)
    cost = torch.where(
        exec_this,
        m.rows_per_warp + torch.where(is_gmem, m.mem_latency_global, 0)
        + torch.where(is_smem, m.mem_latency_shared, 0), 1)
    op_c, ok = _drop(torch.where(exec_this, op, NOP), NUM_OPCODES)
    on = live.to(i32)
    st.op_issues.scatter_add_(1, op_c[:, None],
                              ((exec_this & ok).to(i32) * on)[:, None])
    st.op_lanes.scatter_add_(1, op_c[:, None], (torch.where(
        ok, exec_mask.sum(-1), 0).to(i32) * on)[:, None])
    st.cycles += (cost * on).to(i32)
    st.stack_ops += ((do_push.to(i32) + do_pop.to(i32)
                      + exit_resume.to(i32)) * on).to(i32)
    st.max_sp.copy_(torch.where(live, torch.maximum(st.max_sp, sp_new),
                                st.max_sp))
    st.overflow |= (overflow_now & live).to(i32)

    def warp_set(x, val):
        x[pi, w] = torch.where(live.view(-1, *(1,) * (val.dim() - 1)),
                               val.to(x.dtype), x[pi, w])

    # the barrier release is a whole-block write of the warp states
    st.wstate.copy_(torch.where(live[:, None], wstate, st.wstate))
    warp_set(st.pc, pc_next)
    warp_set(st.alive, alive_new)
    warp_set(st.active, active_new)
    warp_set(st.wstate, wstate_w)
    warp_set(st.sp, sp_new)
    st.last_warp.copy_(torch.where(live, w.to(i32), st.last_warp))


def run_blocks(m: Machine, n_warps: int, code: torch.Tensor,
               geom: torch.Tensor, gmem: torch.Tensor) -> State:
    """Run P blocks to their end.  ``code`` (P, C, 10) int32, ``geom``
    (P, 6) (bdx, bdy, bx, by, gx, gy), ``gmem`` (P, G) int32, all on one
    device.  Returns the final state."""
    dev = code.device
    st = State(m, n_warps, geom[:, 0] * geom[:, 1], gmem)
    lut = torch.as_tensor(cond_lut(), device=dev)
    slot_np = np.full(NUM_OPCODES, 20)
    slot_np[[MOV, IADD, ISUB, IMUL, IMAD, IMIN, IMAX, IABS, AND, OR, XOR,
             NOT, SHL, SHR, SAR, ISET, SELP, S2R, LDG, LDS]] = np.arange(20)
    slot = torch.as_tensor(slot_np, device=dev)
    wr_np = np.zeros(NUM_OPCODES, dtype=bool)
    wr_np[list(WRITES_REG)] = True
    writes_reg = torch.as_tensor(wr_np, device=dev)
    g = [geom[:, i].to(torch.int64) for i in range(6)]
    args = (m, code, lut, slot, writes_reg, g, st)
    if dev.type == "cuda":
        # the same issues, replayed CHECK_EVERY at a time from a CUDA
        # graph of plain PyTorch operations (every write is in place)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            issue(*args)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(CHECK_EVERY):
                issue(*args)
        while bool(st.live(m).any()):
            graph.replay()
        return st
    turn = 0
    while True:
        if turn % CHECK_EVERY == 0 and not bool(st.live(m).any()):
            return st
        issue(*args)
        turn += 1


def _positions(grid) -> np.ndarray:
    """(gx * gy, 2) block coordinates, x fastest."""
    gx, gy = grid
    ys, xs = np.divmod(np.arange(gx * gy), gx)
    return np.stack([xs, ys], 1)


def run_batch(m: Machine, launches: Sequence[Launch], n_sm: int,
              device="cpu"):
    """Run every block of ``launches`` (one batch of the scheduler: block
    positions in launch order, position p on SM ``p % n_sm``).  Returns
    (list of :class:`LaunchResult`, per-SM cycles (n_sm,) int64)."""
    n_warps = max(-(-int(np.prod(l.block_dim)) // WARP_SIZE)
                  for l in launches)
    C = max(len(l.code) for l in launches)
    G = max(len(l.gmem) for l in launches)
    codes, geoms, mems, owner = [], [], [], []
    for i, l in enumerate(launches):
        xy = _positions(l.grid)
        code = np.zeros((C, 10), np.int32)
        code[:len(l.code)] = l.code
        code[len(l.code):, F_OP] = EXIT
        mem = np.zeros(G, np.int32)
        mem[:len(l.gmem)] = l.gmem
        for bx, by in xy:
            codes.append(code)
            geoms.append((*l.block_dim, bx, by, *l.grid))
            mems.append(mem)
            owner.append(i)
    dev = torch.device(device)
    st = run_blocks(m, n_warps,
                    torch.as_tensor(np.stack(codes), device=dev),
                    torch.as_tensor(np.array(geoms, np.int64), device=dev),
                    torch.as_tensor(np.stack(mems), device=dev))
    owner = np.array(owner)
    cyc = st.cycles.cpu().numpy().astype(np.int64)
    per_sm = np.bincount(np.arange(len(owner)) % n_sm,
                         weights=cyc + BLOCK_SCHED_OVERHEAD,
                         minlength=n_sm).astype(np.int64)
    host = {k: getattr(st, k).cpu().numpy().astype(np.int64)
            for k in COUNTERS}
    out = []
    for i, l in enumerate(launches):
        ps = np.flatnonzero(owner == i)
        mem = torch.as_tensor(np.asarray(l.gmem, np.int32), device=dev)
        for p in ps:                      # block order: later blocks win
            wrt = st.gw[p, :len(l.gmem)]
            mem = torch.where(wrt, st.gmem[p, :len(l.gmem)], mem)
        out.append(LaunchResult(
            gmem=mem.cpu().numpy(), cycles_per_block=cyc[ps],
            op_issues=host["op_issues"][ps].sum(0),
            op_lanes=host["op_lanes"][ps].sum(0),
            stack_ops=int(host["stack_ops"][ps].sum()),
            max_sp=int(host["max_sp"][ps].max()),
            overflow=bool(host["overflow"][ps].any())))
    return out, per_sm


def mismatches(got: Sequence, got_sm: np.ndarray, want: Sequence,
               want_sm: np.ndarray) -> Dict[str, int]:
    """Count what differs between two batches' results: gmem words, each
    counter (opcode entries, blocks' cycles, scalars) and SM cycles."""
    out = {"gmem_words": 0, "counters": 0, "sm_cycles": 0}
    for g, w in zip(got, want):
        out["gmem_words"] += int((np.asarray(g.gmem) != w.gmem).sum())
        out["counters"] += int(
            (np.asarray(g.op_issues) != w.op_issues).sum()
            + (np.asarray(g.op_lanes) != w.op_lanes).sum()
            + (np.asarray(g.cycles_per_block) != w.cycles_per_block).sum()
            + (int(g.stack_ops) != w.stack_ops) + (int(g.max_sp) != w.max_sp)
            + (bool(g.overflow) != w.overflow))
    out["sm_cycles"] = int((np.asarray(got_sm) != want_sm).sum())
    if len(got) != len(want):
        out["gmem_words"] += 1
    return out


def issues(results: List[LaunchResult]) -> int:
    """Simulated warp-instruction issues of a batch."""
    return int(sum(int(r.op_issues.sum()) for r in results))
