"""Reference interpreters (port of ``repro.core.microblaze``; numpy, a
copy with its imports pointed at the port).

Two roles, mirroring the paper's experimental setup:

* :class:`RefMachine` — a pure-numpy, Python-control-flow port of the SM
  semantics in :mod:`machine`.  It is the *oracle* for property tests:
  every backend of the interpreter must agree with it bit-for-bit on any
  program.

* :func:`scalar_cycles` — the **MicroBlaze model**: the paper benchmarks
  FlexGrip against a MicroBlaze soft core at the same clock running C
  versions of the kernels.  The equivalent scalar machine executes every
  dynamic (thread, instruction) pair sequentially; we derive its cycle
  count from the SIMT run's per-opcode active-lane counters, so the
  scalar baseline is exact for the same dynamic path without a
  prohibitively slow simulation.  SIMT-only artifacts (SSY/BAR) are
  excluded from scalar work; a per-instruction fetch/decode overhead is
  charged because the scalar core fetches per thread-instruction whereas
  the SM fetches once per 32-lane warp — the instruction-memory
  amortization the paper credits for FlexGrip's energy advantage.
"""
from __future__ import annotations

import numpy as np

from . import isa
from .machine import MachineConfig, READY, WAIT, FINISHED


def _cond(lut, cond, nib):
    return bool(lut[cond, nib])


class RefMachine:
    """Scalar-semantics reference for one thread block (numpy, slow)."""

    def __init__(self, code: np.ndarray, block_dim, block_xy, grid_xy,
                 gmem: np.ndarray, cfg: MachineConfig = MachineConfig()):
        if isinstance(block_dim, tuple):
            self.bdx, self.bdy = block_dim
        else:
            self.bdx, self.bdy = block_dim, 1
        bd = self.bdx * self.bdy
        self.cfg = cfg
        self.code = np.asarray(code, np.int64)
        self.W = -(-bd // isa.WARP_SIZE)
        self.block_xy = block_xy
        self.grid_xy = grid_xy
        self.pc = np.zeros(self.W, np.int64)
        tid = np.arange(self.W * 32).reshape(self.W, 32)
        self.alive = tid < bd
        self.active = self.alive.copy()
        self.wstate = np.where(self.alive.any(1), READY, FINISHED)
        self.stack = [[] for _ in range(self.W)]  # list of (addr, typ, mask)
        self.pred = np.zeros((self.W, 32, 4), np.int64)
        self.regs = np.zeros((self.W, 32, cfg.n_regs), np.int64)
        self.smem = np.zeros(cfg.smem_words, np.int64)
        self.gmem = np.asarray(gmem, np.int64).copy()
        self.gw = np.zeros(gmem.shape[0], bool)
        self.lut = isa.COND_LUT
        self.last = self.W - 1
        self.cycles = 0
        self.max_sp = 0
        self.issues = 0

    @staticmethod
    def _i32(x):
        return ((np.asarray(x, np.int64) + 2**31) % 2**32) - 2**31

    def _srval(self, w, lane, sel):
        tid = w * 32 + lane
        bx, by = self.block_xy
        gx, gy = self.grid_xy
        vals = [tid % self.bdx, tid // self.bdx, bx, by, self.bdx, self.bdy,
                gx, gy, tid, by * gx + bx, self.bdx * self.bdy]
        return vals[max(0, min(sel, len(vals) - 1))]

    def step(self) -> bool:
        """One scheduler issue; returns False when the block is done."""
        if not (self.wstate != FINISHED).any():
            return False
        ready = self.wstate == READY
        if not ready.any():
            self.wstate[self.wstate == WAIT] = READY
            ready = self.wstate == READY
        w = next((self.last + 1 + k) % self.W for k in range(self.W)
                 if ready[(self.last + 1 + k) % self.W])
        self.last = w
        ins = self.code[self.pc[w]]
        op, dst, s1r, s2r, s3r = (int(ins[i]) for i in range(5))
        imm = int(np.int32(ins[isa.F_IMM]))
        fl, gp, gc, pd = (int(ins[i]) for i in range(6, 10))
        cfg = self.cfg

        # sync pop
        exec_this = True
        if (fl & isa.FLAG_SYNC) and self.stack[w]:
            addr, typ, mask = self.stack[w].pop()
            self.active[w] = mask.copy()
            if typ == isa.STACK_TAKEN:
                self.pc[w] = addr
                self.cycles += 1
                return True  # jump consumed the cycle

        gm = np.ones(32, bool)
        if fl & isa.FLAG_GUARD:
            gm = np.array([_cond(self.lut, gc, int(self.pred[w, l, gp]))
                           for l in range(32)])
        cond_val = np.array([_cond(self.lut, gc, int(self.pred[w, l, gp]))
                             for l in range(32)])
        em = self.active[w] & self.alive[w] & gm
        s1 = np.array([imm if fl & isa.FLAG_SRC1_IMM else
                       self.regs[w, l, s1r] for l in range(32)])
        s2 = np.array([imm if fl & isa.FLAG_SRC2_IMM else
                       self.regs[w, l, s2r] for l in range(32)])
        s3 = self.regs[w, :, s3r].copy() if cfg.num_read_operands >= 3 \
            else np.zeros(32, np.int64)

        pc_next = self.pc[w] + 1
        is_mem_g = op in (isa.LDG, isa.STG)
        is_mem_s = op in (isa.LDS, isa.STS)
        self.issues += 1
        self.cycles += cfg.rows_per_warp + (
            cfg.mem_latency_global if is_mem_g else
            cfg.mem_latency_shared if is_mem_s else 0)

        def wreg(vals):
            for l in range(32):
                if em[l]:
                    self.regs[w, l, dst] = self._i32(vals[l])

        if op in (isa.MOV, isa.IADD, isa.ISUB, isa.IMUL, isa.IMAD, isa.IMIN,
                  isa.IMAX, isa.IABS, isa.AND, isa.OR, isa.XOR, isa.NOT,
                  isa.SHL, isa.SHR, isa.SAR, isa.ISET, isa.SELP, isa.S2R):
            sh = s2 & 31
            u1 = np.asarray(self._i32(s1)).astype(np.int64) & 0xFFFFFFFF
            res = {
                isa.MOV: s2, isa.IADD: s1 + s2, isa.ISUB: s1 - s2,
                isa.IMUL: s1 * s2, isa.IMAD: s1 * s2 + s3,
                isa.IMIN: np.minimum(s1, s2), isa.IMAX: np.maximum(s1, s2),
                isa.IABS: np.abs(s1), isa.AND: s1 & s2, isa.OR: s1 | s2,
                isa.XOR: s1 ^ s2, isa.NOT: ~s1,
                isa.SHL: u1 << sh, isa.SHR: u1 >> sh,
                isa.SAR: self._i32(s1) >> sh,
                isa.ISET: cond_val.astype(np.int64),
                isa.SELP: np.where(cond_val, s1, s2),
                isa.S2R: np.array([self._srval(w, l, imm)
                                   for l in range(32)]),
            }[op]
            if op in (isa.IMUL, isa.IMAD) and not cfg.enable_mul:
                res = np.zeros(32, np.int64)
            wreg(res)
        elif op == isa.ISETP:
            d = self._i32(s1 - s2)
            u1 = np.asarray(self._i32(s1)) & 0xFFFFFFFF
            u2 = np.asarray(self._i32(s2)) & 0xFFFFFFFF
            s1_32, s2_32 = self._i32(s1), self._i32(s2)
            nib = ((d < 0) | ((d == 0) << 1) | ((u1 < u2) << 2) |
                   ((((s1_32 ^ s2_32) & (s1_32 ^ d)) < 0) << 3))
            for l in range(32):
                if em[l]:
                    self.pred[w, l, pd] = nib[l]
        elif op == isa.LDG:
            addr = np.clip(s1 + imm, 0, len(self.gmem) - 1)
            wreg(self.gmem[addr])
        elif op == isa.LDS:
            addr = np.clip(s1 + imm, 0, cfg.smem_words - 1)
            wreg(self.smem[addr])
        elif op == isa.STG:
            addr = np.clip(s1 + imm, 0, len(self.gmem) - 1)
            for l in range(32):
                if em[l]:
                    self.gmem[addr[l]] = self._i32(s2[l])
                    self.gw[addr[l]] = True
        elif op == isa.STS:
            addr = np.clip(s1 + imm, 0, cfg.smem_words - 1)
            for l in range(32):
                if em[l]:
                    self.smem[addr[l]] = self._i32(s2[l])
        elif op == isa.SSY:
            self.stack[w].append((imm, isa.STACK_RECONV,
                                  (self.active[w] & self.alive[w]).copy()))
        elif op == isa.BRA:
            part = self.active[w] & self.alive[w]
            taken = part & cond_val if fl & isa.FLAG_GUARD else part.copy()
            ntk = part & ~taken
            if taken.any() and ntk.any():
                self.stack[w].append((imm, isa.STACK_TAKEN, taken.copy()))
                self.active[w] = ntk
            elif taken.any():
                pc_next = imm
        elif op == isa.BAR:
            self.wstate[w] = WAIT
        elif op == isa.EXIT:
            self.alive[w] &= ~em
            if not self.alive[w].any():
                self.wstate[w] = FINISHED
            elif self.stack[w]:
                addr, typ, mask = self.stack[w].pop()
                self.active[w] = mask & self.alive[w]
                if typ == isa.STACK_TAKEN:
                    pc_next = addr
            else:
                self.active[w] = self.alive[w].copy()
        self.max_sp = max(self.max_sp, max(len(s) for s in self.stack))
        if self.wstate[w] != FINISHED:
            self.pc[w] = pc_next
        return True

    def run(self, max_steps: int = 2_000_000):
        for _ in range(max_steps):
            if not self.step():
                break
        return self.gmem, self.gw, self.cycles


# --------------------------------------------------------------------------
# MicroBlaze scalar-core cycle/energy model
# --------------------------------------------------------------------------
# Effective cycles per scalar instruction class.  A MicroBlaze is a 3/5-stage
# in-order core: ALU ops ~1 cycle, loads/stores pay bus latency, taken
# branches pay a 2-cycle penalty, multiplies are pipelined (1) but we keep a
# separate class for the energy model.
SCALAR_CPI = {"alu": 1.0, "mul": 1.0, "gmem": 9.0, "smem": 9.0,
              "bra": 3.0, "pred": 1.0, "ctrl": 1.0}
# Scalar software must additionally materialize thread/loop indices that the
# SM provides architecturally (S2R, launch bookkeeping): charged per thread.
SCALAR_THREAD_OVERHEAD = 6.0


def classify(op: int) -> str:
    if op in isa.MUL_OPS:
        return "mul"
    if op in isa.GMEM_OPS:
        return "gmem"
    if op in isa.SMEM_OPS:
        return "smem"
    if op == isa.BRA:
        return "bra"
    if op in isa.PRED_OPS:
        return "pred"
    if op in (isa.SSY, isa.BAR, isa.NOP, isa.EXIT):
        return "ctrl"
    return "alu"


def scalar_cycles(op_lanes: np.ndarray, n_threads: int) -> float:
    """MicroBlaze-model cycles for the same dynamic work, single-threaded."""
    total = float(n_threads) * SCALAR_THREAD_OVERHEAD
    for op in range(isa.NUM_OPCODES):
        cls = classify(op)
        if op in (isa.SSY, isa.BAR, isa.NOP):
            continue  # SIMT-only artifacts: no scalar equivalent
        total += float(op_lanes[op]) * SCALAR_CPI[cls]
    return total
