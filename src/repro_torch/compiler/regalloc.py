"""Linear-scan register allocation onto the machine's register file.

Maps the SSA IR's unbounded values onto ``MachineConfig.n_regs``
general-purpose registers per thread (default 16 — the paper's BRAM
register file) and the 4 predicate registers of the SZCO predicate
file.  Classic Poletto–Sarkar linear scan over live intervals:

* blocks are numbered in layout order; liveness is a backward dataflow
  over the CFG, so a value live around a loop's back edge gets an
  interval covering the whole loop body;
* a block param's interval opens at the *earliest predecessor jump*
  that writes it (codegen emits the move there) and extends over every
  block where the param is live — one register per param for its whole
  life, so every incoming edge moves into the same register;
* there is no spilling: a kernel whose pressure exceeds the register
  file fails with :class:`RegAllocError` naming the hot values (the
  ``gpgpu_compile`` smoke turns that into a CI failure).  The paper's
  overlay has no spill path either — local memory does not exist.

The allocator runs on the *emission plan* prepared by codegen (values
folded into immediate operands or memory offsets never get a
register), so register pressure reflects the instructions actually
emitted.
"""
from __future__ import annotations

from typing import Dict, List, Set, Tuple

from . import ir
from .ir import Block, Branch, CompileError, Function, Jump, Value


class RegAllocError(CompileError):
    """Register pressure exceeded the machine's register file."""


class Intervals:
    """Live intervals over a linearized function."""

    def __init__(self):
        self.start: Dict[Value, int] = {}
        self.end: Dict[Value, int] = {}

    def open(self, v: Value, pos: int) -> None:
        cur = self.start.get(v)
        self.start[v] = pos if cur is None else min(cur, pos)
        self.end.setdefault(v, pos)

    def use(self, v: Value, pos: int) -> None:
        self.end[v] = max(self.end.get(v, pos), pos)


def _block_positions(fn: Function) -> Tuple[Dict[Block, int],
                                            Dict[Block, int]]:
    """(block start, block end) positions in layout order; each
    instruction occupies one slot and the terminator one more."""
    starts, ends = {}, {}
    pos = 0
    for b in fn.blocks:
        starts[b] = pos
        pos += len(b.instrs) + 1          # +1: the terminator slot
        ends[b] = pos - 1
    return starts, ends


def compute_liveness(fn: Function, plan) -> Intervals:
    """Backward-dataflow liveness -> conservative linear intervals.

    ``plan`` is the codegen emission plan: ``plan.emitted`` (instrs
    that produce machine code), ``plan.allocated`` (values occupying a
    register) and ``plan.reg_operands(ins)`` (register reads of one
    instruction after operand folding).
    """
    starts, ends = _block_positions(fn)
    allocated: Set[Value] = plan.allocated
    live_in: Dict[Block, Set[Value]] = {b: set() for b in fn.blocks}
    live_out: Dict[Block, Set[Value]] = {b: set() for b in fn.blocks}

    def term_uses(b: Block) -> List[Value]:
        t = b.term
        if isinstance(t, Jump):
            return [a for a in t.args if a in allocated]
        if isinstance(t, Branch):
            return [t.pred]
        return []

    def block_uses_defs(b: Block):
        uses: Set[Value] = set()
        defs: Set[Value] = set(b.params)
        for ins in b.instrs:
            if ins not in plan.emitted:
                continue
            for v in plan.reg_operands(ins):
                if v in allocated and v not in defs:
                    uses.add(v)
            if ins.guard and ins.guard[0] not in defs:
                uses.add(ins.guard[0])
            if ins in allocated:
                defs.add(ins)
        for v in term_uses(b):
            if v not in defs:
                uses.add(v)
        return uses, defs

    ud = {b: block_uses_defs(b) for b in fn.blocks}
    changed = True
    while changed:
        changed = False
        for b in reversed(fn.blocks):
            out: Set[Value] = set()
            for s in b.succs():
                out |= live_in[s]
            uses, defs = ud[b]
            new_in = uses | (out - defs)
            if out != live_out[b] or new_in != live_in[b]:
                live_out[b] = out
                live_in[b] = new_in
                changed = True

    iv = Intervals()
    for b in fn.blocks:
        pos = starts[b]
        for p in b.params:
            iv.open(p, pos)
        for i, ins in enumerate(b.instrs):
            if ins not in plan.emitted:
                continue
            at = pos + i
            if ins in allocated:
                iv.open(ins, at)
            for v in plan.reg_operands(ins):
                if v in allocated:
                    iv.use(v, at)
            if ins.guard:
                iv.use(ins.guard[0], at)
        tpos = ends[b]
        t = b.term
        if isinstance(t, Jump):
            for a, prm in zip(t.args, t.target.params):
                if a in allocated:
                    iv.use(a, tpos)
                iv.open(prm, tpos)        # the edge move writes it here
        elif isinstance(t, Branch):
            iv.use(t.pred, tpos)
    # cover back edges and straddled ranges in a second sweep (every
    # def is open by now): anything live at a block boundary spans the
    # whole block
    for b in fn.blocks:
        for v in live_out[b] | live_in[b]:
            if v in iv.start:
                iv.use(v, ends[b])
                iv.start[v] = min(iv.start[v], starts[b])
    return iv


def linear_scan(fn: Function, iv: Intervals, n_regs: int,
                n_pregs: int) -> Tuple[Dict[Value, int], Dict[Value, int]]:
    """Allocate GPRs and predicate registers; no spill path."""
    gpr: Dict[Value, int] = {}
    preg: Dict[Value, int] = {}
    items = sorted(iv.start, key=lambda v: (iv.start[v], v.id))
    free_g = list(range(n_regs))
    free_p = list(range(n_pregs))
    active: List[Tuple[int, Value]] = []     # (interval end, value)

    for v in items:
        start = iv.start[v]
        for endpos, a in list(active):
            if endpos < start:
                active.remove((endpos, a))
                (free_p if a.type == ir.PRED else free_g).append(
                    preg[a] if a.type == ir.PRED else gpr[a])
        pool = free_p if v.type == ir.PRED else free_g
        if not pool:
            kind = ("predicate registers (4)" if v.type == ir.PRED
                    else f"registers (n_regs={n_regs})")
            live_now = sorted(
                a.label() for _, a in active
                if (a.type == ir.PRED) == (v.type == ir.PRED))
            raise RegAllocError(
                f"{fn.name}: out of {kind} allocating {v.label()} "
                f"(interval {start}..{iv.end[v]}); live: "
                f"{', '.join(live_now)} — the overlay has no spill "
                "path; reduce simultaneously-live values or split the "
                "kernel")
        pool.sort()
        r = pool.pop(0)
        (preg if v.type == ir.PRED else gpr)[v] = r
        active.append((iv.end[v], v))
    return gpr, preg
