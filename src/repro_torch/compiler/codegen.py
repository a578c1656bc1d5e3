"""SSA IR -> machine code, via the :class:`repro_torch.core.asm.Program`
builder.

Emission happens in three phases:

1. **Operand planning** — decide, per use, whether a value rides in the
   instruction's immediate slot (ALU/ISETP src2, memory offsets,
   constant jump-move sources) or needs a register.  Address
   expressions ``add(x, c)`` fold into the ``[rX + c]`` base+offset
   form of LDG/STG/LDS/STS.  A pure instruction whose every use was
   absorbed this way is never emitted at all (fixpoint, so a constant
   feeding only folded adds disappears with them).
2. **Register allocation** — :mod:`repro_torch.compiler.regalloc`
   linear-scans the planned values onto ``n_regs`` GPRs + 4 predicate
   registers.
3. **Emission** — blocks in layout order.  Block arguments become
   per-edge register moves (a parallel-copy: cycles are broken with
   XOR swaps, so no scratch register is ever needed); a divergent
   branch emits the paper's SSY / guarded-BRA / ``.S`` warp-stack
   protocol with the reconvergence label on its join block; uniform
   branches are plain guarded BRAs like the hand-written kernels' loop
   latches.

The machine has no divide unit: ``udiv``/``umod`` that survive to
emission (passes disabled, or a non-constant divisor) are emittable
only for power-of-two constant divisors, as SHR/AND.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ..core import asm
from ..core import isa
from . import ir
from .ir import (Block, Branch, CompileError, Function, Instr, Jump, Ret,
                 Value)
from .regalloc import compute_liveness, linear_scan

#: ops whose second argument may ride in the immediate slot
_IMM2_OPS = {ir.ADD, ir.SUB, ir.MUL, ir.MIN, ir.MAX, ir.AND, ir.OR,
             ir.XOR, ir.SHL, ir.SHR, ir.SAR, ir.ICMP, ir.UDIV, ir.UMOD}

#: straightforward binop -> Program method name
_BINOP_EMIT = {ir.ADD: "iadd", ir.SUB: "isub", ir.MUL: "imul",
               ir.MIN: "imin", ir.MAX: "imax", ir.AND: "and_",
               ir.OR: "or_", ir.XOR: "xor", ir.SHL: "shl",
               ir.SHR: "shr", ir.SAR: "sar"}


_cval = ir.const_val


class Plan:
    """Operand-folding decisions feeding regalloc and emission."""

    def __init__(self, fn: Function):
        self.fn = fn
        #: mem instr -> (base value, constant offset)
        self.mem_fold: Dict[Instr, Tuple[Value, int]] = {}
        #: values that are emitted (get a machine instruction)
        self.emitted: Set[Instr] = set()
        #: values that occupy a register (GPR for i32, pred for pred)
        self.allocated: Set[Value] = set()
        self._build()

    def _build(self) -> None:
        fn = self.fn
        # --- address folding ------------------------------------------
        for ins in fn.iter_instrs():
            if ins.op not in (ir.LDG, ir.LDS, ir.STG, ir.STS):
                continue
            a = ins.args[0]
            base, off = a, 0
            if isinstance(a, Instr) and a.op == ir.ADD \
                    and a.guard is None:
                for ci, bi in ((1, 0), (0, 1)):
                    c = _cval(a.args[ci])
                    if c is not None:
                        base, off = a.args[bi], c
                        break
            self.mem_fold[ins] = (base, off)

        # --- which instructions are emitted ---------------------------
        # Fixpoint: a pure instruction with at least one use is skipped
        # when EVERY use is absorbed — into an immediate slot, a folded
        # address, or another skipped instruction.  A use-less pure
        # instruction still emits (this is emission, not DCE: the dce
        # *pass* is what removes dead code, and the passes-disabled
        # baseline owes its traced instructions their slots).
        total_uses = fn.uses()
        emitted: Set[Instr] = set(fn.iter_instrs())
        changed = True
        while changed:
            changed = False
            reg_needed = self._reg_needed(emitted)
            for ins in list(emitted):
                if ins.op in ir.EFFECT_OPS or ins.op in ir.LOAD_OPS:
                    continue
                if ins not in reg_needed and total_uses.get(ins, 0) > 0:
                    emitted.discard(ins)
                    changed = True
        self.emitted = emitted
        self.allocated = {ins for ins in emitted
                          if ins.op not in ir.STORE_OPS
                          and ins.op != ir.BAR}
        for b in fn.blocks:
            self.allocated.update(b.params)

    def _reg_needed(self, emitted: Set[Instr]) -> Set[Value]:
        """Values some emitted instruction or edge reads from a register."""
        need: Set[Value] = set()
        for ins in self.fn.iter_instrs():
            if ins in emitted:
                need.update(self.reg_operands(ins))
                if ins.guard:
                    need.add(ins.guard[0])
        for b in self.fn.blocks:
            t = b.term
            if isinstance(t, Jump):
                for a in t.args:
                    if _cval(a) is None:
                        need.add(a)       # const args move as MOV-imm
            elif isinstance(t, Branch):
                need.add(t.pred)
        return need

    def reg_operands(self, ins: Instr) -> List[Value]:
        """Values this instruction reads from registers."""
        if ins.op in (ir.LDG, ir.LDS, ir.STG, ir.STS):
            base, _ = self.mem_fold[ins]
            out = [base]
            if ins.op in ir.STORE_OPS:
                out.append(ins.args[1])
            return out
        if ins.op in (ir.CONST, ir.SREG, ir.BAR):
            return []
        if ins.op == ir.ISET:
            return [ins.args[0]]
        if ins.op == ir.SELECT:
            return list(ins.args)         # pred + both value operands
        if ins.op in (ir.NOT, ir.ABS):
            return [ins.args[0]]
        if ins.op == ir.MAD:
            return list(ins.args)
        if ins.op in _IMM2_OPS:
            out = [ins.args[0]]
            if _cval(ins.args[1]) is None:
                out.append(ins.args[1])
            return out
        raise CompileError(f"{self.fn.name}: cannot emit op {ins.op!r}")


def _parallel_moves(moves: List[Tuple[int, object]], emit_mov, emit_swap
                    ) -> None:
    """Resolve a parallel copy.  ``moves`` is ``[(dst_reg, src)]`` where
    ``src`` is an int register or ``("imm", value)``.  Register moves
    are ordered so no source is clobbered before it is read; cycles are
    rotated with XOR swaps (no scratch register); immediate moves go
    last (nothing reads their destinations anymore)."""
    reg_moves = [(d, s) for d, s in moves
                 if not isinstance(s, tuple) and d != s]
    imm_moves = [(d, s[1]) for d, s in moves if isinstance(s, tuple)]
    pending = dict(reg_moves)             # dst -> src (dsts are unique)
    while pending:
        src_counts: Dict[int, int] = {}
        for s in pending.values():
            src_counts[s] = src_counts.get(s, 0) + 1
        ready = [d for d in pending if src_counts.get(d, 0) == 0]
        if ready:
            for d in ready:
                emit_mov(d, pending.pop(d))
            continue
        # pure cycle(s): rotate one with XOR swaps
        d0 = next(iter(pending))
        cycle = [d0]
        while pending[cycle[-1]] != d0:
            cycle.append(pending[cycle[-1]])
        for i in range(len(cycle) - 1):
            emit_swap(cycle[i], cycle[i + 1])
        for d in cycle:
            del pending[d]
    for d, v in imm_moves:
        emit_mov(d, ("imm", v))


def emit_function(fn: Function, n_regs: int = 16,
                  n_pregs: int = 4) -> asm.Program:
    """Lower verified IR to an :class:`asm.Program` (unpadded)."""
    ir.verify(fn)
    plan = Plan(fn)
    iv = compute_liveness(fn, plan)
    gpr, preg = linear_scan(fn, iv, n_regs, n_pregs)

    p = asm.Program(fn.name)
    labels = {b: f"{b.name}_{b.id}" for b in fn.blocks}
    sync_blocks = {t.reconv for b in fn.blocks
                   if isinstance((t := b.term), Branch) and t.reconv}

    def r(v: Value) -> str:
        try:
            return f"r{gpr[v]}"
        except KeyError:
            raise CompileError(
                f"{fn.name}: internal: {v.label()} has no register") \
                from None

    def pr(v: Value) -> str:
        return f"p{preg[v]}"

    def src2(v: Value):
        c = _cval(v)
        return c if c is not None else r(v)

    def guard_of(ins: Instr):
        if ins.guard:
            p.guard(pr(ins.guard[0]), ins.guard[1])

    def mark_label(b: Block) -> None:
        if b in sync_blocks and p._sync_next:
            # two reconvergence labels must never share an address: one
            # ``.S`` issue pops exactly one warp-stack entry
            p.nop()
        p.label(labels[b], sync=b in sync_blocks)

    for bi, b in enumerate(fn.blocks):
        mark_label(b)
        for ins in b.instrs:
            if ins not in plan.emitted:
                continue
            op = ins.op
            if op == ir.CONST:
                p.mov(r(ins), int(ins.imm))
            elif op == ir.SREG:
                p.s2r(r(ins), int(ins.imm))
            elif op in _BINOP_EMIT:
                guard_of(ins)
                getattr(p, _BINOP_EMIT[op])(r(ins), r(ins.args[0]),
                                            src2(ins.args[1]))
            elif op in (ir.UDIV, ir.UMOD):
                c = _cval(ins.args[1])
                if c is None or not ir.is_pow2(c):
                    raise CompileError(
                        f"{fn.name}: {op} needs a positive power-of-two "
                        "constant divisor — the overlay has no divide "
                        f"unit (got {c!r})")
                guard_of(ins)
                if op == ir.UDIV:
                    p.shr(r(ins), r(ins.args[0]), c.bit_length() - 1)
                else:
                    p.and_(r(ins), r(ins.args[0]), c - 1)
            elif op == ir.MAD:
                guard_of(ins)
                p.imad(r(ins), r(ins.args[0]), r(ins.args[1]),
                       r(ins.args[2]))
            elif op == ir.NOT:
                guard_of(ins)
                p.not_(r(ins), r(ins.args[0]))
            elif op == ir.ABS:
                guard_of(ins)
                p.iabs(r(ins), r(ins.args[0]))
            elif op in (ir.ICMP, ir.SELECT, ir.ISET):
                if ins.guard:
                    # SELP/ISET carry their predicate *source* in the
                    # guard fields, and ISETP has no guarded form — a
                    # guard here would emit silently-wrong bits, so
                    # fail loud (no pass produces this today)
                    raise CompileError(
                        f"{fn.name}: {op} cannot be predicated on this "
                        "machine (guard fields are its operand slots)")
                if op == ir.ICMP:
                    p.isetp(pr(ins), r(ins.args[0]), src2(ins.args[1]))
                elif op == ir.SELECT:
                    p.selp(r(ins), r(ins.args[1]), r(ins.args[2]),
                           pr(ins.args[0]), ins.cond)
                else:
                    p.iset(r(ins), pr(ins.args[0]), ins.cond)
            elif op in (ir.LDG, ir.LDS):
                base, off = plan.mem_fold[ins]
                guard_of(ins)
                (p.ldg if op == ir.LDG else p.lds)(r(ins), r(base), off)
            elif op in (ir.STG, ir.STS):
                base, off = plan.mem_fold[ins]
                guard_of(ins)
                (p.stg if op == ir.STG else p.sts)(r(base),
                                                   r(ins.args[1]), off)
            elif op == ir.BAR:
                if ins.guard:
                    raise CompileError(
                        f"{fn.name}: a barrier cannot be predicated")
                p.bar()
            else:
                raise CompileError(f"{fn.name}: unhandled op {op!r}")
        nxt = fn.blocks[bi + 1] if bi + 1 < len(fn.blocks) else None
        t = b.term
        if isinstance(t, Jump):
            _emit_jump(p, t, gpr, labels, nxt)
        elif isinstance(t, Branch):
            if t.reconv is not None:
                p.ssy(labels[t.reconv])
            if t.t is nxt:
                p.guard(pr(t.pred), ir.COND_COMPLEMENT[t.cond]) \
                    .bra(labels[t.f])
            elif t.f is nxt:
                p.guard(pr(t.pred), t.cond).bra(labels[t.t])
            else:
                p.guard(pr(t.pred), t.cond).bra(labels[t.t])
                p.bra(labels[t.f])
        elif isinstance(t, Ret):
            p.exit()
        else:
            raise CompileError(f"{fn.name}: unterminated {b.name}")
    return p


def _emit_jump(p: asm.Program, t: Jump, gpr: Dict[Value, int],
               labels: Dict[Block, str], nxt: Optional[Block]) -> None:
    moves: List[Tuple[int, object]] = []
    for a, prm in zip(t.args, t.target.params):
        dst = gpr[prm]
        c = _cval(a)
        if a in gpr:
            moves.append((dst, gpr[a]))
        elif c is not None:
            moves.append((dst, ("imm", c)))
        else:
            raise CompileError(
                f"jump arg {a.label()} has neither a register nor an "
                "immediate form")

    def emit_mov(d, s):
        if isinstance(s, tuple):
            p.mov(f"r{d}", int(s[1]))
        else:
            p.mov(f"r{d}", f"r{s}")

    def emit_swap(ra, rb):
        p.xor(f"r{ra}", f"r{ra}", f"r{rb}")
        p.xor(f"r{rb}", f"r{rb}", f"r{ra}")
        p.xor(f"r{ra}", f"r{ra}", f"r{rb}")

    _parallel_moves(moves, emit_mov, emit_swap)
    if t.target is not nxt:
        p.bra(labels[t.target])
