"""Typed SSA IR for the kernel compiler front end.

The DSL tracer (:mod:`repro_torch.compiler.dsl`) lowers a CUDA-style Python
kernel into this IR; the pass pipeline (:mod:`repro_torch.compiler.passes`)
optimizes it; the back end (:mod:`repro_torch.compiler.regalloc`,
:mod:`repro_torch.compiler.codegen`) maps it onto the machine's register file
and emits a binary via :class:`repro_torch.core.asm.Program`.

Design notes:

* **Block arguments instead of phi nodes** (the MLIR / Cranelift
  convention): a :class:`Block` carries :class:`Param` values and every
  :class:`Jump` into it passes matching arguments.  On the SIMT target
  this is the natural form — a block argument lowers to per-lane
  register moves on each incoming edge, which predicated execution
  makes correct under divergence for free.
* **Branch edges never carry arguments.**  The tracer materializes an
  explicit block on every conditional edge (a then/else/stub block for
  ifs, the body/exit blocks for loops), so any block with more than one
  predecessor is the target of plain jumps only.  That keeps SSA
  construction (Braun et al.'s incremental algorithm, implemented in
  :class:`FunctionBuilder`) and codegen's move insertion simple.
* Two value types: ``i32`` (a 32-bit GPR lane value) and ``pred`` (an
  SZCO predicate nibble, the result of :data:`ICMP`).  A ``pred`` value
  is consumed together with a *condition code* — the same nibble serves
  ``a < b`` and ``a >= b`` — so branch / select / guard sites each
  carry their own cond string, and predicates never flow through block
  params (there is no predicate-move instruction in the ISA).
"""
from __future__ import annotations

import itertools
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core import isa

I32 = "i32"
PRED = "pred"

# ---------------------------------------------------------------- opcodes
# Pure value-producing operations.
CONST = "const"      # imm -> i32
SREG = "sreg"        # imm (special-register index) -> i32
ADD = "add"
SUB = "sub"
MUL = "mul"
MAD = "mad"          # a * b + c (the ISA's only 3-operand instruction)
UDIV = "udiv"        # unsigned divide — only pow2 divisors are emittable
UMOD = "umod"        # unsigned modulo — only pow2 divisors are emittable
MIN = "min"
MAX = "max"
ABS = "abs"
AND = "and"
OR = "or"
XOR = "xor"
NOT = "not"
SHL = "shl"
SHR = "shr"          # logical
SAR = "sar"          # arithmetic
ICMP = "icmp"        # (a, b) -> pred (SZCO nibble of a - b)
SELECT = "select"    # (pred, a, b) + cond -> cond(pred) ? a : b
ISET = "iset"        # (pred,) + cond -> cond(pred) ? 1 : 0
# Memory / synchronization (ordered side effects).
LDG = "ldg"          # (addr,) -> i32
LDS = "lds"
STG = "stg"          # (addr, value)
STS = "sts"
BAR = "bar"          # block barrier

PURE_OPS = frozenset({CONST, SREG, ADD, SUB, MUL, MAD, UDIV, UMOD, MIN,
                      MAX, ABS, AND, OR, XOR, NOT, SHL, SHR, SAR, ICMP,
                      SELECT, ISET})
LOAD_OPS = frozenset({LDG, LDS})
STORE_OPS = frozenset({STG, STS})
EFFECT_OPS = STORE_OPS | {BAR}
BINOPS = frozenset({ADD, SUB, MUL, UDIV, UMOD, MIN, MAX, AND, OR, XOR,
                    SHL, SHR, SAR})
COMMUTATIVE = frozenset({ADD, MUL, MIN, MAX, AND, OR, XOR})

#: Condition-code complements (negating an if condition / else guards).
COND_COMPLEMENT = {"LT": "GE", "GE": "LT", "EQ": "NE", "NE": "EQ",
                   "LE": "GT", "GT": "LE", "LO": "HS", "HS": "LO",
                   "LS": "HI", "HI": "LS", "T": "F", "F": "T"}


class CompileError(Exception):
    """A kernel that cannot be compiled (tracing, verification,
    register allocation or emission failure).  The message says which
    stage rejected it and why."""


def eval_cond(cond: str, a: int, b: int) -> bool:
    """Evaluate ``cond`` on the SZCO flags of int32 ``a - b`` — the
    constant-folding twin of the machine's predicate LUT (Fig. 2)."""
    a32, b32 = np.int32(np.uint32(a & 0xFFFFFFFF)), \
        np.int32(np.uint32(b & 0xFFFFFFFF))
    with np.errstate(over="ignore"):
        d = np.int32(a32 - b32)
        s = int(d < 0)
        z = int(d == 0)
        c = int((int(a32) & 0xFFFFFFFF) < (int(b32) & 0xFFFFFFFF))
        o = int(np.int32((a32 ^ b32) & (a32 ^ d)) < 0)
    nib = s | (z << 1) | (c << 2) | (o << 3)
    return bool(isa.COND_LUT[isa.COND_IDS[cond], nib])


def i32(v: int) -> int:
    """Wrap a python int to int32 two's-complement."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def const_val(v: "Value") -> Optional[int]:
    """The integer behind a CONST instruction, else None — the one
    definition of "is this IR value a known constant" shared by the
    passes, the tracer's validations and codegen's operand planner."""
    if isinstance(v, Instr) and v.op == CONST:
        return v.imm
    return None


def is_pow2(v: int) -> bool:
    return v > 0 and (v & (v - 1)) == 0


# ------------------------------------------------------------------ values
_ids = itertools.count()


class Value:
    """An SSA value: either a :class:`Param` or an :class:`Instr`."""
    __slots__ = ("id", "type", "name")

    def __init__(self, type: str, name: str = ""):
        self.id = next(_ids)
        self.type = type
        self.name = name

    def label(self) -> str:
        return f"%{self.name or self.id}"


class Param(Value):
    """A block argument."""
    __slots__ = ("block",)

    def __init__(self, type: str, block: "Block", name: str = ""):
        super().__init__(type, name)
        self.block = block


class Instr(Value):
    """One IR instruction; the instruction *is* its result value."""
    __slots__ = ("op", "args", "imm", "cond", "guard", "block")

    def __init__(self, op: str, args: Sequence[Value] = (),
                 imm: Optional[int] = None, cond: Optional[str] = None,
                 guard: Optional[Tuple[Value, str]] = None,
                 name: str = ""):
        super().__init__(PRED if op == ICMP else I32, name)
        self.op = op
        self.args = list(args)
        self.imm = imm
        self.cond = cond          # ICMP / SELECT / ISET condition code
        self.guard = guard        # (pred value, cond) predication, or None
        self.block: Optional["Block"] = None

    def is_pure(self) -> bool:
        return self.op in PURE_OPS

    def __repr__(self):
        parts = [self.op]
        if self.cond:
            parts.append(f".{self.cond}")
        s = "".join(parts) + " " + ", ".join(a.label() for a in self.args)
        if self.imm is not None:
            s += f" #{self.imm}"
        if self.guard:
            s = f"@{self.guard[0].label()}.{self.guard[1]} " + s
        return f"{self.label()} = {s}" if self.op not in EFFECT_OPS else s


# -------------------------------------------------------------- terminators
class Jump:
    """Unconditional edge carrying the target's block arguments."""
    __slots__ = ("target", "args")

    def __init__(self, target: "Block", args: Sequence[Value] = ()):
        self.target = target
        self.args = list(args)


class Branch:
    """Conditional edge pair: ``cond(pred)`` lanes go to ``t``, the rest
    to ``f``.  ``reconv`` names the reconvergence block when the branch
    may diverge within a warp (codegen then emits SSY / ``.S``); None
    means the tracer proved the condition warp-uniform."""
    __slots__ = ("pred", "cond", "t", "f", "reconv")

    def __init__(self, pred: Value, cond: str, t: "Block", f: "Block",
                 reconv: Optional["Block"] = None):
        self.pred = pred
        self.cond = cond
        self.t = t
        self.f = f
        self.reconv = reconv


class Ret:
    """Kernel exit."""
    __slots__ = ()


Terminator = Union[Jump, Branch, Ret]


class Block:
    """A basic block: params, instructions, one terminator."""
    __slots__ = ("id", "name", "params", "instrs", "term", "sealed",
                 "_incomplete", "_defs")

    def __init__(self, name: str = ""):
        self.id = next(_ids)
        self.name = name or f"b{self.id}"
        self.params: List[Param] = []
        self.instrs: List[Instr] = []
        self.term: Optional[Terminator] = None
        self.sealed = False
        self._incomplete: Dict[str, Param] = {}   # var name -> pending param
        self._defs: Dict[str, Value] = {}         # var name -> current value

    def succs(self) -> List["Block"]:
        if isinstance(self.term, Jump):
            return [self.term.target]
        if isinstance(self.term, Branch):
            return [self.term.t, self.term.f]
        return []

    def __repr__(self):
        return f"<Block {self.name}>"


class LoopInfo:
    """Structured-loop metadata recorded by the tracer for the unroller."""
    __slots__ = ("preheader", "header", "latch", "exit", "start", "stop",
                 "step")

    def __init__(self, preheader: Block, header: Block, latch: Block,
                 exit: Block, start: Value, stop: Value, step: Value):
        self.preheader = preheader
        self.header = header
        self.latch = latch
        self.exit = exit
        self.start = start
        self.stop = stop
        self.step = step


class Function:
    """One kernel in SSA form: blocks in layout (source) order."""

    def __init__(self, name: str):
        self.name = name
        self.blocks: List[Block] = []
        self.loops: List[LoopInfo] = []

    @property
    def entry(self) -> Block:
        return self.blocks[0]

    def iter_instrs(self) -> Iterable[Instr]:
        for b in self.blocks:
            yield from b.instrs

    def n_instrs(self) -> int:
        return sum(len(b.instrs) for b in self.blocks)

    def preds(self) -> Dict[Block, List[Block]]:
        p: Dict[Block, List[Block]] = {b: [] for b in self.blocks}
        for b in self.blocks:
            for s in b.succs():
                p[s].append(b)
        return p

    # ------------------------------------------------------------- editing
    def replace_uses(self, old: Value, new: Value) -> None:
        """Rewrite every use of ``old`` to ``new`` (instr args, guards,
        terminators, jump arguments and loop metadata)."""
        for b in self.blocks:
            for ins in b.instrs:
                ins.args = [new if a is old else a for a in ins.args]
                if ins.guard and ins.guard[0] is old:
                    ins.guard = (new, ins.guard[1])
            t = b.term
            if isinstance(t, Jump):
                t.args = [new if a is old else a for a in t.args]
            elif isinstance(t, Branch) and t.pred is old:
                t.pred = new
        for lp in self.loops:
            for f in ("start", "stop", "step"):
                if getattr(lp, f) is old:
                    setattr(lp, f, new)

    def uses(self) -> Dict[Value, int]:
        """Use counts over instr args, guards, jump args and branch preds."""
        n: Dict[Value, int] = {}

        def bump(v):
            n[v] = n.get(v, 0) + 1

        for b in self.blocks:
            for ins in b.instrs:
                for a in ins.args:
                    bump(a)
                if ins.guard:
                    bump(ins.guard[0])
            if isinstance(b.term, Jump):
                for a in b.term.args:
                    bump(a)
            elif isinstance(b.term, Branch):
                bump(b.term.pred)
        return n

    def prune_unreachable(self) -> None:
        """Drop blocks no path from entry reaches (after branch folding),
        along with any loop metadata that referenced them."""
        seen = {self.entry}
        work = [self.entry]
        while work:
            for s in work.pop().succs():
                if s not in seen:
                    seen.add(s)
                    work.append(s)
        if len(seen) == len(self.blocks):
            return
        self.blocks = [b for b in self.blocks if b in seen]
        self.loops = [lp for lp in self.loops
                      if lp.header in seen and lp.latch in seen]

    # ------------------------------------------------------------ printing
    def __str__(self):
        out = [f"func @{self.name} {{"]
        for b in self.blocks:
            ps = ", ".join(p.label() for p in b.params)
            out.append(f"{b.name}({ps}):")
            for ins in b.instrs:
                out.append(f"  {ins!r}")
            t = b.term
            if isinstance(t, Jump):
                args = ", ".join(a.label() for a in t.args)
                out.append(f"  jump {t.target.name}({args})")
            elif isinstance(t, Branch):
                sync = f" reconv={t.reconv.name}" if t.reconv else ""
                out.append(f"  br {t.pred.label()}.{t.cond} "
                           f"{t.t.name}, {t.f.name}{sync}")
            elif isinstance(t, Ret):
                out.append("  ret")
            else:
                out.append("  <unterminated>")
        out.append("}")
        return "\n".join(out)


# ------------------------------------------------------------- dominators
def dominators(fn: Function) -> Dict[Block, Block]:
    """Immediate dominators (iterative Cooper–Harvey–Kennedy over a
    reverse-postorder).  Entry maps to itself."""
    order: List[Block] = []
    seen = set()

    def dfs(b):
        seen.add(b)
        for s in b.succs():
            if s not in seen:
                dfs(s)
        order.append(b)

    dfs(fn.entry)
    rpo = list(reversed(order))
    rpo_num = {b: i for i, b in enumerate(rpo)}
    preds = fn.preds()
    idom: Dict[Block, Block] = {fn.entry: fn.entry}

    def intersect(a, b):
        while a is not b:
            while rpo_num[a] > rpo_num[b]:
                a = idom[a]
            while rpo_num[b] > rpo_num[a]:
                b = idom[b]
        return a

    changed = True
    while changed:
        changed = False
        for b in rpo[1:]:
            ps = [p for p in preds[b] if p in idom]
            if not ps:
                continue
            new = ps[0]
            for p in ps[1:]:
                new = intersect(new, p)
            if idom.get(b) is not new:
                idom[b] = new
                changed = True
    return idom


def dominates(idom: Dict[Block, Block], a: Block, b: Block) -> bool:
    """Does ``a`` dominate ``b``?"""
    while True:
        if a is b:
            return True
        nxt = idom.get(b)
        if nxt is None or nxt is b:
            return False
        b = nxt


# --------------------------------------------------------------- verifier
def verify(fn: Function) -> None:
    """Structural + dominance checks; raises :class:`CompileError`.

    Run after construction and after every pass (the ``gpgpu_compile``
    smoke fails on verification errors), so a broken pass can never
    silently emit a wrong binary.
    """
    blocks = set(fn.blocks)
    defined: Dict[Value, Tuple[Block, int]] = {}
    for b in fn.blocks:
        for p in b.params:
            defined[p] = (b, -1)
        for i, ins in enumerate(b.instrs):
            defined[ins] = (b, i)
    idom = dominators(fn)

    def check_use(v: Value, b: Block, pos: int, what: str):
        if v not in defined:
            raise CompileError(
                f"{fn.name}: {what} in {b.name} uses undefined value "
                f"{v.label()}")
        db, dpos = defined[v]
        ok = (db is b and dpos < pos) or (db is not b and
                                          dominates(idom, db, b))
        if not ok:
            raise CompileError(
                f"{fn.name}: use of {v.label()} in {b.name} is not "
                f"dominated by its definition in {db.name}")

    for b in fn.blocks:
        if not b.sealed:
            raise CompileError(f"{fn.name}: block {b.name} never sealed")
        if b.term is None:
            raise CompileError(f"{fn.name}: block {b.name} unterminated")
        for i, ins in enumerate(b.instrs):
            for a in ins.args:
                check_use(a, b, i, ins.op)
            if ins.guard:
                g, cond = ins.guard
                check_use(g, b, i, f"guard of {ins.op}")
                if g.type != PRED or cond not in COND_COMPLEMENT:
                    raise CompileError(
                        f"{fn.name}: bad guard on {ins!r}")
            if ins.op in (SELECT, ISET) and ins.args[0].type != PRED:
                raise CompileError(
                    f"{fn.name}: {ins.op} wants a pred operand, got "
                    f"{ins.args[0].label()}")
        t = b.term
        end = len(b.instrs)
        if isinstance(t, Jump):
            if t.target not in blocks:
                raise CompileError(
                    f"{fn.name}: {b.name} jumps to a removed block")
            if len(t.args) != len(t.target.params):
                raise CompileError(
                    f"{fn.name}: jump {b.name} -> {t.target.name} passes "
                    f"{len(t.args)} args for {len(t.target.params)} params")
            for a in t.args:
                check_use(a, b, end, "jump arg")
        elif isinstance(t, Branch):
            check_use(t.pred, b, end, "branch pred")
            if t.pred.type != PRED:
                raise CompileError(
                    f"{fn.name}: branch in {b.name} on a non-pred value")
            for tgt in (t.t, t.f):
                if tgt not in blocks:
                    raise CompileError(
                        f"{fn.name}: {b.name} branches to a removed block")
                if tgt.params:
                    raise CompileError(
                        f"{fn.name}: branch edge {b.name} -> {tgt.name} "
                        "cannot carry block arguments")
    preds = fn.preds()
    for b in fn.blocks:
        for p in preds[b] if b.params else ():
            if not isinstance(p.term, Jump):
                raise CompileError(
                    f"{fn.name}: param block {b.name} has a non-jump "
                    f"predecessor {p.name}")


# --------------------------------------------------------------- builder
class FunctionBuilder:
    """Incremental SSA construction (Braun et al. 2013), driven by the
    DSL tracer: mutable variables are read/written by name, and block
    params materialize exactly where control-flow joins need them.
    Trivial params (all inputs equal) are removed on sealing."""

    def __init__(self, name: str):
        self.fn = Function(name)
        self.current = self.new_block("entry")
        self.current.sealed = True

    # ---------------------------------------------------------- plumbing
    def new_block(self, name: str = "") -> Block:
        b = Block(name)
        self.fn.blocks.append(b)
        return b

    def emit(self, op: str, args: Sequence[Value] = (),
             imm: Optional[int] = None, cond: Optional[str] = None,
             name: str = "") -> Instr:
        if self.current.term is not None:
            raise CompileError(
                f"{self.fn.name}: emitting {op} into terminated block "
                f"{self.current.name}")
        ins = Instr(op, args, imm=imm, cond=cond, name=name)
        ins.block = self.current
        self.current.instrs.append(ins)
        return ins

    def const(self, v: int) -> Instr:
        return self.emit(CONST, imm=i32(int(v)))

    def terminate(self, term: Terminator) -> None:
        if self.current.term is not None:
            raise CompileError(
                f"{self.fn.name}: block {self.current.name} already "
                "terminated")
        self.current.term = term

    # ----------------------------------------------------- SSA variables
    def write_var(self, name: str, value: Value,
                  block: Optional[Block] = None) -> None:
        (block or self.current)._defs[name] = value

    def read_var(self, name: str, block: Optional[Block] = None) -> Value:
        block = block or self.current
        if name in block._defs:
            return block._defs[name]
        return self._read_var_recursive(name, block)

    def _read_var_recursive(self, name: str, block: Block) -> Value:
        preds = self.fn.preds()[block]
        if not block.sealed:
            p = Param(I32, block, name=name)
            block.params.append(p)
            block._incomplete[name] = p
            val: Value = p
        elif len(preds) == 1:
            val = self.read_var(name, preds[0])
        elif len(preds) == 0:
            raise CompileError(
                f"{self.fn.name}: variable {name!r} read before any "
                "assignment reaches it")
        else:
            p = Param(I32, block, name=name)
            block.params.append(p)
            block._defs[name] = p      # break read cycles through loops
            self._add_param_args(block, p, name)
            val = self._try_remove_trivial(block, p)
        block._defs[name] = val
        return val

    def _add_param_args(self, block: Block, p: Param, name: str) -> None:
        for pred in self.fn.preds()[block]:
            t = pred.term
            if not isinstance(t, Jump):
                raise CompileError(
                    f"{self.fn.name}: block {block.name} needs a param "
                    f"for {name!r} but predecessor {pred.name} is not a "
                    "jump edge")
            t.args.append(self.read_var(name, pred))

    def _try_remove_trivial(self, block: Block, p: Param) -> Value:
        idx = block.params.index(p)
        incoming = {t.args[idx] for t in
                    (b.term for b in self.fn.preds()[block])
                    if isinstance(t, Jump)}
        others = {v for v in incoming if v is not p}
        if len(others) != 1:
            return p
        (same,) = others
        block.params.pop(idx)
        for pred in self.fn.preds()[block]:
            if isinstance(pred.term, Jump):
                pred.term.args.pop(idx)
        self.fn.replace_uses(p, same)
        for b in self.fn.blocks:           # keep variable maps coherent
            for k, v in list(b._defs.items()):
                if v is p:
                    b._defs[k] = same
        # removing p may make params that used it trivial in turn
        for b in self.fn.blocks:
            for q in list(b.params):
                if b.sealed and q is not p:
                    self._recheck_trivial(b, q)
        return same

    def _recheck_trivial(self, block: Block, p: Param) -> None:
        if p not in block.params:
            return
        preds = self.fn.preds()[block]
        if not preds or not all(isinstance(b.term, Jump) for b in preds):
            return
        idx = block.params.index(p)
        incoming = {b.term.args[idx] for b in preds}
        if len({v for v in incoming if v is not p}) == 1:
            self._try_remove_trivial(block, p)

    def seal(self, block: Block) -> None:
        if block.sealed:
            return
        block.sealed = True
        for name, p in list(block._incomplete.items()):
            self._add_param_args(block, p, name)
        for name, p in list(block._incomplete.items()):
            self._try_remove_trivial(block, p)
        block._incomplete.clear()

    def finish(self) -> Function:
        self.terminate(Ret())
        for b in self.fn.blocks:
            if not b.sealed:
                raise CompileError(
                    f"{self.fn.name}: block {b.name} left unsealed — "
                    "unclosed if_/for_ context?")
        verify(self.fn)
        return self.fn
