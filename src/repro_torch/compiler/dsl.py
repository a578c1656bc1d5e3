"""CUDA-style kernel DSL: trace a Python function into SSA IR.

A kernel is a plain Python function taking a :class:`Kernel` context
(conventionally ``k``) plus compile-time parameters (python ints —
the analogue of template / launch constants baked into the binary):

    def saxpy_ish(k, n, a):
        i = k.blockIdx.x * k.blockDim.x + k.threadIdx.x
        with k.if_(i < n):
            k.gmem[Y_AT + i] = a * k.gmem[X_AT + i] + k.gmem[Y_AT + i]

Tracing runs the function once; arithmetic on :class:`Expr` values
records IR instructions, ``with k.if_(...)`` / ``with k.for_(...)``
build structured control flow, and mutable state that must cross a
control-flow edge lives in :meth:`Kernel.var` cells (plain Python
rebinding is invisible to a tracer).  The ISA is integer-only, so every
value is an int32 lane value; comparisons produce predicate values
consumed by ``if_`` / ``select`` or materialized to 0/1 on demand.

Divergence is tracked statically: a value is *uniform* when it provably
does not depend on the thread index or on loaded data.  ``for_`` bounds
must be uniform (the machine's warp stack reconverges structured ifs,
not data-dependent loops); a non-uniform ``if_`` records its
reconvergence block so codegen emits the paper's SSY / ``.S`` warp
stack protocol, and ``syncthreads`` inside one is rejected at trace
time — the hardware would deadlock the barrier.
"""
from __future__ import annotations

from typing import Optional, Union

from ..core import isa
from . import ir
from .ir import CompileError, FunctionBuilder

IntLike = Union[int, "Expr", "Var"]

#: special registers that are warp-uniform (same value for every thread
#: of a block): block/grid geometry and the block index.
_UNIFORM_SREGS = frozenset({
    isa.SR_CTAX, isa.SR_CTAY, isa.SR_NTIDX, isa.SR_NTIDY,
    isa.SR_NCTAX, isa.SR_NCTAY, isa.SR_CTA, isa.SR_NTID})


class Expr:
    """A traced int32 value; arithmetic emits IR into the kernel."""
    __slots__ = ("k", "value", "uniform")

    def __init__(self, k: "Kernel", value: ir.Value, uniform: bool):
        self.k = k
        self.value = value
        self.uniform = uniform

    # -------------------------------------------------------- arithmetic
    def _bin(self, op: str, other: IntLike, swap: bool = False) -> "Expr":
        a, b = self.k._as_expr(other), self
        if not swap:
            a, b = b, a
        v = self.k._emit(op, [a.value, b.value])
        return Expr(self.k, v, a.uniform and b.uniform)

    def __add__(self, o): return self._bin(ir.ADD, o)
    def __radd__(self, o): return self._bin(ir.ADD, o, swap=True)
    def __sub__(self, o): return self._bin(ir.SUB, o)
    def __rsub__(self, o): return self._bin(ir.SUB, o, swap=True)
    def __mul__(self, o): return self._bin(ir.MUL, o)
    def __rmul__(self, o): return self._bin(ir.MUL, o, swap=True)
    def __and__(self, o): return self._bin(ir.AND, o)
    def __rand__(self, o): return self._bin(ir.AND, o, swap=True)
    def __or__(self, o): return self._bin(ir.OR, o)
    def __ror__(self, o): return self._bin(ir.OR, o, swap=True)
    def __xor__(self, o): return self._bin(ir.XOR, o)
    def __rxor__(self, o): return self._bin(ir.XOR, o, swap=True)
    def __lshift__(self, o): return self._bin(ir.SHL, o)
    def __rlshift__(self, o): return self._bin(ir.SHL, o, swap=True)
    def __rshift__(self, o): return self._bin(ir.SHR, o)
    def __rrshift__(self, o): return self._bin(ir.SHR, o, swap=True)

    def __floordiv__(self, o): return self._bin(ir.UDIV, o)
    def __rfloordiv__(self, o): return self._bin(ir.UDIV, o, swap=True)
    def __mod__(self, o): return self._bin(ir.UMOD, o)
    def __rmod__(self, o): return self._bin(ir.UMOD, o, swap=True)

    def __invert__(self):
        return Expr(self.k, self.k._emit(ir.NOT, [self.value]),
                    self.uniform)

    def __neg__(self):
        zero = self.k._as_expr(0)
        return Expr(self.k, self.k._emit(ir.SUB, [zero.value, self.value]),
                    self.uniform)

    # ------------------------------------------------------- comparisons
    def _cmp(self, cond: str, other: IntLike) -> "Cmp":
        o = self.k._as_expr(other)
        v = self.k._emit(ir.ICMP, [self.value, o.value], cond=cond)
        return Cmp(self.k, v, cond, self.uniform and o.uniform)

    def __lt__(self, o): return self._cmp("LT", o)
    def __le__(self, o): return self._cmp("LE", o)
    def __gt__(self, o): return self._cmp("GT", o)
    def __ge__(self, o): return self._cmp("GE", o)
    def __eq__(self, o): return self._cmp("EQ", o)     # noqa: D105
    def __ne__(self, o): return self._cmp("NE", o)

    __hash__ = None       # comparison overloads make Expr unhashable


class Cmp:
    """A traced predicate: the SZCO nibble of an ICMP plus the condition
    code the author meant.  Consumed by ``if_`` / ``select`` / guards;
    arithmetic use materializes it to 0/1 via :meth:`to_i32`."""
    __slots__ = ("k", "value", "cond", "uniform")

    def __init__(self, k: "Kernel", value: ir.Value, cond: str,
                 uniform: bool):
        self.k = k
        self.value = value
        self.cond = cond
        self.uniform = uniform

    def __invert__(self) -> "Cmp":
        return Cmp(self.k, self.value, ir.COND_COMPLEMENT[self.cond],
                   self.uniform)

    def to_i32(self) -> Expr:
        """Materialize as 1 (condition holds) / 0 — the ISA's ISET."""
        v = self.k._emit(ir.ISET, [self.value], cond=self.cond)
        return Expr(self.k, v, self.uniform)

    # arithmetic on a predicate implicitly materializes it, so
    # ``cnt.set(cnt + (v == t))`` counts matches without branching
    def __add__(self, o): return self.to_i32() + o
    def __radd__(self, o): return self.k._as_expr(o) + self.to_i32()
    def __mul__(self, o): return self.to_i32() * o
    def __rmul__(self, o): return self.k._as_expr(o) * self.to_i32()

    __hash__ = None


class Var:
    """A mutable int32 cell: the only state that survives control flow.

    Reads and writes go through the builder's SSA variable map, so a
    value carried around a loop or merged after an ``if_`` becomes a
    block argument exactly where needed (Braun-style construction).
    Storing a comparison materializes it to 0/1 first — predicates
    cannot flow through joins (the ISA has no predicate move).
    """
    __slots__ = ("k", "name", "_uniform")
    _counter = 0

    def __init__(self, k: "Kernel", init: IntLike, name: Optional[str]):
        Var._counter += 1
        self.k = k
        self.name = name or f"v{Var._counter}"
        self._uniform = True
        self.set(init)

    def get(self) -> Expr:
        self.k._flush_pending_else()
        v = self.k.fb.read_var(self.name)
        return Expr(self.k, v, self._uniform)

    def set(self, value: IntLike) -> None:
        e = self.k._as_expr(value)
        # a cell written under non-uniform control flow is non-uniform
        # from then on, whatever the value: which write landed depends
        # on the lane
        self._uniform = (self._uniform and e.uniform
                         and self.k._divergence == 0)
        self.k.fb.write_var(self.name, e.value)

    # reading sugar: vars participate in arithmetic like Exprs
    def _e(self): return self.get()
    def __add__(self, o): return self._e() + o
    def __radd__(self, o): return self.k._as_expr(o) + self._e()
    def __sub__(self, o): return self._e() - o
    def __rsub__(self, o): return self.k._as_expr(o) - self._e()
    def __mul__(self, o): return self._e() * o
    def __rmul__(self, o): return self.k._as_expr(o) * self._e()
    def __and__(self, o): return self._e() & o
    def __or__(self, o): return self._e() | o
    def __xor__(self, o): return self._e() ^ o
    def __lshift__(self, o): return self._e() << o
    def __rlshift__(self, o): return self.k._as_expr(o) << self._e()
    def __rshift__(self, o): return self._e() >> o
    def __rrshift__(self, o): return self.k._as_expr(o) >> self._e()
    def __floordiv__(self, o): return self._e() // o
    def __mod__(self, o): return self._e() % o
    def __invert__(self): return ~self._e()
    def __neg__(self): return -self._e()
    def __lt__(self, o): return self._e() < o
    def __le__(self, o): return self._e() <= o
    def __gt__(self, o): return self._e() > o
    def __ge__(self, o): return self._e() >= o
    def __eq__(self, o): return self._e() == o        # noqa: D105
    def __ne__(self, o): return self._e() != o
    __hash__ = None


class _Dim3:
    """``threadIdx`` / ``blockIdx`` / … accessor with .x / .y."""
    __slots__ = ("k", "_x", "_y")

    def __init__(self, k: "Kernel", sr_x: int, sr_y: int):
        self.k = k
        self._x = sr_x
        self._y = sr_y

    @property
    def x(self) -> Expr:
        return self.k._sreg(self._x)

    @property
    def y(self) -> Expr:
        return self.k._sreg(self._y)


class _Mem:
    """``k.gmem[...]`` / ``k.smem[...]`` — word-addressed load/store."""
    __slots__ = ("k", "load_op", "store_op")

    def __init__(self, k: "Kernel", load_op: str, store_op: str):
        self.k = k
        self.load_op = load_op
        self.store_op = store_op

    def __getitem__(self, idx: IntLike) -> Expr:
        a = self.k._as_expr(idx)
        v = self.k._emit(self.load_op, [a.value])
        return Expr(self.k, v, False)     # loaded data: never uniform

    def __setitem__(self, idx: IntLike, value: IntLike) -> None:
        a = self.k._as_expr(idx)
        v = self.k._as_expr(value)
        self.k._emit(self.store_op, [a.value, v.value])


class _If:
    """``with k.if_(cond):`` — then-branch context, optional
    ``with k.else_():`` immediately after."""

    def __init__(self, k: "Kernel", cond: Cmp):
        self.k = k
        self.cond = cond
        self.then_blk: Optional[ir.Block] = None
        self.else_stub: Optional[ir.Block] = None
        self.join: Optional[ir.Block] = None
        self.divergent = not cond.uniform

    def __enter__(self):
        k = self.k
        k._flush_pending_else()
        fb = k.fb
        self.then_blk = fb.new_block("then")
        self.else_stub = fb.new_block("else")
        self.join = fb.new_block("endif")
        fb.terminate(ir.Branch(self.cond.value, self.cond.cond,
                               self.then_blk, self.else_stub,
                               reconv=self.join if self.divergent
                               else None))
        fb.current = self.then_blk
        fb.seal(self.then_blk)
        if self.divergent:
            k._divergence += 1
        return self

    def __exit__(self, exc_type, *_):
        if exc_type is not None:
            return False
        k = self.k
        k._flush_pending_else()
        k.fb.terminate(ir.Jump(self.join))
        if self.divergent:
            k._divergence -= 1
        # park in the (still-unsealed) else stub: either k.else_() claims
        # it next, or the first other operation flushes it to a fall-
        # through edge
        k.fb.current = self.else_stub
        k.fb.seal(self.else_stub)
        k._pending_else = self
        return False


class _Else:
    def __init__(self, k: "Kernel", branch: _If):
        self.k = k
        self.branch = branch

    def __enter__(self):
        if self.branch.divergent:
            self.k._divergence += 1
        return self

    def __exit__(self, exc_type, *_):
        if exc_type is not None:
            return False
        k = self.k
        k._flush_pending_else()       # nested if inside the else body
        if self.branch.divergent:
            k._divergence -= 1
        k.fb.terminate(ir.Jump(self.branch.join))
        k.fb.seal(self.branch.join)
        k.fb.current = self.branch.join
        return False


class _For:
    """``with k.for_(start, stop, step) as i:`` — a uniform counted loop.

    Lowers to preheader -> header(i, carried...) -> body ... latch ->
    header, exit; the trip test is ``i < stop`` in the header.  Bounds
    must be warp-uniform: the warp stack reconverges structured ifs,
    not data-dependent loop exits, and a divergent backward branch
    would let some lanes escape with divergence state still stacked.
    """
    _counter = 0

    def __init__(self, k: "Kernel", start: IntLike, stop: IntLike,
                 step: IntLike):
        self.k = k
        self.bounds = (start, stop, step)

    def __enter__(self) -> Expr:
        k = self.k
        k._flush_pending_else()
        fb = k.fb
        start, stop, step = (k._as_expr(b) for b in self.bounds)
        for what, e in (("start", start), ("stop", stop), ("step", step)):
            if not e.uniform:
                raise CompileError(
                    f"{fb.fn.name}: for_ {what} must be warp-uniform "
                    "(loop trip counts cannot diverge on this machine); "
                    "use if_ for per-thread conditions")
        step_const = int(self.bounds[2]) \
            if isinstance(self.bounds[2], (int, bool)) \
            else ir.const_val(step.value)
        if step_const is not None and step_const <= 0:
            raise CompileError(
                f"{fb.fn.name}: for_ step must be positive, got "
                f"{step_const} — a zero step never terminates and "
                "counting down is not supported (iterate up and index "
                "with (stop - 1 - i))")
        _For._counter += 1
        self.ivar = f"$i{_For._counter}"
        self.preheader = fb.current
        self.header = fb.new_block("loop")
        self.body = fb.new_block("body")
        self.exit = fb.new_block("endloop")
        self.start, self.stop, self.step = start, stop, step
        fb.write_var(self.ivar, start.value)
        fb.terminate(ir.Jump(self.header))
        fb.current = self.header            # unsealed: latch still unknown
        i = fb.read_var(self.ivar)          # creates the induction param
        cmp = k._emit(ir.ICMP, [i, stop.value], cond="LT")
        fb.terminate(ir.Branch(cmp, "LT", self.body, self.exit,
                               reconv=None))
        fb.current = self.body
        fb.seal(self.body)
        return Expr(k, i, True)

    def __exit__(self, exc_type, *_):
        if exc_type is not None:
            return False
        k = self.k
        k._flush_pending_else()
        fb = k.fb
        i = fb.read_var(self.ivar)
        nxt = k._emit(ir.ADD, [i, self.step.value])
        fb.write_var(self.ivar, nxt)
        latch = fb.current
        fb.terminate(ir.Jump(self.header))
        fb.seal(self.header)
        fb.seal(self.exit)
        fb.current = self.exit
        fb.fn.loops.append(ir.LoopInfo(
            self.preheader, self.header, latch, self.exit,
            self.start.value, self.stop.value, self.step.value))
        return False


class Kernel:
    """The tracing context handed to a DSL kernel function."""

    def __init__(self, name: str):
        self.fb = FunctionBuilder(name)
        self.threadIdx = _Dim3(self, isa.SR_TIDX, isa.SR_TIDY)
        self.blockIdx = _Dim3(self, isa.SR_CTAX, isa.SR_CTAY)
        self.blockDim = _Dim3(self, isa.SR_NTIDX, isa.SR_NTIDY)
        self.gridDim = _Dim3(self, isa.SR_NCTAX, isa.SR_NCTAY)
        self.gmem = _Mem(self, ir.LDG, ir.STG)
        self.smem = _Mem(self, ir.LDS, ir.STS)
        self._divergence = 0              # nested non-uniform if_ depth
        self._pending_else: Optional[_If] = None

    # ------------------------------------------------------ trace helpers
    def _flush_pending_else(self) -> None:
        """Commit a just-closed ``if_`` once it is clear no ``else_``
        follows: the parked else stub falls through to the join."""
        p, self._pending_else = self._pending_else, None
        if p is None:
            return
        self.fb.terminate(ir.Jump(p.join))
        self.fb.seal(p.join)
        self.fb.current = p.join

    def _emit(self, op, args, imm=None, cond=None) -> ir.Instr:
        self._flush_pending_else()
        return self.fb.emit(op, args, imm=imm, cond=cond)

    def _sreg(self, sr: int) -> Expr:
        v = self._emit(ir.SREG, [], imm=sr)
        return Expr(self, v, sr in _UNIFORM_SREGS)

    def _as_expr(self, v: IntLike) -> Expr:
        if isinstance(v, Expr):
            return v
        if isinstance(v, Var):
            return v.get()
        if isinstance(v, Cmp):
            return v.to_i32()
        if isinstance(v, (int, bool)):
            self._flush_pending_else()
            return Expr(self, self.fb.const(int(v)), True)
        raise CompileError(
            f"{self.fb.fn.name}: cannot trace a {type(v).__name__} as an "
            "int32 kernel value")

    def _as_cmp(self, c) -> Cmp:
        if isinstance(c, Cmp):
            return c
        if isinstance(c, (Expr, Var)):
            return self._as_expr(c) != 0
        raise CompileError(
            f"{self.fb.fn.name}: condition must be a comparison or an "
            f"int32 value, got {type(c).__name__}")

    # ---------------------------------------------------------- public API
    @property
    def tid(self) -> Expr:
        """Flat thread index within the block (SR_TID)."""
        return self._sreg(isa.SR_TID)

    @property
    def ctaid(self) -> Expr:
        """Flat block index within the grid (SR_CTA)."""
        return self._sreg(isa.SR_CTA)

    @property
    def ntid(self) -> Expr:
        """Flat block size (SR_NTID)."""
        return self._sreg(isa.SR_NTID)

    def var(self, init: IntLike = 0, name: Optional[str] = None) -> Var:
        """A mutable int32 cell (survives if_/for_ control flow)."""
        self._flush_pending_else()
        return Var(self, init, name)

    def if_(self, cond) -> _If:
        return _If(self, self._as_cmp(cond))

    def else_(self) -> _Else:
        p, self._pending_else = self._pending_else, None
        if p is None:
            raise CompileError(
                f"{self.fb.fn.name}: else_ must immediately follow an "
                "if_ block")
        # reclaim the parked stub as the real else body
        self.fb.current = p.else_stub
        return _Else(self, p)

    def for_(self, start: IntLike, stop: IntLike,
             step: IntLike = 1) -> _For:
        return _For(self, start, stop, step)

    def syncthreads(self) -> None:
        """Block barrier (BAR).  Rejected under divergent control flow:
        lanes parked on the warp stack would never reach the barrier."""
        if self._divergence > 0:
            raise CompileError(
                f"{self.fb.fn.name}: syncthreads() inside a divergent "
                "if_ would deadlock the barrier; hoist it out or make "
                "the condition uniform")
        self._emit(ir.BAR, [])

    def select(self, cond, a: IntLike, b: IntLike) -> Expr:
        """``cond ? a : b`` without branching (SELP)."""
        c = self._as_cmp(cond)
        ae, be = self._as_expr(a), self._as_expr(b)
        v = self._emit(ir.SELECT, [c.value, ae.value, be.value],
                       cond=c.cond)
        return Expr(self, v, c.uniform and ae.uniform and be.uniform)

    def min_(self, a: IntLike, b: IntLike) -> Expr:
        ae, be = self._as_expr(a), self._as_expr(b)
        return Expr(self, self._emit(ir.MIN, [ae.value, be.value]),
                    ae.uniform and be.uniform)

    def max_(self, a: IntLike, b: IntLike) -> Expr:
        ae, be = self._as_expr(a), self._as_expr(b)
        return Expr(self, self._emit(ir.MAX, [ae.value, be.value]),
                    ae.uniform and be.uniform)

    def abs_(self, a: IntLike) -> Expr:
        ae = self._as_expr(a)
        return Expr(self, self._emit(ir.ABS, [ae.value]), ae.uniform)

    def sar(self, a: IntLike, b: IntLike) -> Expr:
        """Arithmetic right shift (``>>`` is logical on this machine)."""
        ae, be = self._as_expr(a), self._as_expr(b)
        return Expr(self, self._emit(ir.SAR, [ae.value, be.value]),
                    ae.uniform and be.uniform)


def trace(fn, params: Optional[dict] = None,
          name: Optional[str] = None) -> ir.Function:
    """Run ``fn(k, **params)`` under tracing; returns verified SSA IR."""
    k = Kernel(name or fn.__name__)
    fn(k, **(params or {}))
    k._flush_pending_else()
    return k.fb.finish()
