"""Optimization passes over the kernel compiler's SSA IR.

The pipeline (in :data:`DEFAULT_PASSES` order):

* ``unroll``   — full unrolling of constant-trip loops under a size
  budget.  Runs first so the later scalar passes see the unrolled
  straight-line code (shift amounts like ``1 << step`` become constants
  the folder can eat).
* ``fold``     — constant folding + algebraic identities + branch
  folding (a constant condition turns a Branch into a Jump; unreachable
  blocks are pruned).
* ``cse``      — dominator-scoped common-subexpression elimination over
  pure ops (loads are memory-ordered and never merged).
* ``strength`` — ``x * 2^k -> x << k``, ``x / 2^k -> x >> k``,
  ``x % 2^k -> x & (2^k - 1)``: the multiplier-free forms the paper's
  §4.2 customization rewards (a kernel with no IMUL/IMAD runs on the
  multiplier-less overlay variant).
* ``madfuse``  — ``a*b + c -> mad(a,b,c)`` when the multiply has no
  other use: the ISA's only three-operand instruction, one issue
  instead of two.
* ``ifconvert``— short, side-effect-light diamonds/triangles become
  straight-line code: merged values turn into SELECT (SELP) and stores
  into guarded instructions, exactly the predication style of the
  hand-written reduction/bitonic kernels.  Removes the SSY/BRA/.S
  divergence protocol for the converted branch.
* ``dce``      — drops instructions (and block params, with their jump
  arguments) that no store, barrier or terminator depends on.

Every pass re-verifies the IR; `run_passes` records per-pass
instruction counts for the ``gpgpu_compile`` report.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from . import ir
from .ir import (ADD, AND, BAR, COND_COMPLEMENT, CONST, ICMP, ISET, MAD,
                 MUL, NOT, SELECT, SHL, SHR, SUB, UDIV, UMOD, XOR,
                 Block, Branch, CompileError, Function, Instr, Jump,
                 Value, eval_cond, i32)

DEFAULT_PASSES = ("unroll", "fold", "cse", "strength", "madfuse",
                  "ifconvert", "fold", "cse", "dce")


_const_val = ir.const_val
_is_pow2 = ir.is_pow2


# ------------------------------------------------------------------- fold
_FOLDERS = {
    ADD: lambda a, b: a + b,
    SUB: lambda a, b: a - b,
    MUL: lambda a, b: a * b,
    ir.MIN: min,
    ir.MAX: max,
    AND: lambda a, b: a & b,
    ir.OR: lambda a, b: a | b,
    XOR: lambda a, b: a ^ b,
    SHL: lambda a, b: a << (b & 31),
    SHR: lambda a, b: (a & 0xFFFFFFFF) >> (b & 31),
    ir.SAR: lambda a, b: a >> (b & 31),
    UDIV: lambda a, b: (a & 0xFFFFFFFF) // (b & 0xFFFFFFFF),
    UMOD: lambda a, b: (a & 0xFFFFFFFF) % (b & 0xFFFFFFFF),
}


def fold(fn: Function, config=None) -> None:
    """Constant folding, algebraic identities, branch folding."""
    changed = True
    while changed:
        changed = False
        for b in fn.blocks:
            for ins in list(b.instrs):
                new = _fold_one(fn, b, ins)
                if new is not None:
                    fn.replace_uses(ins, new)
                    b.instrs.remove(ins)
                    changed = True
        # branch folding: constant condition -> jump
        for b in fn.blocks:
            t = b.term
            if not isinstance(t, Branch):
                continue
            pred = t.pred
            if not (isinstance(pred, Instr) and pred.op == ICMP):
                continue
            ca, cb = _const_val(pred.args[0]), _const_val(pred.args[1])
            if ca is None or cb is None:
                continue
            taken = eval_cond(t.cond, ca, cb)
            b.term = Jump(t.t if taken else t.f)
            changed = True
        if changed:
            fn.prune_unreachable()
    ir.verify(fn)


def _fold_one(fn: Function, b: Block, ins: Instr) -> Optional[Value]:
    """A replacement value for ``ins``, or None.  May rewrite ``ins``
    in place (returning None) for operand-level simplifications."""
    if ins.guard or ins.op not in ir.PURE_OPS or ins.op == CONST:
        return None
    cvals = [_const_val(a) for a in ins.args]

    def const(v: int) -> Instr:
        c = Instr(CONST, imm=i32(v))
        c.block = b
        b.instrs.insert(b.instrs.index(ins), c)
        return c

    if ins.op in _FOLDERS and None not in cvals:
        if ins.op in (UDIV, UMOD) and cvals[1] == 0:
            raise CompileError(
                f"{fn.name}: constant division by zero "
                f"({ins.op} of {cvals[0]} by 0)")
        return const(_FOLDERS[ins.op](*cvals))
    if ins.op == NOT and cvals[0] is not None:
        return const(~cvals[0])
    if ins.op == ir.ABS and cvals[0] is not None:
        return const(abs(i32(cvals[0])))
    if ins.op == ISET and (ca := _const_icmp(ins.args[0])) is not None:
        return const(int(eval_cond(ins.cond, *ca)))
    if ins.op == SELECT:
        if (ca := _const_icmp(ins.args[0])) is not None:
            return ins.args[1] if eval_cond(ins.cond, *ca) else ins.args[2]
        if ins.args[1] is ins.args[2]:
            return ins.args[1]
    if ins.op not in ir.BINOPS:
        return None
    a, bv = ins.args
    ca, cb = cvals
    # canonicalize: constant to the right of commutative ops (helps CSE
    # and the imm operand slot at emission)
    if ins.op in ir.COMMUTATIVE and ca is not None and cb is None:
        ins.args = [bv, a]
        a, bv, ca, cb = bv, a, cb, ca
    if cb == 0:
        if ins.op in (ADD, SUB, ir.OR, XOR, SHL, SHR, ir.SAR):
            return a
        if ins.op in (MUL, AND):
            return ins.args[1]            # x*0 == x&0 == 0
    if cb == 1 and ins.op in (MUL, UDIV):
        return a
    if cb == 1 and ins.op == UMOD:
        return const(0)
    if cb == -1 and ins.op == AND:
        return a
    if ca == 0 and ins.op == ADD:
        return bv
    if a is bv and ins.op in (XOR, SUB):
        return const(0)
    if a is bv and ins.op in (AND, ir.OR, ir.MIN, ir.MAX):
        return a
    return None


def _const_icmp(v: Value) -> Optional[Tuple[int, int]]:
    if isinstance(v, Instr) and v.op == ICMP:
        a, b = _const_val(v.args[0]), _const_val(v.args[1])
        if a is not None and b is not None:
            return a, b
    return None


# -------------------------------------------------------------------- cse
def cse(fn: Function, config=None) -> None:
    """Dominator-scoped value numbering over pure, unguarded ops."""
    idom = ir.dominators(fn)
    children: Dict[Block, List[Block]] = {b: [] for b in fn.blocks}
    for b in fn.blocks:
        if b is not fn.entry and idom.get(b) is not None:
            children[idom[b]].append(b)

    def key(ins: Instr):
        args = tuple(a.id for a in ins.args)
        if ins.op in ir.COMMUTATIVE:
            args = tuple(sorted(args))
        return (ins.op, args, ins.imm, ins.cond)

    def walk(b: Block, avail: Dict) -> None:
        scope = dict(avail)
        for ins in list(b.instrs):
            if not ins.is_pure() or ins.guard:
                continue
            k = key(ins)
            if k in scope:
                fn.replace_uses(ins, scope[k])
                b.instrs.remove(ins)
            else:
                scope[k] = ins
        for c in children[b]:
            walk(c, scope)

    walk(fn.entry, {})
    ir.verify(fn)


# --------------------------------------------------------------- strength
def strength(fn: Function, config=None) -> None:
    """Multiplies/divides/modulos by powers of two become shifts/masks."""
    for b in fn.blocks:
        for ins in b.instrs:
            if ins.op == MUL:
                for i_const, i_other in ((1, 0), (0, 1)):
                    c = _const_val(ins.args[i_const])
                    if c is not None and _is_pow2(c):
                        sh = Instr(CONST, imm=c.bit_length() - 1)
                        sh.block = b
                        b.instrs.insert(b.instrs.index(ins), sh)
                        ins.op = SHL
                        ins.args = [ins.args[i_other], sh]
                        break
            elif ins.op in (UDIV, UMOD):
                c = _const_val(ins.args[1])
                if c is not None and _is_pow2(c):
                    v = c.bit_length() - 1 if ins.op == UDIV else c - 1
                    nc = Instr(CONST, imm=v)
                    nc.block = b
                    b.instrs.insert(b.instrs.index(ins), nc)
                    ins.op = SHR if ins.op == UDIV else AND
                    ins.args = [ins.args[0], nc]
    ir.verify(fn)


# ---------------------------------------------------------------- madfuse
def madfuse(fn: Function, config=None) -> None:
    """``add(mul(a,b), c)`` -> ``mad(a,b,c)`` when the mul is single-use."""
    uses = fn.uses()
    for b in fn.blocks:
        for ins in b.instrs:
            if ins.op != ADD or ins.guard:
                continue
            for mi, ci in ((0, 1), (1, 0)):
                m = ins.args[mi]
                if (isinstance(m, Instr) and m.op == MUL and not m.guard
                        and uses.get(m, 0) == 1):
                    ins.op = MAD
                    ins.args = [m.args[0], m.args[1], ins.args[ci]]
                    break
    dce(fn)            # the fused muls are now dead


# ----------------------------------------------------------------- unroll
def _natural_loop(fn: Function, header: Block, latch: Block) -> List[Block]:
    """Blocks of the natural loop of backedge latch->header (header
    excluded)."""
    preds = fn.preds()
    body = {latch} if latch is not header else set()
    work = [latch] if latch is not header else []
    while work:
        b = work.pop()
        for p in preds[b]:
            if p is not header and p not in body:
                body.add(p)
                work.append(p)
    return [b for b in fn.blocks if b in body]


def unroll(fn: Function, config=None) -> None:
    """Fully unroll constant-trip loops whose unrolled size stays under
    ``config.unroll_limit`` IR instructions.  Innermost loops only (an
    unrolled outer loop would invalidate inner metadata)."""
    limit = getattr(config, "unroll_limit", 24)
    headers = {lp.header for lp in fn.loops}
    for lp in list(fn.loops):
        if lp.header not in {b for b in fn.blocks}:
            continue
        start, stop, step = (_const_val(v) for v in
                             (lp.start, lp.stop, lp.step))
        if step is not None and step <= 0:
            # a traced (non-literal) step that folded to a constant —
            # the tracer's literal check could not see it
            raise CompileError(
                f"{fn.name}: for_ step folded to {step}; steps must be "
                "positive (a zero step never terminates)")
        if start is None or stop is None or step is None:
            continue
        trip = max(0, -(-(stop - start) // step))
        body = _natural_loop(fn, lp.header, lp.latch)
        if any(b in headers and b is not lp.header for b in body):
            continue                      # not innermost
        # the canonical header holds exactly the trip test; anything
        # else means a pass reshaped the loop — leave it alone
        if not (len(lp.header.instrs) == 1
                and lp.header.instrs[0].op == ICMP
                and isinstance(lp.header.term, Branch)):
            continue
        n_body = sum(len(b.instrs) for b in body) + len(lp.header.instrs)
        if trip * n_body > limit:
            continue
        _unroll_one(fn, lp, trip, body)
        fn.loops.remove(lp)
    fn.prune_unreachable()
    ir.verify(fn)


def _unroll_one(fn: Function, lp: ir.LoopInfo, trip: int,
                body: List[Block]) -> None:
    """Replace the loop with ``trip`` cloned copies of its body."""
    pre_jump = lp.preheader.term
    assert isinstance(pre_jump, Jump) and pre_jump.target is lp.header
    # current values of the header params, starting from the preheader
    env: Dict[Value, Value] = dict(zip(lp.header.params, pre_jump.args))
    latch_jump = lp.latch.term
    assert isinstance(latch_jump, Jump) and latch_jump.target is lp.header
    entry = lp.header.term.t              # first body block per iteration
    insert_at = fn.blocks.index(lp.header)

    def resolve(v: Value, vmap: Dict[Value, Value]) -> Value:
        return vmap.get(v, env.get(v, v))

    prev_tail: Block = lp.preheader
    prev_tail.term = None
    for _ in range(trip):
        vmap: Dict[Value, Value] = {}
        clones: Dict[Block, Block] = {}
        order = [b for b in body]
        for b in order:
            nb = Block(b.name + "u")
            nb.sealed = True
            clones[b] = nb
            for p in b.params:            # joins inside the body
                np_ = ir.Param(p.type, nb, name=p.name)
                nb.params.append(np_)
                vmap[p] = np_
        # header instrs (the trip test) are dropped; its params resolve
        # through env.  Body blocks clone with value substitution.
        for b in order:
            nb = clones[b]
            for insn in b.instrs:
                c = Instr(insn.op, [resolve(a, vmap) for a in insn.args],
                          imm=insn.imm, cond=insn.cond, name=insn.name)
                if insn.guard:
                    c.guard = (resolve(insn.guard[0], vmap),
                               insn.guard[1])
                c.block = nb
                nb.instrs.append(c)
                vmap[insn] = c
            t = b.term
            if isinstance(t, Jump):
                if t.target is lp.header:
                    continue              # rewired below
                nb.term = Jump(clones.get(t.target, t.target),
                               [resolve(a, vmap) for a in t.args])
            elif isinstance(t, Branch):
                nb.term = Branch(resolve(t.pred, vmap), t.cond,
                                 clones.get(t.t, t.t),
                                 clones.get(t.f, t.f),
                                 reconv=clones.get(t.reconv, t.reconv)
                                 if t.reconv else None)
        new_blocks = [clones[b] for b in order]
        fn.blocks[insert_at:insert_at] = new_blocks
        insert_at += len(new_blocks)
        prev_tail.term = Jump(clones[entry])
        prev_tail = clones[lp.latch]
        env = {p: resolve(a, vmap)
               for p, a in zip(lp.header.params, latch_jump.args)}
    # the loop exit now follows straight-line from the last latch clone
    prev_tail.term = Jump(lp.exit)
    # uses of the header params after the loop see the final values
    for p, v in env.items():
        fn.replace_uses(p, v)
    # the original header and body are now unreachable; pruned by caller


# -------------------------------------------------------------- ifconvert
def ifconvert(fn: Function, config=None) -> None:
    """Convert short triangles/diamonds to predication.

    A branch whose arms are single blocks with only speculation-safe
    instructions (pure ops and loads — addresses clip on this machine)
    plus at most guarded-able stores, and no instruction already
    guarded, merges into the branch block: stores take a guard, join
    params become SELECTs.  This is exactly how the hand-written
    reduction kernel predicates its tree phase, and it deletes the
    SSY/.S warp-stack round trip for the converted if.
    """
    max_side = getattr(config, "if_convert_max", 8)
    changed = True
    while changed:
        changed = False
        preds = fn.preds()
        for b in list(fn.blocks):
            t = b.term
            if not isinstance(t, Branch):
                continue
            join = _conv_join(t)
            if join is None or t.t is join or t.f is join \
                    or t.t is t.f:
                continue
            arms = (t.t, t.f)
            if not all(_convertible(a, preds, join, max_side)
                       for a in arms):
                continue
            # splice arm instructions (guarding stores), then select the
            # join params
            arg_of = {}
            for arm, cond in ((t.t, t.cond),
                              (t.f, COND_COMPLEMENT[t.cond])):
                for insn in arm.instrs:
                    if insn.op in ir.EFFECT_OPS:
                        insn.guard = (t.pred, cond)
                    insn.block = b
                    b.instrs.append(insn)
                arg_of[arm] = list(arm.term.args)
                arm.instrs = []
            new_args: List[Value] = []
            for i, p in enumerate(join.params):
                ta, fa = arg_of[t.t][i], arg_of[t.f][i]
                if ta is fa:
                    new_args.append(ta)
                    continue
                sel = Instr(SELECT, [t.pred, ta, fa], cond=t.cond)
                sel.block = b
                b.instrs.append(sel)
                new_args.append(sel)
            b.term = Jump(join, new_args)
            for arm in arms:
                fn.blocks.remove(arm)
            changed = True
            break
    fn.prune_unreachable()
    ir.verify(fn)


def _conv_join(t: Branch) -> Optional[Block]:
    """The common join block of a convertible triangle/diamond."""
    tt, ft = t.t.term, t.f.term
    if isinstance(tt, Jump) and isinstance(ft, Jump) \
            and tt.target is ft.target:
        return tt.target
    return None


def _convertible(arm: Block, preds, join: Block, max_side: int) -> bool:
    if len(preds[arm]) != 1 or arm.params:
        return False
    if not isinstance(arm.term, Jump) or arm.term.target is not join:
        return False
    if len(arm.instrs) > max_side:
        return False
    for insn in arm.instrs:
        if insn.guard is not None:
            return False                  # no nested predication
        if insn.op == BAR:
            return False
        if not (insn.is_pure() or insn.op in ir.LOAD_OPS
                or insn.op in ir.STORE_OPS):
            return False
    return True


# -------------------------------------------------------------------- dce
def dce(fn: Function, config=None) -> None:
    """Remove instructions and block params nothing observable needs."""
    live: set = set()
    work: List[Value] = []

    def mark(v: Value):
        if v not in live:
            live.add(v)
            work.append(v)

    param_pos: Dict[Value, Tuple[Block, int]] = {}
    for b in fn.blocks:
        for i, p in enumerate(b.params):
            param_pos[p] = (b, i)
        for ins in b.instrs:
            if ins.op in ir.EFFECT_OPS:
                mark(ins)
        if isinstance(b.term, Branch):
            mark(b.term.pred)
    preds = fn.preds()
    while work:
        v = work.pop()
        if isinstance(v, Instr):
            for a in v.args:
                mark(a)
            if v.guard:
                mark(v.guard[0])
        else:                             # live param: its jump args live
            blk, idx = param_pos[v]
            for p in preds[blk]:
                if isinstance(p.term, Jump):
                    mark(p.term.args[idx])
    for b in fn.blocks:
        b.instrs = [i for i in b.instrs if i in live]
        if b.params and not all(p in live for p in b.params):
            keep = [i for i, p in enumerate(b.params) if p in live]
            b.params = [b.params[i] for i in keep]
            for p in preds[b]:
                if isinstance(p.term, Jump):
                    p.term.args = [p.term.args[i] for i in keep]
    ir.verify(fn)


PASSES = {"fold": fold, "cse": cse, "strength": strength,
          "madfuse": madfuse, "unroll": unroll, "ifconvert": ifconvert,
          "dce": dce}


def check_loop_steps(fn: Function) -> None:
    """Reject loops whose step is a non-positive constant.  The tracer
    catches literal steps; this catches traced expressions that only
    *fold* to a constant (e.g. ``k.ntid - k.ntid``), which would emit
    an induction variable that never advances."""
    for lp in fn.loops:
        if lp.header not in fn.blocks:
            continue
        step = _const_val(lp.step)
        if step is not None and step <= 0:
            raise CompileError(
                f"{fn.name}: for_ step folded to {step}; steps must be "
                "positive (a zero step never terminates)")


def run_passes(fn: Function, names=DEFAULT_PASSES,
               config=None) -> List[Tuple[str, int]]:
    """Run the pipeline; returns ``[(pass, ir_instrs_after), ...]``."""
    log = [("trace", fn.n_instrs())]
    for name in names:
        try:
            PASSES[name](fn, config)
        except KeyError:
            raise CompileError(f"unknown pass {name!r}; "
                               f"choose from {sorted(PASSES)}") from None
        log.append((name, fn.n_instrs()))
    check_loop_steps(fn)
    return log
