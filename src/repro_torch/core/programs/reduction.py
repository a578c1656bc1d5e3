"""Parallel reduction (sum) — NVIDIA SDK style, shared-memory tree.

Each block of BD threads reduces 2*BD elements (first add during load).
The inner tree uses *predication* instead of branches — exactly why the
paper's reduction variant needs a warp-stack depth of 0 (Table 6).
Multi-block inputs produce per-block partials reduced by a second launch
(the host loop in :func:`run_passes`).
"""
import numpy as np

from .. import asm, isa

BD = 128  # threads per block; each block consumes 2*BD inputs
IN_AT = 16  # input after a 16-word parameter block


def build(n: int) -> np.ndarray:
    """One reduction pass: gmem[0] holds n_in; in at IN_AT, out at 1."""
    p = asm.Program("reduction")
    p.s2r("r0", isa.SR_TID)             # tid in block
    p.s2r("r1", isa.SR_CTA)             # flat block id
    p.s2r("r2", isa.SR_NTID)            # block size
    p.mov("r12", 0)
    p.ldg("r13", "r12", 0)              # r13 = n_in (parameter word 0)
    # base = cta * 2*BD ; i = base + tid
    p.iadd("r3", "r2", "r2")            # 2*BD
    p.imul("r4", "r1", "r3")            # base
    p.iadd("r5", "r4", "r0")            # i = base + tid
    # first add during load, with bounds predication
    p.mov("r6", 0)
    p.isetp("p0", "r5", "r13")          # i < n_in ?
    p.guard("p0", "LT").ldg("r6", "r5", IN_AT)
    p.iadd("r7", "r5", "r2")            # i + BD
    p.mov("r8", 0)
    p.isetp("p1", "r7", "r13")
    p.guard("p1", "LT").ldg("r8", "r7", IN_AT)
    p.iadd("r6", "r6", "r8")
    p.sts("r0", "r6")
    p.bar()
    # tree: for s = BD/2 .. 1: if tid < s: sm[tid] += sm[tid+s]
    p.shr("r9", "r2", 1)                # s = BD/2
    p.label("tree")
    p.isetp("p2", "r0", "r9")           # tid < s ?
    p.guard("p2", "LT").iadd("r10", "r0", "r9")
    p.guard("p2", "LT").lds("r11", "r10")
    p.guard("p2", "LT").lds("r6", "r0")
    p.guard("p2", "LT").iadd("r6", "r6", "r11")
    p.guard("p2", "LT").sts("r0", "r6")
    p.bar()
    p.shr("r9", "r9", 1)
    p.isetp("p3", "r9", 0)
    p.guard("p3", "GT").bra("tree")     # uniform
    # thread 0 writes the block partial to out[cta] (out after the input)
    p.isetp("p0", "r0", 0)
    p.guard("p0", "EQ").lds("r6", "r0")
    p.iadd("r11", "r1", 0)
    p.guard("p0", "EQ").stg("r11", "r6", IN_AT + n)
    p.exit()
    from . import PROGRAM_PAD
    return p.finish(pad_to=PROGRAM_PAD)


def launch(n: int):
    blocks = max(1, -(-n // (2 * BD)))
    return (blocks, 1), (min(BD, max(32, n // 2 or 32)), 1)


def n_threads(n: int) -> int:
    g, b = launch(n)
    return g[0] * g[1] * b[0] * b[1]


def make_gmem(rng: np.random.Generator, n: int) -> np.ndarray:
    blocks = launch(n)[0][0]
    g = np.zeros(IN_AT + n + blocks, np.int32)
    g[0] = n
    g[IN_AT:IN_AT + n] = rng.integers(-1000, 1000, n, dtype=np.int32)
    return g


def out_slice(n: int) -> slice:
    return slice(IN_AT + n, IN_AT + n + 1)  # final partial after host passes


def oracle(gmem0: np.ndarray, n: int) -> np.ndarray:
    return np.array([gmem0[IN_AT:IN_AT + n].astype(np.int64).sum()],
                    dtype=np.int32)


def run_passes(run_grid_fn, code, n, gmem, **kw):
    """Host-side multi-pass driver: reduce until one partial remains.

    Returns (final gmem, list of per-pass GridResult).  The paper's sizes
    (<=256) need a single pass; larger inputs exercise the block
    scheduler across many blocks.
    """
    results = []
    n_in = n
    while True:
        grid, bd = launch(n_in)
        res = run_grid_fn(code, grid, bd, gmem, **kw)
        results.append(res)
        gmem = res.gmem.copy()
        n_out = grid[0]
        if n_out == 1:
            return gmem, results  # final partial sits at IN_AT + n
        # move partials (always written at IN_AT + n, the immediate baked
        # into the binary) into the input region for the next pass
        gmem[0] = n_out
        gmem[IN_AT:IN_AT + n_out] = gmem[IN_AT + n:IN_AT + n + n_out]
        n_in = n_out
