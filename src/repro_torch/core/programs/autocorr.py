"""Autocorrelation: r[k] = sum_i x[i] * x[i+k], one thread per lag.

Threads in a warp have different loop trip counts (N - k), so the
loop-exit branch *diverges* every few iterations — this is the paper's
control-intensive benchmark (warp-stack depth 16 in Table 6, worst 2-SM
scaling after reduction in Table 3).
"""
import numpy as np

from .. import asm, isa

BD = 64
IN_AT = 0


def build(n: int) -> np.ndarray:
    p = asm.Program("autocorr")
    p.s2r("r0", isa.SR_TID)
    p.s2r("r1", isa.SR_CTA)
    p.s2r("r2", isa.SR_NTID)
    p.imad("r3", "r1", "r2", "r0")      # k = global lag index
    p.mov("r4", 0)                      # acc
    p.mov("r5", 0)                      # i
    p.mov("r6", n)
    p.isub("r7", "r6", "r3")            # trip = n - k
    p.ssy("done")
    p.isetp("p0", "r5", "r7")           # i < trip ? (guards empty loops)
    p.guard("p0", "GE").bra("done")
    p.label("loop")
    p.ldg("r8", "r5", IN_AT)            # x[i]
    p.iadd("r9", "r5", "r3")
    p.ldg("r10", "r9", IN_AT)           # x[i+k]
    p.imad("r4", "r8", "r10", "r4")
    p.iadd("r5", "r5", 1)
    p.isetp("p0", "r5", "r7")
    p.guard("p0", "LT").bra("loop")     # DIVERGES: trip varies per lane
    p.label("done", sync=True)
    p.stg("r3", "r4", n)                # r at gmem[n + k]
    p.exit()
    from . import PROGRAM_PAD
    return p.finish(pad_to=PROGRAM_PAD)


def launch(n: int):
    lags = n  # compute every lag 0..n-1
    return (max(1, -(-lags // BD)), 1), (min(BD, lags), 1)


def n_threads(n: int) -> int:
    g, b = launch(n)
    return g[0] * b[0]


def make_gmem(rng: np.random.Generator, n: int) -> np.ndarray:
    g = np.zeros(2 * n, np.int32)
    g[:n] = rng.integers(-100, 100, n, dtype=np.int32)
    return g


def out_slice(n: int) -> slice:
    return slice(n, 2 * n)


def oracle(gmem0: np.ndarray, n: int) -> np.ndarray:
    x = gmem0[:n].astype(np.int64)
    r = np.array([np.sum(x[:n - k] * x[k:]) for k in range(n)])
    return (((r + 2**31) % 2**32) - 2**31).astype(np.int32)
