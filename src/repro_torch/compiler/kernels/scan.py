"""Inclusive prefix scan (Hillis–Steele in shared memory), DSL-compiled.

One block of ``n`` threads scans ``n`` values in log2(n) rounds: round
``d`` adds the neighbour ``2^d`` to the left.  The per-round gather is
written as a divergent ``if_`` (threads with ``tid < offset`` have no
neighbour); the compiler's if-conversion pass turns it into a
speculative LDS + SELP — the same predication the hand-written
reduction kernel uses — and deletes the SSY/BRA warp-stack round trip
from the loop.  Barriers separate each round's reads from its writes.

Global memory layout (words)::

    [0, n)      input
    [n, 2n)     inclusive prefix sums
"""
import numpy as np

from ... import compiler

MAX_N = 256    # one block; warp bucket 8 (the machine's max width)


def kernel(k, n, log2n):
    t = k.tid
    x = k.var(k.gmem[t])
    k.smem[t] = x
    k.syncthreads()
    with k.for_(0, log2n) as d:
        off = 1 << d
        y = k.var(0)
        with k.if_(t >= off):
            y.set(k.smem[t - off])
        k.syncthreads()
        x.set(x + y)
        k.smem[t] = x
        k.syncthreads()
    k.gmem[n + t] = x


def _params(n: int) -> dict:
    assert 32 <= n <= MAX_N and n & (n - 1) == 0, \
        f"scan n={n} must be a power of two in [32, {MAX_N}]"
    return {"n": n, "log2n": n.bit_length() - 1}


def build(n: int, optimize: bool = True) -> np.ndarray:
    return compiler.compile_kernel(kernel, _params(n), name="scan",
                                   optimize=optimize).code


def report(n: int = 64) -> compiler.CompileReport:
    return compiler.compile_report(kernel, _params(n), name="scan")


def launch(n: int):
    return (1, 1), (n, 1)


def n_threads(n: int) -> int:
    return n


def make_gmem(rng: np.random.Generator, n: int) -> np.ndarray:
    g = np.zeros(2 * n, np.int32)
    g[:n] = rng.integers(-1000, 1000, n, dtype=np.int32)
    return g


def out_slice(n: int) -> slice:
    return slice(n, 2 * n)


def oracle(gmem0: np.ndarray, n: int) -> np.ndarray:
    return np.cumsum(gmem0[:n].astype(np.int64)).astype(np.int32)
