"""ELL-format sparse matrix-vector multiply, DSL-compiled.

ELLPACK stores an ``n``-row matrix with at most ``KMAX`` nonzeros per
row as two dense ``KMAX x n`` arrays (values and column indices) in
*column-major* order — entry ``j`` of row ``r`` lives at ``j*n + r``,
so consecutive threads read consecutive words (the coalescing layout
of the classic GPU SpMV).  One thread per row: ``y[r] = sum_j
vals[j,r] * x[cols[j,r]]``; padding entries carry ``col=0, val=0`` and
contribute nothing, which keeps the kernel loop- and branch-free per
entry.  The multiply-accumulate fuses to IMAD (the ISA's three-operand
instruction) and ``j*n`` strength-reduces to a shift for power-of-two
``n``.

Global memory layout (words)::

    [0, KMAX*n)             values, column-major
    [KMAX*n, 2*KMAX*n)      column indices, column-major
    [2*KMAX*n, .. + n)      x
    [.. + n, .. + 2n)       y (output)
"""
import numpy as np

from ... import compiler

KMAX = 8      # nonzeros per row (ELL width)
BD = 32       # threads (rows) per block
DENSITY = 0.6  # fraction of the KMAX slots holding real entries


def kernel(k, n, kmax, bd, cols_at, x_at, y_at):
    r = k.blockIdx.x * bd + k.threadIdx.x
    acc = k.var(0)
    with k.for_(0, kmax) as j:
        e = j * n + r
        c = k.gmem[cols_at + e]
        v = k.gmem[e]
        acc.set(acc + v * k.gmem[x_at + c])
    k.gmem[y_at + r] = acc


def _params(n: int) -> dict:
    assert n % BD == 0, f"spmv n={n} must be a multiple of {BD}"
    return {"n": n, "kmax": KMAX, "bd": BD, "cols_at": KMAX * n,
            "x_at": 2 * KMAX * n, "y_at": 2 * KMAX * n + n}


def build(n: int, optimize: bool = True) -> np.ndarray:
    return compiler.compile_kernel(kernel, _params(n), name="spmv",
                                   optimize=optimize).code


def report(n: int = 64) -> compiler.CompileReport:
    return compiler.compile_report(kernel, _params(n), name="spmv")


def launch(n: int):
    return (n // BD, 1), (BD, 1)


def n_threads(n: int) -> int:
    return n


def make_gmem(rng: np.random.Generator, n: int) -> np.ndarray:
    g = np.zeros(2 * KMAX * n + 2 * n, np.int32)
    vals = rng.integers(-100, 100, (KMAX, n), dtype=np.int32)
    cols = rng.integers(0, n, (KMAX, n), dtype=np.int32)
    # ELL padding: empty slots are (col 0, val 0)
    pad = rng.random((KMAX, n)) >= DENSITY
    vals[pad] = 0
    cols[pad] = 0
    g[:KMAX * n] = vals.ravel()
    g[KMAX * n:2 * KMAX * n] = cols.ravel()
    g[2 * KMAX * n:2 * KMAX * n + n] = \
        rng.integers(-100, 100, n, dtype=np.int32)
    return g


def out_slice(n: int) -> slice:
    return slice(2 * KMAX * n + n, 2 * KMAX * n + 2 * n)


def oracle(gmem0: np.ndarray, n: int) -> np.ndarray:
    vals = gmem0[:KMAX * n].reshape(KMAX, n).astype(np.int64)
    cols = gmem0[KMAX * n:2 * KMAX * n].reshape(KMAX, n)
    x = gmem0[2 * KMAX * n:2 * KMAX * n + n].astype(np.int64)
    return (vals * x[cols]).sum(0).astype(np.int32)
