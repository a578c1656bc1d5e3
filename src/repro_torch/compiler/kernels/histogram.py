"""Histogram — atomic-free per-block binning, DSL-compiled.

The ISA has no atomics, so the kernel uses the classic bin-major
formulation: each block stages its chunk of the input in shared memory
(cooperative strided load + barrier), then thread ``t`` walks the whole
chunk counting values equal to ``t`` — a predicated compare-accumulate
(ISET) with zero cross-thread races — and threads ``t < NBINS`` write
the block's 32-bin partial histogram to global memory.  A second
single-block launch (:func:`reduce_build`, driven by
:func:`run_passes`) sums the per-block partials, mirroring the
reduction benchmark's host-side pass loop.

Global memory layout (words)::

    [0, n)                          input values in [0, NBINS)
    [n, n + blocks*NBINS)           per-block partial histograms
    [n + blocks*NBINS, ... + NBINS) final bins (2-pass driver only)

``oracle``/``out_slice`` describe what ONE launch produces (the
per-block partials), so the serving layer and differential tests can
treat a histogram launch like any other tenant; with one block the
partials *are* the final histogram.
"""
import numpy as np

from ... import compiler

NBINS = 32     # bins (values are drawn from [0, NBINS))
BD = 64        # threads per block
MAX_CHUNK = 128


def kernel(k, n, nbins, chunk, bd):
    t = k.tid
    base = k.ctaid * chunk
    # cooperative strided load of this block's chunk into shared memory
    with k.for_(0, chunk, bd) as j0:
        idx = j0 + t
        with k.if_(idx < chunk):
            k.smem[idx] = k.gmem[base + idx]
    k.syncthreads()
    # bin-major count: thread t counts occurrences of value t
    cnt = k.var(0)
    with k.for_(0, chunk) as j:
        cnt.set(cnt + (k.smem[j] == t))
    with k.if_(t < nbins):
        k.gmem[n + k.ctaid * nbins + t] = cnt


def reduce_kernel(k, n, nbins, blocks):
    """Second pass: one block sums the per-block partial histograms."""
    t = k.tid
    acc = k.var(0)
    with k.for_(0, blocks) as b:
        acc.set(acc + k.gmem[n + b * nbins + t])
    with k.if_(t < nbins):
        k.gmem[n + blocks * nbins + t] = acc


def _chunk(n: int) -> int:
    return n if n <= MAX_CHUNK else MAX_CHUNK


def _params(n: int) -> dict:
    chunk = _chunk(n)
    assert n % chunk == 0, f"histogram n={n} must be a multiple of {chunk}"
    return {"n": n, "nbins": NBINS, "chunk": chunk, "bd": BD}


def build(n: int, optimize: bool = True) -> np.ndarray:
    return compiler.compile_kernel(kernel, _params(n), name="histogram",
                                   optimize=optimize).code


def reduce_build(n: int, optimize: bool = True) -> np.ndarray:
    blocks = n // _chunk(n)
    return compiler.compile_kernel(
        reduce_kernel, {"n": n, "nbins": NBINS, "blocks": blocks},
        name="histogram_reduce", optimize=optimize).code


def report(n: int = 64) -> compiler.CompileReport:
    """Optimized-vs-naive compile report (the >=15% acceptance pin)."""
    return compiler.compile_report(kernel, _params(n), name="histogram")


def launch(n: int):
    return (n // _chunk(n), 1), (BD, 1)


def n_threads(n: int) -> int:
    g, b = launch(n)
    return g[0] * g[1] * b[0] * b[1]


def make_gmem(rng: np.random.Generator, n: int) -> np.ndarray:
    blocks = launch(n)[0][0]
    g = np.zeros(n + blocks * NBINS + NBINS, np.int32)
    g[:n] = rng.integers(0, NBINS, n, dtype=np.int32)
    return g


def out_slice(n: int) -> slice:
    """Single-launch output: the per-block partial histograms."""
    blocks = launch(n)[0][0]
    return slice(n, n + blocks * NBINS)


def final_slice(n: int) -> slice:
    """Two-pass output: the reduced bins (see :func:`run_passes`)."""
    blocks = launch(n)[0][0]
    return slice(n + blocks * NBINS, n + blocks * NBINS + NBINS)


def oracle(gmem0: np.ndarray, n: int) -> np.ndarray:
    """Per-block partial histograms (what one launch writes)."""
    chunk = _chunk(n)
    blocks = n // chunk
    parts = [np.bincount(gmem0[b * chunk:(b + 1) * chunk],
                         minlength=NBINS)[:NBINS]
             for b in range(blocks)]
    return np.concatenate(parts).astype(np.int32)


def final_oracle(gmem0: np.ndarray, n: int) -> np.ndarray:
    return np.bincount(gmem0[:n], minlength=NBINS)[:NBINS] \
        .astype(np.int32)


def run_passes(run_grid_fn, code, n, gmem, **kw):
    """Two-launch driver: per-block partials, then the reduce pass.

    Mirrors ``core.programs.reduction.run_passes``; returns (final
    gmem, [per-pass GridResult]).  The final histogram lands at
    :func:`final_slice`.
    """
    grid, bd = launch(n)
    res1 = run_grid_fn(code, grid, bd, gmem, **kw)
    res2 = run_grid_fn(reduce_build(n), (1, 1), (BD, 1),
                       res1.gmem.copy(), **kw)
    return res2.gmem, [res1, res2]
