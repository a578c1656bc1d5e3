"""The paper's five CUDA benchmarks, hand-compiled to the mini-ISA.

A copy of ``repro.core.programs`` (the port imports nothing of the JAX
package): bitonic sort, autocorrelation, matrix multiplication, parallel
reduction and transpose (ERCBench / NVIDIA programmer's guide §5).  Each
module exposes:

  ``build(n) -> np.ndarray``          the kernel binary
  ``launch(n) -> (grid, block_dim)``  launch geometry
  ``make_gmem(rng, n) -> np.ndarray`` initial global memory
  ``oracle(gmem0, n) -> np.ndarray``  expected final global memory region
  ``out_slice(n) -> slice``           where the kernel writes its result
  ``n_threads(n) -> int``             total threads launched (scalar model)

Every kernel is padded to PROGRAM_PAD instructions, so all five share one
code-length bucket.
"""
from . import autocorr, bitonic, matmul, reduction, transpose

PROGRAM_PAD = 96

ALL = {
    "autocorr": autocorr,
    "bitonic": bitonic,
    "matmul": matmul,
    "reduction": reduction,
    "transpose": transpose,
}


def compiled_kernels():
    """The DSL-compiled kernel modules (histogram, scan, spmv) — same
    ``build/launch/make_gmem/oracle/out_slice/n_threads`` interface as
    the hand-written five, but authored in the ``repro_torch.compiler``
    front end and compiled at build() time.  Imported lazily so ``core``
    has no hard dependency on the compiler layer."""
    from ...compiler.kernels import COMPILED
    return dict(COMPILED)
