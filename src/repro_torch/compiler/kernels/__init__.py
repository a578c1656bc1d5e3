"""Bundled DSL kernels, compiled on demand.

Three workloads the hand-written benchmark set lacks — histogram,
inclusive prefix scan and ELL-format SpMV — authored in the
:mod:`repro_torch.compiler.dsl` front end and compiled through the full
pipeline at ``build()`` time (compilation is milliseconds; the binary
then runs on the already-built machine kernels, the paper's
under-a-second CUDA-compile story end to end).

Each module mirrors the paper-benchmark interface of
:mod:`repro_torch.core.programs` (``build / launch / make_gmem / oracle /
out_slice / n_threads``), so the serving CLI, the benchmarks and the
differential server tests treat compiled tenants exactly like the
legacy five.  Binaries are left *unpadded*: the registry buckets them
(64-instr bucket, vs the legacy kernels' 96), so a mixed workload
really exercises heterogeneous footprints.
"""
from . import histogram, scan, spmv

#: name -> module, the compiled analogue of ``core.programs.ALL``
COMPILED = {
    "histogram": histogram,
    "scan": scan,
    "spmv": spmv,
}
