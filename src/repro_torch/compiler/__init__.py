"""Kernel compiler front end: CUDA-style DSL -> SSA IR -> ISA binary.

A copy of ``repro.compiler`` (the port imports nothing of the JAX
package): the same binaries, listings, IR dumps and pass logs.  The IR's
constant folding and the immediates keep numpy's int32 wrap-around.

The paper's headline overlay property is *direct CUDA compilation*: a
kernel compiles in under a second to a binary the already-configured
FPGA runs with no resynthesis.  This package closes the authoring gap
on our side of the analogy — before it, new workloads meant
hand-writing SASS-like assembly against :mod:`repro_torch.core.asm`; now a
kernel is a small Python function:

    from repro_torch.compiler import compile_kernel

    def add_k(k, n, c):
        i = k.blockIdx.x * k.blockDim.x + k.threadIdx.x
        with k.if_(i < n):
            k.gmem[i + n] = k.gmem[i] + c

    ck = compile_kernel(add_k, {"n": 64, "c": 5})
    run_grid(ck.code, (2, 1), (32, 1), gmem)

Stages (each its own module):

* :mod:`~repro_torch.compiler.dsl`      — trace the Python function to IR;
* :mod:`~repro_torch.compiler.ir`       — typed SSA CFG with block arguments;
* :mod:`~repro_torch.compiler.passes`   — unroll / fold / CSE / strength /
  IMAD fusion / if-conversion / DCE;
* :mod:`~repro_torch.compiler.regalloc` — linear scan onto n_regs GPRs + 4
  predicate registers (no spill path — like the overlay);
* :mod:`~repro_torch.compiler.codegen`  — emission via ``asm.Program`` with
  the SSY/``.S`` divergence protocol.

:func:`compile_kernel` runs the whole pipeline;
:func:`compile_report` compiles twice (passes on and off) and reports
the instruction-count saving — the number ``gpgpu_compile`` prints and
the acceptance tests pin.  Bundled DSL kernels (histogram, inclusive
scan, ELL SpMV) live in :mod:`repro_torch.compiler.kernels`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import codegen, dsl, ir, passes
from .ir import CompileError
from .regalloc import RegAllocError

__all__ = ["CompileError", "RegAllocError", "CompilerConfig",
           "CompiledKernel", "CompileReport", "compile_kernel",
           "compile_report"]


@dataclasses.dataclass(frozen=True)
class CompilerConfig:
    """Compilation knobs (machine shape + pass pipeline)."""
    n_regs: int = 16              # GPRs per thread (MachineConfig.n_regs)
    n_pregs: int = 4              # predicate registers (fixed by the ISA)
    #: max unrolled IR instructions per loop.  Deliberately small: full
    #: unrolling trades binary size for cycles, and the overlay's code
    #: buckets (64/96/128) punish size — so only short trip counts
    #: (e.g. a 2-iteration strided-load loop) unroll by default.
    unroll_limit: int = 24
    if_convert_max: int = 8       # max instrs per if-converted arm
    passes: Tuple[str, ...] = passes.DEFAULT_PASSES


@dataclasses.dataclass
class CompiledKernel:
    """A compiled DSL kernel, ready for the registry / run_grid."""
    name: str
    code: np.ndarray              # (n, NUM_FIELDS) int32, unpadded
    n_instr: int                  # emitted machine instructions
    listing: str                  # SASS-like disassembly
    ir_before: str                # IR as traced
    ir_after: str                 # IR after the pass pipeline
    pass_log: List[Tuple[str, int]]   # (pass name, IR instrs after)

    def finish(self, pad_to: Optional[int] = None) -> np.ndarray:
        """The binary, optionally EXIT-padded to ``pad_to`` rows."""
        if pad_to is None:
            return self.code
        from ..runtime import registry as reg
        return reg.pad_code(self.code, pad_to)


@dataclasses.dataclass
class CompileReport:
    """Optimized-vs-naive comparison for one kernel."""
    kernel: CompiledKernel        # passes enabled
    naive: CompiledKernel         # passes disabled

    @property
    def saved_instrs(self) -> int:
        return self.naive.n_instr - self.kernel.n_instr

    @property
    def saving_pct(self) -> float:
        return 100.0 * self.saved_instrs / max(self.naive.n_instr, 1)


def compile_kernel(fn, params: Optional[Dict] = None, *,
                   name: Optional[str] = None, optimize: bool = True,
                   config: CompilerConfig = CompilerConfig()
                   ) -> CompiledKernel:
    """Trace, optimize (unless ``optimize=False``), allocate and emit.

    ``params`` are compile-time constants passed to the kernel function
    — the analogue of values baked into a CUDA binary at nvcc time.
    Raises :class:`CompileError` (tracing/verification/emission) or
    :class:`RegAllocError` (register pressure) on failure.
    """
    func = dsl.trace(fn, params, name=name)
    ir_before = str(func)
    if optimize:
        log = passes.run_passes(func, config.passes, config)
    else:
        log = [("trace", func.n_instrs())]
    prog = codegen.emit_function(func, n_regs=config.n_regs,
                                 n_pregs=config.n_pregs)
    code = prog.finish()
    return CompiledKernel(
        name=func.name, code=code, n_instr=len(code),
        listing=prog.disasm(), ir_before=ir_before, ir_after=str(func),
        pass_log=log)


def compile_report(fn, params: Optional[Dict] = None, *,
                   name: Optional[str] = None,
                   config: CompilerConfig = CompilerConfig()
                   ) -> CompileReport:
    """Compile with and without the pass pipeline; both variants are
    runnable binaries — the differential tests execute them side by
    side."""
    return CompileReport(
        kernel=compile_kernel(fn, params, name=name, config=config),
        naive=compile_kernel(fn, params, name=name, optimize=False,
                             config=config))
