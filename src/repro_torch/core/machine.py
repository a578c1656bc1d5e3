"""The soft-GPGPU streaming multiprocessor (SM) — public facade (port of
``repro.core.machine``).

The SM lives in :mod:`repro_torch.core.pipeline`, one module per paper
pipeline stage (Fetch/Decode, Read, Execute, Write, Control) plus the
fused CUDA kernel.  This module keeps the stable import surface —
``MachineConfig``, ``run_block``, the state and counter types.

Faithful architectural features (paper §3-4): warps of 32 threads whose
``32 / n_sp`` rows cost one cycle each per issue; a per-warp warp stack
for nested divergence (SSY, divergent BRA, ``.S`` pops — Fig. 2); four
SZCO predicate registers per thread resolved through the condition LUT;
block barriers; and the customizable datapath (``enable_mul``,
``num_read_operands``, ``warp_stack_depth`` — §4.1/4.2).

Issue disciplines (``MachineConfig.execute_backend``): ``"torch"`` and
``"cuda"`` run the staged lockstep pipeline with a plain-torch or CUDA
execute stage; ``"cuda_fused"`` (the default) runs whole blocks as one
CUDA kernel; ``"reference"`` runs the seed one-warp-per-issue interpreter
(:func:`issue_one_warp`), the oracle the other three are held to.
"""
from __future__ import annotations

from .pipeline import (  # noqa: F401  (re-exported public surface)
    EXECUTE_BACKENDS, FINISHED, READY, WAIT, Counters, MachineConfig,
    SMState, _pack, _unpack, init_state, issue_one_warp, run_block, sm_step)
