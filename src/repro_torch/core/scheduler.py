"""Block scheduler — facade over :mod:`repro_torch.runtime.executor` (port
of ``repro.core.scheduler``).

The paper's block scheduler assigns thread blocks to SMs round-robin
(§4.3); with 2 SMs the workload per SM roughly halves, giving the
1.77–1.98× scalings of Table 3.  ``run_grid`` executes that schedule;
``GridResult.sm_cycles(n_sm)`` is the analytical round-robin replay,
equal to the executed per-SM counters of ``DeviceGrid.report``.
"""
from __future__ import annotations

from ..runtime.executor import (  # noqa: F401  (re-exported surface)
    BLOCK_SCHED_OVERHEAD, GridResult, LaunchSpec, MultiSMReport, execute,
    run_grid)
