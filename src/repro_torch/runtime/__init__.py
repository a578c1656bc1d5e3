"""The device runtime: binary cache, streams/events, multi-SM execution and
the multi-tenant serving layer (port of ``repro.runtime``).

* :mod:`registry` — binary cache / module registry (bucketed program
  padding, content-addressed memoization), launch footprints, the
  :class:`~repro_torch.runtime.registry.CostModel` of observed
  cycles/block and the device-resident
  :class:`~repro_torch.runtime.registry.GmemPool`;
* :mod:`executor` — the multi-SM executor: blocks of one or more launches
  round-robin across ``n_sm`` SMs, one fused-kernel launch a dispatch
  group on the card, per-SM cycle counters out of the executed schedule,
  host<->device crossings counted in :data:`TRANSFERS`;
* :mod:`stream` — streams and events over ``torch.cuda`` events, plus the
  server-routed :class:`QueuedStream`/:class:`QueuedLaunch` futures;
* :mod:`policy` — the five drain policies, admission control and
  per-tenant / per-bucket accounting;
* :mod:`server` — :class:`RuntimeServer`, the multi-tenant launch queue;
* :mod:`service` — :class:`ServingLoop`, the background drain loop;
* :mod:`loadgen` — seeded open- and closed-loop load generation.

The sharded parts of the JAX package's runtime (``shard_plan``, multi-GPU
``shard_sm``) are not ported yet.  Every layer emits into
:mod:`repro_torch.obs`; its globals are re-exported here.
"""
from .registry import (CODE_BUCKETS, GMEM_MIN_WORDS, SEED_CYCLES_PER_INSTR,
                       WARP_BUCKETS, CostEstimate, CostModel, Footprint,
                       GmemPool, Module, ModuleRegistry, bucket,
                       bucket_code_len, bucket_gmem_len, bucket_warps,
                       footprint, pad_code)
from .executor import (BLOCK_SCHED_OVERHEAD, LAUNCH_BUCKETS, TRANSFERS,
                       DeviceGrid, GridResult, LaunchSpec, MultiSMReport,
                       TransferLog, bucket_launches, execute, run_grid)
from .stream import (Event, Launch, QueuedLaunch, QueuedStream, Runtime,
                     Stream)
from .policy import (POLICIES, AdmissionError, BalancedDrain, BucketDrain,
                     BucketStats, DeadlineExceeded, DrainPolicy,
                     FairBucketDrain, MonolithicDrain, SlaDrain, TenantStats,
                     make_policy)
from .server import DepGmem, DrainStats, LaunchRequest, RuntimeServer
from .service import ServingLoop
from .loadgen import (Arrival, LoadReport, TenantReport, TenantSpec,
                      WorkItem, build_arrivals, run_closed_loop,
                      run_open_loop)
from ..obs import METRICS, TRACER, MetricsRegistry, Tracer

__all__ = [
    "AdmissionError", "Arrival", "BLOCK_SCHED_OVERHEAD", "BalancedDrain",
    "BucketDrain", "BucketStats", "CODE_BUCKETS", "CostEstimate",
    "CostModel", "DeadlineExceeded", "DepGmem", "DeviceGrid",
    "DrainPolicy", "DrainStats",
    "Event", "FairBucketDrain", "Footprint", "GMEM_MIN_WORDS", "GmemPool",
    "GridResult", "Launch", "LaunchRequest", "LaunchSpec",
    "LAUNCH_BUCKETS", "LoadReport", "MonolithicDrain", "Module",
    "ModuleRegistry", "METRICS", "MetricsRegistry",
    "MultiSMReport", "POLICIES", "QueuedLaunch", "QueuedStream", "Runtime",
    "RuntimeServer", "SEED_CYCLES_PER_INSTR", "ServingLoop", "SlaDrain",
    "Stream", "TRACER",
    "TRANSFERS", "TenantReport", "TenantSpec", "TenantStats", "Tracer",
    "TransferLog", "WARP_BUCKETS", "WorkItem", "bucket", "bucket_code_len",
    "bucket_gmem_len",
    "bucket_launches", "bucket_warps", "build_arrivals", "execute",
    "footprint", "make_policy", "pad_code", "run_closed_loop",
    "run_grid", "run_open_loop",
]
