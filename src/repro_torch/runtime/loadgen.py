"""Open-loop load generation for the serving stack (a copy of
``repro.runtime.loadgen``; seeded schedules equal the JAX package's).

Serving systems are evaluated under *open-loop* load: arrivals follow a
seeded stochastic process and do **not** wait for completions, so queue
depth — and therefore latency — is an output of the system, not an
artifact of the generator pacing itself (the closed-loop coordinated-
omission trap).  This module builds seeded arrival schedules (Poisson
and bursty ON-OFF tenants), replays them against a
:class:`~repro_torch.runtime.service.ServingLoop`, and reports per-tenant
latency/throughput read from the server's observability histograms
(``server.latency_s.<tenant>``) — one source of truth shared with the
BENCH rows and the CLI stats print.

Everything is deterministic given ``seed``: the arrival times, each
arrival's tenant and work item, and hence the exact multiset of
launches submitted.  ``time_scale=0`` collapses the schedule to an
instantaneous burst (same launches, no pacing) — that is what the
bit-exactness tests use to compare a served run against the sequential
``run_grid`` oracle.

A *closed-loop* mode (one outstanding launch per tenant) is included
for calibration: its steady throughput approximates server capacity,
which is how the bench picks its 1x and overloaded arrival rates.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.pipeline.state import host_numpy
from .policy import AdmissionError, DeadlineExceeded
from .service import ServingLoop


@dataclass(frozen=True)
class WorkItem:
    """One launchable kernel: everything ``submit`` needs, plus an
    optional precomputed oracle memory for bit-exactness checks."""
    name: str
    code: np.ndarray
    grid: Tuple[int, int]
    block_dim: Tuple[int, int]
    gmem: np.ndarray
    expected_gmem: Optional[np.ndarray] = None


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's arrival process and SLA posture.

    ``process`` is ``"poisson"`` (memoryless arrivals at ``rate_hz``)
    or ``"onoff"`` (bursty: Poisson at ``rate_hz`` during ``on_s``-long
    ON windows separated by silent ``off_s`` gaps — the time-averaged
    rate is ``rate_hz * on_s / (on_s + off_s)``).  ``weight`` is the
    tenant's SLA weight under :class:`~repro_torch.runtime.policy.SlaDrain`;
    ``deadline_s``/``priority`` are stamped onto every submit.
    """
    name: str
    rate_hz: float
    process: str = "poisson"
    weight: float = 1.0
    priority: int = 0
    deadline_s: Optional[float] = None
    on_s: float = 0.1
    off_s: float = 0.3

    def __post_init__(self):
        if self.process not in ("poisson", "onoff"):
            raise ValueError(f"unknown arrival process {self.process!r}")
        if self.rate_hz <= 0:
            raise ValueError("rate_hz must be positive")


@dataclass(frozen=True)
class Arrival:
    """One scheduled launch: offset from run start, tenant, item index."""
    t: float
    tenant: TenantSpec
    item: int


def build_arrivals(tenants: Sequence[TenantSpec], duration_s: float,
                   n_items: int, seed: int = 0) -> List[Arrival]:
    """The seeded open-loop schedule: a time-sorted list of arrivals
    over ``[0, duration_s)``.  Deterministic given ``(tenants,
    duration_s, n_items, seed)`` — each tenant draws from its own
    seeded generator so adding a tenant never perturbs the others'
    schedules."""
    out: List[Arrival] = []
    for i, ten in enumerate(tenants):
        rng = np.random.default_rng(np.random.SeedSequence([seed, i]))
        if ten.process == "poisson":
            t = float(rng.exponential(1.0 / ten.rate_hz))
            while t < duration_s:
                out.append(Arrival(t, ten, int(rng.integers(n_items))))
                t += float(rng.exponential(1.0 / ten.rate_hz))
        else:                                   # onoff
            cycle = 0.0
            while cycle < duration_s:
                on_end = min(cycle + ten.on_s, duration_s)
                t = cycle + float(rng.exponential(1.0 / ten.rate_hz))
                while t < on_end:
                    out.append(Arrival(t, ten, int(rng.integers(n_items))))
                    t += float(rng.exponential(1.0 / ten.rate_hz))
                cycle += ten.on_s + ten.off_s
    out.sort(key=lambda a: (a.t, a.tenant.name))
    return out


@dataclass
class TenantReport:
    """Per-tenant outcome of one load-test run.  ``submitted ==
    completed + shed + failed`` (rejected arrivals were never
    enqueued); latency quantiles come from the server's
    ``server.latency_s.<tenant>`` histogram."""
    submitted: int = 0
    completed: int = 0
    rejected: int = 0        # AdmissionError at submit (backpressure)
    shed: int = 0            # DeadlineExceeded at dequeue
    failed: int = 0          # executed and dropped (poisoned launch)
    p50_ms: float = float("nan")
    p99_ms: float = float("nan")
    mean_ms: float = float("nan")
    throughput_per_s: float = 0.0
    sm_cycles: int = 0
    cycle_share: float = 0.0

    def as_dict(self) -> dict:
        return {k: (round(v, 4) if isinstance(v, float) else v)
                for k, v in self.__dict__.items()}


@dataclass
class LoadReport:
    """Whole-run outcome: per-tenant reports plus run-level totals.
    ``unresolved`` must always be 0 after a quiesced run — every future
    resolved, failed or shed; anything else is a runtime bug."""
    mode: str
    duration_s: float
    tenants: Dict[str, TenantReport] = field(default_factory=dict)
    submitted: int = 0
    completed: int = 0
    rejected: int = 0
    shed: int = 0
    failed: int = 0
    unresolved: int = 0
    mismatched: int = 0      # oracle-checked results that differed
    p50_ms: float = float("nan")
    p99_ms: float = float("nan")
    throughput_per_s: float = 0.0
    loop_iterations: int = 0
    loop_window_errors: int = 0

    def as_dict(self) -> dict:
        d = {k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in self.__dict__.items() if k != "tenants"}
        d["tenants"] = {t: r.as_dict() for t, r in self.tenants.items()}
        return d


def _finish(report: LoadReport, loop: ServingLoop, futs, wall_s: float,
            pool: Sequence[WorkItem], check_results: bool) -> LoadReport:
    """Resolve every future, classify outcomes, and fill the report
    from the server's histograms/stats (shared source of truth)."""
    srv = loop.server
    for ten_name, item_idx, fut in futs:
        tr = report.tenants[ten_name]
        if not fut.done():
            report.unresolved += 1
            continue
        try:
            res = fut.result()
        except DeadlineExceeded:
            tr.shed += 1
            report.shed += 1
            continue
        except Exception:
            tr.failed += 1
            report.failed += 1
            continue
        tr.completed += 1
        report.completed += 1
        exp = pool[item_idx].expected_gmem
        if check_results and exp is not None:
            if not np.array_equal(host_numpy(res.gmem).astype(np.int64),
                                  np.asarray(exp, np.int64)):
                report.mismatched += 1
    total_cycles = 0
    for ten_name, tr in report.tenants.items():
        h = srv.metrics.histogram(f"server.latency_s.{ten_name}")
        if h.count:
            tr.p50_ms = h.percentile(50) * 1e3
            tr.p99_ms = h.percentile(99) * 1e3
            tr.mean_ms = h.total / h.count * 1e3
        tr.throughput_per_s = tr.completed / max(wall_s, 1e-9)
        ts = srv.tenant_stats.get(ten_name)
        if ts is not None:
            tr.sm_cycles = ts.sm_cycles
        total_cycles += tr.sm_cycles
    for tr in report.tenants.values():
        tr.cycle_share = tr.sm_cycles / max(total_cycles, 1)
    h = srv.metrics.histogram("server.latency_s")
    if h.count:
        report.p50_ms = h.percentile(50) * 1e3
        report.p99_ms = h.percentile(99) * 1e3
    report.duration_s = wall_s
    report.throughput_per_s = report.completed / max(wall_s, 1e-9)
    report.loop_iterations = loop.iterations
    report.loop_window_errors = loop.window_errors
    return report


def run_open_loop(loop: ServingLoop, pool: Sequence[WorkItem],
                  arrivals: Sequence[Arrival], time_scale: float = 1.0,
                  check_results: bool = True) -> LoadReport:
    """Replay a schedule from :func:`build_arrivals` against a running
    loop.  Open loop: each arrival submits at its scheduled instant
    (scaled by ``time_scale``; 0 = burst) whatever the backlog looks
    like; ``AdmissionError`` counts as a rejection and the generator
    moves on.  Quiesces, then resolves every future and reports."""
    if not loop.running:
        raise RuntimeError("serving loop is not running")
    report = LoadReport(mode="open", duration_s=0.0)
    futs = []
    t0 = time.perf_counter()
    for a in arrivals:
        tr = report.tenants.setdefault(a.tenant.name, TenantReport())
        target = t0 + a.t * time_scale
        delay = target - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        item = pool[a.item]
        try:
            fut = loop.submit(item.code, item.grid, item.block_dim,
                              item.gmem, client=a.tenant.name,
                              deadline_s=a.tenant.deadline_s,
                              priority=a.tenant.priority)
        except AdmissionError:
            tr.rejected += 1
            report.rejected += 1
            continue
        tr.submitted += 1
        report.submitted += 1
        futs.append((a.tenant.name, a.item, fut))
    loop.quiesce()
    wall = time.perf_counter() - t0
    return _finish(report, loop, futs, wall, pool, check_results)


def run_closed_loop(loop: ServingLoop, pool: Sequence[WorkItem],
                    tenants: Sequence[TenantSpec], n_per_tenant: int,
                    seed: int = 0,
                    check_results: bool = True) -> LoadReport:
    """Closed-loop calibration: one thread per tenant keeps exactly one
    launch outstanding (submit → wait → next), ``n_per_tenant`` times.
    Steady-state throughput ≈ server capacity — the number the bench
    uses to place its open-loop rates at 1x and ≥4x."""
    if not loop.running:
        raise RuntimeError("serving loop is not running")
    report = LoadReport(mode="closed", duration_s=0.0)
    futs = []
    futs_lock = threading.Lock()

    def one_tenant(i: int, ten: TenantSpec) -> None:
        rng = np.random.default_rng(np.random.SeedSequence([seed, i]))
        tr = report.tenants[ten.name]
        for _ in range(n_per_tenant):
            idx = int(rng.integers(len(pool)))
            item = pool[idx]
            try:
                fut = loop.submit(item.code, item.grid, item.block_dim,
                                  item.gmem, client=ten.name,
                                  deadline_s=ten.deadline_s,
                                  priority=ten.priority)
            except AdmissionError:
                tr.rejected += 1
                continue
            tr.submitted += 1
            with futs_lock:
                futs.append((ten.name, idx, fut))
            try:
                fut.wait()
            except Exception:
                pass                    # classified later in _finish
    for ten in tenants:
        report.tenants[ten.name] = TenantReport()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=one_tenant, args=(i, ten),
                                name=f"loadgen-{ten.name}", daemon=True)
               for i, ten in enumerate(tenants)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    loop.quiesce()
    wall = time.perf_counter() - t0
    for tr in report.tenants.values():
        report.submitted += tr.submitted
        report.rejected += tr.rejected
    return _finish(report, loop, futs, wall, pool, check_results)
