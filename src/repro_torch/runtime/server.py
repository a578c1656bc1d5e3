"""Multi-tenant launch queue: policy-cut drain windows over SM packs (port
of ``repro.runtime.server``).

The overlay property makes a soft GPGPU *servable*: kernels are data, so
one resident machine can run many tenants' binaries back-to-back with no
reconfiguration.  :class:`RuntimeServer` is that serving layer:

* clients ``submit`` launches (any mix of binaries, geometries and
  memories) and get a ticket back immediately — or a
  :class:`~repro_torch.runtime.policy.AdmissionError` when backpressure
  (bounded queue, per-tenant in-flight cap) rejects at the door;
* ``drain`` packs pending launches into windows and hands each window
  to the configured :class:`~repro_torch.runtime.policy.DrainPolicy`, which
  cuts it into dispatch groups (sub-batches).  The default
  :class:`~repro_torch.runtime.policy.BucketDrain` keys groups on
  ``(gmem bucket, binary)`` so a small tenant never pads to a large
  tenant's memory bucket — the memory-aware scheduling the monolithic
  super-step lacked;
* results come back per ticket, with a :class:`DrainStats` carrying the
  executed per-SM counters plus the padding/occupancy accounting the
  policies are judged on; ``submit_future`` returns a
  :class:`~repro_torch.runtime.stream.QueuedLaunch` resolved exactly once,
  the moment its sub-batch completes.

A failing sub-batch is *isolated*: its window-mates (other sub-batches)
still execute, its own requests requeue with a bumped retry count —
retried requests drain in singleton sub-batches so a poisoned launch
can never re-poison a shared group — and the drain re-raises the first
failure after finishing everything else, with completed results stashed
for the next drain to redeem.

The server runs on the card unless ``device="cpu"``: every dispatch group
of the default ``execute_backend="cuda_fused"`` is one launch of the
fused SM kernel.  The drain's wall clock (``DrainStats.wall_s``) opens
when ``drain`` starts, so submits (and the resident pool's uploads, made
at submit) fall outside it, and closes after ``to_results`` has fetched
the last group's counters, a host sync, so it covers the device work it
reports.
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..core.pipeline import MachineConfig
from ..core.pipeline.state import host_numpy, resolve_device
from ..obs import METRICS, TRACER, MetricsRegistry, Tracer, safe_div
from . import executor as ex
from . import policy as pol
from .policy import (AdmissionError, BucketStats, DeadlineExceeded,
                     DrainPolicy, TenantStats)
from .registry import GmemPool, ModuleRegistry
from .stream import QueuedLaunch, QueuedStream


class DepGmem(NamedTuple):
    """Deferred global memory of a *dependent* launch: the final gmem of
    ``ticket``, which does not exist until that producer's sub-batch
    completes.  ``drain`` materializes it just before the dependent's
    own sub-batch executes (topologically after the producer's), so a
    chained :class:`~repro_torch.runtime.stream.QueuedStream` launch enqueues
    immediately instead of flushing the whole server.  ``shape`` mirrors
    a 1-D array so footprint bucketing and accounting work before the
    memory exists (a launch's output memory has its input's length)."""
    ticket: int          # producer ticket whose final gmem this is
    length: int          # the producer's gmem length (words)

    @property
    def shape(self):
        return (self.length,)


class LaunchRequest(NamedTuple):
    ticket: int
    client: str
    spec: ex.LaunchSpec
    attempts: int = 0     # failed drain attempts so far
    #: absolute host deadline (perf_counter seconds) or None; a request
    #: still queued past it is *shed* at dequeue time (DeadlineExceeded)
    deadline: Optional[float] = None
    #: scheduling priority — higher arranges first under SlaDrain
    priority: int = 0

    @property
    def deps(self):
        """Producer tickets this request's memory depends on."""
        g = self.spec.gmem
        return (g.ticket,) if isinstance(g, DepGmem) else ()


class DrainStats(NamedTuple):
    n_launches: int
    n_blocks: int
    n_sm: int
    wall_s: float
    launches_per_s: float
    per_sm_cycles: np.ndarray    # executed counters for the drained batch
    n_steps: int
    n_windows: int = 0
    n_sub_batches: int = 0
    useful_gmem_words: int = 0   # words the drained launches asked for
    padded_gmem_words: int = 0   # bucket padding their allocations carried
    occupancy: float = 0.0       # real blocks / (SM-step slots)
    by_tenant: Optional[Dict[str, TenantStats]] = None   # this drain only
    by_bucket: Optional[Dict[int, BucketStats]] = None
    makespan_cycles: int = 0     # sum over sub-batches of busiest-SM cycles
    busy_cycles: int = 0         # sum over sub-batches and SMs of real work
    pool: Optional[Dict[str, int]] = None   # GmemPool.stats() snapshot
    n_devices: int = 1           # devices the SM axis sharded over
    n_shed: int = 0              # launches shed past their deadline
    energy_eu: float = 0.0       # dynamic energy of the drained launches
    #                              (model units; 0.0 unless profiling is on)

    @property
    def duration_balance(self) -> float:
        """Fraction of drain SM-time spent on real blocks:
        ``busy_cycles / (n_sm * makespan_cycles)`` — the duration
        analogue of the slot-count ``occupancy``; what BalancedDrain
        raises on skewed-duration windows.  Always finite: an empty
        drain (zero makespan) reads 0.0, never NaN/inf — these ratios
        land verbatim in BENCH JSON rows."""
        return safe_div(self.busy_cycles, self.n_sm * self.makespan_cycles)


#: sentinel distinguishing "argument not passed" (inherit the server's
#: setting) from an explicit None ("unbounded for this call")
_INHERIT = object()


class _LaunchTiming:
    """Host wall-clock (perf_counter seconds) milestones of one launch.

    Feeds the server's latency histograms: total = complete − submit,
    queue-wait = packed − submit, device = complete − dispatched (the
    sub-batch's execute+materialize extent).  Popped at resolution,
    shed or drop; purely host-side.  ``deferred`` marks a launch a
    partial drain (``max_windows=``) returned to the queue unpacked:
    its retroactive queue-wait span then overlaps that whole earlier
    drain, so the stamp at dequeue time attaches it at the trace root
    instead of nesting it inside a later drain's window."""

    __slots__ = ("submit", "packed", "dispatched", "deferred")

    def __init__(self, submit: float) -> None:
        self.submit = submit
        self.packed: Optional[float] = None
        self.dispatched: Optional[float] = None
        self.deferred = False


class RuntimeServer:
    """Batches pending launches from concurrent clients into super-steps.
    Runs on the card unless ``device="cpu"``; without a card it raises."""

    #: a request is dropped (ticket unredeemable, its future failed)
    #: after this many failed drain attempts
    MAX_ATTEMPTS = 3

    def __init__(self, n_sm: int = 2, cfg: MachineConfig = MachineConfig(),
                 chunk: Optional[int] = None, max_batch: int = 32,
                 registry: Optional[ModuleRegistry] = None,
                 policy: Union[str, DrainPolicy, None] = None,
                 max_pending: Optional[int] = 1024,
                 max_inflight_per_tenant: Optional[int] = 256,
                 max_window_cycles: Optional[int] = None,
                 resident_gmem: bool = False,
                 gmem_pool_entries: Optional[int] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 shard_sm: bool = False,
                 profile: bool = False,
                 device="cuda"):
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            # pin "the current card" now: the serving loop's thread has
            # its own current device
            dev = torch.device("cuda", torch.cuda.current_device())
        #: the device every dispatch group, pooled memory and queued
        #: stream of this server lives on
        self.device = dev
        if shard_sm and dev.type == "cuda" and \
                torch.cuda.device_count() > 1:
            raise NotImplementedError(
                "RuntimeServer(shard_sm=True) across several CUDA devices "
                "is not yet ported (ROADMAP queue 1 item 9, multi-GPU "
                "shard_sm)")
        self.n_sm = n_sm
        self.cfg = cfg
        #: device-parallel SM execution: on one device the executor runs
        #: its single-device path, as the JAX package falls back to it;
        #: ``n_devices`` is the devices the SM axis spans (1)
        self.shard_sm = shard_sm
        self.n_devices = 1
        #: observability sinks — default to the process globals.  The
        #: server emits unconditionally; a disabled registry / tracer
        #: reduces every emission to a no-op (and never a device sync).
        self.metrics = METRICS if metrics is None else metrics
        self.tracer = TRACER if tracer is None else tracer
        #: architectural profiler (``--profile``): folds every completed
        #: launch's device counters — already host-side from the
        #: executor's one batched fetch, so zero added transfers — into
        #: per-tenant/per-module activity, energy accounting and the
        #: ``profile.*`` / ``energy.*`` metric families.  None when off;
        #: ``profiler.report()`` is the ``--profile-out`` document.
        #: Imported lazily, as the JAX package does: ``obs.profile``
        #: prices through ``core.energy``, which imports the executor.
        if profile:
            from ..obs.profile import ArchProfiler
            self.profiler: Optional["ArchProfiler"] = \
                ArchProfiler(cfg, n_sm, self.metrics)
        else:
            self.profiler = None
        #: per-ticket submit/packed/dispatched wall-clock milestones
        self._timings: Dict[int, _LaunchTiming] = {}
        # default: one SM-wide super-step per dispatch — small groups
        # keep lockstep dispatches homogeneous (a group runs as long as
        # its longest block), measurably better than wide groups for
        # mixed-tenant batches
        self.chunk = max(2, n_sm) if chunk is None else chunk
        self.max_batch = max_batch
        #: duration budget per drain window: window packing stops once
        #: the CostModel-predicted cycles of the packed launches exceed
        #: this (None = unbounded).  Complements ``max_windows`` — that
        #: bounds how many windows one drain() call processes, this
        #: bounds how long each window occupies the SMs, so a drain
        #: call has a latency budget whatever the tenants submitted.
        self.max_window_cycles = max_window_cycles
        # an empty registry is falsy: test for None
        self.registry = registry if registry is not None else \
            ModuleRegistry(max_modules=1024)
        self.policy = pol.make_policy(policy)
        # cost-aware arrange policies (SlaDrain) predict durations
        # through the server's own cost model
        self.policy.bind(self.registry)
        #: set by a :class:`~repro_torch.runtime.service.ServingLoop` while it
        #: owns this server's drains; futures then wait for the loop
        #: instead of draining re-entrantly from a foreign thread
        self._serving_loop = None
        self.max_pending = max_pending
        self.max_inflight_per_tenant = max_inflight_per_tenant
        self._pending: List[LaunchRequest] = []
        # results of sub-batches completed inside a drain() that later
        # raised survive here until the next drain redeems them
        self._completed: Dict[int, ex.GridResult] = {}
        self._futures: Dict[int, QueuedLaunch] = {}
        #: device residency: with ``resident_gmem=True`` tenant global
        #: memory lives on device end to end — submit uploads host
        #: arrays once (``gmem_pool.adopt``), drain materializes results
        #: with device gmem (``to_results(host_gmem=False)``), and the
        #: stashed producer memories dependents consume between windows
        #: and drains stay device arrays in the pool.  Host numpy is
        #: involved only at an explicit ``gmem_pool.read``/``evict`` or
        #: a caller's own ``np.asarray`` on a result.
        self.resident_gmem = resident_gmem
        #: per-ticket device gmem pool; also the unified DepGmem stash
        #: (pinned entries = producer memories with queued dependents)
        self.gmem_pool = GmemPool(max_entries=gmem_pool_entries,
                                  device=dev)
        # dependency bookkeeping: how many still-queued dependents wait
        # on each producer ticket, completed producer memories kept
        # alive until the last dependent consumed them (pinned in the
        # gmem pool — see the ``_dep_gmem`` view), and producers
        # dropped while dependents were still waiting (those dependents
        # must fail, not requeue forever)
        self._dep_waiters: Dict[int, int] = {}
        self._dep_dropped: set = set()
        self._next_ticket = 0
        self.drains = 0
        self.launches_served = 0
        #: cumulative accounting across all drains
        self.tenant_stats: Dict[str, TenantStats] = {}
        self.bucket_stats: Dict[int, BucketStats] = {}

    @property
    def _dep_gmem(self) -> Dict[int, object]:
        """Live DepGmem-stash view: the gmem pool's pinned entries.

        Kept as a property (not a second dict) so the stash and the
        resident pool cannot drift — tests assert on it to check the
        dependency bookkeeping fully unwinds."""
        return self.gmem_pool.pinned()

    # ------------------------------------------------------------ admission

    def _admit(self, client: str) -> None:
        """Backpressure checks — raise before anything is enqueued."""
        ts = self.tenant_stats.setdefault(client, TenantStats())
        if self.max_pending is not None and \
                len(self._pending) >= self.max_pending:
            ts.rejected += 1
            raise AdmissionError(
                f"queue full ({self.max_pending} pending launches); "
                "drain before submitting more")
        if self.max_inflight_per_tenant is not None:
            inflight = sum(1 for r in self._pending if r.client == client)
            if inflight >= self.max_inflight_per_tenant:
                ts.rejected += 1
                raise AdmissionError(
                    f"tenant {client!r} at its in-flight cap "
                    f"({self.max_inflight_per_tenant}); drain first")

    def _gmem_or_dep(self, fut: QueuedLaunch):
        """Coerce a :class:`QueuedLaunch` passed as launch memory: a
        resolved (or foreign-server) future snapshots its concrete gmem;
        a future still pending on THIS server becomes a :class:`DepGmem`
        dependency edge instead — the drain orders the dependent's
        sub-batch after the producer's, so nothing flushes now.  The
        length is left 0 here: ``submit`` derives it from the producer's
        pending spec (the single normalization site, shared with
        caller-supplied DepGmems)."""
        if fut._server is self and not fut.done():
            return DepGmem(fut.ticket, 0)
        if self.resident_gmem:
            # resolved memory stays on device (pool-adopt is a no-op for
            # device tensors; a foreign host array uploads exactly once)
            return self.gmem_pool.adopt(fut.gmem())
        return host_numpy(fut.result().gmem).astype(np.int32)

    def submit(self, code, grid, block_dim, gmem,
               client: str = "anon",
               deadline_s: Optional[float] = None,
               priority: int = 0) -> int:
        """Enqueue one launch; returns a ticket redeemable at ``drain``.

        Host arrays are snapshotted — a tenant may reuse its buffer
        immediately after submitting; a tensor is snapshotted on its own
        device (no transfer), since torch tensors, unlike jax arrays,
        are mutable.  ``gmem`` may also be a
        :class:`~repro_torch.runtime.stream.QueuedLaunch` of this server: a
        still-pending producer registers a dependency edge
        (:class:`DepGmem`) and the drain topologically orders the two
        sub-batches — the dependent enqueues without flushing anything.
        Geometry is validated here so a malformed request is rejected at
        the door instead of poisoning a later ``drain`` window shared
        with other tenants; admission control (bounded queue, per-tenant
        cap) rejects with :class:`AdmissionError`.

        ``deadline_s`` is a latency budget relative to now: a launch
        still queued when it expires is **shed** at dequeue time — its
        future fails with :class:`~repro_torch.runtime.policy.DeadlineExceeded`
        and the shed lands in ``server.shed`` counters — instead of
        executing stale work under overload.  ``priority`` (higher
        first) orders arrangement under priority-aware policies
        (:class:`~repro_torch.runtime.policy.SlaDrain`).
        """
        with self.tracer.span("submit", tenant=client) as sp:
            gx, gy = grid
            if gx < 1 or gy < 1:
                raise ValueError(f"empty grid {grid}")
            if ex.warps_for(block_dim) < 1:
                raise ValueError(f"empty block_dim {block_dim}")
            if gx * gy > self.block_budget():
                raise ValueError(
                    f"grid {grid} ({gx * gy} blocks) exceeds this server's "
                    f"per-drain block budget of {self.block_budget()} "
                    f"({self.n_sm} SMs x the executor's 2**15 blocks/SM "
                    "cycle-accumulator bound)")
            if isinstance(gmem, QueuedLaunch):
                gmem = self._gmem_or_dep(gmem)
            if isinstance(gmem, DepGmem):
                prod = next((r for r in self._pending
                             if r.ticket == gmem.ticket), None)
                if prod is None:
                    raise ValueError(
                        f"dependent launch references producer ticket "
                        f"{gmem.ticket}, which is not pending on this "
                        "server")
                # never trust a caller-supplied length: the dependent's
                # gmem bucket must match the memory that will be
                # materialized, or window-mates merged on its footprint
                # would silently pad to the producer's real width
                gmem = DepGmem(gmem.ticket, int(prod.spec.gmem.shape[0]))
            else:
                if isinstance(gmem, torch.Tensor):
                    gmem = gmem.clone()              # snapshot on device
                elif isinstance(gmem, np.ndarray) or \
                        not hasattr(gmem, "ndim"):
                    gmem = np.array(gmem, np.int32)  # snapshot (lists too)
                if gmem.ndim != 1:
                    raise ValueError(
                        f"gmem must be 1-D, got shape {gmem.shape}")
                if self.resident_gmem:
                    # upload once at the door; every window of every
                    # drain then sees a device array (zero per-window
                    # rebuilds)
                    gmem = self.gmem_pool.adopt(gmem)
            with self.tracer.span("admit", tenant=client):
                self._admit(client)
            mod = self.registry.as_module(code)
            ticket = self._next_ticket
            self._next_ticket += 1
            deadline = None if deadline_s is None else \
                time.perf_counter() + float(deadline_s)
            self._pending.append(LaunchRequest(
                ticket, client, ex.LaunchSpec(mod, grid, block_dim, gmem),
                deadline=deadline, priority=int(priority)))
            if isinstance(gmem, DepGmem):
                self._dep_waiters[gmem.ticket] = \
                    self._dep_waiters.get(gmem.ticket, 0) + 1
            sp.set(ticket=ticket, n_blocks=gx * gy)
            self._timings[ticket] = _LaunchTiming(time.perf_counter())
            self.tracer.begin_async(
                "launch", ticket, f"launch t{ticket} {client}",
                tenant=client, ticket=ticket, n_blocks=gx * gy,
                module=mod.name)
            self.metrics.counter("server.submitted").inc()
            self.metrics.counter(f"server.submitted.{client}").inc()
        return ticket

    def submit_future(self, code, grid, block_dim, gmem,
                      client: str = "anon",
                      deadline_s: Optional[float] = None,
                      priority: int = 0) -> QueuedLaunch:
        """``submit`` returning a :class:`QueuedLaunch` future instead of
        a bare ticket.  The future resolves exactly once, the moment its
        sub-batch completes inside a drain — surviving sub-batched
        completion order and window-mate failures."""
        ticket = self.submit(code, grid, block_dim, gmem, client,
                             deadline_s=deadline_s, priority=priority)
        mod = self._pending[-1].spec.code    # submit stored the Module
        fut = QueuedLaunch(self, ticket, client, mod, grid, block_dim)
        self._futures[ticket] = fut
        return fut

    def stream(self, gmem=None, client: str = "stream") -> QueuedStream:
        """A CUDA-style in-order stream routed through this server's
        launch queue (see :class:`QueuedStream`)."""
        return QueuedStream(self, gmem, client)

    def pending(self) -> int:
        return len(self._pending)

    def block_budget(self) -> int:
        """Most blocks one executor pass can attribute exactly."""
        return (1 << 15) * self.n_sm

    # ---------------------------------------------------------------- drain

    def _pack_window(self, queue: List[LaunchRequest],
                     max_window_cycles=_INHERIT
                     ) -> Tuple[List[LaunchRequest],
                                List[LaunchRequest]]:
        """Pop the next window off ``queue``: bounded by the launch
        bucket (max_batch), the executor's exact-cycle block budget —
        so a full window of individually-valid launches can never trip
        the accumulator bound mid-drain (submit() already rejects any
        single launch that could not fit alone) — and, when
        ``max_window_cycles`` is set (the server knob, or a per-call
        value where an explicit None means unbounded), by the
        CostModel-predicted duration of the packed launches: packing
        stops before the window's predicted block-cycles exceed the
        budget.  The first launch always packs (a single over-budget
        launch must still drain), so the budget bounds window *latency*
        without ever starving the queue.

        Returns ``(window, shed)``: a request whose ``deadline``
        already expired at dequeue time is popped into ``shed``
        instead of the window — it consumes no window budget and
        never reaches the device (the caller fails it with
        :class:`DeadlineExceeded`)."""
        budget = self.max_window_cycles if max_window_cycles is _INHERIT \
            else max_window_cycles
        window, shed, blocks_packed, cycles_packed = [], [], 0, 0.0
        now = time.perf_counter()
        while queue and len(window) < self.max_batch:
            nxt = queue[0]
            if nxt.deadline is not None and now > nxt.deadline:
                shed.append(queue.pop(0))
                continue
            nb = nxt.spec.grid[0] * nxt.spec.grid[1]
            if window and blocks_packed + nb > self.block_budget():
                break
            if budget is not None:
                dur = pol.request_duration(nxt, self.registry)
                if window and cycles_packed + dur > budget:
                    break
                cycles_packed += dur
            window.append(queue.pop(0))
            blocks_packed += nb
        return window, shed

    def _cut(self, window: List[LaunchRequest]) -> List[pol.SubBatch]:
        """Policy partition, with retried requests isolated first: a
        launch that already failed once drains in a singleton sub-batch,
        so whatever poisoned it cannot take fresh window-mates down.
        Sub-batches holding an internal producer->dependent edge are
        split so the drain's topological ordering can respect it."""
        fresh = [r for r in window if r.attempts == 0]
        retried = [r for r in window if r.attempts > 0]
        cuts = [pol._make_sub_batch([r], self.registry) for r in retried]
        if fresh:
            cuts.extend(self.policy.partition(fresh, self.registry))
        return self._split_dep_layers(window, cuts)

    def _split_dep_layers(self, window: List[LaunchRequest],
                          cuts: List[pol.SubBatch]) -> List[pol.SubBatch]:
        """Subdivide each policy group by dependency *depth* within this
        window, so the inter-group graph is acyclic and one drain always
        completes a whole chain.  Splitting only direct in-group edges
        would not be enough: a policy may merge an ancestor and a
        descendant of a *third* group (a -> b -> c with b in another
        footprint), leaving a cycle between the two groups that
        ``_topo_order`` could only punt on.  Depth layering kills every
        such cycle — an edge always crosses into a strictly deeper
        layer, whatever the policy merged."""
        if not any(r.deps for r in window):
            return cuts
        # deps always reference older (smaller) tickets, so ascending
        # ticket order computes depths in one pass; deps outside this
        # window (already completed, stashed) contribute no depth
        depth: Dict[int, int] = {}
        for r in sorted(window, key=lambda q: q.ticket):
            ds = [depth[t] for t in r.deps if t in depth]
            depth[r.ticket] = (1 + max(ds)) if ds else 0
        out = []
        for sb in cuts:
            levels = sorted({depth[r.ticket] for r in sb.requests})
            if len(levels) == 1:
                out.append(sb)
                continue
            for lv in levels:
                layer = [r for r in sb.requests
                         if depth[r.ticket] == lv]
                out.append(pol._make_sub_batch(layer, self.registry))
        return out

    def _topo_order(self, cuts: List[pol.SubBatch]
                    ) -> List[pol.SubBatch]:
        """Topologically order a window's sub-batches so every producer
        executes before its dependents, keeping the policy's order among
        unconstrained groups.  Dependency tickets always point at older
        submissions, so the public API cannot create a cycle; if one
        appears anyway the policy order is kept — unready dependents
        then requeue instead of deadlocking the drain."""
        owner = {r.ticket: i for i, sb in enumerate(cuts)
                 for r in sb.requests}
        n = len(cuts)
        dependents = [set() for _ in range(n)]
        indeg = [0] * n
        for j, sb in enumerate(cuts):
            for r in sb.requests:
                for d in r.deps:
                    i = owner.get(d)
                    if i is not None and i != j and j not in dependents[i]:
                        dependents[i].add(j)
                        indeg[j] += 1
        if not any(indeg):
            return cuts
        ready = sorted(i for i in range(n) if indeg[i] == 0)
        order: List[int] = []
        while ready:
            i = ready.pop(0)
            order.append(i)
            for j in sorted(dependents[i]):
                indeg[j] -= 1
                if indeg[j] == 0:
                    bisect.insort(ready, j)   # stable: policy order
        if len(order) != n:                   # cycle: fall back
            return cuts
        return [cuts[i] for i in order]

    def _dep_lookup(self, ticket: int,
                    results: Dict[int, ex.GridResult]):
        """A completed producer's final gmem, from this drain's results
        or the cross-drain pool stash; None while the producer hasn't
        run.  A device-resident result passes through as-is — the
        zero-host-hop edge between a multi-window drain's windows."""
        if ticket in results:
            g = results[ticket].gmem
            if isinstance(g, np.ndarray):
                return np.asarray(g, np.int32)
            return g                        # device tensor: stays resident
        return self.gmem_pool.get(ticket)

    def _dep_done(self, ticket: int) -> None:
        """One dependent of ``ticket`` finished (or was dropped): free
        the stashed producer memory once nobody else waits on it."""
        n = self._dep_waiters.get(ticket, 0) - 1
        if n > 0:
            self._dep_waiters[ticket] = n
        else:
            self._dep_waiters.pop(ticket, None)
            self.gmem_pool.release(ticket)
            self._dep_dropped.discard(ticket)

    def _shed(self, r: LaunchRequest, now: float) -> None:
        """Shed one deadline-expired request at dequeue time: fail its
        future with :class:`DeadlineExceeded`, close its launch
        lifecycle trace pair, and account it (``server.shed`` counters,
        per-tenant ``TenantStats.shed``).  A shed producer's queued
        dependents fail at their own dequeue via the ``_dep_dropped``
        marker — their memory can now never materialize."""
        tm = self._timings.pop(r.ticket, None)
        waited = now - tm.submit if tm is not None else 0.0
        err = DeadlineExceeded(
            f"launch ticket {r.ticket} (tenant {r.client!r}) shed after "
            f"{waited:.4f}s in queue: deadline expired before dispatch")
        ts = self.tenant_stats.setdefault(r.client, TenantStats())
        ts.shed += 1
        self.metrics.counter("server.shed").inc()
        self.metrics.counter(f"server.shed.{r.client}").inc()
        # the lifecycle pair still closes — a trace of an overloaded
        # serving loop shows every launch terminated, some shed
        self.tracer.end_async("launch", r.ticket,
                              shed=True, error=str(err))
        fut = self._futures.pop(r.ticket, None)
        if fut is not None:
            fut._fail(err)
        if r.ticket in self._dep_waiters:
            self._dep_dropped.add(r.ticket)
        for d in r.deps:
            self._dep_done(d)

    def _drop(self, r: LaunchRequest, error: BaseException,
              queue: List[LaunchRequest],
              requeue: List[LaunchRequest]) -> None:
        """Drop one request permanently: account it, fail its future,
        and cascade to queued dependents whose memory can now never
        materialize.  Iterative worklist over an index of queued
        dependents — a recursive cascade would blow the interpreter
        stack on a max_pending-length chain (escaping drain() with the
        whole queue unwritten), and per-level rescans with nested error
        strings would cost O(chain^2)."""
        by_dep: Dict[int, List[LaunchRequest]] = {}
        for lst in (queue, requeue):
            for q in lst:
                for d in q.deps:
                    by_dep.setdefault(d, []).append(q)
        cascade_err = RuntimeError(
            f"producer ticket {r.ticket} was dropped: {error}")
        doomed = set()
        work, err = [r], error            # root keeps the real error
        while work:
            req = work.pop()
            ts = self.tenant_stats.setdefault(req.client, TenantStats())
            ts.dropped += 1
            self.metrics.counter("server.dropped").inc()
            self._timings.pop(req.ticket, None)
            # the launch's lifecycle event still terminates — a trace of
            # a failing drain shows every launch closed, some with error
            self.tracer.end_async("launch", req.ticket,
                                  dropped=True, error=str(err))
            fut = self._futures.pop(req.ticket, None)
            if fut is not None:
                fut._fail(err)
            err = cascade_err             # everything after the root
            if req.ticket in self._dep_waiters:
                # dependents elsewhere in the current window see the
                # drop at materialization time (they are in neither
                # list yet)
                self._dep_dropped.add(req.ticket)
            for d in req.deps:
                self._dep_done(d)
            for q in by_dep.get(req.ticket, ()):
                if q.ticket not in doomed:
                    doomed.add(q.ticket)
                    work.append(q)
        if doomed:
            queue[:] = [q for q in queue if q.ticket not in doomed]
            requeue[:] = [q for q in requeue if q.ticket not in doomed]

    def _account(self, sb: pol.SubBatch, rep: ex.MultiSMReport,
                 by_tenant: Dict[str, TenantStats],
                 by_bucket: Dict[int, BucketStats]) -> None:
        """Charge one completed sub-batch to the per-drain and
        cumulative per-tenant / per-bucket accounting."""
        bs_drain = by_bucket.setdefault(sb.gmem_bucket, BucketStats())
        bs_total = self.bucket_stats.setdefault(sb.gmem_bucket,
                                                BucketStats())
        for bs in (bs_drain, bs_total):
            bs.launches += len(sb.requests)
            bs.sub_batches += 1
            bs.blocks += rep.n_blocks
            bs.sm_steps += rep.n_steps
            bs.sm_slots += rep.n_steps * rep.n_sm
            bs.useful_gmem_words += rep.useful_gmem_words
            bs.padded_gmem_words += rep.padded_gmem_words
            bs.makespan_cycles += rep.kernel_cycles
            bs.busy_cycles += rep.busy_cycles
        for r in sb.requests:
            useful = int(r.spec.gmem.shape[0])
            padded = sb.gmem_bucket - useful
            nb = r.spec.grid[0] * r.spec.grid[1]
            ts_drain = by_tenant.setdefault(r.client, TenantStats())
            ts_total = self.tenant_stats.setdefault(r.client, TenantStats())
            for ts in (ts_drain, ts_total):
                ts.launches += 1
                ts.blocks += nb
                ts.useful_gmem_words += useful
                ts.padded_gmem_words += padded

    def drain(self, max_windows: Optional[int] = None,
              max_window_cycles=_INHERIT
              ) -> Tuple[Dict[int, ex.GridResult], DrainStats]:
        """Execute pending launches in policy-cut, SM-packed sub-batches.

        Packs up to ``max_batch`` launches per window (``max_windows``
        bounds how many windows this call processes; default all;
        ``max_window_cycles`` overrides the server's per-window
        duration budget for this call — windows stop packing before
        their CostModel-predicted cycles exceed it, and an explicit
        ``None`` means unbounded even on a budgeted server), cuts
        each window into dispatch groups via the drain policy —
        **topologically ordered** so a producer's group always executes
        before its dependents' — and runs each group through
        :func:`repro_torch.runtime.executor.execute` with the group's own gmem
        bucket and SM width.  A dependent launch's deferred memory
        (:class:`DepGmem`) is materialized from the producer's completed
        result just before its group executes.  Returns ``{ticket:
        GridResult}`` plus statistics; per-SM counters are summed over
        groups (the SMs run them back-to-back).  Tickets redeemed from a
        previously-failed drain appear in the results but not in this
        drain's execution statistics.  Completed per-block cycle
        counters feed the registry's cost model, so duration predictions
        tighten with every drain.

        On a sub-batch failure the remaining sub-batches still execute;
        the failing group's requests requeue (bumped retry count, tail
        of the queue) and the first exception re-raises at the end with
        every completed result stashed for the next drain.  A dependent
        whose producer has not completed (requeued, or beyond the window
        bound) requeues without a retry bump; once a producer is
        *dropped*, its dependents fail with it.
        """
        if not self._pending and not self._completed:
            return {}, DrainStats(0, 0, self.n_sm, 0.0, 0.0,
                                  np.zeros(self.n_sm, np.int64), 0,
                                  by_tenant={}, by_bucket={},
                                  pool=self.gmem_pool.stats(),
                                  n_devices=self.n_devices)
        t0 = time.perf_counter()
        # redeem sub-batches completed before a previous drain() raised
        results, self._completed = self._completed, {}
        per_sm = np.zeros(self.n_sm, np.int64)
        n_blocks = n_steps = n_launches = 0
        n_windows = n_sub_batches = n_shed = 0
        useful_words = padded_words = sm_slots = 0
        makespan = busy = 0
        energy_eu = 0.0
        by_tenant: Dict[str, TenantStats] = {}
        by_bucket: Dict[int, BucketStats] = {}
        queue = self.policy.arrange(self._pending)
        self._pending = []
        requeue: List[LaunchRequest] = []
        first_error: Optional[BaseException] = None
        drain_sp = self.tracer.span(
            "drain", n_sm=self.n_sm, pending=len(queue),
            policy=type(self.policy).__name__)
        with drain_sp:
          while queue and (max_windows is None or n_windows < max_windows):
            with self.tracer.span("window", index=n_windows) as win_sp:
              with self.tracer.span("pack"):
                window, shed = self._pack_window(queue, max_window_cycles)
              n_windows += 1
              t_pack = time.perf_counter()
              for r in shed:
                  self._shed(r, t_pack)
              n_shed += len(shed)
              win_sp.set(n_launches=len(window), n_shed=len(shed))
              for r in window:
                  tm = self._timings.get(r.ticket)
                  if tm is not None and tm.packed is None:
                      tm.packed = t_pack
                      # stamped at dequeue time; a launch deferred by an
                      # earlier partial drain gets a ROOT span — its
                      # wait overlaps that whole drain, so nesting it
                      # inside THIS drain's window would mis-parent it
                      self.tracer.timed_span(
                          "queue-wait", tm.submit, t_pack,
                          root=tm.deferred,
                          ticket=r.ticket, tenant=r.client)
              for sb in self._topo_order(self._cut(window)):
                # materialize dependent launches' memories from their
                # producers' completed results; a dependent whose
                # producer has not completed yet (requeued after a
                # failure, or queued beyond this drain's window bound)
                # requeues WITHOUT a retry bump — it never executed
                ready, specs = [], []
                with self.tracer.span("dep-resolve",
                                      n_launches=len(sb.requests)):
                    for r in sb.requests:
                        g = r.spec.gmem
                        if isinstance(g, DepGmem):
                            src = self._dep_lookup(g.ticket, results)
                            if src is None:
                                if g.ticket in self._dep_dropped:
                                    self._drop(r, RuntimeError(
                                        f"producer ticket {g.ticket} was "
                                        "dropped"), queue, requeue)
                                else:
                                    requeue.append(r)
                                continue
                            specs.append(r.spec._replace(gmem=src))
                        else:
                            specs.append(r.spec)
                        ready.append(r)
                if not ready:
                    continue
                sb = sb._replace(requests=tuple(ready))
                predicted = sum(pol.request_duration(r, self.registry)
                                for r in sb.requests)
                t_disp = time.perf_counter()
                for r in sb.requests:
                    tm = self._timings.get(r.ticket)
                    if tm is not None:
                        tm.dispatched = t_disp
                disp_sp = self.tracer.span(
                    "dispatch", gmem_bucket=sb.gmem_bucket,
                    n_launches=len(sb.requests),
                    tenants=sorted({r.client for r in sb.requests}),
                    tickets=[r.ticket for r in sb.requests],
                    predicted_cycles=int(predicted))
                try:
                    with disp_sp:
                        dg = ex.execute(specs,
                                        n_sm=self.n_sm, cfg=self.cfg,
                                        chunk=self.chunk,
                                        pad_warps=sb.pad_warps,
                                        registry=self.registry,
                                        shard_sm=self.shard_sm,
                                        device=self.device)
                        sub_results = dg.to_results(
                            host_gmem=not self.resident_gmem)
                except Exception as e:
                    # isolate the failure to this sub-batch: window-mates
                    # in other sub-batches still complete; this group's
                    # requests requeue at the TAIL with a bumped retry
                    # count (drained next time in singleton sub-batches),
                    # and a request that keeps failing is dropped after
                    # MAX_ATTEMPTS — its future fails with the exception
                    # and its dependents are dropped with it
                    if first_error is None:
                        first_error = e
                    self.metrics.counter("server.sub_batch_failures").inc()
                    for r in sb.requests:
                        if r.attempts + 1 < self.MAX_ATTEMPTS:
                            requeue.append(
                                r._replace(attempts=r.attempts + 1))
                        else:
                            self._drop(r, e, queue, requeue)
                    continue
                # resolve futures the moment their sub-batch completes —
                # exactly once, independent of window completion order.
                # Completed producers stash their memory for queued
                # dependents; completed blocks feed the cost model.
                t_done = time.perf_counter()
                with self.tracer.span("complete",
                                      n_launches=len(sb.requests)):
                    for req, res in zip(sb.requests, sub_results):
                        results[req.ticket] = res
                        self.registry.cost_model.observe(
                            req.spec.code, res.cycles_per_block)
                        if req.ticket in self._dep_waiters:
                            # pinned pool deposit: device arrays stay on
                            # device; host results upload once at stash
                            # time
                            self.gmem_pool.put(req.ticket, res.gmem,
                                               pin=True)
                        for d in req.deps:
                            self._dep_done(d)
                        fut = self._futures.pop(req.ticket, None)
                        if fut is not None:
                            fut._resolve(res)
                        tm = self._timings.pop(req.ticket, None)
                        if tm is not None:
                            h = self.metrics.histogram
                            h("server.latency_s").record(
                                t_done - tm.submit)
                            h(f"server.latency_s.{req.client}").record(
                                t_done - tm.submit)
                            if tm.packed is not None:
                                h("server.queue_wait_s").record(
                                    tm.packed - tm.submit)
                            if tm.dispatched is not None:
                                h("server.device_s").record(
                                    t_done - tm.dispatched)
                        cyc = int(np.asarray(res.cycles_per_block,
                                             np.int64).sum())
                        # observed per-tenant device time — the share
                        # SlaDrain's SLA weights are judged on
                        for ts in (by_tenant.setdefault(
                                       req.client, TenantStats()),
                                   self.tenant_stats.setdefault(
                                       req.client, TenantStats())):
                            ts.sm_cycles += cyc
                        end_attrs: dict = {"observed_cycles": cyc}
                        if res.overflow:
                            # a launch's warp stack overflowed: results
                            # past the clipped reconvergence point are
                            # suspect — surface it loudly
                            self.metrics.counter(
                                "server.stack_overflow").inc()
                            self.metrics.counter(
                                f"server.stack_overflow.{req.client}"
                            ).inc()
                            end_attrs["stack_overflow"] = True
                        if self.profiler is not None:
                            # counters are host-side already (the one
                            # batched fetch behind to_results) — pure
                            # host arithmetic, zero added transfers
                            lp = self.profiler.observe(
                                res, tenant=req.client,
                                module=req.spec.code.name,
                                ticket=req.ticket,
                                code=req.spec.code.code)
                            energy_eu += lp.energy.total
                            end_attrs["energy_eu"] = round(
                                lp.energy.total, 3)
                            end_attrs["simt_efficiency"] = round(
                                lp.simt_efficiency, 6)
                        self.tracer.end_async(
                            "launch", req.ticket, **end_attrs)
                rep = dg.report()
                disp_sp.set(observed_cycles=rep.kernel_cycles,
                            max_sp=rep.max_sp)
                if rep.overflow:
                    disp_sp.set(stack_overflow=True)
                per_sm += rep.per_sm_cycles
                n_blocks += rep.n_blocks
                n_steps += rep.n_steps
                n_launches += len(sb.requests)
                n_sub_batches += 1
                useful_words += rep.useful_gmem_words
                padded_words += rep.padded_gmem_words
                sm_slots += rep.n_steps * rep.n_sm
                makespan += rep.kernel_cycles
                busy += rep.busy_cycles
                self._account(sb, rep, by_tenant, by_bucket)
        # anything not drained this call (window bound or failures) goes
        # back on the queue: unprocessed arrivals first, retries at tail
        self._pending = queue + requeue
        for r in queue:
            tm = self._timings.get(r.ticket)
            if tm is not None and tm.packed is None:
                # survived a partial drain unpacked: its eventual
                # queue-wait span overlaps this drain — parent at root
                tm.deferred = True
        if first_error is not None:
            self._completed.update(results)
            raise first_error
        wall = time.perf_counter() - t0
        self.drains += 1
        self.launches_served += n_launches
        stats = DrainStats(
            n_launches, n_blocks, self.n_sm, wall,
            safe_div(n_launches, max(wall, 1e-9)), per_sm, n_steps,
            n_windows=n_windows, n_sub_batches=n_sub_batches,
            useful_gmem_words=useful_words, padded_gmem_words=padded_words,
            occupancy=safe_div(n_blocks, sm_slots),
            by_tenant=by_tenant, by_bucket=by_bucket,
            makespan_cycles=makespan, busy_cycles=busy,
            pool=self.gmem_pool.stats(), n_devices=self.n_devices,
            n_shed=n_shed, energy_eu=energy_eu)
        drain_sp.set(n_launches=n_launches, n_windows=n_windows,
                     n_shed=n_shed, wall_s=round(wall, 6))
        self._publish_drain(stats)
        return results, stats

    def _publish_drain(self, stats: DrainStats) -> None:
        """Mirror one drain's accounting into the metrics registry —
        counters for cumulative totals, gauges for this-drain values
        (``drain.*``, ``drain.tenant.<t>.*``, ``drain.bucket.<b>.*``,
        ``pool.*``).  The CLI's stats print and the BENCH JSON rows both
        read these, so there is exactly one source of truth."""
        m = self.metrics
        m.counter("server.drains").inc()
        m.counter("server.launches_served").inc(stats.n_launches)
        g = m.gauge
        g("drain.n_launches").set(stats.n_launches)
        g("drain.n_blocks").set(stats.n_blocks)
        g("drain.n_windows").set(stats.n_windows)
        g("drain.n_sub_batches").set(stats.n_sub_batches)
        g("drain.n_shed").set(stats.n_shed)
        g("drain.wall_s").set(round(stats.wall_s, 6))
        g("drain.launches_per_s").set(round(stats.launches_per_s, 3))
        g("drain.occupancy").set(round(stats.occupancy, 6))
        g("drain.duration_balance").set(round(stats.duration_balance, 6))
        g("drain.makespan_cycles").set(stats.makespan_cycles)
        g("drain.busy_cycles").set(stats.busy_cycles)
        g("drain.useful_gmem_words").set(stats.useful_gmem_words)
        g("drain.padded_gmem_words").set(stats.padded_gmem_words)
        if self.profiler is not None:
            g("drain.energy_eu").set(round(stats.energy_eu, 3))
        # Perfetto counter tracks: one sample per drain on each series,
        # so the exported trace carries load/efficiency/energy/overload
        # time-series alongside the span tree (cheap no-ops when the
        # tracer is off)
        tr = self.tracer
        tr.counter("queue_depth", pending=len(self._pending))
        tr.counter("device_utilization",
                   duration_balance=round(stats.duration_balance, 6),
                   occupancy=round(stats.occupancy, 6))
        if self.profiler is not None:
            tr.counter("energy_rate",
                       eu_per_s=round(
                           safe_div(stats.energy_eu, stats.wall_s), 3))
        tr.counter("shed_rate", shed=stats.n_shed)
        for t, ts in (stats.by_tenant or {}).items():
            g(f"drain.tenant.{t}.launches").set(ts.launches)
            g(f"drain.tenant.{t}.blocks").set(ts.blocks)
            g(f"drain.tenant.{t}.sm_cycles").set(ts.sm_cycles)
            g(f"drain.tenant.{t}.useful_gmem_words").set(
                ts.useful_gmem_words)
            g(f"drain.tenant.{t}.padded_gmem_words").set(
                ts.padded_gmem_words)
        for b, bs in (stats.by_bucket or {}).items():
            g(f"drain.bucket.{b}.launches").set(bs.launches)
            g(f"drain.bucket.{b}.sub_batches").set(bs.sub_batches)
            g(f"drain.bucket.{b}.blocks").set(bs.blocks)
            g(f"drain.bucket.{b}.occupancy").set(round(bs.occupancy, 6))
            g(f"drain.bucket.{b}.padded_gmem_words").set(
                bs.padded_gmem_words)
        for k, v in (stats.pool or {}).items():
            g(f"pool.{k}").set(v)
