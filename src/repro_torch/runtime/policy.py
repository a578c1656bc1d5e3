"""Drain policies — memory-aware window packing for the multi-tenant server
(a copy of ``repro.runtime.policy``).

The paper's multiprocessor scaling story (§4.3) is about keeping every
SM busy without one kernel's footprint starving the rest.  The serving
analogue: :class:`RuntimeServer` drains a window of pending launches in
one pass, and *how that window is cut into dispatch groups* decides both
device memory (every group member pads to the group-wide gmem bucket)
and lockstep efficiency (a group runs as long as its longest block).
This module makes that cut pluggable:

* :class:`MonolithicDrain` — the pre-policy behaviour: one dispatch
  group per window, every tenant padded to the batch-wide max bucket.
  Kept as the baseline the bucketed policies are measured against.
* :class:`BucketDrain` — sub-batches the window by ``(gmem bucket,
  binary)``, like the existing same-binary packing: a dispatch group
  never pads a small tenant's memory to a large tenant's bucket, and
  groups stay homogeneous in code and width.
* :class:`FairBucketDrain` — BucketDrain plus round-robin window
  composition across tenants, so one chatty tenant cannot monopolize
  the SM slots of a bounded window.
* :class:`BalancedDrain` — cost-model-driven *duration* packing: groups
  are keyed on the full launch footprint (binary-agnostic, so equal
  footprints merge into one dispatch group at zero padding cost) and
  blocks are ordered by descending predicted cycles/block — greedy LPT
  bin-packing realized through the executor's position-major
  round-robin, so one long sub-batch no longer serializes a drain
  window behind short ones.
* :class:`SlaDrain` — FairBucketDrain with per-tenant SLA *weights*
  expressed in predicted SM-cycles (weighted fair queueing over the
  CostModel): under bounded windows each backlogged tenant's share of
  device time tracks its weight, and integer priorities arrange
  strictly first.  The policy the always-on :class:`ServingLoop`
  serves under (see ``docs/serving.md``).

All policies are functionally interchangeable: launches own disjoint
memories, so every ticket's result is bit-exact with a sequential
``run_grid`` regardless of the cut — enforced by the differential fuzz
suite in ``tests/test_torch_server.py``.

The module also holds the server's admission-control error and the
per-tenant / per-bucket accounting records surfaced through
``RuntimeServer`` stats and the ``gpgpu_serve`` CLI.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Union

from ..obs import safe_div
from . import registry as reg
from .registry import ModuleRegistry


class AdmissionError(RuntimeError):
    """Raised by ``submit`` when backpressure rejects a launch at the
    door: the bounded queue is full or the tenant's in-flight cap is
    reached.  The client should drain (or wait for the server to) and
    resubmit; nothing was enqueued."""


class DeadlineExceeded(RuntimeError):
    """A launch admitted with ``submit(deadline_s=...)`` was still
    queued when its deadline expired: the server *sheds* it at dequeue
    time instead of executing stale work.  Distinct from
    :class:`AdmissionError` (nothing was ever enqueued) and from a drop
    (the launch failed while executing): a shed launch never reached
    the device.  Its future fails with this error and the shed is
    counted in ``server.shed`` / per-tenant ``TenantStats.shed``."""


@dataclasses.dataclass
class TenantStats:
    """Cumulative per-tenant serving accounting."""
    launches: int = 0           # launches drained successfully
    blocks: int = 0             # thread blocks those launches ran
    useful_gmem_words: int = 0  # words the tenant's launches asked for
    padded_gmem_words: int = 0  # bucket padding its allocations carried
    rejected: int = 0           # submissions bounced by admission control
    dropped: int = 0            # launches dropped after MAX_ATTEMPTS
    shed: int = 0               # launches shed past their deadline
    sm_cycles: int = 0          # observed device cycles the tenant's
    #                             completed blocks executed (the share
    #                             SlaDrain's SLA weights are judged on)


@dataclasses.dataclass
class BucketStats:
    """Cumulative per-gmem-bucket dispatch accounting."""
    launches: int = 0
    sub_batches: int = 0        # dispatch groups executed in this bucket
    blocks: int = 0
    sm_steps: int = 0           # super-steps those groups occupied
    sm_slots: int = 0           # sm_steps * n_sm (block capacity)
    useful_gmem_words: int = 0
    padded_gmem_words: int = 0
    makespan_cycles: int = 0    # sum of the groups' busiest-SM cycles
    busy_cycles: int = 0        # sum of the groups' real-work SM-cycles

    @property
    def occupancy(self) -> float:
        """Fraction of SM-step slots that held a real block.  Finite by
        construction (0.0 for a bucket that never dispatched) — feeds
        BENCH JSON rows and ``drain.bucket.*`` gauges verbatim."""
        return safe_div(self.blocks, self.sm_slots)


class SubBatch(NamedTuple):
    """One dispatch group cut from a drain window by a policy."""
    requests: tuple             # of server.LaunchRequest, window order
    gmem_bucket: int            # the group's shared gmem allocation width
    pad_warps: int              # the group's shared (bucketed) SM width


def request_footprint(request, registry: ModuleRegistry) -> reg.Footprint:
    """Bucketed footprint of one pending request — the axes dispatch
    groups are keyed on.  Specs enqueued by the server already carry
    Modules, so this never re-hashes a binary.  (A dependent launch's
    deferred gmem exposes the producer's length via ``.shape``, so
    footprints work before the memory exists.)"""
    mod = registry.as_module(request.spec.code)
    return reg.footprint(mod, request.spec.block_dim,
                         int(request.spec.gmem.shape[0]))


def request_block_cycles(request, registry: ModuleRegistry) -> float:
    """Predicted cycles/block of one pending request, from the
    registry's :class:`~repro_torch.runtime.registry.CostModel` (observed mean
    if the module has drained before, static program-length seed
    otherwise)."""
    return registry.cost_model.predicted_block_cycles(
        registry.as_module(request.spec.code))


def request_duration(request, registry: ModuleRegistry) -> float:
    """Predicted total cycles of one pending request: blocks x
    predicted cycles/block.  The duration BalancedDrain packs on."""
    gx, gy = request.spec.grid
    return gx * gy * request_block_cycles(request, registry)


def _make_sub_batch(requests: Sequence,
                    registry: ModuleRegistry) -> SubBatch:
    fps = [request_footprint(r, registry) for r in requests]
    return SubBatch(
        requests=tuple(requests),
        gmem_bucket=max(fp.gmem_bucket for fp in fps),
        pad_warps=max(fp.warp_bucket for fp in fps))


class DrainPolicy:
    """How a drain window is composed and cut into dispatch groups.

    ``arrange`` orders the pending queue before windows are packed off
    its head (FIFO by default); ``partition`` cuts one packed window
    into :class:`SubBatch` dispatch groups.  Policies never touch
    request *contents* — results stay bit-exact with sequential
    execution for any arrange/partition.
    """

    name = "base"

    def bind(self, registry: ModuleRegistry) -> None:
        """Attach the server's registry (called once at server
        construction).  Base policies don't need it; cost-aware arrange
        policies (:class:`SlaDrain`) use it for duration predictions."""

    def arrange(self, pending: List) -> List:
        return list(pending)

    def partition(self, window: Sequence,
                  registry: ModuleRegistry) -> List[SubBatch]:
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}()"


class MonolithicDrain(DrainPolicy):
    """One dispatch group per window — the pre-policy super-step.

    Every window-mate pads to the batch-wide max gmem bucket and SM
    width; same-binary launches are sorted adjacent so lockstep groups
    inside the executor stay homogeneous.  Baseline for the padded-words
    accounting of the bucketed policies.
    """

    name = "monolithic"

    def partition(self, window, registry):
        ordered = sorted(window,
                         key=lambda r: registry.as_module(r.spec.code).key)
        return [_make_sub_batch(ordered, registry)]


class BucketDrain(DrainPolicy):
    """Sub-batch the window by (gmem bucket, binary).

    Dispatch groups are keyed on the launch footprint, so a 64-word
    reduction never pays a 8192-word transpose tenant's allocation, and
    each group is homogeneous in binary (hence code bucket and width) —
    the same-binary packing of the monolithic drain, promoted from a
    sort to a cut.  Group order follows each group's first submission,
    keeping drains fair-ish in arrival order.
    """

    name = "bucket"

    def partition(self, window, registry):
        groups: Dict[tuple, List] = {}
        for r in window:
            fp = request_footprint(r, registry)
            key = (fp.gmem_bucket, registry.as_module(r.spec.code).key)
            groups.setdefault(key, []).append(r)
        return [_make_sub_batch(g, registry) for g in groups.values()]


class FairBucketDrain(BucketDrain):
    """BucketDrain plus round-robin window composition across tenants.

    ``arrange`` interleaves the pending queue one launch per tenant per
    cycle (stable within a tenant), so a bounded window serves every
    waiting tenant before any tenant's second launch — one chatty tenant
    cannot monopolize a window's SM slots.
    """

    name = "fair"

    def arrange(self, pending):
        by_client: Dict[str, List] = {}
        for r in pending:
            by_client.setdefault(r.client, []).append(r)
        queues = list(by_client.values())
        out: List = []
        while queues:
            queues = [q for q in queues if q]
            for q in queues:
                if q:
                    out.append(q.pop(0))
        return out


class BalancedDrain(DrainPolicy):
    """Cost-model-driven duration packing: greedy LPT across SM steps.

    BucketDrain balances *footprint* but not *duration*: its groups are
    one binary each, so a window of eight different single-block
    binaries drains as eight sequential sub-batches, each leaving every
    SM but one idle — the long sub-batch serializes behind the short
    ones.  This policy packs by predicted duration instead:

    * groups are keyed on the **full launch footprint** ``(code bucket,
      gmem bucket, warp bucket)`` rather than ``(gmem bucket, binary)``
      — launches with equal footprints share every padded array shape
      (see :class:`~repro_torch.runtime.registry.Footprint`), so merging
      different binaries into one dispatch group costs no padding and
      keeps the memory-awareness of BucketDrain (a small tenant still
      never pads to a large tenant's gmem bucket);
    * within a group, requests are ordered by **descending predicted
      cycles/block** from the registry's cost model (observed drain
      means, program-length seeds for cold modules).  The executor
      assigns schedule position ``p`` to SM ``p % n_sm``, so emitting
      the longest remaining block at each position *is* the greedy
      LPT heuristic realized through position order: long blocks spread
      across SMs first and short ones level the remainder, instead of
      one SM drawing the long block while the rest sit idle;
    * groups themselves run longest-first (deterministic, and the big
      groups' counters land early in the telemetry).

    Predictions only reorder schedule positions — results stay bit-exact
    with sequential ``run_grid`` whatever the model believes, enforced
    by the differential fuzz suite alongside the other policies.
    """

    name = "balanced"

    def partition(self, window, registry):
        groups: Dict[reg.Footprint, List] = {}
        for r in window:
            groups.setdefault(request_footprint(r, registry), []).append(r)
        subs = []
        for g in groups.values():
            # stable LPT order: longest predicted block first, window
            # order among equals (sort is stable)
            ordered = sorted(g, key=lambda r:
                             -request_block_cycles(r, registry))
            subs.append((sum(request_duration(r, registry)
                             for r in ordered),
                         _make_sub_batch(ordered, registry)))
        subs.sort(key=lambda pair: -pair[0])
        return [sb for _, sb in subs]


class SlaDrain(FairBucketDrain):
    """FairBucketDrain with per-tenant SLA *weights* in predicted
    SM-cycles: weighted fair queueing over the CostModel.

    ``FairBucketDrain`` interleaves one *launch* per tenant per cycle —
    fair in launch count, not in device time: a tenant submitting 256-
    block transposes gets the same slot cadence as one submitting
    single-block reductions.  This policy arranges by **virtual time**
    instead: each tenant accrues ``predicted_cycles / weight`` per
    launch picked (predictions from the registry's
    :class:`~repro_torch.runtime.registry.CostModel`, bound via
    :meth:`bind`), and the queue is rebuilt by repeatedly taking the
    head launch of the lowest-virtual-time tenant.  Under bounded
    windows (``max_batch`` / ``max_window_cycles``) the drained prefix
    then gives each backlogged tenant a share of predicted SM-cycles
    proportional to its weight — weight 3 buys 3x the device time of
    weight 1, whatever the per-launch geometry mix.

    Virtual time restarts at zero each ``arrange`` (every drain re-
    arranges the whole queue), so requeued launches are never double-
    charged and an idle tenant never banks unbounded credit.  Requests
    carry an integer ``priority`` (``submit(priority=)``): higher
    priorities are arranged strictly first, weighted-fair *within* each
    priority tier.  Unknown tenants get ``default_weight``.  Partition
    is inherited from BucketDrain, so dispatch groups stay
    (gmem bucket, binary)-keyed and results remain bit-exact with the
    sequential oracle like every other policy.
    """

    name = "sla"

    def __init__(self, weights: Optional[Dict[str, float]] = None,
                 default_weight: float = 1.0):
        self.weights = dict(weights or {})
        self.default_weight = float(default_weight)
        self._registry: Optional[ModuleRegistry] = None

    def bind(self, registry: ModuleRegistry) -> None:
        self._registry = registry

    def weight(self, client: str) -> float:
        """Effective (floored) weight of one tenant — a zero/negative
        configured weight degrades to best-effort, never a crash."""
        return max(float(self.weights.get(client, self.default_weight)),
                   1e-9)

    def _cost(self, request) -> float:
        """Predicted SM-cycles of one request; block count alone when
        no registry is bound (still geometry-aware, never constant)."""
        if self._registry is not None:
            return max(request_duration(request, self._registry), 1e-9)
        gx, gy = request.spec.grid
        return float(gx * gy)

    def arrange(self, pending):
        if not pending:
            return []
        tiers: Dict[int, Dict[str, List]] = {}
        for r in pending:
            prio = int(getattr(r, "priority", 0))
            tiers.setdefault(prio, {}).setdefault(r.client, []).append(r)
        out: List = []
        for prio in sorted(tiers, reverse=True):
            by_client = tiers[prio]
            # deterministic tenant order: first submission in this tier
            order = sorted(by_client,
                           key=lambda c: by_client[c][0].ticket)
            vtime = {c: 0.0 for c in order}
            while by_client:
                c = min((c for c in order if c in by_client),
                        key=lambda c: vtime[c])
                q = by_client[c]
                r = q.pop(0)
                out.append(r)
                vtime[c] += self._cost(r) / self.weight(c)
                if not q:
                    del by_client[c]
        return out

    def __repr__(self):
        return f"SlaDrain(weights={self.weights!r})"


#: CLI / constructor lookup: ``RuntimeServer(policy="bucket")``.
POLICIES = {p.name: p for p in
            (MonolithicDrain, BucketDrain, FairBucketDrain,
             BalancedDrain, SlaDrain)}


def make_policy(policy: Union[str, DrainPolicy, None]) -> DrainPolicy:
    """Coerce a policy name (or pass through an instance)."""
    if policy is None:
        return BucketDrain()
    if isinstance(policy, DrainPolicy):
        return policy
    try:
        return POLICIES[policy]()
    except KeyError:
        raise ValueError(
            f"unknown drain policy {policy!r}; "
            f"choose from {sorted(POLICIES)}") from None
