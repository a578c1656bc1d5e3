"""Per-launch architectural profiling and live energy accounting (port of
``repro.obs.profile``; it prices through the port's own
``core/{energy,customize,microblaze}``).

The paper's whole evaluation is *activity-driven*: dynamic energy from
unit-level event counts (§5.1.2, Tables 4–6) and the 14%
application-customized saving from observed instruction mix.  The
serving runtime already fetches exactly that signal — every drained
launch comes back as a :class:`~repro_torch.runtime.executor.GridResult`
carrying the device's ``op_issues`` / ``op_lanes`` / ``stack_ops`` /
``max_sp`` / ``overflow`` counters in the executor's one batched
host fetch — and this module stops discarding it:

* :func:`profile_launch` turns one result into a
  :class:`LaunchProfile`: instruction mix by unit class
  (:func:`repro_torch.core.microblaze.classify`), SIMT efficiency
  (active lanes / (issues × 32)), divergence telemetry (stack ops,
  high-water stack pointer, overflow), memory intensity (gmem / smem
  lanes per issue) and the launch's dynamic energy
  (:func:`repro_torch.core.energy.activity_energy` on the observed
  activity).
* :class:`ArchProfiler` aggregates profiles per tenant and per module
  (the :class:`Activity` accumulators), emits the ``profile.*`` /
  ``energy.*`` metric families plus energy-per-launch histograms into
  a :class:`~repro_torch.obs.metrics.MetricsRegistry`, and renders the whole
  run as one JSON-safe :meth:`ArchProfiler.report` (the
  ``--profile-out`` document, ``schema_version``-stamped).
* :func:`advise` is the customization advisor: it turns an observed
  :class:`Activity` into the minimal
  :class:`~repro_torch.core.machine.MachineConfig` that serves it — drop the
  multiplier when no IMUL/IMAD issued, drop the third register-file
  read port when no IMAD issued, shrink the warp stack to the observed
  high-water mark — and prices the predicted dynamic-energy saving on
  the same activity (the paper's Table 6 result, derived live from
  serving telemetry instead of static binary analysis, cross-checked
  against :func:`repro_torch.core.customize.validate` when the binary is
  available).

Everything here is host-side arithmetic on counters the executor
already fetched: enabling profiling adds **zero** device transfers and
cannot perturb results (pinned in
``tests/test_torch_obs.py``).

Import note: this module bridges :mod:`repro_torch.obs` to
:mod:`repro_torch.core` (energy model, ISA classes, customization) and is
therefore *not* imported by ``repro_torch.obs.__init__`` — the obs package
itself stays import-cycle free for the runtime that emits into it.
Consumers import it directly: ``from repro_torch.obs import profile``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..core import customize, isa
from ..core.energy import EnergyReport, activity_energy
from ..core.machine import MachineConfig
from ..core.microblaze import classify
from .metrics import MetricsRegistry, safe_div

#: version stamp of every JSON document this module (and the serving
#: CLI's ``--metrics-out``) emits, so downstream BENCH tooling can
#: evolve the schema without guessing
SCHEMA_VERSION = 1

#: opcode -> unit class, precomputed once (classify is pure)
_CLASS_OF = tuple(classify(op) for op in range(isa.NUM_OPCODES))
#: the unit classes in stable order (alu/bra/ctrl/gmem/mul/pred/smem)
CLASSES = tuple(sorted(set(_CLASS_OF)))


def _config_dict(cfg: MachineConfig) -> dict:
    """The customization-relevant fields of a config, JSON-safe."""
    return {"n_sp": cfg.n_sp,
            "warp_stack_depth": cfg.warp_stack_depth,
            "enable_mul": cfg.enable_mul,
            "num_read_operands": cfg.num_read_operands}


@dataclasses.dataclass
class Activity:
    """Accumulated device activity of one or more launches — the raw
    input of the energy model, summable across launches because every
    energy component is linear in it."""
    launches: int = 0
    op_issues: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(isa.NUM_OPCODES, np.int64))
    op_lanes: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(isa.NUM_OPCODES, np.int64))
    stack_ops: int = 0
    max_sp: int = 0              # high-water mark across launches
    overflow_launches: int = 0   # launches whose warp stack overflowed
    kernel_cycles: int = 0       # sum of per-launch makespans

    def add(self, op_issues, op_lanes, stack_ops: int, max_sp: int,
            overflow: bool, kernel_cycles: int) -> None:
        self.launches += 1
        self.op_issues += np.asarray(op_issues, np.int64)
        self.op_lanes += np.asarray(op_lanes, np.int64)
        self.stack_ops += int(stack_ops)
        self.max_sp = max(self.max_sp, int(max_sp))
        self.overflow_launches += int(bool(overflow))
        self.kernel_cycles += int(kernel_cycles)

    # ------------------------------------------------------------ derived

    @property
    def issues(self) -> int:
        return int(self.op_issues.sum())

    @property
    def lanes(self) -> int:
        return int(self.op_lanes.sum())

    def class_issues(self) -> Dict[str, int]:
        """{unit class: issues} — sums exactly to :attr:`issues`."""
        out = {c: 0 for c in CLASSES}
        for op in range(isa.NUM_OPCODES):
            out[_CLASS_OF[op]] += int(self.op_issues[op])
        return out

    def class_lanes(self) -> Dict[str, int]:
        out = {c: 0 for c in CLASSES}
        for op in range(isa.NUM_OPCODES):
            out[_CLASS_OF[op]] += int(self.op_lanes[op])
        return out

    @property
    def simt_efficiency(self) -> float:
        """Active lanes over issued lane slots (issues × 32) ∈ (0, 1]."""
        return safe_div(self.lanes, self.issues * isa.WARP_SIZE)

    @property
    def gmem_lanes_per_issue(self) -> float:
        return safe_div(self.class_lanes()["gmem"], self.issues)

    @property
    def smem_lanes_per_issue(self) -> float:
        return safe_div(self.class_lanes()["smem"], self.issues)

    def energy(self, cfg: MachineConfig, n_sm: int = 1) -> EnergyReport:
        """Price this activity on ``cfg`` — identical to summing
        :func:`~repro_torch.core.energy.simt_energy` over the constituent
        launches (linearity), which tests pin."""
        return activity_energy(self.op_issues, self.op_lanes,
                               self.stack_ops, self.kernel_cycles,
                               cfg, n_sm)

    def as_dict(self, cfg: MachineConfig, n_sm: int = 1) -> dict:
        e = self.energy(cfg, n_sm)
        return {
            "launches": self.launches,
            "issues": self.issues,
            "lanes": self.lanes,
            "class_issues": self.class_issues(),
            "class_lanes": self.class_lanes(),
            "simt_efficiency": round(self.simt_efficiency, 6),
            "gmem_lanes_per_issue": round(self.gmem_lanes_per_issue, 6),
            "smem_lanes_per_issue": round(self.smem_lanes_per_issue, 6),
            "stack_ops": self.stack_ops,
            "max_sp": self.max_sp,
            "overflow_launches": self.overflow_launches,
            "kernel_cycles": self.kernel_cycles,
            "energy_eu": round(e.total, 3),
            "energy_by_component": {k: round(v, 3)
                                    for k, v in e.by_component.items()},
        }


@dataclasses.dataclass(frozen=True)
class LaunchProfile:
    """One launch's architectural profile (see module docstring)."""
    tenant: str
    module: str
    ticket: int
    issues: int
    lanes: int
    class_issues: Dict[str, int]
    class_lanes: Dict[str, int]
    simt_efficiency: float
    gmem_lanes_per_issue: float
    smem_lanes_per_issue: float
    stack_ops: int
    max_sp: int
    overflow: bool
    kernel_cycles: int
    energy: EnergyReport


def profile_launch(res, cfg: MachineConfig, n_sm: int = 1,
                   tenant: str = "anon", module: str = "?",
                   ticket: int = -1) -> LaunchProfile:
    """Profile one :class:`~repro_torch.runtime.executor.GridResult` — pure
    host arithmetic on the already-fetched counters."""
    act = Activity()
    act.add(res.op_issues, res.op_lanes, res.stack_ops, res.max_sp,
            res.overflow, res.sm_cycles(n_sm))
    return LaunchProfile(
        tenant=tenant, module=module, ticket=ticket,
        issues=act.issues, lanes=act.lanes,
        class_issues=act.class_issues(), class_lanes=act.class_lanes(),
        simt_efficiency=act.simt_efficiency,
        gmem_lanes_per_issue=act.gmem_lanes_per_issue,
        smem_lanes_per_issue=act.smem_lanes_per_issue,
        stack_ops=act.stack_ops, max_sp=act.max_sp,
        overflow=bool(res.overflow), kernel_cycles=act.kernel_cycles,
        energy=act.energy(cfg, n_sm))


@dataclasses.dataclass(frozen=True)
class Advice:
    """Customization-advisor output for one observed activity."""
    suggested: MachineConfig
    base_energy: float
    advised_energy: float
    predicted_saving: float      # 1 - advised/base, in [0, 1)
    problems: List[str]          # static validation caveats (may be [])

    def as_dict(self) -> dict:
        return {"suggested": _config_dict(self.suggested),
                "base_energy_eu": round(self.base_energy, 3),
                "advised_energy_eu": round(self.advised_energy, 3),
                "predicted_saving": round(self.predicted_saving, 6),
                "problems": list(self.problems)}


def advise(act: Activity, base: MachineConfig = MachineConfig(),
           n_sm: int = 1, code: Optional[np.ndarray] = None) -> Advice:
    """The minimal :class:`MachineConfig` for an *observed* activity,
    with its predicted dynamic-energy saving (paper Table 6, live).

    Observed-minimal means: multiplier present iff IMUL/IMAD actually
    issued, third register-read port present iff IMAD issued, warp
    stack shrunk to the observed high-water ``max_sp`` (never grown
    past ``base``; kept at ``base`` when a launch overflowed — a
    truncated stack observation is a lower bound, not a requirement).
    When the module binary is available, the suggestion is
    cross-checked with :func:`repro_torch.core.customize.validate`: static
    problems (e.g. a divergence depth the observed inputs never
    reached) come back as caveats rather than silently widening the
    config — the operator decides whether observed traffic or the
    static bound governs.
    """
    uses_mul = bool(act.op_issues[isa.IMUL] or act.op_issues[isa.IMAD])
    uses_third = bool(act.op_issues[isa.IMAD])
    if act.overflow_launches:
        depth = base.warp_stack_depth
    else:
        depth = min(base.warp_stack_depth, max(act.max_sp, 1))
    suggested = dataclasses.replace(
        base, enable_mul=uses_mul,
        num_read_operands=3 if uses_third else 2,
        warp_stack_depth=depth)
    problems = [] if code is None else customize.validate(code, suggested)
    base_e = act.energy(base, n_sm).total
    adv_e = act.energy(suggested, n_sm).total
    return Advice(suggested, base_e, adv_e,
                  max(0.0, 1.0 - safe_div(adv_e, base_e)), problems)


class ArchProfiler:
    """Aggregates per-launch profiles for a serving run.

    The server calls :meth:`observe` from its drain's complete block —
    the counters are host-side by then (the executor's one batched
    fetch), so profiling adds zero device transfers.  Aggregates live
    per tenant and per module; every observation also lands in the
    metrics registry:

    * ``profile.launches[.<tenant>]`` — profiled launches (counter);
    * ``profile.issues`` / ``profile.lanes`` — cumulative issue/lane
      totals (counters);
    * ``profile.class_issues.<class>`` / ``profile.class_lanes.<class>``
      — instruction mix by unit class (counter families);
    * ``profile.simt_efficiency[.<tenant>]`` — cumulative SIMT
      efficiency (gauge, recomputed per observation);
    * ``energy.total_eu`` / ``energy.tenant.<t>`` /
      ``energy.module.<m>`` — dynamic energy in model units (counters);
    * ``energy.per_launch_eu[.<tenant>]`` — energy-per-launch
      histograms (exact quantiles, like the latency families).
    """

    def __init__(self, cfg: MachineConfig = MachineConfig(),
                 n_sm: int = 1,
                 metrics: Optional[MetricsRegistry] = None):
        self.cfg = cfg
        self.n_sm = n_sm
        self.metrics = metrics if metrics is not None \
            else MetricsRegistry(enabled=False)
        self.total = Activity()
        self.by_tenant: Dict[str, Activity] = {}
        self.by_module: Dict[str, Activity] = {}
        #: latest binary seen per module name — lets :meth:`report`
        #: cross-check advisor suggestions against the static analysis
        self._module_code: Dict[str, np.ndarray] = {}

    # ------------------------------------------------------------- observe

    def observe(self, res, tenant: str = "anon", module: str = "?",
                ticket: int = -1,
                code: Optional[np.ndarray] = None) -> LaunchProfile:
        """Fold one completed launch into the aggregates; returns its
        :class:`LaunchProfile` (the server attaches energy + SIMT
        efficiency from it to the launch's trace span)."""
        lp = profile_launch(res, self.cfg, self.n_sm, tenant=tenant,
                            module=module, ticket=ticket)
        for act in (self.total,
                    self.by_tenant.setdefault(tenant, Activity()),
                    self.by_module.setdefault(module, Activity())):
            act.add(res.op_issues, res.op_lanes, res.stack_ops,
                    res.max_sp, res.overflow, lp.kernel_cycles)
        if code is not None:
            self._module_code[module] = code
        m = self.metrics
        m.counter("profile.launches").inc()
        m.counter(f"profile.launches.{tenant}").inc()
        m.counter("profile.issues").inc(lp.issues)
        m.counter("profile.lanes").inc(lp.lanes)
        for cls, n in lp.class_issues.items():
            if n:
                m.counter(f"profile.class_issues.{cls}").inc(n)
        for cls, n in lp.class_lanes.items():
            if n:
                m.counter(f"profile.class_lanes.{cls}").inc(n)
        m.gauge("profile.simt_efficiency").set(
            round(self.total.simt_efficiency, 6))
        m.gauge(f"profile.simt_efficiency.{tenant}").set(
            round(self.by_tenant[tenant].simt_efficiency, 6))
        e = lp.energy.total
        m.counter("energy.total_eu").inc(e)
        m.counter(f"energy.tenant.{tenant}").inc(e)
        m.counter(f"energy.module.{module}").inc(e)
        m.histogram("energy.per_launch_eu").record(e)
        m.histogram(f"energy.per_launch_eu.{tenant}").record(e)
        return lp

    # -------------------------------------------------------------- report

    def advise_module(self, module: str) -> Advice:
        """Advisor run for one observed module's aggregate activity."""
        return advise(self.by_module[module], self.cfg, self.n_sm,
                      code=self._module_code.get(module))

    def report(self) -> dict:
        """The run's full architectural profile as one JSON-safe
        document (the ``--profile-out`` shape; see
        docs/observability.md for the field inventory)."""
        return {
            "schema_version": SCHEMA_VERSION,
            "n_sm": self.n_sm,
            "base_config": _config_dict(self.cfg),
            "launches": self.total.launches,
            "total": self.total.as_dict(self.cfg, self.n_sm),
            "tenants": {t: a.as_dict(self.cfg, self.n_sm)
                        for t, a in sorted(self.by_tenant.items())},
            "modules": {
                name: {**a.as_dict(self.cfg, self.n_sm),
                       "advisor": self.advise_module(name).as_dict()}
                for name, a in sorted(self.by_module.items())},
        }
