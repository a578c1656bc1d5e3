"""Multi-tenant soft-GPGPU serving driver (port of
``repro.launch.gpgpu_serve``).

    PYTHONPATH=src python -m repro_torch.launch.gpgpu_serve \
        --launches 16 --n-sm 2 --tenants 4 [--device cpu] \
        [--policy bucket|fair|monolithic|balanced|sla] \
        [--skewed | --longtail] [--baseline]

Simulated tenants submit a mixed workload — the five paper kernels
plus the DSL-compiled histogram / prefix-scan / ELL-SpMV kernels
(``repro_torch.compiler``), at several input sizes — to the device
runtime's launch queue
(:class:`repro_torch.runtime.RuntimeServer`), whose drain policy cuts each
window of pending launches into SM-packed dispatch groups on one
compiled machine: the overlay property ("new CUDA binary, no FPGA
recompilation") exercised as a serving layer.  The default ``bucket``
policy sub-batches by (gmem bucket, binary) so a small tenant never
pads to a large tenant's memory bucket; ``--skewed`` builds the
worst-case workload for the monolithic drain (one large-bucket tenant
plus several small ones) to show the padded-words gap; ``--longtail``
builds the worst case for the *bucket* drain — many single-block
binaries of skewed durations, where ``--policy balanced`` packs the
window by predicted duration (cost-model LPT) and cuts the drain
makespan.  Every result is oracle-checked.  ``--baseline`` also times
one sequential ``run_grid`` call per launch and reports the throughput
ratio.

It runs on the card unless ``--device cpu``: every dispatch group is then
one launch of the fused SM kernel (``fused_sm_run``).  ``--no-compiled``
serves the five paper kernels alone.

``--loop`` serves through a background
:class:`~repro_torch.runtime.ServingLoop` (continuous drain) instead of one
explicit drain; ``--loadgen`` drives the loop with the seeded open-loop
generator (Poisson / ``--bursty`` ON-OFF tenants at ``--rate`` over
``--duration-s``), with ``--sla tenant=weight`` switching to
SLA-weighted fair scheduling and ``--deadline-s`` shedding launches
that outstay their latency budget — see ``docs/serving.md``.  Each drain
starts with the executor's predecode cache cleared (where the JAX CLI
clears its jit caches), so its build attribution shows its own misses.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch import obs
from repro_torch import runtime as rt
from repro_torch.core import asm, isa, scheduler
from repro_torch.core.pipeline.state import host_numpy, resolve_device
from repro_torch.core.programs import ALL, compiled_kernels
from repro_torch.runtime import executor

#: per-kernel tenant input sizes (reduction stays single-pass; the
#: DSL-compiled kernels ride along with their own geometries and
#: land in *different* code buckets than the hand-written five, so
#: the mixed workload exercises genuinely heterogeneous footprints)
SIZES = {"autocorr": (32, 64, 128), "bitonic": (32, 64, 128),
         "matmul": (32, 64), "reduction": (32,), "transpose": (32, 64),
         "histogram": (64, 128), "scan": (64, 128), "spmv": (32, 64)}


def workload_kernels(include_compiled: bool = True):
    """Name -> module pool the mixed workload draws from: the paper's
    five hand-written benchmarks plus the DSL-compiled kernels."""
    pool = dict(ALL)
    if include_compiled:
        pool.update(compiled_kernels())
    return pool


def build_workload(n_launches: int, seed: int = 0,
                   include_compiled: bool = True):
    pool = workload_kernels(include_compiled)
    names = sorted(pool)
    counts = {k: 0 for k in names}
    work = []
    for i in range(n_launches):
        name = names[i % len(names)]
        mod = pool[name]
        sizes = SIZES[name]
        n = sizes[counts[name] % len(sizes)]
        counts[name] += 1
        work.append((name, mod, n, mod.build(n), mod.launch(n),
                     mod.make_gmem(np.random.default_rng(seed + i), n)))
    return work


def build_skewed_workload(n_small: int = 7, seed: int = 0):
    """One large-gmem-bucket tenant plus ``n_small`` small ones.

    transpose n=64 lands in the 8192-word pow2 bucket; the small
    tenants (bitonic/autocorr n=32) in the 64-word bucket — the
    footprint skew where a monolithic drain pads every small tenant to
    the large bucket and a bucketed drain pays almost nothing.
    """
    mod = ALL["transpose"]
    work = [("transpose", mod, 64, mod.build(64), mod.launch(64),
             mod.make_gmem(np.random.default_rng(seed), 64))]
    for i in range(n_small):
        name = ("bitonic", "autocorr")[i % 2]
        mod = ALL[name]
        work.append((name, mod, 32, mod.build(32), mod.launch(32),
                     mod.make_gmem(np.random.default_rng(seed + 1 + i), 32)))
    return work


class AddK:
    """Synthetic straightline kernel: ``out[tid] = in[tid] + k``.

    The ``k`` repeated IADDs make per-block duration proportional to
    ``k`` while every variant shares one footprint (64-instr code
    bucket, 128-word gmem bucket, 1 warp) — the controlled duration
    skew the longtail workload needs.  Distinct ``k`` means a distinct
    binary, so the bucket drain cannot merge them; only duration-aware
    packing can.  Mirrors the paper-kernel module interface
    (build/launch/make_gmem/out_slice/oracle) so ``drain_workload``
    oracle-checks it like any tenant kernel.

    ``block_w`` (default a full warp) narrows the block to fewer
    threads: a ``block_w=8`` variant issues full warps with only 8 of
    32 lanes active — SIMT efficiency 0.25 by construction.  The
    profiler benchmarks use it as the controlled *inefficient,
    mul-free* tenant whose advisor-suggested config (no multiplier, no
    third read port, depth-1 stack) shows the paper's Table 6
    customization saving from observed activity alone.
    """

    GMEM_WORDS = 128

    def __init__(self, k: int, in_at: int = 0, out_at: int = 64,
                 grid=(1, 1), block_w: int = 32):
        assert 1 <= k <= 60, "k+4 instructions must fit the 64 bucket"
        assert 1 <= block_w <= 32, "one warp: 1..32 threads"
        self.k = k
        self.in_at = in_at
        self.out_at = out_at
        self.grid = grid
        self.block_w = block_w

    def build(self, n=None) -> np.ndarray:
        p = asm.Program(f"addk{self.k}")
        p.s2r("r0", isa.SR_TID)
        p.ldg("r1", "r0", self.in_at)
        for _ in range(self.k):
            p.iadd("r1", "r1", 1)
        p.stg("r0", "r1", self.out_at)
        p.exit()
        # unpadded: the registry pads to the shared 64-instr bucket and
        # keeps n_instr = k+4, so the cost model's program-length seed
        # really orders the variants before any drain has observed them
        return p.finish()

    def launch(self, n=None):
        return self.grid, (self.block_w, 1)

    def make_gmem(self, rng, n=None) -> np.ndarray:
        g = np.zeros(self.GMEM_WORDS, np.int32)
        g[self.in_at:self.in_at + self.block_w] = \
            rng.integers(0, 1 << 16, self.block_w)
        return g

    def out_slice(self, n=None):
        return slice(self.out_at, self.out_at + self.block_w)

    def oracle(self, g0, n=None):
        return g0[self.in_at:self.in_at + self.block_w] + self.k


def build_longtail_workload(n_launches: int = 8, seed: int = 0):
    """Skewed-duration workload: single-block binaries, linear duration
    spread (k = 7, 14, .., 56 — all inside the 64-instr code bucket).

    Every launch shares one footprint but owns a distinct binary, so
    ``BucketDrain`` cuts the window into one singleton sub-batch per
    binary — each leaving every SM but one idle, makespan ~= the SUM of
    all durations.  ``BalancedDrain`` merges the window into one
    duration-ordered dispatch group whose round-robin positions spread
    the long blocks across SMs first (greedy LPT): makespan ~= sum/n_sm.
    """
    work = []
    for i in range(n_launches):
        mod = AddK(7 * (1 + i % 8))
        work.append((f"addk{mod.k}", mod, 32, mod.build(),
                     mod.launch(),
                     mod.make_gmem(np.random.default_rng(seed + i))))
    return work


def run_sequential_baseline(work, device="cuda") -> float:
    """One ``run_grid`` call per launch, oracle-checked.

    Returns wall seconds — the denominator of the serving-throughput
    claim.  Unlike the JAX CLI's baseline, which starts from cold jit
    caches, the kernels are already built here (``kernels/_build.py``
    builds them once, at the first launch), so this times the launches
    alone.  Each ``run_grid`` ends in its host fetch, so the clock covers
    the device work.
    """
    outs = []
    t0 = time.perf_counter()
    for name, mod, n, code, (grid, bd), g0 in work:
        outs.append(scheduler.run_grid(code, grid, bd, g0.copy(),
                                       device=device))
    wall = time.perf_counter() - t0
    # oracle checks outside the timed window, mirroring drain_workload
    for (name, mod, n, code, _, g0), res in zip(work, outs):
        np.testing.assert_array_equal(res.gmem[mod.out_slice(n)],
                                      mod.oracle(g0, n))
    return wall


def drain_workload(work, n_sm: int, tenants: int = 4,
                   policy: str = "bucket",
                   max_window_cycles: int = None,
                   resident: bool = False,
                   metrics: "obs.MetricsRegistry" = None,
                   shard_sm: bool = False,
                   profile: bool = False,
                   device="cuda", sm_devices=None):
    """Submit ``work`` to a fresh server, predecode cache cleared, and
    drain it.  ``shard_sm`` and ``sm_devices`` are the server's.

    Oracle-checks every ticket; returns ``(server, stats, wall_s)``.
    ``resident=True`` turns on the device-resident gmem pool
    (``RuntimeServer(resident_gmem=True)``): tenant memory is adopted
    onto the device at submit and stays there across drain windows; the
    oracle check below is then the first host read of each result.

    The server writes its latency histograms and drain gauges into a
    fresh :class:`~repro_torch.obs.MetricsRegistry` (or the one passed
    in), so each call's telemetry is isolated; the drain's per-bucket build
    attribution (wall-ms, cache misses — captured as a delta of the
    process-wide counters) is attached as ``srv.jit_attribution``.  The
    drain's results are kept as ``srv.last_results`` ({ticket:
    GridResult}, ticket order = ``work`` order), for callers that check
    more than the oracles.
    """
    executor.clear_caches()
    srv = rt.RuntimeServer(n_sm=n_sm, policy=policy,
                           max_window_cycles=max_window_cycles,
                           resident_gmem=resident,
                           metrics=metrics or obs.MetricsRegistry(),
                           shard_sm=shard_sm, profile=profile,
                           device=device, sm_devices=sm_devices)
    jit_before = obs.jit_summary()
    tickets = {}
    t0 = time.perf_counter()
    for i, (name, mod, n, code, (grid, bd), g0) in enumerate(work):
        t = srv.submit(code, grid, bd, g0.copy(),
                       client=f"tenant{i % tenants}")
        tickets[t] = (mod, n, g0)
    results, stats = srv.drain()
    wall = time.perf_counter() - t0
    srv.jit_attribution = obs.jit_delta(jit_before, obs.jit_summary())
    srv.last_results = results
    for t, (mod, n, g0) in tickets.items():
        np.testing.assert_array_equal(
            host_numpy(results[t].gmem)[mod.out_slice(n)],
            mod.oracle(g0, n))
    return srv, stats, wall


def metrics_document(srv, loadgen=None) -> dict:
    """The serving run's full telemetry as one JSON-safe document: the
    server's registry snapshot (latency histograms, ``drain.*`` /
    ``pool.*`` gauges, ``server.*`` counters) plus the drain's build
    attribution and the process transfer counters.  The CLI's
    ``--metrics`` print, ``--metrics-out`` dump, and the BENCH JSON rows
    all derive from this one shape.  A loadgen run attaches its
    :class:`~repro_torch.runtime.LoadReport` under ``"loadgen"`` — the shape
    the CI serving smoke validates (p50/p99 present, zero unresolved).
    ``schema_version`` stamps the document so downstream BENCH tooling
    can evolve the shape safely."""
    from repro_torch.obs.profile import SCHEMA_VERSION
    doc = {"schema_version": SCHEMA_VERSION,
           "metrics": srv.metrics.snapshot(),
           "jit": getattr(srv, "jit_attribution", {}),
           "transfers": rt.TRANSFERS.snapshot()}
    if loadgen is not None:
        doc["loadgen"] = loadgen.as_dict()
    return doc


def loadgen_pool(work, oracle: bool = True, device="cuda"):
    """:class:`~repro_torch.runtime.WorkItem` pool from ``build_workload``
    output.  With ``oracle=True`` each item carries the full expected
    gmem from one sequential ``run_grid`` call — the load generator then
    bit-checks every completed launch against it (and the run doubles
    as a warm-up, so loadgen latencies measure serving, not the kernels'
    build)."""
    pool = []
    for name, mod, n, code, (grid, bd), g0 in work:
        exp = None
        if oracle:
            exp = np.asarray(
                scheduler.run_grid(code, grid, bd, g0.copy(),
                                   device=device).gmem, np.int64)
        pool.append(rt.WorkItem(
            name=f"{name}-{n}", code=code, grid=grid, block_dim=bd,
            gmem=np.asarray(g0, np.int32), expected_gmem=exp))
    return pool


def parse_sla(pairs):
    """``tenant=weight`` strings -> weights dict (argparse helper)."""
    weights = {}
    for p in pairs or ():
        try:
            tenant, w = p.split("=", 1)
            weights[tenant] = float(w)
        except ValueError:
            raise SystemExit(f"--sla expects tenant=weight, got {p!r}")
    return weights


def build_tenants(n: int, rate_hz: float, weights=None, bursty=False,
                  deadline_s=None):
    """The CLI's tenant set: ``tenant0..tenantN-1`` sharing ``rate_hz``
    equally; with ``bursty`` every other tenant becomes ON-OFF at the
    same time-averaged rate (so the aggregate offered load is
    unchanged, only its burstiness)."""
    weights = weights or {}
    tenants = []
    for i in range(n):
        name = f"tenant{i}"
        onoff = bursty and i % 2 == 1
        # ON-OFF at 4x during the ON quarter of each cycle == the same
        # average rate as the Poisson tenants
        tenants.append(rt.TenantSpec(
            name, rate_hz=(4.0 if onoff else 1.0) * rate_hz / n,
            process="onoff" if onoff else "poisson",
            weight=float(weights.get(name, 1.0)),
            deadline_s=deadline_s, on_s=0.1, off_s=0.3))
    return tenants


def serve_loadgen(work, args, pool=None):
    """The ``--loop --loadgen`` path: a ServingLoop over a fresh server,
    driven by the seeded open-loop (or closed-loop) generator.  Returns
    ``(srv, report)``; every completed launch is oracle-checked inside
    the generator (``report.mismatched`` must be 0).  ``pool`` is a
    :func:`loadgen_pool` of ``work`` built beforehand (its oracle runs
    then happen before the call); by default it is built here."""
    weights = parse_sla(args.sla)
    policy = rt.SlaDrain(weights) if weights else args.policy
    srv = rt.RuntimeServer(n_sm=args.n_sm, policy=policy,
                           max_window_cycles=args.max_window_cycles,
                           resident_gmem=args.resident_gmem,
                           metrics=obs.MetricsRegistry(),
                           shard_sm=args.shard_sm, profile=args.profile,
                           device=args.device)
    if pool is None:
        pool = loadgen_pool(work, device=args.device)
    tenants = build_tenants(args.tenants, args.rate, weights,
                            bursty=args.bursty,
                            deadline_s=args.deadline_s)
    # the loop inherits the server's max_window_cycles by default
    loop = rt.ServingLoop(srv)
    with loop:
        if args.loadgen_mode == "closed":
            n_per = max(1, int(args.rate * args.duration_s
                               / max(args.tenants, 1)))
            report = rt.run_closed_loop(loop, pool, tenants, n_per,
                                        seed=args.seed)
        else:
            arrivals = rt.build_arrivals(tenants, args.duration_s,
                                         len(pool), seed=args.seed)
            report = rt.run_open_loop(loop, pool, arrivals,
                                      time_scale=args.time_scale)
    return srv, report


def print_load_report(report) -> None:
    print(f"[loadgen] mode={report.mode}: {report.submitted} submitted / "
          f"{report.completed} completed / {report.rejected} rejected / "
          f"{report.shed} shed / {report.failed} failed / "
          f"{report.unresolved} unresolved / "
          f"{report.mismatched} mismatched in {report.duration_s:.2f}s "
          f"({report.throughput_per_s:.2f} launches/s)")
    print(f"[loadgen] latency p50 {report.p50_ms:.1f} ms / "
          f"p99 {report.p99_ms:.1f} ms; loop "
          f"{report.loop_iterations} iterations, "
          f"{report.loop_window_errors} window errors")
    for t in sorted(report.tenants):
        tr = report.tenants[t]
        print(f"[loadgen]   {t}: {tr.completed}/{tr.submitted} ok "
              f"(shed {tr.shed}, rejected {tr.rejected}), p50 "
              f"{tr.p50_ms:.1f} ms, p99 {tr.p99_ms:.1f} ms, "
              f"{tr.throughput_per_s:.2f}/s, cycle share "
              f"{tr.cycle_share:.3f}")


def serve_loop(work, args):
    """The ``--loop`` (no loadgen) path: submit the whole workload as a
    burst through a running ServingLoop, quiesce, oracle-check every
    future.  Returns ``(srv, n_completed, wall_s)``."""
    executor.clear_caches()
    srv = rt.RuntimeServer(n_sm=args.n_sm, policy=args.policy,
                           max_window_cycles=args.max_window_cycles,
                           resident_gmem=args.resident_gmem,
                           metrics=obs.MetricsRegistry(),
                           shard_sm=args.shard_sm, profile=args.profile,
                           device=args.device)
    futs = []
    t0 = time.perf_counter()
    with rt.ServingLoop(srv) as loop:
        for i, (name, mod, n, code, (grid, bd), g0) in enumerate(work):
            fut = loop.submit(code, grid, bd, g0.copy(),
                              client=f"tenant{i % args.tenants}")
            futs.append((fut, mod, n, g0))
        loop.quiesce()
    wall = time.perf_counter() - t0
    for fut, mod, n, g0 in futs:
        np.testing.assert_array_equal(
            host_numpy(fut.result().gmem)[mod.out_slice(n)],
            mod.oracle(g0, n))
    return srv, len(futs), wall


def print_stats(srv, stats, wall: float, n_sm: int, tenants: int) -> None:
    per_sm = ",".join(str(int(c)) for c in stats.per_sm_cycles)
    print(f"[serve] {stats.n_launches} launches / {stats.n_blocks} blocks "
          f"from {tenants} tenants on {n_sm} SMs: {wall:.2f}s "
          f"({stats.launches_per_s:.2f} launches/s), "
          f"binary cache {len(srv.registry)} modules "
          f"({srv.registry.hits} hits), per-SM cycles [{per_sm}]")
    print(f"[serve] policy={srv.policy.name}: {stats.n_windows} windows / "
          f"{stats.n_sub_batches} sub-batches, gmem words "
          f"useful={stats.useful_gmem_words} "
          f"padded={stats.padded_gmem_words}, "
          f"SM-step occupancy {stats.occupancy:.2f}")
    print(f"[serve] drain makespan {stats.makespan_cycles} cycles "
          f"(busy {stats.busy_cycles}, duration balance "
          f"{stats.duration_balance:.2f})")
    if stats.n_devices > 1:
        per_dev = ",".join(str(int(c)) for c in stats.device_cycles)
        print(f"[serve] sharded over {stats.n_devices} devices "
              f"({stats.n_sm // stats.n_devices} SMs each): per-device "
              f"cycles [{per_dev}], skew {stats.device_skew:.2f}")
    # the per-tenant / per-bucket / pool detail is one render of the
    # registry snapshot — the same dict --metrics-out and the BENCH
    # JSON carry, so the CLI cannot drift from the recorded telemetry
    # (gauges here; --metrics prints the full snapshot)
    snap = srv.metrics.snapshot()
    print(obs.render_snapshot({"gauges": snap["gauges"]},
                              prefix="[serve]   "))
    jit = getattr(srv, "jit_attribution", None)
    if jit:
        for bucket in sorted(jit):
            d = jit[bucket]
            print(f"[serve]   jit {bucket}: "
                  f"{d.get('jit_cache_misses', 0)} misses, "
                  f"{d.get('jit_trace_ms', 0.0):.1f} ms tracing")


def main(argv=None, pool=None):
    """The CLI.  ``pool`` (Python callers only) hands ``--loadgen`` a
    :func:`loadgen_pool` of the workload these arguments build, so a
    caller counting the serving path's kernel launches can run the
    pool's oracle before it starts counting."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--launches", type=int, default=16)
    ap.add_argument("--n-sm", type=int, default=2)
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policy", choices=sorted(rt.POLICIES),
                    default="bucket", help="drain policy (default: bucket)")
    ap.add_argument("--skewed", action="store_true",
                    help="one large-bucket tenant + small ones (the "
                         "workload bucketed drains exist for)")
    ap.add_argument("--longtail", action="store_true",
                    help="single-block binaries of skewed durations "
                         "(the workload the balanced drain exists for)")
    ap.add_argument("--baseline", action="store_true",
                    help="also time sequential run_grid calls (kernels "
                         "already built)")
    ap.add_argument("--no-compiled", action="store_true",
                    help="legacy five-kernel workload only (skip the "
                         "DSL-compiled histogram/scan/spmv tenants)")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (default: cuda; cpu runs "
                         "the plain PyTorch path)")
    ap.add_argument("--max-window-cycles", type=int, default=None,
                    help="duration budget per drain window: stop "
                         "packing a window once its CostModel-predicted"
                         " cycles exceed this (bounds drain latency)")
    ap.add_argument("--shard-sm", action="store_true",
                    help="shard the SM axis across the local CUDA "
                         "devices: device d runs the contiguous SM range "
                         "[d*n_sm/k, (d+1)*n_sm/k) of every dispatch group "
                         "(bit-exact with the unsharded run); on one card, "
                         "or when --n-sm does not divide over the cards, "
                         "the single-device path runs")
    ap.add_argument("--resident-gmem", action="store_true",
                    help="keep tenant global memory device-resident "
                         "across drain windows (GmemPool); host gmem "
                         "crosses once at submit and once at read-back")
    ap.add_argument("--trace-out", metavar="PATH", default=None,
                    help="record the drain's launch-lifecycle span tree "
                         "and write Chrome-trace/Perfetto JSON to PATH "
                         "(open in chrome://tracing or ui.perfetto.dev)")
    ap.add_argument("--metrics", action="store_true",
                    help="print the full metrics-registry snapshot "
                         "(histogram stats included) after the drain")
    ap.add_argument("--metrics-out", metavar="PATH", default=None,
                    help="dump the metrics document (registry snapshot "
                         "+ transfer counters) as JSON to PATH")
    ap.add_argument("--profile", action="store_true",
                    help="architectural profiling: fold every completed "
                         "launch's device counters into per-tenant/"
                         "per-module instruction mix, SIMT efficiency, "
                         "divergence telemetry and dynamic energy "
                         "(profile.* / energy.* metric families); zero "
                         "added device transfers")
    ap.add_argument("--profile-out", metavar="PATH", default=None,
                    help="write the architectural profile report (per-"
                         "tenant/per-module activity + customization "
                         "advisor) as JSON to PATH (implies --profile)")
    ap.add_argument("--loop", action="store_true",
                    help="serve through a background ServingLoop "
                         "(continuous drain) instead of one explicit "
                         "drain call; every future oracle-checked")
    ap.add_argument("--loadgen", action="store_true",
                    help="drive the loop with the seeded open-loop load"
                         " generator (implies --loop); see docs/"
                         "serving.md for the report schema")
    ap.add_argument("--duration-s", type=float, default=5.0,
                    help="loadgen schedule length in seconds")
    ap.add_argument("--rate", type=float, default=50.0,
                    help="aggregate loadgen arrival rate (launches/s) "
                         "split equally across tenants")
    ap.add_argument("--loadgen-mode", choices=("open", "closed"),
                    default="open",
                    help="open: seeded arrival schedule, no "
                         "coordination with completions; closed: one "
                         "outstanding launch per tenant (capacity "
                         "calibration)")
    ap.add_argument("--time-scale", type=float, default=1.0,
                    help="stretch (>1) or compress (<1, 0=burst) the "
                         "open-loop schedule's real-time pacing")
    ap.add_argument("--sla", action="append", metavar="TENANT=WEIGHT",
                    help="per-tenant SLA weight (repeatable); any "
                         "--sla switches the drain policy to SlaDrain "
                         "(weighted fair queueing in predicted "
                         "SM-cycles)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-launch latency budget for every loadgen "
                         "tenant: launches still queued past it are "
                         "shed with DeadlineExceeded")
    ap.add_argument("--bursty", action="store_true",
                    help="make every other loadgen tenant ON-OFF "
                         "(bursts at 4x rate for a quarter duty cycle)")
    args = ap.parse_args(argv)

    if args.skewed and args.longtail:
        ap.error("--skewed and --longtail are mutually exclusive")
    if args.profile_out:
        args.profile = True
    if args.loadgen:
        args.loop = True
    if args.sla and not args.loadgen:
        ap.error("--sla requires --loadgen (tenant names are the "
                 "loadgen's tenant0..N-1)")
    resolve_device(args.device)       # no card: raise before any work
    if args.skewed:
        work = build_skewed_workload(max(1, args.launches - 1), args.seed)
    elif args.longtail:
        work = build_longtail_workload(args.launches, args.seed)
    else:
        work = build_workload(args.launches, args.seed,
                              include_compiled=not args.no_compiled)
    t_seq = None
    if args.baseline:
        t_seq = run_sequential_baseline(work, device=args.device)
        print(f"[serve] baseline: {len(work)} sequential run_grid "
              f"calls in {t_seq:.2f}s "
              f"({len(work) / t_seq:.2f} launches/s)")

    if args.trace_out:
        obs.TRACER.start()
    stats = report = None
    try:
        if args.loadgen:
            srv, report = serve_loadgen(work, args, pool)
        elif args.loop:
            srv, n_done, wall = serve_loop(work, args)
        else:
            srv, stats, wall = drain_workload(work, args.n_sm,
                                              args.tenants,
                                              args.policy,
                                              args.max_window_cycles,
                                              resident=args.resident_gmem,
                                              shard_sm=args.shard_sm,
                                              profile=args.profile,
                                              device=args.device)
    finally:
        if args.trace_out:
            obs.TRACER.stop()
    if args.trace_out:
        doc = obs.TRACER.export(args.trace_out)
        print(f"[serve] wrote {len(doc['traceEvents'])} trace events "
              f"to {args.trace_out}")
    if args.loadgen:
        print_load_report(report)
    elif args.loop:
        print(f"[serve] loop: {n_done} launches served in {wall:.2f}s "
              f"({n_done / max(wall, 1e-9):.2f} launches/s), all "
              "oracle-checked")
        print(obs.render_snapshot(
            {"gauges": srv.metrics.snapshot()["gauges"]},
            prefix="[serve]   "))
    else:
        print_stats(srv, stats, wall, args.n_sm, args.tenants)
    if args.metrics:
        print(obs.render_snapshot(srv.metrics.snapshot(),
                                  prefix="[metrics] "))
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(metrics_document(srv, loadgen=report), f, indent=1)
        print(f"[serve] wrote metrics snapshot to {args.metrics_out}")
    if args.profile and srv.profiler is not None:
        prof = srv.profiler.report()
        tot = prof["total"]
        print(f"[profile] {prof['launches']} launches profiled: "
              f"{tot['energy_eu']:,.0f} eu dynamic energy, SIMT "
              f"efficiency {tot['simt_efficiency']:.3f}, instruction "
              f"mix {tot['class_issues']}")
        for t, a in prof["tenants"].items():
            print(f"[profile]   {t}: {a['launches']} launches, "
                  f"{a['energy_eu']:,.0f} eu, simt "
                  f"{a['simt_efficiency']:.3f}, max_sp {a['max_sp']}")
        for name, a in prof["modules"].items():
            adv = a["advisor"]
            print(f"[profile]   module {name}: advisor predicts "
                  f"{100 * adv['predicted_saving']:.1f}% energy saving "
                  f"with {adv['suggested']}")
        if args.profile_out:
            with open(args.profile_out, "w") as f:
                json.dump(prof, f, indent=1)
            print(f"[serve] wrote architectural profile to "
                  f"{args.profile_out}")
    if t_seq is not None and not args.loop:
        print(f"[serve] throughput vs sequential: {t_seq / wall:.2f}x")
    return report if args.loadgen else stats


if __name__ == "__main__":
    main()
