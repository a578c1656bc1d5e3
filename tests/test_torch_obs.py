"""The port's observability (``repro_torch.obs``) against the JAX package's
``repro.obs``, on the CPU.

* Metrics: the same recordings give equal snapshots, renderings and
  exact quantiles, ``dropped_samples`` included.
* Tracing: the same three-window dependent drain gives the same span tree
  (names and nesting, less the port's own spans), the same async launch
  pairs and the same ``ph:"C"`` counter tracks with equal samples;
  tracing and profiling add no host<->device transfer, on a drain or on
  the serving loop.  The port's own: a span stack and a tid a thread, a
  ``merge`` span in each ``device-execute``, spans as ``torch.profiler``
  events on the profiler's thread, and the export's clock anchor.
* Profiling: the mul-free narrow ``AddK(13, block_w=8)`` tenant has SIMT
  efficiency 0.25 and a predicted 19.0% saving, equal to
  ``repro.obs.profile``'s, and the whole profiler report is equal.
"""
import json
import math
import threading
import time

import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro.runtime as jrt
import repro_torch.obs as tobs
import repro_torch.runtime as trt
from repro.core import scheduler as jscheduler
from repro.launch.gpgpu_serve import AddK as JAddK
from repro.obs import profile as jprof
from repro_torch.core import asm, isa, scheduler
from repro_torch.core.machine import MachineConfig
from repro_torch.core.programs import ALL
from repro_torch.launch.gpgpu_serve import AddK
from repro_torch.obs import profile as tprof
from torch_port_spans import PORT_ONLY


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------- metrics

def _record(obs):
    m = obs.MetricsRegistry()
    m.counter("a.x").inc()
    m.counter("a.y").inc(3)
    m.gauge("g").set(2.5)
    rng = np.random.default_rng(7)
    for v in np.abs(rng.normal(0.01, 0.02, size=257)) + 1e-7:
        m.histogram("lat").record(float(v))
    capped = obs.Histogram(max_samples=4)
    for v in (1.0, 2.0, 3.0, 4.0, 100.0, 200.0):
        capped.record(v)
    snap = m.snapshot()
    snap["histograms"]["capped"] = capped.stats()
    q = [m.histogram("lat").percentile(p) for p in (0, 25, 50, 90, 99)]
    return (snap, obs.render_snapshot(snap, prefix="  "), m.family("a"),
            q, capped.dropped_samples, capped.percentile(100),
            obs.safe_div(1, 0), obs.safe_div(3, 4))


def test_metrics_equal_to_repro_obs():
    got = _record(tobs)
    assert got == _record(jobs)
    snap, text, family, _q, dropped, p100 = got[:6]
    assert dropped == 2 and p100 == 4.0
    assert snap["histograms"]["capped"]["dropped_samples"] == 2
    assert "exclude 2 dropped samples" in text
    assert family == {"x": 1, "y": 3}
    json.dumps(snap)


def test_disabled_registry_and_tracer_record_nothing():
    m = tobs.MetricsRegistry(enabled=False)
    m.counter("c").inc(5)
    m.histogram("h").record(1.0)
    assert m.counter("c").value == 0
    assert math.isnan(m.histogram("h").percentile(50))
    assert m.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}
    tr = tobs.Tracer()
    with tr.span("a", x=1) as sp:
        sp.set(y=2)
    tr.begin_async("launch", 1, "t1")
    tr.counter("queue_depth", pending=1)
    assert sp is tobs.NULL_SPAN and tr.roots == []
    assert tr.to_chrome()["traceEvents"] == []


# --------------------------------------------------------------- tracing

def _addk(asm_mod, k):
    p = asm_mod.Program(f"addk{k}")
    p.s2r("r0", isa.SR_TID)
    p.ldg("r1", "r0", 0)
    p.iadd("r1", "r1", k)
    p.stg("r0", "r1", 0)
    p.exit()
    return p.finish(pad_to=64)


def _tree(span):
    return (span.name, tuple(_tree(c) for c in span.children))


def _traced_drain(rt, obs, asm_mod):
    """A three-window dependent drain with the tracer on: its span
    forest, async pairs, counter-track samples and chrome event shape."""
    cpu = {"device": "cpu"} if rt is trt else {}
    tr = obs.TRACER.clear().start()
    try:
        srv = rt.RuntimeServer(n_sm=2, max_batch=1,
                               metrics=obs.MetricsRegistry(), **cpu)
        s = srv.stream(np.arange(64, dtype=np.int32), client="t0")
        futs = [s.launch(srv.registry.load(_addk(asm_mod, k), f"k{k}"),
                         (1, 1), (32, 1)) for k in (1, 2, 3)]
        srv.drain()
        out = np.array(futs[-1].result().gmem).tolist() if rt is jrt else \
            futs[-1].result().gmem.tolist()
    finally:
        tr.stop()
    doc = tr.to_chrome()
    counters = {name: tr.counter_samples(name) for name in
                ("queue_depth", "device_utilization", "shed_rate")}
    shape = sorted((e["ph"], e["name"], e["cat"], e["tid"])
                   for e in doc["traceEvents"])
    forest = [_tree(r) for r in tr.roots]
    pairs = tr.async_pairs("launch")
    disp = [sp.attrs["observed_cycles"] for sp in tr.find("dispatch")]
    tr.clear()
    return forest, pairs, counters, shape, disp, out


def _drop_port_only(tree):
    return (tree[0], tuple(_drop_port_only(c) for c in tree[1]
                           if c[0] not in PORT_ONLY))


def test_span_tree_and_counter_tracks_equal_to_repro_obs():
    got = _traced_drain(trt, tobs, asm)
    from repro.core import asm as jasm
    want = _traced_drain(jrt, jobs, jasm)
    forest, pairs, counters, shape, disp, out = got
    port_names = {n for tree in forest for n in _names(tree)}
    assert {"dispatch-wait", "launch-run", "merge"} <= port_names
    forest = [_drop_port_only(t) for t in forest if t[0] not in PORT_ONLY]
    shape = [e for e in shape if e[1] not in PORT_ONLY]
    assert forest == want[0]
    assert pairs == want[1] and all(v == ["b", "e"] for v in pairs.values())
    assert counters == want[2] and all(counters.values())
    assert shape == want[3]
    assert disp == want[4] and out == want[5]
    names = {n for tree in forest for n in _names(tree)}
    assert {"submit", "admit", "drain", "window", "pack", "queue-wait",
            "dep-resolve", "dispatch", "device-execute", "counter-sync",
            "complete"} <= names


def _names(tree):
    yield tree[0]
    for c in tree[1]:
        yield from _names(c)


def test_instrumented_drain_bit_exact_and_transfer_free():
    mod = ALL["reduction"]
    code, (grid, bd) = mod.build(32), mod.launch(32)
    g0 = mod.make_gmem(np.random.default_rng(0), 32)

    def run(metrics, profile=False):
        srv = trt.RuntimeServer(n_sm=2, metrics=metrics, profile=profile,
                                device="cpu")
        t = [srv.submit(code, grid, bd, g0.copy(), client=f"t{i}")
             for i in range(3)]
        w = trt.TRANSFERS.window()
        results, _ = srv.drain()
        return [results[k] for k in t], w.snapshot()

    plain, xfer_plain = run(tobs.MetricsRegistry(enabled=False))
    try:
        tobs.TRACER.start()
        traced, xfer_traced = run(tobs.MetricsRegistry())
        profiled, xfer_prof = run(tobs.MetricsRegistry(), profile=True)
    finally:
        tobs.TRACER.stop()
        tobs.TRACER.clear()
    for a, b, c in zip(plain, traced, profiled):
        for x in (b, c):
            np.testing.assert_array_equal(a.gmem, x.gmem)
            np.testing.assert_array_equal(a.op_issues, x.op_issues)
    assert xfer_traced == xfer_plain == xfer_prof
    assert xfer_plain == {"gmem_uploads": 3, "gmem_syncs": 3,
                          "counter_syncs": 1}


def test_instrumented_serving_loop_bit_exact_and_transfer_free():
    """The serving loop, traced and not: the same results bit for bit and
    the same host<->device transfers, its two threads' spans recorded."""
    mod = ALL["reduction"]
    code, (grid, bd) = mod.build(32), mod.launch(32)
    g0 = mod.make_gmem(np.random.default_rng(0), 32)

    def run():
        srv = trt.RuntimeServer(n_sm=2, metrics=tobs.MetricsRegistry(),
                                device="cpu")
        loop = trt.ServingLoop(srv, poll_interval_s=0.005)
        futs = [loop.submit(code, grid, bd, g0.copy(), client=f"t{i}")
                for i in range(3)]
        w = trt.TRANSFERS.window()
        loop.start().quiesce().stop()
        return [f.result() for f in futs], w.snapshot()

    plain, xfer_plain = run()
    try:
        tobs.TRACER.start()
        traced, xfer_traced = run()
    finally:
        tobs.TRACER.stop()
    waits = tobs.TRACER.find("loop.lock-wait")
    idle = tobs.TRACER.find("loop.idle")
    tobs.TRACER.clear()
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a.gmem, b.gmem)
        np.testing.assert_array_equal(a.op_issues, b.op_issues)
        np.testing.assert_array_equal(a.cycles_per_block, b.cycles_per_block)
    assert xfer_traced == xfer_plain == {"gmem_uploads": 3, "gmem_syncs": 3,
                                         "counter_syncs": 1}
    assert len(waits) == 3 and idle


def test_spans_of_two_threads_nest_apart_and_export_on_own_tids():
    """Two threads open and close spans at once, interleaved by a
    barrier: each nests on its own stack, each span names its thread,
    and the export puts each thread on a tid of its own, named."""
    tr = tobs.Tracer().start()
    gate = threading.Barrier(2)

    def work(tag):
        with tr.span(f"{tag}.outer"):
            gate.wait()
            with tr.span(f"{tag}.inner"):
                gate.wait()
                tr.timed_span(f"{tag}.timed", time.perf_counter(),
                              time.perf_counter())
                gate.wait()
            gate.wait()

    other = threading.Thread(target=work, args=("b",), name="worker-b")
    other.start()
    work("a")
    other.join(10)
    assert not other.is_alive()
    forest = sorted(_tree(r) for r in tr.roots)
    assert forest == [("a.outer", (("a.inner", (("a.timed", ()),)),)),
                      ("b.outer", (("b.inner", (("b.timed", ()),)),))]
    for sp in tr.find("a.outer") + tr.find("a.inner") + tr.find("a.timed"):
        assert sp.thread == 1
    for sp in tr.find("b.outer") + tr.find("b.inner") + tr.find("b.timed"):
        assert sp.thread == 4
    ev = tr.to_chrome()["traceEvents"]
    tid = {e["name"]: e["tid"] for e in ev if e["ph"] == "X"}
    assert {tid[n] for n in ("a.outer", "a.inner", "a.timed")} == {1}
    assert {tid[n] for n in ("b.outer", "b.inner", "b.timed")} == {4}
    named = {e["tid"]: e["args"]["name"] for e in ev if e["ph"] == "M"}
    assert named == {1: threading.current_thread().name, 4: "worker-b"}


def test_spans_of_many_threads_under_stress_lose_nothing():
    """More threads than cores open nested spans with the interpreter
    switching threads as often as it can: every span is recorded once,
    closed, under its own thread's parent, and each thread has a tid of
    its own, though a thread that ends passes its ident on."""
    import os
    import sys
    n_threads, reps = 2 * (os.cpu_count() or 2) + 2, 200
    tr = tobs.Tracer().start()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(reps):
                with tr.span("outer", k=k, i=i):
                    with tr.span("inner", k=k, i=i):
                        tr.timed_span("timed", 0.0, 0.0, k=k, i=i)
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert len(tr.roots) == n_threads * reps
    tid_of = {}
    for root in tr.roots:
        k, i = root.attrs["k"], root.attrs["i"]
        assert root.name == "outer" and tid_of.setdefault(k, root.thread) \
            == root.thread
        (inner,) = root.children
        (timed,) = inner.children
        for sp in (inner, timed):
            assert sp.attrs == {"k": k, "i": i} and sp.thread == root.thread
        assert root.t1 is not None and inner.t1 is not None
    assert sorted(tid_of.values()) == list(range(4, 4 + n_threads))
    assert sorted({(k, i) for k in range(n_threads) for i in range(reps)}) \
        == sorted((r.attrs["k"], r.attrs["i"]) for r in tr.roots)


def test_clear_while_another_thread_holds_a_span():
    """start() on one thread while another holds a span open raises
    nothing; the open span closes into the old tree and the other
    thread's next span is a root of the new one."""
    tr = tobs.Tracer().start()
    opened, cleared = threading.Event(), threading.Event()
    errors = []

    def hold():
        try:
            with tr.span("old") as old:
                opened.set()
                cleared.wait(10)
                with tr.span("after-clear"):
                    pass
            assert old.t1 is not None
            with tr.span("next"):
                pass
        except BaseException as e:          # surfaced below
            errors.append(e)

    t = threading.Thread(target=hold)
    t.start()
    assert opened.wait(10)
    tr.start()
    with tr.span("home"):
        cleared.set()
        t.join(10)
    assert not t.is_alive() and errors == []
    assert sorted(_tree(r) for r in tr.roots) == [
        ("after-clear", ()), ("home", ()), ("next", ())]


def test_merge_spans_inside_every_device_execute():
    """One ``merge`` span in each ``device-execute`` of ``run_groups``;
    on the sharded path over logical shards, one or more."""
    rng = np.random.default_rng(3)
    specs = []
    for name in ("reduction", "bitonic", "transpose"):
        m = ALL[name]
        specs.append(trt.LaunchSpec(m.build(32), *m.launch(32),
                                    m.make_gmem(rng, 32)))

    def groups(**kw):
        tobs.TRACER.clear().start()
        try:
            trt.execute(specs, n_sm=4, chunk=2, device="cpu", **kw)
        finally:
            tobs.TRACER.stop()
        out = [[c.name for c in sp.children]
               for sp in tobs.TRACER.find("device-execute")]
        tobs.TRACER.clear()
        return out

    plain = groups()
    assert len(plain) > 1 and all(g == ["merge"] for g in plain)
    sharded = groups(shard_sm=True, sm_devices=["cpu"] * 4)
    assert sharded and all(g and set(g) == {"merge"} for g in sharded)
    assert max(len(g) for g in sharded) > 1


def _host_events(prof, tmp_path):
    """The profiler's Chrome trace and its host events."""
    path = tmp_path / "kineto.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    return doc, [e for e in doc["traceEvents"]
                 if e.get("cat") == "cpu_op"]


def test_spans_annotate_the_profiler_on_its_own_thread(tmp_path):
    """Under a CPU ``torch.profiler`` with the tracer off, the spans of
    the profiler's thread are host events of their names and the tracer
    records nothing; another thread's spans and every span with no
    profiler running are the null span."""
    from torch.profiler import ProfilerActivity, profile
    tobs.TRACER.stop()
    tobs.TRACER.clear()
    assert tobs.TRACER.span("before") is tobs.NULL_SPAN
    mod = ALL["reduction"]
    code, (grid, bd) = mod.build(32), mod.launch(32)
    off_thread = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        srv = trt.RuntimeServer(n_sm=2, metrics=tobs.MetricsRegistry(),
                                device="cpu")
        srv.submit(code, grid, bd,
                   mod.make_gmem(np.random.default_rng(0), 32))
        srv.drain()
        t = threading.Thread(
            target=lambda: off_thread.append(tobs.TRACER.span("x")))
        t.start()
        t.join(10)
    assert not t.is_alive()
    assert tobs.TRACER.span("after") is tobs.NULL_SPAN
    assert off_thread == [tobs.NULL_SPAN] and tobs.TRACER.roots == []
    _, notes = _host_events(prof, tmp_path)
    names = {e["name"] for e in notes}
    assert {"submit", "admit", "drain", "window", "pack", "dispatch",
            "device-execute", "merge", "counter-sync", "complete"} <= names


def test_export_clock_lays_over_the_profiler_trace(tmp_path):
    """A span's wall-clock instant by ``otherData["t0_unix_ns"]`` is its
    profiler event's by ``baseTimeNanoseconds``."""
    from torch.profiler import ProfilerActivity, profile
    tr = tobs.Tracer().start()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("anchored"):
            time.sleep(0.005)
    kin, notes = _host_events(prof, tmp_path)
    ours = tr.to_chrome()
    ev = next(e for e in ours["traceEvents"] if e["name"] == "anchored")
    note = next(e for e in notes if e["name"] == "anchored")
    at_ours = ours["otherData"]["t0_unix_ns"] / 1e3 + ev["ts"]
    at_theirs = kin.get("baseTimeNanoseconds", 0) / 1e3 + note["ts"]
    assert abs(at_ours - at_theirs) < 1000          # µs
    assert abs(ev["dur"] - note["dur"]) < 1000


# ------------------------------------------------------------- profiling

def _mulfree(rt, obs, addk, cpu):
    """The mul-free narrow tenant as ``benchmarks/run.py``'s
    ``bench_runtime_profile`` serves it: four ``AddK(13, block_w=8)``
    launches through a profiling server on two SMs."""
    srv = rt.RuntimeServer(n_sm=2, metrics=obs.MetricsRegistry(),
                           profile=True, **cpu)
    narrow = addk(13, block_w=8)
    for i in range(4):
        srv.submit(narrow.build(), *narrow.launch(),
                   narrow.make_gmem(np.random.default_rng(100 + i)),
                   client="mulfree")
    srv.drain()
    rep = srv.profiler.report()
    name = srv.registry.as_module(narrow.build()).name
    return rep["tenants"]["mulfree"], rep["modules"][name]["advisor"]


def test_mulfree_tenant_simt_025_saving_190_equal_to_jax():
    tenant, adv = _mulfree(trt, tobs, AddK, {"device": "cpu"})
    assert (tenant, adv) == _mulfree(jrt, jobs, JAddK, {})
    assert tenant["simt_efficiency"] == 0.25
    assert tenant["class_issues"]["mul"] == 0
    assert round(100 * adv["predicted_saving"], 1) == 19.0
    assert adv["suggested"] == {"n_sp": 8, "warp_stack_depth": 1,
                                "enable_mul": False,
                                "num_read_operands": 2}
    assert adv["problems"] == []


def test_advise_on_one_launch_activity_equal_to_jax():
    """``advise`` on a run_grid result's activity, outside the server."""
    def run(sched, prof, addk, cpu):
        narrow = addk(13, block_w=8)
        res = sched.run_grid(narrow.build(), *narrow.launch(),
                             narrow.make_gmem(np.random.default_rng(0)),
                             **cpu)
        act = prof.Activity()
        act.add(res.op_issues, res.op_lanes, res.stack_ops, res.max_sp,
                res.overflow, res.sm_cycles(1))
        return act.as_dict(prof.MachineConfig(), 1), \
            prof.advise(act, code=narrow.build()).as_dict()
    got = run(scheduler, tprof, AddK, {"device": "cpu"})
    assert got == run(jscheduler, jprof, JAddK, {})
    assert got[0]["simt_efficiency"] == 0.25


def _profiled_drain(rt, obs, addk, cpu):
    srv = rt.RuntimeServer(n_sm=2, metrics=obs.MetricsRegistry(),
                           profile=True, **cpu)
    for i, k in enumerate((13, 13, 20)):
        t = addk(k, block_w=8)
        srv.submit(t.build(), *t.launch(),
                   t.make_gmem(np.random.default_rng(i)), client=f"t{i % 2}")
    _, stats = srv.drain()
    return stats.energy_eu, srv.profiler.report(), \
        srv.metrics.snapshot()["counters"]


def test_server_profiler_report_equal_to_jax():
    energy, rep, counters = _profiled_drain(trt, tobs, AddK,
                                            {"device": "cpu"})
    assert (energy, rep, counters) == _profiled_drain(jrt, jobs, JAddK, {})
    assert energy > 0 and rep["schema_version"] == tprof.SCHEMA_VERSION
    assert rep["total"]["simt_efficiency"] == 0.25
    json.dumps(rep)


def test_profiler_prices_like_simt_energy():
    from repro_torch.core.energy import simt_energy
    mod = ALL["bitonic"]
    res = scheduler.run_grid(mod.build(32), *mod.launch(32),
                             mod.make_gmem(np.random.default_rng(0), 32),
                             device="cpu")
    lp = tprof.profile_launch(res, MachineConfig(), 1)
    assert lp.energy.total == simt_energy(res, MachineConfig(), 1).total
    assert sum(lp.class_issues.values()) == lp.issues
