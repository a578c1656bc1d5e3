"""The port's always-on serving stack on the CPU: ``ServingLoop``, deadline
shedding, the seeded load generator and the ``gpgpu_serve`` CLI, held to
the JAX package's where both compute the same thing.

Seeded arrival schedules are equal to ``repro.runtime.build_arrivals``'s
exactly; the CLI's drain accounting, its metrics document and its trace
carry the JAX CLI's numbers and keys on the same arguments (the trace
less the port's own spans).  Traced, the loop's two threads record a
launch's every leg.  Every served
launch is checked against the port's sequential ``run_grid``.
"""
import json
import threading
import time

import numpy as np
import pytest
import torch

import repro.runtime as jrt
import repro_torch.runtime as trt
from repro.launch import gpgpu_serve as jserve
from repro_torch import obs
from repro_torch.core import scheduler
from repro_torch.core.pipeline.state import host_numpy
from repro_torch.core.programs import ALL
from repro_torch.launch import gpgpu_serve as tserve
from torch_port_spans import PORT_ONLY

#: the CLI's cheapest workload: the first four of the five programs
CLI_ARGS = ["--no-compiled", "--launches", "4", "--n-sm", "2",
            "--tenants", "2"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_seq_memo = {}


def _sequential(name, n=32, gseed=0):
    key = (name, n, gseed)
    if key not in _seq_memo:
        mod = ALL[name]
        code = mod.build(n)
        g0 = mod.make_gmem(np.random.default_rng(gseed), n)
        res = scheduler.run_grid(code, *mod.launch(n), g0.copy(),
                                 device="cpu")
        _seq_memo[key] = (code, mod.launch(n), g0, res)
    return _seq_memo[key]


def _assert_bit_identical(got, want):
    np.testing.assert_array_equal(host_numpy(got.gmem), host_numpy(want.gmem))
    np.testing.assert_array_equal(got.cycles_per_block,
                                  want.cycles_per_block)
    np.testing.assert_array_equal(got.op_issues, want.op_issues)
    assert (got.stack_ops, got.max_sp, got.overflow) == \
        (want.stack_ops, want.max_sp, want.overflow)


def _server(**kw):
    return trt.RuntimeServer(device="cpu", **kw)


# ------------------------------------------------------- the serving loop

def test_loop_quiesce_resolves_everything_bit_exact():
    srv = _server(n_sm=2)
    code, launch, g0, seq = _sequential("reduction")
    with trt.ServingLoop(srv, poll_interval_s=0.01) as loop:
        futs = [loop.submit(code, *launch, g0.copy(), client=f"t{i % 3}")
                for i in range(6)]
        loop.quiesce()
        assert srv.pending() == 0 and srv._completed == {}
        assert all(f.done() for f in futs)
    assert not loop.running and srv._serving_loop is None
    for f in futs:
        _assert_bit_identical(f.result(), seq)
    m = srv.metrics
    assert m.counter("loop.iterations").value == loop.iterations >= 1
    assert loop.served == 6 and m.gauge("loop.running").value == 0


def test_result_waits_on_loop_never_drains_from_caller():
    srv = _server(n_sm=1)
    drain_threads = []
    orig = srv.drain

    def recording_drain(*a, **k):
        drain_threads.append(threading.current_thread().name)
        return orig(*a, **k)

    srv.drain = recording_drain
    code, launch, g0, seq = _sequential("transpose")
    with trt.ServingLoop(srv, poll_interval_s=0.005,
                         name="loop-under-test") as loop:
        fut = loop.submit(code, *launch, g0.copy())
        _assert_bit_identical(fut.result(), seq)
    assert set(drain_threads) == {"loop-under-test"}


def test_loop_survives_poisoned_window():
    srv = _server(n_sm=1)
    code, launch, g0, seq = _sequential("reduction")
    bad = srv.submit_future(code, *launch, g0.copy(), client="bad")
    srv._pending[-1] = srv._pending[-1]._replace(
        spec=srv._pending[-1].spec._replace(
            gmem=srv._pending[-1].spec.gmem.reshape(1, -1)))
    with trt.ServingLoop(srv, poll_interval_s=0.005) as loop:
        ok = loop.submit(code, *launch, g0.copy(), client="ok")
        _assert_bit_identical(ok.result(), seq)
        loop.quiesce()
    assert bad.done() and loop.window_errors == srv.MAX_ATTEMPTS
    with pytest.raises(Exception):
        bad.result()


# ------------------------------------------------------ deadline shedding

def test_deadline_expired_launch_is_shed():
    srv = _server(n_sm=1, metrics=trt.MetricsRegistry())
    code, launch, g0, seq = _sequential("reduction")
    doomed = srv.submit_future(code, *launch, g0.copy(), client="late",
                               deadline_s=0.0)
    ok = srv.submit_future(code, *launch, g0.copy(), client="ontime",
                           deadline_s=60.0)
    dependent = srv.submit_future(code, *launch, doomed, client="late")
    time.sleep(0.005)                     # let the deadline expire
    results, stats = srv.drain()
    assert stats.n_shed == 1 and stats.n_launches == 1
    _assert_bit_identical(ok.result(), seq)
    with pytest.raises(trt.DeadlineExceeded, match="shed"):
        doomed.result()
    with pytest.raises(RuntimeError, match="dropped"):
        dependent.result()
    assert srv.tenant_stats["late"].shed == 1
    assert srv.metrics.counter("server.shed").value == 1
    assert srv.metrics.gauge("drain.n_shed").value == 1
    assert srv.pending() == 0


def test_loop_sheds_under_deadline_pressure():
    """An overloaded open loop with a tight deadline sheds some launches
    and still resolves every future; the rest are bit-exact.

    A launch is already queued when the loop starts, so its first
    iteration lingers (0.1 s) before it packs: the burst arrives inside
    that linger and the flood tenant's launches are past their 5 ms
    deadline when packed, whatever the threads' timing.  The calm
    tenant has no deadline and completes."""
    srv = _server(n_sm=1, metrics=trt.MetricsRegistry())
    code, launch, g0, seq = _sequential("transpose")
    pool = [trt.WorkItem("transpose-32", code, launch[0], launch[1], g0,
                         expected_gmem=np.asarray(seq.gmem, np.int64))]
    tenants = [trt.TenantSpec("flood", rate_hz=2000.0, deadline_s=0.005),
               trt.TenantSpec("calm", rate_hz=400.0)]
    arrivals = trt.build_arrivals(tenants, duration_s=0.02, n_items=1,
                                  seed=2)
    first = srv.submit_future(code, *launch, g0.copy(), client="calm")
    with trt.ServingLoop(srv, poll_interval_s=0.002, linger_s=0.1) as loop:
        rep = trt.run_open_loop(loop, pool, arrivals, time_scale=0.0)
    _assert_bit_identical(first.result(), seq)
    assert rep.unresolved == 0 and rep.submitted == len(arrivals)
    assert rep.completed + rep.shed == rep.submitted
    flood, calm = rep.tenants["flood"], rep.tenants["calm"]
    assert flood.shed > 0 and calm.shed == 0
    assert calm.completed == calm.submitted > 0
    assert rep.shed > 0 and rep.mismatched == 0
    assert srv.metrics.counter("server.shed").value == rep.shed


# ------------------------------------------------------------- loadgen

def _schedule(pkg, tenants, seed):
    specs = [pkg.TenantSpec(**t) for t in tenants]
    return [(a.t, a.tenant.name, a.item)
            for a in pkg.build_arrivals(specs, 0.5, n_items=4, seed=seed)]


@pytest.mark.parametrize("seed", (0, 9))
def test_arrival_schedules_equal_jax(seed):
    tenants = [dict(name="a", rate_hz=500.0),
               dict(name="b", rate_hz=500.0, process="onoff", on_s=0.1,
                    off_s=0.3),
               dict(name="c", rate_hz=100.0, weight=2.0)]
    got = _schedule(trt, tenants, seed)
    assert got == _schedule(jrt, tenants, seed) and len(got) > 100
    assert got != _schedule(trt, tenants, seed + 1)
    cli = tserve.build_tenants(4, 50.0, {"tenant0": 3.0}, bursty=True)
    jcli = jserve.build_tenants(4, 50.0, {"tenant0": 3.0}, bursty=True)
    assert [(t.name, t.rate_hz, t.process, t.weight) for t in cli] == \
        [(t.name, t.rate_hz, t.process, t.weight) for t in jcli]


def test_open_loop_burst_bit_exact_vs_oracle():
    srv = _server(n_sm=2, metrics=trt.MetricsRegistry(), policy="sla")
    items = []
    for name in ("reduction", "transpose"):
        code, launch, g0, seq = _sequential(name)
        items.append(trt.WorkItem(f"{name}-32", code, launch[0], launch[1],
                                  g0, np.asarray(seq.gmem, np.int64)))
    tenants = [trt.TenantSpec("a", rate_hz=200.0),
               trt.TenantSpec("b", rate_hz=200.0, process="onoff")]
    arrivals = trt.build_arrivals(tenants, 0.03, n_items=2, seed=4)
    with trt.ServingLoop(srv, poll_interval_s=0.002) as loop:
        rep = trt.run_open_loop(loop, items, arrivals, time_scale=0.0)
    assert rep.submitted == len(arrivals) > 0
    assert rep.completed == rep.submitted and rep.mismatched == 0
    assert rep.unresolved == 0 and rep.p50_ms > 0 and rep.p99_ms >= \
        rep.p50_ms


def test_loop_traces_each_launch_across_both_threads():
    """Traced, the loop records one ``loop.lock-wait`` a submit on the
    client's thread (its ticket, tenant and the drains it met),
    ``loop.idle`` on its own thread, and one
    ``dispatch-wait`` and one ``launch-run`` a launch served; a launch's
    lock-wait, queue-wait, dispatch-wait and launch-run follow each other
    and cover its submit call through its completion, less the server's
    submit span."""
    srv = _server(n_sm=2)
    code, launch, g0, seq = _sequential("reduction")
    tr = obs.TRACER.clear().start()
    calls = {}
    try:
        with trt.ServingLoop(srv, poll_interval_s=0.005) as loop:
            futs = []
            for i in range(6):
                t_call = time.perf_counter()
                futs.append(loop.submit(code, *launch, g0.copy(),
                                        client=f"t{i % 2}"))
                calls[futs[-1].ticket] = t_call - tr._t0
                time.sleep(0.002 * (i % 3))
            loop.quiesce()
    finally:
        tr.stop()
    for f in futs:
        _assert_bit_identical(f.result(), seq)

    def by_ticket(name):
        out = {}
        for sp in tr.find(name):
            if "ticket" in sp.attrs:
                assert sp.attrs["ticket"] not in out, name
                out[sp.attrs["ticket"]] = sp
        return out

    tickets = set(calls)
    waits, queue, disp, run, sub = (by_ticket(n) for n in (
        "loop.lock-wait", "queue-wait", "dispatch-wait", "launch-run",
        "submit"))
    assert set(waits) == set(queue) == set(disp) == set(run) == tickets
    assert len(tr.find("loop.lock-wait")) == 6
    for t in tickets:
        lw, qw, dw, lr = waits[t], queue[t], disp[t], run[t]
        assert lw.thread == 1 and isinstance(lw.attrs["drains"], int)
        assert lw.attrs["tenant"] == qw.attrs["tenant"] == \
            dw.attrs["tenant"] == lr.attrs["tenant"]
        assert dw in tr.roots and lr in tr.roots
        assert calls[t] <= lw.t0 <= lw.t1 <= qw.t0
        assert qw.t1 == dw.t0 and dw.t1 == lr.t0 and lr.t0 <= lr.t1
        gap = qw.t0 - lw.t1                 # inside the submit call
        assert 0 <= gap <= sub[t].t1 - lw.t1
        legs = sum(sp.t1 - sp.t0 for sp in (lw, qw, dw, lr))
        assert legs == pytest.approx(lr.t1 - lw.t0 - gap, abs=1e-9)
    idle = tr.find("loop.idle")
    assert idle and {sp.attrs["wait"] for sp in idle} == {"wake"}
    assert {sp.thread for sp in idle} == {4}     # the loop's thread
    ev = tr.to_chrome()["traceEvents"]
    names = {e["tid"]: e["args"]["name"] for e in ev if e["ph"] == "M"}
    assert names[4] == "serving-loop"
    tids = {(e["name"], e["tid"]) for e in ev if e["ph"] == "X"}
    assert ("loop.lock-wait", 1) in tids and \
        {t for n, t in tids if n == "loop.idle"} == {4}
    tr.clear()


def test_lock_wait_counts_the_drain_a_submit_meets():
    """A submit made while the loop drains waits for the lock through
    the rest of that drain, and its ``loop.lock-wait`` counts it in
    ``drains``; a submit made while the loop waits for work counts
    none."""
    srv = _server(n_sm=1)
    code, launch, g0, seq = _sequential("reduction")
    started, release = threading.Event(), threading.Event()
    drain = srv.drain

    def held_drain(*a, **k):            # a drain that lasts until released
        started.set()
        assert release.wait(10)
        return drain(*a, **k)

    srv.drain = held_drain
    tr = obs.TRACER.clear().start()
    futs = []
    try:
        with trt.ServingLoop(srv, poll_interval_s=0.005) as loop:
            futs.append(loop.submit(code, *launch, g0.copy()))
            assert started.wait(10)
            t = threading.Thread(target=lambda: futs.append(
                loop.submit(code, *launch, g0.copy())))
            t.start()
            time.sleep(0.05)            # the second submit waits for the lock
            release.set()
            t.join(10)
            assert not t.is_alive()
            loop.quiesce()
    finally:
        tr.stop()
    for f in futs:
        _assert_bit_identical(f.result(), seq)
    waits = {sp.attrs["ticket"]: sp for sp in tr.find("loop.lock-wait")}
    first, second = (waits[f.ticket] for f in futs)
    assert first.attrs["drains"] == 0
    assert second.attrs["drains"] == 1
    assert second.t1 - second.t0 >= 0.04
    tr.clear()


def test_loop_linger_is_idle_on_the_loop_thread():
    """Work that waits when the loop starts an iteration lingers first:
    a ``loop.idle`` span with ``wait="linger"``."""
    srv = _server(n_sm=1)
    code, launch, g0, _ = _sequential("reduction")
    tr = obs.TRACER.clear().start()
    try:
        loop = trt.ServingLoop(srv, poll_interval_s=0.005, linger_s=0.002)
        fut = loop.submit(code, *launch, g0.copy())
        loop.start().quiesce().stop()
        assert fut.done()
    finally:
        tr.stop()
    waits = {sp.attrs["wait"] for sp in tr.find("loop.idle")}
    tr.clear()
    assert "linger" in waits


# ------------------------------------------------------------ the CLI

def _keys(doc, depth=0):
    """The key tree of a JSON document (values dropped)."""
    if isinstance(doc, dict):
        return {k: _keys(v, depth + 1) for k, v in doc.items()}
    return None


def _cli(mod, tmp_path, tag, extra=()):
    m_out, t_out = tmp_path / f"{tag}-m.json", tmp_path / f"{tag}-t.json"
    argv = CLI_ARGS + ["--metrics-out", str(m_out), "--trace-out",
                       str(t_out), "--profile"] + list(extra)
    stats = mod.main(argv)
    return stats, json.loads(m_out.read_text()), \
        json.loads(t_out.read_text())


def test_cli_drain_equals_jax_cli(tmp_path, capsys):
    """``gpgpu_serve.main`` on the CPU: the drain's accounting, the
    metrics document's keys and values, and the trace's span names and
    counter tracks equal the JAX CLI's on the same arguments."""
    stats, doc, trace = _cli(tserve, tmp_path, "torch", ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] 4 launches" in out and "[profile]" in out
    jstats, jdoc, jtrace = _cli(jserve, tmp_path, "jax")
    assert stats.n_launches == 4 and stats.energy_eu > 0
    for f in ("n_blocks", "n_steps", "n_windows", "n_sub_batches",
              "useful_gmem_words", "padded_gmem_words", "makespan_cycles",
              "busy_cycles", "energy_eu", "occupancy"):
        assert getattr(stats, f) == getattr(jstats, f), f
    np.testing.assert_array_equal(stats.per_sm_cycles, jstats.per_sm_cycles)
    # the document: same keys at every level; "jit" holds only the
    # "_total" row here, since the CPU plain path predecodes and builds
    # nothing (no miss), where the JAX CLI traces each bucket
    jkeys = _keys(jdoc)
    jkeys["jit"] = {"_total": jkeys["jit"]["_total"]}
    assert _keys(doc) == jkeys
    assert doc["jit"]["_total"]["jit_cache_misses"] == 0
    assert doc["jit"]["_total"]["jit_cache_hits"] == \
        stats.n_sub_batches
    assert doc["transfers"].keys() == jdoc["transfers"].keys()
    gauges, jgauges = doc["metrics"]["gauges"], jdoc["metrics"]["gauges"]
    skip = ("drain.wall_s", "drain.launches_per_s")
    assert {k: v for k, v in gauges.items() if k not in skip} == \
        {k: v for k, v in jgauges.items() if k not in skip}
    assert doc["metrics"]["counters"] == jdoc["metrics"]["counters"]

    def shape(tr):
        ev = tr["traceEvents"]
        return (sorted({e["name"] for e in ev if e["ph"] == "X"}
                       - PORT_ONLY),
                sorted({e["name"] for e in ev if e["ph"] == "C"}),
                sorted({e["ph"] for e in ev}), sorted(tr))
    assert shape(trace) == shape(jtrace)
    assert {"dispatch-wait", "launch-run", "merge"} <= \
        {e["name"] for e in trace["traceEvents"]}


def test_cli_loop_and_loadgen_serve_everything(capsys):
    stats = tserve.main(CLI_ARGS + ["--device", "cpu", "--loop"])
    assert stats is None
    assert "all oracle-checked" in capsys.readouterr().out
    rep = tserve.main(CLI_ARGS + ["--device", "cpu", "--loadgen",
                                  "--duration-s", "0.2", "--rate", "20",
                                  "--profile", "--policy", "balanced"])
    assert rep.unresolved == 0 and rep.mismatched == 0
    assert rep.completed == rep.submitted > 0
    assert "[loadgen] latency p50" in capsys.readouterr().out


def test_cli_skewed_and_longtail_pin_the_jax_numbers(capsys):
    st = tserve.main(["--no-compiled", "--device", "cpu", "--longtail",
                      "--launches", "8", "--policy", "balanced"])
    assert st.makespan_cycles == 784
    with pytest.raises(SystemExit):
        tserve.main(["--skewed", "--longtail", "--device", "cpu"])


def test_cli_without_no_compiled_serves_the_eight_kernel_pool(capsys):
    """Without ``--no-compiled`` the CLI serves the mixed workload: the
    paper's five and the three DSL-compiled kernels, each held to its
    oracle inside the CLI; the workload's kernels equal the JAX CLI's."""
    assert sorted(tserve.workload_kernels()) == \
        sorted(jserve.workload_kernels())
    for n_launches, compiled in ((6, True), (6, False), (8, True)):
        names = [w[0] for w in tserve.build_workload(
            n_launches, include_compiled=compiled)]
        assert names == [w[0] for w in jserve.build_workload(
            n_launches, include_compiled=compiled)]
    st = tserve.main(["--launches", "8", "--n-sm", "8", "--device", "cpu"])
    assert st.n_launches == 8 and st.n_blocks == 14
    assert "[serve] 8 launches" in capsys.readouterr().out


def test_cli_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(CLI_ARGS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.drain_workload(tserve.build_longtail_workload(1), 1)


def test_tracer_records_runtime_spans():
    obs.TRACER.start()
    try:
        srv = _server(n_sm=1)
        code, launch, g0, _ = _sequential("reduction")
        srv.submit(code, *launch, g0.copy())
        srv.drain()
    finally:
        obs.TRACER.stop()
    names = {e["name"] for e in obs.TRACER.to_chrome()["traceEvents"]}
    obs.TRACER.clear()
    assert {"submit", "drain", "window", "dispatch", "device-execute",
            "counter-sync", "complete"} <= names


def test_runtime_streams_and_events_equal_jax():
    """The eager ``Runtime``: a chained stream, an event recorded on it
    and a second stream reading the event's memory give the JAX
    runtime's memories; on the CPU every launch and event is complete."""
    def run(pkg, cpu):
        code, launch, g0, _ = _sequential("reduction")
        rt = pkg.Runtime(n_sm=2, **cpu)
        s1 = rt.stream(g0)
        a = s1.launch(code, *launch)
        b = s1.launch(rt.load(code, "again"), *launch)
        ev = s1.record_event()
        s2 = rt.stream().wait_event(ev)
        c = s2.launch(code, *launch, gmem=ev)
        rt.synchronize()
        assert a.done() and b.done() and c.done() and ev.query()
        return [np.asarray(host_numpy(x.result().gmem)).tolist()
                for x in (a, b, c)], [x.result().cycles_per_block.tolist()
                                      for x in (a, b, c)]
    got = run(trt, {"device": "cpu"})
    assert got == run(jrt, {})
    assert got[0][1] == got[0][2]        # b and c read the same memory
