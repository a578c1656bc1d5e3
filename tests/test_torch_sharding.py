"""The port's sharded overlay executor (``execute(shard_sm=True)``,
``shard_plan``, ``RuntimeServer(shard_sm=True)``) against the JAX package,
on the CPU.

The JAX package checks its sharded executor on 8 forced host devices.  The
port does the same with an explicit mesh that names one device several
times: ``sm_devices=["cpu"] * 8``, so every shard runs on the CPU.  The
JAX sharded path fails on the installed jax, so the port is held to the
JAX package's **unsharded** ``execute(shard_sm=False)`` and to its own
unsharded path.  Tolerance: none — final gmem, every counter, per-SM
cycles and the drain accounting are equal.  The sharded runner really
runs: ``shard.dispatch_groups`` counts its groups.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.core.machine import MachineConfig as JaxConfig
from repro.launch import gpgpu_serve as jserve
from repro_torch import obs
from repro_torch import runtime as rt
from repro_torch.core import asm, isa
from repro_torch.launch import gpgpu_serve as tserve
from repro_torch.runtime import executor

JAX = JaxConfig(execute_backend="jnp")
CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain path's small tensors run fastest on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conflict_kernel(base: int) -> np.ndarray:
    """Every block writes ``base + flat-block-id`` over the SAME 32 words:
    position-order last-writer resolution is observable."""
    p = asm.Program(f"conflict{base}")
    p.s2r("r0", isa.SR_TID)
    p.s2r("r1", isa.SR_CTA)
    p.iadd("r1", "r1", base)
    p.stg("r0", "r1", 64)
    p.exit()
    return p.finish()


def _mixed(seed: int = 0):
    """``tests/test_sharding.py``'s heterogeneous launches, including the
    write-conflict kernel, as (code, grid, block_dim, gmem) tuples."""
    rng = np.random.default_rng(seed)
    specs = []
    for k, grid in [(5, (4, 1)), (9, (3, 2)), (13, (1, 1)), (21, (5, 1))]:
        mod = tserve.AddK(k, grid=grid)
        grid_bd = mod.launch()
        specs.append((mod.build(), grid_bd[0], grid_bd[1],
                      mod.make_gmem(rng)))
    specs.append((_conflict_kernel(100), (7, 1), (32, 1),
                  np.zeros(128, np.int32)))
    return specs


def _port_specs(seed=0):
    return [rt.LaunchSpec(*s) for s in _mixed(seed)]


@functools.lru_cache(maxsize=None)
def _jax_unsharded(n_sm, chunk):
    dg = jrt.execute([jrt.LaunchSpec(*s) for s in _mixed()], n_sm=n_sm,
                     chunk=chunk, cfg=JAX, shard_sm=False)
    return dg.to_results(), dg.report()


def _same(a, b):
    for ra, rb in zip(a, b):
        for f in rb._fields:
            np.testing.assert_array_equal(np.asarray(getattr(ra, f)),
                                          np.asarray(getattr(rb, f)), f)


def _same_report(a, b):
    np.testing.assert_array_equal(a.per_sm_cycles, b.per_sm_cycles)
    assert (a.n_steps, a.n_blocks, a.max_sp, a.overflow) == \
        (b.n_steps, b.n_blocks, b.max_sp, b.overflow)


def _groups():
    return rt.METRICS.counter("shard.dispatch_groups").value


@pytest.mark.parametrize("n", [1, 4, 8, 16, 12])
def test_shard_plan_fallbacks(n):
    """No placement on one SM (a mesh of one entry) or when n_sm does not
    divide over the devices; the sizes are the JAX package's over its 8
    forced host devices."""
    want = {1: None, 4: 4, 8: 8, 16: 8, 12: None}[n]
    plan = rt.shard_plan(n, CPU8)
    assert (None if plan is None else plan.devices.size) == want
    if plan is not None:
        assert plan.axis_names == ("sm",)
    if len(jax.devices()) >= 8:
        jplan = jrt.shard_plan(n)
        assert (None if jplan is None else jplan.devices.size) == want


@pytest.mark.parametrize("width,n_sm", [(8, 8), (16, 8), (8, 4), (12, 4),
                                        (6, 2), (4, 1), (64, 16)])
def test_sm_major_perm_matches_jax(width, n_sm):
    from repro.runtime.executor import _sm_major_perm as jperm
    perm = executor._sm_major_perm(width, n_sm)
    np.testing.assert_array_equal(perm, jperm(width, n_sm))
    spd = width // n_sm
    # slot q = s * spd + j holds position p = j * n_sm + s: SM s's blocks
    # are contiguous
    assert (perm[np.arange(width)] % n_sm ==
            np.arange(width) // spd).all()


@pytest.mark.parametrize("n_sm", [1, 2, 4, 8])
def test_sharded_execute_bit_exact(n_sm):
    """gmem and every counter bit-exact against the port's and the JAX
    package's unsharded paths; the sharded runner runs whenever a
    placement exists."""
    chunk = 2 * n_sm
    base = rt.execute(_port_specs(), n_sm=n_sm, chunk=chunk, device="cpu")
    g0 = _groups()
    shrd = rt.execute(_port_specs(), n_sm=n_sm, chunk=chunk, shard_sm=True,
                      sm_devices=CPU8, device="cpu")
    groups = _groups() - g0
    n_groups = len(executor.group_bounds(shrd.report().n_blocks, n_sm,
                                         chunk))
    assert groups == (0 if n_sm == 1 else n_groups)
    jres, jrep = _jax_unsharded(n_sm, chunk)
    _same(shrd.to_results(), base.to_results())
    _same(shrd.to_results(), jres)
    _same_report(shrd.report(), base.report())
    _same_report(shrd.report(), jrep)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_sharded_over_k_shards_bit_exact(k, monkeypatch):
    """n_sm = 8 over 2, 4 and 8 shards: each equal to the JAX package's
    unsharded run, with one run a shard that holds a real position."""
    calls = []
    real_staged = executor.staged_run

    def counted(*a, **kw):
        calls.append(len(a[3]))
        return real_staged(*a, **kw)

    specs = _port_specs()
    n_blocks = sum(s.grid[0] * s.grid[1] for s in specs)
    order, local_sm, groups = executor.shard_slots(n_blocks, 8, 8, k)
    monkeypatch.setattr(executor, "staged_run", counted)
    before = _groups()
    dg = rt.execute(specs, n_sm=8, shard_sm=True, sm_devices=["cpu"] * k,
                    device="cpu")
    assert _groups() - before == len(groups)
    assert len(calls) == sum(len(runs) for *_, runs in groups)
    assert sum(calls) == n_blocks
    assert sorted(order.tolist()) == list(range(n_blocks))
    jres, jrep = _jax_unsharded(8, 8)
    _same(dg.to_results(), jres)
    _same_report(dg.report(), jrep)


def test_ragged_tail_shard_of_padding_runs_nothing():
    """5 blocks on 8 SMs over 8 shards: the JAX package pads the group to
    8 slots, three of which are padding on three devices; those devices
    launch nothing."""
    order, local_sm, groups = executor.shard_slots(5, 8, 8, 8)
    assert len(groups) == 1
    lo, hi, spd, runs = groups[0]
    assert (lo, hi, spd) == (0, 5, 1)
    assert [d for d, _, _ in runs] == [0, 1, 2, 3, 4]
    assert order.tolist() == [0, 1, 2, 3, 4]
    assert local_sm.tolist() == [0] * 5
    # over 2 devices both hold a real position (SMs 0-3 and 4)
    _, _, g2 = executor.shard_slots(5, 8, 8, 2)
    assert [(d, b - a) for d, a, b in g2[0][3]] == [(0, 4), (1, 1)]
    # 7 blocks, 4 SMs, spd 2: SM-major order, SM 3's padding slot dropped
    order, local_sm, g = executor.shard_slots(7, 4, 8, 2)
    assert order.tolist() == [0, 4, 1, 5, 2, 6, 3]
    assert local_sm.tolist() == [0, 0, 1, 1, 0, 0, 1]
    assert [(d, a, b) for d, a, b in g[0][3]] == [(0, 0, 4), (1, 4, 7)]


def test_sharded_conflict_last_writer_order():
    """The cross-shard last-writer merge resolves overlapping writes in
    schedule-position order: the final value is the LAST block's."""
    spec = rt.LaunchSpec(_conflict_kernel(100), (7, 1), (32, 1),
                         np.zeros(128, np.int32))
    dg = rt.execute([spec], n_sm=4, chunk=8, shard_sm=True,
                    sm_devices=["cpu"] * 4, device="cpu")
    gmem = np.asarray(dg.to_results()[0].gmem)
    np.testing.assert_array_equal(gmem[64:96], np.full(32, 106))
    np.testing.assert_array_equal(gmem[:64], 0)
    jdg = jrt.execute([jrt.LaunchSpec(spec.code, spec.grid, spec.block_dim,
                                      np.zeros(128, np.int32))],
                      n_sm=4, chunk=8, cfg=JAX)
    _same(dg.to_results(), jdg.to_results())


def test_sharded_per_sm_attribution_invariant():
    """Executed per-SM counters under sharding == the analytical
    round-robin replay over the global block list."""
    n_sm = 4
    dg = rt.execute(_port_specs(), n_sm=n_sm, chunk=8, shard_sm=True,
                    sm_devices=CPU8, device="cpu")
    cyc = np.concatenate([np.asarray(r.cycles_per_block, np.int64)
                          for r in dg.to_results()])
    cyc += rt.BLOCK_SCHED_OVERHEAD
    want = np.bincount(np.arange(len(cyc)) % n_sm, weights=cyc,
                       minlength=n_sm).astype(np.int64)
    np.testing.assert_array_equal(dg.report().per_sm_cycles, want)


def test_sharded_spans_and_build_attribution():
    """Each group runs in a "device-execute" span that names its devices;
    the build attribution charges the sharded seam and its bucket."""
    m = rt.METRICS
    calls0 = m.counter("jit.calls.executor.run_positions_sharded").value
    obs.TRACER.clear().start()
    try:
        dg = rt.execute(_port_specs(), n_sm=4, chunk=8, shard_sm=True,
                        sm_devices=CPU8, device="cpu")
    finally:
        obs.TRACER.stop()
    spans = obs.TRACER.find("device-execute")
    obs.TRACER.clear()
    assert len(spans) == len(executor.group_bounds(dg.report().n_blocks, 4,
                                                   8))
    assert {sp.attrs["n_devices"] for sp in spans} == {4}
    assert {sp.attrs["bucket"] for sp in spans} == {"c64g128w1sm4x4dev"}
    assert m.counter("jit.calls.executor.run_positions_sharded").value \
        == calls0 + 1


def test_a_failing_shard_raises(monkeypatch):
    """No fallback hides a shard's failure: it raises out of execute."""
    real_staged, n = executor.staged_run, []

    def fail_second(*a, **kw):
        n.append(1)
        if len(n) == 2:
            raise RuntimeError("shard 1 failed")
        return real_staged(*a, **kw)

    monkeypatch.setattr(executor, "staged_run", fail_second)
    with pytest.raises(RuntimeError, match="shard 1 failed"):
        rt.execute(_port_specs(), n_sm=4, shard_sm=True, sm_devices=CPU8,
                   device="cpu")


@pytest.mark.parametrize("policy", ["bucket", "balanced"])
def test_sharded_server_drain_bit_exact(policy):
    """The serving path (drain policies, windowing, accounting) under
    ``shard_sm=True`` over 4 shards: oracle-checked results, the per-SM
    cycles, makespan and busy cycles of the unsharded drain and of the JAX
    server's, and the per-device shard gauges published."""
    work = tserve.build_longtail_workload(6)
    _, st_a, _ = tserve.drain_workload(work, n_sm=4, policy=policy,
                                       device="cpu")
    srv_b, st_b, _ = tserve.drain_workload(work, n_sm=4, policy=policy,
                                           shard_sm=True,
                                           sm_devices=["cpu"] * 4,
                                           device="cpu")
    _, st_j, _ = jserve.drain_workload(jserve.build_longtail_workload(6),
                                       n_sm=4, policy=policy)
    assert st_a.n_devices == 1 and st_b.n_devices == 4
    for st in (st_a, st_j):
        np.testing.assert_array_equal(st.per_sm_cycles, st_b.per_sm_cycles)
        assert st.makespan_cycles == st_b.makespan_cycles
        assert st.busy_cycles == st_b.busy_cycles
    # one SM a device: device cycles are the per-SM cycles
    np.testing.assert_array_equal(st_b.device_cycles, st_b.per_sm_cycles)
    dev = st_b.per_sm_cycles
    assert st_b.device_skew == dev.max() / dev.mean() >= 1.0
    gauges = srv_b.metrics.snapshot()["gauges"]
    assert gauges["drain.shard.n_devices"] == 4
    assert gauges["drain.shard.device_skew"] == round(st_b.device_skew, 6)
    for d in range(4):
        assert gauges[f"drain.shard.device.{d}.cycles"] == int(dev[d])
    assert not any(k.startswith("drain.shard.") for k in
                   _unsharded_gauges(work, policy))


def _unsharded_gauges(work, policy):
    srv, _, _ = tserve.drain_workload(work, n_sm=4, policy=policy,
                                      device="cpu")
    return srv.metrics.snapshot()["gauges"]


def test_device_cycles_sum_each_devices_sms():
    """With 2 SMs a device, a device's cycles are its two SMs' sum."""
    st = rt.DrainStats(1, 4, 4, 0.0, 0.0, np.array([5, 7, 11, 13]), 1,
                       n_devices=2)
    assert st.device_cycles.tolist() == [12, 24]
    assert st.device_skew == 24 / 18
    one = st._replace(n_devices=1)
    assert one.device_cycles.tolist() == [36] and one.device_skew == 1.0
    empty = rt.DrainStats(0, 0, 2, 0.0, 0.0, np.zeros(2, np.int64), 0)
    assert empty.device_skew == 0.0


def test_sharded_resident_drain_zero_host_transfers():
    """The device-resident gmem pool moves no gmem across the host
    boundary with sharding on; counters cost one fetch a sub-batch."""
    work = tserve.build_longtail_workload(4)
    srv = rt.RuntimeServer(n_sm=4, resident_gmem=True, shard_sm=True,
                           sm_devices=["cpu"] * 4,
                           metrics=obs.MetricsRegistry(), device="cpu")
    assert srv.n_devices == 4
    tickets = {}
    for i, (name, mod, n, code, (grid, bd), g0) in enumerate(work):
        t = srv.submit(code, grid, bd, g0.copy(), client=f"t{i}")
        tickets[t] = (mod, n, g0)
    transfers = rt.TRANSFERS.window()
    before = _groups()
    results, stats = srv.drain()
    assert _groups() > before
    assert transfers.gmem_uploads == 0
    assert transfers.gmem_syncs == 0
    assert transfers.counter_syncs == stats.n_sub_batches
    assert stats.n_devices == 4
    for t, (mod, n, g0) in tickets.items():
        np.testing.assert_array_equal(
            np.asarray(results[t].gmem)[mod.out_slice(n)],
            mod.oracle(g0, n))


def test_serving_cli_shard_sm_on_one_device(capsys):
    """``--shard-sm`` where only one device is there (the CPU): the
    single-device path, bit-exact with the run without the flag."""
    argv = ["--no-compiled", "--launches", "6", "--n-sm", "2",
            "--device", "cpu"]
    before = _groups()
    st_a = tserve.main(argv)
    st_b = tserve.main(argv + ["--shard-sm"])
    assert _groups() == before
    assert st_a.n_devices == st_b.n_devices == 1
    np.testing.assert_array_equal(st_a.per_sm_cycles, st_b.per_sm_cycles)
    assert (st_a.makespan_cycles, st_a.busy_cycles, st_a.n_blocks) == \
        (st_b.makespan_cycles, st_b.busy_cycles, st_b.n_blocks)
    assert "sharded over" not in capsys.readouterr().out


def test_print_stats_prints_the_sharded_line(capsys):
    work = tserve.build_longtail_workload(4)
    srv, st, wall = tserve.drain_workload(work, n_sm=4, shard_sm=True,
                                          sm_devices=["cpu"] * 2,
                                          device="cpu")
    tserve.print_stats(srv, st, wall, 4, 4)
    out = capsys.readouterr().out
    per_dev = ",".join(str(int(c)) for c in st.device_cycles)
    assert (f"[serve] sharded over 2 devices (2 SMs each): per-device "
            f"cycles [{per_dev}], skew {st.device_skew:.2f}") in out
