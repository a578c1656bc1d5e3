"""The port's multi-tenant ``RuntimeServer`` against the JAX package's, on
the CPU, bit for bit.

The same launches (the paper's programs from a seed, the serving CLI's
skewed and longtail workloads, addk chains) go through
``repro_torch.runtime.RuntimeServer(device="cpu")`` and through
``repro.runtime.RuntimeServer``.  Tolerance: none — final gmem, every
counter, per-SM cycles and every accounting field of ``DrainStats`` are
equal.  The port's sequential ``run_grid`` is the per-ticket oracle, as
the JAX package's is in ``tests/test_server_policies.py``; the drain
accounting is held to the JAX server's on the same workload.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.runtime as jrt
import repro_torch.runtime as trt
from repro.launch import gpgpu_serve as jserve
from repro_torch.core import asm, isa, scheduler
from repro_torch.core.pipeline.state import host_numpy
from repro_torch.core.programs import ALL
from repro_torch.launch import gpgpu_serve as tserve

POLICY_NAMES = ("monolithic", "bucket", "fair", "balanced", "sla")

#: the fuzz pool of tests/test_server_policies.py at n=32
_POOL = (("bitonic", 32), ("autocorr", 32), ("reduction", 32),
         ("transpose", 32))

#: DrainStats fields that are exact accounting (wall clocks excluded)
ACCOUNTING = ("n_launches", "n_blocks", "n_sm", "n_steps", "n_windows",
              "n_sub_batches", "useful_gmem_words", "padded_gmem_words",
              "occupancy", "by_tenant", "by_bucket", "makespan_cycles",
              "busy_cycles", "pool", "n_devices", "n_shed", "energy_eu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain path's small tensors run fastest on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _server(pkg, **kw):
    if pkg is trt:
        kw["device"] = "cpu"
    return pkg.RuntimeServer(**kw)


_seq_memo = {}


def _sequential(name, n, gseed):
    """Memoized sequential run_grid oracle (the port's, on the CPU)."""
    key = (name, n, gseed)
    if key not in _seq_memo:
        mod = ALL[name]
        code = mod.build(n)
        g0 = mod.make_gmem(np.random.default_rng(gseed), n)
        res = scheduler.run_grid(code, *mod.launch(n), g0.copy(),
                                 device="cpu")
        _seq_memo[key] = (code, g0, res)
    return _seq_memo[key]


def _assert_bit_identical(got, want):
    np.testing.assert_array_equal(host_numpy(got.gmem), host_numpy(want.gmem))
    np.testing.assert_array_equal(got.cycles_per_block,
                                  want.cycles_per_block)
    np.testing.assert_array_equal(got.op_issues, want.op_issues)
    np.testing.assert_array_equal(got.op_lanes, want.op_lanes)
    assert got.stack_ops == want.stack_ops
    assert got.max_sp == want.max_sp
    assert got.overflow == want.overflow


def _accounting(stats):
    """The exact fields of a DrainStats as plain data (the per-tenant and
    per-bucket dataclasses of the two packages are different types)."""
    d = {f: getattr(stats, f) for f in ACCOUNTING}
    for f in ("by_tenant", "by_bucket"):
        d[f] = {k: dataclasses.asdict(v) for k, v in d[f].items()}
    d["per_sm_cycles"] = np.asarray(stats.per_sm_cycles).tolist()
    return d


def _fuzz_workload(seed, n_launches):
    """The seeded multi-tenant workload of the JAX fuzz: (name, n,
    gseed, tenant) per launch, and the window bound."""
    rng = np.random.default_rng(seed)
    max_batch = int(rng.integers(2, 6))
    work = []
    for _ in range(n_launches):
        name, n = _POOL[int(rng.integers(len(_POOL)))]
        work.append((name, n, int(rng.integers(4)),
                     f"tenant{int(rng.integers(3))}"))
    return max_batch, work


def _drain_fuzz(pkg, policy, max_batch, work):
    srv = _server(pkg, n_sm=2, policy=policy, max_batch=max_batch)
    tickets = {}
    for name, n, gseed, tenant in work:
        code, g0, _ = _sequential(name, n, gseed)
        t = srv.submit(code, *ALL[name].launch(n), g0.copy(), client=tenant)
        tickets[t] = (name, n, gseed)
    results, stats = srv.drain()
    assert srv.pending() == 0
    return tickets, results, stats


# ------------------------------------------------------ differential fuzz

@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_fuzz_bit_exact_with_sequential_and_jax_server(policy):
    """One seeded workload under each policy: every ticket equal to the
    port's sequential run_grid, and tickets, gmem, counters and the
    drain's accounting equal to the JAX server's on the same launches."""
    max_batch, work = _fuzz_workload(424242, 6)
    tickets, results, stats = _drain_fuzz(trt, policy, max_batch, work)
    assert sorted(results) == sorted(tickets)
    for t, key in tickets.items():
        _assert_bit_identical(results[t], _sequential(*key)[2])
    jt, jres, jstats = _drain_fuzz(jrt, policy, max_batch, work)
    assert sorted(jres) == sorted(results) and jt == tickets
    for t in tickets:
        _assert_bit_identical(results[t], jres[t])
    assert _accounting(stats) == _accounting(jstats)
    assert stats.n_launches == 6 and stats.per_sm_cycles.sum() > 0


@pytest.mark.parametrize("seed", (0, 1))
def test_fuzz_seeds_bit_exact(seed):
    """Two more seeded workloads of six launches under the fair and sla
    policies: every ticket equal to sequential run_grid."""
    for policy in ("fair", "sla"):
        max_batch, work = _fuzz_workload(1000 * seed + len(policy), 6)
        tickets, results, stats = _drain_fuzz(trt, policy, max_batch, work)
        for t, key in tickets.items():
            _assert_bit_identical(results[t], _sequential(*key)[2])
        assert sum(ts.launches for ts in stats.by_tenant.values()) == \
            stats.n_launches == len(work)


# ------------------------------------------ the serving CLI's workloads

def _drain_work(pkg, work, policy, n_sm=2):
    srv = _server(pkg, n_sm=n_sm, policy=policy)
    tickets = [srv.submit(code, grid, bd, g0.copy(), client=f"t{i}")
               for i, (name, mod, n, code, (grid, bd), g0)
               in enumerate(work)]
    results, stats = srv.drain()
    return [results[t] for t in tickets], stats


def test_skewed_padded_words_monolithic_56896_bucket_64():
    """One large-bucket tenant plus seven small ones: the monolithic
    drain pads 56896 words, the bucketed one 64, as in the JAX package,
    with every ticket equal to sequential run_grid."""
    work = tserve.build_skewed_workload(n_small=7)
    want = [scheduler.run_grid(code, grid, bd, g0.copy(), device="cpu")
            for _, _, _, code, (grid, bd), g0 in work]
    padded = {}
    for polname in ("monolithic", "bucket"):
        results, stats = _drain_work(trt, work, polname)
        assert stats.n_windows == 1
        for (name, mod, n, _, _, g0), res, seq in zip(work, results, want):
            _assert_bit_identical(res, seq)
            np.testing.assert_array_equal(
                host_numpy(res.gmem)[mod.out_slice(n)], mod.oracle(g0, n))
        padded[polname] = stats.padded_gmem_words
    assert padded == {"monolithic": 56896, "bucket": 64}


def test_longtail_makespan_bucket_1456_balanced_784():
    """Skewed-duration single-block binaries: makespan 1456 cycles under
    the bucket drain, 784 under the balanced one, equal to the JAX
    server's makespan and per-SM cycles on the same launches."""
    work = tserve.build_longtail_workload(8)
    jwork = jserve.build_longtail_workload(8)
    for (_, _, _, code, _, g0), (_, _, _, jcode, _, jg0) in zip(work, jwork):
        np.testing.assert_array_equal(code, jcode)
        np.testing.assert_array_equal(g0, jg0)
    makespan = {}
    for polname in ("bucket", "balanced"):
        results, stats = _drain_work(trt, work, polname)
        jresults, jstats = _drain_work(jrt, jwork, polname)
        for res, jres in zip(results, jresults):
            _assert_bit_identical(res, jres)
        assert _accounting(stats) == _accounting(jstats)
        makespan[polname] = stats.makespan_cycles
    assert makespan == {"bucket": 1456, "balanced": 784}


# ---------------------------------------------------- admission control

def test_admission_bounded_queue_and_tenant_cap():
    code, g0, seq = _sequential("reduction", 32, 0)
    launch = ALL["reduction"].launch(32)
    srv = _server(trt, n_sm=1, max_pending=2)
    srv.submit(code, *launch, g0.copy(), client="a")
    srv.submit(code, *launch, g0.copy(), client="b")
    with pytest.raises(trt.AdmissionError, match="queue full"):
        srv.submit(code, *launch, g0.copy(), client="c")
    with pytest.raises(trt.AdmissionError):
        srv.submit_future(code, *launch, g0.copy(), client="c")
    assert srv.tenant_stats["c"].rejected == 2
    assert srv.pending() == 2 and srv._futures == {}
    results, _ = srv.drain()
    assert len(results) == 2
    srv.submit(code, *launch, g0.copy(), client="c")      # room again

    srv = _server(trt, n_sm=1, max_inflight_per_tenant=2)
    srv.submit(code, *launch, g0.copy(), client="greedy")
    srv.submit(code, *launch, g0.copy(), client="greedy")
    with pytest.raises(trt.AdmissionError, match="in-flight cap"):
        srv.submit(code, *launch, g0.copy(), client="greedy")
    srv.submit(code, *launch, g0.copy(), client="patient")
    assert srv.tenant_stats["greedy"].rejected == 1
    results, _ = srv.drain()
    assert len(results) == 3
    for res in results.values():
        _assert_bit_identical(res, seq)


def test_submit_validates_geometry():
    code, g0, _ = _sequential("reduction", 32, 0)
    srv = _server(trt, n_sm=1)
    with pytest.raises(ValueError, match="empty grid"):
        srv.submit(code, (0, 1), (32, 1), g0)
    with pytest.raises(ValueError, match="1-D"):
        srv.submit(code, (1, 1), (32, 1), g0.reshape(1, -1))
    with pytest.raises(ValueError, match="block budget"):
        srv.submit(code, (1 << 15, 2), (32, 1), g0)
    assert srv.pending() == 0


# ------------------------------------------------- failure isolation

def _poison(srv, index=-1):
    """Corrupt a pending request's gmem behind the validator's back."""
    srv._pending[index] = srv._pending[index]._replace(
        spec=srv._pending[index].spec._replace(
            gmem=srv._pending[index].spec.gmem.reshape(1, -1)))


def test_poisoned_launch_isolated_then_dropped_after_max_attempts():
    """A poisoned launch takes down only its own sub-batch: window-mates
    complete in the same drain.  Kept poisoned, it is dropped after
    MAX_ATTEMPTS with its future failed, and the server serves on."""
    srv = _server(trt, n_sm=2, policy="bucket")
    c_red, g_red, seq_red = _sequential("reduction", 32, 0)
    c_tr, g_tr, seq_tr = _sequential("transpose", 32, 2)
    fut_tr = srv.submit_future(c_tr, *ALL["transpose"].launch(32),
                               g_tr.copy(), client="healthy")
    fut_sick = srv.submit_future(c_red, *ALL["reduction"].launch(32),
                                 g_red.copy(), client="sick")
    _poison(srv)
    with pytest.raises(Exception):
        srv.drain()
    assert fut_tr.done()                      # window-mate completed
    _assert_bit_identical(fut_tr.result(), seq_tr)
    assert [r.attempts for r in srv._pending] == [1]
    for _ in range(srv.MAX_ATTEMPTS - 1):
        with pytest.raises(Exception):
            srv.drain()
    assert srv.pending() == 0                 # dropped, not looping
    assert fut_sick.done()
    with pytest.raises(Exception):
        fut_sick.result()
    assert srv.tenant_stats["sick"].dropped == 1
    t = srv.submit(c_red, *ALL["reduction"].launch(32), g_red.copy())
    results, _ = srv.drain()
    _assert_bit_identical(results[t], seq_red)


# ------------------------------------- streams/events over drain windows

def _kern(region_in, region_out, op):
    p = asm.Program(op)
    p.s2r("r0", isa.SR_TID)
    p.ldg("r1", "r0", region_in)
    if op == "add1":
        p.iadd("r1", "r1", 1)
    else:
        p.iadd("r1", "r1", "r1")
    p.stg("r0", "r1", region_out)
    p.exit()
    return p.finish(pad_to=96)


def test_queued_stream_in_order_across_buckets():
    """A stream's chained (x+1)*2 stays in dataflow order with a
    large-bucket tenant in the same window, in one drain; an event on a
    queued producer fires only after the producer's sub-batch."""
    srv = _server(trt, n_sm=2, policy="bucket")
    m1 = srv.registry.load(_kern(0, 64, "add1"), "add1")
    m2 = srv.registry.load(_kern(64, 128, "double"), "double")
    c_tr, g_tr, seq_tr = _sequential("transpose", 32, 3)
    fut_tr = srv.submit_future(c_tr, *ALL["transpose"].launch(32),
                               g_tr.copy(), client="big")
    g0 = np.zeros(192, np.int32)
    g0[:32] = np.arange(32)
    s = srv.stream(g0, client="chain")
    a = s.launch(m1, (1, 1), (32, 1))
    ev = s.record_event()
    b = s.launch(m2, (1, 1), (32, 1))   # dependency edge on a, no flush
    assert srv.pending() == 3 and not ev.query()
    np.testing.assert_array_equal(host_numpy(b.gmem())[128:160],
                                  (np.arange(32) + 1) * 2)
    assert a.done() and b.done() and ev.query() and srv.drains == 1
    np.testing.assert_array_equal(host_numpy(ev.gmem())[64:96],
                                  np.arange(32) + 1)
    _assert_bit_identical(fut_tr.result(), seq_tr)
    # a consumer stream reads the producer's memory through the event
    s2 = srv.stream(client="consumer")
    s2.wait_event(ev)
    c = s2.launch(m2, (1, 1), (32, 1), gmem=ev)
    np.testing.assert_array_equal(host_numpy(c.gmem())[128:160],
                                  (np.arange(32) + 1) * 2)


def test_dependent_chain_drained_in_one_window_equals_jax():
    """a -> b -> c on one stream plus an unrelated tenant: one drain, one
    window, one sub-batch per chain link, with gmem, tickets and the
    drain accounting equal to the JAX server's."""
    def run(pkg, asm_mod):
        def addk(k):
            p = asm_mod.Program(f"addk{k}")
            p.s2r("r0", isa.SR_TID)
            p.ldg("r1", "r0", 0)
            p.iadd("r1", "r1", k)
            p.stg("r0", "r1", 0)
            p.exit()
            return p.finish(pad_to=64)
        srv = _server(pkg, n_sm=1, policy="balanced")
        other = srv.submit(addk(9), (1, 1), (32, 1),
                           np.arange(128, dtype=np.int32), client="other")
        g0 = np.zeros(128, np.int32)
        g0[:32] = np.arange(32)
        s = srv.stream(g0, client="chain")
        futs = [s.launch(srv.registry.load(addk(k), f"k{k}"), (1, 1),
                         (32, 1)) for k in (3, 5, 7)]
        assert srv.pending() == 4
        results, stats = srv.drain()
        assert srv.drains == 1 and stats.n_windows == 1
        assert srv._dep_waiters == {} and srv._dep_gmem == {}
        out = {t: np.asarray(host_numpy(r.gmem)) for t, r in results.items()}
        return other, [f.ticket for f in futs], out, stats

    from repro.core import asm as jasm
    other, chain, out, stats = run(trt, asm)
    jother, jchain, jout, jstats = run(jrt, jasm)
    assert (other, chain) == (jother, jchain)
    assert sorted(out) == sorted(jout)
    for t in out:
        np.testing.assert_array_equal(out[t], jout[t])
    np.testing.assert_array_equal(out[chain[-1]][:32], np.arange(32) + 15)
    assert stats.n_sub_batches == 3           # the chain's layers + other
    assert _accounting(stats) == _accounting(jstats)


def test_server_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trt.RuntimeServer(n_sm=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trt.Runtime()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trt.GmemPool()
