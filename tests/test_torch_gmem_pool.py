"""The port's device-resident gmem pool and transfer accounting against the
JAX package's, on the CPU.

The same call sequences go through ``repro_torch.runtime.GmemPool(
device="cpu")`` / ``RuntimeServer(device="cpu")`` and their JAX
counterparts; every count (``host_uploads``, ``host_syncs``, ``hits``,
``misses``, ``evictions``, pins, ``TRANSFERS`` windows) and every final
memory is equal.  On the CPU an upload is a numpy array, as it is for the
JAX package on the CPU; a tensor on the pool's device passes through, as
a ``jax.Array`` does.
"""
import numpy as np
import pytest
import torch

import repro.runtime as jrt
import repro_torch.runtime as trt
from repro_torch.runtime import executor as texec
from repro_torch.core import asm, isa
from repro_torch.core.pipeline.state import host_numpy

PKGS = pytest.mark.parametrize("pkg", (jrt, trt), ids=("jax", "torch"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu(pkg, **kw):
    return dict(kw, device="cpu") if pkg is trt else kw


def _addk(k, pad_to=64):
    """out[tid] = gmem[tid] + k for tid in [0, block_dim)."""
    p = asm.Program(f"addk{k}")
    p.s2r("r0", isa.SR_TID)
    p.ldg("r1", "r0", 0)
    p.iadd("r1", "r1", k)
    p.stg("r0", "r1", 0)
    p.exit()
    return p.finish(pad_to=pad_to)


def _chain(srv, g0, ks, client="t"):
    s = srv.stream(g0, client=client)
    return [s.launch(srv.registry.load(_addk(k), f"{client}-addk{k}-{i}"),
                     (1, 1), (32, 1)) for i, k in enumerate(ks)]


# ------------------------------------------------------- GmemPool (unit)

def _pool_sequence(pkg):
    """adopt / put / pin / get / read / evict / release / the LRU cap on
    one pool; every observable count, in order."""
    log = []
    pool = pkg.GmemPool(**_cpu(pkg))
    dev = pool.adopt(np.arange(8, dtype=np.int32))
    log.append(pool.host_uploads)
    assert pool.adopt(dev) is dev                # device memory passes
    log.append(pool.host_uploads)
    g = np.arange(16, dtype=np.int32)
    pool.put(7, g)
    pool.put(8, dev)                             # no second upload
    log.append((pool.get(7) is not None, pool.get(99), pool.hits,
                pool.misses, pool.host_uploads))
    log.append((host_numpy(pool.read(7)).tolist(), pool.host_syncs))
    log.append((pool.evict(8).tolist(), pool.evictions, pool.host_syncs,
                pool.evict(8)))
    pool.release(7)
    log.append((7 in pool, pool.host_syncs, len(pool)))
    pool = pkg.GmemPool(**_cpu(pkg, max_entries=2))
    pool.put(1, np.full(4, 1, np.int32), pin=True)
    pool.put(2, np.full(4, 2, np.int32))
    pool.put(3, np.full(4, 3, np.int32))
    log.append((1 in pool, 2 in pool, 3 in pool, sorted(pool.pinned())))
    pool.get(3)
    pool.put(4, np.full(4, 4, np.int32))
    pool.pin(4)
    log.append((sorted(t for t in (1, 2, 3, 4) if t in pool),
                sorted(pool.pinned()), pool.stats()))
    return log


def test_pool_counts_equal_jax():
    log = _pool_sequence(trt)
    assert log == _pool_sequence(jrt)
    assert log[0] == 1 and log[1] == 1          # one upload, then none


def test_pool_adopt_rules_on_the_port():
    """numpy and tensors on another device upload; a tensor on the
    pool's device passes through; read/evict hand back host copies."""
    pool = trt.GmemPool(device="cpu")
    t = torch.arange(4, dtype=torch.int32)
    assert pool.adopt(t) is t and pool.host_uploads == 0
    t64 = pool.adopt(torch.arange(4))            # dtype only: no upload
    assert t64.dtype == torch.int32 and pool.host_uploads == 0
    pool.put(1, t)
    back = pool.read(1)
    assert isinstance(back, np.ndarray)
    back[:] = -1                                 # a copy, not a view
    assert pool.get(1).tolist() == [0, 1, 2, 3]


# ------------------------------------------- executor transfer batching

@PKGS
def test_one_counter_sync_per_grid(pkg):
    """report() + to_results() share one counter fetch; host_gmem=False
    leaves memory on the device."""
    g0 = np.arange(64, dtype=np.int32)
    w = pkg.TRANSFERS.window()
    dg = pkg.execute([pkg.LaunchSpec(_addk(5), (1, 1), (32, 1), g0)],
                     **_cpu(pkg, n_sm=2))
    dg.report()
    res = dg.to_results()[0]
    assert w.snapshot() == {"gmem_uploads": 1, "gmem_syncs": 1,
                            "counter_syncs": 1}
    want = g0.copy()
    want[:32] += 5
    np.testing.assert_array_equal(res.gmem, want)
    w = pkg.TRANSFERS.window()
    dg = pkg.execute([pkg.LaunchSpec(_addk(2), (1, 1), (32, 1), g0)],
                     **_cpu(pkg))
    res = dg.to_results(host_gmem=False)[0]
    assert not isinstance(res.gmem, np.ndarray)
    assert w.gmem_syncs == 0 and w.counter_syncs == 1


def test_transfer_log_view_semantics():
    """reset() re-bases the shared view, window() is independent."""
    w = trt.TRANSFERS.window()
    trt.TRANSFERS.reset()
    for _ in range(2):                           # the executor's seam
        texec._transfer("gmem_uploads")
    assert trt.TRANSFERS.gmem_uploads == 2 and w.gmem_uploads == 2
    assert trt.METRICS.counter("transfers.gmem_uploads").value >= 2
    trt.TRANSFERS.reset()
    assert trt.TRANSFERS.snapshot() == {"gmem_uploads": 0, "gmem_syncs": 0,
                                        "counter_syncs": 0}


# ------------------------------------------------- server residency

def _resident_chain(pkg, resident):
    g0 = np.arange(64, dtype=np.int32)
    srv = pkg.RuntimeServer(**_cpu(pkg, n_sm=2, resident_gmem=resident,
                                   max_batch=1))
    futs = _chain(srv, g0, (1, 2, 3))
    w = pkg.TRANSFERS.window()
    _, stats = srv.drain()
    out = host_numpy(futs[-1].gmem()) if pkg is trt else \
        np.asarray(futs[-1].gmem())
    assert srv._dep_waiters == {} and srv._dep_gmem == {}
    return w.snapshot(), stats.n_windows, stats.pool, out.tolist()


@pytest.mark.parametrize("resident", (True, False),
                         ids=("resident", "host"))
def test_chain_drain_transfers_equal_jax(resident):
    """A three-window dependent drain: resident, zero gmem uploads and
    zero gmem syncs between windows; on the host path one of each a
    window.  Counts, pool stats and memory equal to the JAX server's."""
    got = _resident_chain(trt, resident)
    assert got == _resident_chain(jrt, resident)
    transfers, n_windows, pool, out = got
    assert n_windows == 3
    want = np.arange(64)
    want[:32] += 6
    assert out == want.tolist()
    if resident:
        assert transfers["gmem_uploads"] == transfers["gmem_syncs"] == 0
        assert pool["host_syncs"] == 0
    else:
        assert transfers["gmem_uploads"] == transfers["gmem_syncs"] == 3


def test_resident_pool_survives_across_drains():
    """A producer drained alone stays pinned on the device between drain
    calls and is consumed, not re-uploaded, by the next drain."""
    g0 = np.arange(64, dtype=np.int32)
    srv = trt.RuntimeServer(n_sm=2, resident_gmem=True, max_batch=1,
                            device="cpu")
    a = srv.submit_future(_addk(4), (1, 1), (32, 1), g0, client="t")
    b = srv.submit_future(_addk(5), (1, 1), (32, 1),
                          trt.DepGmem(a.ticket, 64), client="t")
    c = srv.submit_future(_addk(6), (1, 1), (32, 1),
                          trt.DepGmem(b.ticket, 64), client="t")
    srv.drain(max_windows=1)
    assert a.done() and not b.done()
    assert set(srv._dep_gmem) == {a.ticket}
    assert isinstance(srv._dep_gmem[a.ticket], torch.Tensor)
    w = trt.TRANSFERS.window()
    srv.drain()
    assert w.gmem_uploads == 0
    want = g0.copy()
    want[:32] += 15
    np.testing.assert_array_equal(host_numpy(c.gmem()), want)
    assert isinstance(c.result().gmem, torch.Tensor)
    assert srv._dep_gmem == {}


@pytest.mark.parametrize("max_batch", (1, 8))
def test_resident_matches_host_path_bit_exact(max_batch):
    g0 = np.arange(64, dtype=np.int32) - 17
    outs = {}
    for resident in (False, True):
        srv = trt.RuntimeServer(n_sm=2, resident_gmem=resident,
                                max_batch=max_batch, device="cpu")
        fa = _chain(srv, g0, (3, 5, 7), client="a")
        fb = _chain(srv, g0, (11, 13), client="b")
        srv.drain()
        outs[resident] = [(host_numpy(f.gmem()).tolist(),
                           f.result().cycles_per_block.tolist(),
                           f.result().op_issues.tolist())
                          for f in fa + fb]
    assert outs[False] == outs[True]
