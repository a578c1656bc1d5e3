"""The port's cost model and duration-aware packing against the JAX
package's, on the CPU.

The same binaries (the serving CLI's ``AddK`` kernels) and the same
observations go through ``repro_torch.runtime`` and ``repro.runtime``:
seeds, estimates after drains, eviction and the table bound, and the
LPT order of ``BalancedDrain`` are equal, exactly (the machine counts
cycles, so observed means are exact floats of integer counts).
"""
import numpy as np
import pytest
import torch

import repro.runtime as jrt
import repro_torch.runtime as trt
from repro.launch.gpgpu_serve import AddK as JAddK
from repro_torch.launch.gpgpu_serve import AddK
from repro_torch.runtime import policy as pol

LAUNCH = ((1, 1), (32, 1))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _server(pkg, **kw):
    if pkg is trt:
        kw["device"] = "cpu"
    return pkg.RuntimeServer(**kw)


def _addk(k, in_at=0, out_at=64):
    return AddK(k, in_at, out_at).build()


def _gmem(words=128, seed=0):
    g = np.zeros(words, np.int32)
    g[:32] = np.random.default_rng(seed).integers(0, 1 << 16, 32)
    return g


def test_addk_binaries_equal_the_jax_package():
    for k in (1, 7, 30, 60):
        np.testing.assert_array_equal(AddK(k).build(), JAddK(k).build())
        np.testing.assert_array_equal(
            AddK(k, block_w=8).make_gmem(np.random.default_rng(k)),
            JAddK(k, block_w=8).make_gmem(np.random.default_rng(k)))


@pytest.mark.parametrize("pkg", (jrt, trt), ids=("jax", "torch"))
def test_seed_estimate_from_program_length(pkg):
    regy = pkg.ModuleRegistry()
    mod = regy.load(_addk(5))
    est = regy.cost_model.estimate(mod)
    assert not est.observed and est.samples == 0
    assert est.cycles_per_block == mod.n_instr * pkg.SEED_CYCLES_PER_INSTR
    assert regy.cost_model.predicted_block_cycles(mod) == \
        est.cycles_per_block == 9 * 32


def _converge(pkg):
    """Estimates after one drain of addk7 and after two more launches."""
    srv = _server(pkg, n_sm=1)
    mod = srv.registry.load(_addk(7))
    t = srv.submit(mod.code[:mod.n_instr], *LAUNCH, _gmem())
    results, _ = srv.drain()
    observed = float(np.mean(results[t].cycles_per_block))
    est = srv.registry.cost_model.estimate(mod)
    for _ in range(2):
        srv.submit(mod.code[:mod.n_instr], *LAUNCH, _gmem())
    srv.drain()
    est2 = srv.registry.cost_model.estimate(mod)
    return observed, tuple(est), tuple(est2)


def test_cost_model_converges_to_observed_equal_to_jax():
    """One drain replaces the seed with the executed mean; more drains
    add samples; every number equal to the JAX package's."""
    observed, est, est2 = _converge(trt)
    assert est == (observed, True, 1)
    assert est2 == (observed, True, 3)
    assert observed != 11 * trt.SEED_CYCLES_PER_INSTR
    assert (observed, est, est2) == _converge(jrt)


@pytest.mark.parametrize("pkg", (jrt, trt), ids=("jax", "torch"))
def test_cost_model_forgets_evicted_and_stays_bounded(pkg):
    regy = pkg.ModuleRegistry(max_modules=1)
    mod_a = regy.load(_addk(3))
    regy.cost_model.observe(mod_a, [123.0])
    assert regy.cost_model.estimate(mod_a).observed
    regy.load(_addk(4))                      # evicts mod_a (LRU of 1)
    est = regy.cost_model.estimate(mod_a)
    assert not est.observed
    assert est.cycles_per_block == mod_a.n_instr * pkg.SEED_CYCLES_PER_INSTR
    regy = pkg.ModuleRegistry(max_modules=2)
    mods = [regy.load(_addk(k)) for k in (1, 2, 3, 4, 5)]
    for m in mods:                           # incl. the 3 evicted ones
        regy.cost_model.observe(m, [float(10 * m.n_instr)])
    assert len(regy.cost_model._mean) <= 2
    assert len(regy.cost_model._samples) <= 2
    assert regy.cost_model.estimate(mods[-1]).observed


def test_registry_counts_mirror_into_metrics():
    """Cache events land in METRICS under the JAX package's names."""
    before = {k: trt.METRICS.counter(k).value
              for k in ("module_cache.hits", "module_cache.misses")}
    regy = trt.ModuleRegistry()
    regy.load(_addk(2))
    regy.load(_addk(2))
    assert trt.METRICS.counter("module_cache.misses").value == \
        before["module_cache.misses"] + 1
    assert trt.METRICS.counter("module_cache.hits").value == \
        before["module_cache.hits"] + 1


def _lpt(pkg, observe=None):
    """BalancedDrain's order on addk 10/60/30, and BucketDrain's cuts."""
    srv = _server(pkg, n_sm=2, policy="balanced")
    mods = {k: srv.registry.load(_addk(k)) for k in (10, 60, 30)}
    for k, cyc in (observe or {}).items():
        srv.registry.cost_model.observe(mods[k], [cyc])
    ticket_of = {k: srv.submit(mods[k].code[:mods[k].n_instr], *LAUNCH,
                               _gmem(), client=f"t{k}") for k in mods}
    window = list(srv._pending)
    cuts = srv.policy.partition(window, srv.registry)
    order = [[r.ticket for r in sb.requests] for sb in cuts]
    n_bucket = len(pkg.policy.BucketDrain().partition(window, srv.registry))
    srv._pending.clear()
    return ticket_of, order, n_bucket


@pytest.mark.parametrize("observe", (None, {10: 9000.0, 60: 10.0}),
                         ids=("seeded", "observed"))
def test_balanced_lpt_order_equal_to_jax(observe):
    """Equal-footprint binaries merge into one dispatch group ordered by
    descending predicted cycles (program-length seeds, or observations
    that invert them); BucketDrain cuts one group per binary."""
    ticket_of, order, n_bucket = _lpt(trt, observe)
    assert (ticket_of, order, n_bucket) == _lpt(jrt, observe)
    want = (60, 30, 10) if observe is None else (10, 30, 60)
    assert order == [[ticket_of[k] for k in want]]
    assert n_bucket == 3


def test_balanced_keeps_gmem_buckets_apart():
    srv = _server(trt, n_sm=2, policy="balanced")
    code = _addk(5)
    srv.submit(code, *LAUNCH, _gmem(128), client="small")
    srv.submit(code, *LAUNCH, _gmem(8192), client="big")
    cuts = srv.policy.partition(list(srv._pending), srv.registry)
    assert sorted(sb.gmem_bucket for sb in cuts) == [128, 8192]
    srv._pending.clear()


def test_footprint_and_policy_plumbing():
    assert [trt.bucket_warps(w) for w in (1, 3, 8, 9)] == [1, 4, 8, 16]
    regy = trt.ModuleRegistry()
    mod = regy.load(_addk(5))
    assert trt.footprint(mod, (16, 16), 2048) == trt.Footprint(
        code_bucket=64, gmem_bucket=2048, warp_bucket=8)
    assert isinstance(pol.make_policy(None), pol.BucketDrain)
    with pytest.raises(ValueError, match="unknown drain policy"):
        pol.make_policy("lifo")
    assert sorted(trt.POLICIES) == sorted(jrt.POLICIES)
