"""The port's build attribution (``repro_torch.obs.jitprof``) on the CPU.

A call is a miss when it grew its seam's cache (the executor's predecode
cache ``_records``) or loaded the kernel library; misses and their
wall-ms land under the JAX package's ``jit.*`` names, and ``summary`` /
``delta`` give what ``repro.obs.jitprof`` gives for the same counts.  The
executor and ``run_block`` seams count their calls, and a drain's
attribution reaches the serving CLI's metrics document."""
import numpy as np
import torch

from repro.obs import jitprof as jjit
from repro.obs.metrics import MetricsRegistry as JaxRegistry
from repro_torch import obs
from repro_torch.core import machine, scheduler
from repro_torch.core.machine import MachineConfig
from repro_torch.core.programs import ALL
from repro_torch.launch import gpgpu_serve
from repro_torch.obs import jitprof
from repro_torch.runtime import executor


def _codes(name):
    code = ALL[name].build(32)[None]
    return code.tobytes(), code.shape


def test_predecode_cache_growth_is_a_miss():
    m = obs.MetricsRegistry()
    executor.clear_caches()
    for name, bucket in (("transpose", "c96"), ("transpose", "c96"),
                         ("bitonic", "c96b")):
        with jitprof.jit_call("site", executor._records, bucket=bucket,
                              metrics=m):
            executor._records(*_codes(name), MachineConfig())
    s = jitprof.summary(m)
    assert s["_total"]["jit_cache_misses"] == 2
    assert s["_total"]["jit_cache_hits"] == 1
    assert {k: v["jit_cache_misses"] for k, v in s.items()
            if k != "_total"} == {"c96": 1, "c96b": 1}
    assert m.counter("jit.calls.site").value == 3
    executor.clear_caches()
    with jitprof.jit_call("site", executor._records, bucket="c96",
                          metrics=m):
        executor._records(*_codes("transpose"), MachineConfig())
    assert jitprof.summary(m)["c96"]["jit_cache_misses"] == 2


def test_library_load_is_a_miss():
    m = obs.MetricsRegistry()
    with jitprof.jit_call("site", bucket="b", metrics=m):
        pass
    with jitprof.jit_call("site", bucket="b", metrics=m):
        jitprof.LIBRARY_LOADS.inc()
    assert jitprof.summary(m)["b"]["jit_cache_misses"] == 1
    assert m.counter("jit.cache_hits").value == 1


def test_summary_and_delta_equal_jax():
    """The same hits and misses recorded in each package's registry give
    the same summary and delta."""
    mine, theirs = obs.MetricsRegistry(), JaxRegistry()
    before = (jitprof.summary(mine), jjit.summary(theirs))
    for bucket, miss in (("c64", True), ("c96", True), ("c64", False),
                         ("c96", True)):
        for m in (mine, theirs):
            m.counter("jit.calls.site").inc()
            if miss:
                m.counter("jit.cache_misses").inc()
                m.counter(f"jit.cache_misses.{bucket}").inc()
                m.histogram("jit.trace_ms").record(2.5)
                m.histogram(f"jit.trace_ms.{bucket}").record(2.5)
            else:
                m.counter("jit.cache_hits").inc()
    assert jitprof.summary(mine) == jjit.summary(theirs)
    assert jitprof.delta(before[0], jitprof.summary(mine)) == \
        jjit.delta(before[1], jjit.summary(theirs))
    assert obs.jit_summary is jitprof.summary
    assert obs.jit_delta is jitprof.delta


def test_seams_count_their_calls_and_stay_exact():
    mod = ALL["transpose"]
    code, (grid, bd) = mod.build(16), mod.launch(16)
    g0 = mod.make_gmem(np.random.default_rng(0), 16)
    calls = {s: obs.METRICS.counter(f"jit.calls.{s}").value
             for s in ("executor.run_positions", "pipeline.run_block")}
    res = scheduler.run_grid(code, grid, bd, g0.copy(), device="cpu")
    mem, _, ctr = machine.run_block(code, bd, (0, 0), grid, g0.copy(),
                                    device="cpu")
    assert obs.METRICS.counter(
        "jit.calls.executor.run_positions").value == \
        calls["executor.run_positions"] + 1
    assert obs.METRICS.counter("jit.calls.pipeline.run_block").value == \
        calls["pipeline.run_block"] + 1
    np.testing.assert_array_equal(res.gmem[mod.out_slice(16)],
                                  mod.oracle(g0, 16))
    assert int(ctr.cycles) == int(res.cycles_per_block[0])
    assert torch.equal(mem[mod.out_slice(16)],
                       torch.as_tensor(res.gmem[mod.out_slice(16)]))


def test_drain_attribution_reaches_the_metrics_document():
    work = gpgpu_serve.build_workload(2, include_compiled=False)
    srv, stats, _ = gpgpu_serve.drain_workload(work, 2, 2, device="cpu")
    doc = gpgpu_serve.metrics_document(srv)
    assert doc["jit"] == srv.jit_attribution
    # the plain path predecodes and builds nothing: every call a hit
    assert doc["jit"] == {"_total": {"jit_cache_misses": 0,
                                     "jit_cache_hits": stats.n_sub_batches,
                                     "jit_trace_ms": 0.0}}
