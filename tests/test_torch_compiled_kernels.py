"""The three DSL-compiled kernels (histogram, scan, ELL SpMV) of the port
(``repro_torch.compiler.kernels``) on the CPU.

Their binaries and compile reports equal the JAX package's at every size
the tests and ``chip_smoke.py`` use; through the port's ``run_grid`` they
meet their numpy oracles across grid and block sizes, the naive and the
optimized binaries agree, histogram's two passes reduce, and the
if-converted scan runs with no warp stack.  Served with the paper's five,
they drain bit-exact under the monolithic policy (code buckets 64 and 96
in one execute), and the mixed serving CLI with the compiled tenants
equals the JAX CLI's drain: its accounting and every ticket."""
import numpy as np
import pytest
import torch

from repro import compiler as jcomp
from repro import runtime as jrt
from repro.compiler.kernels import COMPILED as JCOMPILED
from repro.launch import gpgpu_serve as jserve
from repro_torch import compiler as tcomp
from repro_torch import runtime as rt
from repro_torch.compiler.kernels import COMPILED, histogram
from repro_torch.core import customize, scheduler
from repro_torch.core.machine import MachineConfig
from repro_torch.core.pipeline.state import host_numpy
from repro_torch.core.programs import ALL, compiled_kernels
from repro_torch.launch import gpgpu_serve as tserve
from test_torch_compiler import _restore_counters, fresh_ids  # noqa: F401

FIELDS = ("gmem", "cycles_per_block", "op_issues", "op_lanes", "stack_ops",
          "max_sp", "overflow")
#: tests/test_compiled_kernels.py's sizes, and the multi-block grids of
#: chip_smoke.py (histogram n=16384, spmv n=4096)
SIZES = {"histogram": (32, 64, 128, 256, 16384),
         "scan": (32, 64, 128, 256), "spmv": (32, 64, 128, 4096)}
#: the sizes run on the CPU (histogram's 256 is its two-pass case)
RUN_SIZES = {"histogram": (32,), "scan": (32, 64, 128, 256),
             "spmv": (32, 64, 128)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(got, want, tag):
    for f in FIELDS:
        np.testing.assert_array_equal(host_numpy(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{tag}: {f}")


def _report(rep):
    return [(ck.code.tobytes(), ck.n_instr, ck.listing, ck.pass_log)
            for ck in (rep.kernel, rep.naive)] + [rep.saved_instrs,
                                                  rep.saving_pct]


@pytest.mark.parametrize("name,n", [(k, n) for k in sorted(SIZES)
                                    for n in SIZES[k]])
def test_binaries_equal_jax(name, n):
    mod, jmod = COMPILED[name], JCOMPILED[name]
    for optimize in (True, False):
        np.testing.assert_array_equal(mod.build(n, optimize),
                                      jmod.build(n, optimize))
    fresh_ids(tcomp)
    mine = _report(mod.report(n))
    fresh_ids(jcomp)
    assert mine == _report(jmod.report(n))
    if name == "histogram":
        np.testing.assert_array_equal(histogram.reduce_build(n),
                                      JCOMPILED[name].reduce_build(n))
    assert (mod.launch(n), mod.n_threads(n), mod.out_slice(n)) == \
        (jmod.launch(n), jmod.n_threads(n), jmod.out_slice(n))
    g = mod.make_gmem(np.random.default_rng(n), n)
    np.testing.assert_array_equal(g, jmod.make_gmem(
        np.random.default_rng(n), n))
    np.testing.assert_array_equal(mod.oracle(g, n), jmod.oracle(g, n))


@pytest.mark.parametrize("name", sorted(COMPILED))
def test_compiled_kernel_matches_oracle_across_sizes(name):
    mod = COMPILED[name]
    for n in RUN_SIZES[name]:
        code = mod.build(n)
        g0 = mod.make_gmem(np.random.default_rng(1), n)
        res = scheduler.run_grid(code, *mod.launch(n), g0.copy(),
                                 device="cpu")
        np.testing.assert_array_equal(res.gmem[mod.out_slice(n)],
                                      mod.oracle(g0, n),
                                      err_msg=f"{name} n={n}")


@pytest.mark.parametrize("name", sorted(COMPILED))
def test_naive_and_optimized_binaries_agree(name):
    """Passes change instructions, never results; the optimized binary
    takes fewer cycles."""
    mod, n = COMPILED[name], 32
    g0 = mod.make_gmem(np.random.default_rng(3), n)
    opt = scheduler.run_grid(mod.build(n), *mod.launch(n), g0.copy(),
                             device="cpu")
    naive = scheduler.run_grid(mod.build(n, optimize=False),
                               *mod.launch(n), g0.copy(), device="cpu")
    np.testing.assert_array_equal(opt.gmem, naive.gmem)
    assert opt.cycles_per_block.sum() < naive.cycles_per_block.sum()


def test_histogram_two_pass_reduce():
    n = 256
    g0 = histogram.make_gmem(np.random.default_rng(9), n)
    gm, results = histogram.run_passes(
        lambda *a: scheduler.run_grid(*a, device="cpu"),
        histogram.build(n), n, g0.copy())
    assert len(results) == 2
    np.testing.assert_array_equal(gm[histogram.final_slice(n)],
                                  histogram.final_oracle(g0, n))
    np.testing.assert_array_equal(results[0].gmem[histogram.out_slice(n)],
                                  histogram.oracle(g0, n))


def test_spmv_scales_to_two_sms():
    mod, n = COMPILED["spmv"], 128
    g0 = mod.make_gmem(np.random.default_rng(0), n)
    res = scheduler.run_grid(mod.build(n), *mod.launch(n), g0.copy(),
                             device="cpu")
    assert res.sm_cycles(1) > res.sm_cycles(2)


def test_ifconverted_scan_runs_with_zero_stack_depth():
    """tests/test_compiler.py's case, also on the machine the customization
    analyzer picks for it: a one-entry warp stack (the least the reference
    runs: it raises at depth 0) and no multiplier."""
    mod, n = COMPILED["scan"], 64
    code = mod.build(n)
    g0 = mod.make_gmem(np.random.default_rng(0), n)
    small = customize.minimal_config(code)
    assert small.warp_stack_depth == 1 and not small.enable_mul
    for cfg in (MachineConfig(), small):
        res = scheduler.run_grid(code, *mod.launch(n), g0.copy(), cfg,
                                 device="cpu")
        assert res.max_sp == 0 and res.stack_ops == 0
        np.testing.assert_array_equal(res.gmem[mod.out_slice(n)],
                                      mod.oracle(g0, n))


def test_compiled_kernels_land_in_small_code_bucket():
    regy = rt.ModuleRegistry()
    for name, mod in COMPILED.items():
        assert regy.load(mod.build(64), name).padded_len == 64, name
    assert regy.load(ALL["bitonic"].build(32), "bitonic").padded_len == 96
    assert sorted(compiled_kernels()) == ["histogram", "scan", "spmv"]
    for mod in compiled_kernels().values():
        for attr in ("build", "launch", "make_gmem", "oracle",
                     "out_slice", "n_threads", "report"):
            assert hasattr(mod, attr)


def test_monolithic_drain_mixes_code_buckets_bit_exact():
    """The three compiled kernels (64-instruction bucket) and two of the
    five (96) in one dispatch group: EXIT padding changes no result."""
    srv = rt.RuntimeServer(n_sm=2, policy="monolithic", device="cpu")
    want = {}
    for i, (name, n) in enumerate((("histogram", 32), ("scan", 32),
                                   ("spmv", 32), ("bitonic", 32),
                                   ("autocorr", 32))):
        mod = COMPILED.get(name) or ALL[name]
        code = mod.build(n)
        g0 = mod.make_gmem(np.random.default_rng(40 + i), n)
        want[srv.submit(code, *mod.launch(n), g0.copy(),
                        client=f"t{i % 2}")] = scheduler.run_grid(
            code, *mod.launch(n), g0.copy(), device="cpu")
    results, stats = srv.drain()
    assert stats.n_sub_batches == 1 and sorted(results) == sorted(want)
    for t, seq in want.items():
        _same(results[t], seq, f"ticket {t}")


def test_mixed_cli_with_compiled_tenants_equals_jax(monkeypatch, capsys):
    """``gpgpu_serve`` without ``--no-compiled``: all eight kernels from 4
    tenants on 2 SMs, the drain's accounting and every ticket equal to the
    JAX CLI's on the same arguments, and a build-attribution document."""
    drains = {}
    for pkg, server in (("torch", rt.RuntimeServer),
                        ("jax", jrt.RuntimeServer)):
        def drain(self, *a, _orig=server.drain, _pkg=pkg, **k):
            drains[_pkg] = _orig(self, *a, **k)
            return drains[_pkg]
        monkeypatch.setattr(server, "drain", drain)
    argv = ["--launches", "8", "--n-sm", "2"]
    stats = tserve.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    jstats = jserve.main(argv)
    assert "[serve]   jit _total: 0 misses" in out
    assert sorted({w[0] for w in tserve.build_workload(8)}) == \
        sorted({**ALL, **COMPILED})
    for f in ("n_launches", "n_blocks", "n_steps", "n_windows",
              "n_sub_batches", "useful_gmem_words", "padded_gmem_words",
              "occupancy", "makespan_cycles", "busy_cycles", "n_shed"):
        assert getattr(stats, f) == getattr(jstats, f), f
    np.testing.assert_array_equal(stats.per_sm_cycles, jstats.per_sm_cycles)
    (results, _), (jresults, _) = drains["torch"], drains["jax"]
    assert sorted(results) == sorted(jresults) and len(results) == 8
    for t in results:
        _same(results[t], jresults[t], f"ticket {t}")
