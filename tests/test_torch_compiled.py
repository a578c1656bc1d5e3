"""The three DSL-compiled kernels (histogram, scan, ELL SpMV) through the
port's executor against the JAX package, bit for bit, at 1, 2 and 4 SMs.
The binaries are built here with ``repro.compiler`` (the compiler's port
is later work; a test may import the JAX package, the port may not)."""
import functools

import numpy as np
import pytest

from repro import runtime as jrt
from repro.compiler.kernels import COMPILED
from repro.core.machine import MachineConfig as JaxConfig
from repro_torch.core import scheduler

FIELDS = ("gmem", "cycles_per_block", "op_issues", "op_lanes", "stack_ops",
          "max_sp", "overflow")
JAX = JaxConfig(execute_backend="jnp")
#: sizes with 1 (histogram, scan) and 4 (spmv) blocks
SIZES = {"histogram": 32, "scan": 64, "spmv": 128}


def _same(got, want, tag):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{tag}: {f}")


@functools.lru_cache(maxsize=None)
def _case(name):
    mod, n = COMPILED[name], SIZES[name]
    code = mod.build(n)
    g0 = mod.make_gmem(np.random.default_rng(8), n)
    grid, bd = mod.launch(n)
    dg = jrt.execute([jrt.LaunchSpec(code, grid, bd, g0.copy())], n_sm=2,
                     cfg=JAX)
    return mod, n, code, grid, bd, g0, dg.to_results()[0], dg.report()


@pytest.mark.parametrize("n_sm", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(COMPILED))
def test_compiled_kernel_grid(name, n_sm):
    mod, n, code, grid, bd, g0, want, jrep = _case(name)
    dg = scheduler.execute([scheduler.LaunchSpec(code, grid, bd, g0.copy())],
                           n_sm=n_sm, device="cpu")
    got, rep = dg.to_results()[0], dg.report()
    _same(got, want, f"{name} n_sm={n_sm}")
    np.testing.assert_array_equal(got.gmem[mod.out_slice(n)],
                                  mod.oracle(g0, n))
    np.testing.assert_array_equal(rep.per_sm_cycles,
                                  want.per_sm_cycles(n_sm))
    if n_sm == 2:
        np.testing.assert_array_equal(rep.per_sm_cycles, jrep.per_sm_cycles)


def test_compiled_kernels_in_one_batch():
    """Three binaries of different lengths and gmem sizes in one execute:
    every launch equals its own run."""
    specs = []
    for name in sorted(COMPILED):
        mod, n, code, grid, bd, g0, want, _ = _case(name)
        specs.append((scheduler.LaunchSpec(code, grid, bd, g0.copy()), want))
    dg = scheduler.execute([s for s, _ in specs], n_sm=2, device="cpu")
    for (_, want), got in zip(specs, dg.to_results()):
        _same(got, want, "batch")
    cyc = np.concatenate([w.cycles_per_block for _, w in specs])
    np.testing.assert_array_equal(
        dg.report().per_sm_cycles,
        np.bincount(np.arange(len(cyc)) % 2, weights=cyc + 24,
                    minlength=2).astype(np.int64))
