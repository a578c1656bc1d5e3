"""The port's multi-SM executor against the JAX package, bit for bit:
``run_grid``/``execute`` on the five paper programs at 1, 2 and 4 SMs
(final gmem, per-block cycles, every counter, and the executed per-SM
cycles against JAX's ``execute(...).report()`` and the analytical
replay).  Dispatch semantics are in test_torch_dispatch.py."""
import functools

import numpy as np
import pytest

from repro import runtime as jrt
from repro.core.machine import MachineConfig as JaxConfig
from repro_torch.core import scheduler
from repro_torch.core.programs import ALL

FIELDS = ("gmem", "cycles_per_block", "op_issues", "op_lanes", "stack_ops",
          "max_sp", "overflow")
JAX = JaxConfig(execute_backend="jnp")


def _same(got, want, tag):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{tag}: {f}")


def _program(name, n=32):
    mod = ALL[name]
    grid, bd = mod.launch(n)
    return mod, mod.build(n), grid, bd, mod.make_gmem(
        np.random.default_rng(5), n)


@functools.lru_cache(maxsize=None)
def _jax_two_sm(name):
    """JAX's executed two-SM schedule of one paper program."""
    _, code, grid, bd, g0 = _program(name)
    dg = jrt.execute([jrt.LaunchSpec(code, grid, bd, g0.copy())], n_sm=2,
                     cfg=JAX)
    return dg.to_results()[0], dg.report()


@pytest.mark.parametrize("n_sm", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(ALL))
def test_paper_program_grid(name, n_sm):
    mod, code, grid, bd, g0 = _program(name)
    want, jrep = _jax_two_sm(name)
    dg = scheduler.execute([scheduler.LaunchSpec(code, grid, bd, g0.copy())],
                           n_sm=n_sm, device="cpu")
    got, rep = dg.to_results()[0], dg.report()
    _same(got, want, f"{name} n_sm={n_sm}")
    np.testing.assert_array_equal(got.gmem[mod.out_slice(32)],
                                  mod.oracle(g0, 32))
    np.testing.assert_array_equal(rep.per_sm_cycles,
                                  want.per_sm_cycles(n_sm))
    assert rep.per_sm_cycles.dtype == np.int64
    assert (rep.n_sm, rep.max_sp, rep.overflow) == \
        (n_sm, jrep.max_sp, jrep.overflow)
    if n_sm == 2:
        np.testing.assert_array_equal(rep.per_sm_cycles, jrep.per_sm_cycles)
        assert (rep.n_steps, rep.n_blocks, rep.device_gmem_words,
                rep.useful_gmem_words) == \
            (jrep.n_steps, jrep.n_blocks, jrep.device_gmem_words,
             jrep.useful_gmem_words)
