"""Dispatch semantics of the port's multi-SM executor against the JAX
package, bit for bit: the host-side reduction passes, dispatch-group
sizes that must not change results, multi-launch batches, the
position-order last-writer merge with group-start gmem snapshots, and the
module registry."""
import functools

import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.core import scheduler as jsched
from repro.core.machine import MachineConfig as JaxConfig
from repro_torch.core import asm, isa, scheduler
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


def test_reduction_run_passes():
    mod = ALL["reduction"]
    n = 300                                  # two blocks, then one
    code = mod.build(n)
    g0 = mod.make_gmem(np.random.default_rng(6), n)
    final, passes = mod.run_passes(
        functools.partial(scheduler.run_grid, n_sm=2, device="cpu"), code, n,
        g0.copy())
    jfinal, jpasses = mod.run_passes(
        functools.partial(jsched.run_grid, n_sm=2, cfg=JAX), code, n,
        g0.copy())
    assert len(passes) == len(jpasses) == 2
    np.testing.assert_array_equal(final, jfinal)
    for got, want in zip(passes, jpasses):
        _same(got, want, "reduction pass")
    np.testing.assert_array_equal(final[mod.out_slice(n)], mod.oracle(g0, n))


@functools.lru_cache(maxsize=None)
def _transpose48():
    """transpose n=48 is a 3x3 grid: ragged groups at every chunk size."""
    mod = ALL["transpose"]
    code, (grid, bd) = mod.build(48), mod.launch(48)
    g0 = mod.make_gmem(np.random.default_rng(7), 48)
    base = scheduler.run_grid(code, grid, bd, g0.copy(), chunk=8,
                              device="cpu")
    return code, grid, bd, g0, base


@pytest.mark.parametrize("chunk,n_sm", [(64, 1), (4, 2), (1, 1)])
def test_group_size_leaves_results_unchanged(chunk, n_sm):
    code, grid, bd, g0, base = _transpose48()
    got = scheduler.run_grid(code, grid, bd, g0.copy(), chunk=chunk,
                             n_sm=n_sm, device="cpu")
    _same(got, base, f"chunk={chunk}")
    want = jsched.run_grid(code, grid, bd, g0.copy(), cfg=JAX, chunk=chunk,
                           n_sm=n_sm)
    _same(got, want, f"jax chunk={chunk}")


def test_multi_launch_batch_matches_reference():
    specs, jspecs = [], []
    for name in ("autocorr", "transpose", "bitonic"):
        _, code, grid, bd, g0 = _program(name)
        specs.append(scheduler.LaunchSpec(code, grid, bd, g0.copy()))
        jspecs.append(jrt.LaunchSpec(code, grid, bd, g0.copy()))
    dg = scheduler.execute(specs, n_sm=2, device="cpu")
    jdg = jrt.execute(jspecs, n_sm=2, cfg=JAX)
    for got, want in zip(dg.to_results(), jdg.to_results()):
        _same(got, want, "batch")
    rep, jrep = dg.report(), jdg.report()
    np.testing.assert_array_equal(rep.per_sm_cycles, jrep.per_sm_cycles)
    # both packages pad the launch count to its bucket (3 launches, 4 rows)
    from repro_torch.runtime import registry as reg
    width = reg.bucket_gmem_len(max(len(s.gmem) for s in specs))
    assert rep.device_gmem_words == jrep.device_gmem_words
    assert jrep.device_gmem_words == jrt.bucket_launches(len(specs)) * width
    assert rep.useful_gmem_words == jrep.useful_gmem_words
    # each launch alone gives the same result as inside the batch
    for spec, got in zip(specs, dg.to_results()):
        alone = scheduler.run_grid(spec.code, spec.grid, spec.block_dim,
                                   spec.gmem.copy(), device="cpu")
        _same(got, alone, "alone")


def _conflict_program():
    """Every block writes its id to word 0, and copies word 0 as it reads
    it into word 1 + id: the last writer in position order must win, and
    a block sees the gmem of its dispatch group's start."""
    p = asm.Program("conflict")
    p.s2r("r0", isa.SR_CTA)
    p.mov("r1", 0)
    p.ldg("r2", "r1", 0)
    p.stg("r1", "r0", 0)
    p.stg("r0", "r2", 1)
    p.exit()
    return p.finish(pad_to=16)


@pytest.mark.parametrize("chunk,n_sm", [(4, 2), (8, 1), (2, 2)])
def test_last_writer_merge_order(chunk, n_sm):
    code = _conflict_program()
    g0 = np.full(16, -7, np.int32)
    specs = [scheduler.LaunchSpec(code, (9, 1), 32, g0.copy()),
             scheduler.LaunchSpec(code, (3, 1), 32, g0.copy() + 1)]
    dg = scheduler.execute(specs, n_sm=n_sm, chunk=chunk, device="cpu")
    jdg = jrt.execute([jrt.LaunchSpec(*s) for s in specs], n_sm=n_sm,
                      chunk=chunk, cfg=JAX)
    for got, want in zip(dg.to_results(), jdg.to_results()):
        _same(got, want, f"chunk={chunk}")
    first = dg.to_results()[0].gmem
    assert first[0] == 8                      # the last block wins
    assert first[1] == -7 and first[9] != -7  # group-start snapshots


def test_gmem_as_tensor_and_module_registry():
    _, code, grid, bd, g0 = _program("transpose")
    a = scheduler.run_grid(code, grid, bd, g0.copy(), device="cpu")
    b = scheduler.run_grid(code, grid, bd, torch.as_tensor(g0), device="cpu")
    _same(a, b, "tensor gmem")
    from repro_torch.runtime import registry as reg
    r = reg.ModuleRegistry(max_modules=1)
    m = r.load(code, "t")
    assert r.load(code) is m and (r.hits, r.misses) == (1, 1)
    assert m.padded_len == reg.bucket_code_len(len(code)) == 96
    r.load(code[:10])
    assert len(r) == 1 and r.load(code) is not m
    with pytest.raises(ValueError, match="empty grid"):
        scheduler.execute([scheduler.LaunchSpec(code, (0, 1), bd, g0)],
                          device="cpu")
    with pytest.raises(ValueError, match="at least one launch"):
        scheduler.execute([], device="cpu")
