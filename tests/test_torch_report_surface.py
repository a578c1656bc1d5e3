"""The executor's call and report surface against the JAX package:
``execute(pad_warps=, registry=, shard_sm=True)`` on one device (held to
the JAX package's unsharded path: its sharded path fails on the installed
jax wherever several host devices are forced; the port's sharded path is
in ``tests/test_torch_sharding.py``), the four
``MultiSMReport`` properties (``kernel_cycles``, ``busy_cycles``,
``padded_gmem_words``, ``occupancy``), ``device_gmem_words`` with the
launch count padded to its bucket, and ``DeviceGrid.to_results(host_gmem=
False)``."""
import functools

import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.core.machine import MachineConfig as JaxConfig
from repro_torch.core import scheduler
from repro_torch.core.programs import ALL
from repro_torch.runtime import executor
from repro_torch.runtime import registry as reg

FIELDS = ("gmem", "cycles_per_block", "op_issues", "op_lanes", "stack_ops",
          "max_sp", "overflow")
REPORT = ("n_sm", "n_steps", "n_blocks", "device_gmem_words",
          "useful_gmem_words", "max_sp", "overflow", "kernel_cycles",
          "busy_cycles", "padded_gmem_words", "occupancy")
JAX = JaxConfig(execute_backend="jnp")
#: launch mixes: L = 1, 3 and 5 launches (buckets 1, 4 and 8); matmul,
#: the slowest on the CPU, is left to the other parity tests
MIXES = {"one": ("transpose",),
         "three": ("autocorr", "transpose", "bitonic"),
         "five": ("autocorr", "bitonic", "reduction", "transpose",
                  "transpose")}


def _specs(names, n=32):
    out = []
    for i, name in enumerate(names):
        mod = ALL[name]
        out.append((mod.build(n), *mod.launch(n),
                    mod.make_gmem(np.random.default_rng(20 + i), n)))
    return out


@functools.lru_cache(maxsize=None)
def _jax(mix, n_sm, pad_warps):
    dg = jrt.execute([jrt.LaunchSpec(*s) for s in _specs(MIXES[mix])],
                     n_sm=n_sm, cfg=JAX, pad_warps=pad_warps)
    return dg.to_results(), dg.report()


def _same_report(rep, jrep):
    np.testing.assert_array_equal(rep.per_sm_cycles, jrep.per_sm_cycles)
    for f in REPORT:
        assert getattr(rep, f) == getattr(jrep, f), f


@pytest.mark.parametrize("mix,n_sm,pad_warps", [
    ("one", 1, None), ("one", 2, 12), ("three", 2, None), ("three", 1, 9),
    ("five", 2, None), ("five", 1, 10)])
def test_execute_surface_matches_jax(mix, n_sm, pad_warps):
    jres, jrep = _jax(mix, n_sm, pad_warps)
    r = reg.ModuleRegistry()
    dg = scheduler.execute(
        [scheduler.LaunchSpec(*s) for s in _specs(MIXES[mix])], n_sm=n_sm,
        pad_warps=pad_warps, registry=r, shard_sm=True, device="cpu")
    for got, want in zip(dg.to_results(), jres):
        for f in FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f"{mix}: {f}")
    _same_report(dg.report(), jrep)
    # the registry the caller passed is the one that loaded the binaries
    assert r.misses == len(set(MIXES[mix])) and len(r) == r.misses


@pytest.mark.parametrize("mix", ["three", "five"])
def test_device_gmem_words_pads_the_launch_count(mix):
    """L = 3 and 5 launches allocate 4 and 8 rows, as the JAX package's
    launch bucket; the padding rows stay zero."""
    specs = _specs(MIXES[mix])
    dg = scheduler.execute([scheduler.LaunchSpec(*s) for s in specs],
                           n_sm=2, device="cpu")
    rep, (_, jrep) = dg.report(), _jax(mix, 2, None)
    width = reg.bucket_gmem_len(max(len(s[3]) for s in specs))
    rows = executor.bucket_launches(len(specs))
    assert rows == {3: 4, 5: 8}[len(specs)]
    assert rep.device_gmem_words == jrep.device_gmem_words == rows * width
    assert rep.padded_gmem_words == jrep.padded_gmem_words
    assert not dg._gmems[len(specs):].any()


def test_launch_buckets_match_jax():
    assert executor.LAUNCH_BUCKETS == jrt.LAUNCH_BUCKETS
    for n in range(1, 70):
        assert executor.bucket_launches(n) == jrt.bucket_launches(n)


def test_too_few_pad_warps_raise():
    specs = [scheduler.LaunchSpec(*s) for s in _specs(MIXES["three"])]
    with pytest.raises(ValueError, match="pad_warps=7 < 8 warps"):
        scheduler.execute(specs, pad_warps=7, device="cpu")
    with pytest.raises(ValueError, match="pad_warps=7 < 8 warps"):
        jrt.execute([jrt.LaunchSpec(*s) for s in _specs(MIXES["three"])],
                    pad_warps=7, cfg=JAX)


def test_shard_sm_without_sm_devices_runs_one_device_path(monkeypatch):
    """``shard_sm=True`` with no ``sm_devices`` on the CPU spreads over the
    home device alone: the one-device path runs (no sharded group), bit
    for bit, whatever the card count; the server reports one device."""
    from repro_torch import runtime as rt
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    specs = [scheduler.LaunchSpec(*s) for s in _specs(MIXES["one"])]
    groups = rt.METRICS.counter("shard.dispatch_groups")
    before = groups.value
    dg = scheduler.execute(specs, n_sm=2, shard_sm=True, device="cpu")
    assert groups.value == before
    base = scheduler.execute(specs, n_sm=2, device="cpu")  # shard_sm=False
    assert dg.report().n_blocks == base.report().n_blocks == 4
    np.testing.assert_array_equal(dg.report().per_sm_cycles,
                                  base.report().per_sm_cycles)
    for got, want in zip(dg.to_results(), base.to_results()):
        for f in FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                          np.asarray(getattr(want, f)))
    srv = rt.RuntimeServer(n_sm=2, shard_sm=True, device="cpu")
    assert srv.shard_sm and srv.n_devices == 1


def test_to_results_host_gmem_false_keeps_tensors():
    specs = [scheduler.LaunchSpec(*s) for s in _specs(MIXES["three"])]
    dg = scheduler.execute(specs, n_sm=2, device="cpu")
    host, dev = dg.to_results(), dg.to_results(host_gmem=False)
    assert dg.to_results() is host
    assert dg.to_results(host_gmem=False) is dev
    assert len(host) == len(dev) == 3
    for h, d, s in zip(host, dev, specs):
        assert isinstance(h.gmem, np.ndarray)
        assert isinstance(d.gmem, torch.Tensor) and d.gmem.dtype == \
            torch.int32 and d.gmem.shape == (len(s.gmem),)
        np.testing.assert_array_equal(d.gmem.numpy(), h.gmem)
        for f in FIELDS[1:]:
            np.testing.assert_array_equal(np.asarray(getattr(d, f)),
                                          np.asarray(getattr(h, f)))


def test_run_grid_passes_pad_warps_and_registry():
    code, grid, bd, g0 = _specs(("autocorr",))[0]
    r = reg.ModuleRegistry()
    got = scheduler.run_grid(code, grid, bd, g0.copy(), pad_warps=4,
                             registry=r, device="cpu")
    want = scheduler.run_grid(code, grid, bd, g0.copy(), device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)))
    assert r.misses == 1
    with pytest.raises(ValueError, match="pad_warps"):
        scheduler.run_grid(code, (1, 1), 64, g0.copy(), pad_warps=1,
                           device="cpu")
