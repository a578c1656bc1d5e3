"""Architectural state of the port against the JAX package: the same
``MachineConfig`` fields and defaults, configurations and mid-run states
that cross over losslessly, and the lane-mask packing (lane 31 is the
sign bit of the port's int32 bit patterns)."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import isa as jisa
from repro.core import pipeline as jp
from repro.core.programs import ALL as JALL
from repro_torch.core import isa
from repro_torch.core import pipeline as tp
from repro_torch.core.pipeline import state as ts


def _jax_state_dict(st):
    d = {k: np.asarray(v) for k, v in st._asdict().items() if k != "counters"}
    d.update({k: np.asarray(v) for k, v in st.counters._asdict().items()})
    return d


def test_config_fields_and_defaults_match_reference():
    jf = {f.name: f.default for f in dataclasses.fields(jp.MachineConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tp.MachineConfig)}
    assert set(tf) == set(jf) - {"pallas_interpret"}
    for name, default in tf.items():
        if name != "execute_backend":
            assert default == jf[name], name
    assert tf["execute_backend"] == "cuda_fused"
    for n_sp in (8, 16, 32):
        assert tp.MachineConfig(n_sp=n_sp).rows_per_warp == \
            jp.MachineConfig(n_sp=n_sp).rows_per_warp


@pytest.mark.parametrize("backend,expect", [("jnp", "torch"),
                                            ("pallas", "cuda"),
                                            ("pallas_fused", "cuda_fused")])
def test_config_from_reference(backend, expect):
    jcfg = jp.MachineConfig(n_sp=32, warp_stack_depth=2, enable_mul=False,
                            num_read_operands=2, execute_backend=backend)
    cfg = ts.config_from_reference(dataclasses.asdict(jcfg))
    assert cfg.execute_backend == expect
    back = {k: v for k, v in dataclasses.asdict(jcfg).items()
            if k not in ("pallas_interpret", "execute_backend")}
    assert {k: v for k, v in dataclasses.asdict(cfg).items()
            if k != "execute_backend"} == back


def test_reference_backend_not_yet_ported():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tp.MachineConfig(execute_backend="reference")
    with pytest.raises(ValueError):
        tp.MachineConfig(execute_backend="jnp")


@pytest.mark.parametrize("block_dim", [1, 40, 64, 256])
def test_init_state_matches_reference(block_dim):
    W = -(-block_dim // 32) + 1           # one warp of padding
    gmem = np.arange(50, dtype=np.int32)
    jst = jp.init_state(jp.MachineConfig(), W, block_dim, jnp.asarray(gmem))
    tst = tp.init_state(tp.MachineConfig(), W, block_dim,
                        torch.as_tensor(gmem))
    want, got = _jax_state_dict(jst), ts.state_to_numpy(tst)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(
            got[k], want[k].view(np.int32) if want[k].dtype == np.uint32
            else want[k], err_msg=k)


def test_state_round_trip_mid_run():
    """A JAX state after a few steps crosses over and back unchanged,
    uint32 stack masks as int32 bit patterns."""
    mod = JALL["autocorr"]
    n = 32
    code = jnp.asarray(mod.build(n))
    g0 = mod.make_gmem(np.random.default_rng(0), n)
    grid, bd = mod.launch(n)
    cfg = jp.MachineConfig()
    st = jp.init_state(cfg, 1, bd[0], jnp.asarray(g0))
    step = jax.jit(partial(jp.sm_step, cfg))
    geo = [jnp.asarray(v, jnp.int32) for v in ((bd[0], 1), (0, 0), grid)]
    for _ in range(25):
        st = step(code, jnp.asarray(jisa.COND_LUT), *geo, st)
    d = _jax_state_dict(st)
    assert d["stack_mask"].dtype == np.uint32
    tst = ts.state_from_numpy(d, "cpu")
    assert tst.stack_mask.dtype == torch.int32
    back = ts.state_to_numpy(tst)
    for k, v in d.items():
        np.testing.assert_array_equal(
            back[k], v.view(np.int32) if v.dtype == np.uint32 else v,
            err_msg=k)
    again = ts.state_to_numpy(ts.state_from_numpy(back, "cpu"))
    for k in back:
        np.testing.assert_array_equal(again[k], back[k], err_msg=k)


@pytest.mark.parametrize("lanes", [[31], [0], [0, 31], list(range(32)),
                                   [], [5, 17, 30]])
def test_pack_unpack_lane31(lanes):
    m = np.zeros((2, 32), bool)
    m[0, lanes] = True
    packed = ts._pack(torch.as_tensor(m))
    assert packed.dtype == torch.int32
    want = np.asarray(jp._pack(jnp.asarray(m))).view(np.int32)
    np.testing.assert_array_equal(packed.numpy(), want)
    assert (packed[0].item() < 0) == (31 in lanes)
    np.testing.assert_array_equal(ts._unpack(packed).numpy(), m)
    np.testing.assert_array_equal(
        ts._unpack(packed).numpy(),
        np.asarray(jp._unpack(jnp.asarray(want.view(np.uint32)))))


def test_wrap32_and_index_semantics():
    from repro_torch.kernels.ref import wrap32
    x = torch.tensor([2 ** 31, 2 ** 32 + 5, -2 ** 31 - 1, -1],
                     dtype=torch.int64)
    assert wrap32(x).tolist() == [-2 ** 31, 5, 2 ** 31 - 1, -1]
    i = torch.tensor([-7, -1, 0, 4, 5, 9])
    assert ts.clamp_index(i, 5).tolist() == [0, 4, 0, 4, 4, 4]
    idx, ok = ts.drop_index(i, 5)
    assert ok.tolist() == [False, True, True, True, False, False]
    assert idx[ok].tolist() == [4, 0, 4]
    assert isa.NUM_OPCODES == jisa.NUM_OPCODES
