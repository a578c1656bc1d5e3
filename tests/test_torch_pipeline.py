"""The port's SM pipeline against the JAX package, bit for bit: one
``sm_step`` from a mid-run state carried across, and a binary whose register,
predicate, condition, opcode and branch fields leave their ranges (INT_MIN
fill, clamp and drop semantics).  JAX runs its ``"jnp"`` backend; the port
runs its default ``"cuda_fused"`` backend, whose CPU path is the plain
staged pipeline, and ``"torch"``."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import isa as jisa
from repro.core import pipeline as jp
from repro_torch.core import asm, isa
from repro_torch.core import pipeline as tp
from repro_torch.core.pipeline import state as ts
from repro_torch.core.programs import ALL
from test_torch_parity import (assert_same, jax_block,
                               out_of_range_program, port_block,
                               random_branchy)


def _step_cases():
    rng = np.random.default_rng(7)
    branchy = next(c for c in (random_branchy(rng) for _ in range(20))
                   if (c[:, isa.F_OP] == isa.BAR).any()
                   and (c[:, isa.F_OP] == isa.SSY).sum() >= 2)
    cases = {"branchy": (branchy, 64, (1, 1), np.zeros(64, np.int32))}
    for name in ("autocorr", "matmul", "reduction"):
        mod = ALL[name]
        grid, bd = mod.launch(32)
        cases[name] = (mod.build(32), bd, grid,
                       mod.make_gmem(np.random.default_rng(1), 32))
    return cases


STEP_CASES = _step_cases()


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_one_step_from_carried_state(name):
    """Run JAX to several mid-run states; carry each across and take one
    step in both machines: every state field must agree."""
    code, bd, grid, g0 = STEP_CASES[name]
    bdx, bdy = bd if isinstance(bd, tuple) else (bd, 1)
    W = -(-bdx * bdy // 32)
    jcfg = jp.MachineConfig(execute_backend="jnp")
    cfg = ts.config_from_reference(
        {**jcfg.__dict__, "execute_backend": "pallas_fused"})
    jstep = jax.jit(partial(jp.sm_step, jcfg))
    jgeo = [jnp.asarray(v, jnp.int32) for v in ((bdx, bdy), (0, 0), grid)]
    lut = jnp.asarray(jisa.COND_LUT)
    st = jp.init_state(jcfg, W, bdx * bdy, jnp.asarray(g0))
    jcode = jnp.asarray(code)
    tcode = torch.as_tensor(code)
    tlut = tp.cond_lut("cpu")
    checked = 0
    for k in range(200):
        if k in (0, 3, 17, 41, 90, 160):
            d = {f: np.asarray(v) for f, v in st._asdict().items()
                 if f != "counters"}
            d.update({f: np.asarray(v)
                      for f, v in st.counters._asdict().items()})
            tst = ts.state_from_numpy(d, "cpu")
            got = ts.state_to_numpy(tp.sm_step(
                cfg, tcode, tlut, (bdx, bdy), (0, 0), grid, tst))
            nxt = jstep(jcode, lut, *jgeo, st)
            want = {f: np.asarray(v) for f, v in nxt._asdict().items()
                    if f != "counters"}
            want.update({f: np.asarray(v)
                         for f, v in nxt.counters._asdict().items()})
            for f, v in want.items():
                np.testing.assert_array_equal(
                    got[f], v.view(np.int32) if v.dtype == np.uint32 else v,
                    err_msg=f"{name} step {k}: {f}")
            checked += 1
        if not bool(jnp.any(st.wstate != jp.FINISHED)):
            break
        st = jstep(jcode, lut, *jgeo, st)
    assert checked >= 3


@pytest.mark.parametrize("backend", ["cuda_fused", "torch"])
def test_out_of_range_fields_match_reference(backend):
    code = out_of_range_program()
    gmem = np.zeros(16 * 40, np.int32)
    want = jax_block(code, 40, (1, 1), gmem)
    got = port_block(code, 40, (1, 1), gmem, backend)
    assert_same(want, got, backend)
    out = got[0].reshape(40, 16)
    assert (out[:, 3] == ts.INT32_MIN).all()      # the fill is observable
    assert (out[:, 15] == 77).all()


def test_barrier_smem_exchange():
    p = asm.Program()
    p.s2r("r0", isa.SR_TID)
    p.sts("r0", "r0")
    p.bar()
    p.mov("r2", 63)
    p.isub("r2", "r2", "r0")
    p.lds("r3", "r2")
    p.stg("r0", "r3", 0)
    p.exit()
    code = p.finish(pad_to=16)
    gm, _, _ = port_block(code, 64, (1, 1), np.zeros(64, np.int32))
    np.testing.assert_array_equal(gm, 63 - np.arange(64))
