"""CPU parity of the port's AdamW (``repro_torch.optim``) with the JAX
package's, on the reduced qwen3 parameter tree and the same numpy
gradients, in both modes.

Tolerances: the float32 state (m, v or its factored rows and columns)
and the learning rate ``rtol 1e-6`` (largest seen 4.7e-7 relative);
``adamw_lite``'s bf16 m within one bf16 ulp of JAX's (seen 0); the bf16
parameters within one bf16 ulp, taken at the larger of the parameter and
the learning rate (seen 5e-4 of one): an update a float32 rounding apart
moves a parameter by a few ulps of lr, which is many ulps of a parameter
near 0 (one entry of 4.9e-6 is 4 of its own ulps apart).  The step
counter and the int8 codes exactly, the int8 scales ``rtol 1e-6`` (seen
0).

The global norm is a float32 sum of about 90,000 squares, taken in
another order by each framework: at Gaussian gradients JAX's is up to
1.7e-6 from the float64 value, the port's 1.8e-8.  So the port's norm is
held to the float64 value (``rtol 1e-6``) and to JAX's within ``rtol
1e-5``.  Under clipping every gradient is scaled by ``clip / norm``, which
would carry JAX's rounding into the whole state (and, through
``adamw_lite``'s bf16 m, many ulps near 0); the clipped case therefore
uses gradients of small multiples of 2^-4, whose squares every order of
summation adds exactly, so the two norms are equal and the update's own
arithmetic is compared."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.optim import (OptConfig as JOpt, dequantize_grads_int8 as jdq,
                         opt_init as jinit, opt_step as jstep,
                         quantize_grads_int8 as jq)
from repro_torch import tree as T
from repro_torch.models import convert
from repro_torch.optim import (OptConfig, dequantize_grads_int8, opt_init,
                               opt_step, quantize_grads_int8)

STATE = dict(rtol=1e-6, atol=0)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def params():
    spec = jconfigs.reduced(jconfigs.get("qwen3_0p6b"))
    return japi.init(jax.random.key(0), spec)


def _grads(params, seed, kind):
    """"gaussian": N(0, 1e-3^2), global norm about 0.3 (no clipping);
    "exact": integers in [-3, 3] times 2^-4 (2^-2 at seed 1), global norm
    20-80, clipped, its squares summed exactly in float32."""
    rng = np.random.default_rng(seed)
    if kind == "gaussian":
        return jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape) * 1e-3, jnp.bfloat16), params)
    unit = 2.0 ** (-2 if seed == 1 else -4)
    return jax.tree.map(lambda p: jnp.asarray(
        rng.integers(-3, 4, p.shape) * unit, jnp.bfloat16), params)


def _bf16_ulps(got, want, floor=0.0):
    """The largest distance between two bf16 arrays in bf16 ulps of
    ``want``, each ulp taken at ``max(|want|, floor)``."""
    a, b = f32(got), f32(want)
    mag = np.maximum(np.abs(b), floor)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    return float((np.abs(a - b) / ulp).max())


def _exact_norm(g):
    return np.sqrt(sum(np.sum(np.asarray(x, np.float64) ** 2)
                       for x in jax.tree.leaves(g)))


@pytest.mark.parametrize("kind", ["gaussian", "exact"])
@pytest.mark.parametrize("mode", ["adamw", "adamw_lite"])
def test_opt_step_matches_jax(params, mode, kind):
    """Five steps from the same state on the same gradients, with warmup
    3, against JAX's, without clipping ("gaussian") and with it
    ("exact")."""
    kw = dict(lr=1e-2, warmup=3, mode=mode)
    jcfg, tcfg = JOpt(**kw), OptConfig(**kw)
    jp, jo = params, jinit(params, jcfg)
    tp = convert.from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    to = opt_init(tp, tcfg)
    assert T.tree_map(lambda x: (tuple(x.shape), str(x.dtype)[6:]), to) == \
        jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), jo)
    for i in range(5):
        g = _grads(params, i, kind)
        jp, jo, js = jstep(jp, jo, g, jcfg)
        tp, to, ts = opt_step(tp, to, convert.from_numpy(
            jax.tree.map(np.asarray, g), device="cpu"), tcfg)
        assert int(to["step"]) == int(jo["step"]) == i + 1
        assert to["step"].dtype == torch.int32 and to["step"].ndim == 0
        assert (float(js["grad_norm"]) > 1) == (kind == "exact")
        np.testing.assert_allclose(f32(ts["grad_norm"]), _exact_norm(g),
                                   **STATE)
        np.testing.assert_allclose(f32(ts["grad_norm"]),
                                   f32(js["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(f32(ts["lr"]), f32(js["lr"]), **STATE)
        jflat = jax.tree_util.tree_leaves_with_path(jo)
        tflat = T.leaves_with_paths(to)
        assert [tuple(getattr(k, "key", k) for k in p) for p, _ in jflat] \
            == [p for p, _ in tflat]
        for (_, a), (_, b) in zip(jflat, tflat):
            assert str(b.dtype)[6:] == str(a.dtype)
            if b.dtype == torch.bfloat16:       # adamw_lite's m
                assert _bf16_ulps(b, a) <= 1
            else:
                np.testing.assert_allclose(f32(b), f32(a), **STATE)
        for a, b in zip(jax.tree.leaves(jp), T.leaves(tp)):
            assert b.dtype == torch.bfloat16
            assert _bf16_ulps(b, a, floor=kw["lr"]) <= 1


def test_int8_quantization_matches_jax(params):
    g = jax.tree.map(lambda x: x * 3000, _grads(params, 9, "gaussian"))
    jqs, jss = jq(g)
    tqs, tss = quantize_grads_int8(convert.from_numpy(
        jax.tree.map(np.asarray, g), device="cpu"))
    for a, b in zip(jax.tree.leaves(jqs), T.leaves(tqs)):
        assert b.dtype == torch.int8
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(jax.tree.leaves(jss), T.leaves(tss)):
        assert b.ndim == 0
        np.testing.assert_allclose(f32(b), f32(a), **STATE)
    back = dequantize_grads_int8(tqs, tss)
    for a, b, gi in zip(jax.tree.leaves(jdq(jqs, jss)), T.leaves(back),
                        jax.tree.leaves(g)):
        np.testing.assert_allclose(f32(b), f32(a), **STATE)
        # the quantizer's half step bounds the error
        step = float(np.abs(f32(gi)).max()) / 127.0
        assert np.abs(f32(b) - f32(gi)).max() <= step * 0.51 + 1e-12
