"""CPU parity of the port's other dense configurations, llama3.2-3b and
yi-6b, with the JAX package: the qwen3 family without qk-norm, RoPE at
``rope_theta`` 5e5 and 5e6.  They need no model code of their own, so
what is held here is what differs from qwen3: the rotary frequencies and
the attention block without its q/k norms, on the reduced configurations
with the JAX package's weights carried across.  Tolerances as
``tests/test_torch_lm.py``: float32 ``1e-5``, bf16 ``rtol = atol =
2e-2``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi, layers as jL, transformer as jT
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi, layers as tL
from repro_torch.models import transformer as tT

from test_torch_ssm import BF16, F32, assert_state_close, f32, jtree

ARCHS = {"llama3p2_3b": 5e5, "yi_6b": 5e6}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("theta", sorted(ARCHS.values()))
def test_apply_rope_matches(theta, dt):
    """RoPE at the two configurations' ``rope_theta``, positions up to
    5000 (where the low frequencies turn)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 128))
    pos = np.stack([np.arange(7), np.arange(7) + 4993])
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    xj = jnp.asarray(x, jdt)
    xt = torch.from_numpy(f32(xj)).to(tdt)
    want = jL.apply_rope(xj, jnp.asarray(pos, jnp.int32), theta)
    got = tL.apply_rope(xt, torch.as_tensor(pos, dtype=torch.int32), theta)
    assert got.dtype == tdt
    np.testing.assert_allclose(f32(got), f32(want),
                               **(F32 if dt == "f32" else BF16))


@pytest.fixture(scope="module", params=sorted(ARCHS))
def model(request):
    jspec = jconfigs.reduced(jconfigs.get(request.param))
    tspec = tconfigs.reduced(tconfigs.get(request.param))
    jp = japi.init(jax.random.key(0), jspec)
    return jspec, tspec, jp, jtree(jp)


def test_reduced_has_no_qk_norm(model):
    """``reduced()`` keeps ``qk_norm=False`` (so the tree has no q/k norm
    gains) and the JAX reduced config's 10000 rope base."""
    jspec, tspec, jp, tp = model
    assert tspec.cfg.qk_norm is False and "q_norm" not in \
        tp["layers"]["attn"]
    assert tspec.cfg.rope_theta == jspec.cfg.rope_theta
    assert jax.tree.map(lambda a: a.shape, jp) == \
        jax.tree.map(lambda t: tuple(t.shape), tp)


@pytest.mark.parametrize("theta", ["reduced", "published"])
def test_forward_without_qk_norm_matches(model, theta):
    """A reduced forward without qk-norm, at the reduced config's rope
    base and at the full configuration's."""
    jspec, tspec, jp, tp = model
    full = tconfigs.get(tspec.name.replace("-smoke", "")).cfg.rope_theta
    jcfg, tcfg = jspec.cfg, tspec.cfg
    if theta == "published":
        jcfg = dataclasses.replace(jcfg, rope_theta=full)
        tcfg = dataclasses.replace(tcfg, rope_theta=full)
    toks = np.random.default_rng(2).integers(0, 256, (2, 16))
    want = jT.forward(jp, jcfg, jnp.asarray(toks, jnp.int32))
    got = tT.forward(tp, tcfg, torch.as_tensor(toks))
    np.testing.assert_allclose(f32(got), f32(want), **BF16)


def test_prefill_then_decode_match(model):
    """A one-step prefill, then three decode steps with the KV caches
    carried, against JAX ``api.apply_decode`` step for step: logits within
    2e-2 and the caches within 2e-2 per layer."""
    jspec, tspec, jp, tp = model
    B, P = 2, 16
    rng = np.random.default_rng(3)
    jst = japi.decode_state(jspec, B, P + 3)
    tst = jtree(jst)
    for i, toks in enumerate([rng.integers(0, 256, (B, P))] +
                             [rng.integers(0, 256, (B, 1))
                              for _ in range(3)]):
        ci = 0 if i == 0 else P + i - 1
        jl, jst = japi.apply_decode(jp, jspec, jnp.asarray(toks, jnp.int32),
                                    jst, ci)
        tl, tst = tapi.apply_decode(tp, tspec, torch.as_tensor(toks), tst,
                                    ci)
        np.testing.assert_allclose(f32(tl), f32(jl), **BF16,
                                   err_msg=f"step {i}")
        assert_state_close(tst["kv"], jst["kv"], f"kv after step {i}")


@pytest.mark.parametrize("arch", ["llama3.2-3b", "yi-6b", "mamba2-130m",
                                  "zamba2-1.2b"])
def test_serve_cli_reduced_on_cpu(arch):
    """``launch.serve`` of each new architecture at ``--reduced --device
    cpu``: the generated tokens in the vocabulary."""
    gen = tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "16", "--gen", "4"])
    assert gen.shape == (2, 4) and gen.min() >= 0 and gen.max() < 256
