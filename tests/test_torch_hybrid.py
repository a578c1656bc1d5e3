"""CPU parity of the port's zamba2 hybrid (mamba2 blocks and one shared
attention block) with the JAX package.

The reduced zamba2-1.2b configuration (4 layers, attention every 2,
d_model 64, 4 heads of 16) and a ragged one (5 layers, attention every 2:
three applications, the last group one layer), the JAX package's random
weights carried across by ``convert.from_numpy``, and numpy inputs
through both.  Tolerances: bf16 logits ``rtol = atol = 2e-2``, as
``tests/test_torch_lm.py``; decode states and KV caches by relative
Frobenius error per layer or application (``test_prefill_then_decode_
match`` gives the bounds); the training loss and gradients as
``tests/test_torch_ssm.py`` (``check_train_parity``).  With both packages
computing in fp32, everything agrees to about 2e-6.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi, hybrid as jH
from repro_torch import configs as tconfigs, tree as T
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import steps as tsteps, train as ttrain
from repro_torch.models import api as tapi, hybrid as tH

from test_torch_ssm import (BF16, assert_state_close, check_train_parity,
                            f32, f32_compute, jtree)

SHAPES = {"reduced": {}, "ragged": {"n_layers": 5}}


def _specs(shape):
    jspec = jconfigs.reduced(jconfigs.get("zamba2_1p2b"))
    tspec = tconfigs.reduced(tconfigs.get("zamba2-1.2b"))
    kw = SHAPES[shape]
    return (dataclasses.replace(jspec, cfg=dataclasses.replace(jspec.cfg,
                                                               **kw)),
            dataclasses.replace(tspec, cfg=dataclasses.replace(tspec.cfg,
                                                               **kw)))


@pytest.fixture(scope="module", params=sorted(SHAPES))
def model(request):
    jspec, tspec = _specs(request.param)
    jp = japi.init(jax.random.key(0), jspec)
    return jspec, tspec, jp, jtree(jp)


def test_ragged_config_has_a_short_last_group():
    jspec, tspec = _specs("ragged")
    assert tspec.cfg.n_layers % tspec.cfg.attn_every != 0
    assert tspec.cfg.n_apps == jspec.cfg.n_apps == 3
    assert tspec.cfg.param_count() == jspec.cfg.param_count()


def test_init_has_the_jax_tree(model):
    """``api.init`` and ``param_shapes`` (``meta``) have the JAX tree's
    shapes and dtypes, the shared block unstacked."""
    jspec, tspec, jp, _ = model
    tp = tapi.init(torch.Generator().manual_seed(0), tspec)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
    for tree, dev in ((tp, "cpu"), (tapi.param_shapes(tspec), "meta")):
        got = T.tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), tree)
        assert got == want
        assert {t.device.type for t in T.leaves(tree)} == {dev}
    assert tp["shared"]["attn"]["wq"].shape == (64, 64)


def test_forward_matches(model):
    jspec, tspec, jp, tp = model
    toks = np.random.default_rng(1).integers(0, 256, (2, 16))
    want = jH.forward(jp, jspec.cfg, jnp.asarray(toks, jnp.int32))
    got = tH.forward(tp, tspec.cfg, torch.as_tensor(toks))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(f32(got), f32(want), **BF16)


def _mid_state(jspec, B, T_, seed):
    """A mid-sequence decode state, in the dtypes of
    ``api.decode_state``: random conv tails, SSM states and the first
    ``seed % 5 + 3`` KV entries of every application."""
    rng = np.random.default_rng(seed)
    st = japi.decode_state(jspec, B, T_)
    n = seed % 5 + 3
    kv = tuple(jnp.asarray(np.concatenate(
        [rng.standard_normal(c.shape[:2] + (n,) + c.shape[3:]),
         np.zeros(c.shape[:2] + (c.shape[2] - n,) + c.shape[3:])], 2),
        c.dtype) for c in st["kv"])
    conv = st["ssm"]["conv"]
    ssm = {"conv": jnp.asarray(rng.standard_normal(conv.shape), conv.dtype),
           "ssm": jnp.asarray(rng.standard_normal(st["ssm"]["ssm"].shape)
                              * 0.3, jnp.float32)}
    return {"ssm": ssm, "kv": kv}, n


@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("mid_sequence", [False, True])
def test_prefill_then_decode_match(model, mid_sequence, compute,
                                   monkeypatch):
    """A one-step prefill of (B, P) tokens at cache index 0 (the port's
    prefill: its attention goes through the flash wrapper, once an
    application), then decode steps with the states and caches carried,
    against JAX ``api.apply_decode`` on the same tokens; or, from a
    mid-sequence state carried across, decode steps only.

    ``"f32"`` (both packages computing in fp32): logits within ``rtol =
    atol = 1e-4``, states and caches within 1e-4 per layer (measured 2e-6).
    ``"bf16"``: logits within 2e-2; states and caches within 5e-2 per
    layer, since JAX's own bf16 SSM states lie up to 4.0% from its fp32
    ones after the prefill (the port's 3.3%, and 3.3% from JAX's)."""
    calls = []
    real = tfa.flash_attention_gqa
    monkeypatch.setattr(tfa, "flash_attention_gqa",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    jspec, tspec, jp, tp = model
    if compute == "f32":
        jp, tp = f32_compute(monkeypatch, jp)
    logit_tol, state_tol = ((1e-4, 1e-4) if compute == "f32" else
                            (2e-2, 5e-2))
    B, P, T_ = 2, 16, 24
    rng = np.random.default_rng(2)
    if mid_sequence:
        jst, start = _mid_state(jspec, B, T_, 3)
        steps = [rng.integers(0, 256, (B, 1)) for _ in range(5)]
    else:
        jst, start = japi.decode_state(jspec, B, T_), 0
        steps = [rng.integers(0, 256, (B, P))] + \
            [rng.integers(0, 256, (B, 1)) for _ in range(4)]
    tst = jtree(jst)
    ci = start
    for i, toks in enumerate(steps):
        jl, jst = japi.apply_decode(jp, jspec, jnp.asarray(toks, jnp.int32),
                                    jst, ci)
        tl, tst = tapi.apply_decode(tp, tspec, torch.as_tensor(toks), tst,
                                    ci)
        ci += toks.shape[1]
        np.testing.assert_allclose(f32(tl), f32(jl), rtol=logit_tol,
                                   atol=logit_tol, err_msg=f"step {i}")
        assert_state_close(tst["ssm"], jst["ssm"], f"ssm after step {i}",
                           state_tol)
        assert_state_close(tst["kv"], jst["kv"], f"kv after step {i}",
                           state_tol)
    assert len(calls) == (0 if mid_sequence else tspec.cfg.n_apps)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (2, 32))
    labels = rng.integers(0, 256, (2, 32))
    labels[1, :3] = -1
    return ({"tokens": jnp.asarray(toks, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32)},
            {"tokens": torch.as_tensor(toks),
             "labels": torch.as_tensor(labels)})


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_apply_train_loss_and_every_gradient_match(model, compute):
    """``api.apply_train`` and its gradient against JAX's, every leaf, the
    shared block's included (``test_torch_ssm.check_train_parity``)."""
    jspec, tspec, jp, tp = model
    check_train_parity(jspec, tspec, jp, tp, _batch(), compute)


def test_flash_once_an_application_and_shared_outside_remat(monkeypatch):
    """One training step calls the flash forward once and the flash
    backward once an application (the shared block runs outside the remat,
    so its attention is not recomputed); the mamba blocks run under
    ``"dots"``."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tfa.FlashAttention.forward, tfa.flash_attention_bwd

    def counted_fwd(*a):
        calls["fwd"] += 1
        return fwd(*a)

    def counted_bwd(*a, **kw):
        calls["bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(tfa.FlashAttention, "forward",
                        staticmethod(counted_fwd))
    monkeypatch.setattr(tfa, "flash_attention_bwd", counted_bwd)
    _, tspec = _specs("ragged")
    assert tspec.cfg.remat == "dots"
    params = tapi.init(torch.Generator().manual_seed(0), tspec)
    _, tb = _batch(1)
    _, grads = tsteps.build_loss_and_grads(tspec)(params, tb)
    n = tspec.cfg.n_apps
    assert calls == {"fwd": n, "bwd": n}
    norms = tsteps.grad_norms(grads)
    for path, leaf in T.leaves_with_paths(norms):
        want = (tspec.cfg.n_layers,) if path[0] == "layers" else ()
        assert leaf.shape == want and (leaf > 0).all(), path


ARGS = ["--arch", "zamba2-1.2b", "--reduced", "--device", "cpu",
        "--steps", "8", "--seq", "32", "--batch", "4", "--log-every", "1"]


def test_train_cli_and_bit_exact_resume(tmp_path, capsys):
    """The train CLI at ``--reduced --device cpu``: finite losses and
    gradient norms; a run that dies at step 5 and resumes from the
    checkpoint of step 4 (the shared block's tree included) ends with the
    uninterrupted run's parameters, bit for bit."""
    pa = ttrain.main(ARGS)
    out = capsys.readouterr().out
    stats = re.findall(r"^step +\d+ loss +(\S+) gnorm +(\S+)", out, re.M)
    assert len(stats) == 8 and np.isfinite(np.float64(stats)).all()
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"]
    with pytest.raises(SystemExit) as died:
        ttrain.main(ARGS + ck + ["--die-at", "5"])
    assert died.value.code == 42
    pb = ttrain.main(ARGS + ck + ["--restore", "auto"])
    assert "[restore] resumed from step 4" in capsys.readouterr().out
    assert "shared" in pb
    for (path, a), (_, b) in zip(T.leaves_with_paths(pa),
                                 T.leaves_with_paths(pb)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b), path
