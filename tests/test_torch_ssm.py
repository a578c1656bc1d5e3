"""CPU parity of the port's mamba2 (the ssm family) with the JAX package.

The reduced mamba2-130m configuration (2 layers, d_model 64, d_state 16,
head_dim 16, chunk 8) with the JAX package's random weights carried
across by ``convert.from_numpy``; inputs from numpy seeds go through
both.  Tolerances: the SSD's float32 pieces (``_segsum``,
``ssd_chunked``) ``1e-5``; bf16 activations and logits ``rtol = atol =
2e-2``, as ``tests/test_torch_lm.py``; decode states (conv tails, SSM
states) after serving steps a relative Frobenius error of at most 2e-2
per layer, as that file holds KV caches (a bf16 rounding of the residual
that differs moves single conv-tail entries past 2e-2); the training loss
``rtol 1e-3`` and every gradient leaf ``rtol 5e-2, atol 5e-3``, as
``tests/test_torch_train_loss.py``, with fp32 activations in both
packages; in bf16 each leaf within 0.25 of the fp32 gradient's norm
(``check_train_parity`` says why).
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi, layers as jL, mamba2 as jM
from repro_torch import configs as tconfigs, tree as T
from repro_torch.launch import steps as tsteps, train as ttrain
from repro_torch.models import api as tapi, convert, layers as tL
from repro_torch.models import mamba2 as tM

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
GRAD = dict(rtol=5e-2, atol=5e-3)


def f32(x):
    """A JAX array or a torch tensor as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def both(a, dt=jnp.bfloat16):
    """One numpy array as a JAX array and a torch tensor of one dtype."""
    j = jnp.asarray(a, dt)
    t = torch.from_numpy(f32(j))
    return j, t.bfloat16() if dt == jnp.bfloat16 else t


def jtree(tree):
    return convert.from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def assert_trees_close(got, want, tol, what=""):
    wl = jax.tree_util.tree_leaves_with_path(want)
    gl = T.leaves_with_paths(got)
    assert [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p)
            for p, _ in wl] == [p for p, _ in gl], what
    for (path, w), (_, g) in zip(wl, gl):
        assert tuple(g.shape) == w.shape, (what, path)
        np.testing.assert_allclose(f32(g), f32(w), **tol,
                                   err_msg=f"{what} {path}")


def assert_state_close(got, want, what="", tol=2e-2):
    """Every leaf of a decode state within a relative Frobenius error of
    ``tol`` per layer (its leading axis)."""
    wl = jax.tree_util.tree_leaves_with_path(want)
    gl = T.leaves_with_paths(got)
    assert len(wl) == len(gl), what
    for (path, w), (_, g) in zip(wl, gl):
        a, b = f32(g), f32(w)
        assert a.shape == b.shape and g.dtype == TDT[str(w.dtype)], path
        for layer in range(b.shape[0]):
            err = np.linalg.norm(a[layer] - b[layer])
            assert err <= tol * np.linalg.norm(b[layer]), \
                (what, path, layer, err / np.linalg.norm(b[layer]))


TDT = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@pytest.fixture(scope="module")
def model():
    jspec = jconfigs.reduced(jconfigs.get("mamba2_130m"))
    tspec = tconfigs.reduced(tconfigs.get("mamba2-130m"))
    jp = japi.init(jax.random.key(0), jspec)
    return jspec, tspec, jp, jtree(jp)


ARCHS = {"llama3p2_3b": 3212749824, "yi_6b": 5798891520,
         "mamba2_130m": 128958336, "zamba2_1p2b": 1104852736}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_configs_match_jax(arch):
    """The four specs and their ``reduced()`` equal the JAX package's;
    ``param_count()`` as published in the configs' sizes."""
    js, ts = jconfigs.get(arch), tconfigs.get(arch)
    assert type(ts.cfg).__module__.startswith("repro_torch.")
    assert (ts.name, ts.family, ts.skips, ts.source) == \
        (js.name, js.family, js.skips, js.source)
    assert dataclasses.asdict(ts.cfg) == dataclasses.asdict(js.cfg)
    assert ts.cfg.param_count() == js.cfg.param_count() == ARCHS[arch]
    jr, tr = jconfigs.reduced(js), tconfigs.reduced(ts)
    assert dataclasses.asdict(tr.cfg) == dataclasses.asdict(jr.cfg)
    assert tr.cfg.param_count() == jr.cfg.param_count()
    if ts.family == "hybrid":
        assert ts.cfg.n_apps == js.cfg.n_apps == 7
        assert dataclasses.asdict(ts.cfg.mamba) == \
            dataclasses.asdict(js.cfg.mamba)
        assert ts.cfg.attn.__dict__ == js.cfg.attn.__dict__


def test_init_has_the_jax_tree(model):
    """Shapes and dtypes of ``api.init`` and ``param_shapes`` (``meta``)
    are the JAX tree's; ``A_log``, ``dt_bias``, ``D_skip`` fp32."""
    jspec, tspec, jp, _ = model
    tp = tapi.init(torch.Generator().manual_seed(0), tspec)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
    for tree, dev in ((tp, "cpu"), (tapi.param_shapes(tspec), "meta")):
        got = T.tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), tree)
        assert got == want
        assert {t.device.type for t in T.leaves(tree)} == {dev}
    assert tp["layers"]["A_log"].dtype == torch.float32


def test_segsum_matches():
    rng = np.random.default_rng(1)
    la = -np.abs(rng.standard_normal((2, 3, 8))).astype(np.float32)
    want = jM._segsum(jnp.asarray(la))
    got = tM._segsum(torch.from_numpy(la))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert np.isneginf(got.numpy()[..., 0, 1]).all()


def _ssd_inputs(seed, Bt=2, S=32, H=4, P=8, G=2, N=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bt, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bt, S, H)))).astype(np.float32)
    A = (rng.standard_normal(H) * 0.5).astype(np.float32)
    B = rng.standard_normal((Bt, S, G, N)).astype(np.float32)
    C = rng.standard_normal((Bt, S, G, N)).astype(np.float32)
    h0 = rng.standard_normal((Bt, H, P, N)).astype(np.float32)
    return x, dt, A, B, C, h0


@pytest.mark.parametrize("S", [32, 6])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches(S, with_h0):
    """fp32 inputs, G = 2 groups under H = 4 heads; S = 32 is four chunks
    of 8 (the inter-chunk recurrence), S = 6 one chunk shorter than 8."""
    x, dt, A, B, C, h0 = _ssd_inputs(2, S=S)
    cfg = tconfigs.reduced(tconfigs.get("mamba2-130m")).cfg
    jcfg = jconfigs.reduced(jconfigs.get("mamba2_130m")).cfg
    args = (x, dt, A, B, C)
    jy, jh = jM.ssd_chunked(*map(jnp.asarray, args), jcfg,
                            h0=jnp.asarray(h0) if with_h0 else None)
    ty, th = tM.ssd_chunked(*map(torch.from_numpy, args), cfg,
                            h0=torch.from_numpy(h0) if with_h0 else None)
    assert ty.dtype == th.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **F32)


def test_ssd_sequence_off_the_chunk_raises_in_both():
    """S = 12 is longer than the chunk (8) and not a multiple of it: the
    JAX reshape fails, and the port raises rather than pad."""
    x, dt, A, B, C, _ = _ssd_inputs(3, S=12)
    jcfg = jconfigs.reduced(jconfigs.get("mamba2_130m")).cfg
    cfg = tconfigs.reduced(tconfigs.get("mamba2-130m")).cfg
    with pytest.raises((TypeError, ValueError)):
        jM.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), jcfg)
    with pytest.raises(ValueError, match="not a multiple"):
        tM.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, C)), cfg)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches(with_state):
    rng = np.random.default_rng(4)
    xj, xt = both(rng.standard_normal((2, 5, 24)))
    wj, wt = both(rng.standard_normal((4, 24)) * 0.5)
    sj, st = both(rng.standard_normal((2, 3, 24)))
    jy, js = jM._causal_conv(xj, wj, sj if with_state else None)
    ty, ts = tM._causal_conv(xt, wt, st if with_state else None)
    assert ty.dtype == ts.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(ty), f32(jy), **BF16)
    np.testing.assert_array_equal(f32(ts), f32(js))


def test_softplus_is_jax_softplus():
    x = np.array([-30, -3, 0, 0.5, 19, 20.5, 40, 90], np.float32)
    np.testing.assert_array_equal(tM.softplus(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.nn.softplus(x)))


def _state(jspec, B, seed):
    """A mid-sequence decode state: random conv tails (bf16) and SSM
    states (fp32) of every layer."""
    rng = np.random.default_rng(seed)
    st = japi.decode_state(jspec, B, 16)["ssm"]
    return {"conv": jnp.asarray(rng.standard_normal(st["conv"].shape),
                                jnp.bfloat16),
            "ssm": jnp.asarray(rng.standard_normal(st["ssm"].shape) * 0.3,
                               jnp.float32)}


@pytest.mark.parametrize("with_state", [False, True])
def test_block_apply_matches(model, with_state):
    jspec, tspec, jp, tp = model
    rng = np.random.default_rng(5)
    xj, xt = both(rng.standard_normal((2, 16, 64)))
    jlp = jax.tree.map(lambda a: a[1], jp["layers"])
    tlp = tM.layer_params(tp["layers"], 1)
    jst = jax.tree.map(lambda a: a[1], _state(jspec, 2, 6)) \
        if with_state else None
    jo, jns = jM.block_apply(jlp, jspec.cfg, xj, state=jst)
    to, tns = tM.block_apply(tlp, tspec.cfg, xt,
                             state=jtree(jst) if with_state else None)
    np.testing.assert_allclose(f32(to), f32(jo), **BF16)
    if with_state:
        assert_trees_close(tns, jns, BF16, "new state")


def test_forward_matches(model):
    jspec, tspec, jp, tp = model
    toks = np.random.default_rng(7).integers(0, 256, (2, 16))
    want = jM.forward(jp, jspec.cfg, jnp.asarray(toks, jnp.int32))
    got = tM.forward(tp, tspec.cfg, torch.as_tensor(toks))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(f32(got), f32(want), **BF16)


@pytest.mark.parametrize("mid_sequence", [False, True])
def test_prefill_then_decode_match(model, mid_sequence):
    """A one-step prefill of (B, P) tokens, then decode steps with the
    states carried, against JAX ``api.apply_decode`` on the same tokens:
    logits every step and the states after each; from zero states or from
    a mid-sequence state carried across."""
    jspec, tspec, jp, tp = model
    B, P = 2, 16
    rng = np.random.default_rng(8)
    prompt = rng.integers(0, 256, (B, P))
    jst = {"ssm": _state(jspec, B, 9)} if mid_sequence else \
        japi.decode_state(jspec, B, P + 4)
    tst = jtree(jst)
    for i, toks in enumerate([prompt] + [rng.integers(0, 256, (B, 1))
                                         for _ in range(4)]):
        ci = 0 if i == 0 else P + i - 1
        jl, jst = japi.apply_decode(jp, jspec, jnp.asarray(toks, jnp.int32),
                                    jst, ci)
        tl, tst = tapi.apply_decode(tp, tspec, torch.as_tensor(toks), tst,
                                    ci)
        np.testing.assert_allclose(f32(tl), f32(jl), **BF16,
                                   err_msg=f"step {i}")
        assert_state_close(tst, jst, f"state after step {i}")


def test_chunked_prefill_equals_stepwise(model):
    """The port's own duality (``tests/test_models.py::
    test_mamba2_chunked_equals_stepwise``): a train-mode forward of 16
    tokens (two chunks) against 16 decode steps, rtol = atol = 3e-2."""
    _, tspec, _, tp = model
    toks = torch.as_tensor(np.random.default_rng(10).integers(0, 256,
                                                              (1, 16)))
    full = tM.forward(tp, tspec.cfg, toks)
    state = tapi.decode_state(tspec, 1, 16, device="cpu")
    outs = []
    for i in range(16):
        lg, state = tapi.apply_decode(tp, tspec, toks[:, i:i + 1], state, i)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(f32(full), f32(torch.stack(outs, 1)),
                               rtol=3e-2, atol=3e-2)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (2, 32))
    labels = rng.integers(0, 256, (2, 32))
    labels[0, :5] = -1
    return ({"tokens": jnp.asarray(toks, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32)},
            {"tokens": torch.as_tensor(toks),
             "labels": torch.as_tensor(labels)})


def f32_compute(mp, jp):
    """Both packages computing in fp32 (``COMPUTE_DTYPE`` patched through
    ``mp``, a ``MonkeyPatch``): the JAX parameters upcast, and the same
    values for the port."""
    mp.setattr(jL, "COMPUTE_DTYPE", jnp.float32)
    mp.setattr(tL, "COMPUTE_DTYPE", torch.float32)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jp, jtree(jp)


def check_train_parity(jspec, tspec, jp, tp, batches, compute):
    """``api.apply_train`` and its gradient against
    ``jax.value_and_grad(api.apply_train)``: the loss within 1e-3, and
    every gradient leaf in its parameter's dtype, non-zero, and

    * ``"f32"`` (both packages computing in fp32): within ``rtol 5e-2,
      atol 5e-3`` elementwise of JAX's;
    * ``"bf16"`` (the models as they run): within a relative Frobenius
      error of 0.25 of the fp32 gradient.  At these sizes the bf16
      gradients of both packages lie 2-20% from the fp32 one, by a margin
      that changes with the batch: over five batches of the reduced and
      the ragged hybrid, JAX's own up to 15.2% (its embedding entry at
      4.4x the elementwise tolerance from its fp32 one), the port's up to
      19.7%, each the farther of the two on some batches.  An elementwise
      bound against JAX's bf16 gradient would test that rounding noise.
    """
    jb, tb = batches
    if compute == "f32":
        with pytest.MonkeyPatch.context() as mp:
            jp, tp = f32_compute(mp, jp)
            want, wg = jax.value_and_grad(japi.apply_train)(jp, jspec, jb)
            got, tg = tsteps.build_loss_and_grads(tspec)(tp, tb)
        truth = None
    else:
        want, wg = jax.value_and_grad(japi.apply_train)(jp, jspec, jb)
        got, tg = tsteps.build_loss_and_grads(tspec)(tp, tb)
        with pytest.MonkeyPatch.context() as mp:
            jp32, _ = f32_compute(mp, jp)
            truth = jax.grad(japi.apply_train)(jp32, jspec, jb)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-3)
    wl = jax.tree_util.tree_leaves_with_path(wg)
    gl = T.leaves_with_paths(tg)
    assert [tuple(k.key for k in p) for p, _ in wl] == [p for p, _ in gl]
    tl = [None] * len(wl) if truth is None else jax.tree.leaves(truth)
    for (path, w), (_, g), p, t in zip(wl, gl, T.leaves(tp), tl):
        assert g.dtype == p.dtype and tuple(g.shape) == w.shape, path
        a, b = f32(g), f32(w)
        assert np.linalg.norm(a) > 0, path
        if t is None:
            np.testing.assert_allclose(a, b, **GRAD, err_msg=str(path))
        else:
            t = f32(t)
            assert np.linalg.norm(a - t) <= 0.25 * np.linalg.norm(t), path


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_apply_train_loss_and_every_gradient_match(model, compute):
    """``api.apply_train`` and its gradient (through the ``"dots"`` remat)
    against JAX's, every leaf (:func:`check_train_parity`; in fp32 the
    two agree to 2e-6 of each leaf's norm)."""
    jspec, tspec, jp, tp = model
    check_train_parity(jspec, tspec, jp, tp, _batch(), compute)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_remat_variants_same_gradients(model, remat):
    _, tspec, _, tp = model
    _, tb = _batch(1)
    l0, g0 = tsteps.build_loss_and_grads(tspec)(tp, tb)
    other = dataclasses.replace(tspec, cfg=dataclasses.replace(
        tspec.cfg, remat=remat))
    l1, g1 = tsteps.build_loss_and_grads(other)(tp, tb)
    assert float(l1) == float(l0)
    for a, b in zip(T.leaves(g1), T.leaves(g0)):
        assert torch.equal(a, b)


ARGS = ["--arch", "mamba2-130m", "--reduced", "--device", "cpu",
        "--steps", "8", "--seq", "32", "--batch", "4", "--log-every", "1"]


def test_train_cli_and_bit_exact_resume(tmp_path, capsys):
    """The train CLI at ``--reduced --device cpu``: finite losses and
    gradient norms; a run that dies at step 5 and resumes from the
    checkpoint of step 4 ends with the uninterrupted run's parameters, bit
    for bit."""
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
    for (path, a), (_, b) in zip(T.leaves_with_paths(pa),
                                 T.leaves_with_paths(pb)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b), path


def test_grad_norms_per_layer(model):
    """``steps.grad_norms``: a vector over the layers for every stacked
    leaf, a 0-d norm for the embedding and the final norm."""
    _, tspec, _, tp = model
    _, tb = _batch(2)
    _, g = tsteps.build_loss_and_grads(tspec)(tp, tb)
    norms = tsteps.grad_norms(g)
    assert norms["embed"].shape == norms["final_norm"].shape == ()
    for leaf in T.leaves(norms["layers"]):
        assert leaf.shape == (tspec.cfg.n_layers,) and (leaf > 0).all()
