"""CPU parity of the port's training loss and gradients with the JAX
package.

The reduced qwen3 and smollm configurations (2 layers, d_model 64,
head_dim 16, vocabulary 256), the JAX package's random weights carried
across by ``convert.from_numpy``, and one numpy batch (seq 64, batch 2)
through both.  Tolerances: float32 values ``rtol = atol = 1e-5``, a
scalar loss ``rtol 1e-3``, gradients ``rtol 5e-2, atol 5e-3`` (as
``tests/test_perf_variants.py`` holds the remat variants; both frameworks
keep bf16 gradients for bf16 parameters and round them at other places).
Largest errors seen: the cross-entropies 4.8e-7 (0.006 of the float32
tolerance); ``chunked_attention`` 7.6e-6 (0.20 of it); the training loss
2.7e-5 relative; a gradient leaf 0.37 of its tolerance (qwen3's tied
embedding; 3.4e-3 absolute in smollm's); the ``none`` and ``full`` remat
gradients equal ``dots``' exactly; ``accum`` and ``loss_chunk`` 0.07 of
the gradient tolerance."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi, layers as jL
from repro_torch import configs as tconfigs, tree as T
from repro_torch.launch.steps import build_loss_and_grads
from repro_torch.models import api as tapi, convert, layers as tL

F32 = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=5e-2, atol=5e-3)
ARCHS = {"qwen3": ("qwen3_0p6b", "qwen3-0.6b"),
         "smollm": ("smollm_360m", "smollm-360m")}


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module", params=sorted(ARCHS))
def model(request):
    jname, tname = ARCHS[request.param]
    jspec = jconfigs.reduced(jconfigs.get(jname))
    tspec = tconfigs.reduced(tconfigs.get(tname))
    jp = japi.init(jax.random.key(0), jspec)
    tp = convert.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jspec, tspec, jp, tp


def _batch(seed=0, pad=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (2, 64))
    labels = rng.integers(0, 256, (2, 64))
    if pad:
        labels[0, :5] = -1
    return toks, labels


def _both(toks, labels):
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "labels": jnp.asarray(labels, jnp.int32)}
    tb = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}
    return jb, tb


def _grads(spec, params, batch, **kw):
    return build_loss_and_grads(spec, **kw)(params, batch)


def test_smollm_config_matches_jax():
    js, ts = jconfigs.get("smollm_360m"), tconfigs.get("smollm-360m")
    assert (ts.name, ts.family, ts.skips, ts.source) == \
        (js.name, js.family, js.skips, js.source)
    assert dataclasses.asdict(ts.cfg) == dataclasses.asdict(js.cfg)
    assert dataclasses.asdict(tconfigs.reduced(ts).cfg) == \
        dataclasses.asdict(jconfigs.reduced(js).cfg)


@pytest.mark.parametrize("pad", [False, True])
def test_softmax_xent_matches(pad):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 8, 32)).astype(np.float32) * 3
    labels = rng.integers(0, 32, (2, 8))
    if pad:
        labels[:, 5:] = -1
    jl = jnp.asarray(labels, jnp.int32)
    want, wgrad = jax.value_and_grad(jL.softmax_xent)(jnp.asarray(logits),
                                                      jl)
    t = torch.from_numpy(logits).requires_grad_(True)
    got = tL.softmax_xent(t, torch.as_tensor(labels))
    (grad,) = torch.autograd.grad(got, t)
    np.testing.assert_allclose(float(got.detach()), float(want), **F32)
    np.testing.assert_allclose(grad.numpy(), np.asarray(wgrad), **F32)


def test_loss_masks_padding():
    """Changing logits at padded positions does not change the loss (after
    ``tests/test_models.py::test_loss_masks_padding``)."""
    logits = torch.randn((2, 4, 8), generator=torch.Generator()
                         .manual_seed(13))
    labels = torch.tensor([[1, 2, -1, -1], [3, -1, -1, -1]])
    l1 = tL.softmax_xent(logits, labels)
    logits2 = logits.clone()
    logits2[:, 2:] += 100.0
    l2 = tL.softmax_xent(logits2, labels)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)
    for fn in (lambda lg: tL.softmax_xent(lg, labels),
               lambda lg: tL.softmax_xent_chunked(
                   torch.eye(8), lg, labels, chunk=2)):
        lg = logits.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(lg), lg)
        assert float(g[0, 2:].abs().max()) == 0.0


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_softmax_xent_chunked_matches(chunk):
    rng = np.random.default_rng(2)
    head = rng.standard_normal((40, 16)).astype(np.float32)
    x = rng.standard_normal((2, 16, 16)).astype(np.float32)
    labels = rng.integers(0, 40, (2, 16))
    labels[1, :3] = -1

    def jf(h, x):
        return jL.softmax_xent_chunked(h, x, jnp.asarray(labels, jnp.int32),
                                       chunk=chunk)

    want, (wh, wx) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(head), jnp.asarray(x))
    th, tx = (torch.from_numpy(a).requires_grad_(True) for a in (head, x))
    got = tL.softmax_xent_chunked(th, tx, torch.as_tensor(labels),
                                  chunk=chunk)
    gh, gx = torch.autograd.grad(got, (th, tx))
    np.testing.assert_allclose(float(got.detach()), float(want), **F32)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), **F32)
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), **F32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_chunk", [16, 64])
def test_chunked_attention_matches(causal, q_chunk):
    """Values and gradients of q, k, v against JAX's (after
    ``test_perf_variants.py::test_chunked_attention_gradients_match_
    reference``), GQA 4 on 2 heads."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 64, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 64, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, 64, 2, 16)).astype(np.float32)

    def jf(q, k, v):
        out = jL.chunked_attention(q, k, v, causal=causal, q_chunk=q_chunk)
        return (out ** 2).sum(), out

    (_, want), wg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    got = tL.chunked_attention(tq, tk, tv, causal=causal, q_chunk=q_chunk)
    tg = torch.autograd.grad((got ** 2).sum(), (tq, tk, tv))
    np.testing.assert_allclose(f32(got), np.asarray(want), **F32)
    for a, b in zip(tg, wg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)


def test_apply_train_loss_and_every_gradient_match(model):
    """``api.apply_train`` and its gradient against
    ``jax.value_and_grad(api.apply_train)``, every leaf, padded labels
    included."""
    jspec, tspec, jp, tp = model
    jb, tb = _both(*_batch())
    want, wg = jax.value_and_grad(japi.apply_train)(jp, jspec, jb)
    got, tg = _grads(tspec, tp, tb)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-3)
    jleaves = jax.tree_util.tree_leaves_with_path(wg)
    tleaves = T.leaves_with_paths(tg)
    assert [tuple(k.key for k in p) for p, _ in jleaves] == \
        [p for p, _ in tleaves]
    for (path, a), (_, b) in zip(jleaves, tleaves):
        assert b.dtype == torch.bfloat16 and tuple(b.shape) == a.shape
        assert float(b.float().norm()) > 0, path
        np.testing.assert_allclose(f32(b), f32(a), **GRAD,
                                   err_msg=jax.tree_util.keystr(path))


def test_param_shapes_match_jax(model):
    jspec, tspec, _, _ = model
    shapes = T.tree_map(lambda t: (tuple(t.shape), t.device.type),
                        tapi.param_shapes(tspec))
    want = jax.tree.map(lambda s: (tuple(s.shape), "meta"),
                        japi.param_shapes(jspec))
    assert shapes == want


def _variant(spec, **kw):
    return dataclasses.replace(spec, cfg=dataclasses.replace(spec.cfg, **kw))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_remat_variants_same_gradients(model, remat):
    """``none`` and ``full`` give ``dots``' loss and gradients (after
    ``test_perf_variants.py::test_remat_variants_same_gradients``)."""
    _, tspec, _, tp = model
    _, tb = _both(*_batch(5))
    l0, g0 = _grads(_variant(tspec, remat="dots"), tp, tb)
    l1, g1 = _grads(_variant(tspec, remat=remat), tp, tb)
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    for a, b in zip(T.leaves(g1), T.leaves(g0)):
        np.testing.assert_allclose(f32(a), f32(b), **GRAD)


def test_accum_two_matches_one(model):
    """Two microbatches summed in fp32 give the whole batch's gradient."""
    _, tspec, _, tp = model
    _, tb = _both(*_batch(6, pad=False))
    l1, g1 = _grads(tspec, tp, tb)
    l2, g2 = _grads(tspec, tp, tb, accum=2)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-3)
    for a, b in zip(T.leaves(g2), T.leaves(g1)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(f32(a), f32(b), **GRAD)


def test_loss_chunk_matches_unchunked(model):
    """``loss_chunk`` (the chunked cross-entropy) against the unchunked
    loss, values and gradients, and against JAX's chunked loss."""
    jspec, tspec, jp, tp = model
    jb, tb = _both(*_batch(7))
    l0, g0 = _grads(tspec, tp, tb)
    l1, g1 = _grads(_variant(tspec, loss_chunk=16), tp, tb)
    want = japi.apply_train(jp, _variant(jspec, loss_chunk=16), jb)
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-3)
    np.testing.assert_allclose(float(l1), float(want), rtol=1e-3)
    for a, b in zip(T.leaves(g1), T.leaves(g0)):
        np.testing.assert_allclose(f32(a), f32(b), **GRAD)
