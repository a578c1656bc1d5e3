"""The attention gradient of the port's training path on the CPU.

The JAX package has no backward kernel: ``jax.grad`` differentiates its
plain ``causal_attention``.  The port runs the forward on the flash
kernel, so ``kernels.flash_attention.FlashAttention`` carries the
kernel's gradient (``csrc/flash_attention_bwd.cu`` on the card, held to
the plain backward by ``tests/test_torch_cuda.py``).  Here, on CPU
tensors, its forward is ``mha_lse_ref`` and its backward
``kernels.ref.mha_bwd_ref``, the plain version of the backward kernel,
held to ``torch.autograd`` through ``mha_ref`` and to ``jax.grad`` of the
JAX package's ``causal_attention`` (float32, ``rtol = atol = 1e-5``;
largest error seen 4.3e-6, 0.14 of the tolerance), causal and full, GQA
with H / KH = 2 and 4, and a length (70) ragged against the kernel's
64-row tiles.  The bf16 case is held to 2e-2 (seen 7.8e-3)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jL
from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attention as tfa, ops
from repro_torch.kernels.ref import mha_bwd_ref, mha_lse_ref, mha_ref
from repro_torch.launch.steps import build_loss_and_grads
from repro_torch.models import api as tapi

F32 = dict(rtol=1e-5, atol=1e-5)
CASES = [(causal, H, KH, S) for causal in (True, False)
         for H, KH in ((4, 2), (8, 2)) for S in (64, 70)]


def _inputs(H, KH, S, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, S, H, 16)).astype(np.float32)
    k = rng.standard_normal((2, S, KH, 16)).astype(np.float32)
    v = rng.standard_normal((2, S, KH, 16)).astype(np.float32)
    do = rng.standard_normal((2, S, H, 16)).astype(np.float32)
    return q, k, v, do


def _torch(*arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


def _jax_grads(q, k, v, do, causal):
    def f(q, k, v):
        return (jL.causal_attention(q, k, v, causal=causal) * do).sum()
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("causal,H,KH,S", CASES)
def test_plain_backward_matches_autograd_and_jax(causal, H, KH, S):
    """``mha_bwd_ref`` from the forward's o and lse equals autograd through
    ``mha_ref`` and ``jax.grad`` of JAX's ``causal_attention``."""
    q, k, v, do = _inputs(H, KH, S)
    tq, tk, tv = _torch(q, k, v, grad=True)
    o, lse = mha_lse_ref(tq, tk, tv, causal=causal)
    assert lse.shape == (2, H, S) and lse.dtype == torch.float32
    got = mha_bwd_ref(tq, tk, tv, o, torch.from_numpy(do), lse,
                      causal=causal)
    auto = torch.autograd.grad(mha_ref(tq, tk, tv, causal=causal),
                               (tq, tk, tv), torch.from_numpy(do))
    want = _jax_grads(q, k, v, do, causal)
    for g, a, w in zip(got, auto, want):
        assert g.shape == a.shape
        np.testing.assert_allclose(g.detach().numpy(), a.numpy(), **F32)
        np.testing.assert_allclose(g.detach().numpy(), w, **F32)


@pytest.mark.parametrize("causal,H,KH,S", CASES)
def test_ops_mha_under_autograd_matches_jax(causal, H, KH, S):
    """``ops.mha`` takes the kernel branch (the Function) at these shapes;
    its gradients on the CPU are JAX's."""
    q, k, v, do = _inputs(H, KH, S, seed=1)
    tq, tk, tv = _torch(q, k, v, grad=True)
    out = ops.mha(tq, tk, tv, causal=causal)
    assert out.grad_fn is not None and \
        type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    want = _jax_grads(q, k, v, do, causal)
    want_o = np.asarray(jL.causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    np.testing.assert_allclose(out.detach().numpy(), want_o, **F32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **F32)


@pytest.mark.parametrize("needs", [(False, True, True), (True, False, True),
                                   (True, True, False), (False, False, True)])
def test_function_returns_none_for_inputs_without_grad(needs):
    """An input that needs no gradient gets None; the others equal the
    plain backward's."""
    q, k, v, do = _inputs(4, 2, 64, seed=2)
    xs = [torch.from_numpy(a).requires_grad_(n) for a, n in
          zip((q, k, v), needs)]
    out = tfa.FlashAttention.apply(*xs, True, None)
    direct = out.grad_fn.apply(torch.from_numpy(do))     # the backward
    assert [g is None for g in direct[:3]] == [not n for n in needs]
    grads = torch.autograd.grad(out, [x for x in xs if x.requires_grad],
                                torch.from_numpy(do))
    o, lse = mha_lse_ref(*xs, causal=True)
    want = [w for w, n in zip(mha_bwd_ref(*xs, o, torch.from_numpy(do), lse),
                              needs) if n]
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w.detach().numpy(), **F32)


def test_no_grad_takes_the_plain_forward(monkeypatch):
    """Without autograd recording (serving), the wrapper skips the
    Function: no lse is made."""
    calls = []
    monkeypatch.setattr(tfa.FlashAttention, "apply",
                        lambda *a: calls.append(1))
    q, k, v, _ = _inputs(4, 2, 64)
    tq, tk, tv = _torch(q, k, v, grad=True)
    with torch.no_grad():
        tfa.flash_attention_gqa(tq, tk, tv)
    tfa.flash_attention_gqa(*_torch(q, k, v))
    assert calls == []
    tfa.flash_attention_gqa(tq, tk, tv)
    assert calls == [1]


def test_strided_and_bf16_inputs_through_the_function():
    """The model's call: q, k, v as strided views of a fused projection,
    bf16 (the plain backward rounds dq, dk, dv to bf16, 2e-2)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 64, 8, 16))
                         .astype(np.float32)).bfloat16().requires_grad_(True)
    q, k, v = x[:, :, :4], x[:, :, 4:6], x[:, :, 6:]
    do = torch.from_numpy(rng.standard_normal((2, 64, 4, 16))
                          .astype(np.float32)).bfloat16()
    g = torch.autograd.grad(ops.mha(q, k, v), x, do)[0]
    want = torch.autograd.grad(mha_ref(q.float(), k.float(), v.float()),
                               x, do.float())[0]
    assert g.dtype == torch.bfloat16
    np.testing.assert_allclose(g.float().numpy(), want.float().numpy(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("remat,per_layer", [("none", 1), ("dots", 2),
                                             ("full", 2)])
def test_remat_policy_predicts_flash_calls(monkeypatch, remat, per_layer):
    """One training step calls the flash forward once a layer under
    ``"none"`` and twice (the recompute in the backward) under ``"dots"``
    and ``"full"``, and the flash backward once a layer: the launch
    counts the card shows."""
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
    spec = tconfigs.reduced(tconfigs.get("qwen3-0.6b"))
    spec = dataclasses.replace(spec, cfg=dataclasses.replace(spec.cfg,
                                                             remat=remat))
    params = tapi.init(torch.Generator().manual_seed(0), spec)
    toks = torch.as_tensor(np.random.default_rng(4).integers(0, 256, (2, 64)))
    loss, grads = build_loss_and_grads(spec)(params, {"tokens": toks,
                                                      "labels": toks})
    L = spec.cfg.n_layers
    assert calls == {"fwd": per_layer * L, "bwd": L}
    assert float(grads["layers"]["attn"]["wq"].float().norm()) > 0
