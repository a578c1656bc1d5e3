"""CPU parity of the port's flash-attention and matmul wrappers (their
plain versions, on CPU tensors) with the JAX package's Pallas kernels in
interpret mode, and ``ops.mha``'s routing.

Tolerances are ``tests/test_kernels.py``'s: flash attention f32 2e-3,
bf16 3e-2, large logits 1e-2; matmul f32 1e-3, bf16 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.matmul import matmul as jmatmul
from repro_torch.kernels import flash_attention as tfa, ops as tops
from repro_torch.kernels.matmul import matmul as tmatmul

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
FLASH_TOL = {"f32": 2e-3, "bf16": 3e-2}
MM_TOL = {"f32": 1e-3, "bf16": 2e-2}


def both(a, dt):
    j = jnp.asarray(a, JDT[dt])
    return j, torch.from_numpy(np.array(jnp.asarray(j, jnp.float32))) \
        .to(TDT[dt])


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


FLASH_CASES = [
    dict(Sq=64, Sk=64, dh=16, causal=True, bq=32, bk=32),
    dict(Sq=128, Sk=128, dh=64, causal=True, bq=64, bk=64),
    dict(Sq=32, Sk=128, dh=32, causal=False, bq=32, bk=64),
    # causal with Sq != Sk: both align top-left (qi >= ki)
    dict(Sq=32, Sk=96, dh=16, causal=True, bq=32, bk=32),
    # a length that is not a multiple of the CUDA kernel's 64-row tile
    dict(Sq=40, Sk=40, dh=16, causal=True, bq=40, bk=40),
]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("cfg", FLASH_CASES,
                         ids=lambda c: "{Sq}x{Sk}x{dh}-{causal}".format(**c))
def test_flash_attention_plain_matches_pallas(cfg, dt):
    rng = np.random.default_rng(cfg["Sq"] + cfg["dh"])
    BH, dh = 3, cfg["dh"]
    qj, qt = both(rng.standard_normal((BH, cfg["Sq"], dh)), dt)
    kj, kt = both(rng.standard_normal((BH, cfg["Sk"], dh)), dt)
    vj, vt = both(rng.standard_normal((BH, cfg["Sk"], dh)), dt)
    kw = dict(causal=cfg["causal"], bq=cfg["bq"], bk=cfg["bk"])
    want = jflash(qj, kj, vj, interpret=True, **kw)
    got = tfa.flash_attention(qt, kt, vt, **kw)
    assert got.dtype == TDT[dt] and got.shape == qt.shape
    tol = FLASH_TOL[dt]
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


def test_flash_attention_plain_large_logits():
    """Logits of a few thousand must not overflow the softmax."""
    rng = np.random.default_rng(9)
    qj, qt = both(rng.standard_normal((1, 64, 32)) * 30, "f32")
    kj, kt = both(rng.standard_normal((1, 64, 32)) * 30, "f32")
    vj, vt = both(rng.standard_normal((1, 64, 32)), "f32")
    want = jflash(qj, kj, vj, causal=True, bq=32, bk=32, interpret=True)
    got = tfa.flash_attention(qt, kt, vt, causal=True, bq=32, bk=32)
    assert np.isfinite(f32(got)).all()
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(128, 128, 128), (256, 384, 128)])
def test_matmul_plain_matches_pallas(shape, dt):
    M, K, N = shape
    rng = np.random.default_rng(M + N)
    aj, at = both(rng.standard_normal((M, K)), dt)
    bj, bt = both(rng.standard_normal((K, N)), dt)
    want = jmatmul(aj, bj, bm=128, bn=128, bk=128, interpret=True)
    got = tmatmul(at, bt, bm=128, bn=128, bk=128)
    assert got.dtype == TDT[dt] and tuple(got.shape) == (M, N)
    tol = MM_TOL[dt]
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


def test_matmul_refuses_what_the_tpu_kernel_refuses():
    a, b = torch.zeros((96, 64)), torch.zeros((64, 32))
    with pytest.raises(AssertionError):
        jmatmul(jnp.zeros((96, 64)), jnp.zeros((64, 32)), bm=64,
                interpret=True)
    with pytest.raises(ValueError, match="do not tile"):
        tmatmul(a, b, bm=64)
    assert tuple(tmatmul(a, b, bm=32).shape) == (96, 32)
    with pytest.raises(ValueError, match="chain"):
        tmatmul(a, torch.zeros((32, 32)))
    with pytest.raises(ValueError, match="float32 or both"):
        tmatmul(a, b.to(torch.bfloat16))


def test_flash_attention_refuses_bad_inputs():
    q = torch.zeros((2, 64, 16))
    with pytest.raises(ValueError, match="do not tile"):
        tfa.flash_attention(q, q, q, bq=48)
    with pytest.raises(ValueError, match="dh"):
        big = torch.zeros((1, 16, 1, 272))
        tfa.flash_attention_gqa(big, big, big)
    with pytest.raises(ValueError, match="H % KH"):
        tfa.flash_attention_gqa(torch.zeros((1, 16, 3, 16)),
                                torch.zeros((1, 16, 2, 16)),
                                torch.zeros((1, 16, 2, 16)))
    with pytest.raises(ValueError, match="bfloat16"):
        tfa.flash_attention(q, q, q.to(torch.bfloat16))


# (Sq, Sk, causal): the kernel takes a shape iff use_kernel and tile_ok
MHA_CASES = [
    (16, 16, True), (64, 64, True), (12, 12, True),    # tile_ok
    (16, 32, True),        # tile_ok, causal Sq != Sk: top-left
    (32, 48, False),
    (4, 32, True),         # Sq <= 8: the oracle, bottom-right
    (1, 24, True),         # decode
    (300, 300, True),      # 300 % 256 != 0
    (256, 300, False),
]


@pytest.mark.parametrize("Sq,Sk,causal", MHA_CASES)
def test_mha_matches_jax(Sq, Sk, causal):
    """``ops.mha`` (GQA, 4 query heads on 2 KV heads) against the JAX
    package's ``ops.mha``, which runs the Pallas kernel in interpret mode
    where ``tile_ok`` holds and its oracle elsewhere."""
    rng = np.random.default_rng(Sq * 1000 + Sk)
    qj, qt = both(rng.standard_normal((2, Sq, 4, 16)), "f32")
    kj, kt = both(rng.standard_normal((2, Sk, 2, 16)), "f32")
    vj, vt = both(rng.standard_normal((2, Sk, 2, 16)), "f32")
    want = jops.mha(qj, kj, vj, causal=causal)
    got = tops.mha(qt, kt, vt, causal=causal)
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("Sq,Sk,causal", MHA_CASES)
def test_mha_routes_by_tile_ok(monkeypatch, Sq, Sk, causal, use_kernel):
    calls = []
    real = tfa.flash_attention_gqa
    monkeypatch.setattr(tfa, "flash_attention_gqa",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    q = torch.zeros((1, Sq, 2, 16))
    k = torch.zeros((1, Sk, 1, 16))
    tops.mha(q, k, k, causal=causal, use_kernel=use_kernel)
    tile_ok = Sq % min(256, Sq) == 0 and Sk % min(256, Sk) == 0 and Sq > 8
    assert tops.tile_ok(Sq, Sk) == tile_ok
    assert len(calls) == int(use_kernel and tile_ok)


def test_prefill_attention_takes_the_kernel_route(monkeypatch):
    """In the model, the no-cache forward and the prefill step (cache index
    0, S > 1) reach ``ops.mha``'s kernel route once per layer; decode steps
    never do."""
    from repro_torch import configs
    from repro_torch.models import api, transformer
    calls = []
    real = tfa.flash_attention_gqa
    monkeypatch.setattr(tfa, "flash_attention_gqa",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    spec = configs.reduced(configs.get("qwen3-0.6b"))
    params = api.init(torch.Generator().manual_seed(0), spec)
    toks = torch.randint(0, 256, (2, 16), generator=torch.Generator())
    transformer.forward(params, spec.cfg, toks)
    assert len(calls) == spec.cfg.n_layers
    state = api.decode_state(spec, 2, 20, device="cpu")
    api.apply_decode(params, spec, toks, state, 0)
    assert len(calls) == 2 * spec.cfg.n_layers
    api.apply_decode(params, spec, toks[:, :1], state, 16)
    assert len(calls) == 2 * spec.cfg.n_layers
