"""CPU parity of the port's dense LM serving path with the JAX package.

The reduced qwen3 configuration (2 layers, d_model 64, head_dim 16) with
the JAX package's random weights carried across by
``repro_torch.models.convert``; inputs from numpy seeds go through both.
Tolerances: bf16 activations and logits ``rtol = atol = 2e-2``, as
``tests/test_models.py`` holds bf16 logits (the two frameworks round bf16
matmuls at the same places but sum in other orders); float32 layer math
``1e-5``.  KV caches after several serving steps: a relative Frobenius
error of at most 2e-2 per layer (measured 0.7% at layer 1: one or two
bf16 roundings of the residual, which qk-norm amplifies where a head's
key vector is small, so a few single entries stray beyond 2e-2).
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
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import serve as tserve
from repro_torch.launch.steps import build_serve_step
from repro_torch.models import api as tapi, convert, layers as tL
from repro_torch.models import transformer as tT

BF16 = dict(rtol=2e-2, atol=2e-2)
F32 = dict(rtol=1e-5, atol=1e-5)
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def f32(x):
    """A JAX array or a torch tensor as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def both(a, dt="bf16"):
    """One numpy array as a JAX array and a torch tensor of one dtype."""
    j = jnp.asarray(a, JDT[dt])
    return j, torch.from_numpy(f32(j)).to(TDT[dt])


@pytest.fixture(scope="module")
def model():
    jspec = jconfigs.reduced(jconfigs.get("qwen3_0p6b"))
    tspec = tconfigs.reduced(tconfigs.get("qwen3-0.6b"))
    jp = japi.init(jax.random.key(0), jspec)
    tp = convert.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jspec, tspec, jp, tp


def test_dense_configs_match_jax():
    js, ts = jconfigs.get("qwen3_0p6b"), tconfigs.get("qwen3-0.6b")
    assert (ts.name, ts.family, ts.skips, ts.source) == \
        (js.name, js.family, js.skips, js.source)
    assert dataclasses.asdict(ts.cfg) == dataclasses.asdict(js.cfg)
    assert ts.cfg.param_count() == js.cfg.param_count()
    assert ts.cfg.attn.__dict__ == js.cfg.attn.__dict__
    jr, tr = jconfigs.reduced(js), tconfigs.reduced(ts)
    assert dataclasses.asdict(tr.cfg) == dataclasses.asdict(jr.cfg)


def test_unported_families_raise():
    """Every family is ported; what still raises: an unknown architecture
    (``KeyError``) and an unknown family in ``api`` (``ValueError``, as
    the JAX ``api``); ``reduced`` of the overlay's ``flexgrip``, a family
    without a small config, returns the spec unchanged, as the JAX one."""
    with pytest.raises(KeyError):
        tconfigs.get("no-such-arch")
    flexgrip = tconfigs.get("flexgrip")
    assert tconfigs.reduced(flexgrip) is flexgrip
    unknown = tconfigs.ArchSpec(name="x", family="nosuch", cfg=None)
    with pytest.raises(ValueError, match="nosuch"):
        tapi.init(torch.Generator(), unknown)
    with pytest.raises(ValueError, match="nosuch"):
        tapi.decode_state(unknown, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="nosuch"):
        tapi.apply_decode(None, unknown, None, None, 0)


def test_converted_params_keep_the_tree(model):
    _, _, jp, tp = model
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = jax.tree_util.tree_leaves_with_path(tp)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        assert b.dtype == torch.bfloat16 and tuple(b.shape) == a.shape
        np.testing.assert_array_equal(f32(a), f32(b))


def test_port_init_has_the_jax_tree():
    spec = tconfigs.reduced(tconfigs.get("qwen3-0.6b"))
    tp = tapi.init(torch.Generator().manual_seed(0), spec)
    jp = jax.eval_shape(lambda: japi.init(
        jax.random.key(0), jconfigs.reduced(jconfigs.get("qwen3_0p6b"))))
    shapes = jax.tree.map(lambda t: tuple(t.shape), tp)
    assert shapes == jax.tree.map(lambda s: tuple(s.shape), jp)
    # same scales: He init and 0.02 embeddings
    assert abs(float(tp["embed"].float().std()) - 0.02) < 2e-3
    wq = tp["layers"]["attn"]["wq"].float()
    assert abs(float(wq.std()) - 64 ** -0.5) < 0.01


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rmsnorm_matches(dt):
    rng = np.random.default_rng(1)
    xj, xt = both(rng.standard_normal((2, 5, 64)) * 3, dt)
    gj, gt = both(rng.standard_normal(64), dt)
    want = jL.rmsnorm(gj, xj)
    got = tL.rmsnorm(gt, xt)
    assert got.dtype == TDT[dt]
    np.testing.assert_allclose(f32(got), f32(want),
                               **(F32 if dt == "f32" else BF16))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_apply_rope_matches(dt):
    rng = np.random.default_rng(2)
    xj, xt = both(rng.standard_normal((2, 7, 4, 16)), dt)
    pos = np.stack([np.arange(7), np.arange(7) + 100])
    want = jL.apply_rope(xj, jnp.asarray(pos, jnp.int32), 1e6)
    got = tL.apply_rope(xt, torch.as_tensor(pos, dtype=torch.int32), 1e6)
    np.testing.assert_allclose(f32(got), f32(want),
                               **(F32 if dt == "f32" else BF16))


ATTN_CASES = {
    "causal": dict(S=8, T=8),
    "q_offset": dict(S=3, T=12, q_offset=5),
    "decode": dict(S=1, T=12, q_offset=6),
    "full": dict(S=6, T=10, causal=False),
}


@pytest.mark.parametrize("softmax", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_causal_attention_matches(case, softmax):
    c = dict(ATTN_CASES[case])
    rng = np.random.default_rng(3)
    S, T = c.pop("S"), c.pop("T")
    qj, qt = both(rng.standard_normal((2, S, 4, 16)))
    kj, kt = both(rng.standard_normal((2, T, 2, 16)))
    vj, vt = both(rng.standard_normal((2, T, 2, 16)))
    want = jL.causal_attention(qj, kj, vj, softmax_dtype=softmax, **c)
    got = tL.causal_attention(qt, kt, vt, softmax_dtype=softmax, **c)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), **BF16)


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


@pytest.mark.parametrize("mode", ["no_cache", "prefill", "decode", "chunk"])
def test_attn_apply_matches(monkeypatch, model, mode):
    """No cache and cached at index 0 with S = 16 (both take the flash
    route: S passes ``tile_ok``); cached at index > 0 with S = 1 (decode)
    and S = 3 (the plain attention)."""
    calls = []
    real = tfa.flash_attention_gqa
    monkeypatch.setattr(tfa, "flash_attention_gqa",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    jspec, tspec, jp, tp = model
    jcfg, tcfg = jspec.cfg.attn, tspec.cfg.attn
    jl, tl = _layer0(jp["layers"]["attn"]), tT.layer_params(
        tp["layers"]["attn"], 0)
    rng = np.random.default_rng(4)
    B, T = 2, 24
    S, ci = {"no_cache": (16, None), "prefill": (16, 0), "decode": (1, 8),
             "chunk": (3, 8)}[mode]
    xj, xt = both(rng.standard_normal((B, S, 64)))
    start = 0 if ci is None else ci
    pos = np.tile(np.arange(start, start + S), (B, 1))
    cache = None
    if ci is not None:
        cache = rng.standard_normal((2, B, T, 2, 16))
        cache[:, :, ci:] = 0
    jkw, tkw = {}, {}
    if cache is not None:
        (ckj, ckt), (cvj, cvt) = both(cache[0]), both(cache[1])
        jkw = dict(kv_cache=(ckj, cvj), cache_index=ci)
        tkw = dict(kv_cache=(ckt, cvt), cache_index=ci)
    want, wcache = jL.attn_apply(jl, jcfg, xj, jnp.asarray(pos), **jkw)
    got, gcache = tL.attn_apply(tl, tcfg, xt, torch.as_tensor(pos), **tkw)
    assert len(calls) == int(mode in ("no_cache", "prefill"))
    np.testing.assert_allclose(f32(got), f32(want), **BF16)
    if cache is not None:
        for a, b in zip(gcache, wcache):
            np.testing.assert_allclose(f32(a), f32(b), **BF16)


def test_attn_apply_chunked_impl_matches(model):
    """``impl="chunked"`` (query chunks of 16 over S = 64) against the JAX
    package's ``attn_apply`` on the same layer and input (bf16; largest
    error seen 3.9e-3)."""
    jspec, tspec, jp, tp = model
    jcfg = dataclasses.replace(jspec.cfg.attn, impl="chunked", q_chunk=16)
    tcfg = dataclasses.replace(tspec.cfg.attn, impl="chunked", q_chunk=16)
    rng = np.random.default_rng(8)
    xj, xt = both(rng.standard_normal((2, 64, 64)))
    pos = np.tile(np.arange(64), (2, 1))
    want, _ = jL.attn_apply(_layer0(jp["layers"]["attn"]), jcfg, xj,
                            jnp.asarray(pos))
    got, _ = tL.attn_apply(tT.layer_params(tp["layers"]["attn"], 0), tcfg,
                           xt, torch.as_tensor(pos))
    np.testing.assert_allclose(f32(got), f32(want), **BF16)


def test_bf16_softmax_variant_matches(model):
    """The bf16-softmax perf variant keeps the plain attention."""
    jspec, tspec, jp, tp = model
    jcfg = dataclasses.replace(jspec.cfg, softmax_dtype="bf16")
    tcfg = dataclasses.replace(tspec.cfg, softmax_dtype="bf16")
    toks = np.random.default_rng(5).integers(0, 256, (2, 8))
    want = jT.forward(jp, jcfg, jnp.asarray(toks, jnp.int32))
    got = tT.forward(tp, tcfg, torch.as_tensor(toks))
    np.testing.assert_allclose(f32(got), f32(want), **BF16)


def test_forward_matches_without_cache(model):
    jspec, tspec, jp, tp = model
    toks = np.random.default_rng(6).integers(0, 256, (2, 12))
    want = jT.forward(jp, jspec.cfg, jnp.asarray(toks, jnp.int32))
    got = tT.forward(tp, tspec.cfg, torch.as_tensor(toks))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 12, 256)
    np.testing.assert_allclose(f32(got), f32(want), **BF16)


def test_forward_matches_with_caches(model):
    """Prefill of 10 tokens into a 16-long cache, then one step of 2."""
    jspec, tspec, jp, tp = model
    toks = np.random.default_rng(7).integers(0, 256, (2, 12))
    jst = japi.decode_state(jspec, 2, 16)["kv"]
    tst = tapi.decode_state(tspec, 2, 16, device="cpu")["kv"]
    for lo, hi in ((0, 10), (10, 12)):
        want, jst = jT.forward(jp, jspec.cfg,
                               jnp.asarray(toks[:, lo:hi], jnp.int32),
                               kv_caches=jst, cache_index=lo)
        got, tst = tT.forward(tp, tspec.cfg, torch.as_tensor(toks[:, lo:hi]),
                              kv_caches=tst, cache_index=lo)
        np.testing.assert_allclose(f32(got), f32(want), **BF16)
        for a, b in zip(tst, jst):
            np.testing.assert_allclose(f32(a), f32(b), **BF16)


def assert_cache_close(got, want):
    for a, b in zip(got, want):
        a, b = f32(a), f32(b)
        for layer in range(a.shape[0]):
            err = np.linalg.norm(a[layer] - b[layer])
            assert err <= 2e-2 * np.linalg.norm(b[layer]), layer


def _agrees(tok, logits):
    """``tok`` (B,) is the argmax of ``logits`` (B, V), or within the
    tolerance of it (a near-tie that rounding may break either way)."""
    best = logits.max(-1)
    picked = logits[np.arange(len(tok)), tok]
    return np.all(picked >= best - (BF16["atol"] + BF16["rtol"] *
                                    np.abs(best)))


def test_serve_step_matches_apply_decode(model):
    """A prefill step of (B, S) then 4 teacher-forced decode steps against
    ``api.apply_decode`` + argmax, the body of the JAX package's
    ``serve_step``."""
    jspec, tspec, jp, tp = model
    B, S, T = 2, 10, 16
    rng = np.random.default_rng(8)
    toks = rng.integers(0, 256, (B, S))
    jst = japi.decode_state(jspec, B, T)
    tst = tapi.decode_state(tspec, B, T, device="cpu")
    step = build_serve_step(tspec)
    feed, ci = toks, 0
    for _ in range(5):
        jlog, jst = japi.apply_decode(jp, jspec, jnp.asarray(feed, jnp.int32),
                                      jst, ci)
        tlog, _ = tapi.apply_decode(tp, tspec, torch.as_tensor(feed),
                                    {"kv": tuple(x.clone()
                                                 for x in tst["kv"])}, ci)
        np.testing.assert_allclose(f32(tlog[:, -1]), f32(jlog[:, -1]),
                                   **BF16)
        tok, tst = step(tp, tst, torch.as_tensor(feed), ci)
        assert tok.dtype == torch.int32 and tuple(tok.shape) == (B,)
        jtok = np.array(jnp.argmax(jlog[:, -1], axis=-1))
        assert _agrees(tok.numpy(), f32(jlog[:, -1])), (tok, jtok)
        assert_cache_close(tst["kv"], jst["kv"])
        ci += feed.shape[1]
        feed = jtok[:, None]                # teacher-forced by the JAX token


def test_serve_main_on_cpu_follows_jax():
    """``main`` on the CPU: its tokens, fed back step by step through the
    JAX package's ``apply_decode`` with the port's weights carried back,
    are each the JAX argmax (or within tolerance of it)."""
    B, P, G = 2, 12, 5
    gen = tserve.main(["--reduced", "--device", "cpu", "--batch", str(B),
                       "--prompt-len", str(P), "--gen", str(G),
                       "--seed", "3"])
    assert gen.shape == (B, G) and gen.dtype == np.int32
    tspec = tconfigs.reduced(tconfigs.get("qwen3-0.6b"))
    jspec = jconfigs.reduced(jconfigs.get("qwen3_0p6b"))
    tp = tapi.init(torch.Generator().manual_seed(3), tspec)
    jp = jax.tree.map(lambda t: jnp.asarray(f32(t), jnp.bfloat16), tp)
    prompt = np.random.default_rng(3).integers(0, 256, (B, P))
    st = japi.decode_state(jspec, B, P + G)
    logits, st = japi.apply_decode(jp, jspec, jnp.asarray(prompt, jnp.int32),
                                   st, 0)
    tst = tapi.decode_state(tspec, B, P + G, device="cpu")
    prev, _ = build_serve_step(tspec)(tp, tst, torch.as_tensor(prompt), 0)
    prev = prev.numpy()
    assert _agrees(prev, f32(logits[:, -1]))
    for i in range(G):
        logits, st = japi.apply_decode(
            jp, jspec, jnp.asarray(prev[:, None], jnp.int32), st, P + i)
        assert _agrees(gen[:, i], f32(logits[:, -1])), i
        prev = gen[:, i]
