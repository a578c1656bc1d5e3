"""CPU parity of the port's encoder-decoder (``models/encdec.py``, the
audio family, whisper-medium) with the JAX package.

The reduced whisper-medium configuration (2 + 2 layers, d_model 64, 4
heads of 16, 32 encoder frames), the JAX package's random weights carried
across by ``convert.from_numpy``, and numpy inputs (frames from
``default_rng``) through both.  Tolerances as ``tests/test_torch_lm.py``
and ``tests/test_torch_ssm.py``: bf16 activations and logits ``rtol =
atol = 2e-2``; decode caches by relative Frobenius error per layer
(``assert_state_close``, 2e-2); the training loss ``rtol 1e-3`` and every
gradient leaf by ``check_train_parity`` (fp32 activations in both
packages elementwise, bf16 against the fp32 gradient's norm).

Serving decodes against a zeroed cross K/V, as the JAX CLI does: every
cross-attention then takes a uniform softmax over zero values, an output
of exactly 0 in both packages.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import train as jtrain
from repro.models import api as japi, encdec as jE, layers as jL
from repro_torch import configs as tconfigs, tree as T
from repro_torch.ckpt import CheckpointManager
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import serve as tserve, steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi, encdec as tE, layers as tL
from repro_torch.optim import OptConfig, opt_init

from test_torch_ssm import (BF16, assert_state_close, check_train_parity,
                            f32, f32_compute, jtree)

N_PARAMS = 960740352


@pytest.fixture(scope="module")
def model():
    jspec = jconfigs.reduced(jconfigs.get("whisper_medium"))
    tspec = tconfigs.reduced(tconfigs.get("whisper-medium"))
    jp = japi.init(jax.random.key(0), jspec)
    return jspec, tspec, jp, jtree(jp)


def _frames(spec, B=2, seed=3):
    a = np.random.default_rng(seed).standard_normal(
        (B, spec.cfg.enc_len, spec.cfg.d_model)).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def test_config_matches_jax():
    """The spec and its ``reduced()`` equal the JAX package's;
    ``param_count()`` (``enc_pos`` counted) and ``active_param_count()``
    agree; the reduced one has ``enc_len`` 32 and ``n_kv == n_heads``."""
    js, ts = jconfigs.get("whisper_medium"), tconfigs.get("whisper-medium")
    assert type(ts.cfg).__module__ == "repro_torch.models.encdec"
    assert (ts.name, ts.family, ts.skips, ts.source) == \
        (js.name, js.family, js.skips, js.source)
    assert dataclasses.asdict(ts.cfg) == dataclasses.asdict(js.cfg)
    assert ts.cfg.param_count() == js.cfg.param_count() == N_PARAMS
    assert ts.cfg.active_param_count() == js.cfg.active_param_count()
    assert ts.cfg.attn.__dict__ == js.cfg.attn.__dict__
    jr, tr = jconfigs.reduced(js), tconfigs.reduced(ts)
    assert dataclasses.asdict(tr.cfg) == dataclasses.asdict(jr.cfg)
    assert tr.cfg.enc_len == 32 and tr.cfg.n_kv == tr.cfg.n_heads
    assert tr.cfg.param_count() == jr.cfg.param_count()


def test_init_has_the_jax_tree(model):
    """``api.init`` and ``param_shapes`` (``meta``) have the JAX tree's
    shapes and dtypes, ``enc`` and ``dec`` stacked; ``enc_pos`` is 0.02
    times a normal draw, cast to bf16; the parameter count is
    ``param_count()``."""
    jspec, tspec, jp, _ = model
    tp = tapi.init(torch.Generator().manual_seed(0), tspec)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
    for tree, dev in ((tp, "cpu"), (tapi.param_shapes(tspec), "meta")):
        got = T.tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), tree)
        assert got == want
        assert {t.device.type for t in T.leaves(tree)} == {dev}
    assert abs(float(tp["enc_pos"].float().std()) - 0.02) < 2e-3
    assert sum(t.numel() for t in T.leaves(tp)) == tspec.cfg.param_count()


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_encode_matches(model, monkeypatch, compute):
    """The encoder (RoPE, full attention, every layer under the remat)
    and its cross K/V, (Ldec, B, T, K, dh) each.  ``"f32"`` (both packages
    computing in fp32): within 1e-4.  ``"bf16"``: the encoder's output
    within a relative Frobenius error of 2e-2 per sequence, as the caches
    (a rounding of the residual that differs moves single entries of the
    normed output by two or three bf16 steps), the cross K/V computed from
    one output within 2e-2."""
    jspec, tspec, jp, tp = model
    if compute == "f32":
        jp, tp = f32_compute(monkeypatch, jp)
    jf, tf = _frames(tspec)
    want = jE.encode(jp, jspec.cfg, jf)
    got = tE.encode(tp, tspec.cfg, tf)
    assert got.dtype == tL.COMPUTE_DTYPE and tuple(got.shape) == want.shape
    if compute == "f32":
        np.testing.assert_allclose(f32(got), f32(want), rtol=1e-4, atol=1e-4)
    else:
        assert_state_close(got, want, "encoder output")
    jk, jv = jE.cross_kv(jp, jspec.cfg, want)
    tk, tv = tE.cross_kv(tp, tspec.cfg, torch.from_numpy(f32(want))
                         .to(tL.COMPUTE_DTYPE))
    assert tuple(tk.shape) == jk.shape == (2, 2, 32, 4, 16)
    for a, b in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(f32(a), f32(b), **BF16)


def test_encoder_applies_rope(model, monkeypatch):
    """Every encoder layer rotates q and k (positions 0..T-1)."""
    _, tspec, _, tp = model
    seen = []
    real = tL.apply_rope
    monkeypatch.setattr(tL, "apply_rope", lambda x, pos, *a: seen.append(
        pos[0].tolist()) or real(x, pos, *a))
    tE.encode(tp, tspec.cfg, _frames(tspec)[1])
    assert seen == [list(range(32))] * (2 * tspec.cfg.n_layers)


def test_decode_and_forward_match(model):
    """``decode`` from ``enc_out`` and ``forward`` (frames and tokens)."""
    jspec, tspec, jp, tp = model
    jf, tf = _frames(tspec)
    toks = np.random.default_rng(1).integers(0, 256, (2, 16))
    jt, tt = jnp.asarray(toks, jnp.int32), torch.as_tensor(toks)
    enc = jE.encode(jp, jspec.cfg, jf)
    want = jE.decode(jp, jspec.cfg, jt, enc)
    got = tE.decode(tp, tspec.cfg, tt, torch.from_numpy(f32(enc))
                    .bfloat16())
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(f32(got), f32(want), **BF16)
    np.testing.assert_allclose(f32(tE.forward(tp, tspec.cfg, tf, tt)),
                               f32(jE.forward(jp, jspec.cfg, jf, jt)),
                               **BF16)


def _state(jp, jspec, B, T_, seed, mid):
    """A decode state with a non-zero cross K/V (the JAX encoder's, from
    frames of ``seed``); with ``mid``, also the first ``seed % 5 + 3``
    entries of every self-attention cache drawn at random."""
    st = japi.decode_state(jspec, B, T_)
    jf, _ = _frames(jspec, B, seed)
    st["cross"] = jE.cross_kv(jp, jspec.cfg, jE.encode(jp, jspec.cfg, jf))
    n = 0
    if mid:
        rng = np.random.default_rng(seed)
        n = seed % 5 + 3
        st["kv"] = tuple(jnp.asarray(np.concatenate(
            [rng.standard_normal(c.shape[:2] + (n,) + c.shape[3:]),
             np.zeros(c.shape[:2] + (c.shape[2] - n,) + c.shape[3:])], 2),
            c.dtype) for c in st["kv"])
    return st, n


@pytest.mark.parametrize("mid_sequence", [False, True])
def test_prefill_then_decode_match(model, mid_sequence):
    """Against JAX ``api.apply_decode`` on the same tokens and a state
    carried across (its KV caches and a non-zero cross K/V): a one-step
    prefill of (B, P) tokens at cache index 0, then decode steps; or, from
    a mid-sequence state, decode steps only.  Logits within 2e-2, the
    caches within 2e-2 per layer, the cross K/V returned unchanged."""
    jspec, tspec, jp, tp = model
    B, P, T_ = 2, 16, 24
    rng = np.random.default_rng(2)
    jst, start = _state(jp, jspec, B, T_, 4, mid_sequence)
    steps = [rng.integers(0, 256, (B, 1)) for _ in range(4)]
    if not mid_sequence:
        steps = [rng.integers(0, 256, (B, P))] + steps
    tst = jtree(jst)
    cross = tst["cross"]
    ci = start
    for i, toks in enumerate(steps):
        jl, jst = japi.apply_decode(jp, jspec, jnp.asarray(toks, jnp.int32),
                                    jst, ci)
        with torch.inference_mode():
            tl, tst = tapi.apply_decode(tp, tspec, torch.as_tensor(toks),
                                        tst, ci)
        ci += toks.shape[1]
        np.testing.assert_allclose(f32(tl), f32(jl), **BF16,
                                   err_msg=f"step {i}")
        assert_state_close(tst["kv"], jst["kv"], f"kv after step {i}")
        assert tst["cross"] is cross


def test_decode_state_shapes(model):
    jspec, tspec, _, _ = model
    jst = japi.decode_state(jspec, 3, 20)
    tst = tapi.decode_state(tspec, 3, 20, device="cpu")
    assert T.tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), tst) \
        == jax.tree.map(lambda a: (a.shape, str(a.dtype)), jst)
    assert tst["cross"][0].shape == (2, 3, 32, 4, 16)
    assert all(float(t.abs().max()) == 0 for t in T.leaves(tst))


@pytest.mark.parametrize("Sq", [1, 16])
def test_zero_cross_gives_exactly_zero(Sq):
    """Cross-attention against the zeroed cross K/V of ``decode_state``:
    exactly 0 in both packages, by the plain version (a decode step) and by
    the flash wrapper (a prefill)."""
    q = np.random.default_rng(5).standard_normal((2, Sq, 4, 16)) * 5
    want = jL.causal_attention(jnp.asarray(q, jnp.bfloat16),
                               jnp.zeros((2, 32, 4, 16), jnp.bfloat16),
                               jnp.zeros((2, 32, 4, 16), jnp.bfloat16),
                               causal=False)
    got = tL.full_attention(torch.from_numpy(q).bfloat16(),
                            torch.zeros((2, 32, 4, 16), dtype=torch.bfloat16),
                            torch.zeros((2, 32, 4, 16), dtype=torch.bfloat16))
    assert float(jnp.abs(want).max()) == 0.0
    assert got.dtype == torch.bfloat16 and float(got.abs().max()) == 0.0


def test_serving_from_zero_cross_matches_a_decoder_without_it(model):
    """The serving step against the zeroed cross K/V equals the same step
    with the cross-attention's output left out (its ``wo`` zeroed), bit
    for bit: the cross-attention adds exactly 0."""
    _, tspec, _, tp = model
    toks = torch.as_tensor(np.random.default_rng(6).integers(0, 256, (2, 8)))
    cut = T.tree_map(lambda t: t, tp)
    cut["dec"] = dict(tp["dec"], cross=dict(
        tp["dec"]["cross"], wo=torch.zeros_like(tp["dec"]["cross"]["wo"])))
    outs = []
    for p in (tp, cut):
        st = tapi.decode_state(tspec, 2, 12, device="cpu")
        with torch.inference_mode():
            lg, st = tapi.apply_decode(p, tspec, toks, st, 0)
            lg2, _ = tapi.apply_decode(p, tspec, toks[:, :1], st, 8)
        outs.append((lg, lg2))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (2, 16))
    labels = rng.integers(0, 256, (2, 16))
    labels[1, :3] = -1
    frames = rng.standard_normal((2, 32, 64)).astype(np.float32)
    return ({"tokens": jnp.asarray(toks, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32),
             "frames": jnp.asarray(frames)},
            {"tokens": torch.as_tensor(toks),
             "labels": torch.as_tensor(labels),
             "frames": torch.from_numpy(frames)})


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_apply_train_loss_and_every_gradient_match(model, compute):
    """``api.apply_train`` with frames and its gradient (the encoder and
    the decoder under ``"dots"``) against JAX's, every leaf, ``enc_pos``
    included (``test_torch_ssm.check_train_parity``)."""
    jspec, tspec, jp, tp = model
    check_train_parity(jspec, tspec, jp, tp, _batch(), compute)


def test_flash_calls_and_grad_norms_a_step(model, monkeypatch):
    """One training step calls the flash forward twice (``"dots"``
    recomputes it) and the flash backward once for each of a layer
    pair's three attentions (the encoder's full one, the decoder's causal
    self-attention and its full cross-attention at Sq != Sk); the gradient
    norms are per layer for ``enc`` and ``dec``."""
    calls = []
    fwd, bwd = tfa.FlashAttention.forward, tfa.flash_attention_bwd

    def counted_fwd(ctx, q, k, v, causal, variant):
        calls.append(("fwd", q.shape[1], k.shape[1], causal))
        return fwd(ctx, q, k, v, causal, variant)

    def counted_bwd(*a, **kw):
        calls.append(("bwd", a[0].shape[1], a[1].shape[1], kw["causal"]))
        return bwd(*a, **kw)

    monkeypatch.setattr(tfa.FlashAttention, "forward",
                        staticmethod(counted_fwd))
    monkeypatch.setattr(tfa, "flash_attention_bwd", counted_bwd)
    _, tspec, _, tp = model
    assert tspec.cfg.remat == "dots"
    _, tb = _batch(1)
    _, grads = tsteps.build_loss_and_grads(tspec)(tp, tb)
    n = tspec.cfg.n_layers
    want = {("fwd", 32, 32, False): 2 * n, ("fwd", 16, 16, True): 2 * n,
            ("fwd", 16, 32, False): 2 * n, ("bwd", 32, 32, False): n,
            ("bwd", 16, 16, True): n, ("bwd", 16, 32, False): n}
    assert {c: calls.count(c) for c in set(calls)} == want
    for path, leaf in T.leaves_with_paths(tsteps.grad_norms(grads)):
        shape = (n,) if path[0] in ("enc", "dec") else ()
        assert leaf.shape == shape and (leaf > 0).all(), path


def _audio_batch(spec, step):
    """The synthetic token stream's batch ``step`` (8 x 16) and frames
    drawn from ``step``."""
    b = SyntheticLM(DataConfig(vocab=spec.cfg.vocab, seq_len=16,
                               global_batch=8, seed=0)).batch(step)
    b["frames"] = torch.randn((8, spec.cfg.enc_len, spec.cfg.d_model),
                              generator=torch.Generator().manual_seed(step))
    return b


def test_train_step_resume_is_bit_exact(model, tmp_path):
    """Six AdamW steps of the reduced whisper through
    ``steps.build_train_step``, against four steps checkpointed by
    ``CheckpointManager`` every two, restored into fresh trees and run to
    six: the same parameters and optimizer state, bit for bit."""
    _, tspec, _, tp = model
    opt_cfg = OptConfig(lr=1e-3, warmup=2)
    step = tsteps.build_train_step(tspec, opt_cfg)

    def run(params, opt, lo, hi, mgr=None):
        for i in range(lo, hi):
            params, opt, stats = step(params, opt, _audio_batch(tspec, i))
            assert np.isfinite(float(stats["loss"]))
            if mgr:
                mgr.maybe_save(i + 1, {"params": params, "opt": opt})
        return params, opt

    pa, oa = run(tp, opt_init(tp, opt_cfg), 0, 6)
    mgr = CheckpointManager(str(tmp_path / "ck"), every=2)
    run(tp, opt_init(tp, opt_cfg), 0, 4, mgr)
    fresh = tapi.init(torch.Generator().manual_seed(9), tspec)
    restored, start = mgr.resume({"params": fresh,
                                  "opt": opt_init(fresh, opt_cfg)})
    assert start == 4
    pb, ob = run(restored["params"], restored["opt"], 4, 6)
    for (path, a), (_, b) in zip(T.leaves_with_paths((pa, oa)),
                                 T.leaves_with_paths((pb, ob))):
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_train_cli_exits_for_audio_as_jax(capsys):
    """Both train CLIs refuse the audio family with the same message."""
    argv = ["--arch", "whisper-medium", "--reduced", "--steps", "1"]
    with pytest.raises(SystemExit) as want:
        jtrain.main(["--arch", "whisper_medium", "--reduced", "--steps",
                     "1"])
    with pytest.raises(SystemExit) as got:
        ttrain.main(argv + ["--device", "cpu"])
    assert str(got.value.code) == str(want.value.code)
    assert re.search("multimodal_train", str(got.value.code))


def test_serve_cli_reduced(capsys):
    gen = tserve.main(["--arch", "whisper-medium", "--reduced", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "16",
                       "--gen", "4"])
    assert gen.shape == (2, 4) and 0 <= gen.min() and gen.max() < 256
    assert "[serve]" in capsys.readouterr().out
