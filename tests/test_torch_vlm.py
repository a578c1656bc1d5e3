"""CPU parity of the port's vlm family (``models/vlm.py``, paligemma-3b)
with the JAX package.

The reduced paligemma-3b configuration (2 layers, d_model 64, 4/1 heads of
16, vocabulary 256, 8 image patches of width 48), the JAX package's random
weights carried across by ``convert.from_numpy``, and numpy inputs (patch
embeddings from ``default_rng``) through both.  Tolerances as
``tests/test_torch_lm.py`` and ``tests/test_torch_ssm.py``: bf16
activations and logits ``rtol = atol = 2e-2``; decode caches by relative
Frobenius error per layer (``assert_state_close``, 2e-2); the training
loss ``rtol 1e-3`` and every gradient leaf by ``check_train_parity`` (fp32
activations in both packages elementwise within ``rtol 5e-2, atol
5e-3``, bf16 against the fp32 gradient's norm).

The JAX vlm's attention is causal over the image prefix too (its
docstring's "prefix-LM style" is not what its code computes); the port
follows the code.  Also here: ``transformer.forward``/``loss`` of a dense
config with ``prefix_embed`` and ``prefix_drop``, and the two faults the
vlm slice repaired (``configs.reduced`` of a family without a small
config, ``api``'s error for an unknown family), each against the JAX
package.
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
from repro.models import api as japi, transformer as jT, vlm as jV
from repro_torch import configs as tconfigs, tree as T
from repro_torch.ckpt import CheckpointManager
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import serve as tserve, steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi, transformer as tT, vlm as tV
from repro_torch.optim import OptConfig, opt_init

from test_torch_ssm import (BF16, assert_state_close, check_train_parity,
                            f32, jtree)

#: ``VLMConfig.param_count()`` of paligemma-3b, read from the JAX config
N_PARAMS = 2511022080


@pytest.fixture(scope="module")
def model():
    jspec = jconfigs.reduced(jconfigs.get("paligemma_3b"))
    tspec = tconfigs.reduced(tconfigs.get("paligemma-3b"))
    jp = japi.init(jax.random.key(0), jspec)
    return jspec, tspec, jp, jtree(jp)


def _patches(spec, B=2, seed=3):
    """Stub patch embeddings (B, n_patches, d_vision) fp32 for both."""
    a = np.random.default_rng(seed).standard_normal(
        (B, spec.cfg.n_patches, spec.cfg.d_vision)).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _tokens(B, S, seed):
    toks = np.random.default_rng(seed).integers(0, 256, (B, S))
    return jnp.asarray(toks, jnp.int32), torch.as_tensor(toks)


def test_config_matches_jax():
    """The spec and its ``reduced()`` equal the JAX package's, the LM's
    attention config too; ``param_count()`` is 2,511,022,080 in both
    (``vision_proj`` counted); the full LM has one KV head of 256 and the
    reduced one 4/1 heads of 16 and 8 patches of width 48."""
    js, ts = jconfigs.get("paligemma_3b"), tconfigs.get("paligemma-3b")
    assert type(ts.cfg).__module__ == "repro_torch.models.vlm"
    assert (ts.name, ts.family, ts.skips, ts.source) == \
        (js.name, js.family, js.skips, js.source)
    assert dataclasses.asdict(ts.cfg) == dataclasses.asdict(js.cfg)
    assert ts.cfg.param_count() == js.cfg.param_count() == N_PARAMS
    assert ts.cfg.active_param_count() == js.cfg.active_param_count()
    assert ts.cfg.lm.attn.__dict__ == js.cfg.lm.attn.__dict__
    assert (ts.cfg.lm.n_kv, ts.cfg.lm.dh, ts.cfg.lm.vocab) == (1, 256, 257216)
    jr, tr = jconfigs.reduced(js), tconfigs.reduced(ts)
    assert dataclasses.asdict(tr.cfg) == dataclasses.asdict(jr.cfg)
    assert (tr.cfg.n_patches, tr.cfg.d_vision, tr.cfg.lm.n_kv,
            tr.cfg.lm.dh) == (8, 48, 1, 16)
    assert tr.cfg.param_count() == jr.cfg.param_count()


def test_init_has_the_jax_tree(model):
    """``api.init``, ``param_shapes`` (``meta``) and the converted JAX
    parameters have the JAX tree's paths, shapes and dtypes,
    ``vision_proj`` (d_vision, d_model) bf16 in it, He-scaled; the
    parameter count is ``param_count()``."""
    jspec, tspec, jp, tp_conv = model
    tp = tapi.init(torch.Generator().manual_seed(0), tspec)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
    assert want["vision_proj"] == ((48, 64), "bfloat16")
    for tree, dev in ((tp, "cpu"), (tp_conv, "cpu"),
                      (tapi.param_shapes(tspec), "meta")):
        got = T.tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), tree)
        assert got == want
        assert {t.device.type for t in T.leaves(tree)} == {dev}
    assert abs(float(tp["vision_proj"].float().std()) - 48 ** -0.5) < 0.02
    assert sum(t.numel() for t in T.leaves(tp)) == tspec.cfg.param_count()
    full = tapi.param_shapes(tconfigs.get("paligemma-3b"))
    assert tuple(full["vision_proj"].shape) == (1152, 2048)
    assert sum(t.numel() for t in T.leaves(full)) == N_PARAMS


def test_forward_with_patches_matches(model):
    """``vlm.forward`` with patches: logits (B, P + S, V) fp32 over the
    image prefix's positions too, within 2e-2 of JAX's; without patches
    it is the LM's ``transformer.forward`` on the tokens alone."""
    jspec, tspec, jp, tp = model
    jpa, tpa = _patches(tspec)
    jt, tt = _tokens(2, 16, 1)
    want = jV.forward(jp, jspec.cfg, jt, jpa)
    got = tV.forward(tp, tspec.cfg, tt, tpa)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape \
        == (2, 24, 256)
    np.testing.assert_allclose(f32(got), f32(want), **BF16)
    assert torch.equal(tV.forward(tp, tspec.cfg, tt, None),
                       tT.forward(tp, tspec.cfg.lm, tt))


def test_prefill_with_patches_then_decode_match(model):
    """A prefill of the image prefix and 8 text tokens through
    ``vlm.forward`` with caches at cache index 0, then 3 decode steps
    through ``api.apply_decode`` (no patches, positions from 16): logits
    within 2e-2 and the caches within 2e-2 per layer of JAX's on the same
    tokens and state."""
    jspec, tspec, jp, tp = model
    B, T_ = 2, 24
    jpa, tpa = _patches(tspec, B, 4)
    jst = japi.decode_state(jspec, B, T_)
    tst = tapi.decode_state(tspec, B, T_, device="cpu")
    jt, tt = _tokens(B, 8, 5)
    jl, jkv = jV.forward(jp, jspec.cfg, jt, jpa, kv_caches=jst["kv"],
                         cache_index=0)
    with torch.inference_mode():
        tl, tkv = tV.forward(tp, tspec.cfg, tt, tpa, kv_caches=tst["kv"],
                             cache_index=0)
    np.testing.assert_allclose(f32(tl), f32(jl), **BF16, err_msg="prefill")
    assert_state_close(tkv, jkv, "kv after the prefill")
    jst, tst = {"kv": jkv}, {"kv": tkv}
    ci = tspec.cfg.n_patches + 8
    rng = np.random.default_rng(6)
    for i in range(3):
        toks = rng.integers(0, 256, (B, 1))
        jl, jst = japi.apply_decode(jp, jspec, jnp.asarray(toks, jnp.int32),
                                    jst, ci)
        with torch.inference_mode():
            tl, tst = tapi.apply_decode(tp, tspec, torch.as_tensor(toks),
                                        tst, ci)
        ci += 1
        np.testing.assert_allclose(f32(tl), f32(jl), **BF16,
                                   err_msg=f"decode step {i}")
        assert_state_close(tst["kv"], jst["kv"], f"kv after step {i}")


def test_decode_state_shapes(model):
    """Sized by the LM: (L, B, T, n_kv, dh) bf16 zeros, as JAX's."""
    jspec, tspec, _, _ = model
    jst = japi.decode_state(jspec, 3, 20)
    tst = tapi.decode_state(tspec, 3, 20, device="cpu")
    assert T.tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), tst) \
        == jax.tree.map(lambda a: (a.shape, str(a.dtype)), jst)
    assert tst["kv"][0].shape == (2, 3, 20, 1, 16)
    assert all(float(t.abs().max()) == 0 for t in T.leaves(tst))


def _batch(spec, seed=0, B=2, S=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (B, S))
    labels = rng.integers(0, 256, (B, S))
    labels[1, :3] = -1
    patches = rng.standard_normal(
        (B, spec.cfg.n_patches, spec.cfg.d_vision)).astype(np.float32)
    return ({"tokens": jnp.asarray(toks, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32),
             "patches": jnp.asarray(patches)},
            {"tokens": torch.as_tensor(toks),
             "labels": torch.as_tensor(labels),
             "patches": torch.from_numpy(patches)})


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_apply_train_loss_and_every_gradient_match(model, compute):
    """``api.apply_train`` with patches (the loss over the text positions,
    the prefix dropped) and its gradient under ``"dots"`` against JAX's,
    every leaf, ``vision_proj`` included
    (``test_torch_ssm.check_train_parity``)."""
    jspec, tspec, jp, tp = model
    check_train_parity(jspec, tspec, jp, tp, _batch(tspec), compute)


@pytest.fixture(scope="module")
def dense():
    jspec = jconfigs.reduced(jconfigs.get("qwen3_0p6b"))
    tspec = tconfigs.reduced(tconfigs.get("qwen3-0.6b"))
    jp = japi.init(jax.random.key(1), jspec)
    return jspec.cfg, tspec.cfg, jp, jtree(jp)


def _prefix(B=2, P=4, D=64, seed=8):
    a = np.random.default_rng(seed).standard_normal((B, P, D)) * 0.02
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(f32(j)).bfloat16()


def test_transformer_prefix_forward_matches(dense):
    """``transformer.forward`` of a dense config (the reduced qwen3,
    qk-norm) with ``prefix_embed`` (B, 4, D): without caches, and with
    caches at cache index 0 (positions over the whole P + S), logits and
    caches against JAX's."""
    jcfg, tcfg, jp, tp = dense
    jpre, tpre = _prefix()
    jt, tt = _tokens(2, 12, 9)
    want = jT.forward(jp, jcfg, jt, prefix_embed=jpre)
    got = tT.forward(tp, tcfg, tt, prefix_embed=tpre)
    assert tuple(got.shape) == want.shape == (2, 16, 256)
    np.testing.assert_allclose(f32(got), f32(want), **BF16)
    kd = (2, 2, 20, 2, 16)
    jl, jkv = jT.forward(jp, jcfg, jt, prefix_embed=jpre, cache_index=0,
                         kv_caches=(jnp.zeros(kd, jnp.bfloat16),
                                    jnp.zeros(kd, jnp.bfloat16)))
    with torch.inference_mode():
        tl, tkv = tT.forward(tp, tcfg, tt, prefix_embed=tpre, cache_index=0,
                             kv_caches=(torch.zeros(kd, dtype=torch.bfloat16),
                                        torch.zeros(kd,
                                                    dtype=torch.bfloat16)))
    np.testing.assert_allclose(f32(tl), f32(jl), **BF16)
    assert_state_close(tkv, jkv, "kv with a prefix")


@pytest.mark.parametrize("loss_chunk", [0, 4])
def test_transformer_prefix_loss_matches(dense, loss_chunk):
    """``transformer.loss`` with ``prefix_embed`` and ``prefix_drop`` = 4,
    unchunked (JAX slices its logits, the port the trunk's output) and
    chunked (both slice the trunk's output), against JAX's within 1e-3;
    the gradient of the prefix itself within 2e-2 elementwise."""
    jcfg, tcfg, jp, tp = dense
    jcfg, tcfg = (dataclasses.replace(c, loss_chunk=loss_chunk)
                  for c in (jcfg, tcfg))
    jpre, tpre = _prefix(seed=10)
    jt, tt = _tokens(2, 12, 11)
    jlab, tlab = _tokens(2, 12, 12)

    def jloss(pre):
        return jT.loss(jp, jcfg, jt, jlab, prefix_embed=pre, prefix_drop=4)

    want, jg = jax.value_and_grad(jloss)(jpre.astype(jnp.float32))
    tpre32 = tpre.float().requires_grad_(True)
    got = tT.loss(tp, tcfg, tt, tlab, prefix_embed=tpre32, prefix_drop=4)
    (tg,) = torch.autograd.grad(got, tpre32)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-3)
    np.testing.assert_allclose(f32(tg), f32(jg), **BF16)


def test_flash_calls_a_step(model, monkeypatch):
    """One training step calls the flash forward twice (``"dots"``
    recomputes it) and the backward once a layer, each over the whole P +
    S positions, causal; the gradient norms are per layer under
    ``"layers"`` and ``vision_proj``'s is non-zero."""
    calls = []
    fwd, bwd = tfa.FlashAttention.forward, tfa.flash_attention_bwd

    def counted_fwd(ctx, q, k, v, causal, variant):
        calls.append(("fwd", q.shape[1], k.shape[2], causal))
        return fwd(ctx, q, k, v, causal, variant)

    def counted_bwd(*a, **kw):
        calls.append(("bwd", a[0].shape[1], a[1].shape[2], kw["causal"]))
        return bwd(*a, **kw)

    monkeypatch.setattr(tfa.FlashAttention, "forward",
                        staticmethod(counted_fwd))
    monkeypatch.setattr(tfa, "flash_attention_bwd", counted_bwd)
    _, tspec, _, tp = model
    assert tspec.cfg.lm.remat == "dots"
    _, tb = _batch(tspec, 1)
    _, grads = tsteps.build_loss_and_grads(tspec)(tp, tb)
    n = tspec.cfg.lm.n_layers
    assert {c: calls.count(c) for c in set(calls)} == {
        ("fwd", 24, 1, True): 2 * n, ("bwd", 24, 1, True): n}
    norms = tsteps.grad_norms(grads)
    assert norms["vision_proj"].shape == () and norms["vision_proj"] > 0
    for leaf in T.leaves(norms["layers"]):
        assert leaf.shape == (n,) and (leaf > 0).all()


def test_accum_two_splits_the_patches(model):
    """``build_loss_and_grads(accum=2)`` splits every batch leaf, the
    (B, P, d_vision) patches included, on its leading axis: its loss and
    gradients equal, bit for bit, the mean of the two half batches' and
    the fp32 sum of their gradients halved."""
    _, tspec, _, tp = model
    _, tb = _batch(tspec, 2, B=4)
    l2, g2 = tsteps.build_loss_and_grads(tspec, accum=2)(tp, tb)
    one = tsteps.build_loss_and_grads(tspec)
    (la, ga), (lb, gb) = (one(tp, {k: v[s] for k, v in tb.items()})
                          for s in (slice(0, 2), slice(2, 4)))
    assert torch.equal(l2, torch.stack([la, lb]).mean())
    for x, a, b in zip(T.leaves(g2), T.leaves(ga), T.leaves(gb)):
        assert x.dtype == torch.float32
        assert torch.equal(x, a.float() / 2 + b.float() / 2)


def _vlm_batch(spec, step):
    """The synthetic token stream's batch ``step`` (8 x 16) and patches
    drawn from ``step``."""
    b = SyntheticLM(DataConfig(vocab=spec.cfg.lm.vocab, seq_len=16,
                               global_batch=8, seed=0)).batch(step)
    b["patches"] = torch.randn((8, spec.cfg.n_patches, spec.cfg.d_vision),
                               generator=torch.Generator().manual_seed(step))
    return b


def test_train_step_with_accum_resume_is_bit_exact(model, tmp_path):
    """Six AdamW steps of the reduced paligemma with patches through
    ``steps.build_train_step(accum=2)``, against four steps checkpointed
    by ``CheckpointManager`` every two, restored into fresh trees and run
    to six: the same parameters and optimizer state, bit for bit."""
    _, tspec, _, tp = model
    opt_cfg = OptConfig(lr=1e-3, warmup=2)
    step = tsteps.build_train_step(tspec, opt_cfg, accum=2)

    def run(params, opt, lo, hi, mgr=None):
        for i in range(lo, hi):
            params, opt, stats = step(params, opt, _vlm_batch(tspec, i))
            assert np.isfinite(float(stats["loss"]))
            if mgr:
                mgr.maybe_save(i + 1, {"params": params, "opt": opt})
        return params, opt

    pa, oa = run(tp, opt_init(tp, opt_cfg), 0, 6)
    assert not torch.equal(pa["vision_proj"], tp["vision_proj"])
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


def test_serve_cli_reduced(capsys):
    """The serve CLI at ``--reduced``: text only (no patches), as the JAX
    CLI serves the vlm family; tokens in the LM's vocabulary."""
    gen = tserve.main(["--arch", "paligemma-3b", "--reduced", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "16",
                       "--gen", "4"])
    assert gen.shape == (2, 4) and 0 <= gen.min() and gen.max() < 256
    assert "[serve]" in capsys.readouterr().out


def test_train_cli_exits_for_vlm_as_jax(capsys):
    """Both train CLIs refuse the vlm family with the same message."""
    with pytest.raises(SystemExit) as want:
        jtrain.main(["--arch", "paligemma_3b", "--reduced", "--steps", "1"])
    with pytest.raises(SystemExit) as got:
        ttrain.main(["--arch", "paligemma-3b", "--reduced", "--steps", "1",
                     "--device", "cpu"])
    assert str(got.value.code) == str(want.value.code)
    assert re.search("vlm/audio", str(got.value.code))


def test_reduced_keeps_a_family_without_a_small_config_as_jax():
    """``configs.reduced`` of the overlay's ``flexgrip`` (no small config)
    returns the spec unchanged in both packages."""
    js, ts = jconfigs.get("flexgrip"), tconfigs.get("flexgrip")
    assert jconfigs.reduced(js) is js
    assert tconfigs.reduced(ts) is ts


@pytest.mark.parametrize("entry", ["init", "decode_state", "apply_decode"])
def test_api_unknown_family_raises_value_error_as_jax(entry):
    """``api`` of an unknown family raises ``ValueError`` naming it, in
    both packages."""
    jspec = jconfigs.ArchSpec(name="x", family="nosuch", cfg=None)
    tspec = tconfigs.ArchSpec(name="x", family="nosuch", cfg=None)
    calls = {
        "init": (lambda: japi.init(jax.random.key(0), jspec),
                 lambda: tapi.init(torch.Generator(), tspec)),
        "decode_state": (lambda: japi.decode_state(jspec, 1, 4),
                         lambda: tapi.decode_state(tspec, 1, 4,
                                                   device="cpu")),
        "apply_decode": (lambda: japi.apply_decode(None, jspec, None, None,
                                                   0),
                         lambda: tapi.apply_decode(None, tspec, None, None,
                                                   0))}[entry]
    for call in calls:
        with pytest.raises(ValueError, match="nosuch"):
            call()
