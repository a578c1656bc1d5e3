"""CPU parity of the port's mixture-of-experts family (``models/moe.py``,
the moe branch of ``models/transformer.py``, dbrx-132b and kimi-k2) with
the JAX package.

The JAX package's random weights are carried across by
``convert.from_numpy``; inputs come from numpy seeds and go through both.

Routing is a discontinuous function of the router logits: a token whose
k-th and (k+1)-th logits lie closer than the two packages' rounding
differences may pick another expert in each, and its output then differs
entirely.  So every test that compares outputs first holds the routing:
the same experts, gates within 1e-6, and a gap above ``GAP`` between each
token's k-th and (k+1)-th logit.  A seed that puts a token nearer a tie
fails there, saying so, rather than passing or failing by luck.  Seeds:
the dispatch tests draw x from ``default_rng(seed)`` with the seeds of
``DISPATCH_CASES``; the model tests draw tokens from ``default_rng(1)``
and the JAX weights from ``jax.random.key(0)``.  Two seeds were refused
by the guard and moved: x from seed 11 in bf16 put a token's 3rd and 4th
logits 4.8e-5 apart (``"e8k3"`` uses 12), and the training batch of seed
0 a token's 2nd and 3rd logits 8.2e-4 apart in layer 0 (there the port's
bf16 gradient lay 25% from the fp32 one, JAX's 10%; on the batches of
seeds 1-3, 1.4-1.9% and 1.6-10.6%).

Tolerances: bf16 outputs ``rtol = atol = 2e-2`` against JAX
(``tests/test_models.py``), the three dispatches against each other
``3e-2`` (``tests/test_perf_variants.py``); the router in fp32 ``1e-6``;
the training loss ``rtol 1e-3`` and every gradient leaf as
``tests/test_torch_ssm.py`` holds them (``check_train_parity``).
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.models import api as japi, layers as jL, moe as jM
from repro.models import transformer as jT
from repro_torch import configs as tconfigs, tree as T
from repro_torch.launch import serve as tserve, steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi, convert, moe as tM
from repro_torch.models import transformer as tT

from test_torch_ssm import (assert_state_close, check_train_parity,
                            f32_compute)

BF16 = dict(rtol=2e-2, atol=2e-2)
VARIANTS = dict(rtol=3e-2, atol=3e-2)
GRAD = dict(rtol=5e-2, atol=5e-3)
#: the least gap between a token's k-th and (k+1)-th router logit: on the
#: same inputs (the routing and dispatch tests), and in the model, where
#: the packages' bf16 activations differ by a rounding here and there,
#: which moves a router logit by up to about 1e-3
GAP, MODEL_GAP = 1e-4, 2e-3
ARCHS = {"dbrx_132b": ("dbrx-132b", 130979960832, 35853146112),
         "kimi_k2": ("kimi-k2", 1041000002560, 30894158848)}


def f32(x):
    """A JAX array or a torch tensor as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def jtree(tree):
    return convert.from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def min_gap(logits, k):
    """The least gap between a row's k-th and (k+1)-th largest value."""
    top = np.sort(f32(logits), axis=-1)[..., ::-1]
    return float((top[..., k - 1] - top[..., k]).min())


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_configs_match_jax(arch):
    """Both specs and their ``reduced()`` equal the JAX package's;
    ``param_count()`` and ``active_param_count()`` agree."""
    tname, n, active = ARCHS[arch]
    js, ts = jconfigs.get(arch), tconfigs.get(tname)
    assert type(ts.cfg).__module__ == "repro_torch.models.transformer"
    assert type(ts.cfg.moe).__module__ == "repro_torch.models.moe"
    assert (ts.name, ts.family, ts.skips, ts.source) == \
        (js.name, js.family, js.skips, js.source)
    assert dataclasses.asdict(ts.cfg) == dataclasses.asdict(js.cfg)
    assert ts.cfg.param_count() == js.cfg.param_count() == n
    assert ts.cfg.active_param_count() == js.cfg.active_param_count() == \
        active
    jr, tr = jconfigs.reduced(js), tconfigs.reduced(ts)
    assert dataclasses.asdict(tr.cfg) == dataclasses.asdict(jr.cfg)
    assert tr.cfg.param_count() == jr.cfg.param_count()
    assert tr.cfg.active_param_count() == jr.cfg.active_param_count()


@pytest.mark.parametrize("factor", [1.0, 1.25, 8.0])
@pytest.mark.parametrize("E", [4, 16, 384])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_capacity_matches(k, E, factor):
    for g in (1, 3, 8, 32, 100, 512):
        jc = jM.MoEConfig(n_experts=E, top_k=k, d_model=8, d_ff=8,
                          capacity_factor=factor)
        tc = tM.MoEConfig(n_experts=E, top_k=k, d_model=8, d_ff=8,
                          capacity_factor=factor)
        assert tM._capacity(tc, g) == jM._capacity(jc, g), g


def test_group_keeps_its_assert():
    cfg = tM.MoEConfig(n_experts=4, top_k=2, d_model=8, d_ff=8,
                       group_size=32)
    xg, g = tM._group(torch.zeros((2, 64, 8)), cfg)
    assert g == 32 and xg.shape == (4, 32, 8)
    with pytest.raises(AssertionError):
        tM._group(torch.zeros((1, 48, 8)), cfg)


# (n_experts, top_k, d_model, d_ff, group_size, B, S, seed)
DISPATCH_CASES = {"e4k2": (4, 2, 16, 32, 32, 2, 64, 10),
                  "e8k3": (8, 3, 32, 48, 16, 2, 48, 12)}


def _moe_case(name, factor, dtype="bf16"):
    """The JAX config and weights (``moe_init``), the port's config and
    the same weights, and x from a numpy seed in both packages."""
    E, k, D, Fd, g, B, S, seed = DISPATCH_CASES[name]
    kw = dict(n_experts=E, top_k=k, d_model=D, d_ff=Fd,
              capacity_factor=factor, group_size=g)
    jc, tc = jM.MoEConfig(**kw), tM.MoEConfig(**kw)
    jp = jM.moe_init(jax.random.key(seed), jc)
    x = jnp.asarray(np.random.default_rng(seed).standard_normal((B, S, D)),
                    jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    return jc, tc, jp, jtree(jp), x, torch.from_numpy(f32(x)).to(
        torch.bfloat16 if dtype == "bf16" else torch.float32)


def _check_route(jc, tc, jp, tp, jx, tx):
    """The same experts and gates within 1e-6 for every token, each with
    a gap above ``GAP``; returns the port's (gates, experts)."""
    jxg, _ = jM._group(jx, jc)
    txg, _ = tM._group(tx, tc)
    jg, ji = jM._route(jp, jc, jxg)
    tg, ti = tM._route(tp, tc, txg)
    logits = txg.float() @ tp["router"]
    assert min_gap(logits, tc.top_k) > GAP
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)
    return tg, ti


@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_route_matches(case):
    jc, tc, jp, tp, jx, tx = _moe_case(case, 1.25, "f32")
    _check_route(jc, tc, jp, tp, jx, tx)


def test_route_breaks_ties_to_the_lower_index():
    """Equal logits: the lower expert first, as ``jax.lax.top_k``."""
    logits = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    vals, idx = tM._top_k(logits, 3)
    assert idx.tolist() == [[1, 2, 4]] and vals.tolist() == [[3.0] * 3]
    _, jidx = jax.lax.top_k(jnp.asarray(logits.numpy()), 3)
    assert np.asarray(jidx).tolist() == idx.tolist()


@pytest.mark.parametrize("dispatch", ["onehot", "sort", "scatter"])
@pytest.mark.parametrize("factor", [1.0, 8.0])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_dispatch_matches_jax(case, dtype, factor, dispatch):
    """Each dispatch against the JAX one of the same name on the same
    inputs; at factor 1.0 pairs are dropped (checked), at 8.0 none."""
    jc, tc, jp, tp, jx, tx = _moe_case(case, factor, dtype)
    _, ti = _check_route(jc, tc, jp, tp, jx, tx)
    onehot, rank = tM._onehot_ranks(ti, tc.n_experts)
    xg, g = tM._group(tx, tc)
    dropped = int(((rank >= tM._capacity(tc, g)) & (onehot > 0)).sum())
    assert (dropped > 0) == (factor == 1.0), dropped
    jfn = {"onehot": jM.moe_apply_onehot, "sort": jM.moe_apply_sorted,
           "scatter": jM.moe_apply_scatter}[dispatch]
    tfn = {"onehot": tM.moe_apply_onehot, "sort": tM.moe_apply_sorted,
           "scatter": tM.moe_apply_scatter}[dispatch]
    want = jfn(jp, jc, jx)
    got = tfn(tp, tc, tx)
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    np.testing.assert_allclose(f32(got), f32(want), **BF16)


@pytest.mark.parametrize("factor", [1.0, 1.25, 8.0])
@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_dispatches_agree(case, factor):
    """The three dispatches of the port against each other, drops
    included (after ``tests/test_perf_variants.py::
    test_moe_dispatch_variants_agree``), and ``moe_apply`` picks the one
    its config names."""
    _, tc, _, tp, _, tx = _moe_case(case, factor)
    base = tM.moe_apply_onehot(tp, tc, tx)
    for dispatch in ("onehot", "sort", "scatter"):
        cfg = dataclasses.replace(tc, dispatch=dispatch)
        got = tM.moe_apply(tp, cfg, tx)
        np.testing.assert_allclose(f32(got), f32(base), **VARIANTS,
                                   err_msg=dispatch)


def test_dropped_pairs_are_the_same_in_every_dispatch():
    """With one expert's weights scaled up, a token's output shows which
    of its pairs reached that expert: the three dispatches drop the same
    (token, choice) pairs (an output exactly equal where a token lost
    every pair)."""
    _, tc, _, tp, _, tx = _moe_case("e4k2", 1.0)
    outs = [tM.moe_apply(tp, dataclasses.replace(tc, dispatch=d), tx)
            for d in ("onehot", "sort", "scatter")]
    zero = [(o.float().abs().sum(-1) == 0) for o in outs]
    assert torch.equal(zero[0], zero[1]) and torch.equal(zero[0], zero[2])


def test_unknown_dispatch_raises():
    _, tc, _, tp, _, tx = _moe_case("e4k2", 8.0)
    with pytest.raises(ValueError):
        tM.moe_apply(tp, dataclasses.replace(tc, dispatch="ring"), tx)
    with pytest.raises(ValueError):
        jM.moe_apply(jM.moe_init(jax.random.key(0), jM.MoEConfig(
            4, 2, 16, 32, dispatch="ring")), jM.MoEConfig(
                4, 2, 16, 32, dispatch="ring"), jnp.zeros((1, 8, 16)))


@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_aux_load_balance_loss_matches(case):
    jc, tc, jp, tp, jx, tx = _moe_case(case, 1.25, "f32")
    _check_route(jc, tc, jp, tp, jx, tx)
    want = jM.aux_load_balance_loss(jp, jc, jx)
    got = tM.aux_load_balance_loss(tp, tc, tx)
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_moe_init_shapes_scales_and_slices(monkeypatch):
    """``moe_init``: the router fp32 (D, E), ``wi``/``wg`` (E, D, F) and
    ``wo`` (E, F, D) bf16, He-scaled; stacked on ``lead``; drawn a slice
    at a time (a budget of 3 experts' worth here gives the same shapes and
    scales, the experts filled in slices of 3, 3 and 1)."""
    cfg = tM.MoEConfig(n_experts=7, top_k=2, d_model=64, d_ff=96)
    monkeypatch.setattr(tM, "_FILL_ELEMS", 3 * 64 * 96)
    draws = []
    real = torch.randn

    def counted(shape, *a, **kw):
        draws.append(tuple(shape))
        return real(shape, *a, **kw)

    monkeypatch.setattr(torch, "randn", counted)
    p = tM.moe_init(torch.Generator().manual_seed(0), cfg, lead=(2,))
    assert p["router"].dtype == torch.float32
    assert p["router"].shape == (2, 64, 7)
    for name, shape in (("wi", (2, 7, 64, 96)), ("wg", (2, 7, 64, 96)),
                        ("wo", (2, 7, 96, 64))):
        w = p[name]
        assert w.dtype == torch.bfloat16 and w.shape == shape
        fan_in = shape[-2]
        assert abs(float(w.float().std()) - fan_in ** -0.5) < 0.01
        assert bool((w != 0).all()), name
    assert draws.count((3, 64, 96)) == 8 and draws.count((1, 64, 96)) == 4
    meta = tM.moe_init(torch.Generator(), cfg, lead=(2,), device="meta")
    assert {t.device.type for t in meta.values()} == {"meta"}


# ------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def model():
    jspec = jconfigs.reduced(jconfigs.get("dbrx_132b"))
    tspec = tconfigs.reduced(tconfigs.get("dbrx-132b"))
    jp = japi.init(jax.random.key(0), jspec)
    return jspec, tspec, jp, jtree(jp)


def jax_routes(jp, jspec, tokens, kv=None, cache_index=None):
    """The JAX model's experts layer by layer (``transformer._block`` in a
    Python loop, the forward's scan unrolled so that ``moe._route`` sees
    values), on the same tokens and decode state."""
    seen = []
    real = jM._route

    def rec(p, cfg, xg):
        gates, topi = real(p, cfg, xg)
        seen.append(np.asarray(topi))
        return gates, topi

    cfg = jspec.cfg
    x = jnp.take(jp["embed"], tokens, axis=0).astype(jL.COMPUTE_DTYPE)
    B, S, _ = x.shape
    start = 0 if cache_index is None else cache_index
    pos = jnp.broadcast_to(start + jnp.arange(S, dtype=jnp.int32)[None],
                           (B, S))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jM, "_route", rec)
        for i in range(cfg.n_layers):
            lp = jax.tree.map(lambda a: a[i], jp["layers"])
            cache = None if kv is None else (kv[0][i], kv[1][i])
            x, _ = jT._block(cfg, lambda t, *a: t, lp, x, pos, cache,
                             cache_index)
    return seen


class Routes:
    """Records the port's routing: every ``_route`` call's experts and the
    least gap between a token's k-th and (k+1)-th logit."""

    def __init__(self, mp):
        self.topi, self.gaps = [], []
        real = tM._route

        def rec(p, cfg, xg):
            gates, topi = real(p, cfg, xg)
            self.topi.append(topi.numpy())
            self.gaps.append(min_gap(xg.float() @ p["router"], cfg.top_k))
            return gates, topi

        mp.setattr(tM, "_route", rec)

    def check(self, want):
        """The same experts as the JAX model's, each token clear of a
        tie by ``MODEL_GAP``."""
        assert min(self.gaps) > MODEL_GAP, self.gaps
        assert len(self.topi) == len(want)
        for a, b in zip(self.topi, want):
            np.testing.assert_array_equal(a, b)
        self.topi, self.gaps = [], []


def test_init_has_the_jax_tree(model):
    """``api.init`` and ``param_shapes`` (``meta``) have the JAX tree's
    shapes and dtypes: ``moe`` in the place of ``ffn``, the router fp32."""
    jspec, tspec, jp, _ = model
    tp = tapi.init(torch.Generator().manual_seed(0), tspec)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
    for tree, dev in ((tp, "cpu"), (tapi.param_shapes(tspec), "meta")):
        got = T.tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), tree)
        assert got == want
        assert {t.device.type for t in T.leaves(tree)} == {dev}
    assert "ffn" not in tp["layers"]
    assert tp["layers"]["moe"]["router"].dtype == torch.float32


def test_forward_matches(model, monkeypatch):
    jspec, tspec, jp, tp = model
    toks = np.random.default_rng(1).integers(0, 256, (2, 16))
    routes = Routes(monkeypatch)
    want = jT.forward(jp, jspec.cfg, jnp.asarray(toks, jnp.int32))
    got = tT.forward(tp, tspec.cfg, torch.as_tensor(toks))
    routes.check(jax_routes(jp, jspec, jnp.asarray(toks, jnp.int32)))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(f32(got), f32(want), **BF16)


def test_prefill_then_decode_match(model, monkeypatch):
    """A one-step prefill of (B, P) tokens at cache index 0, then decode
    steps with the caches carried, against JAX ``api.apply_decode`` on the
    same tokens: logits within 2e-2, the KV caches within a relative
    Frobenius error of 2e-2 per layer (as ``tests/test_torch_lm.py``
    holds them: a bf16 rounding of the residual that differs moves single
    entries past 2e-2) and the same experts at every step."""
    jspec, tspec, jp, tp = model
    routes = Routes(monkeypatch)
    B, P, T_ = 2, 16, 24
    rng = np.random.default_rng(1)
    steps = [rng.integers(0, 256, (B, P))] + \
        [rng.integers(0, 256, (B, 1)) for _ in range(4)]
    jst = japi.decode_state(jspec, B, T_)
    tst = tapi.decode_state(tspec, B, T_, device="cpu")
    ci = 0
    for i, toks in enumerate(steps):
        jtoks = jnp.asarray(toks, jnp.int32)
        want_routes = jax_routes(jp, jspec, jtoks, jst["kv"], ci)
        jl, jst = japi.apply_decode(jp, jspec, jtoks, jst, ci)
        with torch.inference_mode():
            tl, tst = tapi.apply_decode(tp, tspec, torch.as_tensor(toks),
                                        tst, ci)
        routes.check(want_routes)
        ci += toks.shape[1]
        np.testing.assert_allclose(f32(tl), f32(jl), **BF16,
                                   err_msg=f"step {i}")
        assert_state_close(tst["kv"], jst["kv"], f"kv after step {i}")


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
def test_apply_train_loss_and_every_gradient_match(model, monkeypatch,
                                                   compute):
    """``api.apply_train`` and its gradient (through the ``"dots"``
    remat) against ``jax.value_and_grad(api.apply_train)``, every leaf,
    the router's and every expert's included
    (``test_torch_ssm.check_train_parity``: the loss within 1e-3; with
    fp32 activations in both packages every leaf within rtol 5e-2 / atol
    5e-3, measured 1.1e-6 of each leaf's norm; in bf16 within 0.25 of the
    fp32 gradient's norm, since the two packages' bf16 gradients lie 9% to
    23% from each other here), with the same experts in both."""
    jspec, tspec, jp, tp = model
    batches = _batch(1)
    routes = Routes(monkeypatch)
    check_train_parity(jspec, tspec, jp, tp, batches, compute)
    with pytest.MonkeyPatch.context() as mp:
        jr = f32_compute(mp, jp)[0] if compute == "f32" else jp
        want = jax_routes(jr, jspec, batches[0]["tokens"])
    # the dots remat runs each layer's routing again in the backward pass,
    # the last layer first
    routes.check(want + want[::-1])


class BmmCount(TorchDispatchMode):
    """Counts ``aten.bmm`` and ``aten.mm`` calls that run, each by the
    function they ran inside (``where``: set by the callers' wrappers)."""

    def __init__(self):
        super().__init__()
        self.where, self.counts = None, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.where and func in (torch.ops.aten.bmm.default,
                                   torch.ops.aten.mm.default):
            key = (self.where, func.__name__.split(".")[0])
            self.counts[key] = self.counts.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat", ["dots", "none"])
def test_dots_remat_recomputes_the_expert_products(model, monkeypatch,
                                                   remat):
    """Under ``"dots"`` a training step runs each layer's three expert
    products (``aten.bmm``) twice, the forward and the recompute, and the
    router product (a 2-D ``aten.mm``) once, kept; under ``"none"`` each
    once.  The products of the backward pass run outside the counted
    functions."""
    _, tspec, _, tp = model
    spec = dataclasses.replace(tspec, cfg=dataclasses.replace(
        tspec.cfg, remat=remat))
    mode = BmmCount()

    def inside(name, fn):
        def run(*a):
            was, mode.where = mode.where, name
            try:
                return fn(*a)
            finally:
                mode.where = was
        return run

    monkeypatch.setattr(tM, "_expert_ffn", inside("experts",
                                                  tM._expert_ffn))
    monkeypatch.setattr(tM, "_route", inside("router", tM._route))
    _, tb = _batch(1)
    with mode:
        tsteps.build_loss_and_grads(spec)(tp, tb)
    n = spec.cfg.n_layers
    runs = 2 if remat == "dots" else 1
    assert mode.counts == {("experts", "bmm"): 3 * n * runs,
                           ("router", "mm"): n}


def test_grad_norms_by_layer(model):
    _, tspec, _, tp = model
    _, tb = _batch(2)
    _, grads = tsteps.build_loss_and_grads(tspec)(tp, tb)
    for path, leaf in T.leaves_with_paths(tsteps.grad_norms(grads)):
        want = (tspec.cfg.n_layers,) if path[0] == "layers" else ()
        assert leaf.shape == want and (leaf > 0).all(), path


def test_serve_cli_reduced(capsys):
    for arch in ("dbrx-132b", "kimi-k2"):
        gen = tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "16", "--gen",
                           "4"])
        assert gen.shape == (2, 4) and 0 <= gen.min() and gen.max() < 256
    assert capsys.readouterr().out.count("[serve]") == 2


ARGS = ["--arch", "dbrx-132b", "--reduced", "--device", "cpu",
        "--steps", "8", "--seq", "32", "--batch", "4", "--log-every", "1"]


def test_train_cli_and_bit_exact_resume(tmp_path, capsys):
    """The train CLI at ``--reduced --device cpu`` for dbrx: finite losses
    and gradient norms; a run that dies at step 5 and resumes from the
    checkpoint of step 4 ends with the uninterrupted run's parameters, bit
    for bit (the experts' and the router's included)."""
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
    assert "moe" in pb["layers"]
    for (path, a), (_, b) in zip(T.leaves_with_paths(pa),
                                 T.leaves_with_paths(pb)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b), path
