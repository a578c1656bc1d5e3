"""The port's device meshes and sharding rules (``repro_torch.launch.mesh``)
against the JAX package's (``repro.launch.mesh``), on the CPU.

The rules are pure functions of a path, a shape and the mesh's axis sizes.
Both packages are given the same ``FakeMesh``-style object (``shape`` and
``axis_names`` only, as ``tests/test_sharding.py`` gives the JAX rules) at
shapes (1, 1), (4, 2), (2, 4), (16, 16) and (2, 16, 16), and each spec is
held equal as a tuple: ``param_spec`` over every leaf of every
architecture's parameter tree, ``opt_spec`` over the optimizer state's in
both modes, ``act_spec`` over every kind under ``"tp"`` and ``"seq"``,
``batch_spec``, and ``decode_state_spec`` over ``api.decode_state``'s
shapes.  The port's own trees (``api.param_shapes`` on the meta device)
have the JAX trees' paths and shapes.  The JAX package's golden tables are
re-asserted on the port.  Tolerance: none.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.launch import mesh as JM
from repro.models import api as japi
from repro.optim import OptConfig as JOpt, opt_init as jopt_init
from repro_torch import configs as tconfigs
from repro_torch import tree as T
from repro_torch.launch import mesh as M
from repro_torch.launch.mesh import P
from repro_torch.models import api as tapi
from repro_torch.optim import OptConfig as TOpt, opt_init as topt_init

ARCHS = [a for a in jconfigs.ARCH_IDS if a != "flexgrip"]
SHAPES = {"1x1": (1, 1), "4x2": (4, 2), "2x4": (2, 4), "16x16": (16, 16),
          "2x16x16": (2, 16, 16)}


class FakeMesh:
    """Axis names and sizes only, as the JAX tests' ``FakeMesh``."""

    def __init__(self, shape):
        self.axis_names = (("pod", "data", "model") if len(shape) == 3
                           else ("data", "model"))
        self.shape = dict(zip(self.axis_names, shape))


def _tuple(spec):
    return None if spec is None else tuple(spec)


def _jax_leaves(tree):
    """[(path, shape)] of a JAX tree, named as ``JM.spec_tree`` names them."""
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), tuple(leaf.shape))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_leaves(tree):
    return [("/".join(str(k) for k in path), tuple(leaf.shape))
            for path, leaf in T.leaves_with_paths(tree)]


@functools.lru_cache(maxsize=None)
def _params(arch):
    return japi.param_shapes(jconfigs.get(arch)), \
        tapi.param_shapes(tconfigs.get(arch))


@functools.lru_cache(maxsize=None)
def _opt(arch, mode):
    jp, tp = _params(arch)
    return (jax.eval_shape(lambda p: jopt_init(p, JOpt(mode=mode)), jp),
            topt_init(tp, TOpt(mode=mode)))


def _same_tree_specs(jtree, ttree, fake, jfn, tfn):
    """The JAX and port spec trees leaf by leaf, over the same paths."""
    assert _jax_leaves(jtree) == _port_leaves(ttree)
    jspecs = jax.tree_util.tree_leaves(
        JM.spec_tree(jtree, fake, jfn), is_leaf=lambda x: isinstance(x, JP))
    tspecs = T.leaves(M.spec_tree(ttree, fake, tfn),
                      is_leaf=lambda x: isinstance(x, P))
    assert len(jspecs) == len(tspecs) == len(_port_leaves(ttree))
    for (path, shape), js, ts in zip(_port_leaves(ttree), jspecs, tspecs):
        assert isinstance(ts, P)
        assert tuple(ts) == tuple(js), (path, shape, ts, js)
    return tspecs


@pytest.mark.parametrize("mesh", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_every_leaf_matches_jax(arch, mesh):
    jp, tp = _params(arch)
    fake = FakeMesh(SHAPES[mesh])
    specs = _same_tree_specs(jp, tp, fake, JM.param_spec, M.param_spec)
    # the port's own abstract mesh of the same sizes gives the same specs
    own = M._make_mesh(SHAPES[mesh], fake.axis_names)
    assert own.devices is None and \
        tuple(own.shape.values()) == SHAPES[mesh]
    for (path, shape), spec in zip(_port_leaves(tp), specs):
        assert M.param_spec(path, shape, own) == spec


@pytest.mark.parametrize("mode", ["adamw", "adamw_lite"])
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_spec_every_leaf_matches_jax(arch, mode):
    jo, to = _opt(arch, mode)
    for shape in SHAPES.values():
        _same_tree_specs(jo, to, FakeMesh(shape), JM.opt_spec, M.opt_spec)


KINDS = ("act_resid", "act_ffn", "act_heads", "act_kv", "moe_expert",
         "param:attn/wq", "param:attn/wo", "param:ffn/wi", "param:moe/wi",
         "param:moe/wo", "param:ln1", "logits")
ACT_SHAPES = ((256, 4096, 960), (4, 512, 1024), (1, 8, 2560),
              (3, 12, 30), (256, 4096, 15, 64), (8, 512, 16, 128),
              (1, 1, 8, 64), (6, 10, 4, 32), (128, 384, 4, 7168),
              (2048, 384, 16, 7168), (12, 8, 8, 64), (32, 960, 960),
              (61, 384, 7168, 2048), (960,))


@pytest.mark.parametrize("mesh", sorted(SHAPES))
@pytest.mark.parametrize("profile", ["tp", "seq"])
def test_act_spec_every_kind_matches_jax(profile, mesh):
    fake = FakeMesh(SHAPES[mesh])
    for kind in KINDS:
        for shape in ACT_SHAPES:
            want = _tuple(JM.act_spec(kind, shape, fake, profile))
            got = M.act_spec(kind, shape, fake, profile)
            assert _tuple(got) == want, (kind, shape, got, want)


@pytest.mark.parametrize("mesh", sorted(SHAPES))
def test_batch_spec_matches_jax(mesh):
    fake = FakeMesh(SHAPES[mesh])
    for b in (1, 2, 3, 4, 8, 16, 32, 64, 96, 256, 512):
        for shape in ((b,), (b, 512), (b, 4096, 960), (b, 8, 8, 64)):
            for path in ("tokens", "labels", "frames", "patches"):
                got = M.batch_spec(path, shape, fake)
                assert tuple(got) == tuple(JM.batch_spec(path, shape, fake))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_spec_matches_jax(arch):
    for batch, seq in ((1, 524288), (4, 64), (128, 32768), (2, 24),
                       (16, 8)):
        js = jax.eval_shape(
            lambda: japi.decode_state(jconfigs.get(arch), batch, seq))
        ts = tapi.decode_state(tconfigs.get(arch), batch, seq,
                               device="meta")
        for shape in SHAPES.values():
            _same_tree_specs(js, ts, FakeMesh(shape), JM.decode_state_spec,
                             M.decode_state_spec)


# --------------------------------------- the JAX package's golden tables

def test_param_rules_shard_expected_axes():
    mesh = FakeMesh((1, 1))
    assert M.param_spec("embed", (49152, 960), mesh) == P("model", None)
    assert M.param_spec("layers/attn/wq", (32, 960, 960), mesh) == \
        P(None, "data", "model")
    assert M.param_spec("layers/attn/wo", (32, 960, 960), mesh) == \
        P(None, "model", "data")
    assert M.param_spec("layers/moe/wi", (61, 384, 7168, 2048), mesh) == \
        P(None, "model", "data", None)
    assert M.param_spec("layers/ln1", (32, 960), mesh) == P()
    assert M.param_spec("final_norm", (960,), mesh) == P()


def test_param_rules_drop_nondivisible_axes():
    mesh = FakeMesh((16, 16))
    # vocab 50280 % 16 != 0 -> vocab axis must not shard
    assert M._fit(mesh, (50280, 768), ("model", None)) == P(None, None)
    assert M._fit(mesh, (49152, 960), ("model", None)) == P("model", None)


def test_opt_state_spec_mirrors_params():
    mesh = FakeMesh((16, 16))
    assert M.opt_spec("m/layers/ffn/wi", (32, 960, 2560), mesh) == \
        M.param_spec("layers/ffn/wi", (32, 960, 2560), mesh)
    assert M.opt_spec("v/layers/ffn/wi/row", (32, 960), mesh) == \
        P(None, "data")
    assert M.opt_spec("v/layers/ffn/wi/col", (32, 2560), mesh) == \
        P(None, "model")
    assert M.opt_spec("step", (), mesh) == P()


def test_activation_specs():
    mesh = FakeMesh((16, 16))
    assert M.act_spec("act_resid", (256, 4096, 960), mesh) == \
        P("data", None, None)
    assert M.act_spec("act_ffn", (256, 4096, 2560), mesh) == \
        P("data", None, "model")
    # 15 heads don't divide 16 -> head axis dropped
    assert M.act_spec("act_heads", (256, 4096, 15, 64), mesh) == \
        P("data", None, None, None)
    assert M.act_spec("param:attn/wq", (960, 960), mesh) is None


def test_decode_state_spec_long_context():
    mesh = FakeMesh((2, 16, 16))
    # batch=1: shard time axis; kv heads 32 shard over model
    assert M.decode_state_spec("kv/0", (7, 1, 524288, 32, 64), mesh) == \
        P(None, None, ("pod", "data"), "model", None)
    # batch=128: shard batch
    assert M.decode_state_spec("kv/0", (28, 128, 32768, 8, 128),
                               mesh)[1] == ("pod", "data")


def test_moe_expert_decode_regime_shards_contraction():
    mesh = FakeMesh((16, 16))
    assert M.act_spec("moe_expert", (128, 384, 4, 7168), mesh, "seq") == \
        P(None, "model", None, "data")
    assert M.act_spec("moe_expert", (2048, 384, 16, 7168), mesh, "seq") == \
        P("data", "model", None, None)


def test_fit_golden_rule_table():
    """``_fit`` over its full rule table: keep a divisible axis, drop a
    non-divisible one, keep size-1 axes, pad the spec to rank, multiply
    tuple axes."""
    class Fake:
        shape = {"data": 4, "model": 2, "one": 1}
        axis_names = ("data", "model", "one")
    cases = [
        ((8, 8), ("data", "model"), P("data", "model")),
        ((6, 8), ("data", "model"), P(None, "model")),     # 6 % 4 != 0
        ((8, 7), ("data", "model"), P("data", None)),      # 7 % 2 != 0
        ((5, 5), ("one", None), P("one", None)),           # size-1 kept
        ((8, 8, 3), ("data", "model"), P("data", "model", None)),
        ((8,), (("data", "model"),), P(("data", "model"))),  # 8 % (4*2)
        ((4,), (("data", "model"),), P(None)),             # 4 % 8 != 0
    ]
    for shape, axes, want in cases:
        assert M._fit(Fake, shape, axes) == want, (shape, axes)
        assert tuple(M._fit(Fake, shape, axes)) == \
            tuple(JM._fit(Fake, shape, axes))


def test_decode_state_spec_time_axis_model_fallback():
    """Heads don't divide model but time does (and batch took the data
    axis), so the TIME axis picks up the model sharding."""
    mesh = FakeMesh((4, 2))
    assert M.decode_state_spec("kv/0", (2, 4, 8, 3, 64), mesh) == \
        P(None, "data", "model", None, None)
    assert M.decode_state_spec("kv/0", (2, 4, 8, 4, 64), mesh) == \
        P(None, "data", None, "model", None)


def test_param_rules_table_is_the_jax_one():
    assert [p for p, _ in M._PARAM_RULES] == [p for p, _ in JM._PARAM_RULES]
    for (_, tr), (_, jr) in zip(M._PARAM_RULES, JM._PARAM_RULES):
        assert tr((8, 8)) == jr((8, 8))


# ------------------------------------------------------------ the meshes

def test_make_sm_mesh_over_a_device_list():
    """One ``("sm",)`` axis over the first min(n_sm, len(devices))
    entries; entries may repeat a device."""
    m1 = M.make_sm_mesh(1, ["cpu"] * 8)
    assert m1.axis_names == ("sm",) and m1.devices.size == 1
    m8 = M.make_sm_mesh(8, ["cpu"] * 8)
    assert m8.devices.size == 8 and m8.shape == {"sm": 8}
    assert all(d == torch.device("cpu") for d in m8.devices.flat)
    assert M.make_sm_mesh(10 ** 6, ["cpu"] * 8).devices.size == 8
    assert M.make_sm_mesh(0, ["cpu"] * 3).devices.size == 1
    mixed = M.make_sm_mesh(4, ["cpu", "meta", "cpu", "meta"])
    assert [d.type for d in mixed.devices.flat] == ["cpu", "meta"] * 2


def test_meshes_without_a_card_raise(monkeypatch):
    """The default devices are the local cards: without one the mesh
    constructors raise, as the entry points do, and never fall back to
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_sm_mesh(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_debug_mesh(1)


def test_make_sm_mesh_defaults_to_every_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    m = M.make_sm_mesh(8)
    assert [str(d) for d in m.devices.flat] == [f"cuda:{i}" for i in
                                                range(4)]
    assert M.make_sm_mesh(2).devices.size == 2
    d = M.make_debug_mesh(2)
    assert d.axis_names == ("data", "model") and d.shape == \
        {"data": 1, "model": 2} and d.devices.shape == (1, 2)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_is_abstract(multi_pod):
    m = M.make_production_mesh(multi_pod=multi_pod)
    want = ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})
    assert m.shape == want and tuple(m.axis_names) == tuple(want)
    assert m.devices is None
    assert M.batch_axes(m) == (("pod", "data") if multi_pod else ("data",))


def test_use_mesh_makes_the_mesh_current():
    a, b = M.make_sm_mesh(2, ["cpu"] * 2), M.make_production_mesh()
    assert M.current_mesh() is None
    with M.use_mesh(a) as got:
        assert got is a and M.current_mesh() is a
        with M.use_mesh(b):
            assert M.current_mesh() is b
        assert M.current_mesh() is a
    assert M.current_mesh() is None


def test_mesh_needs_enough_devices():
    with pytest.raises(ValueError, match="needs 4 devices"):
        M._make_mesh((2, 2), ("data", "model"), ["cpu"] * 3)
    assert repr(P("data", None)) == "P('data', None)"
    assert repr(P("sm")) == "P('sm')" and P() == ()
