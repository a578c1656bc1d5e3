"""The port's sharding rules applied to tensors (``repro_torch.launch.mesh``
``device_mesh``, ``placements``, ``place``, ``make_constrain``), on the CPU.

At the production mesh, (16, 16) over ``("data", "model")`` and (2, 16,
16) with ``"pod"``, over torch's fake process group in a subprocess
(``tests/torch_mesh_worker.py``): every parameter and optimizer-state leaf
of every architecture (AdamW in both modes) is placed on fake tensors by
``steps.shardings_for``, and the shard rank 0 holds must have the shape
the JAX package's spec implies (each dim divided by the sizes of the axes
its ``PartitionSpec`` entry names; ``("pod", "data")`` by both).  The
same process holds ``make_constrain`` to ``repro.launch.mesh.act_spec``:
placements where the spec shards, the activation unchanged where the
spec is None, a dim does not divide, or a ``"param:"`` kind runs under
``"tp"``.  Tolerance: none."""
import functools
import json
import math
import os
import subprocess
import sys

import jax
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import mesh as JM
from repro.models import api as japi
from repro.optim import OptConfig as JOpt, opt_init as jopt_init
from repro_torch.launch import mesh as M

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_mesh_worker.py")
ARCHS = [a for a in jconfigs.ARCH_IDS if a != "flexgrip"]
CONSTRAIN = [
    ("act_resid", (256, 4096, 1024), "tp"),
    ("act_resid", (1, 8, 1024), "tp"),           # batch 1: unchanged
    ("act_ffn", (256, 4096, 3072), "tp"),
    ("act_heads", (256, 4096, 16, 128), "tp"),
    ("act_kv", (256, 4096, 8, 128), "tp"),       # 8 heads: model dropped
    ("act_heads", (256, 4096, 16, 128), "seq"),
    ("act_kv", (256, 4096, 8, 128), "seq"),
    ("act_resid", (256, 4096, 1024), "seq"),
    ("param:attn/wq", (1024, 2048), "tp"),       # tp: unchanged
    ("param:attn/wq", (1024, 2048), "seq"),
    ("param:ffn/wo", (3072, 1024), "seq"),
    ("moe_expert", (2048, 16, 160, 6144), "tp"),
    ("moe_expert", (2048, 16, 4, 6144), "seq"),  # decode regime
    ("act_other", (4, 4), "tp"),
]


class FakeMesh:
    """Axis names and sizes only, as the JAX tests' ``FakeMesh``."""

    def __init__(self, multi):
        self.axis_names = (("pod", "data", "model") if multi
                           else ("data", "model"))
        self.shape = dict(zip(self.axis_names,
                              (2, 16, 16) if multi else (16, 16)))


def _jax_leaves(tree, mesh, fn):
    """{path: (shape, spec)} of a JAX tree under the rule ``fn``."""
    shapes = jax.tree_util.tree_flatten_with_path(tree)[0]
    specs = jax.tree_util.tree_leaves(JM.spec_tree(tree, mesh, fn),
                                      is_leaf=lambda x: isinstance(x, JM.P))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): (tuple(leaf.shape), tuple(spec))
            for (path, leaf), spec in zip(shapes, specs)}


def _local(shape, spec, mesh):
    out = []
    for d, n in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        out.append(n // math.prod(mesh.shape[a] for a in axes))
    return out


def _code(spec, mesh):
    """The placements a spec implies, as the worker writes them."""
    out = ["R"] * len(mesh.axis_names)
    for d, e in enumerate(spec):
        for a in (() if e is None else e if isinstance(e, tuple) else (e,)):
            out[mesh.axis_names.index(a)] = "S%d" % d
    return out


@functools.lru_cache(maxsize=None)
def _worker(multi):
    out = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                       f"placements_{os.getpid()}_{int(multi)}.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    run = subprocess.run(
        [sys.executable, WORKER, "placements",
         json.dumps(dict(multi=multi, archs=ARCHS, constrain=CONSTRAIN,
                         out=out))],
        env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    with open(out) as f:
        rec = json.load(f)
    os.remove(out)
    return rec


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_is_placed_as_the_jax_spec_implies(arch, multi):
    got = _worker(multi)[arch]
    mesh = FakeMesh(multi)
    spec = jconfigs.get(arch)
    pshapes = japi.param_shapes(spec)
    want = _jax_leaves(pshapes, mesh, JM.param_spec)
    assert sorted(got["params"]) == sorted(want)
    for path, (shape, s) in want.items():
        assert got["params"][path] == _local(shape, s, mesh), path
    for mode in ("adamw", "adamw_lite"):
        oshapes = jax.eval_shape(lambda p: jopt_init(p, JOpt(mode=mode)),
                                 pshapes)
        want = _jax_leaves(oshapes, mesh, JM.opt_spec)
        assert sorted(got[mode]) == sorted(want), mode
        for path, (shape, s) in want.items():
            assert got[mode][path] == _local(shape, s, mesh), (mode, path)


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_make_constrain_follows_act_spec(multi):
    got = _worker(multi)["constrain"]
    mesh = FakeMesh(multi)
    for (kind, shape, profile), g in zip(CONSTRAIN, got):
        spec = JM.act_spec(kind, shape, mesh, profile)
        if spec is not None:
            sizes = [JM._axis_size(mesh, a) for a in spec]
            if not all(d % n == 0 for d, n in zip(shape, sizes)):
                spec = None
        if spec is None or all(e is None for e in spec):
            assert g is None or g == ["R"] * len(mesh.axis_names), \
                (kind, shape, profile, g)
        else:
            assert g == _code(spec, mesh), (kind, shape, profile)
    # the three cases where it must hand the activation back unchanged
    assert got[1] is None and got[8] is None and got[-1] is None


def test_make_constrain_without_a_mesh_is_the_identity():
    x = torch.zeros(2, 3)
    c = M.make_constrain(None, "seq")
    assert c(x, "act_resid") is x and c(x, "param:attn/wq") is x


class _DM:
    """A DeviceMesh's axis names and sizes, for ``placements``."""

    def __init__(self, names, sizes):
        self.mesh_dim_names, self._sizes = names, sizes

    def size(self, i):
        return self._sizes[i]


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    dm = _DM(("pod", "data", "model"), (2, 16, 16))
    assert M.placements(M.P(("pod", "data"), None, "model"), dm) == \
        (Shard(0), Shard(0), Shard(2))
    assert M.placements(M.P(None, "data"), dm) == \
        (Replicate(), Shard(1), Replicate())
    assert M.placements(M.P(), dm) == (Replicate(),) * 3
    # a mesh dim of size 1 stays replicated: the same layout
    assert M.placements(M.P("data", "model"), _DM(("data", "model"),
                                                  (1, 2))) == \
        (Replicate(), Shard(1))
    with pytest.raises(ValueError):
        M.placements(M.P(("data", "pod")), dm)
