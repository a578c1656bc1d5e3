"""Processes for the port's mesh tests: the sharded LM steps over several
gloo ranks on the CPU, and placements over torch's fake process group.

It imports torch and the port only (never JAX).  The tests run it as a
script, ``python tests/torch_mesh_worker.py MODE ARGS_JSON``:

* ``lm``: spawns one gloo rank per device of a ``("data", "model")``
  mesh (a ``FileStore`` in a temporary directory) and runs each case's
  sharded steps on the inputs of an ``.npz`` (the JAX package's weights
  and batches, written by the test); rank 0 writes the full results to
  another ``.npz``;
* ``placements``: one process over a fake group of the production mesh's
  256 or 512 ranks; writes, for every architecture, the local shard
  shape of every parameter and optimizer-state leaf as rank 0 holds it,
  and what ``make_constrain`` does to a few activations;
* ``analyze``: ``launch.hloanalysis.analyze`` of one product and one
  redistribution on a (2, 2) fake mesh; writes the counts.
"""
import json
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import configs, tree as T  # noqa: E402
from repro_torch.launch import mesh as M, steps  # noqa: E402
from repro_torch.models import api, layers as L  # noqa: E402
from repro_torch.optim import OptConfig, opt_init  # noqa: E402


def _path(p):
    return "/".join(str(k) for k in p)


def _load_tree(like, arrays, prefix, dtype=None):
    """``like``'s tree with the arrays stored under ``prefix/<path>``."""
    return T.unflatten(like, [
        torch.from_numpy(arrays[f"{prefix}/{_path(p)}"]).to(
            dtype or leaf.dtype)
        for p, leaf in T.leaves_with_paths(like)])


def _full(tree):
    return [(_path(p), (t.full_tensor() if hasattr(t, "full_tensor")
                        else t).detach().float().numpy())
            for p, t in T.leaves_with_paths(tree)]


def _case(case, arrays, dm):
    """One family's runs, all with fp32 activations (``COMPUTE_DTYPE``, as
    the unsharded parity tests hold the models to the JAX package's
    elementwise): the sharded gradients, one sharded train step and the
    sharded serve steps; returns {name: array}."""
    name = case["name"]
    spec = configs.reduced(configs.get(case["arch"]))
    shapes = api.param_shapes(spec)
    batch = {k[len(name) + 7:]: torch.from_numpy(v)
             for k, v in arrays.items() if k.startswith(f"{name}/batch/")}
    out = {}
    L.COMPUTE_DTYPE = torch.float32
    try:
        p32 = _load_tree(shapes, arrays, f"{name}/params", torch.float32)
        t = case["grads"]
        lg = steps.build_loss_and_grads(spec, 1, mesh=dm,
                                        profile=t["profile"],
                                        shard_grads=t["shard_grads"])
        psh = steps.shardings_for(spec, dm, None)[0]
        bsh = T.tree_map(lambda x: M.NamedSharding(dm, M.batch_spec(
            "", tuple(x.shape), M.rules_mesh(dm))), batch)
        with steps.deterministic(), steps._on_mesh(dm):
            loss, grads = lg(M.place(p32, psh), M.place(batch, bsh))
        out[f"{name}/grads/loss"] = np.float32(steps._full(loss))
        for p, a in _full(grads):
            out[f"{name}/grads/{p}"] = a
        for p, g in T.leaves_with_paths(grads):
            out[f"{name}/placed/{_path(p)}"] = np.array(
                [str(x) for x in g.placements] ==
                [str(x) for x in psh_leaf(psh, p).placements])
        t = case["step"]
        opt_cfg = OptConfig(**t["opt"])
        step = steps.build_train_step(spec, opt_cfg, t["accum"], mesh=dm,
                                      donate=t["donate"],
                                      profile=t["profile"],
                                      shard_grads=t["shard_grads"])
        # a donated step writes into its inputs' storage (placing a plain
        # tree may keep views of it), so it gets a copy: p32 serves below
        p = T.tree_map(torch.clone, p32)
        new_p, new_o, stats = step(p, opt_init(p, opt_cfg), batch)
        out[f"{name}/step/loss"] = np.float32(stats["loss"])
        out[f"{name}/step/grad_norm"] = np.float32(stats["grad_norm"])
        for p, a in _full(new_p):
            out[f"{name}/step/params/{p}"] = a
        out[f"{name}/step/opt_step"] = np.int32(
            steps._full(new_o["step"]))
        B, T_ = case["batch"], case["max_seq"]
        serve = steps.build_serve_step(spec, mesh=dm,
                                       profile=case["serve_profile"])
        state = api.decode_state(spec, B, T_, device="cpu")
        feeds = sorted(k for k in arrays if k.startswith(f"{name}/feed/"))
        ci = 0
        for i, key in enumerate(feeds):
            tok = torch.from_numpy(arrays[key])
            nt, state = serve(p32, state, tok, ci)
            out[f"{name}/serve/{i}/tok"] = nt.numpy()
            ci += tok.shape[1]
        for p, a in _full(state):
            out[f"{name}/serve/state/{p}"] = a
    finally:
        L.COMPUTE_DTYPE = torch.bfloat16
    return out


def psh_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _lm_rank(rank, args, store_dir):
    dist.init_process_group("gloo", init_method=f"file://{store_dir}/store",
                            rank=rank, world_size=int(np.prod(args["mesh"])))
    torch.set_num_threads(1)
    try:
        dm = M.device_mesh(M._make_mesh(args["mesh"], ("data", "model")),
                           "cpu")
        arrays = dict(np.load(args["inputs"]))
        out = {}
        for case in args["cases"]:
            out.update(_case(case, arrays, dm))
        if rank == 0:
            np.savez(args["out"], **out)
    finally:
        dist.destroy_process_group()


def lm(args):
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_lm_rank, args=(args, d), nprocs=int(np.prod(args["mesh"])))


def placements(args):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore
    pmesh = M.make_production_mesh(multi_pod=args["multi"])
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(np.prod(list(pmesh.shape.values()))))
    out = {}
    try:
        dm = M.device_mesh(pmesh, "cpu")
        with FakeTensorMode():
            for arch in args["archs"]:
                spec = configs.get(arch)
                shapes = api.param_shapes(spec)
                params = T.tree_map(
                    lambda m: torch.zeros(m.shape, dtype=m.dtype), shapes)
                rec = {}
                for mode in ("adamw", "adamw_lite"):
                    psh, osh = steps.shardings_for(spec, dm,
                                                   OptConfig(mode=mode))
                    placed = M.place(opt_init(params, OptConfig(mode=mode)),
                                     osh)
                    rec[mode] = {_path(p): list(M.local_shape(t))
                                 for p, t in T.leaves_with_paths(placed)}
                placed = M.place(params, psh)
                rec["params"] = {_path(p): list(M.local_shape(t))
                                 for p, t in T.leaves_with_paths(placed)}
                out[arch] = rec
            out["constrain"] = _constrain_cases(dm, args["constrain"])
    finally:
        dist.destroy_process_group()
    with open(args["out"], "w") as f:
        json.dump(out, f)


def _code(placements):
    """Placements as strings: "S<dim>", "R" or "P"."""
    return ["S%d" % p.dim if hasattr(p, "dim") else
            "P" if p.is_partial() else "R" for p in placements]


def _constrain_cases(dm, cases):
    """Each (kind, shape, profile): the placements ``make_constrain`` gives
    a replicated activation, or None where it returns it unchanged."""
    from torch.distributed.tensor import DTensor, Replicate
    out = []
    for kind, shape, profile in cases:
        x = DTensor.from_local(torch.zeros(shape), dm,
                               [Replicate()] * dm.ndim)
        y = M.make_constrain(dm, profile)(x, kind)
        out.append(None if y is x else _code(y.placements))
    return out


def analyze(args):
    """x (8, 16) fp32 sharded on rows over ``data``; w (16, 32) on columns
    over ``model``; ``x @ w`` then gathered over ``data``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch import hloanalysis
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        dm = M.device_mesh(M._make_mesh((2, 2), ("data", "model")), "cpu")
        with FakeTensorMode():
            x = M.place(torch.zeros(8, 16), M.NamedSharding(
                dm, M.P("data", None)))
            w = M.place(torch.zeros(16, 32), M.NamedSharding(
                dm, M.P(None, "model")))

            def step(x, w):
                y = x @ w
                return y, y.redistribute(dm, [Replicate(), Shard(1)])

            cost = hloanalysis.analyze(step, x, w)
            y, z = cost.result
            rec = dict(flops=cost.flops, bytes=cost.bytes,
                       transcendental=cost.transcendental,
                       collective_bytes=cost.collective_bytes,
                       coll_by_type=cost.coll_by_type,
                       coll_count=cost.coll_count,
                       y=_code(y.placements), z=_code(z.placements),
                       top=[list(r) for r in
                            hloanalysis.top_collectives(cost)])
    finally:
        dist.destroy_process_group()
    with open(args["out"], "w") as f:
        json.dump(rec, f)


if __name__ == "__main__":
    {"lm": lm, "placements": placements, "analyze": analyze}[sys.argv[1]](
        json.loads(sys.argv[2]))
