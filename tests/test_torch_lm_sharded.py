"""The sharded LM train and serve steps (``repro_torch.launch.steps`` with a
``mesh``) over gloo ranks on the CPU, against the JAX package's unsharded
steps on the same numpy inputs.

One process per device of a ``("data", "model")`` mesh of shape (1, 2),
(2, 1) or (2, 2), spawned by ``tests/torch_mesh_worker.py`` (which
imports no JAX); one spawn a mesh, the three started together and run
while this process computes the JAX references.  Each mesh runs the reduced dense
(qwen3), moe (dbrx), ssm (mamba2), hybrid (zamba2), audio (whisper) and
vlm (paligemma) configurations, batch 4 of 16 tokens:

* the gradients (``build_loss_and_grads`` under the mesh, ``accum`` 1)
  against ``jax.value_and_grad(api.apply_train)``, with fp32 activations
  in both packages (``COMPUTE_DTYPE``, as ``tests/test_torch_ssm.py``'s
  ``check_train_parity`` holds them): the loss within ``rtol 1e-3``, every
  leaf within ``rtol 5e-2, atol 5e-3``, and every gradient back on its
  parameter's placements;
* one train step (``build_train_step``, ``accum`` 2; both halves of
  the batch hold as many labelled tokens, so the mean of their means is
  the batch's) against JAX's ``opt_step`` on those gradients, both with
  ``OptConfig(lr=1e-2, warmup=1)`` (:data:`OPT`) so that the first step
  moves every element by about 1e-2, well past the gradient tolerance:
  the loss within 1e-3, ``grad_norm`` within 5e-2, every parameter
  within the gradient tolerance, and every leaf's update (the new
  parameter less the old) within a relative Frobenius error of
  :data:`UPDATE` of JAX's, so that a skipped, wrong-signed or unwritten
  update fails;
* a prefill of 16 tokens and 3 decode steps through
  ``build_serve_step`` against ``api.apply_decode``, fp32 activations in
  both as ``tests/test_torch_hybrid.py`` holds them: each next token the
  argmax of JAX's logits or within ``1e-4`` of it (a near-tie), and the
  final decode state within a relative Frobenius error of 1e-4 a layer.
  (In bf16 the unsharded port's own hybrid state drifts 4% from JAX's by
  its fourth layer here: rounding, not sharding.)

Each mesh covers both profiles and both ``shard_grads`` settings (the
gradients under one, the step under the other) and ``donate`` on or off.
The JAX package's own mesh paths fail on the installed jax, so the
reference is its unsharded step.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import api as japi, layers as jL
from repro.optim import OptConfig as JOpt, opt_init as jopt_init, \
    opt_step as jopt_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_mesh_worker.py")
FAMILIES = {"dense": ("qwen3_0p6b", "qwen3-0.6b"),
            "moe": ("dbrx_132b", "dbrx-132b"),
            "ssm": ("mamba2_130m", "mamba2-130m"),
            "hybrid": ("zamba2_1p2b", "zamba2-1.2b"),
            "audio": ("whisper_medium", "whisper-medium"),
            "vlm": ("paligemma_3b", "paligemma-3b")}
B, S, MAX_SEQ, DECODES = 4, 16, 24, 3
GRAD = dict(rtol=5e-2, atol=5e-3)
F32 = dict(rtol=1e-4, atol=1e-4)
STATE = 1e-4
#: the train step's optimizer in both packages: its first step's rate is
#: ``lr`` itself (warm-up over one step)
OPT = dict(lr=1e-2, warmup=1)
#: an update's relative Frobenius error against JAX's (AdamW's first step
#: moves an element by lr * g / (|g| + eps), about lr * sign(g); the worst
#: leaf of the three meshes is 1.0e-3 off); a skipped update is 1 off, a
#: wrong-signed one 2
UPDATE = 1e-2
TP = dict(profile="tp", shard_grads=True)
SEQ = dict(profile="seq", shard_grads=False)
MESHES = {
    "1x2": dict(mesh=[1, 2], grads=TP, step=dict(SEQ, accum=2, donate=True),
                serve_profile="tp"),
    "2x1": dict(mesh=[2, 1], grads=SEQ, step=dict(TP, accum=2, donate=False),
                serve_profile="seq"),
    "2x2": dict(mesh=[2, 2], grads=TP, step=dict(SEQ, accum=2, donate=True),
                serve_profile="seq"),
}


def _key(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _flat(tree):
    return [(_key(p), np.asarray(jnp.asarray(x, jnp.float32)))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _batch(spec, rng):
    toks = rng.integers(0, 256, (B, S))
    labels = rng.integers(0, 256, (B, S))
    labels[0, :3] = labels[B // 2, :3] = -1
    out = {"tokens": toks.astype(np.int64), "labels": labels.astype(np.int64)}
    if spec.family == "audio":
        out["frames"] = rng.standard_normal(
            (B, spec.cfg.enc_len, spec.cfg.d_model)).astype(np.float32)
    if spec.family == "vlm":
        out["patches"] = rng.standard_normal(
            (B, spec.cfg.n_patches, spec.cfg.d_vision)).astype(np.float32)
    return out


def _jax_batch(b):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype == np.int64 else
                           jnp.float32) for k, v in b.items()}


def _inputs(name, jname, seed):
    """One family's JAX weights, batch and serving feeds, as numpy."""
    spec = jconfigs.reduced(jconfigs.get(jname))
    jp = japi.init(jax.random.key(seed), spec)
    rng = np.random.default_rng(seed)
    batch = _batch(spec, rng)
    feeds = [rng.integers(0, 256, (B, S))] + \
        [rng.integers(0, 256, (B, 1)) for _ in range(DECODES)]
    inputs = {f"{name}/params/{k}": v for k, v in _flat(jp)}
    inputs.update({f"{name}/batch/{k}": v for k, v in batch.items()})
    inputs.update({f"{name}/feed/{i}": f.astype(np.int64)
                   for i, f in enumerate(feeds)})
    return spec, jp, batch, feeds, inputs


def _reference(spec, jp, batch, feeds):
    """The JAX package's unsharded results, fp32 activations."""
    ref = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jL, "COMPUTE_DTYPE", jnp.float32)
        jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        loss, grads = jax.jit(lambda p, b: jax.value_and_grad(
            japi.apply_train)(p, spec, b))(jp32, _jax_batch(batch))
        ref["grads"] = (float(loss), _flat(grads))
        # both halves hold as many labelled tokens, so the mean of their
        # two means (a step's accum 2) is the whole batch's mean
        opt = JOpt(**OPT)
        new_p, _, stats = jopt_step(jp32, jopt_init(jp32, opt), grads, opt)
        ref["step"] = (float(loss), float(stats["grad_norm"]),
                       _flat(new_p), _flat(jp32))
        decode = jax.jit(lambda p, t, st, ci: japi.apply_decode(
            p, spec, t, st, ci))
        state = japi.decode_state(spec, B, MAX_SEQ)
        logits, ci = [], 0
        for f in feeds:
            lg, state = decode(jp32, jnp.asarray(f, jnp.int32), state,
                               jnp.int32(ci))
            logits.append(np.asarray(lg[:, -1], np.float32))
            ci += f.shape[1]
        ref["serve"] = (logits, _flat(state))
    return ref


def _worker(mode, args):
    """``tests/torch_mesh_worker.py`` started in the background."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, WORKER, mode, json.dumps(args)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three meshes' workers, started together on the numpy inputs and
    run while the JAX package computes its references."""
    tmp = tmp_path_factory.mktemp("sharded")
    inputs, families = {}, {}
    for seed, (name, (jname, _)) in enumerate(sorted(FAMILIES.items())):
        spec, jp, batch, feeds, i = _inputs(name, jname, seed)
        inputs.update(i)
        families[name] = (spec, jp, batch, feeds)
    np.savez(tmp / "inputs.npz", **inputs)
    procs = {}
    for mesh, m in MESHES.items():
        cases = [dict(name=name, arch=tname, batch=B, max_seq=MAX_SEQ,
                      grads=m["grads"], step=dict(m["step"], opt=OPT),
                      serve_profile=m["serve_profile"])
                 for name, (_, tname) in sorted(FAMILIES.items())]
        procs[mesh] = (_worker("lm", dict(
            mesh=m["mesh"], cases=cases, inputs=str(tmp / "inputs.npz"),
            out=str(tmp / f"{mesh}.npz"))), tmp / f"{mesh}.npz")
    try:
        refs = {name: _reference(*f) for name, f in families.items()}
    finally:
        done = {mesh: (p.communicate(timeout=900), p.returncode, out)
                for mesh, (p, out) in procs.items()}
    return refs, done


def _agrees(tok, logits):
    """``tok`` is the argmax of ``logits`` or within the tolerance of it (a
    near-tie that rounding may break either way)."""
    best = logits.max(-1)
    picked = logits[np.arange(len(tok)), tok]
    return np.all(picked >= best - (F32["atol"] + F32["rtol"] *
                                    np.abs(best)))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_steps_match_jax(mesh, runs):
    refs, done = runs
    (_, err), rc, out = done[mesh]
    assert rc == 0, err[-4000:]
    got = dict(np.load(out))
    for name, ref in sorted(refs.items()):
        loss, grads = ref["grads"]
        np.testing.assert_allclose(got[f"{name}/grads/loss"], loss,
                                   rtol=1e-3, err_msg=name)
        for k, want in grads:
            np.testing.assert_allclose(got[f"{name}/grads/{k}"], want,
                                       **GRAD, err_msg=f"{name} grad {k}")
            assert got[f"{name}/placed/{k}"], (name, k)
        loss, gnorm, params, before = ref["step"]
        np.testing.assert_allclose(got[f"{name}/step/loss"], loss,
                                   rtol=1e-3, err_msg=name)
        np.testing.assert_allclose(got[f"{name}/step/grad_norm"], gnorm,
                                   rtol=5e-2, err_msg=name)
        assert got[f"{name}/step/opt_step"] == 1
        for (k, want), (_, p0) in zip(params, before):
            new = got[f"{name}/step/params/{k}"]
            np.testing.assert_allclose(new, want, **GRAD,
                                       err_msg=f"{name} param {k}")
            moved, want_moved = new - p0, want - p0
            err = np.linalg.norm(moved - want_moved)
            assert err <= UPDATE * np.linalg.norm(want_moved), \
                (name, k, err, np.linalg.norm(want_moved))
        logits, state = ref["serve"]
        for i, lg in enumerate(logits):
            assert _agrees(got[f"{name}/serve/{i}/tok"], lg), (name, i)
        for k, want in state:
            a = got[f"{name}/serve/state/{k}"]
            assert a.shape == want.shape, (name, k)
            for layer in range(want.shape[0]):
                err = np.linalg.norm(a[layer] - want[layer])
                assert err <= STATE * np.linalg.norm(want[layer]), \
                    (name, k, layer, err)
