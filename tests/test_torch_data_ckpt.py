"""The port's synthetic data stream and checkpoints on the CPU.

Data (``repro_torch.data``): the properties ``tests/test_substrate.py``
holds for the JAX pipeline.  The port's random stream is its own (a CPU
``torch.Generator`` per row, seeded from (seed, step, row)), so its
tokens are not the JAX package's; the construction is.

Checkpoints (``repro_torch.ckpt``): the JAX package's tests of the
protocol, and the on-disk format shared with it: a JAX ``save`` of
parameters and optimizer state restores in the port equal to
``convert.from_numpy`` of the same tree, a port ``save`` restores in JAX's
``restore``, and bf16 is bit-exact both ways (compared as raw bits)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.ckpt import restore as jrestore, save as jsave
from repro.models import api as japi
from repro.optim import OptConfig as JOpt, opt_init as jopt_init
from repro_torch import tree as T
from repro_torch.ckpt import CheckpointManager, latest_step, restore, save
from repro_torch.data import DataConfig, SyntheticLM, make_batch_specs
from repro_torch.models import convert

CFG = DataConfig(vocab=1000, seq_len=128, global_batch=8)


def test_data_is_pure_in_seed_step_and_shard():
    b1, b2 = SyntheticLM(CFG).batch(7), SyntheticLM(CFG).batch(7)
    for k in ("tokens", "labels"):
        assert b1[k].dtype == torch.int32 and b1[k].shape == (8, 128)
        assert torch.equal(b1[k], b2[k])
    assert not torch.equal(b1["tokens"], SyntheticLM(CFG).batch(8)["tokens"])
    other = SyntheticLM(DataConfig(vocab=1000, seq_len=128, global_batch=8,
                                   seed=5)).batch(7)
    assert not torch.equal(b1["tokens"], other["tokens"])
    sh = SyntheticLM(CFG, n_shards=2)
    assert torch.equal(sh.batch(7, 1)["tokens"], sh.batch(7, 1)["tokens"])


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_shards_tile_the_global_batch(n_shards):
    whole = SyntheticLM(CFG).batch(3)
    sh = SyntheticLM(CFG, n_shards=n_shards)
    parts = [sh.batch(3, s) for s in range(n_shards)]
    assert parts[0]["tokens"].shape == (8 // n_shards, 128)
    for k in ("tokens", "labels"):
        assert torch.equal(torch.cat([p[k] for p in parts]), whole[k])
    with pytest.raises(ValueError):
        sh.batch(3, n_shards)
    with pytest.raises(ValueError):
        SyntheticLM(CFG, n_shards=3)


def test_labels_are_the_shifted_tokens():
    b = SyntheticLM(CFG).batch(11)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_copy_overlay_repeats_half_a_period_earlier():
    """Every position whose index modulo 64 is 32 or more holds the token
    32 positions earlier (over tokens and labels, one stream of 129)."""
    b = SyntheticLM(CFG).batch(2)
    stream = torch.cat([b["tokens"], b["labels"][:, -1:]], dim=1)
    pos = torch.arange(stream.shape[1])
    copy = (pos % 64 >= 32) & (pos >= 32)
    assert copy.sum() == 64
    assert torch.equal(stream[:, copy], stream[:, pos[copy] - 32])


def test_unigram_frequencies_fall_with_rank():
    """Tokens are Zipf(1.1) by rank: over many draws, each of the first
    ranks is more frequent than the next, and token 0 is about p(1)."""
    data = SyntheticLM(DataConfig(vocab=1000, seq_len=256, global_batch=64))
    base = torch.cat([data.batch(s)["tokens"][:, :32].reshape(-1)
                      for s in range(4)])       # positions outside copies
    counts = torch.bincount(base.long(), minlength=1000).float()
    assert all(counts[i] > counts[i + 1] for i in range(4))
    p0 = float(data.probs[0])
    assert abs(float(counts[0]) / base.numel() - p0) < 0.1 * p0
    assert int(base.max()) < 1000 and int(base.min()) >= 0


def test_batch_moves_to_the_pipeline_device_and_specs():
    b = SyntheticLM(CFG, device="meta").batch(0)
    assert b["tokens"].device.type == "meta"
    specs = make_batch_specs(1000, 64, 4)
    assert specs["tokens"].shape == (4, 64) and \
        specs["labels"].dtype == torch.int32


# -------------------------------------------------------------- checkpoints
def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
                       "step": torch.tensor(7, dtype=torch.int32)},
            "pair": (torch.zeros(2, dtype=torch.int8),
                     torch.ones((2, 2), dtype=torch.bfloat16))}


def _bits(t):
    """A tensor's raw bits (bf16 as int16), to compare bit for bit."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    save(str(tmp_path), 7, tree)
    out, step = restore(str(tmp_path), tree)
    assert step == 7
    for a, b in zip(T.leaves(tree), T.leaves(out)):
        assert b.dtype == a.dtype and b.shape == a.shape
        assert torch.equal(_bits(a), _bits(b))
    assert isinstance(out["pair"], tuple)
    mf = json.load(open(tmp_path / "step_00000007" / "manifest.json"))
    assert sorted(mf["files"]) == ["a", "nested/b", "nested/step", "pair/0",
                                   "pair/1"]
    assert mf["files"]["nested/b"]["dtype"] == "bfloat16"
    assert mf["files"]["pair/1"]["file"] == "pair__1.npy"
    raw = np.load(tmp_path / "step_00000007" / "nested__b.npy")
    assert raw.dtype == np.uint8 and raw.shape == (4,)


def test_checkpoint_survives_corruption(tmp_path):
    """A corrupted newest checkpoint is skipped, not trusted."""
    tree = {"w": torch.ones(4)}
    save(str(tmp_path), 10, tree)
    save(str(tmp_path), 20, tree)
    with open(tmp_path / "step_00000020" / "w.npy", "wb") as f:
        f.write(b"garbage")
    os.makedirs(tmp_path / "step_00000030.tmp")     # a torn write
    assert latest_step(str(tmp_path)) == 10
    _, step = restore(str(tmp_path), tree)
    assert step == 10
    with pytest.raises(IOError):
        restore(str(tmp_path), tree, step=20)
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "none"), tree)


def test_checkpoint_manager_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=1, keep=2)
    tree = {"w": torch.zeros(2)}
    for s in range(1, 6):
        mgr.maybe_save(s, {"w": torch.full((2,), float(s))})
    assert sorted(d for d in os.listdir(tmp_path)
                  if d.startswith("step_")) == ["step_00000004",
                                                "step_00000005"]
    out, step = mgr.resume(tree)
    assert step == 5 and torch.equal(out["w"], torch.full((2,), 5.0))
    assert CheckpointManager(str(tmp_path), every=3).maybe_save(4, tree) \
        is None
    assert CheckpointManager(str(tmp_path / "empty")).resume(tree) == \
        (None, 0)


@pytest.fixture(scope="module")
def jax_state():
    """The reduced qwen3 parameters and AdamW state of the JAX package,
    the moments made non-zero."""
    spec = jconfigs.reduced(jconfigs.get("qwen3_0p6b"))
    params = japi.init(jax.random.key(0), spec)
    opt = jopt_init(params, JOpt())
    opt = {"step": jnp.asarray(3, jnp.int32),
           "m": jax.tree.map(lambda p: p.astype(jnp.float32) * 0.5, params),
           "v": jax.tree.map(lambda p, v: v + p.astype(jnp.float32) ** 2,
                             params, opt["v"])}
    return {"params": params, "opt": opt}


def test_jax_checkpoint_restores_in_the_port(tmp_path, jax_state):
    jsave(str(tmp_path), 12, jax_state)
    like = convert.from_numpy(jax.tree.map(np.asarray, jax_state),
                              device="cpu")
    zeros = T.tree_map(torch.zeros_like, like)
    out, step = restore(str(tmp_path), zeros)
    assert step == 12
    for a, b in zip(T.leaves(like), T.leaves(out)):
        assert b.dtype == a.dtype and b.shape == a.shape
        assert torch.equal(_bits(a), _bits(b))
    assert out["params"]["embed"].dtype == torch.bfloat16
    assert out["opt"]["step"].dtype == torch.int32 and \
        int(out["opt"]["step"]) == 3


def test_port_checkpoint_restores_in_jax(tmp_path, jax_state):
    tree = convert.from_numpy(jax.tree.map(np.asarray, jax_state),
                              device="cpu")
    save(str(tmp_path), 4, tree)
    out, step = jrestore(str(tmp_path), convert.to_numpy(tree))
    assert step == 4
    for a, b, c in zip(jax.tree.leaves(jax_state), jax.tree.leaves(out),
                       jax.tree.leaves(convert.to_numpy(tree))):
        np.testing.assert_array_equal(np.asarray(b, np.float32), c)
        b = np.asarray(b)
        assert b.dtype == a.dtype and b.shape == a.shape
        np.testing.assert_array_equal(          # the raw bytes
            b.reshape(-1).view(np.uint8),
            np.asarray(a).reshape(-1).view(np.uint8))
