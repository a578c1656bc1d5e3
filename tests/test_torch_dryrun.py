"""The port's dry-run and cost analysis (``repro_torch.launch.dryrun`` and
``launch.hloanalysis``) on the CPU.

``repro.launch.dryrun`` is never imported here: it sets ``XLA_FLAGS`` to
512 host devices at import.  Its record's keys are read from its source.

* ``analyze`` on a hand-sized product under a (2, 2) fake mesh (in a
  subprocess, ``tests/torch_mesh_worker.py``): x (8, 16) fp32 sharded on
  rows over ``data``, w (16, 32) on columns over ``model``, y = x @ w,
  then y gathered over ``data``.  Per chip: the product is (4, 16) @ (16,
  16), 2 * 4 * 16 * 16 = 2048 FLOPs (the global 2 * 8 * 16 * 32 over the
  4 chips its output is sharded on); its bytes 4 * (4 * 16 + 16 * 16 + 4 *
  16) = 1536; the all-gather's result is (8, 16) fp32, 512 bytes, charged
  again with its 256-byte operand: 2304 bytes, 512 collective bytes, one
  collective;
* the flash kernels' observers: a launch is counted from its shape;
* ``dryrun_cell`` of qwen3-0.6b ``train_4k`` through the CLI (a
  subprocess): status ``ok``; ``params``, ``active_params``, ``n_chips``
  and ``model_flops_per_chip`` equal to the JAX formulas; positive
  FLOPs, bytes and collective bytes; the roofline fraction from the H100
  figures; every key of the JAX record;
* a skipped cell carries the JAX spec's reason.  Tolerance: none (the
  roofline fraction to float rounding)."""
import ast
import json
import os
import subprocess
import sys

import pytest

from repro import configs as jconfigs
from repro_torch.kernels import _build
from repro_torch.launch import dryrun, hloanalysis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_mesh_worker.py")


def _env():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    return env


def _jax_record_keys():
    """The keys of the dict the JAX ``dryrun_cell`` returns for an ``ok``
    cell, read from its source."""
    tree = ast.parse(open(os.path.join(ROOT, "src", "repro", "launch",
                                       "dryrun.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "rec":
            return {k.value for k in node.value.keys}
    raise AssertionError("no rec in the JAX dry-run")


def test_analyze_counts_a_product_and_its_gather(tmp_path):
    out = str(tmp_path / "analyze.json")
    run = subprocess.run([sys.executable, WORKER, "analyze",
                          json.dumps(dict(out=out))], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    with open(out) as f:
        rec = json.load(f)
    assert rec["y"] == ["S0", "S1"] and rec["z"] == ["R", "S1"]
    assert rec["flops"] == 2 * 4 * 16 * 16 == 2 * 8 * 16 * 32 / 4
    assert rec["bytes"] == 4 * (4 * 16 + 16 * 16 + 4 * 16) + 512 + 256
    assert rec["collective_bytes"] == 512 and rec["coll_count"] == 1
    assert rec["coll_by_type"] == {"all-gather": 512}
    assert rec["top"] == [[512, "all-gather", 1, [8, 16], ""]]
    assert rec["transcendental"] == 0


def test_analyze_counts_the_flash_kernels_from_their_shapes():
    B, H, KH, S, dh = 2, 4, 2, 64, 16

    def launches():
        _build.observe("flash_attention", B, H, KH, S, S, dh, True, 2)
        _build.observe("flash_attention_bwd", B, H, KH, S, S, dh, True, 2)

    cost = hloanalysis.analyze(launches)
    pairs = S * (S + 1) / 2
    assert cost.flops == (4 + 10) * B * H * dh * pairs
    assert cost.transcendental == 2 * B * H * pairs
    q, kv, lse = B * S * H * dh * 2, B * S * KH * dh * 2, B * H * S * 4
    assert cost.bytes == (2 * q + 2 * kv + lse) + (4 * q + 4 * kv + lse)
    assert cost.kernels == {"flash_attention": 1, "flash_attention_bwd": 1}
    # outside an analysis a launch reaches no mode and raises nothing
    flops = cost.flops
    launches()
    assert cost.flops == flops


def test_analyze_refuses_a_torch_without_the_propagator_hook(monkeypatch):
    """Where neither private name of DTensor's shape inference exists, the
    analysis raises rather than count fake global shapes as a chip's."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    for name in ("_propagate_tensor_meta_non_cached",
                 "_propagate_tensor_meta"):
        monkeypatch.delattr(ShardingPropagator, name, raising=False)
    with pytest.raises(RuntimeError, match="ShardingPropagator"):
        hloanalysis.analyze(lambda: None)


def test_attention_region_is_named_only_under_an_analysis():
    """``layers.attend`` names ``"flashable_attn"`` while a ``CostMode`` is
    active (its heavy bytes land in ``scope_bytes``) and goes straight to
    the attention otherwise."""
    import torch
    from repro_torch.models import layers
    q = torch.ones(1, 4, 2, 8)
    kv = torch.ones(1, 4, 1, 8)
    seen = []

    def fn(q, k, v):
        seen.append(layers._counting())
        return layers.causal_attention(q, k, v)

    cost = hloanalysis.analyze(layers.attend, fn, q, kv, kv)
    assert seen == [True] and cost.scope_bytes > 0
    assert cost.scope_bytes <= cost.bytes
    layers.attend(fn, q, kv, kv)
    assert seen == [True, False]


def test_dryrun_cli_qwen3_train_4k(tmp_path):
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-0.6b", "--shape", "train_4k", "--mesh", "single", "--out",
         str(tmp_path)], env=_env(), capture_output=True, text=True,
        timeout=600, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-4000:]
    rec = json.loads(run.stdout.strip().splitlines()[-1])
    assert rec["status"] == "ok", rec
    cfg = jconfigs.get("qwen3_0p6b").cfg
    seq, batch, kind = jconfigs.SHAPES["train_4k"]
    assert (rec["kind"], rec["seq"], rec["batch"]) == (kind, seq, batch)
    assert rec["params"] == cfg.param_count()
    assert rec["active_params"] == cfg.active_param_count()
    assert rec["n_chips"] == 256
    assert rec["model_flops_per_chip"] == \
        6 * cfg.active_param_count() * batch * seq / 256
    for k in ("hlo_flops_per_chip", "hlo_bytes_per_chip",
              "collective_bytes_per_chip", "attn_scope_bytes"):
        assert rec[k] > 0, k
    assert rec["compute_t"] == rec["hlo_flops_per_chip"] / 989e12
    assert rec["memory_t"] == rec["hlo_bytes_per_chip"] / 3.35e12
    assert rec["collective_t"] == rec["collective_bytes_per_chip"] / 450e9
    worst = max(rec["compute_t"], rec["memory_t"], rec["collective_t"])
    assert rec["roofline_fraction"] == pytest.approx(
        rec["model_flops_per_chip"] / 989e12 / worst, rel=1e-12)
    L, H, K, dh = cfg.n_layers, cfg.n_heads, cfg.n_kv, cfg.dh
    assert rec["flash_model_bytes"] == pytest.approx(
        batch * L * (2 * seq * H * dh + 2 * seq * K * dh) * 2 * 3.3 / 256)
    assert rec["memory"]["argument_bytes"] > 0 and \
        rec["memory"]["temp_bytes"] > 0
    assert rec["builtin_flops"] is None and \
        rec["memory"]["generated_code_bytes"] is None
    assert _jax_record_keys() <= set(rec)
    assert os.path.exists(tmp_path / "qwen3_0p6b__train_4k__single.json")


@pytest.mark.parametrize("arch,shape", [("qwen3-0.6b", "long_500k"),
                                        ("flexgrip", "train_4k")])
def test_a_skipped_cell_carries_the_jax_reason(arch, shape):
    rec = dryrun.dryrun_cell(arch, shape, multi_pod=True)
    jspec = jconfigs.get(arch.replace("-", "_").replace(".", "p"))
    assert rec == {"arch": arch, "shape": shape, "mesh": "multi",
                   "status": "skipped",
                   "reason": jspec.skip_reason(shape)}
    assert rec["reason"]
