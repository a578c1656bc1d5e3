"""The LM training cell at a tiny size on the CPU: a whole run is correct,
the program agrees with the plain reference within the cell's limits,
the control and each fault fail a limit, the readers read by hand, and
the yardstick's counts agree with counts made by hand.  The control at
the cell's own size runs on the card (``test_lm_controls_at_cell_size``).
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import counts, harness as H, run  # noqa: E402
from perfbench.drivers import lm_train  # noqa: E402
from perfbench.reference import dense_lm as R  # noqa: E402

CELL = "qwen3-0.6b.train-4x4096"
SEED = 2 ** 31 + 211
CONFIG = H.config                     # the file as it is, never patched


def _tiny_spec():
    """The program's reduced qwen3 (d 64, 4/2 heads of 16, FFN 128, 256
    words) at 8 layers: the worst of 90 leaves, where two layers' 24
    leaves leave the control's worst gradient leaf under its limit on
    some seeds."""
    import dataclasses
    from repro_torch import configs
    spec = configs.reduced(configs.get("qwen3-0.6b"))
    return dataclasses.replace(spec, cfg=dataclasses.replace(spec.cfg,
                                                             n_layers=8))


def _tiny_config() -> dict:
    """The configuration file with the widths of :func:`_tiny_spec`."""
    c = _tiny_spec().cfg
    cfg = CONFIG("qwen3-0.6b")
    cfg.update(hidden_size=c.d_model, intermediate_size=c.d_ff,
               vocab_size=c.vocab, num_attention_heads=c.n_heads,
               num_key_value_heads=c.n_kv, head_dim=c.dh,
               num_hidden_layers=c.n_layers, rope_theta=c.rope_theta)
    return cfg


@pytest.fixture
def tiny(monkeypatch):
    """Runs on the CPU with the cell cut to 4 x 64 tokens of
    :func:`_tiny_spec`."""
    monkeypatch.setattr(H, "DEVICE", "cpu")
    torch.set_num_threads(4)
    workload = H.workload

    def wl(name):
        w = workload(name)
        if name == CELL:
            w.update(seq=64, pool=4)
        return w

    def cfg(name):
        return _tiny_config() if name == "qwen3-0.6b" else CONFIG(name)

    monkeypatch.setattr(H, "workload", wl)
    monkeypatch.setattr(H, "config", cfg)
    monkeypatch.setattr(lm_train, "program_spec", lambda cfg: _tiny_spec())
    return monkeypatch


def _run(capsys, trace: int = 0) -> dict:
    rc = run.main(["--workload", CELL, "--seed", str(SEED), "--seconds",
                   "2", "--trace", str(trace)], require_chip=False)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# ------------------------------------------------------------ whole runs
def test_lm_sound_run_is_correct(tiny, capsys):
    out = _run(capsys)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert set(out["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert set(out["checks"]) == {"grad_norm_gap", "grad1_leaf_gap",
                                  "change_leaf_gap"}


def test_lm_traced_run_reports_its_per_layer_metrics(tiny, capsys):
    """On the CPU no kernel of the card runs: the readers of the device
    trace find nothing, and the whole step's share is read from the
    host's clock."""
    out = _run(capsys, trace=1)
    assert out["correct"] is True
    assert "train_step_mfu" in out["metrics"]
    assert "flash_attention_roofline" not in out["metrics"]


def test_lm_state_unchanged_is_incorrect(tiny, capsys):
    """The optimizer writes its moments and returns the old parameters."""
    from repro_torch.launch import steps
    real = steps.opt_step

    def stale(params, opt_state, grads, cfg, donate=False):
        _, state, stats = real(params, opt_state, grads, cfg, donate)
        return params, state, stats
    tiny.setattr(steps, "opt_step", stale)
    out = _run(capsys)
    assert out["correct"] is False
    c = out["checks"]["change_leaf_gap"]
    assert c["value"] > c["limit"]


def test_lm_half_batch_is_incorrect(tiny, capsys):
    """Half of each batch left out, the mean taken over the rest."""
    from repro_torch.models import api
    real = api.apply_train

    def half(params, spec, batch, constrain=lambda t, *a: t):
        return real(params, spec, {k: v[:v.shape[0] // 2]
                                   for k, v in batch.items()}, constrain)
    tiny.setattr(api, "apply_train", half)
    assert _run(capsys)["correct"] is False


def test_lm_update_altered_is_incorrect(tiny, capsys):
    """The parameters altered where they are produced: the optimizer
    moves one layer's weight twice as far as it should."""
    from repro_torch.launch import steps
    real = steps.opt_step

    def double(params, opt_state, grads, cfg, donate=False):
        new, state, stats = real(params, opt_state, grads, cfg, donate)
        old, wq = params["layers"]["attn"]["wq"], \
            new["layers"]["attn"]["wq"]
        wq = wq.clone()
        wq[1] = (2 * wq[1].float() - old[1].float()).to(wq.dtype)
        new["layers"]["attn"]["wq"] = wq
        return new, state, stats
    tiny.setattr(steps, "opt_step", double)
    out = _run(capsys)
    assert out["correct"] is False
    c = out["checks"]["change_leaf_gap"]
    assert c["value"] > c["limit"]


# ------------------------------------------------- reference, controls
def test_lm_reference_agrees_with_the_program(tiny):
    """The program's first steps against the reference: every number
    within the cell's limit."""
    wl, cfg = H.workload(CELL), H.config("qwen3-0.6b")
    cell = lm_train.Cell(wl, cfg, SEED)
    cell.setup()
    ref = R.train_steps(lm_train.make_weights(cell.spec, cfg, SEED, "cpu"),
                        cell.compared, cfg)
    got = lm_train.numbers(cell.program, ref)
    for name, lim in wl["limits"].items():
        assert got[name] <= lim["limit"], name
    assert got["loss_gap"] < 1e-4


def test_lm_controls_fail(tiny):
    """The control (e4m3 weight products) and both faults read in the
    reference each fail at least one of the cell's limits; the program
    fails none."""
    wl, cfg = H.workload(CELL), H.config("qwen3-0.6b")
    out = lm_train.controls(wl, cfg, SEED)
    limits = {k: v["limit"] for k, v in wl["limits"].items()}
    for side, got in out.items():
        failed = [k for k, v in limits.items() if got[k] > v]
        assert bool(failed) == (side != "program"), (side, got)
    assert out["fault_state_unchanged"]["change_leaf_gap"] == 1.0


def test_reference_blocks_do_not_change_the_loss():
    """Attention in blocks of query rows and the loss in blocks of rows
    give the loss and gradient of one block each."""
    cfg = _tiny_config()
    params = lm_train.make_weights(_tiny_spec(), cfg, SEED, "cpu")
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg["vocab_size"], (2, 33), generator=g)
    P = {k: v.float().requires_grad_(True)
         for k, v in R.flatten(params).items()}

    def one(**kw):
        value = R.loss(P, tokens[:, :-1], tokens[:, 1:], cfg, **kw)
        return value, torch.autograd.grad(value, P["embed"])[0]
    a, ga = one(block=32, rows=64)
    b, gb = one(block=5, rows=7)
    assert torch.allclose(a, b, rtol=1e-6)
    assert torch.allclose(ga, gb, rtol=1e-5, atol=1e-6 * ga.abs().max())


def test_reference_sets_no_tf32_and_imports_nothing_of_the_program():
    src = (ROOT / "perfbench/reference/dense_lm.py").read_text()
    assert "repro" not in src.split('"""', 2)[2]
    torch.backends.cuda.matmul.allow_tf32 = True
    with R.no_tf32():
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False


def test_lm_config_is_the_programs():
    """The configuration file's widths are the program's qwen3-0.6b, and
    a width that differs is refused."""
    cfg = H.config("qwen3-0.6b")
    spec = lm_train.program_spec(cfg)
    c = spec.cfg
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv, c.dh, c.d_ff,
            c.vocab) == (cfg["num_hidden_layers"], cfg["hidden_size"],
                         cfg["num_attention_heads"],
                         cfg["num_key_value_heads"], cfg["head_dim"],
                         cfg["intermediate_size"], cfg["vocab_size"])
    assert c.rope_theta == cfg["rope_theta"] and c.qk_norm
    bad = json.loads(json.dumps(cfg))
    bad["program"]["expect"]["d_ff"] = 4096
    with pytest.raises(SystemExit):
        lm_train.program_spec(bad)


# -------------------------------------------------------------- counts
def test_dense_lm_counts_by_hand():
    cfg = H.config("qwen3-0.6b")
    per_layer = 1024 * 2048 * 2 + 2 * 1024 * 1024 + 3 * 1024 * 3072
    assert counts.dense_lm_product_params(cfg) == \
        28 * per_layer + 151936 * 1024 == 595_984_384
    pairs = 4 * 16 * 4096 * 4097 // 2
    assert counts.dense_lm_train_flops(cfg, 4, 4096) == \
        6 * 595_984_384 * 16384 + 28 * 3 * 4 * 128 * pairs
    assert counts.flash_fwd_work(4, 4096, 16, 8, 128, "bf16") == \
        (2 * (2 * 4 * 4096 * 16 * 128 + 2 * 4 * 4096 * 8 * 128)
         + 4 * 4 * 16 * 4096, 4 * 128 * pairs)
    assert counts.flash_bwd_work(4, 4096, 16, 8, 128, "bf16") == \
        (2 * (4 * 4 * 4096 * 16 * 128 + 4 * 4 * 4096 * 8 * 128)
         + 4 * 4 * 16 * 4096, 10 * 128 * pairs)


def test_lm_readers_by_hand():
    fwd, bwd = (3.35e9, 989e9), (6.7e9, 2 * 989e9)
    ctx = {"window": {"turns": 10, "window_s": 5.0, "launches": {},
                      "spans": {}},
           "facts": {"step_flops": 98.9e12, "flash_fwd": fwd,
                     "flash_bwd": bwd},
           "profile": {"kernels": {
               "void (anonymous namespace)::flash_tc_kernel<128>(...)":
                   [0.02, 4],
               "void (anonymous namespace)::delta_tc_kernel<128>(...)":
                   [0.01, 2],
               "void (anonymous namespace)::dkv_tc_kernel<128>(...)":
                   [0.02, 2],
               "void (anonymous namespace)::dq_tc_kernel<128>(...)":
                   [0.01, 2],
               "void at::native::vectorized_elementwise_kernel<4>(...)":
                   [0.05, 90],
               "Memcpy DtoD (Device -> Device)": [0.01, 7],
               "Memset (Device)": [0.001, 3]},
               "launches": {"flash_attention": 4, "flash_attention_bwd": 2},
               "turns": 2, "busy_s": 0.3, "window_s": 0.4, "result": {}}}
    read = H.metric_reader
    # 10 steps of 98.9 TFLOP in 5 s: 197.8 TFLOP/s of 989
    assert read("train_step_mfu")(ctx) == pytest.approx(20.0)
    # four launches of 1 ms of work (FLOPs) in 20 ms
    assert read("flash_attention_roofline")(ctx) == pytest.approx(20.0)
    # two launches of 2 ms of work in 40 ms over three kernels
    assert read("flash_attention_bwd_roofline")(ctx) == pytest.approx(10.0)
    assert read("train.kernels_per_step")(ctx) == 50
    assert read("device_idle.train")(ctx) == pytest.approx(25.0)


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
def test_lm_controls_at_cell_size():
    """At the cell's own size on the card, the control and each fault
    fail one of the cell's limits and the program none
    (``calibrate.py``, one seed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, str(ROOT / "perfbench/calibrate.py"), "--workload",
         CELL, "--seeds", str(SEED)], capture_output=True, text=True,
        timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    row = json.loads(out.stdout.strip().splitlines()[-1])
    limits = {k: v["limit"] for k, v in H.workload(CELL)["limits"].items()}
    for side in ("program", "control_fp8", "fault_half_batch",
                 "fault_state_unchanged"):
        failed = [k for k, v in limits.items() if row[side][k] > v]
        assert bool(failed) == (side != "program"), (side, row[side])
