"""The comparison that decides ``correct`` fails what it must.

Each cell's control (the reference a step below the stated precision, or
with a stated guarantee broken) fails its numbers; and a whole run,
driven on the CPU at a tiny size past the look for a chip, with the
timed path broken underneath in each way the cell can break, ends with
``correct`` false.  The control at each cell's own size runs on the card
(``test_controls_at_cell_size``)."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness as H, run  # noqa: E402
from perfbench.reference import overlay as R  # noqa: E402

SEED = 2 ** 31 + 101


def _small_programs(tmp_path) -> str:
    """The five paper programs at n=32, in the layout of the frozen
    data files."""
    from repro_torch.core.programs import ALL
    layout = {"autocorr": [[0, 32, -100, 100]],
              "bitonic": [[0, 32, -10000, 10000]],
              "matmul": [[0, 2048, -64, 64]],
              "reduction": [[16, 32, -1000, 1000]],
              "transpose": [[0, 1024, -1000, 1000]]}
    data = {}
    for name, m in sorted(ALL.items()):
        grid, bd = m.launch(32)
        bd = bd if isinstance(bd, tuple) else (bd, 1)
        g = m.make_gmem(np.random.default_rng(0), 32)
        data[name] = {
            "n": 32, "grid": list(grid), "block_dim": list(bd),
            "gmem_words": len(g), "code": m.build(32).tolist(),
            "inputs": [dict(zip(("at", "count", "low", "high"), x))
                       for x in layout[name]],
            "params": [{"at": 0, "value": 32}] if name == "reduction"
            else []}
    path = tmp_path / "programs.json"
    path.write_text(json.dumps(data))
    return str(path)


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    """Runs on the CPU with every cell cut to a size the CPU holds."""
    monkeypatch.setattr(H, "DEVICE", "cpu")
    torch.set_num_threads(4)
    programs = _small_programs(tmp_path)
    items = json.loads((ROOT / "perfbench/data/flexgrip_serve.json")
                       .read_text())
    small = {k: items[k] for k in ("reduction-n128", "scan-n128",
                                   "spmv-n64", "bitonic-n128")}
    (tmp_path / "items.json").write_text(json.dumps(small))
    workload, config = H.workload, H.config

    def wl(name):
        w = workload(name)
        if name == "flexgrip.suite-n256":
            w.update(pool=2)
        if name == "flexgrip.serve-open":
            w.update(items=str(tmp_path / "items.json"), rate_hz=4.0,
                     warmup_s=0.5, check_launches=4,
                     tenants=[{"name": "a", "share": 0.5,
                               "items": ["scan-n128", "bitonic-n128"]},
                              {"name": "b", "share": 0.5,
                               "items": ["reduction-n128", "spmv-n64"]}])
        return w

    def cfg(name):
        c = config(name)
        if name == "flexgrip":
            c.update(programs=programs)
        return c

    monkeypatch.setattr(H, "workload", wl)
    monkeypatch.setattr(H, "config", cfg)
    return monkeypatch


def _run(cell: str, capsys, seconds: float = 1.0) -> dict:
    rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                   str(seconds), "--trace", "0"], require_chip=False)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# ------------------------------------------------------------- controls
def test_overlay_control_fails():
    """The overlay states no precision: its control breaks the stated
    n_sp = 8 (a 32-lane cycle model), and the counters no longer agree."""
    from repro_torch.core.programs import ALL
    rng = np.random.default_rng(5)
    launches = []
    for name, m in sorted(ALL.items()):
        grid, bd = m.launch(32)
        bd = bd if isinstance(bd, tuple) else (bd, 1)
        launches.append(R.Launch(m.build(32), tuple(grid), bd,
                                 m.make_gmem(rng, 32)))
    machine = H.config("flexgrip")["machine"]
    want = R.run_batch(R.Machine(**machine), launches, 2)
    ctl = R.run_batch(R.Machine(**dict(machine, n_sp=32)), launches, 2)
    mis = R.mismatches(*ctl, *want)
    assert mis["counters"] > 0 and mis["sm_cycles"] > 0


# ------------------------------------------------- whole runs, broken
def test_suite_answer_altered(tiny, capsys):
    from repro_torch.runtime import executor
    real = executor.DeviceGrid.to_results

    def altered(self, host_gmem=True):
        out = real(self, host_gmem)
        out[2].gmem[-1] += 1                 # matmul's last output word
        return out
    tiny.setattr(executor.DeviceGrid, "to_results", altered)
    assert _run("flexgrip.suite-n256", capsys)["correct"] is False


def test_suite_sound_run_is_correct(tiny, capsys):
    assert _run("flexgrip.suite-n256", capsys)["correct"] is True


def test_serve_answer_altered(tiny, capsys):
    from repro_torch.runtime import stream
    real = stream.QueuedLaunch.result

    def altered(self):
        res = real(self)
        gm = np.array(res.gmem, copy=True)
        gm[0] += 1
        return res._replace(gmem=gm)
    tiny.setattr(stream.QueuedLaunch, "result", altered)
    assert _run("flexgrip.serve-open", capsys, 2.0)["correct"] is False


# ------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["flexgrip.suite-n256",
                                  "flexgrip.serve-open"])
def test_controls_at_cell_size(cell):
    """Each cell's control at its own size on the card fails one of its
    numbers (``calibrate.py``, one seed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, str(ROOT / "perfbench/calibrate.py"), "--workload",
         cell, "--seeds", str(SEED)], capture_output=True, text=True,
        timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    row = json.loads(out.stdout.strip().splitlines()[-1])
    for key, got in row.items():
        if key.startswith("control"):        # exact: any mismatch fails
            assert sum(got.values()) > 0
