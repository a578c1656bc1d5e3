"""The port's training CLI (``repro_torch.launch.train``) on the CPU, on
a dense configuration, after ``tests/test_system.py``: training lowers
the loss, and a run that dies at step 17 and resumes from its last
checkpoint (``--restore auto``) ends with the uninterrupted run's
parameters, bit for bit (the checkpoint plus the stateless data stream;
the train step runs under ``torch.use_deterministic_algorithms``)."""
import re

import pytest
import torch

from repro_torch import tree as T
from repro_torch.launch import train

ARGS = ["--arch", "smollm-360m", "--reduced", "--device", "cpu",
        "--steps", "30"]


def _losses(out):
    return [float(m) for m in re.findall(r"^step +\d+ loss +([\d.]+) ",
                                         out, flags=re.M)]


def test_training_lowers_the_loss(capsys):
    """30 steps with the CLI's defaults (lr 3e-4, warmup 100): the mean
    loss of the last five steps at least 0.02 below the first five's
    (measured 5.5625 -> 5.5185)."""
    params = train.main(ARGS + ["--log-every", "1"])
    losses = _losses(capsys.readouterr().out)
    assert len(losses) == 30
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    assert last < first - 0.02, (first, last)
    assert all(torch.isfinite(p.float()).all() for p in T.leaves(params))


def test_crash_recovery_bit_exact(tmp_path, capsys):
    """Run A: 30 uninterrupted steps.  Run B: dies at 17 (exit code 42),
    restarts from the checkpoint of step 15, continues to 30."""
    pa = train.main(ARGS + ["--seed", "3"])
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "5",
          "--seed", "3"]
    with pytest.raises(SystemExit) as died:
        train.main(ARGS + ck + ["--die-at", "17"])
    assert died.value.code == 42
    pb = train.main(ARGS + ck + ["--restore", "auto"])
    out = capsys.readouterr().out
    assert "[failure-sim] dying at step 17" in out
    assert "[restore] resumed from step 15" in out
    assert "[done] 15 steps" in out
    for a, b in zip(T.leaves(pa), T.leaves(pb)):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
