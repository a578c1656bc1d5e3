"""The plain reference agrees with the program at tiny sizes on the CPU:
the overlay interpreter with the executor on the paper's five programs
and the three compiled kernels."""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness as H  # noqa: E402
from perfbench.reference import overlay as R  # noqa: E402

@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(H, "DEVICE", "cpu")
    torch.set_num_threads(4)


def _kernels(n):
    from repro_torch.compiler.kernels import COMPILED
    from repro_torch.core.programs import ALL
    mods = dict(ALL, **COMPILED)
    rng = np.random.default_rng(11)
    out = []
    for name in sorted(mods):
        m = mods[name]
        grid, bd = m.launch(n)
        bd = bd if isinstance(bd, tuple) else (bd, 1)
        out.append((m.build(n), tuple(grid), bd, m.make_gmem(rng, n)))
    return out


def test_overlay_reference_equals_the_executor():
    from repro_torch.core.pipeline.state import MachineConfig
    from repro_torch.runtime import executor as E
    cfg = H.config("flexgrip")
    launches = _kernels(32)
    dg = E.execute([E.LaunchSpec(*x) for x in launches], n_sm=cfg["n_sm"],
                   cfg=MachineConfig(**cfg["machine"],
                                     execute_backend="cuda_fused"),
                   device="cpu")
    got, got_sm = dg.to_results(), dg.report().per_sm_cycles
    want, want_sm = R.run_batch(R.Machine(**cfg["machine"]),
                                [R.Launch(*x) for x in launches],
                                cfg["n_sm"])
    assert R.mismatches(got, got_sm, want, want_sm) == \
        {"gmem_words": 0, "counters": 0, "sm_cycles": 0}
    assert R.issues(want) == sum(int(r.op_issues.sum()) for r in got) > 0
