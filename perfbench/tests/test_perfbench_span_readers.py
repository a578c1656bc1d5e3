"""The readers of the program's spans, each checked by hand on a hand-made
context: the nearest-rank 95th percentile of the serving legs, the loop's
idle share over the window and the drain after it, and the executor's
merge milliseconds a group."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import harness as H  # noqa: E402


def _ctx(spans, **window):
    return {"window": dict({"turns": 0, "window_s": 10.0, "launches": {},
                            "spans": spans, "completed": 0}, **window)}


#: twenty durations, 1..20 ms: the nearest rank of 0.95 is the 19th
TWENTY = [k * 1e-3 for k in range(20, 0, -1)]


@pytest.mark.parametrize("metric,span", [
    ("serve.lock_wait_p95_ms", "loop.lock-wait"),
    ("serve.dispatch_wait_p95_ms", "dispatch-wait"),
    ("serve.launch_run_p95_ms", "launch-run")])
def test_p95_by_the_nearest_rank(metric, span):
    read = H.metric_reader(metric)
    assert read(_ctx({span: TWENTY})) == pytest.approx(19.0)
    # 21 values: ceil(0.95 * 21) = 20th, never an interpolation
    assert read(_ctx({span: TWENTY + [0.5]})) == pytest.approx(20.0)
    assert read(_ctx({span: [0.004]})) == pytest.approx(4.0)
    assert read(_ctx({"other": TWENTY})) is None


def test_loop_idle_share_over_window_and_drain():
    read = H.metric_reader("serve.loop_idle_share")
    spans = {"loop.idle": [1.0, 2.5, 0.5]}
    assert read(_ctx(spans, window_s=10.0, drain_s=6.0)) == \
        pytest.approx(25.0)
    assert read(_ctx(spans, window_s=16.0, drain_s=0.0)) == \
        pytest.approx(25.0)
    assert read(_ctx(spans)) is None                 # no drain_s
    assert read(_ctx({}, drain_s=1.0)) is None


def test_merge_ms_per_group():
    read = H.metric_reader("executor.merge_ms_per_group")
    # four groups, merges of 0.1 + 0.2 + 0.3 + 0.2 ms (the sharded path
    # may give a group several): 0.8 ms over 4 groups
    spans = {"device-execute": [0.5e-3] * 4,
             "merge": [0.1e-3, 0.2e-3, 0.3e-3, 0.2e-3]}
    assert read(_ctx(spans)) == pytest.approx(0.2)
    spans["merge"] += [0.4e-3]
    assert read(_ctx(spans)) == pytest.approx(0.3)
    assert read(_ctx({"device-execute": [1e-3]})) is None
    assert read(_ctx({"merge": [1e-3]})) is None


def test_each_span_reader_is_found_by_its_own_file():
    for name in ("serve.lock_wait_p95_ms", "serve.dispatch_wait_p95_ms",
                 "serve.launch_run_p95_ms", "serve.loop_idle_share",
                 "executor.merge_ms_per_group"):
        assert H.metric_reader(name).__globals__["__file__"].endswith(
            f"metrics/{name}.py")
