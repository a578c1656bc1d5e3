"""The yardstick's arithmetic against counts made by hand at one shape."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import counts, harness as H  # noqa: E402

def test_roofline_takes_the_larger_bound():
    assert counts.roofline_s(3.35e12, 1.0, "bf16") == pytest.approx(1.0)
    assert counts.roofline_s(1.0, 989e12, "bf16") == pytest.approx(1.0)
    assert counts.roofline_s(0, 67e12, "fp32") == pytest.approx(1.0)


def test_overlay_batch_bytes_by_hand():
    """Launches of 3 and 1 blocks: each program in, each memory in and
    out, each block's counters out, however the blocks are grouped."""
    cw = counts.COUNTER_WORDS
    assert counts.overlay_batch_bytes([3, 1], [100, 10], [20, 30]) == \
        4 * (20 + 200 + 30 + 20 + 4 * cw)
    # the suite's batch: five launches, 518 blocks
    assert counts.overlay_batch_bytes([1, 1, 256, 4, 256], [0] * 5,
                                      [0] * 5) == 4 * 518 * cw


def test_readers_by_hand():
    ctx = {"window": {"turns": 4, "window_s": 2.0, "completed": 10,
                      "launches": {"fused_sm_run": 260},
                      "queue_wait_p50_s": 0.00025,
                      "spans": {"device-execute": [1e-3, 3e-3]}},
           "facts": {"batch_bytes": 3.35e9},
           "profile": {"kernels": {"fused_sm_run_kernel<true>": [4e-3, 2],
                                   "void other_kernel": [1e-3, 6]},
                       "launches": {}, "turns": 1, "busy_s": 0.75,
                       "window_s": 1.0, "result": {}}}
    read = H.metric_reader
    assert read("fused_sm_run.roofline")(ctx) == pytest.approx(
        100 * (3.35e9 / 3.35e12) / 4e-3)
    assert read("fused_sm_run.launches_per_batch")(ctx) == 65
    assert read("executor.host_ms_per_group")(ctx) == pytest.approx(2.0)
    assert read("serve.fused_launches_per_launch")(ctx) == 26
    assert read("serve.queue_wait_p50_ms")(ctx) == pytest.approx(0.25)
    assert read("device_idle.suite")(ctx) == pytest.approx(25.0)
    assert read("device_idle.serve")(ctx) == pytest.approx(25.0)
