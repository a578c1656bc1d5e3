#!/usr/bin/env python3
"""The cost of the program's tracing on the card: the benchmark's two
overlay cells run with ``TRACER`` off and on, in turns, in one process.

    python3 scripts/trace_overhead_ab.py [--seconds 10] [--rounds 2] \
        [--seed 2147483711] [--out build/trace_overhead.json]

Each cell (``flexgrip.suite-n256``, a closed loop of five-program
batches; ``flexgrip.serve-open``, the open loop of Poisson tenants) is
set up as ``perfbench/run.py`` sets it up, warm-up included, and then
runs windows of ``--seconds`` in the order off, on, on, off, once a
round.  For each window it prints the cell's end-to-end metric
(``sim_issues_per_s``; ``launch_p95_ms`` and the server's median latency
``server.latency_s``), the spans recorded and, traced, how many submits
met how many of the loop's drains while they waited for its lock
(``drains`` on ``loop.lock-wait``), and the loop's idle share over the
window and its drain (as ``serve.loop_idle_share`` reads it) and over
the tracer's whole time on.  It also times one span's
enter and exit on this host: the tracer off, on, and off while a
``torch.profiler`` records the thread.  The last line is one JSON object
with the card's name and power limit; ``--out`` keeps it in a file too.
Needs one NVIDIA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from perfbench import harness as H  # noqa: E402
from perfbench.run import _spans  # noqa: E402

CELLS = {"flexgrip.suite-n256": "sim_issues_per_s",
         "flexgrip.serve-open": "launch_p95_ms"}


def windows(name: str, seed: int, seconds: float, rounds: int) -> dict:
    from repro_torch.obs.trace import TRACER
    wl = H.workload(name)
    cell = H.driver(wl["driver"]).Cell(wl, H.config(wl["config"]), seed)
    cell.setup()
    H.sync()
    metric = CELLS[name]
    rows = []
    for traced in [False, True, True, False] * rounds:
        t_on = time.perf_counter()
        if traced:
            TRACER.start()
        res = cell.window(seconds=seconds)
        TRACER.stop()
        t_on = time.perf_counter() - t_on
        spans = _spans(TRACER)
        row = {"traced": traced, metric: res["metrics"][metric],
               "spans": sum(map(len, spans.values())),
               "work": res.get("completed", res["turns"])}
        if spans.get("loop.idle") and "drain_s" in res:
            # the loop's idle share as ``serve.loop_idle_share`` reads it
            # (over the window and its drain) and over the tracer's whole
            # time on, which also holds the window's set-up
            idle = 100 * sum(spans["loop.idle"])
            row["loop_idle_share"] = idle / (res["window_s"] + res["drain_s"])
            row["loop_idle_share_on"] = idle / t_on
        # the drains each submit met while it waited for the loop's lock
        # (a ``loop.lock-wait`` is a root of the client's thread)
        drains = [sp.attrs["drains"] for sp in TRACER.roots
                  if sp.name == "loop.lock-wait" and "drains" in sp.attrs]
        if drains:
            row["drains"] = {str(k): drains.count(k)
                             for k in sorted(set(drains))}
        if hasattr(cell, "metrics"):
            row["latency_p50_ms"] = 1e3 * cell.metrics.histogram(
                "server.latency_s").percentile(50)
        TRACER.clear()
        rows.append(row)
        print(f"trace_overhead: {name} {row}", file=sys.stderr)
    cell.release()
    out = {"windows": rows}
    for key in (metric, "latency_p50_ms"):
        if key not in rows[0]:
            continue
        off = statistics.median(r[key] for r in rows if not r["traced"])
        on = statistics.median(r[key] for r in rows if r["traced"])
        out[key] = {"off_median": off, "on_median": on,
                    "on_over_off": on / off}
    on_rows = [r for r in rows if r["traced"]]
    out["spans_per_unit"] = sum(r["spans"] for r in on_rows) / \
        max(1, sum(r["work"] for r in on_rows))
    return out


def span_us(reps: int) -> dict:
    """One span's enter and exit, µs: off, on, off under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs.trace import TRACER

    def loop(n):
        t0 = time.perf_counter()
        for _ in range(n):
            with TRACER.span("x", ticket=1):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    out = {"off": loop(reps)}
    TRACER.start()
    out["on"] = loop(reps)
    TRACER.stop()
    TRACER.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out["off_profiled"] = loop(reps // 10)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=2147483711)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    H.prepare_environment()
    import torch
    if not torch.cuda.is_available():
        print("trace_overhead: needs a CUDA device", file=sys.stderr)
        return 2
    import repro_torch.runtime  # noqa: F401  (installs the profiler hook)
    out = {"card": H.power_limit(), "torch": torch.__version__,
           "span_us": span_us(200_000)}
    for name in CELLS:
        out[name] = windows(name, args.seed, args.seconds, args.rounds)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
