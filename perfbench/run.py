"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

A new process a run: set-up (loading, weights or inputs from the seed,
warm-up of the cell's own shapes), then the measured window, then the
check of what the window produced against the plain reference.  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``; its last key, ``checks``, holds each number compared
beside its limit, which are also the last lines on standard error.

Everything a cell needs is found by name: ``workloads/<cell>.json``
names its configuration (``configs/``) and its driver (``drivers/``);
each per-layer metric is read by ``metrics/<metric>.py``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from perfbench import harness as H  # noqa: E402


def main(argv=None, require_chip: bool = True) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    if not (H.ROOT / "src" / "repro_torch").is_dir():
        print("perfbench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    H.prepare_environment()
    wl = H.workload(args.workload)
    cfg = H.config(wl["config"])
    import torch
    if require_chip and (not torch.cuda.is_available() or
                         torch.cuda.device_count() < wl["chips"]):
        print(f"perfbench: {args.workload} needs {wl['chips']} CUDA "
              "device(s); none or too few here", file=sys.stderr)
        return 2
    mod = H.driver(wl["driver"])
    cell = mod.Cell(wl, cfg, args.seed)

    cell.setup()
    H.sync()
    setup_s = time.perf_counter() - t_start
    if H.DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()

    if args.trace:
        from repro_torch.kernels import _build
        from repro_torch.obs.trace import TRACER
        from torch.profiler import ProfilerActivity, profile
        t0 = time.perf_counter()
        _build.LAUNCHES.clear()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            profiled = cell.window(**wl["trace_window"])
        launches_prof = dict(_build.LAUNCHES)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            trace = json.loads(Path(path).read_text())
        finally:
            os.unlink(path)
        profile_ctx = H.profile_reduce(trace, profiled["window_s"])
        profile_ctx.update(turns=profiled["turns"], launches=launches_prof,
                           result=profiled)
        del trace, prof
        # the rest of the window unprofiled, with the program's spans on
        rest = max(1.0, args.seconds - (time.perf_counter() - t0))
        _build.LAUNCHES.clear()
        TRACER.start()
        result = cell.window(seconds=rest)
        TRACER.stop()
        ctx = {"workload": wl, "config": cfg, "profile": profile_ctx,
               "window": dict(result, launches=dict(_build.LAUNCHES),
                              spans=_spans(TRACER)),
               "facts": cell.facts()}
        metrics = {}
        for m in H.metrics_of(args.workload, "per_layer"):
            v = H.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device = dict(H.device_info(wl["chips"]),
                      busy_s=profile_ctx["busy_s"],
                      window_s=profile_ctx["window_s"])
        attempted = profiled["attempted"] + result["attempted"]
        failed = profiled["failed"] + result["failed"]
        breakdown = {"device_ops": [list(x) for x in
                                    profile_ctx["device_ops"]],
                     "idle_gaps": [list(x) for x in
                                   profile_ctx["idle_gaps"]]}
    else:
        result = cell.window(seconds=args.seconds)
        attempted, failed = result["attempted"], result["failed"]
        values = dict(result["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in H.metrics_of(args.workload, "end_to_end")}
        device = H.device_info(wl["chips"])
        breakdown = None
    print(f"perfbench: {args.workload} seed {args.seed}: window "
          f"{result['window_s']:.3f} s, {attempted} attempted, {failed} "
          f"failed; {H.power_limit()}", file=sys.stderr)

    cell.release()
    if H.DEVICE == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = cell.check()
    correct = bool(checks) and failed == 0 and \
        all(v <= lim for _, v, lim in checks)
    print(f"perfbench: check took {time.perf_counter() - t_check:.1f} s",
          file=sys.stderr)

    found = H.forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    for name, v, lim in checks:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    out = {"correct": correct, "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in checks}
    print(json.dumps(out))
    return 0


def _spans(tracer) -> dict:
    """The program's spans by name: their durations in seconds."""
    out: dict = {}
    stack = list(tracer.roots)
    while stack:
        sp = stack.pop()
        if sp.t1 is not None:
            out.setdefault(sp.name, []).append(sp.t1 - sp.t0)
        stack.extend(sp.children)
    return out


if __name__ == "__main__":
    sys.exit(main())
