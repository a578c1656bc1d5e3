"""The benchmark's own machinery, shared by every cell: finding a cell's
files by name, the measured window, the profiler's reduction to device
busy time, kernel times and idle gaps, the check that no JAX module was
loaded, and the result line.

Nothing here is specific to a configuration, a traffic mix or a metric:
those live in files of their own (``configs/``, ``workloads/``,
``drivers/``, ``metrics/``, ``reference/``), found by the names in
``BENCHMARK.json``.
"""
from __future__ import annotations

import bisect
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

#: the device the cells run on; the CPU tests set "cpu" to drive a run's
#: every step through the plain versions of the program's kernels
DEVICE = "cuda"

#: top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def prepare_environment() -> None:
    """Caches inside the checkout, at fixed paths; the program's source
    importable.  Runs before torch is imported."""
    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("REPRO_TORCH_BUILD_DIR", str(build / "kernels"))
    os.environ.setdefault("USE_FLAX", "0")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(name: str) -> dict:
    """The cell's traffic file, checked against its manifest entry."""
    entry = next((w for w in manifest()["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise SystemExit(f"perfbench: no workload {name!r} in BENCHMARK.json")
    wl = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    if wl["config"] != entry["config"] or wl["chips"] != entry["chips"]:
        raise SystemExit(f"perfbench: {name}: its file and BENCHMARK.json "
                         "disagree on the config or the chips")
    return wl


def config(name: str) -> dict:
    entry = next(c for c in manifest()["configs"] if c["name"] == name)
    return json.loads((ROOT / entry["file"]).read_text())


def driver(name: str):
    """The module ``drivers/<name>.py`` that drives a kind of traffic."""
    return importlib.import_module(f"perfbench.drivers.{name}")


def metric_reader(name: str):
    """``read(ctx)`` of ``metrics/<name>.py`` or, where there is no such
    file, of the file named by the name less its last dotted part, and so
    on: ``metrics/device_idle.py`` reads ``device_idle.suite`` and
    ``device_idle.serve`` alike."""
    stem = name
    while not (BENCH / "metrics" / f"{stem}.py").is_file():
        if "." not in stem:
            raise FileNotFoundError(f"perfbench: no reader for {name!r} "
                                    "under perfbench/metrics")
        stem = stem.rsplit(".", 1)[0]
    path = BENCH / "metrics" / f"{stem}.py"
    spec = importlib.util.spec_from_file_location(f"_pb_metric_{len(name)}_"
                                                  + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(cell: str, kind: str) -> List[dict]:
    """The manifest's ``kind`` ("end_to_end" or "per_layer") metrics that
    this cell reports."""
    return [m for m in manifest()[kind]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: the
    modules loaded), each compared whole: ``repro_torch`` is not
    ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({k.split(".")[0] for k in names} & set(FORBIDDEN))


def quantile(xs, q: float) -> float:
    """The ``q`` quantile of ``xs`` by the nearest rank (a tail is one of
    the values measured, never an interpolation)."""
    s = sorted(xs)
    return s[min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))]


# ------------------------------------------------------------ the window
def sync() -> None:
    if DEVICE == "cuda":
        import torch
        torch.cuda.synchronize()



class ClosedLoopCell:
    """A cell whose client waits for each turn before the next: the
    window runs whole turns until its seconds have passed on the host's
    clock and ends when the device has finished the last, so a rate is
    whole turns over their whole time.  A driver gives ``setup``,
    ``turn``, ``rates``, ``facts``, ``check`` and, where the program
    holds memory the check needs, ``release``."""

    def __init__(self, workload: dict, config: dict, seed: int):
        self.wl, self.cfg, self.seed = workload, config, seed

    def release(self) -> None:
        pass

    def window(self, seconds: Optional[float] = None,
               turns: Optional[int] = None) -> dict:
        """Turns for ``seconds``, or exactly ``turns`` of them."""
        sync()
        t0 = time.perf_counter()
        n = 0
        while True:
            self.turn()
            n += 1
            if (turns is not None and n >= turns) or \
                    (turns is None and time.perf_counter() - t0 >= seconds):
                break
        sync()
        window_s = time.perf_counter() - t0
        return {"window_s": window_s, "turns": n, "attempted": n,
                "failed": 0, "metrics": self.rates(n, window_s)}


# ---------------------------------------------------------- the profiler
def profile_reduce(trace: dict, window_s: float) -> dict:
    """From a profiler's Chrome trace: device kernels by name (seconds,
    count), the device's busy seconds (the union of the intervals of its
    kernels, copies and fills), the window, and the idle gaps summed by
    what the host was doing when each began (the innermost host operation
    running then, or ``python`` between operations)."""
    kernels: Dict[str, list] = {}
    spans, host = [], []
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        t0, t1 = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            k = kernels.setdefault(ev["name"], [0.0, 0])
            k[0] += float(ev["dur"]) * 1e-6
            k[1] += 1
            spans.append((t0, t1))
        elif cat in ("cpu_op", "cuda_runtime", "user_annotation"):
            host.append((t0, t1, ev["name"]))
    spans.sort()
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    host.sort()
    starts = [h[0] for h in host]
    by_host: Dict[str, float] = {}
    for g0, g1 in gaps:
        name, width = "python", None
        i = bisect.bisect_right(starts, g0)
        for h0, h1, hn in reversed(host[max(0, i - 64):i]):
            if h1 > g0 and (width is None or h1 - h0 < width):
                name, width = hn, h1 - h0
        by_host[name] = by_host.get(name, 0.0) + (g1 - g0) * 1e-6
    return {"kernels": kernels, "busy_s": busy * 1e-6, "window_s": window_s,
            "idle_gaps": sorted(by_host.items(), key=lambda kv: -kv[1])[:10],
            "device_ops": sorted(((k, v[0]) for k, v in kernels.items()),
                                 key=lambda kv: -kv[1])[:10]}


def kernel_seconds(ctx: dict, pattern: str) -> tuple:
    """(device seconds, calls) of the profiled kernels whose name matches
    the regular expression ``pattern``."""
    import re
    rx = re.compile(pattern)
    s = n = 0
    for name, (sec, cnt) in ctx["profile"]["kernels"].items():
        if rx.search(name):
            s += sec
            n += cnt
    return s, n


def device_info(count: int) -> dict:
    import torch
    if DEVICE != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(count)))}


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None
