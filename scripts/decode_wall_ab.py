#!/usr/bin/env python3
"""Time the unsharded qwen3-0.6b serve step of one source tree on the
host's clock, so that two trees can be compared on one card in one run.

    python3 scripts/decode_wall_ab.py SRC [--decodes 32] [--rounds 3]
                                          [--profile] [--preimport]

``SRC`` is the ``src`` directory of a checkout of this repository (this
one's, or an older commit's unpacked with ``git archive``); its
``repro_torch`` is imported and its kernels built into ``SRC/../build``.
Needs one NVIDIA Hopper card.  ``launch.steps.build_serve_step(spec)``
(no mesh) on qwen3-0.6b at full width, random bf16 weights from seed 0,
a prompt of 4 x 512 tokens from numpy's seed 27: ``--rounds`` times a
prefill and ``--decodes`` greedy decode steps, each step ending in a
device sync, after one warm-up round.  The decode is host-bound, so its
wall is what the Python around the kernels costs.

It prints one JSON line: the card's name and power limit, the prefill
walls and each round's decode walls (ms), and each round's thread CPU
time a decode step (the host's own work and the short wait at each
step's sync; another tenant's load on the host stretches it less than
the wall, and a round's total outlasts a coarse thread clock's tick).
With ``--profile``, one more
decode step under ``cProfile`` (the Python functions by own time) and
one under ``torch.profiler`` (the host operations and CUDA runtime calls
by own CPU time, with their counts) join it: where a difference in walls
comes from.  ``--preimport`` imports ``torch.distributed.tensor`` and
its functional collectives before the tree (what the port's mesh code
adds to a process that never builds a mesh); the JSON also gives the
garbage collector's passes and seconds over the timed rounds.  Run trees
in turns (A, B, B, A) in one call to compare them.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

B, P = 4, 512


def rounds(n_rounds: int, decodes: int, profile: bool) -> dict:
    from repro_torch import configs
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models import api
    spec = configs.get("qwen3-0.6b")
    params = api.init(torch.Generator(device="cuda").manual_seed(0), spec)
    prompt = torch.as_tensor(np.random.default_rng(27).integers(
        0, spec.cfg.vocab, (B, P)), device="cuda")
    step = build_serve_step(spec)

    def one_round():
        state = api.decode_state(spec, B, P + decodes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, state = step(params, state, prompt, 0)
        torch.cuda.synchronize()
        walls = [(time.perf_counter() - t0) * 1e3]
        c0 = time.thread_time()
        for i in range(decodes):
            t0 = time.perf_counter()
            tok, state = step(params, state, tok[:, None], P + i)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return walls, (time.thread_time() - c0) * 1e3 / decodes

    one_round()
    gc_log = {"passes": [0, 0, 0], "s": 0.0}
    started = []

    def gc_seen(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            gc_log["passes"][info["generation"]] += 1
            gc_log["s"] += time.perf_counter() - started.pop()

    gc.callbacks.append(gc_seen)
    try:
        timed = [one_round() for _ in range(n_rounds)]
    finally:
        gc.callbacks.remove(gc_seen)
    runs = [w for w, _ in timed]
    out = {"prefill_ms": [r[0] for r in runs],
           "decode_ms": [r[1:] for r in runs],
           "decode_median_ms": [float(np.median(r[1:])) for r in runs],
           "decode_cpu_ms": [c for _, c in timed],
           "gc": gc_log, "gc_objects": len(gc.get_objects()),
           "modules": len(sys.modules)}
    if profile:
        state = api.decode_state(spec, B, P + 4)
        tok, state = step(params, state, prompt, 0)

        def decode(i):
            step(params, state, tok[:, None], P + i)
            torch.cuda.synchronize()

        decode(0)
        out["python_top"] = python_top(lambda: decode(1))
        out["torch_top"] = torch_top(lambda: decode(2))
    return out


def python_top(fn, n: int = 25):
    """[function, calls, own ms] of one ``fn()`` under cProfile, the
    largest own times first."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = [(f"{Path(f).name}:{line}({name})", calls, tt * 1e3)
            for (f, line, name), (_, calls, tt, _, _) in stats.items()]
    rows.sort(key=lambda r: -r[2])
    return [[name, calls, round(ms, 4)] for name, calls, ms in rows[:n]]


def torch_top(fn, n: int = 25):
    """[operation, count, own CPU ms] of one ``fn()`` under
    ``torch.profiler``, the largest first."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    rows = [(e.key, e.count, e.self_cpu_time_total / 1e3)
            for e in prof.key_averages()]
    rows.sort(key=lambda r: -r[2])
    return [[key, count, round(ms, 4)] for key, count, ms in rows[:n]]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", type=Path)
    ap.add_argument("--decodes", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--preimport", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_wall_ab.py: no CUDA device", file=sys.stderr)
        return 1
    if args.preimport:
        for name in ("torch.distributed._functional_collectives",
                     "torch.distributed.tensor"):
            importlib.import_module(name)
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.kernels import _build
    _build.load()
    out = {"src": str(args.src), "preimport": args.preimport, "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()}
    out.update(rounds(args.rounds, args.decodes, args.profile))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
