#!/usr/bin/env python3
"""Time the fused SM kernel and the overlay's main path of one source tree,
so that two trees can be compared on one card in one session.

    python3 scripts/fused_ab.py SRC [--reps 3]

``SRC`` is the ``src`` directory of a checkout of this repository (this
one's, or an older commit's unpacked with ``git archive``); its
``repro_torch`` is imported and its kernels built into ``SRC/../build``.
Needs one NVIDIA Hopper card.  For each paper program at n=256 it times

* one dispatch group (the first 8 blocks, fewer if the grid is smaller)
  through ``fused_sm_run(cfg, n_warps, codes, geom, gmem)``: the kernel's
  device time from ``torch.profiler``, per launch and per simulated step;
* ``scheduler.run_grid`` at ``n_sm=1`` on the program's launch (for
  reduction its first pass): host clock around the call, which ends in a
  copy of the results to the host, ``--reps`` times after one warm-up.

It prints one JSON line with the card's name and power limit.  Run trees
in turns (A, B, B, A) in one call to compare them.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch


def group(ALL, reg, name, n=256, positions=8):
    mod = ALL[name]
    code = torch.as_tensor(mod.build(n))[None].contiguous()
    g0 = mod.make_gmem(np.random.default_rng(4), n)
    (gx, gy), (bdx, bdy) = mod.launch(n)
    P = min(positions, gx * gy)
    geom = np.array([[0, bdx * bdy, bdx, bdy, p % gx, p // gx, gx, gy]
                     for p in range(P)], np.int32)
    gmem = torch.zeros((P, reg.bucket_gmem_len(len(g0))), dtype=torch.int32)
    gmem[:, :len(g0)] = torch.as_tensor(g0)
    return code, geom, gmem, -(-bdx * bdy // 32)


def kernel_ms(fn, reps: int) -> float:
    """Mean device ms of the fused kernel per call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if "fused_sm_run_kernel" in e.key)
    return us / 1e3 / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", type=Path)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fused_ab.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.core import scheduler
    from repro_torch.core.machine import MachineConfig
    from repro_torch.core.pipeline.fused import C_STEPS, fused_sm_run
    from repro_torch.core.programs import ALL
    from repro_torch.runtime import registry as reg
    cfg, out = MachineConfig(), {"src": str(args.src)}
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    out.update(group_ms={}, us_per_step={}, run_grid_ms={})
    for name in sorted(ALL):
        code, geom, gmem, W = group(ALL, reg, name)
        code_d, gmem_d = code.cuda(), gmem.cuda()
        ctr = fused_sm_run(cfg, W, code_d, geom, gmem_d.clone())[2]
        ms = kernel_ms(lambda: fused_sm_run(cfg, W, code_d, geom,
                                            gmem_d.clone()), args.reps)
        steps = int(ctr[:, C_STEPS].max())
        out["group_ms"][name] = ms
        out["us_per_step"][name] = ms / steps * 1e3
        mod = ALL[name]
        prog, (grid, bd) = mod.build(256), mod.launch(256)
        g0 = mod.make_gmem(np.random.default_rng(3), 256)
        walls = []
        for _ in range(args.reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scheduler.run_grid(prog, grid, bd, g0.copy(), device="cuda")
            walls.append((time.perf_counter() - t0) * 1e3)
        out["run_grid_ms"][name] = walls[1:]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
