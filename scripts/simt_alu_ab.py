#!/usr/bin/env python3
"""Time the ``simt_alu`` kernel and the staged ``"cuda"`` path of one source
tree, so that two trees can be compared on one card in one session.

    python3 scripts/simt_alu_ab.py SRC [--reps 3] [--plain]

``SRC`` is the ``src`` directory of a checkout of this repository (this
one's, or an older commit's unpacked with ``git archive``); its
``repro_torch`` is imported and its kernels built into ``SRC/../build``.
Needs one NVIDIA Hopper card.  It times

* ``simt_alu(op, s1, s2, s3, cond, s2r, mask)`` on (R, 32) int32 operands
  for R in 8, 32, 64, 4096 and 65536 rows: device ms (calls queued behind
  a spin kernel, so the card runs them back to back) and event ms (calls
  launched back to back on an idle card, which for a call shorter than
  its launch measures the host), each beside the memory bound; at 8 rows
  also the least host µs a call takes, and at 65536 rows the device ms
  with the L2 emptied of the operands before each call (``cold_ms``);
* ``scheduler.run_grid`` of matmul n=32 with ``execute_backend="cuda"``:
  host clock around the call, ``--reps`` times after one warm-up, and the
  ``simt_alu`` launches of one call;
* with ``--plain``, the plain staged path (``staged_run``, backend
  ``"torch"``) on the first dispatch group of matmul n=256 (8 blocks) on
  the host CPU, once: a host time, not a device one.

The timing helpers are this checkout's ``chip_smoke.py``'s.  It prints
one JSON line with the card's name and power limit.  Run trees in turns
(A, B, B, A) in one call to compare them.
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

ROOT = Path(__file__).resolve().parents[1]
ROWS = (8, 32, 64, 4096, 65536)


def host_us(fn, reps: int = 2000, rounds: int = 5) -> float:
    """Least host microseconds a call of ``fn()`` takes, over ``rounds``
    runs of ``reps`` calls (the card runs ahead of the host for a call
    shorter than its launch)."""
    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, (time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    return best


def operands(rng, rows: int):
    """op (rows,) over every opcode, six (rows, 32) int32 operands."""
    op = np.resize(np.arange(28, dtype=np.int32), rows)
    big = (rows, 32)
    lanes = [rng.integers(-2 ** 31, 2 ** 31, big, dtype=np.int64)
             for _ in range(3)] + [rng.integers(0, 2, big),
                                   rng.integers(0, 1024, big),
                                   rng.integers(0, 2, big)]
    return [torch.as_tensor(np.asarray(x).astype(np.int32)).cuda()
            for x in [op] + lanes]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", type=Path)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--plain", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("simt_alu_ab.py: no CUDA device", file=sys.stderr)
        return 1
    # the timing helpers come from this checkout's chip_smoke.py, which puts
    # its own src on the path; SRC goes in front of it
    sys.path.insert(0, str(ROOT))
    from chip_smoke import HBM_BYTES_PER_S, device_ms, event_ms, l2_cold_ms
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.core import scheduler
    from repro_torch.core.machine import MachineConfig
    from repro_torch.core.programs import ALL
    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import simt_alu_ref
    from repro_torch.kernels.simt_alu import simt_alu
    out = {"src": str(args.src), "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()}
    rng = np.random.default_rng(0)
    out["simt_alu"] = {}
    for rows in ROWS:
        x = operands(rng, rows)
        got = simt_alu(*x)
        if not all(torch.equal(a, b) for a, b in zip(got, simt_alu_ref(*x))):
            raise AssertionError(f"simt_alu != simt_alu_ref at {rows}x32")
        reps = 200 if rows <= 4096 else 100
        bound = (rows + 8 * rows * 32) * 4 / HBM_BYTES_PER_S * 1e3
        ms = device_ms(lambda: simt_alu(*x), reps)
        out["simt_alu"][f"{rows}x32"] = dict(
            device_ms=ms, event_ms=event_ms(lambda: simt_alu(*x), reps),
            bound_ms=bound, share=bound / ms)
        if rows == ROWS[0]:
            out["simt_alu"][f"{rows}x32"]["host_us"] = host_us(
                lambda: simt_alu(*x))
        if rows == ROWS[-1]:
            cold = l2_cold_ms(lambda: simt_alu(*x), 50)
            out["simt_alu"][f"{rows}x32"].update(cold_ms=cold,
                                                 cold_share=bound / cold)
        del x
    mod, n = ALL["matmul"], 32
    code, (grid, bd) = mod.build(n), mod.launch(n)
    g0 = mod.make_gmem(np.random.default_rng(2), n)
    cfg = MachineConfig(execute_backend="cuda")
    walls = []
    for _ in range(args.reps + 1):
        _build.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scheduler.run_grid(code, grid, bd, g0.copy(), cfg, device="cuda")
        walls.append((time.perf_counter() - t0) * 1e3)
    out["staged_cuda_matmul32"] = dict(wall_ms=walls[1:],
                                       launches=dict(_build.LAUNCHES))
    if args.plain:
        from repro_torch.core.pipeline.fused import staged_run
        from repro_torch.runtime import registry as reg
        mod = ALL["matmul"]
        prog = torch.as_tensor(mod.build(256))[None].contiguous()
        g0 = mod.make_gmem(np.random.default_rng(4), 256)
        (gx, gy), (bdx, bdy) = mod.launch(256)
        geom = np.array([[0, bdx * bdy, bdx, bdy, p % gx, p // gx, gx, gy]
                         for p in range(8)], np.int32)
        gmem = torch.zeros((8, reg.bucket_gmem_len(len(g0))),
                           dtype=torch.int32)
        gmem[:, :len(g0)] = torch.as_tensor(g0)
        t0 = time.perf_counter()
        staged_run(MachineConfig(execute_backend="torch"), bdx * bdy // 32,
                   prog, geom, gmem)
        out["plain_matmul256_group_host_s"] = time.perf_counter() - t0
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
