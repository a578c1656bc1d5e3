#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one
NVIDIA Hopper card.

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` (into
``build/kernels/``), holds each against its plain PyTorch version, drives
the main path — the five paper programs at the paper's largest size, n=256,
through ``scheduler.run_grid`` / ``execute`` with the default
``execute_backend="cuda_fused"`` — and checks the results against the
programs' numpy oracles and the analytical cycle replay.  Any failure
raises and exits non-zero; nothing is caught.  Without a CUDA device, or
without the repository around it, it exits non-zero before any result.

Phases, each printed as it ends:

1. device: ``torch.cuda.get_device_name`` and ``nvidia-smi``'s name and
   power limit;
2. build: seconds, and the registers and spills ptxas reports;
3. ``simt_alu`` against ``simt_alu_ref``, bit for bit: every opcode (and
   two out-of-range ones) at W in {1, 8, 64, 4096} warps, for
   ``enable_mul`` x ``num_read_operands`` in {T, F} x {2, 3}, on random
   int32 operands plus edge values;
4. the fused kernel against the plain staged path: ``run_grid`` with
   ``"cuda_fused"`` on the card against ``"torch"`` on CPU tensors, the
   five programs at n=32 under three configurations, every counter;
5. the staged ``"cuda"`` path on the card (``simt_alu`` inside the
   pipeline), against the CPU;
6. the main path at n=256 on the card, at n_sm 1 and 2, plus one
   multi-launch ``execute`` of all five, against the oracles and the
   analytical replay; every program but matmul also against the plain
   path on the host CPU, every counter; matmul must cost 83968 cycles a
   block;
7. timings: each kernel's time at the shape its path gives it, its plain
   version's time on the same inputs (``simt_alu``'s on the card; the
   fused kernel's on the host CPU, plus the plain path on the card over a
   cycle budget), and its bound.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Times are CUDA-event times on the card
named in the output, beside its power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import replace
from functools import partial
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
INT32_OPS_PER_S = 67e12     # H100 SXM 32-bit non-tensor peak (fp32 rate)
INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1
EDGES = [0, 1, -1, INT32_MIN, INT32_MAX, 31, 32, -32, 2, 0x55555555]
SIMT_REPLACES = "src/repro/kernels/simt_alu.py:115"
FUSED_REPLACES = "src/repro/core/pipeline/fused.py:116"


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean CUDA-event milliseconds of ``fn()`` over ``reps`` runs after
    one warm-up run."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------ phase 3
def alu_inputs(rng, W, opcodes):
    """op (W,) and six (W, 32) int32 operands; edge-value pairs fill the
    first lanes of s1/s2 (every pair once where they fit)."""
    from repro_torch.core import isa
    L = isa.WARP_SIZE
    op = np.resize(np.asarray(opcodes, np.int32), W)
    s1 = rng.integers(INT32_MIN, INT32_MAX, (W, L), dtype=np.int64)
    s2 = rng.integers(INT32_MIN, INT32_MAX, (W, L), dtype=np.int64)
    pairs = np.array([(a, b) for a in EDGES for b in EDGES], np.int64)
    k = min(len(pairs), W * L)
    s1.reshape(-1)[:k], s2.reshape(-1)[:k] = pairs[:k, 0], pairs[:k, 1]
    s3 = rng.integers(INT32_MIN, INT32_MAX, (W, L), dtype=np.int64)
    cond = rng.integers(0, 2, (W, L))
    s2r = rng.integers(0, 1024, (W, L))
    mask = (rng.random((W, L)) > 0.2).astype(np.int64)
    return [torch.as_tensor(np.asarray(x).astype(np.int32)).cuda()
            for x in (op, s1, s2, s3, cond, s2r, mask)]


def phase_simt_alu(rng):
    from repro_torch.core import isa
    from repro_torch.kernels.ref import simt_alu_ref
    from repro_torch.kernels.simt_alu import simt_alu
    all_ops = list(range(isa.NUM_OPCODES)) + [-1, isa.NUM_OPCODES]
    n_cases, max_err = 0, 0
    for W in (1, 8, 64, 4096):
        # small W: one call per opcode; large W: every opcode in one call
        op_sets = [[o] for o in all_ops] if W < len(all_ops) else [all_ops]
        for ops in op_sets:
            for em in (True, False):
                for nro in (2, 3):
                    x = alu_inputs(rng, W, ops)
                    kw = dict(enable_mul=em, num_read_operands=nro)
                    got = simt_alu(*x, **kw)
                    want = simt_alu_ref(*x, **kw)
                    torch.cuda.synchronize()
                    for g, w_ in zip(got, want):
                        err = (g.long() - w_.long()).abs().max().item()
                        max_err = max(max_err, err)
                        if not torch.equal(g, w_):
                            raise AssertionError(
                                f"simt_alu != simt_alu_ref at W={W} ops={ops}"
                                f" enable_mul={em} nro={nro}")
                    n_cases += 1
    log(f"[simt_alu] bit-exact vs simt_alu_ref: {n_cases} cases, "
        f"W in (1, 8, 64, 4096), opcodes {all_ops[0]}..{all_ops[-1]}, "
        f"max_abs_err {max_err}")
    return max_err


# ------------------------------------------------------------ phase 4/5
FIELDS = ("gmem", "cycles_per_block", "op_issues", "op_lanes", "stack_ops",
          "max_sp", "overflow")


def assert_same(a, b, tag):
    for f in FIELDS:
        if not np.array_equal(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f))):
            raise AssertionError(f"{tag}: {f} differs")


def phase_fused_vs_plain():
    from repro_torch.core import scheduler
    from repro_torch.core.machine import MachineConfig
    from repro_torch.core.programs import ALL
    configs = {"baseline": {}, "n_sp=32": dict(n_sp=32),
               "warp_stack_depth=2": dict(warp_stack_depth=2)}
    n, checked, t_cpu = 32, [], 0.0
    fits = {}
    for cname, kw in configs.items():
        for name in sorted(ALL):
            mod = ALL[name]
            if cname == "warp_stack_depth=2" and fits[name] > 2:
                continue                  # needs a deeper warp stack
            code, (grid, bd) = mod.build(n), mod.launch(n)
            g0 = mod.make_gmem(np.random.default_rng(1), n)
            t0 = time.perf_counter()
            plain = scheduler.run_grid(
                code, grid, bd, g0.copy(),
                MachineConfig(execute_backend="torch", **kw), device="cpu")
            t_cpu += time.perf_counter() - t0
            card = scheduler.run_grid(code, grid, bd, g0.copy(),
                                      MachineConfig(**kw), device="cuda")
            assert_same(plain, card, f"fused {name} {cname}")
            if cname == "baseline":
                fits[name] = plain.max_sp
            checked.append(f"{name}/{cname}")
    log(f"[fused_sm_run] bit-exact vs plain staged path (CPU, "
        f"{t_cpu:.1f} s): {len(checked)} runs at n={n}: "
        + " ".join(checked))


def phase_staged_cuda(launches):
    from repro_torch.core import scheduler
    from repro_torch.core.machine import MachineConfig
    from repro_torch.core.programs import ALL
    mod, n = ALL["matmul"], 32
    code, (grid, bd) = mod.build(n), mod.launch(n)
    g0 = mod.make_gmem(np.random.default_rng(2), n)
    plain = scheduler.run_grid(code, grid, bd, g0.copy(),
                               MachineConfig(execute_backend="torch"),
                               device="cpu")
    launches.clear()
    t0 = time.perf_counter()
    card = scheduler.run_grid(code, grid, bd, g0.copy(),
                              MachineConfig(execute_backend="cuda"),
                              device="cuda")
    wall = time.perf_counter() - t0
    counts = dict(launches)
    assert_same(plain, card, "staged cuda matmul n=32")
    if counts.get("simt_alu", 0) == 0 or counts.get("fused_sm_run", 0):
        raise AssertionError(f"staged 'cuda' path launched {counts}")
    log(f"[staged cuda] matmul n={n}: bit-exact vs CPU, wall "
        f"{wall * 1e3:.1f} ms, launches {counts}")
    return counts["simt_alu"]


# ------------------------------------------------------------ phase 6
#: main-path programs also run whole through the plain path on the host CPU
#: (matmul's 256 blocks would take most of an hour there; one dispatch group
#: of it is held against the plain path in phase 7)
PLAIN_AT_FULL_SIZE = ("autocorr", "bitonic", "reduction", "transpose")


def check_grid(mod, n, g0, res, tag):
    got = res.gmem[mod.out_slice(n)]
    if not np.array_equal(got, mod.oracle(g0, n)):
        raise AssertionError(f"{tag}: gmem differs from the oracle")


def run_entry(name, n, g0, **kw):
    """One paper program through its user entry point: reduction's
    host-side passes, else one ``run_grid``.  One GridResult per pass; the
    last holds the final gmem."""
    from repro_torch.core import scheduler
    from repro_torch.core.programs import ALL
    mod = ALL[name]
    code, (grid, bd) = mod.build(n), mod.launch(n)
    if name != "reduction":
        return [scheduler.run_grid(code, grid, bd, g0.copy(), **kw)]
    final, passes = mod.run_passes(partial(scheduler.run_grid, **kw), code,
                                   n, g0.copy())
    return passes[:-1] + [passes[-1]._replace(gmem=final)]


def phase_main_path(launches):
    from repro_torch.core import scheduler
    from repro_torch.core.machine import MachineConfig
    from repro_torch.core.programs import ALL
    n = 256
    rng = np.random.default_rng(3)
    inputs = {name: ALL[name].make_gmem(rng, n) for name in sorted(ALL)}
    t0 = time.perf_counter()
    plain = {name: run_entry(name, n, inputs[name], device="cpu",
                             cfg=MachineConfig(execute_backend="torch"))
             for name in PLAIN_AT_FULL_SIZE}
    log(f"[main path] plain path on the host CPU at n={n}: "
        f"{' '.join(PLAIN_AT_FULL_SIZE)} in "
        f"{time.perf_counter() - t0:.1f} s")
    launches.clear()
    specs, walls = [], {}
    for name in sorted(ALL):
        mod, g0 = ALL[name], inputs[name]
        code, (grid, bd) = mod.build(n), mod.launch(n)
        specs.append(scheduler.LaunchSpec(code, grid, bd, g0.copy()))
        for n_sm in (1, 2):
            t0 = time.perf_counter()
            passes = run_entry(name, n, g0, n_sm=n_sm, device="cuda")
            walls[f"{name}/run_grid/n_sm={n_sm}"] = time.perf_counter() - t0
            res = passes[-1]
            check_grid(mod, n, g0, res, f"{name} n_sm={n_sm}")
            if name in plain:
                if len(passes) != len(plain[name]):
                    raise AssertionError(f"{name}: pass count differs from "
                                         "the plain path")
                for a, b in zip(passes, plain[name]):
                    assert_same(a, b, f"{name} n={n} n_sm={n_sm} vs plain")
            t0 = time.perf_counter()
            dg = scheduler.execute([scheduler.LaunchSpec(code, grid, bd,
                                                         g0.copy())],
                                   n_sm=n_sm, device="cuda")
            rep, res2 = dg.report(), dg.to_results()[0]
            walls[f"{name}/execute/n_sm={n_sm}"] = time.perf_counter() - t0
            if not np.array_equal(rep.per_sm_cycles,
                                  res2.per_sm_cycles(n_sm)):
                raise AssertionError(f"{name} n_sm={n_sm}: executed per-SM "
                                     "cycles != analytical replay")
            if name != "reduction":
                assert_same(res, res2, f"{name} run_grid vs execute")
            if name == "matmul":
                if set(res2.cycles_per_block.tolist()) != {83968}:
                    raise AssertionError("matmul cycles per block != 83968")
                if n_sm == 1 and rep.per_sm_cycles.tolist() != [21_501_952]:
                    raise AssertionError("matmul per-SM cycles != 21501952")
            vs = "every field == plain path (CPU), " if name in plain else ""
            log(f"[main path] {name} n={n} n_sm={n_sm}: oracle ok, {vs}"
                f"per-SM cycles {rep.per_sm_cycles.tolist()} == analytical, "
                f"cycles/block {sorted(set(res2.cycles_per_block.tolist()))}"
                f", steps/block max {int(dg.block_steps().max())}, wall "
                f"{walls[f'{name}/run_grid/n_sm={n_sm}'] * 1e3:.1f} ms")
    # the drain shape: all five launches in one execute over two SMs
    t0 = time.perf_counter()
    dg = scheduler.execute(specs, n_sm=2, device="cuda")
    results, rep = dg.to_results(), dg.report()
    walls["drain/execute/n_sm=2"] = time.perf_counter() - t0
    for name, res in zip(sorted(ALL), results):
        check_grid(ALL[name], n, inputs[name], res, f"drain {name}")
    cyc = np.concatenate([r.cycles_per_block for r in results])
    want = np.bincount(np.arange(len(cyc)) % 2, weights=cyc + 24,
                       minlength=2).astype(np.int64)
    if not np.array_equal(rep.per_sm_cycles, want):
        raise AssertionError("drain: executed per-SM cycles != analytical")
    counts = dict(launches)
    if counts.get("fused_sm_run", 0) == 0 or counts.get("simt_alu", 0):
        raise AssertionError(f"main path launched {counts}")
    log(f"[main path] drain of 5 launches n={n} n_sm=2: oracles ok, per-SM "
        f"cycles {rep.per_sm_cycles.tolist()} == analytical, wall "
        f"{walls['drain/execute/n_sm=2'] * 1e3:.1f} ms, launches {counts}")
    return counts["fused_sm_run"], walls


# ------------------------------------------------------------ phase 7
def time_simt_alu(rng, launches_on_path, max_err):
    from repro_torch.kernels.ref import simt_alu_ref
    from repro_torch.kernels.simt_alu import simt_alu
    out = {}
    for W in (8, 4096):          # the staged path's shape; a large one
        x = alu_inputs(rng, W, list(range(28)))
        ms = cuda_ms(lambda: simt_alu(*x), 2000 if W == 8 else 200)
        plain_ms = cuda_ms(lambda: simt_alu_ref(*x), 50)
        nbytes = (W + 8 * W * 32) * 4          # op + 6 operands in, 2 out
        ops = W * 32 * 8      # selected op, difference, 4 flags, 2 masks
        bound = max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3
        out[W] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                      bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                      >= ops / INT32_OPS_PER_S else "operations")
        log(f"[timing] simt_alu W={W}x32: {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound:.6f} ms ({nbytes} B)")
    return dict(name="simt_alu", route="cuda",
                source="src/repro_torch/csrc/simt_alu.cu",
                replaces=SIMT_REPLACES, launches=launches_on_path,
                max_abs_err=max_err, library_ms=None, **out[8])


#: cycles a block may run in the budgeted comparison on the card (about
#: 110 of matmul's 2286 steps)
PLAIN_CARD_BUDGET = 4000


def time_fused(launches_on_path):
    """One dispatch group of the main path, 8 matmul n=256 blocks: the
    kernel on the card against the plain version on the host CPU, whole,
    and against the plain version on the card over a cycle budget."""
    from repro_torch.core.machine import MachineConfig
    from repro_torch.core.pipeline.fused import (C_STEPS, fused_sm_run,
                                                 staged_run)
    from repro_torch.core.programs import ALL
    from repro_torch.runtime import registry as reg
    mod, n, P = ALL["matmul"], 256, 8
    cfg = MachineConfig()
    code = torch.as_tensor(mod.build(n))[None].contiguous()
    g0 = mod.make_gmem(np.random.default_rng(4), n)
    G = reg.bucket_gmem_len(len(g0))
    gmem = torch.zeros((P, G), dtype=torch.int32)
    gmem[:, :len(g0)] = torch.as_tensor(g0)
    (gx, gy), (bdx, bdy) = mod.launch(n)
    geom = np.array([[0, bdx * bdy, bdx, bdy, p % gx, p // gx, gx, gy]
                     for p in range(P)], np.int32)
    code_d, gmem_d = code.cuda(), gmem.cuda()
    work = gmem_d.clone()

    def kernel():
        work.copy_(gmem_d)
        return fused_sm_run(cfg, 8, code_d, geom, work)

    def max_err(got, want):
        return max((a.cpu().long() - b.cpu().long()).abs().max().item()
                   for a, b in zip(got, want))

    k_ms = cuda_ms(kernel, 5) - cuda_ms(lambda: work.copy_(gmem_d), 5)
    mem_k, wrt_k, ctr_k = fused_sm_run(cfg, 8, code_d, geom, gmem_d.clone())
    t0 = time.perf_counter()
    plain = staged_run(replace(cfg, execute_backend="torch"), 8, code, geom,
                       gmem.clone())
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max_err((mem_k, wrt_k, ctr_k), plain)
    # the plain version on the card, over PLAIN_CARD_BUDGET cycles a block
    bcfg = replace(cfg, max_cycles=PLAIN_CARD_BUDGET)
    short_k = fused_sm_run(bcfg, 8, code_d, geom, gmem_d.clone())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    short_p = staged_run(replace(bcfg, execute_backend="torch"), 8, code_d,
                         geom, gmem_d.clone())
    torch.cuda.synchronize()
    card_plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(err, max_err(short_k, short_p))
    if err:
        raise AssertionError("fused_sm_run != staged_run")
    words = P * G
    nbytes = (code.numel() + geom.size + 3 * words
              + ctr_k.numel()) * 4          # gmem in; gmem, gw, counters out
    lane_ops = int(ctr_k[:, 28:56].sum().item())   # simulated lane-instrs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, lane_ops / INT32_OPS_PER_S
    bound = max(t_bytes, t_ops) * 1e3
    steps = int(ctr_k[:, C_STEPS].max().item())
    short_steps = int(short_p[2][:, C_STEPS].max().item())
    log(f"[timing] fused_sm_run matmul n=256, {P} blocks x 8 warps, {steps} "
        f"steps each: {k_ms:.3f} ms per launch ({k_ms / steps * 1e3:.3f} "
        f"us per step); plain staged path on the host CPU {plain_ms:.1f} ms "
        f"(bit-exact); bound {bound:.6f} ms ({nbytes} B, {lane_ops} "
        f"lane-instructions)")
    log(f"[timing] plain staged path on the card, first {short_steps} steps "
        f"(max_cycles={PLAIN_CARD_BUDGET}), bit-exact with the kernel: "
        f"{card_plain_ms:.1f} ms, {card_plain_ms / short_steps:.3f} ms per "
        f"step of the group (kernel: {k_ms / steps * 1e3:.3f} us)")
    return dict(name="fused_sm_run", route="cuda",
                source="src/repro_torch/csrc/fused_sm.cu",
                replaces=FUSED_REPLACES, launches=launches_on_path,
                max_abs_err=err, ms=k_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: run it from the repository (src/repro_torch "
              "is missing)", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {kind}, {torch.cuda.device_count()} device(s), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)

    from repro_torch.kernels import _build
    _build.load()
    regs = [l.strip() for l in _build.BUILD_INFO["ptxas"].splitlines()
            if "registers" in l or "spill" in l]
    log(f"[build] {_build.BUILD_INFO['seconds']:.1f} s -> "
        f"{_build.BUILD_INFO['path']}; ptxas: " + " | ".join(regs))

    rng = np.random.default_rng(0)
    alu_err = phase_simt_alu(rng)
    phase_fused_vs_plain()
    alu_launches = phase_staged_cuda(_build.LAUNCHES)
    fused_launches, _ = phase_main_path(_build.LAUNCHES)
    kernels = [time_simt_alu(rng, alu_launches, alu_err),
               time_fused(fused_launches)]
    log(f"[done] {time.perf_counter() - t_start:.1f} s; {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
