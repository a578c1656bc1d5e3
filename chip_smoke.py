#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one
NVIDIA Hopper card.

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` (into
``build/kernels/``), holds each against its plain PyTorch version, drives
the main path — the five paper programs at the paper's largest size, n=256,
through ``scheduler.run_grid`` / ``execute`` with the default
``execute_backend="cuda_fused"``, and the paper's tables computed that way
— and checks the results against the programs' numpy oracles, the
analytical cycle replay and the JAX package's table values.  Any failure
raises and exits non-zero; nothing is caught.  Without a CUDA device, or
without the repository around it, it exits non-zero before any result.

Phases, each printed as it ends:

1. device: ``torch.cuda.get_device_name`` and ``nvidia-smi``'s name and
   power limit;
2. build: seconds, and the registers and spills ptxas reports;
3. ``simt_alu`` against ``simt_alu_ref``, bit for bit: every opcode (and
   two out-of-range ones) at W in {1, 8, 64, 4096} warps and at the
   staged pipeline's batched (P, W, 32) shapes, for ``enable_mul`` x
   ``num_read_operands`` in {T, F} x {2, 3}, on random int32 operands
   plus edge values, also for rows of 30 lanes and for operands one word
   off a 16-byte boundary;
4. the fused kernel against the plain staged path: ``run_grid`` with
   ``"cuda_fused"`` on the card against ``"torch"`` on CPU tensors, the
   five programs at n=32 under three configurations, every counter;
5. the staged ``"cuda"`` path on the card (``simt_alu`` inside the
   pipeline, one launch a step for a whole dispatch group), against the
   CPU: matmul n=32 with exactly 298 launches, and the five programs at
   n=32 in one ``execute`` over two SMs;
6. the main path at n=256 on the card, at n_sm 1 and 2, plus one
   multi-launch ``execute`` of all five, against the oracles and the
   analytical replay; every program but matmul also against the plain
   path on the host CPU, every counter; matmul must cost 83968 cycles a
   block;
7. timings: each kernel's time at the shape its path gives it, its plain
   version's time on the same inputs (``simt_alu``'s on the card, at five
   shapes up to 65536 x 32, which must reach half its memory bound both
   back to back and with the L2 emptied of its operands before each call;
   the
   fused kernel's on the host CPU, plus the plain path on the card over a
   cycle budget), and its bound; the fused kernel on one dispatch group
   of each of the five programs at n=256, in µs per simulated step, with
   the number of a block's steps that took its read/write barrier;
8. ``flash_attention`` and ``matmul`` against their plain versions on the
   card: the sweep of ``tests/test_kernels.py`` plus a ragged length
   (S=200), large logits, and the model's strided GQA call, each bf16 case
   through both variants (the rule's tensor-core one and the SIMT one,
   forced by ``variant="simt"``), and a misaligned q that the rule must
   send to the SIMT variant; matmul at the sweep's shapes, a ragged
   200x200x200 and a scalar-load shape, in both dtypes, and at
   ``kernel_micro``'s 512x512 float32 with 128 tiles, through
   ``ops.matmul`` (that call is the matmul kernel's path);
9. the LM serving path: ``repro_torch.launch.serve.main`` serves
   qwen3-0.6b at full width (28 layers, random bf16 weights from seed 0):
   batch 4, prompts of 512 and 200 tokens, 32 new tokens each, with one
   flash launch per layer in each prefill, every one the tensor-core
   variant; then the prefill step with the kernel and with the plain
   attention on the same weights and prompt, compared per layer and end
   to end, the same measures read for two planted faults, and the
   prefill and decode times;
10. the flash kernel's two variants and the matmul kernel in both dtypes
   timed at their paths' shapes beside the plain version, one PyTorch
   library call (for attention, each ``scaled_dot_product_attention``
   backend that takes the shape, and which of them the unrestricted call
   ran), and the bound;
11. the paper's tables at n=32 (``paper_rows``: ``benchmarks/run.py``'s
   Table 2, Fig. 4, Fig. 5 / Table 3, Table 5 and Table 6 rows, with its
   formulas, through ``run_grid``/``execute`` with ``"cuda_fused"``) on
   the card, equal to the same function on the host CPU through the plain
   ``"torch"`` backend, every row and every number behind it, and to the
   JAX package's values pinned in ``PINNED_N32`` and ``PINNED_VARIANTS``;
   ``fused_sm_run`` must launch, and nothing else;
12. the same tables at n=256 on the card, every program held to its
   oracle, one ``[paper]`` line per table, and the means over the five
   programs (Fig. 4 at 8/16/32 SPs, Fig. 5 at 32 SPs on two SMs, Table 5,
   Table 6's dynamic-energy saving) beside the paper's 44x / 80% / 14%,
   with the phase's wall time;
13. the ``"reference"`` backend (the seed one-warp-per-issue interpreter)
   on the card: ``REFERENCE_PROGRAMS`` at n=32 over two SMs, gmem and
   every counter equal to ``"cuda_fused"``, no kernel launched, and its
   wall time;
14. the serving runtime (``[serve-overlay]``): the multi-tenant CLI
   ``repro_torch.launch.gpgpu_serve.main --no-compiled`` on the card,
   every result held to its oracle inside the CLI, every dispatch group
   one ``fused_sm_run`` launch and each drain's launch count exactly the
   executor's groups over its traced dispatch groups (the load test's
   pool, whose oracle runs ``run_grid``, is built before the counting):
   64 launches from 4 tenants on 8 SMs
   under each of the five drain policies, with the executed per-SM cycles
   equal to the analytical replay of each dispatch group; one 16-launch
   drain equal to the same drain on the host CPU's plain path, every
   ticket and every accounting field; the skewed workload's padded words
   (56896 monolithic, 64 bucket) and the longtail's makespan (1456 bucket,
   784 balanced); a ``--resident-gmem`` drain with no gmem crossing in a
   ``TRANSFERS`` window; the five paper programs at n=256 from four
   tenants on 8 SMs (matmul 83968 cycles a block); five bucket drains
   with host memory and five resident, in turns (walls of submit + drain
   and of the drain alone); one bucket drain's device time under
   ``torch.profiler`` beside the same run's wall; and ``--loadgen
   --loop --profile`` for 3 s (no unresolved launch, p50 / p99 latency,
   energy above 0).  Each drain prints its launches/s, wall and
   ``fused_sm_run`` launches beside the card's name and power limit.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Times are on the card named in the
output, beside its power limit.  A kernel's ``ms`` (and its plain
version's and library call's) is device time: CUDA events around many
calls queued behind a spin kernel, so that the device runs them back to
back (``device_ms``); ``event_ms`` is the CUDA-event time of the same
calls launched back to back on an idle device, which for a call shorter
than its launch measures the host.  The fused kernel's time is device time
less that of the snapshot copy each launch needs; serving times are host
clocks around work that ends in a device sync (a drain's wall closes
after its last counter fetch).
"""
from __future__ import annotations

import contextlib
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
#: H100 SXM dense peaks by input dtype: bf16 on the tensor cores, float32
#: on the fp32 cores (the kernels never use TF32)
PEAK_FLOPS = {torch.bfloat16: (989e12, "bf16 tensor-core 989 TFLOP/s"),
              torch.float32: (67e12, "fp32 non-tensor 67 TFLOP/s")}
INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1
EDGES = [0, 1, -1, INT32_MIN, INT32_MAX, 31, 32, -32, 2, 0x55555555]
SIMT_REPLACES = "src/repro/kernels/simt_alu.py:115"
FUSED_REPLACES = "src/repro/core/pipeline/fused.py:116"
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:66"
MATMUL_REPLACES = "src/repro/kernels/matmul.py:35"
#: the serving path: qwen3-0.6b at full width, as a user runs it
SERVE_ARGS = ["--arch", "qwen3-0.6b", "--batch", "4", "--gen", "32",
              "--seed", "0"]
PROMPTS = (512, 200)
#: the serving CLI's printed output in phase 14 (it is long)
SERVE_LOG = ROOT / "build" / "serve" / "gpgpu_serve.log"
#: the prefill with the flash kernel against the same step with the plain
#: attention (``mha_ref`` in the flash wrapper's place).  The guard is the
#: per-layer check: every layer's kernel output against the plain version
#: on the same inputs within the kernel's bf16 tolerance (3e-2,
#: tests/test_kernels.py).  End to end, the last-position logits and each
#: layer's KV cache within a relative Frobenius error of 5e-2 is a sanity
#: bound only: the kernel rounds P to bf16 before the PV product, as the
#: TPU kernel does, and the plain version does not, a 1-ulp difference in
#: some outputs of every layer that 28 layers compound.  Two planted
#: faults are read against both measures (``planted``)
LAYER_TOL, LM_REL_TOL = 3e-2, 5e-2


def log(*a):
    print(*a, flush=True)


def event_ms(fn, reps: int) -> float:
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


#: cycles of the spin kernel that holds the device while the host queues
#: the calls ``device_ms`` times (about 60 ms at the H100's clocks)
SPIN_CYCLES = 100_000_000


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds of one ``fn()`` over ``reps`` runs after
    one warm-up run.  The runs are queued behind a spin kernel
    (``torch.cuda._sleep``), so the device runs them back to back while
    the host is still launching them, and the CUDA-event time over them
    is the device's, not the host's launch rate, which is what
    ``event_ms`` measures for a call shorter than its launch.  Raises if
    the host took longer to queue the runs than the spin lasted."""
    fn()
    torch.cuda.synchronize()
    spin, start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
    spin.record()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if host_ms >= spin.elapsed_time(start):
        raise AssertionError(f"device_ms: queueing {reps} runs took the host "
                             f"{host_ms:.1f} ms, longer than the "
                             f"{spin.elapsed_time(start):.1f} ms spin")
    return start.elapsed_time(end) / reps


def l2_cold_ms(fn, reps: int) -> float:
    """Device milliseconds of one ``fn()`` with the L2 holding none of its
    operands: a read of 128 MB (over twice the H100's 50 MB L2) queued
    before each run, less that read's own time."""
    flush = torch.zeros(2 ** 25, dtype=torch.int32, device="cuda")
    return device_ms(lambda: (flush.sum(), fn()), reps) - \
        device_ms(flush.sum, reps)


def timed(fn, reps: int):
    """(device ms, CUDA-event ms) of one ``fn()``."""
    return device_ms(fn, reps), event_ms(fn, reps)


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
    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import simt_alu_ref
    from repro_torch.kernels.simt_alu import simt_alu
    all_ops = list(range(isa.NUM_OPCODES)) + [-1, isa.NUM_OPCODES]
    n_cases, max_err = 0, 0

    def check(x, tag):
        nonlocal n_cases, max_err
        for em in (True, False):
            for nro in (2, 3):
                kw = dict(enable_mul=em, num_read_operands=nro)
                _build.LAUNCHES.clear()
                got = simt_alu(*x, **kw)
                want = simt_alu_ref(*x, **kw)
                torch.cuda.synchronize()
                if dict(_build.LAUNCHES) != {"simt_alu": 1}:
                    raise AssertionError(f"simt_alu {tag}: launched "
                                         f"{dict(_build.LAUNCHES)}")
                for g, w_ in zip(got, want):
                    err = (g.long() - w_.long()).abs().max().item()
                    max_err = max(max_err, err)
                    if g.shape != x[1].shape or not torch.equal(g, w_):
                        raise AssertionError(
                            f"simt_alu != simt_alu_ref at {tag} "
                            f"enable_mul={em} nro={nro}")
                n_cases += 1

    for W in (1, 8, 64, 4096):
        # small W: one call per opcode; large W: every opcode in one call
        op_sets = [[o] for o in all_ops] if W < len(all_ops) else [all_ops]
        for ops in op_sets:
            check(alu_inputs(rng, W, ops), f"W={W} ops={ops}")
    # the staged pipeline's calls: (P, W, 32), a dispatch group's rows;
    # then rows that are not whole 16-byte vectors, and operands one word
    # past a 16-byte boundary
    for shape, offset in (((4, 8, 32), 0), ((8, 8, 32), 0), ((3, 5, 30), 0),
                          ((4, 8, 32), 1)):
        P, W, L = shape
        op, *lanes = alu_inputs(rng, P * W, all_ops)
        check([op.view(P, W)] + [offset_view(t[:, :L].reshape(shape), offset)
                                 for t in lanes],
              f"{shape} offset {offset}")
    log(f"[simt_alu] bit-exact vs simt_alu_ref: {n_cases} cases, "
        f"W in (1, 8, 64, 4096) and (P, W, L) in (4, 8, 32), (8, 8, 32), "
        f"(3, 5, 30) and (4, 8, 32) one word off 16 bytes, "
        f"opcodes {all_ops[0]}..{all_ops[-1]}, max_abs_err {max_err}")
    return max_err


def offset_view(x, offset):
    """``x`` copied into a buffer ``offset`` words in: a contiguous view
    whose pointer is ``4 * offset`` bytes past the buffer's."""
    if not offset:
        return x
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    buf[offset:] = x.reshape(-1)
    return buf[offset:].view(x.shape)


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


def staged_launches_expected(dg, n_sm):
    """simt_alu launches of a staged run: one a group step, so the sum
    over the executor's dispatch groups of each group's longest block."""
    from repro_torch.runtime.executor import group_bounds
    steps = dg.block_steps()
    return sum(int(steps[lo:hi].max())
               for lo, hi in group_bounds(len(steps), n_sm, 8))


def phase_staged_cuda(launches):
    """The staged ``"cuda"`` backend on the card (``simt_alu`` inside the
    pipeline, one launch a step for a whole dispatch group) against the
    plain path on the host CPU: matmul n=32 (one group of 4 blocks of 298
    steps: 298 launches, where one position at a time made 1192), then
    the five paper programs at n=32 in one ``execute`` over two SMs."""
    from repro_torch.core import scheduler
    from repro_torch.core.machine import MachineConfig
    from repro_torch.core.programs import ALL
    mod, n = ALL["matmul"], 32
    code, (grid, bd) = mod.build(n), mod.launch(n)
    g0 = mod.make_gmem(np.random.default_rng(2), n)
    plain_dg = scheduler.execute(
        [scheduler.LaunchSpec(code, grid, bd, g0.copy())],
        cfg=MachineConfig(execute_backend="torch"), device="cpu")
    plain = plain_dg.to_results()[0]
    launches.clear()
    t0 = time.perf_counter()
    card = scheduler.run_grid(code, grid, bd, g0.copy(),
                              MachineConfig(execute_backend="cuda"),
                              device="cuda")
    wall = time.perf_counter() - t0
    counts = dict(launches)
    assert_same(plain, card, "staged cuda matmul n=32")
    want = staged_launches_expected(plain_dg, 1)
    if want != 298 or counts != {"simt_alu": want}:
        raise AssertionError(f"staged 'cuda' matmul n=32 launched {counts}, "
                             f"want {{'simt_alu': 298}} (expected {want})")
    log(f"[staged cuda] matmul n={n}: bit-exact vs CPU, wall "
        f"{wall * 1e3:.1f} ms, launches {counts} == 298, the group's "
        f"longest block's steps (4 blocks x 298 one position at a time "
        f"were 1192)")
    # the five-program drain through the staged backend, two SMs
    specs = []
    for name in sorted(ALL):
        m = ALL[name]
        specs.append((m.build(n), *m.launch(n),
                      m.make_gmem(np.random.default_rng(3), n)))
    cfg = MachineConfig(execute_backend="cuda")
    t0 = time.perf_counter()
    plain_dg = scheduler.execute([scheduler.LaunchSpec(*x) for x in specs],
                                 n_sm=2, cfg=cfg, device="cpu")
    plain = plain_dg.to_results()
    cpu_s = time.perf_counter() - t0
    launches.clear()
    t0 = time.perf_counter()
    dg = scheduler.execute([scheduler.LaunchSpec(*x) for x in specs],
                           n_sm=2, cfg=cfg, device="cuda")
    results, rep = dg.to_results(), dg.report()
    drain_wall = time.perf_counter() - t0
    drain_counts = dict(launches)
    for name, a, b, x in zip(sorted(ALL), plain, results, specs):
        assert_same(a, b, f"staged cuda drain {name}")
        check_grid(ALL[name], n, x[3], b, f"staged cuda drain {name}")
    if not np.array_equal(rep.per_sm_cycles, plain_dg.report().per_sm_cycles):
        raise AssertionError("staged cuda drain: per-SM cycles differ")
    want = staged_launches_expected(plain_dg, 2)
    if drain_counts != {"simt_alu": want}:
        raise AssertionError(f"staged cuda drain launched {drain_counts}, "
                             f"want {want}")
    log(f"[staged cuda] drain of 5 launches n={n} n_sm=2: oracles ok, every "
        f"field bit-exact vs CPU (plain path on the host CPU {cpu_s:.1f} s), "
        f"per-SM cycles {rep.per_sm_cycles.tolist()}, wall "
        f"{drain_wall * 1e3:.1f} ms, launches {drain_counts} == the sum of "
        f"each group's longest block ({int(plain_dg.block_steps().sum())} "
        f"block steps in all)")
    return counts["simt_alu"], wall


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
#: simt_alu's timing shapes: (label, operand shape).  The staged path's
#: call in phase 5 is the matmul n=32 group's 4 x 8 warp rows; 65536 rows
#: (67.4 MB of operands and results) exceed the 50 MB L2, so that reading
#: is held to the memory bound
ALU_SHAPES = (("8x32", (8, 32)), ("4x8x32, the staged path", (4, 8, 32)),
              ("8x8x32, an n=256 group", (8, 8, 32)), ("4096x32", (4096, 32)),
              ("65536x32", (65536, 32)))
#: the share of its bound the 65536-row readings (back to back, and with
#: the L2 emptied of the operands before each call) must reach
ALU_BOUND_SHARE = 0.5


def time_simt_alu(rng, launches_on_path, max_err, staged_wall):
    from repro_torch.kernels.ref import simt_alu_ref
    from repro_torch.kernels.simt_alu import simt_alu
    out = {}
    for label, shape in ALU_SHAPES:
        rows = int(np.prod(shape[:-1]))
        x = [t.view(*shape[:-1], *t.shape[1:])
             for t in alu_inputs(rng, rows, list(range(28)))]
        reps = 200 if rows <= 4096 else 100
        ms, ev_ms = timed(lambda: simt_alu(*x), reps)
        plain_ms = device_ms(lambda: simt_alu_ref(*x), 5)
        nbytes = (rows + 8 * rows * 32) * 4     # op + 6 operands in, 2 out
        ops = rows * 32 * 8   # selected op, difference, 4 flags, 2 masks
        bound = max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3
        out[label] = dict(ms=ms, event_ms=ev_ms, plain_ms=plain_ms,
                          bound_ms=bound, share=bound / ms, nbytes=nbytes,
                          bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                          >= ops / INT32_OPS_PER_S else "operations")
        cold = ""
        if label == "65536x32":
            out[label]["cold_ms"] = l2_cold_ms(lambda: simt_alu(*x), 50)
            out[label]["cold_share"] = bound / out[label]["cold_ms"]
            cold = (f"; L2 emptied before each call "
                    f"{out[label]['cold_ms']:.4f} ms, "
                    f"{out[label]['cold_share']:.1%} of the bound")
        log(f"[timing] simt_alu {label}: device {ms:.4f} ms (events, "
            f"back to back: {ev_ms:.4f} ms), plain device "
            f"{plain_ms:.4f} ms, bound {bound:.6f} ms ({nbytes} B), "
            f"{bound / ms:.1%} of the bound{cold}")
    big = out["65536x32"]
    if min(big["share"], big["cold_share"]) < ALU_BOUND_SHARE:
        raise AssertionError(f"simt_alu at 65536x32: {big['share']:.1%} and "
                             f"(L2 emptied) {big['cold_share']:.1%} of its "
                             f"bound, below {ALU_BOUND_SHARE:.0%}")
    path = out["4x8x32, the staged path"]
    return dict(name="simt_alu", route="cuda", variant="single",
                source="src/repro_torch/csrc/simt_alu.cu",
                replaces=SIMT_REPLACES, launches=launches_on_path,
                max_abs_err=max_err, library_ms=None,
                staged_matmul_wall_ms=staged_wall * 1e3,
                by_shape={k: {f: v[f] for f in ("ms", "event_ms", "bound_ms",
                                                "share", "cold_ms",
                                                "cold_share") if f in v}
                          for k, v in out.items()},
                **{k: path[k] for k in ("ms", "event_ms", "plain_ms",
                                        "bound_ms", "bound_by")})


#: cycles a block may run in the budgeted comparison on the card (about
#: 110 of matmul's 2286 steps)
PLAIN_CARD_BUDGET = 4000


def fused_group(name, n=256, positions=8):
    """The first dispatch group of ``name`` at ``n`` as the executor
    forms it: the program (1, C, 10), the geometry rows of the first
    ``positions`` blocks (fewer if the grid is smaller), their (P, G)
    gmem snapshots (host tensors), and the warps a block needs."""
    from repro_torch.core.programs import ALL
    from repro_torch.runtime import registry as reg
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


def time_group(name):
    """One dispatch group of ``name`` at n=256 on the card: device ms per
    launch (spin-queued, less the snapshot copy each launch needs), steps,
    store steps (those that take the read/write barrier) and the bound."""
    from repro_torch.core.machine import MachineConfig
    from repro_torch.core.pipeline.fused import (C_STEPS, C_STORE_STEPS,
                                                 fused_sm_run, predecode)
    cfg = MachineConfig()
    code, geom, gmem, W = fused_group(name)
    code_d, gmem_d = code.cuda(), gmem.cuda()
    pre = dict(records=predecode(code_d, cfg),
               geom_dev=torch.as_tensor(geom, device="cuda"))
    work = gmem_d.clone()

    def kernel():
        work.copy_(gmem_d)
        return fused_sm_run(cfg, W, code_d, geom, work, **pre)

    k_ms = device_ms(kernel, 10) - device_ms(lambda: work.copy_(gmem_d), 10)
    _, _, ctr = fused_sm_run(cfg, W, code_d, geom, gmem_d.clone(), **pre)
    ctr = ctr.cpu()
    P, G = gmem.shape
    nbytes = (code.numel() + geom.size + 3 * P * G
              + ctr.numel()) * 4          # gmem in; gmem, gw, counters out
    lane_ops = int(ctr[:, 28:56].sum())   # simulated lane-instructions
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, lane_ops / INT32_OPS_PER_S
    steps = int(ctr[:, C_STEPS].max())
    store = int(ctr[ctr[:, C_STEPS].argmax(), C_STORE_STEPS])
    out = dict(ms=k_ms, steps=steps, store_steps=store, P=P, W=W,
               us_per_step=k_ms / steps * 1e3,
               bound_ms=max(t_bytes, t_ops) * 1e3, nbytes=nbytes,
               lane_ops=lane_ops,
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    log(f"[timing] fused_sm_run {name} n=256, {P} blocks x {W} warps, "
        f"{steps} steps a block, {store} of them with the read/write "
        f"barrier ({store / steps:.1%}): {k_ms:.4f} ms per launch "
        f"({out['us_per_step']:.4f} us per step); bound "
        f"{out['bound_ms']:.6f} ms ({nbytes} B, {lane_ops} "
        f"lane-instructions)")
    return out


def time_fused(launches_on_path):
    """One dispatch group of each paper program at n=256 on the card; the
    matmul group (8 blocks) also against the plain version on the host
    CPU, whole, and on the card over a cycle budget."""
    from repro_torch.core.machine import MachineConfig
    from repro_torch.core.pipeline.fused import (C_STEPS, fused_sm_run,
                                                 staged_run)
    from repro_torch.core.programs import ALL
    groups = {name: time_group(name) for name in sorted(ALL)}
    cfg = MachineConfig()
    code, geom, gmem, W = fused_group("matmul")
    code_d, gmem_d = code.cuda(), gmem.cuda()

    def max_err(got, want):
        return max((a.cpu().long() - b.cpu().long()).abs().max().item()
                   for a, b in zip(got, want))

    got = fused_sm_run(cfg, W, code_d, geom, gmem_d.clone())
    t0 = time.perf_counter()
    plain = staged_run(replace(cfg, execute_backend="torch"), W, code, geom,
                       gmem.clone())
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max_err(got, plain)
    # the plain version on the card, over PLAIN_CARD_BUDGET cycles a block
    bcfg = replace(cfg, max_cycles=PLAIN_CARD_BUDGET)
    short_k = fused_sm_run(bcfg, W, code_d, geom, gmem_d.clone())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    short_p = staged_run(replace(bcfg, execute_backend="torch"), W, code_d,
                         geom, gmem_d.clone())
    torch.cuda.synchronize()
    card_plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(err, max_err(short_k, short_p))
    if err:
        raise AssertionError("fused_sm_run != staged_run")
    mm = groups["matmul"]
    short_steps = int(short_p[2][:, C_STEPS].max().item())
    log(f"[timing] fused_sm_run matmul n=256 group: every output bit-exact "
        f"with the plain staged path on the host CPU ({plain_ms:.1f} ms) "
        f"and, over max_cycles={PLAIN_CARD_BUDGET} ({short_steps} steps), "
        f"on the card ({card_plain_ms:.1f} ms, "
        f"{card_plain_ms / short_steps:.3f} ms per step of the group; "
        f"kernel {mm['us_per_step']:.4f} us)")
    log("[timing] fused_sm_run us per step at n=256: " + ", ".join(
        f"{k} {v['us_per_step']:.4f}" for k, v in groups.items()))
    return dict(name="fused_sm_run", route="cuda", variant="single",
                source="src/repro_torch/csrc/fused_sm.cu",
                replaces=FUSED_REPLACES, launches=launches_on_path,
                max_abs_err=err, ms=mm["ms"], plain_ms=plain_ms,
                bound_ms=mm["bound_ms"], bound_by=mm["bound_by"],
                library_ms=None, us_per_step={
                    k: v["us_per_step"] for k, v in groups.items()},
                store_steps={k: [v["store_steps"], v["steps"]]
                             for k, v in groups.items()})


# ------------------------------------------------------------ phase 8
def rand(g, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


def close(got, want, tol, tag):
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol, msg=lambda m: f"{tag}: {m}")
    return err


def variant_counts():
    from repro_torch.kernels import _build
    return dict(_build.VARIANTS)


def flash_case(fn, want_fn, args, causal, tol, tag, want_variant,
               forced=None):
    """One flash call against its plain version; the launch must have
    taken ``want_variant``."""
    from repro_torch.kernels import _build
    _build.VARIANTS.clear()
    got = fn(*args, causal=causal, variant=forced)
    if variant_counts() != {("flash_attention", want_variant): 1}:
        raise AssertionError(f"{tag}: launched {variant_counts()}, want "
                             f"{want_variant}")
    return close(got, want_fn(*args, causal=causal), tol, tag)


def phase_flash_vs_plain():
    """The sweep through both variants: every bf16 case at dh 64/128 by
    the rule's tensor-core variant and by the SIMT one; float32 and the
    misaligned case by the SIMT one, which the rule must choose."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_gqa)
    from repro_torch.kernels.ref import flash_attention_ref, mha_ref
    g = torch.Generator(device="cuda").manual_seed(5)
    cases = [(256, 256, 64, True), (256, 256, 128, True),
             (128, 512, 64, False), (512, 512, 64, True),
             (200, 200, 128, True), (200, 200, 64, False)]
    errs = {"tc": 0.0, "simt f32": 0.0, "simt bf16": 0.0}
    n = 0
    for Sq, Sk, dh, causal in cases:
        for dtype, tol in ((torch.float32, 2e-3), (torch.bfloat16, 3e-2)):
            q, k, v = (rand(g, (3, s, dh), dtype) for s in (Sq, Sk, Sk))
            tag = f"flash {Sq}x{Sk}x{dh} causal={causal} {dtype}"
            runs = [("simt", "simt")] if dtype == torch.float32 else \
                [("tc", None), ("simt", "simt")]
            for want, forced in runs:
                key = want if want == "tc" else \
                    f"simt {'f32' if dtype == torch.float32 else 'bf16'}"
                errs[key] = max(errs[key], flash_case(
                    flash_attention, flash_attention_ref, (q, k, v), causal,
                    tol, f"{tag} {want}", want, forced))
                n += 1
    max_err = max(errs.values())
    # large logits (q, k scaled by 30): tolerance 1e-2
    q, k = (rand(g, (1, 256, 64), torch.float32, 30) for _ in range(2))
    v = rand(g, (1, 256, 64), torch.float32)
    got = flash_attention(q, k, v, causal=True)
    if not torch.isfinite(got).all():
        raise AssertionError("flash: non-finite output at large logits")
    max_err = max(max_err, close(got, flash_attention_ref(q, k, v), 1e-2,
                                 "flash large logits"))
    # the model's call: GQA heads, keys a prefix of a longer bf16 cache
    q = rand(g, (4, 512, 16, 128), torch.bfloat16)
    ck, cv = (rand(g, (4, 544, 8, 128), torch.bfloat16) for _ in range(2))
    args = (q, ck[:, :512], cv[:, :512])
    for want, forced in (("tc", None), ("simt", "simt")):
        max_err = max(max_err, flash_case(
            flash_attention_gqa, mha_ref, args, True, 3e-2,
            f"flash GQA cache prefix {want}", want, forced))
    # a q one element past a 16-byte boundary: the rule must take SIMT
    buf = rand(g, (4 * 256 * 8 * 64 + 1,), torch.bfloat16)
    qm = buf[1:].view(4, 256, 8, 64)
    km, vm = (rand(g, (4, 256, 4, 64), torch.bfloat16) for _ in range(2))
    max_err = max(max_err, flash_case(
        flash_attention_gqa, mha_ref, (qm, km, vm), True, 3e-2,
        "flash misaligned q", "simt"))
    log(f"[flash_attention] vs flash_attention_ref: {n + 4} cases (the "
        f"test_kernels sweep, S=200, each bf16 case by both variants; "
        f"large logits; GQA cache prefix by both; misaligned q by SIMT) "
        f"within tolerance (f32 2e-3, bf16 3e-2, large 1e-2); every launch "
        f"took the variant the rule or the caller named; max_abs_err "
        f"{max_err:.3e} (sweep tc {errs['tc']:.3e}, simt f32 "
        f"{errs['simt f32']:.3e}, simt bf16 {errs['simt bf16']:.3e})")
    return max_err


def phase_matmul_vs_plain(launches):
    """The sweep, then the matmul kernel's path: ``ops.matmul`` at
    ``kernel_micro``'s shape, 512x512 float32 with 128 tiles."""
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.matmul import variant
    from repro_torch.kernels.ref import matmul_ref
    g = torch.Generator(device="cuda").manual_seed(6)
    by_dtype = {torch.float32: 0.0, torch.bfloat16: 0.0}
    seen = set()
    # the sweep; 200^3 is ragged against the 64 x 32 tiles; rows of K =
    # 100 and N = 50 are not whole 16-byte vectors (the scalar variants)
    for M, K, N, blk in ((128, 128, 128, 128), (256, 384, 128, 128),
                         (384, 128, 256, 128), (200, 200, 200, 512),
                         (300, 100, 50, 512)):
        for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 2e-2)):
            a, b = rand(g, (M, K), dtype), rand(g, (K, N), dtype)
            want = variant(a, b)
            seen.add(want)
            _build.VARIANTS.clear()
            got = ops.matmul(a, b, bm=blk, bn=blk, bk=blk)
            if variant_counts() != {("matmul", want): 1}:
                raise AssertionError(f"matmul {M}x{K}x{N} {dtype}: launched "
                                     f"{variant_counts()}, want {want}")
            by_dtype[dtype] = max(by_dtype[dtype], close(
                got, matmul_ref(a, b), tol, f"matmul {M}x{K}x{N} {dtype}"))
    if seen != {"simt", "simt_scalar", "tc", "tc_scalar"}:
        raise AssertionError(f"matmul sweep took only {seen}")
    a, b = (rand(g, (512, 512), torch.float32) for _ in range(2))
    launches.clear()
    _build.VARIANTS.clear()
    got = ops.matmul(a, b, bm=128, bn=128, bk=128)
    counts = dict(launches)
    if counts != {"matmul": 1} or variant_counts() != {("matmul", "simt"): 1}:
        raise AssertionError(f"ops.matmul path launched {counts}, "
                             f"{variant_counts()}")
    path_err = close(got, matmul_ref(a, b), 1e-3, "matmul 512x512 f32")
    max_err = max(path_err, *by_dtype.values())
    log(f"[matmul] vs matmul_ref: 11 cases, all four variants, within "
        f"tolerance (f32 1e-3, bf16 2e-2); max_abs_err {max_err:.3e} (f32 "
        f"{max(path_err, by_dtype[torch.float32]):.3e}, bf16 "
        f"{by_dtype[torch.bfloat16]:.3e}, one bf16 ulp of outputs near "
        f"20); ops.matmul 512x512 f32 path launches {counts}")
    return counts["matmul"], max_err, (a, b)


# ------------------------------------------------------------ phase 9
def prefill(params, spec, prompt, max_seq):
    """The serving prefill step: (B, P) tokens at cache index 0."""
    from repro_torch.models import api
    state = api.decode_state(spec, prompt.shape[0], max_seq)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits, state = api.apply_decode(params, spec, prompt, state, 0)
    torch.cuda.synchronize()
    return logits[:, -1].clone(), state, (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def flash_swapped(fn):
    """Run the enclosed code with ``fn`` in the place of the flash wrapper
    that ``ops.mha`` calls."""
    from repro_torch.kernels import flash_attention as fa
    real = fa.flash_attention_gqa
    fa.flash_attention_gqa = fn
    try:
        yield
    finally:
        fa.flash_attention_gqa = real


def plain_attention():
    """The prefill's attention as the plain version (no launch)."""
    from repro_torch.kernels.ref import mha_ref
    return flash_swapped(mha_ref)


@contextlib.contextmanager
def per_layer_check(errs, fn=None, tol=LAYER_TOL):
    """Hold every flash call of the enclosed run (the kernel, or ``fn``)
    against the plain version on the same inputs, within ``tol`` (None:
    record the error only).  The plain calls are not counted: the wrapper
    counts only its own launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import mha_ref
    run = fn or fa.flash_attention_gqa

    def checked(q, k, v, *, causal=True):
        out = run(q, k, v, causal=causal)
        want = mha_ref(q, k, v, causal=causal)
        errs.append(close(out, want, tol, f"layer {len(errs)}")
                    if tol is not None else
                    (out.float() - want.float()).abs().max().item())
        return out

    with flash_swapped(checked):
        yield


def planted(q, k, v, *, causal=True, fault):
    """Plain GQA attention with a planted fault, to read what the checks
    see of one: ``"bf16_scores"`` rounds the scores to bf16 before the
    softmax; ``"dropped_tile"`` drops keys 0-63 (the kernel's first KV
    tile) for every query past them."""
    rep = q.shape[2] // k.shape[2]
    k, v = (x.repeat_interleave(rep, 2).float() for x in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * q.shape[-1] ** -0.5
    if fault == "bf16_scores":
        s = s.to(torch.bfloat16).float()
    Sq, Sk = s.shape[-2:]
    qi = torch.arange(Sq, device=q.device)[:, None]
    kj = torch.arange(Sk, device=q.device)[None, :]
    masked = (kj > qi) if causal else torch.zeros_like(kj > qi)
    if fault == "dropped_tile":
        masked = masked | ((kj < 64) & (qi >= 64))
    p = s.masked_fill(masked, float("-inf")).softmax(-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).to(q.dtype)


def rel_err(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def device_profile(fn):
    """Device time (ms), kernel launches and the three costliest kernels
    of one run of ``fn``, from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    dev_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:3]
    return dev_us / 1e3, launches, "; ".join(
        f"{e.key[:40]} x{e.count} {e.self_device_time_total / 1e3:.2f} ms"
        for e in top)


def phase_serving(launches):
    """``serve.main`` at full width, then the prefill step with and
    without the flash kernel on the same weights and prompt, decode, and
    a device profile of one prefill and of three decode steps."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models import api
    spec = configs.get("qwen3-0.6b")
    cfg, B, G = spec.cfg, 4, 32
    flash_launches = None
    from repro_torch.kernels import _build
    for P in PROMPTS:
        launches.clear()
        _build.VARIANTS.clear()
        t0 = time.perf_counter()
        gen = serve.main(SERVE_ARGS + ["--prompt-len", str(P)])
        wall = time.perf_counter() - t0
        counts = dict(launches)
        if counts != {"flash_attention": cfg.n_layers}:
            raise AssertionError(f"serve P={P}: launches {counts}, want "
                                 f"{cfg.n_layers} flash_attention")
        if variant_counts() != {("flash_attention", "tc"): cfg.n_layers}:
            raise AssertionError(f"serve P={P}: variants {variant_counts()}"
                                 f", want all {cfg.n_layers} tc")
        if gen.shape != (B, G) or gen.min() < 0 or gen.max() >= cfg.vocab:
            raise AssertionError(f"serve P={P}: tokens {gen.shape}")
        flash_launches = flash_launches or counts["flash_attention"]
        log(f"[serve] main P={P}: {gen.shape} tokens in [0, {cfg.vocab}), "
            f"wall {wall:.1f} s, launches {counts}, every flash launch the "
            f"tensor-core variant")

        params = api.init(torch.Generator(device="cuda").manual_seed(0),
                          spec)
        prompt = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab, (B, P)), device="cuda")
        errs = []
        with per_layer_check(errs):
            prefill(params, spec, prompt, P + G)
        if len(errs) != cfg.n_layers:
            raise AssertionError(f"prefill P={P}: {len(errs)} flash calls")
        lk, sk, k_ms = prefill(params, spec, prompt, P + G)
        with plain_attention():
            lp, sp, p_ms = prefill(params, spec, prompt, P + G)

        def against_plain(logits, state):
            return rel_err(logits, lp), max(
                rel_err(a[layer, :, :P], b[layer, :, :P])
                for a, b in zip(state["kv"], sp["kv"])
                for layer in range(cfg.n_layers))

        logit_rel, cache_rel = against_plain(lk, sk)
        logit_abs = (lk - lp).abs().max().item()
        agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
        if not (logit_rel <= LM_REL_TOL and cache_rel <= LM_REL_TOL):
            raise AssertionError(f"prefill P={P}: logits relative error "
                                 f"{logit_rel}, caches {cache_rel}")
        log(f"[serve] prefill P={P} B={B}: every layer's flash output "
            f"within {LAYER_TOL} of the plain version (max "
            f"{max(errs):.3e}); vs the plain attention end to end: "
            f"logits relative {logit_rel:.3e} (max abs {logit_abs:.3e}), "
            f"caches relative <= {cache_rel:.3e} (tol {LM_REL_TOL}); "
            f"greedy token agreement {agree:.2f}")
        if P == PROMPTS[0]:
            for fault in ("bf16_scores", "dropped_tile"):
                ferrs = []
                with per_layer_check(ferrs, partial(planted, fault=fault),
                                     tol=None):
                    lf, sf, _ = prefill(params, spec, prompt, P + G)
                f_logit, f_cache = against_plain(lf, sf)
                log(f"[serve] planted fault {fault} P={P}: per-layer max "
                    f"abs error {max(ferrs):.3e} (guard {LAYER_TOL}); vs "
                    f"the plain attention end to end: logits relative "
                    f"{f_logit:.3e}, caches relative <= {f_cache:.3e} "
                    f"(sanity bound {LM_REL_TOL})")
                del lf, sf
        del sp, lp
        # decode: 32 steps from the kernel prefill's state
        step = build_serve_step(spec)
        tok, state = lk.argmax(-1).to(torch.int32), sk
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(G):
            tok, state = step(params, state, tok[:, None], P + i)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        log(f"[serve] P={P} B={B}: prefill {k_ms:.1f} ms with the kernel "
            f"({B * P / k_ms * 1e3:.0f} tok/s), {p_ms:.1f} ms with the plain "
            f"attention; decode {G} steps {dec_s * 1e3:.1f} ms "
            f"({dec_s / G * 1e3:.2f} ms a step, {B * G / dec_s:.1f} tok/s)")
        if P == PROMPTS[0]:
            pre = device_profile(
                lambda: prefill(params, spec, prompt, P + G))
            state = api.decode_state(spec, B, P + G)
            step(params, state, prompt, 0)

            def three_steps():
                t = tok
                for i in range(3):
                    t, _ = step(params, state, t[:, None], P + i)

            dec = device_profile(three_steps)
            step_ms = dec_s / G * 1e3
            log(f"[profile] prefill P={P}: device {pre[0]:.2f} ms, "
                f"{pre[1]} launches; busy {pre[0] / k_ms:.2f} of the "
                f"unprofiled {k_ms:.1f} ms; top: {pre[2]}")
            log(f"[profile] decode: device {dec[0] / 3:.2f} ms and "
                f"{dec[1] / 3:.0f} launches a step; busy "
                f"{dec[0] / 3 / step_ms:.2f} of the unprofiled {step_ms:.2f} "
                f"ms; top over 3 steps: {dec[2]}")
        del params, sk, state, lk
        torch.cuda.empty_cache()
    return flash_launches


# ------------------------------------------------------------ phase 10
def bound(nbytes, flops, dtype):
    peak, name = PEAK_FLOPS[dtype]
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations", \
        name


def time_sdpa(qh, kh, vh):
    """``scaled_dot_product_attention`` on (B, H, S, dh) inputs: its
    device and event times unrestricted, its device time under
    ``sdpa_kernel`` restricted to each backend that takes the shape (one
    that refuses it raises RuntimeError on the call, which is what the
    probe reads), and the backend whose output equals the unrestricted
    call's bit for bit, the closest in device time first."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    lib = partial(F.scaled_dot_product_attention, qh, kh, vh,
                  is_causal=True, enable_gqa=True)
    ref = lib()
    lib_ms, lib_event_ms = timed(lib, 50)
    by_backend, same = {}, []
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        with sdpa_kernel(be):
            try:
                out = lib()
            except RuntimeError:
                continue
            by_backend[be.name] = device_ms(lib, 20)
        if torch.equal(out, ref):
            same.append(be.name)
    same.sort(key=lambda n: abs(by_backend[n] - lib_ms))
    return (lib, lib_ms, lib_event_ms, by_backend,
            same[0] if same else "none matched")


def time_flash(launches_on_path, max_err):
    """The prefill's call: B 4, S 512, 16 query heads on 8 KV heads, dh
    128, bf16, causal, by both variants."""
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    from repro_torch.kernels.ref import mha_ref
    B, S, H, KH, dh = 4, 512, 16, 8, 128
    g = torch.Generator(device="cuda").manual_seed(7)
    q = rand(g, (B, S, H, dh), torch.bfloat16)
    k, v = (rand(g, (B, S, KH, dh), torch.bfloat16) for _ in range(2))
    tc_ms, tc_event = timed(
        lambda: flash_attention_gqa(q, k, v, causal=True), 50)
    simt_ms, simt_event = timed(
        lambda: flash_attention_gqa(q, k, v, causal=True, variant="simt"),
        20)
    plain_ms = device_ms(lambda: mha_ref(q, k, v, causal=True), 10)
    lib, lib_ms, lib_event, by_backend, backend = time_sdpa(
        *(x.transpose(1, 2).contiguous() for x in (q, k, v)))
    lib_err = (lib().transpose(1, 2).float()
               - flash_attention_gqa(q, k, v).float()).abs().max().item()
    nbytes = 2 * (2 * B * S * H * dh + 2 * B * S * KH * dh)
    flops = 4 * dh * B * H * (S * (S + 1) // 2)   # QK^T and PV, causal
    bound_ms, by, peak = bound(nbytes, flops, torch.bfloat16)
    log(f"[timing] flash_attention B={B} S={S} H={H}/{KH} dh={dh} bf16 "
        f"causal, device (events, back to back): tc {tc_ms:.4f} ms "
        f"({tc_event:.4f}), simt {simt_ms:.4f} ms ({simt_event:.4f}; "
        f"{simt_ms / tc_ms:.1f}x tc), plain {plain_ms:.4f} ms, "
        f"scaled_dot_product_attention {lib_ms:.4f} ms ({lib_event:.4f}; "
        f"max diff {lib_err:.2e}; by backend "
        + ", ".join(f"{n} {t:.4f} ms" for n, t in by_backend.items())
        + f"; the unrestricted call ran {backend}); bound {bound_ms:.5f} ms "
        f"({nbytes} B, {flops} FLOP, {by}; peak {peak})")
    return dict(name="flash_attention", route="cuda", variant="tc",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces=FLASH_REPLACES, launches=launches_on_path,
                max_abs_err=max_err, ms=tc_ms, event_ms=tc_event,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=lib_ms, variant_ms={"tc": tc_ms, "simt": simt_ms},
                library_backend=backend)


def time_matmul(launches_on_path, max_err, ab):
    """``kernel_micro``'s call, 512x512 float32 with 128 tiles (the path),
    and the same product in bfloat16 (the tensor-core variant), each
    beside ``torch.matmul`` of its dtype."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import matmul_ref
    out = {}
    for a, b in (ab, tuple(x.bfloat16() for x in ab)):
        ms, ev_ms = timed(
            lambda: ops.matmul(a, b, bm=128, bn=128, bk=128), 100)
        plain_ms = device_ms(lambda: matmul_ref(a, b), 100)
        lib_ms, lib_event = timed(lambda: torch.matmul(a, b), 100)
        M, K = a.shape
        N = b.shape[1]
        nbytes = a.element_size() * (M * K + K * N + M * N)
        flops = 2 * M * N * K
        bound_ms, by, peak = bound(nbytes, flops, a.dtype)
        log(f"[timing] matmul {M}x{K}x{N} {str(a.dtype)[6:]}, device "
            f"(events, back to back): {ms:.4f} ms ({ev_ms:.4f}), plain "
            f"{plain_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms "
            f"({lib_event:.4f}); bound {bound_ms:.5f} ms ({nbytes} B, "
            f"{flops} FLOP, {by}; peak {peak})")
        out[a.dtype] = dict(ms=ms, event_ms=ev_ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=by, library_ms=lib_ms)
    return dict(name="matmul", route="cuda", variant="simt",
                source="src/repro_torch/csrc/matmul.cu",
                replaces=MATMUL_REPLACES, launches=launches_on_path,
                max_abs_err=max_err, **out[torch.float32],
                variant_ms={"simt": out[torch.float32]["ms"],
                            "tc": out[torch.bfloat16]["ms"]})


# ------------------------------------------------------------ phases 11-13
#: the paper's SP counts (Fig. 4, Tables 3 and 5)
SPS = (8, 16, 32)
#: rows of ``benchmarks/run.py`` at BENCH_N=32 as the JAX package gives them
#: (table2 as in BENCH_1786234012.json); the card's rows must equal them
PINNED_N32 = {
    "table2_area_1sm_8sp": "lut_bits=29968;state_bits=161040",
    "table2_area_1sm_16sp": "lut_bits=38416;state_bits=169488",
    "table2_area_1sm_32sp": "lut_bits=55312;state_bits=186384",
    "table2_area_2sm_8sp": "lut_bits=59936;state_bits=322080",
    "table2_area_2sm_16sp": "lut_bits=76832;state_bits=338976",
    "table2_area_2sm_32sp": "lut_bits=110624;state_bits=372768",
    "fig4_autocorr_8sp": "speedup=9.13", "fig4_bitonic_8sp": "speedup=16.92",
    "fig4_matmul_8sp": "speedup=22.01",
    "fig4_reduction_8sp": "speedup=8.76",
    "fig4_transpose_8sp": "speedup=15.77",
    "table5_autocorr_8sp": "energy_red=44%",
    "table5_bitonic_8sp": "energy_red=71%",
    "table5_matmul_8sp": "energy_red=63%",
    "table5_reduction_8sp": "energy_red=64%",
    "table5_transpose_8sp": "energy_red=54%",
}
#: Table 6's variant per program at n=32 (tests/test_customize_energy.py)
PINNED_VARIANTS = {"autocorr": "stack2", "bitonic": "stack2_nomul",
                   "matmul": "stack2", "reduction": "stack2",
                   "transpose": "stack2"}
#: the programs phase 13 runs through the "reference" backend on the card:
#: all five (matmul, 2384 issues a block, is most of the phase's time)
REFERENCE_PROGRAMS = ("autocorr", "bitonic", "matmul", "reduction",
                      "transpose")


def paper_rows(n, device="cuda", backend="cuda_fused"):
    """The paper's tables at input size ``n`` through the port's entry
    points, with the formulas and row formats of ``benchmarks/run.py`` at
    ``BENCH_N=n``: ``table2_area_*``, ``fig4_*`` (8/16/32 SPs),
    ``fig5_*_2sm`` and ``table3_*`` (from executed one- and two-SM
    schedules, ``rep.kernel_cycles``), ``table5_*`` and ``table6_*`` (each
    program on its ``minimal_config``).  Every program's output is held to
    its numpy oracle and each executed per-SM cycle count to the analytical
    replay.  Returns (rows, values): the row name -> its ``derived`` string,
    and the row name -> the numbers behind it."""
    from repro_torch.core import customize, energy, scheduler
    from repro_torch.core.machine import MachineConfig
    from repro_torch.core.programs import ALL, reduction
    rows, values, cache = {}, {}, {}
    run_grid = partial(scheduler.run_grid, device=device)

    def emit(name, derived, **v):
        rows[name], values[name] = derived, v

    def cfg_of(**kw):
        return MachineConfig(execute_backend=backend, **kw)

    def run(name, cfg):                         # benchmarks/run.py _run
        if (name, cfg) not in cache:
            mod = ALL[name]
            code = mod.build(n)
            g0 = mod.make_gmem(np.random.default_rng(0), n)
            if name == "reduction":
                gmem, passes = reduction.run_passes(run_grid, code, n,
                                                    g0.copy(), cfg=cfg)
                res = passes[0]
            else:
                res = run_grid(code, *mod.launch(n), g0.copy(), cfg)
                gmem = res.gmem
            if not np.array_equal(gmem[mod.out_slice(n)], mod.oracle(g0, n)):
                raise AssertionError(f"paper n={n} {name}: oracle differs")
            cache[name, cfg] = res
        return cache[name, cfg]

    for n_sm in (1, 2):                                       # Table 2
        for n_sp in SPS:
            cfg = cfg_of(n_sp=n_sp)
            lut, bits = cfg.lut_bits() * n_sm, cfg.state_bits() * n_sm
            emit(f"table2_area_{n_sm}sm_{n_sp}sp",
                 f"lut_bits={lut};state_bits={bits}", lut_bits=lut,
                 state_bits=bits)
    for name in sorted(ALL):                                  # Fig. 4
        for n_sp in SPS:
            res = run(name, cfg_of(n_sp=n_sp))
            simt = res.sm_cycles(1)
            scal = energy.scalar_model_cycles(res, ALL[name].n_threads(n))
            emit(f"fig4_{name}_{n_sp}sp", f"speedup={scal / simt:.2f}",
                 speedup=scal / simt, scalar_cycles=scal, simt_cycles=simt)
    # Fig. 5 / Table 3: sizes giving each program >= 2 blocks; bitonic
    # sorts two independent segments
    n_2sm = {"autocorr": 2 * n, "matmul": n, "transpose": n,
             "reduction": 32 * n, "bitonic": n}
    for name in sorted(ALL):
        mod, m = ALL[name], n_2sm[name]
        kw = {"blocks": 2} if name == "bitonic" else {}
        code = mod.build(m, **kw)
        g0 = mod.make_gmem(np.random.default_rng(0), m, **kw)
        spec = (code, *mod.launch(m, **kw))
        for n_sp in SPS:
            cfg = cfg_of(n_sp=n_sp)
            dg = scheduler.execute([scheduler.LaunchSpec(*spec, g0.copy())],
                                   n_sm=1, cfg=cfg, device=device)
            res = dg.to_results()[0]
            if name == "reduction":        # the first pass's partials
                nb, bd = reduction.launch(m)[0][0], 2 * reduction.BD
                x = g0[reduction.IN_AT:reduction.IN_AT + m].astype(np.int64)
                want = np.array([x[b * bd:(b + 1) * bd].sum()
                                 for b in range(nb)]).astype(np.int32)
                got = res.gmem[reduction.IN_AT + m:reduction.IN_AT + m + nb]
            else:
                want = mod.oracle(g0, m, **kw)
                got = res.gmem[mod.out_slice(m, **kw)]
            if not np.array_equal(got, want):
                raise AssertionError(f"paper fig5 {name} n={m}: oracle")
            dg2 = scheduler.execute([scheduler.LaunchSpec(*spec, g0.copy())],
                                    n_sm=2, cfg=cfg, device=device)
            one_r, two_r = dg.report(), dg2.report()
            for rep in (one_r, two_r):
                if not np.array_equal(rep.per_sm_cycles,
                                      res.per_sm_cycles(rep.n_sm)):
                    raise AssertionError(f"paper fig5 {name}: executed "
                                         "per-SM cycles != analytical")
            one, two = one_r.kernel_cycles, two_r.kernel_cycles
            scal = energy.scalar_model_cycles(res, mod.n_threads(m, **kw))
            emit(f"fig5_{name}_{n_sp}sp_2sm",
                 f"speedup_vs_scalar={scal / two:.2f}",
                 speedup_vs_scalar=scal / two, scalar_cycles=scal,
                 kernel_cycles_2sm=two)
            emit(f"table3_{name}_{n_sp}sp",
                 f"scaling_2sm_over_1sm={one / two:.2f}",
                 scaling=one / two, kernel_cycles_1sm=one,
                 kernel_cycles_2sm=two)
    for name in sorted(ALL):                                  # Table 5
        for n_sp in SPS:
            cfg = cfg_of(n_sp=n_sp)
            res = run(name, cfg)
            e_simt = energy.simt_energy(res, cfg).total
            e_scal = energy.scalar_energy(res, ALL[name].n_threads(n)).total
            red = 100.0 * (1 - e_simt / e_scal)
            emit(f"table5_{name}_{n_sp}sp", f"energy_red={red:.0f}%",
                 energy_red=red, e_simt=e_simt, e_scalar=e_scal)
    base = cfg_of(n_sp=8)                                     # Table 6
    for name in sorted(ALL):
        code = ALL[name].build(n)
        mcfg = customize.minimal_config(code, base)
        res = run(name, mcfg)
        area = 100 * (1 - mcfg.lut_bits() / base.lut_bits())
        e_base = energy.simt_energy(res, base).total
        e_min = energy.simt_energy(res, mcfg).total
        dyn = 100 * (1 - e_min / e_base)
        variant = customize.select_variant(code)
        emit(f"table6_{name}",
             f"variant={variant};stack={mcfg.warp_stack_depth};"
             f"mul={int(mcfg.enable_mul)};area_red={area:.0f}%;"
             f"dyn_energy_red={dyn:.0f}%", variant=variant, area_red=area,
             dyn_energy_red=dyn, e_base=e_base, e_min=e_min)
    return rows, values


def log_tables(n, rows):
    """One ``[paper]`` line per table."""
    for table in ("table2", "fig4", "fig5", "table3", "table5", "table6"):
        log(f"[paper] n={n} {table}: " + " ".join(
            f"{k[len(table) + 1:]}:{v}" for k, v in rows.items()
            if k.startswith(table + "_")))


def phase_paper_n32(launches):
    """The tables at n=32 on the card (the default ``"cuda_fused"``
    backend) against the same function on the host CPU through the plain
    ``"torch"`` backend, every row and every number behind it, and against
    the JAX package's values pinned above."""
    t0 = time.perf_counter()
    plain_rows, plain_values = paper_rows(32, "cpu", "torch")
    cpu_s = time.perf_counter() - t0
    launches.clear()
    t0 = time.perf_counter()
    rows, values = paper_rows(32)
    card_s = time.perf_counter() - t0
    counts = dict(launches)
    if set(counts) != {"fused_sm_run"}:       # fused_sm_run, and only it
        raise AssertionError(f"paper n=32 launched {counts}")
    if rows != plain_rows or values != plain_values:
        bad = [k for k in rows if rows[k] != plain_rows.get(k)
               or values[k] != plain_values.get(k)]
        raise AssertionError(f"paper n=32: card != CPU plain path at {bad}")
    bad = {k: (rows.get(k), v) for k, v in PINNED_N32.items()
           if rows.get(k) != v}
    bad.update({f"table6_{k}": (values[f"table6_{k}"]["variant"], v)
                for k, v in PINNED_VARIANTS.items()
                if values[f"table6_{k}"]["variant"] != v})
    if bad:
        raise AssertionError(f"paper n=32 differs from the pinned values: "
                             f"{bad}")
    log_tables(32, rows)
    log(f"[paper] n=32: {len(rows)} rows on the card ({card_s:.1f} s, "
        f"launches {counts}) == the plain path on the host CPU "
        f"({cpu_s:.1f} s), every row and number; == the {len(PINNED_N32)} "
        f"pinned rows and the Table 6 variants of the JAX package")
    return counts["fused_sm_run"], card_s


def phase_paper_n256(launches, smi):
    """The tables at the paper's largest size on the card, and the means
    over the five programs beside the paper's headline numbers."""
    launches.clear()
    t0 = time.perf_counter()
    rows, values = paper_rows(256)
    wall = time.perf_counter() - t0
    counts = dict(launches)
    if set(counts) != {"fused_sm_run"}:
        raise AssertionError(f"paper n=256 launched {counts}")
    log_tables(256, rows)
    names = sorted({k.split("_")[1] for k in rows if k.startswith("fig4_")})

    def mean(fmt, key):
        return float(np.mean([values[fmt.format(p)][key] for p in names]))

    means = {f"fig4_speedup_{sp}sp": mean("fig4_{}_%dsp" % sp, "speedup")
             for sp in SPS}
    means["fig5_speedup_32sp_2sm"] = mean("fig5_{}_32sp_2sm",
                                          "speedup_vs_scalar")
    means.update({f"table5_energy_red_{sp}sp": mean("table5_{}_%dsp" % sp,
                                                    "energy_red")
                  for sp in SPS})
    means["table6_dyn_energy_red"] = mean("table6_{}", "dyn_energy_red")
    log(f"[paper] n=256 means over {len(names)} programs: " + ", ".join(
        f"{k} {v:.2f}" for k, v in means.items())
        + "; the paper: 44x over MicroBlaze, 80% dynamic-energy saving, a "
        "further 14% from customized variants (the model's numbers, not a "
        "criterion)")
    log(f"[paper] n=256: {len(rows)} rows, every output == its oracle, "
        f"wall {wall:.1f} s, launches {counts}; {smi}")
    return counts["fused_sm_run"], wall, means


def phase_reference(launches, smi):
    """The seed one-warp-per-issue interpreter on the card: the programs
    of ``REFERENCE_PROGRAMS`` at n=32 through ``run_grid`` with
    ``execute_backend="reference"``, against ``"cuda_fused"`` on the same
    inputs, gmem and every counter, bit for bit; it launches no kernel."""
    from repro_torch.core import scheduler
    from repro_torch.core.machine import MachineConfig
    from repro_torch.core.programs import ALL
    n, walls = 32, {}
    for name in REFERENCE_PROGRAMS:
        mod = ALL[name]
        code, (grid, bd) = mod.build(n), mod.launch(n)
        g0 = mod.make_gmem(np.random.default_rng(9), n)
        fused = scheduler.run_grid(code, grid, bd, g0.copy(), n_sm=2,
                                   device="cuda")
        launches.clear()
        t0 = time.perf_counter()
        ref = scheduler.run_grid(code, grid, bd, g0.copy(),
                                 MachineConfig(execute_backend="reference"),
                                 n_sm=2, device="cuda")
        walls[name] = time.perf_counter() - t0
        if launches:
            raise AssertionError(f"reference {name} launched "
                                 f"{dict(launches)}")
        assert_same(ref, fused, f"reference vs cuda_fused {name}")
        check_grid(mod, n, g0, ref, f"reference {name}")
    log(f"[reference] n={n} n_sm=2 on the card: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in walls.items())
        + f" ({sum(walls.values()):.1f} s); gmem and every counter == "
        f"cuda_fused, oracles ok, no kernel launched; {smi}")
    return walls


# ------------------------------------------------------------ phase 14
SERVE_POLICIES = ("monolithic", "bucket", "fair", "balanced", "sla")
#: the CLI's arguments for the policy drains: 64 launches of the five paper
#: programs at the CLI's sizes, from 4 tenants on 8 SMs
SERVE_DRAIN = ["--no-compiled", "--launches", "64", "--n-sm", "8",
               "--tenants", "4"]
#: drain accounting held equal between the card and the CPU plain path
DRAIN_FIELDS = ("n_launches", "n_blocks", "n_steps", "n_windows",
                "n_sub_batches", "useful_gmem_words", "padded_gmem_words",
                "occupancy", "makespan_cycles", "busy_cycles", "n_shed")


def counted_drains(launches, fn, n_sm, tag):
    """Run ``fn`` with the launch counts at 0 and the tracer on: every
    dispatch group it drained must have gone through ``fused_sm_run``, one
    launch a group of the executor's ``group_bounds`` over the group's
    blocks (the server's default chunk, ``max(2, n_sm)``), and nothing
    else may have launched.  Returns ``fn``'s result, the fused launches
    and each dispatch group's tickets."""
    from repro_torch import obs
    from repro_torch.runtime.executor import group_bounds
    launches.clear()
    obs.TRACER.clear().start()
    try:
        out = fn()
    finally:
        obs.TRACER.stop()
    counts = dict(launches)
    blocks = {sp.attrs["ticket"]: sp.attrs["n_blocks"]
              for sp in obs.TRACER.find("submit") if "ticket" in sp.attrs}
    groups = [sp.attrs["tickets"] for sp in obs.TRACER.find("dispatch")]
    obs.TRACER.clear()
    want = sum(len(group_bounds(sum(blocks[t] for t in g), n_sm,
                                max(2, n_sm))) for g in groups)
    if counts != {"fused_sm_run": want}:
        raise AssertionError(f"{tag}: launched {counts}, want "
                             f"{want} fused_sm_run for {len(groups)} "
                             "dispatch groups")
    return out, want, groups


def serve_cli(launches, argv, tag, smi, n_sm, pool=None):
    """One ``gpgpu_serve.main`` run on the card, counted by
    :func:`counted_drains`.  Returns the CLI's result (DrainStats or
    LoadReport) and the fused launches."""
    from repro_torch.launch import gpgpu_serve

    def run():
        with open(SERVE_LOG, "a") as f, contextlib.redirect_stdout(f):
            return gpgpu_serve.main(argv + ["--device", "cuda"], pool=pool)
    out, n, _ = counted_drains(launches, run, n_sm, tag)
    if hasattr(out, "n_sub_batches"):
        log(f"[serve-overlay] {tag}: {out.n_launches} launches, "
            f"{out.n_blocks} blocks, {out.n_sub_batches} sub-batches, "
            f"{out.launches_per_s:.1f} launches/s, wall "
            f"{out.wall_s * 1e3:.1f} ms, fused_sm_run {n}, padded "
            f"{out.padded_gmem_words}, makespan {out.makespan_cycles}; "
            f"{smi}")
    return out, n


def replay_per_sm(results, dispatches, n_sm):
    """The analytical per-SM cycles of a drain: each dispatch group's
    launches' blocks round-robin over the SMs, in the group's order."""
    from repro_torch.runtime.executor import BLOCK_SCHED_OVERHEAD
    total = np.zeros(n_sm, np.int64)
    for tickets in dispatches:
        cyc = np.concatenate([results[t].cycles_per_block for t in tickets])
        total += np.bincount(np.arange(len(cyc)) % n_sm,
                             weights=cyc + BLOCK_SCHED_OVERHEAD,
                             minlength=n_sm).astype(np.int64)
    return total


def spread(xs):
    """``min/median/max`` of ``xs`` seconds, in ms."""
    ms = sorted(x * 1e3 for x in xs)
    return f"{ms[0]:.1f}/{ms[len(ms) // 2]:.1f}/{ms[-1]:.1f}"


def phase_serve_overlay(launches, smi):
    """The serving runtime on the card through its CLI (docstring item
    14).  Returns the fused launches of the phase's counted drains."""
    from repro_torch import runtime as rt
    from repro_torch.core.programs import ALL
    from repro_torch.launch import gpgpu_serve
    SERVE_LOG.parent.mkdir(parents=True, exist_ok=True)
    SERVE_LOG.write_text("")
    t_phase, fused = time.perf_counter(), 0
    work64 = gpgpu_serve.build_workload(64, include_compiled=False)
    for policy in SERVE_POLICIES:
        st, n = serve_cli(launches, SERVE_DRAIN + ["--policy", policy],
                          f"{policy} 64x", smi, 8)
        fused += n
        # the same drain through the CLI's drain function, so each dispatch
        # group's tickets and results give the analytical replay
        (srv, stats, _), n, groups = counted_drains(
            launches, lambda: gpgpu_serve.drain_workload(
                work64, 8, 4, policy, device="cuda"), 8, f"{policy} replay")
        fused += n
        want = replay_per_sm(srv.last_results, groups, 8)
        if not np.array_equal(stats.per_sm_cycles, want):
            raise AssertionError(f"{policy}: executed per-SM cycles "
                                 f"{stats.per_sm_cycles} != replay {want}")
        log(f"[serve-overlay] {policy}: per-SM cycles "
            f"{stats.per_sm_cycles.tolist()} == analytical replay of "
            f"{len(groups)} dispatch groups")
    # bucket drains with and without resident memory, in turns: walls of
    # submit + drain (drain_workload's) and of the drain alone (wall_s)
    walls = {False: ([], []), True: ([], [])}
    for _ in range(5):
        for resident in (False, True):
            _, stats, wall = gpgpu_serve.drain_workload(
                work64, 8, 4, resident=resident, device="cuda")
            walls[resident][0].append(wall)
            walls[resident][1].append(stats.wall_s)
    log("[serve-overlay] bucket 64x, 5 runs in turns, min/median/max ms: "
        f"submit+drain {spread(walls[False][0])} host gmem against "
        f"{spread(walls[True][0])} resident; drain alone "
        f"{spread(walls[False][1])} against {spread(walls[True][1])}; {smi}")
    # where a bucket drain's wall goes: device time and the host clock of
    # one profiled run (the profiler's host cost lengthens that wall)
    box = {}
    dev_ms, n_kern, top = device_profile(lambda: box.update(
        r=gpgpu_serve.drain_workload(work64, 8, 4, device="cuda")))
    wall_ms = box["r"][2] * 1e3
    log(f"[serve-overlay] bucket 64x under torch.profiler: {dev_ms:.2f} ms "
        f"of device time in {n_kern} kernel launches, busy "
        f"{dev_ms / wall_ms:.3f} of the same run's submit+drain wall "
        f"{wall_ms:.1f} ms; top: {top}; {smi}")
    # one 16-launch drain on the card against the plain path on the host
    work = gpgpu_serve.build_workload(16, seed=5, include_compiled=False)
    t0 = time.perf_counter()
    cpu_srv, cpu_stats, _ = gpgpu_serve.drain_workload(work, 8, 4,
                                                       device="cpu")
    cpu_s = time.perf_counter() - t0
    (srv, stats, _), n, _ = counted_drains(
        launches, lambda: gpgpu_serve.drain_workload(work, 8, 4,
                                                     device="cuda"),
        8, "16-launch drain")
    fused += n
    for t, res in cpu_srv.last_results.items():
        assert_same(srv.last_results[t], res, f"16-launch drain ticket {t}")
    bad = [f for f in DRAIN_FIELDS
           if getattr(stats, f) != getattr(cpu_stats, f)]
    if bad or not np.array_equal(stats.per_sm_cycles,
                                 cpu_stats.per_sm_cycles):
        raise AssertionError(f"16-launch drain: card != CPU at {bad}")
    log(f"[serve-overlay] 16-launch bucket drain on 8 SMs: every ticket "
        f"and the drain's accounting == the plain path on the host CPU "
        f"({cpu_s:.1f} s there, {stats.wall_s * 1e3:.1f} ms on the card, "
        f"fused_sm_run {n})")
    # the pinned accounting of the skewed and longtail workloads (2 SMs)
    pinned = {("--skewed", "monolithic"): ("padded_gmem_words", 56896),
              ("--skewed", "bucket"): ("padded_gmem_words", 64),
              ("--longtail", "bucket"): ("makespan_cycles", 1456),
              ("--longtail", "balanced"): ("makespan_cycles", 784)}
    for (shape, policy), (field, value) in pinned.items():
        st, n = serve_cli(launches, ["--no-compiled", shape, "--launches",
                                     "8", "--policy", policy],
                          f"{shape[2:]} {policy}", smi, 2)
        fused += n
        if getattr(st, field) != value:
            raise AssertionError(f"{shape} {policy}: {field} "
                                 f"{getattr(st, field)} != {value}")
    # resident memory: no gmem crosses between host and card in the drain
    w = rt.TRANSFERS.window()
    st, n = serve_cli(launches, SERVE_DRAIN + ["--resident-gmem"],
                      "resident 64x", smi, 8)
    fused += n
    if w.gmem_uploads or w.gmem_syncs or st.pool["host_syncs"]:
        raise AssertionError(f"resident drain crossed: {w.snapshot()}, "
                             f"pool {st.pool}")
    log(f"[serve-overlay] resident: TRANSFERS {w.snapshot()} (gmem 0 up, "
        f"0 back), pool {st.pool}")
    # the five paper programs at the paper's largest size, four tenants
    n = 256
    work = [(name, ALL[name], n, ALL[name].build(n), ALL[name].launch(n),
             ALL[name].make_gmem(np.random.default_rng(40 + i), n))
            for i, name in enumerate(sorted(ALL))]
    (srv, stats, _), n_fused, _ = counted_drains(
        launches, lambda: gpgpu_serve.drain_workload(work, 8, 4,
                                                     device="cuda"),
        8, f"paper programs n={n}")
    fused += n_fused
    mm = [t for t, w_ in zip(sorted(srv.last_results), work)
          if w_[0] == "matmul"][0]
    if set(srv.last_results[mm].cycles_per_block.tolist()) != {83968}:
        raise AssertionError("served matmul n=256: cycles a block != 83968")
    log(f"[serve-overlay] paper programs n={n} from 4 tenants on 8 SMs: "
        f"oracles ok, matmul 83968 cycles a block, {stats.n_blocks} blocks, "
        f"{stats.launches_per_s:.1f} launches/s, wall "
        f"{stats.wall_s * 1e3:.1f} ms, fused_sm_run {n_fused}, makespan "
        f"{stats.makespan_cycles}; {smi}")
    # the always-on loop under seeded open-loop load, profiled; its pool's
    # oracle (one sequential run_grid an item) runs before the counting
    launches.clear()
    pool = gpgpu_serve.loadgen_pool(
        gpgpu_serve.build_workload(16, include_compiled=False),
        device="cuda")
    n_oracle = launches["fused_sm_run"]
    prof_out = SERVE_LOG.parent / "serve_profile.json"
    rep, n = serve_cli(launches, [
        "--no-compiled", "--launches", "16", "--n-sm", "8", "--tenants", "4",
        "--loadgen", "--duration-s", "3", "--profile-out", str(prof_out)],
        "loadgen", smi, 8, pool=pool)
    fused += n
    energy = json.loads(prof_out.read_text())["total"]["energy_eu"]
    if rep.unresolved or rep.mismatched or rep.failed or not (energy > 0) \
            or rep.completed == 0:
        raise AssertionError(f"loadgen: {rep.as_dict()}, energy {energy}")
    log(f"[serve-overlay] loadgen 3 s open loop: {rep.submitted} submitted, "
        f"{rep.completed} completed, {rep.unresolved} unresolved, "
        f"{rep.mismatched} mismatched, p50 {rep.p50_ms:.2f} ms, p99 "
        f"{rep.p99_ms:.2f} ms, {rep.throughput_per_s:.1f} launches/s, "
        f"{rep.loop_iterations} loop iterations, energy {energy:.0f} eu, "
        f"fused_sm_run {n} (and {n_oracle} before it for the pool's "
        f"oracle, not counted); {smi}")
    log(f"[serve-overlay] phase wall {time.perf_counter() - t_phase:.1f} s, "
        f"{fused} fused_sm_run launches; CLI output in {SERVE_LOG}")
    return fused


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

    # the plain versions' float32 products in full float32, as the kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build
    _build.load()
    regs = [l.strip() for l in _build.BUILD_INFO["ptxas"].splitlines()
            if "registers" in l or "spill" in l]
    log(f"[build] {_build.BUILD_INFO['seconds']:.1f} s -> "
        f"{_build.BUILD_INFO['path']}; ptxas: " + " | ".join(regs))

    rng = np.random.default_rng(0)
    alu_err = phase_simt_alu(rng)
    phase_fused_vs_plain()
    alu_launches, staged_wall = phase_staged_cuda(_build.LAUNCHES)
    fused_launches, _ = phase_main_path(_build.LAUNCHES)
    kernels = [time_simt_alu(rng, alu_launches, alu_err, staged_wall),
               time_fused(fused_launches)]
    flash_err = phase_flash_vs_plain()
    mm_launches, mm_err, mm_inputs = phase_matmul_vs_plain(_build.LAUNCHES)
    flash_launches = phase_serving(_build.LAUNCHES)
    kernels += [time_flash(flash_launches, flash_err),
                time_matmul(mm_launches, mm_err, mm_inputs)]
    paper32_launches, _ = phase_paper_n32(_build.LAUNCHES)
    paper256_launches, _, _ = phase_paper_n256(_build.LAUNCHES, smi)
    phase_reference(_build.LAUNCHES, smi)
    serve_launches = phase_serve_overlay(_build.LAUNCHES, smi)
    kernels[1]["launches_by_path"] = {"main path (phase 6)": fused_launches,
                                      "paper tables n=32": paper32_launches,
                                      "paper tables n=256": paper256_launches,
                                      "serving runtime (phase 14)":
                                          serve_launches}
    log(f"[done] {time.perf_counter() - t_start:.1f} s; {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
