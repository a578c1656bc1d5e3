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
   (S=200) and dh 256, large logits, and the model's strided GQA call at
   dh 128 and its MQA call at dh 256, each bf16 case through both
   variants (the rule's tensor-core one and the SIMT one, forced by
   ``variant="simt"``), and a misaligned q that the rule must send to the
   SIMT variant; the moe, audio and vlm families' calls
   (``FAMILY_FWD_SHAPES``: dbrx's GQA ratio 6 at dh 128, whisper's
   cross-attention 512 x 1500 and encoder 1500 x 1500 at dh 64, full, and
   paligemma's 8/1 heads of 256, each by both variants), two calls
   bit-equal; Zamba2-7B's dh 224 scaled by (224 / 2) ** -0.5 at the
   benchmark cell's (2, 4096, 32/32) and a ragged GQA shape, o and lse
   against ``mha_lse_ref`` by both variants; matmul at the sweep's
   shapes, a ragged 200x200x200 and a scalar-load shape, in both dtypes, and at
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
   ``fused_sm_run`` launches beside the card's name and power limit;
15. the kernel compiler's binaries on the card (``[compile]``):
   ``repro_torch.launch.gpgpu_compile.main(["--all", "--no-ir", "--run",
   "-n", N])`` for N in {64, 256}, each binary held to its oracle inside
   the CLI and its compile line (naive -> optimized instructions) equal
   to the JAX CLI's (``PINNED_COMPILE``), histogram's two passes held to
   ``final_oracle``; at n=64 the optimized and the naive binary of each
   kernel on the card equal to the CPU plain path, every counter, with
   equal outputs and both cycle totals printed; histogram n=16384 (two
   passes) and spmv n=4096 (128 blocks each) on 1, 2 and 8 SMs, held to
   the oracles and each pass's executed per-SM cycles to the replay;
   scan n=64 on ``customize.minimal_config`` (a one-entry warp stack, no
   multiplier) with ``max_sp`` and ``stack_ops`` 0; scan and spmv through
   the staged ``"cuda"`` backend, equal to the CPU, one ``simt_alu``
   launch a group step.  Every run launches exactly the executor's
   groups of ``fused_sm_run`` (or its steps of ``simt_alu``) and nothing
   else;
16. the mixed serving workload with its compiled tenants
   (``[serve-mixed]``): ``gpgpu_serve.main`` without ``--no-compiled``, 64
   launches of the eight kernels from 4 tenants on 8 SMs under each of the
   five policies, counted and replayed as in phase 14; one 16-launch mixed
   drain equal to the CPU plain path; the build attribution of a drain
   from cleared caches (misses in the 64- and the 96-instruction code
   buckets) and of the same drain again (no miss);
17. training (``[train]``): the flash backward kernels against their
   plain version (``mha_bwd_ref``) at thirteen shapes (qwen3's training
   shape, smollm's 15/5 heads of 64, float32 dh 16, a ragged S=200, full
   attention, dh 256 in bf16 and in float32, whisper's cross-attention
   512 x 1500 full, dbrx's GQA ratio 6, paligemma's training shape, 8/1
   heads of 256, and at dh 256 a ragged S=200 with one KV head, a full
   200 x 232 and 16/16 heads; and Zamba2-7B's dh 224 at its scale,
   (2, 4096, 32/32) and a ragged GQA shape), each by the rule's variant
   (``"tc"`` for
   bf16, ``"simt"`` for float32) and the ``"tc"`` ones by the forced
   ``"simt"`` too, two calls bit-equal; ``repro_torch.launch.train.main``
   trains qwen3-0.6b at full width (28 layers, 596,042,752 random bf16
   parameters from seed 0) for 6 steps of 8 x 512 tokens, every loss and
   gradient norm finite, the flash launches exactly what the remat policy
   predicts, every forward and backward the ``"tc"`` variant; one ``build_train_step`` step with every gradient leaf
   non-zero in every layer, and the same step with the plain attention in
   the kernel's place; a reduced step on the card against the CPU plain
   path; ``--die-at 9`` then ``--restore auto`` at ``--reduced``, the
   final parameters bit-exact against an uninterrupted run; one
   full-width step under ``torch.profiler`` (device ms, launches, busy
   share, tokens/s, top operations), and the backward kernels' time at
   the training shape, ``"tc"`` and ``"simt"`` in turns, beside the plain
   version and the backward of ``scaled_dot_product_attention``, and both
   variants' time at dh 256;
18. the other families serving (``[serve-families]``): ``serve.main`` at
   full width, batch 4, a 512-token prompt and 32 new tokens, random bf16
   weights from seed 0, for llama3.2-3b, yi-6b, mamba2-130m and
   zamba2-1.2b, with 28 / 32 / 0 / 7 flash launches a prefill (one a
   layer; none; one an application of zamba2's shared attention block),
   every one ``"tc"``; each one's prefill step with the kernel against
   the same step with the plain attention, per layer (``LAYER_TOL``), and
   end to end (logits and every decode state) no farther from the fp32
   prefill than the plain attention's plus ``LM_REL_TOL``, and but for the
   hybrid within ``LM_REL_TOL`` of the plain attention directly; prefill
   and decode times and a profile of each; and mamba2's one-step prefill
   of 200 tokens against its 200 decode steps (every position's logits
   within 3e-2 in fp32; bf16 read);
19. the other families training (``[train-families]``):
   ``launch.train.main`` of mamba2-130m and zamba2-1.2b at full width, 4
   steps of 8 x 512, with zamba2's 7 flash forwards and 7 backwards a
   step (its shared block outside the remat), all ``"tc"``; a
   ``build_train_step`` step with every gradient leaf non-zero; one step
   with every flash forward and backward call held to its plain version
   on the same inputs, and its loss and whole gradient no farther from the
   fp32 step than the plain attention's plus ``TRAIN_LOSS_TOL`` and
   ``TRAIN_GRAD_TOL``; a profiled step with its peak memory; and a
   bit-exact resume at ``--reduced``;
19b. Zamba2-7B-Instruct's published hybrid training (``[train-zamba2-7b]``):
   the first of its four pipeline stages at the published widths (24
   layers, 2.73 G parameters), one ``build_train_step`` step of 1 x 4096
   after a warm-up step: exactly 4 flash forwards and 4 backwards, one of
   each a shared-block call, all ``"tc"`` at dh 224, the counters zeroed
   just before; loss and gradient norm finite;
20. the moe family serving (``[serve-moe]``): dbrx-132b at 8 of 40 layers
   and kimi-k2 at 1 of 61, every width as published (the cut spec built
   by ``dataclasses.replace``, each cut logged), random bf16 weights from
   seed 0, through ``build_serve_step`` as ``serve.main`` runs it (batch
   4, a 512-token prompt, 32 new tokens): 8 and 1 flash launches a
   prefill, all ``"tc"``; the prefill with every flash call within
   ``LAYER_TOL`` of its plain version; against the plain attention end to
   end, routing flips counted, within ``LM_REL_TOL`` where none flipped;
   no farther from the fp32 prefill (2 layers for dbrx, 1 for kimi-k2)
   than the plain attention's plus ``LM_REL_TOL``; the three dispatches
   on layer 0's input at the config's capacity, drops included, within
   ``DISPATCH_TOL`` of each other and each bit-equal over two calls;
   ``aux_load_balance_loss`` against the CPU; prefill and decode
   profiles and peak memory;
21. the moe family training (``[train-moe]``): dbrx-132b at 1 layer, 3
   steps of 8 x 512 through ``build_train_step`` with
   ``OptConfig(mode="adamw_lite")``, 2 flash forwards and 1 backward a
   step (GQA 6), all ``"tc"``; every gradient leaf non-zero (the router's
   too); the step against the plain attention (``TRAIN_LOSS_TOL``,
   ``TRAIN_GRAD_TOL``), every flash call against its plain version; a
   profiled step; a bit-exact ``--reduced`` resume through the train CLI;
22. the audio family serving (``[serve-audio]``): whisper-medium uncut
   through ``serve.main`` (batch 4, a 512-token prompt, 32 new tokens,
   the zeroed cross K/V): 48 flash launches a prefill, all ``"tc"``; then
   ``encode`` of frames (4, 1500, 1024) from seed 0, ``cross_kv`` and the
   prefill against them (24 + 48 launches), each flash call within
   ``LAYER_TOL`` of its plain version, the end to end within
   ``LM_REL_TOL`` of the plain attention and no farther from fp32 than it
   plus ``LM_REL_TOL``; profiles and peak memory;
23. the audio family training (``[train-audio]``): whisper-medium uncut,
   3 AdamW steps of 8 x 512 tokens with frames (8, 1500, 1024) through
   ``build_train_step``: 144 flash forwards and 72 backwards a step, all
   ``"tc"``; the checks of phase 21; the resume through
   ``CheckpointManager`` at reduced size (the train CLI refuses the audio
   family, as the JAX CLI does);
24. the vlm family serving (``[serve-vlm]``): paligemma-3b uncut (18
   layers, d_model 2048, 8/1 heads of 256, vocabulary 257216) through
   ``serve.main`` (batch 4, a 512-token text prompt, 32 new tokens, no
   patches, as the JAX CLI serves it): 18 flash launches a prefill, all
   ``"tc"`` (dh 256); then image patches (4, 256, 1152) from numpy seed
   0 and 256 text tokens through ``vlm.forward`` with caches (18
   ``"tc"`` launches, each within ``LAYER_TOL`` of its plain version),
   32 decode steps, 200 text tokens behind the patches (456 positions:
   the plain attention by ``tile_ok``, 0 launches), the 512-position
   prefill against the plain attention end to end within ``LM_REL_TOL``;
   profiles and peak memory;
25. the vlm family training (``[train-vlm]``): paligemma-3b uncut, 3 AdamW
   steps of 8 x (256 patches + 256 text) through ``build_train_step``: 36
   flash forwards and 18 backwards a step, all ``"tc"``; the checks of
   phase 23 (``vision_proj``'s gradient non-zero too); then the flash
   forward and backward timed at the families' shapes (at paligemma's,
   the rule's ``"tc"`` kernels and the forced SIMT ones) beside their
   plain versions, the library calls and their bounds, and the backward
   of ``scaled_dot_product_attention`` at dh 256;
26. the sharded executor over logical shards of the one card
   (``[shard-sm]``): the five paper programs at n=256 on 8 SMs through
   ``execute(shard_sm=True, sm_devices=["cuda:0"] * k)`` for k in {2, 4,
   8}, and one execute of all five, each bit-equal to the unsharded run
   on the card (gmem, the written mask of each launch, the six counters,
   ``per_sm_cycles``, ``n_steps``, ``n_blocks``), held to the oracles and
   the analytical replay (matmul 83968 cycles a block), with exactly one
   ``fused_sm_run`` launch a shard with a real position in each group and
   one ``shard.dispatch_groups`` a group; the conflict kernel (7 blocks
   on 4 SMs, last writer 106); longtail drains under ``bucket`` and
   ``balanced`` over 4 shards equal to the unsharded drains, with the
   per-device cycles and the ``drain.shard.*`` gauges; a resident drain
   with no gmem crossing; the serving CLI with ``--shard-sm`` on the one
   card (one device, equal to the run without the flag); and the walls of
   matmul n=256 unsharded and at each k, in turns.  Copies between
   distinct cards are not exercised: one card;
27. the LM steps on a torch ``DeviceMesh`` (``[mesh-lm]``): a world-size-1
   NCCL process group (a ``FileStore`` in a temporary directory) and a
   (1, 1) ``("data", "model")`` mesh over ``cuda:0``; qwen3-0.6b at full
   width through ``build_serve_step(mesh=...)``: a prefill of 4 x 512 and
   8 decode steps under ``profile="tp"``, the prefill again under
   ``"seq"``, every next token and KV cache bit-equal to the same steps
   without a mesh, 28 flash launches a prefill; three
   ``build_train_step(mesh=..., donate=True, shard_grads=True)`` steps of
   8 x 512, losses, gradient norms and parameters bit-equal to the
   unsharded steps', 28 + 28 flash forwards and 28 backwards a step; the
   walls of the sharded and unsharded serve steps in turns and of the
   train steps; paligemma-3b's peak memory over one train step with
   ``donate`` off and on; ``launch.hloanalysis.analyze`` of the unsharded
   qwen3 train step (8 x 512) and prefill (4 x 512), its compute and
   memory times at the H100 SXM datasheet rates beside the measured wall;
   and ``python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape
   train_4k --mesh single`` in a subprocess (the production mesh over 256
   fake ranks on the host CPU), its record ``ok`` and printed.

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
import io
import json
import os
import re
import subprocess
import sys
import time
import warnings
from dataclasses import replace
from functools import partial
from pathlib import Path

# cuBLAS is deterministic only with a fixed workspace, named before it
# starts: phase 17 resumes a training run bit for bit
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

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


def mangled_ids(name: str):
    """The length-prefixed identifiers of a mangled name up to the first
    that ends in ``_kernel``."""
    ids, i = [], 0
    while i < len(name):
        m = re.match(r"\d+", name[i:])
        if not m:
            i += 1
            continue
        start = i + len(m.group())
        ids.append(name[start:start + int(m.group())])
        if ids[-1].endswith("_kernel"):
            break
        i = start + int(m.group())
    return ids


def ptxas_kernels(report: str):
    """(kernel, registers, spill store bytes, spill load bytes) of each
    entry function in an ``nvcc -Xptxas -v`` report, the kernel named
    from its mangled name as ``[tc::]name<template ints>[ bf16|f32]``."""
    out, name, spill = [], None, (0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            ids = mangled_ids(name)
            kern = ids[-1] if ids[-1:] and ids[-1].endswith("_kernel") \
                else name
            label = ("tc::" if "tc" in ids else "") + kern
            ints = re.findall(r"Li(\d+)E", name)
            if ints:
                label += "<" + ",".join(ints) + ">"
            if "I13__nv_bfloat16" in name:
                label += " bf16"
            elif re.search(r"IfL", name):
                label += " f32"
            out.append((label, int(m.group(1))) + spill)
            name = None
    return out


# ------------------------------------------------------------ phase 3
def check_wide(built):
    """The wide tensor-core kernels at dh 256 and 224 (the forward, dK/dV,
    dQ and delta), four a width, none spilling."""
    for dh in (256, 224):
        wide = [x for x in built
                if x[0].startswith("tc::") and f"<{dh}>" in x[0]]
        if len(wide) != 4 or any(x[2] or x[3] for x in wide):
            raise AssertionError(f"ptxas: the dh-{dh} tensor-core kernels "
                                 f"{wide}, want four without spill")


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


#: the forward at the moe, audio and vlm families' shapes, (tag, B, S, H,
#: KH, dh, causal), S one length or (Sq, Sk): dbrx's prefill (GQA ratio
#: 6), whisper's cross-attention (512 queries on 1500 frames) and encoder
#: (1500 x 1500), full and with ragged last tiles, and paligemma's prefill
#: (one KV head of 256); the rule gives each the tensor-core variant
FAMILY_FWD_SHAPES = [("dbrx GQA 6", 4, 512, 48, 8, 128, True),
                     ("whisper cross", 8, (512, 1500), 16, 16, 64, False),
                     ("whisper encoder", 4, 1500, 16, 16, 64, False),
                     ("paligemma MQA dh 256", 4, 512, 8, 1, 256, True)]
#: Zamba2-7B-Instruct's shared attention: heads of 224, scores scaled by
#: (224 / 2) ** -0.5; (tag, B, S, H, KH), causal: the benchmark cell's
#: call and a ragged GQA shape
DH224_SCALE = (224 / 2) ** -0.5
DH224_SHAPES = [("zamba2-7b shared attention", 2, 4096, 32, 32),
                ("dh 224 ragged GQA", 2, 200, 4, 2)]


def phase_flash_vs_plain():
    """The sweep through both variants: every bf16 case at dh 64, 128 and
    256 by the rule's tensor-core variant and by the SIMT one; float32 and
    the misaligned case by the SIMT one, which the rule must choose; the
    GQA cache prefix at dh 128 and 256, the families' shapes
    (``FAMILY_FWD_SHAPES``) and Zamba2-7B's dh 224 at its scale
    (``DH224_SHAPES``) by both."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import (TC_HEAD_DIMS,
                                                     flash_attention,
                                                     flash_attention_gqa)
    from repro_torch.kernels.ref import (flash_attention_ref, mha_lse_ref,
                                         mha_ref)
    g = torch.Generator(device="cuda").manual_seed(5)
    cases = [(256, 256, 64, True), (256, 256, 128, True),
             (128, 512, 64, False), (512, 512, 64, True),
             (200, 200, 128, True), (200, 200, 64, False),
             (200, 200, 256, True), (200, 200, 256, False)]
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
    # the same at dh 256 with one KV head and a ragged S of 200 (paligemma)
    q = rand(g, (4, 200, 8, 256), torch.bfloat16)
    ck, cv = (rand(g, (4, 232, 1, 256), torch.bfloat16) for _ in range(2))
    args = (q, ck[:, :200], cv[:, :200])
    for want, forced in (("tc", None), ("simt", "simt")):
        max_err = max(max_err, flash_case(
            flash_attention_gqa, mha_ref, args, True, 3e-2,
            f"flash MQA dh 256 cache prefix S=200 {want}", want, forced))
    # a q one element past a 16-byte boundary: the rule must take SIMT
    buf = rand(g, (4 * 256 * 8 * 64 + 1,), torch.bfloat16)
    qm = buf[1:].view(4, 256, 8, 64)
    km, vm = (rand(g, (4, 256, 4, 64), torch.bfloat16) for _ in range(2))
    max_err = max(max_err, flash_case(
        flash_attention_gqa, mha_ref, (qm, km, vm), True, 3e-2,
        "flash misaligned q", "simt"))
    # the moe, audio and vlm families' calls, two calls bit-equal, each by
    # the rule's tensor-core variant and by the forced SIMT one
    fam = []
    for tag, B, S, H, KH, dh, causal in FAMILY_FWD_SHAPES:
        Sq, Sk = lengths(S)
        q = rand(g, (B, Sq, H, dh), torch.bfloat16)
        k, v = (rand(g, (B, Sk, KH, dh), torch.bfloat16) for _ in range(2))
        want_out = mha_ref(q, k, v, causal=causal)
        if dh not in TC_HEAD_DIMS:
            raise AssertionError(f"flash {tag}: dh {dh} has no tc kernel")
        for want, forced in (("tc", None), ("simt", "simt")):
            _build.VARIANTS.clear()
            got = flash_attention_gqa(q, k, v, causal=causal, variant=forced)
            again = flash_attention_gqa(q, k, v, causal=causal,
                                        variant=forced)
            if variant_counts() != {("flash_attention", want): 2} or \
                    not torch.equal(got, again):
                raise AssertionError(f"flash {tag} {want}: launched "
                                     f"{variant_counts()}, two calls equal "
                                     f"{torch.equal(got, again)}")
            err = close(got, want_out, 3e-2, f"flash {tag} {want}")
            max_err = max(max_err, err)
            fam.append(f"{tag} {want} {err:.3e}")
        del q, k, v, want_out, got, again
    # Zamba2-7B's shared attention at dh 224 with its own scale: o and
    # lse by the rule's tensor-core variant and the forced SIMT one
    z = []
    for tag, B, S, H, KH in DH224_SHAPES:
        q = rand(g, (B, S, H, 224), torch.bfloat16)
        k, v = (rand(g, (B, S, KH, 224), torch.bfloat16) for _ in range(2))
        want_o, want_lse = mha_lse_ref(q, k, v, causal=True,
                                       scale=DH224_SCALE)
        if fa.variant(q, k, v) != "tc":
            raise AssertionError(f"flash {tag}: the rule picked "
                                 f"{fa.variant(q, k, v)}, want tc")
        for want, forced in (("tc", None), ("simt", "simt")):
            _build.VARIANTS.clear()
            o, lse = fa._launch(q, k, v, True, forced, want_lse=True,
                                scale=DH224_SCALE)
            if variant_counts() != {("flash_attention", want): 1}:
                raise AssertionError(f"flash {tag} {want}: launched "
                                     f"{variant_counts()}")
            err = close(o, want_o, 3e-2, f"flash {tag} {want}")
            lse_err = (lse - want_lse).abs().max().item()
            if lse_err > 1e-4 * max(1.0, want_lse.abs().max().item()):
                raise AssertionError(f"flash lse {tag} {want}: error "
                                     f"{lse_err}")
            max_err = max(max_err, err)
            z.append(f"{tag} (B {B}, S {S}, {H}/{KH} heads) {want} "
                     f"{err:.3e}, lse {lse_err:.1e}")
        del q, k, v, want_o, want_lse, o, lse
    log(f"[flash_attention] dh 224, scale (224 / 2) ** -0.5, against "
        f"mha_lse_ref (o within 3e-2, lse within 1e-4), the rule's tc and "
        f"the forced simt: " + ", ".join(z))
    log(f"[flash_attention] vs flash_attention_ref: {n + 6} cases (the "
        f"test_kernels sweep, S=200, dh 64-256, each bf16 case by both "
        f"variants; large logits; GQA cache prefix at dh 128 and MQA at dh "
        f"256 by both; misaligned q by SIMT) "
        f"within tolerance (f32 2e-3, bf16 3e-2, large 1e-2); every launch "
        f"took the variant the rule or the caller named; max_abs_err "
        f"{max_err:.3e} (sweep tc {errs['tc']:.3e}, simt f32 "
        f"{errs['simt f32']:.3e}, simt bf16 {errs['simt bf16']:.3e}); the "
        f"families' shapes against mha_ref within 3e-2, two calls "
        f"bit-equal, by the rule's tc and the forced simt: "
        + ", ".join(fam))
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
        with torch.no_grad():
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


def device_profile(fn, top=3):
    """Device time (ms), kernel launches and the ``top`` costliest kernels
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
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
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


def time_sdpa(qh, kh, vh, causal=True):
    """``scaled_dot_product_attention`` on (B, H, S, dh) inputs: its
    device and event times unrestricted, its device time under
    ``sdpa_kernel`` restricted to each backend that takes the shape (one
    that refuses it raises RuntimeError on the call, which is what the
    probe reads), and the backend whose output equals the unrestricted
    call's bit for bit, the closest in device time first."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    lib = partial(F.scaled_dot_product_attention, qh, kh, vh,
                  is_causal=causal, enable_gqa=True)
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


def serve_cli(launches, argv, tag, smi, n_sm, pool=None,
              prefix="[serve-overlay]"):
    """One ``gpgpu_serve.main`` run on the card, counted by
    :func:`counted_drains`.  Returns the CLI's result (DrainStats or
    LoadReport) and the fused launches."""
    from repro_torch.launch import gpgpu_serve

    def run():
        with open(SERVE_LOG, "a") as f, contextlib.redirect_stdout(f):
            return gpgpu_serve.main(argv + ["--device", "cuda"], pool=pool)
    out, n, _ = counted_drains(launches, run, n_sm, tag)
    if hasattr(out, "n_sub_batches"):
        log(f"{prefix} {tag}: {out.n_launches} launches, "
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


# ------------------------------------------------------------ phase 15
#: the JAX CLI's compile lines (``python -m repro.launch.gpgpu_compile --all
#: --no-ir -n N``): kernel -> (naive, optimized, saved, saving %)
PINNED_COMPILE = {
    64: {"histogram": (43, 26, 17, 40), "scan": (29, 27, 2, 7),
         "spmv": (21, 20, 1, 5)},
    256: {"histogram": (43, 31, 12, 28), "scan": (29, 27, 2, 7),
          "spmv": (21, 20, 1, 5)}}
COMPILE_LINE = re.compile(r"\[compile\] (\w+): (\d+) naive -> (\d+) optimized "
                          r"instructions \((\d+) saved, (\d+)%\), (\d+) ms$")
#: the multi-block grids of phase 15: histogram 128 blocks of 64 threads
#: (chunk 128) through its two passes, spmv 128 blocks of 32 rows
MULTI_BLOCK = (("histogram", 16384), ("spmv", 4096))


def grid_groups(n_blocks, n_sm, gmem_words):
    """``fused_sm_run`` launches of one ``execute`` of a launch of
    ``gmem_words`` words on the card, ``chunk`` left unset
    (``executor.resolve_chunk``): one a dispatch group."""
    import torch
    from repro_torch.core.machine import MachineConfig
    from repro_torch.runtime import registry as reg
    from repro_torch.runtime.executor import group_bounds, resolve_chunk
    chunk = resolve_chunk(None, MachineConfig(), torch.device("cuda"), False,
                          n_blocks, n_sm, reg.bucket_gmem_len(gmem_words))
    return len(group_bounds(n_blocks, n_sm, chunk))


def n_blocks(mod, n):
    (gx, gy), _ = mod.launch(n)
    return gx * gy


def counted(launches, fn, want, tag):
    """``fn()`` with the launch counts at 0: it must have launched exactly
    ``want`` (a dict), and nothing else."""
    launches.clear()
    out = fn()
    if dict(launches) != want:
        raise AssertionError(f"{tag}: launched {dict(launches)}, want {want}")
    return out


def phase_compile(launches, smi):
    """The kernel compiler's binaries on the card (docstring item 15).
    Returns (fused_sm_run launches, simt_alu launches) of the phase."""
    from repro_torch.compiler.kernels import COMPILED, histogram
    from repro_torch.core import customize, scheduler
    from repro_torch.core.machine import MachineConfig
    from repro_torch.launch import gpgpu_compile
    t_phase, fused, alu = time.perf_counter(), 0, 0
    # the CLI, each binary held to its oracle inside it
    for n in (64, 256):
        buf = io.StringIO()
        want = sum(grid_groups(n_blocks(COMPILED[k], n), 1, len(
            COMPILED[k].make_gmem(np.random.default_rng(0), n)))
            for k in COMPILED)

        def cli():
            with contextlib.redirect_stdout(buf):
                return gpgpu_compile.main(["--all", "--no-ir", "--run", "-n",
                                           str(n), "--device", "cuda"])
        t0 = time.perf_counter()
        rc = counted(launches, cli, {"fused_sm_run": want}, f"compile n={n}")
        wall = time.perf_counter() - t0
        fused += want
        out = buf.getvalue().splitlines()
        got = {m[1]: tuple(int(x) for x in m.groups()[1:5])
               for m in map(COMPILE_LINE.match, out) if m}
        ms = {m[1]: int(m[6]) for m in map(COMPILE_LINE.match, out) if m}
        ran = [l for l in out if " ran " in l and l.endswith("oracle OK")]
        if rc != 0 or got != PINNED_COMPILE[n] or len(ran) != len(COMPILED):
            raise AssertionError(f"gpgpu_compile n={n}: rc {rc}, compile "
                                 f"lines {got} != {PINNED_COMPILE[n]}, ran "
                                 f"{ran}")
        log(f"[compile] n={n}: compile lines == the JAX CLI's {got}; compile "
            f"ms on the host CPU {ms}; " + "; ".join(
                l.split(": ", 1)[1] for l in ran)
            + f"; CLI wall {wall:.2f} s, fused_sm_run {want}; {smi}")
        # histogram's two passes, reduced bins held to the final oracle
        g0 = histogram.make_gmem(np.random.default_rng(0), n)
        gm, _ = counted(launches, lambda: histogram.run_passes(
            partial(scheduler.run_grid, device="cuda"), histogram.build(n), n,
            g0.copy()), {"fused_sm_run": grid_groups(n_blocks(histogram, n),
                                                     1, len(g0)) + 1},
            f"histogram two passes n={n}")
        fused += launches["fused_sm_run"]
        if not np.array_equal(gm[histogram.final_slice(n)],
                              histogram.final_oracle(g0, n)):
            raise AssertionError(f"histogram n={n}: reduced bins differ")
    # n=64: optimized and naive binaries on the card == the CPU plain path
    n, cycles = 64, {}
    cpu = MachineConfig(execute_backend="torch")
    for name in sorted(COMPILED):
        mod = COMPILED[name]
        g0 = mod.make_gmem(np.random.default_rng(7), n)
        outs = {}
        for variant in ("optimized", "naive"):
            code = mod.build(n, optimize=variant == "optimized")
            plain = scheduler.run_grid(code, *mod.launch(n), g0.copy(), cpu,
                                       device="cpu")
            card = counted(launches, lambda: scheduler.run_grid(
                code, *mod.launch(n), g0.copy(), device="cuda"),
                {"fused_sm_run": grid_groups(n_blocks(mod, n), 1, len(g0))},
                f"{name} {variant}")
            fused += launches["fused_sm_run"]
            assert_same(card, plain, f"{name} n={n} {variant} card vs CPU")
            check_grid(mod, n, g0, card, f"{name} n={n} {variant}")
            outs[variant] = card.gmem[mod.out_slice(n)]
            cycles[name, variant] = int(card.cycles_per_block.sum())
        if not np.array_equal(outs["optimized"], outs["naive"]):
            raise AssertionError(f"{name}: naive and optimized outputs differ")
    log(f"[compile] n={n}: optimized and naive binaries on the card == the "
        "plain path on the host CPU, every counter; cycles optimized/naive: "
        + ", ".join(f"{k} {cycles[k, 'optimized']}/{cycles[k, 'naive']}"
                    for k in sorted(COMPILED)))
    # multi-block grids on 1, 2 and 8 SMs, held to the oracle and the replay
    for name, n in MULTI_BLOCK:
        mod = COMPILED[name]
        g0 = mod.make_gmem(np.random.default_rng(11), n)
        for n_sm in (1, 2, 8):
            passes = []

            def run(code, grid, bd, gmem, _passes=passes, _n_sm=n_sm):
                dg = scheduler.execute(
                    [scheduler.LaunchSpec(code, grid, bd, gmem)], n_sm=_n_sm,
                    device="cuda")
                res, per_sm = dg.to_results()[0], dg.report().per_sm_cycles
                if not (np.array_equal(per_sm, res.per_sm_cycles(_n_sm))
                        and per_sm.max() == res.sm_cycles(_n_sm)):
                    raise AssertionError(f"{name} n={n} n_sm={_n_sm}: "
                                         "executed per-SM cycles != replay")
                _passes.append((res, grid_groups(grid[0] * grid[1], _n_sm,
                                                 len(gmem))))
                return res
            launches.clear()
            t0 = time.perf_counter()
            if name == "histogram":
                gm, _ = histogram.run_passes(run, mod.build(n), n, g0.copy())
                ok = np.array_equal(gm[histogram.final_slice(n)],
                                    histogram.final_oracle(g0, n))
            else:
                gm = run(mod.build(n), *mod.launch(n), g0.copy()).gmem
                ok = True
            wall = time.perf_counter() - t0
            want = sum(g for _, g in passes)
            if dict(launches) != {"fused_sm_run": want}:
                raise AssertionError(f"{name} n={n} n_sm={n_sm}: launched "
                                     f"{dict(launches)}, want {want}")
            fused += want
            if not ok or not np.array_equal(
                    passes[0][0].gmem[mod.out_slice(n)], mod.oracle(g0, n)):
                raise AssertionError(f"{name} n={n} n_sm={n_sm}: oracle")
            log(f"[compile] {name} n={n} ({n_blocks(mod, n)} blocks) n_sm="
                f"{n_sm}: oracle ok, per-SM cycles "
                f"{passes[0][0].per_sm_cycles(n_sm).tolist()} == replay "
                f"(kernel time {passes[0][0].sm_cycles(n_sm)}), wall "
                f"{wall * 1e3:.1f} ms, fused_sm_run {want}; {smi}")
    # scan on the smallest machine the customization analyzer allows
    mod, n = COMPILED["scan"], 64
    code = mod.build(n)
    small = customize.minimal_config(code)
    g0 = mod.make_gmem(np.random.default_rng(0), n)
    card = counted(launches, lambda: scheduler.run_grid(
        code, *mod.launch(n), g0.copy(), small, device="cuda"),
        {"fused_sm_run": 1}, "scan minimal config")
    fused += 1
    plain = scheduler.run_grid(code, *mod.launch(n), g0.copy(),
                               replace(small, execute_backend="torch"),
                               device="cpu")
    assert_same(card, plain, "scan minimal config card vs CPU")
    check_grid(mod, n, g0, card, "scan minimal config")
    if card.max_sp or card.stack_ops or small.warp_stack_depth != 1:
        raise AssertionError(f"if-converted scan used the warp stack: "
                             f"max_sp {card.max_sp}, {card.stack_ops} ops")
    log(f"[compile] scan n={n} on warp_stack_depth={small.warp_stack_depth}, "
        f"enable_mul={small.enable_mul}: max_sp 0, stack_ops 0, oracle ok, "
        "== CPU")
    # the staged "cuda" backend: simt_alu in the pipeline
    cfg = MachineConfig(execute_backend="cuda")
    for name in ("scan", "spmv"):
        mod = COMPILED[name]
        code, g0 = mod.build(n), mod.make_gmem(np.random.default_rng(5), n)
        spec = [scheduler.LaunchSpec(code, *mod.launch(n), g0.copy())]
        plain_dg = scheduler.execute(spec, cfg=cfg, device="cpu")
        want = staged_launches_expected(plain_dg, 1)
        card = counted(launches, lambda: scheduler.run_grid(
            code, *mod.launch(n), g0.copy(), cfg, device="cuda"),
            {"simt_alu": want}, f"staged cuda {name}")
        alu += want
        assert_same(card, plain_dg.to_results()[0], f"staged cuda {name}")
        log(f"[compile] staged cuda {name} n={n}: == CPU, simt_alu {want} == "
            "the group steps")
    log(f"[compile] phase wall {time.perf_counter() - t_phase:.1f} s, "
        f"fused_sm_run {fused}, simt_alu {alu}; {smi}")
    return fused, alu


# ------------------------------------------------------------ phase 16
#: the mixed workload's policy drains: 64 launches of the eight kernels at
#: the CLI's sizes, from 4 tenants on 8 SMs
MIXED_DRAIN = ["--launches", "64", "--n-sm", "8", "--tenants", "4"]


def phase_serve_mixed(launches, smi):
    """The mixed serving workload with its compiled tenants (docstring
    item 16).  Returns the fused launches of the phase's counted drains."""
    from repro_torch import obs
    from repro_torch import runtime as rt
    from repro_torch.launch import gpgpu_serve
    t_phase, fused = time.perf_counter(), 0
    work64 = gpgpu_serve.build_workload(64)
    for policy in SERVE_POLICIES:
        st, n = serve_cli(launches, MIXED_DRAIN + ["--policy", policy],
                          f"{policy} 64x", smi, 8, prefix="[serve-mixed]")
        fused += n
        (srv, stats, _), n, groups = counted_drains(
            launches, lambda: gpgpu_serve.drain_workload(
                work64, 8, 4, policy, device="cuda"), 8,
            f"mixed {policy} replay")
        fused += n
        want = replay_per_sm(srv.last_results, groups, 8)
        if not np.array_equal(stats.per_sm_cycles, want):
            raise AssertionError(f"mixed {policy}: executed per-SM cycles "
                                 f"{stats.per_sm_cycles} != replay {want}")
        log(f"[serve-mixed] {policy}: {stats.n_launches} launches, "
            f"{stats.launches_per_s:.1f} launches/s, drain wall "
            f"{stats.wall_s * 1e3:.1f} ms, fused_sm_run {n} over "
            f"{len(groups)} dispatch groups, per-SM cycles == replay; {smi}")
    # one 16-launch mixed drain on the card against the host CPU
    work = gpgpu_serve.build_workload(16, seed=5)
    t0 = time.perf_counter()
    cpu_srv, cpu_stats, _ = gpgpu_serve.drain_workload(work, 8, 4,
                                                       device="cpu")
    cpu_s = time.perf_counter() - t0
    (srv, stats, _), n, _ = counted_drains(
        launches, lambda: gpgpu_serve.drain_workload(work, 8, 4,
                                                     device="cuda"),
        8, "mixed 16-launch drain")
    fused += n
    for t, res in cpu_srv.last_results.items():
        assert_same(srv.last_results[t], res, f"mixed 16-launch ticket {t}")
    bad = [f for f in DRAIN_FIELDS
           if getattr(stats, f) != getattr(cpu_stats, f)]
    if bad or not np.array_equal(stats.per_sm_cycles,
                                 cpu_stats.per_sm_cycles):
        raise AssertionError(f"mixed 16-launch drain: card != CPU at {bad}")
    log(f"[serve-mixed] 16-launch drain on 8 SMs: every ticket and the "
        f"drain's accounting == the plain path on the host CPU ({cpu_s:.1f} "
        f"s there, {stats.wall_s * 1e3:.1f} ms on the card, fused_sm_run "
        f"{n})")
    # build attribution: a drain from cleared caches misses in both code
    # buckets; the same drain again, caches kept, misses nowhere
    (srv, stats, wall), n, _ = counted_drains(
        launches, lambda: gpgpu_serve.drain_workload(work64, 8, 4,
                                                     device="cuda"),
        8, "mixed attribution drain")
    fused += n
    jit = gpgpu_serve.metrics_document(srv)["jit"]
    buckets = sorted(b for b in jit if b != "_total")
    if not {"c64", "c96"} <= {b.split("g")[0] for b in buckets}:
        raise AssertionError(f"first mixed drain's jit misses {jit}")

    def again():
        before = obs.jit_summary()
        srv2 = rt.RuntimeServer(n_sm=8, metrics=obs.MetricsRegistry(),
                                device="cuda")
        for i, (_, _, _, code, (grid, bd), g0) in enumerate(work64):
            srv2.submit(code, grid, bd, g0.copy(), client=f"tenant{i % 4}")
        srv2.drain()
        return obs.jit_delta(before, obs.jit_summary())
    second, n, _ = counted_drains(launches, again, 8, "mixed second drain")
    fused += n
    if set(second) != {"_total"} or second["_total"]["jit_cache_misses"]:
        raise AssertionError(f"second mixed drain missed: {second}")
    log(f"[serve-mixed] build attribution, first drain: " + ", ".join(
        f"{b} {jit[b]['jit_cache_misses']} misses "
        f"{jit[b]['jit_trace_ms']:.1f} ms" for b in buckets)
        + f" ({jit['_total']['jit_cache_hits']} hits); second drain, caches "
        f"kept: 0 misses, {second['_total']['jit_cache_hits']} hits; {smi}")
    log(f"[serve-mixed] phase wall {time.perf_counter() - t_phase:.1f} s, "
        f"{fused} fused_sm_run launches; CLI output in {SERVE_LOG}")
    return fused


# ------------------------------------------------------------ phase 17
FLASH_BWD_REPLACES = "src/repro/models/layers.py:62"
#: full-width training: qwen3-0.6b uncut, 6 steps of 8 x 512 tokens
TRAIN_ARGS = ["--arch", "qwen3-0.6b", "--steps", "6", "--batch", "8",
              "--seq", "512", "--log-every", "1"]
TRAIN_B, TRAIN_S = 8, 512
#: the backward kernel against the fp32 plain backward on the same q, k,
#: v, o, dO and lse: the largest error of each gradient within this share
#: of its largest magnitude (bf16 outputs round at 2^-8 of their value)
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-3}
#: (tag, B, S, H, KH, dh, dtype, causal); S is (Sq, Sk) where they differ
BWD_SHAPES = [("qwen3 training", 8, 512, 16, 8, 128, torch.bfloat16, True),
              ("smollm 15/5 heads", 8, 512, 15, 5, 64, torch.bfloat16, True),
              ("f32 dh 16", 2, 256, 4, 2, 16, torch.float32, True),
              ("ragged S=200", 4, 200, 16, 8, 128, torch.bfloat16, True),
              ("full attention", 4, 256, 16, 8, 128, torch.bfloat16, False),
              ("dh 256", 2, 256, 8, 4, 256, torch.bfloat16, True),
              ("f32 dh 256", 2, 256, 8, 4, 256, torch.float32, True),
              ("whisper cross", 8, (512, 1500), 16, 16, 64, torch.bfloat16,
               False),
              ("dbrx GQA 6", 4, 512, 48, 8, 128, torch.bfloat16, True),
              ("paligemma training", 8, 512, 8, 1, 256, torch.bfloat16,
               True),
              ("dh 256 MQA ragged S=200", 2, 200, 8, 1, 256,
               torch.bfloat16, True),
              ("dh 256 full 200 x 232", 2, (200, 232), 8, 2, 256,
               torch.bfloat16, False),
              ("dh 256 16/16 heads", 2, 512, 16, 16, 256, torch.bfloat16,
               True)]
#: the full-width step with the flash kernel against the same step with
#: the plain attention: the loss within 1e-2 relative and each gradient
#: leaf within a relative Frobenius error of 5e-2, sanity bounds like
#: LM_REL_TOL (the kernel rounds P to bf16 before PV, the plain version
#: does not, over 28 layers); the reduced step card against CPU: loss
#: 1e-3 relative, gradient norms 5e-2, parameters 2e-2 (bf16)
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-2, 5e-2


def lengths(S):
    """(Sq, Sk) of a shape's length: one for both, or a pair."""
    return S if isinstance(S, tuple) else (S, S)


def bwd_case(g, B, S, H, KH, dh, dtype, causal, scale=None):
    """Inputs of one backward call (``S``: one length or (Sq, Sk)), the
    forward's o and lse from the kernel (the variant the rule picks, the
    scores scaled by ``scale``, None: dh ** -0.5), and the backward's
    variant by the rule."""
    from repro_torch.kernels import flash_attention as fa
    Sq, Sk = lengths(S)
    q = rand(g, (B, Sq, H, dh), dtype)
    k, v = (rand(g, (B, Sk, KH, dh), dtype) for _ in range(2))
    do = rand(g, (B, Sq, H, dh), dtype)
    o, lse = fa._launch(q, k, v, causal, None, want_lse=True, scale=scale)
    return q, k, v, o, do, lse, fa.variant(q, k, v, o, do)


def phase_flash_bwd_vs_plain():
    """The backward kernels at every ``BWD_SHAPES`` case against
    ``mha_bwd_ref``, by the rule's variant (the tensor-core one for bf16
    at dh 64, 128 and 256, the SIMT one for float32) and, where the rule
    picks ``"tc"``, by the forced SIMT one too; two calls give equal bits
    and each launch took the variant named.  At dh 256 the cases cover
    ``bwd_split``'s partials (4 splits at paligemma's shape and the full
    200 x 232 case, 2 at "dh 256", 8 at the ragged MQA one), the direct
    bf16 stores of one split (16/16 heads: 256 CTAs without a split) and
    ragged tails.  Zamba2-7B's dh 224 (``DH224_SHAPES``) runs at its
    scale, the cell's call one split of 32/32 heads.
    Returns the largest absolute error."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import mha_bwd_ref, mha_lse_ref
    g = torch.Generator(device="cuda").manual_seed(17)
    max_err, lines = 0.0, []
    shapes = [(*x, None) for x in BWD_SHAPES] + [
        (tag, B, S, H, KH, 224, torch.bfloat16, True, DH224_SCALE)
        for tag, B, S, H, KH in DH224_SHAPES]
    for tag, B, S, H, KH, dh, dtype, causal, sm_scale in shapes:
        q, k, v, o, do, lse, var = bwd_case(g, B, S, H, KH, dh, dtype,
                                            causal, sm_scale)
        rule = "tc" if dtype == torch.bfloat16 and dh in fa.TC_HEAD_DIMS \
            else "simt"
        if var != rule:
            raise AssertionError(f"flash_attention_bwd {tag}: the rule "
                                 f"picked {var}, want {rule}")
        lse_err = (lse - mha_lse_ref(q, k, v, causal=causal,
                                     scale=sm_scale)[1]).abs().max().item()
        if lse_err > 1e-4 * max(1.0, lse.abs().max().item()):
            raise AssertionError(f"flash lse {tag}: error {lse_err}")
        want = mha_bwd_ref(q, k, v, o, do, lse, causal=causal,
                           scale=sm_scale)
        runs = [(var, None)] + ([("simt", "simt")] if var == "tc" else [])
        for name_v, forced in runs:
            _build.VARIANTS.clear()
            got = fa.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                         variant=forced, scale=sm_scale)
            again = fa.flash_attention_bwd(q, k, v, o, do, lse,
                                           causal=causal, variant=forced,
                                           scale=sm_scale)
            torch.cuda.synchronize()
            if variant_counts() != {("flash_attention_bwd", name_v): 2}:
                raise AssertionError(f"flash_attention_bwd {tag}: launched "
                                     f"{variant_counts()}, want {name_v}")
            rels = []
            for name, a, b, w in zip(("dq", "dk", "dv"), got, again, want):
                if not torch.equal(a, b):
                    raise AssertionError(f"flash_attention_bwd {tag} "
                                         f"{name_v} {name}: two calls differ")
                err = (a.float() - w.float()).abs().max().item()
                scale = w.float().abs().max().item()
                if not err <= BWD_TOL[dtype] * scale:
                    raise AssertionError(f"flash_attention_bwd {tag} "
                                         f"{name_v} {name}: error {err} over "
                                         f"{scale}")
                max_err = max(max_err, err)
                rels.append(err / scale)
            at = "" if sm_scale is None else f", scale {sm_scale:.4f}"
            lines.append(f"{tag} (B {B}, S {S}, {H}/{KH} heads, dh {dh}, "
                         f"{str(dtype)[6:]}, causal={causal}{at}) {name_v}"
                         f"{' forced' if forced else ''}: lse "
                         f"{lse_err:.1e}, dq/dk/dv "
                         + "/".join(f"{r:.1e}" for r in rels))
            del got, again
        del q, k, v, o, do, lse, want
    log("[flash_attention_bwd] vs mha_bwd_ref, error over each gradient's "
        "largest magnitude (tolerance bf16 2e-2, f32 1e-3), two calls "
        "bit-equal, each launch the variant named: " + "; ".join(lines)
        + f"; max_abs_err {max_err:.3e}")
    return max_err


def train_cli(launches, argv):
    """``launch.train.main(argv)`` with its printed lines echoed; returns
    (params, [(loss, grad norm)], counts, wall s)."""
    from repro_torch.launch import train
    buf = io.StringIO()
    launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        params = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launches)
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"[train] {line}")
    stats = [(float(a), float(b)) for a, b in re.findall(
        r"^step +\d+ loss +(\S+) gnorm +(\S+)", out, flags=re.M)]
    return params, stats, counts, wall


def rel_leaves(a, b):
    """{path: relative Frobenius error} of two gradient trees."""
    from repro_torch import tree as T
    return {"/".join(map(str, p)): rel_err(x, y) for (p, x), (_, y) in
            zip(T.leaves_with_paths(a), T.leaves_with_paths(b))}


def nonzero_grad_norms(stats, tag):
    """The gradient norms of a train step's ``stats`` by leaf path; raises
    unless every one is finite and non-zero (in every layer).  Returns
    them and the smallest (path, norms)."""
    from repro_torch import tree as T
    norms = {"/".join(map(str, p)): n.float().cpu() for p, n in
             T.leaves_with_paths(stats["grad_norms"])}
    bad = [k for k, n in norms.items()
           if not (torch.isfinite(n).all() and (n > 0).all())]
    if bad:
        raise AssertionError(f"{tag}: zero or non-finite gradient in {bad}")
    return norms, min(norms.items(), key=lambda kv: kv[1].min().item())


def step_vs_plain(spec, params, batch, prefix):
    """The loss and gradients of one full-width step with the flash kernel
    against the same step with the plain attention in its place, within
    ``TRAIN_LOSS_TOL`` and ``TRAIN_GRAD_TOL``."""
    from repro_torch.launch.steps import build_loss_and_grads, deterministic
    loss_and_grads = build_loss_and_grads(spec)
    with deterministic():
        lk, gk = loss_and_grads(params, batch)
    with plain_attention(), deterministic():
        lp, gp = loss_and_grads(params, batch)
    loss_rel = abs(lk.item() - lp.item()) / abs(lp.item())
    rels = rel_leaves(gk, gp)
    worst = max(rels.items(), key=lambda kv: kv[1])
    if not (loss_rel <= TRAIN_LOSS_TOL and worst[1] <= TRAIN_GRAD_TOL):
        raise AssertionError(f"{prefix} {spec.name} step vs plain attention:"
                             f" loss {loss_rel}, gradients {rels}")
    log(f"{prefix} {spec.name} full-width step, flash kernel vs plain "
        f"attention: loss {lk.item():.5f} vs {lp.item():.5f} (relative "
        f"{loss_rel:.2e}, tol {TRAIN_LOSS_TOL}); gradient leaves relative "
        f"Frobenius <= {worst[1]:.2e} ({worst[0]}; tol {TRAIN_GRAD_TOL}); "
        "attn: " + ", ".join(f"{k.split('/')[-1]} {v:.1e}" for k, v in
                            rels.items() if "/attn/" in k))


@contextlib.contextmanager
def bwd_call_check(errs):
    """Hold every flash backward call of the enclosed run against
    ``mha_bwd_ref`` on the same q, k, v, o, dO and lse: each gradient's
    largest error within ``BWD_TOL`` of its largest magnitude; ``errs``
    gets the largest share a call."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import mha_bwd_ref
    real = fa.flash_attention_bwd

    def checked(q, k, v, o, do, lse, *, causal=True, variant=None,
                scale=None):
        got = real(q, k, v, o, do, lse, causal=causal, variant=variant,
                   scale=scale)
        want = mha_bwd_ref(q, k, v, o, do, lse, causal=causal, scale=scale)
        shares = [((a.float() - w.float()).abs().max()
                   / w.float().abs().max()).item() for a, w in zip(got, want)]
        if not max(shares) <= BWD_TOL[q.dtype]:
            raise AssertionError(f"flash backward call {len(errs)}: dq/dk/dv "
                                 f"errors {shares} of their magnitudes")
        errs.append(max(shares))
        return got

    fa.flash_attention_bwd = checked
    try:
        yield
    finally:
        fa.flash_attention_bwd = real


def global_rel(a, b):
    """The relative Frobenius error of two gradient trees taken whole."""
    from repro_torch import tree as T
    num = sum((x.float() - y.float()).square().sum().item()
              for x, y in zip(T.leaves(a), T.leaves(b)))
    return (num / sum(y.float().square().sum().item()
                      for y in T.leaves(b))) ** 0.5


def step_vs_plain_fp32(spec, params, batch, prefix):
    """One full-width step with the flash kernel, every flash call in it
    held to its plain version on the same inputs (forward within
    ``LAYER_TOL``, backward within ``BWD_TOL``), and the same step with the
    plain attention, each against the step computed in fp32 (the weights
    upcast, ``COMPUTE_DTYPE`` float32, the plain attention): the kernel's
    loss, and its whole gradient (relative Frobenius), no farther from
    fp32 than the plain attention's plus ``TRAIN_LOSS_TOL`` and
    ``TRAIN_GRAD_TOL``.  Each leaf's distances are read.

    ``step_vs_plain``'s direct bound cannot hold for the hybrid: its bf16
    mamba layers amplify any perturbation, so that on the card its bf16
    gradients with the kernel and with the plain attention lie 11.5% from
    each other at 6 layers of the full width, 25% at 12 and 71% at all 38,
    and the plain attention's 14%, 28% and 72% from the fp32 gradient."""
    from repro_torch import tree as T
    from repro_torch.launch.steps import build_loss_and_grads, deterministic
    loss_and_grads = build_loss_and_grads(spec)
    ferrs, berrs = [], []
    with per_layer_check(ferrs), bwd_call_check(berrs), deterministic():
        lk, gk = loss_and_grads(params, batch)
    with plain_attention(), deterministic():
        lp, gp = loss_and_grads(params, batch)
    n = flash_per_prefill(spec)
    if len(ferrs) != n or len(berrs) != n:
        raise AssertionError(f"{prefix} {spec.name} step: {len(ferrs)} flash "
                             f"forwards, {len(berrs)} backwards, want {n}")
    p32 = T.tree_map(lambda t: t.float(), params)
    with plain_attention(), compute_dtype(torch.float32), deterministic():
        l32, g32 = build_loss_and_grads(spec)(p32, batch)
    del p32
    dk, dp = abs(lk.item() - l32.item()), abs(lp.item() - l32.item())
    ek, ep = global_rel(gk, g32), global_rel(gp, g32)
    if not (dk <= dp + TRAIN_LOSS_TOL * abs(l32.item())
            and ek <= ep + TRAIN_GRAD_TOL):
        raise AssertionError(f"{prefix} {spec.name} against fp32: loss kernel "
                             f"{lk.item()}, plain {lp.item()}, fp32 "
                             f"{l32.item()}; gradient kernel {ek}, plain {ep}")
    rk, rp, direct = rel_leaves(gk, g32), rel_leaves(gp, g32), \
        rel_leaves(gk, gp)
    log(f"{prefix} {spec.name} full-width step: {n} flash forwards within "
        f"{LAYER_TOL} of the plain version (max "
        f"{max(ferrs, default=0.0):.3e}) and {n} backwards within "
        f"{BWD_TOL[torch.bfloat16]} of each gradient's magnitude (max "
        f"{max(berrs, default=0.0):.3e}); against fp32: loss kernel "
        f"{lk.item():.5f}, plain {lp.item():.5f}, fp32 {l32.item():.5f}; "
        f"whole gradient relative kernel {ek:.3e}, plain {ep:.3e} (the "
        f"kernel within the plain's + {TRAIN_GRAD_TOL}); by leaf, read, "
        f"kernel / plain from fp32 <= {max(rk.values()):.3e} / "
        f"{max(rp.values()):.3e}, kernel vs plain <= "
        f"{max(direct.values()):.3e}; attn kernel/plain: "
        + ", ".join(f"{k.split('/')[-1]} {rk[k]:.2e}/{rp[k]:.2e}"
                    for k in rk if "/attn/" in k))


def profile_train_step(spec, step, params, opt_state, batch, smi):
    """One train step: three unprofiled walls after a warm-up, then one
    under ``torch.profiler`` (device ms, launches, busy share, top
    operations).  Returns (best wall ms, device ms, launches)."""
    B, S = batch["tokens"].shape

    def one_step():
        step(params, opt_state, batch)

    one_step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    step_ms = min(walls)
    dev_ms, n_launch, top = device_profile(one_step, top=8)
    log(f"[profile] train step {spec.name} B={B} S={S}: wall "
        f"{', '.join(f'{w:.1f}' for w in walls)} ms "
        f"({B * S / step_ms * 1e3:.0f} tokens/s at the best); "
        f"device {dev_ms:.1f} ms in {n_launch} launches, busy "
        f"{dev_ms / step_ms:.2f} of the best unprofiled wall; top: {top}; "
        f"{smi}")
    return step_ms, dev_ms, n_launch


def check_resume(launches, arch, prefix):
    """``--reduced`` training of ``arch`` on the card (seq 64, batch 8, 12
    steps): ``--die-at 9`` exits 42, ``--restore auto`` resumes from the
    checkpoint of step 8, and the final parameters equal the uninterrupted
    run's bit for bit."""
    import tempfile
    from repro_torch import tree as T
    small_args = ["--arch", arch, "--reduced", "--seq", "64", "--batch", "8",
                  "--steps", "12", "--log-every", "100"]
    pa, _, _, wall_a = train_cli(launches, small_args)
    with tempfile.TemporaryDirectory() as ck:
        ck_args = small_args + ["--ckpt-dir", ck, "--ckpt-every", "4"]
        try:
            train_cli(launches, ck_args + ["--die-at", "9"])
        except SystemExit as e:
            if e.code != 42:
                raise
        else:
            raise AssertionError(f"train {arch} --die-at 9 did not exit")
        pb, _, _, _ = train_cli(launches, ck_args + ["--restore", "auto"])
    diff = [k for (k, a), (_, b) in zip(T.leaves_with_paths(pa),
                                       T.leaves_with_paths(pb))
            if not (a.dtype == b.dtype and torch.equal(
                a.reshape(-1).view(torch.uint8),
                b.reshape(-1).view(torch.uint8)))]
    if diff:
        raise AssertionError(f"resume {arch}: parameters differ at {diff}")
    log(f"{prefix} {arch} resume at --reduced (seq 64): --die-at 9 exited "
        f"42, --restore auto resumed from step 8; the final parameters "
        f"equal the uninterrupted 12-step run's bit for bit ({wall_a:.1f} s "
        f"for that run)")


def phase_train(launches, smi):
    """Training (docstring item 17).  Returns (flash forward launches,
    backward launches) of the full-width CLI run, the backward kernel's
    largest error, and the training shape's inputs for the timing."""
    from repro_torch import configs, tree as T
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import build_loss_and_grads, build_train_step
    from repro_torch.models import api
    from repro_torch.optim import OptConfig, opt_init
    from repro_torch.kernels import _build
    t_phase = time.perf_counter()
    bwd_err = phase_flash_bwd_vs_plain()

    # (2) the CLI at full width: 6 steps, every loss and norm finite
    spec = configs.get("qwen3-0.6b")
    cfg = spec.cfg
    L, steps = cfg.n_layers, int(TRAIN_ARGS[TRAIN_ARGS.index("--steps") + 1])
    per_step = {"none": (1, 1), "dots": (2, 1), "full": (2, 1)}[cfg.remat]
    want = {"flash_attention": steps * L * per_step[0],
            "flash_attention_bwd": steps * L * per_step[1]}
    torch.cuda.reset_peak_memory_stats()
    _build.VARIANTS.clear()
    params, stats, counts, wall = train_cli(launches, TRAIN_ARGS)
    if counts != want:
        raise AssertionError(f"train: launches {counts}, the remat policy "
                             f"{cfg.remat!r} predicts {want}")
    if dict(_build.VARIANTS) != {
            ("flash_attention", "tc"): want["flash_attention"],
            ("flash_attention_bwd", "tc"): want["flash_attention_bwd"]}:
        raise AssertionError(f"train: variants {dict(_build.VARIANTS)}, "
                             f"want every launch tc")
    if len(stats) != steps or not all(np.isfinite(x) for s in stats
                                      for x in s):
        raise AssertionError(f"train: step lines {stats}")
    # param_count() leaves out the qk-norm gains (the JAX formula)
    n_params = sum(p.numel() for p in T.leaves(params))
    if n_params != cfg.param_count() + 2 * L * cfg.dh * cfg.qk_norm:
        raise AssertionError(f"train: {n_params} parameters")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[train] qwen3-0.6b full width ({L} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv} heads of {cfg.dh}, vocab {cfg.vocab}, "
        f"{n_params} parameters, param_count() {cfg.param_count()} without "
        f"the qk-norm gains), {steps} steps of {TRAIN_B} x {TRAIN_S}: "
        f"losses {[round(s[0], 4) for s in stats]}, grad norms "
        f"{[round(s[1], 3) for s in stats]}, all finite; wall {wall:.1f} s; "
        f"launches {counts} == remat {cfg.remat!r}'s prediction ({per_step[0]}"
        f" forward, {per_step[1]} backward a layer a step), every forward "
        f"and every backward the tc variant; peak memory {peak_gb:.1f} GB; {smi}")
    del params

    # (3) one step by build_train_step: every gradient non-zero; the same
    # loss and gradients with the plain attention in the kernel's place
    params = api.init(torch.Generator(device="cuda").manual_seed(0), spec)
    opt_cfg = OptConfig()
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                  global_batch=TRAIN_B, seed=0),
                       device="cuda")
    batch = data.batch(0)
    step = build_train_step(spec, opt_cfg)
    launches.clear()
    _, _, st = step(params, opt_init(params, opt_cfg), batch)
    torch.cuda.synchronize()
    counts = dict(launches)
    if counts != {k: n // steps for k, n in want.items()}:
        raise AssertionError(f"train step: launches {counts}")
    norms, lo = nonzero_grad_norms(st, "train step")
    log(f"[train] build_train_step at full width: launches {counts}; every "
        f"gradient leaf finite and non-zero in every layer ({len(norms)} "
        f"leaves; smallest {lo[0]} {lo[1].min().item():.3e}); attn norms "
        f"layer 0: " + ", ".join(
            f"{k.split('/')[-1]} {norms[k][0].item():.3e}" for k in norms
            if "/attn/" in k))
    del st
    step_vs_plain(spec, params, batch, "[train]")

    # (6a) one full-width step under the profiler, and unprofiled
    profile_train_step(spec, step, params, opt_init(params, opt_cfg), batch,
                       smi)
    del params, batch
    torch.cuda.empty_cache()

    # (4) the reduced step on the card against the CPU plain path: loss,
    # every gradient leaf (rtol 5e-2, atol 5e-3, the CPU tests' gradient
    # tolerance), and the parameters after one AdamW step within 2 lr plus
    # one bf16 ulp (2^-7 of the larger value): Adam's first step moves each
    # entry by lr times the sign of its gradient, so an entry whose
    # gradient is near 0 may move either way
    small = configs.reduced(spec)
    p_cpu = api.init(torch.Generator().manual_seed(0), small)
    b_cpu = SyntheticLM(DataConfig(vocab=small.cfg.vocab, seq_len=64,
                                   global_batch=8, seed=0)).batch(0)
    lr = 1e-2
    sstep = build_train_step(small, OptConfig(lr=lr, warmup=1))
    outs = []
    for dev in ("cpu", "cuda"):
        p = T.tree_map(lambda t: t.to(dev), p_cpu)
        b = {k: x.to(dev) for k, x in b_cpu.items()}
        outs.append(build_loss_and_grads(small)(p, b)
                    + sstep(p, opt_init(p, OptConfig()), b)[:1])
    (lc, gc, pc), (lg, gg, pg) = outs
    loss_rel = abs(lg.item() - lc.item()) / lc.item()
    g_err = max(((a.cpu().float() - b.float()).abs()
                 / (5e-3 + 5e-2 * b.float().abs())).max().item()
                for a, b in zip(T.leaves(gg), T.leaves(gc)))
    p_err = max(((a.cpu().float() - b.float()).abs()
                 / (2 * lr + 2 ** -7 * torch.maximum(
                     a.cpu().float().abs(), b.float().abs()))).max().item()
                for a, b in zip(T.leaves(pg), T.leaves(pc)))
    if not (loss_rel <= 1e-3 and g_err <= 1 and p_err <= 1):
        raise AssertionError(f"reduced step card vs CPU: loss {loss_rel}, "
                             f"gradients {g_err} of the tolerance, "
                             f"params {p_err}")
    log(f"[train] reduced step (seq 64, batch 8) card vs CPU plain path: "
        f"loss {lg.item():.5f} vs {lc.item():.5f} (relative "
        f"{loss_rel:.1e}, tol 1e-3), every gradient leaf within "
        f"{g_err:.2f} of its tolerance, parameters after one step within "
        f"{p_err:.3f} of the tolerance (2 lr + 2^-7 of the larger value, "
        f"lr {lr})")

    # (5) resume on the card, bit-exact against an uninterrupted run
    check_resume(launches, "qwen3-0.6b", "[train]")
    log(f"[train] phase wall {time.perf_counter() - t_phase:.1f} s; {smi}")
    return want["flash_attention"], want["flash_attention_bwd"], bwd_err


def time_flash_bwd(launches_on_path, max_err):
    """The backward kernels at the training shape (B 8, S 512, 16/8
    heads, dh 128, bf16, causal), the tensor-core and the SIMT variant in
    turns (tc, simt, simt, tc; the lower reading of each), beside the
    plain version and the backward of ``scaled_dot_product_attention`` on
    the same inputs."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import mha_bwd_ref
    _, B, S, H, KH, dh, dtype, causal = BWD_SHAPES[0]
    g = torch.Generator(device="cuda").manual_seed(18)
    q, k, v, o, do, lse, var = bwd_case(g, B, S, H, KH, dh, dtype, causal)
    runs = {"tc": (lambda: fa.flash_attention_bwd(q, k, v, o, do, lse), 20),
            "simt": (lambda: fa.flash_attention_bwd(q, k, v, o, do, lse,
                                                    variant="simt"), 5)}
    _build.VARIANTS.clear()
    reads = {"tc": [], "simt": []}
    for name in ("tc", "simt", "simt", "tc"):
        fn, reps = runs[name]
        reads[name].append(device_ms(fn, reps))
    if var != "tc" or set(variant_counts()) != {
            ("flash_attention_bwd", "tc"), ("flash_attention_bwd", "simt")}:
        raise AssertionError(f"time_flash_bwd: rule {var}, launched "
                             f"{variant_counts()}")
    ms, simt_ms = min(reads["tc"]), min(reads["simt"])
    ev_ms = event_ms(runs["tc"][0], 10)
    plain_ms = device_ms(lambda: mha_bwd_ref(q, k, v, o, do, lse), 3)
    by_backend, lib_name = sdpa_bwd_by_backend(q, k, v, do, causal)
    lib_ms = by_backend[lib_name]
    nbytes, flops = bwd_work(B, S, H, KH, dh, dtype, causal)
    bound_ms, by, peak = bound(nbytes, flops, dtype)
    share = {"tc": bound_ms / ms, "simt": bound_ms / simt_ms}
    log(f"[timing] flash_attention_bwd B={B} S={S} H={H}/{KH} dh={dh} bf16 "
        f"causal, device (in turns tc, simt, simt, tc: tc "
        + ", ".join(f"{t:.4f}" for t in reads["tc"]) + " ms, simt "
        + ", ".join(f"{t:.4f}" for t in reads["simt"]) + " ms): "
        f"tc {ms:.4f} ms (events, back to back, {ev_ms:.4f}; "
        f"{share['tc']:.1%} of the bound), simt {simt_ms:.4f} ms "
        f"({share['simt']:.1%} of the bound; {simt_ms / ms:.1f}x tc), plain "
        f"{plain_ms:.4f} ms, scaled_dot_product_attention backward by "
        f"backend " + ", ".join(f"{n} {t:.4f} ms" for n, t in
                                by_backend.items())
        + f" (library_ms: {lib_name}); bound {bound_ms:.5f} ms ({nbytes} B, "
        f"{flops} FLOP, {by}; peak {peak}); tc {ms / lib_ms:.2f}x the "
        f"library")
    dh256 = time_flash_bwd_dh256()
    return dict(name="flash_attention_bwd", route="cuda", variant="tc",
                source="src/repro_torch/csrc/flash_attention_bwd.cu",
                replaces=FLASH_BWD_REPLACES, launches=launches_on_path,
                max_abs_err=max_err, ms=ms, event_ms=ev_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=lib_ms, library_backend=lib_name,
                variant_ms={"tc": ms, "simt": simt_ms}, bound_share=share,
                tc_dh256=dh256["tc"], simt_dh256=dh256["simt"])


def sdpa_bwd_by_backend(q, k, v, do, causal):
    """The device ms of the backward of ``scaled_dot_product_attention``
    (``enable_gqa``) on the flash wrapper's inputs, by each backend that
    takes the shape, and the one to cite: cuDNN's where it runs, else the
    fastest."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    doh = do.transpose(1, 2).contiguous()
    by_backend = {}
    for be in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
               SDPBackend.EFFICIENT_ATTENTION):
        # a backend that refuses the shape raises (and warns why)
        with sdpa_kernel(be), warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            try:
                out = F.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=causal, enable_gqa=True)
                torch.autograd.grad(out, (qh, kh, vh), doh,
                                    retain_graph=True)
            except RuntimeError:
                continue
            by_backend[be.name] = device_ms(
                lambda: torch.autograd.grad(out, (qh, kh, vh), doh,
                                            retain_graph=True), 10)
        del out
    return by_backend, ("CUDNN_ATTENTION" if "CUDNN_ATTENTION" in by_backend
                        else min(by_backend, key=by_backend.get))


def bwd_work(B, S, H, KH, dh, dtype, causal):
    """Bytes and FLOP of one flash backward: q, o, dO, dq and k, v, dk,
    dv moved once, lse read once; five products (S, dP, dV, dQ, dK) over
    the pairs the mask keeps.  ``S``: one length, or (Sq, Sk) for full
    attention."""
    Sq, Sk = lengths(S)
    esz = torch.tensor([], dtype=dtype).element_size()
    nbytes = esz * (4 * B * Sq * H * dh + 4 * B * Sk * KH * dh) + \
        4 * B * H * Sq
    pairs = B * H * (Sq * (Sq + 1) // 2 if causal else Sq * Sk)
    return nbytes, 5 * 2 * dh * pairs


def time_flash_bwd_dh256():
    """The backward at ``BWD_SHAPES``' bf16 dh-256 shape by the rule's
    tensor-core kernels and the forced SIMT ones (32-row tiles), in turns
    (``in_turns``), beside the plain version and the bound: {"tc": ...,
    "simt": ...}."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import mha_bwd_ref
    _, B, S, H, KH, dh, dtype, causal = next(
        x for x in BWD_SHAPES if x[0] == "dh 256")
    g = torch.Generator(device="cuda").manual_seed(19)
    q, k, v, o, do, lse, var = bwd_case(g, B, S, H, KH, dh, dtype, causal)
    if var != "tc":
        raise AssertionError(f"time_flash_bwd_dh256: the rule gave {var}")
    _, turns = in_turns(lambda forced: fa.flash_attention_bwd(
        q, k, v, o, do, lse, causal=causal, variant=forced), dh, 10)
    reads = turns["readings"]
    plain_ms = device_ms(lambda: mha_bwd_ref(q, k, v, o, do, lse,
                                             causal=causal), 5)
    nbytes, flops = bwd_work(B, S, H, KH, dh, dtype, causal)
    bound_ms, by, peak = bound(nbytes, flops, dtype)
    out = {name: dict(shape=[B, S, H, KH, dh], variant=name, ms=ms,
                      readings=reads[name], plain_ms=plain_ms,
                      bound_ms=bound_ms, bound_by=by)
           for name, ms in turns["variant_ms"].items()}
    log(f"[timing] flash_attention_bwd B={B} S={S} H={H}/{KH} dh={dh} bf16 "
        f"causal, device in turns (tc, simt, simt, tc): tc "
        + ", ".join(f"{t:.4f}" for t in reads["tc"]) + " ms ("
        f"{bound_ms / out['tc']['ms']:.1%} of the bound), simt (32-row "
        f"tiles) " + ", ".join(f"{t:.4f}" for t in reads["simt"])
        + f" ms ({bound_ms / out['simt']['ms']:.1%}; "
        f"{out['simt']['ms'] / out['tc']['ms']:.1f}x tc), plain "
        f"{plain_ms:.4f} ms; bound {bound_ms:.5f} ms ({nbytes} B, {flops} "
        f"FLOP, {by}; peak {peak})")
    return out


def bwd_by_split(q, k, v, o, do, lse, causal):
    """The tensor-core backward at dh 256 by each split of the GQA
    group's query heads (the divisors of H // KH), in turns (the list,
    then reversed; the lower reading of each), and each of its kernels'
    device ms a call at ``bwd_split``'s choice, from ``torch.profiler``:
    {"rule": ..., "ms_by_split": ..., "readings": ..., "kernel_ms": ...}."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import flash_attention as fa
    B, S, H, dh = q.shape
    KH = k.shape[2]
    rep = H // KH
    splits = [d for d in range(1, rep + 1) if rep % d == 0]
    reads = {d: [] for d in splits}
    for d in splits + splits[::-1]:
        reads[d].append(device_ms(lambda: fa._launch_bwd(
            q, k, v, o, do, lse, causal, None, split=d), 10))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fa.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
        torch.cuda.synchronize()
    # the mean over the launches the trace kept: a trace taken after
    # others in one process may drop some of them
    kernel_ms, kernel_n = {}, {}
    for e in prof.key_averages():
        if e.device_type.name == "CUDA":
            m = re.search(r"\w+_kernel", e.key)
            name = m.group(0) if m else e.key
            kernel_ms[name] = e.self_device_time_total / e.count / 1e3
            kernel_n[name] = e.count
    rule = fa.bwd_split(B, H, KH, k.shape[1], dh, fa._n_sm(q.get_device()))
    out = dict(rule=rule, ms_by_split={d: min(r) for d, r in reads.items()},
               readings=reads, kernel_ms=kernel_ms, kernel_traced=kernel_n)
    log(f"[timing] flash_attention_bwd by split (B={B} S={S} H={H}/{KH} "
        f"dh={dh}; the rule's {rule}; in turns): " + ", ".join(
            f"{d}: {min(r):.4f} ms" for d, r in reads.items())
        + f"; kernels at split {rule} (mean of the launches traced, of "
        f"10): " + ", ".join(f"{n} {t:.4f} ms ({kernel_n[n]})"
                            for n, t in kernel_ms.items())
        + f", {sum(kernel_ms.values()):.4f} ms in all")
    return out


# ------------------------------------------------------- phases 18-19
#: the families serving and training, at full width: (arch, flash
#: launches a prefill); the dense ones launch one a layer, mamba2 none,
#: zamba2 one an application of its shared attention block
FAMILIES = (("llama3.2-3b", 28), ("yi-6b", 32), ("mamba2-130m", 0),
            ("zamba2-1.2b", 7))
FAMILY_PROMPT, FAMILY_GEN = 512, 32
# Each one's prefill with the kernel is held to the plain attention per
# layer (``LAYER_TOL``) and, end to end, no farther from the fp32 prefill
# (the weights upcast, the plain attention) than the plain attention's
# bf16 prefill plus ``LM_REL_TOL``; the others but the hybrid also within
# ``LM_REL_TOL`` of the plain attention directly, as in phase 9.  zamba2's
# 38 bf16 mamba layers amplify any perturbation: its bf16 prefill lies 24%
# (logits) and 36% (states) from its fp32 one with the plain attention,
# and 23% and 34% from the kernel's (on the CPU, a 12-layer hybrid of
# width 1024: 9.4% from fp32, and 9.3% between the plain attention and one
# that rounds P to bf16 as the kernel does)

#: mamba2's one-step prefill against its token-by-token decode on the
#: card, at the serving path's shorter prompt (one SSD chunk of 200), with
#: the CPU test's bound (tests/test_models.py::
#: test_mamba2_chunked_equals_stepwise), computing in fp32: the two orders
#: of the same sums agree to about 1e-5 there.  In bf16 the comparison is
#: read, not bounded: the two paths round the SSD's output to bf16 after
#: sums in other orders, and 24 layers compound the flipped roundings (on
#: the CPU: 1.1% relative at 6 layers of width 384, 3.0% at 12 of 768, 1e-5
#: in fp32 at both)
STEPWISE_PROMPT, STEPWISE_TOL = 200, 3e-2
TRAIN_FAMILIES = ("mamba2-130m", "zamba2-1.2b")
TRAIN_FAMILY_STEPS = 4


def flash_per_prefill(spec):
    """The flash launches one prefill makes: a layer's attention (dense,
    moe), an application of the shared block's (hybrid), a decoder layer's
    self- and cross-attention (audio; the encoder adds one a layer); a
    layer's attention of the vlm's LM over the prefix and the text; none
    for mamba2."""
    cfg = spec.cfg
    if spec.family == "vlm":
        return cfg.lm.n_layers
    return {"dense": cfg.n_layers, "moe": cfg.n_layers, "ssm": 0,
            "hybrid": getattr(cfg, "n_apps", 0),
            "audio": 2 * cfg.n_layers}[spec.family]


def state_rel(a, b):
    """The largest relative Frobenius error of two decode states, over
    their leaves and each leaf's leading (layer or application) axis."""
    from repro_torch import tree as T
    return max(rel_err(x[i], y[i]) for x, y in zip(T.leaves(a), T.leaves(b))
               for i in range(x.shape[0]) if y[i].float().norm() > 0)


def expect_launches(launches, n, tag):
    """Raises unless ``launches`` holds exactly ``n`` flash launches (none
    of any other kernel), every one the tensor-core variant."""
    want = {"flash_attention": n} if n else {}
    if dict(launches) != want:
        raise AssertionError(f"{tag}: launches {dict(launches)}, want {want}")
    if variant_counts() != ({("flash_attention", "tc"): n} if n else {}):
        raise AssertionError(f"{tag}: variants {variant_counts()}, want all "
                             f"{n} tc")


def phase_serve_families(launches, smi):
    """``serve.main`` of each of ``FAMILIES`` at full width (batch 4, a
    512-token prompt, 32 new tokens, random bf16 weights from seed 0)
    with its flash launches counted; its prefill step with the kernel
    against the plain attention, per layer and end to end; decode; a
    profile of one prefill and of three decode steps; and mamba2's
    one-step prefill against its token-by-token decode.  Returns the
    flash launches by architecture."""
    from repro_torch import configs, tree as T
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models import api
    t_phase = time.perf_counter()
    B, P, G = 4, FAMILY_PROMPT, FAMILY_GEN
    out = {}
    for arch, n_flash in FAMILIES:
        spec = configs.get(arch)
        cfg = spec.cfg
        if flash_per_prefill(spec) != n_flash:
            raise AssertionError(f"{arch}: {flash_per_prefill(spec)} flash "
                                 f"calls a prefill, want {n_flash}")
        launches.clear()
        _build.VARIANTS.clear()
        t0 = time.perf_counter()
        gen = serve.main(["--arch", arch, "--batch", str(B), "--prompt-len",
                          str(P), "--gen", str(G), "--seed", "0"])
        wall = time.perf_counter() - t0
        expect_launches(launches, n_flash, f"serve {arch}")
        if gen.shape != (B, G) or gen.min() < 0 or gen.max() >= cfg.vocab:
            raise AssertionError(f"serve {arch}: tokens {gen.shape}")
        out[arch] = n_flash

        torch.cuda.reset_peak_memory_stats()
        params = api.init(torch.Generator(device="cuda").manual_seed(0),
                          spec)
        n_params = sum(x.numel() for x in T.leaves(params))
        prompt = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab, (B, P)), device="cuda")
        errs = []
        with per_layer_check(errs):
            prefill(params, spec, prompt, P + G)
        if len(errs) != n_flash:
            raise AssertionError(f"prefill {arch}: {len(errs)} flash calls")
        launches.clear()
        _build.VARIANTS.clear()
        lk, sk, k_ms = prefill(params, spec, prompt, P + G)
        expect_launches(launches, n_flash, f"prefill {arch}")
        with plain_attention():
            lp, sp, p_ms = prefill(params, spec, prompt, P + G)
            p32 = T.tree_map(lambda t: t.float(), params)
            with compute_dtype(torch.float32):
                l32, s32, _ = prefill(p32, spec, prompt, P + G)
            del p32
        logit_rel, st_rel = rel_err(lk, lp), state_rel(sk, sp)
        anchored = [(rel_err(lk, l32), rel_err(lp, l32)),
                    (state_rel(sk, s32), state_rel(sp, s32))]
        if any(k > p + LM_REL_TOL for k, p in anchored) or (
                spec.family != "hybrid" and
                not (logit_rel <= LM_REL_TOL and st_rel <= LM_REL_TOL)):
            raise AssertionError(f"prefill {arch}: logits relative error "
                                 f"{logit_rel}, states {st_rel}; from fp32 "
                                 f"(kernel, plain): {anchored}")
        agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
        del lp, sp, l32, s32
        step = build_serve_step(spec)
        tok, state = lk.argmax(-1).to(torch.int32), sk
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(G):
            tok, state = step(params, state, tok[:, None], P + i)
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t0) / G * 1e3
        pre = device_profile(lambda: prefill(params, spec, prompt, P + G))
        state = api.decode_state(spec, B, P + G)
        step(params, state, prompt, 0)

        def three_steps():
            t = tok
            for i in range(3):
                t, _ = step(params, state, t[:, None], P + i)

        dec = device_profile(three_steps)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        log(f"[serve-families] {arch} ({spec.family}, {cfg.n_layers} "
            f"layers, d_model {cfg.d_model}, {n_params} parameters) B={B} "
            f"P={P}: serve.main {gen.shape} tokens in [0, {cfg.vocab}), "
            f"wall {wall:.1f} s, {n_flash} flash launches a prefill, all "
            f"tc; each layer's flash output within {LAYER_TOL} of the "
            f"plain version (max {max(errs, default=0.0):.3e}); vs the plain "
            f"attention end to end: logits relative {logit_rel:.3e}, states "
            f"relative <= {st_rel:.3e} (tol {LM_REL_TOL}"
            f"{', read' if spec.family == 'hybrid' else ''}), greedy agreement "
            f"{agree:.2f}; from the fp32 prefill, kernel / plain: logits "
            f"{anchored[0][0]:.3e} / {anchored[0][1]:.3e}, states "
            f"{anchored[1][0]:.3e} / {anchored[1][1]:.3e} (the kernel within "
            f"the plain's + {LM_REL_TOL}); prefill {k_ms:.1f} ms ({p_ms:.1f} with the plain "
            f"attention), decode {dec_ms:.2f} ms a step "
            f"({B / dec_ms * 1e3:.1f} tok/s); peak memory {peak_gb:.1f} GB; "
            f"{smi}")
        log(f"[profile] {arch} prefill P={P}: device {pre[0]:.2f} ms, "
            f"{pre[1]} launches, busy {pre[0] / k_ms:.2f} of the unprofiled "
            f"{k_ms:.1f} ms; top: {pre[2]}")
        log(f"[profile] {arch} decode: device {dec[0] / 3:.2f} ms and "
            f"{dec[1] / 3:.0f} launches a step, busy "
            f"{dec[0] / 3 / dec_ms:.2f} of the unprofiled {dec_ms:.2f} ms; "
            f"top over 3 steps: {dec[2]}")
        if spec.family == "ssm":
            mamba_stepwise(params, spec)
        del params, sk, state, lk, tok
        torch.cuda.empty_cache()
    log(f"[serve-families] phase wall {time.perf_counter() - t_phase:.1f} "
        f"s; {smi}")
    return out


@contextlib.contextmanager
def compute_dtype(dtype):
    """The models' activation dtype (``layers.COMPUTE_DTYPE``) set to
    ``dtype`` for the enclosed code."""
    from repro_torch.models import layers as L
    was, L.COMPUTE_DTYPE = L.COMPUTE_DTYPE, dtype
    try:
        yield
    finally:
        L.COMPUTE_DTYPE = was


def mamba_stepwise(params, spec):
    """mamba2's one-step prefill of ``STEPWISE_PROMPT`` tokens (one SSD
    chunk) against the same tokens decoded one at a time: in fp32 (the
    weights upcast, ``COMPUTE_DTYPE`` float32) every position's logits
    within ``STEPWISE_TOL``; in bf16, as served, the error read."""
    from repro_torch import tree as T
    from repro_torch.models import api
    B, P = 4, STEPWISE_PROMPT
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, spec.cfg.vocab, (B, P)), device="cuda")
    reads = []
    for dtype in (torch.float32, torch.bfloat16):
        p = T.tree_map(lambda t: t.to(dtype) if t.dtype == torch.bfloat16
                       else t, params)
        with compute_dtype(dtype), torch.inference_mode():
            full, s_full = api.apply_decode(p, spec, prompt,
                                            api.decode_state(spec, B, P), 0)
            state, outs = api.decode_state(spec, B, P), []
            for i in range(P):
                lg, state = api.apply_decode(p, spec, prompt[:, i:i + 1],
                                             state, i)
                outs.append(lg[:, 0])
            dec = torch.stack(outs, 1)
        err = close(full, dec, STEPWISE_TOL, f"mamba2 stepwise P={P}") \
            if dtype == torch.float32 else (full - dec).abs().max().item()
        reads.append(f"{str(dtype)[6:]}: max abs {err:.3e}, logits relative "
                     f"{rel_err(full, dec):.3e}, final states relative "
                     f"{state_rel(state, s_full):.3e}")
        del p, full, dec, state, s_full
    log(f"[serve-families] {spec.name} one-step prefill of {P} tokens vs "
        f"{P} decode steps on the card, every position's logits ({B} "
        f"sequences): " + "; ".join(reads) + f" (fp32 within {STEPWISE_TOL}"
        f"; bf16 read, not bounded)")


def phase_train_families(launches, smi):
    """``launch.train.main`` of each of ``TRAIN_FAMILIES`` at full width
    (4 steps of 8 x 512), its flash launches counted (zamba2: one forward
    and one backward an application a step, the shared block outside the
    remat, all tc); one ``build_train_step`` step with every gradient leaf
    non-zero; that step against the plain attention; a profiled step; and
    a bit-exact resume at ``--reduced``.  Returns the flash forward and
    backward launches of zamba2's CLI run."""
    from repro_torch import configs, tree as T
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import _build
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import api
    from repro_torch.optim import OptConfig, opt_init
    t_phase = time.perf_counter()
    steps, fwd, bwd = TRAIN_FAMILY_STEPS, 0, 0
    for arch in TRAIN_FAMILIES:
        spec = configs.get(arch)
        cfg = spec.cfg
        n = flash_per_prefill(spec)
        want = {"flash_attention": steps * n,
                "flash_attention_bwd": steps * n} if n else {}
        torch.cuda.reset_peak_memory_stats()
        _build.VARIANTS.clear()
        params, stats, counts, wall = train_cli(
            launches, ["--arch", arch, "--steps", str(steps), "--batch",
                       str(TRAIN_B), "--seq", str(TRAIN_S), "--log-every",
                       "1"])
        if counts != want or variant_counts() != {
                (k, "tc"): v for k, v in want.items()}:
            raise AssertionError(f"train {arch}: launches {counts}, variants"
                                 f" {variant_counts()}, want {want} all tc")
        if len(stats) != steps or not all(np.isfinite(x) for st in stats
                                          for x in st):
            raise AssertionError(f"train {arch}: step lines {stats}")
        n_params = sum(x.numel() for x in T.leaves(params))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        fwd += counts.get("flash_attention", 0)
        bwd += counts.get("flash_attention_bwd", 0)
        log(f"[train-families] {arch} full width ({cfg.n_layers} layers, "
            f"d_model {cfg.d_model}, {n_params} parameters; param_count() "
            f"{cfg.param_count()}, the JAX formula), {steps} steps "
            f"of {TRAIN_B} x {TRAIN_S}: losses "
            f"{[round(st[0], 4) for st in stats]}, grad norms "
            f"{[round(st[1], 3) for st in stats]}, all finite; wall "
            f"{wall:.1f} s; launches {counts} ({n} forward and {n} backward "
            f"a step, every one tc); peak memory {peak_gb:.1f} GB; {smi}")
        del params

        params = api.init(torch.Generator(device="cuda").manual_seed(0),
                          spec)
        batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                       global_batch=TRAIN_B, seed=0),
                            device="cuda").batch(0)
        opt_cfg = OptConfig()
        step = build_train_step(spec, opt_cfg)
        _, _, st = step(params, opt_init(params, opt_cfg), batch)
        norms, lo = nonzero_grad_norms(st, f"train step {arch}")
        log(f"[train-families] {arch} build_train_step: every gradient leaf "
            f"finite and non-zero in every layer ({len(norms)} leaves; "
            f"smallest {lo[0]} {lo[1].min().item():.3e})")
        del st
        step_vs_plain_fp32(spec, params, batch, "[train-families]")
        torch.cuda.reset_peak_memory_stats()
        profile_train_step(spec, step, params, opt_init(params, opt_cfg),
                           batch, smi)
        log(f"[train-families] {arch} peak memory of the profiled steps "
            f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
        del params, batch
        torch.cuda.empty_cache()
        check_resume(launches, arch, "[train-families]")
    log(f"[train-families] phase wall {time.perf_counter() - t_phase:.1f} "
        f"s; {smi}")
    return fwd, bwd


#: Zamba2-7B-Instruct's published hybrid as the benchmark trains it (the
#: first of four pipeline stages, 24 layers, 2.73 G parameters), at one
#: row of the cell's 4096 tokens: the flash launches a step do not depend
#: on the batch, and one row leaves room beside what the phases before
#: left in the allocator
ZAMBA2_7B, ZAMBA2_7B_B, ZAMBA2_7B_S = "zamba2-7b-instruct", 1, 4096


def phase_train_zamba2_7b(launches, smi):
    """``build_train_step`` of ``ZAMBA2_7B`` at its published widths: one
    step to warm up, then, the counters zeroed just before, one step
    that launches exactly one flash forward and one backward a
    shared-block call (4 + 4: the block runs outside the remat), every
    one ``"tc"`` at dh 224, nothing else of the flash kernels; its loss
    and gradient norm finite.  Returns the step's flash forward and
    backward launches."""
    from repro_torch import configs, tree as T
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import _build
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import api
    from repro_torch.optim import OptConfig, opt_init
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    spec = configs.get(ZAMBA2_7B)
    cfg = spec.cfg
    calls = len(cfg.hybrid_layer_ids)
    params = api.init(torch.Generator(device="cuda").manual_seed(0), spec)
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=ZAMBA2_7B_S,
                                   global_batch=ZAMBA2_7B_B, seed=0),
                        device="cuda").batch(0)
    opt_cfg = OptConfig()
    step = build_train_step(spec, opt_cfg)
    state = opt_init(params, opt_cfg)
    params, state, _ = step(params, state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches.clear()
    _build.VARIANTS.clear()
    t0 = time.perf_counter()
    params, state, stats = step(params, state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: n for k, n in launches.items() if k.startswith("flash")}
    want = {"flash_attention": calls, "flash_attention_bwd": calls}
    got_v = {k: n for k, n in variant_counts().items()
             if k[0].startswith("flash")}
    if counts != want or got_v != {(k, "tc"): n for k, n in want.items()}:
        raise AssertionError(f"train {ZAMBA2_7B}: flash launches {counts}, "
                             f"variants {got_v}, want {want} all tc")
    loss, gnorm = float(stats["loss"]), float(stats["grad_norm"])
    if not (np.isfinite(loss) and np.isfinite(gnorm)):
        raise AssertionError(f"train {ZAMBA2_7B}: loss {loss}, grad norm "
                             f"{gnorm}")
    n_params = sum(x.numel() for x in T.leaves(params))
    log(f"[train-zamba2-7b] {ZAMBA2_7B} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, hybrid layers {list(cfg.hybrid_layer_ids)} on "
        f"{cfg.num_mem_blocks} tied blocks, {cfg.n_heads} heads of "
        f"{cfg.head_dim}; {n_params} parameters), build_train_step at "
        f"{ZAMBA2_7B_B} x {ZAMBA2_7B_S}: one step after the warm-up "
        f"launched {counts} (one forward and one backward a shared-block "
        f"call), every one tc; loss {loss:.4f}, grad norm {gnorm:.3f}; "
        f"step wall {wall:.2f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s; {smi}")
    del params, state, stats, batch, step
    torch.cuda.empty_cache()
    return counts["flash_attention"], counts["flash_attention_bwd"]


# ------------------------------------------------------- phases 20-23
#: the moe family served at full width, each cut in depth to what one
#: card's 80 GB holds: (arch, layers kept).  dbrx-132b's layer is 3.26 G
#: parameters (6.5 GB in bf16) and its embedding 1.23 GB; kimi-k2's layer
#: 17.05 G (34.1 GB) and its embedding 2.35 GB
SERVE_MOE = (("dbrx-132b", 8), ("kimi-k2", 1))
#: the depth at which each one's prefill is also run in fp32 (the weights
#: upcast), the anchor of the end to end when routing flips: dbrx's 2
#: layers take 29 GB in fp32, kimi-k2's one 73 GB
MOE_FP32_LAYERS = {"dbrx-132b": 2, "kimi-k2": 1}
#: the three dispatches against each other on one layer's real input:
#: the JAX tests' tolerance for the dispatch variants
#: (tests/test_perf_variants.py), bf16 outputs
DISPATCH_TOL = 3e-2
#: training the moe family: dbrx-132b at one layer, with the
#: memory-scaled AdamW (bf16 m, factored v): fp32 m and v, with the
#: functional update's new trees, would pass 80 GB even at one layer.
#: kimi-k2's parameters and their gradients alone pass 72 GB at one layer:
#: its training is held on the CPU at reduced size
TRAIN_MOE, TRAIN_MOE_LAYERS, TRAIN_STEPS_NEW = "dbrx-132b", 1, 3


def cut(spec, n_layers, tag):
    """``spec`` with ``n_layers`` layers (widths, heads, experts, top_k,
    capacity and vocabulary unchanged); logs the cut."""
    log(f"{tag} {spec.name} reduced: n_layers {spec.cfg.n_layers} → "
        f"{n_layers} (one card's 80 GB)")
    return replace(spec, cfg=replace(spec.cfg, n_layers=n_layers))


@contextlib.contextmanager
def recorded(module, name, record, pick):
    """Run the enclosed code with ``module.name`` wrapped: ``record`` gets
    ``pick(args, result)`` of every call."""
    real = getattr(module, name)

    def rec(*a):
        out = real(*a)
        record.append(pick(a, out))
        return out

    setattr(module, name, rec)
    try:
        yield
    finally:
        setattr(module, name, real)


def routes(record):
    """Every MoE routing of the enclosed run: its experts (G, g, k)."""
    from repro_torch.models import moe
    return recorded(moe, "_route", record, lambda a, out: out[1])


def flips(a, b):
    """Tokens whose set of experts differs between two runs' routings."""
    if len(a) != len(b):
        raise AssertionError(f"{len(a)} routings against {len(b)}")
    return sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
               for x, y in zip(a, b))


def to_fp32_in_place(tree):
    """Every bf16 leaf of ``tree`` (nested dicts) replaced by its fp32
    copy, the largest first, each bf16 leaf dropped once its copy exists:
    the peak is about twice the tree's bf16 bytes plus the smallest leaf,
    where a whole copy would hold three times."""
    from repro_torch import tree as T
    order = sorted(((p, x.numel()) for p, x in T.leaves_with_paths(tree)),
                   key=lambda pn: -pn[1])
    for path, _ in order:
        node = tree
        for key in path[:-1]:
            node = node[key]
        if node[path[-1]].dtype == torch.bfloat16:
            node[path[-1]] = node[path[-1]].float()


def moe_dispatch_check(lp, cfg, x, tag):
    """The three dispatches on one layer's real input ``x`` at the config's
    own capacity (drops included): each within ``DISPATCH_TOL`` of the
    one-hot one, two calls of each bit-equal under deterministic
    algorithms; ``aux_load_balance_loss`` on the card against the CPU's on
    the same input.  Returns a line to log."""
    from repro_torch.launch.steps import deterministic
    from repro_torch.models import moe
    xg, g = moe._group(x, cfg)
    G, C = xg.shape[0], moe._capacity(cfg, g)
    _, topi = moe._route(lp, cfg, xg)
    onehot, rank = moe._onehot_ranks(topi, cfg.n_experts)
    dropped = int(((rank >= C) & (onehot > 0)).sum())
    outs, reads = {}, []
    with torch.inference_mode(), deterministic():
        for d in ("onehot", "sort", "scatter"):
            c = replace(cfg, dispatch=d)
            a, b = moe.moe_apply(lp, c, x), moe.moe_apply(lp, c, x)
            if not torch.equal(a, b):
                raise AssertionError(f"{tag} dispatch {d}: two calls differ")
            outs[d] = a
        for d in ("sort", "scatter"):
            err = close(outs[d], outs["onehot"], DISPATCH_TOL,
                        f"{tag} {d} vs onehot")
            reads.append(f"{d} {err:.3e}")
        aux = moe.aux_load_balance_loss(lp, cfg, x).item()
    aux_cpu = moe.aux_load_balance_loss(
        {"router": lp["router"].cpu()}, cfg, x.cpu()).item()
    if not abs(aux - aux_cpu) <= 1e-4 * abs(aux_cpu):
        raise AssertionError(f"{tag} aux loss card {aux}, CPU {aux_cpu}")
    return (f"the three dispatches on layer 0's input ({G} groups of {g}, "
            f"capacity {C}, {dropped} of {topi.numel()} (token, choice) "
            f"pairs dropped): each twice bit-equal under deterministic "
            f"algorithms, against onehot max abs {', '.join(reads)} (tol "
            f"{DISPATCH_TOL}); aux_load_balance_loss card {aux:.6f}, CPU "
            f"{aux_cpu:.6f}")


def moe_anchor(params, spec, prompt, P, G, depth, kernel, plain):
    """The moe prefill's end to end held to fp32 at ``depth`` layers (the
    first ``depth`` of ``params``): the kernel's logits and caches no
    farther from the fp32 prefill (the weights upcast, the plain
    attention) than the plain attention's plus ``LM_REL_TOL``.  ``kernel``
    and ``plain`` are the (logits, state) of the two bf16 prefills when
    ``depth`` is the served depth, else None (they are run here).  Frees
    ``params``; returns a line to log."""
    from repro_torch import tree as T
    torch.cuda.empty_cache()
    if kernel is None:
        small = {k: v for k, v in params.items() if k != "layers"}
        small["layers"] = T.tree_map(lambda t: t[:depth].clone(),
                                     params["layers"])
        params.clear()
        torch.cuda.empty_cache()
        params = small
        spec = replace(spec, cfg=replace(spec.cfg, n_layers=depth))
        rk, rp = [], []
        with routes(rk):
            kernel = prefill(params, spec, prompt, P + G)[:2]
        with plain_attention(), routes(rp):
            plain = prefill(params, spec, prompt, P + G)[:2]
        n_flip = flips(rk, rp)
    else:
        n_flip = None
    to_fp32_in_place(params)
    r32 = []
    with plain_attention(), compute_dtype(torch.float32), routes(r32):
        l32, s32, _ = prefill(params, spec, prompt, P + G)
    params.clear()
    (lk, sk), (lp, sp) = kernel, plain
    anchored = [(rel_err(lk, l32), rel_err(lp, l32)),
                (state_rel(sk, s32), state_rel(sp, s32))]
    if any(k > p + LM_REL_TOL for k, p in anchored):
        raise AssertionError(f"{spec.name} at {depth} layers, from fp32 "
                             f"(kernel, plain): {anchored}")
    return (f"at {depth} layer(s) from the fp32 prefill, kernel / plain: "
            f"logits {anchored[0][0]:.3e} / {anchored[0][1]:.3e}, caches "
            f"{anchored[1][0]:.3e} / {anchored[1][1]:.3e} (the kernel within "
            f"the plain's + {LM_REL_TOL})"
            + ("" if n_flip is None else
               f", {n_flip} routing flips between the two bf16 prefills"))


def phase_serve_moe(launches, smi):
    """``[serve-moe]``: each of ``SERVE_MOE`` at full width, cut in depth,
    random bf16 weights from seed 0, served through ``build_serve_step``
    as ``serve.main`` runs it (batch 4, a 512-token prompt, 32 new
    tokens), a flash launch a layer in the prefill, every one ``"tc"``;
    the prefill with every flash call held to its plain version, against
    the plain attention end to end (routing flips counted; the direct
    ``LM_REL_TOL`` bound held where no token flipped) and against fp32 at
    ``MOE_FP32_LAYERS``; the three dispatches and the load-balance loss on
    layer 0's input; profiles of a prefill and of three decode steps.
    Returns the flash launches a prefill by architecture."""
    from repro_torch import configs, tree as T
    from repro_torch.kernels import _build
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models import api, transformer
    from repro_torch.models.layers import layer_params
    t_phase = time.perf_counter()
    B, P, G = 4, FAMILY_PROMPT, FAMILY_GEN
    out = {}
    for arch, depth in SERVE_MOE:
        spec = cut(configs.get(arch), depth, "[serve-moe]")
        cfg = spec.cfg
        n_flash = flash_per_prefill(spec)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = api.init(torch.Generator(device="cuda").manual_seed(0),
                          spec)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(x.numel() for x in T.leaves(params))
        if n_params != cfg.param_count():
            raise AssertionError(f"{arch}: {n_params} parameters, "
                                 f"param_count() {cfg.param_count()}")
        # the serving CLI's sequence: prompt from the seed, one prefill
        # step at cache index 0, then one token at a time
        prompt = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab, (B, P)), device="cuda")
        step = build_serve_step(spec)
        state = api.decode_state(spec, B, P + G)
        launches.clear()
        _build.VARIANTS.clear()
        t0 = time.perf_counter()
        tok, state = step(params, state, prompt, 0)
        torch.cuda.synchronize()
        pre_wall = (time.perf_counter() - t0) * 1e3
        expect_launches(launches, n_flash, f"serve {arch} prefill")
        launches.clear()
        _build.VARIANTS.clear()
        toks = []
        t0 = time.perf_counter()
        for i in range(G):
            tok, state = step(params, state, tok[:, None], P + i)
            toks.append(tok)
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t0) / G * 1e3
        expect_launches(launches, 0, f"serve {arch} decode")
        gen = torch.stack(toks, 1)
        if gen.shape != (B, G) or gen.min() < 0 or gen.max() >= cfg.vocab:
            raise AssertionError(f"serve {arch}: tokens {gen.shape}")
        del state
        out[arch] = n_flash

        # the prefill: every flash call against its plain version, the
        # end to end against the plain attention, routing flips counted
        errs, rk, rp, x0 = [], [], [], []
        with per_layer_check(errs), routes(rk), recorded(
                transformer, "moe_apply", x0, lambda a, _: a[2]):
            lk, sk, _ = prefill(params, spec, prompt, P + G)
        if len(errs) != n_flash:
            raise AssertionError(f"prefill {arch}: {len(errs)} flash calls")
        with plain_attention(), routes(rp):
            lp, sp, p_ms = prefill(params, spec, prompt, P + G)
        n_flip = flips(rk, rp)
        logit_rel, st_rel = rel_err(lk, lp), state_rel(sk, sp)
        direct = logit_rel <= LM_REL_TOL and st_rel <= LM_REL_TOL
        if not direct and n_flip == 0:
            raise AssertionError(f"prefill {arch}: logits relative error "
                                 f"{logit_rel}, caches {st_rel}, no "
                                 f"routing flip")
        agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
        dispatch = moe_dispatch_check(
            layer_params(params["layers"], 0)["moe"], cfg.moe, x0[0],
            f"[serve-moe] {arch}")
        del x0, rk, rp

        # profiles: one prefill, three decode steps
        _, _, k_ms = prefill(params, spec, prompt, P + G)
        pre = device_profile(lambda: prefill(params, spec, prompt, P + G))
        state = api.decode_state(spec, B, P + G)
        step(params, state, prompt, 0)

        def three_steps():
            t = tok
            for i in range(3):
                t, _ = step(params, state, t[:, None], P + i)

        dec = device_profile(three_steps)
        del state
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        n_tok = B * P * depth
        log(f"[serve-moe] {arch} ({depth} of {configs.get(arch).cfg.n_layers}"
            f" layers, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv} heads "
            f"of {cfg.dh}, {cfg.moe.n_experts} experts top-{cfg.moe.top_k} of "
            f"d_ff {cfg.moe.d_ff}, capacity factor "
            f"{cfg.moe.capacity_factor}, vocab {cfg.vocab}; {n_params} "
            f"parameters, drawn in {init_s:.1f} s) B={B} P={P}: "
            f"{gen.shape} tokens in [0, {cfg.vocab}); {n_flash} flash "
            f"launches a prefill, all tc, none in decode; each flash output "
            f"within {LAYER_TOL} of the plain version (max "
            f"{max(errs):.3e}); vs the plain attention end to end: logits "
            f"relative {logit_rel:.3e}, caches relative <= {st_rel:.3e} (tol "
            f"{LM_REL_TOL}, {'held' if direct else 'passed by flips'}), "
            f"{n_flip} of {n_tok} (token, layer) routings flipped, greedy "
            f"agreement {agree:.2f}; {dispatch}; prefill wall {pre_wall:.1f} "
            f"ms (serve step), {k_ms:.1f} ms with the kernel, {p_ms:.1f} ms "
            f"with the plain attention; decode {dec_ms:.2f} ms a step "
            f"({B / dec_ms * 1e3:.1f} tok/s); peak memory {peak_gb:.1f} GB; "
            f"{smi}")
        log(f"[profile] {arch} prefill P={P}: device {pre[0]:.2f} ms, "
            f"{pre[1]} launches, busy {pre[0] / k_ms:.2f} of the unprofiled "
            f"{k_ms:.1f} ms; top: {pre[2]}")
        log(f"[profile] {arch} decode: device {dec[0] / 3:.2f} ms and "
            f"{dec[1] / 3:.0f} launches a step, busy "
            f"{dec[0] / 3 / dec_ms:.2f} of the unprofiled {dec_ms:.2f} ms; "
            f"top over 3 steps: {dec[2]}")
        fp32_depth = MOE_FP32_LAYERS[arch]
        same = fp32_depth == depth
        line = moe_anchor(params, spec, prompt, P, G, fp32_depth,
                          (lk, sk) if same else None,
                          (lp, sp) if same else None)
        log(f"[serve-moe] {arch} {line}")
        del params, lk, sk, lp, sp, tok, toks
        torch.cuda.empty_cache()
    log(f"[serve-moe] phase wall {time.perf_counter() - t_phase:.1f} s; "
        f"{smi}")
    return out


def train_vs_plain(spec, params, batch, prefix, n_fwd, n_bwd):
    """One step's loss and gradients with the flash kernel, every flash
    call held to its plain version on the same inputs (``LAYER_TOL``,
    ``BWD_TOL``; ``n_fwd`` and ``n_bwd`` calls), against the same step
    with the plain attention, routing flips between the two counted.
    Where no token's routing flipped, the loss and every gradient leaf
    within ``TRAIN_LOSS_TOL`` and ``TRAIN_GRAD_TOL`` of the plain step's;
    where some did (a flipped token's experts, and so its gradient, change
    outright), both steps against the step in fp32 (the weights upcast,
    the plain attention): the kernel's loss and whole gradient no farther
    from it than the plain attention's plus the same tolerances, as
    ``step_vs_plain_fp32`` holds the hybrid."""
    from repro_torch import tree as T
    from repro_torch.launch.steps import build_loss_and_grads, deterministic
    loss_and_grads = build_loss_and_grads(spec)
    ferrs, berrs, rk, rp = [], [], [], []
    with per_layer_check(ferrs), bwd_call_check(berrs), routes(rk), \
            deterministic():
        lk, gk = loss_and_grads(params, batch)
    with plain_attention(), routes(rp), deterministic():
        lp, gp = loss_and_grads(params, batch)
    if len(ferrs) != n_fwd or len(berrs) != n_bwd:
        raise AssertionError(f"{prefix} {spec.name}: {len(ferrs)} flash "
                             f"forwards, {len(berrs)} backwards checked, "
                             f"want {n_fwd} and {n_bwd}")
    n_flip = flips(rk, rp)
    loss_rel = abs(lk.item() - lp.item()) / abs(lp.item())
    rels = rel_leaves(gk, gp)
    worst = max(rels.items(), key=lambda kv: kv[1])
    direct = loss_rel <= TRAIN_LOSS_TOL and worst[1] <= TRAIN_GRAD_TOL
    if not direct and n_flip == 0:
        raise AssertionError(f"{prefix} {spec.name} step vs plain attention:"
                             f" loss {loss_rel}, gradients {rels}")
    line = (f"{prefix} {spec.name} step: {n_fwd} flash forwards within "
            f"{LAYER_TOL} of the plain version (max {max(ferrs):.3e}), "
            f"{n_bwd} backwards within {BWD_TOL[torch.bfloat16]} of each "
            f"gradient's magnitude (max {max(berrs):.3e}); vs the plain "
            f"attention: loss {lk.item():.5f} vs {lp.item():.5f} (relative "
            f"{loss_rel:.2e}), gradient leaves relative Frobenius <= "
            f"{worst[1]:.2e} ({worst[0]}) (tol {TRAIN_LOSS_TOL} / "
            f"{TRAIN_GRAD_TOL}, {'held' if direct else 'passed by flips'})"
            + (f", {n_flip} of {sum(r.numel() // r.shape[-1] for r in rk)} "
               f"token routings flipped" if rk else ""))
    if n_flip:
        p32 = T.tree_map(lambda t: t.float(), params)
        with plain_attention(), compute_dtype(torch.float32), \
                deterministic():
            l32, g32 = loss_and_grads(p32, batch)
        del p32
        dk, dp = abs(lk.item() - l32.item()), abs(lp.item() - l32.item())
        ek, ep = global_rel(gk, g32), global_rel(gp, g32)
        if not (dk <= dp + TRAIN_LOSS_TOL * abs(l32.item())
                and ek <= ep + TRAIN_GRAD_TOL):
            raise AssertionError(f"{prefix} {spec.name} against fp32: loss "
                                 f"kernel {lk.item()}, plain {lp.item()}, "
                                 f"fp32 {l32.item()}; gradient kernel {ek}, "
                                 f"plain {ep}")
        line += (f"; against the fp32 step: loss kernel {lk.item():.5f}, "
                 f"plain {lp.item():.5f}, fp32 {l32.item():.5f}, whole "
                 f"gradient relative kernel {ek:.3e}, plain {ep:.3e} (the "
                 f"kernel within the plain's + {TRAIN_GRAD_TOL})")
        del g32
    log(line)


def train_steps(launches, spec, step, params, opt_state, batches, want,
                prefix, smi):
    """``len(batches)`` train steps, each launching exactly ``want``, every
    flash launch the tensor-core variant, every loss and norm finite and
    every gradient leaf non-zero in every layer.  Returns (params,
    opt_state)."""
    from repro_torch.kernels import _build
    losses, walls = [], []
    for i, batch in enumerate(batches):
        launches.clear()
        _build.VARIANTS.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, st = step(params, opt_state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if dict(launches) != want or variant_counts() != {
                (k, "tc"): v for k, v in want.items()}:
            raise AssertionError(f"{prefix} {spec.name} step {i}: launches "
                                 f"{dict(launches)}, variants "
                                 f"{variant_counts()}, want {want} all "
                                 f"tc")
        loss, gnorm = st["loss"].item(), st["grad_norm"].item()
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError(f"{prefix} {spec.name} step {i}: loss "
                                 f"{loss}, grad norm {gnorm}")
        norms, lo = nonzero_grad_norms(st, f"{prefix} {spec.name} step {i}")
        losses.append((round(loss, 4), round(gnorm, 3)))
        del st
    log(f"{prefix} {spec.name} {len(batches)} steps: (loss, grad norm) "
        f"{losses}; walls {', '.join(f'{w:.0f}' for w in walls)} ms; "
        f"launches a step {want}, every one tc; every gradient leaf "
        f"finite and non-zero in every layer ({len(norms)} leaves; smallest "
        f"{lo[0]} {lo[1].min().item():.3e}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB; {smi}")
    return params, opt_state


def phase_train_moe(launches, smi):
    """``[train-moe]``: dbrx-132b at full width, cut to
    ``TRAIN_MOE_LAYERS``, ``TRAIN_STEPS_NEW`` steps of 8 x 512 through
    ``build_train_step`` with ``OptConfig(mode="adamw_lite")``: 2 flash
    forwards (``dots``) and 1 backward a layer a step, all ``"tc"`` (GQA
    ratio 6); every gradient leaf non-zero (the router's too); the step
    against the plain attention, every flash call against its plain
    version; a profiled step; a bit-exact resume at ``--reduced``.
    Returns the flash forward and backward launches of the steps."""
    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import api
    from repro_torch.optim import OptConfig, opt_init
    t_phase = time.perf_counter()
    spec = cut(configs.get(TRAIN_MOE), TRAIN_MOE_LAYERS, "[train-moe]")
    cfg = spec.cfg
    n = flash_per_prefill(spec)
    want = {"flash_attention": 2 * n, "flash_attention_bwd": n}
    torch.cuda.reset_peak_memory_stats()
    params = api.init(torch.Generator(device="cuda").manual_seed(0), spec)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                  global_batch=TRAIN_B, seed=0),
                       device="cuda")
    opt_cfg = OptConfig(mode="adamw_lite")
    step = build_train_step(spec, opt_cfg)
    log(f"[train-moe] {spec.name} ({cfg.n_layers} layer, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv} heads (GQA "
        f"{cfg.n_heads // cfg.n_kv}), {cfg.moe.n_experts} experts top-"
        f"{cfg.moe.top_k}, vocab {cfg.vocab}; {cfg.param_count()} "
        f"parameters), {TRAIN_STEPS_NEW} steps of {TRAIN_B} x {TRAIN_S}, "
        f"OptConfig(mode='adamw_lite'); kimi-k2 is not trained on the card "
        f"(its parameters and their gradients alone pass 72 GB at one "
        f"layer; its training is held on the CPU at reduced size)")
    params, opt_state = train_steps(
        launches, spec, step, params, opt_init(params, opt_cfg),
        [data.batch(i) for i in range(TRAIN_STEPS_NEW)], want,
        "[train-moe]", smi)
    del opt_state
    batch = data.batch(TRAIN_STEPS_NEW)
    train_vs_plain(spec, params, batch, "[train-moe]", 2 * n, n)
    torch.cuda.reset_peak_memory_stats()
    profile_train_step(spec, step, params, opt_init(params, opt_cfg), batch,
                       smi)
    log(f"[train-moe] peak memory of the profiled steps "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    del params, batch
    torch.cuda.empty_cache()
    check_resume(launches, TRAIN_MOE, "[train-moe]")
    log(f"[train-moe] phase wall {time.perf_counter() - t_phase:.1f} s; "
        f"{smi}")
    return TRAIN_STEPS_NEW * want["flash_attention"], \
        TRAIN_STEPS_NEW * want["flash_attention_bwd"]


def audio_prefill(params, spec, frames, prompt, max_seq):
    """Encode ``frames``, the decoder layers' cross K/V from it, and the
    serving prefill step against them: (last-position logits, state, ms)."""
    from repro_torch.models import api, encdec
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        enc = encdec.encode(params, spec.cfg, frames)
        state = api.decode_state(spec, prompt.shape[0], max_seq)
        state["cross"] = encdec.cross_kv(params, spec.cfg, enc)
        logits, state = api.apply_decode(params, spec, prompt, state, 0)
    torch.cuda.synchronize()
    return logits[:, -1].clone(), state, (time.perf_counter() - t0) * 1e3


def phase_serve_audio(launches, smi):
    """``[serve-audio]``: whisper-medium uncut through ``serve.main``
    (batch 4, a 512-token prompt, 32 new tokens, the zeroed cross K/V):
    48 flash launches a prefill (24 causal self-attentions, 24 cross), all
    ``"tc"``; then ``encode`` of frames (4, 1500, 1024) from seed 0,
    ``cross_kv`` and the prefill against them: 24 more (full 1500 x 1500),
    each flash call within ``LAYER_TOL`` of its plain version, the end to
    end (logits, KV caches and cross K/V) within ``LM_REL_TOL`` of the
    plain attention and no farther from fp32 than it plus ``LM_REL_TOL``;
    profiles.  Returns the flash launches (prefill, encoder)."""
    from repro_torch import configs, tree as T
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models import api
    t_phase = time.perf_counter()
    B, P, G = 4, FAMILY_PROMPT, FAMILY_GEN
    spec = configs.get("whisper-medium")
    cfg = spec.cfg
    n_flash = flash_per_prefill(spec)
    torch.cuda.reset_peak_memory_stats()
    launches.clear()
    _build.VARIANTS.clear()
    t0 = time.perf_counter()
    gen = serve.main(["--arch", spec.name, "--batch", str(B), "--prompt-len",
                      str(P), "--gen", str(G), "--seed", "0"])
    wall = time.perf_counter() - t0
    expect_launches(launches, n_flash, "serve whisper-medium")
    if gen.shape != (B, G) or gen.min() < 0 or gen.max() >= cfg.vocab:
        raise AssertionError(f"serve whisper: tokens {gen.shape}")

    params = api.init(torch.Generator(device="cuda").manual_seed(0), spec)
    n_params = sum(x.numel() for x in T.leaves(params))
    if n_params != cfg.param_count():
        raise AssertionError(f"whisper: {n_params} parameters")
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, P)), device="cuda")
    frames = torch.randn((B, cfg.enc_len, cfg.d_model), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(0)).bfloat16()
    errs = []
    launches.clear()
    _build.VARIANTS.clear()
    with per_layer_check(errs):
        lk, sk, _ = audio_prefill(params, spec, frames, prompt, P + G)
    n_enc = cfg.n_layers
    expect_launches(launches, n_enc + n_flash, "whisper encode + prefill")
    if len(errs) != n_enc + n_flash:
        raise AssertionError(f"whisper: {len(errs)} flash calls checked")
    with plain_attention():
        lp, sp, p_ms = audio_prefill(params, spec, frames, prompt, P + G)
        p32 = T.tree_map(lambda t: t.float(), params)
        with compute_dtype(torch.float32):
            l32, s32, _ = audio_prefill(p32, spec, frames.float(), prompt,
                                        P + G)
        del p32
    logit_rel, st_rel = rel_err(lk, lp), state_rel(sk, sp)
    anchored = [(rel_err(lk, l32), rel_err(lp, l32)),
                (state_rel(sk, s32), state_rel(sp, s32))]
    if not (logit_rel <= LM_REL_TOL and st_rel <= LM_REL_TOL) or any(
            k > p + LM_REL_TOL for k, p in anchored):
        raise AssertionError(f"whisper prefill: logits relative {logit_rel}, "
                             f"states {st_rel}; from fp32 {anchored}")
    agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    del lp, sp, l32, s32
    _, _, k_ms = audio_prefill(params, spec, frames, prompt, P + G)
    pre = device_profile(lambda: audio_prefill(params, spec, frames, prompt,
                                               P + G))
    step = build_serve_step(spec)
    tok, state = lk.argmax(-1).to(torch.int32), sk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(G):
        tok, state = step(params, state, tok[:, None], P + i)
    torch.cuda.synchronize()
    dec_ms = (time.perf_counter() - t0) / G * 1e3

    def three_steps():
        t = tok
        for i in range(3):
            t, _ = step(params, state, t[:, None], P + G - 3 + i)

    dec = device_profile(three_steps)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[serve-audio] whisper-medium ({cfg.n_layers} + {cfg.n_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv} heads of "
        f"{cfg.d_model // cfg.n_heads}, enc_len {cfg.enc_len}, vocab "
        f"{cfg.vocab}; {n_params} parameters, uncut) B={B} P={P}: "
        f"serve.main {gen.shape} tokens in [0, {cfg.vocab}) against the "
        f"zeroed cross K/V, wall {wall:.1f} s, {n_flash} flash launches a "
        f"prefill ({cfg.n_layers} causal self, {cfg.n_layers} cross {P} x "
        f"{cfg.enc_len}), all tc; with frames ({B}, {cfg.enc_len}, "
        f"{cfg.d_model}): encode + cross_kv + prefill {n_enc} + {n_flash} "
        f"launches (the encoder's full {cfg.enc_len} x {cfg.enc_len}), all "
        f"tc, each within {LAYER_TOL} of the plain version (max "
        f"{max(errs):.3e}); vs the plain attention end to end: logits "
        f"relative {logit_rel:.3e}, states (KV caches, cross K/V) relative "
        f"<= {st_rel:.3e} (tol {LM_REL_TOL}), greedy agreement {agree:.2f}; "
        f"from the fp32 prefill, kernel / plain: logits "
        f"{anchored[0][0]:.3e} / {anchored[0][1]:.3e}, states "
        f"{anchored[1][0]:.3e} / {anchored[1][1]:.3e}; encode + prefill "
        f"{k_ms:.1f} ms ({p_ms:.1f} with the plain attention), decode "
        f"{dec_ms:.2f} ms a step ({B / dec_ms * 1e3:.1f} tok/s); peak memory "
        f"{peak_gb:.1f} GB; {smi}")
    log(f"[profile] whisper-medium encode + prefill P={P}: device "
        f"{pre[0]:.2f} ms, {pre[1]} launches, busy {pre[0] / k_ms:.2f} of "
        f"the unprofiled {k_ms:.1f} ms; top: {pre[2]}")
    log(f"[profile] whisper-medium decode: device {dec[0] / 3:.2f} ms and "
        f"{dec[1] / 3:.0f} launches a step, busy {dec[0] / 3 / dec_ms:.2f} "
        f"of the unprofiled {dec_ms:.2f} ms; top over 3 steps: {dec[2]}")
    del params, state, sk, lk, tok, frames
    torch.cuda.empty_cache()
    log(f"[serve-audio] phase wall {time.perf_counter() - t_phase:.1f} s; "
        f"{smi}")
    return n_flash, n_enc


def audio_batch(spec, step, B, S, device):
    """A training batch of the audio family: the synthetic token stream's
    batch ``step`` (B x S) and fp32 frames (B, enc_len, d_model) drawn
    from ``step`` on ``device``."""
    from repro_torch.data import DataConfig, SyntheticLM
    cfg = spec.cfg
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S,
                                   global_batch=B, seed=0),
                        device=device).batch(step)
    batch["frames"] = torch.randn(
        (B, cfg.enc_len, cfg.d_model), device=device,
        generator=torch.Generator(device=device).manual_seed(step))
    return batch


def check_resume_manager(spec, prefix, make_batch):
    """``spec`` reduced, on the card: 12 AdamW steps (batch 8 x 64, each
    ``make_batch(small, step, 8, 64, "cuda")``) uninterrupted, against 8
    steps checkpointed every 4 by ``CheckpointManager``, restored into
    fresh trees and run to 12: the same parameters and optimizer state,
    bit for bit (the train CLI refuses the audio and vlm families, as the
    JAX CLI does)."""
    import tempfile
    from repro_torch import configs, tree as T
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import api
    from repro_torch.optim import OptConfig, opt_init
    small = configs.reduced(spec)
    opt_cfg = OptConfig()
    step = build_train_step(small, opt_cfg)

    def run(params, opt, lo, hi, mgr=None):
        for i in range(lo, hi):
            params, opt, _ = step(params, opt,
                                  make_batch(small, i, 8, 64, "cuda"))
            if mgr:
                mgr.maybe_save(i + 1, {"params": params, "opt": opt})
        return params, opt

    def fresh(seed):
        p = api.init(torch.Generator(device="cuda").manual_seed(seed), small)
        return p, opt_init(p, opt_cfg)

    a = run(*fresh(0), 0, 12)
    with tempfile.TemporaryDirectory() as ck:
        mgr = CheckpointManager(ck, every=4)
        run(*fresh(0), 0, 8, mgr)
        p, o = fresh(1)
        restored, start = mgr.resume({"params": p, "opt": o})
        if start != 8:
            raise AssertionError(f"{prefix} resume from step {start}")
        b = run(restored["params"], restored["opt"], 8, 12)
    diff = [k for (k, x), (_, y) in zip(T.leaves_with_paths(a),
                                       T.leaves_with_paths(b))
            if not (x.dtype == y.dtype and torch.equal(
                x.reshape(-1).view(torch.uint8),
                y.reshape(-1).view(torch.uint8)))]
    if diff:
        raise AssertionError(f"{prefix} resume: trees differ at {diff}")
    log(f"{prefix} {spec.name} resume at reduced size (8 x 64): 8 steps "
        f"checkpointed every 4, restored into fresh trees at step 8 and run "
        f"to 12: parameters and optimizer state equal to the uninterrupted "
        f"run's bit for bit")


def phase_train_audio(launches, smi):
    """``[train-audio]``: whisper-medium uncut, ``TRAIN_STEPS_NEW`` AdamW
    steps of 8 x 512 tokens with frames (8, 1500, 1024) through
    ``build_train_step``: 144 flash forwards (the 72 attentions, twice
    under ``dots``) and 72 backwards a step, all ``"tc"``; every gradient
    leaf non-zero; the step against the plain attention, every flash call
    against its plain version; a profiled step; a bit-exact resume through
    ``CheckpointManager`` at reduced size.  Returns the flash forward and
    backward launches of the steps."""
    from repro_torch import configs
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import api
    from repro_torch.optim import OptConfig, opt_init
    t_phase = time.perf_counter()
    spec = configs.get("whisper-medium")
    n = 3 * spec.cfg.n_layers
    want = {"flash_attention": 2 * n, "flash_attention_bwd": n}
    torch.cuda.reset_peak_memory_stats()
    params = api.init(torch.Generator(device="cuda").manual_seed(0), spec)
    opt_cfg = OptConfig()
    step = build_train_step(spec, opt_cfg)
    log(f"[train-audio] whisper-medium uncut ({spec.cfg.param_count()} "
        f"parameters), {TRAIN_STEPS_NEW} AdamW steps of {TRAIN_B} x "
        f"{TRAIN_S} tokens with frames ({TRAIN_B}, {spec.cfg.enc_len}, "
        f"{spec.cfg.d_model})")
    params, opt_state = train_steps(
        launches, spec, step, params, opt_init(params, opt_cfg),
        [audio_batch(spec, i, TRAIN_B, TRAIN_S, "cuda")
         for i in range(TRAIN_STEPS_NEW)], want, "[train-audio]", smi)
    batch = audio_batch(spec, TRAIN_STEPS_NEW, TRAIN_B, TRAIN_S, "cuda")
    train_vs_plain(spec, params, batch, "[train-audio]", 2 * n, n)
    torch.cuda.reset_peak_memory_stats()
    profile_train_step(spec, step, params, opt_state, batch, smi)
    log(f"[train-audio] peak memory of the profiled steps "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    del params, opt_state, batch
    torch.cuda.empty_cache()
    check_resume_manager(spec, "[train-audio]", audio_batch)
    log(f"[train-audio] phase wall {time.perf_counter() - t_phase:.1f} s; "
        f"{smi}")
    return TRAIN_STEPS_NEW * want["flash_attention"], \
        TRAIN_STEPS_NEW * want["flash_attention_bwd"]


# ------------------------------------------------------- phases 24-25
#: paligemma-3b served: the image prefix of ``n_patches`` (256) and text
#: behind it, 512 positions in all (a multiple of 256, so ``ops.tile_ok``
#: gives the flash kernel); the shorter text of 200 makes 456 positions,
#: which it refuses (the plain attention, no launch), as the JAX rule does
VLM_TEXT = (256, 200)


def vlm_prefill(params, spec, patches, text, max_seq):
    """The image-and-text prefill: ``vlm.forward`` of ``patches`` and the
    ``text`` tokens with the KV caches at cache index 0: (last-position
    logits, state, ms)."""
    from repro_torch.models import api, vlm
    state = api.decode_state(spec, text.shape[0], max_seq)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits, kv = vlm.forward(params, spec.cfg, text, patches,
                                 kv_caches=state["kv"], cache_index=0)
    torch.cuda.synchronize()
    return logits[:, -1].clone(), {"kv": kv}, (time.perf_counter() - t0) * 1e3


def vlm_batch(spec, step, B, S, device):
    """A training batch of the vlm family from numpy seed ``step``: tokens
    and labels (B, S) in the LM's vocabulary, patches (B, n_patches,
    d_vision) fp32."""
    cfg = spec.cfg
    rng = np.random.default_rng(step)
    tokens, labels = (torch.as_tensor(rng.integers(0, cfg.lm.vocab, (B, S)),
                                      device=device) for _ in range(2))
    patches = rng.standard_normal((B, cfg.n_patches, cfg.d_vision),
                                  dtype=np.float32)
    return {"tokens": tokens, "labels": labels,
            "patches": torch.from_numpy(patches).to(device)}


def phase_serve_vlm(launches, smi):
    """``[serve-vlm]``: paligemma-3b uncut (18 layers, d_model 2048, 8/1
    heads of 256, vocabulary 257216; random bf16 weights from seed 0).
    ``serve.main`` at batch 4, a 512-token prompt and 32 new tokens, text
    only as the JAX CLI serves it: 18 flash launches a prefill, all
    ``"tc"`` (dh 256).  Then patches (4, 256, 1152) fp32 from numpy seed
    0 and 256 text tokens through ``vlm.forward`` with caches at index 0
    (512 positions, 18 ``"tc"`` launches, each within ``LAYER_TOL`` of
    its plain version), 32 decode steps from 512 (no launch), 200 text
    tokens behind the same patches (456 positions: the plain attention, 0
    launches), and the 512-position prefill against the plain attention
    end to end (logits, KV caches) within ``LM_REL_TOL``; profiles and
    peak memory.  Returns the flash launches a prefill."""
    from repro_torch import configs, tree as T
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models import api
    t_phase = time.perf_counter()
    B, G = 4, FAMILY_GEN
    spec = configs.get("paligemma-3b")
    cfg, lm = spec.cfg, spec.cfg.lm
    P = cfg.n_patches + VLM_TEXT[0]
    n_flash = flash_per_prefill(spec)
    torch.cuda.reset_peak_memory_stats()
    launches.clear()
    _build.VARIANTS.clear()
    t0 = time.perf_counter()
    gen = serve.main(["--arch", spec.name, "--batch", str(B), "--prompt-len",
                      str(P), "--gen", str(G), "--seed", "0"])
    wall = time.perf_counter() - t0
    expect_launches(launches, n_flash, "serve paligemma-3b")
    if gen.shape != (B, G) or gen.min() < 0 or gen.max() >= lm.vocab:
        raise AssertionError(f"serve paligemma: tokens {gen.shape}")

    params = api.init(torch.Generator(device="cuda").manual_seed(0), spec)
    n_params = sum(x.numel() for x in T.leaves(params))
    if n_params != cfg.param_count():
        raise AssertionError(f"paligemma: {n_params} parameters")
    patches = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (B, cfg.n_patches, cfg.d_vision), dtype=np.float32)).cuda()
    text = torch.as_tensor(np.random.default_rng(1).integers(
        0, lm.vocab, (B, VLM_TEXT[0])), device="cuda")
    errs = []
    launches.clear()
    _build.VARIANTS.clear()
    with per_layer_check(errs):
        vlm_prefill(params, spec, patches, text, P + G)
    expect_launches(launches, n_flash, "paligemma checked prefill")
    if len(errs) != n_flash:
        raise AssertionError(f"paligemma: {len(errs)} flash calls checked")
    launches.clear()
    _build.VARIANTS.clear()
    lk, sk, k_ms = vlm_prefill(params, spec, patches, text, P + G)
    expect_launches(launches, n_flash, "paligemma prefill")
    with plain_attention():
        lp, sp, p_ms = vlm_prefill(params, spec, patches, text, P + G)
    logit_rel, st_rel = rel_err(lk, lp), state_rel(sk, sp)
    if not (logit_rel <= LM_REL_TOL and st_rel <= LM_REL_TOL):
        raise AssertionError(f"paligemma prefill: logits relative "
                             f"{logit_rel}, caches {st_rel}")
    agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    del lp, sp
    launches.clear()
    _build.VARIANTS.clear()
    l200, _, s_ms = vlm_prefill(params, spec, patches, text[:, :VLM_TEXT[1]],
                                cfg.n_patches + VLM_TEXT[1] + G)
    expect_launches(launches, 0, "paligemma 456-position prefill")
    if not torch.isfinite(l200).all():
        raise AssertionError("paligemma 456-position prefill: non-finite")
    pre = device_profile(lambda: vlm_prefill(params, spec, patches, text,
                                             P + G))
    step = build_serve_step(spec)
    tok, state = lk.argmax(-1).to(torch.int32), sk
    launches.clear()
    _build.VARIANTS.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(G):
        tok, state = step(params, state, tok[:, None], P + i)
    torch.cuda.synchronize()
    dec_ms = (time.perf_counter() - t0) / G * 1e3
    expect_launches(launches, 0, "paligemma decode")
    if not (0 <= tok.min() and tok.max() < lm.vocab):
        raise AssertionError(f"paligemma decode: tokens {tok.tolist()}")

    def three_steps():
        t = tok
        for i in range(3):
            t, _ = step(params, state, t[:, None], P + G - 3 + i)

    dec = device_profile(three_steps)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[serve-vlm] paligemma-3b ({lm.n_layers} layers, d_model "
        f"{lm.d_model}, {lm.n_heads}/{lm.n_kv} heads of {lm.dh}, d_ff "
        f"{lm.d_ff}, vocab {lm.vocab}, {cfg.n_patches} patches of "
        f"{cfg.d_vision}; {n_params} parameters, uncut) B={B}: serve.main "
        f"(text only, P={P}) {gen.shape} tokens in [0, {lm.vocab}), wall "
        f"{wall:.1f} s, {n_flash} flash launches a prefill, all tc; "
        f"patches ({B}, {cfg.n_patches}, {cfg.d_vision}) + {VLM_TEXT[0]} "
        f"text tokens = {P} positions: {n_flash} launches, all tc, each "
        f"within {LAYER_TOL} of the plain version (max {max(errs):.3e}); vs "
        f"the plain attention end to end: logits relative {logit_rel:.3e}, "
        f"KV caches relative <= {st_rel:.3e} (tol {LM_REL_TOL}), greedy "
        f"agreement {agree:.2f}; {G} decode steps from {P}, 0 launches; "
        f"{VLM_TEXT[1]} text tokens behind the patches "
        f"({cfg.n_patches + VLM_TEXT[1]} positions, refused by tile_ok): 0 "
        f"launches, {s_ms:.1f} ms; prefill {k_ms:.1f} ms ({p_ms:.1f} with "
        f"the plain attention), decode {dec_ms:.2f} ms a step "
        f"({B / dec_ms * 1e3:.1f} tok/s); peak memory {peak_gb:.1f} GB; "
        f"{smi}")
    log(f"[profile] paligemma-3b prefill (patches + text, {P} positions): "
        f"device {pre[0]:.2f} ms, {pre[1]} launches, busy "
        f"{pre[0] / k_ms:.2f} of the unprofiled {k_ms:.1f} ms; top: "
        f"{pre[2]}")
    log(f"[profile] paligemma-3b decode: device {dec[0] / 3:.2f} ms and "
        f"{dec[1] / 3:.0f} launches a step, busy {dec[0] / 3 / dec_ms:.2f} "
        f"of the unprofiled {dec_ms:.2f} ms; top over 3 steps: {dec[2]}")
    del params, state, sk, lk, tok, patches, l200
    torch.cuda.empty_cache()
    log(f"[serve-vlm] phase wall {time.perf_counter() - t_phase:.1f} s; "
        f"{smi}")
    return n_flash


def phase_train_vlm(launches, smi):
    """``[train-vlm]``: paligemma-3b uncut, ``TRAIN_STEPS_NEW`` AdamW
    steps of 8 x (256 patches + 256 text) through ``build_train_step``
    under ``dots``: 36 flash forwards (18, and 18 again in the remat's
    recompute) and 18 backwards a step, all ``"tc"`` (dh 256); every
    gradient leaf non-zero, ``vision_proj``'s too; the step against the
    plain attention, every flash call against its plain version; a
    profiled step; a bit-exact resume through ``CheckpointManager`` at
    reduced size.  Returns the flash forward and backward launches of the
    steps."""
    from repro_torch import configs
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import api
    from repro_torch.optim import OptConfig, opt_init
    t_phase = time.perf_counter()
    spec = configs.get("paligemma-3b")
    cfg = spec.cfg
    S = TRAIN_S - cfg.n_patches
    n = flash_per_prefill(spec)
    want = {"flash_attention": 2 * n, "flash_attention_bwd": n}
    torch.cuda.reset_peak_memory_stats()
    params = api.init(torch.Generator(device="cuda").manual_seed(0), spec)
    opt_cfg = OptConfig()
    step = build_train_step(spec, opt_cfg)
    log(f"[train-vlm] paligemma-3b uncut ({cfg.param_count()} parameters), "
        f"{TRAIN_STEPS_NEW} AdamW steps of {TRAIN_B} x ({cfg.n_patches} "
        f"patches + {S} text tokens), patches ({TRAIN_B}, {cfg.n_patches}, "
        f"{cfg.d_vision}) fp32, remat {cfg.lm.remat}")
    params, opt_state = train_steps(
        launches, spec, step, params, opt_init(params, opt_cfg),
        [vlm_batch(spec, i, TRAIN_B, S, "cuda")
         for i in range(TRAIN_STEPS_NEW)], want, "[train-vlm]", smi)
    batch = vlm_batch(spec, TRAIN_STEPS_NEW, TRAIN_B, S, "cuda")
    train_vs_plain(spec, params, batch, "[train-vlm]", 2 * n, n)
    torch.cuda.reset_peak_memory_stats()
    step_ms, _, _ = profile_train_step(spec, step, params, opt_state, batch,
                                       smi)
    log(f"[train-vlm] peak memory of the profiled steps "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB; "
        f"{TRAIN_B * TRAIN_S / step_ms * 1e3:.0f} positions/s (patches and "
        f"text) at the best wall")
    del params, opt_state, batch
    torch.cuda.empty_cache()
    check_resume_manager(spec, "[train-vlm]", vlm_batch)
    log(f"[train-vlm] phase wall {time.perf_counter() - t_phase:.1f} s; "
        f"{smi}")
    return TRAIN_STEPS_NEW * want["flash_attention"], \
        TRAIN_STEPS_NEW * want["flash_attention_bwd"]


# ------------------------------------------------------------ phase 26
#: the SM mesh of phase 26: 8 SMs over k entries that all name the card
SHARD_N_SM = 8
SHARD_KS = (2, 4, 8)
#: the longtail drains of phase 26: launches, SMs and shards
SHARD_DRAIN = (8, 4, 4)


@contextlib.contextmanager
def written_masks():
    """Record, per launch of one ``execute``, the union of the words its
    positions wrote (the written masks ``fused_sm_run`` returns), by
    wrapping the executor's ``fused_sm_run``; the kernel launches as
    before."""
    from repro_torch.runtime import executor
    real, masks = executor.fused_sm_run, {}

    def recording(cfg, n_warps, codes, geom, gmem, **kw):
        mem, wrt, ctr = real(cfg, n_warps, codes, geom, gmem, **kw)
        for li in sorted(set(geom[:, 0].tolist())):
            rows = torch.as_tensor(np.flatnonzero(geom[:, 0] == li),
                                   device=wrt.device)
            m = wrt.index_select(0, rows).any(0)
            masks[li] = m if li not in masks else masks[li] | m
        return mem, wrt, ctr

    executor.fused_sm_run = recording
    try:
        yield masks
    finally:
        executor.fused_sm_run = real


def shard_prediction(n_blocks, n_sm, chunk, k):
    """(fused_sm_run launches, dispatch groups) of a sharded ``execute``
    of ``n_blocks`` positions: one launch a shard with a real position in
    each group (``executor.shard_slots``)."""
    from repro_torch.runtime.executor import shard_slots
    _, _, groups = shard_slots(n_blocks, n_sm, chunk, k)
    return sum(len(runs) for *_, runs in groups), len(groups)


def sharded_execute(launches, specs, k, tag, n_sm=SHARD_N_SM, chunk=8):
    """One ``execute(shard_sm=True)`` over ``["cuda:0"] * k`` and the same
    call unsharded: every result field, the written masks and the report
    bit-equal, the fused launches and ``shard.dispatch_groups`` equal to
    :func:`shard_prediction`.  Returns (sharded grid, its launches)."""
    from repro_torch import runtime as rt
    groups = rt.METRICS.counter("shard.dispatch_groups")
    with written_masks() as want_w:
        want = rt.execute(specs, n_sm=n_sm, chunk=chunk, device="cuda")
        want_res, want_rep = want.to_results(), want.report()
    launches.clear()
    g0 = groups.value
    with written_masks() as got_w:
        got = rt.execute(specs, n_sm=n_sm, chunk=chunk, shard_sm=True,
                         sm_devices=["cuda:0"] * k, device="cuda")
        res, rep = got.to_results(), got.report()
    counts, n_groups = dict(launches), groups.value - g0
    n_launch, n_group = shard_prediction(rep.n_blocks, n_sm, chunk, k)
    if counts != {"fused_sm_run": n_launch} or n_groups != n_group:
        raise AssertionError(f"{tag} k={k}: launched {counts} in {n_groups} "
                             f"sharded groups, want {n_launch} fused_sm_run "
                             f"in {n_group}")
    for i, (a, b) in enumerate(zip(res, want_res)):
        assert_same(a, b, f"{tag} k={k} launch {i} vs unsharded")
    if sorted(got_w) != sorted(want_w) or not all(
            torch.equal(got_w[i], want_w[i]) for i in want_w):
        raise AssertionError(f"{tag} k={k}: written masks differ")
    if not (np.array_equal(rep.per_sm_cycles, want_rep.per_sm_cycles)
            and (rep.n_steps, rep.n_blocks) ==
            (want_rep.n_steps, want_rep.n_blocks)):
        raise AssertionError(f"{tag} k={k}: report differs from unsharded")
    return got, n_launch


def shard_drain_launches(launches, fn, n_sm, k, tag):
    """Run a drain ``fn`` with the launch counts at 0 and the tracer on:
    each dispatch group must launch ``fused_sm_run`` once a shard with a
    real position (the server's chunk, ``max(2, n_sm)``).  Returns
    ``fn``'s result and the launches."""
    from repro_torch import obs
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
    want = sum(shard_prediction(sum(blocks[t] for t in g), n_sm,
                                max(2, n_sm), k)[0] for g in groups)
    if counts != {"fused_sm_run": want}:
        raise AssertionError(f"{tag}: launched {counts}, want {want} "
                             f"fused_sm_run for {len(groups)} groups")
    return out, want


def conflict_kernel():
    """Every block writes ``100 + flat-block-id`` over the same 32 words
    (``tests/test_sharding.py``'s conflict kernel)."""
    from repro_torch.core import asm, isa
    p = asm.Program("conflict100")
    p.s2r("r0", isa.SR_TID)
    p.s2r("r1", isa.SR_CTA)
    p.iadd("r1", "r1", 100)
    p.stg("r0", "r1", 64)
    p.exit()
    return p.finish()


def phase_shard_sm(launches, smi):
    """``[shard-sm]``: the sharded executor over logical shards of the one
    card (docstring item 26).  Returns the fused launches of its counted
    sharded runs."""
    from repro_torch import obs
    from repro_torch import runtime as rt
    from repro_torch.core.programs import ALL
    from repro_torch.launch import gpgpu_serve
    SERVE_LOG.parent.mkdir(parents=True, exist_ok=True)
    t_phase, fused, n = time.perf_counter(), 0, 256
    rng = np.random.default_rng(26)
    inputs = {name: ALL[name].make_gmem(rng, n) for name in sorted(ALL)}
    specs = {}
    for name in sorted(ALL):
        mod = ALL[name]
        specs[name] = rt.LaunchSpec(mod.build(n), *mod.launch(n),
                                    inputs[name].copy())
    for k in SHARD_KS:
        for name in sorted(ALL):
            mod = ALL[name]
            dg, got = sharded_execute(launches, [specs[name]], k, name)
            fused += got
            res, rep = dg.to_results()[0], dg.report()
            # reduction at n=256 is one pass: its output is the final one
            check_grid(mod, n, inputs[name], res, f"{name} k={k}")
            if not np.array_equal(rep.per_sm_cycles,
                                  res.per_sm_cycles(SHARD_N_SM)):
                raise AssertionError(f"{name} k={k}: per-SM cycles != "
                                     "analytical replay")
            if name == "matmul" and \
                    set(res.cycles_per_block.tolist()) != {83968}:
                raise AssertionError("matmul cycles per block != 83968")
            log(f"[shard-sm] {name} n={n} k={k} on {SHARD_N_SM} SMs: "
                f"bit-equal to unsharded (gmem, written mask, 6 counters, "
                f"report), oracle ok, per-SM {rep.per_sm_cycles.tolist()} "
                f"== analytical, fused_sm_run {got} == predicted")
        # the drain shape: all five launches in one execute
        dg, got = sharded_execute(launches, list(specs.values()), k,
                                  "five-launch execute")
        fused += got
        for name, res in zip(specs, dg.to_results()):
            check_grid(ALL[name], n, inputs[name], res, f"drain {name}")
        log(f"[shard-sm] five-launch execute k={k}: bit-equal to unsharded, "
            f"per-SM {dg.report().per_sm_cycles.tolist()}, fused_sm_run "
            f"{got} == predicted")
    # the conflict kernel: 7 blocks on 4 SMs write the same 32 words
    p = conflict_kernel()
    for k in (2, 4):
        dg, got = sharded_execute(
            launches, [rt.LaunchSpec(p, (7, 1), (32, 1),
                                     np.zeros(128, np.int32))],
            k, "conflict", n_sm=4)
        fused += got
        gmem = dg.to_results()[0].gmem
        if not ((gmem[64:96] == 106).all() and not gmem[:64].any()):
            raise AssertionError(f"conflict k={k}: last writer lost")
    log("[shard-sm] conflict kernel, 7 blocks on 4 SMs over 2 and 4 shards: "
        "words 64-95 == 106 (the last block's), words 0-63 == 0")
    # longtail drains over 4 shards against the same drains unsharded
    n_l, n_sm, k = SHARD_DRAIN
    work = gpgpu_serve.build_longtail_workload(n_l)
    for policy in ("bucket", "balanced"):
        _, st_a, _ = gpgpu_serve.drain_workload(work, n_sm, policy=policy,
                                                device="cuda")
        (srv, st_b, _), got = shard_drain_launches(
            launches, lambda: gpgpu_serve.drain_workload(
                work, n_sm, policy=policy, shard_sm=True,
                sm_devices=["cuda:0"] * k, device="cuda"),
            n_sm, k, f"longtail {policy}")
        fused += got
        per = n_sm // k
        owner = st_b.per_sm_cycles.reshape(k, per).sum(1)
        gauges = srv.metrics.snapshot()["gauges"]
        if not (np.array_equal(st_a.per_sm_cycles, st_b.per_sm_cycles)
                and st_a.makespan_cycles == st_b.makespan_cycles
                and st_a.busy_cycles == st_b.busy_cycles
                and st_a.n_devices == 1 and st_b.n_devices == k
                and np.array_equal(st_b.device_cycles, owner)
                and gauges.get("drain.shard.n_devices") == k
                and "drain.shard.device_skew" in gauges
                and all(f"drain.shard.device.{d}.cycles" in gauges
                        for d in range(k))):
            raise AssertionError(f"longtail {policy}: sharded drain differs "
                                 f"({st_a} vs {st_b})")
        log(f"[shard-sm] longtail {n_l} {policy} on {n_sm} SMs over {k} "
            f"shards: per-SM {st_b.per_sm_cycles.tolist()}, makespan "
            f"{st_b.makespan_cycles}, busy {st_b.busy_cycles} == unsharded; "
            f"device cycles {st_b.device_cycles.tolist()}, skew "
            f"{st_b.device_skew:.3f}, fused_sm_run {got} == predicted")
    # resident memory: no gmem crosses between host and card in the drain
    srv = rt.RuntimeServer(n_sm=n_sm, resident_gmem=True, shard_sm=True,
                           sm_devices=["cuda:0"] * k,
                           metrics=obs.MetricsRegistry(), device="cuda")
    tickets = {}
    for i, (name, mod, nn, code, (grid, bd), g0) in enumerate(work):
        tickets[srv.submit(code, grid, bd, g0.copy(), client=f"t{i}")] = \
            (mod, nn, g0)
    w = rt.TRANSFERS.window()
    results, stats = srv.drain()
    crossings = w.snapshot()
    if (crossings["gmem_uploads"], crossings["gmem_syncs"]) != (0, 0) or \
            crossings["counter_syncs"] != stats.n_sub_batches or \
            stats.n_devices != k:
        raise AssertionError(f"resident sharded drain crossed {crossings}")
    for t, (mod, nn, g0) in tickets.items():
        if not np.array_equal(results[t].gmem.cpu().numpy()[
                mod.out_slice(nn)], mod.oracle(g0, nn)):
            raise AssertionError("resident sharded drain: oracle")
    log(f"[shard-sm] resident drain over {k} shards: TRANSFERS {crossings}")
    # the CLI with --shard-sm on the one card: the one-device path
    base, _ = serve_cli(launches, SERVE_DRAIN, "cli", smi, 8,
                        prefix="[shard-sm]")
    flag, _ = serve_cli(launches, SERVE_DRAIN + ["--shard-sm"],
                        "cli --shard-sm", smi, 8, prefix="[shard-sm]")
    if flag.n_devices != 1 or not np.array_equal(
            base.per_sm_cycles, flag.per_sm_cycles) or any(
            getattr(base, f) != getattr(flag, f) for f in DRAIN_FIELDS):
        raise AssertionError("--shard-sm on one card differs")
    log(f"[shard-sm] CLI --shard-sm on {torch.cuda.device_count()} card(s): "
        f"n_devices 1, accounting == the run without the flag")
    # walls: matmul n=256 unsharded and at each k, in turns
    walls = {k: [] for k in (1,) + SHARD_KS}
    for _ in range(3):
        for k in (1,) + SHARD_KS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rt.execute([specs["matmul"]], n_sm=SHARD_N_SM, shard_sm=k > 1,
                       sm_devices=["cuda:0"] * k, device="cuda").report()
            walls[k].append(time.perf_counter() - t0)
    n_fused = {k: shard_prediction(256, SHARD_N_SM, 8, k)[0]
               for k in SHARD_KS}
    n_fused[1] = grid_groups(256, SHARD_N_SM, len(specs["matmul"].gmem))
    log("[shard-sm] matmul n=256 on 8 SMs, wall of execute + report "
        "(min/median/max ms over 3 turns): " + ", ".join(
            f"{'unsharded' if k == 1 else f'k={k}'} {spread(v)} "
            f"({n_fused[k]} launches)" for k, v in walls.items())
        + f"; {smi}")
    log(f"[shard-sm] phase wall {time.perf_counter() - t_phase:.1f} s, "
        f"fused_sm_run {fused} in the counted sharded runs; {smi}")
    return fused


def in_turns(call, dh, reps):
    """Device ms of ``call(None)`` (the rule's variant) and, at dh 256, of
    ``call("simt")`` too, in turns (tc, simt, simt, tc), the lower reading
    of each: (ms, {"variant_ms": ..., "readings": ...}), the dict empty
    below dh 256."""
    if dh != 256:
        return device_ms(lambda: call(None), reps), {}
    reads = {"tc": [], "simt": []}
    for name in ("tc", "simt", "simt", "tc"):
        forced = None if name == "tc" else name
        reads[name].append(device_ms(lambda: call(forced), reps))
    best = {k: min(v) for k, v in reads.items()}
    return best["tc"], {"variant_ms": best, "readings": reads}


def turns_note(variant_ms):
    """The SIMT reading beside the rule's, for a log line."""
    if not variant_ms:
        return ""
    r, best = variant_ms["readings"], variant_ms["variant_ms"]
    return (" (in turns tc " + ", ".join(f"{t:.4f}" for t in r["tc"])
            + ", simt " + ", ".join(f"{t:.4f}" for t in r["simt"])
            + f"; simt {best['simt'] / best['tc']:.1f}x tc)")


def time_family_shapes():
    """The flash forward at dbrx's prefill call (GQA 6, dh 128, causal),
    whisper's encoder call (full 1500 x 1500, dh 64) and paligemma's
    prefill call (8/1 heads of 256, causal), and the backward at
    ``BWD_SHAPES``' "dbrx GQA 6", "whisper cross" and "paligemma
    training" cases, each by the rule's variant (at dh 256 also by the
    forced SIMT one, in turns tc, simt, simt, tc) beside its plain
    version, the library call and the bound, paligemma's backward also
    by split (``bwd_by_split``); and the backward of
    ``scaled_dot_product_attention`` at the "dh 256" case (the library
    time of that case's row).  Returns {"forward": ..., "backward": ...,
    "library_bwd_dh256": ...}."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import mha_bwd_ref, mha_ref
    g = torch.Generator(device="cuda").manual_seed(23)
    out = {"forward": {}, "backward": {}}
    for tag, B, S, H, KH, dh, causal in FAMILY_FWD_SHAPES:
        if tag == "whisper cross":
            continue
        Sq, Sk = lengths(S)
        q = rand(g, (B, Sq, H, dh), torch.bfloat16)
        k, v = (rand(g, (B, Sk, KH, dh), torch.bfloat16) for _ in range(2))
        var = fa.variant(q, k, v)
        ms, variant_ms = in_turns(
            lambda forced: fa.flash_attention_gqa(
                q, k, v, causal=causal, variant=forced), dh, 20)
        plain_ms = device_ms(lambda: mha_ref(q, k, v, causal=causal), 5)
        _, lib_ms, _, by_backend, backend = time_sdpa(
            *(x.transpose(1, 2).contiguous() for x in (q, k, v)),
            causal=causal)
        nbytes = 2 * (2 * B * Sq * H * dh + 2 * B * Sk * KH * dh)
        flops = 4 * dh * B * H * (Sq * (Sq + 1) // 2 if causal else Sq * Sk)
        bound_ms, by, peak = bound(nbytes, flops, torch.bfloat16)
        log(f"[timing] flash_attention {tag} B={B} Sq={Sq} Sk={Sk} "
            f"H={H}/{KH} dh={dh} bf16 causal={causal}: {var} {ms:.4f} ms "
            f"({bound_ms / ms:.1%} of the bound){turns_note(variant_ms)}, "
            f"plain {plain_ms:.4f} ms, "
            f"scaled_dot_product_attention {lib_ms:.4f} ms (ran {backend}; "
            + ", ".join(f"{n_} {t:.4f}" for n_, t in by_backend.items())
            + f"); bound {bound_ms:.5f} ms ({nbytes} B, {flops} FLOP, {by}; "
            f"peak {peak})")
        out["forward"][tag] = dict(ms=ms, variant=var, plain_ms=plain_ms,
                                   library_ms=lib_ms, library_backend=backend,
                                   bound_ms=bound_ms, bound_by=by,
                                   **variant_ms)
        del q, k, v
    for tag in ("dbrx GQA 6", "whisper cross", "paligemma training",
                "dh 256"):
        _, B, S, H, KH, dh, dtype, causal = next(
            x for x in BWD_SHAPES if x[0] == tag)
        q, k, v, o, do, lse, var = bwd_case(g, B, S, H, KH, dh, dtype,
                                            causal)
        by_backend, lib_name = sdpa_bwd_by_backend(q, k, v, do, causal)
        if tag == "dh 256":
            out["library_bwd_dh256"] = dict(
                ms=by_backend[lib_name], backend=lib_name,
                by_backend=by_backend)
            log(f"[timing] scaled_dot_product_attention backward at dh 256 "
                f"(B={B} S={S} H={H}/{KH} bf16 causal): {lib_name} "
                f"{by_backend[lib_name]:.4f} ms; by backend "
                + ", ".join(f"{n_} {t:.4f} ms" for n_, t in
                            by_backend.items()))
            continue
        ms, variant_ms = in_turns(
            lambda forced: fa.flash_attention_bwd(
                q, k, v, o, do, lse, causal=causal, variant=forced), dh, 10)
        if tag == "paligemma training":
            variant_ms["by_split"] = bwd_by_split(q, k, v, o, do, lse,
                                                  causal)
        plain_ms = device_ms(lambda: mha_bwd_ref(q, k, v, o, do, lse,
                                                 causal=causal), 3)
        nbytes, flops = bwd_work(B, S, H, KH, dh, dtype, causal)
        bound_ms, by, peak = bound(nbytes, flops, dtype)
        log(f"[timing] flash_attention_bwd {tag} B={B} S={S} H={H}/{KH} "
            f"dh={dh} bf16 causal={causal}: {var} {ms:.4f} ms "
            f"({bound_ms / ms:.1%} of the bound){turns_note(variant_ms)}, "
            f"plain {plain_ms:.4f} ms, "
            f"scaled_dot_product_attention backward {lib_name} "
            f"{by_backend[lib_name]:.4f} ms (" + ", ".join(
                f"{n_} {t:.4f}" for n_, t in by_backend.items())
            + f"); bound {bound_ms:.5f} ms ({nbytes} B, {flops} FLOP, {by}; "
            f"peak {peak})")
        out["backward"][tag] = dict(ms=ms, variant=var, plain_ms=plain_ms,
                                    library_ms=by_backend[lib_name],
                                    library_backend=lib_name,
                                    bound_ms=bound_ms, bound_by=by,
                                    **variant_ms)
        del q, k, v, o, do, lse
    return out


# ------------------------------------------------------------ phase 27
#: phase 27's serving: qwen3-0.6b's prefill of 4 x 512 and 8 decode steps;
#: training: 3 steps of 8 x 512
MESH_B, MESH_P, MESH_DECODES, MESH_TRAIN_STEPS = 4, 512, 8, 3


def tree_max_diff(a, b):
    """The largest absolute difference over two trees of tensors (a
    DTensor compared by its full value)."""
    from repro_torch import tree as T
    return max((x.full_tensor() if hasattr(x, "full_tensor") else x)
               .float().sub(y.float()).abs().max().item()
               for x, y in zip(T.leaves(a), T.leaves(b)))


def walls_in_turns(runs, order):
    """Each run's walls (ms) when called in ``order`` (names of ``runs``),
    each call ended by a device sync."""
    walls = {k: [] for k in runs}
    for name in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name]()
        torch.cuda.synchronize()
        walls[name].append((time.perf_counter() - t0) * 1e3)
    return walls


def roofline(cost, wall_ms):
    """(compute_t, memory_t, share) of one analysed step at the H100 SXM
    datasheet rates (``launch.dryrun``): the share is the larger bound
    over the measured wall."""
    from repro_torch.launch import dryrun
    compute_t = cost.flops / dryrun.PEAK_FLOPS
    memory_t = cost.bytes / dryrun.HBM_BW
    return compute_t, memory_t, max(compute_t, memory_t) * 1e3 / wall_ms


def phase_mesh_lm(launches, smi):
    """``[mesh-lm]`` (docstring item 27).  Returns the flash forward
    launches of the sharded serve runs, and the forward and backward
    launches of the sharded train steps."""
    import tempfile
    import torch.distributed as dist
    from repro_torch import configs, tree as T
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import hloanalysis, mesh as M
    from repro_torch.launch.steps import build_serve_step, build_train_step
    from repro_torch.models import api
    from repro_torch.optim import OptConfig, opt_init
    t_phase = time.perf_counter()
    # the dry-run traces on the host's CPU: start it first, read it last
    dry_dir = ROOT / "build" / "dryrun"
    cached = dry_dir / "qwen3_0p6b__train_4k__single.json"
    if cached.exists():
        cached.unlink()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    dry = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-0.6b", "--shape", "train_4k", "--mesh", "single", "--out",
         str(dry_dir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=str(ROOT))
    spec = configs.get("qwen3-0.6b")
    cfg, L, B, P = spec.cfg, spec.cfg.n_layers, MESH_B, MESH_P
    store = tempfile.TemporaryDirectory(prefix="mesh_lm_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store.name}/store",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        dm = M.device_mesh(M.make_debug_mesh(1))
        log(f"[mesh-lm] NCCL process group of 1 rank, DeviceMesh {dm} "
            f"(data 1, model 1) over cuda:0")
        params = api.init(torch.Generator(device="cuda").manual_seed(0),
                          spec)
        rng = np.random.default_rng(27)
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (B, P)),
                                 device="cuda")
        plain_step = build_serve_step(spec)
        steps = {"tp": build_serve_step(spec, mesh=dm, profile="tp"),
                 "seq": build_serve_step(spec, mesh=dm, profile="seq")}

        def serve(step, decodes):
            """The prefill, then ``decodes`` greedy steps: (tokens of each
            step, final state, flash launches, walls ms)."""
            state = api.decode_state(spec, B, P + MESH_DECODES)
            launches.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, state = step(params, state, prompt, 0)
            torch.cuda.synchronize()
            walls = [(time.perf_counter() - t0) * 1e3]
            toks = [tok]
            for i in range(decodes):
                t0 = time.perf_counter()
                tok, state = step(params, state, tok[:, None], P + i)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                toks.append(tok)
            return toks, state, dict(launches), walls

        ref = serve(plain_step, MESH_DECODES)
        serve_launches = 0
        for profile, decodes in (("tp", MESH_DECODES), ("seq", 0)):
            toks, state, counts, _ = serve(steps[profile], decodes)
            if counts != {"flash_attention": L}:
                raise AssertionError(f"mesh serve {profile}: launches "
                                     f"{counts}, want {L} flash_attention")
            serve_launches += counts["flash_attention"]
            same = all(torch.equal(a, b) for a, b in zip(toks, ref[0]))
            diff = tree_max_diff(state, ref[1]) if decodes else \
                max(tree_max_diff([c[:, :, :P]], [r[:, :, :P]])
                    for c, r in zip(state["kv"], ref[1]["kv"]))
            if not same or diff != 0:
                raise AssertionError(f"mesh serve {profile}: tokens equal "
                                     f"{same}, caches max diff {diff}")
            log(f"[mesh-lm] sharded serve profile={profile}: prefill "
                f"{B} x {P} and {decodes} decode steps, every next token and "
                f"the KV caches bit-equal to the unsharded steps; "
                f"{counts['flash_attention']} flash launches a prefill")
            del state
        # walls in turns: unsharded, sharded, sharded, unsharded
        walls = {}
        for name in ("plain", "tp", "tp", "plain"):
            w = serve(plain_step if name == "plain" else steps["tp"],
                      MESH_DECODES)[3]
            walls.setdefault(name, []).append(w)
        pre = {k: [w[0] for w in v] for k, v in walls.items()}
        dec = {k: [sum(w[1:]) / MESH_DECODES for w in v]
               for k, v in walls.items()}
        log(f"[mesh-lm] walls in turns (plain, tp, tp, plain): prefill "
            f"plain {pre['plain']} ms, sharded {pre['tp']} ms; decode step "
            f"plain {[round(x, 3) for x in dec['plain']]} ms, sharded "
            f"{[round(x, 3) for x in dec['tp']]} ms (DTensor dispatch on the "
            f"host); {smi}")

        # training: 3 steps, donate and shard_grads, against the plain step
        opt_cfg = OptConfig()
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                      global_batch=TRAIN_B, seed=0),
                           device="cuda")
        batches = [data.batch(i) for i in range(MESH_TRAIN_STEPS)]
        plain_train = build_train_step(spec, opt_cfg)
        mesh_train = build_train_step(spec, opt_cfg, mesh=dm, donate=True,
                                      shard_grads=True)
        runs = {}
        for name, step in (("plain", plain_train), ("mesh", mesh_train)):
            p = T.tree_map(torch.clone, params)
            o = opt_init(p, opt_cfg)
            stats, walls, counts = [], [], []
            for b in batches:
                launches.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                p, o, st = step(p, o, b)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                counts.append(dict(launches))
                stats.append((st["loss"].item(), st["grad_norm"].item()))
            runs[name] = (p, stats, walls, counts)
        want = {"flash_attention": 2 * L, "flash_attention_bwd": L}
        if any(c != want for c in runs["mesh"][3]):
            raise AssertionError(f"mesh train: launches {runs['mesh'][3]}, "
                                 f"want {want} a step")
        pdiff = tree_max_diff(runs["mesh"][0], runs["plain"][0])
        if runs["mesh"][1] != runs["plain"][1] or pdiff != 0:
            raise AssertionError(f"mesh train: stats {runs['mesh'][1]} vs "
                                 f"{runs['plain'][1]}, params max diff "
                                 f"{pdiff}")
        log(f"[mesh-lm] sharded train (donate, shard_grads, tp): "
            f"{MESH_TRAIN_STEPS} steps of {TRAIN_B} x {TRAIN_S}, losses and "
            f"grad norms {runs['mesh'][1]} bit-equal to the unsharded "
            f"steps', parameters bit-equal; {want} launches a step; walls "
            f"sharded {[round(w, 1) for w in runs['mesh'][2]]} ms, "
            f"unsharded {[round(w, 1) for w in runs['plain'][2]]} ms; {smi}")
        del runs, params
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        store.cleanup()

    # paligemma-3b's train step peak, without and with donate
    vspec = configs.get("paligemma-3b")
    vparams = api.init(torch.Generator(device="cuda").manual_seed(0), vspec)
    vopt = opt_init(vparams, opt_cfg)
    vbatch = vlm_batch(vspec, 0, TRAIN_B, TRAIN_S - vspec.cfg.n_patches,
                       "cuda")
    peaks = {}
    for donate in (False, True):
        step = build_train_step(vspec, opt_cfg, donate=donate)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        new_p, new_o, _ = step(vparams, vopt, vbatch)
        torch.cuda.synchronize()
        peaks[donate] = (torch.cuda.max_memory_allocated() / 1e9,
                         base / 1e9)
        vparams, vopt = new_p, new_o
        del new_p, new_o
        torch.cuda.empty_cache()
    log(f"[mesh-lm] paligemma-3b train step (8 x (256 patches + 256 text)) "
        f"peak memory: donate=False {peaks[False][0]:.2f} GB, donate=True "
        f"{peaks[True][0]:.2f} GB (held before the step {peaks[False][1]:.2f}"
        f" and {peaks[True][1]:.2f} GB); {smi}")
    del vparams, vopt, vbatch
    torch.cuda.empty_cache()

    # a first roofline share: the unsharded qwen3 train step (phase 17's
    # shape) and prefill (phase 9's), counted by hloanalysis.analyze
    params = api.init(torch.Generator(device="cuda").manual_seed(0), spec)
    opt_state = opt_init(params, opt_cfg)
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                   global_batch=TRAIN_B, seed=0),
                        device="cuda").batch(0)
    train = build_train_step(spec, opt_cfg)
    plain_step = build_serve_step(spec)
    cases = {
        "train step": lambda: train(params, opt_state, batch),
        "prefill": lambda: plain_step(params, api.decode_state(
            spec, B, P + MESH_DECODES), prompt, 0)}
    for name, fn in cases.items():
        launches.clear()
        cost = hloanalysis.analyze(fn)
        if not cost.kernels or cost.kernels != dict(launches):
            raise AssertionError(f"roofline {name}: the analysis counted "
                                 f"flash launches {cost.kernels}, the "
                                 f"wrappers {dict(launches)}")
        walls = walls_in_turns({name: fn}, [name] * 3)[name]
        ct, mt, share = roofline(cost, min(walls))
        log(f"[mesh-lm] roofline {name} qwen3-0.6b: {cost.flops:.4e} FLOPs, "
            f"{cost.bytes:.4e} bytes (flash kernels counted from their "
            f"shapes: {cost.kernels}); compute_t {ct * 1e3:.3f} ms, memory_t "
            f"{mt * 1e3:.3f} ms at the H100 SXM datasheet rates; wall "
            f"{[round(w, 2) for w in walls]} ms; share of the roofline "
            f"{share:.3f}; {smi}")
    del params, opt_state, batch
    torch.cuda.empty_cache()

    out, err = dry.communicate(timeout=600)
    if dry.returncode != 0:
        raise AssertionError(f"dry-run: exit {dry.returncode}: {err[-2000:]}")
    rec = json.loads(out.strip().splitlines()[-1])
    if rec["status"] != "ok":
        raise AssertionError(f"dry-run: {rec}")
    log(f"[mesh-lm] dry-run qwen3-0.6b train_4k at the production mesh "
        f"(256 fake ranks): {json.dumps(rec)}")
    log(f"[mesh-lm] phase wall {time.perf_counter() - t_phase:.1f} s; {smi}")
    return serve_launches, MESH_TRAIN_STEPS * 2 * L, MESH_TRAIN_STEPS * L


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
    built = ptxas_kernels(_build.BUILD_INFO["ptxas"])
    log(f"[build] {_build.BUILD_INFO['seconds']:.1f} s -> "
        f"{_build.BUILD_INFO['path']}; ptxas (kernel: registers, spill "
        f"stores/loads bytes): " + " | ".join(
            f"{n}: {r}, {st}/{ld}" for n, r, st, ld in built))
    if not _build.BUILD_INFO["ptxas"]:
        raise AssertionError(f"no ptxas report beside "
                             f"{_build.BUILD_INFO['path']}: remove the "
                             f"library so that it is built again")
    check_wide(built)

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
    compile_fused, compile_alu = phase_compile(_build.LAUNCHES, smi)
    mixed_launches = phase_serve_mixed(_build.LAUNCHES, smi)
    train_fwd, train_bwd, bwd_err = phase_train(_build.LAUNCHES, smi)
    family_prefill = phase_serve_families(_build.LAUNCHES, smi)
    zamba_fwd, zamba_bwd = phase_train_families(_build.LAUNCHES, smi)
    z7_fwd, z7_bwd = phase_train_zamba2_7b(_build.LAUNCHES, smi)
    moe_prefill = phase_serve_moe(_build.LAUNCHES, smi)
    moe_fwd, moe_bwd = phase_train_moe(_build.LAUNCHES, smi)
    audio_prefill_n, audio_enc = phase_serve_audio(_build.LAUNCHES, smi)
    audio_fwd, audio_bwd = phase_train_audio(_build.LAUNCHES, smi)
    vlm_prefill_n = phase_serve_vlm(_build.LAUNCHES, smi)
    vlm_fwd, vlm_bwd = phase_train_vlm(_build.LAUNCHES, smi)
    shard_launches = phase_shard_sm(_build.LAUNCHES, smi)
    mesh_serve, mesh_fwd, mesh_bwd = phase_mesh_lm(_build.LAUNCHES, smi)
    kernels.append(time_flash_bwd(train_bwd, bwd_err))
    shapes = time_family_shapes()
    kernels[2]["launches_by_path"] = {
        "serving prefill (phase 9)": flash_launches,
        "training (phase 17)": train_fwd,
        **{f"{arch} prefill (phase 18)": n
           for arch, n in family_prefill.items() if n},
        "zamba2-1.2b training (phase 19)": zamba_fwd,
        f"{ZAMBA2_7B} training step (phase 19b)": z7_fwd,
        **{f"{arch} prefill (phase 20)": n
           for arch, n in moe_prefill.items()},
        f"{TRAIN_MOE} training (phase 21)": moe_fwd,
        "whisper-medium prefill (phase 22)": audio_prefill_n,
        "whisper-medium encoder (phase 22)": audio_enc,
        "whisper-medium training (phase 23)": audio_fwd,
        "paligemma-3b prefill (phase 24)": vlm_prefill_n,
        "paligemma-3b training (phase 25)": vlm_fwd,
        "mesh serve (phase 27)": mesh_serve,
        "mesh train (phase 27)": mesh_fwd}
    kernels[2]["shapes"] = shapes["forward"]
    kernels[-1]["launches_by_path"] = {
        "qwen3-0.6b training (phase 17)": train_bwd,
        "zamba2-1.2b training (phase 19)": zamba_bwd,
        f"{ZAMBA2_7B} training step (phase 19b)": z7_bwd,
        f"{TRAIN_MOE} training (phase 21)": moe_bwd,
        "whisper-medium training (phase 23)": audio_bwd,
        "paligemma-3b training (phase 25)": vlm_bwd,
        "mesh train (phase 27)": mesh_bwd}
    kernels[-1]["shapes"] = shapes["backward"]
    for key in ("tc_dh256", "simt_dh256"):
        kernels[-1][key]["library_ms"] = shapes["library_bwd_dh256"]["ms"]
        kernels[-1][key]["library_backend"] = \
            shapes["library_bwd_dh256"]["backend"]
    pali = shapes["forward"]["paligemma MQA dh 256"]
    for key in ("tc", "simt"):
        kernels[2][f"{key}_dh256"] = dict(
            pali, variant=key, ms=pali["variant_ms"][key],
            shape=list(next(x for x in FAMILY_FWD_SHAPES
                            if x[0] == "paligemma MQA dh 256")[1:6]))
    kernels[0]["launches_by_path"] = {"staged path (phase 5)": alu_launches,
                                      "compiled binaries (phase 15)":
                                          compile_alu}
    kernels[1]["launches_by_path"] = {"main path (phase 6)": fused_launches,
                                      "paper tables n=32": paper32_launches,
                                      "paper tables n=256": paper256_launches,
                                      "serving runtime (phase 14)":
                                          serve_launches,
                                      "compiled binaries (phase 15)":
                                          compile_fused,
                                      "mixed serving (phase 16)":
                                          mixed_launches,
                                      "sharded executor (phase 26)":
                                          shard_launches}
    log(f"[done] {time.perf_counter() - t_start:.1f} s; {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
