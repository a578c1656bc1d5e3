#!/usr/bin/env python3
"""Time one full-width qwen3-0.6b training step and the flash backward of
one source tree, so that two trees can be compared on one card in one
run.

    python3 scripts/train_step_ab.py SRC [--walls 5] [--profiles 2]

``SRC`` is the ``src`` directory of a checkout of this repository (this
one's, or an older commit's unpacked with ``git archive``); its
``repro_torch`` is imported and its kernels built into ``SRC/../build``.
Needs one NVIDIA Hopper card.  It measures

* ``launch.steps.build_train_step`` on qwen3-0.6b at full width, random
  bf16 weights from seed 0, one batch of 8 x 512 tokens of the synthetic
  stream, AdamW: the host clock around ``--walls`` steps after one
  warm-up, each ending in a device sync, and ``--profiles`` steps under
  ``torch.profiler`` (the sum of the kernels' device time, and the kernel
  launches);
* ``flash_attention_bwd`` at the training shape (B 8, S 512, 16/8 heads,
  dh 128, bf16, causal) on inputs from a seeded generator: device ms a
  call (CUDA events around 20 calls queued behind a spin kernel), and
  each of its kernels' device ms a launch from ``torch.profiler``.

It prints one JSON line with the card's name and power limit.  Run trees
in turns (A, B, B, A) in one call to compare them.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

# cuBLAS is deterministic only with a fixed workspace (the train step
# runs under torch.use_deterministic_algorithms)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

B, S, H, KH, DH = 8, 512, 16, 8, 128


def profiled(fn):
    """(device ms, kernel launches, {kernel name: (launches, device ms)})
    of one run of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = {e.key: (e.count, e.self_device_time_total / 1e3)
               for e in events if e.device_type.name == "CUDA"}
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    return sum(ms for _, ms in kernels.values()), launches, kernels


def device_ms(fn, reps: int) -> float:
    """Mean device ms of one ``fn()``: the calls queued behind a spin
    kernel, so that the device runs them back to back."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def train_step(walls: int, profiles: int) -> dict:
    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import api
    from repro_torch.optim import OptConfig, opt_init
    spec = configs.get("qwen3-0.6b")
    params = api.init(torch.Generator(device="cuda").manual_seed(0), spec)
    opt_cfg = OptConfig()
    batch = SyntheticLM(DataConfig(vocab=spec.cfg.vocab, seq_len=S,
                                   global_batch=B, seed=0),
                        device="cuda").batch(0)
    step = build_train_step(spec, opt_cfg)
    state = opt_init(params, opt_cfg)

    def one_step():
        step(params, state, batch)

    one_step()
    torch.cuda.synchronize()
    wall_ms = []
    for _ in range(walls):
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
    runs = [profiled(one_step)[:2] for _ in range(profiles)]
    return {"wall_ms": wall_ms, "device_ms": [d for d, _ in runs],
            "launches": [n for _, n in runs]}


def flash_bwd() -> dict:
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(18)

    def rand(shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    q, do = rand((B, S, H, DH)), rand((B, S, H, DH))
    k, v = rand((B, S, KH, DH)), rand((B, S, KH, DH))
    o, lse = fa._launch(q, k, v, True, None, want_lse=True)
    _build.VARIANTS.clear()

    def call():
        fa.flash_attention_bwd(q, k, v, o, do, lse, causal=True)

    ms = device_ms(call, 20)
    call()
    _, _, kernels = profiled(lambda: [call() for _ in range(10)])
    return {"ms": ms, "kernel_ms": {name: t / n for name, (n, t)
                                    in kernels.items()},
            "variants": {f"{k[0]}/{k[1]}": n
                         for k, n in _build.VARIANTS.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", type=Path)
    ap.add_argument("--walls", type=int, default=5)
    ap.add_argument("--profiles", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_step_ab.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    out = {"src": str(args.src), "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()}
    out["train_step"] = train_step(args.walls, args.profiles)
    torch.cuda.empty_cache()
    out["flash_bwd"] = flash_bwd()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
