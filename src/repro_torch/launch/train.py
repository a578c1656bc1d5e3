"""End-to-end training driver (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 200 --batch 8 --seq 256 --reduced --ckpt-dir ckpt \\
        --device cpu

What it runs, as the JAX CLI does on one device:

* the train step (``launch.steps.build_train_step``): loss, gradients and
  AdamW, under ``torch.use_deterministic_algorithms(True)``;
* deterministic synthetic data, stateless in (seed, step, shard);
* a checkpoint every ``--ckpt-every`` steps, committed atomically, and
  ``--restore auto`` to resume from the last committed step;
* a simulated preemption (``--die-at``, exit code 42) to show recovery:
  the resumed run ends with the uninterrupted run's parameters, bit for
  bit.

It runs on the card unless ``--device cpu``, and raises without one.  On
the card, cuBLAS is deterministic only with ``CUBLAS_WORKSPACE_CONFIG``
set before it starts; the CLI sets ``:4096:8`` unless the environment
already names one.  Parameters are random, made from ``--seed``.  The JAX
CLI's mesh has no counterpart on one card (``launch/steps``).
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from .. import configs
from ..ckpt import CheckpointManager
from ..core.pipeline.state import resolve_device
from ..data import DataConfig, SyntheticLM
from ..models import api
from ..optim import OptConfig, opt_init
from .steps import build_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config of the same family")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--restore", default=None, choices=[None, "auto"])
    ap.add_argument("--die-at", type=int, default=None,
                    help="simulate a node failure at this step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    spec = configs.get(args.arch)
    if args.reduced:
        spec = configs.reduced(spec)
    if spec.family in ("vlm", "audio"):
        raise SystemExit("use examples/multimodal_train.py for vlm/audio")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dev = resolve_device(args.device)

    opt_cfg = OptConfig(lr=args.lr)
    step_fn = build_train_step(spec, opt_cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(args.seed),
                      spec)
    opt_state = opt_init(params, opt_cfg)

    data = SyntheticLM(DataConfig(vocab=spec.cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed),
                       device=dev)
    start = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, every=args.ckpt_every)
        if args.restore == "auto":
            restored, start = mgr.resume({"params": params,
                                          "opt": opt_state})
            if restored is not None:
                params, opt_state = restored["params"], restored["opt"]
                print(f"[restore] resumed from step {start}")

    t0 = time.time()
    for step in range(start, args.steps):
        if args.die_at is not None and step == args.die_at:
            print(f"[failure-sim] dying at step {step} (restart with "
                  f"--restore auto)")
            raise SystemExit(42)
        params, opt_state, stats = step_fn(params, opt_state,
                                           data.batch(step))
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(stats["loss"])
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(stats['grad_norm']):7.3f} "
                  f"({(time.time() - t0):6.1f}s)", flush=True)
        if mgr:
            mgr.maybe_save(step + 1, {"params": params, "opt": opt_state})
    print(f"[done] {args.steps - start} steps in {time.time() - t0:.1f}s")
    return params


if __name__ == "__main__":
    main()
