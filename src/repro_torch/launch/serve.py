"""Batched serving: one prefill step, then token-by-token decode
(port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --reduced --batch 4 --prompt-len 32 --gen 32 --device cpu

The prompt is prefilled in one ``serve_step`` of (B, P) tokens at cache
index 0, the step the JAX package lowers for its prefill cells; on the
card its attention is the flash kernel.  Decode is then one token at a
time.  The vlm family is served text only, without image patches, as the
JAX CLI serves it.  Runs on the card unless ``--device cpu``; weights are
random, made from ``--seed``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import configs
from ..core.pipeline.state import resolve_device
from ..models import api
from .steps import build_serve_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    spec = configs.get(args.arch)
    if args.reduced:
        spec = configs.reduced(spec)
    dev = resolve_device(args.device)
    max_seq = args.prompt_len + args.gen

    params = api.init(torch.Generator(device=dev).manual_seed(args.seed),
                      spec)
    state = api.decode_state(spec, args.batch, max_seq, device=dev)
    step = build_serve_step(spec)
    rng = np.random.default_rng(args.seed)
    vocab = spec.cfg.lm.vocab if spec.family == "vlm" else spec.cfg.vocab
    prompt = rng.integers(0, vocab, (args.batch, args.prompt_len))
    prompt = torch.as_tensor(prompt, device=dev)

    # prefill: one step of (B, P) tokens at cache index 0
    t0 = time.perf_counter()
    tok, state = step(params, state, prompt, 0)
    _sync(dev)
    prefill_t = time.perf_counter() - t0

    out = []
    t0 = time.perf_counter()
    for i in range(args.gen):
        tok, state = step(params, state, tok[:, None], args.prompt_len + i)
        out.append(tok)
    _sync(dev)
    decode_t = time.perf_counter() - t0

    gen = torch.stack(out, 1).cpu().numpy()
    print(f"[serve] batch={args.batch} prefill={args.prompt_len}tok "
          f"({prefill_t:.2f}s) decode={args.gen}tok ({decode_t:.2f}s, "
          f"{args.gen * args.batch / max(decode_t, 1e-9):.1f} tok/s)")
    print("first sequences:", gen[:2, :12].tolist())
    return gen


if __name__ == "__main__":
    main()
