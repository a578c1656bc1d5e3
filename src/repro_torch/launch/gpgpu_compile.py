"""Kernel compiler driver: DSL source -> IR -> optimized ISA binary (port
of ``repro.launch.gpgpu_compile``).

    PYTHONPATH=src python -m repro_torch.launch.gpgpu_compile histogram
    PYTHONPATH=src python -m repro_torch.launch.gpgpu_compile my_kernel.py \
        --params '{"n": 64}'
    PYTHONPATH=src python -m repro_torch.launch.gpgpu_compile --all

Compiles a DSL kernel — one of the bundled three (histogram, scan,
spmv) or a ``.py`` file defining ``kernel(k, **params)`` (and
optionally a ``PARAMS`` dict of defaults) — and prints the IR before
and after the pass pipeline, the per-pass instruction counts, the
final SASS-like listing, and the optimized-vs-naive emitted-
instruction saving (the paper's "CUDA binary in under a second",
with the compiler's win quantified per kernel).

``--all`` compiles every bundled kernel and exits non-zero if any
fails IR verification or register allocation — the CI compile-smoke
step.  ``--run`` additionally executes the binary against the
bundle's numpy oracle through ``run_grid`` on ``--device`` (default
``cuda``: the fused SM kernel on the card; ``cpu`` runs the plain PyTorch
path).  Without a card the CLI raises unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time

import numpy as np

from repro_torch import compiler
from repro_torch.compiler.kernels import COMPILED
from repro_torch.core import scheduler
from repro_torch.core.pipeline.state import resolve_device


def _load_file(path: str):
    spec = importlib.util.spec_from_file_location("dsl_kernel", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not hasattr(mod, "kernel"):
        raise SystemExit(
            f"{path}: a DSL kernel file must define kernel(k, **params)")
    return mod.kernel, dict(getattr(mod, "PARAMS", {}))


def _print_report(name: str, rep: compiler.CompileReport,
                  show_ir: bool, wall_s: float) -> None:
    naive, opt = rep.naive, rep.kernel
    if show_ir:
        print(f"=== {name}: IR as traced ===")
        print(opt.ir_before)
        print(f"=== {name}: pass pipeline ===")
        prev = None
        for pname, count in opt.pass_log:
            delta = "" if prev is None else f" ({count - prev:+d})"
            print(f"  {pname:<10s} {count:4d} IR instrs{delta}")
            prev = count
        print(f"=== {name}: IR after passes ===")
        print(opt.ir_after)
        print(f"=== {name}: listing ===")
        print(opt.listing)
    print(f"[compile] {name}: {naive.n_instr} naive -> {opt.n_instr} "
          f"optimized instructions "
          f"({rep.saved_instrs} saved, {rep.saving_pct:.0f}%), "
          f"{wall_s * 1e3:.0f} ms")


def _run_bundled(name: str, n: int, device) -> None:
    mod = COMPILED[name]
    code = mod.build(n)
    g0 = mod.make_gmem(np.random.default_rng(0), n)
    res = scheduler.run_grid(code, *mod.launch(n), g0.copy(), device=device)
    np.testing.assert_array_equal(res.gmem[mod.out_slice(n)],
                                  mod.oracle(g0, n))
    print(f"[compile] {name}: ran {mod.launch(n)} grid, "
          f"{int(res.cycles_per_block.sum())} cycles, oracle OK")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("kernel", nargs="?",
                    help="bundled kernel name "
                         f"({', '.join(sorted(COMPILED))}) or a .py "
                         "file defining kernel(k, **params)")
    ap.add_argument("--all", action="store_true",
                    help="compile every bundled kernel (CI smoke); "
                         "fails on any verification/regalloc error")
    ap.add_argument("-n", type=int, default=64,
                    help="input size for bundled kernels (default 64)")
    ap.add_argument("--params", type=str, default=None,
                    help="JSON dict of compile-time kernel parameters "
                         "(file kernels; overrides the file's PARAMS)")
    ap.add_argument("--no-ir", action="store_true",
                    help="summary line only (skip IR/listing dumps)")
    ap.add_argument("--run", action="store_true",
                    help="also execute bundled kernels against their "
                         "numpy oracle via run_grid")
    ap.add_argument("--device", default="cuda",
                    help="device --run executes on (default: cuda; cpu "
                         "runs the plain PyTorch path)")
    args = ap.parse_args(argv)

    if not args.all and not args.kernel:
        ap.error("pass a kernel name/file or --all")
    resolve_device(args.device)       # no card: raise before any work

    names = sorted(COMPILED) if args.all else [args.kernel]
    failures = 0
    for name in names:
        try:
            t0 = time.perf_counter()
            if name in COMPILED:
                rep = COMPILED[name].report(args.n)
            elif name.endswith(".py"):
                fn, params = _load_file(name)
                if args.params:
                    params.update(json.loads(args.params))
                rep = compiler.compile_report(fn, params)
            else:
                raise SystemExit(
                    f"unknown kernel {name!r}: not one of "
                    f"{sorted(COMPILED)} and not a .py file")
            wall = time.perf_counter() - t0
        except compiler.CompileError as e:
            print(f"[compile] {name}: FAILED: {e}", file=sys.stderr)
            failures += 1
            continue
        _print_report(name, rep, show_ir=not args.no_ir, wall_s=wall)
        if args.run and name in COMPILED:
            _run_bundled(name, args.n, args.device)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
