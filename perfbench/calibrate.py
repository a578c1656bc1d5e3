"""Readings that set a cell's limits: its control at the cell's own
size, on the seeds given, one JSON line a seed.

    python3 perfbench/calibrate.py --workload <name> --seeds <n> [<n> ...]

The control is the plain reference put in the program's place and
computed a step below the precision the configuration states (or, where
it states none, with one of its guarantees broken), compared with the
reference as the cell's own check compares the program.  The
benchmark's runs do not run this; the limits in the drivers come from
its readings and from the program's own over a dozen seeds or more
(``PERF.md``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from perfbench import harness as H  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    H.prepare_environment()
    wl = H.workload(args.workload)
    cfg = H.config(wl["config"])
    mod = H.driver(wl["driver"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = mod.controls(wl, cfg, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
