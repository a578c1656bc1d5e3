"""Offer an open-loop cell's traffic at several rates, one server each,
and print what each sustained, one JSON line a rate: the sweep that
fixes a serving cell's rate (four fifths of the highest rate whose
backlog does not grow).

    python3 perfbench/sweep.py --workload <name> --seed <n> \
        --seconds <s> --rates <hz> [<hz> ...]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from perfbench import harness as H  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    H.prepare_environment()
    wl = H.workload(args.workload)
    mod = H.driver(wl["driver"])
    for row in mod.sweep(wl, H.config(wl["config"]), args.seed, args.rates,
                         args.seconds):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
