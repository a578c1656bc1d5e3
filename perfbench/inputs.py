"""The overlay's inputs, shared by every driver that runs its programs:
the frozen binaries and input layouts of ``perfbench/data``, and global
memories drawn from a seeded generator."""
from __future__ import annotations

import json

import numpy as np

from perfbench import harness as H


def programs(path: str, names=None) -> dict:
    """The frozen binaries and input layouts of the data file ``path``
    (relative to the checkout), those named or all of them."""
    data = json.loads((H.ROOT / path).read_text())
    return data if names is None else {k: data[k] for k in names}


def make_gmem(rng: np.random.Generator, prog: dict) -> np.ndarray:
    """A program's initial global memory: its inputs drawn uniformly in
    their stated ranges (where an input states a density, each entry is
    kept with that chance and zero otherwise), its parameter words set."""
    g = np.zeros(prog["gmem_words"], np.int32)
    for inp in prog["inputs"]:
        x = rng.integers(inp["low"], inp["high"], inp["count"],
                         dtype=np.int32)
        if inp.get("density", 1.0) < 1.0:
            x[rng.random(inp["count"]) >= inp["density"]] = 0
        g[inp["at"]:inp["at"] + inp["count"]] = x
    for par in prog["params"]:
        g[par["at"]] = par["value"]
    return g
