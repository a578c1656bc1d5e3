"""An architect's batch on the overlay: a closed loop of one client whose
every turn executes the cell's programs in one batch of the program's
executor (``runtime.executor.execute``) and reads the results back
(``to_results``, ``report``).

Inputs: the frozen binaries of ``perfbench/data`` and global memories
drawn from the seed into a pool made in set-up; turns cycle through the
pool.  A seeded sample of the window's batches (``check_batches``) is
kept and, once the window has closed, compared in full with the plain
reference (``reference/overlay.py``) run on the card: every word of every
launch's final global memory, its six counters, every block's cycles and
the per-SM cycles.
"""
from __future__ import annotations

import random

import numpy as np

from perfbench import counts, harness as H
from perfbench.inputs import make_gmem, programs
from perfbench.reference import overlay as R


class Cell(H.ClosedLoopCell):
    def setup(self) -> None:
        from repro_torch.core.pipeline.state import MachineConfig
        from repro_torch.runtime import executor
        self.executor = executor
        self.machine = MachineConfig(
            **self.cfg["machine"], execute_backend=self.cfg["execute_backend"])
        self.progs = programs(self.cfg["programs"], self.wl["programs"])
        rng = np.random.default_rng(self.seed)
        self.pool = [[make_gmem(rng, self.progs[k]) for k in self.progs]
                     for _ in range(self.wl["pool"])]
        self.codes = [np.asarray(p["code"], np.int32)
                      for p in self.progs.values()]
        self.sampler = random.Random(self.seed)
        self.kept, self.seen, self.issues, self.i = [], 0, 0, 0
        for _ in range(2):                   # builds, loads, predecodes
            self.turn()
        self.kept, self.seen, self.issues, self.i = [], 0, 0, 0

    def launches(self, j: int):
        return [self.executor.LaunchSpec(c, tuple(p["grid"]),
                                         tuple(p["block_dim"]), g)
                for c, p, g in zip(self.codes, self.progs.values(),
                                   self.pool[j])]

    def turn(self) -> None:
        j = self.i % len(self.pool)
        self.i += 1
        dg = self.executor.execute(self.launches(j),
                                   n_sm=self.cfg["n_sm"], cfg=self.machine,
                                   device=H.DEVICE)
        res = dg.to_results()
        sm = dg.report().per_sm_cycles
        self.issues += sum(int(r.op_issues.sum()) for r in res)
        # a seeded reservoir sample of the batches for the check
        self.seen += 1
        k = self.wl["check_batches"]
        if len(self.kept) < k:
            self.kept.append((j, res, sm))
        else:
            r = self.sampler.randrange(self.seen)
            if r < k:
                self.kept[r] = (j, res, sm)

    def rates(self, turns: int, window_s: float) -> dict:
        issues, self.issues = self.issues, 0
        return {"sim_issues_per_s": issues / window_s}

    def facts(self) -> dict:
        blocks = [int(np.prod(p["grid"])) for p in self.progs.values()]
        return {"batch_bytes": counts.overlay_batch_bytes(
                    blocks, [p["gmem_words"] for p in self.progs.values()],
                    [c.size for c in self.codes])}

    def check(self):
        m = R.Machine(**self.cfg["machine"])
        total = {"gmem_words": 0, "counters": 0, "sm_cycles": 0}
        for j, res, sm in self.kept:
            want, want_sm = R.run_batch(
                m, [R.Launch(c, tuple(p["grid"]), tuple(p["block_dim"]), g)
                    for c, p, g in zip(self.codes, self.progs.values(),
                                       self.pool[j])],
                self.cfg["n_sm"], device=H.DEVICE)
            for k, v in R.mismatches(res, sm, want, want_sm).items():
                total[k] += v
        return [("gmem_words_differing", total["gmem_words"], 0),
                ("counters_differing", total["counters"], 0),
                ("sm_cycles_differing", total["sm_cycles"], 0)]


def controls(wl: dict, cfg: dict, seed: int) -> dict:
    """The reference against itself with the control: the cycle model
    of a 32-lane SM in place of the stated n_sp = 8 (every warp issued
    in one row), on the batch of the seed's first pool entry."""
    progs = programs(cfg["programs"], wl["programs"])
    rng = np.random.default_rng(seed)
    gmems = [make_gmem(rng, p) for p in progs.values()]
    launches = [R.Launch(np.asarray(p["code"], np.int32), tuple(p["grid"]),
                         tuple(p["block_dim"]), g)
                for p, g in zip(progs.values(), gmems)]
    want = R.run_batch(R.Machine(**cfg["machine"]), launches, cfg["n_sm"],
                       device=H.DEVICE)
    ctl = R.run_batch(R.Machine(**dict(cfg["machine"], n_sp=32)), launches,
                      cfg["n_sm"], device=H.DEVICE)
    return {"control_n_sp_32": R.mismatches(*ctl, *want)}
