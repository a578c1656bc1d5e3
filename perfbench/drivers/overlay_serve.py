"""Tenants of the overlay's serving runtime: an open loop of Poisson
tenants submitting kernel launches through the program's
``runtime.service.ServingLoop`` (a ``RuntimeServer`` under its default
drain policy), at a rate fixed in the cell.

Each tenant's arrivals are a fixed number of launches (its share of the
rate times the window) at instants drawn once for the cell (uniformly
over the window from its ``arrival_seed``: Poisson arrivals of that
count), its work items a fixed multiset in an order drawn from the seed:
every seed offers the same work at the same instants, in another
order.  Each launch is timed from the instant the schedule made it due
to the instant its result could be read (its future resolved, seen by
the client's poll); a rejected, shed or failed launch enters the tail
as slower than any that completed.  How late the generator ran is
printed.

A seeded sample of the launches served, the largest item among them, is
compared once the window has closed with the plain reference
(``reference/overlay.py``) on the card: final global memory and the six
counters of each.
"""
from __future__ import annotations

import random
import sys
import time

import numpy as np

from perfbench import harness as H
from perfbench.inputs import make_gmem, programs
from perfbench.reference import overlay as R

#: the client's poll of its outstanding futures, seconds
POLL_S = 0.0005
#: how long past the window the client waits for its last results
GRACE_S = 60.0


def schedule(wl: dict, seconds: float, seed: int, rate: float) -> list:
    """(due, tenant, item, variant), in time order.  Each tenant's
    instants are Poisson arrivals of a fixed count over the window, drawn
    from the cell's own ``arrival_seed`` (the same for every run); the
    order of its items and their data come from ``seed``."""
    out = []
    for i, ten in enumerate(wl["tenants"]):
        n = int(round(rate * ten["share"] * seconds))
        clock = np.random.default_rng(
            np.random.SeedSequence([wl["arrival_seed"], i]))
        due = np.sort(clock.uniform(0.0, seconds, n))
        rng = np.random.default_rng(np.random.SeedSequence([seed, i]))
        items = [ten["items"][j % len(ten["items"])] for j in range(n)]
        order = rng.permutation(n)
        var = rng.integers(0, wl["variants"], n)
        out += [(float(due[j]), ten["name"], items[order[j]], int(var[j]))
                for j in range(n)]
    out.sort(key=lambda a: (a[0], a[1]))
    return out


class Cell:
    def __init__(self, workload: dict, config: dict, seed: int):
        self.wl, self.cfg, self.seed = workload, config, seed
        self.rate = workload["rate_hz"]

    def setup(self) -> None:
        from repro_torch.core.pipeline.state import MachineConfig
        from repro_torch.obs.metrics import MetricsRegistry
        from repro_torch.runtime.server import RuntimeServer
        from repro_torch.runtime.service import ServingLoop
        self.items = programs(self.wl["items"])
        rng = np.random.default_rng(self.seed)
        self.gmem = {k: [make_gmem(rng, p) for _ in range(self.wl["variants"])]
                     for k, p in sorted(self.items.items())}
        self.codes = {k: np.asarray(p["code"], np.int32)
                      for k, p in self.items.items()}
        self.metrics = MetricsRegistry()
        machine = MachineConfig(**self.cfg["machine"],
                                execute_backend=self.cfg["execute_backend"])
        self.server = RuntimeServer(n_sm=self.cfg["n_sm"], cfg=machine,
                                    metrics=self.metrics, device=H.DEVICE)
        self.loop = ServingLoop(self.server).start()
        self.sampler = random.Random(self.seed)
        self.biggest = max(self.items, key=lambda k: int(np.prod(
            self.items[k]["grid"])))
        # warm-up: the cell's own traffic for a while, at its rate
        self.kept, self.kept_big, self.seen, self.seen_big = [], [], 0, 0
        self.window(seconds=self.wl["warmup_s"], seed=self.seed + 7919)
        self.kept, self.kept_big, self.seen, self.seen_big = [], [], 0, 0

    def _keep(self, rec) -> None:
        """A seeded reservoir sample of the launches served, and one of
        the largest item's."""
        k = self.wl["check_launches"]
        self.seen += 1
        if len(self.kept) < k:
            self.kept.append(rec)
        elif self.sampler.randrange(self.seen) < k:
            self.kept[self.sampler.randrange(k)] = rec
        if rec[0] == self.biggest:
            self.seen_big += 1
            if not self.kept_big or \
                    self.sampler.randrange(self.seen_big) == 0:
                self.kept_big = [rec]

    def window(self, seconds: float, seed=None) -> dict:
        """One open-loop schedule of ``seconds``; the client then waits
        for the last results (``drain_s`` past the window's close)."""
        from repro_torch.runtime.policy import AdmissionError
        arrivals = schedule(self.wl, seconds, self.seed if seed is None
                            else seed, self.rate)
        self.metrics.reset()
        H.sync()
        open_, lat, late, failed = [], [], [], 0

        def poll(now):
            keep = []
            for rec in open_:
                fut, due = rec[0], rec[1]
                if not fut.done():
                    keep.append(rec)
                    continue
                try:
                    res = fut.result()
                except Exception:
                    lat.append(None)
                    continue
                lat.append(now - due)
                self._keep((rec[2], rec[3], res))
            open_[:] = keep

        t0 = time.perf_counter()
        for due, tenant, item, var in arrivals:
            target = t0 + due
            while True:
                now = time.perf_counter()
                if now >= target:
                    break
                poll(now)
                time.sleep(min(POLL_S, max(0.0, target - now)))
            p = self.items[item]
            try:
                fut = self.loop.submit(self.codes[item], tuple(p["grid"]),
                                       tuple(p["block_dim"]),
                                       self.gmem[item][var], client=tenant)
            except AdmissionError:
                lat.append(None)
                continue
            late.append(time.perf_counter() - target)
            open_.append((fut, target, item, var))
        t_close = t0 + seconds
        while open_ and time.perf_counter() < t_close + GRACE_S:
            poll(time.perf_counter())
            time.sleep(POLL_S)
        drain_s = time.perf_counter() - t_close
        failed = sum(x is None for x in lat) + len(open_)
        done = [x for x in lat if x is not None]
        worst = (max(done) if done else 0.0) + \
            (time.perf_counter() - t_close)
        tail = [worst if x is None else x for x in lat] + \
            [worst] * len(open_)
        p95 = H.quantile(tail, 0.95) * 1e3 if tail else 0.0
        if late:
            print(f"perfbench: generator late by p50 "
                  f"{H.quantile(late, 0.5) * 1e3:.3f} ms, max "
                  f"{max(late) * 1e3:.3f} ms over {len(late)} submits",
                  file=sys.stderr)
        return {"window_s": seconds, "turns": len(done),
                "attempted": len(arrivals), "failed": failed,
                "metrics": {"launch_p95_ms": p95},
                "queue_wait_p50_s": self.metrics.histogram(
                    "server.queue_wait_s").percentile(50),
                "completed": len(done), "drain_s": drain_s}

    def facts(self) -> dict:
        return {}

    def release(self) -> None:
        self.loop.stop(drain=True)

    def check(self):
        kept = self.kept + [r for r in self.kept_big
                            if all(r is not k for k in self.kept)]
        if not kept:
            return [("launches_compared", 0, -1)]
        m = R.Machine(**self.cfg["machine"])
        launches = [R.Launch(self.codes[item], tuple(self.items[item]["grid"]),
                             tuple(self.items[item]["block_dim"]),
                             self.gmem[item][var]) for item, var, _ in kept]
        want, _ = R.run_batch(m, launches, self.cfg["n_sm"], device=H.DEVICE)
        got = [res for _, _, res in kept]
        mis = R.mismatches(got, np.zeros(1), want, np.zeros(1))
        return [("gmem_words_differing", mis["gmem_words"], 0),
                ("counters_differing", mis["counters"], 0)]


def sweep(wl: dict, cfg: dict, seed: int, rates, seconds: float) -> list:
    """Each offered rate in turn, on a server of its own: the launches
    completed a second, the failures, p95, and how long the backlog took
    to drain after the window closed (a backlog that grows through the
    window shows as a drain that grows with it)."""
    out = []
    for rate in rates:
        cell = Cell(dict(wl, rate_hz=rate), cfg, seed)
        cell.setup()
        r = cell.window(seconds=seconds)
        out.append({"rate_hz": rate,
                    "completed_per_s": r["completed"] / seconds,
                    "failed": r["failed"], "drain_s": r["drain_s"],
                    "p95_ms": r["metrics"]["launch_p95_ms"]})
        cell.release()
    return out


def controls(wl: dict, cfg: dict, seed: int) -> dict:
    """The reference against itself with the control, the cycle model of
    a 32-lane SM in place of the stated n_sp = 8, on one launch of each
    of the cell's items drawn for ``seed``."""
    items = programs(wl["items"])
    rng = np.random.default_rng(seed)
    launches = [R.Launch(np.asarray(p["code"], np.int32), tuple(p["grid"]),
                         tuple(p["block_dim"]), make_gmem(rng, p))
                for _, p in sorted(items.items())]
    want, _ = R.run_batch(R.Machine(**cfg["machine"]), launches,
                          cfg["n_sm"], device=H.DEVICE)
    ctl, _ = R.run_batch(R.Machine(**dict(cfg["machine"], n_sp=32)),
                         launches, cfg["n_sm"], device=H.DEVICE)
    zero = np.zeros(1)
    return {"control_n_sp_32": R.mismatches(ctl, zero, want, zero)}
