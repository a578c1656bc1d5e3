"""Multi-SM executor: blocks from one or more launches, round-robin SMs
(port of ``repro.runtime.executor``).

The paper's block scheduler (§4.3) assigns thread blocks to SMs
round-robin; Table 3's two-SM scalings follow from ``max over SMs of (sum
of its blocks' cycles)``.  The schedule is executed:

* the global block list — the concatenation of every launch's blocks — is
  laid out position-major, so position ``p`` runs on SM ``p % n_sm`` in
  super-step ``p // n_sm``;
* each dispatch group covers ``spd × n_sm`` positions, ``spd`` halving
  for a ragged tail exactly as in the JAX package; on the card the whole
  group is one launch of the fused kernel, one CTA per position;
* the schedule (geometry, launch and SM of each position, the predecoded
  programs) goes to the device once, so the group loop
  (:func:`run_groups`) makes no synchronizing call and the host queues
  the next group while the card runs this one;
* every position runs on a private copy of its launch's gmem as it stood
  when the group started;
* write sets merge into each launch's global memory in position order
  (last writer wins), bit-exact with sequential block-order resolution;
* per-SM cycle counters accumulate in int64 from the executed blocks
  (``BLOCK_SCHED_OVERHEAD`` per block), cross-checked against the
  analytical replay :meth:`GridResult.per_sm_cycles`.

The stacked gmem holds ``bucket_launches(L)`` rows, as the JAX package's
does, so ``MultiSMReport.device_gmem_words`` and ``padded_gmem_words`` are
the reference's figures and what the allocation holds; the padding rows
stay zero and no position names them.

Differences from the JAX package, none of which changes a result: there
is no jit-shape cache to feed, so the SM width is not padded to a bucket
unless the caller asks (``pad_warps``), and a group's padding positions
are not run; the per-SM accumulator is int64 rather than split hi/lo
int32 lanes, so it has no blocks-per-SM bound.
Sharding across devices (``shard_sm`` on more than one device) waits.

Host<->device crossings are counted at the reference's three seams
(``transfers.*`` in :data:`repro_torch.obs.METRICS`, viewed through
:data:`TRANSFERS`): ``gmem_uploads`` where ``execute`` takes a launch
memory that is not yet a tensor on its device, ``counter_syncs`` at the
one counter fetch of a :class:`DeviceGrid`, ``gmem_syncs`` per launch
materialized by ``to_results(host_gmem=True)``.  Each dispatch group runs
in a ``"device-execute"`` span and the counter fetch in a
``"counter-sync"`` span of :data:`repro_torch.obs.TRACER`; both are host
bookkeeping and add no synchronizing call.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core import isa
from ..core.pipeline import MachineConfig
from ..core.pipeline.fused import (C_CYCLES, C_STEPS, counters_from_rows,
                                   fused_sm_run, predecode, staged_run)
from ..core.pipeline.state import as_int32, on_device, resolve_device
from ..obs import METRICS, TRACER
from . import registry as reg
from .registry import Module, ModuleRegistry

# Cycles the block scheduler spends dispatching one block (parameter pass,
# register-file id init — §3.1 "initializes registers ... with thread IDs").
BLOCK_SCHED_OVERHEAD = 24


def _transfer(field: str) -> None:
    """Count one host<->device crossing (``transfers.<field>`` counter)."""
    METRICS.counter("transfers." + field).inc()


class TransferLog:
    """A *view* over the ``transfers.*`` registry counters, with the JAX
    package's interface.

    The executor's transfer counts — ``gmem_uploads`` (host memory
    copied onto the device in :func:`execute`), ``gmem_syncs``
    (per-launch gmem materializations in :meth:`DeviceGrid.to_results`
    with ``host_gmem=True``) and ``counter_syncs`` (the one batched
    accounting fetch in :meth:`DeviceGrid._host_fetch`) — live in
    :data:`repro_torch.obs.METRICS` as ``transfers.*`` counters.  Each
    view holds a per-field baseline: ``reset()`` re-bases it (the
    counters are monotone and never rewind), and attribute reads return
    *counter − baseline*.  :meth:`window` returns an independent
    zero-based view — scoped measurement without moving the shared
    ``TRANSFERS`` baseline other code may rely on.
    """

    _FIELDS = ("gmem_uploads", "gmem_syncs", "counter_syncs")

    def __init__(self) -> None:
        self._base = {f: 0 for f in self._FIELDS}
        self.reset()

    def _raw(self, field: str) -> int:
        return METRICS.counter("transfers." + field).value

    def __getattr__(self, name: str) -> int:
        if name in self._FIELDS:
            return self._raw(name) - self._base[name]
        raise AttributeError(name)

    def reset(self) -> "TransferLog":
        """Re-base this view: all three fields read 0 until the next
        crossing.  Registry counters are untouched."""
        for f in self._FIELDS:
            self._base[f] = self._raw(f)
        return self

    def window(self) -> "TransferLog":
        """A fresh zero-based view over the same counters — the scoped
        measurement idiom (``w = TRANSFERS.window(); ...; w.gmem_syncs``)
        that cannot disturb other holders' baselines."""
        return TransferLog()

    def snapshot(self) -> dict:
        return {f: getattr(self, f) for f in self._FIELDS}


#: Process-wide transfer-counter view (see :class:`TransferLog`; the
#: counters themselves live in ``repro_torch.obs.METRICS``).
TRANSFERS = TransferLog()

#: Launch-batch-width buckets: a drain of L concurrent launches pads its
#: stacked gmem to the next bucket, as the JAX package does for its
#: jit-shape cache.
LAUNCH_BUCKETS = (1, 2, 4, 8, 16, 32)


def bucket_launches(n: int) -> int:
    return reg.bucket(n, LAUNCH_BUCKETS, 32)


class GridResult(NamedTuple):
    """Per-launch result: final memory plus the paper's activity counters
    (host numpy).  ``gmem`` is a device tensor under
    ``DeviceGrid.to_results(host_gmem=False)``."""
    gmem: np.ndarray            # final global memory (original length)
    cycles_per_block: np.ndarray
    op_issues: np.ndarray       # (NUM_OPCODES,) int64, summed over blocks
    op_lanes: np.ndarray        # (NUM_OPCODES,) int64
    stack_ops: int
    max_sp: int
    overflow: bool

    def per_sm_cycles(self, n_sm: int) -> np.ndarray:
        """Analytical per-SM cycle totals under round-robin assignment —
        the cross-check for the executed counters of MultiSMReport."""
        cyc = np.asarray(self.cycles_per_block,
                         np.int64) + BLOCK_SCHED_OVERHEAD
        return np.bincount(np.arange(len(cyc)) % n_sm, weights=cyc,
                           minlength=n_sm).astype(np.int64)

    def sm_cycles(self, n_sm: int) -> int:
        """Kernel time on ``n_sm`` SMs under round-robin block assignment."""
        return int(self.per_sm_cycles(n_sm).max())


class MultiSMReport(NamedTuple):
    """Executed-schedule timing: per-SM counters out of the run itself."""
    n_sm: int
    per_sm_cycles: np.ndarray   # (n_sm,) int64 — executed, not replayed
    n_steps: int                # super-steps in the executed schedule
    n_blocks: int               # real (non-padding) blocks executed
    device_gmem_words: int = 0  # words the stacked gmem allocation holds
    useful_gmem_words: int = 0  # words the launches actually asked for
    max_sp: int = 0             # warp-stack high-water mark (max over blocks)
    overflow: bool = False      # any block's warp stack overflowed

    @property
    def kernel_cycles(self) -> int:
        """Makespan of this dispatch group: the busiest SM's cycles.
        Sub-batches of a drain run back-to-back, so a drain's makespan
        is the sum of its groups' kernel_cycles — the duration the
        cost-model policies (``BalancedDrain``) minimize."""
        return int(self.per_sm_cycles.max())

    @property
    def busy_cycles(self) -> int:
        """Total SM-cycles of real work in this group (sum over SMs).
        ``busy / (n_sm * kernel_cycles)`` is the drain-level
        ``DrainStats.duration_balance``."""
        return int(self.per_sm_cycles.sum())

    @property
    def padded_gmem_words(self) -> int:
        """Memory the bucketing wasted: allocation minus requested words.

        This is the per-dispatch-group cost the drain policies minimize —
        a monolithic drain pads every tenant to the batch-wide max gmem
        bucket; bucket-keyed sub-batching keeps it near zero.
        """
        return self.device_gmem_words - self.useful_gmem_words

    @property
    def occupancy(self) -> float:
        """Fraction of SM-step slots holding a real (non-padding) block."""
        slots = self.n_steps * self.n_sm
        return self.n_blocks / slots if slots else 0.0


class LaunchSpec(NamedTuple):
    """One kernel launch: binary (or Module), geometry, global memory."""
    code: Union[np.ndarray, Module]
    grid: Tuple[int, int]
    block_dim: Union[int, Tuple[int, int]]
    gmem: object                # np.ndarray or torch.Tensor


def _norm_block_dim(block_dim) -> Tuple[int, int]:
    if isinstance(block_dim, tuple):
        return block_dim
    return block_dim, 1


def warps_for(block_dim) -> int:
    """Warps one block of ``block_dim`` threads occupies."""
    bdx, bdy = _norm_block_dim(block_dim)
    return -(-bdx * bdy // isa.WARP_SIZE)


def _block_positions(grid: Tuple[int, int]) -> np.ndarray:
    """(gx*gy, 2) block coordinates in the scheduler's launch order."""
    gx, gy = grid
    xs, ys = np.meshgrid(np.arange(gx), np.arange(gy))
    return np.stack([xs.ravel(), ys.ravel()], 1).astype(np.int32)


class DeviceGrid:
    """Results of an executed multi-launch schedule, on the device they
    ran on; ``report`` and ``to_results`` fetch the counters to the host
    once."""

    def __init__(self, *, gmems: torch.Tensor, ctr: torch.Tensor,
                 sm_cyc: torch.Tensor, n_sm: int, n_steps: int,
                 launch_offsets: Sequence[int], launch_blocks: Sequence[int],
                 orig_lens: Sequence[int]):
        self._gmems = gmems              # (bucket_launches(L), G) int32
        self._ctr = ctr                  # (n_blocks, N_CTR) int32
        self._sm_cyc = sm_cyc            # (n_sm,) int64
        self.n_sm = n_sm
        self.n_steps = n_steps
        self._offsets = list(launch_offsets)
        self._blocks = list(launch_blocks)
        self._orig_lens = list(orig_lens)
        self._host: Optional[tuple] = None
        self._results: dict = {}

    def launch_gmem(self, i: int) -> torch.Tensor:
        """Launch ``i``'s final global memory, on the device."""
        return self._gmems[i, :self._orig_lens[i]]

    def _host_fetch(self) -> tuple:
        """Per-block counter rows and per-SM cycles, fetched once."""
        if self._host is None:
            _transfer("counter_syncs")
            with TRACER.span("counter-sync", n_sm=self.n_sm,
                             n_blocks=int(sum(self._blocks))):
                self._host = (self._ctr.cpu().numpy().astype(np.int64),
                              self._sm_cyc.cpu().numpy())
        return self._host

    def block_steps(self) -> np.ndarray:
        """Lockstep steps each block took, in block-position order."""
        return self._host_fetch()[0][:, C_STEPS]

    def report(self) -> MultiSMReport:
        """Executed per-SM cycle counters and divergence telemetry."""
        ctr, sm_cyc = self._host_fetch()
        c = counters_from_rows(ctr)
        nb = int(sum(self._blocks))
        return MultiSMReport(
            n_sm=self.n_sm, per_sm_cycles=sm_cyc.astype(np.int64),
            n_steps=self.n_steps, n_blocks=nb,
            device_gmem_words=int(self._gmems.numel()),
            useful_gmem_words=int(sum(self._orig_lens)),
            max_sp=int(c.max_sp.max()) if nb else 0,
            overflow=bool(c.overflow.any()))

    def to_results(self, host_gmem: bool = True) -> List[GridResult]:
        """One :class:`GridResult` per launch, memoized per flag.  With
        ``host_gmem=True`` (default) each launch's final gmem is synced to
        numpy; ``host_gmem=False`` leaves the ``gmem`` fields as device
        tensors (the resident serving mode).  Counters come from the one
        host fetch either way."""
        if host_gmem in self._results:
            return self._results[host_gmem]
        ctr, _ = self._host_fetch()
        c = counters_from_rows(ctr)
        out = []
        for i, (off, nb) in enumerate(zip(self._offsets, self._blocks)):
            sl = slice(off, off + nb)
            gmem = self.launch_gmem(i)
            if host_gmem:
                _transfer("gmem_syncs")
                gmem = gmem.cpu().numpy()
            out.append(GridResult(
                gmem=gmem,
                cycles_per_block=c.cycles[sl],
                op_issues=c.op_issues[sl].sum(0),
                op_lanes=c.op_lanes[sl].sum(0),
                stack_ops=int(c.stack_ops[sl].sum()),
                max_sp=int(c.max_sp[sl].max()),
                overflow=bool(c.overflow[sl].any())))
        self._results[host_gmem] = out
        return out


@functools.lru_cache(maxsize=64)
def _records(codes: bytes, shape: Tuple[int, ...],
             cfg: MachineConfig) -> torch.Tensor:
    """:func:`predecode` of the programs ``codes`` (int32 bytes of
    ``shape``) on the host, once per programs and configuration."""
    x = np.frombuffer(codes, np.int32).reshape(shape)
    return predecode(torch.from_numpy(x.copy()), cfg)


class Schedule(NamedTuple):
    """The dispatch schedule of one :func:`execute`, uploaded once: one
    geometry row per position (:data:`GEOM_FIELDS` of the fused kernel),
    on the host and on the device, each position's launch and SM, and the
    programs' predecoded records (the fused backend on the card only;
    elsewhere each group runs the plain staged pipeline)."""
    geom: np.ndarray                  # (n_blocks, 8) int32
    geom_dev: torch.Tensor            # the same rows on the device
    launch_ids: torch.Tensor          # (n_blocks,) int32
    sm_ids: torch.Tensor              # (n_blocks,) int32
    records: Optional[torch.Tensor]   # (L, C, 4) int32, or None


def group_bounds(n_blocks: int, n_sm: int,
                 chunk: int) -> List[Tuple[int, int]]:
    """The dispatch groups of ``n_blocks`` positions as (lo, hi) bounds.
    Position p runs on SM ``p % n_sm`` in super-step ``p // n_sm``; a group
    spans ``spd`` super-steps, ``chunk // n_sm`` at most, ``spd`` halving
    while the rest still fits."""
    spd_max, lo, out = max(1, chunk // n_sm), 0, []
    while lo < n_blocks:
        spd = spd_max
        while spd // 2 >= -(-(n_blocks - lo) // n_sm):
            spd //= 2
        hi = min(lo + spd * n_sm, n_blocks)
        out.append((lo, hi))
        lo = hi
    return out


def run_groups(cfg: MachineConfig, n_warps: int, n_sm: int, chunk: int,
               codes: torch.Tensor, sched: Schedule, gmems: torch.Tensor):
    """The dispatch-group loop: each group's gmem snapshots, one run of its
    positions, the position-order merge into ``gmems`` (in place) and the
    per-SM cycle sums.  Returns (counter rows (n_blocks, N_CTR), per-SM
    cycles (n_sm,) int64), both on the device.

    With the fused backend on the card it makes no synchronizing call, so
    the host queues group g+1 while group g runs: it reads only host
    geometry and device tensors sliced from ``sched``."""
    sm_cyc = torch.zeros(n_sm, dtype=torch.int64, device=gmems.device)
    ctr_groups = []
    bucket = f"c{codes.shape[1]}g{gmems.shape[1]}w{n_warps}sm{n_sm}"
    for lo, hi in group_bounds(len(sched.geom), n_sm, chunk):
        geom = sched.geom[lo:hi]
        with TRACER.span("device-execute", bucket=bucket, width=hi - lo,
                         n_blocks=hi - lo, n_sm=n_sm):
            snap = gmems.index_select(0, sched.launch_ids[lo:hi])
            if sched.records is None:
                mem, wrt, ctr = staged_run(cfg, n_warps, codes, geom, snap)
            else:
                mem, wrt, ctr = fused_sm_run(
                    cfg, n_warps, codes, geom, snap, records=sched.records,
                    geom_dev=sched.geom_dev[lo:hi])
            # position-order merge: later positions overwrite earlier ones
            for p, li in enumerate(geom[:, 0].tolist()):
                gmems[li] = torch.where(wrt[p], mem[p], gmems[li])
            cost = ctr[:, C_CYCLES].to(torch.int64) + BLOCK_SCHED_OVERHEAD
            sm_cyc.index_add_(0, sched.sm_ids[lo:hi], cost)
        ctr_groups.append(ctr)
    return torch.cat(ctr_groups), sm_cyc


def execute(launches: Sequence[LaunchSpec], n_sm: int = 1,
            cfg: MachineConfig = MachineConfig(), chunk: int = 8,
            pad_warps: Optional[int] = None,
            registry: Optional[ModuleRegistry] = None,
            shard_sm: bool = False, device="cuda") -> DeviceGrid:
    """Execute the blocks of ``launches`` round-robin across ``n_sm`` SMs.

    Blocks may not communicate (true of the paper's benchmarks); write
    sets merge in global block order after each dispatch group.  ``chunk``
    bounds the positions per group (rounded to a multiple of ``n_sm``).
    The SM is as wide as the widest launch's block, or ``pad_warps`` warps
    (the serving path pads all tenants to one width; warps beyond a
    launch's threads start FINISHED, so counters stay exact); fewer than
    the widest launch needs raises.  ``registry`` replaces the default
    module registry.  ``shard_sm=True`` runs this single-device path
    where only one device exists, as the JAX package falls back to it;
    with more than one CUDA device it raises (not yet ported).  Runs on
    the card unless ``device="cpu"``; without a card it raises.
    """
    dev = resolve_device(device)
    if not launches:
        raise ValueError("execute() needs at least one launch")
    if shard_sm and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            "execute(shard_sm=True) across several CUDA devices is not yet "
            "ported (ROADMAP queue 1 item 9, multi-GPU shard_sm)")
    if registry is None:       # an empty registry is falsy: test for None
        registry = _default_registry
    mods = [registry.as_module(l.code) for l in launches]
    code_len = max(m.padded_len for m in mods)
    codes = np.stack([reg.pad_code(m.code, code_len) for m in mods])
    orig_lens, pos_l, offsets, nblocks = [], [], [], []
    for i, (launch, mod) in enumerate(zip(launches, mods)):
        bdx, bdy = _norm_block_dim(launch.block_dim)
        orig_lens.append(int(launch.gmem.shape[0]))
        bxys = _block_positions(launch.grid)
        if len(bxys) == 0:
            raise ValueError(
                f"launch {i} ({mod.name}) has an empty grid "
                f"{launch.grid} (0 blocks)")
        offsets.append(sum(nblocks))
        nblocks.append(len(bxys))
        # geometry row per position: launch, bdim, bdx, bdy, bx, by, gx, gy
        rows = np.empty((len(bxys), 8), np.int32)
        rows[:, :4] = (i, bdx * bdy, bdx, bdy)
        rows[:, 4:6] = bxys
        rows[:, 6:] = launch.grid
        pos_l.append(rows)

    g_width = reg.bucket_gmem_len(max(orig_lens))
    gmems = torch.zeros((bucket_launches(len(launches)), g_width),
                        dtype=torch.int32, device=dev)
    for i, launch in enumerate(launches):
        g = launch.gmem
        if not on_device(g, dev):
            _transfer("gmem_uploads")        # host memory crossing over
        gmems[i, :orig_lens[i]] = as_int32(g, dev)

    warps_needed = max(warps_for(l.block_dim) for l in launches)
    n_warps = pad_warps or warps_needed
    if n_warps < warps_needed:
        widest = max(int(np.prod(_norm_block_dim(l.block_dim)))
                     for l in launches)
        raise ValueError(
            f"pad_warps={pad_warps} < {warps_needed} warps required by "
            f"the widest launch ({widest} threads) — threads beyond the "
            "padding would silently never run")
    geom = np.concatenate(pos_l)
    n_blocks = len(geom)
    # everything the group loop reads goes to the device once, here: the
    # programs, their records (predecoded on the host, cached), and one
    # buffer of the geometry rows, launch ids and SM ids of the positions
    codes_d = torch.as_tensor(codes, device=dev)
    buf = torch.as_tensor(np.concatenate(
        [geom.ravel(), geom[:, 0], np.arange(n_blocks) % n_sm]
    ).astype(np.int32), device=dev)
    sched = Schedule(
        geom=geom, geom_dev=buf[:8 * n_blocks].view(n_blocks, 8),
        launch_ids=buf[8 * n_blocks:9 * n_blocks],
        sm_ids=buf[9 * n_blocks:],
        records=(_records(codes.tobytes(), codes.shape, cfg).to(dev)
                 if cfg.execute_backend == "cuda_fused" and dev.type == "cuda"
                 else None))
    ctr, sm_cyc = run_groups(cfg, n_warps, n_sm, chunk, codes_d, sched,
                             gmems)
    return DeviceGrid(gmems=gmems, ctr=ctr, sm_cyc=sm_cyc,
                      n_sm=n_sm, n_steps=-(-n_blocks // n_sm),
                      launch_offsets=offsets, launch_blocks=nblocks,
                      orig_lens=orig_lens)


#: Registry behind bare execute()/run_grid() calls (bounded).
_default_registry = ModuleRegistry(max_modules=1024)


def run_grid(code, grid: Tuple[int, int], block_dim, gmem,
             cfg: MachineConfig = MachineConfig(), chunk: int = 8,
             n_sm: int = 1, pad_warps: Optional[int] = None,
             registry: Optional[ModuleRegistry] = None,
             device="cuda") -> GridResult:
    """Single-launch entry: execute and materialize."""
    dg = execute([LaunchSpec(code, grid, block_dim, gmem)],
                 n_sm=n_sm, cfg=cfg, chunk=chunk, pad_warps=pad_warps,
                 registry=registry, device=device)
    return dg.to_results()[0]
