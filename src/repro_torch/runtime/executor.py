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
* every position runs on a private copy of its launch's gmem as it stood
  when the group started;
* write sets merge into each launch's global memory in position order
  (last writer wins), bit-exact with sequential block-order resolution;
* per-SM cycle counters accumulate in int64 from the executed blocks
  (``BLOCK_SCHED_OVERHEAD`` per block), cross-checked against the
  analytical replay :meth:`GridResult.per_sm_cycles`.

Differences from the JAX package, none of which changes a result: there
is no jit-shape cache to feed, so neither the launch count nor the SM width
is padded to a bucket, and a group's padding positions are not run; the
per-SM accumulator is int64 rather than split hi/lo int32 lanes, so it has
no blocks-per-SM bound.
Sharding across devices, ``TransferLog`` and the tracing spans wait.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core import isa
from ..core.pipeline import MachineConfig
from ..core.pipeline.fused import (C_CYCLES, C_STEPS, counters_from_rows,
                                   fused_sm_run, staged_run)
from ..core.pipeline.state import as_int32, resolve_device
from . import registry as reg
from .registry import Module, ModuleRegistry

# Cycles the block scheduler spends dispatching one block (parameter pass,
# register-file id init — §3.1 "initializes registers ... with thread IDs").
BLOCK_SCHED_OVERHEAD = 24


class GridResult(NamedTuple):
    """Per-launch result: final memory plus the paper's activity counters
    (host numpy)."""
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
        self._gmems = gmems              # (L, G) int32
        self._ctr = ctr                  # (n_blocks, N_CTR) int32
        self._sm_cyc = sm_cyc            # (n_sm,) int64
        self.n_sm = n_sm
        self.n_steps = n_steps
        self._offsets = list(launch_offsets)
        self._blocks = list(launch_blocks)
        self._orig_lens = list(orig_lens)
        self._host: Optional[tuple] = None

    def launch_gmem(self, i: int) -> torch.Tensor:
        """Launch ``i``'s final global memory, on the device."""
        return self._gmems[i, :self._orig_lens[i]]

    def _host_fetch(self) -> tuple:
        """Per-block counter rows and per-SM cycles, fetched once."""
        if self._host is None:
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

    def to_results(self) -> List[GridResult]:
        """One :class:`GridResult` per launch, gmem synced to numpy."""
        ctr, _ = self._host_fetch()
        c = counters_from_rows(ctr)
        out = []
        for i, (off, nb) in enumerate(zip(self._offsets, self._blocks)):
            sl = slice(off, off + nb)
            out.append(GridResult(
                gmem=self.launch_gmem(i).cpu().numpy(),
                cycles_per_block=c.cycles[sl],
                op_issues=c.op_issues[sl].sum(0),
                op_lanes=c.op_lanes[sl].sum(0),
                stack_ops=int(c.stack_ops[sl].sum()),
                max_sp=int(c.max_sp[sl].max()),
                overflow=bool(c.overflow[sl].any())))
        return out


def execute(launches: Sequence[LaunchSpec], n_sm: int = 1,
            cfg: MachineConfig = MachineConfig(), chunk: int = 8,
            device="cuda") -> DeviceGrid:
    """Execute the blocks of ``launches`` round-robin across ``n_sm`` SMs.

    Blocks may not communicate (true of the paper's benchmarks); write
    sets merge in global block order after each dispatch group.  ``chunk``
    bounds the positions per group (rounded to a multiple of ``n_sm``).
    The SM is as wide as the widest launch's block.  Runs on the card
    unless ``device="cpu"``; without a card it raises.
    """
    dev = resolve_device(device)
    if not launches:
        raise ValueError("execute() needs at least one launch")
    mods = [_default_registry.as_module(l.code) for l in launches]
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
    gmems = torch.zeros((len(launches), g_width), dtype=torch.int32,
                        device=dev)
    for i, launch in enumerate(launches):
        gmems[i, :orig_lens[i]] = as_int32(launch.gmem, dev)

    n_warps = max(warps_for(l.block_dim) for l in launches)
    geom_all = np.concatenate(pos_l)
    n_blocks = len(geom_all)

    # schedule: position p -> SM p % n_sm, super-step p // n_sm; a group
    # spans spd super-steps, spd halving while the rest still fits
    sm_ids_all = torch.as_tensor(np.arange(n_blocks) % n_sm, device=dev)
    spd_max = max(1, chunk // n_sm)
    run = fused_sm_run if cfg.execute_backend == "cuda_fused" else staged_run
    codes_d = torch.as_tensor(codes, device=dev)
    sm_cyc = torch.zeros(n_sm, dtype=torch.int64, device=dev)
    ctr_groups = []
    lo = 0
    while lo < n_blocks:
        spd = spd_max
        while spd // 2 >= -(-(n_blocks - lo) // n_sm):
            spd //= 2
        take = min(spd * n_sm, n_blocks - lo)
        geom = geom_all[lo:lo + take]
        launch_ids = torch.as_tensor(geom[:, 0], device=dev).long()
        mem, wrt, ctr = run(cfg, n_warps, codes_d, geom, gmems[launch_ids])
        # position-order merge: later positions overwrite earlier ones
        for p, li in enumerate(geom[:, 0].tolist()):
            gmems[li] = torch.where(wrt[p], mem[p], gmems[li])
        cost = ctr[:, C_CYCLES].to(torch.int64) + BLOCK_SCHED_OVERHEAD
        sm_cyc.index_add_(0, sm_ids_all[lo:lo + take], cost)
        ctr_groups.append(ctr)
        lo += take

    return DeviceGrid(gmems=gmems, ctr=torch.cat(ctr_groups), sm_cyc=sm_cyc,
                      n_sm=n_sm, n_steps=-(-n_blocks // n_sm),
                      launch_offsets=offsets, launch_blocks=nblocks,
                      orig_lens=orig_lens)


#: Registry behind bare execute()/run_grid() calls (bounded).
_default_registry = ModuleRegistry(max_modules=1024)


def run_grid(code, grid: Tuple[int, int], block_dim, gmem,
             cfg: MachineConfig = MachineConfig(), chunk: int = 8,
             n_sm: int = 1, device="cuda") -> GridResult:
    """Single-launch entry: execute and materialize."""
    dg = execute([LaunchSpec(code, grid, block_dim, gmem)],
                 n_sm=n_sm, cfg=cfg, chunk=chunk, device=device)
    return dg.to_results()[0]
