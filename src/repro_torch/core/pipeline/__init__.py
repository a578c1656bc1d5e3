"""The soft-GPGPU streaming multiprocessor as a five-stage package (port of
``repro.core.pipeline``).

One module per pipeline stage of the paper's SM:

* :mod:`.fetch_decode` — barrier release, all-warp fetch, decode, ``.S`` pop;
* :mod:`.read`         — operand units, guard LUT, S2R, memory read ports;
* :mod:`.execute`      — the pluggable SP array (plain torch or the CUDA
  ``simt_alu`` kernel);
* :mod:`.write`        — register/predicate writeback, global/shared stores;
* :mod:`.control`      — warp stack, EXIT/BAR, next PC, counters;
* :mod:`.fused`        — whole blocks as ONE CUDA kernel
  (``execute_backend="cuda_fused"``, the default);
* :mod:`.reference`    — the seed one-warp-per-issue interpreter
  (``execute_backend="reference"``), the oracle the others are held to.

:func:`sm_step` issues the instruction of every ready warp at once over
the (W, 32) lane grid, while per-warp cycle accounting still charges the
seed's serialized-issue cost.  :func:`run_block_body` is the machine
loop, a Python loop here (``lax.while_loop`` in the JAX package); staged
it is the plain version of the fused kernel.  :func:`block_loop` steps a
whole dispatch group at once: the state carries a leading position axis
and every stage works over it, as the JAX executor's ``vmap`` over
positions does.  Its step is :func:`sm_step`, or
:func:`issue_one_warp` under ``"reference"``.
"""
from __future__ import annotations

import torch

from .. import isa
from ...obs import jit_call
from .state import (EXECUTE_BACKENDS, FINISHED, READY, WAIT, Counters,
                    MachineConfig, SMState, _pack, _unpack, as_int32,
                    clamp_index, init_state, resolve_device, select_state)
from .fetch_decode import Decoded, fetch_decode
from .read import Operands, read_operands
from .execute import execute
from .write import write_back
from .control import control
from .reference import issue_one_warp
from . import fused

__all__ = [
    "EXECUTE_BACKENDS", "READY", "WAIT", "FINISHED", "Counters", "Decoded",
    "MachineConfig", "Operands", "SMState", "sm_step", "issue_one_warp",
    "init_state", "run_block", "run_block_body", "_pack", "_unpack",
]


def cond_lut(device) -> torch.Tensor:
    """The (16, 16) bool condition LUT of Fig. 2 on ``device``."""
    return torch.as_tensor(isa.COND_LUT, device=device)


def sm_step(cfg: MachineConfig, code: torch.Tensor, lut: torch.Tensor,
            block_dim_xy, block_xy, grid_xy, st: SMState) -> SMState:
    """One lockstep step: every READY warp runs the full pipeline.  For one
    block the geometry arguments are (x, y) pairs of ints and ``code`` is
    (C, NUM_FIELDS); for a state of P blocks they are (P, 2) tensors and
    (P, C, NUM_FIELDS), one row per position."""
    dec = fetch_decode(code, st)
    ops = read_operands(cfg, lut, block_dim_xy, block_xy, grid_xy, st, dec)
    result, nib_new = execute(cfg, dec, ops)
    wb = write_back(cfg, st, dec, ops, result, nib_new)
    (pc, alive, active, wstate, stack_addr, stack_type, stack_mask, sp,
     counters) = control(cfg, st, dec, ops)
    return SMState(
        pc=pc, alive=alive, active=active, wstate=wstate,
        stack_addr=stack_addr, stack_type=stack_type,
        stack_mask=stack_mask, sp=sp,
        pred=wb.pred, regs=wb.regs, smem=wb.smem, gmem=wb.gmem, gw=wb.gw,
        last_warp=st.last_warp, counters=counters)


def block_loop(cfg: MachineConfig, code: torch.Tensor, block_dim_xy,
               block_xy, grid_xy, st: SMState):
    """Step ``st`` (one block, or P blocks with ``code`` and the geometry
    per position, as :func:`sm_step` takes them) until no position is
    live; returns (final state, steps, store steps), int32 tensors with
    the state's leading shape.

    A position is live while some warp is not FINISHED and its cycles are
    below ``max_cycles``.  Every step runs all positions at once, one
    execute-stage call for all their rows, and makes one host sync (the
    count of live positions); a position that is no longer live keeps its
    whole state, counters included, and its steps stop counting: the JAX
    package's ``vmap`` of ``lax.while_loop``.  A store step is one in
    which some live warp's instruction is STS or STG: the steps in which
    the fused kernel orders its loads before its stores with a second
    barrier.

    Under ``"reference"`` a step is :func:`issue_one_warp`, one issue of
    one warp per position: steps count issues, and store steps stay 0."""
    reference = cfg.execute_backend == "reference"
    step = issue_one_warp if reference else sm_step
    dev = code.device
    lut = cond_lut(dev)
    # geometry on the device once, not as host pairs copied every step
    geom = [torch.as_tensor(v, device=dev).to(torch.int64)
            for v in (block_dim_xy, block_xy, grid_xy)]
    ops = code[..., isa.F_OP]
    is_store = (ops == isa.STG) | (ops == isa.STS)        # (..., C)
    steps = torch.zeros(st.pc.shape[:-1], dtype=torch.int32, device=dev)
    store_steps = torch.zeros_like(steps)
    while True:
        running = st.wstate != FINISHED
        live = running.any(-1) & (st.counters.cycles < cfg.max_cycles)
        n_live = int(live.sum())
        if n_live == 0:
            return st, steps, store_steps
        if not reference:
            stores = torch.take_along_dim(
                is_store, clamp_index(st.pc, is_store.shape[-1]), dim=-1)
            store_steps += live & (stores & running).any(-1)
        steps += live
        nxt = step(cfg, code, lut, *geom, st)
        st = nxt if n_live == live.numel() else select_state(live, nxt, st)


def run_block_body(cfg: MachineConfig, n_warps: int, code: torch.Tensor,
                   block_dim: int, block_dim_xy, block_xy, grid_xy,
                   gmem: torch.Tensor):
    """The machine loop: run one block to completion with ``n_warps``
    warps.  Warps beyond ``block_dim`` threads start FINISHED and never
    issue, so counters are exact at any warp padding.  Returns
    ``(gmem, written-mask, Counters)`` with the store-sentinel word
    stripped."""
    st0 = init_state(cfg, n_warps, block_dim, gmem)
    st, _, _ = block_loop(cfg, code, block_dim_xy, block_xy, grid_xy,
                          st0)
    return st.gmem[:-1], st.gw[:-1], st.counters


def run_block(code, block_dim, block_xy, grid_xy, gmem,
              cfg: MachineConfig = MachineConfig(), device="cuda"):
    """Execute one thread block; returns (gmem, written-mask, Counters) as
    tensors on ``device``.  ``block_dim`` may be an int (1-D block) or an
    (x, y) tuple.  Runs on the card unless ``device="cpu"``.  Every
    backend but ``"cuda_fused"`` (``"torch"``, ``"cuda"``, ``"reference"``)
    runs :func:`run_block_body`."""
    dev = resolve_device(device)
    bdx, bdy = block_dim if isinstance(block_dim, tuple) else (block_dim, 1)
    bdx, bdy = int(bdx), int(bdy)
    code, gmem = as_int32(code, dev), as_int32(gmem, dev)
    n_warps = -(-bdx * bdy // isa.WARP_SIZE)
    bucket = f"c{code.shape[0]}g{gmem.shape[0]}b{bdx * bdy}"
    with jit_call("pipeline.run_block", bucket=bucket):
        if cfg.execute_backend == "cuda_fused":
            geom = [[0, bdx * bdy, bdx, bdy, *block_xy, *grid_xy]]
            mem, wrt, ctr = fused.fused_sm_run(cfg, n_warps, code[None],
                                               geom, gmem[None].clone())
            c = fused.counters_from_rows(ctr)
            return mem[0], wrt[0], Counters(*(x[0] for x in c))
        return run_block_body(cfg, n_warps, code, bdx * bdy, (bdx, bdy),
                              tuple(int(v) for v in block_xy),
                              tuple(int(v) for v in grid_xy), gmem)
