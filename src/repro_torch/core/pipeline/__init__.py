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
  (``execute_backend="cuda_fused"``, the default).

:func:`sm_step` issues the instruction of every ready warp at once over
the (W, 32) lane grid, while per-warp cycle accounting still charges the
seed's serialized-issue cost.  :func:`run_block_body` is the machine
loop, a Python loop here (``lax.while_loop`` in the JAX package); staged
it is the plain version of the fused kernel.
"""
from __future__ import annotations

import torch

from .. import isa
from .state import (EXECUTE_BACKENDS, FINISHED, READY, WAIT, Counters,
                    MachineConfig, SMState, _pack, _unpack, as_int32,
                    init_state, resolve_device)
from .fetch_decode import Decoded, fetch_decode
from .read import Operands, read_operands
from .execute import execute
from .write import write_back
from .control import control
from . import fused

__all__ = [
    "EXECUTE_BACKENDS", "READY", "WAIT", "FINISHED", "Counters", "Decoded",
    "MachineConfig", "Operands", "SMState", "sm_step", "init_state",
    "run_block", "run_block_body", "_pack", "_unpack",
]


def cond_lut(device) -> torch.Tensor:
    """The (16, 16) bool condition LUT of Fig. 2 on ``device``."""
    return torch.as_tensor(isa.COND_LUT, device=device)


def sm_step(cfg: MachineConfig, code: torch.Tensor, lut: torch.Tensor,
            block_dim_xy, block_xy, grid_xy, st: SMState) -> SMState:
    """One lockstep step: every READY warp runs the full pipeline.  The
    geometry arguments are (x, y) pairs of Python ints."""
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
    """Step ``st`` until every warp is FINISHED or ``max_cycles`` is
    reached; returns (final state, steps taken)."""
    lut = cond_lut(code.device)
    steps = 0
    while bool(((st.wstate != FINISHED).any()
                & (st.counters.cycles < cfg.max_cycles)).item()):
        st = sm_step(cfg, code, lut, block_dim_xy, block_xy, grid_xy, st)
        steps += 1
    return st, steps


def run_block_body(cfg: MachineConfig, n_warps: int, code: torch.Tensor,
                   block_dim: int, block_dim_xy, block_xy, grid_xy,
                   gmem: torch.Tensor):
    """The machine loop: run one block to completion with ``n_warps``
    warps.  Warps beyond ``block_dim`` threads start FINISHED and never
    issue, so counters are exact at any warp padding.  Returns
    ``(gmem, written-mask, Counters)`` with the store-sentinel word
    stripped."""
    st0 = init_state(cfg, n_warps, block_dim, gmem)
    st, _ = block_loop(cfg, code, block_dim_xy, block_xy, grid_xy, st0)
    return st.gmem[:-1], st.gw[:-1], st.counters


def run_block(code, block_dim, block_xy, grid_xy, gmem,
              cfg: MachineConfig = MachineConfig(), device="cuda"):
    """Execute one thread block; returns (gmem, written-mask, Counters) as
    tensors on ``device``.  ``block_dim`` may be an int (1-D block) or an
    (x, y) tuple.  Runs on the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    bdx, bdy = block_dim if isinstance(block_dim, tuple) else (block_dim, 1)
    bdx, bdy = int(bdx), int(bdy)
    code, gmem = as_int32(code, dev), as_int32(gmem, dev)
    n_warps = -(-bdx * bdy // isa.WARP_SIZE)
    if cfg.execute_backend == "cuda_fused":
        geom = [[0, bdx * bdy, bdx, bdy, *block_xy, *grid_xy]]
        mem, wrt, ctr = fused.fused_sm_run(cfg, n_warps, code[None], geom,
                                           gmem[None].clone())
        c = fused.counters_from_rows(ctr)
        return mem[0], wrt[0], Counters(*(x[0] for x in c))
    return run_block_body(cfg, n_warps, code, bdx * bdy, (bdx, bdy),
                          tuple(int(v) for v in block_xy),
                          tuple(int(v) for v in grid_xy), gmem)
