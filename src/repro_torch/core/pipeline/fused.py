"""Fused SM kernel — whole blocks of the pipeline as ONE CUDA kernel (port
of ``repro.core.pipeline.fused``, ``execute_backend="cuda_fused"``).

The paper's overlay keeps the entire SIMT pipeline on chip: fetch, operand
read, the SP array, writeback and the warp scheduler are one datapath over
block RAMs.  The JAX package's ``fused_sm_step`` runs one lockstep step of
one block per Pallas launch, inside a ``lax.while_loop`` under a ``vmap``
over schedule positions.  ``csrc/fused_sm.cu`` folds all three levels into
one launch per dispatch group: one CTA per position, the step loop inside
the kernel, architectural state in shared memory (see the source's header
for the design and what bounds it).

:func:`fused_sm_run` is the wrapper.  CUDA tensors launch the kernel or
raise; CPU tensors take the plain version :func:`staged_run`, the staged
:func:`sm_step` iterated position by position.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import isa
from ...kernels import _build
from .state import Counters, MachineConfig

#: columns of a per-position counter row (op_issues, op_lanes, then these)
C_CYCLES = 2 * isa.NUM_OPCODES
C_STACK_OPS, C_MAX_SP, C_OVERFLOW, C_STEPS = range(C_CYCLES + 1,
                                                   C_CYCLES + 5)
N_CTR = C_CYCLES + 5
#: columns of a per-position geometry row
GEOM_FIELDS = ("launch", "block_dim", "bdx", "bdy", "bx", "by", "gx", "gy")

#: shared memory one CTA may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232_448
MAX_WARPS = 32                      # 1024 threads per CTA


def counters_from_rows(ctr: torch.Tensor) -> Counters:
    """(P, N_CTR) counter rows -> Counters stacked over positions."""
    n = isa.NUM_OPCODES
    return Counters(op_issues=ctr[:, :n], op_lanes=ctr[:, n:2 * n],
                    cycles=ctr[:, C_CYCLES], stack_ops=ctr[:, C_STACK_OPS],
                    max_sp=ctr[:, C_MAX_SP], overflow=ctr[:, C_OVERFLOW])


def fused_sm_run(cfg: MachineConfig, n_warps: int, codes: torch.Tensor,
                 geom: np.ndarray, gmem: torch.Tensor):
    """Run one block per schedule position to completion.

    ``codes`` (L, C, NUM_FIELDS) int32 programs; ``geom`` a host (P, 8)
    int array, one row of :data:`GEOM_FIELDS` per position; ``gmem``
    (P, G) int32, each position's private snapshot, updated in place.
    Returns ``(gmem, written (P, G) bool, counters (P, N_CTR) int32)``;
    the last counter column is the number of lockstep steps each block
    took.
    """
    geom = np.asarray(geom, np.int32)
    P, G = gmem.shape
    L, C, F = codes.shape
    if F != isa.NUM_FIELDS or geom.shape != (P, len(GEOM_FIELDS)):
        raise ValueError(f"fused_sm_run: codes must be (L, C, "
                         f"{isa.NUM_FIELDS}) and geom ({P}, 8)")
    if ((geom[:, 0] < 0) | (geom[:, 0] >= L)
            | (geom[:, 1] > n_warps * isa.WARP_SIZE)).any():
        raise ValueError(f"fused_sm_run: a position names a launch outside "
                         f"[0, {L}) or more threads than {n_warps} warps")
    if not gmem.is_cuda:
        return staged_run(cfg, n_warps, codes, geom, gmem)
    R, D, S = cfg.n_regs, cfg.warp_stack_depth, cfg.smem_words
    if any(x.dtype != torch.int32 or x.device != gmem.device
           or not x.is_contiguous() for x in (codes, gmem)):
        raise ValueError("fused_sm_run: inputs must be contiguous int32 "
                         "tensors on one device")
    if not 1 <= n_warps <= MAX_WARPS:
        raise ValueError(f"fused_sm_run: {n_warps} warps; a CTA holds 1 "
                         f"to {MAX_WARPS}")
    if min(P, G, C, R, D, S) < 1:
        raise ValueError("fused_sm_run: every dimension must be positive")
    lib = _build.load()
    nbytes = lib.fused_sm_smem_bytes(n_warps, C, R, D, S)
    if nbytes > MAX_SMEM_BYTES:
        raise ValueError(f"fused_sm_run: the block's state needs {nbytes} "
                         f"bytes of shared memory, above {MAX_SMEM_BYTES}")
    dev = gmem.device
    geom_d = torch.as_tensor(geom, device=dev)
    lut = torch.as_tensor(isa.COND_LUT.astype(np.int32).ravel(), device=dev)
    gw = torch.zeros((P, G), dtype=torch.int32, device=dev)
    ctr = torch.empty((P, N_CTR), dtype=torch.int32, device=dev)
    rc = lib.fused_sm_run_launch(
        codes.data_ptr(), lut.data_ptr(), geom_d.data_ptr(), gmem.data_ptr(),
        gw.data_ptr(), ctr.data_ptr(), P, n_warps, C, G, R, D, S,
        cfg.rows_per_warp, cfg.mem_latency_global, cfg.mem_latency_shared,
        cfg.max_cycles, int(cfg.enable_mul),
        3 if cfg.num_read_operands >= 3 else 2, _build.stream_ptr(gmem))
    _build.check(rc, "fused_sm_run")
    _build.LAUNCHES["fused_sm_run"] += 1
    return gmem, gw != 0, ctr


def staged_run(cfg: MachineConfig, n_warps: int, codes: torch.Tensor,
               geom: np.ndarray, gmem: torch.Tensor):
    """The plain version of :func:`fused_sm_run`, with its arguments and
    results: the staged pipeline, one position at a time, on any device.
    It is also how the executor runs the ``"torch"`` and ``"cuda"``
    backends, whose execute stage ``cfg.execute_backend`` picks."""
    from . import block_loop, init_state
    gws, rows = [], []
    for p, g in enumerate(np.asarray(geom).tolist()):
        li, bdim, bdx, bdy, bx, by, gx, gy = g
        st0 = init_state(cfg, n_warps, bdim, gmem[p])
        st, steps = block_loop(cfg, codes[li], (bdx, bdy), (bx, by),
                               (gx, gy), st0)
        gmem[p] = st.gmem[:-1]
        gws.append(st.gw[:-1])
        c = st.counters
        rows.append(torch.cat([
            c.op_issues, c.op_lanes,
            torch.stack([c.cycles, c.stack_ops, c.max_sp, c.overflow]),
            torch.tensor([steps], dtype=torch.int32, device=gmem.device)]))
    return gmem, torch.stack(gws), torch.stack(rows).to(torch.int32)
