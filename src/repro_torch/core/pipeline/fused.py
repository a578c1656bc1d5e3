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

:func:`predecode` turns the programs into the kernel's instruction records
once, on their device; :func:`fused_sm_run` is the wrapper.  CUDA tensors
launch the kernel or raise; CPU tensors take the plain version
:func:`staged_run`, the staged :func:`sm_step` stepping all positions of
the group together.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from .. import isa
from ...kernels import _build
from ...kernels.ref import wrap32
from .state import Counters, MachineConfig, clamp_index, drop_index, opcode_in

#: columns of a per-position counter row (op_issues, op_lanes, then these);
#: C_STEPS counts lockstep steps (issues of one warp under the
#: ``"reference"`` backend, whose rows come from :func:`staged_run`);
#: C_STORE_STEPS counts the steps in which some live warp's instruction is
#: STS or STG, the steps that take the kernel's read/write barrier (0 under
#: ``"reference"``)
C_CYCLES = 2 * isa.NUM_OPCODES
C_STACK_OPS, C_MAX_SP, C_OVERFLOW, C_STEPS, C_STORE_STEPS = range(
    C_CYCLES + 1, C_CYCLES + 6)
N_CTR = C_CYCLES + 6
#: columns of a per-position geometry row
GEOM_FIELDS = ("launch", "block_dim", "bdx", "bdy", "bx", "by", "gx", "gy")

#: shared memory one CTA may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232_448
MAX_WARPS = 32                      # 1024 threads per CTA

# ---- the predecoded instruction record: int32 words (imm, regs, ctl, lut)
#   regs: dst | src1 << 8 | src2 << 16 | src3 << 24, REG_NONE out of range
#   ctl:  op | ctr << REC_CTR | pdst << REC_PDST | gpred << REC_GPRED |
#         sel << REC_SEL | flags << REC_FLAGS, and one bit each: REC_WREG
#         (writes a register in range), REC_WPRED (ISETP to a predicate in
#         range), REC_LOAD, REC_STORE, REC_CONTROL (BRA, SSY, EXIT, BAR or
#         a .S instruction: the kernel's control stage runs)
#   lut:  LUT row (bit n: the guard holds on nibble n) | cost << REC_COST
# The names and values are those of csrc/fused_sm.cu.
REG_NONE, PRED_NONE, OP_NONE, CTR_NONE = 255, 7, 31, 31
REC_CTR, REC_PDST, REC_GPRED, REC_SEL, REC_FLAGS = 5, 10, 13, 16, 20
REC_WREG, REC_WPRED, REC_LOAD, REC_STORE, REC_CONTROL = 24, 25, 26, 27, 28
REC_COST = 16
#: the flag bits the pipeline reads
FLAG_BITS = (isa.FLAG_SRC2_IMM | isa.FLAG_SYNC | isa.FLAG_GUARD
             | isa.FLAG_SRC1_IMM)
#: the opcodes whose issue runs the control stage (with any .S instruction)
CONTROL_OPS = (isa.BRA, isa.SSY, isa.EXIT, isa.BAR)
MAX_COST = 0xFFFF


@functools.lru_cache(maxsize=None)
def _lut_rows(device: torch.device) -> torch.Tensor:
    """(16,) int64: bit n of row c is COND_LUT[c, n]; one copy per device."""
    bits = (isa.COND_LUT.astype(np.int64) << np.arange(16)).sum(1)
    return torch.as_tensor(bits, device=device)


def predecode(codes: torch.Tensor, cfg: MachineConfig) -> torch.Tensor:
    """(L, C, NUM_FIELDS) int32 programs -> (L, C, 4) int32 records, one
    16-byte record per instruction, on the codes' device.

    A record holds what the stages derive from an instruction alone: the
    opcode (``OP_NONE`` outside the ISA), the counter column (the opcode
    wrapped once, ``CTR_NONE`` out of range), the register indices wrapped
    once (``REG_NONE`` out of range: a gather fills INT_MIN, a write
    drops), the predicate indices likewise (``PRED_NONE``), the S2R
    selector, the flags, whether it writes a register or a predicate (in
    range), loads, stores or runs the control stage, the guard's LUT row,
    the issue's cycle cost and the immediate.  Raises on a configuration
    whose values do not fit their bits."""
    R = cfg.n_regs
    if not 1 <= R < REG_NONE:
        raise ValueError(f"predecode: n_regs={R}; a record holds register "
                         f"indices below {REG_NONE}")
    rows, lat_g, lat_s = (cfg.rows_per_warp, cfg.mem_latency_global,
                          cfg.mem_latency_shared)
    if min(lat_g, lat_s) < 0 or rows + max(lat_g, lat_s) > MAX_COST:
        raise ValueError(f"predecode: memory latencies ({lat_g}, {lat_s}) "
                         f"must give a cost in [0, {MAX_COST}]")
    if codes.shape[-1] != isa.NUM_FIELDS:
        raise ValueError(f"predecode: codes must end in {isa.NUM_FIELDS} "
                         "fields")
    x = codes.to(torch.int64)
    op, flags = x[..., isa.F_OP], x[..., isa.F_FLAGS] & FLAG_BITS

    def index(field, n):
        return drop_index(x[..., field], n)

    def bit(b, cond):
        return cond.long() << b

    dst, dst_ok = index(isa.F_DST, R)
    pdst, pdst_ok = index(isa.F_PDST, 4)
    gpred, gpred_ok = index(isa.F_GPRED, 4)
    ctr, ctr_ok = index(isa.F_OP, isa.NUM_OPCODES)
    known = (op >= 0) & (op < isa.NUM_OPCODES)
    is_g = opcode_in(isa.IS_GMEM_MASK, op)
    is_s = opcode_in(isa.IS_SMEM_MASK, op)
    regs = torch.where(dst_ok, dst, REG_NONE)
    for k, field in enumerate((isa.F_SRC1, isa.F_SRC2, isa.F_SRC3), 1):
        i, ok = index(field, R)
        regs = regs | torch.where(ok, i, REG_NONE) << 8 * k
    control = (flags & isa.FLAG_SYNC) != 0
    for c in CONTROL_OPS:
        control = control | (op == c)
    ctl = (torch.where(known, op, OP_NONE)
           | torch.where(ctr_ok, ctr, CTR_NONE) << REC_CTR
           | torch.where(pdst_ok, pdst, PRED_NONE) << REC_PDST
           | torch.where(gpred_ok, gpred, PRED_NONE) << REC_GPRED
           | x[..., isa.F_IMM].clamp(0, isa.SR_NTID) << REC_SEL
           | flags << REC_FLAGS
           | bit(REC_WREG, opcode_in(isa.WRITES_REG_MASK, op) & dst_ok)
           | bit(REC_WPRED, (op == isa.ISETP) & pdst_ok)
           | bit(REC_LOAD, (op == isa.LDG) | (op == isa.LDS))
           | bit(REC_STORE, (op == isa.STG) | (op == isa.STS))
           | bit(REC_CONTROL, control))
    cost = (rows + torch.where(is_g, lat_g, 0)
            + torch.where(is_s, lat_s, 0))
    lut = (_lut_rows(codes.device)[clamp_index(x[..., isa.F_GCOND], 16)]
           | cost << REC_COST)
    return wrap32(torch.stack([x[..., isa.F_IMM], regs, ctl, lut], -1))


def counters_from_rows(ctr: torch.Tensor) -> Counters:
    """(P, N_CTR) counter rows -> Counters stacked over positions."""
    n = isa.NUM_OPCODES
    return Counters(op_issues=ctr[:, :n], op_lanes=ctr[:, n:2 * n],
                    cycles=ctr[:, C_CYCLES], stack_ops=ctr[:, C_STACK_OPS],
                    max_sp=ctr[:, C_MAX_SP], overflow=ctr[:, C_OVERFLOW])


def fused_sm_run(cfg: MachineConfig, n_warps: int, codes: torch.Tensor,
                 geom: np.ndarray, gmem: torch.Tensor, *,
                 records: Optional[torch.Tensor] = None,
                 geom_dev: Optional[torch.Tensor] = None):
    """Run one block per schedule position to completion.

    ``codes`` (L, C, NUM_FIELDS) int32 programs; ``geom`` a host (P, 8)
    int array, one row of :data:`GEOM_FIELDS` per position; ``gmem``
    (P, G) int32, each position's private snapshot, updated in place.
    Returns ``(gmem, written (P, G) bool, counters (P, N_CTR) int32)``;
    column ``C_STEPS`` is the number of lockstep steps each block took.

    A caller that launches many groups passes ``records``
    (:func:`predecode` of ``codes``) and ``geom_dev`` (``geom`` on
    ``gmem``'s device), so that a launch copies nothing from the host.
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
    dev = gmem.device
    if records is None:
        records = predecode(codes, cfg)
    if geom_dev is None:
        geom_dev = torch.as_tensor(geom, device=dev)
    if any(x.dtype != torch.int32 or x.device != dev or not x.is_contiguous()
           for x in (codes, gmem, records, geom_dev)):
        raise ValueError("fused_sm_run: inputs must be contiguous int32 "
                         "tensors on one device")
    if records.shape != (L, C, 4) or geom_dev.shape != geom.shape:
        raise ValueError(f"fused_sm_run: records must be ({L}, {C}, 4) and "
                         f"geom_dev {geom.shape}")
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
    gw = torch.zeros((P, G), dtype=torch.int32, device=dev)
    ctr = torch.empty((P, N_CTR), dtype=torch.int32, device=dev)
    rc = lib.fused_sm_run_launch(
        records.data_ptr(), geom_dev.data_ptr(), gmem.data_ptr(),
        gw.data_ptr(), ctr.data_ptr(), P, n_warps, C, G, R, D, S,
        cfg.max_cycles, int(cfg.enable_mul),
        3 if cfg.num_read_operands >= 3 else 2, _build.stream_ptr(gmem))
    _build.check(rc, "fused_sm_run")
    _build.LAUNCHES["fused_sm_run"] += 1
    return gmem, gw != 0, ctr


def staged_run(cfg: MachineConfig, n_warps: int, codes: torch.Tensor,
               geom: np.ndarray, gmem: torch.Tensor):
    """The plain version of :func:`fused_sm_run`, with its arguments and
    results: the staged pipeline over all positions of the group at once
    (:func:`block_loop` on a state with a leading position axis), on any
    device.  It is also how the executor runs the ``"torch"`` and
    ``"cuda"`` backends, whose execute stage ``cfg.execute_backend``
    picks (one execute-stage call a step for the whole group), and the
    ``"reference"`` backend (one warp issue per position a step)."""
    from . import block_loop, init_state
    g = torch.as_tensor(np.asarray(geom, np.int32), device=gmem.device)
    st0 = init_state(cfg, n_warps, g[:, 1], gmem)
    st, steps, store_steps = block_loop(
        cfg, codes[g[:, 0].long()], g[:, 2:4], g[:, 4:6], g[:, 6:8], st0)
    gmem.copy_(st.gmem[:, :-1])
    c = st.counters
    rows = torch.cat([c.op_issues, c.op_lanes, torch.stack(
        [c.cycles, c.stack_ops, c.max_sp, c.overflow, steps, store_steps],
        -1)], -1)
    return gmem, st.gw[:, :-1], rows.to(torch.int32)
