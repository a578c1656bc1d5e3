"""Write stage of the all-warp pipeline (port of
``repro.core.pipeline.write``).

Commits one lockstep issue for every warp at once: register and predicate
writebacks are (W, 32) masked column scatters; global and shared stores
from all warps flatten to one scatter each, with inactive lanes sent to
the sentinel word with its own value, so the scatter needs no branch.
Same-step stores to one address from different lanes have no defined
winner — the race the paper's race-free programs never observe.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import isa
from .state import MachineConfig, SMState, drop_index, opcode_in
from .fetch_decode import Decoded
from .read import Operands


class Written(NamedTuple):
    regs: torch.Tensor
    pred: torch.Tensor
    smem: torch.Tensor
    gmem: torch.Tensor
    gw: torch.Tensor


def _set_column(x: torch.Tensor, idx: torch.Tensor, wr: torch.Tensor,
                val: torch.Tensor) -> torch.Tensor:
    """x (W, 32, K) with column ``idx[w]`` of warp w set to ``val`` where
    ``wr``; an out-of-range index drops the whole warp's write."""
    i, ok = drop_index(idx, x.shape[2])
    i = i[:, None, None].expand(-1, x.shape[1], 1)
    old = torch.gather(x, 2, i)[..., 0]
    new = torch.where(wr & ok[:, None], val, old)
    return x.scatter(2, i, new[..., None])


def write_back(cfg: MachineConfig, st: SMState, dec: Decoded,
               ops: Operands, result: torch.Tensor,
               nib_new: torch.Tensor) -> Written:
    G = st.gmem.shape[0] - 1

    # ---- register / predicate writeback ---------------------------------
    wr = ops.exec_mask & opcode_in(isa.WRITES_REG_MASK, dec.op)[:, None]
    regs = _set_column(st.regs, dec.dst, wr, result)
    setp = ops.exec_mask & (dec.op == isa.ISETP)[:, None]
    pred = _set_column(st.pred, dec.pdst, setp, nib_new)

    # ---- global / shared stores (inactive lanes write the sentinel) ------
    st_g = ops.exec_mask & (dec.op == isa.STG)[:, None]
    gidx = torch.where(st_g, ops.gaddr, G).ravel()
    gmem = st.gmem.clone()
    gmem[gidx] = torch.where(st_g, ops.s2, st.gmem[G]).ravel()
    gw = st.gw.clone()
    gw[gidx] = st.gw[gidx] | st_g.ravel()

    st_s = ops.exec_mask & (dec.op == isa.STS)[:, None]
    sidx = torch.where(st_s, ops.saddr, cfg.smem_words).ravel()
    smem = st.smem.clone()
    smem[sidx] = torch.where(st_s, ops.s2, st.smem[cfg.smem_words]).ravel()

    return Written(regs=regs, pred=pred, smem=smem, gmem=gmem, gw=gw)
