"""Write stage of the all-warp pipeline (port of
``repro.core.pipeline.write``).

Commits one lockstep issue for every warp at once: register and predicate
writebacks are (W, 32) masked column scatters; global and shared stores
from all warps (of all positions, for a state of P blocks) flatten to one
scatter each, with inactive lanes sent to their position's sentinel word
with its own value, so the scatter needs no branch.
Same-step stores to one address from different lanes have no defined
winner — the race the paper's race-free programs never observe.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

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
    """x (..., W, 32, K) with column ``idx[..., w]`` of warp w set to
    ``val`` where ``wr``; an out-of-range index drops the whole warp's
    write."""
    i, ok = drop_index(idx, x.shape[-1])
    i = i[..., None, None].expand(*x.shape[:-1], 1)
    old = torch.gather(x, -1, i)[..., 0]
    new = torch.where(wr & ok[..., None], val, old)
    return x.scatter(-1, i, new[..., None])


def _store(mem: torch.Tensor, hit: torch.Tensor, addr: torch.Tensor,
           val: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter ``val`` (..., W, 32) into ``mem`` (..., N + 1) at ``addr``
    where ``hit``; other lanes write the sentinel word N its own value.
    Positions lie end to end in one flat scatter.  Returns (new memory,
    flat indices written)."""
    n = mem.shape[-1]
    base = torch.arange(mem[..., 0].numel(), device=mem.device) * n
    idx = (base.view(*mem.shape[:-1], 1, 1)
           + torch.where(hit, addr, n - 1)).ravel()
    out = mem.clone()
    out.view(-1)[idx] = torch.where(hit, val, mem[..., n - 1, None, None]
                                    ).ravel()
    return out, idx


def write_back(cfg: MachineConfig, st: SMState, dec: Decoded,
               ops: Operands, result: torch.Tensor,
               nib_new: torch.Tensor) -> Written:
    op = dec.op[..., None]

    # ---- register / predicate writeback ---------------------------------
    wr = ops.exec_mask & opcode_in(isa.WRITES_REG_MASK, op)
    regs = _set_column(st.regs, dec.dst, wr, result)
    setp = ops.exec_mask & (op == isa.ISETP)
    pred = _set_column(st.pred, dec.pdst, setp, nib_new)

    # ---- global / shared stores (inactive lanes write the sentinel) ------
    st_g = ops.exec_mask & (op == isa.STG)
    gmem, gidx = _store(st.gmem, st_g, ops.gaddr, ops.s2)
    gw = st.gw.clone()
    gw.view(-1)[gidx] = st.gw.view(-1)[gidx] | st_g.ravel()
    st_s = ops.exec_mask & (op == isa.STS)
    smem, _ = _store(st.smem, st_s, ops.saddr, ops.s2)

    return Written(regs=regs, pred=pred, smem=smem, gmem=gmem, gw=gw)
