"""Architectural state shared by every issue discipline (PyTorch port of
``repro.core.pipeline.state``).

``MachineConfig`` is the static architecture description (the paper's §4
customization axes plus substrate knobs); ``SMState`` is the state the
machine loop carries from step to step; ``Counters`` drives the energy
model.  Every tensor is int32 or bool on one ``torch.device``.

Differences from the JAX package, all at the type level:

* ``stack_mask`` holds the uint32 lane masks as int32 bit patterns
  (lane 31 is the sign bit): torch's uint32 coverage is thin, and the
  CUDA kernels read the same bits as ``unsigned``;
* ``pallas_interpret`` is gone, and the backends are renamed (see
  :data:`EXECUTE_BACKENDS`);
* :func:`config_from_reference`, :func:`state_from_numpy` and
  :func:`state_to_numpy` carry a configuration and a mid-run state across
  from the JAX package as plain dicts of numpy arrays, so a test can step
  both machines from the same state.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple

import numpy as np
import torch

from .. import isa
from ...kernels.ref import wrap32

READY, WAIT, FINISHED = 0, 1, 2

#: Execute-stage backends selectable via ``MachineConfig.execute_backend``:
#:   ``"torch"``      — staged pipeline, plain-torch vector ALU (the JAX
#:                      package's ``"jnp"``); runs on any device;
#:   ``"cuda"``       — staged pipeline, the CUDA ``simt_alu`` kernel for
#:                      the execute stage only (``"pallas"``);
#:   ``"cuda_fused"`` — the whole block loop as ONE CUDA kernel
#:                      (``"pallas_fused"``, :mod:`.fused`); the default;
#:   ``"reference"``  — the seed one-warp-per-issue interpreter
#:                      (:mod:`.reference`), the oracle the other
#:                      backends are held to; plain torch on any device.
#: On CPU tensors ``"cuda"`` and ``"cuda_fused"`` run their kernels' plain
#: versions; on CUDA tensors they launch the kernels or raise.
EXECUTE_BACKENDS = ("torch", "cuda", "cuda_fused", "reference")

#: JAX package backend name -> port backend name.
REFERENCE_BACKENDS = {"jnp": "torch", "pallas": "cuda",
                      "pallas_fused": "cuda_fused", "reference": "reference"}

INT32_MIN = -2 ** 31


@dataclasses.dataclass(frozen=True)
class MachineConfig:
    """Static architectural parameters (the customization axes of §4)."""
    n_sp: int = 8                 # scalar processors per SM (8/16/32)
    n_regs: int = 16              # 32-bit GPRs per thread
    warp_stack_depth: int = 32    # §4.1 customization axis
    enable_mul: bool = True       # §4.2: multiplier present?
    num_read_operands: int = 3    # §4.2: third read port present?
    smem_words: int = 4096        # 16 KB shared memory per SM
    mem_latency_global: int = 8   # extra cycles per global access (AXI)
    mem_latency_shared: int = 2   # extra cycles per shared access
    max_cycles: int = 4_000_000   # runaway-program guard
    execute_backend: str = "cuda_fused"  # see EXECUTE_BACKENDS

    def __post_init__(self):
        if self.execute_backend not in EXECUTE_BACKENDS:
            raise ValueError(
                f"execute_backend must be one of {EXECUTE_BACKENDS}, "
                f"got {self.execute_backend!r}")

    @property
    def rows_per_warp(self) -> int:
        """A 32-thread warp is arranged into rows of n_sp threads."""
        return max(1, isa.WARP_SIZE // self.n_sp)

    def lut_bits(self, n_warps: int = 8) -> int:
        """LUT/FF-area proxy (paper Tables 2/6): warp-stack registers
        (66 bits/entry, Fig. 2), predicate file, per-warp control state,
        and the multiplier / third-operand-port datapaths.  The register
        file is EXCLUDED — on the FPGA it lives in block RAM, which the
        paper reports separately from LUT area.
        """
        stack = n_warps * self.warp_stack_depth * 66
        pred = n_warps * isa.WARP_SIZE * 4 * 4
        ctrl = n_warps * (32 + 32 + 2)
        # read-operand units + ALU datapath per SP lane
        read_units = self.num_read_operands * self.n_sp * 32 * 3
        mul = (self.n_sp * 32 * 24) if self.enable_mul else 0
        return stack + pred + ctrl + read_units + mul

    def state_bits(self, n_warps: int = 8) -> int:
        """Total architectural state (LUT proxy + BRAM regfile)."""
        regfile = n_warps * isa.WARP_SIZE * self.n_regs * 32
        return self.lut_bits(n_warps) + regfile


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  CUDA without a card raises: the
    port never carries on on the CPU unless asked to (``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' to "
            "run the plain PyTorch versions on the CPU")
    return dev


def on_device(x, device: torch.device) -> bool:
    """Whether ``x`` is a tensor on ``device`` (``cuda`` without an index
    names the current card)."""
    if not isinstance(x, torch.Tensor) or x.device.type != device.type:
        return False
    if device.type != "cuda":
        return True
    want = torch.cuda.current_device() if device.index is None \
        else device.index
    return x.device.index == want


def as_int32(x, device) -> torch.Tensor:
    """A numpy array, sequence or tensor as an int32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(x, np.int32), device=device)


def host_numpy(x) -> np.ndarray:
    """A numpy array, sequence or tensor (on any device) as host numpy."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def config_from_reference(d: dict) -> MachineConfig:
    """Port config from ``dataclasses.asdict`` of a JAX ``MachineConfig``:
    the backend is renamed and ``pallas_interpret`` dropped."""
    kw = {k: v for k, v in d.items() if k != "pallas_interpret"}
    kw["execute_backend"] = REFERENCE_BACKENDS[kw["execute_backend"]]
    return MachineConfig(**kw)


class Counters(NamedTuple):
    """Per-block dynamic-activity counters (drive the energy model)."""
    op_issues: torch.Tensor   # (NUM_OPCODES,) instruction issues per opcode
    op_lanes: torch.Tensor    # (NUM_OPCODES,) active-lane executions
    cycles: torch.Tensor      # () SM cycles for this block
    stack_ops: torch.Tensor   # () warp-stack pushes + pops
    max_sp: torch.Tensor      # () observed maximum warp-stack depth
    overflow: torch.Tensor    # () 1 if a push ever exceeded the stack depth


class SMState(NamedTuple):
    """One block's state, shapes as below; a state of P blocks (one per
    schedule position, :func:`init_state`) has a leading P axis on every
    field and every counter."""
    pc: torch.Tensor          # (W,) int32
    alive: torch.Tensor       # (W, 32) bool — thread not EXITed
    active: torch.Tensor      # (W, 32) bool — current divergence mask
    wstate: torch.Tensor      # (W,) int32 READY/WAIT/FINISHED
    stack_addr: torch.Tensor  # (W, D) int32
    stack_type: torch.Tensor  # (W, D) int32
    stack_mask: torch.Tensor  # (W, D) int32 bit patterns of uint32 masks
    sp: torch.Tensor          # (W,) int32
    pred: torch.Tensor        # (W, 32, 4) int32 SZCO nibbles
    regs: torch.Tensor        # (W, 32, R) int32
    smem: torch.Tensor        # (S+1,) int32 (last word = store sentinel)
    gmem: torch.Tensor        # (G+1,) int32 (last word = store sentinel)
    gw: torch.Tensor          # (G+1,) bool — global words written by block
    last_warp: torch.Tensor   # () int32 (round-robin pointer)
    counters: Counters


# ---- the JAX package's index semantics, reproduced exactly -------------
# Every index below is wrapped once like Python (``i < 0 -> i + n``); then
#   * a plain gather ``x[i]`` clamps to [0, n-1]           (clamp_index);
#   * ``jnp.take_along_axis`` fills INT32_MIN out of range  (take_lanes);
#   * ``.at[i].set`` / ``.at[i].add`` drop out of range     (drop_index).
# Paper and compiled programs never leave range; the packages must still
# not differ silently when a binary does.

def clamp_index(i: torch.Tensor, n: int) -> torch.Tensor:
    i = torch.where(i < 0, i + n, i)
    return i.clamp(0, n - 1).to(torch.int64)


def drop_index(i: torch.Tensor, n: int):
    """(wrapped index clamped into range, in-range mask)."""
    i = torch.where(i < 0, i + n, i)
    ok = (i >= 0) & (i < n)
    return torch.where(ok, i, 0).to(torch.int64), ok


def take_lanes(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., W, 32, K), idx (..., W) -> (..., W, 32) column per warp;
    INT32_MIN where the index is out of range."""
    i, ok = drop_index(idx, x.shape[-1])
    col = torch.take_along_dim(x, i[..., None, None], dim=-1)[..., 0]
    return torch.where(ok[..., None], col, INT32_MIN)


def opcode_in(mask: int, op: torch.Tensor) -> torch.Tensor:
    """``(mask >> op) & 1`` with the arithmetic shift of XLA: 0 for an
    opcode outside [0, 31] (the masks are positive)."""
    ok = (op >= 0) & (op < 32)
    return ok & (((mask >> op.clamp(0, 31).to(torch.int64)) & 1) != 0)


def _lanes(device) -> torch.Tensor:
    return torch.arange(isa.WARP_SIZE, dtype=torch.int64, device=device)


def _pack(mask_bool: torch.Tensor) -> torch.Tensor:
    """(..., 32) bool lane mask -> (...,) int32 bit pattern, lane i in
    bit i."""
    bits = torch.ones((), dtype=torch.int64,
                      device=mask_bool.device) << _lanes(mask_bool.device)
    return wrap32(torch.where(mask_bool, bits, 0).sum(-1))


def _unpack(mask_i32: torch.Tensor) -> torch.Tensor:
    """(...,) int32 bit pattern -> (..., 32) bool lane mask."""
    m = mask_i32.to(torch.int64)[..., None]
    return ((m >> _lanes(mask_i32.device)) & 1) != 0


def init_state(cfg: MachineConfig, n_warps: int, block_dim,
               gmem: torch.Tensor) -> SMState:
    """Fresh block state; threads at or beyond ``block_dim`` start EXITed
    and a warp without threads starts FINISHED.

    ``gmem`` (G,) with an int ``block_dim`` gives one block's state;
    ``gmem`` (P, G) with ``block_dim`` a (P,) tensor or sequence gives the
    state of P blocks, one per schedule position: every field, the
    counters included, gains a leading position axis (the JAX package's
    ``vmap`` over positions, written out)."""
    dev = gmem.device
    lead = gmem.shape[:-1]
    W, D, R = n_warps, cfg.warp_stack_depth, cfg.n_regs
    i32 = dict(dtype=torch.int32, device=dev)
    bd = torch.as_tensor(block_dim, **i32).expand(lead)
    tid = torch.arange(W * isa.WARP_SIZE, **i32).reshape(W, isa.WARP_SIZE)
    exists = tid < bd[..., None, None]                  # (..., W, 32)
    zero = torch.zeros(lead, **i32)
    counters = Counters(
        op_issues=torch.zeros((*lead, isa.NUM_OPCODES), **i32),
        op_lanes=torch.zeros((*lead, isa.NUM_OPCODES), **i32),
        cycles=zero, stack_ops=zero.clone(), max_sp=zero.clone(),
        overflow=zero.clone())
    return SMState(
        pc=torch.zeros((*lead, W), **i32),
        alive=exists,
        active=exists.clone(),
        wstate=torch.where(exists.any(-1), READY, FINISHED).to(torch.int32),
        stack_addr=torch.zeros((*lead, W, D), **i32),
        stack_type=torch.zeros((*lead, W, D), **i32),
        stack_mask=torch.zeros((*lead, W, D), **i32),
        sp=torch.zeros((*lead, W), **i32),
        pred=torch.zeros((*lead, W, isa.WARP_SIZE, 4), **i32),
        regs=torch.zeros((*lead, W, isa.WARP_SIZE, R), **i32),
        # one extra word = store sentinel for masked-off lanes
        smem=torch.zeros((*lead, cfg.smem_words + 1), **i32),
        gmem=torch.cat([gmem.to(torch.int32),
                        torch.zeros((*lead, 1), **i32)], -1),
        gw=torch.zeros((*lead, gmem.shape[-1] + 1), dtype=torch.bool,
                       device=dev),
        last_warp=torch.full(lead, W - 1, **i32),
        counters=counters)


def select_state(keep: torch.Tensor, new: SMState, old: SMState) -> SMState:
    """Per position, ``new`` where ``keep`` (P,) else ``old``: every field,
    the counters included, as ``vmap`` of ``lax.while_loop`` holds a
    position whose loop has ended."""
    def sel(a, b):
        return torch.where(keep.view(-1, *(1,) * (a.dim() - 1)), a, b)

    return SMState(
        *(sel(a, b) for a, b in zip(new[:-1], old[:-1])),
        counters=Counters(*map(sel, new.counters, old.counters)))


_BOOL_FIELDS = ("alive", "active", "gw")


def state_from_numpy(d: Dict[str, np.ndarray], device) -> SMState:
    """SMState from a flat dict of numpy arrays: the SMState fields
    (``counters`` excepted) plus the six Counters fields.  ``stack_mask``
    may be uint32 (as the JAX package holds it) or int32 bit patterns."""
    def t(name):
        a = np.asarray(d[name])
        if name in _BOOL_FIELDS:
            return torch.as_tensor(a.astype(bool), device=device)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.as_tensor(a.astype(np.int32), device=device)

    return SMState(
        **{f: t(f) for f in SMState._fields if f != "counters"},
        counters=Counters(*(t(f) for f in Counters._fields)))


def state_to_numpy(st: SMState) -> Dict[str, np.ndarray]:
    """Inverse of :func:`state_from_numpy` (``stack_mask`` as int32)."""
    out = {f: getattr(st, f).cpu().numpy() for f in SMState._fields
           if f != "counters"}
    out.update({f: getattr(st.counters, f).cpu().numpy()
                for f in Counters._fields})
    return out
