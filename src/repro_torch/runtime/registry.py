"""Binary cache / module registry, cost model and gmem pool (port of
``repro.runtime.registry``).

A kernel binary is data: one machine executes any program.  Programs of
different lengths land on a small fixed set of padded shapes, and loaded
binaries are memoized by content:

* :func:`bucket_code_len` / :func:`pad_code` — pad a program to the next
  length bucket with EXIT rows;
* :func:`bucket_gmem_len` — round global memory up to a power of two;
* :class:`ModuleRegistry` — content-addressed cache of loaded binaries;
* :func:`footprint` — the bucketed (code, gmem, warps) shape of a launch,
  the key the drain policies schedule on;
* :class:`CostModel` — per-module cycles/block, seeded from program
  length and memoized from completed drains, which the duration-aware
  policies pack by;
* :class:`GmemPool` — a per-ticket pool of device-resident global
  memories, the server's resident mode and its dependency stash.

In the port the buckets no longer save compiles (PyTorch runs eagerly and
the CUDA kernels take shapes as arguments), but they still fix the padded
gmem width, which decides where an out-of-range address clips, so the
executor keeps them for bit-exact parity; the drain policies key their
sub-batches on them too.  Cache and pool events are mirrored into
:data:`repro_torch.obs.METRICS` under the JAX package's names.
"""
from __future__ import annotations

import hashlib
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..core import isa
from ..core.pipeline.state import on_device, resolve_device
from ..obs import METRICS


def _count(name: str, n: int = 1) -> None:
    """Mirror a cache/pool event into the process metrics registry."""
    METRICS.counter(name).inc(n)

#: Padded-program-length buckets (all five paper kernels build at 96).
CODE_BUCKETS = (64, 96, 128, 192, 256)

#: Smallest global-memory allocation; sizes round up to powers of two.
GMEM_MIN_WORDS = 64

#: SM-width buckets: a dispatch group's pad_warps rounds up to the next
#: bucket, as in the JAX package, so a sub-batch's width is the figure
#: the reference's accounting uses.
WARP_BUCKETS = (1, 2, 4, 8)


def bucket(n: int, table, step: int) -> int:
    """Smallest table bucket holding ``n``; beyond the table, the next
    multiple of ``step``."""
    for b in table:
        if n <= b:
            return b
    return -(-n // step) * step


def bucket_code_len(n_instr: int) -> int:
    """Smallest code-length bucket that holds ``n_instr`` instructions."""
    return bucket(n_instr, CODE_BUCKETS, 64)


def bucket_gmem_len(n_words: int) -> int:
    """Global-memory bucket: next power of two, at least GMEM_MIN_WORDS."""
    b = GMEM_MIN_WORDS
    while b < n_words:
        b *= 2
    return b


def bucket_warps(n_warps: int) -> int:
    """SM-width bucket: pow2 up to 8 warps, then multiples of 8."""
    return bucket(n_warps, WARP_BUCKETS, 8)


class Footprint(NamedTuple):
    """The bucketed shape one launch occupies on the machine.

    Dispatch groups are keyed on these three axes: launches with equal
    footprints share every padded array shape, so batching them costs no
    padding at all, and the drain policies use ``gmem_bucket`` to keep a
    small tenant out of a large tenant's memory allocation.
    """
    code_bucket: int    # padded program length (instructions)
    gmem_bucket: int    # padded global-memory words (pow2)
    warp_bucket: int    # padded SM width (warps)


def footprint(module: "Module", block_dim, gmem_len: int) -> Footprint:
    """Bucketed (code, gmem, warps) footprint of one launch."""
    from . import executor as ex      # here: the executor imports us
    return Footprint(
        code_bucket=module.padded_len,
        gmem_bucket=bucket_gmem_len(gmem_len),
        warp_bucket=bucket_warps(ex.warps_for(block_dim)))


def pad_code(code: np.ndarray, pad_to: Optional[int] = None) -> np.ndarray:
    """Pad a program to ``pad_to`` (default: its bucket) with EXIT rows, so
    a PC that falls off the real program retires the warp."""
    code = np.asarray(code, np.int32)
    if code.ndim != 2 or code.shape[1] != isa.NUM_FIELDS:
        raise ValueError(f"program must be (n, {isa.NUM_FIELDS}) int32, "
                         f"got {code.shape}")
    target = bucket_code_len(len(code)) if pad_to is None else pad_to
    if len(code) > target:
        raise ValueError(f"program of {len(code)} instrs > bucket {target}")
    return np.concatenate([code, isa.exit_pad_rows(target - len(code))])


class Module(NamedTuple):
    """A loaded kernel binary: bucket-padded, content-addressed."""
    name: str
    code: np.ndarray     # (bucket_len, NUM_FIELDS) int32, EXIT-padded
    n_instr: int         # original (pre-padding) instruction count
    key: str             # content hash of the original binary

    @property
    def padded_len(self) -> int:
        return self.code.shape[0]


#: Static cycles/block prior for a module no drain has observed yet:
#: every *real* (pre-padding) instruction is charged this many cycles.
#: It is a coarse prior — issue cost is really rows_per_warp plus
#: memory latency per instruction, times warps per block — but the cost
#: model only needs it to be monotone in program length so the LPT
#: packing of :class:`~repro_torch.runtime.policy.BalancedDrain` orders cold
#: modules sensibly; the first completed drain replaces it with the
#: executed mean.
SEED_CYCLES_PER_INSTR = 32


class CostEstimate(NamedTuple):
    """One cost-model answer: predicted cycles/block and its provenance."""
    cycles_per_block: float
    observed: bool       # False while the estimate is the static seed
    samples: int         # executed blocks folded into the mean so far


class CostModel:
    """Per-module predicted cycles/block, memoized from completed drains.

    A module the server has never executed is estimated statically from
    its program length (``n_instr * SEED_CYCLES_PER_INSTR``); every
    completed drain then folds the *executed* per-block cycle counters
    into a running mean keyed on the module's content hash, so the
    prediction converges to the observed duration after one drain and
    keeps tightening as more blocks complete.  Drain policies query
    :meth:`predicted_block_cycles` to balance sub-batch durations
    (greedy LPT packing); predictions never affect results — they only
    reorder schedule positions, and every policy stays bit-exact with
    sequential execution.

    ``max_entries`` bounds the observation tables the same way the
    registry bounds modules (LRU eviction beyond it): a module evicted
    mid-drain can still be *observed* afterwards — its Module object
    survives in the pending request — so eviction-time ``forget`` alone
    would not keep a binary-churning server's tables bounded.
    """

    def __init__(self, max_entries: Optional[int] = None) -> None:
        self.max_entries = max_entries
        self._mean: Dict[str, float] = {}     # module key -> mean cyc/block
        self._samples: Dict[str, int] = {}    # module key -> blocks observed

    def seed_estimate(self, module: Module) -> float:
        """Static prior from program length (pre-padding instructions)."""
        return float(module.n_instr) * SEED_CYCLES_PER_INSTR

    def predicted_block_cycles(self, module: Module) -> float:
        """Best current cycles/block prediction: observed mean if any
        drain completed blocks of this module, the static seed otherwise."""
        if module.key in self._mean:
            return self._mean[module.key]
        return self.seed_estimate(module)

    def estimate(self, module: Module) -> CostEstimate:
        """Prediction plus provenance (observed vs seeded, sample count)."""
        key = module.key
        if key in self._mean:
            return CostEstimate(self._mean[key], True, self._samples[key])
        return CostEstimate(self.seed_estimate(module), False, 0)

    def observe(self, module: Module, cycles_per_block) -> None:
        """Fold executed per-block cycle counters into the running mean.

        ``cycles_per_block`` is a scalar or array of cycle counts, one
        per completed block — exactly ``GridResult.cycles_per_block``.
        """
        arr = np.asarray(cycles_per_block, np.float64).ravel()
        if arr.size == 0:
            return
        key = module.key
        n0 = self._samples.get(key, 0)
        m0 = self._mean.pop(key, 0.0)         # re-insert at the back:
        self._samples.pop(key, None)          # dict order is LRU order
        n1 = n0 + int(arr.size)
        self._mean[key] = (m0 * n0 + float(arr.sum())) / n1
        self._samples[key] = n1
        if self.max_entries and len(self._mean) > self.max_entries:
            self.forget(next(iter(self._mean)))

    def forget(self, key: str) -> None:
        """Drop a module's observations (paired with registry eviction)."""
        self._mean.pop(key, None)
        self._samples.pop(key, None)


def _host_copy(g: torch.Tensor) -> np.ndarray:
    """A host numpy copy of a pool entry (never a view of its storage)."""
    return g.cpu().numpy().astype(np.int32, copy=True)


class GmemPool:
    """Device-resident per-ticket global-memory pool (LRU, pinnable).

    Generalizes the server's ``DepGmem`` stash: every entry is an int32
    tensor on the pool's ``device``, keyed by producer ticket.  Entries
    with still-queued dependents are **pinned** (never evicted, reported by
    :meth:`pinned`); unpinned entries are LRU-evicted beyond
    ``max_entries``, with a host write-back sync (``host_syncs``) so an
    evicted memory is never silently lost.  ``adopt`` is the single
    host→device upload seam: a host array crosses once and is counted
    (``host_uploads``); device arrays pass through untouched.  Hit/miss
    counters make residency behaviour testable the same way the module
    registry's do.

    An upload is a numpy array (or any host sequence) or a tensor on
    another device than the pool's; a tensor already on the pool's
    device passes through uncounted, as a ``jax.Array`` does in the JAX
    package, so the counts on the CPU equal the reference's on the CPU.
    The pool lives on the card unless ``device="cpu"``.
    """

    def __init__(self, max_entries: Optional[int] = None,
                 device="cuda") -> None:
        self.device = resolve_device(device)
        self.max_entries = max_entries
        self._mem: Dict[int, object] = {}     # ticket -> device array
        self._pins: Dict[int, bool] = {}      # ticket -> pinned?
        self.hits = 0
        self.misses = 0
        self.host_uploads = 0
        self.host_syncs = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._mem)

    def __contains__(self, ticket: int) -> bool:
        return ticket in self._mem

    def adopt(self, gmem):
        """Coerce launch memory to an int32 tensor on the pool's device,
        counting the upload if it was elsewhere.  The one place host
        numpy crosses to the device on the resident path."""
        if on_device(gmem, self.device):
            return gmem if gmem.dtype == torch.int32 else \
                gmem.to(torch.int32)
        self.host_uploads += 1
        _count("gmem_pool.host_uploads")
        if isinstance(gmem, torch.Tensor):
            return gmem.to(device=self.device, dtype=torch.int32)
        return torch.as_tensor(np.asarray(gmem, np.int32),
                               device=self.device)

    def put(self, ticket: int, gmem, pin: bool = False) -> None:
        """Deposit a ticket's final gmem (a device tensor stays put)."""
        self._mem.pop(ticket, None)           # LRU refresh on re-put
        self._pins.pop(ticket, None)
        self._mem[ticket] = self.adopt(gmem)
        self._pins[ticket] = pin
        if self.max_entries is not None:
            unpinned = [t for t, p in self._pins.items() if not p]
            while len(self._mem) > self.max_entries and unpinned:
                self.evict(unpinned.pop(0))

    def pin(self, ticket: int) -> None:
        if ticket in self._pins:
            self._pins[ticket] = True

    def get(self, ticket: int):
        """Device tensor for ``ticket`` (LRU-refreshed), or None."""
        g = self._mem.get(ticket)
        if g is None:
            self.misses += 1
            _count("gmem_pool.misses")
            return None
        self.hits += 1
        _count("gmem_pool.hits")
        self._mem.pop(ticket)
        self._mem[ticket] = g                 # re-insert: dict order = LRU
        return g

    def read(self, ticket: int) -> Optional[np.ndarray]:
        """Host copy of a resident entry (explicit device→host sync)."""
        g = self._mem.get(ticket)
        if g is None:
            return None
        self.host_syncs += 1
        _count("gmem_pool.host_syncs")
        return _host_copy(g)

    def evict(self, ticket: int) -> Optional[np.ndarray]:
        """Write back and drop one entry: syncs the device tensor to host
        (the only other sync point besides :meth:`read`) and returns the
        host copy; None if the ticket is not resident."""
        g = self._mem.pop(ticket, None)
        self._pins.pop(ticket, None)
        if g is None:
            return None
        self.evictions += 1
        self.host_syncs += 1
        _count("gmem_pool.evictions")
        _count("gmem_pool.host_syncs")
        return _host_copy(g)

    def release(self, ticket: int) -> None:
        """Drop an entry nobody will read again — no write-back sync."""
        self._mem.pop(ticket, None)
        self._pins.pop(ticket, None)

    def pinned(self) -> Dict[int, object]:
        """{ticket: device tensor} of pinned entries — the live DepGmem
        stash view the server (and its tests) observe."""
        return {t: self._mem[t] for t, p in self._pins.items() if p}

    def stats(self) -> Dict[str, int]:
        return dict(entries=len(self._mem),
                    pinned=sum(1 for p in self._pins.values() if p),
                    hits=self.hits, misses=self.misses,
                    host_uploads=self.host_uploads,
                    host_syncs=self.host_syncs,
                    evictions=self.evictions)

class ModuleRegistry:
    """Content-addressed cache of loaded kernel binaries.

    ``load`` is idempotent: the same binary (bit for bit) returns the same
    :class:`Module`.  ``hits``/``misses`` expose cache behaviour; beyond
    ``max_modules`` the least recently used module is evicted.  The
    registry carries the serving layer's :class:`CostModel`
    (``cost_model``), so policies, server and CLI share one set of
    duration observations; evicting a module drops its observations.
    """

    def __init__(self, max_modules: Optional[int] = None) -> None:
        self._modules: Dict[str, Module] = {}
        self.max_modules = max_modules
        self.hits = 0
        self.misses = 0
        self.cost_model = CostModel(max_entries=max_modules)

    def __len__(self) -> int:
        return len(self._modules)

    def load(self, code: np.ndarray, name: Optional[str] = None) -> Module:
        code = np.asarray(code, np.int32)
        key = hashlib.sha1(code.tobytes()).hexdigest()
        mod = self._modules.pop(key, None)
        if mod is not None:
            self.hits += 1
            _count("module_cache.hits")
            self._modules[key] = mod         # dict order is LRU order
            return mod
        self.misses += 1
        _count("module_cache.misses")
        if self.max_modules and len(self._modules) >= self.max_modules:
            evicted = self._modules.pop(next(iter(self._modules)))  # LRU
            self.cost_model.forget(evicted.key)
        mod = Module(name=name or f"module_{key[:8]}", code=pad_code(code),
                     n_instr=len(code), key=key)
        self._modules[key] = mod
        return mod

    def as_module(self, code_or_module, name: Optional[str] = None) -> Module:
        """Coerce a raw binary (or pass through a Module) via the cache."""
        if isinstance(code_or_module, Module):
            return code_or_module
        return self.load(code_or_module, name)
