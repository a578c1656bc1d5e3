"""Binary cache / module registry (port of the parts of
``repro.runtime.registry`` the executor needs).

A kernel binary is data: one machine executes any program.  Programs of
different lengths land on a small fixed set of padded shapes, and loaded
binaries are memoized by content:

* :func:`bucket_code_len` / :func:`pad_code` — pad a program to the next
  length bucket with EXIT rows;
* :func:`bucket_gmem_len` — round global memory up to a power of two;
* :class:`ModuleRegistry` — content-addressed cache of loaded binaries.

In the port the buckets no longer save compiles (PyTorch runs eagerly and
the CUDA kernels take shapes as arguments), but they still fix the padded
gmem width, which decides where an out-of-range address clips, so the
executor keeps them for bit-exact parity.  The registry's ``CostModel``,
``GmemPool`` and metrics mirroring wait for the serving runtime's port.
"""
from __future__ import annotations

import hashlib
from typing import Dict, NamedTuple, Optional

import numpy as np

from ..core import isa

#: Padded-program-length buckets (all five paper kernels build at 96).
CODE_BUCKETS = (64, 96, 128, 192, 256)

#: Smallest global-memory allocation; sizes round up to powers of two.
GMEM_MIN_WORDS = 64


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


class ModuleRegistry:
    """Content-addressed cache of loaded kernel binaries.

    ``load`` is idempotent: the same binary (bit for bit) returns the same
    :class:`Module`.  ``hits``/``misses`` expose cache behaviour; beyond
    ``max_modules`` the least recently used module is evicted.
    """

    def __init__(self, max_modules: Optional[int] = None) -> None:
        self._modules: Dict[str, Module] = {}
        self.max_modules = max_modules
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._modules)

    def load(self, code: np.ndarray, name: Optional[str] = None) -> Module:
        code = np.asarray(code, np.int32)
        key = hashlib.sha1(code.tobytes()).hexdigest()
        mod = self._modules.pop(key, None)
        if mod is not None:
            self.hits += 1
            self._modules[key] = mod         # dict order is LRU order
            return mod
        self.misses += 1
        if self.max_modules and len(self._modules) >= self.max_modules:
            self._modules.pop(next(iter(self._modules)))
        mod = Module(name=name or f"module_{key[:8]}", code=pad_code(code),
                     n_instr=len(code), key=key)
        self._modules[key] = mod
        return mod

    def as_module(self, code_or_module, name: Optional[str] = None) -> Module:
        """Coerce a raw binary (or pass through a Module) via the cache."""
        if isinstance(code_or_module, Module):
            return code_or_module
        return self.load(code_or_module, name)
