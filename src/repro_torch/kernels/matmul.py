"""The tiled matmul kernel (port of ``repro.kernels.matmul.matmul``).

Replaces the Pallas kernel ``matmul`` (body ``_mm_kernel``): (M, K) @
(K, N) with a float32 accumulator, the output in ``a``'s dtype.  On the
card it is ``csrc/matmul.cu``: 64 x 64 output tiles, 16-deep K steps
staged in shared memory, IEEE fp32 FMAs (never TF32).  The block sizes
``bm``, ``bn``, ``bk`` keep the TPU kernel's rule (clipped to the dims,
each must divide its dim) so the same shapes are accepted; the kernel's
own tiles are fixed and mask the edges.

CPU tensors take the plain version :func:`.ref.matmul_ref`; CUDA tensors
launch the kernel or raise.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import matmul_ref


def matmul(a, b, *, bm: int = 512, bn: int = 512, bk: int = 512):
    """a (M, K) @ b (K, N) -> (M, N); dtype follows ``a``."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} do not chain")
    (M, K), N = a.shape, b.shape[1]
    if min(M, N, K) < 1:
        raise ValueError("matmul: every dimension must be positive")
    bm, bn, bk = min(bm, M), min(bn, N), min(bk, K)
    if M % bm or N % bn or K % bk:
        raise ValueError(f"matmul: blocks ({bm}, {bn}, {bk}) do not tile "
                         f"({M}, {N}, {K})")
    if a.dtype not in _build.DTYPES or b.dtype != a.dtype:
        raise ValueError("matmul: a and b must both be float32 or both "
                         "bfloat16")
    if not a.is_cuda:
        return matmul_ref(a, b)
    if not b.is_cuda or b.device != a.device:
        raise ValueError("matmul: a and b must be on one device")
    a, b = a.contiguous(), b.contiguous()
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    lib = _build.load()
    rc = lib.matmul_launch(a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K,
                           _build.DTYPES[a.dtype], _build.stream_ptr(a))
    _build.check(rc, "matmul")
    _build.LAUNCHES["matmul"] += 1
    return c
