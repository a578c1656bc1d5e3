"""The tiled matmul kernel (port of ``repro.kernels.matmul.matmul``).

Replaces the Pallas kernel ``matmul`` (body ``_mm_kernel``): (M, K) @
(K, N) with a float32 accumulator, the output in ``a``'s dtype.  On the
card it is ``csrc/matmul.cu``: 64 x 32 output tiles, 32-deep K slabs in
a ``cp.async`` ring (3 stages for float32, 4 for bfloat16); float32 as
register-blocked IEEE fp32 FMAs (never TF32), bfloat16 on the tensor
cores (``mma.sync``).  The block sizes ``bm``, ``bn``, ``bk`` keep the TPU kernel's rule (clipped to the
dims, each must divide its dim) so the same shapes are accepted; the
kernel's own tiles are fixed and mask the edges.  :func:`variant` names
which of the four kernels a call takes: the dtype's (``"simt"`` for
float32, ``"tc"`` for bfloat16), with ``"_scalar"`` where rows are not
whole 16-byte vectors.

CPU tensors take the plain version :func:`.ref.matmul_ref`; CUDA tensors
launch the kernel or raise.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import matmul_ref

#: elements of one 16-byte vector, by dtype
_VEC = {torch.float32: 4, torch.bfloat16: 8}


def variant(a, b) -> str:
    """The kernel a (M, K) @ (K, N) call takes, from dtypes, shapes and
    pointers alone: ``"simt"`` (float32) or ``"tc"`` (bfloat16), with
    ``"_scalar"`` appended where the 16-byte copies do not fit: float32
    copies B by vectors (A goes by 4-byte copies, transposed), so it needs
    N a multiple of 4 and B 16-byte aligned; bfloat16 copies both, so it
    needs K and N multiples of 8 and A, B 16-byte aligned."""
    if a.dtype == torch.bfloat16:
        base, copied, dims = "tc", (a, b), (a.shape[1], b.shape[1])
    else:
        base, copied, dims = "simt", (b,), (b.shape[1],)
    if any(d % _VEC[a.dtype] for d in dims) or any(
            x.data_ptr() % 16 for x in copied):
        return base + "_scalar"
    return base


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
    chosen = variant(a, b)
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    lib = _build.load()
    rc = lib.matmul_launch(a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K,
                           _build.DTYPES[a.dtype],
                           int(not chosen.endswith("_scalar")),
                           _build.stream_ptr(a))
    _build.check(rc, "matmul")
    _build.LAUNCHES["matmul"] += 1
    _build.VARIANTS[("matmul", chosen)] += 1
    return c
