"""The model-facing wrappers of the port's kernels (port of
``repro.kernels.ops``).

Model code calls these.  ``simt_alu``, ``matmul`` and ``mha`` keep the JAX package's
signatures and its shape rule, so the same shapes reach the kernels: on
CUDA tensors they launch the hand-written kernels, on CPU tensors the
plain versions.  There is no interpret mode and no fallback on a kernel
failure.
"""
from __future__ import annotations

from . import flash_attention as _fa
from . import matmul as _mm
from . import ref
from . import simt_alu as _sa


def simt_alu(op, s1, s2, s3, cond, s2r, mask, *, enable_mul=True,
             num_read_operands=3):
    return _sa.simt_alu(op, s1, s2, s3, cond, s2r, mask,
                        enable_mul=enable_mul,
                        num_read_operands=num_read_operands)


def matmul(a, b, **kw):
    return _mm.matmul(a, b, **kw)


def tile_ok(Sq: int, Sk: int) -> bool:
    """The JAX package's rule for which shapes take the flash kernel."""
    return Sq % min(256, Sq) == 0 and Sk % min(256, Sk) == 0 and Sq > 8


def mha(q, k, v, *, causal=True, bq=256, bk=256, use_kernel=True,
        scale=None):
    """(B, S, H, dh) GQA attention via the flash kernel.

    q (B, Sq, H, dh), k/v (B, Sk, KH, dh); the scores scaled by ``scale``
    (None: dh ** -0.5).  Shapes that pass
    :func:`tile_ok` take the kernel (causal mask aligned top-left, as the
    TPU kernel's); the others, e.g. decode, and every shape under
    ``use_kernel=False``, take the plain oracle, aligned bottom-right as
    the JAX package's oracle is.  The two alignments agree when Sq == Sk.
    Under autograd the kernel branch is ``flash_attention.FlashAttention``,
    whose backward is the flash backward kernel on the card and the plain
    backward on the CPU.
    """
    Sq, Sk = q.shape[1], k.shape[1]
    if use_kernel and tile_ok(Sq, Sk):
        _fa.check_blocks(Sq, Sk, bq, bk)
        kw = {} if scale is None else {"scale": scale}
        return _fa.flash_attention_gqa(q, k, v, causal=causal, **kw)
    return ref.mha_ref(q, k, v, causal=causal, q_offset=Sk - Sq,
                       scale=scale)
