"""Matrix transpose: out[i*N+j] = in[j*N+i], 16x16 thread blocks.

Straight-line code (no branches) — the paper's transpose needs warp-stack
depth 0 (Table 6) and scales near-perfectly to 2 SMs (1.98x, Table 3).
"""
import numpy as np

from .. import asm, isa

TILE = 16
IN_AT = 0


def build(n: int) -> np.ndarray:
    p = asm.Program("transpose")
    p.s2r("r0", isa.SR_TIDX)          # tx
    p.s2r("r1", isa.SR_TIDY)          # ty
    p.s2r("r2", isa.SR_CTAX)          # bx
    p.s2r("r3", isa.SR_CTAY)          # by
    p.mov("r4", TILE)
    p.imad("r5", "r2", "r4", "r0")    # i = bx*16 + tx
    p.imad("r6", "r3", "r4", "r1")    # j = by*16 + ty
    p.mov("r7", n)
    p.imad("r8", "r6", "r7", "r5")    # j*N + i   (read index)
    p.imad("r9", "r5", "r7", "r6")    # i*N + j   (write index)
    p.ldg("r10", "r8", IN_AT)
    p.stg("r9", "r10", n * n)         # out at n*n
    p.exit()
    from . import PROGRAM_PAD
    return p.finish(pad_to=PROGRAM_PAD)


def launch(n: int):
    assert n % TILE == 0
    return (n // TILE, n // TILE), (TILE, TILE)


def n_threads(n: int) -> int:
    return n * n


def make_gmem(rng: np.random.Generator, n: int) -> np.ndarray:
    g = np.zeros(2 * n * n, np.int32)
    g[:n * n] = rng.integers(-1000, 1000, n * n, dtype=np.int32)
    return g


def out_slice(n: int) -> slice:
    return slice(n * n, 2 * n * n)


def oracle(gmem0: np.ndarray, n: int) -> np.ndarray:
    a = gmem0[:n * n].reshape(n, n)
    return a.T.ravel()
