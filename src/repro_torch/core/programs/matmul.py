"""Tiled integer matrix multiply C = A @ B with 16x16 shared-memory tiles.

The classic CUDA SDK kernel: cooperative tile loads, barrier, 16 MADs per
tile, barrier.  Loop branches are warp-uniform, so the required
warp-stack depth is 0 (Table 6) and 2-SM scaling is 1.98x (Table 3).
Heaviest user of the multiplier / third-operand read port (IMAD).
"""
import numpy as np

from .. import asm, isa

TILE = 16
A_AT = 0


def build(n: int) -> np.ndarray:
    a_at, b_at, c_at = A_AT, n * n, 2 * n * n
    p = asm.Program("matmul")
    p.s2r("r0", isa.SR_TIDX)            # tx
    p.s2r("r1", isa.SR_TIDY)            # ty
    p.s2r("r2", isa.SR_CTAX)            # bx
    p.s2r("r3", isa.SR_CTAY)            # by
    p.mov("r4", TILE)
    p.imad("r5", "r3", "r4", "r1")      # row = by*16 + ty
    p.imad("r6", "r2", "r4", "r0")      # col = bx*16 + tx
    p.mov("r7", n)
    p.mov("r8", 0)                      # acc
    p.mov("r9", 0)                      # t (tile index)
    p.imad("r10", "r1", "r4", "r0")     # smem slot = ty*16 + tx
    p.label("tile_loop")
    # As[ty][tx] = A[row*N + t*16 + tx]
    p.imad("r11", "r9", "r4", "r0")     # t*16 + tx
    p.imad("r11", "r5", "r7", "r11")    # row*N + ...
    p.ldg("r12", "r11", a_at)
    p.sts("r10", "r12", 0)
    # Bs[ty][tx] = B[(t*16+ty)*N + col]
    p.imad("r11", "r9", "r4", "r1")     # t*16 + ty
    p.imad("r11", "r11", "r7", "r6")    # (t*16+ty)*N + col
    p.ldg("r12", "r11", b_at)
    p.sts("r10", "r12", 256)            # Bs at smem[256]
    p.bar()
    # inner product over the tile
    p.mov("r13", 0)                     # k
    p.label("k_loop")
    p.imad("r11", "r1", "r4", "r13")    # ty*16 + k
    p.lds("r12", "r11", 0)              # As[ty][k]
    p.imad("r11", "r13", "r4", "r0")    # k*16 + tx
    p.lds("r14", "r11", 256)            # Bs[k][tx]
    p.imad("r8", "r12", "r14", "r8")    # acc += As*Bs
    p.iadd("r13", "r13", 1)
    p.isetp("p0", "r13", TILE)
    p.guard("p0", "LT").bra("k_loop")   # uniform
    p.bar()
    p.iadd("r9", "r9", 1)
    p.isetp("p1", "r9", n // TILE)
    p.guard("p1", "LT").bra("tile_loop")  # uniform
    p.imad("r11", "r5", "r7", "r6")     # row*N + col
    p.stg("r11", "r8", c_at)
    p.exit()
    from . import PROGRAM_PAD
    return p.finish(pad_to=PROGRAM_PAD)


def launch(n: int):
    assert n % TILE == 0
    return (n // TILE, n // TILE), (TILE, TILE)


def n_threads(n: int) -> int:
    return n * n


def make_gmem(rng: np.random.Generator, n: int) -> np.ndarray:
    g = np.zeros(3 * n * n, np.int32)
    g[:2 * n * n] = rng.integers(-64, 64, 2 * n * n, dtype=np.int32)
    return g


def out_slice(n: int) -> slice:
    return slice(2 * n * n, 3 * n * n)


def oracle(gmem0: np.ndarray, n: int) -> np.ndarray:
    a = gmem0[:n * n].reshape(n, n).astype(np.int64)
    b = gmem0[n * n:2 * n * n].reshape(n, n).astype(np.int64)
    c = (a @ b)
    return (((c + 2**31) % 2**32) - 2**31).astype(np.int32).ravel()
