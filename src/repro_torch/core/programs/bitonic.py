"""Bitonic sort of N values in shared memory, one block of N threads.

The NVIDIA SDK kernel: for k in {2,4,..,N}, for j in {k/2,..,1}, each
thread compare-exchanges with its partner tid^j.  Compare-exchange is
fully *predicated* (no multiplier, 2 read operands) — this is the paper's
flagship customization target: Table 6 removes the multiplier and the
third operand port for bitonic (62% area / 38% energy reduction) with a
2-deep warp stack.
"""
import numpy as np

from .. import asm, isa

IN_AT = 0


def build(n: int, blocks: int = 1) -> np.ndarray:
    """Sort ``blocks`` independent n-value segments (one per block).

    in[cta*n + tid] -> out[blocks*n + cta*n + tid]; blocks=1 is the
    paper's single-block kernel.
    """
    assert n & (n - 1) == 0 and 32 <= n <= 256
    p = asm.Program("bitonic")
    p.s2r("r0", isa.SR_TID)
    p.s2r("r13", isa.SR_CTA)
    p.shl("r14", "r13", n.bit_length() - 1)   # cta * n (n is a pow2 —
    p.iadd("r15", "r14", "r0")        # keeps the kernel multiplier-free)
    p.ldg("r1", "r15", IN_AT)
    p.sts("r0", "r1")
    p.bar()
    p.mov("r2", 2)                       # k
    p.label("k_loop")
    p.shr("r3", "r2", 1)                 # j = k >> 1
    p.label("j_loop")
    p.xor("r4", "r0", "r3")              # partner = tid ^ j
    # direction: ascending iff (tid & k) == 0
    p.and_("r5", "r0", "r2")
    # active iff partner > tid
    p.isetp("p0", "r4", "r0")            # partner > tid -> GT
    p.lds("r6", "r0")                    # mine
    p.lds("r7", "r4")                    # theirs
    p.imin("r8", "r6", "r7")             # lo
    p.imax("r9", "r6", "r7")             # hi
    p.isetp("p1", "r5", 0)               # ascending ? (r5 == 0)
    p.selp("r10", "r8", "r9", "p1", "EQ")   # keep-at-tid value
    p.selp("r11", "r9", "r8", "p1", "EQ")   # keep-at-partner value
    p.guard("p0", "GT").sts("r0", "r10")
    p.guard("p0", "GT").sts("r4", "r11")
    p.bar()
    p.shr("r3", "r3", 1)
    p.isetp("p2", "r3", 0)
    p.guard("p2", "GT").bra("j_loop")    # uniform
    p.shl("r2", "r2", 1)
    p.isetp("p3", "r2", n)
    p.guard("p3", "LE").bra("k_loop")    # uniform
    p.lds("r12", "r0")
    p.stg("r15", "r12", n * blocks)      # out at gmem[blocks*n + seg+tid]
    p.exit()
    from . import PROGRAM_PAD
    return p.finish(pad_to=PROGRAM_PAD)


def launch(n: int, blocks: int = 1):
    return (blocks, 1), (n, 1)


def n_threads(n: int, blocks: int = 1) -> int:
    return n * blocks


def make_gmem(rng: np.random.Generator, n: int,
              blocks: int = 1) -> np.ndarray:
    g = np.zeros(2 * n * blocks, np.int32)
    g[:n * blocks] = rng.integers(-10000, 10000, n * blocks,
                                  dtype=np.int32)
    return g


def out_slice(n: int, blocks: int = 1) -> slice:
    return slice(n * blocks, 2 * n * blocks)


def oracle(gmem0: np.ndarray, n: int, blocks: int = 1) -> np.ndarray:
    segs = [np.sort(gmem0[i * n:(i + 1) * n])
            for i in range(blocks)]
    return np.concatenate(segs).astype(np.int32)
