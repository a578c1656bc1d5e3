"""The benchmark's yardstick: the table of peaks, and the operations and
bytes of the work, counted from shapes alone.

Counts are of what the work needs, whatever kernels run it: each input
byte read once, each output byte written once.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

#: one NVIDIA H100 SXM (data sheet, dense): bytes/s of HBM, FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12,
              "fp32": 67e12}


def roofline_s(nbytes: float, flops: float, dtype: str) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


# ----------------------------------------------------------- the overlay
#: the counters a block hands back: two per-opcode rows of 28, cycles,
#: stack operations, the deepest stack, overflow
COUNTER_WORDS = 2 * 28 + 4


def dispatch_groups(n_blocks: int, n_sm: int,
                    chunk: int) -> List[Tuple[int, int]]:
    """The scheduler's dispatch groups of ``n_blocks`` positions as (lo,
    hi): up to ``chunk // n_sm`` super-steps of ``n_sm`` positions, the
    super-steps halving while the rest still fits."""
    spd_max, lo, out = max(1, chunk // n_sm), 0, []
    while lo < n_blocks:
        spd = spd_max
        while spd // 2 >= -(-(n_blocks - lo) // n_sm):
            spd //= 2
        hi = min(lo + spd * n_sm, n_blocks)
        out.append((lo, hi))
        lo = hi
    return out


def overlay_group_bytes(blocks: Sequence[int], gmem_words: Sequence[int],
                        code_words: Sequence[int], n_sm: int,
                        chunk: int) -> List[int]:
    """Bytes each dispatch group of one batch needs: the program of each
    launch it holds, that launch's global memory once in and once out,
    and each block's counters out (int32 words)."""
    owner = [i for i, nb in enumerate(blocks) for _ in range(nb)]
    out = []
    for lo, hi in dispatch_groups(len(owner), n_sm, chunk):
        held = sorted(set(owner[lo:hi]))
        words = sum(code_words[i] + 2 * gmem_words[i] for i in held)
        out.append(4 * (words + (hi - lo) * COUNTER_WORDS))
    return out
