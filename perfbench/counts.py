"""The benchmark's yardstick: the table of peaks, and the operations and
bytes of the work, counted from shapes alone.

Counts are of what the work needs, whatever kernels run it: each input
byte read once, each output byte written once.
"""
from __future__ import annotations

from typing import Sequence, Tuple

#: one NVIDIA H100 SXM (data sheet, dense): bytes/s of HBM, FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12,
              "fp32": 67e12}

#: bytes of an element of each dtype the work is counted in
ITEMSIZE = {"bf16": 2, "fp16": 2, "fp32": 4}


def roofline_s(nbytes: float, flops: float, dtype: str) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


# ----------------------------------------------------------- the overlay
#: the counters a block hands back: two per-opcode rows of 28, cycles,
#: stack operations, the deepest stack, overflow
COUNTER_WORDS = 2 * 28 + 4


def overlay_batch_bytes(blocks: Sequence[int], gmem_words: Sequence[int],
                        code_words: Sequence[int]) -> int:
    """Bytes one batch of launches needs, however the executor groups its
    blocks: each launch's program in, its global memory once in and once
    out, and each block's counters out (int32 words)."""
    words = sum(c + 2 * g for c, g in zip(code_words, gmem_words))
    return 4 * (words + sum(blocks) * COUNTER_WORDS)


# ------------------------------------------------------ the dense decoder
def dense_lm_product_params(cfg: dict) -> int:
    """Weights that enter a product, a token each: per layer the four
    attention projections and the three of the gated feed-forward, and
    the unembedding (V x D, tied or not; the embedding's lookup is no
    product).  ``cfg`` is a configuration file's published keys."""
    D, F, V = cfg["hidden_size"], cfg["intermediate_size"], \
        cfg["vocab_size"]
    H, K, dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], \
        cfg["head_dim"]
    attn = D * H * dh + 2 * D * K * dh + H * dh * D
    return cfg["num_hidden_layers"] * (attn + 3 * D * F) + V * D


def causal_pairs(batch: int, heads: int, seq: int) -> int:
    """(query, key) pairs a causal mask keeps, the diagonal included."""
    return batch * heads * (seq * (seq + 1) // 2)


def dense_lm_train_flops(cfg: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one training step, nothing recomputed: 6 a weight
    and token for the products (forward, and the backward's two), and
    causal attention's QK^T and PV forward (4 dh a pair) and backward
    (twice the forward)."""
    tokens = batch * seq
    attn = 3 * 4 * cfg["head_dim"] * causal_pairs(
        batch, cfg["num_attention_heads"], seq)
    return 6 * dense_lm_product_params(cfg) * tokens + \
        cfg["num_hidden_layers"] * attn


def flash_fwd_work(batch: int, seq: int, heads: int, kv_heads: int,
                   dh: int, dtype: str) -> Tuple[int, int]:
    """(bytes, FLOPs) of one causal flash forward that training calls: q,
    k, v in, o out, and the rows' fp32 log-sum-exp out; QK^T and PV over
    the pairs the mask keeps."""
    esz = ITEMSIZE[dtype]
    nbytes = esz * (2 * batch * seq * heads * dh +
                    2 * batch * seq * kv_heads * dh) + 4 * batch * heads * seq
    return nbytes, 4 * dh * causal_pairs(batch, heads, seq)


def flash_bwd_work(batch: int, seq: int, heads: int, kv_heads: int,
                   dh: int, dtype: str) -> Tuple[int, int]:
    """(bytes, FLOPs) of one causal flash backward: q, o, dO in and dQ
    out, k, v in and dK, dV out, the log-sum-exp in; five products (S
    again, dP, dV, dQ, dK) over the pairs the mask keeps.  S is counted
    because the forward hands on o and the log-sum-exp, not P."""
    esz = ITEMSIZE[dtype]
    nbytes = esz * (4 * batch * seq * heads * dh +
                    4 * batch * seq * kv_heads * dh) + 4 * batch * heads * seq
    return nbytes, 5 * 2 * dh * causal_pairs(batch, heads, seq)
