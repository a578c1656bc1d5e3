"""The yardstick of the hybrid LM cells: the model FLOPs of a Zamba2
training step and the shapes of its flash calls, counted from a
configuration file's published keys (``ctx["config"]``) and a cell's
batch and sequence (``ctx["workload"]``) alone.

Counts are of what the model needs, nothing recomputed: 6 a weight and a
token for every product (the forward, and the backward's two), causal
attention's QK^T and PV forward (4 dh a pair) and backward (twice the
forward), and the SSD's chunked einsums forward and backward (three
times the forward).
"""
from __future__ import annotations

from typing import Optional, Tuple

from perfbench import counts


def is_zamba2(cfg: Optional[dict]) -> bool:
    return bool(cfg) and cfg.get("model_type") == "zamba2"


def _mamba_dims(cfg: dict):
    D = cfg["hidden_size"]
    DI = cfg["mamba_expand"] * D
    GN = cfg["mamba_ngroups"] * cfg["mamba_d_state"]
    return D, DI, GN, cfg["n_mamba_heads"]


def product_params(cfg: dict) -> int:
    """Weights that enter a product, a token each: every Mamba2 layer's
    in_proj and out_proj; for each shared-block call its block's q, k, v,
    o, gate-up and down, its adapter's two factors and its linear; and
    the tied unembedding (the embedding's lookup and the depthwise conv
    are no products)."""
    D, DI, GN, H = _mamba_dims(cfg)
    layer = D * (2 * DI + 2 * GN + H) + DI * D
    A, heads, kv = cfg["attention_hidden_size"], \
        cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh, F, r = cfg["attention_head_dim"], cfg["intermediate_size"], \
        cfg["adapter_rank"]
    call = (A * heads * dh + 2 * A * kv * dh + heads * dh * D +
            D * 2 * F + F * D + D * r + r * 2 * F + D * D)
    return cfg["num_hidden_layers"] * layer + \
        len(cfg["hybrid_layer_ids"]) * call + cfg["vocab_size"] * D


def ssd_flops(cfg: dict, batch: int, seq: int) -> int:
    """One forward of every layer's chunked scan: C B^T within a chunk
    and its product with x (2 Q N and 2 Q P a position and head), each
    chunk's end state and the carried states' output (2 P N each)."""
    _, DI, _, H = _mamba_dims(cfg)
    P, N, Q = DI // H, cfg["mamba_d_state"], min(cfg["chunk_size"], seq)
    per_layer = 2 * batch * seq * H * (Q * N + Q * P + 2 * P * N)
    return cfg["num_hidden_layers"] * per_layer


def flash_shape(cfg: dict, batch: int, seq: int) -> Tuple:
    """(batch, seq, heads, kv heads, dh, dtype) of one shared-block call's
    flash attention."""
    return (batch, seq, cfg["num_attention_heads"],
            cfg["num_key_value_heads"], cfg["attention_head_dim"], "bf16")


def train_flops(cfg: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one training step (the module's rule)."""
    tokens = batch * seq
    attn = 3 * 4 * cfg["attention_head_dim"] * counts.causal_pairs(
        batch, cfg["num_attention_heads"], seq)
    return (6 * product_params(cfg) * tokens +
            len(cfg["hybrid_layer_ids"]) * attn +
            3 * ssd_flops(cfg, batch, seq))


def cell_shape(ctx: dict):
    """(config, batch, seq) of a Zamba2 cell's context, else None."""
    cfg, wl = ctx.get("config"), ctx.get("workload")
    if not is_zamba2(cfg) or not wl:
        return None
    return cfg, wl["batch"], wl["seq"]
