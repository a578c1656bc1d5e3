"""Whisper-style encoder-decoder transformer backbone (port of
``repro.models.encdec``).

The audio frontend (mel spectrogram + conv subsampling) is a stub, as in
the JAX package: the encoder takes precomputed frame embeddings (B,
T_enc, D).  Encoder = bidirectional self-attention with RoPE; decoder =
causal self-attention + cross-attention to the encoder output.  Layer
weights are stacked on a leading ``L`` axis (``"enc"``, ``"dec"``); where
the JAX package scans over them, the port loops, one layer at a time.

Attention on the card: the decoder's self-attention is
``layers.attn_apply`` (the flash kernel, causal, in a prefill and in
training); the encoder's self-attention and the cross-attention are
``layers.full_attention`` (the flash kernel without a mask, whatever the
lengths; the plain version for a decode step's query).  So a training
step at ``remat="dots"`` launches the flash forward twice and the flash
backward once for each of the 3 attentions of a layer pair.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import layers as L
from .layers import layer_params


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    n_layers: int          # per stack (whisper-medium: 24 enc + 24 dec)
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    enc_len: int = 1500
    remat: str = "dots"

    @property
    def attn(self) -> L.AttnConfig:
        return L.AttnConfig(self.d_model, self.n_heads, self.n_kv,
                            self.d_model // self.n_heads)

    def param_count(self) -> int:
        D, F = self.d_model, self.d_ff
        dh = D // self.n_heads
        attn = D * self.n_heads * dh + 2 * D * self.n_kv * dh + \
            self.n_heads * dh * D
        ffn = 3 * D * F
        enc_layer = attn + ffn + 2 * D
        dec_layer = 2 * attn + ffn + 3 * D
        return (self.n_layers * (enc_layer + dec_layer) +
                self.vocab * D + 2 * D + self.enc_len * D)

    def active_param_count(self) -> int:
        return self.param_count()


def init(gen: torch.Generator, cfg: EncDecConfig, device=None):
    """Random bf16 parameters on ``device`` (default: ``gen``'s;
    ``"meta"`` gives the shapes without storage), the JAX package's tree:
    ``enc`` and ``dec`` stacked on a leading ``L`` axis, ``enc_pos`` drawn
    in fp32 times 0.02 and then cast."""
    D, lead, dev = cfg.d_model, (cfg.n_layers,), device or gen.device

    def norm():
        return L.rmsnorm_init(D, device=dev, lead=lead)

    enc_pos = torch.randn((cfg.enc_len, D), generator=gen, device=dev,
                          dtype=torch.float32) * 0.02
    return {
        "embed": L.embed_init(gen, cfg.vocab, D, device=dev),
        "enc_pos": enc_pos.to(L.PARAM_DTYPE),
        "enc": {"ln1": norm(), "ln2": norm(),
                "attn": L.attn_init(gen, cfg.attn, lead=lead, device=dev),
                "ffn": L.ffn_init(gen, D, cfg.d_ff, lead=lead, device=dev)},
        "dec": {"ln1": norm(), "lnx": norm(), "ln2": norm(),
                "self": L.attn_init(gen, cfg.attn, lead=lead, device=dev),
                "cross": L.attn_init(gen, cfg.attn, lead=lead, device=dev),
                "ffn": L.ffn_init(gen, D, cfg.d_ff, lead=lead, device=dev)},
        "enc_norm": L.rmsnorm_init(D, device=dev),
        "final_norm": L.rmsnorm_init(D, device=dev),
    }


def _positions(B: int, S: int, start: int, device):
    return (start + torch.arange(S, dtype=torch.int32,
                                 device=device))[None, :].expand(B, S)


def encode(params, cfg: EncDecConfig, frames, constrain=lambda t, *a: t):
    """frames: (B, T_enc, D) stub embeddings -> (B, T_enc, D); every layer
    under the remat policy (``layers.remat``)."""
    x = frames.to(L.COMPUTE_DTYPE) + params["enc_pos"][None]
    B, T, _ = x.shape
    positions = _positions(B, T, 0, x.device)
    H, Kh, dh = cfg.attn.n_heads, cfg.attn.n_kv, cfg.attn.head_dim

    def body(x, lp):
        h = L.rmsnorm(lp["ln1"], x)
        q = L.split_last(h @ lp["attn"]["wq"], H, dh)
        k = L.split_last(h @ lp["attn"]["wk"], Kh, dh)
        v = L.split_last(h @ lp["attn"]["wv"], Kh, dh)
        q = L.apply_rope(q, positions)
        k = L.apply_rope(k, positions)
        o = L.full_attention(q, k, v)
        x = x + constrain(L.merge_last(o) @ lp["attn"]["wo"],
                          "act_resid")
        return x + L.ffn_apply(lp["ffn"], L.rmsnorm(lp["ln2"], x), constrain)

    body = L.remat(cfg.remat, body)
    for i in range(cfg.n_layers):
        x = body(x, layer_params(params["enc"], i))
    return L.rmsnorm(params["enc_norm"], x)


def cross_kv(params, cfg: EncDecConfig, enc_out):
    """Every decoder layer's cross K/V from the encoder output: (k, v),
    each (Ldec, B, T, K, dh)."""
    B, T, D = enc_out.shape
    Kh, dh = cfg.attn.n_kv, cfg.attn.head_dim
    cross = params["dec"]["cross"]
    ks = [L.split_last(enc_out @ w, Kh, dh) for w in cross["wk"]]
    vs = [L.split_last(enc_out @ w, Kh, dh) for w in cross["wv"]]
    return torch.stack(ks), torch.stack(vs)


def decode(params, cfg: EncDecConfig, tokens, enc_out=None, *,
           cross=None, kv_caches=None, cache_index: Optional[int] = None,
           constrain=lambda t, *a: t):
    """Decoder forward: tokens (B, S) -> logits (B, S, V) fp32.  Supply
    either ``enc_out`` (training) or ``cross`` ((k, v) from
    :func:`cross_kv`, serving).  ``kv_caches``: the self-attention's
    stacked (k, v), each (L, B, T, K, dh), written in place and returned
    with the logits.  Each layer runs under the remat policy only
    without caches, as in the JAX package."""
    if cross is None:
        cross = cross_kv(params, cfg, enc_out)
    x = constrain(L.embed_apply(params["embed"], tokens), "act_resid")
    B, S, _ = x.shape
    start = 0 if cache_index is None else int(cache_index)
    positions = _positions(B, S, start, x.device)
    H, dh = cfg.attn.n_heads, cfg.attn.head_dim

    def body(x, lp, ck, cv, cache=None):
        h, new_cache = L.attn_apply(lp["self"], cfg.attn,
                                    L.rmsnorm(lp["ln1"], x), positions,
                                    kv_cache=cache, cache_index=cache_index,
                                    constrain=constrain)
        x = x + h
        hx = L.rmsnorm(lp["lnx"], x)
        q = L.split_last(hx @ lp["cross"]["wq"], H, dh)
        o = L.full_attention(q, ck, cv)
        x = x + constrain(L.merge_last(o) @ lp["cross"]["wo"],
                          "act_resid")
        x = x + L.ffn_apply(lp["ffn"], L.rmsnorm(lp["ln2"], x), constrain)
        return x, new_cache

    if kv_caches is None:
        step = L.remat(cfg.remat, lambda x, lp, ck, cv: body(x, lp, ck,
                                                             cv)[0])
    for i in range(cfg.n_layers):
        lp = layer_params(params["dec"], i)
        if kv_caches is None:
            x = step(x, lp, cross[0][i], cross[1][i])
        else:
            x, _ = body(x, lp, cross[0][i], cross[1][i],
                        (kv_caches[0][i], kv_caches[1][i]))
    x = L.rmsnorm(params["final_norm"], x)
    logits = L.unembed_apply(params["embed"], x)
    return (logits, kv_caches) if kv_caches is not None else logits


def forward(params, cfg: EncDecConfig, frames, tokens,
            constrain=lambda t, *a: t):
    """Full encoder-decoder training forward: logits (B, S, V) fp32."""
    enc_out = encode(params, cfg, frames, constrain)
    return decode(params, cfg, tokens, enc_out, constrain=constrain)
