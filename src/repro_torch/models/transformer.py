"""Dense / MoE decoder-only transformer (port of
``repro.models.transformer``, the llama/qwen/dbrx family).

Layer weights are stacked on a leading ``L`` axis as in the JAX package;
where it scans over them, :func:`forward` and :func:`loss` loop, one layer
at a time.  :func:`loss` applies the remat policy to each layer as the
JAX package applies it to its scan body:

* ``"none"``: nothing is recomputed;
* ``"full"``: ``torch.utils.checkpoint`` of the whole layer (non-reentrant):
  only its input is kept, the layer runs again in the backward pass;
* ``"dots"``: a selective checkpoint that keeps the outputs of the weight
  products (``aten.mm``, the 2-D matrix products that the (B, S, D) @ (D,
  F) projections lower to: the counterpart of
  ``checkpoint_dots_with_no_batch_dims``) and recomputes the rest,
  attention included.

So on the card one training step launches the flash forward once a layer
under ``"none"`` and twice under ``"dots"`` and ``"full"`` (the recompute),
and the flash backward once a layer.  A mixture-of-experts layer
(``cfg.moe``) runs ``moe.moe_apply`` in the FFN's place.

``forward`` and ``loss`` take the JAX package's ``constrain`` hook and
call it at its sites: ``act_resid`` on the embedding, and through
``_block`` in every layer (``layers.attn_apply``, ``layers.ffn_apply``,
``moe.moe_apply``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import layers as L
from .layers import layer_params
from .moe import MoEConfig, moe_apply, moe_init


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    rope_theta: float = 10000.0
    moe: Optional[MoEConfig] = None
    tie_embeddings: bool = True
    # remat policy of each layer in ``loss``: "none" | "dots" | "full"
    remat: str = "dots"
    attn_impl: str = "reference"   # "reference" | "chunked"
    q_chunk: int = 512
    softmax_dtype: str = "f32"     # "f32" | "bf16" (perf variant)
    loss_chunk: int = 0            # >0: chunked big-vocab cross-entropy

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def attn(self) -> L.AttnConfig:
        return L.AttnConfig(self.d_model, self.n_heads, self.n_kv, self.dh,
                            self.qk_norm, self.rope_theta,
                            impl=self.attn_impl, q_chunk=self.q_chunk,
                            softmax_dtype=self.softmax_dtype)

    def param_count(self) -> int:
        D, F, V, H, K, dh = (self.d_model, self.d_ff, self.vocab,
                             self.n_heads, self.n_kv, self.dh)
        attn = D * H * dh + 2 * D * K * dh + H * dh * D
        if self.moe:
            ffn = self.moe.n_experts * 3 * D * self.moe.d_ff + \
                D * self.moe.n_experts
        else:
            ffn = 3 * D * F
        per_layer = attn + ffn + 2 * D
        return self.n_layers * per_layer + V * D + D + \
            (0 if self.tie_embeddings else V * D)

    def active_param_count(self) -> int:
        if not self.moe:
            return self.param_count()
        D = self.d_model
        attn = D * self.n_heads * self.dh + 2 * D * self.n_kv * self.dh + \
            self.n_heads * self.dh * D
        ffn = self.moe.top_k * 3 * D * self.moe.d_ff + \
            D * self.moe.n_experts
        per_layer = attn + ffn + 2 * D
        return self.n_layers * per_layer + self.vocab * D + D


def init_layer(gen: torch.Generator, cfg: LMConfig, device=None):
    """One layer's weights (the JAX package's ``init_layer``): ``ln1``,
    ``ln2``, ``attn`` and ``ffn`` (or ``moe``), unstacked."""
    dev = device or gen.device
    p = {"ln1": L.rmsnorm_init(cfg.d_model, device=dev),
         "ln2": L.rmsnorm_init(cfg.d_model, device=dev),
         "attn": L.attn_init(gen, cfg.attn, device=dev)}
    if cfg.moe:
        p["moe"] = moe_init(gen, cfg.moe, device=dev)
    else:
        p["ffn"] = L.ffn_init(gen, cfg.d_model, cfg.d_ff, device=dev)
    return p


def init(gen: torch.Generator, cfg: LMConfig, device=None):
    """Random bf16 parameters on ``device`` (default: ``gen``'s), the JAX
    package's tree with every layer weight stacked on a leading ``L``
    axis (a moe layer's ``"moe"`` in the place of ``"ffn"``).
    ``device="meta"`` gives the shapes without storage."""
    lead, dev = (cfg.n_layers,), device or gen.device
    layers = {
        "ln1": L.rmsnorm_init(cfg.d_model, device=dev, lead=lead),
        "ln2": L.rmsnorm_init(cfg.d_model, device=dev, lead=lead),
        "attn": L.attn_init(gen, cfg.attn, lead=lead, device=dev),
    }
    if cfg.moe:
        layers["moe"] = moe_init(gen, cfg.moe, lead=lead, device=dev)
    else:
        layers["ffn"] = L.ffn_init(gen, cfg.d_model, cfg.d_ff, lead=lead,
                                   device=dev)
    p = {
        "embed": L.embed_init(gen, cfg.vocab, cfg.d_model, device=dev),
        "layers": layers,
        "final_norm": L.rmsnorm_init(cfg.d_model, device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.embed_init(gen, cfg.vocab, cfg.d_model, device=dev)
    return p


def _block(cfg: LMConfig, constrain, lp, x, positions, kv_cache=None,
           cache_index=None):
    h, new_cache = L.attn_apply(lp["attn"], cfg.attn,
                                L.rmsnorm(lp["ln1"], x), positions,
                                kv_cache=kv_cache, cache_index=cache_index,
                                constrain=constrain)
    x = x + h
    hn = L.rmsnorm(lp["ln2"], x)
    if cfg.moe:
        x = x + moe_apply(lp["moe"], cfg.moe, hn, constrain)
    else:
        x = x + L.ffn_apply(lp["ffn"], hn, constrain)
    return x, new_cache


def _embed(params, tokens, prefix_embed, constrain):
    """The token embeddings, ``prefix_embed`` (B, P, D) cast to their
    dtype and concatenated in front when given; ``act_resid``."""
    x = L.embed_apply(params["embed"], tokens)
    if prefix_embed is not None:
        x = torch.cat([prefix_embed.to(x.dtype), x], dim=1)
    return constrain(x, "act_resid")


def forward(params, cfg: LMConfig, tokens, *, constrain=lambda t, *a: t,
            kv_caches=None, cache_index: Optional[int] = None,
            prefix_embed=None):
    """tokens: (B, S) int -> logits (B, P + S, V) fp32.

    ``kv_caches``: stacked (k, v) each (L, B, T, K, dh), written in place
    and returned with the logits.  ``prefix_embed``: optional (B, P, D)
    embeddings prepended to the token embeddings (the VLM's image
    patches); positions run over the whole P + S from ``cache_index``.
    """
    x = _embed(params, tokens, prefix_embed, constrain)
    B, S, D = x.shape
    start = 0 if cache_index is None else int(cache_index)
    positions = (start + torch.arange(S, dtype=torch.int32,
                                      device=x.device))[None, :].expand(B, S)
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        cache = None if kv_caches is None else \
            (kv_caches[0][i], kv_caches[1][i])
        x, _ = _block(cfg, constrain, lp, x, positions, cache, cache_index)
    x = L.rmsnorm(params["final_norm"], x)
    head = params.get("lm_head", params["embed"])
    logits = L.unembed_apply(head, x)
    return (logits, kv_caches) if kv_caches is not None else logits


# ------------------------------------------------------------------ training
def _trunk(params, cfg: LMConfig, tokens, prefix_embed, constrain):
    """Embedding (``prefix_embed`` in front, as in :func:`forward`), the
    layers under the remat policy, the final norm: (B, P + S, D)."""
    x = _embed(params, tokens, prefix_embed, constrain)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None, :].expand(B, S)

    def body(x, lp):
        return _block(cfg, constrain, lp, x, positions)[0]

    body = L.remat(cfg.remat, body)
    for i in range(cfg.n_layers):
        x = body(x, layer_params(params["layers"], i))
    return L.rmsnorm(params["final_norm"], x)


def loss(params, cfg: LMConfig, tokens, labels, *,
         constrain=lambda t, *a: t, prefix_embed=None, prefix_drop: int = 0):
    """Training loss, the token mean (labels < 0 are padding); the chunked
    big-vocabulary cross-entropy when ``cfg.loss_chunk > 0``.  The first
    ``prefix_drop`` positions (the VLM's image prefix, ``prefix_embed``)
    are dropped before the unembedding: the JAX function unembeds them
    too when ``loss_chunk == 0`` and slices the logits, the same logits
    kept, since the unembedding is per row."""
    x = _trunk(params, cfg, tokens, prefix_embed, constrain)[:, prefix_drop:]
    head = params.get("lm_head", params["embed"])
    if cfg.loss_chunk <= 0:
        return L.softmax_xent(L.unembed_apply(head, x), labels)
    return L.softmax_xent_chunked(head, x, labels, chunk=cfg.loss_chunk)
