"""Zamba2-style hybrid: a Mamba2 backbone plus one SHARED attention block
applied every ``attn_every`` layers (port of ``repro.models.hybrid``,
arXiv:2411.15242).

The shared block's parameters are reused at every application point;
each application point owns its own KV cache.  The layers run in groups,
the shared block before each group: ``n_apps`` applications, the last
group shorter when ``attn_every`` does not divide ``n_layers``.  When
training, each mamba block runs under the remat policy and the shared
block outside it, as in the JAX package; its attention is
``layers.attn_apply``, so on the card a training step launches the flash
forward and the flash backward once an application, and a prefill the
flash forward once an application.

:class:`Zamba2Config` is the published Zamba2 block (``transformers``'
``Zamba2ForCausalLM``, arXiv:2411.15242), on the same entry points
(:func:`init`, :func:`forward`, :func:`init_decode_state` take either
config):

* ``num_mem_blocks`` shared blocks, tied across their calls: the layers
  in ``hybrid_layer_ids`` each call one, call c the block c mod
  ``num_mem_blocks``;
* a call takes ``concat(h, emb)`` (the stream and the token embedding,
  2D wide) through an RMSNorm into attention (MHA over 2D, heads of
  ``head_dim``, RoPE over the whole head, scores scaled by (head_dim /
  2) ** -0.5) whose output projection maps to D, then an RMSNorm and a
  GELU-gated MLP whose fused gate-up product adds call c's own low-rank
  term ``x @ lora_a[c] @ lora_b[c]``;
* the block has no residual of its own: call c's ``linear[c]`` carries its
  output into its layer's Mamba2 input, ``h + mamba(norm(h + linear(
  block(h, emb))))``, the residual staying h;
* the Mamba2 layers normalise after the gate, per group, with a conv
  bias, eps ``norm_eps`` and dt clamped at ``dt_min``
  (:class:`~repro_torch.models.mamba2.PublishedMamba2Config`).

Each call is the span ``hybrid.shared-block`` of ``obs.trace.TRACER``
(attributes ``call`` and ``block``), and a forward adds a sample to its
counter ``hybrid.forward`` (``shared_block_calls``, ``ssd_chunks``).  When
training, each Mamba2 layer runs under the remat policy and the shared
blocks outside it: a training step launches the flash forward and backward
once a call.  One KV cache a call serves prefill and decode.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..obs.trace import TRACER
from . import layers as L
from . import mamba2 as M


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    name: str
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int
    n_kv: int
    d_ff: int
    d_state: int = 64
    head_dim: int = 64
    attn_every: int = 6
    remat: str = "dots"

    @property
    def mamba(self) -> M.Mamba2Config:
        return M.Mamba2Config(
            name=self.name + "-mamba", n_layers=self.n_layers,
            d_model=self.d_model, vocab=self.vocab, d_state=self.d_state,
            head_dim=self.head_dim, remat=self.remat)

    @property
    def attn(self) -> L.AttnConfig:
        return L.AttnConfig(self.d_model, self.n_heads, self.n_kv,
                            self.d_model // self.n_heads)

    @property
    def n_apps(self) -> int:
        return -(-self.n_layers // self.attn_every)

    def param_count(self) -> int:
        m = self.mamba.param_count()
        D, dh = self.d_model, self.d_model // self.n_heads
        shared = (D * self.n_heads * dh + 2 * D * self.n_kv * dh +
                  self.n_heads * dh * D + 3 * D * self.d_ff + 2 * D)
        return m + shared

    def active_param_count(self) -> int:
        return self.param_count()


@dataclasses.dataclass(frozen=True)
class Zamba2Config:
    """The published Zamba2 hybrid (``transformers``' ``Zamba2Config``
    names in comments)."""
    name: str
    n_layers: int                 # num_hidden_layers
    d_model: int                  # hidden_size
    vocab: int                    # vocab_size
    n_heads: int                  # num_attention_heads
    n_kv: int                     # num_key_value_heads
    head_dim: int                 # attention_head_dim: 2 * d_model / n_heads
    d_ff: int                     # intermediate_size
    hybrid_layer_ids: Tuple[int, ...]
    num_mem_blocks: int = 2
    adapter_rank: int = 128
    d_state: int = 64             # mamba_d_state
    mamba_head_dim: int = 64      # mamba_headdim
    n_groups: int = 2             # mamba_ngroups
    expand: int = 2               # mamba_expand
    conv_width: int = 4           # mamba_d_conv
    chunk: int = 256              # chunk_size
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5        # rms_norm_eps (and the gated norm's)
    dt_min: float = 0.001         # time_step_min
    remat: str = "dots"

    @property
    def mamba(self) -> M.Mamba2Config:
        return M.PublishedMamba2Config(
            name=self.name + "-mamba", n_layers=self.n_layers,
            d_model=self.d_model, vocab=self.vocab, d_state=self.d_state,
            head_dim=self.mamba_head_dim, expand=self.expand,
            n_groups=self.n_groups, conv_width=self.conv_width,
            chunk=self.chunk, remat=self.remat, norm_eps=self.norm_eps,
            dt_min=self.dt_min)

    @property
    def attn(self) -> L.ScaledAttnConfig:
        return L.ScaledAttnConfig(2 * self.d_model, self.n_heads, self.n_kv,
                                  self.head_dim, rope_theta=self.rope_theta,
                                  scale=(self.head_dim / 2) ** -0.5)

    @property
    def n_calls(self) -> int:
        return len(self.hybrid_layer_ids)

    @property
    def layers_block_type(self):
        """The published per-layer list: ``"hybrid"`` where a layer calls
        a shared block, else ``"mamba"``."""
        return ["hybrid" if i in self.hybrid_layer_ids else "mamba"
                for i in range(self.n_layers)]

    @property
    def n_apps(self) -> int:
        """Calls of a shared block a forward (one KV cache each)."""
        return self.n_calls

    def param_count(self) -> int:
        """Every leaf of :func:`init`'s tree."""
        D, D2, F, r = self.d_model, 2 * self.d_model, self.d_ff, \
            self.adapter_rank
        m = self.mamba
        DI, GN, MH = m.d_inner, m.n_groups * m.d_state, m.n_heads
        layer = (D + D * (2 * DI + 2 * GN + MH) + (m.conv_width + 1) *
                 (DI + 2 * GN) + 3 * MH + DI + DI * D)
        H, K, dh = self.n_heads, self.n_kv, self.head_dim
        block = (D2 * H * dh + 2 * D2 * K * dh + H * dh * D + D2 + D +
                 D * 2 * F + F * D)
        call = D * r + r * 2 * F + D * D
        return (self.n_layers * layer + self.vocab * D + D +
                self.num_mem_blocks * block + self.n_calls * call)

    def active_param_count(self) -> int:
        return self.param_count()


def _zamba2_init(gen: torch.Generator, cfg: Zamba2Config, dev):
    """The mamba tree plus ``"blocks"`` (``ln1``, ``attn``, ``ln2``,
    ``ffn`` {``gate_up``, ``down``}, stacked on ``num_mem_blocks``) and
    ``"calls"`` (``lora_a``, ``lora_b``, ``linear``, stacked on the
    calls)."""
    D, F, r, nb, nc = (cfg.d_model, cfg.d_ff, cfg.adapter_rank,
                       cfg.num_mem_blocks, cfg.n_calls)
    a = cfg.attn
    p = M.init(gen, cfg.mamba, device=dev)
    p["blocks"] = {
        "ln1": L.rmsnorm_init(2 * D, device=dev, lead=(nb,)),
        "attn": {"wq": L._he(gen, (nb, 2 * D, a.n_heads * a.head_dim),
                             device=dev),
                 "wk": L._he(gen, (nb, 2 * D, a.n_kv * a.head_dim),
                             device=dev),
                 "wv": L._he(gen, (nb, 2 * D, a.n_kv * a.head_dim),
                             device=dev),
                 "wo": L._he(gen, (nb, a.n_heads * a.head_dim, D),
                             device=dev)},
        "ln2": L.rmsnorm_init(D, device=dev, lead=(nb,)),
        "ffn": {"gate_up": L._he(gen, (nb, D, 2 * F), device=dev),
                "down": L._he(gen, (nb, F, D), device=dev)},
    }
    p["calls"] = {"lora_a": L._he(gen, (nc, D, r), device=dev),
                  "lora_b": L._he(gen, (nc, r, 2 * F), device=dev),
                  "linear": L._he(gen, (nc, D, D), device=dev)}
    return p


def init(gen: torch.Generator, cfg, device=None):
    """Random parameters on ``device`` (default: ``gen``'s; ``"meta"``
    gives the shapes without storage): the mamba tree plus
    ``"shared"`` (``ln1``, ``ln2``, ``attn``, ``ffn``, unstacked), or for
    a :class:`Zamba2Config` its blocks and calls (:func:`_zamba2_init`)."""
    dev = device or gen.device
    if isinstance(cfg, Zamba2Config):
        return _zamba2_init(gen, cfg, dev)
    p = M.init(gen, cfg.mamba, device=dev)
    p["shared"] = {
        "ln1": L.rmsnorm_init(cfg.d_model, device=dev),
        "ln2": L.rmsnorm_init(cfg.d_model, device=dev),
        "attn": L.attn_init(gen, cfg.attn, device=dev),
        "ffn": L.ffn_init(gen, cfg.d_model, cfg.d_ff, device=dev),
    }
    return p


def _shared_block(sp, cfg: HybridConfig, x, positions, kv_cache=None,
                  cache_index=None, constrain=lambda t, *a: t):
    h, new_cache = L.attn_apply(sp["attn"], cfg.attn,
                                L.rmsnorm(sp["ln1"], x), positions,
                                kv_cache=kv_cache, cache_index=cache_index,
                                constrain=constrain)
    x = x + h
    x = x + L.ffn_apply(sp["ffn"], L.rmsnorm(sp["ln2"], x), constrain)
    return x, new_cache


def _zamba2_block(params, cfg: Zamba2Config, c: int, h, emb, positions,
                  kv_cache, cache_index):
    """Call ``c`` of a shared block on the stream ``h``: the block's
    output carried by ``linear[c]``, what its layer adds to its Mamba2
    input, and the KV cache."""
    b = c % cfg.num_mem_blocks
    bp = L.layer_params(params["blocks"], b)
    cp = L.layer_params(params["calls"], c)
    with TRACER.span("hybrid.shared-block", call=c, block=b):
        x = L.rmsnorm(bp["ln1"], torch.cat([h, emb], -1), cfg.norm_eps)
        a, new_cache = L.attn_apply(bp["attn"], cfg.attn, x, positions,
                                    kv_cache=kv_cache,
                                    cache_index=cache_index)
        x = L.rmsnorm(bp["ln2"], a, cfg.norm_eps)
        x = L.gelu_ffn_lora_apply(bp["ffn"], x, cp["lora_a"], cp["lora_b"])
        return x @ cp["linear"], new_cache


def _zamba2_forward(params, cfg: Zamba2Config, tokens, states, kv_caches,
                    cache_index, constrain):
    """:func:`forward` of the published block: layer by layer, a hybrid
    layer first calling its shared block."""
    mcfg = cfg.mamba
    emb = constrain(L.embed_apply(params["embed"], tokens), "act_resid")
    B, S, _ = emb.shape
    start = 0 if cache_index is None else int(cache_index)
    positions = (start + torch.arange(S, dtype=torch.int32,
                                      device=emb.device))[None, :].expand(B, S)
    calls = {lid: c for c, lid in enumerate(cfg.hybrid_layer_ids)}
    x = emb
    for i in range(cfg.n_layers):
        inject = None
        if i in calls:
            c = calls[i]
            cache = None if kv_caches is None else \
                (kv_caches[0][c], kv_caches[1][c])
            inject, _ = _zamba2_block(params, cfg, c, x, emb, positions,
                                      cache, cache_index)
        x = M.run_layers(params["layers"], mcfg, x, i, i + 1, states,
                         constrain, inject=inject)
    TRACER.counter("hybrid.forward", shared_block_calls=cfg.n_calls,
                   ssd_chunks=cfg.n_layers * -(-S // cfg.chunk))
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed_apply(params["embed"], x)


def forward(params, cfg, tokens, *, states=None,
            kv_caches=None, cache_index=None, constrain=lambda t, *a: t):
    """Grouped: [shared attention, ``attn_every`` mamba blocks] x n_apps
    (a :class:`Zamba2Config`: the published block, layer by layer).

    tokens (B, S) -> logits (B, S, V) fp32.  ``states``: the stacked
    mamba decode state or None; ``kv_caches``: (k, v) each (n_apps, B, T,
    K, dh) or None.  Both are written in place and returned after the
    logits, each when given."""
    if isinstance(cfg, Zamba2Config):
        logits = _zamba2_forward(params, cfg, tokens, states, kv_caches,
                                 cache_index, constrain)
        outs = [logits] + [x for x in (states, kv_caches) if x is not None]
        return outs[0] if len(outs) == 1 else tuple(outs)
    mcfg = cfg.mamba
    x = constrain(L.embed_apply(params["embed"], tokens), "act_resid")
    B, S, _ = x.shape
    start = 0 if cache_index is None else int(cache_index)
    positions = (start + torch.arange(S, dtype=torch.int32,
                                      device=x.device))[None, :].expand(B, S)
    for app in range(cfg.n_apps):
        lo = app * cfg.attn_every
        hi = min(cfg.n_layers, lo + cfg.attn_every)
        cache = None if kv_caches is None else \
            (kv_caches[0][app], kv_caches[1][app])
        x, _ = _shared_block(params["shared"], cfg, x, positions,
                             kv_cache=cache, cache_index=cache_index,
                             constrain=constrain)
        x = M.run_layers(params["layers"], mcfg, x, lo, hi, states,
                         constrain)
    x = L.rmsnorm(params["final_norm"], x)
    logits = L.unembed_apply(params["embed"], x)
    outs = [logits]
    if states is not None:
        outs.append(states)
    if kv_caches is not None:
        outs.append(kv_caches)
    return outs[0] if len(outs) == 1 else tuple(outs)


def init_decode_state(cfg, batch: int, max_seq: int, device=None):
    """(mamba decode state, (k, v)): the KV caches each (n_apps, batch,
    max_seq, n_kv, dh) bf16, zeroed (a :class:`Zamba2Config`: one a
    call)."""
    mstate = M.init_decode_state(cfg.mamba, batch, device=device)
    dh = cfg.head_dim if isinstance(cfg, Zamba2Config) else \
        cfg.d_model // cfg.n_heads
    kd = (cfg.n_apps, batch, max_seq, cfg.n_kv, dh)
    kv = (torch.zeros(kd, dtype=L.COMPUTE_DTYPE, device=device),
          torch.zeros(kd, dtype=L.COMPUTE_DTYPE, device=device))
    return mstate, kv
