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
"""
from __future__ import annotations

import dataclasses

import torch

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


def init(gen: torch.Generator, cfg: HybridConfig, device=None):
    """Random parameters on ``device`` (default: ``gen``'s; ``"meta"``
    gives the shapes without storage): the mamba tree plus
    ``"shared"`` (``ln1``, ``ln2``, ``attn``, ``ffn``, unstacked)."""
    dev = device or gen.device
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


def forward(params, cfg: HybridConfig, tokens, *, states=None,
            kv_caches=None, cache_index=None, constrain=lambda t, *a: t):
    """Grouped: [shared attention, ``attn_every`` mamba blocks] x n_apps.

    tokens (B, S) -> logits (B, S, V) fp32.  ``states``: the stacked
    mamba decode state or None; ``kv_caches``: (k, v) each (n_apps, B, T,
    K, dh) or None.  Both are written in place and returned after the
    logits, each when given."""
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


def init_decode_state(cfg: HybridConfig, batch: int, max_seq: int,
                      device=None):
    """(mamba decode state, (k, v)): the KV caches each (n_apps, batch,
    max_seq, n_kv, dh) bf16, zeroed."""
    mstate = M.init_decode_state(cfg.mamba, batch, device=device)
    dh = cfg.d_model // cfg.n_heads
    kd = (cfg.n_apps, batch, max_seq, cfg.n_kv, dh)
    kv = (torch.zeros(kd, dtype=L.COMPUTE_DTYPE, device=device),
          torch.zeros(kd, dtype=L.COMPUTE_DTYPE, device=device))
    return mstate, kv
