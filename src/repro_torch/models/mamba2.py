"""Mamba2: state-space duality (SSD) blocks (port of
``repro.models.mamba2``, arXiv:2405.21060).

The SSD layer computes, per head, ``y_t = C_t^T h_t`` with
``h_t = a_t h_{t-1} + b_t x_t^T`` (a scalar decay ``a_t`` per head).  The
chunked algorithm splits the sequence into Q-length chunks: a quadratic
term inside each chunk (attention-like) plus a state carried from chunk
to chunk (O(S) in all).  Decode carries a constant-size state (heads,
head_dim, d_state).

The JAX package computes all of it in plain ``jnp`` (einsums and a
``lax.scan``), with no Pallas kernel, and so does the port: ``torch``
einsums, and a Python loop over the chunks where JAX scans.  Layer
weights are stacked on a leading ``L`` axis as in the JAX package;
:func:`forward` loops over the layers, each under the remat policy
(``layers.remat``) when training.  Where the port departs from the JAX
arithmetic, a comment says why:

* cumulative sums are products with a triangle of ones in fp32
  (:func:`_cumsum`): ``torch.cumsum`` on a CUDA float tensor raises under
  ``torch.use_deterministic_algorithms``, which the train step runs under;
* B and C are repeated over the heads of their group by an ``expand``
  that gives head h the group h // rep, the order of ``jnp.repeat``.

Four settings of :class:`Mamba2Config` are class defaults that give the
JAX package's block (so its configurations' fields stay the JAX
package's); :class:`PublishedMamba2Config` makes them fields, set to
Zamba2's published block (``transformers``' ``Zamba2MambaMixer``):
``norm_before_gate`` False normalises after the gate, ``rmsnorm(y *
silu(z))`` over each of ``n_groups`` groups of d_inner; ``conv_bias`` adds
a bias to the depthwise conv; ``norm_eps`` is the eps of both norms;
``dt_min`` clamps dt from below after its softplus.

The chunked scan is the span ``mamba2.ssd`` of ``obs.trace.TRACER``, with
its chunks as an attribute.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..launch.mesh import local_call, pin_grad
from ..obs.trace import TRACER
from . import layers as L
from .layers import _he, layer_params


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    name: str
    n_layers: int
    d_model: int
    vocab: int
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256
    remat: str = "dots"
    #: True: ``rmsnorm(y) * silu(z)`` over all of d_inner (the JAX
    #: package's); False: ``rmsnorm(y * silu(z))`` over each group of
    #: ``d_inner / n_groups`` (Mamba2's and Zamba2's published block)
    norm_before_gate: ClassVar[bool] = True
    #: a bias on the depthwise conv, added before its SiLU
    conv_bias: ClassVar[bool] = False
    #: eps of the block's input norm and of its gated norm
    norm_eps: ClassVar[float] = 1e-6
    #: dt clamped from below after its softplus (0: no clamp)
    dt_min: ClassVar[float] = 0.0

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    def param_count(self) -> int:
        D, DI = self.d_model, self.d_inner
        G, N, H = self.n_groups, self.d_state, self.n_heads
        in_proj = D * (2 * DI + 2 * G * N + H)
        conv = (self.conv_width + self.conv_bias) * (DI + 2 * G * N)
        per_layer = in_proj + conv + H * 2 + DI + DI * D + 2 * D
        return self.n_layers * per_layer + self.vocab * D + D

    def active_param_count(self) -> int:
        return self.param_count()


@dataclasses.dataclass(frozen=True)
class PublishedMamba2Config(Mamba2Config):
    """:class:`Mamba2Config` with the published block's settings as
    fields (Zamba2's defaults)."""
    norm_before_gate: bool = False
    conv_bias: bool = True
    norm_eps: float = 1e-5
    dt_min: float = 0.001


def _block_weights(gen: torch.Generator, cfg: Mamba2Config, lead, dev):
    D, DI, G, N, H = (cfg.d_model, cfg.d_inner, cfg.n_groups, cfg.d_state,
                      cfg.n_heads)
    f32 = dict(dtype=torch.float32, device=dev)
    out = {
        "ln": L.rmsnorm_init(D, device=dev, lead=lead),
        "in_proj": _he(gen, (*lead, D, 2 * DI + 2 * G * N + H), device=dev),
        "conv_w": _he(gen, (*lead, cfg.conv_width, DI + 2 * G * N),
                      device=dev),
        "A_log": torch.zeros((*lead, H), **f32),
        "dt_bias": torch.zeros((*lead, H), **f32),
        "D_skip": torch.ones((*lead, H), **f32),
        "gate_norm": L.rmsnorm_init(DI, device=dev, lead=lead),
        "out_proj": _he(gen, (*lead, DI, D), device=dev),
    }
    if cfg.conv_bias:
        out["conv_b"] = torch.zeros((*lead, DI + 2 * G * N),
                                    dtype=L.PARAM_DTYPE, device=dev)
    return out


def init_layer(gen: torch.Generator, cfg: Mamba2Config, device=None):
    """One block's weights (the JAX package's ``init_layer``),
    unstacked."""
    return _block_weights(gen, cfg, (), device or gen.device)


def init(gen: torch.Generator, cfg: Mamba2Config, device=None):
    """Random parameters on ``device`` (default: ``gen``'s; ``"meta"``
    gives the shapes without storage), the JAX package's tree: every
    block's weights stacked on a leading ``L`` axis, ``A_log``,
    ``dt_bias`` and ``D_skip`` fp32, the rest bf16."""
    dev = device or gen.device
    return {
        "embed": L.embed_init(gen, cfg.vocab, cfg.d_model, device=dev),
        "layers": _block_weights(gen, cfg, (cfg.n_layers,), dev),
        "final_norm": L.rmsnorm_init(cfg.d_model, device=dev),
    }


def _cumsum(x, dim: int):
    """``cumsum`` along ``dim`` as a product with a triangle of ones, in
    fp32: ``torch.cumsum`` of a CUDA float tensor raises under
    ``torch.use_deterministic_algorithms`` (a product does not)."""
    n = x.shape[dim]
    tri = torch.ones((n, n), dtype=torch.float32, device=x.device).triu()
    return (x.movedim(dim, -1).float() @ tri).movedim(-1, dim)


def _segsum(log_a):
    """(..., Q) -> (..., Q, Q) lower-triangular cumulative log-decay,
    ``-inf`` above the diagonal (selected before the ``exp`` that follows,
    so no ``inf * 0`` reaches a gradient)."""
    Q = log_a.shape[-1]
    cs = _cumsum(log_a, -1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=log_a.device).tril()
    return torch.where(mask, diff, float("-inf"))


def _repeat_groups(x, rep: int):
    """(..., G, N) -> (..., G * rep, N), head h reading group h // rep:
    ``jnp.repeat(x, rep, axis=-2)``."""
    *lead, G, N = x.shape
    return x[..., None, :].expand(*lead, G, rep, N).reshape(*lead, G * rep, N)


def ssd_chunked(x, dt, A, B, C, cfg: Mamba2Config, h0=None):
    """SSD scan (:func:`ssd_local`); on DTensors it runs on each rank's
    shards (``launch.mesh.local_call``), exact per sequence and per head:
    x, dt, A and h0 keep their batch and head shardings, B and C their
    batch's (the groups they hold serve every head), the sequence is
    gathered (the chunk recurrence runs along it)."""
    if not isinstance(x, DTensor):
        return ssd_local(x, dt, A, B, C, cfg, h0)

    def pl(batch_dim, head_dim):
        """x's batch and head shardings at these dims of another tensor
        (None: it has no such dim), the rest replicated."""
        return tuple(
            Shard(batch_dim) if isinstance(p, Shard) and p.dim == 0 and
            batch_dim is not None else
            Shard(head_dim) if isinstance(p, Shard) and p.dim == 2 and
            head_dim is not None else Replicate() for p in x.placements)

    args = (x, dt, A, B, C) + (() if h0 is None else (h0,))
    ins = (pl(0, 2), pl(0, 2), pl(None, 0), pl(0, None), pl(0, None),
           pl(0, 1))

    def run(x, dt, A, B, C, h0=None):
        return ssd_local(x, dt, A, B, C, cfg, h0)

    return local_call(run, args, ins[:len(args)], (pl(0, 2), pl(0, 1)),
                      x.device_mesh)


def ssd_local(x, dt, A, B, C, cfg: Mamba2Config, h0=None):
    """SSD scan.  x: (Bt, S, H, P)  dt: (Bt, S, H)  B/C: (Bt, S, G, N).

    Returns (y, h_final) with y: (Bt, S, H, P) in x's dtype, h: (Bt, H, P,
    N) fp32.  S must be at most ``cfg.chunk`` or a multiple of it: the
    JAX function reshapes S into whole chunks and fails otherwise, and the
    port raises rather than pad."""
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    Q = min(cfg.chunk, S)
    if S % Q:
        raise ValueError(f"ssd_chunked: a sequence of {S} is longer than the "
                         f"chunk {cfg.chunk} and not a multiple of it")
    nc = S // Q
    rep = H // G
    xc = x.reshape(Bt, nc, Q, H, P)
    dtc = dt.reshape(Bt, nc, Q, H)
    Bc = _repeat_groups(B.reshape(Bt, nc, Q, G, N), rep)
    Cc = _repeat_groups(C.reshape(Bt, nc, Q, G, N), rep)
    log_a = -torch.exp(A) * dtc                          # (Bt,nc,Q,H) <= 0
    xdt = xc * dtc[..., None]                            # bf16 x fp32: fp32

    # intra-chunk (quadratic, attention-like)
    LSS = _segsum(log_a.permute(0, 1, 3, 2))             # (Bt,nc,H,Q,Q)
    CB = torch.einsum("bcqhn,bckhn->bchqk", Cc.float(), Bc.float())
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", CB * torch.exp(LSS),
                           xdt.float())

    # chunk-final states: sum_k exp(sum_{j>k} log_a) * B_k x_k
    csum = _cumsum(log_a, 2)
    tail = csum[:, :, -1:, :] - csum                     # (Bt,nc,Q,H)
    states = torch.einsum("bcqhn,bcqhp->bchpn",
                          (Bc * torch.exp(tail)[..., None]).float(),
                          xdt.float())                   # (Bt,nc,H,P,N)

    # inter-chunk recurrence: the JAX package's lax.scan, chunk by chunk
    chunk_decay = torch.exp(csum[:, :, -1, :])           # (Bt,nc,H)
    h = torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, 1)                    # (Bt,nc,H,P,N)

    # inter-chunk output: C_t . (decay-to-t . h_prev)
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp",
                           (Cc * torch.exp(csum)[..., None]).float(),
                           h_prevs)
    y = (y_intra + y_inter).reshape(Bt, S, H, P)
    return y.to(x.dtype), h


def _causal_conv(x, w, state=None, bias=None):
    """Depthwise causal conv.  x: (B, S, C), w: (K, C), bias: None or
    (C,).

    Returns (y, new_state) where state is the trailing K-1 inputs.  The K
    products are summed left to right in x's dtype, each sum rounded, as
    the JAX package's Python ``sum`` does; the bias is added last, before
    the SiLU."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], 1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i][None, None] for i in range(K))
    if bias is not None:
        y = y + bias
    return F.silu(y), xp[:, -(K - 1):]


def softplus(x):
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)`` (``F.softplus``
    returns x itself above 20, within an fp32 ulp of this)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def block_apply(lp, cfg: Mamba2Config, x, *, state=None,
                constrain=lambda t, *a: t):
    """One Mamba2 block.  state: None (train) or dict(conv, ssm) of this
    layer.  Returns (out, new_state); ``constrain`` at the JAX sites,
    ``act_ffn`` on ``xs`` and ``act_resid`` on the output."""
    Bt, S, D = x.shape
    DI, G, N, H, P = (cfg.d_inner, cfg.n_groups, cfg.d_state, cfg.n_heads,
                      cfg.head_dim)
    xn = L.rmsnorm(lp["ln"], x, cfg.norm_eps)
    # on a mesh whole along the split that follows, its gradient placed so
    # too, for in_proj's gradient product
    zxbcdt = pin_grad(xn @ lp["in_proj"], whole_last=True)
    z, xbc, dt = torch.split(zxbcdt, [DI, DI + 2 * G * N, H], dim=-1)
    conv_state = None if state is None else state["conv"]
    xbc, new_conv = _causal_conv(xbc, lp["conv_w"], conv_state,
                                 lp.get("conv_b"))
    xs, B_, C_ = torch.split(xbc, [DI, G * N, G * N], dim=-1)
    xs = constrain(xs, "act_ffn")
    dt = softplus(dt.float() + lp["dt_bias"])
    if cfg.dt_min:
        dt = dt.clamp(min=cfg.dt_min)
    xh = L.split_last(xs, H, P)
    B_ = L.split_last(B_, G, N)
    C_ = L.split_last(C_, G, N)
    h0 = None if state is None else state["ssm"]
    # the published block keeps the scan's output, its skip and the gated
    # norm in fp32 (the JAX package's rounds the scan's output to bf16)
    xh = xh if cfg.norm_before_gate else xh.float()
    with TRACER.span("mamba2.ssd", chunks=-(-S // cfg.chunk)):
        y, h_final = ssd_chunked(xh, dt, lp["A_log"], B_, C_, cfg, h0=h0)
    y = y + xh * lp["D_skip"][None, None, :, None].to(y.dtype)
    y = L.merge_last(y)
    if cfg.norm_before_gate:
        y = L.rmsnorm(lp["gate_norm"], y, cfg.norm_eps) * F.silu(z)
    else:
        y = gated_group_norm(lp["gate_norm"], y, z, G, cfg.norm_eps)
    out = y @ lp["out_proj"]
    new_state = None if state is None else \
        {"conv": new_conv, "ssm": h_final}
    return constrain(out, "act_resid"), new_state


def gated_group_norm(g, y, z, groups: int, eps: float):
    """``rmsnorm(y * silu(z))`` over each of ``groups`` equal groups of the
    last axis, in fp32, rounded to z's dtype before the gain (Zamba2's
    ``Zamba2RMSNormGated``)."""
    yz = y.float() * F.silu(z.float())
    yg = yz.reshape(*yz.shape[:-1], groups, yz.shape[-1] // groups)
    yg = yg * torch.rsqrt(yg.square().mean(-1, keepdim=True) + eps)
    return yg.reshape(yz.shape).to(z.dtype) * g


def run_layers(layers, cfg: Mamba2Config, x, lo: int, hi: int, states=None,
               constrain=lambda t, *a: t, inject=None):
    """Blocks ``lo`` to ``hi`` of the stacked ``layers`` over the residual
    ``x``.  Training (``states`` None): each block's body under the remat
    policy ``cfg.remat``.  Decode: ``states`` (the stacked dict(conv, ssm)
    of all layers) is read, and written in place with the new states.
    ``inject`` (Zamba2's shared-block output) is added to block ``lo``'s
    input and not to its residual: ``x + block(x + inject)``."""
    def body(x, lp, inject=None):
        h = x if inject is None else x + inject
        return x + block_apply(lp, cfg, h, constrain=constrain)[0]

    if states is None:
        body = L.remat(cfg.remat, body)
    for i in range(lo, hi):
        lp = layer_params(layers, i)
        inj, inject = inject, None
        if states is None:
            x = body(x, lp) if inj is None else body(x, lp, inj)
            continue
        st = layer_params(states, i)
        out, new = block_apply(lp, cfg, x if inj is None else x + inj,
                               state=st, constrain=constrain)
        x = x + out
        st["conv"].copy_(new["conv"])
        st["ssm"].copy_(new["ssm"])
    return x


def forward(params, cfg: Mamba2Config, tokens, *, states=None,
            constrain=lambda t, *a: t):
    """tokens (B, S) -> logits (B, S, V) fp32.  ``states``: None (train)
    or the stacked decode state (:func:`init_decode_state`), written in
    place and returned with the logits."""
    x = constrain(L.embed_apply(params["embed"], tokens), "act_resid")
    x = run_layers(params["layers"], cfg, x, 0, cfg.n_layers, states,
                   constrain)
    x = L.rmsnorm(params["final_norm"], x)
    logits = L.unembed_apply(params["embed"], x)
    return (logits, states) if states is not None else logits


def init_decode_state(cfg: Mamba2Config, batch: int, device=None):
    """Constant-size decode state: the conv tail bf16 (L, B, K-1, DI +
    2GN) and the SSM state fp32 (L, B, H, P, N), zeroed."""
    return {
        "conv": torch.zeros((cfg.n_layers, batch, cfg.conv_width - 1,
                             cfg.d_inner + 2 * cfg.n_groups * cfg.d_state),
                            dtype=L.COMPUTE_DTYPE, device=device),
        "ssm": torch.zeros((cfg.n_layers, batch, cfg.n_heads, cfg.head_dim,
                            cfg.d_state), dtype=torch.float32,
                           device=device),
    }
