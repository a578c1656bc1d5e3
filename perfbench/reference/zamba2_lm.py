"""Plain reference of Zamba2's first training steps, in fp32.

It follows the published model of hf:Zyphra/Zamba2-7B-Instruct
(``transformers``' ``Zamba2ForCausalLM``, its eager path), with the sizes
of a configuration file (``perfbench/configs/<config>.json``, its
published keys, ``num_hidden_layers`` and ``hybrid_layer_ids`` as cut):

* every layer is a Mamba2 layer, ``h + mamba(rmsnorm(h + t))``, where t is
  0 but in a hybrid layer: there t = linear_c(block_b(h, emb)) for call c
  (the layer's index in ``hybrid_layer_ids``), b = c mod
  ``num_mem_blocks``; the block has no residual of its own;
* a shared block: x = RMSNorm(concat(h, emb)) (2 hidden_size wide), then
  MHA of ``num_attention_heads`` heads of ``attention_head_dim`` with RoPE
  over the whole head (``rotate_half``, ``rope_theta``), causal, scaled by
  (attention_head_dim / 2) ** -0.5, o_proj to hidden_size; RMSNorm; the
  MLP down(gelu(gate) * up) with [gate, up] = gate_up(x) +
  lora_b_c(lora_a_c(x)), GELU exact;
* the Mamba2 mixer: in_proj to [z, xBC, dt]; a depthwise causal conv of
  ``mamba_d_conv`` with its bias, SiLU; dt = max(softplus(dt + dt_bias),
  ``time_step_min``); A = -exp(A_log); the SSD scan over chunks of
  ``chunk_size`` (written here from the published equations: per chunk
  the masked decay matrix L = exp(segsum(A dt)), y_diag = (C B^T o L)
  (x dt), each chunk's end state, the states carried across chunks by
  exp(segsum) of the chunks' total decays, y_off = C (decay o state));
  B and C of ``mamba_ngroups`` groups, head h reading group h // (H / G);
  y + D x; the gated norm rmsnorm(y * silu(z)) over each group of
  d_inner / G (eps 1e-5); out_proj;
* a final RMSNorm and the tied unembedding; RMSNorms x * rsqrt(mean(x^2)
  + eps) * gain with ``rms_norm_eps``;
* the loss the configuration states (``"loss"``), and AdamW as it states
  (``"optimizer"``, ``"optimizer_rules"``), the new parameters rounded to
  the dtype each is stored in (bf16, or fp32 for A_log, dt_bias and D).

Weights are read as the benchmark made them, the program's tree: matrices
(in, out) as they multiply from the right; ``"layers"`` stacked on the
layer axis, ``"blocks"`` on the shared blocks, ``"calls"`` on the calls.
Everything runs in fp32 with TF32 off, gradients by autograd on plain
operations, one sequence at a time, each layer, each shared-block call
and each block of loss rows recomputed in the backward pass
(``torch.utils.checkpoint``), attention in blocks of query rows.

``precision="fp8"`` is the control (``dense_lm``'s): every weight
product's inputs through float8 e4m3, the unembedding's through bf16.
``precision="bf16"`` rounds every weight product's inputs through bf16,
the precision the program holds them in, and leaves the unembedding in
fp32: a witness, not a control, whose readings show the size of a gap
that bf16 rounding alone makes.

Imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.dense_lm import (_Rounded, _unembed, leaf_norms,
                                          no_tf32, rmsnorm, rope,
                                          rope_tables)
from perfbench.reference.dense_lm import _product as _dense_product

__all__ = ["entry", "flatten", "leaf_norms", "logits", "loss", "ssd",
           "train_steps"]

#: the subtrees whose leaves are stacked on a leading axis
STACKED = ("layers", "blocks", "calls")


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Leaves by name, keys sorted, as the check compares them:
    ``"embed"``, ``"layers/in_proj/3"`` (layer 3 of a stacked matrix, a
    view), ``"blocks/attn/wq/1"``, ``"calls/linear/0"``,
    ``"final_norm"``; a stacked leaf of one vector an entry (a layer's
    ``A_log``, ``dt_bias``, ``D_skip``, ``conv_b``, ``ln``, ``gate_norm``,
    a block's ``ln1``, ``ln2``) is one leaf over the stack,
    ``"layers/D_skip"``: alone, one layer's vector has a gradient that
    nearly cancels (112 values behind a group norm), and the program's
    bf16 and the fp8 control's worst leaves alike were such vectors, at
    rounding's scale (``PERF.md``, §2)."""
    out: Dict[str, torch.Tensor] = {}
    for k in sorted(tree):
        name = f"{prefix}{k}"
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten(v, name + "/"))
        elif name.split("/")[0] in STACKED and v.ndim > 2:
            out.update({f"{name}/{i}": v[i] for i in range(v.shape[0])})
        else:
            out[name] = v
    return out


def entry(P: Dict[str, torch.Tensor], name: str, i: int):
    """Entry ``i`` of the stacked leaf ``name`` of :func:`flatten`'s
    leaves (``"layers/in_proj"``, layer 3: ``P["layers/in_proj/3"]``; a
    vector: ``P["layers/D_skip"][3]``)."""
    key = f"{name}/{i}"
    return P[key] if key in P else P[name][i]


def _product(x, w, precision: str):
    """A weight product, ``x @ w``: fp32, the control's (``"fp8"``), or
    its inputs rounded through bf16 (``"bf16"``)."""
    if precision == "bf16":
        return _Rounded.apply(x, "bf16") @ _Rounded.apply(w, "bf16")
    return _dense_product(x, w, precision)


# ------------------------------------------------------------------ SSD
def segsum(a):
    """(..., T) -> (..., T, T): out[i, j] = a[j+1] + ... + a[i] for j <= i
    (0 on the diagonal), -inf above it."""
    T = a.shape[-1]
    x = a[..., None].expand(*a.shape, T)
    x = x.masked_fill(~torch.ones(T, T, dtype=torch.bool,
                                  device=a.device).tril(-1), 0)
    x = torch.cumsum(x, dim=-2)
    return x.masked_fill(~torch.ones(T, T, dtype=torch.bool,
                                     device=a.device).tril(), -math.inf)


def ssd(x, dt, A, B, C, chunk: int):
    """The SSD scan from a zero state.  x (b, S, H, P), dt (b, S, H), A
    (H,) negative, B and C (b, S, H, N) (already repeated over the heads
    of a group); S a multiple of ``chunk`` or under it.  Returns y (b, S,
    H, P): y_t = C_t . h_t, h_t = exp(A dt_t) h_{t-1} + dt_t B_t x_t^T."""
    b, S, H, P = x.shape
    Q = min(chunk, S)
    c = S // Q
    xs = (x * dt[..., None]).reshape(b, c, Q, H, P)
    a = (A * dt).reshape(b, c, Q, H).permute(0, 3, 1, 2)      # (b,H,c,Q)
    Bc, Cc = B.reshape(b, c, Q, H, -1), C.reshape(b, c, Q, H, -1)
    a_cum = torch.cumsum(a, -1)
    L = torch.exp(segsum(a))                                   # (b,H,c,Q,Q)
    y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", Cc, Bc, L, xs)
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)          # (b,H,c,Q)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bc, decay_states, xs)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], 1)
    decay_chunk = torch.exp(segsum(F.pad(a_cum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)[:, :-1]
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Cc, states,
                         torch.exp(a_cum))
    return (y_diag + y_off).reshape(b, S, H, P)


# ----------------------------------------------------------------- model
def _dims(cfg: dict):
    D = cfg["hidden_size"]
    DI = cfg["mamba_expand"] * D
    G, N = cfg["mamba_ngroups"], cfg["mamba_d_state"]
    H = cfg["n_mamba_heads"]
    return D, DI, G, N, H, DI // H


def mamba_layer(x, inject, P, i: int, cfg: dict, precision: str):
    """Layer ``i``: x + mixer(rmsnorm(x + inject))."""
    D, DI, G, N, H, Pd = _dims(cfg)
    b, S, _ = x.shape

    def w(name):
        return entry(P, f"layers/{name}", i)

    h = x if inject is None else x + inject
    h = rmsnorm(h, w("ln"), cfg["rms_norm_eps"])
    zxbcdt = _product(h, w("in_proj"), precision)
    z, xbc, dt = torch.split(zxbcdt, [DI, DI + 2 * G * N, H], dim=-1)
    K = cfg["mamba_d_conv"]
    conv = F.conv1d(xbc.transpose(1, 2), w("conv_w").t()[:, None, :],
                    bias=w("conv_b"), padding=K - 1,
                    groups=xbc.shape[-1])[..., :S]
    xbc = F.silu(conv.transpose(1, 2))
    xs, Bm, Cm = torch.split(xbc, [DI, G * N, G * N], dim=-1)
    dt = torch.clamp(F.softplus(dt + w("dt_bias")), min=cfg["time_step_min"])
    A = -torch.exp(w("A_log"))
    xh = xs.reshape(b, S, H, Pd)
    Bm = Bm.reshape(b, S, G, N).repeat_interleave(H // G, dim=2)
    Cm = Cm.reshape(b, S, G, N).repeat_interleave(H // G, dim=2)
    y = ssd(xh, dt, A, Bm, Cm, cfg["chunk_size"])
    y = (y + xh * w("D_skip")[:, None]).reshape(b, S, DI)
    yz = (y * F.silu(z)).reshape(b, S, G, DI // G)
    yz = yz * torch.rsqrt(yz.square().mean(-1, keepdim=True) + 1e-5)
    y = yz.reshape(b, S, DI) * w("gate_norm")
    return x + _product(y, w("out_proj"), precision)


def attention(q, k, v, scale: float, block: int):
    """Causal MHA, q, k, v (b, S, H, dh), in blocks of query rows."""
    S = q.shape[1]
    outs = []
    for a in range(0, S, block):
        e = min(S, a + block)
        s = torch.einsum("bqhd,bthd->bhqt", q[:, a:e], k[:, :e]) * scale
        rows = torch.arange(a, e, device=q.device)[:, None]
        keep = rows >= torch.arange(e, device=q.device)[None, :]
        p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
        outs.append(torch.einsum("bhqt,bthd->bqhd", p, v[:, :e]))
    return torch.cat(outs, 1)


def shared_block(h, emb, P, c: int, cfg: dict, cos, sin, precision: str,
                 block: int):
    """Call ``c``: linear_c(block_b(h, emb)), b = c mod num_mem_blocks."""
    b = c % cfg["num_mem_blocks"]
    B_, S, D = h.shape
    H, dh = cfg["num_attention_heads"], cfg["attention_head_dim"]
    K = cfg["num_key_value_heads"]
    eps = cfg["rms_norm_eps"]

    def w(name):
        return entry(P, f"blocks/{name}", b)

    x = rmsnorm(torch.cat([h, emb], -1), w("ln1"), eps)
    q = _product(x, w("attn/wq"), precision).reshape(B_, S, H, dh)
    k = _product(x, w("attn/wk"), precision).reshape(B_, S, K, dh)
    v = _product(x, w("attn/wv"), precision).reshape(B_, S, K, dh)
    q, k = rope(q, cos, sin), rope(k, cos, sin)
    k, v = (t.repeat_interleave(H // K, dim=2) for t in (k, v))
    o = attention(q, k, v, (dh / 2) ** -0.5, block).reshape(B_, S, H * dh)
    x = rmsnorm(_product(o, w("attn/wo"), precision), w("ln2"), eps)
    gu = _product(x, w("ffn/gate_up"), precision) + _product(
        _product(x, entry(P, "calls/lora_a", c), precision),
        entry(P, "calls/lora_b", c), precision)
    gate, up = gu.chunk(2, dim=-1)
    x = _product(F.gelu(gate) * up, w("ffn/down"), precision)
    return _product(x, entry(P, "calls/linear", c), precision)


def hidden(P, tokens, cfg: dict, *, precision: str = "fp32",
           block: int = 512, remat: bool = True):
    """The final normed hidden state (b, S, D) of ``tokens`` (b, S)."""
    emb = P["embed"][tokens.long()]
    S = tokens.shape[1]
    cos, sin = rope_tables(S, cfg["attention_head_dim"],
                           float(cfg["rope_theta"]), emb.device)
    calls = {lid: c for c, lid in enumerate(cfg["hybrid_layer_ids"])}

    def run(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False) if remat \
            else fn(*args)

    x = emb
    for i in range(cfg["num_hidden_layers"]):
        inject = None
        if i in calls:
            inject = run(shared_block, x, emb, P, calls[i], cfg, cos, sin,
                         precision, block)
        x = run(mamba_layer, x, inject, P, i, cfg, precision)
    return rmsnorm(x, P["final_norm"], cfg["rms_norm_eps"])


def logits(P, tokens, cfg: dict):
    """Logits (b, S, V) in fp32, nothing recomputed (the CPU tests)."""
    return hidden(P, tokens, cfg, remat=False) @ P["embed"].t()


def _xent_rows(x, table, labels, z_loss: float, precision: str):
    """Summed loss of a block of rows: lse - gold + z_loss * lse^2."""
    lg = _unembed(x, table, precision)
    lse = torch.logsumexp(lg, -1)
    gold = lg.gather(-1, labels[:, None].long())[:, 0]
    return (lse - gold + z_loss * lse.square()).sum()


def loss(P, tokens, labels, cfg: dict, *, precision: str = "fp32",
         block: int = 512, rows: int = 2048):
    """Summed loss of ``tokens`` (b, S), nothing divided."""
    x = hidden(P, tokens, cfg, precision=precision, block=block)
    x = x.reshape(-1, x.shape[-1])
    flat = labels.reshape(-1)
    z = cfg["loss"]["z_loss"]
    return sum(checkpoint(_xent_rows, x[r:r + rows], P["embed"],
                          flat[r:r + rows], z, precision,
                          use_reentrant=False)
               for r in range(0, x.shape[0], rows))


# ------------------------------------------------------------- optimizer
def _decayed(name: str, p) -> bool:
    """Weight decay on leaves of two or more dimensions as the tree
    stacks them: every stacked leaf, and the others of two or more."""
    return name.split("/")[0] in STACKED or p.ndim >= 2


def _against(grads, scale, against: Dict) -> dict:
    """``train_steps``' readings of its first gradient (``grads`` times
    ``scale``) against another side's, a leaf at a time."""
    diff, rows = {}, {}
    for n, g in grads.items():
        own = g * scale
        other = against[n].to(own.device, torch.float32)
        diff[n] = float((own - other).norm())
        if n.split("/")[0] in STACKED and not n.split("/")[-1].isdigit():
            rows[n] = {"own": own.norm(dim=-1).tolist(),
                       "against": other.norm(dim=-1).tolist(),
                       "diff": (own - other).norm(dim=-1).tolist()}
        del own, other
    return {"grad1_diff": diff, "grad1_rows": rows}


def train_steps(params, batches: List[Tuple[torch.Tensor, torch.Tensor]],
                cfg: dict, *, precision: str = "fp32",
                half_batch: bool = False, block: int = 512,
                rows: int = 2048, against: Optional[Dict] = None,
                keep: bool = False) -> dict:
    """The configuration's first training steps from ``params`` (the
    program's tree as the benchmark made it), one a batch of (tokens,
    labels), one sequence at a time.  Returns each step's ``losses``, the
    first step's global gradient norm before clipping (``grad_norm``),
    the norms by leaf of the first gradient as the update applies it,
    clipped (``grad1``), and of the change of the stored parameters over
    the steps (``change``).  ``half_batch``: the fault that leaves out the
    second half of each batch, the mean taken over the rest.

    ``against``: another side's first gradient by :func:`flatten`'s
    leaves (any device); then ``grad1_diff`` holds the norm of the
    difference by leaf, and ``grad1_rows``, for each stacked leaf of one
    vector an entry (a layer's ``D_skip``), the norms of each entry's
    gradient (``"own"``, ``"against"``) and of their difference
    (``"diff"``).  ``keep``: ``grad1_full`` holds this first gradient by
    leaf in fp32 on the host."""
    o = cfg["optimizer"]
    b1, b2 = torch.tensor(o["b1"]), torch.tensor(o["b2"])
    with no_tf32():
        start = flatten(params)
        P = {n: t.detach().float().clone().requires_grad_(True)
             for n, t in start.items()}
        m = {n: torch.zeros_like(t) for n, t in P.items()}
        v = {n: torch.zeros_like(t) for n, t in P.items()}
        out: dict = {"losses": []}
        for t, (tokens, labels) in enumerate(batches, 1):
            if half_batch:
                tokens, labels = (x[:x.shape[0] // 2]
                                  for x in (tokens, labels))
            n_tok = tokens.numel()
            total = 0.0
            for r in range(tokens.shape[0]):
                value = loss(P, tokens[r:r + 1], labels[r:r + 1], cfg,
                             precision=precision, block=block,
                             rows=rows) / n_tok
                value.backward()
                total += float(value.detach())
                del value
            out["losses"].append(total)
            with torch.no_grad():
                grads = {n: p.grad for n, p in P.items()}
                gn = torch.sqrt(sum(g.square().sum() for g in grads.values()))
                scale = torch.clamp(o["clip_norm"] / (gn + 1e-9), max=1.0)
                step = torch.tensor(float(t), device=gn.device)
                lr = o["lr"] * torch.clamp((step + 1) / max(o["warmup"], 1),
                                           max=1.0)
                bc1 = 1 - torch.pow(b1.to(gn.device), step)
                bc2 = 1 - torch.pow(b2.to(gn.device), step)
                if t == 1:
                    out["grad_norm"] = float(gn)
                    out["grad1"] = leaf_norms({n: g * scale
                                               for n, g in grads.items()})
                    if against is not None:
                        out.update(_against(grads, scale, against))
                    if keep:
                        out["grad1_full"] = {n: (g * scale).cpu()
                                             for n, g in grads.items()}
                for n, p in P.items():
                    g = grads[n] * scale
                    m[n] = o["b1"] * m[n] + (1 - o["b1"]) * g
                    v[n] = o["b2"] * v[n] + (1 - o["b2"]) * g.square()
                    u = (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + o["eps"])
                    if _decayed(n, p):
                        u = u + o["weight_decay"] * p
                    p.copy_((p - lr * u).to(start[n].dtype).float())
                    p.grad = None
                del grads, g
        out["change"] = leaf_norms({n: P[n].detach() - start[n].float()
                                    for n in P})
    return out
