"""Plain reference of a dense decoder's first training steps, in fp32.

It follows the published layer of hf:Qwen/Qwen3-0.6B
(``Qwen3DecoderLayer``), with the sizes of a configuration file
(``perfbench/configs/<config>.json``, its published keys):

* x + o_proj(attn(rope(q_norm(q_proj(h))), rope(k_norm(k_proj(h))),
  v_proj(h))) with h = RMSNorm(x), then x + down(silu(gate(h)) * up(h))
  with h = RMSNorm(x); RMSNorm is x * rsqrt(mean(x^2) + eps) * gain, and
  q_norm and k_norm are RMSNorms over each head's ``head_dim``;
* RoPE by halves (``rotate_half``) with inverse frequencies
  ``1 / rope_theta ** (2i / head_dim)``, positions 0..S-1 in each row;
* causal attention, scaled by ``head_dim ** -0.5``, query head h reading
  key-value head h // (H / K), computed in blocks of query rows so that
  no (S, S) score matrix is held;
* a final RMSNorm and the tied unembedding;
* the loss the configuration states (``"loss"``): the token mean of
  lse - gold + z_loss * lse^2 over every position; the published model's
  own loss has no z-loss (the file's ``departures``);
* AdamW as the configuration states it (``"optimizer"`` and
  ``"optimizer_rules"``), the new parameters rounded to bf16, the
  precision they are stored in.

Weights are read as the benchmark made them, a nested dict of bf16
tensors: matrices (in, out) as they multiply from the right, each layer
leaf stacked on a leading ``n_layers`` axis under ``"layers"``.
Everything runs in fp32 with TF32 off, gradients by autograd on plain
operations, each layer and each block of loss rows recomputed in the
backward pass (``torch.utils.checkpoint``) so that the full-width step
fits beside nothing else.

``precision="fp8"`` is the control: every weight product's inputs
rounded through float8 e4m3 with a scale a tensor (its largest magnitude
to 448), the step below the stated bf16, and the unembedding's through
bf16, the step below its stated fp32.

Imports nothing of the program.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

#: the subtrees whose leaves are stacked on a leading layer axis
STACKED = ("layers",)


# ----------------------------------------------------------------- trees
def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Leaves by name, keys sorted: ``"embed"``, ``"layers/attn/wq/3"``
    (layer 3 of a stacked leaf, a view), ``"final_norm"``."""
    out: Dict[str, torch.Tensor] = {}
    for k in sorted(tree):
        name = f"{prefix}{k}"
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten(v, name + "/"))
        elif name.split("/")[0] in STACKED:
            out.update({f"{name}/{i}": v[i] for i in range(v.shape[0])})
        else:
            out[name] = v
    return out


def leaf_norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's norm in fp32, by name."""
    names = list(leaves)
    norms = torch.stack([leaves[n].float().norm() for n in names]).tolist()
    return dict(zip(names, norms))


@contextlib.contextmanager
def no_tf32():
    """fp32 products in fp32: TF32 off for matmuls and cuDNN, restored
    after."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


# ------------------------------------------------------------- precision
class _Rounded(torch.autograd.Function):
    """``x`` rounded through a lower precision, the gradient passed
    straight through."""

    @staticmethod
    def forward(ctx, x, kind):
        if kind == "bf16":
            return x.to(torch.bfloat16).float()
        scale = 448.0 / x.detach().abs().amax().clamp(min=1e-30)
        return (x * scale).to(torch.float8_e4m3fn).float() / scale

    @staticmethod
    def backward(ctx, g):
        return g, None


def _product(x, w, precision: str):
    """A weight product, ``x @ w``: fp32, or (the control) its inputs
    rounded through e4m3."""
    if precision == "fp8":
        x, w = _Rounded.apply(x, "fp8"), _Rounded.apply(w, "fp8")
    return x @ w


def _unembed(x, table, precision: str):
    """Logits (rows, V) in fp32; the control rounds the inputs to bf16."""
    if precision == "fp8":
        x, table = _Rounded.apply(x, "bf16"), _Rounded.apply(table, "bf16")
    return x @ table.t()


# ----------------------------------------------------------------- model
def rmsnorm(x, gain, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * gain


def rope_tables(seq: int, dh: int, theta: float, device):
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                        device=device) / dh))
    ang = torch.arange(seq, dtype=torch.float32, device=device)[:, None] \
        * inv[None, :]
    emb = torch.cat([ang, ang], -1)                      # (S, dh)
    return emb.cos()[None, :, None, :], emb.sin()[None, :, None, :]


def rope(x, cos, sin):
    """x (B, S, heads, dh): x cos + rotate_half(x) sin."""
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos + torch.cat([-x2, x1], -1) * sin


def attention(q, k, v, block: int):
    """Causal GQA attention, q (B, S, H, dh), k and v (B, S, K, dh), in
    blocks of ``block`` query rows, each over the keys up to its last
    row."""
    B, S, H, dh = q.shape
    K = k.shape[2]
    qg = q.reshape(B, S, K, H // K, dh)
    outs = []
    for a in range(0, S, block):
        e = min(S, a + block)
        s = torch.einsum("bqkrd,btkd->bkrqt", qg[:, a:e], k[:, :e]) \
            * dh ** -0.5
        rows = torch.arange(a, e, device=q.device)[:, None]
        keep = rows >= torch.arange(e, device=q.device)[None, :]
        p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
        outs.append(torch.einsum("bkrqt,btkd->bqkrd", p, v[:, :e]))
    return torch.cat(outs, 1).reshape(B, S, H, dh)


def _layer(x, P, i: int, cfg: dict, cos, sin, precision: str, block: int):
    B, S, D = x.shape
    H, K, dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], \
        cfg["head_dim"]
    eps = cfg["rms_norm_eps"]

    def w(name):
        return P[f"layers/{name}/{i}"]

    h = rmsnorm(x, w("ln1"), eps)
    q = _product(h, w("attn/wq"), precision).reshape(B, S, H, dh)
    k = _product(h, w("attn/wk"), precision).reshape(B, S, K, dh)
    v = _product(h, w("attn/wv"), precision).reshape(B, S, K, dh)
    q = rope(rmsnorm(q, w("attn/q_norm"), eps), cos, sin)
    k = rope(rmsnorm(k, w("attn/k_norm"), eps), cos, sin)
    o = attention(q, k, v, block).reshape(B, S, H * dh)
    x = x + _product(o, w("attn/wo"), precision)
    h = rmsnorm(x, w("ln2"), eps)
    f = F.silu(_product(h, w("ffn/wg"), precision)) * \
        _product(h, w("ffn/wi"), precision)
    return x + _product(f, w("ffn/wo"), precision)


def _xent_rows(x, table, labels, z_loss: float, precision: str):
    """Summed loss of a block of rows: lse - gold + z_loss * lse^2."""
    logits = _unembed(x, table, precision)
    lse = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, labels[:, None].long())[:, 0]
    return (lse - gold + z_loss * lse.square()).sum()


def loss(P, tokens, labels, cfg: dict, *, precision: str = "fp32",
         block: int = 512, rows: int = 2048):
    """Token-mean loss of one batch, ``P`` the fp32 leaves by name."""
    B, S = tokens.shape
    table = P["embed"]
    x = table[tokens.long()]
    cos, sin = rope_tables(S, cfg["head_dim"], float(cfg["rope_theta"]),
                           x.device)
    for i in range(cfg["num_hidden_layers"]):
        x = checkpoint(_layer, x, P, i, cfg, cos, sin, precision, block,
                       use_reentrant=False)
    x = rmsnorm(x, P["final_norm"], cfg["rms_norm_eps"]).reshape(B * S, -1)
    head = table if cfg["tie_word_embeddings"] else P["lm_head"]
    flat = labels.reshape(-1)
    z = cfg["loss"]["z_loss"]
    total = sum(checkpoint(_xent_rows, x[r:r + rows], head,
                           flat[r:r + rows], z, precision,
                           use_reentrant=False)
                for r in range(0, B * S, rows))
    return total / (B * S)


# ------------------------------------------------------------- optimizer
def _decayed(name: str, p) -> bool:
    """Weight decay on leaves of two or more dimensions as the tree
    stacks them: every layer leaf, and the others of two or more."""
    return name.split("/")[0] in STACKED or p.ndim >= 2


def train_steps(params, batches: List[Tuple[torch.Tensor, torch.Tensor]],
                cfg: dict, *, precision: str = "fp32",
                half_batch: bool = False, block: int = 512,
                rows: int = 2048) -> dict:
    """The configuration's first training steps from ``params`` (bf16,
    the nested tree), one a batch of (tokens, labels).  Returns each
    step's ``losses``, the first step's global gradient norm before
    clipping (``grad_norm``), the norms by leaf of the first gradient as
    the update applies it, clipped (``grad1``; the program's m after one
    step over 1 - b1), and of the change of the stored parameters over
    all the steps (``change``).  ``half_batch``: the fault that leaves out
    the second half of each batch, the mean taken over the rest."""
    o = cfg["optimizer"]
    b1, b2 = torch.tensor(o["b1"]), torch.tensor(o["b2"])
    with no_tf32():
        start = {n: t.detach().float().clone()
                 for n, t in flatten(params).items()}
        P = {n: t.clone() for n, t in start.items()}
        m = {n: torch.zeros_like(t) for n, t in P.items()}
        v = {n: torch.zeros_like(t) for n, t in P.items()}
        out: dict = {"losses": []}
        for t, (tokens, labels) in enumerate(batches, 1):
            if half_batch:
                tokens, labels = (x[:x.shape[0] // 2]
                                  for x in (tokens, labels))
            for p in P.values():
                p.requires_grad_(True)
            value = loss(P, tokens, labels, cfg, precision=precision,
                         block=block, rows=rows)
            grads = dict(zip(P, torch.autograd.grad(value, list(P.values()))))
            out["losses"].append(float(value.detach()))
            with torch.no_grad():
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
                for n, p in P.items():
                    g = grads[n] * scale
                    m[n] = o["b1"] * m[n] + (1 - o["b1"]) * g
                    v[n] = o["b2"] * v[n] + (1 - o["b2"]) * g.square()
                    u = (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + o["eps"])
                    if _decayed(n, p):
                        u = u + o["weight_decay"] * p
                    P[n] = (p - lr * u).to(torch.bfloat16).float()
            del grads, value
        out["change"] = leaf_norms({n: P[n] - start[n] for n in P})
    return out
