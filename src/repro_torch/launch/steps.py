"""The train and serve steps (port of ``repro.launch.steps``).

The JAX package jits each step with shardings over a device mesh, donates
its buffers, and can pin gradients to their parameters' shardings; its
``mesh``, the shardings (``shardings_for``), ``donate``, ``profile`` and
``shard_grads`` are levers of several devices and are left out here: the
rules that say where each tensor goes are ported
(:mod:`repro_torch.launch.mesh`), applying them on a torch
``DeviceMesh`` is not yet.  The steps run eagerly on the parameters'
device.

* :func:`build_train_step`: loss and gradients (``accum`` microbatches
  summed in fp32, as the JAX ``lax.scan`` does), then the AdamW update,
  all under ``torch.use_deterministic_algorithms(True)`` so that a run
  resumed from a checkpoint repeats the uninterrupted one bit for bit
  (on the card cuBLAS needs ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set
  before it starts; the port's own kernels use no float atomics);
* :func:`build_serve_step`: one serving step under
  ``torch.inference_mode()``, the KV caches written in place.
"""
from __future__ import annotations

import contextlib

import torch

from .. import tree as T
from ..configs import ArchSpec
from ..models import api
from ..optim import OptConfig, opt_step


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` for the enclosed code,
    restored after."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def build_loss_and_grads(spec: ArchSpec, accum: int = 1):
    """Returns ``loss_and_grads(params, batch) -> (loss, grads)``: the
    token-mean loss (0-d fp32) and the gradient tree of ``params``.  With
    ``accum > 1`` the batch's leading axis splits into ``accum``
    microbatches; the gradients are the fp32 sum of each microbatch's
    divided by ``accum`` and the loss their mean, as in the JAX step."""

    def one(params, batch):
        flat = [p.detach().requires_grad_(True) for p in T.leaves(params)]
        loss = api.apply_train(T.unflatten(params, flat), spec, batch)
        grads = torch.autograd.grad(loss, flat)
        return loss.detach(), T.unflatten(params, list(grads))

    def loss_and_grads(params, batch):
        if accum == 1:
            return one(params, batch)
        micro = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
                 for k, v in batch.items()}
        acc = T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        losses = []
        for i in range(accum):
            loss, g = one(params, {k: v[i] for k, v in micro.items()})
            acc = T.tree_map(lambda a, gi: a + gi.float() / accum, acc, g)
            losses.append(loss)
        return torch.stack(losses).mean(), acc

    return loss_and_grads


#: the parameter subtrees whose leaves are stacked on a leading layer axis
STACKED = ("layers", "enc", "dec")


def grad_norms(grads):
    """The gradient's norm by leaf, fp32: a vector over the layers for a
    stacked layer weight (under ``"layers"``, or the encoder-decoder's
    ``"enc"`` and ``"dec"``), a 0-d tensor for the others."""
    def norm(path, g):
        g = g.float()
        if path[0] in STACKED:
            return g.reshape(g.shape[0], -1).norm(dim=1)
        return g.norm()

    pairs = T.leaves_with_paths(grads)
    return T.unflatten(grads, [norm(p, g) for p, g in pairs])


def build_train_step(spec: ArchSpec, opt_cfg: OptConfig, accum: int = 1):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, stats)``; ``stats`` holds ``loss``, ``grad_norm`` and
    ``lr`` as in the JAX package, and ``grad_norms``, the gradient's norm
    by leaf and layer (:func:`grad_norms`)."""
    loss_and_grads = build_loss_and_grads(spec, accum)

    def train_step(params, opt_state, batch):
        with deterministic():
            loss, grads = loss_and_grads(params, batch)
            params, opt_state, stats = opt_step(params, opt_state, grads,
                                                opt_cfg)
            stats["grad_norms"] = grad_norms(grads)
        stats["loss"] = loss
        return params, opt_state, stats

    return train_step


def build_serve_step(spec: ArchSpec):
    """Returns ``serve_step(params, state, tokens, cache_index) ->
    (next_tok, state)``: one step over (B, S) tokens at ``cache_index``
    and the greedy next token (B,) int32 of its last position.  S > 1 at
    index 0 is the prefill, S = 1 one decode step."""

    def serve_step(params, state, tokens, cache_index):
        with torch.inference_mode():
            logits, new_state = api.apply_decode(params, spec, tokens,
                                                 state, cache_index)
            next_tok = logits[:, -1].argmax(-1).to(torch.int32)
        return next_tok, new_state

    return serve_step
