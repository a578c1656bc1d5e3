"""The train and serve steps (port of ``repro.launch.steps``).

* :func:`build_train_step`: loss and gradients (``accum`` microbatches
  summed in fp32, as the JAX ``lax.scan`` does), then the AdamW update,
  all under ``torch.use_deterministic_algorithms(True)`` so that a run
  resumed from a checkpoint repeats the uninterrupted one bit for bit
  (on the card cuBLAS needs ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set
  before it starts; the port's own kernels use no float atomics);
* :func:`build_serve_step`: one serving step under
  ``torch.inference_mode()`` (``torch.no_grad()`` on a mesh: DTensor
  views fail under inference mode), the KV caches written in place.

Both take the JAX package's ``mesh``, ``donate`` and ``profile`` (and the
train step ``shard_grads``).  ``mesh`` is a torch ``DeviceMesh``
(``launch.mesh.device_mesh``) or None, which runs the step eagerly on
the parameters' device as before.  Under a mesh the inputs are placed as
``jax.jit``'s ``in_shardings`` place them (:func:`shardings_for`,
``mesh.batch_spec``, ``mesh.decode_state_spec``; a DTensor already
placed is left as it is), every model gets ``mesh.make_constrain(mesh,
profile)``, and plain tensors made inside the step (positions, masks)
count as replicated (``implicit_replication``).  Outputs keep their
shardings (``out_shardings``); the serve step's ``next_tok`` and the
train step's ``stats`` come back as plain tensors, the same on every
rank.
"""
from __future__ import annotations

import contextlib

import torch

from .. import tree as T
from ..configs import ArchSpec
from ..models import api
from ..optim import OptConfig, opt_init, opt_step
from . import mesh as M


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


def shardings_for(spec: ArchSpec, mesh, opt_cfg):
    """(param, opt) :class:`~repro_torch.launch.mesh.NamedSharding` trees
    on the ``DeviceMesh`` ``mesh``, from ``api.param_shapes`` and the
    optimizer state's shapes on the meta device (no allocation); the opt
    tree is None without ``opt_cfg``."""
    pshapes = api.param_shapes(spec)
    psh = M.sharding_tree(pshapes, mesh, M.param_spec)
    osh = None
    if opt_cfg is not None:
        osh = M.sharding_tree(opt_init(pshapes, opt_cfg), mesh, M.opt_spec)
    return psh, osh


def _on_mesh(mesh):
    """Plain tensors count as replicated under a mesh."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _batch_shardings(batch, mesh):
    return T.tree_map(lambda t: M.NamedSharding(
        mesh, M.batch_spec("", tuple(t.shape), M.rules_mesh(mesh))), batch)


def _full(x):
    """A DTensor's full value as a plain tensor (``x`` itself if plain)."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _batch_only(x):
    """A DTensor gathered on every axis but the batch (its first): the
    vocabulary of the last logits before their argmax, which DTensor
    cannot take across shards."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
          for p in x.placements]
    return x if pl == list(x.placements) else \
        x.redistribute(x.device_mesh, pl)


def settle_grads(grads, params, shard_grads: bool = True):
    """Gradients reduced onto their parameters' placements: a DTensor
    gradient may come back ``Partial`` and AdamW is not linear.
    ``shard_grads``: straight to the parameter's placements (a
    reduce-scatter); otherwise to ``Replicate()`` first and then sliced
    (an all-reduce).  Equal values either way; plain tensors pass."""
    from torch.distributed.tensor import DTensor, Replicate

    def one(g, p):
        if not isinstance(g, DTensor):
            return g
        mesh = g.device_mesh
        if not shard_grads:
            g = g.redistribute(mesh, [Replicate()] * mesh.ndim)
        return g.redistribute(mesh, p.placements)

    return T.tree_map(one, grads, params)


def build_loss_and_grads(spec: ArchSpec, accum: int = 1, *, mesh=None,
                         profile: str = "tp", shard_grads: bool = True):
    """Returns ``loss_and_grads(params, batch) -> (loss, grads)``: the
    token-mean loss (0-d fp32) and the gradient tree of ``params``.  With
    ``accum > 1`` the batch's leading axis splits into ``accum``
    microbatches; the gradients are the fp32 sum of each microbatch's
    divided by ``accum`` and the loss their mean, as in the JAX step.
    Under a ``mesh`` (params and batch already DTensors) the models get
    ``make_constrain(mesh, profile)`` and each microbatch's gradients are
    settled on their parameters' placements (:func:`settle_grads`)."""
    constrain = M.make_constrain(mesh, profile)

    def one(params, batch):
        flat = [p.detach().requires_grad_(True) for p in T.leaves(params)]
        loss = api.apply_train(T.unflatten(params, flat), spec, batch,
                               constrain)
        grads = T.unflatten(params, list(torch.autograd.grad(loss, flat)))
        if mesh is not None:
            grads = settle_grads(grads, params, shard_grads)
        return loss.detach(), grads

    def loss_and_grads(params, batch):
        if accum == 1:
            return one(params, batch)
        micro = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
                 for k, v in batch.items()}
        acc = T.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
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
            # over every axis but the layers' (no reshape: a flattened
            # DTensor shard is costly to place)
            return torch.linalg.vector_norm(g, dim=tuple(range(1, g.ndim)))
        return g.norm()

    pairs = T.leaves_with_paths(grads)
    return T.unflatten(grads, [norm(p, g) for p, g in pairs])


def build_train_step(spec: ArchSpec, opt_cfg: OptConfig, accum: int = 1, *,
                     mesh=None, donate: bool = False, profile: str = "tp",
                     shard_grads: bool = True):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, stats)``; ``stats`` holds ``loss``, ``grad_norm`` and
    ``lr`` as in the JAX package, and ``grad_norms``, the gradient's norm
    by leaf and layer (:func:`grad_norms`).

    ``mesh``, ``profile`` and ``shard_grads``: see the module and
    :func:`settle_grads`.  ``donate``: the update is written into the
    storage of ``params`` and ``opt_state`` (``opt_step(donate=True)``),
    which then hold the new values; off by default, so that a caller's
    trees stay as they were."""
    loss_and_grads = build_loss_and_grads(spec, accum, mesh=mesh,
                                          profile=profile,
                                          shard_grads=shard_grads)
    psh, osh = shardings_for(spec, mesh, opt_cfg) if mesh is not None \
        else (None, None)

    def train_step(params, opt_state, batch):
        if mesh is not None:
            params, opt_state = M.place(params, psh), M.place(opt_state, osh)
            batch = M.place(batch, _batch_shardings(batch, mesh))
        with deterministic(), _on_mesh(mesh):
            loss, grads = loss_and_grads(params, batch)
            params, opt_state, stats = opt_step(params, opt_state, grads,
                                                opt_cfg, donate=donate)
            stats["grad_norms"] = grad_norms(grads)
            if mesh is not None:
                params, opt_state = (M.place(params, psh),
                                     M.place(opt_state, osh))
                stats = T.tree_map(_full, stats)
                loss = _full(loss)
        stats["loss"] = loss
        return params, opt_state, stats

    return train_step


def build_serve_step(spec: ArchSpec, *, mesh=None, donate: bool = True,
                     profile: str = "tp"):
    """Returns ``serve_step(params, state, tokens, cache_index) ->
    (next_tok, state)``: one step over (B, S) tokens at ``cache_index``
    and the greedy next token (B,) int32 of its last position.  S > 1 at
    index 0 is the prefill, S = 1 one decode step.

    ``donate`` (the default, as in the JAX package): the step writes the
    KV caches and SSM states of ``state`` in place and returns them;
    ``donate=False`` writes into a copy and leaves ``state`` as it was.
    Under a ``mesh`` the state is placed by ``decode_state_spec`` (a plain
    state is copied into its shards, so the returned state is the one to
    carry) and ``next_tok`` comes back replicated, a plain tensor."""
    constrain = M.make_constrain(mesh, profile)
    psh = shardings_for(spec, mesh, None)[0] if mesh is not None else None

    def serve_step(params, state, tokens, cache_index):
        if not donate:
            state = T.tree_map(torch.clone, state)
        if mesh is not None:
            params = M.place(params, psh)
            state = M.place(state, M.sharding_tree(state, mesh,
                                                   M.decode_state_spec))
            tokens = M.place(tokens, _batch_shardings(tokens, mesh))
        # DTensor views fail under inference mode: no_grad on a mesh
        grad_off = torch.inference_mode() if mesh is None else \
            torch.no_grad()
        with grad_off, _on_mesh(mesh):
            logits, new_state = api.apply_decode(params, spec, tokens,
                                                 state, cache_index,
                                                 constrain)
            next_tok = _full(_batch_only(logits[:, -1]).argmax(-1)
                             .to(torch.int32))
        return next_tok, new_state

    return serve_step
