"""Device meshes and the sharding rules (port of ``repro.launch.mesh``).

Mesh: ``(data=16, model=16)`` per pod and ``(pod=2, data=16, model=16)``
for the two-pod dry-run.  The ``pod`` axis composes with ``data`` as an
outer batch axis.

A :class:`Mesh` here is a small description of the port's own: its axis
names, an ordered mapping from axis to size, and the devices it spans (a
numpy object array of ``torch.device``, or ``None`` for an abstract mesh),
so that ``mesh.devices.size`` reads as it does in JAX.  The runtime's
``("sm",)`` mesh (:func:`make_sm_mesh`) may name one device several times:
the port's counterpart of XLA's forced host device count, which lets one
card (or the CPU) run every shard of the sharded executor.

Sharding rules are *name- and shape-driven*: :func:`param_spec`
pattern-matches tree paths (wq/wo/wi/experts/embed/...), and every rule
degrades gracefully — an axis that does not divide evenly is dropped from
the spec rather than failing, so one rule set serves every architecture.
A spec is a :class:`P`, a tuple of axis names, ``None`` or tuples of
names, equal as a tuple to the JAX package's ``PartitionSpec``.  The rules
read only ``mesh.axis_names`` and ``mesh.shape``.

The paper connection: the FlexGrip block scheduler maps thread blocks
round-robin onto SMs; here data shards map onto devices along ``(pod,
data)``.

Applying the specs: :func:`device_mesh` makes a torch ``DeviceMesh`` of a
:class:`Mesh` (a process group with one rank per device must exist),
:func:`placements` turns a :class:`P` into DTensor placements,
:class:`NamedSharding` pairs the two and :func:`place` distributes a tree
of tensors by a tree of them (``jax.jit``'s ``in_shardings``).
:func:`make_constrain` is the ``constrain(x, kind)`` hook the models call:
it redistributes a DTensor to :func:`act_spec`'s placements.  The rules
and :func:`make_constrain` take either a :class:`Mesh` or a
``DeviceMesh`` (:func:`rules_mesh`).  :func:`local_call` runs a function
that DTensor has no rule for, or a CUDA kernel, on each rank's local
shards.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from .. import tree as T
from ..core.pipeline.state import resolve_device


class P(tuple):
    """A partition spec: one entry per tensor axis, each an axis name,
    ``None`` (replicated) or a tuple of names (the product of their
    sizes)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "P" + (tuple.__repr__(self) if len(self) != 1
                      else f"({self[0]!r})")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names, ``shape`` (axis -> size, in axis order) and the devices
    (an object array of that shape, or ``None`` when abstract)."""
    axis_names: Tuple[str, ...]
    shape: Mapping[str, int]
    devices: Optional[np.ndarray] = dataclasses.field(default=None,
                                                      compare=False)


def _make_mesh(shape, axes, devices=None) -> Mesh:
    """A mesh of ``shape`` over ``axes``; ``devices`` (a flat sequence of
    at least ``prod(shape)`` entries) fills it in order, or leaves it
    abstract when ``None``."""
    shape = tuple(int(s) for s in shape)
    dev = None
    if devices is not None:
        flat = [torch.device(d) for d in devices][:int(np.prod(shape))]
        if len(flat) != int(np.prod(shape)):
            raise ValueError(f"a mesh of shape {shape} needs "
                             f"{int(np.prod(shape))} devices, got "
                             f"{len(flat)}")
        dev = np.empty(len(flat), object)
        dev[:] = flat
        dev = dev.reshape(shape)
    return Mesh(tuple(axes), dict(zip(axes, shape)), dev)


def local_devices() -> list:
    """Every local CUDA device, ``cuda:0`` to ``cuda:N-1``; without a card
    it raises, as the port's entry points do."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


_CURRENT: list = []


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """``with use_mesh(mesh):`` makes ``mesh`` the current one
    (:func:`current_mesh`) for the enclosed code."""
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()


def current_mesh() -> Optional[Mesh]:
    """The mesh of the innermost :func:`use_mesh`, or ``None``."""
    return _CURRENT[-1] if _CURRENT else None


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The abstract production mesh: ``(16, 16)`` over ``("data",
    "model")``, or ``(2, 16, 16)`` with the ``pod`` axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes)


def make_debug_mesh(n_devices: int = 1) -> Mesh:
    """Tiny ``(1, n)`` ``("data", "model")`` mesh over local devices."""
    return _make_mesh((1, n_devices), ("data", "model"), local_devices())


def make_sm_mesh(n_sm: int, devices: Optional[Sequence] = None) -> Mesh:
    """One-axis ``("sm",)`` mesh for the device runtime's block executor.

    The paper's blocks->SMs round-robin, lifted to devices: the schedule
    axis shards over the first ``min(max(1, n_sm), len(devices))`` entries
    of ``devices`` — by default every local CUDA device.  A caller's list
    may name one device several times (``["cpu"] * 8``, ``["cuda:0"] *
    4``): each entry is one shard.
    """
    devices = local_devices() if devices is None else list(devices)
    n = min(max(1, n_sm), len(devices))
    return _make_mesh((n,), ("sm",), devices)


def batch_axes(mesh: Mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _axis_size(mesh: Mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def _fit(mesh: Mesh, shape, spec_axes) -> P:
    """Drop sharding on axes whose size does not divide evenly."""
    fixed = []
    for dim, axis in zip(shape, spec_axes):
        n = _axis_size(mesh, axis)
        fixed.append(axis if dim % n == 0 else None)
    # pad spec to rank
    fixed += [None] * (len(shape) - len(fixed))
    return P(*fixed)


# --------------------------------------------------------------- params
_PARAM_RULES = (
    # (path regex, spec builder given the core shape)
    (r"(embed|lm_head)$", lambda s: ("model", None)),
    (r"enc_pos$", lambda s: (None, None)),
    (r"vision_proj$", lambda s: (None, "model")),
    (r"(wq|wk|wv)$", lambda s: ("data", "model")),
    (r"attn/wo$|self/wo$|cross/wo$|shared.*wo$", lambda s: ("model", "data")),
    (r"(wi|wg)$", lambda s: ("data", "model")),       # ffn in-projections
    (r"ffn/wo$", lambda s: ("model", "data")),
    (r"router$", lambda s: ("data", "model")),
    (r"in_proj$", lambda s: ("data", "model")),
    (r"conv_w$", lambda s: (None, "model")),
    (r"out_proj$", lambda s: ("model", "data")),
    (r"moe/(wi|wg)$", lambda s: ("model", "data", None)),
    (r"moe/wo$", lambda s: ("model", None, "data")),
)


def param_spec(path: str, shape: Tuple[int, ...], mesh: Mesh) -> P:
    """Sharding spec for one parameter leaf (path uses '/')."""
    # layer-stacked params carry a leading L (or n_apps) axis: unsharded
    lead = ()
    core = shape
    stacked = bool(re.search(r"(layers|enc|dec)/", path)) and len(shape) >= 2
    if stacked:
        lead, core = (None,), shape[1:]
    # MoE expert tensors: (L, E, D, F)
    if re.search(r"moe/(wi|wg)$", path) and len(core) == 3:
        return _fit(mesh, shape, lead + ("model", "data", None))
    if re.search(r"moe/wo$", path) and len(core) == 3:
        return _fit(mesh, shape, lead + ("model", None, "data"))
    for pat, rule in _PARAM_RULES:
        if re.search(pat, path):
            axes = rule(core)
            if len(axes) != len(core):
                axes = tuple(axes) + (None,) * (len(core) - len(axes))
            return _fit(mesh, shape, lead + tuple(axes[:len(core)]))
    return P()  # norms, biases, scalars: replicated


def spec_tree(tree, mesh: Mesh, spec_fn):
    """Map (path, leaf shape) -> spec over a tree of nested dicts, tuples
    and lists (leaves in JAX's order; a path's keys and indices joined by
    '/').  A :class:`P` is a tuple, so read the result's leaves with
    ``tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))``."""
    mesh = rules_mesh(mesh)
    specs = [spec_fn("/".join(str(k) for k in path), tuple(leaf.shape), mesh)
             for path, leaf in T.leaves_with_paths(tree)]
    return T.unflatten(tree, specs)


def opt_spec(path: str, shape, mesh: Mesh) -> P:
    """Optimizer state mirrors its parameter's sharding.

    Factored second moments (…/v/…/row, …/col) inherit the parameter
    spec minus the reduced axis; the step counter is replicated.
    """
    if path.endswith("step"):
        return P()
    shape = tuple(shape)
    core = re.sub(r"^(m|v)/", "", path)
    is_row = core.endswith("/row")
    is_col = core.endswith("/col")
    core = re.sub(r"/(row|col)$", "", core)

    def padded(base, n):
        t = tuple(base)
        return t + (None,) * (n - len(t))

    if is_row:
        base = padded(param_spec(core, shape + (1,), mesh), len(shape) + 1)
        return P(*base[:len(shape)])
    if is_col:
        # col drops the second-to-last param axis
        base = padded(param_spec(core, shape[:-1] + (1, shape[-1]), mesh),
                      len(shape) + 1)
        return P(*(base[:len(shape) - 1] + (base[-1],)))
    return param_spec(core, shape, mesh)


# ----------------------------------------------------------- activations
def act_spec(kind: str, shape, mesh: Mesh, profile: str = "tp"
             ) -> Optional[P]:
    """Activation sharding.

    ``profile="tp"``  — Megatron-style tensor parallelism: hidden/head
    axes shard over ``model``; each layer pays two (B, S, D) activation
    all-reduces (the psum after wo / ffn-wo).

    ``profile="seq"`` — sequence parallelism: the SEQUENCE axis shards
    over ``model`` end-to-end; weight contractions are local and attention
    gathers only the GQA K/V heads.
    """
    # weight tensors constrained inside layer bodies ("param:<name>"),
    # in the "seq" profile only
    if kind.startswith("param:"):
        if profile != "seq":
            return None
        return param_spec("layers/" + kind[6:], shape, mesh)
    b = batch_axes(mesh)
    bspec = b if len(b) > 1 else b[0]
    if profile == "seq":
        if kind in ("act_resid", "act_ffn"):
            return _fit(mesh, shape, (bspec, "model", None))
        if kind == "act_heads":               # q: S-sharded
            return _fit(mesh, shape, (bspec, "model", None, None))
        if kind == "act_kv":                  # k/v: gathered (GQA: small)
            return _fit(mesh, shape, (bspec, None, None, None))
        if kind == "moe_expert" and len(shape) == 4:
            G, E, C, D = shape
            if C <= 8:
                # decode regime (minimal per-group capacity): shard the
                # contracted D over data, so the expert product reduces
                # small (C, F) partials instead of gathering the weights
                return _fit(mesh, shape, (None, "model", None, "data"))
            return _fit(mesh, shape, (bspec, "model", None, None))
        return None
    if kind == "act_resid":
        return _fit(mesh, shape, (bspec, None, None))
    if kind == "act_ffn":
        return _fit(mesh, shape, (bspec, None, "model"))
    if kind in ("act_heads", "act_kv"):
        return _fit(mesh, shape, (bspec, None, "model", None))
    if kind == "moe_expert":              # (G, E, C, D)
        return _fit(mesh, shape, (bspec, "model", None, None))
    return None


# ------------------------------------------------------------ batch/state
def batch_spec(path: str, shape, mesh: Mesh) -> P:
    """Input batches: leading dim is the global batch."""
    b = batch_axes(mesh)
    bspec = b if len(b) > 1 else b[0]
    return _fit(mesh, shape, (bspec,) + (None,) * (len(shape) - 1))


def decode_state_spec(path: str, shape, mesh: Mesh) -> P:
    """Decode state: KV caches (L, B, T, K, dh), SSD states, conv states.

    Prefer sharding batch over (pod, data); if batch doesn't divide
    (long-context batch=1), shard the time axis instead.  Heads/channels
    shard over model when divisible.
    """
    b = batch_axes(mesh)
    bspec = b if len(b) > 1 else b[0]
    nb = _axis_size(mesh, bspec)
    nm = mesh.shape["model"]
    if "kv" in path and len(shape) == 5:
        L, B, T_, K, dh = shape
        spec = [None] * 5
        if B % nb == 0:
            spec[1] = bspec
        elif T_ % nb == 0:
            spec[2] = bspec
        if K % nm == 0:
            spec[3] = "model"
        elif T_ % nm == 0 and spec[2] is None:
            spec[2] = "model"
        return _fit(mesh, shape, tuple(spec))
    if "cross" in path and len(shape) == 5:
        L, B, T_, K, dh = shape
        spec = [None, bspec if B % nb == 0 else None, None,
                "model" if K % nm == 0 else None, None]
        return _fit(mesh, shape, tuple(spec))
    if "ssm" in path and len(shape) == 5:   # (L, B, H, P, N)
        L, B, H, Pd, N = shape
        spec = [None, bspec if B % nb == 0 else None,
                "model" if H % nm == 0 else None, None, None]
        return _fit(mesh, shape, tuple(spec))
    if "conv" in path and len(shape) == 4:  # (L, B, K-1, C)
        L, B, K1, C = shape
        spec = [None, bspec if B % nb == 0 else None, None,
                "model" if C % nm == 0 else None]
        return _fit(mesh, shape, tuple(spec))
    return batch_spec(path, shape, mesh)


# ------------------------------------------------------ applying the specs
def rules_mesh(mesh) -> Mesh:
    """The :class:`Mesh` the rules read (axis names and sizes) of a torch
    ``DeviceMesh``; anything else (a :class:`Mesh`, or any object with
    ``axis_names`` and ``shape``) as it is."""
    if not hasattr(mesh, "mesh_dim_names"):
        return mesh
    return _make_mesh(tuple(mesh.shape), mesh.mesh_dim_names)


def device_mesh(mesh: Mesh, device_type: Optional[str] = None):
    """A torch ``DeviceMesh`` with ``mesh``'s axis names, order and sizes,
    over the ranks of the default process group (which must have
    ``prod(mesh.shape)`` ranks).  ``device_type`` defaults to the type of
    ``mesh.devices``, else ``"cuda"``."""
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        device_type = (mesh.devices.flat[0].type if mesh.devices is not None
                       else "cuda")
    return init_device_mesh(device_type, tuple(mesh.shape.values()),
                            mesh_dim_names=tuple(mesh.axis_names))


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``: a
    tensor dim d naming an axis is ``Shard(d)`` on that mesh dim (a tuple
    of axes, ``("pod", "data")``, on each of them, major to minor, as in
    JAX); every other mesh dim is ``Replicate()``, and so is a mesh dim of
    size 1 (the same layout: DTensor will not reshape a tensor dim sharded
    even one way)."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        dims = [names.index(a) for a in
                (entry if isinstance(entry, tuple) else (entry,))]
        if dims != sorted(dims):
            raise ValueError(f"placements: {entry} is not in the mesh's "
                             f"axis order {names}")
        for i in dims:
            if mesh.size(i) > 1:
                out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A ``DeviceMesh`` and a :class:`P` (JAX's ``NamedSharding``)."""
    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def sharding_tree(tree, mesh, spec_fn):
    """:class:`NamedSharding` of each leaf of ``tree`` by ``spec_fn`` (a
    rule of this module) on the ``DeviceMesh`` ``mesh``."""
    specs = spec_tree(tree, mesh, spec_fn)
    return T.tree_map(lambda s: NamedSharding(mesh, s), specs,
                      is_leaf=lambda x: isinstance(x, P))


def param_sharding_tree(shapes_tree, mesh):
    return sharding_tree(shapes_tree, mesh, param_spec)


def place(tree, shardings):
    """``tree``'s tensors distributed by ``shardings`` (a tree of
    :class:`NamedSharding` of the same structure, or one for a single
    tensor): a plain tensor becomes this rank's shard of it, with no
    communication (every rank is given the same tensors, as every JAX
    host is); a DTensor is redistributed where its placements differ."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, s):
        pl = s.placements
        if isinstance(t, DTensor):
            return t if tuple(t.placements) == pl else \
                t.redistribute(s.mesh, pl)
        return distribute_tensor(t, s.mesh, pl, src_data_rank=None)

    if isinstance(shardings, NamedSharding):
        return one(tree, shardings)
    return T.tree_map(one, tree, shardings)


def shard_range(size: int, mesh, placements, dim: int):
    """(offset, length) of this rank's shard of a tensor dim of ``size``
    under ``placements`` (torch.chunk's split, mesh dims major to minor).
    Reads only this rank's mesh coordinate, so it works on fake tensors."""
    coord = mesh.get_coordinate()
    off, n = 0, size
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            chunk = -(-n // mesh.size(i))
            o = min(coord[i] * chunk, n)
            off, n = off + o, max(0, min(chunk, n - o))
    return off, n


def local_shape(t) -> tuple:
    """The shape of the shard this rank holds (``t``'s shape when ``t``
    is not a DTensor)."""
    return tuple((t.to_local() if isinstance(t, DTensor) else t).shape)


def make_constrain(mesh, profile: str = "tp"):
    """Build the ``constrain(x, kind)`` callback passed into models: the
    identity when ``mesh`` is None; otherwise ``x`` redistributed to
    :func:`act_spec`'s placements on the ``DeviceMesh`` ``mesh``, or
    ``x`` unchanged where the spec is None or a dim does not divide (e.g.
    batch 1 long-context decode).  The ``"param:<name>"`` kinds act only
    under ``profile="seq"``."""
    if mesh is None:
        return lambda x, *a: x
    rm = rules_mesh(mesh)

    def constrain(x, kind):
        spec = act_spec(kind, tuple(x.shape), rm, profile)
        if spec is None:
            return x
        sizes = [_axis_size(rm, a) for a in spec]
        if not all(d % n == 0 for d, n in zip(x.shape, sizes)):
            return x
        target = placements(spec, mesh)
        return x if tuple(x.placements) == target else \
            x.redistribute(mesh, target)

    return constrain


class _PartialFromLocal(torch.autograd.Function):
    """``DTensor.from_local(local, mesh, placements)`` whose gradient is
    taken at ``grad_placements`` (the keyword of ``from_local`` that
    older torch lacks)."""

    @staticmethod
    def forward(ctx, local, mesh, placements, grad_placements):
        ctx.mesh, ctx.grad_placements = mesh, grad_placements
        return DTensor.from_local(local, mesh, placements, run_check=False)

    @staticmethod
    def backward(ctx, grad):
        if isinstance(grad, DTensor):
            if tuple(grad.placements) != ctx.grad_placements:
                grad = grad.redistribute(ctx.mesh, ctx.grad_placements)
            grad = grad.to_local()
        return grad, None, None, None


def local_call(fn, args, in_placements, out_placements, mesh):
    """``fn(*locals)`` on each rank's shards: every DTensor in ``args`` is
    redistributed to its entry of ``in_placements`` and handed to ``fn``
    as its local tensor; ``fn``'s output becomes a DTensor with
    ``out_placements`` (a tuple of outputs, one placement sequence each).
    Plain tensors in ``args`` pass as they are.

    Differentiable both ways.  An argument replicated on a mesh dim that
    another argument is sharded on (the work is split there, each rank
    using all of it) gets its gradient as ``Partial`` on that dim, each
    rank's share summed; where every argument is replicated on a dim the
    ranks repeat the same work and the gradient stays replicated."""
    placed = []
    for a, pl in zip(args, in_placements):
        if isinstance(a, DTensor) and tuple(a.placements) != tuple(pl):
            a = a.redistribute(mesh, pl)
        placed.append(a)
    split = {i for a in placed if isinstance(a, DTensor)
             for i, p in enumerate(a.placements) if isinstance(p, Shard)}
    local = []
    for a in placed:
        if isinstance(a, DTensor):
            grad_pl = [Partial() if i in split and isinstance(p, Replicate)
                       else p for i, p in enumerate(a.placements)]
            a = a.to_local(grad_placements=grad_pl)
        local.append(a)
    out = fn(*local)

    def wrap(o, pl):
        if not any(isinstance(p, Partial) for p in pl):
            return DTensor.from_local(o, mesh, pl, run_check=False)
        # a Partial output is this rank's share of a sum: its gradient is
        # the sum's, whole on every rank
        grad_pl = tuple(Replicate() if isinstance(p, Partial) else p
                        for p in pl)
        return _PartialFromLocal.apply(o, mesh, tuple(pl), grad_pl)

    if isinstance(out, tuple):
        return tuple(wrap(o, pl) for o, pl in zip(out, out_placements))
    return wrap(out, out_placements)


def pin_grad(x, whole_last: bool = False):
    """``x`` itself, whose gradient arrives redistributed to ``x``'s own
    placements (the cotangent side of JAX's sharding constraint); with
    ``whole_last`` both are first gathered on the last axis.  Before a
    product that consumes the gradient, so that DTensor sees a layout it
    can propagate (not a token axis strided over a 3-axis mesh).  A plain
    tensor passes."""
    if not isinstance(x, DTensor):
        return x
    last = x.ndim - 1
    pl = tuple(Replicate() if isinstance(p, Partial) or (
        whole_last and isinstance(p, Shard) and p.dim in (last, -1)) else p
        for p in x.placements)
    return local_call(lambda t: t, (x,), (pl,), pl, x.device_mesh)
