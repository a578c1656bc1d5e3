"""Cost analysis of a traced step (counterpart of
``repro.launch.hloanalysis``).

The JAX module walks the optimized HLO text of a compiled step.  The port
has no HLO: :func:`analyze` runs the step and counts what it dispatches.
A ``TorchDispatchMode`` sees every aten operation that a rank runs on its
own tensors: a DTensor operation arrives desugared (the mode hands it to
DTensor and sees the local compute and the collectives of its
redistributions).  So the counts are per chip, read off the local shapes.
That is the same number as the global count divided by the mesh dims an
output is ``Shard`` or ``Partial`` on: a ``Replicate`` dim divides
nothing, since every rank does the work.  The eager step runs every layer,
so no loop needs a trip count.  Per chip:

* FLOPs: the matrix products' ``2 * M * N * K`` (``torch.utils.
  flop_counter``'s formulas); element-wise arithmetic 1 a result element,
  transcendentals 4 (and 1 transcendental), the JAX module's two sets;
* bytes: operands plus results of the heavy operations (the counterparts
  of the JAX module's ``_HEAVY``; element-wise chains are taken as fused);
  a gather or slice read counts twice its result, a scatter or slice
  write twice its update;
* collective bytes: each collective's result, by type;
  ``collective_bytes_bf16`` counts fp32 collectives at half width, as the
  JAX module normalises them;
* ``scope_bytes``: the heavy bytes inside a region named
  ``flashable_attn`` (:data:`SCOPE_RE`; ``models.layers.attend`` names it
  around every attention while a mode that ``reads_scopes`` is active);
* the port's flash kernels are not dispatcher operations: their launches
  are counted from their shapes (``kernels._build.observe`` tells every
  active mode that ``counts_kernels``), so a step on the card with its
  real kernels is counted whole; ``CostMode.kernels`` counts the
  launches by name.

:class:`OpCost` keeps the JAX fields and adds ``peak_bytes``, the most
bytes that the operations' results held alive at once (the temporaries'
peak, on fake tensors too).
"""
from __future__ import annotations

import collections
import dataclasses
import re
import weakref
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

_ELEMENTWISE1 = {"add", "sub", "mul", "div", "maximum", "minimum", "where",
                 "eq", "ne", "lt", "le", "gt", "ge", "neg", "abs",
                 "logical_and", "logical_or", "logical_not", "bitwise_and",
                 "bitwise_or", "bitwise_xor", "bitwise_not", "clamp",
                 "clamp_min", "clamp_max", "floor", "ceil", "round", "sign",
                 "remainder", "fmod", "masked_fill", "rsub", "reciprocal",
                 "square"}
_ELEMENTWISE4 = {"exp", "log", "tanh", "rsqrt", "sqrt", "pow", "sigmoid",
                 "sin", "cos", "expm1", "log1p", "atan2", "erf", "silu",
                 "logaddexp", "softplus", "exp2"}

# operations whose operands and results touch memory even under perfect
# fusion: products, reductions, gathers and scatters, sorts, concatenation,
# padding, copies across layouts, scans, random numbers
_HEAVY = {"mm", "bmm", "addmm", "baddbmm", "matmul", "sum", "mean", "amax",
          "amin", "max", "min", "logsumexp", "_softmax", "_log_softmax",
          "var", "var_mean", "norm", "linalg_vector_norm", "prod",
          "gather", "index", "index_select", "embedding", "take",
          "scatter", "scatter_add", "index_put", "index_put_", "index_add",
          "slice_scatter", "select_scatter", "copy_", "sort", "topk",
          "argsort", "cat", "stack", "constant_pad_nd", "clone",
          "contiguous", "cumsum", "searchsorted", "randn", "rand",
          "normal", "uniform"}
_SLICE_READ = {"gather", "index", "index_select", "embedding", "take"}
_SLICE_WRITE = {"scatter", "scatter_add", "index_put", "index_put_",
                "index_add", "slice_scatter", "select_scatter", "copy_"}

_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "all_reduce": "all-reduce",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "broadcast": "collective-permute"}

#: heavy operations inside a region whose name matches this run, on the
#: card, inside the flash kernels; the dry-run reports their bytes apart
SCOPE_RE = re.compile(r"flashable_attn")


@dataclasses.dataclass
class OpCost:
    flops: float = 0.0
    bytes: float = 0.0
    transcendental: float = 0.0
    collective_bytes: float = 0.0
    collective_bytes_bf16: float = 0.0
    coll_by_type: Optional[Dict[str, float]] = None
    coll_count: float = 0.0
    scope_bytes: float = 0.0   # bytes of heavy ops inside SCOPE_RE
    peak_bytes: float = 0.0    # most result bytes alive at once
    collective_rows: Optional[List[tuple]] = None

    def __iadd__(self, o):
        self.flops += o.flops
        self.bytes += o.bytes
        self.transcendental += o.transcendental
        self.collective_bytes += o.collective_bytes
        self.collective_bytes_bf16 += o.collective_bytes_bf16
        self.coll_count += o.coll_count
        self.scope_bytes += o.scope_bytes
        self.peak_bytes = max(self.peak_bytes, o.peak_bytes)
        if o.coll_by_type:
            self.coll_by_type = self.coll_by_type or {}
            for k, v in o.coll_by_type.items():
                self.coll_by_type[k] = self.coll_by_type.get(k, 0) + v
        return self

    def scaled(self, mult: float) -> "OpCost":
        return OpCost(self.flops * mult, self.bytes * mult,
                      self.transcendental * mult,
                      self.collective_bytes * mult,
                      self.collective_bytes_bf16 * mult,
                      {k: v * mult for k, v in
                       (self.coll_by_type or {}).items()},
                      self.coll_count * mult, self.scope_bytes * mult,
                      self.peak_bytes)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    return 0


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    return []


def flash_cost(name: str, B: int, H: int, KH: int, Sq: int, Sk: int,
               dh: int, causal: bool, itemsize: int) -> OpCost:
    """What one launch of the port's flash forward (``name``
    ``"flash_attention"``) or backward (``"flash_attention_bwd"``) does:
    2 products a pair of query and key rows forward (S and PV), 5 backward
    (S again, dP, dV, dQ, dK), over the pairs the causal mask keeps (Sq ==
    Sk: the lower triangle); one exp a pair; q, k, v read and o (and lse)
    written forward; q, k, v, o, dO, lse read and dQ, dK, dV written
    backward."""
    pairs = Sq * (Sq + 1) / 2 if causal and Sq == Sk else Sq * Sk
    q, kv, lse = B * Sq * H * dh * itemsize, B * Sk * KH * dh * itemsize, \
        B * H * Sq * 4
    if name == "flash_attention":
        return OpCost(flops=4.0 * B * H * dh * pairs,
                      transcendental=float(B * H * pairs),
                      bytes=float(2 * q + 2 * kv + lse))
    return OpCost(flops=10.0 * B * H * dh * pairs,
                  transcendental=float(B * H * pairs),
                  bytes=float(4 * q + 4 * kv + lse))


class CostMode(TorchDispatchMode):
    """The counting mode of :func:`analyze`; ``cost`` accumulates, and
    ``kernels`` counts the flash launches by name."""

    #: read by ``models.layers`` (name the attention region) and
    #: ``kernels._build.observe`` (tell :meth:`kernel` of each launch)
    reads_scopes = True
    counts_kernels = True

    def __init__(self):
        super().__init__()
        self.inferring = 0
        self.cost = OpCost(coll_by_type={}, collective_rows=[])
        self.kernels: collections.Counter = collections.Counter()
        self.scopes: List[str] = []
        self.live = 0
        self._seen = set()

    def _alloc(self, t):
        key = id(t)
        if key in self._seen:
            return
        n = _nbytes(t)
        self._seen.add(key)
        self.live += n
        self.cost.peak_bytes = max(self.cost.peak_bytes, self.live)

        def free(key=key, n=n, mode=weakref.ref(self)):
            m = mode()
            if m is not None:
                m.live -= n
                m._seen.discard(key)

        weakref.finalize(t, free)

    def kernel(self, name, *shape):
        """One launch of the port's flash kernels (``_build.observe``)."""
        self.kernels[name] += 1
        self.cost += flash_cost(name, *shape)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # let DTensor desugar; count that
        kwargs = kwargs or {}
        if self.inferring:
            # DTensor's sharding propagation runs the operation on fake
            # global shapes to learn its output's: no rank does that work
            return func(*args, **kwargs)
        if torch.is_inference_mode_enabled() and func.namespace == "aten":
            # composite operations arrive whole under inference mode: each
            # counts as the operations it decomposes into
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        name = func.__name__.split(".")[0]
        if name == "_record_function_enter_new":
            self.scopes.append(str(args[0]))
        elif name == "_record_function_exit" and self.scopes:
            self.scopes.pop()
        out = func(*args, **kwargs)
        base = name[:-1] if name.endswith("_") and name != "index_put_" \
            and name != "copy_" else name
        c = self.cost
        if base in _COLLECTIVES:
            kind = _COLLECTIVES[base]
            b = _nbytes(out)
            b16 = b / 2 if any(t.dtype == torch.float32
                               for t in _tensors(out)) else b
            c.collective_bytes += b
            c.collective_bytes_bf16 += b16
            c.coll_by_type[kind] = c.coll_by_type.get(kind, 0.0) + b
            c.coll_count += 1
            c.collective_rows.append(
                (b, kind, tuple(_tensors(out)[0].shape) if _tensors(out)
                 else (), "/".join(self.scopes)))
            c.bytes += b + _nbytes(args)
            return out
        if func._overloadpacket in flop_registry:
            c.flops += float(flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out))
        elif base in _ELEMENTWISE1:
            c.flops += float(sum(t.numel() for t in _tensors(out)))
        elif base in _ELEMENTWISE4:
            n = float(sum(t.numel() for t in _tensors(out)))
            c.flops += 4.0 * n
            c.transcendental += n
        if base in _HEAVY:
            rb = _nbytes(out)
            if base == "copy_":
                b = 2 * _nbytes(args[1])
            elif base in _SLICE_WRITE:
                b = 2 * sum(_nbytes(t) for t in _tensors(args[1:])
                            if _nbytes(t) < _nbytes(args[0]))
            elif base in _SLICE_READ:
                b = 2 * rb
            else:
                b = rb + sum(_nbytes(t) for t in _tensors(args))
            c.bytes += b
            if any(SCOPE_RE.search(s) for s in self.scopes):
                c.scope_bytes += b
        if not getattr(func, "is_view", False):
            for t in _tensors(out):
                if not any(t is a for a in _tensors(args)):
                    self._alloc(t)
        return out


def analyze(fn, *args, **kwargs) -> OpCost:
    """Run ``fn(*args, **kwargs)`` and count what it dispatches (module
    docstring); the result is at ``cost.result`` and the flash launches
    by name at ``cost.kernels``.  DTensor's inference of output shapes
    (its sharding propagator running an operation on fake global shapes)
    is not counted: the propagator's private method is wrapped for the
    call, and a torch release that names it otherwise raises rather than
    count global shapes as a chip's work."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    mode = CostMode()
    # the propagator's shape inference (its name by torch release)
    name = next((n for n in ("_propagate_tensor_meta_non_cached",
                             "_propagate_tensor_meta")
                 if hasattr(ShardingPropagator, n)), None)
    if name is None:
        raise RuntimeError(
            "hloanalysis.analyze: torch " + torch.__version__ + "'s "
            "ShardingPropagator has neither _propagate_tensor_meta_non_cached"
            " nor _propagate_tensor_meta, whose calls the analysis must "
            "leave uncounted")
    infer = getattr(ShardingPropagator, name)

    def inferring(self, *a, **k):
        mode.inferring += 1
        try:
            return infer(self, *a, **k)
        finally:
            mode.inferring -= 1

    setattr(ShardingPropagator, name, inferring)
    try:
        with mode:
            result = fn(*args, **kwargs)
    finally:
        setattr(ShardingPropagator, name, infer)
    mode.cost.result = result
    mode.cost.kernels = dict(mode.kernels)
    return mode.cost


def top_collectives(cost: OpCost, n: int = 12):
    """The largest collectives of an analysis, each (bytes summed, type,
    count, shape, scope), grouped by the last three: which reduction
    eats the step."""
    rows: Dict[tuple, list] = {}
    for b, kind, shape, where in cost.collective_rows or ():
        r = rows.setdefault((kind, shape, where), [0.0, 0])
        r[0] += b
        r[1] += 1
    out = [(b, kind, cnt, shape, where)
           for (kind, shape, where), (b, cnt) in rows.items()]
    out.sort(key=lambda r: -r[0])
    return out[:n]
