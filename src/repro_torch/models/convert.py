"""Carry trees between the JAX package and the port.

:func:`from_numpy` takes the JAX package's parameters, optimizer state or
decode state as nested dicts (and tuples) of numpy arrays, layer weights
stacked on their leading ``L`` axis, as ``jax.tree.map(np.asarray, tree)``
gives it; bf16 arrives as ``ml_dtypes.bfloat16``.  :func:`to_numpy` is the
way back, bf16 as float32 (which holds every bf16 value).  Nothing here
imports JAX: the caller does the ``jax <-> numpy`` step.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.pipeline.state import resolve_device


def from_numpy(tree, device="cuda"):
    """The same tree of torch tensors on ``device``; bf16 goes through
    float32, which holds every bf16 value exactly.  Like every entry point
    of the port it runs on the card unless asked for the CPU
    (``device="cpu"``), and raises without one."""
    return _from_numpy(tree, resolve_device(device))


def _from_numpy(tree, device):
    if isinstance(tree, dict):
        return {k: _from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_from_numpy(v, device) for v in tree)
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, order="C"))   # 0-d stays 0-d
    return t.to(device)


def to_numpy(tree):
    """The same tree of numpy arrays on the host; bf16 as float32."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
