"""Crash-safe checkpointing with atomic commit and auto-resume (port of
``repro.ckpt.checkpoint``), in the JAX package's on-disk format.

Protocol (two-phase):
  1. write ``step_<n>.tmp/`` with one ``.npy`` per leaf, named by its tree
     path with ``/`` -> ``__``, plus a ``manifest.json`` (step, wall time,
     and for each leaf its file, dtype, shape and ``sha256[:16]``);
  2. ``os.replace`` the directory to ``step_<n>/``, atomic on POSIX.

A reader only trusts directories whose manifest checksums match, so a run
that dies mid-write never poisons a restart: ``restore`` walks back to
the last complete step.

bfloat16 leaves are written as their raw bytes (a ``uint8`` array) under
the dtype string ``"bfloat16"``, as the JAX package writes them, and read
back through torch (``view(torch.bfloat16)``), so the port needs no
``ml_dtypes``.  A checkpoint written by either package restores in the
other.  Leaves are written from tensors on any device and restored onto
the device of the matching leaf of ``tree_like``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import shutil
import time
from typing import Any, Optional

import numpy as np
import torch

from .. import tree as T

_NATIVE = set("?bhilqBHILQefdFD")


def _to_disk(leaf):
    """(array written to disk, dtype string, shape) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:   # raw bytes, as the JAX package
            raw = (t if t.ndim else t.reshape(1)).view(torch.uint8)
            return raw.numpy(), "bfloat16", list(t.shape)
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.char not in _NATIVE:
        raise TypeError(f"checkpoint: cannot write dtype {arr.dtype}")
    return arr, str(arr.dtype), list(arr.shape)


def _from_disk(arr: np.ndarray, dtype_str: str, shape) -> torch.Tensor:
    arr = np.array(arr, order="C")         # writable; 0-d stays 0-d
    if str(arr.dtype) == dtype_str:
        return torch.from_numpy(arr)
    if dtype_str == "bfloat16" and arr.dtype == np.uint8:
        return torch.from_numpy(arr.reshape(-1)).view(torch.bfloat16) \
            .reshape(shape)
    raise TypeError(f"checkpoint: cannot read dtype {dtype_str!r} stored "
                    f"as {arr.dtype}")


def _flatten_with_paths(tree):
    return [("/".join(str(k) for k in path), leaf)
            for path, leaf in T.leaves_with_paths(tree)]


def save(directory: str, step: int, tree: Any, extra: Optional[dict] = None):
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "time": time.time(), "files": {},
                "extra": extra or {}}
    for name, leaf in _flatten_with_paths(tree):
        arr, dtype, shape = _to_disk(leaf)
        fname = name.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        with open(os.path.join(tmp, fname), "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        manifest["files"][name] = {"file": fname, "dtype": dtype,
                                   "shape": shape, "sha": digest}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic commit
    return final


def _verify(path: str) -> Optional[dict]:
    mf = os.path.join(path, "manifest.json")
    if not os.path.exists(mf):
        return None
    try:
        with open(mf) as f:
            manifest = json.load(f)
        for meta in manifest["files"].values():
            with open(os.path.join(path, meta["file"]), "rb") as f:
                if hashlib.sha256(f.read()).hexdigest()[:16] != meta["sha"]:
                    return None
        return manifest
    except (OSError, ValueError, KeyError, TypeError):
        return None


def _steps(directory: str):
    return sorted((int(m.group(1)) for d in os.listdir(directory)
                   if (m := re.fullmatch(r"step_(\d+)", d))), reverse=True)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    for s in _steps(directory):
        if _verify(os.path.join(directory, f"step_{s:08d}")):
            return s
    return None


def restore(directory: str, tree_like: Any, step: Optional[int] = None):
    """Restore into the structure of ``tree_like``, each leaf on the
    device of ``tree_like``'s leaf at its path; returns (tree, step)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    manifest = _verify(path)
    if manifest is None:
        raise IOError(f"checkpoint {path} failed verification")
    named = _flatten_with_paths(tree_like)
    missing = [n for n, _ in named if n not in manifest["files"]]
    if missing:
        raise KeyError(f"checkpoint missing leaves: {missing[:5]}...")
    flat = []
    for name, like in named:
        meta = manifest["files"][name]
        t = _from_disk(np.load(os.path.join(path, meta["file"])),
                       meta["dtype"], meta["shape"])
        flat.append(t.to(like.device) if isinstance(like, torch.Tensor)
                    else t)
    return T.unflatten(tree_like, flat), step


@dataclasses.dataclass
class CheckpointManager:
    """Every-N-steps saver with retention and auto-resume."""
    directory: str
    every: int = 100
    keep: int = 3

    def maybe_save(self, step: int, tree: Any, extra: Optional[dict] = None):
        if step % self.every:
            return None
        path = save(self.directory, step, tree, extra)
        self._gc()
        return path

    def _gc(self):
        if not os.path.isdir(self.directory):
            return
        for s in _steps(self.directory)[self.keep:]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def resume(self, tree_like: Any):
        step = latest_step(self.directory)
        if step is None:
            return None, 0
        return restore(self.directory, tree_like, step)
