"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources compile at first use with ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into one shared library with
a plain C interface, loaded through ``ctypes``: no PyTorch headers, so a
build takes seconds, not minutes.  Each ``.cu`` compiles in its own
``nvcc`` process, all started together, then one link.  The library lands
in ``build/kernels/`` at the repository root (``REPRO_TORCH_BUILD_DIR``
overrides it), named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads at once.

Nothing here runs at import time: the CPU tests import every module of
the port on a host without ``nvcc``.  A failed build raises; no caller
falls back to a plain version on CUDA tensors.

``LAUNCHES`` counts kernel launches by name.  Each wrapper adds one where
it launches its kernel and nowhere else, so a run can show that its path
went through the kernels.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel name -> launches since the last ``LAUNCHES.clear()``
LAUNCHES: collections.Counter = collections.Counter()

#: what the last build did: seconds, library path, ptxas report
BUILD_INFO: dict = {}

_lib: Optional[ctypes.CDLL] = None


def _build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "build only on a host with the CUDA toolkit")
    return found


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    deps = srcs + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in deps:
        h.update(p.name.encode() + p.read_bytes())
    return srcs, h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources if no library of their hash exists; return it."""
    srcs, key = _sources()
    out_dir = _build_dir()
    lib_path = out_dir / f"librepro_torch_{key}.so"
    if lib_path.exists():
        BUILD_INFO.update(seconds=0.0, path=str(lib_path), cached=True,
                          ptxas="")
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tag = f"{key}.{os.getpid()}"
    objs = [out_dir / f"{s.stem}.{tag}.o" for s in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for s, o in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    for s, p, log in zip(srcs, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {s.name}:\n{log}")
    tmp = out_dir / f"librepro_torch_{tag}.so"
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    for o in objs:
        o.unlink()
    BUILD_INFO.update(seconds=time.perf_counter() - t0, path=str(lib_path),
                      cached=False, ptxas="".join(logs))
    return lib_path


def load() -> ctypes.CDLL:
    """The kernel library, built on first use; argument types declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.simt_alu_launch.argtypes = [p] * 9 + [i, i, i, i, p]
        lib.simt_alu_launch.restype = i
        lib.fused_sm_run_launch.argtypes = [p] * 6 + [i] * 13 + [p]
        lib.fused_sm_run_launch.restype = i
        lib.fused_sm_smem_bytes.argtypes = [i] * 5
        lib.fused_sm_smem_bytes.restype = ctypes.c_long
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise on a launch that CUDA refused (the C entry returns
    ``cudaGetLastError()`` right after the launch)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def stream_ptr(tensor) -> int:
    import torch
    return torch.cuda.current_stream(tensor.device).cuda_stream
