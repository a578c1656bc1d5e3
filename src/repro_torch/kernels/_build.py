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

Each load of the library adds one to ``obs.jitprof.LIBRARY_LOADS``, so
build attribution charges it to the call that needed it.

``LAUNCHES`` counts kernel launches by name.  Each wrapper adds one where
it launches its kernel and nowhere else, so a run can show that its path
went through the kernels.  ``VARIANTS`` counts the same launches by
(name, variant) for the kernels that come in variants (flash attention's
``"tc"``/``"simt"``, matmul's four), so a run can also show which one ran.
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

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from ..obs.jitprof import LIBRARY_LOADS

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel name -> launches since the last ``LAUNCHES.clear()``
LAUNCHES: collections.Counter = collections.Counter()

#: (kernel name, variant) -> launches since the last ``VARIANTS.clear()``
VARIANTS: collections.Counter = collections.Counter()

def observe(name: str, *shape) -> None:
    """Tell each active dispatch mode that counts kernels (``launch.
    hloanalysis.CostMode``, its ``kernel`` method) of a flash forward or
    backward launch, ``shape`` being ``(B, H, KH, Sq, Sk, dh, causal,
    itemsize)``: the launch is no dispatcher operation, so no mode sees
    it otherwise."""
    for mode in _get_current_dispatch_mode_stack():
        if getattr(mode, "counts_kernels", False):
            mode.kernel(name, *shape)


#: dtype codes of the C entries that take float32 or bfloat16 tensors
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: what the last build did: seconds, library path, ptxas report (kept
#: beside the library as ``.ptxas`` and read back when it is cached)
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
    report = lib_path.with_suffix(".ptxas")
    if lib_path.exists():
        BUILD_INFO.update(seconds=0.0, path=str(lib_path), cached=True,
                          ptxas=report.read_text() if report.exists()
                          else "")
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
    # the report lands before the library, so a cached library has one
    tmp_report = out_dir / f"librepro_torch_{tag}.ptxas"
    tmp_report.write_text("".join(logs))
    os.replace(tmp_report, report)
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
        lib.simt_alu_launch.argtypes = [p] * 8 + [ctypes.c_long, i, i, i, p]
        lib.simt_alu_launch.restype = i
        lib.fused_sm_run_launch.argtypes = [p] * 5 + [i] * 10 + [p]
        lib.fused_sm_run_launch.restype = i
        lib.fused_sm_smem_bytes.argtypes = [i] * 5
        lib.fused_sm_smem_bytes.restype = ctypes.c_long
        lib.flash_attention_launch.argtypes = (
            [p] * 5 + [ctypes.POINTER(ctypes.c_longlong)] + [i] * 6
            + [ctypes.c_float, i, i, i, p])
        lib.flash_attention_launch.restype = i
        lib.flash_attention_bwd_launch.argtypes = (
            [p] * 10 + [ctypes.POINTER(ctypes.c_longlong)] + [i] * 6
            + [ctypes.c_float, i, i, i, i, p, p])
        lib.flash_attention_bwd_launch.restype = i
        lib.matmul_launch.argtypes = [p] * 3 + [i] * 5 + [p]
        lib.matmul_launch.restype = i
        _lib = lib
        LIBRARY_LOADS.inc()
    return _lib


def check(rc: int, what: str) -> None:
    """Raise on a launch that CUDA refused (the C entry returns
    ``cudaGetLastError()`` right after the launch)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def stream_ptr(tensor) -> int:
    """The CUDA stream a kernel on ``tensor`` launches on: PyTorch's
    current stream on the tensor's device, from the raw getter PyTorch's
    own generated kernels call (``current_stream()`` builds a
    ``torch.cuda.Stream`` object each call, several microseconds)."""
    return torch._C._cuda_getCurrentRawStream(tensor.get_device())
