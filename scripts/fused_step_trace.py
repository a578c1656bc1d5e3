#!/usr/bin/env python3
"""Where one lockstep step of the fused SM kernel spends its clock cycles.

    python3 scripts/fused_step_trace.py [--n 256]

Needs one NVIDIA Hopper card and ``nvcc``.  It copies
``src/repro_torch/csrc/fused_sm.cu`` into ``build/trace/`` with a
``clock64()`` probe before every section comment of the step loop (the
full-line ``//`` comments indented one level inside it), before the
next step's fetch and before the step's closing barrier, builds that copy
with the port's ``nvcc`` flags, and runs the first dispatch group of each
paper program at ``n`` through it (``chip_smoke.fused_group``).  For the
first and the last warp of the group's first block it prints the mean
cycles from each probe to the next over the block's steps (the first 50,
or half of them, left out), labelled by the comment that follows the probe; the last
segment runs through the step barrier to the next step's top.  The probes
themselves add a few cycles each; the kernel in ``src/`` is not changed.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

MAX_STEPS, MAX_PROBES = 4096, 16
LOOP = "  for (int parity = 0;; parity ^= 1) {\n"
END = "    __syncthreads();\n  }\n"


def traced_source(src: str):
    """The kernel source with probes in its step loop, and their labels."""
    head, rest = src.split(LOOP, 1)
    body, tail = rest.split(END, 1)
    labels, out = ["top of step"], []
    probe = "    TRACE({});\n"
    for line in body.splitlines(keepends=True):
        m = re.match(r"    // (.*)", line)
        if m or line == "    fetch();\n":
            out.append(probe.format(len(labels)))
            labels.append(m.group(1).strip(" -") if m else "fetch")
        out.append(line)
    out.append(probe.format(len(labels)))
    labels.append("step barrier")
    assert len(labels) <= MAX_PROBES
    trace = (
        "__device__ long long g_trace[2][%d][%d];\n"
        "#define TRACE(k) if (blockIdx.x == 0 && lane == 0 && (w == 0 || "
        "w == W - 1) && tr_step < %d) g_trace[w ? 1 : 0][tr_step][k] = "
        "clock64()\n" % (MAX_STEPS, MAX_PROBES, MAX_STEPS))
    inc = '#include "alu_datapath.cuh"\n'
    head = head.replace(inc, inc + trace, 1)
    text = (head + "  int tr_step = -1;\n" + LOOP
            + "    ++tr_step;\n    TRACE(0);\n" + "".join(out) + END + tail
            + '\nextern "C" int trace_copy(void* out) {\n'
              "  return (int)cudaMemcpyFromSymbol(out, g_trace, "
              "sizeof(g_trace));\n}\n")
    return text, labels


def build(text: str) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    out = ROOT / "build" / "trace"
    out.mkdir(parents=True, exist_ok=True)
    for p in _build.CSRC.glob("*.cuh"):
        (out / p.name).write_text(p.read_text())
    (out / "fused_sm_trace.cu").write_text(text)
    lib = out / "libfused_sm_trace.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(lib), str(out / "fused_sm_trace.cu")], check=True,
                   capture_output=True)
    dll = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.fused_sm_run_launch.argtypes = [p] * 5 + [i] * 10 + [p]
    dll.trace_copy.argtypes = [p]
    return dll


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256)
    n = ap.parse_args().n
    if not torch.cuda.is_available():
        print("fused_step_trace.py: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.core.machine import MachineConfig
    from repro_torch.core.pipeline.fused import C_STEPS, N_CTR, predecode
    from repro_torch.core.programs import ALL
    text, labels = traced_source(
        (ROOT / "src/repro_torch/csrc/fused_sm.cu").read_text())
    lib = build(text)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; {smi}")
    cfg = MachineConfig()
    for name in sorted(ALL):
        code, geom, gmem, W = chip_smoke.fused_group(name, n)
        code_d, gmem_d = code.cuda(), gmem.cuda()
        rec = predecode(code_d, cfg)
        geom_d = torch.as_tensor(geom, device="cuda")
        P, G = gmem.shape
        gw = torch.zeros_like(gmem_d)
        ctr = torch.empty((P, N_CTR), dtype=torch.int32, device="cuda")
        rc = lib.fused_sm_run_launch(
            rec.data_ptr(), geom_d.data_ptr(), gmem_d.data_ptr(),
            gw.data_ptr(), ctr.data_ptr(), P, W, code.shape[1], G,
            cfg.n_regs, cfg.warp_stack_depth, cfg.smem_words,
            cfg.max_cycles, int(cfg.enable_mul), 3,
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        buf = np.zeros((2, MAX_STEPS, MAX_PROBES), np.int64)
        if rc or lib.trace_copy(buf.ctypes.data):
            raise RuntimeError(f"{name}: launch or trace copy failed")
        steps = min(int(ctr[0, C_STEPS]), MAX_STEPS)
        K = len(labels)
        for who, tag in ((0, "warp 0"), (1, f"warp {W - 1}")):
            t = buf[who, min(50, steps // 2):steps, :K]
            # probe k to k+1 within a step; the last to the next step's top
            per = np.diff(np.concatenate([t[:-1], t[1:, :1]], 1), 1).mean(0)
            print(f"{name} n={n}, {W} warps, {steps} steps, {tag}: "
                  f"{per.sum():.0f} cycles a step: " + "; ".join(
                      f"{labels[k]} {per[k]:.0f}" for k in range(K)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
