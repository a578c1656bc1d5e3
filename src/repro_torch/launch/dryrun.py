"""Dry-run of the production mesh: trace one (arch x shape x mesh) cell
and count what it costs (counterpart of ``repro.launch.dryrun``).

The JAX dry-run builds the production mesh from 512 placeholder host
devices, compiles the sharded step against ``ShapeDtypeStruct`` inputs and
reads XLA's memory and cost analyses.  Here :func:`dryrun_cell` builds
the production ``DeviceMesh`` over torch's ``"fake"`` process group (256
or 512 ranks in one process; collectives do nothing) and runs the
sharded train step, or the prefill or decode serve step, once on fake
tensors (``FakeTensorMode``: shapes and dtypes, no storage), this process
being rank 0.  Attention is the port's plain version, as the JAX dry-run
lowers plain ``jnp``.  ``launch.hloanalysis.analyze`` counts the step per
chip; memory is the argument bytes of the local shards, the output bytes,
and the peak of live temporaries.  The roofline terms use the H100 SXM's
datasheet figures (per card: bf16 dense 989 TFLOP/s, HBM3 3.35 TB/s,
NVLink 450 GB/s a direction; the card measured is an NVIDIA H100 80GB
HBM3 at 700.00 W), which replace the JAX module's TPU v5e constants.

The fake group is one per process: a cell creates it and destroys it on
the way out, and refuses to run beside another process group (run it in
a subprocess there, as the CLI does for each cell).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out build/dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

from .. import tree as T
from ..configs import ARCH_IDS, SHAPES, get
from ..models import api
from ..optim import OptConfig, opt_init
from . import hloanalysis
from . import mesh as M
from .steps import build_serve_step, build_train_step, shardings_for

#: NVIDIA H100 SXM datasheet figures, per card
PEAK_FLOPS = 989e12        # bf16 dense FLOP/s
HBM_BW = 3.35e12           # HBM3 bytes/s
ICI_BW = 450e9             # NVLink bytes/s a direction
HARDWARE = ("NVIDIA H100 SXM datasheet: bf16 989e12 FLOP/s dense, HBM "
            "3.35e12 B/s, NVLink 450e9 B/s a direction (card measured: "
            "NVIDIA H100 80GB HBM3, 700.00 W)")


def _flash_traffic_model(spec, seq, batch, kind) -> float:
    """Analytical HBM bytes of attention under a flash kernel (q/k/v/o
    streamed once; the logits stay on chip), the JAX module's formula with
    bf16 bytes.  Train ~3.3 passes (forward + the backward's re-reads)."""
    fam = spec.family
    cfg = spec.cfg
    passes = 3.3 if kind == "train" else 1.0
    bt = 2  # bf16
    if fam in ("dense", "moe"):
        L, H, K, dh = cfg.n_layers, cfg.n_heads, cfg.n_kv, cfg.dh
    elif fam == "vlm":
        L, H, K, dh = (cfg.lm.n_layers, cfg.lm.n_heads, cfg.lm.n_kv,
                       cfg.lm.dh)
    elif fam == "hybrid":
        L, H, K, dh = (cfg.n_apps, cfg.n_heads, cfg.n_kv,
                       cfg.d_model // cfg.n_heads)
    elif fam == "audio":
        dh = cfg.d_model // cfg.n_heads
        enc = cfg.n_layers * (2 * cfg.enc_len * cfg.n_heads * dh +
                              2 * cfg.enc_len * cfg.n_kv * dh)
        dec = cfg.n_layers * (2 * seq * cfg.n_heads * dh +
                              2 * seq * cfg.n_kv * dh +
                              2 * cfg.enc_len * cfg.n_kv * dh)
        return batch * (enc + dec) * bt * passes
    else:
        return 0.0
    per_layer = 2 * seq * H * dh + 2 * seq * K * dh
    return batch * L * per_layer * bt * passes


def _local_bytes(tree) -> int:
    return sum(int(torch.Size(M.local_shape(t)).numel()) * t.element_size()
               for t in T.leaves(tree) if isinstance(t, torch.Tensor))


def _variant_spec(spec, variant: Dict):
    """``variant``'s config-field overrides applied to ``spec``, as the JAX
    dry-run applies them (``moe_dispatch`` and ``lm.<field>`` included)."""
    cfg = spec.cfg
    fields = {f.name for f in dataclasses.fields(type(cfg))}
    direct = {k: v for k, v in variant.items() if k in fields}
    if direct:
        cfg = dataclasses.replace(cfg, **direct)
    if "moe_dispatch" in variant and getattr(cfg, "moe", None):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=variant["moe_dispatch"]))
    if hasattr(cfg, "lm") and any(k.startswith("lm.") for k in variant):
        lmo = {k[3:]: v for k, v in variant.items() if k.startswith("lm.")}
        cfg = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, **lmo))
    return dataclasses.replace(spec, cfg=cfg)


def dryrun_cell(arch: str, shape_name: str, multi_pod: bool,
                opt_mode: str = "auto", donate: bool = True,
                variant: Optional[Dict] = None) -> Dict:
    """Trace one (arch, shape, mesh) cell; returns the record, with the
    JAX record's keys (``None`` where the port has no counterpart:
    ``builtin_flops``, ``builtin_bytes``, ``generated_code_bytes``).

    ``variant``: config-field overrides (e.g. ``{"attn_impl":
    "chunked"}``), and ``"profile"`` and ``"accum"`` for the step."""
    spec = get(arch)
    variant = dict(variant or {})
    profile = variant.pop("profile", "tp")
    accum = variant.pop("accum", 1)
    if variant:
        spec = _variant_spec(spec, variant)
    mesh_name = "multi" if multi_pod else "single"
    reason = spec.skip_reason(shape_name)
    if reason:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": reason}
    if dist.is_initialized():
        raise RuntimeError("dryrun_cell: a process group exists; run the "
                           "cell in a subprocess")
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore
    pmesh = M.make_production_mesh(multi_pod=multi_pod)
    n_chips = math.prod(pmesh.shape.values())
    seq, batch, kind = SHAPES[shape_name]
    if opt_mode == "auto":
        opt_mode = "adamw_lite" if spec.cfg.param_count() > 2e10 else "adamw"
    t0 = time.time()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_chips)
    try:
        dm = M.device_mesh(pmesh, "cpu")
        with FakeTensorMode():
            def fake(meta):
                return torch.zeros(meta.shape, dtype=meta.dtype)

            pshapes = api.param_shapes(spec)
            params = T.tree_map(fake, pshapes)
            if kind == "train":
                opt_cfg = OptConfig(mode=opt_mode)
                step = build_train_step(spec, opt_cfg, accum, mesh=dm,
                                        donate=donate, profile=profile)
                psh, osh = shardings_for(spec, dm, opt_cfg)
                bspec = api.input_specs(spec, shape_name)
                args = (M.place(params, psh),
                        M.place(opt_init(params, opt_cfg), osh),
                        M.place(T.tree_map(fake, bspec),
                                T.tree_map(lambda t: M.NamedSharding(
                                    dm, M.batch_spec("", tuple(t.shape),
                                                     pmesh)), bspec)))
            else:  # prefill (forward + KV fill, (B, S) tokens) or decode
                step = build_serve_step(spec, mesh=dm, donate=donate,
                                        profile=profile)
                state = api.decode_state(spec, batch, seq, device="meta")
                n_tok = seq if kind == "prefill" else 1
                if spec.family == "vlm" and kind == "prefill":
                    n_tok = seq - spec.cfg.n_patches
                tok = torch.zeros((batch, n_tok), dtype=torch.int32)
                ssh = M.sharding_tree(state, dm, M.decode_state_spec)
                args = (M.place(params, M.param_sharding_tree(pshapes, dm)),
                        M.place(T.tree_map(fake, state), ssh),
                        M.place(tok, M.NamedSharding(
                            dm, M.batch_spec("", tuple(tok.shape), pmesh))),
                        0 if kind == "prefill" else seq - 1)
            arg_bytes = _local_bytes(args[:3])
            cost = hloanalysis.analyze(step, *args)
            out_bytes = _local_bytes(cost.result)
    finally:
        dist.destroy_process_group()

    coll = dict(cost.coll_by_type or {})
    coll["count"] = cost.coll_count
    flops = float(cost.flops)
    bytes_accessed = float(cost.bytes)
    coll_total = float(cost.collective_bytes)
    compute_t = flops / PEAK_FLOPS
    memory_t = bytes_accessed / HBM_BW
    collective_t = coll_total / ICI_BW
    # kernel-adjusted memory: the attention region's bytes swapped for a
    # flash kernel's streamed q/k/v/o traffic
    flash_bytes = _flash_traffic_model(spec, seq, batch, kind) / n_chips
    adj_bytes = max(bytes_accessed - float(cost.scope_bytes), 0.0) + \
        flash_bytes
    memory_t_flash = adj_bytes / HBM_BW
    collective_t_bf16 = float(cost.collective_bytes_bf16) / ICI_BW

    # useful model FLOPs: 6 * active params * tokens (train) or 2 * active
    # params * tokens (serve)
    n_active = spec.cfg.active_param_count()
    tokens = batch * (seq if kind in ("train", "prefill") else 1)
    mult = 6 if kind == "train" else 2
    model_flops_per_chip = mult * n_active * tokens / n_chips

    def frac(*terms):
        worst = max(terms)
        return model_flops_per_chip / PEAK_FLOPS / worst if worst > 0 else 0

    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok", "kind": kind,
        "n_chips": n_chips,
        "seq": seq, "batch": batch,
        "opt_mode": opt_mode if kind in ("train", "prefill") else None,
        "params": spec.cfg.param_count(),
        "active_params": n_active,
        "hlo_flops_per_chip": flops,
        "hlo_bytes_per_chip": bytes_accessed,
        "builtin_flops": None,
        "builtin_bytes": None,
        "transcendentals_per_chip": float(cost.transcendental),
        "collective_bytes_per_chip": coll_total,
        "collectives": coll,
        "compute_t": compute_t,
        "memory_t": memory_t,
        "attn_scope_bytes": float(cost.scope_bytes),
        "flash_model_bytes": flash_bytes,
        "memory_t_flash": memory_t_flash,
        "collective_t": collective_t,
        "collective_t_bf16": collective_t_bf16,
        "dominant": max((("compute", compute_t), ("memory", memory_t),
                         ("collective", collective_t)),
                        key=lambda kv: kv[1])[0],
        "model_flops_per_chip": model_flops_per_chip,
        "useful_flop_ratio": (model_flops_per_chip / flops) if flops else 0,
        "roofline_fraction": frac(compute_t, memory_t, collective_t),
        "roofline_fraction_flash": frac(compute_t, memory_t_flash,
                                        collective_t),
        "roofline_fraction_adj": frac(compute_t, memory_t_flash,
                                      collective_t_bf16),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": float(cost.peak_bytes),
            "generated_code_bytes": None,
        },
        "variant": dict(variant, profile=profile, accum=accum),
        "hardware": HARDWARE,
        "compile_s": round(time.time() - t0, 1),
    }


def _cell_in_subprocess(arch, shape, multi_pod, opt, donate, variant):
    """One cell in a fresh interpreter (one fake group per process); its
    record, or an error record."""
    code = ("import json, sys; from repro_torch.launch.dryrun import "
            "dryrun_cell; print('RECORD ' + json.dumps(dryrun_cell("
            "*json.loads(sys.argv[1]))))")
    args = json.dumps([arch, shape, multi_pod, opt, donate, variant])
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    run = subprocess.run([sys.executable, "-c", code, args], env=env,
                         capture_output=True, text=True)
    for line in run.stdout.splitlines():
        if line.startswith("RECORD "):
            return json.loads(line[len("RECORD "):])
    return {"arch": arch, "shape": shape,
            "mesh": "multi" if multi_pod else "single", "status": "error",
            "error": (run.stderr or run.stdout)[-2000:]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--opt", default="auto")
    ap.add_argument("--no-donate", action="store_true")
    ap.add_argument("--variant", default=None,
                    help="JSON config overrides, e.g. "
                         "'{\"profile\": \"seq\", \"remat\": \"full\"}'")
    args = ap.parse_args(argv)
    variant = json.loads(args.variant) if args.variant else None

    archs = ([a for a in ARCH_IDS if a != "flexgrip"]
             if (args.all or not args.arch) else [args.arch])
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch.replace('-', '_').replace('.', 'p')}__" \
                      f"{shape}__{'multi' if mp else 'single'}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[skip-cached] {tag}")
                    continue
                print(f"[dryrun] {tag} ...", flush=True)
                rec = _cell_in_subprocess(arch, shape, mp, args.opt,
                                          not args.no_donate, variant)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                extra = ""
                if rec["status"] == "ok":
                    extra = (f" dominant={rec['dominant']}"
                             f" roofline={rec['roofline_fraction']:.3f}"
                             f" trace={rec['compile_s']}s")
                print(f"  -> {rec['status']}{extra}", flush=True)
                print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
