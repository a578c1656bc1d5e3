"""The PyTorch port stands alone: importing it pulls in neither ``jax`` nor
the JAX package ``repro``, no source line of it imports them, and its
entry points refuse to run on a missing card instead of carrying on on
the CPU."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch

SRC = Path(repro_torch.__file__).resolve().parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(SRC)], prefix="repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert {"repro_torch.runtime.executor", "repro_torch.launch.serve",
            "repro_torch.models.transformer", "repro_torch.kernels.ops",
            "repro_torch.kernels.flash_attention",
            "repro_torch.configs.qwen3_0p6b", "repro_torch.core.energy",
            "repro_torch.core.customize", "repro_torch.core.microblaze",
            "repro_torch.core.pipeline.reference",
            "repro_torch.configs.flexgrip", "repro_torch.obs",
            "repro_torch.obs.metrics", "repro_torch.obs.trace",
            "repro_torch.obs.profile", "repro_torch.runtime.policy",
            "repro_torch.runtime.stream", "repro_torch.runtime.server",
            "repro_torch.runtime.service", "repro_torch.runtime.loadgen",
            "repro_torch.launch.gpgpu_serve"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith(('jax.', 'jaxlib')) or k == 'repro' or "
            "k.startswith('repro.'))\n"
            "from repro_torch.kernels import _build\n"
            "print(','.join(bad), _build._lib is None)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=str(SRC.parent)))
    # no jax, no repro, and no kernel library built or loaded on import
    assert out.stdout.split() == ["True"], out.stdout


@pytest.mark.parametrize("path", sorted(SRC.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(SRC)))
def test_no_source_imports_jax_or_repro(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), \
                f"{path}: imports {name}"


def test_chip_smoke_imports_neither():
    tree = ast.parse((SRC.parents[1] / "chip_smoke.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module or ""])
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "repro")


def test_entry_points_raise_without_a_card(monkeypatch):
    """Default device is the card; with none, every entry point raises."""
    from repro_torch.core import machine, scheduler
    from repro_torch.core.programs import ALL
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = ALL["transpose"]
    code, (grid, bd) = mod.build(16), mod.launch(16)
    g0 = np.zeros(mod.make_gmem(np.random.default_rng(0), 16).shape[0],
                  np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scheduler.run_grid(code, grid, bd, g0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scheduler.execute([scheduler.LaunchSpec(code, grid, bd, g0)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        machine.run_block(code, bd, (0, 0), grid, g0)


def test_lm_entry_points_raise_without_a_card(monkeypatch):
    """The serving entry point and the decode state default to the card."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import api
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = configs.reduced(configs.get("qwen3-0.6b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--gen", "1", "--prompt-len", "4"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.decode_state(spec, 1, 8)


def test_serving_entry_points_raise_without_a_card(monkeypatch):
    """The serving runtime and its CLI default to the card too."""
    from repro_torch import runtime as rt
    from repro_torch.launch import gpgpu_serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (rt.RuntimeServer, rt.Runtime, rt.GmemPool):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpgpu_serve.main(["--no-compiled", "--launches", "1"])
    srv = rt.RuntimeServer(device="cpu")        # asked for the CPU: runs
    assert srv.device.type == "cpu" and srv.gmem_pool.device.type == "cpu"
