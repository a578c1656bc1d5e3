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
    assert "repro_torch.runtime.executor" in mods
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

