"""The manifest and the files it names: every cell, configuration and
metric is found by name, and the manifest keeps to the benchmark's
contract; importing the benchmark loads no JAX module."""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
CELLS = [w["name"] for w in MANIFEST["workloads"]]
PER_LAYER = [m["name"] for m in MANIFEST["per_layer"]]


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_manifest_keys_and_names():
    assert set(MANIFEST) == KEYS
    assert MANIFEST["command"] == ["python3", "perfbench/run.py"]
    assert MANIFEST["paths"] == ["perfbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in MANIFEST[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("perfbench/")
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
        assert NAME.match(w["traffic"])
    for kind in ("end_to_end", "per_layer"):
        for m in MANIFEST[kind]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
            assert set(m["workloads"]) <= set(CELLS) if "workloads" in m \
                else True
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    """Its traffic file, configuration, driver and readers; it reports
    setup_s, another end-to-end metric and a per-layer metric, and each
    per-layer metric it lists moves an end-to-end metric it reports."""
    sys.path.insert(0, str(ROOT))
    from perfbench import harness as H
    wl = H.workload(cell)
    cfg = H.config(wl["config"])
    assert cfg["name"] == wl["config"]
    mod = H.driver(wl["driver"])
    assert hasattr(mod, "Cell") and hasattr(mod, "controls")
    e2e = [m["name"] for m in H.metrics_of(cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = H.metrics_of(cell, "per_layer")
    assert layer and all(m["moves"] in e2e for m in layer)
    for m in layer:
        assert callable(H.metric_reader(m["name"]))


@pytest.mark.parametrize("name", PER_LAYER)
def test_reader_finds_nothing_returns_nothing(name):
    """A reader with nothing to read returns None, never 0."""
    sys.path.insert(0, str(ROOT))
    from perfbench import harness as H
    empty = {"profile": {"kernels": {}, "busy_s": 0.0, "window_s": 0.0,
                         "turns": 0, "launches": {}, "result": {}},
             "window": {"turns": 0, "window_s": 1.0, "launches": {},
                        "spans": {}, "completed": 0},
             "facts": {}}
    assert H.metric_reader(name)(empty) is None


def test_reader_found_by_the_name_less_its_last_part():
    """A metric with no file of its own is read by the file named by its
    name less its last dotted part; a file of its own comes first, and a
    name with neither is refused."""
    sys.path.insert(0, str(ROOT))
    from perfbench import harness as H
    idle = H.metric_reader("device_idle.suite")
    assert idle.__globals__["__file__"].endswith("metrics/device_idle.py")
    assert H.metric_reader("device_idle.serve").__globals__["__file__"] \
        .endswith("metrics/device_idle.py")
    own = H.metric_reader("fused_sm_run.roofline")
    assert own.__globals__["__file__"].endswith(
        "metrics/fused_sm_run.roofline.py")
    assert H.metric_reader("device_idle.a.b").__globals__["__file__"] \
        .endswith("metrics/device_idle.py")
    with pytest.raises(FileNotFoundError):
        H.metric_reader("no_such_metric.suite")


def test_no_jax_module_after_importing_the_benchmark():
    """Every module of the benchmark, and the program's modules a run
    loads, imported in a fresh process: no module whose whole top-level
    name is jax, jaxlib, flax or repro (repro_torch is the program)."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in BENCH.rglob("*.py")
        if "tests" not in p.parts and "metrics" not in p.parts)
    code = (
        "import sys, importlib\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from perfbench import harness as H\n"
        "for m in H.manifest()['per_layer']: H.metric_reader(m['name'])\n"
        "import repro_torch.runtime.service, repro_torch.runtime.executor\n"
        "print(H.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_the_checkout(tmp_path):
    """In a directory holding only BENCHMARK.json and perfbench/, a run
    exits non-zero and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert "not in this checkout" in out.stderr
    assert '"correct"' not in out.stdout


def test_forbidden_names_are_matched_whole():
    sys.path.insert(0, str(ROOT))
    from perfbench import harness as H
    assert H.forbidden_modules(["repro_torch", "repro_torch.models",
                                "jaxtyping", "flaxen"]) == []
    assert H.forbidden_modules(["repro.core", "jax", "jaxlib.xla",
                                "flax"]) == ["flax", "jax", "jaxlib",
                                             "repro"]
