"""The paper's tables through the port, ``chip_smoke.paper_rows(32, "cpu")``,
against the same rows computed by the JAX package with the formulas of
``benchmarks/run.py`` (its table functions, run at ``BENCH_N=32``), row for
row; and against the values ``chip_smoke.py`` pins and holds the card to."""
import functools
import importlib.util
import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

TABLES = ("table2", "fig4", "fig5", "table3", "table5", "table6")


@functools.lru_cache(maxsize=None)
def _port_rows():
    return chip_smoke.paper_rows(32, "cpu", "torch")


@functools.lru_cache(maxsize=None)
def _jax_rows():
    """name -> derived of ``benchmarks/run.py``'s table functions at
    BENCH_N=32 (the module reads BENCH_N when it loads)."""
    old = os.environ.get("BENCH_N")
    os.environ["BENCH_N"] = "32"
    try:
        spec = importlib.util.spec_from_file_location(
            "bench_run_n32", ROOT / "benchmarks" / "run.py")
        run = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(run)
    finally:
        if old is None:
            del os.environ["BENCH_N"]
        else:
            os.environ["BENCH_N"] = old
    assert run.N == 32
    for table in (run.table2_area, run.fig4_speedup, run.fig5_table3_2sm,
                  run.table5_energy, run.table6_customize):
        table()
    return {r["name"]: r["derived"] for r in run._ROWS}


def _table(rows, table):
    return {k: v for k, v in rows.items() if k.startswith(table + "_")}


@pytest.mark.parametrize("table", TABLES)
def test_rows_match_the_jax_benchmark(table):
    rows, values = _port_rows()
    got, want = _table(rows, table), _table(_jax_rows(), table)
    assert got and got == want
    assert set(values) == set(rows)


def test_rows_equal_the_pinned_values():
    rows, values = _port_rows()
    for name, derived in chip_smoke.PINNED_N32.items():
        assert rows[name] == derived, name
    for name, variant in chip_smoke.PINNED_VARIANTS.items():
        assert values[f"table6_{name}"]["variant"] == variant
        assert rows[f"table6_{name}"].startswith(f"variant={variant};")
    # the numbers behind a row print as the row does
    v = values["fig4_matmul_8sp"]
    assert v["speedup"] == v["scalar_cycles"] / v["simt_cycles"]
    assert f"speedup={v['speedup']:.2f}" == rows["fig4_matmul_8sp"]
