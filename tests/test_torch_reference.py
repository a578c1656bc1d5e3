"""The port's ``"reference"`` backend — the seed one-warp-per-issue
interpreter, ``core/pipeline/reference.issue_one_warp`` — against the JAX
package's ``"reference"`` backend, bit for bit: final gmem and all six
counters for the five paper programs at n=32 (whole grids through the
executor, a dispatch group at a time), the three DSL-compiled kernels,
the seeded random straight-line and branchy programs of
tests/test_pipeline_equivalence.py and a binary whose fields leave their
ranges (one block).  Then the port's ``"reference"`` against its own
``"torch"`` and ``"cuda_fused"`` backends (the latter's plain version on
the CPU)."""
import functools

import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.compiler.kernels import COMPILED as JCOMPILED
from repro.core import machine as jm
from repro_torch.compiler.kernels import COMPILED
from repro_torch.core import machine as tm
from repro_torch.core import scheduler
from repro_torch.core.pipeline import block_loop, init_state
from repro_torch.core.programs import ALL
from test_torch_parity import (COUNTERS, assert_same, out_of_range_program,
                               random_branchy, random_straightline)

FIELDS = ("gmem", "cycles_per_block", "op_issues", "op_lanes", "stack_ops",
          "max_sp", "overflow")
JREF = jm.MachineConfig(execute_backend="reference")
REF = tm.MachineConfig(execute_backend="reference")
#: compiled kernel sizes of tests/test_torch_compiled.py
SIZES = {"histogram": 32, "scan": 64, "spmv": 128}


def _same_grid(got, want, tag):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{tag}: {f}")


def _launch(mod, n):
    return (mod.build(n), *mod.launch(n),
            mod.make_gmem(np.random.default_rng(11), n))


@functools.lru_cache(maxsize=None)
def _port(name, backend="reference"):
    code, grid, bd, g0 = _launch(ALL[name], 32)
    dg = scheduler.execute([scheduler.LaunchSpec(code, grid, bd, g0)],
                           n_sm=2, device="cpu",
                           cfg=tm.MachineConfig(execute_backend=backend))
    return dg.to_results()[0], dg.report(), dg.block_steps()


@pytest.mark.parametrize("name", sorted(ALL))
def test_paper_program_matches_jax_reference(name):
    mod = ALL[name]
    code, grid, bd, g0 = _launch(mod, 32)
    jdg = jrt.execute([jrt.LaunchSpec(code, grid, bd, g0.copy())], n_sm=2,
                      cfg=JREF)
    got, rep, _ = _port(name)
    _same_grid(got, jdg.to_results()[0], name)
    np.testing.assert_array_equal(rep.per_sm_cycles,
                                  jdg.report().per_sm_cycles)
    np.testing.assert_array_equal(got.gmem[mod.out_slice(32)],
                                  mod.oracle(g0, 32))


@pytest.mark.parametrize("name", sorted(COMPILED))
def test_compiled_kernel_matches_jax_reference(name):
    mod, n = COMPILED[name], SIZES[name]
    code, grid, bd, g0 = _launch(mod, n)
    jcode = JCOMPILED[name].build(n)
    np.testing.assert_array_equal(code, jcode)
    want = jrt.execute([jrt.LaunchSpec(jcode, grid, bd, g0.copy())], n_sm=2,
                       cfg=JREF).to_results()[0]
    got = scheduler.run_grid(code, grid, bd, g0.copy(), REF, n_sm=2,
                             device="cpu")
    _same_grid(got, want, name)
    np.testing.assert_array_equal(got.gmem[mod.out_slice(n)],
                                  mod.oracle(g0, n))


def _blocks():
    """(tag, code, block_dim, gmem): the seeded programs of
    tests/test_pipeline_equivalence.py and the out-of-range binary."""
    out = []
    for seed in range(6):
        rng = np.random.default_rng(seed)
        code = random_straightline(rng)
        out.append((f"straight{seed}", code, 40,
                    rng.integers(-1000, 1000, 40 * 8, dtype=np.int32)))
    for seed in range(6):
        rng = np.random.default_rng(seed + 100)
        out.append((f"branchy{seed}", random_branchy(rng), 64,
                    np.zeros(64, np.int32)))
    out.append(("out_of_range", out_of_range_program(), 40,
                np.zeros(16 * 40 + 64, np.int32)))
    return out


def _block(m, cfg, code, bd, gmem, **kw):
    gm, gw, c = m.run_block(code, bd, (0, 0), (1, 1), gmem, cfg, **kw)
    return (np.asarray(gm), np.asarray(gw),
            {f: np.asarray(getattr(c, f)) for f in COUNTERS})


@pytest.mark.parametrize("tag,code,bd,gmem", _blocks(),
                         ids=[b[0] for b in _blocks()])
def test_program_block_matches_jax_reference(tag, code, bd, gmem):
    want = _block(jm, JREF, code, bd, gmem)
    assert_same(want, _block(tm, REF, code, bd, gmem, device="cpu"), tag)


@pytest.mark.parametrize("backend", ["torch", "cuda_fused"])
@pytest.mark.parametrize("name", sorted(ALL))
def test_reference_matches_port_backends(name, backend):
    ref, rep, _ = _port(name)
    got, grep, _ = _port(name, backend)
    _same_grid(got, ref, f"{name} {backend}")
    np.testing.assert_array_equal(grep.per_sm_cycles, rep.per_sm_cycles)


def test_steps_count_issues():
    """Under ``"reference"`` a step is one warp's issue: on a program
    without divergence (so no TAKEN pop, which issues no opcode) the steps
    are the opcode issues, and no step is counted as a store step."""
    code, grid, bd, g0 = _launch(ALL["transpose"], 32)
    st0 = init_state(REF, 8, 256, torch.as_tensor(g0))
    st, steps, store_steps = block_loop(REF, torch.as_tensor(code), bd,
                                        (0, 0), grid, st0)
    assert int(steps) == int(st.counters.op_issues.sum()) > 0
    assert int(store_steps) == 0
