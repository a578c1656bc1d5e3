"""The port's kernel compiler (``repro_torch.compiler``) against the JAX
package's (``repro.compiler``) on the CPU.

Every DSL kernel of tests/test_compiler.py is defined once here and
compiled by both compilers: the binary, the listing, the IR before and
after the passes, the pass log and the instruction count are identical,
optimized and naive, with 16 and with 4 registers; a kernel that one
compiler rejects the other rejects with the same error and message.  The
kernels that run go through the port's executor on the CPU (the port's
binary) and the JAX executor (the JAX binary): gmem and every counter are
equal, and equal to what the kernel computes.  The ``gpgpu_compile`` CLI
prints what the JAX CLI prints, apart from the milliseconds."""
import itertools
import re

import numpy as np
import pytest
import torch

from repro import compiler as jcomp
from repro.compiler import dsl as jdsl
from repro.compiler import ir as jir
from repro import runtime as jrt
from repro.core.machine import MachineConfig as JaxConfig
from repro.launch import gpgpu_compile as jcli
from repro_torch import compiler as tcomp
from repro_torch.compiler import dsl, passes
from repro_torch.compiler import ir as tir
from repro_torch.core import isa, scheduler
from repro_torch.launch import gpgpu_compile as tcli

JAX = JaxConfig(execute_backend="jnp")
FIELDS = ("gmem", "cycles_per_block", "op_issues", "op_lanes", "stack_ops",
          "max_sp", "overflow")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: each compiler's name counters: the IR's value and block ids, and the
#: tracer's variable and loop-index numbers
COUNTERS = ((tir, "_ids"), (dsl.Var, "_counter"), (dsl._For, "_counter"),
            (jir, "_ids"), (jdsl.Var, "_counter"), (jdsl._For, "_counter"))


@pytest.fixture(autouse=True)
def _restore_counters(monkeypatch):
    """Leave both compilers' name counters as the test found them."""
    for owner, attr in COUNTERS:
        monkeypatch.setattr(owner, attr, getattr(owner, attr))


# ------------------------------------------- the kernels of test_compiler

def k_trace(k):
    t = k.tid
    k.gmem[t + 32] = k.gmem[t] + 1


def k_uniform_sync(k):
    with k.if_(k.blockIdx.x < 4):
        k.syncthreads()
    k.gmem[k.tid] = 1


def k_if_else(k, n):
    t = k.tid
    v = k.var(0)
    with k.if_(t < n):
        v.set(t + 100)
    with k.else_():
        v.set(t - 100)
    k.gmem[64 + t] = v


def k_cmp(k):
    t = k.tid
    k.gmem[32 + t] = (t > 4) + (t == 2) * 10


def k_select(k):
    t = k.tid
    k.gmem[32 + t] = k.select(t < 10, k.min_(t, 5), k.max_(t, 20))


def k_pow2_div(k):
    t = k.tid
    k.gmem[32 + t] = (t // 8) * 100 + t % 8


def k_fold(k):
    t = k.tid
    c = (t * 0 + 7) * 8 - 6
    k.gmem[t] = c


def k_cse(k):
    t = k.tid
    a = k.blockIdx.x * 64 + t
    b = k.blockIdx.x * 64 + t
    k.gmem[a + 32] = k.gmem[b] + 1


def k_sum(k, n):
    acc = k.var(0)
    with k.for_(0, n) as i:
        acc.set(acc + k.gmem[i])
    k.gmem[n + k.tid] = acc


def k_dce(k):
    t = k.tid
    dead = k.gmem[t + 7]
    del dead
    k.gmem[32 + t] = t


def k_seeded(k, n):
    t = k.tid
    acc = k.var(0)
    with k.for_(0, n) as i:
        v = k.gmem[i * 4 % 64]
        with k.if_((v & 1) == 0):
            acc.set(acc + v * 3)
        with k.else_():
            acc.set(acc - (v >> 1))
    with k.if_(t < n):
        k.gmem[64 + t] = acc + t


def k_swap(k, n):
    a = k.var(1)
    b = k.var(1000)
    with k.for_(0, n) as i:
        tmp_a = a.get()
        a.set(b.get() + 0)
        b.set(tmp_a + 1)
    t = k.tid
    k.gmem[t] = a
    k.gmem[32 + t] = b


def bad_one_path(k):
    with k.if_(k.tid < 4):
        w = k.var(5)
    k.gmem[0] = w


def bad_divergent_sync(k):
    with k.if_(k.tid < 4):
        k.syncthreads()


def bad_divergent_for(k):
    with k.for_(0, k.tid) as i:
        k.gmem[i] = 0


def bad_else(k):
    k.gmem[0] = 1
    with k.else_():
        pass


def bad_div3(k):
    k.gmem[0] = k.tid // 3


def bad_div0(k):
    k.gmem[0] = (k.tid * 0 + 8) // 0


def bad_zero_step(k):
    with k.for_(0, 10, 0) as i:
        k.gmem[i] = 0


def bad_down_step(k):
    with k.for_(10, 0, -1) as i:
        k.gmem[i] = 0


def bad_folded_zero_step(k):
    with k.for_(0, 4, k.ntid - k.ntid) as i:
        k.gmem[i] = 0


def bad_hog(k):
    t = k.tid
    vals = [k.gmem[t + i] for i in range(20)]
    total = k.var(0)
    for v in reversed(vals):
        total.set(total + v)
    k.gmem[64 + t] = total


def bad_preds(k):
    t = k.tid
    cmps = [(t < i) for i in range(1, 7)]
    acc = k.var(0)
    for c in reversed(cmps):
        acc.set(acc + c)
    k.gmem[32 + t] = acc


#: name -> (kernel, params, CompilerConfig fields)
CASES = {
    "trace": (k_trace, None, {}),
    "uniform_sync": (k_uniform_sync, None, {}),
    "if_else": (k_if_else, {"n": 7}, {}),
    "cmp": (k_cmp, None, {}),
    "select": (k_select, None, {}),
    "pow2_div": (k_pow2_div, None, {}),
    "fold": (k_fold, None, {}),
    "cse": (k_cse, None, {}),
    "unroll_small": (k_sum, {"n": 2}, {}),
    "unroll_big": (k_sum, {"n": 32}, {}),
    "dce": (k_dce, None, {}),
    "seeded": (k_seeded, {"n": 8}, {}),
    "swap0": (k_swap, {"n": 0}, {"unroll_limit": 0}),
    "swap3": (k_swap, {"n": 3}, {"unroll_limit": 0}),
    "swap4": (k_swap, {"n": 4}, {"unroll_limit": 0}),
    "swap3_unrolled": (k_swap, {"n": 3}, {}),
    "one_path": (bad_one_path, None, {}),
    "divergent_sync": (bad_divergent_sync, None, {}),
    "divergent_for": (bad_divergent_for, None, {}),
    "else_alone": (bad_else, None, {}),
    "div3": (bad_div3, None, {}),
    "div0": (bad_div0, None, {}),
    "zero_step": (bad_zero_step, None, {}),
    "down_step": (bad_down_step, None, {}),
    "folded_zero_step": (bad_folded_zero_step, None, {}),
    "hog": (bad_hog, None, {}),
    "preds": (bad_preds, None, {}),
}

#: the rejections tests/test_compiler.py pins: name -> (error, message)
REJECTED = {
    "one_path": ("CompileError", "read before any assignment"),
    "divergent_sync": ("CompileError", "deadlock the barrier"),
    "divergent_for": ("CompileError", "warp-uniform"),
    "else_alone": ("CompileError", "immediately follow"),
    "div3": ("CompileError", "power-of-two"),
    "div0": ("CompileError", ""),
    "zero_step": ("CompileError", "step must be positive"),
    "down_step": ("CompileError", "step must be positive"),
    "folded_zero_step": ("CompileError", "folded to 0"),
    "hog": ("RegAllocError", "n_regs=16"),
    "preds": ("RegAllocError", "predicate registers"),
}


def fresh_ids(comp):
    """Number ``comp``'s IR values, blocks, variables and loop indices from
    0 again.  Each comes from one counter per process, so two compilers
    print the same names only from the same start."""
    ir_mod, dsl_mod = (tir, dsl) if comp is tcomp else (jir, jdsl)
    ir_mod._ids = itertools.count()
    dsl_mod.Var._counter = dsl_mod._For._counter = 0


def outcome(comp, case, optimize=True, n_regs=16):
    """What ``comp.compile_kernel`` makes of ``case``: every field of the
    compiled kernel, or the error's type and message."""
    fn, params, cfg = CASES[case]
    config = comp.CompilerConfig(n_regs=n_regs, **cfg)
    fresh_ids(comp)
    try:
        ck = comp.compile_kernel(fn, params, optimize=optimize,
                                 config=config)
    except comp.CompileError as e:
        return type(e).__name__, str(e)
    return ("ok", ck.name, ck.code.dtype, ck.code.shape, ck.code.tobytes(),
            ck.n_instr, ck.listing, ck.ir_before, ck.ir_after, ck.pass_log)


@pytest.mark.parametrize("n_regs", [16, 4])
@pytest.mark.parametrize("optimize", [True, False], ids=["opt", "naive"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_compile_equals_jax(case, optimize, n_regs):
    assert outcome(tcomp, case, optimize, n_regs) == \
        outcome(jcomp, case, optimize, n_regs)


@pytest.mark.parametrize("case", sorted(REJECTED))
def test_rejections_keep_their_messages(case):
    err, match = REJECTED[case]
    for optimize in (True, False):
        got = outcome(tcomp, case, optimize)
        if case == "folded_zero_step" and not optimize:
            continue                # only the pass pipeline sees it fold
        assert got[0] == err and match in got[1], (optimize, got)


def test_trace_and_pass_log():
    fn = dsl.trace(k_trace)
    text = str(fn)
    assert "ldg" in text and "stg" in text and "func @k_trace" in text
    ck = tcomp.compile_kernel(k_seeded, {"n": 8})
    names = [n for n, _ in ck.pass_log]
    assert names[0] == "trace" and set(names[1:]) <= set(passes.PASSES)
    assert all(c > 0 for _, c in ck.pass_log)
    # EXIT padding through the port's registry, as the JAX package pads
    assert ck.finish() is ck.code
    np.testing.assert_array_equal(
        ck.finish(96), jcomp.compile_kernel(k_seeded, {"n": 8}).finish(96))


def test_numpy_wraparound_in_folding():
    """Folding and immediates wrap at 32 bits as numpy int32 does."""
    def k_wrap(k):
        k.gmem[k.tid] = (k.tid * 0 + 2 ** 30) * 4 + 2 ** 31 - 1
    for optimize in (True, False):
        fresh_ids(tcomp)
        a = tcomp.compile_kernel(k_wrap, optimize=optimize)
        fresh_ids(jcomp)
        b = jcomp.compile_kernel(k_wrap, optimize=optimize)
        np.testing.assert_array_equal(a.code, b.code)
        assert a.ir_after == b.ir_after


# ------------------------------------------------------------ running them

def _ops(code):
    return {int(o) for o in code[:, isa.F_OP]}


def run_both(case, gmem, optimize=True, n_regs=16):
    """The port's binary through the port's executor on the CPU and the JAX
    binary through ``repro.runtime.execute``: every field equal.  Returns
    the port's result and binary."""
    fn, params, cfg = CASES[case]
    t = tcomp.compile_kernel(fn, params, optimize=optimize,
                             config=tcomp.CompilerConfig(n_regs=n_regs, **cfg))
    j = jcomp.compile_kernel(fn, params, optimize=optimize,
                             config=jcomp.CompilerConfig(n_regs=n_regs, **cfg))
    g = np.asarray(gmem, np.int32)
    got = scheduler.run_grid(t.code, (1, 1), (32, 1), g.copy(), device="cpu")
    want = jrt.execute([jrt.LaunchSpec(j.code, (1, 1), (32, 1), g.copy())],
                       cfg=JAX).to_results()[0]
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{case}: {f}")
    return got, t.code


T = np.arange(32)


@pytest.mark.parametrize("optimize", [True, False], ids=["opt", "naive"])
def test_if_else_cmp_select_div_run_as_jax(optimize):
    res, _ = run_both("if_else", np.zeros(96), optimize)
    np.testing.assert_array_equal(res.gmem[64:96],
                                  np.where(T < 7, T + 100, T - 100))
    res, _ = run_both("cmp", np.zeros(64), optimize)
    np.testing.assert_array_equal(res.gmem[32:],
                                  (T > 4).astype(int) + (T == 2) * 10)
    res, _ = run_both("select", np.zeros(64), optimize)
    np.testing.assert_array_equal(
        res.gmem[32:], np.where(T < 10, np.minimum(T, 5), np.maximum(T, 20)))
    res, _ = run_both("pow2_div", np.zeros(64), optimize)
    np.testing.assert_array_equal(res.gmem[32:], (T // 8) * 100 + T % 8)


def test_fold_unroll_dce_run_as_jax():
    res, code = run_both("fold", np.zeros(64))
    np.testing.assert_array_equal(res.gmem[:32], 50)
    assert len(code) < len(tcomp.compile_kernel(k_fold,
                                                optimize=False).code)
    for case, n in (("unroll_small", 2), ("unroll_big", 32)):
        g = np.zeros(n + 32, np.int32)
        g[:n] = np.arange(n) + 1
        res, code = run_both(case, g)
        assert (isa.BRA in _ops(code)) == (n == 32)
        np.testing.assert_array_equal(res.gmem[n:n + 32], n * (n + 1) // 2)
    g = np.arange(64, dtype=np.int32)
    res, code = run_both("dce", g)
    assert isa.LDG not in _ops(code)
    np.testing.assert_array_equal(res.gmem[32:], T)


@pytest.mark.parametrize("case", ["swap0", "swap3", "swap4"])
def test_xor_swap_parallel_moves_run_as_jax(case):
    n = CASES[case][1]["n"]
    res, _ = run_both(case, np.zeros(64))
    a, b = 1, 1000
    for _ in range(n):
        a, b = b, a + 1
    np.testing.assert_array_equal(res.gmem[:32], a)
    np.testing.assert_array_equal(res.gmem[32:], b)


def test_small_register_file_runs_as_jax():
    """Compiled for 4 registers, run on the default 16-register machine."""
    res, code = run_both("trace", np.zeros(64), n_regs=4)
    assert {int(r) for r in code[:, isa.F_DST]} <= {0, 1, 2, 3}
    np.testing.assert_array_equal(res.gmem[32:], 1)


@pytest.mark.parametrize("optimize", [True, False], ids=["opt", "naive"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_kernel_runs_as_jax(seed, optimize):
    """tests/test_compiler.py's differential kernel: each binary on each
    executor, and the optimized binary's memory equal to the naive's."""
    g0 = np.zeros(128, np.int32)
    g0[:64] = np.random.default_rng(seed).integers(-100, 100, 64)
    res, _ = run_both("seeded", g0, optimize)
    other, _ = run_both("seeded", g0, not optimize)
    np.testing.assert_array_equal(res.gmem, other.gmem)


# ------------------------------------------------------------------- CLI

def _lines(text):
    """The CLI's output with each compile wall ``<ms> ms`` blanked."""
    return re.sub(r"\d+ ms$", "<ms> ms", text, flags=re.M).splitlines()


@pytest.mark.parametrize("argv", [["--all", "--no-ir"],
                                  ["--all", "--no-ir", "-n", "256"],
                                  ["histogram", "-n", "64"],
                                  ["scan", "-n", "128"]],
                         ids=["all-64", "all-256", "histogram-ir",
                              "scan-ir"])
def test_cli_prints_what_jax_prints(argv, capsys):
    fresh_ids(tcomp)
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    fresh_ids(jcomp)
    assert jcli.main(argv) == 0
    assert _lines(got) == _lines(capsys.readouterr().out)
    assert "optimized instructions" in got


def test_cli_file_kernel_and_failures(tmp_path, capsys):
    src = tmp_path / "addk.py"
    src.write_text("PARAMS = {'c': 5}\n\n"
                   "def kernel(k, n, c):\n"
                   "    i = k.blockIdx.x * k.blockDim.x + k.threadIdx.x\n"
                   "    with k.if_(i < n):\n"
                   "        k.gmem[i + n] = k.gmem[i] + c\n")
    argv = [str(src), "--params", '{"n": 64}']
    fresh_ids(tcomp)
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    fresh_ids(jcomp)
    assert jcli.main(argv) == 0
    assert _lines(got) == _lines(capsys.readouterr().out)
    bad = tmp_path / "bad.py"
    bad.write_text("def kernel(k):\n    k.gmem[0] = k.tid // 3\n")
    assert tcli.main([str(bad), "--device", "cpu"]) == 1
    assert "power-of-two" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        tcli.main(["nosuchkernel", "--device", "cpu"])


def test_cli_run_holds_each_kernel_to_its_oracle(capsys):
    """``--run`` on the CPU: the JAX CLI's lines (the JAX package's grid
    and cycle totals at n=64)."""
    assert tcli.main(["--all", "--no-ir", "--run", "--device", "cpu"]) == 0
    ran = [l for l in capsys.readouterr().out.splitlines() if " ran " in l]
    assert ran == [
        "[compile] histogram: ran ((1, 1), (64, 1)) grid, 5556 cycles, "
        "oracle OK",
        "[compile] scan: ran ((1, 1), (64, 1)) grid, 996 cycles, oracle OK",
        "[compile] spmv: ran ((2, 1), (32, 1)) grid, 1248 cycles, "
        "oracle OK"]
