"""The staged pipeline stepping a whole dispatch group at once, against the
JAX package's ``vmap`` over positions, bit for bit.

``staged_run`` (the plain version of the fused kernel, and how the
executor runs the ``"torch"`` and ``"cuda"`` backends) steps every
position of a group in one loop: one execute-stage call and one host sync
a step, positions whose loop has ended held as they are.  Held here:

* the port's ``execute`` on a launch mix whose groups hold positions of
  different step counts (the five paper programs at n=32) against the JAX
  executor (``"jnp"``, and ``"pallas"`` in interpret mode): gmem, the
  written mask and all six counters, with zero tolerance, also under a
  ``max_cycles`` that stops some positions while others run on;
* the batched rows (``C_STEPS`` and the store steps included) against one
  position at a time through ``run_block_body``'s loop;
* the execute stage's calls: the group's longest step count, not the sum,
  over the executor's dispatch groups (``executor.group_bounds``);
* ``simt_alu_ref`` on (P, W, 32) against the Pallas ``simt_alu`` under
  ``jax.vmap``.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.core.machine import MachineConfig as JaxConfig
from repro.kernels.simt_alu import simt_alu as pallas_simt_alu
from repro_torch.core import isa, scheduler
from repro_torch.core import pipeline as tp
from repro_torch.core.machine import MachineConfig
from repro_torch.core.pipeline import fused
from repro_torch.core.pipeline.state import SMState
from repro_torch.core.programs import ALL
from repro_torch.kernels.ref import simt_alu_ref
from repro_torch.kernels.simt_alu import simt_alu
from repro_torch.runtime import executor

N = 32
FIELDS = ("gmem", "cycles_per_block", "op_issues", "op_lanes", "stack_ops",
          "max_sp", "overflow")
#: stops autocorr (1499 cycles a block at n=32), bitonic (1224) and matmul
#: (10944) early while reduction (362) and transpose (544) run to their end
SHORT = 1000
CONFIGS = {"baseline": {}, "max_cycles": dict(max_cycles=SHORT)}


def _specs(cls):
    """The five paper programs at n=32, in one launch mix: 11 blocks of
    268 to 13 steps."""
    out = []
    for name in sorted(ALL):
        mod = ALL[name]
        grid, bd = mod.launch(N)
        out.append(cls(mod.build(N), grid, bd,
                       mod.make_gmem(np.random.default_rng(7), N)))
    return out


@functools.lru_cache(maxsize=None)
def _jax(backend, n_sm, cfg_name):
    kw = dict(pallas_interpret=True) if backend == "pallas" else {}
    dg = jrt.execute(_specs(jrt.LaunchSpec), n_sm=n_sm,
                     cfg=JaxConfig(execute_backend=backend,
                                   **CONFIGS[cfg_name], **kw))
    return dg.to_results(), dg.report()


@functools.lru_cache(maxsize=None)
def _port(backend, n_sm, cfg_name):
    dg = scheduler.execute(_specs(scheduler.LaunchSpec), n_sm=n_sm,
                           cfg=MachineConfig(execute_backend=backend,
                                             **CONFIGS[cfg_name]),
                           device="cpu")
    return dg.to_results(), dg.report()


#: (JAX backend, n_sm, configuration): the Pallas backend (interpret
#: mode) on the baseline configuration
JAX_RUNS = [("jnp", n_sm, c) for n_sm in (1, 2) for c in sorted(CONFIGS)] \
    + [("pallas", n_sm, "baseline") for n_sm in (1, 2)]


@pytest.mark.parametrize("jax_backend,n_sm,cfg_name", JAX_RUNS)
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_launch_mix_matches_jax_vmap(backend, jax_backend, n_sm, cfg_name):
    got, rep = _port(backend, n_sm, cfg_name)
    want, jrep = _jax(jax_backend, n_sm, cfg_name)
    for i, (g, w) in enumerate(zip(got, want)):
        for f in FIELDS:
            np.testing.assert_array_equal(
                np.asarray(getattr(g, f)), np.asarray(getattr(w, f)),
                err_msg=f"launch {i} {f}")
    np.testing.assert_array_equal(rep.per_sm_cycles, jrep.per_sm_cycles)
    assert (rep.max_sp, rep.overflow) == (jrep.max_sp, jrep.overflow)


def test_max_cycles_stops_some_positions_only():
    """The short configuration holds some blocks at the budget while the
    others end: the mix above compares both kinds in one group."""
    got, _ = _port("torch", 1, "max_cycles")
    full, _ = _port("torch", 1, "baseline")
    stopped = [int(c) for g in got for c in g.cycles_per_block
               if c >= SHORT]
    ended = [int(c) for g, f in zip(got, full)
             for c, fc in zip(g.cycles_per_block, f.cycles_per_block)
             if c == fc < SHORT]
    assert stopped and ended
    # a block stops after the step that reaches the budget: at most one
    # step past it, 8 warps of 4 rows and a global access each
    cfg = MachineConfig()
    step_max = 8 * (cfg.rows_per_warp + cfg.mem_latency_global)
    assert all(c < SHORT + step_max for c in stopped)


def _group(names, n=N):
    """One dispatch group of the blocks of ``names`` (one launch each):
    programs (L, C, 10), geometry rows, (P, G) gmem snapshots, warps."""
    mods = [ALL[m] for m in names]
    codes = [m.build(n) for m in mods]
    C = max(len(c) for c in codes)
    pad = [np.concatenate([c, np.tile(c[-1:], (C - len(c), 1))])
           for c in codes]
    rows, gm = [], []
    for li, m in enumerate(mods):
        (gx, gy), (bdx, bdy) = m.launch(n)
        g0 = m.make_gmem(np.random.default_rng(li), n)
        for p in range(gx * gy):
            rows.append([li, bdx * bdy, bdx, bdy, p % gx, p // gx, gx, gy])
            gm.append(g0)
    G = max(len(g) for g in gm)
    gmem = np.zeros((len(gm), G), np.int32)
    for p, g in enumerate(gm):
        gmem[p, :len(g)] = g
    W = max(-(-r[1] // 32) for r in rows)
    return (torch.as_tensor(np.stack(pad)), np.asarray(rows, np.int32),
            torch.as_tensor(gmem), W)


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
@pytest.mark.parametrize("names", [("matmul",), ("autocorr", "transpose"),
                                   ("bitonic", "reduction", "matmul")])
def test_batched_rows_equal_one_position_at_a_time(names, cfg_name):
    cfg = MachineConfig(execute_backend="torch", **CONFIGS[cfg_name])
    codes, geom, gmem, W = _group(names)
    mem, wrt, ctr = fused.staged_run(cfg, W, codes, geom, gmem.clone())
    assert ctr.shape == (len(geom), fused.N_CTR) and ctr.dtype == torch.int32
    for p, (li, bdim, bdx, bdy, bx, by, gx, gy) in enumerate(geom.tolist()):
        geo = ((bdx, bdy), (bx, by), (gx, gy))
        g1, w1, c1 = tp.run_block_body(cfg, W, codes[li], bdim, *geo,
                                       gmem[p])
        st0 = tp.init_state(cfg, W, bdim, gmem[p])
        _, steps, store_steps = tp.block_loop(cfg, codes[li], *geo, st0)
        want = torch.cat([c1.op_issues, c1.op_lanes, torch.stack(
            [c1.cycles, c1.stack_ops, c1.max_sp, c1.overflow, steps,
             store_steps])])
        assert torch.equal(ctr[p], want), f"position {p}"
        assert torch.equal(mem[p], g1) and torch.equal(wrt[p], w1), p
    # the group's positions take different step counts
    assert len(set(ctr[:, fused.C_STEPS].tolist())) == len(names)


def test_batched_init_state_stacks_the_positions():
    cfg = MachineConfig()
    gmem = torch.arange(3 * 40, dtype=torch.int32).view(3, 40)
    dims = [64, 33, 1]
    batched = tp.init_state(cfg, 2, dims, gmem)
    one = [tp.init_state(cfg, 2, d, gmem[p]) for p, d in enumerate(dims)]
    for f in SMState._fields:
        a, b = getattr(batched, f), [getattr(s, f) for s in one]
        if f == "counters":
            for x, *ys in zip(a, *b):
                assert torch.equal(x, torch.stack(ys))
        else:
            assert torch.equal(a, torch.stack(b)), f


def _count_calls(monkeypatch):
    calls = []
    real = tp.execute

    def counted(*a, **kw):
        calls.append(a[1].op.shape)
        return real(*a, **kw)

    monkeypatch.setattr(tp, "execute", counted)
    return calls


def test_matmul_execute_calls_are_the_longest_step_count(monkeypatch):
    """matmul n=32 is one group of 4 blocks of 298 steps: 298 calls of the
    execute stage, each on all (4, 8) warp rows, where the position loop
    made 1192."""
    calls = _count_calls(monkeypatch)
    mod = ALL["matmul"]
    grid, bd = mod.launch(N)
    dg = scheduler.execute([scheduler.LaunchSpec(
        mod.build(N), grid, bd, mod.make_gmem(np.random.default_rng(2), N))],
        cfg=MachineConfig(execute_backend="cuda"), device="cpu")
    assert dg.block_steps().tolist() == [298] * 4
    assert len(calls) == 298
    assert set(calls) == {(4, 8)}


@pytest.mark.parametrize("n_sm", [1, 2])
def test_mix_execute_calls_follow_each_groups_longest(monkeypatch, n_sm):
    calls = _count_calls(monkeypatch)
    per_group = []
    real = executor.staged_run

    def run(*a):
        before = len(calls)
        out = real(*a)
        per_group.append((len(calls) - before,
                          int(out[2][:, fused.C_STEPS].max())))
        return out

    monkeypatch.setattr(executor, "staged_run", run)
    scheduler.execute(_specs(scheduler.LaunchSpec), n_sm=n_sm,
                      cfg=MachineConfig(execute_backend="cuda"),
                      device="cpu")
    assert len(per_group) == len(executor.group_bounds(11, n_sm, 8)) > 1
    assert all(n == longest for n, longest in per_group)
    assert len(calls) == sum(longest for _, longest in per_group)


@pytest.mark.parametrize("nro", [2, 3])
@pytest.mark.parametrize("enable_mul", [True, False])
def test_batched_alu_ref_matches_pallas_under_vmap(enable_mul, nro):
    """Every opcode (and two outside the ISA) spread over (P, W) rows."""
    rng = np.random.default_rng(int(enable_mul) * 10 + nro)
    P, W, L = 4, 9, 32
    op = rng.permutation(np.resize(np.arange(-1, isa.NUM_OPCODES + 1),
                                   P * W)).reshape(P, W).astype(np.int32)
    big = (P, W, L)
    args = [rng.integers(-2 ** 31, 2 ** 31 - 1, big).astype(np.int32),
            rng.integers(-2 ** 31, 2 ** 31 - 1, big).astype(np.int32),
            rng.integers(-2 ** 31, 2 ** 31 - 1, big).astype(np.int32),
            (rng.random(big) > 0.5).astype(np.int32),
            rng.integers(0, 1024, big).astype(np.int32),
            (rng.random(big) > 0.25).astype(np.int32)]
    kw = dict(enable_mul=enable_mul, num_read_operands=nro)
    want = jax.vmap(functools.partial(pallas_simt_alu, interpret=True,
                                      **kw))(op, *args)
    t = [torch.as_tensor(x) for x in [op] + args]
    for got in (simt_alu_ref(*t, **kw), simt_alu(*t, **kw)):
        for g, w in zip(got, want):
            assert g.shape == big
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # one row at a time gives the same
    flat = simt_alu_ref(t[0].reshape(-1), *(x.reshape(-1, L) for x in t[1:]),
                        **kw)
    for g, f in zip(simt_alu_ref(*t, **kw), flat):
        assert torch.equal(g.reshape(-1, L), f)


@pytest.mark.parametrize("n_blocks,n_sm,chunk,want", [
    (4, 1, 8, [(0, 4)]),                      # matmul n=32: one group
    (11, 1, 8, [(0, 8), (8, 11)]),            # the launch mix above
    (11, 2, 8, [(0, 8), (8, 11)]),            # 4 super-steps, then 2
    (256, 1, 8, [(8 * k, 8 * k + 8) for k in range(32)]),
    (5, 2, 8, [(0, 5)]),
    (3, 4, 8, [(0, 3)]),                      # fewer blocks than SMs
    (20, 4, 8, [(0, 8), (8, 16), (16, 20)]),  # spd 2, then 1
    (7, 3, 8, [(0, 6), (6, 7)]),
])
def test_group_bounds(n_blocks, n_sm, chunk, want):
    """Dispatch groups of whole super-steps, at most ``chunk // n_sm`` of
    them, ``spd`` halving for the tail, covering every position once."""
    got = executor.group_bounds(n_blocks, n_sm, chunk)
    assert got == want
    assert [lo for lo, _ in got] == [0] + [hi for _, hi in got[:-1]]
    assert got[-1][1] == n_blocks


def test_frozen_positions_keep_their_state():
    """``select_state`` holds every field of a position whose loop has
    ended, counters included."""
    cfg = MachineConfig()
    gmem = torch.zeros((2, 16), dtype=torch.int32)
    old = tp.init_state(cfg, 1, [32, 32], gmem)
    new = old._replace(pc=old.pc + 1, gmem=old.gmem + 5,
                       counters=old.counters._replace(
                           cycles=old.counters.cycles + 7))
    keep = torch.tensor([True, False])
    st = tp.select_state(keep, new, old)
    assert st.pc.tolist() == [[1], [0]]
    assert st.gmem[:, 0].tolist() == [5, 0]
    assert st.counters.cycles.tolist() == [7, 0]
    assert torch.equal(st.regs, old.regs)
