"""Dispatch semantics of the port's multi-SM executor against the JAX
package, bit for bit: the host-side reduction passes, dispatch-group
sizes that must not change results, multi-launch batches, the
position-order last-writer merge with group-start gmem snapshots, and the
module registry; the width an unset ``chunk`` resolves to, and the merge
of a launch's positions in one reduction against the loop a position."""
import functools

import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.core import scheduler as jsched
from repro.core.machine import MachineConfig as JaxConfig
from repro_torch import obs
from repro_torch.core import asm, isa, scheduler
from repro_torch.core.machine import MachineConfig
from repro_torch.core.programs import ALL
from repro_torch.runtime import executor
from torch_wide_groups import PINNED_N64, digest, five_programs

FIELDS = ("gmem", "cycles_per_block", "op_issues", "op_lanes", "stack_ops",
          "max_sp", "overflow")
JAX = JaxConfig(execute_backend="jnp")


def _same(got, want, tag):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{tag}: {f}")


def _program(name, n=32):
    mod = ALL[name]
    grid, bd = mod.launch(n)
    return mod, mod.build(n), grid, bd, mod.make_gmem(
        np.random.default_rng(5), n)


def test_reduction_run_passes():
    mod = ALL["reduction"]
    n = 300                                  # two blocks, then one
    code = mod.build(n)
    g0 = mod.make_gmem(np.random.default_rng(6), n)
    final, passes = mod.run_passes(
        functools.partial(scheduler.run_grid, n_sm=2, device="cpu"), code, n,
        g0.copy())
    jfinal, jpasses = mod.run_passes(
        functools.partial(jsched.run_grid, n_sm=2, cfg=JAX), code, n,
        g0.copy())
    assert len(passes) == len(jpasses) == 2
    np.testing.assert_array_equal(final, jfinal)
    for got, want in zip(passes, jpasses):
        _same(got, want, "reduction pass")
    np.testing.assert_array_equal(final[mod.out_slice(n)], mod.oracle(g0, n))


@functools.lru_cache(maxsize=None)
def _transpose48():
    """transpose n=48 is a 3x3 grid: ragged groups at every chunk size."""
    mod = ALL["transpose"]
    code, (grid, bd) = mod.build(48), mod.launch(48)
    g0 = mod.make_gmem(np.random.default_rng(7), 48)
    base = scheduler.run_grid(code, grid, bd, g0.copy(), chunk=8,
                              device="cpu")
    return code, grid, bd, g0, base


@pytest.mark.parametrize("chunk,n_sm", [(64, 1), (4, 2), (1, 1)])
def test_group_size_leaves_results_unchanged(chunk, n_sm):
    code, grid, bd, g0, base = _transpose48()
    got = scheduler.run_grid(code, grid, bd, g0.copy(), chunk=chunk,
                             n_sm=n_sm, device="cpu")
    _same(got, base, f"chunk={chunk}")
    want = jsched.run_grid(code, grid, bd, g0.copy(), cfg=JAX, chunk=chunk,
                           n_sm=n_sm)
    _same(got, want, f"jax chunk={chunk}")


def test_multi_launch_batch_matches_reference():
    specs, jspecs = [], []
    for name in ("autocorr", "transpose", "bitonic"):
        _, code, grid, bd, g0 = _program(name)
        specs.append(scheduler.LaunchSpec(code, grid, bd, g0.copy()))
        jspecs.append(jrt.LaunchSpec(code, grid, bd, g0.copy()))
    dg = scheduler.execute(specs, n_sm=2, device="cpu")
    jdg = jrt.execute(jspecs, n_sm=2, cfg=JAX)
    for got, want in zip(dg.to_results(), jdg.to_results()):
        _same(got, want, "batch")
    rep, jrep = dg.report(), jdg.report()
    np.testing.assert_array_equal(rep.per_sm_cycles, jrep.per_sm_cycles)
    # both packages pad the launch count to its bucket (3 launches, 4 rows)
    from repro_torch.runtime import registry as reg
    width = reg.bucket_gmem_len(max(len(s.gmem) for s in specs))
    assert rep.device_gmem_words == jrep.device_gmem_words
    assert jrep.device_gmem_words == jrt.bucket_launches(len(specs)) * width
    assert rep.useful_gmem_words == jrep.useful_gmem_words
    # each launch alone gives the same result as inside the batch
    for spec, got in zip(specs, dg.to_results()):
        alone = scheduler.run_grid(spec.code, spec.grid, spec.block_dim,
                                   spec.gmem.copy(), device="cpu")
        _same(got, alone, "alone")


def _conflict_program():
    """Every block writes its id to word 0, and copies word 0 as it reads
    it into word 1 + id: the last writer in position order must win, and
    a block sees the gmem of its dispatch group's start."""
    p = asm.Program("conflict")
    p.s2r("r0", isa.SR_CTA)
    p.mov("r1", 0)
    p.ldg("r2", "r1", 0)
    p.stg("r1", "r0", 0)
    p.stg("r0", "r2", 1)
    p.exit()
    return p.finish(pad_to=16)


@pytest.mark.parametrize("chunk,n_sm", [(4, 2), (8, 1), (2, 2)])
def test_last_writer_merge_order(chunk, n_sm):
    code = _conflict_program()
    g0 = np.full(16, -7, np.int32)
    specs = [scheduler.LaunchSpec(code, (9, 1), 32, g0.copy()),
             scheduler.LaunchSpec(code, (3, 1), 32, g0.copy() + 1)]
    dg = scheduler.execute(specs, n_sm=n_sm, chunk=chunk, device="cpu")
    jdg = jrt.execute([jrt.LaunchSpec(*s) for s in specs], n_sm=n_sm,
                      chunk=chunk, cfg=JAX)
    for got, want in zip(dg.to_results(), jdg.to_results()):
        _same(got, want, f"chunk={chunk}")
    first = dg.to_results()[0].gmem
    assert first[0] == 8                      # the last block wins
    assert first[1] == -7 and first[9] != -7  # group-start snapshots


def test_gmem_as_tensor_and_module_registry():
    _, code, grid, bd, g0 = _program("transpose")
    a = scheduler.run_grid(code, grid, bd, g0.copy(), device="cpu")
    b = scheduler.run_grid(code, grid, bd, torch.as_tensor(g0), device="cpu")
    _same(a, b, "tensor gmem")
    from repro_torch.runtime import registry as reg
    r = reg.ModuleRegistry(max_modules=1)
    m = r.load(code, "t")
    assert r.load(code) is m and (r.hits, r.misses) == (1, 1)
    assert m.padded_len == reg.bucket_code_len(len(code)) == 96
    r.load(code[:10])
    assert len(r) == 1 and r.load(code) is not m
    with pytest.raises(ValueError, match="empty grid"):
        scheduler.execute([scheduler.LaunchSpec(code, (0, 1), bd, g0)],
                          device="cpu")
    with pytest.raises(ValueError, match="at least one launch"):
        scheduler.execute([], device="cpu")


GIB = 1 << 30


@pytest.mark.parametrize("n_blocks,n_sm,g_words,free,want", [
    (518, 2, 262144, 80 * 10**9, 518),      # the suite: one group
    (517, 2, 262144, 80 * 10**9, 518),      # rounded up to the SMs
    (35, 2, 16384, 80 * 10**9, 36),
    (518, 2, 262144, 2 * GIB, 408),         # capped: 409 fit
    (518, 5, 262144, 2 * GIB, 405),         # a multiple of 5 that fits
    (518, 2, 262144, 10**6, 2),             # never below n_sm
    (1, 8, 1024, 0, 8),
])
def test_wide_chunk_rule(n_blocks, n_sm, g_words, free, want):
    """The width is every position rounded up to a multiple of n_sm,
    capped where the group's buffers would pass their share of the free
    memory, and at least n_sm."""
    got = executor.wide_chunk(n_blocks, n_sm, g_words, free)
    assert got == want
    assert got % n_sm == 0 and got >= n_sm
    per = executor.GROUP_BYTES_PER_WORD * g_words
    assert got == n_sm or got * per <= free * executor.GROUP_MEMORY_SHARE
    if (got + n_sm) * per <= free * executor.GROUP_MEMORY_SHARE:
        assert got >= n_blocks                # not capped: every position
    if n_blocks == 518 and free == 80 * 10**9:
        assert len(executor.dispatch_groups(n_blocks, n_sm, got)) == 1


CARD = torch.device("cuda")


@pytest.mark.parametrize("backend,device,sharded,wide", [
    ("cuda_fused", torch.device("cpu"), False, False),
    ("torch", CARD, False, False),
    ("cuda", CARD, False, False),
    ("reference", CARD, False, False),
    ("cuda_fused", CARD, True, False),
    ("cuda_fused", CARD, False, True),
])
def test_unset_chunk_resolves_by_backend(monkeypatch, backend, device,
                                         sharded, wide):
    """chunk=None is 8 on the CPU, on the staged backends and on the
    sharded path, where the card's memory is never read; on the fused
    backend's one-device path on a card it is the wide group, the free
    memory read once until ``clear_caches``.  A chunk the caller sets
    comes back as it was, with today's group bounds."""
    reads = []

    def mem_get_info(dev):
        reads.append(dev)
        return 80 * 10**9, 80 * 10**9

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    cfg = MachineConfig(execute_backend=backend)
    executor.clear_caches()
    try:
        for _ in range(2):                    # read once, then kept
            got = executor.resolve_chunk(None, cfg, device, sharded, 518, 2,
                                         262144)
            assert got == (518 if wide else 8)
        assert executor.DEFAULT_CHUNK == 8
        assert reads == ([device] if wide else [])
        for chunk in (1, 2, 4, 8, 64):
            assert executor.resolve_chunk(chunk, cfg, device, sharded, 518,
                                          2, 262144) == chunk
        assert len(reads) == int(wide)
    finally:
        executor.clear_caches()               # forget the fake reading
    assert executor.group_bounds(518, 2, 8) == \
        [(i, i + 8) for i in range(0, 512, 8)] + [(512, 518)]
    assert executor.group_bounds(11, 2, 2) == \
        [(i, min(i + 2, 11)) for i in range(0, 11, 2)]
    assert executor.group_bounds(9, 2, 64) == [(0, 9)]


@pytest.mark.parametrize("chunk,shard", [(None, False), (None, True),
                                         (4, False), (64, False)])
def test_execute_groups_on_the_cpu(chunk, shard):
    """On the CPU an unset chunk runs 8-position groups, sharded or not;
    a set chunk runs exactly its group bounds.  Each group's positions go
    to ``executor.group_positions`` and its merge span counts the
    launches it held."""
    specs = [scheduler.LaunchSpec(*s) for s in five_programs(32)]
    hist = executor.METRICS.histogram("executor.group_positions")
    shard_groups = executor.METRICS.counter("shard.dispatch_groups")
    n0, t0, g0 = hist.count, hist.total, shard_groups.value
    kw = dict(shard_sm=True, sm_devices=["cpu"] * 2) if shard else {}
    obs.TRACER.clear().start()
    try:
        dg = scheduler.execute(specs, n_sm=2, chunk=chunk, device="cpu", **kw)
    finally:
        obs.TRACER.stop()
    merges = [sp.attrs for sp in sorted(obs.TRACER.find("merge"),
                                        key=lambda sp: sp.t0)]
    obs.TRACER.clear()
    n_blocks = dg.report().n_blocks
    bounds = executor.group_bounds(n_blocks, 2, chunk or 8)
    if shard:
        assert shard_groups.value - g0 == len(bounds)
        assert hist.count == n0
        return
    assert hist.count - n0 == len(bounds)
    assert hist.total - t0 == n_blocks
    offsets = np.cumsum([0] + [int(np.prod(s.grid)) for s in specs])
    assert [m["n_positions"] for m in merges] == \
        [hi - lo for lo, hi in bounds]
    assert [m["n_launches"] for m in merges] == [
        int(((offsets[1:] > lo) & (offsets[:-1] < hi)).sum())
        for lo, hi in bounds]


def _loop_merge(gmems, mem, wrt, launch_ids):
    """The merge a ``torch.where`` a position, in position order."""
    for p, li in enumerate(launch_ids.tolist()):
        gmems[li] = torch.where(wrt[p], mem[p], gmems[li])


def _merge_case(kind, rng):
    G = 40
    if kind == "one launch":
        ids = np.zeros(9, np.int32)
    elif kind == "mixed launches":
        ids = np.repeat(np.arange(4), [1, 5, 2, 3]).astype(np.int32)
    elif kind == "two and one":
        ids = np.array([0, 0, 1], np.int32)
    elif kind == "unordered":
        ids = rng.integers(0, 3, 12).astype(np.int32)
    else:
        ids = np.repeat(np.arange(2), [6, 3]).astype(np.int32)
    P = len(ids)
    mem = torch.as_tensor(rng.integers(-2**31, 2**31, (P, G)),
                          dtype=torch.int32)
    if kind == "one word each":               # every position, one word
        wrt = torch.zeros((P, G), dtype=torch.bool)
        wrt[:, 7] = True
    elif kind == "empty":
        wrt = torch.zeros((P, G), dtype=torch.bool)
    else:
        wrt = torch.as_tensor(rng.random((P, G)) < 0.4)
    return ids, mem, wrt


@pytest.mark.parametrize("kind", ["one launch", "mixed launches",
                                  "two and one", "unordered",
                                  "one word each", "empty"])
def test_merge_writes_equals_position_loop(kind):
    """One reduction a launch run equals the loop a position, bit for
    bit: the last writer of each word wins, unwritten words keep the
    group's starting gmem."""
    rng = np.random.default_rng(len(kind))
    ids, mem, wrt = _merge_case(kind, rng)
    start = torch.as_tensor(rng.integers(-2**31, 2**31, (4, mem.shape[1])),
                            dtype=torch.int32)
    want, got = start.clone(), start.clone()
    _loop_merge(want, mem, wrt, ids)
    runs = executor.merge_writes(got, mem, wrt, ids)
    assert torch.equal(got, want)
    assert runs == 1 + int((ids[1:] != ids[:-1]).sum())
    if kind == "one word each":
        assert got[0, 7] == mem[5, 7] and got[1, 7] == mem[8, 7]
    if kind == "empty":
        assert torch.equal(got, start)


def test_five_programs_pin_matches_jax():
    """The pin the card's widest group is held to is the JAX package's
    execute of the five programs at n=64 on 2 SMs at its default chunk,
    and the port's CPU path gives it at its default and in one group."""
    jdg = jrt.execute([jrt.LaunchSpec(*s) for s in five_programs(64)],
                      n_sm=2, cfg=JAX)
    assert digest(jdg.to_results(), jdg.report().per_sm_cycles) == \
        PINNED_N64
    for chunk in (None, 64):
        dg = scheduler.execute(
            [scheduler.LaunchSpec(*s) for s in five_programs(64)], n_sm=2,
            chunk=chunk, device="cpu")
        assert digest(dg.to_results(), dg.report().per_sm_cycles) == \
            PINNED_N64, chunk
