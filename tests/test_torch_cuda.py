"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips.  On a host
with an NVIDIA Hopper card and ``nvcc``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The CPU parity of the plain versions with the JAX package is in the other
``tests/test_torch_*.py`` files; ``chip_smoke.py`` drives the main path."""
import numpy as np
import pytest
import torch

from dataclasses import replace

from repro_torch.core import isa, machine, scheduler
from repro_torch.core.machine import MachineConfig
from repro_torch.core.pipeline.fused import C_STEPS, fused_sm_run, staged_run
from repro_torch.core.programs import ALL
from repro_torch.runtime import executor
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_gqa)
from repro_torch.kernels.matmul import matmul
from repro_torch.kernels.ref import (flash_attention_ref, matmul_ref,
                                     mha_ref, simt_alu_ref)
from repro_torch.kernels.simt_alu import simt_alu
from test_torch_parity import (out_of_range_program, random_branchy,
                               random_straightline, same_step_gmem,
                               same_step_program)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    return torch.device("cuda")


@pytest.mark.parametrize("W", [1, 33, 1000])
def test_simt_alu_kernel_matches_plain(card, W):
    rng = np.random.default_rng(W)
    op = torch.as_tensor(rng.integers(-1, isa.NUM_OPCODES + 1, W)
                         .astype(np.int32), device=card)
    lanes = [torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, (W, 32))
                             .astype(np.int32), device=card)
             for _ in range(6)]
    _build.LAUNCHES.clear()
    for em in (True, False):
        for nro in (2, 3):
            got = simt_alu(op, *lanes, enable_mul=em, num_read_operands=nro)
            want = simt_alu_ref(op, *lanes, enable_mul=em,
                                num_read_operands=nro)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _build.LAUNCHES["simt_alu"] == 4


def _alu_operands(rng, shape, device):
    """op shape[:-1] (every opcode and two outside the ISA) and six int32
    lane operands of ``shape``."""
    op = rng.integers(-1, isa.NUM_OPCODES + 1, shape[:-1]).astype(np.int32)
    lanes = [rng.integers(-2 ** 31, 2 ** 31, shape).astype(np.int32)
             for _ in range(4)] + [rng.integers(0, 2, shape).astype(np.int32)
                                   for _ in range(2)]
    return [torch.as_tensor(x, device=device) for x in [op] + lanes]


@pytest.mark.parametrize("shape,offset", [
    ((4, 8, 32), 0),          # a dispatch group: P x W rows of 32
    ((3, 5, 32), 0),
    ((2, 7, 30), 0),          # rows not whole 16-byte vectors
    ((4, 8, 32), 1),          # operands one word past 16 bytes
])
def test_batched_simt_alu_matches_ref(card, shape, offset):
    rng = np.random.default_rng(sum(shape) + offset)
    op, *lanes = _alu_operands(rng, shape, card)
    if offset:
        n = lanes[0].numel()

        def shifted(x):
            buf = torch.empty(n + offset, dtype=torch.int32, device=card)
            buf[offset:] = x.reshape(-1)
            return buf[offset:].view(shape)

        lanes = [shifted(x) for x in lanes]
        assert lanes[0].is_contiguous() and lanes[0].data_ptr() % 16
    for em in (True, False):
        for nro in (2, 3):
            _build.LAUNCHES.clear()
            got = simt_alu(op, *lanes, enable_mul=em, num_read_operands=nro)
            assert _build.LAUNCHES == {"simt_alu": 1}
            ref = simt_alu_ref(op, *lanes, enable_mul=em,
                               num_read_operands=nro)
            for a, b in zip(got, ref):
                assert a.shape == shape and torch.equal(a, b)


@pytest.mark.parametrize("n_sm", [1, 2])
def test_staged_cuda_drain_matches_cpu(card, n_sm):
    """The five paper programs at n=32 in one execute through the staged
    "cuda" backend: one simt_alu launch a group step, the sum over groups
    of each group's longest block."""
    specs = []
    for name in sorted(ALL):
        mod = ALL[name]
        grid, bd = mod.launch(32)
        specs.append((mod.build(32), grid, bd,
                      mod.make_gmem(np.random.default_rng(3), 32)))
    cfg = MachineConfig(execute_backend="cuda")
    want_dg = scheduler.execute([scheduler.LaunchSpec(*s) for s in specs],
                                n_sm=n_sm, cfg=cfg, device="cpu")
    _build.LAUNCHES.clear()
    got_dg = scheduler.execute([scheduler.LaunchSpec(*s) for s in specs],
                               n_sm=n_sm, cfg=cfg, device=card)
    got, want = got_dg.to_results(), want_dg.to_results()
    for g, w in zip(got, want):
        for f in w._fields:
            np.testing.assert_array_equal(np.asarray(getattr(g, f)),
                                          np.asarray(getattr(w, f)), f)
    steps = want_dg.block_steps()
    groups = executor.group_bounds(len(steps), n_sm, 8)
    assert dict(_build.LAUNCHES) == {
        "simt_alu": sum(int(steps[lo:hi].max()) for lo, hi in groups)}


@pytest.mark.parametrize("backend", ["cuda_fused", "cuda"])
@pytest.mark.parametrize("name", ["autocorr", "transpose"])
def test_grid_on_card_matches_cpu(card, name, backend):
    mod = ALL[name]
    code, (grid, bd) = mod.build(32), mod.launch(32)
    g0 = mod.make_gmem(np.random.default_rng(0), 32)
    want = scheduler.run_grid(code, grid, bd, g0.copy(), n_sm=2,
                              device="cpu")
    _build.LAUNCHES.clear()
    got = scheduler.run_grid(code, grid, bd, g0.copy(), n_sm=2,
                             cfg=MachineConfig(execute_backend=backend),
                             device=card)
    for f in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)
    kernel = "fused_sm_run" if backend == "cuda_fused" else "simt_alu"
    assert _build.LAUNCHES[kernel] > 0


def test_out_of_range_fields_on_card(card):
    """The fused kernel's fill, clamp and drop index semantics equal the
    plain path's (which the CPU tests hold to the JAX package)."""
    code, gmem = out_of_range_program(), np.zeros(16 * 40, np.int32)
    want = machine.run_block(code, 40, (0, 0), (1, 1), gmem, device="cpu")
    _build.LAUNCHES.clear()
    got = machine.run_block(code, 40, (0, 0), (1, 1), gmem, device=card)
    assert _build.LAUNCHES["fused_sm_run"] == 1
    for a, b in zip(got[:2] + tuple(got[2]), want[:2] + tuple(want[2])):
        assert torch.equal(a.cpu(), b)


def block_on_card_matches_cpu(card, code, bd, gmem):
    """One block through the fused kernel and through the plain path on
    the CPU: gmem, written mask and every counter equal."""
    want = machine.run_block(code, bd, (0, 0), (1, 1), gmem, device="cpu")
    _build.LAUNCHES.clear()
    got = machine.run_block(code, bd, (0, 0), (1, 1), gmem, device=card)
    assert _build.LAUNCHES["fused_sm_run"] == 1
    for a, b in zip(got[:2] + tuple(got[2]), want[:2] + tuple(want[2])):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("bd", [64, 256, 1024])
def test_same_step_load_sees_the_value_before_the_step_on_card(card, bd):
    """An odd warp's LDS (LDG) in the step of its even neighbour's STS
    (STG) to the same word reads the word as it was before the step: the
    case a wrongly skipped read/write barrier breaks."""
    block_on_card_matches_cpu(card, same_step_program(bd), bd,
                              same_step_gmem(bd))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kind", ["straight", "branchy"])
def test_random_programs_on_card(card, kind, seed):
    """The seeded random programs of tests/test_torch_parity.py."""
    if kind == "straight":
        rng = np.random.default_rng(seed)
        code, bd = random_straightline(rng), 40
        gmem = rng.integers(-1000, 1000, 40 * 8, dtype=np.int32)
    else:
        code, bd = random_branchy(np.random.default_rng(seed + 100)), 64
        gmem = np.zeros(64, np.int32)
    block_on_card_matches_cpu(card, code, bd, gmem)


@pytest.mark.parametrize("bd", [1024, 1000])
def test_widest_and_partial_blocks_on_card(card, bd):
    """32 warps (1024 threads), and a block whose last warp has 8 threads."""
    rng = np.random.default_rng(bd)
    block_on_card_matches_cpu(card, random_straightline(rng), bd,
                              rng.integers(-1000, 1000, bd * 8,
                                           dtype=np.int32))


@pytest.mark.parametrize("budget", [1, 777, 3000])
def test_cycle_budget_stops_blocks_mid_program_on_card(card, budget):
    """max_cycles stops every block of a matmul group mid-program; the
    kernel's rows, the step it stopped at included, equal the plain
    path's."""
    mod = ALL["matmul"]
    (gx, gy), (bdx, bdy) = mod.launch(32)
    geom = np.array([[0, bdx * bdy, bdx, bdy, p % gx, p // gx, gx, gy]
                     for p in range(gx * gy)], np.int32)
    code = torch.as_tensor(mod.build(32))[None].contiguous()
    g0 = torch.as_tensor(mod.make_gmem(np.random.default_rng(9), 32))
    gmem = g0[None].repeat(len(geom), 1)
    cfg = MachineConfig(max_cycles=budget)
    W = bdx * bdy // 32
    want = staged_run(replace(cfg, execute_backend="torch"), W, code, geom,
                      gmem.clone())
    full = staged_run(MachineConfig(execute_backend="torch"), W, code, geom,
                      gmem.clone())
    assert (want[2][:, C_STEPS] < full[2][:, C_STEPS]).all()
    got = fused_sm_run(cfg, W, code.to(card), geom, gmem.to(card))
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_group_loop_makes_no_synchronizing_call(card, monkeypatch):
    """execute's dispatch-group loop under sync debug mode "error": any
    call that waits for the card raises.  Results equal the CPU's."""
    mod = ALL["transpose"]
    code, (grid, bd) = mod.build(64), mod.launch(64)
    g0 = mod.make_gmem(np.random.default_rng(0), 64)
    real = executor.run_groups

    def strict(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(executor, "run_groups", strict)
    want = scheduler.run_grid(code, grid, bd, g0.copy(), n_sm=2,
                              device="cpu")
    _build.LAUNCHES.clear()
    got = scheduler.run_grid(code, grid, bd, g0.copy(), n_sm=2, device=card)
    assert _build.LAUNCHES["fused_sm_run"] == 2
    for f in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    z = torch.zeros((2, 32), dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        simt_alu(torch.zeros(3, dtype=torch.int32, device=card),
                 z, z, z, z, z, z)
    with pytest.raises(ValueError, match="warps"):
        scheduler.run_grid(np.asarray(ALL["bitonic"].build(32)), (1, 1),
                           33 * 32, np.zeros(64, np.int32), device=card)


# (Sq, Sk, dh, causal); tolerances: f32 2e-3, bf16 3e-2 (tests/test_kernels)
FLASH_SHAPES = [(256, 256, 64, True), (256, 256, 128, True),
                (128, 512, 64, False), (200, 200, 128, True),
                (40, 72, 16, True), (512, 512, 256, False)]


def expected_flash_variant(dtype, dh, forced):
    """bf16 at dh 64/128 takes the tensor cores unless the SIMT variant
    is forced; float32 and other widths take SIMT."""
    if forced:
        return forced
    return "tc" if dtype == torch.bfloat16 and dh in (64, 128) else "simt"


@pytest.mark.parametrize("forced", [None, "simt"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk,dh,causal", FLASH_SHAPES)
def test_flash_attention_kernel_matches_plain(card, Sq, Sk, dh, causal,
                                              dtype, forced):
    g = torch.Generator(device=card).manual_seed(Sq + dh)
    q, k, v = (torch.randn((3, s, dh), generator=g, device=card).to(dtype)
               for s in (Sq, Sk, Sk))
    _build.LAUNCHES.clear()
    _build.VARIANTS.clear()
    got = flash_attention(q, k, v, causal=causal, variant=forced)
    assert _build.LAUNCHES["flash_attention"] == 1
    assert _build.VARIANTS == {
        ("flash_attention", expected_flash_variant(dtype, dh, forced)): 1}
    want = flash_attention_ref(q, k, v, causal=causal)
    tol = 2e-3 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("forced", [None, "simt"])
@pytest.mark.parametrize("S,dh", [(16, 128), (200, 128), (512, 128),
                                  (200, 64), (512, 64)])
def test_flash_attention_gqa_reads_strided_cache(card, S, dh, forced):
    """The model's call: q (B, S, H, dh), k/v a prefix of a longer cache,
    causal, 8 query heads on 2 KV heads."""
    g = torch.Generator(device=card).manual_seed(S + dh)
    q = torch.randn((2, S, 8, dh), generator=g, device=card).bfloat16()
    ck, cv = (torch.randn((2, S + 40, 2, dh), generator=g, device=card)
              .bfloat16() for _ in range(2))
    _build.VARIANTS.clear()
    got = flash_attention_gqa(q, ck[:, :S], cv[:, :S], causal=True,
                              variant=forced)
    assert _build.VARIANTS == {("flash_attention", forced or "tc"): 1}
    want = mha_ref(q, ck[:, :S], cv[:, :S], causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2,
                               atol=3e-2)


def test_flash_attention_misaligned_q_takes_simt(card):
    g = torch.Generator(device=card).manual_seed(1)
    buf = torch.randn(2 * 128 * 4 * 64 + 1, generator=g, device=card)
    q = buf.bfloat16()[1:].view(2, 128, 4, 64)
    k, v = (torch.randn((2, 128, 2, 64), generator=g, device=card).bfloat16()
            for _ in range(2))
    _build.VARIANTS.clear()
    got = flash_attention_gqa(q, k, v, causal=True)
    assert _build.VARIANTS == {("flash_attention", "simt"): 1}
    torch.testing.assert_close(got.float(), mha_ref(q, k, v).float(),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(128, 128, 128), (256, 384, 128),
                                   (384, 128, 256), (512, 512, 512)])
def test_matmul_kernel_matches_plain(card, shape, dtype):
    M, K, N = shape
    g = torch.Generator(device=card).manual_seed(M)
    a = torch.randn((M, K), generator=g, device=card).to(dtype)
    b = torch.randn((K, N), generator=g, device=card).to(dtype)
    _build.LAUNCHES.clear()
    got = ops.matmul(a, b, bm=128, bn=128, bk=128)
    assert _build.LAUNCHES["matmul"] == 1 and got.dtype == dtype
    tol = 1e-3 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), matmul_ref(a, b).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kind", [((200, 200, 200), ""),
                                        ((512, 512, 512), ""),
                                        ((300, 100, 50), "_scalar")])
def test_matmul_default_blocks(card, shape, kind, dtype):
    """The default blocks (512, clipped to the dims): 200^3 is ragged
    against the kernel's 64 x 32 tiles; K = 100, N = 50 are not whole
    16-byte rows, so both dtypes take their scalar-load variants."""
    M, K, N = shape
    g = torch.Generator(device=card).manual_seed(M + K)
    a = torch.randn((M, K), generator=g, device=card).to(dtype)
    b = torch.randn((K, N), generator=g, device=card).to(dtype)
    _build.VARIANTS.clear()
    got = matmul(a, b)
    base = "simt" if dtype == torch.float32 else "tc"
    assert _build.VARIANTS == {("matmul", base + kind): 1}
    tol = 1e-3 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), matmul_ref(a, b).float(),
                               rtol=tol, atol=tol)


def test_reduced_prefill_on_card(monkeypatch, card):
    """The reduced model's prefill step: one flash launch per layer;
    logits within the bf16 tolerance (2e-2) of the plain attention's
    (``mha_ref`` in the flash wrapper's place), and
    each layer's caches within a 2e-2 relative Frobenius error (the
    measure tests/test_torch_lm.py holds caches to)."""
    from repro_torch import configs
    from repro_torch.models import api
    spec = configs.reduced(configs.get("qwen3-0.6b"))
    params = api.init(torch.Generator(device=card).manual_seed(0), spec)
    toks = torch.randint(0, 256, (2, 32), device=card)
    runs = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(tfa, "flash_attention_gqa", mha_ref)
        _build.LAUNCHES.clear()
        state = api.decode_state(spec, 2, 40, device=card)
        runs.append(api.apply_decode(params, spec, toks, state, 0))
        assert _build.LAUNCHES["flash_attention"] == \
            (0 if plain else spec.cfg.n_layers)
    (lk, sk), (lp, sp) = runs
    torch.testing.assert_close(lk, lp, rtol=2e-2, atol=2e-2)
    for a, b in zip(sk["kv"], sp["kv"]):
        for layer in range(spec.cfg.n_layers):
            err = (a[layer].float() - b[layer].float()).norm()
            assert err <= 2e-2 * b[layer].float().norm()


@pytest.mark.parametrize("name", ["bitonic", "transpose", "reduction"])
def test_reference_backend_on_card(card, name):
    """The seed one-warp-per-issue interpreter on CUDA tensors: gmem and
    every counter equal to "cuda_fused" on the card and to itself on the
    CPU, and no kernel launched."""
    mod = ALL[name]
    code, (grid, bd) = mod.build(32), mod.launch(32)
    g0 = mod.make_gmem(np.random.default_rng(12), 32)
    ref = MachineConfig(execute_backend="reference")
    _build.LAUNCHES.clear()
    got = scheduler.run_grid(code, grid, bd, g0.copy(), ref, n_sm=2,
                             device=card)
    assert not _build.LAUNCHES
    fused = scheduler.run_grid(code, grid, bd, g0.copy(), n_sm=2,
                               device=card)
    cpu = scheduler.run_grid(code, grid, bd, g0.copy(), ref, n_sm=2,
                             device="cpu")
    for want in (fused, cpu):
        for f in want._fields:
            np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                          np.asarray(getattr(want, f)), f)


def test_report_surface_on_card(card):
    """pad_warps, shard_sm on one card, the bucketed gmem rows, the report
    properties and to_results(host_gmem=False) on CUDA tensors, against
    the same call on the CPU."""
    specs = []
    for i, name in enumerate(("autocorr", "transpose", "bitonic")):
        mod = ALL[name]
        specs.append(scheduler.LaunchSpec(
            mod.build(32), *mod.launch(32),
            mod.make_gmem(np.random.default_rng(30 + i), 32)))
    kw = dict(n_sm=2, pad_warps=10, shard_sm=torch.cuda.device_count() == 1)
    got = scheduler.execute(specs, device=card, **kw)
    want = scheduler.execute(specs, device="cpu", **kw)
    rep, wrep = got.report(), want.report()
    assert rep.device_gmem_words == wrep.device_gmem_words == 4 * 2048
    for f in ("kernel_cycles", "busy_cycles", "padded_gmem_words",
              "occupancy", "n_steps", "n_blocks"):
        assert getattr(rep, f) == getattr(wrep, f), f
    dev = got.to_results(host_gmem=False)
    for d, h in zip(dev, want.to_results()):
        assert d.gmem.is_cuda
        np.testing.assert_array_equal(d.gmem.cpu().numpy(), h.gmem)
        np.testing.assert_array_equal(d.cycles_per_block, h.cycles_per_block)
    with pytest.raises(ValueError, match="pad_warps"):
        scheduler.execute(specs, pad_warps=4, device=card)


def _serving_work():
    from repro_torch.launch.gpgpu_serve import build_workload
    return build_workload(10, seed=3, include_compiled=False)


def _drain(work, device, policy="bucket", resident=False):
    from repro_torch import runtime as rt
    srv = rt.RuntimeServer(n_sm=2, policy=policy, resident_gmem=resident,
                           device=device)
    tickets = [srv.submit(code, grid, bd, g0.copy(), client=f"t{i % 3}")
               for i, (_, _, _, code, (grid, bd), g0) in enumerate(work)]
    results, stats = srv.drain()
    return [results[t] for t in tickets], stats


@pytest.mark.parametrize("resident", [False, True])
def test_server_drain_on_card_matches_cpu(card, resident):
    """A bucket drain of the paper programs on the card: every ticket's
    gmem and counters and the drain's accounting equal the same drain on
    the CPU plain path; every dispatch group is one fused launch, and a
    resident drain moves no gmem between host and card."""
    from repro_torch import runtime as rt
    work = _serving_work()
    want, wstats = _drain(work, "cpu")
    _build.LAUNCHES.clear()
    w = rt.TRANSFERS.window()
    got, stats = _drain(work, card, resident=resident)
    assert _build.LAUNCHES["fused_sm_run"] >= stats.n_sub_batches > 0
    assert set(_build.LAUNCHES) == {"fused_sm_run"}
    if resident:
        assert w.gmem_syncs == 0
        assert w.gmem_uploads == 0     # adopted at submit, inside window
        assert stats.pool["host_uploads"] == len(work)
    for g, h in zip(got, want):
        assert isinstance(g.gmem, torch.Tensor) == resident
        for f in h._fields:
            np.testing.assert_array_equal(
                g.gmem.cpu().numpy() if f == "gmem" and resident
                else np.asarray(getattr(g, f)), np.asarray(getattr(h, f)), f)
    for f in ("n_blocks", "n_steps", "n_sub_batches", "padded_gmem_words",
              "makespan_cycles", "busy_cycles"):
        assert getattr(stats, f) == getattr(wstats, f), f
    np.testing.assert_array_equal(stats.per_sm_cycles, wstats.per_sm_cycles)


def test_serving_loop_and_stream_events_on_card(card):
    """The loop's thread drains on the card; a Runtime stream's launch is
    done once its CUDA event has completed, and a second stream waits on
    the first's event."""
    from repro_torch import runtime as rt
    mod = ALL["reduction"]
    code, (grid, bd) = mod.build(32), mod.launch(32)
    g0 = mod.make_gmem(np.random.default_rng(0), 32)
    want = scheduler.run_grid(code, grid, bd, g0.copy(), device="cpu")
    srv = rt.RuntimeServer(n_sm=2, device=card)
    with rt.ServingLoop(srv, poll_interval_s=0.002) as loop:
        futs = [loop.submit(code, grid, bd, g0.copy()) for _ in range(4)]
        loop.quiesce()
    for f in futs:
        np.testing.assert_array_equal(f.result().gmem, want.gmem)
    runtime = rt.Runtime(n_sm=2, device=card)
    s1 = runtime.stream(g0)
    l1 = s1.launch(code, grid, bd)
    ev = s1.record_event()
    s2 = runtime.stream()
    s2.wait_event(ev)
    l2 = s2.launch(code, grid, bd, gmem=ev)
    l2.wait()
    assert l1.done() and l2.done() and ev.query()
    np.testing.assert_array_equal(l1.result().gmem, want.gmem)
    twice = scheduler.run_grid(code, grid, bd, want.gmem.copy(),
                               device="cpu")
    np.testing.assert_array_equal(l2.result().gmem, twice.gmem)
