"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips.  On a host
with an NVIDIA Hopper card and ``nvcc``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The CPU parity of the plain versions with the JAX package is in the other
``tests/test_torch_*.py`` files; ``chip_smoke.py`` drives the main path."""
import numpy as np
import pytest
import torch

from repro_torch.core import isa, machine, scheduler
from repro_torch.core.machine import MachineConfig
from repro_torch.core.programs import ALL
from repro_torch.kernels import _build
from repro_torch.kernels.ref import simt_alu_ref
from repro_torch.kernels.simt_alu import simt_alu
from test_torch_parity import out_of_range_program

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


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    z = torch.zeros((2, 32), dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        simt_alu(torch.zeros(3, dtype=torch.int32, device=card),
                 z, z, z, z, z, z)
    with pytest.raises(ValueError, match="warps"):
        scheduler.run_grid(np.asarray(ALL["bitonic"].build(32)), (1, 1),
                           33 * 32, np.zeros(64, np.int32), device=card)
