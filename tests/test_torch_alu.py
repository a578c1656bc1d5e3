"""The execute-stage ALU of the port against the JAX package: the plain
``simt_alu_ref`` (and the ``simt_alu`` wrapper on CPU tensors, which runs
it) against ``repro.kernels.ref.simt_alu_ref`` and the Pallas
``simt_alu`` in interpret mode, bit for bit, over the opcode and shape
sweep of ``tests/test_kernels.py`` plus int32 edge values.  The CUDA
header's ISA constants are held to ``isa.py`` here, since the CUDA
kernels themselves only run on the card."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.simt_alu import simt_alu as pallas_simt_alu
from repro_torch.core import isa
from repro_torch.core.pipeline import fused
from repro_torch.kernels import _build
from repro_torch.kernels.ref import simt_alu_ref
from repro_torch.kernels.simt_alu import simt_alu

OPCODES = [isa.MOV, isa.IADD, isa.ISUB, isa.IMUL, isa.IMAD, isa.IMIN,
           isa.IMAX, isa.IABS, isa.AND, isa.OR, isa.XOR, isa.NOT, isa.SHL,
           isa.SHR, isa.SAR, isa.ISETP, isa.ISET, isa.SELP, isa.S2R]
INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1
EDGES = [0, 1, -1, INT32_MIN, INT32_MAX, 31, 32, -32, 2, 0x55555555]
CSRC = Path(_build.CSRC)


def _inputs(rng, W, L):
    s1 = rng.integers(-2 ** 31, 2 ** 31 - 1, (W, L)).astype(np.int32)
    s2 = rng.integers(-2 ** 31, 2 ** 31 - 1, (W, L)).astype(np.int32)
    s3 = rng.integers(-999, 999, (W, L)).astype(np.int32)
    cond = (rng.random((W, L)) > 0.5).astype(np.int32)
    s2r = rng.integers(0, 1024, (W, L)).astype(np.int32)
    mask = (rng.random((W, L)) > 0.25).astype(np.int32)
    return s1, s2, s3, cond, s2r, mask


def _port(op, args, **kw):
    t = [torch.as_tensor(x) for x in (op,) + tuple(args)]
    a = simt_alu_ref(*t, **kw)
    b = simt_alu(*t, **kw)                # CPU tensors: the plain version
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    return [x.numpy() for x in a]


def _jax_ref(op, args, **kw):
    return [np.asarray(x) for x in
            jref.simt_alu_ref(*(jnp.asarray(x) for x in (op,) + tuple(args)),
                              **kw)]


@pytest.mark.parametrize("opc", OPCODES)
def test_opcode_matches_reference_and_pallas(opc, rng):
    W, L = 9, 32
    op = np.full(W, opc, np.int32)
    args = _inputs(rng, W, L)
    got = _port(op, args)
    for want in (_jax_ref(op, args),
                 [np.asarray(x) for x in
                  pallas_simt_alu(op, *args, interpret=True)]):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("enable_mul", [True, False])
@pytest.mark.parametrize("nro", [2, 3])
def test_edge_values_every_opcode(enable_mul, nro, rng):
    """Every pair of edge values (INT_MIN, INT_MAX, +-1, shift counts 0,
    31, 32, -1 ...) under every opcode, out-of-range opcodes included."""
    pairs = np.array([(a, b) for a in EDGES for b in EDGES], np.int64)
    ops = list(range(isa.NUM_OPCODES)) + [-1, isa.NUM_OPCODES, 40]
    W, L = len(ops) * 4, 32                # 4 rows of 32 lanes per opcode
    s1 = np.resize(pairs[:, 0], (W, L)).astype(np.int32)
    s2 = np.resize(pairs[:, 1], (W, L)).astype(np.int32)
    _, _, s3, cond, s2r, mask = _inputs(rng, W, L)
    op = np.repeat(np.asarray(ops, np.int32), 4)
    args = (s1, s2, s3, cond, s2r, mask)
    kw = dict(enable_mul=enable_mul, num_read_operands=nro)
    got = _port(op, args, **kw)
    want = _jax_ref(op, args, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    pal = pallas_simt_alu(op, *args, interpret=True, **kw)
    np.testing.assert_array_equal(got[0], np.asarray(pal[0]))
    np.testing.assert_array_equal(got[1], np.asarray(pal[1]))


def test_iabs_int_min_and_shifts():
    op = np.array([isa.IABS, isa.SHL, isa.SHR, isa.SAR], np.int32)
    s1 = np.full((4, 1), INT32_MIN, np.int32)
    s2 = np.full((4, 1), 33, np.int32)    # shift count 33 & 31 = 1
    z = np.zeros((4, 1), np.int32)
    out, _ = _port(op, (s1, s2, z, z, z, np.ones((4, 1), np.int32)))
    assert out[:, 0].tolist() == [INT32_MIN, 0, 2 ** 30, -2 ** 30]


def test_mul_and_third_port_removed(rng):
    W, L = 4, 32
    s1 = rng.integers(-99, 99, (W, L)).astype(np.int32)
    s2 = rng.integers(-99, 99, (W, L)).astype(np.int32)
    s3 = rng.integers(1, 99, (W, L)).astype(np.int32)
    z, ones = np.zeros((W, L), np.int32), np.ones((W, L), np.int32)
    imul = np.full(W, isa.IMUL, np.int32)
    imad = np.full(W, isa.IMAD, np.int32)
    assert (_port(imul, (s1, s2, z, z, z, ones), enable_mul=False)[0]
            == 0).all()
    assert (_port(imad, (s1, s2, s3, z, z, ones), num_read_operands=2)[0]
            == 0).all()
    np.testing.assert_array_equal(
        _port(imad, (s1, s2, s3, z, z, ones))[0], s1 * s2 + s3)


@pytest.mark.parametrize("seed", range(6))
def test_shape_sweep(seed):
    rng = np.random.default_rng(seed)
    W, L = int(rng.integers(1, 41)), int(rng.integers(1, 33))
    op = rng.choice([isa.IADD, isa.XOR, isa.SHL, isa.ISETP, isa.IMAD],
                    W).astype(np.int32)
    args = _inputs(rng, W, L)
    got = _port(op, args)
    want = [np.asarray(x) for x in pallas_simt_alu(op, *args,
                                                   interpret=True)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_cpu_tensors_never_launch():
    _build.LAUNCHES.clear()
    z = torch.zeros((2, 32), dtype=torch.int32)
    simt_alu(torch.zeros(2, dtype=torch.int32), z, z, z, z, z, z)
    assert sum(_build.LAUNCHES.values()) == 0


def _constexprs(text):
    return {k: int(v, 0) for k, v in
            re.findall(r"\b([A-Z][A-Z0-9_]*)\s*=\s*(0x[0-9A-Fa-f]+|\d+)\b",
                       text)}


def test_cuda_header_constants_match_isa():
    consts = _constexprs((CSRC / "alu_datapath.cuh").read_text())
    names = [n for n in dir(isa) if n.isupper()
             and isinstance(getattr(isa, n), int) and n in consts]
    assert len(names) > 40
    for n in names:
        assert consts[n] == getattr(isa, n), n
    assert consts["NUM_SPECIAL_REGS"] == isa.SR_NTID + 1


def test_fused_kernel_layout_matches_wrapper():
    """The counter and geometry columns the CUDA kernel writes and reads
    are the ones the Python wrapper names."""
    text = (CSRC / "fused_sm.cu").read_text()
    geom = re.findall(r"\bG_([A-Z]+) = (\d+)", text)
    assert [int(i) for _, i in geom] == list(range(len(fused.GEOM_FIELDS)))
    assert [n.lower() for n, _ in geom] == \
        ["launch", "bdim", "bdx", "bdy", "bx", "by", "gx", "gy"]
    offs = dict(re.findall(r"\b([A-Z_]+) = C_CYCLES \+ (\d)", text))
    assert {k: int(v) for k, v in offs.items()} == {
        "C_STACK_OPS": fused.C_STACK_OPS - fused.C_CYCLES,
        "C_MAX_SP": fused.C_MAX_SP - fused.C_CYCLES,
        "C_OVERFLOW": fused.C_OVERFLOW - fused.C_CYCLES,
        "C_STEPS": fused.C_STEPS - fused.C_CYCLES,
        "C_STORE_STEPS": fused.C_STORE_STEPS - fused.C_CYCLES,
        "N_CTR": fused.N_CTR - fused.C_CYCLES}
    assert "C_CYCLES = 2 * isa::NUM_OPCODES" in text
