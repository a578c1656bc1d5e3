"""Seeded random straight-line and branchy programs through the port's SM
pipeline against the JAX package, bit for bit — and the helpers the other
parity tests (tests/test_torch_*.py) share: one block through both
packages, the comparison of every result, the random program generators
of tests/test_pipeline_equivalence.py (copied; that file stays as it is),
and a binary with out-of-range fields.  JAX is imported only by
jax_block, so the card's tests can use the rest without it."""
import numpy as np
import pytest

from repro_torch.core import asm, isa
from repro_torch.core import machine as tm

CONFIGS = {"baseline": {}, "sp32": dict(n_sp=32),
           "stack2": dict(warp_stack_depth=2)}
COUNTERS = ("op_issues", "op_lanes", "cycles", "stack_ops", "max_sp",
            "overflow")


def jax_block(code, bd, grid, gmem, **kw):
    from repro.core import machine as jm
    gm, gw, c = jm.run_block(code, bd, (0, 0), grid, gmem,
                             jm.MachineConfig(execute_backend="jnp", **kw))
    return np.asarray(gm), np.asarray(gw), {f: np.asarray(getattr(c, f))
                                            for f in COUNTERS}


def port_block(code, bd, grid, gmem, backend="cuda_fused", **kw):
    gm, gw, c = tm.run_block(code, bd, (0, 0), grid, gmem,
                             tm.MachineConfig(execute_backend=backend, **kw),
                             device="cpu")
    return gm.numpy(), gw.numpy(), {f: getattr(c, f).numpy()
                                    for f in COUNTERS}


def assert_same(want, got, tag):
    np.testing.assert_array_equal(got[0], want[0], err_msg=f"{tag}: gmem")
    np.testing.assert_array_equal(got[1], want[1], err_msg=f"{tag}: gw")
    for f in COUNTERS:
        np.testing.assert_array_equal(got[2][f], want[2][f],
                                      err_msg=f"{tag}: {f}")


def random_branchy(rng):
    """Nested if/else on tid with SSY scoping and an optional barrier at
    the reconvergence point (tests/test_pipeline_equivalence.py)."""
    p = asm.Program("rand-branchy")
    p.s2r("r0", isa.SR_TID)
    p.mov("r1", 0)
    uid = [0]
    with_bar = rng.random() < 0.5

    def emit_block(depth):
        for _ in range(int(rng.integers(1, 4))):
            op = [isa.IADD, isa.IMUL, isa.XOR][int(rng.integers(3))]
            p._alu(op, 1, 1, int(rng.integers(1, 98)))
        if depth < 2 and rng.random() < 0.5:
            uid[0] += 1
            tag = uid[0]
            thr = int(rng.integers(0, 41))
            cond = ["LT", "GE", "EQ", "NE"][int(rng.integers(4))]
            p.ssy(f"join{tag}")
            p.isetp("p0", "r0", thr)
            p.guard("p0", cond).bra(f"taken{tag}")
            emit_block(depth + 1)          # not-taken path
            p.bra(f"join{tag}")
            p.label(f"taken{tag}")
            emit_block(depth + 1)          # taken path
            p.label(f"join{tag}", sync=True)
            p.nop()
            if with_bar and depth == 0:
                p.bar()

    emit_block(0)
    p.stg("r0", "r1", 0)
    p.exit()
    return p.finish(pad_to=96)


_ALU_CHOICES = [isa.IADD, isa.ISUB, isa.IMUL, isa.IMIN, isa.IMAX, isa.AND,
                isa.OR, isa.XOR, isa.SHL, isa.SHR, isa.SAR, isa.IMAD]


def random_straightline(rng):
    p = asm.Program("rand-straight")
    p.s2r("r0", isa.SR_TID)
    for _ in range(int(rng.integers(3, 15))):
        op = _ALU_CHOICES[int(rng.integers(len(_ALU_CHOICES)))]
        dst = int(rng.integers(1, 8))
        s1 = int(rng.integers(0, 8))
        if op == isa.IMAD:
            p.imad(dst, s1, int(rng.integers(0, 8)),
                   int(rng.integers(0, 8)))
        else:
            s2 = (int(rng.integers(-1000, 1000)) if rng.random() < 0.5
                  else int(rng.integers(0, 8)))
            p._alu(op, dst, s1, s2)
    for r in range(8):
        p.iadd("r8", "r0", 0)
        p.shl("r8", "r8", 3)
        p.iadd("r8", "r8", r)
        p.stg("r8", r)
    p.exit()
    return p.finish(pad_to=64)


def out_of_range_program():
    """A 64-row binary whose register, predicate, condition, opcode and
    branch fields leave their ranges; 40 threads store r1..r15 at
    16 * tid + r."""
    E = isa.encode
    G, S2 = isa.FLAG_GUARD, isa.FLAG_SRC2_IMM
    rows = [
        E(isa.S2R, dst=0, imm=isa.SR_TID),
        E(isa.S2R, dst=1, imm=99),                   # selector clamps to 10
        E(isa.S2R, dst=2, imm=-5),                   # ... and to 0
        E(isa.MOV, dst=-1, src2=7, flags=S2, imm=77),   # r-1 -> r15
        E(isa.MOV, dst=20, src2=0, flags=S2, imm=55),   # dropped
        E(isa.IADD, dst=3, src1=17, src2=0, flags=S2),  # INT_MIN fill
        E(isa.IADD, dst=4, src1=-3, src2=0, flags=S2, imm=1),  # r13 + 1
        E(isa.ISETP, pdst=-2, src1=0, src2=0, flags=S2, imm=16),  # p2
        E(isa.ISETP, pdst=6, src1=0, src2=0, flags=S2, imm=3),    # dropped
        E(isa.ISET, dst=5, gpred=5, gcond=isa.COND_EQ),  # nib INT_MIN->0
        E(isa.ISET, dst=6, gpred=-2, gcond=isa.COND_LT),  # p2
        E(isa.ISET, dst=7, gpred=2, gcond=40),       # cond clamps to 15
        E(isa.ISET, dst=8, gpred=2, gcond=-5),       # -5 + 16 = 11 (HS)
        E(30, dst=9, src1=0, src2=0),                # unknown opcode
        E(-1, dst=10, src1=0, src2=0),               # wraps to BAR's slot
        E(isa.MOV, dst=11, src2=0, flags=S2 | G, imm=5, gpred=9,
          gcond=isa.COND_EQ),                        # guard on INT_MIN
    ]
    for r in (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 15):
        rows += [E(isa.SHL, dst=12, src1=0, src2=4, flags=S2, imm=4),
                 E(isa.IADD, dst=12, src1=12, src2=0, flags=S2, imm=r),
                 E(isa.STG, src1=12, src2=r, imm=0)]
    rows += [E(isa.BRA, imm=500)]                    # pc past the end
    return np.concatenate([np.stack(rows), isa.exit_pad_rows(64 - len(rows))])


@pytest.mark.parametrize("seed", range(6))
def test_random_straightline(seed):
    rng = np.random.default_rng(seed)
    code = random_straightline(rng)
    gmem = rng.integers(-1000, 1000, 40 * 8, dtype=np.int32)
    assert_same(jax_block(code, 40, (1, 1), gmem),
                port_block(code, 40, (1, 1), gmem), f"seed={seed}")


@pytest.mark.parametrize("seed", range(6))
def test_random_branchy(seed):
    rng = np.random.default_rng(seed + 100)
    code = random_branchy(rng)
    gmem = np.zeros(64, np.int32)
    assert_same(jax_block(code, 64, (1, 1), gmem),
                port_block(code, 64, (1, 1), gmem), f"seed={seed}")
