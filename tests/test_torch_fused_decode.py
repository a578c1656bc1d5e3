"""The fused kernel's predecoded instruction records
(``repro_torch.core.pipeline.fused.predecode``) against what the plain
pipeline stages derive from the raw instructions.

Every record is unpacked and each field held against the stages: one probe
warp per instruction (warp w at pc w) goes through ``fetch_decode`` and
``read_operands``; ``write_back`` runs with every lane executing a marker
result; ``control`` runs once per warp, that warp alone issuing.  The
programs are the five paper programs, the three compiled kernels, the
seeded random programs of tests/test_torch_parity.py and a binary with
out-of-range fields under three configurations.  The record layout the
CUDA kernel reads is held to the wrapper's constants."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import isa
from repro_torch.core.pipeline import (MachineConfig, cond_lut,
                                       control, execute, fetch_decode,
                                       init_state, read_operands, write_back)
from repro_torch.core.pipeline import fused
from repro_torch.core.pipeline.state import INT32_MIN, opcode_in
from repro_torch.core.programs import ALL
from test_torch_parity import (out_of_range_program, random_branchy,
                               random_straightline)

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
CONFIGS = {"baseline": {}, "n_regs8": dict(n_regs=8),
           "stack2": dict(warp_stack_depth=2)}
#: the compiled kernels at the sizes of tests/test_torch_compiled.py
COMPILED_SIZES = {"histogram": 32, "scan": 64, "spmv": 128}
CASES = ([(f"paper-{n}", "baseline") for n in sorted(ALL)]
         + [(f"compiled-{n}", "baseline") for n in sorted(COMPILED_SIZES)]
         + [(f"straight-{s}", "baseline") for s in range(6)]
         + [(f"branchy-{s}", "baseline") for s in range(6)]
         + [("out_of_range", c) for c in sorted(CONFIGS)])
#: the probe block's geometry: block (48, 3), block index (2, 5), grid (7, 11)
GEOM = ((48, 3), (2, 5), (7, 11))


def program(case):
    kind, _, arg = case.partition("-")
    if kind == "paper":
        return ALL[arg].build(32)
    if kind == "compiled":
        from repro.compiler.kernels import COMPILED as JCOMPILED
        from repro_torch.compiler.kernels import COMPILED
        code = COMPILED[arg].build(COMPILED_SIZES[arg])
        np.testing.assert_array_equal(
            code, JCOMPILED[arg].build(COMPILED_SIZES[arg]))
        return code
    if kind == "straight":
        return random_straightline(np.random.default_rng(int(arg)))
    if kind == "branchy":
        return random_branchy(np.random.default_rng(int(arg) + 100))
    return out_of_range_program()


def unpack(rec):
    """(C, 4) int32 records -> dict of (C,) int64 fields."""
    imm = rec[:, 0].long()
    regs, ctl, lut = (rec[:, i].long() & 0xFFFFFFFF for i in (1, 2, 3))
    return dict(
        imm=imm, dst=regs & 255, src1=(regs >> 8) & 255,
        src2=(regs >> 16) & 255, src3=regs >> 24, op=ctl & 31,
        ctr=(ctl >> fused.REC_CTR) & 31, pdst=(ctl >> fused.REC_PDST) & 7,
        gpred=(ctl >> fused.REC_GPRED) & 7, sel=(ctl >> fused.REC_SEL) & 15,
        flags=(ctl >> fused.REC_FLAGS) & 15,
        wreg=(ctl >> fused.REC_WREG) & 1, wpred=(ctl >> fused.REC_WPRED) & 1,
        load=(ctl >> fused.REC_LOAD) & 1, store=(ctl >> fused.REC_STORE) & 1,
        control=(ctl >> fused.REC_CONTROL) & 1, lut=lut & 0xFFFF,
        cost=lut >> fused.REC_COST)


def probe_state(cfg, C):
    """C warps, all READY, every lane alive; register r of lane l holds
    1000 r + l + 1, predicate p of lane l the nibble (l + 5 p) % 16, and
    each warp's stack one RECONV entry over all lanes, so that a .S
    instruction pops."""
    W, R = C, cfg.n_regs
    st = init_state(cfg, W, W * 32, torch.zeros(max(W, 64), dtype=torch.int32))
    lane = torch.arange(32)[None, :, None]
    regs = (1000 * torch.arange(R)[None, None, :] + lane + 1).expand(W, 32, R)
    pred = ((lane + 5 * torch.arange(4)[None, None, :]) % 16).expand(W, 32, 4)
    mask = st.stack_mask.clone()
    mask[:, 0] = -1
    return st._replace(
        pc=torch.arange(W, dtype=torch.int32),
        regs=regs.to(torch.int32).contiguous(),
        pred=pred.to(torch.int32).contiguous(), stack_mask=mask,
        stack_type=torch.full_like(st.stack_type, isa.STACK_RECONV),
        sp=torch.ones(W, dtype=torch.int32))


def gathered(x, idx, none):
    """x (W, 32, K) column idx[w] of each warp; INT32_MIN where none."""
    i = torch.where(idx == none, 0, idx)[:, None, None].expand(-1, 32, 1)
    col = torch.gather(x, 2, i)[..., 0]
    return torch.where((idx == none)[:, None], INT32_MIN, col)


def special_registers(W):
    """(11, W, 32): the S2R values of read.py for the probe geometry."""
    (bdx, bdy), (bx, by), (gx, gy) = GEOM
    tid = torch.arange(W * 32).reshape(W, 32)
    full = [torch.full_like(tid, v) for v in (bx, by, bdx, bdy, gx, gy)]
    return torch.stack([tid % bdx, tid // bdx] + full
                       + [tid, torch.full_like(tid, by * gx + bx),
                          torch.full_like(tid, bdx * bdy)])


def eq(got, want, what):
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    assert torch.equal(got.long(), want.long()), \
        f"{what}: record {got.tolist()} != stages {want.tolist()}"


@pytest.mark.parametrize("case,cfg_name", CASES)
def test_records_match_the_stages(case, cfg_name):
    cfg = MachineConfig(**CONFIGS[cfg_name])
    code = torch.as_tensor(program(case))
    C, R = code.shape[0], cfg.n_regs
    rec = fused.predecode(code[None], cfg)
    assert rec.dtype == torch.int32 and rec.shape == (1, C, 4)
    f = unpack(rec[0])
    st = probe_state(cfg, C)
    dec = fetch_decode(code, st)
    ops = read_operands(cfg, cond_lut("cpu"), *GEOM, st, dec)

    # fetch / decode
    eq(f["imm"], dec.imm, "imm")
    known = (dec.op >= 0) & (dec.op < isa.NUM_OPCODES)
    eq(f["op"], torch.where(known, dec.op, fused.OP_NONE), "op")
    eq(f["flags"], dec.flags & fused.FLAG_BITS, "flags")
    eq(f["flags"] & isa.FLAG_GUARD != 0, dec.guarded, "guard")
    eq(f["flags"] & isa.FLAG_SYNC != 0, dec.do_pop, ".S pop")
    # the execute stage gives the same on the record's opcode as on the raw
    for a, b in zip(execute(cfg, dec._replace(op=f["op"].int()), ops),
                    execute(cfg, dec, ops)):
        eq(a, b, "execute on the record's opcode")
    # ... and merges the memory read ports where the record says load
    marker = torch.full((C, 32), INT32_MIN + 12345, dtype=torch.int32)
    res, _ = execute(cfg, dec, ops._replace(ld_g=marker, ld_s=marker))
    eq(f["load"], (res == marker).all(1), "load")

    # read: operand gathers, guard LUT, S2R selector
    imm = f["imm"][:, None]
    for k, flag in (("src1", isa.FLAG_SRC1_IMM), ("src2", isa.FLAG_SRC2_IMM)):
        want = getattr(ops, "s" + k[-1])
        eq(torch.where((f["flags"] & flag != 0)[:, None], imm,
                       gathered(st.regs, f[k], fused.REG_NONE)), want, k)
    eq(gathered(st.regs, f["src3"], fused.REG_NONE), ops.s3, "src3")
    nib = gathered(st.pred, f["gpred"], fused.PRED_NONE)
    nib = torch.where(nib == INT32_MIN, 0, nib)
    eq((f["lut"][:, None] >> nib) & 1, ops.cond_val, "guard LUT row")
    eq(special_registers(C)[f["sel"], torch.arange(C)], ops.s2r_val, "S2R")

    # write: every lane executes; warp w stores to word w
    everyone = torch.ones((C, 32), dtype=torch.bool)
    word = torch.arange(C)[:, None].expand(C, 32)
    wb = write_back(cfg, st, dec, ops._replace(
        exec_mask=everyone, gaddr=word, saddr=word,
        s2=torch.full((C, 32), -5, dtype=torch.int32)),
        torch.full((C, 32), -7, dtype=torch.int32),
        torch.full((C, 32), 99, dtype=torch.int32))
    want_reg = torch.zeros((C, R), dtype=torch.bool)
    hit = f["wreg"] == 1
    want_reg[hit, f["dst"][hit]] = True
    eq((wb.regs != st.regs)[:, 0], want_reg, "dst / writes a register")
    eq(f["wreg"], opcode_in(isa.WRITES_REG_MASK, dec.op)
       & (f["dst"] != fused.REG_NONE), "writes a register")
    want_pred = torch.zeros((C, 4), dtype=torch.bool)
    hit = f["wpred"] == 1
    want_pred[hit, f["pdst"][hit]] = True
    eq((wb.pred != st.pred)[:, 0], want_pred, "pdst / writes a predicate")
    stored = wb.gw[:C] | (wb.smem[:C] != st.smem[:C])
    eq(f["store"], stored, "store")

    # control: each warp alone; its counter column and its cycle cost, and
    # an instruction the record does not mark as control moves to pc + 1
    # and changes no other control state
    for w in range(C):
        one = torch.arange(C) == w
        pc, alive, active, wstate, *stacks, sp, c = control(
            cfg, st, dec._replace(issued=one, exec_this=one,
                                  do_pop=dec.do_pop & one),
            ops._replace(exec_mask=ops.exec_mask & one[:, None]))
        want = torch.zeros(isa.NUM_OPCODES, dtype=torch.int32)
        if f["ctr"][w] != fused.CTR_NONE:
            want[f["ctr"][w]] = 1
        eq(c.op_issues, want, f"counter column of pc {w}")
        eq(c.cycles, f["cost"][w], f"cost of pc {w}")
        if not f["control"][w]:
            eq(pc[w], w + 1, f"next pc of pc {w}")
            assert torch.equal(alive, st.alive) and torch.equal(
                active, dec.active) and torch.equal(wstate, st.wstate), w
            assert all(torch.equal(a, b) for a, b in zip(
                stacks, (st.stack_addr, st.stack_type, st.stack_mask))), w
            eq(sp[w], dec.sp[w], f"sp of pc {w}")
            eq(c.stack_ops, 0, f"stack ops of pc {w}")


def test_predecode_batches_programs():
    """(L, C, 10) in, (L, C, 4) out: each program's records are its own."""
    codes = torch.as_tensor(np.stack([ALL[n].build(32) for n in sorted(ALL)]))
    cfg = MachineConfig()
    rec = fused.predecode(codes, cfg)
    for i in range(len(codes)):
        assert torch.equal(rec[i], fused.predecode(codes[i][None], cfg)[0])


@pytest.mark.parametrize("kw", [dict(n_regs=255), dict(n_regs=1000),
                                dict(mem_latency_global=70_000),
                                dict(mem_latency_shared=-1)])
def test_predecode_raises_on_what_does_not_fit(kw):
    code = torch.as_tensor(ALL["matmul"].build(32))[None]
    with pytest.raises(ValueError, match="predecode"):
        fused.predecode(code, MachineConfig(**kw))


def test_record_layout_matches_the_kernel():
    """The record fields and sentinels the CUDA kernel reads are the ones
    predecode writes."""
    text = (CSRC / "fused_sm.cu").read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"\b((?:REC|REG|PRED|OP|CTR)_[A-Z_]+) = (\d+)",
                         text)}
    names = [n for n in dir(fused) if n.startswith(
        ("REC_", "REG_NONE", "PRED_NONE", "OP_NONE", "CTR_NONE"))]
    assert len(names) == 15
    assert sorted(consts) == sorted(names)
    for n in names:
        assert consts[n] == getattr(fused, n), n
