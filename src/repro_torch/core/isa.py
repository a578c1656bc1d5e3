"""G80-like integer ISA for the FlexGrip-JAX soft-SIMT overlay.

The paper's soft GPGPU supports the NVIDIA G80 integer instruction set
(compute capability 1.0); 27 instructions were exercised.  We define a
27-opcode integer ISA that covers the same functional classes:

  * integer ALU       : MOV IADD ISUB IMUL IMAD IMIN IMAX IABS
  * bitwise / shifts  : AND OR XOR NOT SHL SHR SAR
  * predicates        : ISETP (set 4-bit SZCO predicate), ISET, SELP
  * special registers : S2R (threadIdx/blockIdx/blockDim/gridDim)
  * memory            : LDG STG (global), LDS STS (shared)
  * control flow      : BRA (guarded, divergent), SSY (push reconvergence),
                        BAR (block barrier), EXIT, NOP

Instructions are encoded as rows of a ``(n, NUM_FIELDS)`` int32 array so a
*program is data*: the jit-compiled interpreter executes any binary of the
same padded length without retracing — the JAX analogue of the paper's
"new CUDA binary without FPGA recompilation" overlay property.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------- opcodes
NOP = 0
EXIT = 1
MOV = 2
IADD = 3
ISUB = 4
IMUL = 5
IMAD = 6
IMIN = 7
IMAX = 8
IABS = 9
AND = 10
OR = 11
XOR = 12
NOT = 13
SHL = 14
SHR = 15
SAR = 16
ISETP = 17
ISET = 18
SELP = 19
S2R = 20
LDG = 21
STG = 22
LDS = 23
STS = 24
BRA = 25
SSY = 26
BAR = 27

NUM_OPCODES = 28  # NOP + 27 executable instructions (paper: 27 tested)

OP_NAMES = {
    NOP: "NOP", EXIT: "EXIT", MOV: "MOV", IADD: "IADD", ISUB: "ISUB",
    IMUL: "IMUL", IMAD: "IMAD", IMIN: "IMIN", IMAX: "IMAX", IABS: "IABS",
    AND: "AND", OR: "OR", XOR: "XOR", NOT: "NOT", SHL: "SHL", SHR: "SHR",
    SAR: "SAR", ISETP: "ISETP", ISET: "ISET", SELP: "SELP", S2R: "S2R",
    LDG: "LDG", STG: "STG", LDS: "LDS", STS: "STS", BRA: "BRA",
    SSY: "SSY", BAR: "BAR",
}
OP_IDS = {v: k for k, v in OP_NAMES.items()}

# ------------------------------------------------------------- field slots
F_OP = 0      # opcode
F_DST = 1     # destination register
F_SRC1 = 2    # source register 1 (address base for LDG/STG/LDS/STS)
F_SRC2 = 3    # source register 2 (store value for STG/STS)
F_SRC3 = 4    # source register 3 (IMAD only — third-operand read port)
F_IMM = 5     # 32-bit immediate (branch target, mem offset, S2R selector)
F_FLAGS = 6   # bitfield, see below
F_GPRED = 7   # guard predicate register index (0..3)
F_GCOND = 8   # guard condition code (0..15)
F_PDST = 9    # predicate destination register for ISETP (0..3)
NUM_FIELDS = 10

# -------------------------------------------------------------- flag bits
FLAG_SRC2_IMM = 1   # src2 comes from F_IMM instead of the register file
FLAG_SYNC = 2       # this address is a reconvergence point (".S" suffix)
FLAG_GUARD = 4      # instruction is guarded by @p<GPRED>.<GCOND>
FLAG_SRC1_IMM = 8   # src1 comes from F_IMM (rare; MOV-from-imm uses SRC2)

# --------------------------------------------------- warp-stack entry types
STACK_RECONV = 0  # entry address is a reconvergence point (pushed by SSY)
STACK_TAKEN = 1   # entry address is the start of the taken branch path

# -------------------------------------------------------- condition codes
# The paper stores a 4-bit predicate (sign, zero, carry, overflow) per
# thread and resolves (predicate, condition) through a lookup table to a
# per-thread mask bit (Fig. 2).  Flag bit order below: S=1, Z=2, C=4, O=8.
COND_F = 0    # never
COND_LT = 1   # signed <    : S ^ O
COND_EQ = 2   #        =    : Z
COND_LE = 3   # signed <=   : (S ^ O) | Z
COND_GT = 4   # signed >    : ~((S ^ O) | Z)
COND_NE = 5   #        !=   : ~Z
COND_GE = 6   # signed >=   : ~(S ^ O)
COND_T = 7    # always
COND_LO = 8   # unsigned <  : C (borrow)
COND_LS = 9   # unsigned <= : C | Z
COND_HI = 10  # unsigned >  : ~(C | Z)
COND_HS = 11  # unsigned >= : ~C

COND_NAMES = {
    COND_F: "F", COND_LT: "LT", COND_EQ: "EQ", COND_LE: "LE",
    COND_GT: "GT", COND_NE: "NE", COND_GE: "GE", COND_T: "T",
    COND_LO: "LO", COND_LS: "LS", COND_HI: "HI", COND_HS: "HS",
}
COND_IDS = {v: k for k, v in COND_NAMES.items()}


def build_cond_lut() -> np.ndarray:
    """(16, 16) bool LUT: [condition, SZCO-flag-nibble] -> mask bit.

    This is the hardware lookup table of Fig. 2 that combines the stored
    4-bit predicate with the branch condition to produce one mask bit per
    thread.
    """
    lut = np.zeros((16, 16), dtype=bool)
    for flags in range(16):
        s = bool(flags & 1)
        z = bool(flags & 2)
        c = bool(flags & 4)
        o = bool(flags & 8)
        lt = s ^ o
        lut[COND_F, flags] = False
        lut[COND_LT, flags] = lt
        lut[COND_EQ, flags] = z
        lut[COND_LE, flags] = lt or z
        lut[COND_GT, flags] = not (lt or z)
        lut[COND_NE, flags] = not z
        lut[COND_GE, flags] = not lt
        lut[COND_T, flags] = True
        lut[COND_LO, flags] = c
        lut[COND_LS, flags] = c or z
        lut[COND_HI, flags] = not (c or z)
        lut[COND_HS, flags] = not c
        for spare in range(12, 16):
            lut[spare, flags] = True
    return lut


COND_LUT = build_cond_lut()

# ------------------------------------------------------ special registers
SR_TIDX = 0    # threadIdx.x
SR_TIDY = 1    # threadIdx.y
SR_CTAX = 2    # blockIdx.x
SR_CTAY = 3    # blockIdx.y
SR_NTIDX = 4   # blockDim.x
SR_NTIDY = 5   # blockDim.y
SR_NCTAX = 6   # gridDim.x
SR_NCTAY = 7   # gridDim.y
SR_TID = 8     # flat thread id within the block
SR_CTA = 9     # flat block id
SR_NTID = 10   # flat block size

# Opcode classes used by the energy model and the customization analyzer.
ALU_OPS = (MOV, IADD, ISUB, IMIN, IMAX, IABS, AND, OR, XOR, NOT, SHL, SHR,
           SAR, ISET, SELP, S2R)
MUL_OPS = (IMUL, IMAD)
GMEM_OPS = (LDG, STG)
SMEM_OPS = (LDS, STS)
CTRL_OPS = (BRA, SSY, BAR, EXIT, NOP)
PRED_OPS = (ISETP,)

# ---------------------------------------------------- opcode-class tables
# Dense boolean tables indexed by opcode, for vectorized dispatch: the
# all-warp pipeline classifies a (W,)-vector of fetched opcodes with one
# gather instead of ``isin`` chains.  Built once at import; the machine
# converts them to device arrays.
WRITES_REG = np.zeros(NUM_OPCODES, dtype=bool)
WRITES_REG[list(ALU_OPS) + list(MUL_OPS) + [LDG, LDS]] = True

IS_GMEM = np.zeros(NUM_OPCODES, dtype=bool)
IS_GMEM[list(GMEM_OPS)] = True

IS_SMEM = np.zeros(NUM_OPCODES, dtype=bool)
IS_SMEM[list(SMEM_OPS)] = True


def _table_mask(table: np.ndarray) -> int:
    """Fold a <=31-entry bool opcode table into a scalar int bitmask, so
    pipeline stages can test membership with ``(mask >> op) & 1`` — a
    scalar constant, usable inside Pallas kernel bodies where captured
    array constants are rejected (NUM_OPCODES=28 fits int32)."""
    return int(sum(1 << i for i, v in enumerate(table) if v))


WRITES_REG_MASK = _table_mask(WRITES_REG)
IS_GMEM_MASK = _table_mask(IS_GMEM)
IS_SMEM_MASK = _table_mask(IS_SMEM)

WARP_SIZE = 32


def encode(op, dst=0, src1=0, src2=0, src3=0, imm=0, flags=0, gpred=0,
           gcond=COND_T, pdst=0) -> np.ndarray:
    """Encode one instruction as a NUM_FIELDS int32 row."""
    row = np.zeros(NUM_FIELDS, dtype=np.int32)
    row[F_OP] = op
    row[F_DST] = dst
    row[F_SRC1] = src1
    row[F_SRC2] = src2
    row[F_SRC3] = src3
    row[F_IMM] = np.int32(np.uint32(imm & 0xFFFFFFFF))
    row[F_FLAGS] = flags
    row[F_GPRED] = gpred
    row[F_GCOND] = gcond
    row[F_PDST] = pdst
    return row


def exit_pad_rows(n: int) -> np.ndarray:
    """``(n, NUM_FIELDS)`` of EXIT rows encoded exactly like an emitted
    EXIT (gcond T), so padded listings round-trip through
    ``decode_str``/``assemble``.  The single source of trap padding for
    ``asm.Program.finish`` and ``runtime.registry.pad_code``."""
    pad = np.zeros((n, NUM_FIELDS), np.int32)
    pad[:, F_OP] = EXIT
    pad[:, F_GCOND] = COND_T
    return pad


def decode_str(row) -> str:
    """Human-readable disassembly of one encoded instruction row.

    The output is *assembler-grade*: for every instruction the text
    assembler can express, ``asm.assemble(decode_str(row))`` re-encodes
    the identical row (pinned by the round-trip property tests in
    ``tests/test_asm_roundtrip.py``) — branch targets print as numeric
    addresses, MOV prints its real operand count, and ISET/SELP print
    their predicate-source fields.
    """
    op = int(row[F_OP])
    name = OP_NAMES.get(op, f"OP{op}")
    parts = [name]
    fl = int(row[F_FLAGS])
    if fl & FLAG_SYNC:
        parts[0] += ".S"
    guard = ""
    if fl & FLAG_GUARD:
        guard = f"@p{int(row[F_GPRED])}.{COND_NAMES.get(int(row[F_GCOND]), '?')} "
    src2i = f"#{int(row[F_IMM])}" if fl & FLAG_SRC2_IMM \
        else f"r{int(row[F_SRC2])}"
    if op in (BRA, SSY):
        parts.append(str(int(row[F_IMM])))
    elif op == S2R:
        parts.append(f"r{int(row[F_DST])}, sr{int(row[F_IMM])}")
    elif op in (LDG, LDS):
        parts.append(f"r{int(row[F_DST])}, [r{int(row[F_SRC1])}+{int(row[F_IMM])}]")
    elif op in (STG, STS):
        parts.append(f"[r{int(row[F_SRC1])}+{int(row[F_IMM])}], r{int(row[F_SRC2])}")
    elif op == ISETP:
        parts.append(f"p{int(row[F_PDST])}, r{int(row[F_SRC1])}, {src2i}")
    elif op == MOV:
        parts.append(f"r{int(row[F_DST])}, {src2i}")
    elif op == ISET:
        parts.append(f"r{int(row[F_DST])}, p{int(row[F_GPRED])}, "
                     f"{COND_NAMES.get(int(row[F_GCOND]), '?')}")
    elif op == SELP:
        parts.append(f"r{int(row[F_DST])}, r{int(row[F_SRC1])}, "
                     f"r{int(row[F_SRC2])}, p{int(row[F_GPRED])}, "
                     f"{COND_NAMES.get(int(row[F_GCOND]), '?')}")
    elif op in (NOT, IABS):
        parts.append(f"r{int(row[F_DST])}, r{int(row[F_SRC1])}")
    elif op in (EXIT, NOP, BAR):
        pass
    else:
        ops = [f"r{int(row[F_DST])}", f"r{int(row[F_SRC1])}", src2i]
        if op == IMAD:
            ops.append(f"r{int(row[F_SRC3])}")
        parts.append(", ".join(ops))
    return guard + " ".join(parts)
