"""Assembler for the FlexGrip-JAX mini-ISA.

Two front ends:

* :class:`Program` — a builder API used by the benchmark kernels
  (``p.iadd("r3", "r1", "r2")`` style, with labels for control flow).
* :func:`assemble` — a text assembler for CUDA-SASS-like listings, e.g.::

      SSY done
      S2R    r0, sr8          ; r0 = flat threadIdx
      ISETP  p0, r0, #16
      @p0.GE BRA skip
      LDG    r1, [r0+0]
      IADD   r1, r1, #1
      STG    [r0+0], r1
  skip.S:
      EXIT

The paper's point is that compiling a kernel takes under a second versus
hours of FPGA synthesis; here assembly is microseconds and — more to the
point — the produced binary runs on the *already-jitted* interpreter.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Union

import numpy as np

from . import isa

Reg = Union[str, int]


class AsmError(Exception):
    """An assembly-time rejection with an actionable message: bad
    register names, duplicate or undefined labels, out-of-range
    immediates, unknown mnemonics.  Subclasses ``KeyError`` via
    :class:`UndefinedLabel` where historical callers catch that."""


class UndefinedLabel(AsmError, KeyError):
    """A branch references a label no line defines."""

    def __str__(self):          # KeyError would repr() the message
        return self.args[0] if self.args else ""


#: register index must fit the encoding's int32 field sanely; the
#: machine's real file is MachineConfig.n_regs (default 16) / 4 preds,
#: but the assembler only rejects what could never be configured
MAX_REG = 255
MAX_PRED = 3


def _reg(r: Reg, pred: bool = False) -> int:
    if isinstance(r, str):
        kind = "p" if pred else "r"
        if not r or r[0] != kind or not r[1:].isdigit():
            raise AsmError(
                f"bad {'predicate ' if pred else ''}register {r!r}: "
                f"expected {kind}<index> (e.g. {kind}{0})")
        idx = int(r[1:])
    else:
        idx = int(r)
    bound = MAX_PRED if pred else MAX_REG
    if not 0 <= idx <= bound:
        raise AsmError(
            f"register index {idx} out of range 0..{bound} "
            f"({'predicate file' if pred else 'register file'})")
    return idx


def _imm32(v: int) -> int:
    if not -(1 << 31) <= v < (1 << 32):
        raise AsmError(
            f"immediate {v} does not fit in 32 bits "
            f"(range {-(1 << 31)}..{(1 << 32) - 1})")
    return int(v)


class Program:
    """Instruction-builder with label fixup; emits an (n, NUM_FIELDS) array."""

    def __init__(self, name: str = "kernel"):
        self.name = name
        self.rows: List[np.ndarray] = []
        self.labels: Dict[str, int] = {}
        self._fixups: List = []  # (row_index, label)
        self._guard: Optional[tuple] = None
        self._sync_next = False

    # ------------------------------------------------------------ plumbing
    def label(self, name: str, sync: bool = False) -> None:
        """Define a label at the current address; ``sync=True`` marks the
        next emitted instruction as a reconvergence point (``.S``)."""
        if name in self.labels:
            raise AsmError(
                f"duplicate label {name!r} in {self.name}: first "
                f"defined at address {self.labels[name]}, redefined at "
                f"{len(self.rows)}")
        self.labels[name] = len(self.rows)
        if sync:
            self._sync_next = True

    def guard(self, pred: Reg, cond: str) -> "Program":
        """Guard the next instruction: ``p.guard('p0','LT').bra('loop')``."""
        self._guard = (_reg(pred, pred=True), self._cond(cond))
        return self

    @staticmethod
    def _cond(cond: str) -> int:
        try:
            return isa.COND_IDS[cond]
        except KeyError:
            raise AsmError(
                f"unknown condition code {cond!r}; choose from "
                f"{sorted(isa.COND_IDS)}") from None

    def _emit(self, op, dst=0, src1=0, src2=0, src3=0, imm=0, flags=0,
              pdst=0, label=None):
        gpred, gcond = 0, isa.COND_T
        if self._guard is not None:
            gpred, gcond = self._guard
            flags |= isa.FLAG_GUARD
            self._guard = None
        if self._sync_next:
            flags |= isa.FLAG_SYNC
            self._sync_next = False
        row = isa.encode(op, dst, src1, src2, src3, _imm32(imm), flags,
                         gpred, gcond, pdst)
        if label is not None:
            self._fixups.append((len(self.rows), label))
        self.rows.append(row)

    # --------------------------------------------------------------- ALU
    def _alu(self, op, dst, s1, s2, s3=0):
        flags = 0
        if isinstance(s2, int):
            flags, imm, s2r = isa.FLAG_SRC2_IMM, s2, 0
        else:
            imm, s2r = 0, _reg(s2)
        self._emit(op, _reg(dst), _reg(s1), s2r, _reg(s3) if s3 else 0,
                   imm, flags)

    def mov(self, dst, src):
        if isinstance(src, int):
            self._emit(isa.MOV, _reg(dst), 0, 0, imm=src,
                       flags=isa.FLAG_SRC2_IMM)
        else:
            self._emit(isa.MOV, _reg(dst), 0, _reg(src))

    def iadd(self, d, a, b): self._alu(isa.IADD, d, a, b)
    def isub(self, d, a, b): self._alu(isa.ISUB, d, a, b)
    def imul(self, d, a, b): self._alu(isa.IMUL, d, a, b)
    def imin(self, d, a, b): self._alu(isa.IMIN, d, a, b)
    def imax(self, d, a, b): self._alu(isa.IMAX, d, a, b)
    def and_(self, d, a, b): self._alu(isa.AND, d, a, b)
    def or_(self, d, a, b): self._alu(isa.OR, d, a, b)
    def xor(self, d, a, b): self._alu(isa.XOR, d, a, b)
    def shl(self, d, a, b): self._alu(isa.SHL, d, a, b)
    def shr(self, d, a, b): self._alu(isa.SHR, d, a, b)
    def sar(self, d, a, b): self._alu(isa.SAR, d, a, b)

    def not_(self, d, a):
        self._emit(isa.NOT, _reg(d), _reg(a))

    def iabs(self, d, a):
        self._emit(isa.IABS, _reg(d), _reg(a))

    def imad(self, d, a, b, c):
        """d = a * b + c — the only 3-operand instruction (third read port)."""
        self._emit(isa.IMAD, _reg(d), _reg(a), _reg(b), _reg(c))

    # -------------------------------------------------------- predicates
    def isetp(self, pdst, a, b):
        """Set predicate ``pdst`` to the SZCO flags of (a - b)."""
        flags = 0
        if isinstance(b, int):
            flags, imm, s2 = isa.FLAG_SRC2_IMM, b, 0
        else:
            imm, s2 = 0, _reg(b)
        self._emit(isa.ISETP, 0, _reg(a), s2, imm=imm, flags=flags,
                   pdst=_reg(pdst, pred=True))

    def iset(self, dst, pred, cond):
        """dst = LUT[cond, pred] ? 1 : 0 (materialize a predicate).

        Reads the predicate fields as a *source* (no FLAG_GUARD — lanes
        where the condition is false still execute and write 0).
        """
        self._emit(isa.ISET, _reg(dst), 0, 0)
        self.rows[-1][isa.F_GPRED] = _reg(pred, pred=True)
        self.rows[-1][isa.F_GCOND] = self._cond(cond)

    def selp(self, dst, a, b, pred, cond):
        """dst = cond(pred) ? a : b (predicate as source, not guard)."""
        self._emit(isa.SELP, _reg(dst), _reg(a), _reg(b))
        self.rows[-1][isa.F_GPRED] = _reg(pred, pred=True)
        self.rows[-1][isa.F_GCOND] = self._cond(cond)

    # ------------------------------------------------------------ special
    def s2r(self, dst, sr: int):
        self._emit(isa.S2R, _reg(dst), imm=sr)

    # ------------------------------------------------------------- memory
    def ldg(self, dst, base, off=0): self._emit(isa.LDG, _reg(dst), _reg(base), imm=off)
    def stg(self, base, val, off=0): self._emit(isa.STG, 0, _reg(base), _reg(val), imm=off)
    def lds(self, dst, base, off=0): self._emit(isa.LDS, _reg(dst), _reg(base), imm=off)
    def sts(self, base, val, off=0): self._emit(isa.STS, 0, _reg(base), _reg(val), imm=off)

    # ------------------------------------------------------- control flow
    def bra(self, label: Union[str, int]):
        """Branch to a label, or directly to a numeric address (the
        form ``decode_str`` prints, so listings re-assemble)."""
        if isinstance(label, int):
            self._emit(isa.BRA, imm=label)
        else:
            self._emit(isa.BRA, label=label)

    def ssy(self, label: Union[str, int]):
        """Push the reconvergence point for the next divergent branch."""
        if isinstance(label, int):
            self._emit(isa.SSY, imm=label)
        else:
            self._emit(isa.SSY, label=label)

    def bar(self):
        self._emit(isa.BAR)

    def exit(self):
        self._emit(isa.EXIT)

    def nop(self):
        self._emit(isa.NOP)

    # -------------------------------------------------------------- final
    def finish(self, pad_to: Optional[int] = None) -> np.ndarray:
        for idx, label in self._fixups:
            if label not in self.labels:
                defined = ", ".join(sorted(self.labels)) or "(none)"
                raise UndefinedLabel(
                    f"undefined label {label!r} in {self.name} "
                    f"(instruction {idx}); defined labels: {defined}")
            self.rows[idx][isa.F_IMM] = self.labels[label]
        code = np.stack(self.rows).astype(np.int32)
        if pad_to is not None:
            if len(code) > pad_to:
                raise ValueError(f"{self.name}: {len(code)} instrs > pad {pad_to}")
            # padding traps to EXIT (encoded like an emitted EXIT, so
            # padded listings round-trip through decode_str/assemble)
            code = np.concatenate(
                [code, isa.exit_pad_rows(pad_to - len(code))])
        return code

    def disasm(self) -> str:
        code = self.finish()
        inv = {v: k for k, v in self.labels.items()}
        out = []
        for i, row in enumerate(code):
            lbl = (inv[i] + ":") if i in inv else ""
            out.append(f"{lbl:>12s} {i:4d}: {isa.decode_str(row)}")
        return "\n".join(out)


# ---------------------------------------------------------------------------
# Text assembler
# ---------------------------------------------------------------------------
_LINE = re.compile(
    r"^\s*(?:(?P<label>\w+)(?P<sync>\.S)?\s*:)?\s*"
    r"(?:(?:@(?P<gp>p\d)\.(?P<gc>\w+)\s+)?(?P<body>\S.*?))?\s*(?:;.*)?$")


#: mnemonics the text assembler understands (3-operand ALU default path)
_ALU3 = {"IADD", "ISUB", "IMUL", "IMIN", "IMAX", "XOR", "SHL", "SHR",
         "SAR"}


def assemble(text: str, name: str = "kernel",
             pad_to: Optional[int] = None) -> np.ndarray:
    """Assemble a SASS-like text listing into an instruction array.

    Errors (unknown mnemonics, malformed operands, bad registers,
    out-of-range immediates) raise :class:`AsmError` carrying the
    offending line number and text; duplicate labels and undefined
    branch targets are rejected the same way.
    """
    p = Program(name)
    srmap = {"tidx": isa.SR_TIDX, "tidy": isa.SR_TIDY, "ctax": isa.SR_CTAX,
             "ctay": isa.SR_CTAY, "ntidx": isa.SR_NTIDX,
             "ntidy": isa.SR_NTIDY, "nctax": isa.SR_NCTAX,
             "nctay": isa.SR_NCTAY, "tid": isa.SR_TID, "cta": isa.SR_CTA,
             "ntid": isa.SR_NTID}

    def val(tok):
        tok = tok.strip()
        if tok.startswith("#"):
            return int(tok[1:], 0)
        if tok.startswith("sr"):
            return tok
        return tok  # register name

    def one_line(m) -> None:
        if m.group("label"):
            p.label(m.group("label"), sync=bool(m.group("sync")))
        body = m.group("body")
        if not body:
            return
        if m.group("gp"):
            p.guard(m.group("gp"), m.group("gc").upper())
        mem = re.match(r"(\w+(?:\.S)?)\s*(.*)", body)
        mn, rest = mem.group(1), mem.group(2)
        sync = mn.endswith(".S")
        if sync:
            mn = mn[:-2]
            p._sync_next = True
        mn = mn.upper()
        # memory operand form: [rX+imm]
        memop = re.search(r"\[\s*(r\d+)\s*(?:\+\s*(-?\d+))?\s*\]", rest)
        args = [a.strip() for a in
                re.sub(r"\[[^]]*\]", "MEM", rest).split(",") if a.strip()]
        off = int(memop.group(2) or 0) if memop else 0
        base = memop.group(1) if memop else None
        if mn in ("LDG", "LDS"):
            getattr(p, mn.lower())(args[0], base, off)
        elif mn in ("STG", "STS"):
            getattr(p, mn.lower())(base, args[1], off)
        elif mn in ("BRA", "SSY"):
            tgt = args[0]
            neg = tgt.lstrip("-")
            getattr(p, mn.lower())(int(tgt) if neg.isdigit() else tgt)
        elif mn == "S2R":
            sr = args[1]
            srv = srmap[sr[2:].lower()] if sr.lower().startswith("sr") and \
                not sr[2:].isdigit() else int(sr[2:])
            p.s2r(args[0], srv)
        elif mn == "ISETP":
            p.isetp(args[0], args[1], val(args[2]))
        elif mn == "ISET":
            p.iset(args[0], args[1], args[2].upper())
        elif mn == "SELP":
            p.selp(args[0], args[1], args[2], args[3], args[4].upper())
        elif mn == "IMAD":
            p.imad(args[0], args[1], args[2], args[3])
        elif mn in ("NOT", "IABS"):
            getattr(p, mn.lower() + ("_" if mn == "NOT" else ""))(
                args[0], args[1])
        elif mn == "MOV":
            p.mov(args[0], val(args[1]))
        elif mn in ("EXIT", "NOP", "BAR"):
            getattr(p, mn.lower())()
        elif mn in ("AND", "OR"):
            getattr(p, mn.lower() + "_")(args[0], args[1], val(args[2]))
        elif mn in _ALU3:
            getattr(p, mn.lower())(args[0], args[1], val(args[2]))
        else:
            raise AsmError(f"unknown instruction {mn!r}")

    for lineno, raw in enumerate(text.splitlines(), 1):
        m = _LINE.match(raw)
        if not m or (m.group("label") is None and m.group("body") is None):
            continue
        try:
            one_line(m)
        except AsmError as e:
            raise AsmError(
                f"{name}: line {lineno}: {raw.strip()!r}: {e}") from None
        except (IndexError, ValueError, AttributeError) as e:
            raise AsmError(
                f"{name}: line {lineno}: {raw.strip()!r}: malformed "
                f"operands ({e})") from None
    return p.finish(pad_to=pad_to)
