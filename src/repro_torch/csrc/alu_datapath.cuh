// The SP-array datapath shared by the port's two kernels, and the ISA
// constants both need.
//
// Port of repro/kernels/simt_alu.py::alu_datapath, the select-by-opcode
// datapath the two Pallas kernels (simt_alu and the fused SM step) share.
// Here simt_alu.cu and fused_sm.cu include this header, so the datapath
// exists once.  The constants mirror repro_torch/core/isa.py; a CPU test
// (tests/test_torch_alu.py) parses this header and holds them to it.
//
// C++ leaves signed overflow undefined, so every wrapping operation
// (IADD, ISUB, IMUL, IMAD and the ISETP difference) runs in uint32_t and
// is cast back; IABS of INT_MIN is INT_MIN, as in two's complement.
#pragma once
#include <cstdint>

namespace isa {
constexpr int NOP = 0, EXIT = 1, MOV = 2, IADD = 3, ISUB = 4, IMUL = 5,
              IMAD = 6, IMIN = 7, IMAX = 8, IABS = 9, AND = 10, OR = 11,
              XOR = 12, NOT = 13, SHL = 14, SHR = 15, SAR = 16, ISETP = 17,
              ISET = 18, SELP = 19, S2R = 20, LDG = 21, STG = 22, LDS = 23,
              STS = 24, BRA = 25, SSY = 26, BAR = 27;
constexpr int NUM_OPCODES = 28;
constexpr int F_OP = 0, F_DST = 1, F_SRC1 = 2, F_SRC2 = 3, F_SRC3 = 4,
              F_IMM = 5, F_FLAGS = 6, F_GPRED = 7, F_GCOND = 8, F_PDST = 9;
constexpr int NUM_FIELDS = 10;
constexpr int FLAG_SRC2_IMM = 1, FLAG_SYNC = 2, FLAG_GUARD = 4,
              FLAG_SRC1_IMM = 8;
constexpr int STACK_RECONV = 0, STACK_TAKEN = 1;
constexpr int WRITES_REG_MASK = 0xBDFFFC;
constexpr int IS_GMEM_MASK = 0x600000;
constexpr int IS_SMEM_MASK = 0x1800000;
constexpr int NUM_SPECIAL_REGS = 11;
}  // namespace isa

// One lane of the SP array.  `res` is zero outside `mask`; `nib` is the
// ISETP SZCO nibble of s1 - s2, zero outside `mask` and outside ISETP.
template <bool ENABLE_MUL, int NUM_READ_OPERANDS>
__device__ __forceinline__ void alu_datapath(int op, int s1, int s2, int s3,
                                             bool cond, int s2r, bool mask,
                                             int& res, int& nib) {
  const uint32_t u1 = static_cast<uint32_t>(s1);
  const uint32_t u2 = static_cast<uint32_t>(s2);
  const uint32_t sh = u2 & 31u;
  int r = 0;
  switch (op) {
    case isa::MOV: r = s2; break;
    case isa::IADD: r = static_cast<int>(u1 + u2); break;
    case isa::ISUB: r = static_cast<int>(u1 - u2); break;
    case isa::IMUL:
      if (ENABLE_MUL) r = static_cast<int>(u1 * u2);
      break;
    case isa::IMAD:  // needs both the multiplier and the third read port
      if (ENABLE_MUL && NUM_READ_OPERANDS >= 3)
        r = static_cast<int>(u1 * u2 + static_cast<uint32_t>(s3));
      break;
    case isa::IMIN: r = s1 < s2 ? s1 : s2; break;
    case isa::IMAX: r = s1 > s2 ? s1 : s2; break;
    case isa::IABS: r = s1 < 0 ? static_cast<int>(0u - u1) : s1; break;
    case isa::AND: r = s1 & s2; break;
    case isa::OR: r = s1 | s2; break;
    case isa::XOR: r = s1 ^ s2; break;
    case isa::NOT: r = ~s1; break;
    case isa::SHL: r = static_cast<int>(u1 << sh); break;
    case isa::SHR: r = static_cast<int>(u1 >> sh); break;
    case isa::SAR: r = s1 >> sh; break;  // arithmetic on signed int
    case isa::ISET: r = cond ? 1 : 0; break;
    case isa::SELP: r = cond ? s1 : s2; break;
    case isa::S2R: r = s2r; break;
    default: break;
  }
  const int d = static_cast<int>(u1 - u2);
  const int f = (d < 0 ? 1 : 0) | (d == 0 ? 2 : 0) | (u1 < u2 ? 4 : 0) |
                (((s1 ^ s2) & (s1 ^ d)) < 0 ? 8 : 0);
  res = mask ? r : 0;
  nib = (mask && op == isa::ISETP) ? f : 0;
}
