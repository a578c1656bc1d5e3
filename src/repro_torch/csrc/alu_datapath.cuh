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

// c[op] for op in [0, 32), 0 outside: a tree of selects on the opcode's
// five bits, with no branch (the indices are constants once unrolled, so
// c lives in registers).
__device__ __forceinline__ int select_by_opcode(int op, const int (&c)[32]) {
  int v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = (op & 1) ? c[2 * i + 1] : c[2 * i];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = (op & 2) ? v[2 * i + 1] : v[2 * i];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = (op & 4) ? v[2 * i + 1] : v[2 * i];
#pragma unroll
  for (int i = 0; i < 2; ++i) v[i] = (op & 8) ? v[2 * i + 1] : v[2 * i];
  const int r = (op & 16) ? v[1] : v[0];
  return static_cast<unsigned>(op) < 32u ? r : 0;
}

// One lane of the SP array.  `res` is zero outside `mask`; `nib` is the
// ISETP SZCO nibble of s1 - s2, zero outside `mask` and outside ISETP.
// Every opcode's result is computed and one is selected by the opcode's
// bits: the opcode is uniform across a warp in both kernels, and a select
// tree costs less than the branch tree a switch compiles to.
template <bool ENABLE_MUL, int NUM_READ_OPERANDS>
__device__ __forceinline__ void alu_datapath(int op, int s1, int s2, int s3,
                                             bool cond, int s2r, bool mask,
                                             int& res, int& nib) {
  const uint32_t u1 = static_cast<uint32_t>(s1);
  const uint32_t u2 = static_cast<uint32_t>(s2);
  const uint32_t sh = u2 & 31u;
  int c[32] = {};
  c[isa::MOV] = s2;
  c[isa::IADD] = static_cast<int>(u1 + u2);
  c[isa::ISUB] = static_cast<int>(u1 - u2);
  if (ENABLE_MUL) c[isa::IMUL] = static_cast<int>(u1 * u2);
  if (ENABLE_MUL && NUM_READ_OPERANDS >= 3)  // multiplier and third port
    c[isa::IMAD] = static_cast<int>(u1 * u2 + static_cast<uint32_t>(s3));
  c[isa::IMIN] = s1 < s2 ? s1 : s2;
  c[isa::IMAX] = s1 > s2 ? s1 : s2;
  c[isa::IABS] = s1 < 0 ? static_cast<int>(0u - u1) : s1;
  c[isa::AND] = s1 & s2;
  c[isa::OR] = s1 | s2;
  c[isa::XOR] = s1 ^ s2;
  c[isa::NOT] = ~s1;
  c[isa::SHL] = static_cast<int>(u1 << sh);
  c[isa::SHR] = static_cast<int>(u1 >> sh);
  c[isa::SAR] = s1 >> sh;  // arithmetic on signed int
  c[isa::ISET] = cond ? 1 : 0;
  c[isa::SELP] = cond ? s1 : s2;
  c[isa::S2R] = s2r;
  const int r = select_by_opcode(op, c);
  const int d = static_cast<int>(u1 - u2);
  const int f = (d < 0 ? 1 : 0) | (d == 0 ? 2 : 0) | (u1 < u2 ? 4 : 0) |
                (((s1 ^ s2) & (s1 ^ d)) < 0 ? 8 : 0);
  res = mask ? r : 0;
  nib = (mask && op == isa::ISETP) ? f : 0;
}
