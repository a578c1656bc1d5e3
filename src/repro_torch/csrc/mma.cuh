// Tensor-core and async-copy helpers shared by flash_attention.cu,
// flash_attention_bwd.cu and matmul.cu: cp.async copies from device
// memory into shared memory (a padded tile of bf16 rows at a time),
// ldmatrix loads of 8x8 bf16 tiles into mma fragments, and the
// m16n8k16 bf16 product with an fp32 accumulator (sm_80 and later, so
// sm_90a).
//
// Fragment layout of mma.sync.m16n8k16.row.col (g = lane / 4, t = lane % 4),
// each register two bf16 values, the lower address in the low half:
//   A (16 x 16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                           a3 (g+8, 2t+8..)
//   B (16 x 8, "col"):      b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C (16 x 8, fp32):       c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
// So the C fragments of two neighbouring n8 tiles, packed to bf16, are
// one A fragment of a 16-deep product: the online softmax's P goes from
// the QK^T accumulator into the PV product without shared memory.
#pragma once
#include <cuda_bf16.h>
#include <cstdint>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, bypassing L1; the bytes past src_bytes
// (0 or 16) are zero-filled, so a row past the edge reads as zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// rows row0 .. row0+ROWS-1 of a row-major bf16 matrix (DH contiguous
// columns, row stride `stride` elements) into a shared tile of row stride
// LD elements, by 16-byte copies spread over THREADS threads; rows at or
// past n are zero-filled (the source is then row 0, which is valid, and
// reads no byte)
template <int ROWS, int DH, int LD, int THREADS>
__device__ __forceinline__ void cp_async_rows(__nv_bfloat16* dst,
                                              const __nv_bfloat16* src,
                                              long long stride, int row0,
                                              int n) {
  constexpr int CH = DH / 8;  // 16-byte chunks of a row
#pragma unroll
  for (int e = 0; e < ROWS * CH / THREADS; ++e) {
    const int i = e * THREADS + threadIdx.x;
    const int r = i / CH, c = i % CH, row = row0 + r;
    const bool ok = row < n;
    cp_async16(dst + r * LD + c * 8, src + (ok ? row * stride : 0) + c * 8,
               ok ? 16 : 0);
  }
}

// the same as a loop that is not unrolled: each copy's address is
// computed where it is issued, so a kernel that calls it in its main loop
// keeps no hoisted per-copy offsets live in registers (at dh 256 a tile
// is 16 copies a thread of 128, 32 64-bit offsets for K and V)
template <int ROWS, int DH, int LD, int THREADS>
__device__ __forceinline__ void cp_async_rows_rolled(
    __nv_bfloat16* dst, const __nv_bfloat16* src, long long stride, int row0,
    int n) {
  constexpr int CH = DH / 8;
#pragma unroll 1
  for (int e = 0; e < ROWS * CH / THREADS; ++e) {
    const int i = e * THREADS + threadIdx.x;
    const int r = i / CH, c = i % CH, row = row0 + r;
    const bool ok = row < n;
    cp_async16(dst + r * LD + c * 8, src + (ok ? row * stride : 0) + c * 8,
               ok ? 16 : 0);
  }
}

// 4 bytes from global to shared (src_bytes 0 or 4, zero-filled as above)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 tiles; lanes 8i..8i+7 give the row addresses of tile i,
// register i receives tile i's row g, columns 2t..2t+1
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// the same, each tile transposed: register i receives tile i's rows
// 2t..2t+1 of column g, i.e. a B fragment of a row-major (k, n) tile
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a b for one m16n8k16 tile, bf16 inputs, fp32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace mma
