// simt_alu: the execute stage as a CUDA kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/simt_alu.py::simt_alu (body
// _alu_kernel): one decoded instruction per warp row applied across the
// row's L lanes, with the ISETP flag nibble.  The staged pipeline hands it
// every warp row of a dispatch group in one call, R = P x W rows, as the
// Pallas kernel sees (P, W, 32) under the JAX executor's vmap.
//
// What bounds it: each lane reads six int32 words (s1, s2, s3, cond, s2r,
// mask) and writes two (result, nibble) for a few dozen integer
// operations, and no word is used twice, so bytes set the bound: 32 bytes
// a lane (and 4 an opcode row) over the card's memory rate.  One thread a
// lane: a warp's access to each array is 128 contiguous bytes, whole
// sectors, and its opcode reads fall in one or two.  256 threads a CTA;
// nothing is staged in shared memory.  On an H100 at 65536 x 32 it reads
// about 90% of the bound with the L2 cold.  A form with four lanes a
// thread and 128-bit loads and stores was measured beside this one on the
// same card and was slower at every shape, so it is not kept (PERF.md).
// enable_mul and num_read_operands are template parameters (§4.2): a
// variant without the multiplier or the third read port has no multiply in
// its code, and one without IMAD never loads s3.
#include <cuda_runtime.h>

#include "alu_datapath.cuh"

namespace {

constexpr int kThreads = 256;

template <bool ENABLE_MUL, int NUM_READ_OPERANDS>
__global__ void __launch_bounds__(kThreads)
    simt_alu_kernel(const int* __restrict__ op, const int* __restrict__ s1,
                    const int* __restrict__ s2, const int* __restrict__ s3,
                    const int* __restrict__ cond,
                    const int* __restrict__ s2r,
                    const int* __restrict__ mask, int* __restrict__ out,
                    int* __restrict__ nib, long n, int L) {
  const long i = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  int r, f;
  alu_datapath<ENABLE_MUL, NUM_READ_OPERANDS>(
      op[i / L], s1[i], s2[i], s3[i], cond[i] != 0, s2r[i], mask[i] != 0, r,
      f);
  out[i] = r;
  nib[i] = f;
}

template <bool ENABLE_MUL, int NUM_READ_OPERANDS>
void launch(const int* op, const int* s1, const int* s2, const int* s3,
            const int* cond, const int* s2r, const int* mask, int* out,
            long rows, int L, cudaStream_t stream) {
  const long n = rows * L;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) /
                                                kThreads);
  simt_alu_kernel<ENABLE_MUL, NUM_READ_OPERANDS>
      <<<blocks, kThreads, 0, stream>>>(op, s1, s2, s3, cond, s2r, mask, out,
                                        out + n, n, L);
}

}  // namespace

// `out` holds 2 * rows * L ints: the results, then the nibbles.
extern "C" int simt_alu_launch(const int* op, const int* s1, const int* s2,
                               const int* s3, const int* cond, const int* s2r,
                               const int* mask, int* out, long rows, int L,
                               int enable_mul, int num_read_operands,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (enable_mul && num_read_operands >= 3)
    launch<true, 3>(op, s1, s2, s3, cond, s2r, mask, out, rows, L, s);
  else if (enable_mul)
    launch<true, 2>(op, s1, s2, s3, cond, s2r, mask, out, rows, L, s);
  else if (num_read_operands >= 3)
    launch<false, 3>(op, s1, s2, s3, cond, s2r, mask, out, rows, L, s);
  else
    launch<false, 2>(op, s1, s2, s3, cond, s2r, mask, out, rows, L, s);
  return static_cast<int>(cudaGetLastError());
}
