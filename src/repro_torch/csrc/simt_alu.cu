// simt_alu: the execute stage as a CUDA kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/simt_alu.py::simt_alu (body
// _alu_kernel): one decoded instruction per warp row applied across the
// row's L lanes, with the ISETP flag nibble.  One thread per lane over
// W*L lanes; the opcode is read per row.  Each lane reads seven int32
// words and writes two, for a handful of integer operations, so the
// kernel is bound by memory traffic: consecutive threads touch
// consecutive words, and nothing is staged.
#include <cuda_runtime.h>

#include "alu_datapath.cuh"

namespace {

template <bool ENABLE_MUL, int NUM_READ_OPERANDS>
__global__ void simt_alu_kernel(const int* __restrict__ op,
                                const int* __restrict__ s1,
                                const int* __restrict__ s2,
                                const int* __restrict__ s3,
                                const int* __restrict__ cond,
                                const int* __restrict__ s2r,
                                const int* __restrict__ mask,
                                int* __restrict__ out, int* __restrict__ nib,
                                long n, int L) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int r, f;
  alu_datapath<ENABLE_MUL, NUM_READ_OPERANDS>(
      op[i / L], s1[i], s2[i], s3[i], cond[i] != 0, s2r[i], mask[i] != 0, r,
      f);
  out[i] = r;
  nib[i] = f;
}

}  // namespace

extern "C" int simt_alu_launch(const int* op, const int* s1, const int* s2,
                               const int* s3, const int* cond, const int* s2r,
                               const int* mask, int* out, int* nib, int W,
                               int L, int enable_mul, int num_read_operands,
                               void* stream) {
  const long n = static_cast<long>(W) * L;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (enable_mul && num_read_operands >= 3)
    simt_alu_kernel<true, 3><<<blocks, threads, 0, s>>>(
        op, s1, s2, s3, cond, s2r, mask, out, nib, n, L);
  else if (enable_mul)
    simt_alu_kernel<true, 2><<<blocks, threads, 0, s>>>(
        op, s1, s2, s3, cond, s2r, mask, out, nib, n, L);
  else if (num_read_operands >= 3)
    simt_alu_kernel<false, 3><<<blocks, threads, 0, s>>>(
        op, s1, s2, s3, cond, s2r, mask, out, nib, n, L);
  else
    simt_alu_kernel<false, 2><<<blocks, threads, 0, s>>>(
        op, s1, s2, s3, cond, s2r, mask, out, nib, n, L);
  return static_cast<int>(cudaGetLastError());
}
