// matmul: a tiled GEMM with an fp32 accumulator as a CUDA kernel for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/matmul.py::matmul (body
// _mm_kernel): (M, K) @ (K, N) -> (M, N), row-major, summed in fp32, the
// output in the inputs' dtype (float32 or bfloat16).  The TPU kernel
// carries its accumulator across a sequential K grid axis in VMEM; here
// each CTA loops over K itself and keeps its 64 x 64 output tile in
// registers.
//
// Design: 256 threads per CTA; each step stages a 64 x 16 tile of A
// (transposed, so a column of A is a row of shared memory) and a 16 x 64
// tile of B in shared memory as fp32, and thread (ty, tx) accumulates the
// 4 x 4 outputs (ty + 16i, tx + 16j) with IEEE fp32 FMAs: no tensor cores,
// so float32 inputs are never rounded to TF32.  Edges that do not fill a
// tile are zero-filled on load and not stored, so any M, N, K works; the
// wrapper keeps the TPU kernel's divisibility rule on its block sizes.
//
// What bounds it: a 512 x 512 x 512 float32 product is 0.27 GFLOP over
// 3 MB, bound on this card by the 67 TFLOP/s fp32 rate; this kernel
// reads one shared-memory word for every two FMAs and fills 64 CTAs at
// that size, so it is bound by shared-memory bandwidth and occupancy.
// wgmma with TMA for bf16, and register-blocked tiles for fp32, are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 64, TN = 64, TK = 16, THREADS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ c, int M, int N, int K) {
  __shared__ float As[TK][TM + 1];  // As[k][m] = A[m0 + m][k0 + k]
  __shared__ float Bs[TK][TN];      // Bs[k][n] = B[k0 + k][n0 + n]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += TK) {
#pragma unroll
    for (int e = 0; e < TM * TK / THREADS; ++e) {
      const int i = tid + e * THREADS;
      const int r = i / TK, kk = i % TK;       // A: along k
      const int gm = m0 + r, gk = k0 + kk;
      As[kk][r] = (gm < M && gk < K)
                      ? to_f(a[static_cast<long long>(gm) * K + gk])
                      : 0.f;
      const int kb = i / TN, n = i % TN;        // B: along n
      const int gkb = k0 + kb, gn = n0 + n;
      Bs[kb][n] = (gkb < K && gn < N)
                      ? to_f(b[static_cast<long long>(gkb) * N + gn])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N)
        c[static_cast<long long>(gm) * N + gn] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* c, int M, int N, int K,
           cudaStream_t stream) {
  const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  matmul_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (M, K), b (K, N), c (M, N), contiguous, one dtype: 0 float32, 1
// bfloat16.  Returns cudaGetLastError() after the launch.
extern "C" int matmul_launch(const void* a, const void* b, void* c, int M,
                             int N, int K, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, c, M, N, K, s);
  return launch<float>(a, b, c, M, N, K, s);
}
