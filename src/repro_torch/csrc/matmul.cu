// matmul: a tiled GEMM with an fp32 accumulator as CUDA kernels for
// Hopper (sm_90a), one for each input dtype.
//
// Replaces the Pallas kernel repro/kernels/matmul.py::matmul (body
// _mm_kernel): (M, K) @ (K, N) -> (M, N), row-major, summed in fp32, the
// output in the inputs' dtype (float32 or bfloat16).  The TPU kernel
// carries its accumulator across a sequential K grid axis in VMEM; here
// each CTA loops over K itself and keeps its output tile in registers.
//
// Tiles: 64 x 32 outputs a CTA of 128 threads, K in slabs of 32.  At the
// kernel_micro path's 512 x 512 x 512 that is 128 CTAs, about one a
// streaming multiprocessor of the card's 132 (a 64 x 64 tile gave 64, half
// the card idle), and four warps a CTA, one for each of the SM's four
// schedulers.  Both kernels move their slabs through a ring of cp.async
// copies, three stages for float32 and four for bfloat16: a slab's
// products take less time than its copies' latency, so the copies of
// slab s+1 .. s+STAGES-1 are in flight while slab s computes, one barrier
// a slab.  Edges that do not fill a tile are zero-filled by the
// copies and not stored, so any M, N, K works; the wrapper keeps the TPU
// kernel's divisibility rule on its block sizes, which admits ragged
// shapes such as 200 x 200 x 200.  Where rows are not whole 16-byte
// vectors (N, or K for bf16, not a multiple of the vector width, or an
// unaligned pointer) the wrapper picks the scalar-load variant (vec = 0)
// of the same kernel.
//
// float32 (sgemm_kernel): IEEE fmaf on the fp32 cores, never TF32.  Each
// thread accumulates a 4 x 4 block of outputs from one float4 of A and
// one float4 of B a k step: A is staged k-major (As[k][m], by 4-byte
// copies that transpose as they land; a warp's copies cover 4 rows x 8
// k, which fall in 32 distinct banks at the row stride of 68), B as it
// lies (16-byte copies, or 4-byte ones in the scalar variant).  So 16
// FMAs cost two shared-memory vector loads.  What bounds it: 0.268 GFLOP over 3.1 MB at 512^3,
// 0.0040 ms at the card's 67 TFLOP/s fp32 rate, so operations.
//
// bfloat16 (hgemm_kernel): mma.sync m16n8k16 with an fp32 accumulator
// (mma.cuh).  The four warps tile the 64 x 32 output 2 x 2, 32 x 16
// each: a 16-deep step is two ldmatrix loads of A, one ldmatrix.trans of
// B (row-major B is the "row" form, so it is transposed into B
// fragments) and four products.  Rows are padded by 16 bytes so that
// ldmatrix's eight rows fall in distinct banks.  The scalar variant loads
// element by element (cp.async copies at least 4 bytes) into the same
// ring.  The output is rounded to bf16 once.  What bounds it: 1.6 MB at
// 512^3 over 3.35 TB/s, 0.0005 ms, above 0.268 GFLOP at 989 TFLOP/s,
// 0.0003 ms, so bytes.  wgmma with TMA is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int BM = 64, BN = 32, BK = 32, THREADS = 128;
// ring depth: a slab's products take less time than its copies' latency,
// so the copies are issued STAGES - 1 slabs ahead (static shared memory:
// 37.5 KB for float32, 30 KB for bfloat16)
constexpr int STAGES_F32 = 3, STAGES_BF16 = 4;

// ------------------------------------------------------------ float32
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    sgemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ c, int M, int N, int K) {
  constexpr int LA = BM + 4;  // row stride of As, a multiple of 4 floats
  constexpr int ST = STAGES_F32;
  __shared__ __align__(16) float As[ST][BK][LA];  // As[k][m] = A[m0+m][k0+k]
  __shared__ __align__(16) float Bs[ST][BK][BN];  // Bs[k][n] = B[k0+k][n0+n]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tx = tid & 7, ty = tid >> 3;  // outputs (4ty.., 4tx..)
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  const int n_slabs = (K + BK - 1) / BK;
  auto copy = [&](int buf, int k0) {
    // A: warp w copies k = 8w + lane % 8 of rows 4e + lane / 8
    const int kk = warp * 8 + (lane & 7), gk = k0 + kk;
#pragma unroll
    for (int e = 0; e < BM / 4; ++e) {
      const int mm = e * 4 + (lane >> 3), gm = m0 + mm;
      const bool ok = gm < M && gk < K;
      mma::cp_async4(&As[buf][kk][mm],
                     a + (ok ? static_cast<long long>(gm) * K + gk : 0),
                     ok ? 4 : 0);
    }
    if (VEC) {  // N % 4 == 0: a 4-float chunk is wholly in or out
#pragma unroll
      for (int e = 0; e < BK * BN / 4 / THREADS; ++e) {
        const int i = e * THREADS + tid, kb = i >> 3, n4 = (i & 7) * 4;
        const int gkb = k0 + kb, gn = n0 + n4;
        const bool ok = gkb < K && gn < N;
        mma::cp_async16(&Bs[buf][kb][n4],
                        b + (ok ? static_cast<long long>(gkb) * N + gn : 0),
                        ok ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int e = 0; e < BK * BN / THREADS; ++e) {
        const int i = e * THREADS + tid, kb = i / BN, n = i % BN;
        const int gkb = k0 + kb, gn = n0 + n;
        const bool ok = gkb < K && gn < N;
        mma::cp_async4(&Bs[buf][kb][n],
                       b + (ok ? static_cast<long long>(gkb) * N + gn : 0),
                       ok ? 4 : 0);
      }
    }
  };
  // slab `slab` into ring entry `buf`, one commit group a call (empty
  // past the last slab, so that the wait below counts slabs)
  auto load = [&](int buf, int slab) {
    if (slab < n_slabs) copy(buf, slab * BK);
    mma::cp_async_commit();
  };

  float acc[4][4] = {};
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) load(s, s);
  for (int s = 0; s < n_slabs; ++s) {
    mma::cp_async_wait<ST - 2>();  // slab s has landed
    __syncthreads();  // ... for every thread; slab s-1 is consumed
    load((s + ST - 1) % ST, s + ST - 1);
    const int buf = s % ST;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }

  const int gn = n0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M || gn >= N) continue;
    float* row = c + static_cast<long long>(gm) * N + gn;
    if (VEC) {
      *reinterpret_cast<float4*>(row) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gn + j < N) row[j] = acc[i][j];
    }
  }
}

// ------------------------------------------------------------ bfloat16
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    hgemm_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                 bf16* __restrict__ c, int M, int N, int K) {
  constexpr int LA = BK + 8, LB = BN + 8;  // padded rows: 80 bytes
  constexpr int ST = STAGES_BF16;
  __shared__ __align__(16) bf16 As[ST][BM][LA];  // As[m][k] = A[m0+m][k0+k]
  __shared__ __align__(16) bf16 Bs[ST][BK][LB];  // Bs[k][n] = B[k0+k][n0+n]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;  // the warp's 32 x 16 outputs
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bf16 zero = __float2bfloat16(0.f);

  const int n_slabs = (K + BK - 1) / BK;
  auto copy = [&](int buf, int k0) {
    if (VEC) {  // K % 8 == 0, N % 8 == 0: 8-element chunks in or out
#pragma unroll
      for (int e = 0; e < BM * BK / 8 / THREADS; ++e) {
        const int i = e * THREADS + tid, r = i >> 2, k8 = (i & 3) * 8;
        const int gm = m0 + r, gk = k0 + k8;
        const bool ok = gm < M && gk < K;
        mma::cp_async16(&As[buf][r][k8],
                        a + (ok ? static_cast<long long>(gm) * K + gk : 0),
                        ok ? 16 : 0);
      }
      {
        const int r = tid >> 2, n8 = (tid & 3) * 8;  // BK * BN / 8 == 128
        const int gk = k0 + r, gn = n0 + n8;
        const bool ok = gk < K && gn < N;
        mma::cp_async16(&Bs[buf][r][n8],
                        b + (ok ? static_cast<long long>(gk) * N + gn : 0),
                        ok ? 16 : 0);
      }
    } else {  // synchronous element loads into the same ring
#pragma unroll
      for (int e = 0; e < BM * BK / THREADS; ++e) {
        const int i = e * THREADS + tid, r = i / BK, kk = i % BK;
        const int gm = m0 + r, gk = k0 + kk;
        As[buf][r][kk] = gm < M && gk < K
                             ? a[static_cast<long long>(gm) * K + gk]
                             : zero;
      }
#pragma unroll
      for (int e = 0; e < BK * BN / THREADS; ++e) {
        const int i = e * THREADS + tid, r = i / BN, n = i % BN;
        const int gk = k0 + r, gn = n0 + n;
        Bs[buf][r][n] = gk < K && gn < N
                            ? b[static_cast<long long>(gk) * N + gn]
                            : zero;
      }
    }
  };

  // slab `slab` into ring entry `buf`, one commit group a call (empty
  // past the last slab, and in the scalar form, whose stores are done by
  // the barrier that follows)
  auto load = [&](int buf, int slab) {
    if (slab < n_slabs) copy(buf, slab * BK);
    mma::cp_async_commit();
  };

  float acc[2][2][4] = {};
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) load(s, s);
  for (int s = 0; s < n_slabs; ++s) {
    mma::cp_async_wait<ST - 2>();  // slab s has landed
    __syncthreads();  // ... for every thread; slab s-1 is consumed
    load((s + ST - 1) % ST, s + ST - 1);
    const int buf = s % ST;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t af[2][4], bfr[4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        mma::ldmatrix_x4(af[mi], &As[buf][wm * 32 + mi * 16 + (lane & 15)]
                                    [ks * 16 + (lane >> 4) * 8]);
      mma::ldmatrix_x4_trans(
          bfr, &Bs[buf][ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8]
                  [wn * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma::mma_bf16(acc[mi][0], af[mi], bfr[0], bfr[1]);
        mma::mma_bf16(acc[mi][1], af[mi], bfr[2], bfr[3]);
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int gm = m0 + wm * 32 + mi * 16 + g + 8 * r;
        const int gn = n0 + wn * 16 + nj * 8 + 2 * t4;
        if (gm >= M) continue;
        bf16* row = c + static_cast<long long>(gm) * N;
        if (gn < N) row[gn] = __float2bfloat16(acc[mi][nj][2 * r]);
        if (gn + 1 < N) row[gn + 1] = __float2bfloat16(acc[mi][nj][2 * r + 1]);
      }
}

template <typename T, bool VEC>
void launch_kernel(const void* a, const void* b, void* c, int M, int N, int K,
                   cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if constexpr (sizeof(T) == 4)
    sgemm_kernel<VEC><<<grid, THREADS, 0, stream>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(c), M, N, K);
  else
    hgemm_kernel<VEC><<<grid, THREADS, 0, stream>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(b),
        static_cast<bf16*>(c), M, N, K);
}

}  // namespace

// a (M, K), b (K, N), c (M, N), contiguous, one dtype: 0 float32, 1
// bfloat16.  vec 1: rows of whole 16-byte vectors (float32: N % 4 == 0
// and b 16-byte aligned; bfloat16: K % 8 == 0, N % 8 == 0 and a, b
// 16-byte aligned), else 0.  Returns cudaGetLastError() after the launch.
extern "C" int matmul_launch(const void* a, const void* b, void* c, int M,
                             int N, int K, int dtype, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (vec) launch_kernel<bf16, true>(a, b, c, M, N, K, s);
    else launch_kernel<bf16, false>(a, b, c, M, N, K, s);
  } else {
    if (vec) launch_kernel<float, true>(a, b, c, M, N, K, s);
    else launch_kernel<float, false>(a, b, c, M, N, K, s);
  }
  return static_cast<int>(cudaGetLastError());
}
