// flash_attention: causal or full attention as a CUDA kernel for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel): softmax(q k^T * dh^-0.5) v with an
// online softmax (running max m, normaliser l, fp32 accumulator), KV tiles
// past the diagonal skipped under `causal`, the causal mask qi >= ki
// aligned top-left, P rounded to v's dtype before the PV product, and the
// output acc / max(l, 1e-30) in q's dtype.
//
// Layout: q and o are (B, Sq, H, dh), k and v (B, Sk, KH, dh), each with
// its own batch, sequence and head strides and a contiguous last axis, so
// the model's (B, S, H, dh) activations and a prefix of its KV cache are
// read where they lie.  Query head h reads KV head h / (H / KH): GQA
// without materialising the repeated heads.  The (BH, S, dh) form of the
// TPU kernel is B = BH, H = KH = 1.
//
// Design: one CTA of 256 threads per (64-query tile, head, batch).  The Q
// tile and one 64-key tile (K, then V in the same buffer) are staged in
// shared memory as fp32, rows padded to an odd stride so that the 16 rows
// one column is read from fall in distinct banks.  Thread (g, c) of 16
// row groups x 16 column lanes owns query rows 4g..4g+3: for QK^T the key
// columns c + 16j (j < 4), for PV the output columns c + 16j (j < dh/16).
// A row's 64 scores live in the 16 lanes of one half-warp, so the row
// max and sum are xor-shuffles within it; m, l and the accumulator stay
// in registers.  Ragged tails (Sq or Sk not a multiple of 64) are masked:
// rows past Sq are not stored, keys past Sk score -1e30 and their V rows
// are zero.
//
// What bounds it: at the serving path's prefill shape (B 4, S 512, H 16,
// KH 8, dh 128, bf16) the work is 4.3 GFLOP over 25 MB, so the card's
// bound is its memory rate; this kernel does its FMAs on the fp32 cores
// from shared memory (no tensor cores, no TMA, no async copies), so it is
// bound by shared-memory bandwidth and fp32 throughput, far above that bound.
// wgmma, TMA and a pipelined K/V ring are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;         // query rows per CTA
constexpr int BK = 64;         // keys per KV tile
constexpr int THREADS = 256;   // 16 row groups x 16 column lanes
constexpr int PLD = BK + 1;    // row stride of the P tile
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Strides {
  long long b, s, h;           // elements; the last axis is contiguous
};

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

// rows row0 .. row0+63 of head h of batch b into dst[64][ld] as fp32;
// rows at or past n are zero
template <typename T>
__device__ void load_tile(float* dst, int ld, const T* __restrict__ src,
                          Strides st, int b, int h, int row0, int n, int dh) {
  const T* base = src + b * st.b + h * st.h;
  for (int i = threadIdx.x; i < BK * dh; i += THREADS) {
    const int r = i / dh, d = i - r * dh, row = row0 + r;
    dst[r * ld + d] = row < n ? to_f(base[row * st.s + d]) : 0.f;
  }
}

// max / sum over the 16 lanes of a half-warp
__device__ __forceinline__ float half_max(float x) {
  for (int off = 8; off; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
  for (int off = 8; off; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

template <typename T, int NJ>  // NJ * 16 >= dh output columns per row
__global__ void __launch_bounds__(THREADS)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Strides qs,
                 Strides ks, Strides vs, Strides os, int rep, int Sq, int Sk,
                 int dh, float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = dh | 1;
  float* Qs = smem;            // [BQ][ld]
  float* KVs = Qs + BQ * ld;   // [BK][ld]: the K tile, then the V tile
  float* Ps = KVs + BK * ld;   // [BQ][PLD]
  const int lane = threadIdx.x & 15, r0 = (threadIdx.x >> 4) * 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / rep;

  load_tile(Qs, ld, q, qs, b, h, q0, Sq, dh);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous V tile and P tile are consumed
    load_tile(KVs, ld, k, ks, b, hk, k0, Sk, dh);
    __syncthreads();

    float s[4][4] = {};
    for (int d = 0; d < dh; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(r0 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = KVs[(lane + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + r0 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ki = k0 + lane + 16 * j;
        float x = s[i][j] * scale;
        if (ki >= Sk || (causal && qi < ki)) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        // P in v's dtype for the PV product; l sums the unrounded p
        Ps[(r0 + i) * PLD + lane + 16 * j] = to_f(from_f<T>(p));
      }
      l[i] = l[i] * alpha + half_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // the K tile is consumed and P is written
    load_tile(KVs, ld, v, vs, b, hk, k0, Sk, dh);
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(r0 + i) * PLD + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 16 * j;
        if (c < dh) {
          const float vv = KVs[kk * ld + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + r0 + i;
    if (qi >= Sq) continue;
    T* row = o + b * os.b + qi * os.s + h * os.h;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 16 * j;
      if (c < dh) row[c] = from_f<T>(acc[i][j] / den);
    }
  }
}

// dynamic shared memory of one CTA: 82.7 KB at dh 128, 148 KB at dh 256,
// under the card's 227 KB a block
size_t smem_bytes(int dh) {
  const int ld = dh | 1;
  return static_cast<size_t>(BQ * ld + BK * ld + BQ * PLD) * sizeof(float);
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, int B, int H, int KH, int Sq, int Sk, int dh,
           float scale, int causal, cudaStream_t stream) {
  auto kernel = flash_kernel<T, NJ>;
  const size_t bytes = smem_bytes(dh);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, H / KH,
      Sq, Sk, dh, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             const long long* st, int B, int H, int KH, int Sq, int Sk,
             int dh, float scale, int causal, cudaStream_t s) {
  if (dh <= 32)
    return launch<T, 2>(q, k, v, o, st, B, H, KH, Sq, Sk, dh, scale, causal,
                        s);
  if (dh <= 64)
    return launch<T, 4>(q, k, v, o, st, B, H, KH, Sq, Sk, dh, scale, causal,
                        s);
  if (dh <= 128)
    return launch<T, 8>(q, k, v, o, st, B, H, KH, Sq, Sk, dh, scale, causal,
                        s);
  return launch<T, 16>(q, k, v, o, st, B, H, KH, Sq, Sk, dh, scale, causal,
                       s);
}

}  // namespace

// q, o (B, Sq, H, dh); k, v (B, Sk, KH, dh); `strides` holds the batch,
// sequence and head strides of q, k, v and o, in elements, in that order
// (12 values, host memory).  dtype: 0 float32, 1 bfloat16.  1 <= dh <=
// 256, H % KH == 0.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* strides, int B, int H,
                                      int KH, int Sq, int Sk, int dh,
                                      float scale, int causal, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, strides, B, H, KH, Sq, Sk, dh,
                                   scale, causal, s);
  return dispatch<float>(q, k, v, o, strides, B, H, KH, Sq, Sk, dh, scale,
                         causal, s);
}
