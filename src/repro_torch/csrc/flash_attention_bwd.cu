// flash_attention_bwd: the gradient of the flash-attention kernel
// (flash_attention.cu) as CUDA kernels for Hopper (sm_90a).
//
// The JAX package has no backward kernel: jax.grad differentiates the plain
// causal_attention (repro/models/layers.py:62), and its Pallas kernel
// (repro/kernels/flash_attention.py::flash_attention) has no custom_vjp.
// The port runs the forward on a kernel, so it owes that kernel's gradient.
// Given q, k, v, the forward's output o, the output gradient dO and the
// forward's row log-sum-exp lse (natural log, fp32 (B, H, Sq)):
//
//   P  = exp(S * scale - lse), S = q k^T, masked (causal qi >= ki aligned
//        top-left, keys past Sk, rows past Sq) to exactly 0
//   D  = rowsum(dO o o)                      (delta_kernel)
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D)
//   dQ = dS K * scale                        (dq_kernel)
//   dK = dS^T Q * scale                      (dkv_kernel)
//
// summed over the H / KH query heads that share a KV head (GQA).  Layout
// as the forward's: q, o, dO, dq (B, Sq, H, dh) and k, v, dk, dv (B, Sk,
// KH, dh), each with its own batch, sequence and head strides and a
// contiguous last axis; float32 or bfloat16, sums in fp32; dh <= 128.
//
// Deterministic: no float atomics.  One CTA per (64-key tile, KV head,
// batch) owns its dK and dV rows and loops over the query heads of its KV
// head and over the query tiles in a fixed order; one CTA per (64-query
// tile, head, batch) owns its dQ rows and loops over the KV tiles (up to
// the diagonal under `causal`).  Both recompute S and dP from q, k, v and
// dO; two calls on the same inputs give equal bits.
//
// What bounds it: at the training shape (B 8, S 512, H 16, KH 8, dh 128,
// bf16, causal) the function moves 100.9 MB (q, k, v, o, dO, lse read
// once, dq, dk, dv written once: 0.030 ms at 3.35 TB/s) and does five
// products over the causal half, 21.5 GFLOP (0.022 ms at the bf16
// tensor-core rate of 989 TFLOP/s): the memory rate bounds it.  This
// kernel is the simple one: SIMT fp32 FMAs from shared memory, like the
// forward's "simt" variant, with every product recomputed once per
// kernel, so it runs far from that bound; mma.sync / wgmma fed by
// cp.async or TMA are later work.
//
// Each CTA has 256 threads: 16 row groups g x 16 column lanes.  For a
// 64 x 64 tile of S or dP, thread (g, lane) owns rows 4g..4g+3 and keys
// lane + 16j (j < 4), as in the forward's SIMT variant; the products
// read rows of q/dO and k/v staged in shared memory as fp32 with an odd
// row stride, so the 16 rows a half-warp reads fall in distinct banks.
// For the accumulators, thread (g, lane) owns rows (keys in dkv_kernel,
// queries in dq_kernel) 4g..4g+3 and columns lane + 16j (j < dh / 16),
// in registers; P and dS pass through shared memory between the two.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // keys per tile
constexpr int THREADS = 256;   // 16 row groups x 16 column lanes
constexpr int PLD = BK + 1;    // row stride of the P and dS tiles
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

// lse and D of rows q0 .. q0+63 of head h into Ls, Dl (0 past Sq)
__device__ void load_rows(float* Ls, float* Dl, const float* __restrict__ lse,
                          const float* __restrict__ delta, long long bh,
                          int q0, int Sq) {
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    const int row = q0 + i;
    Ls[i] = row < Sq ? lse[bh * Sq + row] : 0.f;
    Dl[i] = row < Sq ? delta[bh * Sq + row] : 0.f;
  }
}

// D = rowsum(dO o o), fp32 (B, H, Sq): one warp a row
template <typename T>
__global__ void __launch_bounds__(THREADS)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 Strides os, Strides ds, float* __restrict__ delta, int H,
                 int Sq, int dh, long long rows) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (THREADS / 32) + threadIdx.x / 32;
  if (row >= rows) return;   // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int i = static_cast<int>(row % Sq);
  const long long bh = row / Sq;
  const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
  const T* orow = o + b * os.b + i * os.s + h * os.h;
  const T* drow = dout + b * ds.b + i * ds.s + h * ds.h;
  float acc = 0.f;
  for (int d = lane; d < dh; d += 32)
    acc = fmaf(to_f(orow[d]), to_f(drow[d]), acc);
  for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(FULL, acc, off);
  if (lane == 0) delta[row] = acc;
}

// S = A B^T and dP = C E^T for rows r0..r0+3 of A, C and rows lane + 16j
// of B, E (all [64][ld] tiles)
__device__ __forceinline__ void two_products(
    float (&s)[4][4], float (&dp)[4][4], const float* A, const float* Bt,
    const float* C, const float* Et, int ld, int r0, int lane, int dh) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int d = 0; d < dh; ++d) {
    float a[4], c[4], bv[4], ev[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = A[(r0 + i) * ld + d];
      c[i] = C[(r0 + i) * ld + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bv[j] = Bt[(lane + 16 * j) * ld + d];
      ev[j] = Et[(lane + 16 * j) * ld + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], bv[j], s[i][j]);
        dp[i][j] = fmaf(c[i], ev[j], dp[i][j]);
      }
  }
}

// dK and dV of one 64-key tile of one KV head: the query heads that share
// it, then the query tiles, in that fixed order
template <typename T, int NJ>  // NJ * 16 >= dh
__global__ void __launch_bounds__(THREADS)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, Strides qs,
               Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
               int rep, int H, int Sq, int Sk, int dh, float scale,
               int causal) {
  extern __shared__ float smem[];
  const int ld = dh | 1;
  float* Ks = smem;             // [BK][ld]
  float* Vs = Ks + BK * ld;     // [BK][ld]
  float* Qs = Vs + BK * ld;     // [BQ][ld]
  float* Gs = Qs + BQ * ld;     // [BQ][ld]: dO
  float* Ps = Gs + BQ * ld;     // [BQ][PLD]: P
  float* Ss = Ps + BQ * PLD;    // [BQ][PLD]: dS
  float* Ls = Ss + BQ * PLD;    // [BQ]: lse
  float* Dl = Ls + BQ;          // [BQ]: D
  const int lane = threadIdx.x & 15, r0 = (threadIdx.x >> 4) * 4;
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;

  load_tile(Ks, ld, k, ks, b, hk, k0, Sk, dh);
  load_tile(Vs, ld, v, vs, b, hk, k0, Sk, dh);

  // keys k0 + r0 + i, columns lane + 16j
  float dK[4][NJ], dV[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dK[i][j] = dV[i][j] = 0.f;

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;  // no row of an earlier tile sees k0
  for (int r = 0; r < rep; ++r) {
    const int h = hk * rep + r;
    const long long bh = static_cast<long long>(b) * H + h;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tiles are consumed
      load_tile(Qs, ld, q, qs, b, h, q0, Sq, dh);
      load_tile(Gs, ld, dout, dos, b, h, q0, Sq, dh);
      load_rows(Ls, Dl, lse, delta, bh, q0, Sq);
      __syncthreads();

      float s[4][4], dp[4][4];  // rows q0 + r0 + i, keys k0 + lane + 16j
      two_products(s, dp, Qs, Ks, Gs, Vs, ld, r0, lane, dh);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + r0 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + lane + 16 * j;
          float p = 0.f;
          if (row < Sq && key < Sk && !(causal && row < key))
            p = expf(s[i][j] * scale - Ls[r0 + i]);
          Ps[(r0 + i) * PLD + lane + 16 * j] = p;
          Ss[(r0 + i) * PLD + lane + 16 * j] = p * (dp[i][j] - Dl[r0 + i]);
        }
      }
      __syncthreads();  // P and dS are written

      // dV += P^T dO, dK += dS^T Q over the tile's 64 rows
      for (int rr = 0; rr < BQ; ++rr) {
        float pv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[rr * PLD + r0 + i];
          sv[i] = Ss[rr * PLD + r0 + i];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = lane + 16 * j;
          if (c < dh) {
            const float g = Gs[rr * ld + c], qv = Qs[rr * ld + c];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              dV[i][j] = fmaf(pv[i], g, dV[i][j]);
              dK[i][j] = fmaf(sv[i], qv, dK[i][j]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + r0 + i;
    if (key >= Sk) continue;
    T* krow = dk + b * dks.b + key * dks.s + hk * dks.h;
    T* vrow = dv + b * dvs.b + key * dvs.s + hk * dvs.h;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 16 * j;
      if (c < dh) {
        krow[c] = from_f<T>(dK[i][j] * scale);
        vrow[c] = from_f<T>(dV[i][j]);
      }
    }
  }
}

// dQ of one 64-query tile of one head: the KV tiles in order
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, Strides qs, Strides ks, Strides vs,
              Strides dos, Strides dqs, int rep, int H, int Sq, int Sk,
              int dh, float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = dh | 1;
  float* Qs = smem;             // [BQ][ld]
  float* Gs = Qs + BQ * ld;     // [BQ][ld]: dO
  float* Ks = Gs + BQ * ld;     // [BK][ld]
  float* Vs = Ks + BK * ld;     // [BK][ld]
  float* Ss = Vs + BK * ld;     // [BQ][PLD]: dS
  float* Ls = Ss + BQ * PLD;    // [BQ]: lse
  float* Dl = Ls + BQ;          // [BQ]: D
  const int lane = threadIdx.x & 15, r0 = (threadIdx.x >> 4) * 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / rep;

  load_tile(Qs, ld, q, qs, b, h, q0, Sq, dh);
  load_tile(Gs, ld, dout, dos, b, h, q0, Sq, dh);
  load_rows(Ls, Dl, lse, delta, static_cast<long long>(b) * H + h, q0, Sq);

  // rows q0 + r0 + i, columns lane + 16j
  float dQ[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dQ[i][j] = 0.f;

  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous K tile and dS tile are consumed
    load_tile(Ks, ld, k, ks, b, hk, k0, Sk, dh);
    load_tile(Vs, ld, v, vs, b, hk, k0, Sk, dh);
    __syncthreads();

    float s[4][4], dp[4][4];  // rows q0 + r0 + i, keys k0 + lane + 16j
    two_products(s, dp, Qs, Ks, Gs, Vs, ld, r0, lane, dh);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + r0 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + lane + 16 * j;
        float ds = 0.f;
        if (row < Sq && key < Sk && !(causal && row < key))
          ds = expf(s[i][j] * scale - Ls[r0 + i]) * (dp[i][j] - Dl[r0 + i]);
        Ss[(r0 + i) * PLD + lane + 16 * j] = ds;
      }
    }
    __syncthreads();  // dS is written

    // dQ += dS K over the tile's 64 keys
    for (int kk = 0; kk < BK; ++kk) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = Ss[(r0 + i) * PLD + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 16 * j;
        if (c < dh) {
          const float kv = Ks[kk * ld + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) dQ[i][j] = fmaf(sv[i], kv, dQ[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r0 + i;
    if (row >= Sq) continue;
    T* dst = dq + b * dqs.b + row * dqs.s + h * dqs.h;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 16 * j;
      if (c < dh) dst[c] = from_f<T>(dQ[i][j] * scale);
    }
  }
}

// dynamic shared memory of one CTA: four [64][dh | 1] fp32 tiles, the P
// and dS tiles (dkv) or the dS tile (dq), and two rows of 64: 166 KB
// (dkv) and 149 KB (dq) at dh 128, under the card's 227 KB a block
size_t dkv_smem(int dh) {
  return static_cast<size_t>(4 * 64 * (dh | 1) + 2 * BQ * PLD + 2 * BQ) *
         sizeof(float);
}
size_t dq_smem(int dh) {
  return static_cast<size_t>(4 * 64 * (dh | 1) + BQ * PLD + 2 * BQ) *
         sizeof(float);
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, const long long* st, int B, int H, int KH,
           int Sq, int Sk, int dh, float scale, int causal,
           cudaStream_t stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]},
      dos{st[12], st[13], st[14]}, dqs{st[15], st[16], st[17]},
      dks{st[18], st[19], st[20]}, dvs{st[21], st[22], st[23]};
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int rep = H / KH;

  const long long rows = static_cast<long long>(B) * H * Sq;
  const unsigned blocks =
      static_cast<unsigned>((rows + THREADS / 32 - 1) / (THREADS / 32));
  delta_kernel<T><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(o), dot, os, dos, delta, H, Sq, dh, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  {
    auto kernel = dkv_kernel<T, NJ>;
    const size_t bytes = dkv_smem(dh);
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((Sk + BK - 1) / BK, KH, B);
    kernel<<<grid, THREADS, bytes, stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        qs, ks, vs, dos, dks, dvs, rep, H, Sq, Sk, dh, scale, causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  {
    auto kernel = dq_kernel<T, NJ>;
    const size_t bytes = dq_smem(dh);
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((Sq + BQ - 1) / BQ, H, B);
    kernel<<<grid, THREADS, bytes, stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), qs, ks, vs, dos,
        dqs, rep, H, Sq, Sk, dh, scale, causal);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, void* dq,
             void* dk, void* dv, const long long* st, int B, int H, int KH,
             int Sq, int Sk, int dh, float scale, int causal,
             cudaStream_t s) {
  if (dh <= 16)
    return launch<T, 1>(q, k, v, o, dout, lse, delta, dq, dk, dv, st, B, H,
                        KH, Sq, Sk, dh, scale, causal, s);
  if (dh <= 32)
    return launch<T, 2>(q, k, v, o, dout, lse, delta, dq, dk, dv, st, B, H,
                        KH, Sq, Sk, dh, scale, causal, s);
  if (dh <= 64)
    return launch<T, 4>(q, k, v, o, dout, lse, delta, dq, dk, dv, st, B, H,
                        KH, Sq, Sk, dh, scale, causal, s);
  return launch<T, 8>(q, k, v, o, dout, lse, delta, dq, dk, dv, st, B, H, KH,
                      Sq, Sk, dh, scale, causal, s);
}

}  // namespace

// q, o, dout, dq (B, Sq, H, dh); k, v, dk, dv (B, Sk, KH, dh); lse and
// delta fp32 (B, H, Sq), contiguous (delta is scratch the launch fills).
// `strides` holds the batch, sequence and head strides of q, k, v, o,
// dout, dq, dk and dv, in elements, in that order (24 values, host
// memory).  dtype: 0 float32, 1 bfloat16; 1 <= dh <= 128; H % KH == 0.  Returns
// cudaGetLastError() after the last launch.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, const long long* strides, int B, int H, int KH, int Sq, int Sk,
    int dh, float scale, int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh < 1 || dh > 128 || KH < 1 || H % KH)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                   strides, B, H, KH, Sq, Sk, dh, scale,
                                   causal, s);
  return dispatch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, strides,
                         B, H, KH, Sq, Sk, dh, scale, causal, s);
}
