// flash_attention: causal or full attention as CUDA kernels for Hopper
// (sm_90a), in two variants.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel): softmax(q k^T * dh^-0.5) v with an
// online softmax (running max m, normaliser l, fp32 accumulator), KV tiles
// past the diagonal skipped under `causal`, the causal mask qi >= ki
// aligned top-left, P rounded to v's dtype before the PV product, and the
// output acc / max(l, 1e-30) in q's dtype.
//
// Row log-sum-exp (training): a non-null `lse` receives fp32 (B, H, Sq),
// the natural-log m * scale + log l of each row, which the backward
// (flash_attention_bwd.cu) needs to recompute P = exp(S * scale - lse).
// The SIMT variant keeps m in natural-log units; the tensor-core one keeps
// it in log2 units (scale * log2 e folded in), so it writes m * ln 2 +
// log l.  Serving passes null and stores no row statistic.
//
// Layout: q and o are (B, Sq, H, dh), k and v (B, Sk, KH, dh), each with
// its own batch, sequence and head strides and a contiguous last axis, so
// the model's (B, S, H, dh) activations and a prefix of its KV cache are
// read where they lie.  Query head h reads KV head h / (H / KH): GQA
// without materialising the repeated heads.  The (BH, S, dh) form of the
// TPU kernel is B = BH, H = KH = 1.  Ragged tails (Sq or Sk not a
// multiple of 64) are masked: rows past Sq are not stored, keys past Sk
// score -1e30 and their V rows are zero.
//
// What bounds it: at the serving path's prefill shape (B 4, S 512, H 16,
// KH 8, dh 128, bf16, causal) the work is 4.30 GFLOP over 25.2 MB: 0.0075
// ms of device memory at 3.35 TB/s, 0.0044 ms of bf16 tensor-core
// products at 989 TFLOP/s, so the bound is the memory rate.  At
// paligemma's (B 4, S 512, 8/1 heads of 256) the same 4.30 GFLOP over
// 18.9 MB: 0.0056 ms, bytes again.
//
// Variant "tc" (bf16, dh 64, 128, 224 or 256, 16-byte aligned rows), what
// every model path runs.  One CTA of 4 warps per (64-query tile, head,
// batch); each warp owns 16 query rows.  The query tile is the slowest
// grid axis, reversed under `causal`: causal tile i does i+1 KV tiles, so
// the heaviest tiles start first and the last wave holds the lightest.
// S = QK^T is mma.sync m16n8k16 (bf16 in, fp32 accumulator) with K's B
// fragments read by ldmatrix from the K tile as it lies (row-major K is
// the "col" operand): the bf16 x bf16 products are exact in fp32, as in
// the TPU kernel's f32 dot of widened inputs.  The online softmax runs on
// the accumulator fragments (softmax_tile): a row's 64 scores lie in one
// quad of lanes, so the row max and, at the end, the row sum are two
// xor-shuffles; exp2f with scale * log2(e) folded into one multiply; the
// -1e30 mask only on the diagonal tile and the ragged last one.  P is
// packed to bf16 in registers (two neighbouring S fragments are one A
// fragment) and O += PV reads V's fragments by ldmatrix.trans (pv_tile);
// l sums the unrounded p.  Tiles move by cp.async.cg 16-byte copies, rows
// past Sk zero-filled by the copy's source size.  Rows are padded by 16
// bytes, so ldmatrix's eight 16-byte rows fall in distinct banks.
//  - dh 64 and 128 (flash_tc_kernel): Q is copied once into shared memory
//    and kept in registers as A fragments for the whole KV loop; K and V
//    move through a two-stage ring, tile t+1 in flight while tile t
//    computes, one barrier a tile.  Shared memory: four 64-row tiles (Q
//    borrows the second stage's K tile before the ring fills it), 68 KB
//    at dh 128 and 36 KB at dh 64; at dh 128 the registers (up to 255 a
//    thread under __launch_bounds__(128, 2)) allow two or three CTAs an
//    SM.
//  - dh 256 (flash_tc_wide_kernel, paligemma's one KV head of 256): that
//    plan breaks.  Q's A fragments (64 registers a thread), O's
//    accumulator (128) and S (32) would be 224 registers before any
//    address, and a Q tile beside a two-stage K/V ring 169 KB, one CTA an
//    SM.  So Q stays in shared memory and each warp reloads its rows' A
//    fragments by ldmatrix for each KV tile (16 ldmatrix beside the 128
//    that read K and V), and K and V have one tile each, copied in turn:
//    K(t+1) lands while the warps form P and multiply by V(t), V(t+1)
//    while they compute S of tile t+1 (three barriers a tile).  Three
//    tiles, 99 KB of shared memory, and about 200 registers (no spill)
//    give two CTAs an SM under __launch_bounds__(128, 2): paligemma's
//    prefill grid of 8 query tiles x 8 heads x 4 batches, 256 CTAs, fits
//    the 264 places of 132 SMs in one wave, which the causal tiles'
//    unequal work then bounds.
//  - dh 224 (Zamba2-7B's shared attention, 32 heads of 224) runs the same
//    kernel: 14 chunks 16 deep and 28 n8 tiles of O a warp; a row of 232
//    elements (464 bytes, 29 16-byte units) keeps ldmatrix's eight rows
//    in distinct banks, and a tile is 14 copies a thread; three tiles are
//    87 KB.  Zero-padding to 256 would copy q, k, v and o and do 14% more
//    products.
// wgmma with TMA, warp-specialised, is later work.
//
// Variant "simt" (flash_kernel): float32 (the tensor cores would round it
// to TF32), any dh up to 256 (bf16 at widths other than 64, 128, 224 and
// 256),
// and rows that are not 16-byte aligned; `variant="simt"` forces it.  One
// CTA of 256 threads per (64-query tile, head, batch).  The Q tile and
// one 64-key tile (K, then V in the same buffer) are staged in shared
// memory as fp32, rows padded to an odd stride so that the 16 rows one
// column is read from fall in distinct banks.  Thread (g, c) of 16 row
// groups x 16 column lanes owns query rows 4g..4g+3: for QK^T the key
// columns c + 16j (j < 4), for PV the output columns c + 16j (j < dh/16).
// A row's 64 scores live in the 16 lanes of one half-warp, so the row
// max and sum are xor-shuffles within it; m, l and the accumulator stay
// in registers.  Its FMAs run on the fp32 cores from shared memory, with
// synchronous loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

constexpr int BQ = 64;         // query rows per CTA
constexpr int BK = 64;         // keys per KV tile
constexpr int THREADS = 256;   // simt: 16 row groups x 16 column lanes
constexpr int PLD = BK + 1;    // row stride of the P tile
constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;
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
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Strides qs,
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
    if (lse != nullptr && lane == 0)  // (B, H, Sq); gridDim.y is H
      lse[(static_cast<long long>(b) * gridDim.y + h) * Sq + qi] =
          m[i] + logf(l[i]);
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
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
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
      static_cast<const T*>(v), static_cast<T*>(o), lse,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, H / KH,
      Sq, Sk, dh, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, const long long* st, int B, int H, int KH, int Sq,
             int Sk, int dh, float scale, int causal, cudaStream_t s) {
  if (dh <= 32)
    return launch<T, 2>(q, k, v, o, lse, st, B, H, KH, Sq, Sk, dh, scale,
                        causal, s);
  if (dh <= 64)
    return launch<T, 4>(q, k, v, o, lse, st, B, H, KH, Sq, Sk, dh, scale,
                        causal, s);
  if (dh <= 128)
    return launch<T, 8>(q, k, v, o, lse, st, B, H, KH, Sq, Sk, dh, scale,
                        causal, s);
  return launch<T, 16>(q, k, v, o, lse, st, B, H, KH, Sq, Sk, dh, scale,
                       causal, s);
}


// ------------------------------------------------------ variant "tc"
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 128;   // 4 warps, 16 query rows each

template <int DH>
struct Tile {
  static constexpr int LD = DH + 8;     // padded row, elements
  static constexpr int SIZE = BK * LD;  // elements of one 64-row tile
  // dh 64, 128: two stages of K and V; Q borrows tile 2 (stage 1's K) at
  // the start.  dh 224 and 256: Q, K and V, one tile each
  static constexpr size_t SMEM = (DH > 128 ? 3 : 4) * SIZE * sizeof(bf16);
};

// rows row0 .. row0+63 of one head into a padded tile (mma.cuh)
template <int DH>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int row0,
                                          int n) {
  mma::cp_async_rows<BK, DH, Tile<DH>::LD, THREADS>(dst, src, stride, row0,
                                                     n);
}

// the same in a loop that is not unrolled (the dh-256 kernel's K and V
// copies inside its KV loop)
template <int DH>
__device__ __forceinline__ void load_tile_rolled(bf16* dst, const bf16* src,
                                                 long long stride, int row0,
                                                 int n) {
  mma::cp_async_rows_rolled<BK, DH, Tile<DH>::LD, THREADS>(dst, src, stride,
                                                            row0, n);
}

// s += A K^T over one 16-deep chunk: A the warp's 16 rows (an A
// fragment), K the tile's 64 keys at depth c0 .. c0+15 (B fragments read
// by ldmatrix from the tile as it lies: row-major K is the "col" operand)
template <int LD>
__device__ __forceinline__ void qk_chunk(float (&s)[8][4],
                                         const uint32_t (&a)[4],
                                         const bf16* Ks, int c0, int lane) {
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    uint32_t kf[4];  // B fragments of keys 16np .. 16np+15
    mma::ldmatrix_x4(kf, Ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                             c0 + ((lane >> 3) & 1) * 8);
    mma::mma_bf16(s[2 * np], a, kf[0], kf[1]);
    mma::mma_bf16(s[2 * np + 1], a, kf[2], kf[3]);
  }
}

// one KV tile of the online softmax in the log2 domain on the S fragments
// of the warp's rows w0 + g and w0 + g + 8: the -1e30 mask (keys past Sk,
// causal row < key) only on an edge tile; m and l (which sums the
// unrounded p) updated, acc rescaled; s becomes p
template <int NO>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], float (&m)[2],
                                             float (&l)[2],
                                             float (&acc)[NO][4], int k0,
                                             int w0, int lane, int Sk,
                                             int causal, float scale_log2) {
  const int g = lane >> 2, t4 = lane & 3;
  const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > w0);
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * scale_log2;
      if (edge) {
        const int key = k0 + 8 * j + 2 * t4 + (e & 1);
        const int row = w0 + g + 8 * (e >> 1);
        if (key >= Sk || (causal && row < key)) x = NEG_INF;
      }
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[j][e] - m[e >> 1]);
      s[j][e] = p;
      rs[e >> 1] += p;  // this lane's share of the row sum
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    acc[j][0] *= alpha[0];
    acc[j][1] *= alpha[0];
    acc[j][2] *= alpha[1];
    acc[j][3] *= alpha[1];
  }
}

// O += P V over one KV tile: P rounded to bf16 in registers (two
// neighbouring S fragments are one A fragment), V's B fragments by
// ldmatrix.trans
template <int DH>
__device__ __forceinline__ void pv_tile(float (&acc)[DH / 8][4],
                                        const float (&s)[8][4],
                                        const bf16* Vs, int lane) {
  constexpr int LD = Tile<DH>::LD;
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) {
    const uint32_t pa[4] = {
        mma::pack_bf16(s[2 * kc][0], s[2 * kc][1]),
        mma::pack_bf16(s[2 * kc][2], s[2 * kc][3]),
        mma::pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
        mma::pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp) {
      uint32_t vf[4];  // B fragments of columns 16dp .. 16dp+15
      mma::ldmatrix_x4_trans(
          vf, Vs + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                  dp * 16 + (lane >> 4) * 8);
      mma::mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
      mma::mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
    }
  }
}

// the warp's rows of O = acc / max(l, 1e-30) in bf16 and, when asked, the
// lse (m is in log2 units; gridDim.x is H)
template <int NO>
__device__ __forceinline__ void store_rows(const float (&acc)[NO][4],
                                           const float (&m)[2], float (&l)[2],
                                           bf16* __restrict__ o,
                                           float* __restrict__ lse,
                                           Strides os, int b, int h, int w0,
                                           int lane, int Sq) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);  // the row's four lanes
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
    const int row = w0 + g + 8 * r;
    if (row >= Sq) continue;
    bf16* dst = o + b * os.b + row * os.s + h * os.h + 2 * t4;
    const float den = fmaxf(l[r], 1e-30f);
    if (lse != nullptr && t4 == 0)
      lse[(static_cast<long long>(b) * gridDim.x + h) * Sq + row] =
          m[r] * LN2 + logf(l[r]);
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          mma::pack_bf16(acc[j][2 * r] / den, acc[j][2 * r + 1] / den);
  }
}

// dh 64 and 128: Q in registers, K and V through a two-stage ring
template <int DH>
__global__ void __launch_bounds__(THREADS, 2)
    flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, Strides qs, Strides ks,
                    Strides vs, Strides os, int rep,
                    int Sq, int Sk, float scale_log2, int causal) {
  using T = Tile<DH>;
  constexpr int KC = DH / 16;  // 16-deep chunks of a head
  constexpr int NO = DH / 8;   // n8 tiles of a head (O's fragments)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* tiles = reinterpret_cast<bf16*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / rep;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * BQ, w0 = q0 + warp * 16;  // first row of the warp
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;

  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, qt + 1);

  load_tile<DH>(tiles + 2 * T::SIZE, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
  load_tile<DH>(tiles, kb, ks.s, 0, Sk);
  load_tile<DH>(tiles + T::SIZE, vb, vs.s, 0, Sk);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KC][4];  // the warp's 16 rows of Q as A fragments
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
    mma::ldmatrix_x4(qf[kc], tiles + 2 * T::SIZE +
                                 (warp * 16 + (lane & 15)) * T::LD +
                                 kc * 16 + (lane >> 4) * 8);
  __syncthreads();  // Q is in registers: tile 2 is free for the ring

  // rows g and g+8 of the warp: [0] for fragments c0, c1; [1] for c2, c3
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t > 0) {
      mma::cp_async_wait<0>();  // tile t has landed
      __syncthreads();          // ... for every thread; tile t-1 is consumed
    }
    if (t + 1 < n_tiles) {      // tile t+1 into the other stage
      bf16* nxt = tiles + ((t + 1) & 1) * 2 * T::SIZE;
      load_tile<DH>(nxt, kb, ks.s, (t + 1) * BK, Sk);
      load_tile<DH>(nxt + T::SIZE, vb, vs.s, (t + 1) * BK, Sk);
      mma::cp_async_commit();
    }
    const bf16* Ks = tiles + (t & 1) * 2 * T::SIZE;
    const bf16* Vs = Ks + T::SIZE;

    // S = Q K^T: 8 n8 tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
      qk_chunk<T::LD>(s, qf[kc], Ks, kc * 16, lane);
    softmax_tile<NO>(s, m, l, acc, t * BK, w0, lane, Sk, causal, scale_log2);
    pv_tile<DH>(acc, s, Vs, lane);
  }
  store_rows<NO>(acc, m, l, o, lse, os, b, h, w0, lane, Sq);
}

// dh 224 and 256: Q stays in shared memory and its A fragments are
// reloaded by ldmatrix each KV tile; K and V have one buffer each and move
// in turn: K(t+1) is in flight while the warps form P and multiply by
// V(t), V(t+1) while they compute S of tile t+1 (three barriers a tile)
template <int DH>
__global__ void __launch_bounds__(THREADS, 2)
    flash_tc_wide_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         float* __restrict__ lse, Strides qs, Strides ks,
                         Strides vs, Strides os, int rep, int Sq, int Sk,
                         float scale_log2, int causal) {
  using T = Tile<DH>;
  constexpr int KC = DH / 16;
  constexpr int NO = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + T::SIZE;
  bf16* Vs = Ks + T::SIZE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / rep;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * BQ, w0 = q0 + warp * 16;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;

  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, qt + 1);

  load_tile<DH>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
  load_tile<DH>(Ks, kb, ks.s, 0, Sk);
  mma::cp_async_commit();  // group: Q and K(0)
  load_tile<DH>(Vs, vb, vs.s, 0, Sk);
  mma::cp_async_commit();  // group: V(0)

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  mma::cp_async_wait<1>();  // Q and K(0) have landed
  __syncthreads();          // ... for every thread
  for (int t = 0; t < n_tiles; ++t) {
    const bool more = t + 1 < n_tiles;
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t qa[4];
      mma::ldmatrix_x4(qa, Qs + (warp * 16 + (lane & 15)) * T::LD + kc * 16 +
                               (lane >> 4) * 8);
      qk_chunk<T::LD>(s, qa, Ks, kc * 16, lane);
    }
    __syncthreads();  // every warp is done with K(t)
    if (more) {
      load_tile_rolled<DH>(Ks, kb, ks.s, (t + 1) * BK, Sk);
      mma::cp_async_commit();
    }
    softmax_tile<NO>(s, m, l, acc, t * BK, w0, lane, Sk, causal, scale_log2);
    if (more)
      mma::cp_async_wait<1>();  // V(t) has landed; K(t+1) may be in flight
    else
      mma::cp_async_wait<0>();
    __syncthreads();  // ... for every thread
    pv_tile<DH>(acc, s, Vs, lane);
    if (more) {
      mma::cp_async_wait<0>();  // K(t+1) has landed
      __syncthreads();          // ... for every thread; V(t) is consumed
      load_tile_rolled<DH>(Vs, vb, vs.s, (t + 1) * BK, Sk);
      mma::cp_async_commit();
    }
  }
  store_rows<NO>(acc, m, l, o, lse, os, b, h, w0, lane, Sq);
}

// the kernel of a head width (only that one is instantiated)
template <int DH>
auto kernel_for() {
  if constexpr (DH > 128)
    return flash_tc_wide_kernel<DH>;
  else
    return flash_tc_kernel<DH>;
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const long long* st, int B, int H, int KH, int Sq, int Sk,
           float scale, int causal, cudaStream_t stream) {
  auto kernel = kernel_for<DH>();
  const size_t bytes = Tile<DH>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B, (Sq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, H / KH,
      Sq, Sk, scale * 1.4426950408889634f, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// q, o (B, Sq, H, dh); k, v (B, Sk, KH, dh); lse null or fp32 (B, H, Sq),
// contiguous; `strides` holds the batch,
// sequence and head strides of q, k, v and o, in elements, in that order
// (12 values, host memory).  dtype: 0 float32, 1 bfloat16.  variant: 0
// "simt" (1 <= dh <= 256), 1 "tc" (bfloat16, dh 64, 128, 224 or 256,
// 16-byte aligned pointers, strides multiples of 8 elements: the
// wrapper's rule; any other width returns cudaErrorInvalidValue).
// H % KH == 0.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      const long long* strides, int B, int H,
                                      int KH, int Sq, int Sk, int dh,
                                      float scale, int causal, int dtype,
                                      int variant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (dtype == 1 && dh == 64)
      return tc::launch<64>(q, k, v, o, lse, strides, B, H, KH, Sq, Sk,
                            scale, causal, s);
    if (dtype == 1 && dh == 128)
      return tc::launch<128>(q, k, v, o, lse, strides, B, H, KH, Sq, Sk,
                             scale, causal, s);
    if (dtype == 1 && dh == 224)
      return tc::launch<224>(q, k, v, o, lse, strides, B, H, KH, Sq, Sk,
                             scale, causal, s);
    if (dtype == 1 && dh == 256)
      return tc::launch<256>(q, k, v, o, lse, strides, B, H, KH, Sq, Sk,
                             scale, causal, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, lse, strides, B, H, KH, Sq,
                                   Sk, dh, scale, causal, s);
  return dispatch<float>(q, k, v, o, lse, strides, B, H, KH, Sq, Sk, dh,
                         scale, causal, s);
}
