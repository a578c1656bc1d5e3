// flash_attention_bwd: the gradient of the flash-attention kernel
// (flash_attention.cu) as CUDA kernels for Hopper (sm_90a), in two
// variants.
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
// contiguous last axis; float32 or bfloat16, sums in fp32; dh <= 256.
//
// Deterministic in both variants: no float atomics.  One CTA per (64-key
// tile, KV head, batch) owns its dK and dV rows and loops over the query
// heads of its KV head and over the query tiles in a fixed order; one CTA
// per (64-query tile, head, batch) owns its dQ rows and loops over the KV
// tiles (up to the diagonal under `causal`).  Both recompute S and dP
// from q, k, v and dO (seven products where the function needs five); two
// calls on the same inputs give equal bits.
//
// What bounds it: at the training shape (B 8, S 512, H 16, KH 8, dh 128,
// bf16, causal) the function moves 100.9 MB (q, k, v, o, dO, lse read
// once, dq, dk, dv written once: 0.030 ms at 3.35 TB/s) and does five
// products over the causal half, 21.5 GFLOP (0.022 ms at the bf16
// tensor-core rate of 989 TFLOP/s): the memory rate bounds the function.
// The kernels recompute S and dP and read q, dO (dkv) and k, v (dq) once
// per tile pair from the L2, so what bounds them is the tensor-core and
// ldmatrix issue rate of mma.sync: about 34 GFLOP of m16n8k16 products at
// that shape, the diagonal tiles' masked halves included.
//
// Variant "tc" (bf16, dh 64, 128, 224 or 256, 16-byte aligned rows of q, k, v,
// o and dO), what training runs, on mma.sync m16n8k16 (bf16 in, fp32
// accumulator) with the helpers of mma.cuh, as the forward's "tc".  At dh
// 64 and 128 (dkv_tc_kernel, dq_tc_kernel, delta_tc_kernel) each CTA has
// 4 warps and 16 rows a warp:
//  - dkv: a warp owns 16 keys.  It works in the transposed orientation,
//    S^T = K Q^T and dP^T = V dO^T, with K and V the A operand (ldmatrix
//    from the K and V tiles, loaded once) and Q and dO the "col" B operand
//    (ldmatrix from the tiles as they lie).  P^T = exp2(S^T scale log2 e -
//    lse log2 e) and dS^T = P^T o (dP^T - D) are formed on the accumulator
//    fragments (lse and D are per query, a column here, read as float2
//    from a 64-entry row in shared memory), masked to exactly 0, rounded
//    to bf16 and packed in registers as A fragments (two neighbouring C
//    fragments are one A fragment), then dV += P^T dO and dK += dS^T Q
//    with dO and Q read by ldmatrix.trans.  P and dS never leave the
//    registers.  At dh 128 a warp holds dK and dV, two 16 x 128 fp32
//    accumulators (128 registers a thread), and S^T and dP^T of the 64
//    queries (64 more), so K's and V's A fragments are reloaded from
//    shared memory for each query tile rather than kept: ptxas gives 255
//    registers and an 8-byte spill under __launch_bounds__(128, 2) (32-
//    query sub-blocks spilled the same and ran no faster).  Q, dO and
//    their lse and D rows come through a two-stage cp.async ring, one
//    barrier an iteration: iteration i + 1's tiles are in flight while i
//    computes.  The key tile is the slowest grid axis in order: under
//    `causal` key tile 0 sees every query tile, so the heaviest CTAs
//    start first.
//  - dq: a warp owns 16 queries.  Q and dO, loaded once, are the A
//    operand (their fragments reloaded by ldmatrix each KV tile: dQ's
//    accumulator and S and dP hold 128 registers); K and V come through
//    the two-stage ring and are the B operand of S = Q K^T and dP = dO V^T
//    as they lie and, by ldmatrix.trans, of dQ += dS K.  The query tile is
//    the slowest grid axis, reversed under `causal` (tile i does i + 1 KV
//    tiles).
//  - delta: 16-byte loads, dh / 8 lanes a row (rounded up to a power of
//    two, the lanes past it adding 0), summed by xor-shuffles.
// Rows are padded by 16 bytes, so ldmatrix's eight rows fall in distinct
// banks.  Shared memory: six 64-row tiles and two stages of the lse and D
// rows, 103 KB at dh 128 (two CTAs an SM) and 55 KB at dh 64.  P and dS
// are rounded to bf16 before their products, as in FlashAttention-2 and
// as the forward rounds P.
//
// At dh 256 (paligemma's one KV head of 256) a warp of that design would
// hold two 16 x 256 fp32 accumulators, 256 registers a thread, and the
// (KV head, batch, key tile) grid is 64 CTAs at paligemma's training
// shape (B 8, S 512, 8/1 heads).  So its kernels (dkv_tc_wide_kernel,
// dq_tc_wide_kernel, delta_tc_kernel<256>, dkv_sum_kernel) have CTAs of 8
// warps that share the products without computing any twice:
//  - dkv: warp w computes S^T and dP^T for keys 16 (w % 4) .. +15 and
//    queries 32 (w / 4) .. +31 of the 64 x 64 tile pair over the whole
//    head, forms P^T and dS^T on the fragments and writes them to shared
//    memory in bf16 (two 64 x 64 tiles); after a barrier it owns dK and
//    dV of keys 16 (w % 4) .. +15 x columns 128 (w / 4) .. +127 and reads
//    the P^T and dS^T rows of its keys back by ldmatrix as A fragments:
//    128 accumulator registers and 32 for S^T and dP^T.  K and V are
//    loaded once, Q, dO and their lse and D rows through the two-stage
//    ring: 217 KB of shared memory, one CTA an SM, two barriers an
//    iteration.  The grid gains a split of each GQA group's query heads
//    (flash_attention.bwd_split picks it: the smallest divisor of H / KH
//    whose CTAs outnumber the SMs; 4 at paligemma's shape, 256 CTAs):
//    each split writes fp32 partials of dK and dV to scratch, and
//    dkv_sum_kernel adds them in split order (16-byte loads) and rounds
//    to bf16, so the sums stay in a fixed order.  One split writes bf16
//    directly.
//  - dq: warp w computes S and dP for queries 16 (w % 4) .. +15 and keys
//    32 (w / 4) .. +31 of the KV tile, writes dS in bf16 to shared memory
//    and, after a barrier, owns dQ of its 16 queries x columns 128 (w / 4)
//    .. +127 (64 registers).  Q and dO are loaded once, K and V through
//    the ring: 208 KB, one CTA an SM; the grid is dh 128's, 512 CTAs at
//    paligemma's shape.
// What bounds them at that shape is the same five products' issue rate
// (mma.sync and ldmatrix, 21.5 GFLOP with the masked halves of the
// diagonal tiles) and the causal imbalance of the dK/dV tiles: key tile 0
// sees all 8 query tiles, key tile 7 one.  wgmma with TMA is later work.
// At dh 224 (Zamba2-7B's shared attention, 32 heads of 224, MHA) the same
// kernels run: a warp's half of the head is 112 columns, 7 m16n8k16
// column pairs, 112 accumulator registers for dK and dV; rows of 232
// elements (29 16-byte units) keep ldmatrix conflict-free, and a tile is
// 7 copies a thread of 256.  Shared memory 193 KB (dkv) and 184 KB (dq).
// With one query head a KV head the split is 1 and dK, dV go out in bf16.
//
// Variant "simt" (delta_kernel, dkv_kernel, dq_kernel): float32 (the
// tensor cores would round it to TF32), dh 1..256 (bf16 at widths other
// than 64, 128, 224, 256), unaligned rows; `variant="simt"` forces it.  Each
// CTA has 256 threads: 16 row groups g x 16 column lanes, and works on
// tiles of TR = 16 R rows (R = 4 up to dh 128, R = 2 above).  For a TR x
// TR tile of S or dP, thread (g, lane) owns rows Rg..Rg+R-1 and keys
// lane + 16j (j < R), as in the forward's SIMT variant; the products read
// rows of q/dO and k/v staged in shared memory as fp32 with an odd row
// stride, so the 16 rows a half-warp reads fall in distinct banks.  For
// the accumulators, thread (g, lane) owns rows (keys in dkv_kernel,
// queries in dq_kernel) Rg..Rg+R-1 and columns lane + 16j (j < dh / 16),
// in registers; P and dS pass through shared memory between the two.  Its
// FMAs run on the fp32 cores from shared memory with synchronous loads.
// Shared memory holds four [TR][dh | 1] fp32 tiles: at dh 128 with 64-row
// tiles 166 KB (dkv), one CTA an SM; at dh 256 64-row tiles would need
// 290 KB, over the card's 227 KB a block, so the tiles there are 32 rows
// (140 KB dkv, 136 KB dq), and the accumulators 2 rows x 16 columns a
// thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

constexpr int BQ = 64;         // query rows per tile ("tc")
constexpr int BK = 64;         // keys per tile ("tc")
constexpr int THREADS = 256;   // 16 row groups x 16 column lanes
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

// rows row0 .. row0+TR-1 of head h of batch b into dst[TR][ld] as fp32;
// rows at or past n are zero
template <int TR, typename T>
__device__ void load_tile(float* dst, int ld, const T* __restrict__ src,
                          Strides st, int b, int h, int row0, int n, int dh) {
  const T* base = src + b * st.b + h * st.h;
  for (int i = threadIdx.x; i < TR * dh; i += THREADS) {
    const int r = i / dh, d = i - r * dh, row = row0 + r;
    dst[r * ld + d] = row < n ? to_f(base[row * st.s + d]) : 0.f;
  }
}

// lse and D of rows q0 .. q0+TR-1 of head h into Ls, Dl (0 past Sq)
template <int TR>
__device__ void load_rows(float* Ls, float* Dl, const float* __restrict__ lse,
                          const float* __restrict__ delta, long long bh,
                          int q0, int Sq) {
  for (int i = threadIdx.x; i < TR; i += THREADS) {
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

// S = A B^T and dP = C E^T for rows r0..r0+R-1 of A, C and rows lane + 16j
// (j < R) of B, E (all [16 R][ld] tiles)
template <int R>
__device__ __forceinline__ void two_products(
    float (&s)[R][R], float (&dp)[R][R], const float* A, const float* Bt,
    const float* C, const float* Et, int ld, int r0, int lane, int dh) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int d = 0; d < dh; ++d) {
    float a[R], c[R], bv[R], ev[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      a[i] = A[(r0 + i) * ld + d];
      c[i] = C[(r0 + i) * ld + d];
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      bv[j] = Bt[(lane + 16 * j) * ld + d];
      ev[j] = Et[(lane + 16 * j) * ld + d];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] = fmaf(a[i], bv[j], s[i][j]);
        dp[i][j] = fmaf(c[i], ev[j], dp[i][j]);
      }
  }
}

// dK and dV of one TR-key tile of one KV head: the query heads that share
// it, then the query tiles, in that fixed order
template <typename T, int NJ, int R>  // NJ * 16 >= dh; tiles of 16 R rows
__global__ void __launch_bounds__(THREADS)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, Strides qs,
               Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
               int rep, int H, int Sq, int Sk, int dh, float scale,
               int causal) {
  constexpr int TR = 16 * R, PLD = TR + 1;  // PLD: P and dS row stride
  extern __shared__ float smem[];
  const int ld = dh | 1;
  float* Ks = smem;             // [TR][ld]
  float* Vs = Ks + TR * ld;     // [TR][ld]
  float* Qs = Vs + TR * ld;     // [TR][ld]
  float* Gs = Qs + TR * ld;     // [TR][ld]: dO
  float* Ps = Gs + TR * ld;     // [TR][PLD]: P
  float* Ss = Ps + TR * PLD;    // [TR][PLD]: dS
  float* Ls = Ss + TR * PLD;    // [TR]: lse
  float* Dl = Ls + TR;          // [TR]: D
  const int lane = threadIdx.x & 15, r0 = (threadIdx.x >> 4) * R;
  const int k0 = blockIdx.x * TR, hk = blockIdx.y, b = blockIdx.z;

  load_tile<TR>(Ks, ld, k, ks, b, hk, k0, Sk, dh);
  load_tile<TR>(Vs, ld, v, vs, b, hk, k0, Sk, dh);

  // keys k0 + r0 + i, columns lane + 16j
  float dK[R][NJ], dV[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dK[i][j] = dV[i][j] = 0.f;

  const int n_qt = (Sq + TR - 1) / TR;
  const int qt0 = causal ? k0 / TR : 0;  // no row of an earlier tile sees k0
  for (int r = 0; r < rep; ++r) {
    const int h = hk * rep + r;
    const long long bh = static_cast<long long>(b) * H + h;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * TR;
      __syncthreads();  // the previous tiles are consumed
      load_tile<TR>(Qs, ld, q, qs, b, h, q0, Sq, dh);
      load_tile<TR>(Gs, ld, dout, dos, b, h, q0, Sq, dh);
      load_rows<TR>(Ls, Dl, lse, delta, bh, q0, Sq);
      __syncthreads();

      float s[R][R], dp[R][R];  // rows q0 + r0 + i, keys k0 + lane + 16j
      two_products<R>(s, dp, Qs, Ks, Gs, Vs, ld, r0, lane, dh);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int row = q0 + r0 + i;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int key = k0 + lane + 16 * j;
          float p = 0.f;
          if (row < Sq && key < Sk && !(causal && row < key))
            p = expf(s[i][j] * scale - Ls[r0 + i]);
          Ps[(r0 + i) * PLD + lane + 16 * j] = p;
          Ss[(r0 + i) * PLD + lane + 16 * j] = p * (dp[i][j] - Dl[r0 + i]);
        }
      }
      __syncthreads();  // P and dS are written

      // dV += P^T dO, dK += dS^T Q over the tile's TR rows
      for (int rr = 0; rr < TR; ++rr) {
        float pv[R], sv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pv[i] = Ps[rr * PLD + r0 + i];
          sv[i] = Ss[rr * PLD + r0 + i];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = lane + 16 * j;
          if (c < dh) {
            const float g = Gs[rr * ld + c], qv = Qs[rr * ld + c];
#pragma unroll
            for (int i = 0; i < R; ++i) {
              dV[i][j] = fmaf(pv[i], g, dV[i][j]);
              dK[i][j] = fmaf(sv[i], qv, dK[i][j]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
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

// dQ of one TR-query tile of one head: the KV tiles in order
template <typename T, int NJ, int R>
__global__ void __launch_bounds__(THREADS)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, Strides qs, Strides ks, Strides vs,
              Strides dos, Strides dqs, int rep, int H, int Sq, int Sk,
              int dh, float scale, int causal) {
  constexpr int TR = 16 * R, PLD = TR + 1;  // PLD: dS row stride
  extern __shared__ float smem[];
  const int ld = dh | 1;
  float* Qs = smem;             // [TR][ld]
  float* Gs = Qs + TR * ld;     // [TR][ld]: dO
  float* Ks = Gs + TR * ld;     // [TR][ld]
  float* Vs = Ks + TR * ld;     // [TR][ld]
  float* Ss = Vs + TR * ld;     // [TR][PLD]: dS
  float* Ls = Ss + TR * PLD;    // [TR]: lse
  float* Dl = Ls + TR;          // [TR]: D
  const int lane = threadIdx.x & 15, r0 = (threadIdx.x >> 4) * R;
  const int q0 = blockIdx.x * TR, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / rep;

  load_tile<TR>(Qs, ld, q, qs, b, h, q0, Sq, dh);
  load_tile<TR>(Gs, ld, dout, dos, b, h, q0, Sq, dh);
  load_rows<TR>(Ls, Dl, lse, delta, static_cast<long long>(b) * H + h, q0,
                Sq);

  // rows q0 + r0 + i, columns lane + 16j
  float dQ[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dQ[i][j] = 0.f;

  int n_tiles = (Sk + TR - 1) / TR;
  if (causal) n_tiles = min(n_tiles, (q0 + TR - 1) / TR + 1);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * TR;
    __syncthreads();  // the previous K tile and dS tile are consumed
    load_tile<TR>(Ks, ld, k, ks, b, hk, k0, Sk, dh);
    load_tile<TR>(Vs, ld, v, vs, b, hk, k0, Sk, dh);
    __syncthreads();

    float s[R][R], dp[R][R];  // rows q0 + r0 + i, keys k0 + lane + 16j
    two_products<R>(s, dp, Qs, Ks, Gs, Vs, ld, r0, lane, dh);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + r0 + i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int key = k0 + lane + 16 * j;
        float ds = 0.f;
        if (row < Sq && key < Sk && !(causal && row < key))
          ds = expf(s[i][j] * scale - Ls[r0 + i]) * (dp[i][j] - Dl[r0 + i]);
        Ss[(r0 + i) * PLD + lane + 16 * j] = ds;
      }
    }
    __syncthreads();  // dS is written

    // dQ += dS K over the tile's TR keys
    for (int kk = 0; kk < TR; ++kk) {
      float sv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) sv[i] = Ss[(r0 + i) * PLD + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 16 * j;
        if (c < dh) {
          const float kv = Ks[kk * ld + c];
#pragma unroll
          for (int i = 0; i < R; ++i) dQ[i][j] = fmaf(sv[i], kv, dQ[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
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

// dynamic shared memory of one CTA: four [TR][dh | 1] fp32 tiles, the P
// and dS tiles (dkv) or the dS tile (dq), and two rows of TR: 166 KB
// (dkv) and 149 KB (dq) at dh 128 (TR 64), 140 KB and 136 KB at dh 256
// (TR 32), under the card's 227 KB a block
size_t dkv_smem(int dh, int TR) {
  return static_cast<size_t>(4 * TR * (dh | 1) + 2 * TR * (TR + 1) +
                             2 * TR) * sizeof(float);
}
size_t dq_smem(int dh, int TR) {
  return static_cast<size_t>(4 * TR * (dh | 1) + TR * (TR + 1) + 2 * TR) *
         sizeof(float);
}

template <typename T, int NJ, int R>
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

  constexpr int TR = 16 * R;
  {
    auto kernel = dkv_kernel<T, NJ, R>;
    const size_t bytes = dkv_smem(dh, TR);
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((Sk + TR - 1) / TR, KH, B);
    kernel<<<grid, THREADS, bytes, stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        qs, ks, vs, dos, dks, dvs, rep, H, Sq, Sk, dh, scale, causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  {
    auto kernel = dq_kernel<T, NJ, R>;
    const size_t bytes = dq_smem(dh, TR);
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((Sq + TR - 1) / TR, H, B);
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
    return launch<T, 1, 4>(q, k, v, o, dout, lse, delta, dq, dk, dv, st, B,
                           H, KH, Sq, Sk, dh, scale, causal, s);
  if (dh <= 32)
    return launch<T, 2, 4>(q, k, v, o, dout, lse, delta, dq, dk, dv, st, B,
                           H, KH, Sq, Sk, dh, scale, causal, s);
  if (dh <= 64)
    return launch<T, 4, 4>(q, k, v, o, dout, lse, delta, dq, dk, dv, st, B,
                           H, KH, Sq, Sk, dh, scale, causal, s);
  if (dh <= 128)
    return launch<T, 8, 4>(q, k, v, o, dout, lse, delta, dq, dk, dv, st, B,
                           H, KH, Sq, Sk, dh, scale, causal, s);
  // 32-row tiles: four 64-row tiles of dh 256 do not fit 227 KB
  return launch<T, 16, 2>(q, k, v, o, dout, lse, delta, dq, dk, dv, st, B, H,
                          KH, Sq, Sk, dh, scale, causal, s);
}

// ------------------------------------------------------ variant "tc"
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 128;   // 4 warps, 16 rows each
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
struct Tile {
  static constexpr int LD = DH + 8;     // padded row, elements
  static constexpr int SIZE = BK * LD;  // elements of one 64-row tile
  // two tiles loaded once, two stages of two, two stages of the lse and
  // D rows
  static constexpr size_t SMEM =
      6 * SIZE * sizeof(bf16) + 2 * 2 * BQ * sizeof(float);
};

// rows row0 .. row0+63 of one head into a padded tile (mma.cuh), by the
// CTA's NT threads
template <int DH, int NT = THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int row0,
                                          int n) {
  mma::cp_async_rows<BK, DH, Tile<DH>::LD, NT>(dst, src, stride, row0, n);
}

// lse and D of rows row0 .. row0+63 of one (batch, head) into rows[0..63]
// and rows[64..127] by 4-byte async copies, one each by the first 128
// threads; rows at or past n are zero
__device__ __forceinline__ void load_rows(float* rows, const float* lse,
                                          const float* delta, int row0,
                                          int n) {
  if (threadIdx.x >= 2 * BQ) return;
  const int row = row0 + (threadIdx.x & 63);
  const bool ok = row < n;
  mma::cp_async4(rows + threadIdx.x,
                 (threadIdx.x < BQ ? lse : delta) + (ok ? row : 0),
                 ok ? 4 : 0);
}

// A fragment of the 16 x 16 block at (r0, c0) of a row-major tile
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* tile,
                                       int r0, int c0, int lane) {
  mma::ldmatrix_x4(a, tile + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8);
}

// B fragments of two n8 tiles (n0..n0+7 in [0], [1]; n0+8.. in [2], [3])
// at depth c0..c0+15 of a tile whose rows are n and columns the depth
// (the "col" operand as it lies: K in Q K^T)
template <int LD>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const bf16* tile,
                                       int n0, int c0, int lane) {
  mma::ldmatrix_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                          c0 + ((lane >> 3) & 1) * 8);
}

// the same from a tile whose rows are the depth k0..k0+15 and columns n
// (row-major (k, n): V in P V), by ldmatrix.trans
template <int LD>
__device__ __forceinline__ void frag_bt(uint32_t (&b)[4], const bf16* tile,
                                        int k0, int n0, int lane) {
  mma::ldmatrix_x4_trans(
      b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 +
             (lane >> 4) * 8);
}

// two neighbouring C fragments (columns 0-7, 8-15) rounded to bf16: one A
// fragment of a 16-deep product
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = mma::pack_bf16(c0[0], c0[1]);
  a[1] = mma::pack_bf16(c0[2], c0[3]);
  a[2] = mma::pack_bf16(c1[0], c1[1]);
  a[3] = mma::pack_bf16(c1[2], c1[3]);
}

// lanes a row of delta_tc_kernel: dh / 8 rounded up to a power of two, so
// that a row's lanes lie in one warp and xor-shuffles sum them
template <int DH>
__host__ __device__ constexpr int delta_lanes() {
  int n = 1;
  while (n < DH / 8) n *= 2;
  return n;
}

// D = rowsum(dO o o) by 16-byte loads: dh / 8 lanes a row (the lanes past
// them, at dh 224, add 0)
template <int DH>
__global__ void __launch_bounds__(256)
    delta_tc_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                    Strides os, Strides ds, float* __restrict__ delta, int H,
                    int Sq, long long rows) {
  constexpr int CH = DH / 8;
  constexpr int LANES = delta_lanes<DH>();
  const long long row =
      (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) / LANES;
  const int c = threadIdx.x % LANES;
  float acc = 0.f;
  if (row < rows && c < CH) {
    const int i = static_cast<int>(row % Sq);
    const long long bh = row / Sq;
    const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
    const uint4 a = *reinterpret_cast<const uint4*>(
        o + b * os.b + i * os.s + h * os.h + c * 8);
    const uint4 d = *reinterpret_cast<const uint4*>(
        dout + b * ds.b + i * ds.s + h * ds.h + c * 8);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float2 fa = __bfloat1622float2(a2[m]);
      const float2 fd = __bfloat1622float2(d2[m]);
      acc = fmaf(fa.x, fd.x, acc);
      acc = fmaf(fa.y, fd.y, acc);
    }
  }
#pragma unroll
  for (int off = LANES / 2; off; off >>= 1)
    acc += __shfl_xor_sync(FULL, acc, off);
  if (row < rows && c == 0) delta[row] = acc;
}

// dK and dV of one 64-key tile of one KV head: the query heads that share
// it, then the query tiles, in that fixed order
template <int DH>
__global__ void __launch_bounds__(THREADS, 2)
    dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, Strides qs, Strides ks, Strides vs,
                  Strides dos, Strides dks, Strides dvs, int rep, int H,
                  int Sq, int Sk, float scale, int causal) {
  using T = Tile<DH>;
  constexpr int KC = DH / 16;  // 16-deep chunks of a head
  constexpr int NO = DH / 8;   // n8 tiles of a head (dK's, dV's fragments)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + T::SIZE;
  bf16* ring = Vs + T::SIZE;  // stage s: Q at 2s, dO at 2s + 1 tiles
  float* rows = reinterpret_cast<float*>(ring + 4 * T::SIZE);  // 128 a stage
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int hk = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;
  const int k0 = kt * BK, kw = k0 + warp * 16;  // the warp's first key
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int qt0 = causal ? kt : 0;  // no row of an earlier tile sees k0
  const int n_per = max(n_qt - qt0, 0), n_it = rep * n_per;
  const float scale_log2 = scale * LOG2E;

  // iteration i: query head hk * rep + i / n_per, query tile qt0 + i % n_per
  auto issue = [&](int i) {
    const int h = hk * rep + i / n_per, q0 = (qt0 + i % n_per) * BQ;
    bf16* stage = ring + 2 * (i & 1) * T::SIZE;
    const long long bh = static_cast<long long>(b) * H + h;
    load_tile<DH>(stage, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
    load_tile<DH>(stage + T::SIZE, dout + b * dos.b + h * dos.h, dos.s, q0,
                  Sq);
    load_rows(rows + 2 * BQ * (i & 1), lse + bh * Sq, delta + bh * Sq, q0,
              Sq);
    mma::cp_async_commit();
  };
  if (n_it > 0) {
    load_tile<DH>(Ks, k + b * ks.b + hk * ks.h, ks.s, k0, Sk);
    load_tile<DH>(Vs, v + b * vs.b + hk * vs.h, vs.s, k0, Sk);
    issue(0);
  }

  // keys kw + g + 8 (e >> 1), columns 8j + 2 t4 + (e & 1)
  float dK[NO][4], dV[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dK[j][e] = dV[j][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    mma::cp_async_wait<0>();  // iteration it's tiles have landed
    __syncthreads();          // ... for every thread; it - 1's are consumed
    if (it + 1 < n_it) issue(it + 1);
    const bf16* Qs = ring + 2 * (it & 1) * T::SIZE;
    const bf16* Gs = Qs + T::SIZE;
    const float* Ls = rows + 2 * BQ * (it & 1);
    const float* Ds = Ls + BQ;
    const int q0 = (qt0 + it % n_per) * BQ;

    // S^T = K Q^T, dP^T = V dO^T: keys kw + g (+8) x queries 8j + 2 t4 (+1)
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t ka[4], va[4];
      frag_a<T::LD>(ka, Ks, warp * 16, kc * 16, lane);
      frag_a<T::LD>(va, Vs, warp * 16, kc * 16, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t qb[4], gb[4];
        frag_b<T::LD>(qb, Qs, np * 16, kc * 16, lane);
        mma::mma_bf16(st[2 * np], ka, qb[0], qb[1]);
        mma::mma_bf16(st[2 * np + 1], ka, qb[2], qb[3]);
        frag_b<T::LD>(gb, Gs, np * 16, kc * 16, lane);
        mma::mma_bf16(dpt[2 * np], va, gb[0], gb[1]);
        mma::mma_bf16(dpt[2 * np + 1], va, gb[2], gb[3]);
      }
    }

    // P^T and dS^T on the fragments, exactly 0 where masked
    const bool edge = q0 + BQ > Sq || kw + 16 > Sk ||
                      (causal && q0 < kw + 15);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t4;  // the lane's first query in the tile
      const float2 l2 = *reinterpret_cast<const float2*>(Ls + c);
      const float2 d2 = *reinterpret_cast<const float2*>(Ds + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lq = (e & 1) ? l2.y : l2.x, dq = (e & 1) ? d2.y : d2.x;
        float p = exp2f(fmaf(st[j][e], scale_log2, -lq * LOG2E));
        float ds = p * (dpt[j][e] - dq);
        if (edge) {
          const int row = q0 + c + (e & 1), key = kw + g + 8 * (e >> 1);
          if (row >= Sq || key >= Sk || (causal && row < key))
            p = ds = 0.f;
        }
        st[j][e] = p;
        dpt[j][e] = ds;
      }
    }

    // dV += P^T dO, dK += dS^T Q over the tile's 64 queries
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
      uint32_t pa[4], sa[4];
      pack_a(pa, st[2 * kc], st[2 * kc + 1]);
      pack_a(sa, dpt[2 * kc], dpt[2 * kc + 1]);
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t gb[4], qb[4];
        frag_bt<T::LD>(gb, Gs, kc * 16, dp * 16, lane);
        mma::mma_bf16(dV[2 * dp], pa, gb[0], gb[1]);
        mma::mma_bf16(dV[2 * dp + 1], pa, gb[2], gb[3]);
        frag_bt<T::LD>(qb, Qs, kc * 16, dp * 16, lane);
        mma::mma_bf16(dK[2 * dp], sa, qb[0], qb[1]);
        mma::mma_bf16(dK[2 * dp + 1], sa, qb[2], qb[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw + g + 8 * r;
    if (key >= Sk) continue;
    bf16* krow = dk + b * dks.b + key * dks.s + hk * dks.h + 2 * t4;
    bf16* vrow = dv + b * dvs.b + key * dvs.s + hk * dvs.h + 2 * t4;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      *reinterpret_cast<uint32_t*>(krow + 8 * j) =
          mma::pack_bf16(dK[j][2 * r] * scale, dK[j][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(vrow + 8 * j) =
          mma::pack_bf16(dV[j][2 * r], dV[j][2 * r + 1]);
    }
  }
}

// dQ of one 64-query tile of one head: the KV tiles in order
template <int DH>
__global__ void __launch_bounds__(THREADS, 2)
    dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dq,
                 Strides qs, Strides ks, Strides vs, Strides dos,
                 Strides dqs, int rep, int H, int Sq, int Sk, float scale,
                 int causal) {
  using T = Tile<DH>;
  constexpr int KC = DH / 16;
  constexpr int NO = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Gs = Qs + T::SIZE;
  bf16* ring = Gs + T::SIZE;  // stage s: K at 2s, V at 2s + 1 tiles
  float* rows = reinterpret_cast<float*>(ring + 4 * T::SIZE);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / rep;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * BQ, w0 = q0 + warp * 16;  // first row of the warp
  const long long bh = static_cast<long long>(b) * H + h;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  const float scale_log2 = scale * LOG2E;

  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, qt + 1);

  load_tile<DH>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
  load_tile<DH>(Gs, dout + b * dos.b + h * dos.h, dos.s, q0, Sq);
  load_rows(rows, lse + bh * Sq, delta + bh * Sq, q0, Sq);
  load_tile<DH>(ring, kb, ks.s, 0, Sk);
  load_tile<DH>(ring + T::SIZE, vb, vs.s, 0, Sk);
  mma::cp_async_commit();

  // rows w0 + g + 8 (e >> 1), columns 8j + 2 t4 + (e & 1)
  float dQ[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dQ[j][e] = 0.f;
  float lr[2], dr[2];  // lse (log2 units) and D of rows g and g + 8

  for (int t = 0; t < n_tiles; ++t) {
    mma::cp_async_wait<0>();  // tile t has landed
    __syncthreads();          // ... for every thread; tile t-1 is consumed
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lr[r] = rows[warp * 16 + g + 8 * r] * LOG2E;
        dr[r] = rows[BQ + warp * 16 + g + 8 * r];
      }
    }
    if (t + 1 < n_tiles) {  // tile t+1 into the other stage
      bf16* nxt = ring + 2 * ((t + 1) & 1) * T::SIZE;
      load_tile<DH>(nxt, kb, ks.s, (t + 1) * BK, Sk);
      load_tile<DH>(nxt + T::SIZE, vb, vs.s, (t + 1) * BK, Sk);
      mma::cp_async_commit();
    }
    const bf16* Ks = ring + 2 * (t & 1) * T::SIZE;
    const bf16* Vs = Ks + T::SIZE;

    // S = Q K^T, dP = dO V^T: 8 n8 tiles of 8 keys each
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t qa[4], ga[4];
      frag_a<T::LD>(qa, Qs, warp * 16, kc * 16, lane);
      frag_a<T::LD>(ga, Gs, warp * 16, kc * 16, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4], vf[4];
        frag_b<T::LD>(kf, Ks, np * 16, kc * 16, lane);
        mma::mma_bf16(s[2 * np], qa, kf[0], kf[1]);
        mma::mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
        frag_b<T::LD>(vf, Vs, np * 16, kc * 16, lane);
        mma::mma_bf16(dp[2 * np], ga, vf[0], vf[1]);
        mma::mma_bf16(dp[2 * np + 1], ga, vf[2], vf[3]);
      }
    }

    // dS = P o (dP - D) on the fragments, exactly 0 where masked
    const int k0 = t * BK;
    const bool edge = k0 + BK > Sk || w0 + 16 > Sq ||
                      (causal && k0 + BK - 1 > w0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float ds = exp2f(fmaf(s[j][e], scale_log2, -lr[r])) *
                   (dp[j][e] - dr[r]);
        if (edge) {
          const int key = k0 + 8 * j + 2 * t4 + (e & 1);
          const int row = w0 + g + 8 * r;
          if (key >= Sk || row >= Sq || (causal && row < key)) ds = 0.f;
        }
        s[j][e] = ds;
      }

    // dQ += dS K, dS rounded to bf16 in registers
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t sa[4];
      pack_a(sa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int dc = 0; dc < DH / 16; ++dc) {
        uint32_t kf[4];
        frag_bt<T::LD>(kf, Ks, kc * 16, dc * 16, lane);
        mma::mma_bf16(dQ[2 * dc], sa, kf[0], kf[1]);
        mma::mma_bf16(dQ[2 * dc + 1], sa, kf[2], kf[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    if (row >= Sq) continue;
    bf16* dst = dq + b * dqs.b + row * dqs.s + h * dqs.h + 2 * t4;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          mma::pack_bf16(dQ[j][2 * r] * scale, dQ[j][2 * r + 1] * scale);
  }
}

// ---- dh 224 and 256: eight warps, P^T and dS^T (dS for dQ) through
// shared memory
constexpr int WTHREADS = 256;  // 8 warps
constexpr int PLD = BQ + 8;    // row stride of a P or dS tile, elements

template <int DH>
struct Wide {
  using T = Tile<DH>;
  static constexpr int DC = DH / 2;  // columns of dK, dV or dQ a warp owns
  static constexpr int PSIZE = BK * PLD;
  // K, V (dkv) or Q, dO (dq) loaded once, two stages of two tiles, the P
  // and dS tiles (dkv) or the dS tile (dq), the lse and D rows
  static constexpr size_t DKV_SMEM = 6 * T::SIZE * sizeof(bf16) +
                                     2 * PSIZE * sizeof(bf16) +
                                     2 * 2 * BQ * sizeof(float);
  static constexpr size_t DQ_SMEM = 6 * T::SIZE * sizeof(bf16) +
                                    PSIZE * sizeof(bf16) +
                                    2 * BQ * sizeof(float);
};

// an accumulator fragment pair (rows r0 + g, r0 + g + 8; columns c0 + 8j +
// 2 t4 (+1)) rounded to bf16 into a [64][PLD] tile
__device__ __forceinline__ void put_bf16(bf16* tile, const float (&c)[4],
                                         int r0, int c0, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  *reinterpret_cast<uint32_t*>(tile + (r0 + g) * PLD + c0 + 2 * t4) =
      mma::pack_bf16(c[0], c[1]);
  *reinterpret_cast<uint32_t*>(tile + (r0 + g + 8) * PLD + c0 + 2 * t4) =
      mma::pack_bf16(c[2], c[3]);
}

// dK and dV of one 64-key tile of one KV head, for the query heads of one
// split of its GQA group (all of them when n_split is 1), then the query
// tiles, in that fixed order.  Warp w: S^T and dP^T of keys 16 (w % 4) ..
// +15 x queries 32 (w / 4) .. +31 of the tile over the whole head; dK and
// dV of the same keys x columns DC (w / 4) .. +DC-1.  `part` null: dk and
// dv in bf16; else fp32 partials (2, n_split, B, Sk, KH, DH), summed by
// dkv_sum_kernel
template <int DH>
__global__ void __launch_bounds__(WTHREADS, 1)
    dkv_tc_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, float* __restrict__ part,
                       Strides qs, Strides ks, Strides vs, Strides dos,
                       Strides dks, Strides dvs, int rep, int H, int KH,
                       int Sq, int Sk, float scale, int causal, int n_split) {
  using T = Tile<DH>;
  using W = Wide<DH>;
  constexpr int KC = DH / 16;
  constexpr int NO = W::DC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + T::SIZE;
  bf16* ring = Vs + T::SIZE;  // stage s: Q at 2s, dO at 2s + 1 tiles
  bf16* Ps = ring + 4 * T::SIZE;
  bf16* Ss = Ps + W::PSIZE;
  float* rows = reinterpret_cast<float*>(Ss + W::PSIZE);  // 128 a stage
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kr = (warp & 3) * 16;   // the warp's keys in the tile
  const int qc = (warp >> 2) * 32;  // its queries in the tile (S^T, dP^T)
  const int dc = (warp >> 2) * W::DC;  // its columns of dK and dV
  const int hk = blockIdx.x / n_split, sp = blockIdx.x % n_split;
  const int b = blockIdx.y, kt = blockIdx.z;
  const int k0 = kt * BK, kw = k0 + kr;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int qt0 = causal ? kt : 0;  // no row of an earlier tile sees k0
  const int n_per = max(n_qt - qt0, 0), rs = rep / n_split;
  const int n_it = rs * n_per, h0 = hk * rep + sp * rs;
  const float scale_log2 = scale * LOG2E;

  // iteration i: query head h0 + i / n_per, query tile qt0 + i % n_per
  auto issue = [&](int i) {
    const int h = h0 + i / n_per, q0 = (qt0 + i % n_per) * BQ;
    bf16* stage = ring + 2 * (i & 1) * T::SIZE;
    const long long bh = static_cast<long long>(b) * H + h;
    load_tile<DH, WTHREADS>(stage, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
    load_tile<DH, WTHREADS>(stage + T::SIZE, dout + b * dos.b + h * dos.h,
                            dos.s, q0, Sq);
    load_rows(rows + 2 * BQ * (i & 1), lse + bh * Sq, delta + bh * Sq, q0,
              Sq);
    mma::cp_async_commit();
  };
  if (n_it > 0) {
    load_tile<DH, WTHREADS>(Ks, k + b * ks.b + hk * ks.h, ks.s, k0, Sk);
    load_tile<DH, WTHREADS>(Vs, v + b * vs.b + hk * vs.h, vs.s, k0, Sk);
    issue(0);
  }

  // keys kw + g + 8 (e >> 1), columns dc + 8j + 2 t4 + (e & 1)
  float dK[NO][4], dV[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dK[j][e] = dV[j][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    mma::cp_async_wait<0>();  // iteration it's tiles have landed
    __syncthreads();          // ... for every thread; it - 1 is consumed
    if (it + 1 < n_it) issue(it + 1);
    const bf16* Qs = ring + 2 * (it & 1) * T::SIZE;
    const bf16* Gs = Qs + T::SIZE;
    const float* Ls = rows + 2 * BQ * (it & 1);
    const float* Ds = Ls + BQ;
    const int q0 = (qt0 + it % n_per) * BQ;

    // S^T = K Q^T, dP^T = V dO^T: keys kw + g (+8) x queries qc + 8j +
    // 2 t4 (+1)
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t ka[4], va[4];
      frag_a<T::LD>(ka, Ks, kr, kc * 16, lane);
      frag_a<T::LD>(va, Vs, kr, kc * 16, lane);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t qb[4], gb[4];
        frag_b<T::LD>(qb, Qs, qc + np * 16, kc * 16, lane);
        mma::mma_bf16(st[2 * np], ka, qb[0], qb[1]);
        mma::mma_bf16(st[2 * np + 1], ka, qb[2], qb[3]);
        frag_b<T::LD>(gb, Gs, qc + np * 16, kc * 16, lane);
        mma::mma_bf16(dpt[2 * np], va, gb[0], gb[1]);
        mma::mma_bf16(dpt[2 * np + 1], va, gb[2], gb[3]);
      }
    }

    // P^T and dS^T on the fragments, exactly 0 where masked, to shared
    // memory in bf16
    const bool edge = q0 + qc + 32 > Sq || kw + 16 > Sk ||
                      (causal && q0 + qc < kw + 15);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = qc + 8 * j + 2 * t4;  // the lane's first query
      const float2 l2 = *reinterpret_cast<const float2*>(Ls + c);
      const float2 d2 = *reinterpret_cast<const float2*>(Ds + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lq = (e & 1) ? l2.y : l2.x, dq = (e & 1) ? d2.y : d2.x;
        float p = exp2f(fmaf(st[j][e], scale_log2, -lq * LOG2E));
        float ds = p * (dpt[j][e] - dq);
        if (edge) {
          const int row = q0 + c + (e & 1), key = kw + g + 8 * (e >> 1);
          if (row >= Sq || key >= Sk || (causal && row < key))
            p = ds = 0.f;
        }
        st[j][e] = p;
        dpt[j][e] = ds;
      }
      put_bf16(Ps, st[j], kr, qc + 8 * j, lane);
      put_bf16(Ss, dpt[j], kr, qc + 8 * j, lane);
    }
    __syncthreads();  // the tile's P^T and dS^T are whole

    // dV += P^T dO, dK += dS^T Q over the tile's 64 queries, the warp's
    // columns
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
      uint32_t pa[4], sa[4];
      frag_a<PLD>(pa, Ps, kr, kc * 16, lane);
      frag_a<PLD>(sa, Ss, kr, kc * 16, lane);
#pragma unroll
      for (int dp = 0; dp < W::DC / 16; ++dp) {
        uint32_t gb[4], qb[4];
        frag_bt<T::LD>(gb, Gs, kc * 16, dc + dp * 16, lane);
        mma::mma_bf16(dV[2 * dp], pa, gb[0], gb[1]);
        mma::mma_bf16(dV[2 * dp + 1], pa, gb[2], gb[3]);
        frag_bt<T::LD>(qb, Qs, kc * 16, dc + dp * 16, lane);
        mma::mma_bf16(dK[2 * dp], sa, qb[0], qb[1]);
        mma::mma_bf16(dK[2 * dp + 1], sa, qb[2], qb[3]);
      }
    }
  }

  const long long n_out = static_cast<long long>(gridDim.y) * Sk * KH * DH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw + g + 8 * r;
    if (key >= Sk) continue;
    if (part == nullptr) {
      bf16* krow = dk + b * dks.b + key * dks.s + hk * dks.h + dc + 2 * t4;
      bf16* vrow = dv + b * dvs.b + key * dvs.s + hk * dvs.h + dc + 2 * t4;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        *reinterpret_cast<uint32_t*>(krow + 8 * j) =
            mma::pack_bf16(dK[j][2 * r] * scale, dK[j][2 * r + 1] * scale);
        *reinterpret_cast<uint32_t*>(vrow + 8 * j) =
            mma::pack_bf16(dV[j][2 * r], dV[j][2 * r + 1]);
      }
    } else {  // (2, n_split, B, Sk, KH, DH); dK unscaled
      float* kp = part + sp * n_out +
                  ((static_cast<long long>(b) * Sk + key) * KH + hk) * DH +
                  dc + 2 * t4;
      float* vp = kp + n_split * n_out;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        *reinterpret_cast<float2*>(kp + 8 * j) =
            make_float2(dK[j][2 * r], dK[j][2 * r + 1]);
        *reinterpret_cast<float2*>(vp + 8 * j) =
            make_float2(dV[j][2 * r], dV[j][2 * r + 1]);
      }
    }
  }
}

// dk = scale * the sum of the n_split partials of dK, dv the sum of dV's,
// in split order; four columns a thread
__global__ void __launch_bounds__(256)
    dkv_sum_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, Strides dks, Strides dvs, int Sk,
                   int KH, int dh, int n_split, long long n_out,
                   float scale) {
  const long long i4 =
      (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) * 4;
  if (i4 >= n_out) return;
  const int which = blockIdx.y;  // 0: dK, 1: dV
  const float* src = part + which * n_split * n_out + i4;
  float4 a = *reinterpret_cast<const float4*>(src);
  for (int s = 1; s < n_split; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(src + s * n_out);
    a.x += x.x;
    a.y += x.y;
    a.z += x.z;
    a.w += x.w;
  }
  const float f = which ? 1.f : scale;
  const int c = static_cast<int>(i4 % dh);
  const long long rest = i4 / dh;
  const int hk = static_cast<int>(rest % KH);
  const int key = static_cast<int>((rest / KH) % Sk);
  const int b = static_cast<int>(rest / KH / Sk);
  const Strides st = which ? dvs : dks;
  bf16* dst = (which ? dv : dk) + b * st.b + key * st.s + hk * st.h + c;
  const uint2 out = make_uint2(mma::pack_bf16(a.x * f, a.y * f),
                               mma::pack_bf16(a.z * f, a.w * f));
  *reinterpret_cast<uint2*>(dst) = out;
}

// dQ of one 64-query tile of one head: the KV tiles in order.  Warp w: S
// and dP of queries 16 (w % 4) .. +15 x keys 32 (w / 4) .. +31 of the KV
// tile over the whole head; dQ of the same queries x columns DC (w / 4) ..
// +DC-1
template <int DH>
__global__ void __launch_bounds__(WTHREADS, 1)
    dq_tc_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dq,
                      Strides qs, Strides ks, Strides vs, Strides dos,
                      Strides dqs, int rep, int H, int Sq, int Sk,
                      float scale, int causal) {
  using T = Tile<DH>;
  using W = Wide<DH>;
  constexpr int KC = DH / 16;
  constexpr int NO = W::DC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Gs = Qs + T::SIZE;
  bf16* ring = Gs + T::SIZE;  // stage s: K at 2s, V at 2s + 1 tiles
  bf16* Ss = ring + 4 * T::SIZE;
  float* rows = reinterpret_cast<float*>(Ss + W::PSIZE);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int qr = (warp & 3) * 16;      // the warp's queries in the tile
  const int kc0 = (warp >> 2) * 32;    // its keys in the KV tile (S, dP)
  const int dc = (warp >> 2) * W::DC;  // its columns of dQ
  const int h = blockIdx.x, b = blockIdx.y, hk = h / rep;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * BQ, w0 = q0 + qr;
  const long long bh = static_cast<long long>(b) * H + h;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  const float scale_log2 = scale * LOG2E;

  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, qt + 1);

  load_tile<DH, WTHREADS>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
  load_tile<DH, WTHREADS>(Gs, dout + b * dos.b + h * dos.h, dos.s, q0,
                          Sq);
  load_rows(rows, lse + bh * Sq, delta + bh * Sq, q0, Sq);
  load_tile<DH, WTHREADS>(ring, kb, ks.s, 0, Sk);
  load_tile<DH, WTHREADS>(ring + T::SIZE, vb, vs.s, 0, Sk);
  mma::cp_async_commit();

  // rows w0 + g + 8 (e >> 1), columns dc + 8j + 2 t4 + (e & 1)
  float dQ[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dQ[j][e] = 0.f;
  float lr[2], dr[2];  // lse (log2 units) and D of rows g and g + 8

  for (int t = 0; t < n_tiles; ++t) {
    mma::cp_async_wait<0>();  // tile t has landed
    __syncthreads();          // ... for every thread; tile t-1 is consumed
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lr[r] = rows[qr + g + 8 * r] * LOG2E;
        dr[r] = rows[BQ + qr + g + 8 * r];
      }
    }
    if (t + 1 < n_tiles) {  // tile t+1 into the other stage
      bf16* nxt = ring + 2 * ((t + 1) & 1) * T::SIZE;
      load_tile<DH, WTHREADS>(nxt, kb, ks.s, (t + 1) * BK, Sk);
      load_tile<DH, WTHREADS>(nxt + T::SIZE, vb, vs.s, (t + 1) * BK, Sk);
      mma::cp_async_commit();
    }
    const bf16* Ks = ring + 2 * (t & 1) * T::SIZE;
    const bf16* Vs = Ks + T::SIZE;

    // S = Q K^T, dP = dO V^T: rows w0 + g (+8) x keys kc0 + 8j + 2 t4 (+1)
    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t qa[4], ga[4];
      frag_a<T::LD>(qa, Qs, qr, kc * 16, lane);
      frag_a<T::LD>(ga, Gs, qr, kc * 16, lane);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t kf[4], vf[4];
        frag_b<T::LD>(kf, Ks, kc0 + np * 16, kc * 16, lane);
        mma::mma_bf16(s[2 * np], qa, kf[0], kf[1]);
        mma::mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
        frag_b<T::LD>(vf, Vs, kc0 + np * 16, kc * 16, lane);
        mma::mma_bf16(dp[2 * np], ga, vf[0], vf[1]);
        mma::mma_bf16(dp[2 * np + 1], ga, vf[2], vf[3]);
      }
    }

    // dS = P o (dP - D) on the fragments, exactly 0 where masked, to
    // shared memory in bf16
    const int k0 = t * BK + kc0;  // the warp's first key
    const bool edge = k0 + 32 > Sk || w0 + 16 > Sq ||
                      (causal && k0 + 31 > w0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float ds = exp2f(fmaf(s[j][e], scale_log2, -lr[r])) *
                   (dp[j][e] - dr[r]);
        if (edge) {
          const int key = k0 + 8 * j + 2 * t4 + (e & 1);
          const int row = w0 + g + 8 * r;
          if (key >= Sk || row >= Sq || (causal && row < key)) ds = 0.f;
        }
        s[j][e] = ds;
      }
      put_bf16(Ss, s[j], qr, kc0 + 8 * j, lane);
    }
    __syncthreads();  // the tile's dS is whole

    // dQ += dS K over the tile's 64 keys, the warp's columns
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t sa[4];
      frag_a<PLD>(sa, Ss, qr, kc * 16, lane);
#pragma unroll
      for (int dn = 0; dn < W::DC / 16; ++dn) {
        uint32_t kf[4];
        frag_bt<T::LD>(kf, Ks, kc * 16, dc + dn * 16, lane);
        mma::mma_bf16(dQ[2 * dn], sa, kf[0], kf[1]);
        mma::mma_bf16(dQ[2 * dn + 1], sa, kf[2], kf[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    if (row >= Sq) continue;
    bf16* dst = dq + b * dqs.b + row * dqs.s + h * dqs.h + dc + 2 * t4;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          mma::pack_bf16(dQ[j][2 * r] * scale, dQ[j][2 * r + 1] * scale);
  }
}

// the dynamic shared memory a kernel needs, and the carveout that gives
// two CTAs an SM at dh 128
template <typename K>
cudaError_t max_shared(K kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, float* part, const long long* st, int B,
           int H, int KH, int Sq, int Sk, float scale, int causal,
           int n_split, cudaStream_t stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]},
      dos{st[12], st[13], st[14]}, dqs{st[15], st[16], st[17]},
      dks{st[18], st[19], st[20]}, dvs{st[21], st[22], st[23]};
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  const int rep = H / KH;

  const long long rows = static_cast<long long>(B) * H * Sq;
  const unsigned blocks =
      static_cast<unsigned>((rows * delta_lanes<DH>() + 255) / 256);
  delta_tc_kernel<DH><<<blocks, 256, 0, stream>>>(
      static_cast<const bf16*>(o), dot, os, dos, delta, H, Sq, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if constexpr (DH > 128) {
    using W = Wide<DH>;
    auto dkv = dkv_tc_wide_kernel<DH>;
    err = max_shared(dkv, W::DKV_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    dkv<<<dim3(KH * n_split, B, (Sk + BK - 1) / BK), WTHREADS, W::DKV_SMEM,
          stream>>>(qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dk),
                    static_cast<bf16*>(dv), n_split > 1 ? part : nullptr, qs,
                    ks, vs, dos, dks, dvs, rep, H, KH, Sq, Sk, scale, causal,
                    n_split);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_split > 1) {
      const long long n_out = static_cast<long long>(B) * Sk * KH * DH;
      dkv_sum_kernel<<<dim3(static_cast<unsigned>((n_out / 4 + 255) / 256),
                            2), 256, 0, stream>>>(
          part, static_cast<bf16*>(dk), static_cast<bf16*>(dv), dks, dvs, Sk,
          KH, DH, n_split, n_out, scale);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    auto dqk = dq_tc_wide_kernel<DH>;
    err = max_shared(dqk, W::DQ_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    dqk<<<dim3(H, B, (Sq + BQ - 1) / BQ), WTHREADS, W::DQ_SMEM, stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dq), qs, ks, vs, dos,
        dqs, rep, H, Sq, Sk, scale, causal);
  } else {
    const size_t bytes = Tile<DH>::SMEM;
    auto dkv = dkv_tc_kernel<DH>;
    err = max_shared(dkv, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    dkv<<<dim3(KH, B, (Sk + BK - 1) / BK), THREADS, bytes, stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), qs, ks, vs, dos, dks, dvs, rep, H, Sq, Sk,
        scale, causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);

    auto dqk = dq_tc_kernel<DH>;
    err = max_shared(dqk, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    dqk<<<dim3(H, B, (Sq + BQ - 1) / BQ), THREADS, bytes, stream>>>(
        qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dq), qs, ks, vs, dos,
        dqs, rep, H, Sq, Sk, scale, causal);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc


}  // namespace

// q, o, dout, dq (B, Sq, H, dh); k, v, dk, dv (B, Sk, KH, dh); lse and
// delta fp32 (B, H, Sq), contiguous (delta is scratch the launch fills).
// `strides` holds the batch, sequence and head strides of q, k, v, o,
// dout, dq, dk and dv, in elements, in that order (24 values, host
// memory).  dtype: 0 float32, 1 bfloat16.  use_tc: 0 "simt" (dh 1..256),
// 1 "tc" (bfloat16, dh 64, 128, 224 or 256, 16-byte aligned pointers,
// strides multiples of 8 elements: the wrapper's rule).  n_split: at dh 224
// and 256 "tc", the number of parts the query heads of a GQA group are
// split into for dK and dV (a divisor of H / KH); above 1, `part` is fp32
// scratch of 2 x n_split x B x Sk x KH x dh values.  Else 1 and null.
// H % KH == 0.
// Returns cudaGetLastError() after the last launch.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, const long long* strides, int B, int H, int KH, int Sq, int Sk,
    int dh, float scale, int causal, int dtype, int use_tc, int n_split,
    float* part, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh < 1 || dh > 256 || KH < 1 || H % KH || n_split < 1 ||
      (H / KH) % n_split || (n_split > 1 && (part == nullptr || dh <= 128 ||
                                             !use_tc)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (use_tc) {
    if (dtype == 1 && dh == 64)
      return tc::launch<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, part,
                            strides, B, H, KH, Sq, Sk, scale, causal, 1, s);
    if (dtype == 1 && dh == 128)
      return tc::launch<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, part,
                             strides, B, H, KH, Sq, Sk, scale, causal, 1, s);
    if (dtype == 1 && dh == 224)
      return tc::launch<224>(q, k, v, o, dout, lse, delta, dq, dk, dv, part,
                             strides, B, H, KH, Sq, Sk, scale, causal,
                             n_split, s);
    if (dtype == 1 && dh == 256)
      return tc::launch<256>(q, k, v, o, dout, lse, delta, dq, dk, dv, part,
                             strides, B, H, KH, Sq, Sk, scale, causal,
                             n_split, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                   strides, B, H, KH, Sq, Sk, dh, scale,
                                   causal, s);
  return dispatch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, strides,
                         B, H, KH, Sq, Sk, dh, scale, causal, s);
}
