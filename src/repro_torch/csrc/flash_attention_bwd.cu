// Flash-attention backward, for Hopper (sm_90a): dQ, dK and dV of the
// forward in flash_attention.cu, from its output O, the log-sum-exp `lse`
// it writes and the output gradient dO.
//
// Replaces no TPU kernel: the JAX package computes this backward in plain
// JAX (`_make_blocked_vjp`'s bwd, src/repro/kernels/flash_attention/
// ops.py:166, a lax.scan of einsums over KV blocks that saves (out, lse)
// and recomputes p per block).  The port needs it as a kernel because its
// forward is one, which autograd cannot see through.  q, O, dO (B, H, Sq,
// D), k/v (B, KH, Sk, D), contiguous; lse (B, H, Sq) float32; dq, dk, dv in
// their inputs' types.  The masks and the visible-key rule are the
// forward's (`visible`, `key_range`); a masked pair has p = 0, so a row
// that sees no key (output 0 in the forward) has no gradient.
//
// Bound: operations — the backward's five products (S, dP, dV, dK, dQ), 10
// B H Sq Sk D FLOPs times the visible fraction, against the bf16
// tensor-core peak (989 TFLOP/s) or, in float32, the CUDA cores' (67
// TFLOP/s).  Both pairs below split the work into two kernels, launched in
// this order on one stream, so that every output element is summed in one
// fixed order with no atomics (deterministic run to run): a dQ kernel,
// which also writes delta = rowsum(dO O), then a dK/dV kernel that keeps a
// key tile's dK and dV on chip while it walks every query head of the KV
// head's group (G = H / KH) and every query tile that sees one of its
// keys.  Each kernel recomputes S and dP, so the pair does seven products
// where the bound counts five: the price of determinism without a float32
// dQ scratch summed by atomics.
//
// flash_bwd_dq_wgmma_kernel / flash_bwd_dkdv_wgmma_kernel — bfloat16 at head
// dims 64, 128 and 256: the tensor cores.  Warpgroup 0 of a block gives
// its registers away (`setmaxnreg`) and one of its threads loads every
// tile by TMA into a ring with full and empty mbarriers (the out-of-bounds
// zero fill gives the ragged edges); the consumer warpgroups run the
// products by `wgmma`, bf16 operands and float32 accumulators.  dQ: a
// block per (query rows, h, b) holds its Q and dO tiles and streams K and
// V tiles, S = Q K^T and dP = dO V^T (both K-major), P = exp2(S scale
// log2 e - lse log2 e) with S scaled exactly as the forward scales it, dS
// = P (dP - delta) converted in registers to the bf16 A operand (as the
// forward turns S into P), dQ += dS K with K read MN-major; the thread's
// two rows' delta comes from O and dO in global memory (a quad a row), and
// the kernel writes delta and lse2 = lse log2 e (+inf where lse is -1e30
// or the row lies past Sq, so p = 0 there) for the second kernel.  dK/dV:
// a block per (keys, KV head, b) holds K and V and streams Q and dO tiles
// with their lse2 and delta (1-D bulk copies); keys are the accumulators'
// rows, so S^T = K Q^T and dP^T = V dO^T, lse2 and delta apply per column,
// and dV += P^T dO, dK += dS^T Q read dO and Q MN-major.  A warpgroup
// skips the products of a tile in which none of its pairs is visible, and
// masks only tiles that straddle a mask edge.
//
// At D 64 and 128 a block owns 128 rows, 64 a consumer
// warpgroup, in a 3-stage ring: at D 128 a thread holds dK and dV (128
// float32 registers) beside S^T and dP^T (64), within the 240 that
// `setmaxnreg` gives, with 64-row streamed tiles; at D 64 the same
// registers hold 128-row tiles.  At D 256 that design breaks three ways,
// and the kernels answer each:
//  - registers: 64 keys' dK and dV at 256 columns are 256 registers a
//    thread.  The dK/dV block's two consumer warpgroups share its 64 keys
//    instead: warpgroup 0 computes S^T, P^T and dV, warpgroup 1 dP^T, dS^T
//    and dK, each 128 accumulator registers.  dS^T needs P^T: warpgroup 0
//    writes it in float32, in its accumulator order (conflict-free), to one
//    of two 16 KB slots, and the two meet on named barriers (kPFull,
//    kPFree) instead of a block-wide one.  The dQ kernel's warpgroups own
//    64 query rows each (dQ 128 registers, S and dP 16 or 32);
//  - shared memory: 64-row tiles at D 256 are 32 KB, so the dK/dV block
//    holds 64 keys (64 KB) and a 2-stage ring of 64-row Q and dO tiles
//    (128 KB) beside the slots; the dQ block holds 128 query rows (128 KB)
//    and a 3-stage ring of 32-key K and V tiles (96 KB);
//  - the grid under MQA: a block per 64 keys gives B KH Sk / 64 blocks
//    (64 at recurrentgemma-9b's training shape, KH 1, for 132 SMs).  The
//    wrapper splits each group's query heads into `split` slices over
//    blocks (the fewest that fill the card; ops.bwd_split); each slice's
//    block writes float32 partial dK and dV, and flash_bwd_sum_kernel adds
//    them in slice order and rounds once.
// No atomics anywhere: every output element is summed in one fixed order,
// bit-equal run to run.  Float32 stays on the CUDA cores: TF32 would round
// past its 2e-5 tolerance; bf16 at D 32 and 96 too (later work).
//
// flash_bwd_dq_kernel / flash_bwd_dkdv_kernel — float32 at every head dim
// and bfloat16 at 32 and 96: CUDA-core float32 FMAs on tiles staged
// in shared memory as float32 (bfloat16 widened on the way in), with the
// forward's 16 x 16 thread grid and its rows padded by one float; the
// scale multiplies q before Q K^T, and dQ once more at the end.  They read
// their operands from shared memory and so run well below the float32
// peak.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;     // the forward's lse of a keyless row

enum Mode { kCausal = 0, kLength = 1, kFull = 2 };

__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x;
  o[1] = x.y;
  o[2] = x.z;
  o[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  o[0] = a.x;
  o[1] = a.y;
  o[2] = b.x;
  o[3] = b.y;
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
struct Tile {
  static constexpr int BQ = D == 256 ? 32 : 64;  // query rows per tile
  static constexpr int BK = D == 256 ? 32 : 64;  // keys per tile
  static constexpr int RQ = BQ / 16;             // query rows per thread
  static constexpr int RK = BK / 16;             // keys per thread
  static constexpr int RD = D / 16;              // columns per thread
  static constexpr int LD = D + 1;               // padded row, floats
  static constexpr int LS = BK + 1;              // a row of dS (dq pass)
  static constexpr int LT = BQ + 1;              // a row of P^T, dS^T
  static constexpr size_t kDqSmem =
      sizeof(float) * (size_t)(2 * BQ * LD + 2 * BK * LD + BQ * LS + 2 * BQ);
  static constexpr size_t kDkdvSmem =
      sizeof(float) * (size_t)(2 * BQ * LD + 2 * BK * LD + 2 * BK * LT +
                               2 * BQ);
};

// Stage rows [row0, row0 + rows) of a (n_rows, D) matrix as float32 into
// dst (row stride LD), times `scale`; rows past n_rows are zeros.
template <typename T, int D, int LD>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           int row0, int rows, int n_rows,
                                           float scale) {
  for (int e = threadIdx.x * 4; e < rows * D; e += kThreads * 4) {
    const int r = e / D, c = e % D;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < n_rows) load4(src + (size_t)(row0 + r) * D + c, x);
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[r * LD + c + i] = x[i] * scale;
  }
}

// the forward's rule: query row qi (< sq) sees key kj
__device__ __forceinline__ bool visible(int mode, int qi, int kj, int len,
                                        int window, int q_offset, int sq,
                                        int sk) {
  if (qi >= sq || kj >= sk) return false;
  if (mode == kCausal) {
    const int qp = qi + q_offset;
    return kj <= qp && (window <= 0 || kj > qp - window);
  }
  if (mode == kLength) return kj < len && (window <= 0 || kj >= len - window);
  return true;
}

// the KV range [k_lo, k_hi) that holds a visible key for some query row in
// [q0, q_last] (the forward's block skip)
__device__ __forceinline__ void key_range(int mode, int q0, int q_last,
                                          int len, int window, int q_offset,
                                          int sk, int* k_lo, int* k_hi) {
  *k_lo = 0;
  *k_hi = sk;
  if (mode == kCausal) {
    *k_hi = min(sk, q_last + q_offset + 1);
    if (window > 0) *k_lo = max(0, q0 + q_offset - window + 1);
  } else if (mode == kLength) {
    *k_hi = min(sk, len);
    if (window > 0) *k_lo = max(0, len - window);
  }
}

// its converse: the query rows [q_lo, q_hi) that may see a key of [k_first,
// k_last] (causal: k <= q + q_offset, and k > q + q_offset - window)
__device__ __forceinline__ void query_range(int mode, int k_first,
                                            int k_last, int len, int window,
                                            int q_offset, int sq, int* q_lo,
                                            int* q_hi) {
  *q_lo = 0;
  *q_hi = sq;
  if (mode == kCausal) {
    *q_lo = max(0, k_first - q_offset);
    if (window > 0) *q_hi = min(sq, k_last + window - q_offset);
  } else if (mode == kLength) {
    if (k_first >= len || (window > 0 && k_last < len - window)) *q_hi = 0;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ out,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const int* __restrict__ lengths,
                    float* __restrict__ delta, T* __restrict__ dq, int H,
                    int KH, int Sq, int Sk, int mode, int window,
                    int q_offset, float scale) {
  using G = Tile<D>;
  extern __shared__ float smem[];
  float* qs = smem;                       // (BQ, LD) q * scale
  float* dos = qs + G::BQ * G::LD;        // (BQ, LD) dO
  float* ks = dos + G::BQ * G::LD;        // (BK, LD)
  float* vs = ks + G::BK * G::LD;         // (BK, LD)
  float* ds = vs + G::BK * G::LD;         // (BQ, LS) dS
  float* lse_s = ds + G::BQ * G::LS;      // (BQ)
  float* delta_s = lse_s + G::BQ;         // (BQ)

  const int q0 = blockIdx.x * G::BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const size_t row0 = (size_t)(b * H + h) * Sq;   // this head's row 0
  const T* kp = k + (size_t)(b * KH + kvh) * Sk * D;
  const T* vp = v + (size_t)(b * KH + kvh) * Sk * D;
  const int len = lengths[b];

  stage_rows<T, D, G::LD>(qs, q + row0 * D, q0, G::BQ, Sq, scale);
  stage_rows<T, D, G::LD>(dos, dout + row0 * D, q0, G::BQ, Sq, 1.f);
  __syncthreads();
  // delta = rowsum(dO * O), a warp a row
  for (int row = warp; row < G::BQ; row += kWarps) {
    float acc = 0.f;
    if (q0 + row < Sq)
      for (int c = 4 * lane; c < D; c += 128) {
        float o[4];
        load4(out + (row0 + q0 + row) * D + c, o);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc = fmaf(dos[row * G::LD + c + i], o[i], acc);
      }
    acc = warp_sum(acc);
    if (lane == 0) {
      const bool live = q0 + row < Sq;
      delta_s[row] = acc;
      lse_s[row] = live ? lse[row0 + q0 + row] : 0.f;
      if (live) delta[row0 + q0 + row] = acc;
    }
  }

  int k_lo, k_hi;
  key_range(mode, q0, min(q0 + G::BQ, Sq) - 1, len, window, q_offset, Sk,
            &k_lo, &k_hi);

  float acc[G::RQ][G::RD];
#pragma unroll
  for (int r = 0; r < G::RQ; ++r)
#pragma unroll
    for (int c = 0; c < G::RD; ++c) acc[r][c] = 0.f;

  for (int k0 = (k_lo / G::BK) * G::BK; k0 < k_hi; k0 += G::BK) {
    __syncthreads();  // the previous tile's K and dS are consumed
    stage_rows<T, D, G::LD>(ks, kp, k0, G::BK, Sk, 1.f);
    stage_rows<T, D, G::LD>(vs, vp, k0, G::BK, Sk, 1.f);
    __syncthreads();

    // S = Q K^T and dP = dO V^T on the 16 x 16 thread grid
    float s[G::RQ][G::RK], dp[G::RQ][G::RK];
#pragma unroll
    for (int r = 0; r < G::RQ; ++r)
#pragma unroll
      for (int c = 0; c < G::RK; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[G::RQ], dov[G::RQ], kv[G::RK], vv[G::RK];
#pragma unroll
      for (int r = 0; r < G::RQ; ++r) {
        qv[r] = qs[(ty + 16 * r) * G::LD + d];
        dov[r] = dos[(ty + 16 * r) * G::LD + d];
      }
#pragma unroll
      for (int c = 0; c < G::RK; ++c) {
        kv[c] = ks[(tx + 16 * c) * G::LD + d];
        vv[c] = vs[(tx + 16 * c) * G::LD + d];
      }
#pragma unroll
      for (int r = 0; r < G::RQ; ++r)
#pragma unroll
        for (int c = 0; c < G::RK; ++c) {
          s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
          dp[r][c] = fmaf(dov[r], vv[c], dp[r][c]);
        }
    }
    // dS = P (dP - delta), P = exp(S - lse) on the visible pairs
#pragma unroll
    for (int r = 0; r < G::RQ; ++r)
#pragma unroll
      for (int c = 0; c < G::RK; ++c) {
        const int row = ty + 16 * r, col = tx + 16 * c;
        const float p = visible(mode, q0 + row, k0 + col, len, window,
                                q_offset, Sq, Sk)
                            ? expf(s[r][c] - lse_s[row]) : 0.f;
        ds[row * G::LS + col] = p * (dp[r][c] - delta_s[row]);
      }
    __syncthreads();

    // dQ += dS K
#pragma unroll 4
    for (int j = 0; j < G::BK; ++j) {
      float dsv[G::RQ], kv[G::RD];
#pragma unroll
      for (int r = 0; r < G::RQ; ++r) dsv[r] = ds[(ty + 16 * r) * G::LS + j];
#pragma unroll
      for (int c = 0; c < G::RD; ++c) kv[c] = ks[j * G::LD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < G::RQ; ++r)
#pragma unroll
        for (int c = 0; c < G::RD; ++c)
          acc[r][c] = fmaf(dsv[r], kv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < G::RQ; ++r) {
    const int row = ty + 16 * r;
    if (q0 + row >= Sq) continue;
#pragma unroll
    for (int c = 0; c < G::RD; ++c)
      store1(dq + (row0 + q0 + row) * D + tx + 16 * c, acc[r][c] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ lengths, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int KH, int Sq, int Sk,
                      int mode, int window, int q_offset, float scale) {
  using G = Tile<D>;
  extern __shared__ float smem[];
  float* ks = smem;                       // (BK, LD)
  float* vs = ks + G::BK * G::LD;         // (BK, LD)
  float* qs = vs + G::BK * G::LD;         // (BQ, LD) q * scale
  float* dos = qs + G::BQ * G::LD;        // (BQ, LD) dO
  float* pt = dos + G::BQ * G::LD;        // (BK, LT) P^T
  float* dst = pt + G::BK * G::LT;        // (BK, LT) dS^T
  float* lse_s = dst + G::BK * G::LT;     // (BQ)
  float* delta_s = lse_s + G::BQ;         // (BQ)

  const int k0 = blockIdx.x * G::BK, kvh = blockIdx.y, b = blockIdx.z;
  const int group = H / KH;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t krow0 = (size_t)(b * KH + kvh) * Sk;   // this KV head's row 0
  const int len = lengths[b];

  stage_rows<T, D, G::LD>(ks, k + krow0 * D, k0, G::BK, Sk, 1.f);
  stage_rows<T, D, G::LD>(vs, v + krow0 * D, k0, G::BK, Sk, 1.f);

  int q_lo, q_hi;
  query_range(mode, k0, min(k0 + G::BK, Sk) - 1, len, window, q_offset, Sq,
              &q_lo, &q_hi);

  float dka[G::RK][G::RD], dva[G::RK][G::RD];
#pragma unroll
  for (int r = 0; r < G::RK; ++r)
#pragma unroll
    for (int c = 0; c < G::RD; ++c) dka[r][c] = dva[r][c] = 0.f;

  for (int g = 0; g < group; ++g) {
    const size_t row0 = (size_t)(b * H + kvh * group + g) * Sq;
    for (int q0 = (q_lo / G::BQ) * G::BQ; q0 < q_hi; q0 += G::BQ) {
      __syncthreads();  // the previous tile's Q, dO, P^T and dS^T consumed
      stage_rows<T, D, G::LD>(qs, q + row0 * D, q0, G::BQ, Sq, scale);
      stage_rows<T, D, G::LD>(dos, dout + row0 * D, q0, G::BQ, Sq, 1.f);
      for (int row = tid; row < G::BQ; row += kThreads) {
        const bool live = q0 + row < Sq;
        lse_s[row] = live ? lse[row0 + q0 + row] : 0.f;
        delta_s[row] = live ? delta[row0 + q0 + row] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: keys on ty, query rows on tx
      float s[G::RK][G::RQ], dp[G::RK][G::RQ];
#pragma unroll
      for (int r = 0; r < G::RK; ++r)
#pragma unroll
        for (int c = 0; c < G::RQ; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[G::RK], vv[G::RK], qv[G::RQ], dov[G::RQ];
#pragma unroll
        for (int r = 0; r < G::RK; ++r) {
          kv[r] = ks[(ty + 16 * r) * G::LD + d];
          vv[r] = vs[(ty + 16 * r) * G::LD + d];
        }
#pragma unroll
        for (int c = 0; c < G::RQ; ++c) {
          qv[c] = qs[(tx + 16 * c) * G::LD + d];
          dov[c] = dos[(tx + 16 * c) * G::LD + d];
        }
#pragma unroll
        for (int r = 0; r < G::RK; ++r)
#pragma unroll
          for (int c = 0; c < G::RQ; ++c) {
            s[r][c] = fmaf(kv[r], qv[c], s[r][c]);
            dp[r][c] = fmaf(vv[r], dov[c], dp[r][c]);
          }
      }
#pragma unroll
      for (int r = 0; r < G::RK; ++r)
#pragma unroll
        for (int c = 0; c < G::RQ; ++c) {
          const int kr = ty + 16 * r, qc = tx + 16 * c;
          const float p = visible(mode, q0 + qc, k0 + kr, len, window,
                                  q_offset, Sq, Sk)
                              ? expf(s[r][c] - lse_s[qc]) : 0.f;
          pt[kr * G::LT + qc] = p;
          dst[kr * G::LT + qc] = p * (dp[r][c] - delta_s[qc]);
        }
      __syncthreads();

      // dV += P^T dO, dK += dS^T (q scale)
#pragma unroll 4
      for (int j = 0; j < G::BQ; ++j) {
        float pv[G::RK], dsv[G::RK], dov[G::RD], qv[G::RD];
#pragma unroll
        for (int r = 0; r < G::RK; ++r) {
          pv[r] = pt[(ty + 16 * r) * G::LT + j];
          dsv[r] = dst[(ty + 16 * r) * G::LT + j];
        }
#pragma unroll
        for (int c = 0; c < G::RD; ++c) {
          dov[c] = dos[j * G::LD + tx + 16 * c];
          qv[c] = qs[j * G::LD + tx + 16 * c];
        }
#pragma unroll
        for (int r = 0; r < G::RK; ++r)
#pragma unroll
          for (int c = 0; c < G::RD; ++c) {
            dva[r][c] = fmaf(pv[r], dov[c], dva[r][c]);
            dka[r][c] = fmaf(dsv[r], qv[c], dka[r][c]);
          }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < G::RK; ++r) {
    const int kr = ty + 16 * r;
    if (k0 + kr >= Sk) continue;
#pragma unroll
    for (int c = 0; c < G::RD; ++c) {
      const size_t at = (krow0 + k0 + kr) * D + tx + 16 * c;
      store1(dk + at, dka[r][c]);
      store1(dv + at, dva[r][c]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const void* lse,
                   const void* lengths, void* delta, void* dq, void* dk,
                   void* dv, int B, int H, int KH, int Sq, int Sk, int mode,
                   int window, int q_offset, float scale,
                   cudaStream_t stream) {
  using G = Tile<D>;
  auto dq_kernel = flash_bwd_dq_kernel<T, D>;
  auto dkdv_kernel = flash_bwd_dkdv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)G::kDqSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkdv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)G::kDkdvSmem);
  if (err != cudaSuccess) return err;
  // dQ and delta first: the dK/dV pass reads delta
  dq_kernel<<<dim3((Sq + G::BQ - 1) / G::BQ, H, B), kThreads, G::kDqSmem,
              stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(out),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const int*>(lengths), static_cast<float*>(delta),
      static_cast<T*>(dq), H, KH, Sq, Sk, mode, window, q_offset, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<dim3((Sk + G::BK - 1) / G::BK, KH, B), kThreads,
                G::kDkdvSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(lengths), static_cast<T*>(dk),
      static_cast<T*>(dv), H, KH, Sq, Sk, mode, window, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const void* out, const void* dout, const void* lse,
                     const void* lengths, void* delta, void* dq, void* dk,
                     void* dv, int B, int H, int KH, int Sq, int Sk, int mode,
                     int window, int q_offset, float scale, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, dout, lse, lengths, delta,
                                  dq, dk, dv, B, H, KH, Sq, Sk, mode, window,
                                  q_offset, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, dout, lse, lengths, delta,
                                  dq, dk, dv, B, H, KH, Sq, Sk, mode, window,
                                  q_offset, scale, s);
    case 96: return launch<T, 96>(q, k, v, out, dout, lse, lengths, delta,
                                  dq, dk, dv, B, H, KH, Sq, Sk, mode, window,
                                  q_offset, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, dout, lse, lengths, delta,
                                    dq, dk, dv, B, H, KH, Sq, Sk, mode,
                                    window, q_offset, scale, s);
    case 256: return launch<T, 256>(q, k, v, out, dout, lse, lengths, delta,
                                    dq, dk, dv, B, H, KH, Sq, Sk, mode,
                                    window, q_offset, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The tensor-core pair (bfloat16, head dims 64, 128 and 256)
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 384;      // producer warpgroup + 2 consumers
constexpr int kBwdRows = 128;         // the scratch's rows: Sq rounded up
constexpr int kProducerRegs = 24;     // setmaxnreg: 128 * 24 + 256 * 240
constexpr int kConsumerRegs = 240;    //   fits the SM's 65,536 registers
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmemLimit = 232448;    // a block's 227 KB
// the D 256 dK/dV kernel's named barriers between its two warpgroups:
// P^T slot s written (kPFull + s) and read (kPFree + s); 0 is
// __syncthreads'
constexpr int kPFull = 1, kPFree = 3;

// The pair's tile constants (the variant tool sets these two lines).
// kStep, the rows of a streamed tile of both kernels at D 64 and 128 and
// of the dK/dV kernel at D 256: at D 128 a thread's dK and dV (or dQ)
// leave room for 64-column S and dP accumulators, at D 64 for 128-column
// ones; kStages, the ring's depth at D 64 and 128.  Measured on the card
// against 64 rows at D 64 and 2 or 4 stages (PERF.md): 3 stages of these
// ran fastest, and at D 64 ptxas spilled the dK/dV kernel's registers at
// 2 and 4.
template <int D>
struct BwdTile {
  static_assert(D == 64 || D == 128 || D == 256,
                "the tensor-core backward's head dims");
  static constexpr int kStep = D == 64 ? 128 : 64;
  static constexpr int kStages = 3;
};

// the most ring stages, up to 3, of `stage` bytes each that fit a block
// beside `fixed` bytes, the mbarriers and the 1 KB of alignment
constexpr int ring_stages(int fixed, int stage) {
  return (kSmemLimit - 1024 - 64 - fixed) / stage < 3
             ? (kSmemLimit - 1024 - 64 - fixed) / stage : 3;
}

// The dQ kernel's shared memory: its own Q and dO tiles (kRows rows), the
// ring of streamed K and V tiles (kStep keys), then the mbarriers.  Every
// tile is D / 64 boxes of 64 columns (128-byte rows under the 128-byte
// swizzle), box c at c * rows * 128.  Two consumer warpgroups own 64 rows
// each; at D 256 they stream 32-key tiles, so that 128 rows and 3 stages
// fit 227 KB.  One warpgroup of 64 rows against 64-key tiles (2 stages)
// ran 6% slower on the card (PERF.md: dQ 0.399 against 0.360 ms at
// recurrentgemma-9b's shape): here a K and V tile serves 128 rows, and one
// warpgroup's products overlap the other's softmax.
template <int D>
struct DqTile {
  static constexpr int kRows = 128;
  static constexpr int kStep = D == 256 ? 32 : BwdTile<D>::kStep;
  static constexpr int kOwnBytes = kRows * D * 2;
  static constexpr int kStepBytes = kStep * D * 2;
  static constexpr int kRingOffset = 2 * kOwnBytes;
  static constexpr int kStages =
      D == 256 ? ring_stages(kRingOffset, 2 * kStepBytes)
               : BwdTile<D>::kStages;
  static constexpr int kBarOffset = kRingOffset + kStages * 2 * kStepBytes;
  // own_full, then full[kStages], empty[kStages]; + 1 KB to align
  static constexpr size_t kSmemBytes = kBarOffset + 8 * (1 + 2 * kStages)
                                       + 1024;
  static_assert(kStages >= 2 && kSmemBytes <= kSmemLimit,
                "past a block's 227 KB");
};

// The dK/dV kernel's: its own K and V tiles (kRows keys), the ring of
// streamed Q and dO tiles (kStep rows), the ring of lse2 and delta vectors
// (kStep floats each a stage), at D 256 the two slots of P^T that its
// warpgroups exchange (kHalves), then the mbarriers.  At D 64 and 128 each
// consumer warpgroup owns 64 of the block's 128 keys at all D columns; at
// D 256 (kHalves) both own the block's 64 keys, warpgroup 0 their dV and
// warpgroup 1 their dK (64 x 256 float32 accumulators = 128 registers a
// thread either way).
template <int D>
struct DkdvTile {
  static constexpr bool kHalves = D == 256;
  static constexpr int kRows = kHalves ? 64 : 128;
  static constexpr int kStep = BwdTile<D>::kStep;
  static constexpr int kOwnBytes = kRows * D * 2;
  static constexpr int kStepBytes = kStep * D * 2;
  static constexpr int kVecBytes = 2 * kStep * 4;          // lse2, delta
  static constexpr int kSlotFloats = 64 * kStep;           // a P^T slot
  static constexpr int kXBytes = kHalves ? 2 * kSlotFloats * 4 : 0;
  static constexpr int kRingOffset = 2 * kOwnBytes;
  static constexpr int kStages =
      kHalves ? ring_stages(kRingOffset + kXBytes, 2 * kStepBytes + kVecBytes)
              : BwdTile<D>::kStages;
  static constexpr int kVecOffset = kRingOffset + kStages * 2 * kStepBytes;
  static constexpr int kXOffset = kVecOffset + kStages * kVecBytes;
  static constexpr int kBarOffset = kXOffset + kXBytes;
  static constexpr size_t kSmemBytes = kBarOffset + 8 * (1 + 2 * kStages)
                                       + 1024;
  static_assert(kBwdRows % kStep == 0, "streamed tiles cover the rows");
  static_assert(kStages >= 2 && kSmemBytes <= kSmemLimit,
                "past a block's 227 KB");
};

// every (q, k) pair with q in [qa, qb] and k in [k0, k0 + bk) visible: the
// tile needs no mask (the forward's rule; rows past Sq get p = 0 from their
// lse2 of +inf instead)
__device__ __forceinline__ bool tile_unmasked(int mode, int qa, int qb,
                                              int k0, int bk, int len,
                                              int window, int q_offset,
                                              int sk) {
  if (k0 + bk > sk) return false;
  if (mode == kCausal)
    return k0 + bk - 1 <= qa + q_offset &&
           (window <= 0 || k0 > qb + q_offset - window);
  if (mode == kLength)
    return k0 + bk <= len && (window <= 0 || k0 >= len - window);
  return true;
}

// no pair with q in [qa, qb] (< sq) and k in [ka, kb] (< sk) visible: the
// warpgroup skips the tile (it still waits for it and releases it)
__device__ __forceinline__ bool tile_empty(int mode, int qa, int qb, int ka,
                                           int kb, int len, int window,
                                           int q_offset, int sq, int sk) {
  if (qa >= sq || ka >= sk) return true;
  qb = min(qb, sq - 1);
  kb = min(kb, sk - 1);
  if (mode == kCausal)
    return ka > qb + q_offset ||
           (window > 0 && kb <= qa + q_offset - window);
  if (mode == kLength)
    return ka >= len || (window > 0 && kb < len - window);
  return false;
}

// descriptor of the 16 columns at k-step kk of a K-major operand: rows of
// 128 bytes, 8-row groups 1,024 bytes apart; `row0` rows into a tile of
// `rows` rows at `tile`
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int row0,
                                           int kk) {
  return smem_desc(tile + (kk / 4) * rows * 128 + row0 * 128 + (kk % 4) * 32,
                   16, 1024, 128);
}

// descriptor of the 16 rows at k-step kk of an MN-major B operand (the
// product runs over the tile's rows, N over its D columns): box to box
// (LBO) rows * 128 bytes, 8-row groups (SBO) 1,024 bytes apart
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows, int kk) {
  return smem_desc(tile + kk * 16 * 128, rows * 128, 1024, 128);
}

// the m64nN accumulator's element j lies at row 8 * ((j % 4) / 2) (+ the
// thread's row) and column 8 * (j / 4) + 2 * (lane % 4) + (j % 2); each
// k-step fragment of a bf16 A operand comes from 8 of them
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4],
                                       const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// one 64-row tile's rows of a (rows, D) bf16 result, from an m64nD
// accumulator times `scale`; rows at or past n_rows dropped
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, int row,
                                           int n_rows, int col,
                                           const float (&acc)[D / 2],
                                           float scale) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int at = row + 8 * r;
    if (at >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + (size_t)at * D + 8 * j + col) =
          pack_bf16(acc[4 * j + 2 * r] * scale,
                    acc[4 * j + 2 * r + 1] * scale);
  }
}

// the same rows as float32 (a partial sum for flash_bwd_sum_kernel)
template <int D>
__device__ __forceinline__ void store_rows_f32(float* dst, int row,
                                               int n_rows, int col,
                                               const float (&acc)[D / 2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int at = row + 8 * r;
    if (at >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + (size_t)at * D + 8 * j + col) =
          make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    acc = fmaf(u.x, w.x, acc);
    acc = fmaf(u.y, w.y, acc);
  }
  return acc;
}

// dQ (and the vectors the dK/dV kernel reads): one block per (kRows query
// rows, h, b), heaviest (last) rows first; each consumer warpgroup owns 64
// rows.  vec holds lse2 = lse log2 e (+inf for a row that sees no key or
// lies past Sq) at [b H + h][row] and delta = rowsum(dO O) at [B H + b H +
// h][row], sq_pad rows a head.
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __nv_bfloat16* __restrict__ out,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const int* __restrict__ lengths,
                          float* __restrict__ vec,
                          __nv_bfloat16* __restrict__ dq, int B, int H,
                          int KH, int Sq, int Sk, int sq_pad, int mode,
                          int window, int q_offset, float scale,
                          float scale_log2) {
  using G = DqTile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_do = s_q + G::kOwnBytes;
  const uint32_t s_ring = s_q + G::kRingOffset;   // stage st: K, then V
  const uint32_t own_full = s_q + G::kBarOffset;
  const uint32_t full = own_full + 8;
  const uint32_t empty = full + 8 * G::kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * G::kRows;
  const int bh = b * H + h;
  const int len = lengths[b];
  int k_lo, k_hi;
  key_range(mode, q0, min(q0 + G::kRows, Sq) - 1, len, window, q_offset, Sk,
            &k_lo, &k_hi);
  const int t0 = (k_lo / G::kStep) * G::kStep;
  const int n_tiles =
      k_hi > t0 ? (k_hi - t0 + G::kStep - 1) / G::kStep : 0;

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int st = 0; st < G::kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0 && n_tiles > 0) {
      const int kvm = b * KH + h / (H / KH);
      mbar_expect_tx(own_full, 2 * G::kOwnBytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load3(s_q + c * G::kRows * 128, &tq, own_full, 64 * c, q0, bh);
        tma_load3(s_do + c * G::kRows * 128, &tdo, own_full, 64 * c, q0, bh);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % G::kStages;
        mbar_wait(empty + 8 * st, ((i / G::kStages) & 1) ^ 1);
        const uint32_t k_st = s_ring + st * 2 * G::kStepBytes;
        const int k0 = t0 + i * G::kStep;
        mbar_expect_tx(full + 8 * st, 2 * G::kStepBytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load3(k_st + c * G::kStep * 128, &tk, full + 8 * st, 64 * c,
                    k0, kvm);
          tma_load3(k_st + G::kStepBytes + c * G::kStep * 128, &tv,
                    full + 8 * st, 64 * c, k0, kvm);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int ct = threadIdx.x - 128;
    const int g = ct / 128, warp = (ct % 128) / 32, lane = ct % 32;
    const int qa = q0 + 64 * g;                  // this warpgroup's rows
    const int row = qa + 16 * warp + lane / 4;   // and row + 8
    const int col = 2 * (lane % 4);

    // delta and lse2 of the thread's two rows: a quad sums a row's D
    // columns, 8 at a time
    float dl[2], l2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row + 8 * r;
      float acc = 0.f;
      if (qi < Sq) {
        const size_t at = ((size_t)bh * Sq + qi) * D;
#pragma unroll
        for (int c = 8 * (lane % 4); c < D; c += 32)
          acc += dot8(*reinterpret_cast<const uint4*>(dout + at + c),
                      *reinterpret_cast<const uint4*>(out + at + c));
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      const float x = qi < Sq ? lse[(size_t)bh * Sq + qi] : kNegInf;
      dl[r] = acc;
      l2[r] = x <= kNegInf ? INFINITY : x * kLog2e;
      if (lane % 4 == 0) {
        vec[(size_t)bh * sq_pad + qi] = l2[r];
        vec[((size_t)B * H + bh) * sq_pad + qi] = acc;
      }
    }

    float dqa[D / 2];
    zero(dqa);
    if (n_tiles > 0) mbar_wait(own_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % G::kStages;
      const int k0 = t0 + i * G::kStep;
      const uint32_t k_st = s_ring + st * 2 * G::kStepBytes;
      const uint32_t v_st = k_st + G::kStepBytes;
      mbar_wait(full + 8 * st, (i / G::kStages) & 1);
      if (!tile_empty(mode, qa, qa + 63, k0, k0 + G::kStep - 1, len,
                      window, q_offset, Sq, Sk)) {
        // S = Q K^T and dP = dO V^T, K-major from shared memory
        float s[G::kStep / 2], dp[G::kStep / 2];
        zero(s);
        zero(dp);
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<G::kStep>::ss(s, kmajor(s_q, G::kRows, 64 * g, kk),
                              kmajor(k_st, G::kStep, 0, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<G::kStep>::ss(dp, kmajor(s_do, G::kRows, 64 * g, kk),
                              kmajor(v_st, G::kStep, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
        // P = exp2(S scale log2 e - lse2), the forward's scale at its place
        const bool masked = !tile_unmasked(mode, qa, qa + 63, k0,
                                           G::kStep, len, window, q_offset,
                                           Sk);
#pragma unroll
        for (int j = 0; j < G::kStep / 2; ++j) {
          const int r = (j % 4) / 2;
          const float x = s[j] * scale_log2;
          s[j] = masked && !visible(mode, row + 8 * r,
                                    k0 + 8 * (j / 4) + col + (j % 2), len,
                                    window, q_offset, Sq, Sk)
                     ? 0.f : exp2f(x - l2[r]);
        }
        wgmma_wait<0>();
        fence_regs(dp);
        // dS = P (dP - delta), as bf16 A fragments
#pragma unroll
        for (int j = 0; j < G::kStep / 2; ++j)
          dp[j] = s[j] * (dp[j] - dl[(j % 4) / 2]);
        uint32_t ds[G::kStep / 16][4];
        pack_a<G::kStep>(ds, dp);
        // dQ += dS K, K read MN-major
        fence_regs(dqa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < G::kStep / 16; ++kk)
          Wgmma<D>::rs(dqa, ds[kk], mnmajor(k_st, G::kStep, kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dqa);
      }
      mbar_arrive(empty + 8 * st);
    }
    store_rows<D>(dq + (size_t)bh * Sq * D, row, Sq, col, dqa, scale);
  }
}

// dK and dV: one block per (kRows keys, KV head, b, slice of the group's
// query heads: `split` slices of H / KH / split heads, the slice fastest),
// walking each query head of its slice and every kStep-row query tile that
// sees a key of the block, in that order.  At D 64 and 128 (split 1) each
// consumer warpgroup holds 64 keys' dK and dV in registers.  At D 256 both
// warpgroups take the block's 64 keys: warpgroup 0 computes S^T = K Q^T,
// P^T and dV += P^T dO; warpgroup 1 dP^T = V dO^T, dS^T = P^T (dP^T -
// delta) and dK += dS^T Q, reading P^T in float32 from the slot that
// warpgroup 0 wrote (two slots, named barriers kPFull / kPFree); with
// split > 1 each writes its float32 sum to part (dK's, then dV's: [2]
// [split][B KH][Sk][D]) for flash_bwd_sum_kernel.
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tdo,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const float* __restrict__ vec,
                            const int* __restrict__ lengths,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv,
                            float* __restrict__ part, int B, int H,
                            int KH, int Sq, int Sk, int sq_pad, int mode,
                            int window, int q_offset, int split,
                            float scale, float scale_log2) {
  using G = DkdvTile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_k = smem_u32(smem);
  const uint32_t s_v = s_k + G::kOwnBytes;
  const uint32_t s_ring = s_k + G::kRingOffset;   // stage st: Q, then dO
  const uint32_t s_vec = s_k + G::kVecOffset;     // stage st: lse2, delta
  const float* vec_s = reinterpret_cast<const float*>(smem + G::kVecOffset);
  const uint32_t own_full = s_k + G::kBarOffset;
  const uint32_t full = own_full + 8;
  const uint32_t empty = full + 8 * G::kStages;

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = (blockIdx.z / split) * G::kRows;  // causal: heaviest first
  const int slice = blockIdx.z % split;
  const int group = H / KH, heads = group / split;
  const int h0 = kvh * group + slice * heads;      // the slice's first head
  const int len = lengths[b];
  int q_lo, q_hi;
  query_range(mode, k0, min(k0 + G::kRows, Sk) - 1, len, window, q_offset,
              Sq, &q_lo, &q_hi);
  const int t0 = (q_lo / G::kStep) * G::kStep;
  const int n_q = q_hi > t0 ? (q_hi - t0 + G::kStep - 1) / G::kStep : 0;
  const int n_tiles = heads * n_q;

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int st = 0; st < G::kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0 && n_tiles > 0) {
      const int kvm = b * KH + kvh;
      mbar_expect_tx(own_full, 2 * G::kOwnBytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load3(s_k + c * G::kRows * 128, &tk, own_full, 64 * c, k0, kvm);
        tma_load3(s_v + c * G::kRows * 128, &tv, own_full, 64 * c, k0, kvm);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % G::kStages;
        const int bh = b * H + h0 + i / n_q;
        const int q0 = t0 + (i % n_q) * G::kStep;
        mbar_wait(empty + 8 * st, ((i / G::kStages) & 1) ^ 1);
        const uint32_t q_st = s_ring + st * 2 * G::kStepBytes;
        const uint32_t v_st = s_vec + st * G::kVecBytes;
        mbar_expect_tx(full + 8 * st, 2 * G::kStepBytes + G::kVecBytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load3(q_st + c * G::kStep * 128, &tq, full + 8 * st, 64 * c,
                    q0, bh);
          tma_load3(q_st + G::kStepBytes + c * G::kStep * 128, &tdo,
                    full + 8 * st, 64 * c, q0, bh);
        }
        bulk_load(v_st, vec + (size_t)bh * sq_pad + q0, G::kStep * 4,
                  full + 8 * st);
        bulk_load(v_st + G::kStep * 4,
                  vec + ((size_t)B * H + bh) * sq_pad + q0, G::kStep * 4,
                  full + 8 * st);
      }
    }
  } else if constexpr (G::kHalves) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int ct = threadIdx.x - 128;
    const int g = ct / 128, t = ct % 128, warp = t / 32, lane = ct % 32;
    const int row = k0 + 16 * warp + lane / 4;   // the thread's keys: row
    const int col = 2 * (lane % 4);              //   and row + 8
    float* slots = reinterpret_cast<float*>(smem + G::kXOffset);

    float acc[D / 2];                            // g 0: dV, g 1: dK
    zero(acc);
    if (n_tiles > 0) mbar_wait(own_full, 0);
    int done = 0;                                // tiles not skipped
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % G::kStages;
      const int q0 = t0 + (i % n_q) * G::kStep;
      const uint32_t q_st = s_ring + st * 2 * G::kStepBytes;
      const uint32_t do_st = q_st + G::kStepBytes;
      const float* lse2 = vec_s + st * (G::kVecBytes / 4);
      const float* delta = lse2 + G::kStep;
      mbar_wait(full + 8 * st, (i / G::kStages) & 1);
      // both warpgroups skip the same tiles: they hold the same keys
      if (!tile_empty(mode, q0, q0 + G::kStep - 1, k0, k0 + 63, len, window,
                      q_offset, Sq, Sk)) {
        const int slot = done & 1;
        float* x = slots + slot * G::kSlotFloats;
        // g 0: S^T = K Q^T; g 1: dP^T = V dO^T (keys are the rows)
        float s[G::kStep / 2];
        zero(s);
        fence_regs(s);
        wgmma_fence();
        const uint32_t a_own = g == 0 ? s_k : s_v;
        const uint32_t b_st = g == 0 ? q_st : do_st;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<G::kStep>::ss(s, kmajor(a_own, G::kRows, 0, kk),
                              kmajor(b_st, G::kStep, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        if (g == 0) {
          // P^T = exp2(S^T scale log2 e - lse2 of the column), to the slot
          const bool masked = !tile_unmasked(mode, q0, q0 + G::kStep - 1,
                                             k0, 64, len, window, q_offset,
                                             Sk);
#pragma unroll
          for (int j = 0; j < G::kStep / 2; ++j) {
            const int c = 8 * (j / 4) + col + (j % 2);
            const float y = s[j] * scale_log2;
            s[j] = masked && !visible(mode, q0 + c, row + 8 * ((j % 4) / 2),
                                      len, window, q_offset, Sq, Sk)
                       ? 0.f : exp2f(y - lse2[c]);
          }
          // warpgroup 1 has read what this slot held two tiles ago
          if (done >= 2) named_bar_sync(kPFree + slot, 256);
#pragma unroll
          for (int j = 0; j < G::kStep / 2; ++j) x[j * 128 + t] = s[j];
          named_bar_arrive(kPFull + slot, 256);
        } else {
          // dS^T = P^T (dP^T - delta of the column), P^T from the slot
          named_bar_sync(kPFull + slot, 256);
#pragma unroll
          for (int j = 0; j < G::kStep / 2; ++j)
            s[j] = x[j * 128 + t] *
                   (s[j] - delta[8 * (j / 4) + col + (j % 2)]);
          named_bar_arrive(kPFree + slot, 256);
        }
        // g 0: dV += P^T dO; g 1: dK += dS^T Q (dO and Q read MN-major)
        uint32_t a[G::kStep / 16][4];
        pack_a<G::kStep>(a, s);
        const uint32_t b_mn = g == 0 ? do_st : q_st;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < G::kStep / 16; ++kk)
          Wgmma<D>::rs(acc, a[kk], mnmajor(b_mn, G::kStep, kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        ++done;
      }
      mbar_arrive(empty + 8 * st);
    }
    // take warpgroup 1's last two reads off their barriers, so none is
    // left part-way at exit
    if (g == 0)
      for (int d = max(done - 2, 0); d < done; ++d)
        named_bar_sync(kPFree + (d & 1), 256);
    const size_t base = (size_t)(b * KH + kvh) * Sk * D;
    if (split == 1) {
      store_rows<D>((g == 0 ? dv : dk) + base, row, Sk, col, acc,
                    g == 0 ? 1.f : scale);
    } else {
      const size_t n = (size_t)B * KH * Sk * D;
      store_rows_f32<D>(part + ((size_t)(1 - g) * split + slice) * n + base,
                        row, Sk, col, acc);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int ct = threadIdx.x - 128;
    const int g = ct / 128, warp = (ct % 128) / 32, lane = ct % 32;
    const int ka = k0 + 64 * g;                  // this warpgroup's keys
    const int row = ka + 16 * warp + lane / 4;   // and row + 8
    const int col = 2 * (lane % 4);

    float dka[D / 2], dva[D / 2];
    zero(dka);
    zero(dva);
    if (n_tiles > 0) mbar_wait(own_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % G::kStages;
      const int q0 = t0 + (i % n_q) * G::kStep;
      const uint32_t q_st = s_ring + st * 2 * G::kStepBytes;
      const uint32_t do_st = q_st + G::kStepBytes;
      const float* lse2 = vec_s + st * (G::kVecBytes / 4);
      const float* delta = lse2 + G::kStep;
      mbar_wait(full + 8 * st, (i / G::kStages) & 1);
      if (!tile_empty(mode, q0, q0 + G::kStep - 1, ka, ka + 63, len, window,
                      q_offset, Sq, Sk)) {
        // S^T = K Q^T and dP^T = V dO^T: keys are the rows
        float s[G::kStep / 2], dp[G::kStep / 2];
        zero(s);
        zero(dp);
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<G::kStep>::ss(s, kmajor(s_k, G::kRows, 64 * g, kk),
                              kmajor(q_st, G::kStep, 0, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<G::kStep>::ss(dp, kmajor(s_v, G::kRows, 64 * g, kk),
                              kmajor(do_st, G::kStep, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
        // P^T = exp2(S^T scale log2 e - lse2 of the column)
        const bool masked = !tile_unmasked(mode, q0, q0 + G::kStep - 1, ka,
                                           64, len, window, q_offset, Sk);
#pragma unroll
        for (int j = 0; j < G::kStep / 2; ++j) {
          const int c = 8 * (j / 4) + col + (j % 2);
          const float x = s[j] * scale_log2;
          s[j] = masked && !visible(mode, q0 + c, row + 8 * ((j % 4) / 2),
                                    len, window, q_offset, Sq, Sk)
                     ? 0.f : exp2f(x - lse2[c]);
        }
        wgmma_wait<0>();
        fence_regs(dp);
        // dS^T = P^T (dP^T - delta of the column)
#pragma unroll
        for (int j = 0; j < G::kStep / 2; ++j)
          dp[j] = s[j] * (dp[j] - delta[8 * (j / 4) + col + (j % 2)]);
        uint32_t pt[G::kStep / 16][4], dst[G::kStep / 16][4];
        pack_a<G::kStep>(pt, s);
        pack_a<G::kStep>(dst, dp);
        // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major
        fence_regs(dva);
        fence_regs(dka);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < G::kStep / 16; ++kk)
          Wgmma<D>::rs(dva, pt[kk], mnmajor(do_st, G::kStep, kk));
#pragma unroll
        for (int kk = 0; kk < G::kStep / 16; ++kk)
          Wgmma<D>::rs(dka, dst[kk], mnmajor(q_st, G::kStep, kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dva);
        fence_regs(dka);
      }
      mbar_arrive(empty + 8 * st);
    }
    const size_t base = (size_t)(b * KH + kvh) * Sk * D;
    store_rows<D>(dk + base, row, Sk, col, dka, scale);
    store_rows<D>(dv + base, row, Sk, col, dva, 1.f);
  }
}

// dK and dV from the D 256 dK/dV kernel's float32 partials ([2][split][n],
// dK's then dV's), each element summed over the split in slice order and
// rounded once (dK times `scale`): n / 4 groups of 4 elements, a thread a
// group at a time.
__global__ void __launch_bounds__(256)
flash_bwd_sum_kernel(const float* __restrict__ part,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, size_t n, int split,
                     float scale) {
  for (size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
       i < n; i += (size_t)gridDim.x * blockDim.x * 4) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
    for (int s = 0; s < split; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(part + s * n + i);
      const float4 y =
          *reinterpret_cast<const float4*>(part + (split + s) * n + i);
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      c.x += y.x; c.y += y.y; c.z += y.z; c.w += y.w;
    }
    *reinterpret_cast<uint2*>(dk + i) =
        make_uint2(pack_bf16(a.x * scale, a.y * scale),
                   pack_bf16(a.z * scale, a.w * scale));
    *reinterpret_cast<uint2*>(dv + i) =
        make_uint2(pack_bf16(c.x, c.y), pack_bf16(c.z, c.w));
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const void* out, const void* dout, const void* lse,
                         const void* lengths, void* vec, void* part,
                         void* dq, void* dk, void* dv, int B, int H, int KH,
                         int Sq, int Sk, int mode, int window, int q_offset,
                         int split, float scale, cudaStream_t stream) {
  using Q = DqTile<D>;
  using K = DkdvTile<D>;
  // the head split: D 256 only, a divisor of the group, partials for > 1
  if (split < 1 || (H / KH) % split != 0 ||
      (split > 1 && (!K::kHalves || part == nullptr)))
    return cudaErrorInvalidValue;
  const int sq_pad = (Sq + kBwdRows - 1) / kBwdRows * kBwdRows;
  // the dQ kernel's maps: Q and dO in boxes of its own rows, K and V in
  // its streamed ones; the dK/dV kernel's the other way round
  CUtensorMap tq_own, tdo_own, tk_step, tv_step, tq_step, tdo_step, tk_own,
      tv_own;
  if (!encode_map(&tq_own, q, D, Sq, B * H, Q::kRows, 64) ||
      !encode_map(&tdo_own, dout, D, Sq, B * H, Q::kRows, 64) ||
      !encode_map(&tk_step, k, D, Sk, B * KH, Q::kStep, 64) ||
      !encode_map(&tv_step, v, D, Sk, B * KH, Q::kStep, 64) ||
      !encode_map(&tq_step, q, D, Sq, B * H, K::kStep, 64) ||
      !encode_map(&tdo_step, dout, D, Sq, B * H, K::kStep, 64) ||
      !encode_map(&tk_own, k, D, Sk, B * KH, K::kRows, 64) ||
      !encode_map(&tv_own, v, D, Sk, B * KH, K::kRows, 64))
    return cudaErrorInvalidValue;
  auto dq_kernel = flash_bwd_dq_wgmma_kernel<D>;
  auto dkdv_kernel = flash_bwd_dkdv_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Q::kSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkdv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)K::kSmemBytes);
  if (err != cudaSuccess) return err;
  const float scale_log2 = scale * kLog2e;     // as the forward scales S
  // dQ and the vectors first: the dK/dV pass reads them
  dq_kernel<<<dim3(H, B, sq_pad / Q::kRows), kBwdThreads, Q::kSmemBytes,
              stream>>>(
      tq_own, tdo_own, tk_step, tv_step,
      static_cast<const __nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const int*>(lengths),
      static_cast<float*>(vec), static_cast<__nv_bfloat16*>(dq), B, H, KH,
      Sq, Sk, sq_pad, mode, window, q_offset, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<dim3(KH, B, (Sk + K::kRows - 1) / K::kRows * split),
                kBwdThreads, K::kSmemBytes, stream>>>(
      tq_step, tdo_step, tk_own, tv_own, static_cast<const float*>(vec),
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), static_cast<float*>(part), B, H, KH,
      Sq, Sk, sq_pad, mode, window, q_offset, split, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return err;
  const size_t n = (size_t)B * KH * Sk * D;
  const size_t blocks = (n / 4 + 255) / 256;
  flash_bwd_sum_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                         stream>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), n, split, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0 = float32, 1 = bfloat16, at D = 32, 64, 96, 128 or 256; Sq, Sk,
// B, H >= 1.  `delta` is a (B, H, Sq) float32 scratch.  Returns the
// launches' CUDA error code.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* out, const void* dout, const void* lse,
                        const void* lengths, void* delta, void* dq, void* dk,
                        void* dv, int dtype, int B, int H, int KH, int Sq,
                        int Sk, int D, int mode, int window, int q_offset,
                        float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KH <= 0 || H % KH != 0 || mode < kCausal || mode > kFull || B <= 0 ||
      Sq <= 0 || Sk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(launch_d<float>(
        D, q, k, v, out, dout, lse, lengths, delta, dq, dk, dv, B, H, KH, Sq,
        Sk, mode, window, q_offset, scale, s));
  if (dtype == 1)
    return static_cast<int>(launch_d<__nv_bfloat16>(
        D, q, k, v, out, dout, lse, lengths, delta, dq, dk, dv, B, H, KH, Sq,
        Sk, mode, window, q_offset, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core pair: bfloat16 q, k, v, out, dout (16-byte aligned) at D =
// 64, 128 or 256; Sq, Sk, B, H >= 1.  `vec` is a float32 scratch of 2 x B x
// H x roundup(Sq, 128).  `split` slices each KV head's group of query heads
// over dK/dV blocks (D 256 only; it divides H / KH); with split > 1, `part`
// is a float32 scratch of 2 x split x B x KH x Sk x D (else unused).
// Returns the launches' CUDA error code.
int flash_attention_wgmma_bwd(const void* q, const void* k, const void* v,
                              const void* out, const void* dout,
                              const void* lse, const void* lengths,
                              void* vec, void* part, void* dq, void* dk,
                              void* dv, int B, int H, int KH, int Sq, int Sk,
                              int D, int mode, int window, int q_offset,
                              int split, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KH <= 0 || H % KH != 0 || mode < kCausal || mode > kFull || B <= 0 ||
      Sq <= 0 || Sk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64: return static_cast<int>(launch_wgmma<64>(
        q, k, v, out, dout, lse, lengths, vec, part, dq, dk, dv, B, H, KH,
        Sq, Sk, mode, window, q_offset, split, scale, s));
    case 128: return static_cast<int>(launch_wgmma<128>(
        q, k, v, out, dout, lse, lengths, vec, part, dq, dk, dv, B, H, KH,
        Sq, Sk, mode, window, q_offset, split, scale, s));
    case 256: return static_cast<int>(launch_wgmma<256>(
        q, k, v, out, dout, lse, lengths, vec, part, dq, dk, dv, B, H, KH,
        Sq, Sk, mode, window, q_offset, split, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the tensor-core pair's dynamic shared memory a block at head dim D, of
// the dQ kernel (which 0) or the dK/dV kernel (1); 0 for a head dim it
// does not take
int flash_attention_wgmma_bwd_smem(int D, int which) {
  switch (D) {
    case 64: return static_cast<int>(which ? DkdvTile<64>::kSmemBytes
                                           : DqTile<64>::kSmemBytes);
    case 128: return static_cast<int>(which ? DkdvTile<128>::kSmemBytes
                                            : DqTile<128>::kSmemBytes);
    case 256: return static_cast<int>(which ? DkdvTile<256>::kSmemBytes
                                            : DqTile<256>::kSmemBytes);
    default: return 0;
  }
}

// the keys a tensor-core dK/dV block owns at head dim D (ops.BWD_KEYS_256
// copies the D 256 value to count the split's blocks); 0 for a head dim it
// does not take
int flash_attention_wgmma_bwd_keys(int D) {
  switch (D) {
    case 64: return DkdvTile<64>::kRows;
    case 128: return DkdvTile<128>::kRows;
    case 256: return DkdvTile<256>::kRows;
    default: return 0;
  }
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
