// Flash-attention backward, for Hopper (sm_90a): dQ, dK and dV of the
// forward in flash_attention.cu, from its output O, the log-sum-exp `lse`
// it writes and the output gradient dO.
//
// Replaces no TPU kernel: the JAX package computes this backward in plain
// JAX (`_make_blocked_vjp`'s bwd, src/repro/kernels/flash_attention/
// ops.py:166, a lax.scan of einsums over KV blocks that saves (out, lse)
// and recomputes p per block).  The port needs it as a kernel because its
// forward is one, which autograd cannot see through.  q, O, dO (B, H, Sq,
// D), k/v (B, KH, Sk, D), float32 or bfloat16, contiguous; lse (B, H, Sq)
// float32; dq, dk, dv in their inputs' types.  The masks and the visible-key
// rule are the forward's (`visible`, `key_range`); the scale multiplies q
// before Q K^T, and dQ once more at the end.  A masked pair has p = 0, so a
// row that sees no key (output 0 in the forward) has no gradient.  Two
// kernels, launched in this order on one stream:
//
// flash_bwd_dq_kernel — one block (256 threads) per (BQ query rows, h, b):
// delta = rowsum(dO * O) (also written to a float32 scratch for the second
// kernel), then over the key tiles that hold a visible key for some row of
// the block: S = (q scale) K^T, P = exp(S - lse) on visible pairs, dP =
// dO V^T, dS = P (dP - delta), dQ += dS K (a RQ x RD register tile a
// thread); dQ * scale is written.
//
// flash_bwd_dkdv_kernel — one block per (BK keys, KV head, b): K and V
// staged once, then for every query head of the KV head's group (G = H /
// KH) and every query tile that sees one of the block's keys: S^T, P^T,
// dP^T = V dO^T and dS^T, then dV += P^T dO and dK += dS^T (q scale) in
// registers.  The group's sum stays inside one block, so nothing is added
// by atomics and every output element is summed in one fixed order: both
// kernels are deterministic, run to run.
//
// Both are CUDA-core float32 FMAs on tiles staged in shared memory as
// float32 (bfloat16 widened on the way in), with the forward's 16 x 16
// thread grid and its rows padded by one float.  Bound: operations — the
// backward's five products (S, dP, dV, dK, dQ), 10 B H Sq Sk D FLOPs times
// the visible fraction, against the float32 peak (67 TFLOP/s without the
// tensor cores); these kernels recompute S and dP in both passes (seven
// products) and read their operands from shared memory, so they run well
// below it.  The tensor cores are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
