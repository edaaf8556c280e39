// Blocked online-softmax attention, forward, for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel
// src/repro/kernels/flash_attention/kernel.py (_attn_kernel /
// flash_attention_pallas).  q (B, H, Sq, D), k/v (B, KH, Sk, D), float32 or
// bfloat16, contiguous; the output has q's shape and type.  GQA: query head
// h reads KV head h / (H / KH).  Masks, with q and k absolute row indices:
//   causal (mode 0): k <= q + q_offset, and k > q + q_offset - window if
//                    window > 0;
//   length (mode 1): k < lengths[b], and k >= lengths[b] - window if
//                    window > 0;
//   full   (mode 2): none;
// and k < Sk always (the tail tile).  Scores are (q * scale) . k in float32,
// softmax is online over KV tiles (running max m, sum l, accumulator acc in
// float32), and the output is acc / max(l, 1e-30) in q's type — what the
// TPU kernel computes.  A masked score gives p = 0 (the TPU kernel's
// exp(-1e30 - m) is 0 as well once a row has seen a visible key).
//
// Design: one thread block (256 threads) per (q-tile of BQ rows, h, b).  It
// stages its Q tile (pre-scaled, float32) in shared memory once, then walks
// only the KV tiles that hold a visible key for some row of the tile (the
// TPU kernel's block skip, as a loop range): each K/V tile is staged in
// shared memory as float32, the BQ x BK scores are computed by a 16 x 16
// thread grid (each thread a RQ x RK register tile), one warp per row does
// the online-softmax update, and each thread keeps a RQ x RD slice of the
// output accumulator in registers.  Rows are padded by one float so that
// the column-wise shared-memory reads do not conflict.
//
// Bound: at prefill shapes, operations — 4 * B * H * Sq * Sk * D times the
// visible fraction, against the card's bf16 tensor-core peak (989 TFLOP/s
// on an H100 SXM).  This first kernel does its products with CUDA-core
// float32 FMAs from shared memory (67 TFLOP/s peak, and bound in practice by
// shared-memory loads), so it sits well above that bound; wgmma tiles fed
// by TMA, with warp specialisation, are the later design.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
struct Tile {
  static constexpr int BQ = D == 256 ? 32 : 64;  // query rows per block
  static constexpr int BK = D == 256 ? 32 : 64;  // keys per KV tile
  static constexpr int RQ = BQ / 16;             // rows per thread
  static constexpr int RK = BK / 16;             // score columns per thread
  static constexpr int RD = D / 16;              // output columns per thread
  static constexpr int LD = D + 1;               // padded row, floats
  static constexpr int LS = BK + 1;
  static constexpr size_t kSmemBytes =
      sizeof(float) * (size_t)(BQ * LD + 2 * BK * LD + BQ * LS + 3 * BQ);
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

__device__ __forceinline__ bool visible(int mode, int qi, int kj, int len,
                                        int window, int q_offset, int sk) {
  if (kj >= sk) return false;
  if (mode == kCausal) {
    const int qp = qi + q_offset;
    return kj <= qp && (window <= 0 || kj > qp - window);
  }
  if (mode == kLength) return kj < len && (window <= 0 || kj >= len - window);
  return true;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ lengths,
                 T* __restrict__ out, int H, int KH, int Sq, int Sk, int mode,
                 int window, int q_offset, float scale) {
  using G = Tile<D>;
  extern __shared__ float smem[];
  float* qs = smem;                       // (BQ, LD)
  float* ks = qs + G::BQ * G::LD;         // (BK, LD)
  float* vs = ks + G::BK * G::LD;         // (BK, LD)
  float* ss = vs + G::BK * G::LD;         // (BQ, LS) scores, then p
  float* m_s = ss + G::BQ * G::LS;        // running max per row
  float* l_s = m_s + G::BQ;               // running sum per row
  float* a_s = l_s + G::BQ;               // this tile's rescale per row

  const int q0 = blockIdx.x * G::BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const T* qp = q + (size_t)(b * H + h) * Sq * D;
  const T* kp = k + (size_t)(b * KH + kvh) * Sk * D;
  const T* vp = v + (size_t)(b * KH + kvh) * Sk * D;
  T* op = out + (size_t)(b * H + h) * Sq * D;
  const int len = lengths[b];

  stage_rows<T, D, G::LD>(qs, qp, q0, G::BQ, Sq, scale);
  for (int r = tid; r < G::BQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  // keys visible to some row of this tile: [k_lo, k_hi)
  const int q_last = min(q0 + G::BQ, Sq) - 1;
  int k_lo = 0, k_hi = Sk;
  if (mode == kCausal) {
    k_hi = min(Sk, q_last + q_offset + 1);
    if (window > 0) k_lo = max(0, q0 + q_offset - window + 1);
  } else if (mode == kLength) {
    k_hi = min(Sk, len);
    if (window > 0) k_lo = max(0, len - window);
  }

  float acc[G::RQ][G::RD];
#pragma unroll
  for (int r = 0; r < G::RQ; ++r)
#pragma unroll
    for (int c = 0; c < G::RD; ++c) acc[r][c] = 0.f;

  for (int k0 = (k_lo / G::BK) * G::BK; k0 < k_hi; k0 += G::BK) {
    __syncthreads();  // the previous tile's K, V and p are consumed
    stage_rows<T, D, G::LD>(ks, kp, k0, G::BK, Sk, 1.f);
    stage_rows<T, D, G::LD>(vs, vp, k0, G::BK, Sk, 1.f);
    __syncthreads();

    float s[G::RQ][G::RK];
#pragma unroll
    for (int r = 0; r < G::RQ; ++r)
#pragma unroll
      for (int c = 0; c < G::RK; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[G::RQ], kv[G::RK];
#pragma unroll
      for (int r = 0; r < G::RQ; ++r) qv[r] = qs[(ty + 16 * r) * G::LD + d];
#pragma unroll
      for (int c = 0; c < G::RK; ++c) kv[c] = ks[(tx + 16 * c) * G::LD + d];
#pragma unroll
      for (int r = 0; r < G::RQ; ++r)
#pragma unroll
        for (int c = 0; c < G::RK; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }
#pragma unroll
    for (int r = 0; r < G::RQ; ++r)
#pragma unroll
      for (int c = 0; c < G::RK; ++c) {
        const int row = ty + 16 * r, col = tx + 16 * c;
        ss[row * G::LS + col] =
            visible(mode, q0 + row, k0 + col, len, window, q_offset, Sk)
                ? s[r][c] : kNegInf;
      }
    __syncthreads();

    // online softmax, one warp per row
    for (int row = warp; row < G::BQ; row += kWarps) {
      float* srow = ss + row * G::LS;
      float mx = kNegInf;
      for (int c = lane; c < G::BK; c += 32) mx = fmaxf(mx, srow[c]);
      mx = warp_max(mx);
      const float m_prev = m_s[row];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < G::BK; c += 32) {
        const float sv = srow[c];
        const float p = sv <= kNegInf ? 0.f : expf(sv - m_new);
        srow[c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[row] = alpha;
        l_s[row] = alpha * l_s[row] + sum;
        m_s[row] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < G::RQ; ++r) {
      const float alpha = a_s[ty + 16 * r];
#pragma unroll
      for (int c = 0; c < G::RD; ++c) acc[r][c] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < G::BK; ++j) {
      float pv[G::RQ], vv[G::RD];
#pragma unroll
      for (int r = 0; r < G::RQ; ++r) pv[r] = ss[(ty + 16 * r) * G::LS + j];
#pragma unroll
      for (int c = 0; c < G::RD; ++c) vv[c] = vs[j * G::LD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < G::RQ; ++r)
#pragma unroll
        for (int c = 0; c < G::RD; ++c)
          acc[r][c] = fmaf(pv[r], vv[c], acc[r][c]);
    }
  }
  __syncthreads();  // l_s is final (also when no tile was visible)

#pragma unroll
  for (int r = 0; r < G::RQ; ++r) {
    const int row = ty + 16 * r;
    if (q0 + row >= Sq) continue;
    const float l = fmaxf(l_s[row], 1e-30f);
#pragma unroll
    for (int c = 0; c < G::RD; ++c)
      store1(op + (size_t)(q0 + row) * D + tx + 16 * c, acc[r][c] / l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, int B, int H, int KH,
                   int Sq, int Sk, int mode, int window, int q_offset,
                   float scale, cudaStream_t stream) {
  using G = Tile<D>;
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)G::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + G::BQ - 1) / G::BQ, H, B);
  kernel<<<grid, kThreads, G::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(out), H, KH, Sq, Sk, mode, window, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const void* lengths, void* out, int B, int H, int KH,
                     int Sq, int Sk, int mode, int window, int q_offset,
                     float scale, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, lengths, out, B, H, KH, Sq, Sk,
                                  mode, window, q_offset, scale, s);
    case 64: return launch<T, 64>(q, k, v, lengths, out, B, H, KH, Sq, Sk,
                                  mode, window, q_offset, scale, s);
    case 128: return launch<T, 128>(q, k, v, lengths, out, B, H, KH, Sq, Sk,
                                    mode, window, q_offset, scale, s);
    case 256: return launch<T, 256>(q, k, v, lengths, out, B, H, KH, Sq, Sk,
                                    mode, window, q_offset, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's CUDA error code.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* lengths, void* out, int dtype, int B,
                        int H, int KH, int Sq, int Sk, int D, int mode,
                        int window, int q_offset, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KH <= 0 || H % KH != 0 || mode < kCausal || mode > kFull)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(launch_d<float>(D, q, k, v, lengths, out, B, H,
                                            KH, Sq, Sk, mode, window,
                                            q_offset, scale, s));
  if (dtype == 1)
    return static_cast<int>(launch_d<__nv_bfloat16>(
        D, q, k, v, lengths, out, B, H, KH, Sq, Sk, mode, window, q_offset,
        scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
