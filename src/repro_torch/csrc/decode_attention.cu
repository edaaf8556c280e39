// Flash-decode partial for Hopper (sm_90a): one query token per (b, h)
// against one shard of a KV cache.
//
// Replaces the JAX package's TPU kernel
// src/repro/kernels/decode_attention/kernel.py (_decode_kernel /
// decode_partial_pallas).  q (B, H, 1, D), k/v (B, KH, S, D), float32 or
// bfloat16, contiguous; lengths (B,) int32 are GLOBAL cache lengths and the
// shard's row j holds global position j + kpos_offset.  Position p is
// visible iff p < lengths[b] and, with window > 0, p >= lengths[b] - window.
// Outputs, float32: acc (B, H, 1, D) = sum_p exp(s_p - m) v_p, m (B, H, 1, 1)
// = max_p s_p, l (B, H, 1, 1) = sum_p exp(s_p - m), with s_p = (q * scale) .
// k_p — the un-normalised partial that merges across shards.  A row with no
// visible position (an idle serving slot, lengths[b] == 0) gives acc = 0,
// l = 0, m = -1e30.
//
// Design: one thread block (8 warps) per (kv head, chunk of up to GC of its
// G = H / KH query heads, b), so a KV head's rows are read once for GC query
// heads (GC is 4, 2 or 1, the largest not above G; qwen3's G = 2 is served
// by one block per kv head).  The block streams only the
// visible rows [max(0, len - window) - kpos_offset, len - kpos_offset) of
// its shard, clipped to [0, S): the TPU kernel's block skip, as a loop
// range.  Each warp takes chunks of KPW consecutive rows; a lane holds D/32
// elements of a row (one 8- or 16-byte load for D = 128), dots them with
// its slice of each query head, and the warp's butterfly sum gives every
// lane the scores.  Each warp keeps its own online-softmax state (m, l and
// its lanes' slice of acc) in registers, with no block barrier in the
// stream; at the end the 8 warps' partials merge through shared memory by
// the same flash-decoding identity that merges shards.
//
// Bound: bytes — the visible K and V rows, q and the outputs, over the
// card's memory bandwidth (3.35 TB/s on an H100 SXM); the arithmetic is two
// FMAs per byte of bf16 cache.  With B * KH blocks (128 at B 16, KH 8) each
// SM streams one (b, kv head) cache with a few loads in flight per lane, so
// a long, uneven length leaves SMs idle; splitting the sequence over blocks
// (a second combine pass) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

template <int N>
__device__ __forceinline__ void load_n(const float* p, float* o) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      o[i] = x.x;
      o[i + 1] = x.y;
      o[i + 2] = x.z;
      o[i + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x;
    o[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = p[i];
  }
}

template <int N>
__device__ __forceinline__ void load_n(const __nv_bfloat16* p, float* o) {
  if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 x =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + i));
      o[i] = x.x;
      o[i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = __bfloat162float(p[i]);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D, int GC>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              float* __restrict__ acc_out, float* __restrict__ m_out,
              float* __restrict__ l_out, int H, int KH, int S, int window,
              int kpos_offset, float scale) {
  constexpr int EPL = D / 32;                // row elements per lane
  constexpr int KPW = D == 256 ? 4 : 8;      // rows per warp per step
  __shared__ float m_w[kWarps][GC];
  __shared__ float l_w[kWarps][GC];
  __shared__ float acc_w[kWarps][GC][D];

  const int G = H / KH;
  const int chunks = (G + GC - 1) / GC;
  const int kvh = blockIdx.x / chunks, g0 = (blockIdx.x % chunks) * GC;
  const int gn = min(GC, G - g0);
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t h0 = (size_t)b * H + (size_t)kvh * G + g0;  // first (b, h)
  const T* kp = k + ((size_t)b * KH + kvh) * S * D + lane * EPL;
  const T* vp = v + ((size_t)b * KH + kvh) * S * D + lane * EPL;

  float qr[GC][EPL];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    float x[EPL];
    if (g < gn) {
      load_n<EPL>(q + (h0 + g) * D + lane * EPL, x);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[g][e] = x[e] * scale;
  }

  // this shard's visible rows [j_lo, j_hi)
  const int len = lengths[b];
  const int lo = window > 0 ? len - window : 0;
  const int j_lo = max(0, lo - kpos_offset);
  const int j_hi = min(S, len - kpos_offset);

  float m[GC], l[GC], acc[GC][EPL];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  for (int base = j_lo + warp * KPW; base < j_hi; base += kWarps * KPW) {
    float kr[KPW][EPL], vr[KPW][EPL];
#pragma unroll
    for (int i = 0; i < KPW; ++i) {
      if (base + i < j_hi) {
        load_n<EPL>(kp + (size_t)(base + i) * D, kr[i]);
        load_n<EPL>(vp + (size_t)(base + i) * D, vr[i]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kr[i][e] = vr[i][e] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float s[KPW];
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < KPW; ++i) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qr[g][e], kr[i][e], dot);
        dot = warp_sum(dot);
        s[i] = base + i < j_hi ? dot : kNegInf;
        mx = fmaxf(mx, s[i]);
      }
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int i = 0; i < KPW; ++i) {
        const float p = s[i] <= kNegInf ? 0.f : expf(s[i] - m_new);
        psum += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(p, vr[i][e], acc[g][e]);
      }
      l[g] = alpha * l[g] + psum;
      m[g] = m_new;
    }
  }

  // merge the warps' partials
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (lane == 0) {
      m_w[warp][g] = m[g];
      l_w[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc_w[warp][g][lane * EPL + e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < gn * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, m_w[w][g]);
    float a = 0.f, ll = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(m_w[w][g] - mm);
      a = fmaf(acc_w[w][g][d], f, a);
      ll = fmaf(l_w[w][g], f, ll);
    }
    acc_out[(h0 + g) * D + d] = a;
    if (d == 0) {
      m_out[h0 + g] = mm;
      l_out[h0 + g] = ll;
    }
  }
}

template <typename T, int D, int GC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* acc, void* m, void* l, int B,
                   int H, int KH, int S, int window, int kpos_offset,
                   float scale, cudaStream_t stream) {
  const int chunks = (H / KH + GC - 1) / GC;
  const dim3 grid(KH * chunks, B);
  decode_kernel<T, D, GC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), H, KH, S, window, kpos_offset, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_g(const void* q, const void* k, const void* v,
                     const void* lengths, void* acc, void* m, void* l, int B,
                     int H, int KH, int S, int window, int kpos_offset,
                     float scale, cudaStream_t s) {
  const int G = H / KH;
  if (G >= 4)
    return launch<T, D, 4>(q, k, v, lengths, acc, m, l, B, H, KH, S, window,
                           kpos_offset, scale, s);
  if (G >= 2)
    return launch<T, D, 2>(q, k, v, lengths, acc, m, l, B, H, KH, S, window,
                           kpos_offset, scale, s);
  return launch<T, D, 1>(q, k, v, lengths, acc, m, l, B, H, KH, S, window,
                         kpos_offset, scale, s);
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const void* lengths, void* acc, void* m, void* l, int B,
                     int H, int KH, int S, int window, int kpos_offset,
                     float scale, cudaStream_t s) {
  switch (D) {
    case 32: return launch_g<T, 32>(q, k, v, lengths, acc, m, l, B, H, KH, S,
                                    window, kpos_offset, scale, s);
    case 64: return launch_g<T, 64>(q, k, v, lengths, acc, m, l, B, H, KH, S,
                                    window, kpos_offset, scale, s);
    case 128: return launch_g<T, 128>(q, k, v, lengths, acc, m, l, B, H, KH,
                                      S, window, kpos_offset, scale, s);
    case 256: return launch_g<T, 256>(q, k, v, lengths, acc, m, l, B, H, KH,
                                      S, window, kpos_offset, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's CUDA error code.
int decode_partial(const void* q, const void* k, const void* v,
                   const void* lengths, void* acc, void* m, void* l,
                   int dtype, int B, int H, int KH, int S, int D, int window,
                   int kpos_offset, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KH <= 0 || H % KH != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(launch_d<float>(D, q, k, v, lengths, acc, m, l, B,
                                            H, KH, S, window, kpos_offset,
                                            scale, s));
  if (dtype == 1)
    return static_cast<int>(launch_d<__nv_bfloat16>(
        D, q, k, v, lengths, acc, m, l, B, H, KH, S, window, kpos_offset,
        scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
