// WKV6 recurrence (RWKV6 / Finch time-mix) for Hopper (sm_90a): one thread
// block per (batch row, head) walks the sequence.
//
// Replaces the JAX package's TPU kernel src/repro/kernels/rwkv6/kernel.py
// (_wkv6_kernel / wkv6_pallas).  It computes the recurrence the plain scan
// defines (repro_torch/kernels/rwkv6/ref.py::wkv6_reference), for one head
// with key dim N and value dim M = N:
//     o_t = r_t (S + diag(u) k_t^T v_t),   S <- diag(w_t) S + k_t^T v_t,
// S starting at zero; o (B, H, T, M) in r's type and the final S
// (B, H, N, M) in float32.  r, k, v are float32 or bfloat16 (one type), w
// and u float32; every product and sum is float32.  The TPU kernel uses the
// chunked matmul form, which divides k_t by the cumulative decay W_t of its
// 32-step chunk (clamped at 1e-30): for a decay below ~0.115 that ratio is
// out of float32's range and the result is wrong.  This kernel keeps the
// step-by-step form, which is exact for every decay in (0, 1).
//
// Design: N threads per block; thread m holds column m of S (N floats) in
// registers for the whole sequence.  Per chunk of kChunk steps the block
// stages r, k, w, v as float32 in shared memory (one coalesced row of N
// per step and array), and one warp per step sums r_n u_n k_n over n.
// Then per step each thread reads r, k, w of the step as shared-memory
// broadcasts and does two multiply-adds per state element:
//     o_t[m] = sum_n r_n S[n][m] + v_m sum_n r_n u_n k_n,
//     S[n][m] = w_n S[n][m] + k_n v_m,
// with four partial sums for the dot product to shorten its dependency
// chain.  Bound: at the prefill shape (B 4, H 64, T 2,048, N 64) the
// 4 N M operations per step and head at the card's float32 rate (67 TFLOP/s)
// and the bytes (r, k, v, o in bf16, w in float32) at 3.35 TB/s are about
// equal.  With B * H blocks of N threads (256 blocks of 2 warps there) each
// SM holds a few warps, so the kernel is latency-bound; a tensor-core
// chunked form with a range-safe chunk algebra is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;   // steps staged per pair of barriers

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int N>
__global__ void __launch_bounds__(N)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, T* __restrict__ o,
            float* __restrict__ s_out, int H, int T_len) {
  __shared__ __align__(16) float sr[kChunk][N];
  __shared__ __align__(16) float sk[kChunk][N];
  __shared__ __align__(16) float sw[kChunk][N];
  __shared__ float sv[kChunk][N];
  __shared__ float su[N];
  __shared__ float sruk[kChunk];

  const int m = threadIdx.x;
  const int bh = blockIdx.x;
  const int h = bh % H;
  const size_t base = static_cast<size_t>(bh) * T_len * N;
  su[m] = u[h * N + m];

  float s[N];
#pragma unroll
  for (int n = 0; n < N; ++n) s[n] = 0.f;

  for (int t0 = 0; t0 < T_len; t0 += kChunk) {
    const int len = min(kChunk, T_len - t0);
    __syncthreads();   // the last chunk's readers are done (and su is set)
    const size_t off = base + static_cast<size_t>(t0) * N + m;
    for (int tt = 0; tt < len; ++tt) {
      const size_t i = off + static_cast<size_t>(tt) * N;
      sr[tt][m] = to_float(r[i]);
      sk[tt][m] = to_float(k[i]);
      sv[tt][m] = to_float(v[i]);
      sw[tt][m] = w[i];
    }
    __syncthreads();
    // sum_n r_n u_n k_n of each step: one warp per step, lanes over n
    for (int tt = m / 32; tt < len; tt += N / 32) {
      float acc = 0.f;
#pragma unroll
      for (int n = m % 32; n < N; n += 32) acc += sr[tt][n] * su[n] * sk[tt][n];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (m % 32 == 0) sruk[tt] = acc;
    }
    __syncthreads();
    for (int tt = 0; tt < len; ++tt) {
      const float vm = sv[tt][m];
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int n = 0; n < N; n += 4) {
        const float4 rr = *reinterpret_cast<const float4*>(&sr[tt][n]);
        const float4 kk = *reinterpret_cast<const float4*>(&sk[tt][n]);
        const float4 ww = *reinterpret_cast<const float4*>(&sw[tt][n]);
        a0 += rr.x * s[n];
        a1 += rr.y * s[n + 1];
        a2 += rr.z * s[n + 2];
        a3 += rr.w * s[n + 3];
        s[n] = ww.x * s[n] + kk.x * vm;
        s[n + 1] = ww.y * s[n + 1] + kk.y * vm;
        s[n + 2] = ww.z * s[n + 2] + kk.z * vm;
        s[n + 3] = ww.w * s[n + 3] + kk.w * vm;
      }
      o[off + static_cast<size_t>(tt) * N] =
          from_float<T>((a0 + a1) + (a2 + a3) + vm * sruk[tt]);
    }
  }
  float* so = s_out + static_cast<size_t>(bh) * N * N + m;
#pragma unroll
  for (int n = 0; n < N; ++n) so[static_cast<size_t>(n) * N] = s[n];
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, void* o, void* s_out, int B, int H,
                   int steps, int N, cudaStream_t stream) {
  const dim3 grid(B * H);
  switch (N) {
    case 32:
      wkv6_kernel<T, 32><<<grid, 32, 0, stream>>>(
          static_cast<const T*>(r), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const float*>(w),
          static_cast<const float*>(u), static_cast<T*>(o),
          static_cast<float*>(s_out), H, steps);
      break;
    case 64:
      wkv6_kernel<T, 64><<<grid, 64, 0, stream>>>(
          static_cast<const T*>(r), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const float*>(w),
          static_cast<const float*>(u), static_cast<T*>(o),
          static_cast<float*>(s_out), H, steps);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of r, k, v and o: 0 = float32, 1 = bfloat16.  Returns the launch's
// CUDA error code.
int wkv6_forward(const void* r, const void* k, const void* v, const void* w,
                 const void* u, void* o, void* s_out, int dtype, int B, int H,
                 int T, int N, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || T < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(launch<float>(r, k, v, w, u, o, s_out, B, H, T, N,
                                          s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(r, k, v, w, u, o, s_out, B,
                                                  H, T, N, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
