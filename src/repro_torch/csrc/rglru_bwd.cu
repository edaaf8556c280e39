// RG-LRU backward (Griffin / RecurrentGemma) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package differentiates its plain chunked
// form (src/repro/kernels/rglru/ops.py::_chunked_jax) by autodiff.  It
// computes the gradients of h_t = a_t h_{t-1} + u_t (h_0 = 0; the forward
// in csrc/rglru.cu), as the plain version
// repro_torch/kernels/rglru/ref.py::rglru_backward_reference does, walking
// time in reverse:
//     g_T = dh_T + dh_last,   g_t = dh_t + a_{t+1} g_{t+1},
//     du_t = g_t,   da_t = g_t h_{t-1},
// from the forward's saved h (B, T, D) in a's type.  a, h, dh, da and du
// are float32 or bfloat16 (one type), dh_last (B, D) float32 or absent.
// Each multiply and add is float32 and rounded on its own (no fused
// multiply-add), as the plain version rounds them, so the two agree bit
// for bit.  One thread owns one (b, d): no atomics, a run repeats bit for
// bit.
//
// Bound: bytes -- a, h and dh read once, da and du written once: at the
// recurrentgemma-9b shape (4, 2,048, 4,096) float32 671 MB, 0.20 ms at the
// card's 3.35 TB/s.
//
// Design: grid (D / 64, B), a thread a channel, coalesced loads straight
// from device memory: each thread loads kUnroll steps of a, dh and h_{t-1}
// into registers, then walks them backward in time and stores da and du.
// A reversed TMA ring, as the forward's rglru_ring_kernel runs forward, is
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 16;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_bwd_kernel(const T* __restrict__ a, const T* __restrict__ h,
                 const T* __restrict__ dh, const float* __restrict__ dh_last,
                 T* __restrict__ da, T* __restrict__ du, int T_len, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const size_t base = static_cast<size_t>(b) * T_len * D + d;
  float carry =
      dh_last == nullptr ? 0.f : dh_last[static_cast<size_t>(b) * D + d];
  int t = T_len - 1;
  // whole blocks of kUnroll steps, t down to t - kUnroll + 1
  for (; t - kUnroll + 1 >= 0; t -= kUnroll) {
    float av[kUnroll], gv[kUnroll], hv[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int s = t - i;
      const size_t j = base + static_cast<size_t>(s) * D;
      av[i] = to_float(a[j]);
      gv[i] = to_float(dh[j]);
      hv[i] = s > 0 ? to_float(h[j - D]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const size_t j = base + static_cast<size_t>(t - i) * D;
      const float g = __fadd_rn(gv[i], carry);
      du[j] = from_float<T>(g);
      da[j] = from_float<T>(__fmul_rn(g, hv[i]));
      carry = __fmul_rn(av[i], g);
    }
  }
  for (; t >= 0; --t) {
    const size_t j = base + static_cast<size_t>(t) * D;
    const float g = __fadd_rn(to_float(dh[j]), carry);
    du[j] = from_float<T>(g);
    da[j] = from_float<T>(__fmul_rn(g, t > 0 ? to_float(h[j - D]) : 0.f));
    carry = __fmul_rn(to_float(a[j]), g);
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* h, const void* dh,
                   const void* dh_last, void* da, void* du, int B, int steps,
                   int D, cudaStream_t stream) {
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  rglru_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(h),
      static_cast<const T*>(dh), static_cast<const float*>(dh_last),
      static_cast<T*>(da), static_cast<T*>(du), steps, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of a, h, dh, da and du: 0 = float32, 1 = bfloat16.  dh_last
// ((B, D) float32) may be null.  Returns the launch's CUDA error code.
int rglru_backward(const void* a, const void* h, const void* dh,
                   const void* dh_last, void* da, void* du, int dtype, int B,
                   int T, int D, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || D <= 0 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(launch<float>(a, h, dh, dh_last, da, du, B, T, D,
                                          s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(a, h, dh, dh_last, da, du,
                                                  B, T, D, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
