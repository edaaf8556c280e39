// RG-LRU recurrence (Griffin / RecurrentGemma) for Hopper (sm_90a): one
// thread per (batch row, channel) walks the sequence.
//
// Replaces the JAX package's TPU kernel src/repro/kernels/rglru/kernel.py
// (_rglru_kernel / rglru_pallas).  It computes the plain scan
// (repro_torch/kernels/rglru/ref.py::rglru_reference):
//     h_t = a_t h_{t-1} + u_t,   h_0 = 0,
// over a, u (B, T, D), float32 or bfloat16 (one type); h (B, T, D) in a's
// type and the final state (B, D) in float32.  Each step is a float32
// multiply and a float32 add, each rounded (no fused multiply-add), as the
// plain scan rounds them, so on float32 inputs the two agree bit for bit.
// (The TPU kernel's chunked cumprod / cumsum form divides by the cumulative
// decay of a 32-step chunk; this kernel needs no such range.)
//
// Design: the recurrence is elementwise in d, so thread d of a block owns
// channel d and neighbouring threads read neighbouring words of each step:
// every load and store is coalesced.  The only dependency is h along t; a
// thread loads kUnroll steps of a and u into registers before it walks
// them, so each thread keeps that many loads in flight.  Bound: bytes — a
// and u read once, h written once, the final state written once, at the
// card's 3.35 TB/s (two operations per element are nothing beside them).
// At B 4, D 4,096 there are 16,384 threads (256 blocks of 64), too few to
// keep the card's memory system full; splitting T over blocks (a scan of
// per-chunk (prod a, h) pairs) is later work.
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
rglru_kernel(const T* __restrict__ a, const T* __restrict__ u,
             T* __restrict__ h, float* __restrict__ h_last, int T_len,
             int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const size_t base = static_cast<size_t>(b) * T_len * D + d;
  float hv = 0.f;
  int t = 0;
  for (; t + kUnroll <= T_len; t += kUnroll) {
    float av[kUnroll], uv[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const size_t j = base + static_cast<size_t>(t + i) * D;
      av[i] = to_float(a[j]);
      uv[i] = to_float(u[j]);
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      hv = __fadd_rn(__fmul_rn(av[i], hv), uv[i]);
      h[base + static_cast<size_t>(t + i) * D] = from_float<T>(hv);
    }
  }
  for (; t < T_len; ++t) {
    const size_t j = base + static_cast<size_t>(t) * D;
    hv = __fadd_rn(__fmul_rn(to_float(a[j]), hv), to_float(u[j]));
    h[j] = from_float<T>(hv);
  }
  h_last[static_cast<size_t>(b) * D + d] = hv;
}

template <typename T>
cudaError_t launch(const void* a, const void* u, void* h, void* h_last, int B,
                   int steps, int D, cudaStream_t stream) {
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  rglru_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(u), static_cast<T*>(h),
      static_cast<float*>(h_last), steps, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of a, u and h: 0 = float32, 1 = bfloat16.  Returns the launch's CUDA
// error code.
int rglru_forward(const void* a, const void* u, void* h, void* h_last,
                  int dtype, int B, int T, int D, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || D <= 0 || T < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(launch<float>(a, u, h, h_last, B, T, D, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(a, u, h, h_last, B, T, D,
                                                  s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
