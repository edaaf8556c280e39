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
// step-by-step form, which is exact for every decay in (0, 1).  A chunked
// form on the tensor cores is left for later: its state products in TF32
// or bf16 would miss the 5e-5 to which the float32 state is held against
// the plain and float64 scans, and its chunk algebra needs a range-safe
// form first.
//
// Bound: at the prefill shape (B 4, H 64, T 2,048, N 64) the 4 N M
// operations per step and head at the card's float32 rate (67 TFLOP/s)
// and the bytes (r, k, v, o in bf16, w in float32) at 3.35 TB/s are about
// equal.  The old kernel gave each column of S to one thread: 256 blocks of
// 2 warps, about 4 warps per SM, so the FMA chains and shared-memory
// broadcasts had nothing to hide behind, and it staged each chunk
// synchronously between three barriers.
//
// Design: each thread holds a 4 x 4 tile of S, rows [4i, 4i+4) of columns
// [4j, 4j+4), in registers for the whole sequence; the N/4 threads of a
// column group sit in adjacent lanes, so a block has N^2/16 threads (256
// at N 64, about 16 warps per SM at the prefill shape).  Per step a thread
// reads its 4 rows' r, k, w and its 4 columns' v from shared memory (one
// 16-byte load each), updates its tile with S[n][m] = w_n S[n][m] + k_n
// v_m (the per-element arithmetic of the one-thread-per-column kernel)
// while it forms its part of sum_n r_n S[n][m] for its 4 columns, and the
// column group's lanes sum the parts: two shuffle steps that each halve
// the columns a lane carries, then plain butterfly steps, leave each lane
// one column's o_t[m] = sum + v_m sum_n r_n u_n k_n.  (Four threads per
// column, 16 rows each, ran no faster than the old kernel on an H100: a
// warp's 16-byte shared-memory load takes four cycles of the SM's
// shared-memory pipe however many lanes read one address, so per step and
// SM it reads as many bytes as one thread per column did; a 4 x 4 tile
// reads a quarter of that.)  Staging overlaps the scan: chunk c + 1 of r,
// k, v, w (kChunk steps) is copied raw with 16-byte cp.async into one of
// two buffers while chunk c is scanned; each thread then converts the
// copies it made itself into float32 and sums its part of each step's
// sum_n r_n u_n k_n, a shuffle reduction over the threads of a step
// completing it, so one barrier per chunk makes the staged chunk visible
// and frees the other buffer.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;   // steps staged per buffer
constexpr int kTile = 4;     // a thread's rows and columns of the state

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the 16 bytes at p as floats: 4 float32 or 8 bfloat16
__device__ __forceinline__ void unpack16(const float* p, float* o) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x;
  o[1] = x.y;
  o[2] = x.z;
  o[3] = x.w;
}

__device__ __forceinline__ void unpack16(const __nv_bfloat16* p, float* o) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    o[2 * j] = __uint_as_float(w[j] << 16);
    o[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Shared memory: two raw buffers (r, k, v in T, w in float32, kChunk steps
// each), then two float32 buffers (r, k, w, v, and the steps' sum_n r_n
// u_n k_n).
template <typename T, int N>
struct Layout {
  static constexpr int kGroup = N / kTile;         // row (column) groups
  static constexpr int kThreads = kGroup * kGroup;
  static constexpr int kArr = kChunk * N;          // elements per array
  static constexpr int kRawBytes = kArr * (3 * (int)sizeof(T) + 4);
  static constexpr int kFloatBytes = (4 * kArr + kChunk) * 4;
  static constexpr int kSmemBytes = 2 * (kRawBytes + kFloatBytes);
  static constexpr int kEpc = 16 / (int)sizeof(T);  // elements per copy
  static constexpr int kCopiesPerStep = N / kEpc;
  static_assert(kGroup == 8 || kGroup == 16, "a column group's lanes");
  static_assert(kThreads * kEpc % N == 0, "a thread's copies share n");
  static_assert(kChunk * kCopiesPerStep % kThreads == 0, "copies per thread");
  static_assert(kChunk * (N / 4) % kThreads == 0, "w copies per thread");
};

template <typename T, int N>
__global__ void __launch_bounds__((N / kTile) * (N / kTile))
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, T* __restrict__ o,
            float* __restrict__ s_out, int H, int T_len) {
  using L = Layout<T, N>;
  constexpr int kThreads = L::kThreads, RG = L::kGroup, EPC = L::kEpc;
  constexpr int GS = L::kCopiesPerStep;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int rg = tid % RG, cg = tid / RG;   // rows 4 rg.., columns 4 cg..
  const int bh = blockIdx.x;
  const int h = bh % H;
  const size_t base = static_cast<size_t>(bh) * T_len * N;
  // u at the elements this thread stages (the same n for every copy)
  const int n_own = (tid * EPC) % N;
  float uu[EPC];
#pragma unroll
  for (int e = 0; e < EPC; ++e) uu[e] = u[h * N + n_own + e];

  auto raw_of = [&](int buf) { return smem + buf * L::kRawBytes; };
  auto floats_of = [&](int buf) {
    return reinterpret_cast<float*>(smem + 2 * L::kRawBytes +
                                    buf * L::kFloatBytes);
  };

  // copy chunk c's raw rows into raw buffer `buf` (one commit group)
  auto issue = [&](int c, int buf) {
    const int len = min(kChunk, T_len - c * kChunk);
    unsigned char* raw = raw_of(buf);
    T* rr = reinterpret_cast<T*>(raw);
    T* rk = rr + L::kArr;
    T* rv = rk + L::kArr;
    float* rw = reinterpret_cast<float*>(rv + L::kArr);
    const size_t off = base + static_cast<size_t>(c) * kChunk * N;
#pragma unroll
    for (int j = 0; j < kChunk * GS / kThreads; ++j) {
      const int cp = tid + j * kThreads;
      if (cp < len * GS) {
        cp_async16(rr + cp * EPC, r + off + cp * EPC);
        cp_async16(rk + cp * EPC, k + off + cp * EPC);
        cp_async16(rv + cp * EPC, v + off + cp * EPC);
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk * (N / 4) / kThreads; ++j) {
      const int cp = tid + j * kThreads;
      if (cp < len * (N / 4)) cp_async16(rw + cp * 4, w + off + cp * 4);
    }
    cp_async_commit();
  };

  // the copies this thread made of a chunk, as float32, and each step's
  // sum_n r_n u_n k_n
  auto stage = [&](int len, int buf) {
    const unsigned char* raw = raw_of(buf);
    const T* rr = reinterpret_cast<const T*>(raw);
    const T* rk = rr + L::kArr;
    const T* rv = rk + L::kArr;
    const float* rw = reinterpret_cast<const float*>(rv + L::kArr);
    float* fr = floats_of(buf);
    float* fk = fr + L::kArr;
    float* fw = fk + L::kArr;
    float* fv = fw + L::kArr;
    float* fruk = fv + L::kArr;
#pragma unroll
    for (int j = 0; j < kChunk * GS / kThreads; ++j) {
      const int cp = tid + j * kThreads;
      const bool valid = cp < len * GS;      // whole steps: uniform per group
      float part = 0.f;
      if (valid) {
        float xr[EPC], xk[EPC], xv[EPC];
        unpack16(rr + cp * EPC, xr);
        unpack16(rk + cp * EPC, xk);
        unpack16(rv + cp * EPC, xv);
        const int e0 = cp * EPC;                 // step cp / GS, n n_own
#pragma unroll
        for (int g = 0; g < EPC; g += 4) {
          *reinterpret_cast<float4*>(fr + e0 + g) =
              make_float4(xr[g], xr[g + 1], xr[g + 2], xr[g + 3]);
          *reinterpret_cast<float4*>(fk + e0 + g) =
              make_float4(xk[g], xk[g + 1], xk[g + 2], xk[g + 3]);
          *reinterpret_cast<float4*>(fv + e0 + g) =
              make_float4(xv[g], xv[g + 1], xv[g + 2], xv[g + 3]);
        }
#pragma unroll
        for (int e = 0; e < EPC; ++e) part = fmaf(xr[e] * uu[e], xk[e], part);
      }
#pragma unroll
      for (int off = GS / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (valid && cp % GS == 0) fruk[cp / GS] = part;
    }
#pragma unroll
    for (int j = 0; j < kChunk * (N / 4) / kThreads; ++j) {
      const int cp = tid + j * kThreads;
      if (cp < len * (N / 4))
        *reinterpret_cast<float4*>(fw + cp * 4) =
            *reinterpret_cast<const float4*>(rw + cp * 4);
    }
  };

  float s[kTile][kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int j = 0; j < kTile; ++j) s[i][j] = 0.f;
  // after the reduction this lane holds column j of its group; lanes with
  // the low bits of rg clear write it
  const int j_own = 2 * ((rg & (RG / 2)) != 0) + ((rg & (RG / 4)) != 0);
  const bool writer = (rg & (RG / 4 - 1)) == 0;

  const int n_chunks = (T_len + kChunk - 1) / kChunk;
  if (n_chunks > 0) issue(0, 0);
  for (int c = 0; c < n_chunks; ++c) {
    const int len = min(kChunk, T_len - c * kChunk);
    if (c + 1 < n_chunks) {
      issue(c + 1, (c + 1) & 1);   // its buffer's last reader was this thread
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    stage(len, c & 1);
    // the chunk's floats are visible, and every thread is done with the
    // other float buffer (chunk c - 1's scan)
    __syncthreads();
    const float* fr = floats_of(c & 1);
    const float* fk = fr + L::kArr;
    const float* fw = fk + L::kArr;
    const float* fv = fw + L::kArr;
    const float* fruk = fv + L::kArr;
    const size_t out = base + static_cast<size_t>(c) * kChunk * N +
                       kTile * cg + j_own;
#pragma unroll 8
    for (int tt = 0; tt < len; ++tt) {
      const int row = tt * N;
      const float4 r4 = *reinterpret_cast<const float4*>(fr + row + 4 * rg);
      const float4 k4 = *reinterpret_cast<const float4*>(fk + row + 4 * rg);
      const float4 w4 = *reinterpret_cast<const float4*>(fw + row + 4 * rg);
      const float4 v4 = *reinterpret_cast<const float4*>(fv + row + 4 * cg);
      const float rr[kTile] = {r4.x, r4.y, r4.z, r4.w};
      const float kk[kTile] = {k4.x, k4.y, k4.z, k4.w};
      const float ww[kTile] = {w4.x, w4.y, w4.z, w4.w};
      const float vv[kTile] = {v4.x, v4.y, v4.z, v4.w};
      float a[kTile] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
          a[j] = fmaf(rr[i], s[i][j], a[j]);
          s[i][j] = ww[i] * s[i][j] + kk[i] * vv[j];
        }
      }
      // sum the column group's parts: lanes whose RG/2 bit is set keep
      // columns 2, 3 and send 0, 1; then the RG/4 bit picks one of two
      const bool hi = (rg & (RG / 2)) != 0;
      float k0 = hi ? a[2] : a[0], k1 = hi ? a[3] : a[1];
      k0 += __shfl_xor_sync(0xffffffffu, hi ? a[0] : a[2], RG / 2);
      k1 += __shfl_xor_sync(0xffffffffu, hi ? a[1] : a[3], RG / 2);
      const bool odd = (rg & (RG / 4)) != 0;
      float sum = odd ? k1 : k0;
      sum += __shfl_xor_sync(0xffffffffu, odd ? k0 : k1, RG / 4);
#pragma unroll
      for (int off = RG / 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float vj = j_own == 0   ? v4.x
                       : j_own == 1 ? v4.y
                       : j_own == 2 ? v4.z
                                    : v4.w;
      if (writer)
        o[out + static_cast<size_t>(tt) * N] =
            from_float<T>(sum + vj * fruk[tt]);
    }
  }
  float* so = s_out + static_cast<size_t>(bh) * N * N + kTile * cg;
#pragma unroll
  for (int i = 0; i < kTile; ++i)
    *reinterpret_cast<float4*>(so + static_cast<size_t>(kTile * rg + i) * N) =
        make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
}

template <typename T, int N>
cudaError_t launch_n(const void* r, const void* k, const void* v,
                     const void* w, const void* u, void* o, void* s_out,
                     int B, int H, int steps, cudaStream_t stream) {
  using L = Layout<T, N>;
  auto kernel = wkv6_kernel<T, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<B * H, L::kThreads, L::kSmemBytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<T*>(o),
      static_cast<float*>(s_out), H, steps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, void* o, void* s_out, int B, int H,
                   int steps, int N, cudaStream_t stream) {
  switch (N) {
    case 32:
      return launch_n<T, 32>(r, k, v, w, u, o, s_out, B, H, steps, stream);
    case 64:
      return launch_n<T, 64>(r, k, v, w, u, o, s_out, B, H, steps, stream);
    default:
      return cudaErrorInvalidValue;
  }
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
