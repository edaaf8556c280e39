// WKV6 backward (RWKV6 / Finch time-mix) for Hopper (sm_90a): one thread
// block per (batch row, head) walks the sequence twice.
//
// Replaces no TPU kernel: the JAX package differentiates its plain chunked
// form (src/repro/kernels/rwkv6/ops.py::_chunked_jax) by autodiff.  It
// computes the gradients of the forward in csrc/wkv6.cu, as the plain
// version repro_torch/kernels/rwkv6/ref.py::wkv6_backward_reference does,
// pass for pass.  Per head, with S_t = diag(w_t) S_{t-1} + k_t^T v_t and
// o_t = r_t (S_{t-1} + diag(u) k_t^T v_t), given do (B, H, T, N) and an
// optional dS_T:
//   pass A, forward in time, recomputes S and writes
//     dr_t = S_{t-1} do_t + u k_t (v_t . do_t),  a_t = r_t (S_{t-1} do_t);
//   pass B, backward in time, carries G_t = dL/dS_t (G_T = dS_T or 0),
//   G_{t-1} = diag(w_t) G_t + r_t^T do_t, and writes
//     dk_t = G_t v_t + u r_t (v_t . do_t),
//     dv_t = G_t^T k_t + (sum_n r_t u k_t) do_t,
//     w_t dw_t = q_t - b_t,  b_t = k_t (G_t v_t),
//   with q_t = sum_m G_t S_t carried as q_{t-1} = q_t - b_t + a_t from
//   q_T = sum_m dS_T S_T, so dw never needs S and G at one step (and
//   dw_1 = 0, as S_0 = 0); du is
//   sum_t r_t k_t (v_t . do_t), a float32 partial per (b, h) that the
//   wrapper sums over B.  r, k, v, do are float32 or bfloat16 (one type),
//   w, u and dS_T float32; dr, dk, dv come out in r's type, dw in float32.
//   No atomics: every output element has one writer, so a run repeats
//   bit for bit.
//
// Precision: w dw = q - b cancels where w is small (q and b are of the size
// of G_t S_t, their difference w times that), and the rounding of S and G
// enters both.  With float32 states, decays down to 0.01 lose 2e-5 to
// 3e-5 of dw's scale (tools/wkv6_dw_precision.py), past the 1e-5 the
// plain version is held to against JAX.  So S, G, the row sums that
// feed a_t and b_t, q and the a_t scratch are float64 (the plain version
// does the same); dv's column sums and the per-step scalars are float32.
//
// Bound: operations.  Per step and head pass A does 4 N^2 (S update,
// S do) and pass B 6 N^2 (G update, G v, G^T k): at the prefill shape (4,
// 64, 2,048, 64) 21.5 GFLOP, 0.32 ms at the float32 rate; the float64 FMAs
// run at half of it.  The bytes (r, k, v, do, w in, dr, dk, dv, dw out)
// are about 0.74 GB, 0.22 ms.
//
// Design: the forward's tiling, a 4 x 4 tile of S (pass A) or G (pass B)
// a thread in registers for the whole sequence, N^2/16 threads, but with
// the lanes transposed: the N/4 threads of a row group sit in adjacent
// lanes, so the row sums over m that dr, a, dk and b need reduce inside a
// warp (two shuffle steps that each halve the rows a lane carries, then
// butterfly steps; the lane left with row n writes it).  dv sums a column
// over n, across the warps: each warp reduces its rows by shuffles and
// leaves a partial per column and step in shared memory, and after the
// chunk the block adds the warps' partials (in a fixed order).  None of
// the reductions feeds the recurrences, so the walks, unrolled by 4 steps,
// let a step's shuffle chains overlap the next steps' FMAs
// (tools/wkv6_bwd_variants.py times 1, 2, 4 and 8 steps; PERF.md).
// Chunks of kChunk steps of r, k, v, do, w (and, in pass B, a) are copied
// raw with 16-byte cp.async into one of two buffers while the other chunk
// is walked; the per-step scalars v_t . do_t and sum_n r_t u k_t are
// summed once per chunk, a warp a step.  (Converting each chunk to
// float64 once, into a third buffer, instead of each element at each use
// ran no faster on an H100: the conversions do not bound the walk, while
// overlapping its steps does help.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;   // steps staged per buffer
constexpr int kTile = 4;     // a thread's rows and columns of the state
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// the four elements at p (16-byte aligned for float, 8 for bfloat16)
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x;
  o[1] = x.y;
  o[2] = x.z;
  o[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  o[0] = __uint_as_float(x.x << 16);
  o[1] = __uint_as_float(x.x & 0xffff0000u);
  o[2] = __uint_as_float(x.y << 16);
  o[3] = __uint_as_float(x.y & 0xffff0000u);
}

// x[i] by selects (a register array indexed at run time would go to local
// memory)
__device__ __forceinline__ float sel4(const float* x, int i) {
  return i == 0 ? x[0] : i == 1 ? x[1] : i == 2 ? x[2] : x[3];
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Sum p[0..3] (the thread's four rows) over the CG lanes of its row group.
// Lanes whose CG/2 bit is set keep rows 2, 3 and send 0, 1; then the CG/4
// bit picks one of two; then butterfly steps.  Returns the sum of row
// 2 * (CG/2 bit) + (CG/4 bit) of the tile, on every lane of its subgroup.
template <int CG>
__device__ __forceinline__ double row_reduce(const double* p, int cg) {
  const bool hi = (cg & (CG / 2)) != 0;
  double k0 = hi ? p[2] : p[0], k1 = hi ? p[3] : p[1];
  k0 += __shfl_xor_sync(kFull, hi ? p[0] : p[2], CG / 2);
  k1 += __shfl_xor_sync(kFull, hi ? p[1] : p[3], CG / 2);
  const bool odd = (cg & (CG / 4)) != 0;
  double s = odd ? k1 : k0;
  s += __shfl_xor_sync(kFull, odd ? k0 : k1, CG / 4);
#pragma unroll
  for (int off = CG / 8; off > 0; off >>= 1)
    s += __shfl_xor_sync(kFull, s, off);
  return s;
}

// Shared memory: two buffers of one chunk (a in float64, w in float32,
// then r, k, v, do in T), dv's per-warp column partials of a chunk, and
// the chunk's per-step scalars (v . do, sum_n r u k).
template <typename T, int N>
struct Layout {
  static constexpr int kGroup = N / kTile;             // CG: row-group lanes
  static constexpr int kThreads = kGroup * kGroup;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kRowsPerWarp = 32 / kGroup;     // row groups a warp
  static constexpr int kArr = kChunk * N;              // elements an array
  static constexpr int kBufBytes = kArr * (8 + 4 + 4 * (int)sizeof(T));
  static constexpr int kPartBytes = kChunk * kWarps * N * 4;
  static constexpr int kSmemBytes = 2 * kBufBytes + kPartBytes + kChunk * 8;
  static_assert(kGroup == 8 || kGroup == 16, "a row group's lanes");
  static_assert(kRowsPerWarp == 2 || kRowsPerWarp == 4, "rows in a warp");
  static_assert(N * (int)sizeof(T) % 16 == 0, "whole 16-byte copies");
};

// two blocks an SM at N 64: at most 128 registers a thread
template <typename T, int N>
__global__ void __launch_bounds__((N / kTile) * (N / kTile), 2)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const T* __restrict__ dout,
                const float* __restrict__ ds, T* __restrict__ dr,
                T* __restrict__ dk, T* __restrict__ dv,
                float* __restrict__ dw, float* __restrict__ du_part,
                double* __restrict__ a_buf, int H, int T_len) {
  using L = Layout<T, N>;
  constexpr int CG = L::kGroup, NT = L::kThreads, W = L::kWarps;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int cg = tid % CG, rg = tid / CG;   // rows 4 rg.., columns 4 cg..
  const int lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.x;
  const int h = bh % H;
  const size_t base = static_cast<size_t>(bh) * T_len * N;
  // after a row reduction this lane holds row i_own of its tile; lanes
  // with the low bits of cg clear write it
  const int i_own = 2 * ((cg & (CG / 2)) != 0) + ((cg & (CG / 4)) != 0);
  const bool writer = (cg & (CG / 4 - 1)) == 0;
  const int n_own = kTile * rg + i_own;
  const double u_own = u[h * N + n_own];
  // u at the elements this lane sums in the per-step scalars
  float u_lane[N / 32];
#pragma unroll
  for (int e = 0; e < N / 32; ++e) u_lane[e] = u[h * N + lane + 32 * e];

  float* part = reinterpret_cast<float*>(smem + 2 * L::kBufBytes);
  float2* scal = reinterpret_cast<float2*>(smem + 2 * L::kBufBytes +
                                           L::kPartBytes);
  struct Buf {
    double* a;
    float* w;
    T *r, *k, *v, *d;
  };
  auto buf_of = [&](int b) {
    unsigned char* p = smem + b * L::kBufBytes;
    Buf x;
    x.a = reinterpret_cast<double*>(p);
    x.w = reinterpret_cast<float*>(x.a + L::kArr);
    x.r = reinterpret_cast<T*>(x.w + L::kArr);
    x.k = x.r + L::kArr;
    x.v = x.k + L::kArr;
    x.d = x.v + L::kArr;
    return x;
  };
  const int n_chunks = (T_len + kChunk - 1) / kChunk;
  auto len_of = [&](int c) { return min(kChunk, T_len - c * kChunk); };

  // copy chunk c (and, with_a, its a_t) into buffer b: one commit group
  auto issue = [&](int c, int b, bool with_a) {
    const Buf x = buf_of(b);
    const int len = len_of(c);
    const size_t off = base + static_cast<size_t>(c) * kChunk * N;
    constexpr int kEpc = 16 / (int)sizeof(T);
    for (int cp = tid; cp < len * N / kEpc; cp += NT) {
      cp_async16(x.r + cp * kEpc, r + off + cp * kEpc);
      cp_async16(x.k + cp * kEpc, k + off + cp * kEpc);
      cp_async16(x.v + cp * kEpc, v + off + cp * kEpc);
      cp_async16(x.d + cp * kEpc, dout + off + cp * kEpc);
    }
    for (int cp = tid; cp < len * N / 4; cp += NT)
      cp_async16(x.w + cp * 4, w + off + cp * 4);
    if (with_a)
      for (int cp = tid; cp < len * N / 2; cp += NT)
        cp_async16(x.a + cp * 2, a_buf + off + cp * 2);
    cp_async_commit();
  };

  // the chunk's per-step scalars, a warp a step
  auto scalars = [&](const Buf& x, int len) {
    for (int tt = warp; tt < len; tt += W) {
      float vd = 0.f, ruk = 0.f;
#pragma unroll
      for (int e = 0; e < N / 32; ++e) {
        const int i = tt * N + lane + 32 * e;
        vd = fmaf(to_float(x.v[i]), to_float(x.d[i]), vd);
        ruk = fmaf(to_float(x.r[i]) * u_lane[e], to_float(x.k[i]), ruk);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        vd += __shfl_xor_sync(kFull, vd, off);
        ruk += __shfl_xor_sync(kFull, ruk, off);
      }
      if (lane == 0) scal[tt] = make_float2(vd, ruk);
    }
  };

  // ---- pass A: forward in time; S in registers; dr, a_t, du ----
  double s[kTile][kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int j = 0; j < kTile; ++j) s[i][j] = 0.0;
  double du_acc = 0.0;
  issue(0, 0, false);
  for (int c = 0; c < n_chunks; ++c) {
    const int len = len_of(c);
    cp_async_wait_all();
    // chunk c is visible; every thread is done with chunk c - 1
    __syncthreads();
    if (c + 1 < n_chunks) issue(c + 1, (c + 1) & 1, false);
    const Buf x = buf_of(c & 1);
    scalars(x, len);
    __syncthreads();
    const size_t out = base + static_cast<size_t>(c) * kChunk * N + n_own;
#pragma unroll 4
    for (int tt = 0; tt < len; ++tt) {
      float rr[kTile], kk[kTile], ww[kTile], vv[kTile], dd[kTile];
      load4(x.r + tt * N + kTile * rg, rr);
      load4(x.k + tt * N + kTile * rg, kk);
      load4(x.w + tt * N + kTile * rg, ww);
      load4(x.v + tt * N + kTile * cg, vv);
      load4(x.d + tt * N + kTile * cg, dd);
      double p[kTile];
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        double acc = 0.0;
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
          acc = fma(s[i][j], (double)dd[j], acc);
          s[i][j] = fma((double)ww[i], s[i][j], (double)kk[i] * vv[j]);
        }
        p[i] = acc;
      }
      const double sdo = row_reduce<CG>(p, cg);
      if (writer) {
        const double vd = scal[tt].x;
        const double rn = sel4(rr, i_own), kn = sel4(kk, i_own);
        dr[out + static_cast<size_t>(tt) * N] =
            from_float<T>(static_cast<float>(sdo + u_own * kn * vd));
        a_buf[out + static_cast<size_t>(tt) * N] = rn * sdo;
        du_acc = fma(rn * kn, vd, du_acc);
      }
    }
  }
  if (writer) du_part[static_cast<size_t>(bh) * N + n_own] = (float)du_acc;

  // ---- pass B: backward in time; G in registers; dk, dv, dw ----
  double g[kTile][kTile];
  double q;
  {
    double p[kTile];
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      float dsi[kTile] = {0.f, 0.f, 0.f, 0.f};
      if (ds != nullptr)
        load4(ds + static_cast<size_t>(bh) * N * N +
                  static_cast<size_t>(kTile * rg + i) * N + kTile * cg,
              dsi);
      p[i] = 0.0;
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        g[i][j] = dsi[j];
        p[i] = fma(g[i][j], s[i][j], p[i]);
      }
    }
    q = row_reduce<CG>(p, cg);
  }
  // pass A's a_t stores are visible to the block's copies below
  __threadfence();
  __syncthreads();
  const bool hi_r = (lane & CG) != 0;          // column reduction's bits
  const bool odd_r = (lane & (2 * CG)) != 0;
  issue(n_chunks - 1, 0, true);
  for (int j = 0; j < n_chunks; ++j) {
    const int c = n_chunks - 1 - j;
    const int len = len_of(c);
    cp_async_wait_all();
    __syncthreads();
    if (c > 0) issue(c - 1, (j + 1) & 1, true);
    const Buf x = buf_of(j & 1);
    scalars(x, len);
    __syncthreads();
    const size_t out = base + static_cast<size_t>(c) * kChunk * N + n_own;
#pragma unroll 4
    for (int tt = len - 1; tt >= 0; --tt) {
      float rr[kTile], kk[kTile], ww[kTile], vv[kTile], dd[kTile];
      load4(x.r + tt * N + kTile * rg, rr);
      load4(x.k + tt * N + kTile * rg, kk);
      load4(x.w + tt * N + kTile * rg, ww);
      load4(x.v + tt * N + kTile * cg, vv);
      load4(x.d + tt * N + kTile * cg, dd);
      double gv[kTile], gk[kTile] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        double acc = 0.0;
#pragma unroll
        for (int jj = 0; jj < kTile; ++jj) {
          acc = fma(g[i][jj], (double)vv[jj], acc);
          gk[jj] = fma(g[i][jj], (double)kk[i], gk[jj]);
          g[i][jj] = fma((double)ww[i], g[i][jj], (double)rr[i] * dd[jj]);
        }
        gv[i] = acc;
      }
      // dv's partial: the warp's rows of each column
      float c0 = (float)(hi_r ? gk[2] : gk[0]);
      float c1 = (float)(hi_r ? gk[3] : gk[1]);
      c0 += __shfl_xor_sync(kFull, (float)(hi_r ? gk[0] : gk[2]), CG);
      c1 += __shfl_xor_sync(kFull, (float)(hi_r ? gk[1] : gk[3]), CG);
      float* pt = part + (tt * W + warp) * N + kTile * cg + 2 * hi_r;
      if constexpr (L::kRowsPerWarp == 2) {
        *reinterpret_cast<float2*>(pt) = make_float2(c0, c1);
      } else {
        float cs = odd_r ? c1 : c0;
        cs += __shfl_xor_sync(kFull, odd_r ? c0 : c1, 2 * CG);
        pt[odd_r] = cs;
      }
      const double gvn = row_reduce<CG>(gv, cg);
      if (writer) {
        const double vd = scal[tt].x;
        const double rn = sel4(rr, i_own), kn = sel4(kk, i_own);
        const size_t o = out + static_cast<size_t>(tt) * N;
        dk[o] = from_float<T>(static_cast<float>(gvn + u_own * rn * vd));
        const double bn = kn * gvn;
        // S_0 = 0: dw_1 is 0 exactly, not the rounding of q - b
        dw[o] = c == 0 && tt == 0
                    ? 0.f
                    : static_cast<float>((q - bn) / (double)sel4(ww, i_own));
        q += x.a[tt * N + n_own] - bn;
      }
    }
    // the chunk's dv: the warps' partials in order, and (sum r u k) do
    __syncthreads();
    const size_t dv0 = base + static_cast<size_t>(c) * kChunk * N;
    for (int e = tid; e < len * N; e += NT) {
      const int tt = e / N, m = e % N;
      float acc = scal[tt].y * to_float(x.d[e]);
#pragma unroll
      for (int wi = 0; wi < W; ++wi) acc += part[(tt * W + wi) * N + m];
      dv[dv0 + e] = from_float<T>(acc);
    }
  }
}

template <typename T, int N>
cudaError_t launch_n(const void* r, const void* k, const void* v,
                     const void* w, const void* u, const void* dout,
                     const void* ds, void* dr, void* dk, void* dv, void* dw,
                     void* du_part, void* a_buf, int B, int H, int steps,
                     cudaStream_t stream) {
  using L = Layout<T, N>;
  auto kernel = wkv6_bwd_kernel<T, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<B * H, L::kThreads, L::kSmemBytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const T*>(dout),
      static_cast<const float*>(ds), static_cast<T*>(dr),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(dw),
      static_cast<float*>(du_part), static_cast<double*>(a_buf), H, steps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* dout, const void* ds, void* dr,
                   void* dk, void* dv, void* dw, void* du_part, void* a_buf,
                   int B, int H, int steps, int N, cudaStream_t stream) {
  switch (N) {
    case 32:
      return launch_n<T, 32>(r, k, v, w, u, dout, ds, dr, dk, dv, dw,
                             du_part, a_buf, B, H, steps, stream);
    case 64:
      return launch_n<T, 64>(r, k, v, w, u, dout, ds, dr, dk, dv, dw,
                             du_part, a_buf, B, H, steps, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype of r, k, v, do, dr, dk, dv: 0 = float32, 1 = bfloat16.  ds (the
// final state's gradient, (B, H, N, N) float32) may be null.  a_buf is a
// (B, H, T, N) float64 scratch.  Returns the launch's CUDA error code.
int wkv6_backward(const void* r, const void* k, const void* v, const void* w,
                  const void* u, const void* dout, const void* ds, void* dr,
                  void* dk, void* dv, void* dw, void* du_part, void* a_buf,
                  int dtype, int B, int H, int T, int N, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(launch<float>(r, k, v, w, u, dout, ds, dr, dk,
                                          dv, dw, du_part, a_buf, B, H, T, N,
                                          s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(r, k, v, w, u, dout, ds,
                                                  dr, dk, dv, dw, du_part,
                                                  a_buf, B, H, T, N, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
