// WKV6 backward (RWKV6 / Finch time-mix) for Hopper (sm_90a): one thread
// block per (batch row, head) walks the sequence in chunks of kChunk steps,
// forward to keep the state at every chunk's start, then backward.
//
// Replaces no TPU kernel: the JAX package differentiates its plain chunked
// form (src/repro/kernels/rwkv6/ops.py::_chunked_jax) by autodiff.  It
// computes the gradients of the forward in csrc/wkv6.cu from the chunk
// algebra that repro_torch/kernels/rwkv6/ref.py::wkv6_backward_chunked
// renders in plain PyTorch (and wkv6_backward_reference computes step by
// step).  Per head, with S_t = diag(w_t) S_{t-1} + k_t^T v_t, G_t = dL/dS_t
// and, over a chunk of C steps from t0, per channel n:
//   Hd_t = prod_{t0<=j<t} w_j,  Tl_t = prod_{t<j<t0+C} w_j,
//   b(x, t) = prod_{t<j<x} w_j  (t < x),
// S_prev the state before the chunk and G_end dL/dS at its last step:
//   P_t = S_prev do_t,  Q_t = G_end v_t,  A[s][x] = v_s . do_x,
//   Gamma = sum_m G_end . S_prev,  Zv_t = G_end^T (Tl_t k_t),
//   Y_t[x] = sum_{s<t} b(t, s) k_s A[s][x],  yq_t = sum_{s<t} b(t, s) k_s Q_s,
//   dr_t = Hd_t P_t + Y_t[t] + u k_t A[t][t],
//   dk_t = Tl_t Q_t + sum_{x>t} b(x, t) r_x A[t][x] + u r_t A[t][t],
//   dw_t = Hd_t Tl_t Gamma + Hd_t sum_{x>t} b(x, t) r_x P_x + Tl_t yq_t
//          + sum_{x>t} b(x, t) r_x Y_t[x],
//   M[t][x] = sum_n b(x, t) r_x k_t,
//   dv_t = Zv_t + sum_{x>t} M[t][x] do_x + (sum_n r_t u k_t) do_t,
//   G_{t0-1} = Hd_{t0+C} G_end + sum_x (Hd_x r_x) do_x^T,
//   S_next = Hd_{t0+C} S_prev + sum_s (Tl_s k_s) v_s^T,
// and du = sum_t r_t k_t A[t][t], a float32 partial per (b, h) that the
// wrapper sums over B.  Every factor is a product of decays (none above
// 1), and nothing divides by a decay: dw_t = sum_m G_t S_{t-1} holds at any
// decay, and is 0 at the first step (S_0 = 0).  (The walk this kernel
// replaced got dw from w_t dw_t = q_t - b_t, which cancels at small decays
// and so carried float64 states; it was wrong below w ~ 1e-11 all the
// same.)  So the states and the sums are float32.  r, k, v, do are float32
// or bfloat16 (one type), w, u and dS_T float32; dr, dk, dv come out in r's
// type, dw in float32.  No atomics: every output element has one writer and
// every sum a fixed order, so a run repeats bit for bit.
//
// Bound: bytes.  r, k, v, do, w in and dr, dk, dv, dw out are about
// 0.74 GB at the prefill shape (4, 64, 2,048, 64), 0.22 ms at 3.35 TB/s.
// The step form's work, 10 N^2 a step and head (pass A 4 N^2, pass B
// 6 N^2), 21.5 GFLOP there, takes 0.13 ms at the rate of the route below:
// the TF32 tensor-core peak (495 TFLOP/s) over the three products that
// make one float32 product.  The chunk form does about as much in its
// products and adds O(C N) a step of pairwise terms on the CUDA cores.
// The chunk states pass A keeps for pass B ((T / C - 1) N^2 floats a head,
// 537 MB at the prefill shape, written and read back) add 0.32 ms more.
//
// Design: 4 N threads a block.  A chunk's r, k, v, do and w land by 16-byte
// cp.async in a raw buffer while the chunk before is worked, are converted
// to float32 once into padded [C][N + 4] arrays (steps past T read as
// r = k = v = do = 0, w = 1), and the chunk's S_prev is copied from pass
// A's scratch the same way.  The products (P, Q, Zv, A, G's and S's
// updates, dv's sum over M) run on the tensor cores: mma.sync m16n8k8
// TF32, each operand split in a high and a low TF32 part and three
// products summed (hi hi, hi lo, lo hi), about float32's precision (plain
// TF32 keeps ~3 digits, past the tolerances); a warp owns 16 x 8 output
// tiles.  Pass A keeps S in its warps' accumulators.  Pass B keeps G in
// shared memory and, a chunk:
//   I    as the chunk is converted, one thread a channel forms Tl k, Hd,
//        Hd r and Hd_{t0+C} by running products;
//   II   P, Q, Zv and A (and A^T); Gamma and sum_n r u k;
//   III  every lane walks a channel at C / 4 steps (the same number of
//        pairwise products in every warp): dr, dk, dw, and M summed over
//        the warp's 32 channels by shuffles (one partial a warp of
//        channels); then G's update;
//   IV   dv.
// Every decay factor is a running product of the chunk's decays, formed
// where it is used; nothing is exponentiated.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;   // steps a chunk
constexpr unsigned kFull = 0xffffffffu;

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

// the four elements at p (16-byte aligned for float, 8 for bfloat16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(x.x << 16),
                     __uint_as_float(x.x & 0xffff0000u),
                     __uint_as_float(x.y << 16),
                     __uint_as_float(x.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
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

// ---- the products on the tensor cores ----------------------------------

// x to TF32, rounded to nearest (ties away): 10 bits of mantissa, the low
// 13 bits of the float cleared
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo within 2^-22 of x, both TF32 (x - hi is exact)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += A B for one 16 x 8 tile over k in [0, K): A (16 x K) and B (K x 8)
// read through a(row, k) and b(k, col).  d is mma's fragment: with g =
// lane / 4 and q = lane % 4, d[0], d[1] at (g, 2 q), (g, 2 q + 1) and d[2],
// d[3] at (g + 8, 2 q), (g + 8, 2 q + 1).  Three TF32 products a k-step
// (the small ones first), summed from 0 on the tensor cores and added to d
// by float32 adds: the tensor cores' own sums round toward zero, which
// would bias a sum carried through many steps.
template <int K, typename FA, typename FB>
__device__ __forceinline__ void mma_tile(float (&d)[4], FA a, FB b,
                                         int lane) {
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ah[4], al[4], bh[2], bl[2];
    split_tf32(a(g, k0 + q), ah[0], al[0]);
    split_tf32(a(g + 8, k0 + q), ah[1], al[1]);
    split_tf32(a(g, k0 + q + 4), ah[2], al[2]);
    split_tf32(a(g + 8, k0 + q + 4), ah[3], al[3]);
    split_tf32(b(k0 + q, g), bh[0], bl[0]);
    split_tf32(b(k0 + q + 4, g), bh[1], bl[1]);
    float e[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(e, al, bh);
    mma_tf32(e, ah, bl);
    mma_tf32(e, ah, bh);
#pragma unroll
    for (int j = 0; j < 4; ++j) d[j] += e[j];
  }
}

// st(row, col, value) for each of a tile's four fragment values
template <typename FS>
__device__ __forceinline__ void store_tile(const float (&d)[4], FS st,
                                           int lane) {
  const int g = lane / 4, q = lane % 4;
  st(g, 2 * q, d[0]);
  st(g, 2 * q + 1, d[1]);
  st(g + 8, 2 * q, d[2]);
  st(g + 8, 2 * q + 1, d[3]);
}

// ---- the walk ----------------------------------------------------------

// Sum v[0..C-1] over the warp's 32 lanes and store the sums to dst[0..C-1]:
// each stage halves the values a lane holds (the lanes whose offset bit is
// set keep the upper half and send the lower), so a lane ends with one
// index's sum; the lanes left with the same index add by butterfly, and
// the one whose remaining bits are 0 stores it.  The stages are template
// steps, so every index is a constant and v stays in registers.
template <int W, int OFF>
__device__ __forceinline__ void sum_lanes(float (&v)[kChunk], int lane,
                                          int& idx) {
  if constexpr (OFF > 0) {
    if constexpr (W > 1) {
      const bool hi = (lane & OFF) != 0;
#pragma unroll
      for (int i = 0; i < W / 2; ++i) {
        const float keep = hi ? v[i + W / 2] : v[i];
        const float send = hi ? v[i] : v[i + W / 2];
        v[i] = keep + __shfl_xor_sync(kFull, send, OFF);
      }
      if (hi) idx += W / 2;
      sum_lanes<W / 2, OFF / 2>(v, lane, idx);
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], OFF);
      sum_lanes<1, OFF / 2>(v, lane, idx);
    }
  }
}

__device__ __forceinline__ void warp_sum_store(float (&v)[kChunk],
                                               float* dst, int lane) {
  int idx = 0;
  sum_lanes<kChunk, 16>(v, lane, idx);
  if ((lane & (32 / kChunk - 1)) == 0) dst[idx] = v[0];
}

// row[0..C-1] = p[0..C-1] (16-byte aligned): C / 4 vector loads, the same
// address on every lane
__device__ __forceinline__ void load_row(const float* p,
                                         float (&row)[kChunk]) {
#pragma unroll
  for (int j = 0; j < kChunk / 4; ++j) {
    const float4 x = load4(p + 4 * j);
    row[4 * j] = x.x;
    row[4 * j + 1] = x.y;
    row[4 * j + 2] = x.z;
    row[4 * j + 3] = x.w;
  }
}

// One step t of a chunk for channel n (one lane; t is the same across the
// warp): dr_t, dk_t, dw_t and the lane's terms of M[t][x], summed over the
// warp's channels into mw.  The pairwise terms with s < t < x take
// min(t, C - 1 - t) C products: Y_t[x] = sum_{s<t} b(t, s) k_s A[s][x]
// when t is in the chunk's first half, else Z[s] = sum_{x>t} b(x, t) r_x
// A[s][x].  Every index of y, z, cm and the rows of A is a constant
// (unrolled loops, predicated by t, which is the same on every lane).
template <int N, typename T>
__device__ __forceinline__ void walk_step(
    int t, int n, int lane, float un, float gam, const float* fr,
    const float* fk, const float* fw, const float* Am, const float* AmT,
    const float* Pm, const float* Qm, float hd, bool write, T* dr, T* dk,
    float* dw, size_t o, float* mw, float& du_acc) {
  constexpr int kP = N + 4, C = kChunk;
  const float kt = fk[t * kP + n], rt = fr[t * kP + n], att = Am[t * C + t];
  float dri = 0.f, dki = 0.f, yq = 0.f, t2 = 0.f, t4 = 0.f, tl;
  float cm[C], at[C];
  load_row(Am + t * C, at);         // A[t][x]
  if (2 * t < C) {
    float y[C];
#pragma unroll
    for (int x = 0; x < C; ++x) y[x] = 0.f;
    float a = 1.f;                     // b(t, s), s descending
#pragma unroll
    for (int s = C - 1; s >= 0; --s) {
      if (s < t) {
        float as[C];
        load_row(Am + s * C, as);   // A[s][x]
        const float ak = a * fk[s * kP + n];
        dri = fmaf(ak, Am[s * C + t], dri);
        yq = fmaf(ak, Qm[s * N + n], yq);
#pragma unroll
        for (int x = 0; x < C; ++x)
          if (x > t) y[x] = fmaf(ak, as[x], y[x]);
        a *= fw[s * kP + n];
      }
    }
    float b = 1.f;                     // b(x, t), x ascending
#pragma unroll
    for (int x = 0; x < C; ++x) {
      cm[x] = 0.f;
      if (x > t) {
        const float tmp = b * fr[x * kP + n];
        dki = fmaf(tmp, at[x], dki);
        t2 = fmaf(tmp, Pm[x * N + n], t2);
        t4 = fmaf(tmp, y[x], t4);
        cm[x] = tmp * kt;
        b *= fw[x * kP + n];
      }
    }
    tl = b;
  } else {
    float z[C];
#pragma unroll
    for (int s = 0; s < C; ++s) z[s] = 0.f;
    float b = 1.f;
#pragma unroll
    for (int x = 0; x < C; ++x) {
      cm[x] = 0.f;
      if (x > t) {
        float ax[C];
        load_row(AmT + x * C, ax);  // A[s][x]
        const float tmp = b * fr[x * kP + n];
        dki = fmaf(tmp, at[x], dki);
        t2 = fmaf(tmp, Pm[x * N + n], t2);
        cm[x] = tmp * kt;
#pragma unroll
        for (int s = 0; s < C; ++s)
          if (s < t) z[s] = fmaf(tmp, ax[s], z[s]);
        b *= fw[x * kP + n];
      }
    }
    tl = b;
    float a = 1.f;
#pragma unroll
    for (int s = C - 1; s >= 0; --s) {
      if (s < t) {
        const float ak = a * fk[s * kP + n];
        dri = fmaf(ak, Am[s * C + t], dri);
        yq = fmaf(ak, Qm[s * N + n], yq);
        t4 = fmaf(ak, z[s], t4);
        a *= fw[s * kP + n];
      }
    }
  }
  if (write) {
    dr[o] = from_float<T>(fmaf(hd, Pm[t * N + n], dri) + un * kt * att);
    dk[o] = from_float<T>(fmaf(tl, Qm[t * N + n], dki) + un * rt * att);
    dw[o] = fmaf(hd * tl, gam, fmaf(hd, t2, fmaf(tl, yq, t4)));
  }
  du_acc = fmaf(rt * kt, att, du_acc);
  warp_sum_store(cm, mw + t * C, lane);
}

// ---- the kernel --------------------------------------------------------

// Shared memory: the raw chunk (r, k, v, do in T, then w), then float32
// arrays, offsets in floats.
template <typename T, int N>
struct Layout {
  static constexpr int C = kChunk;
  static constexpr int kThreads = 4 * N;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kChannelWarps = N / 32;  // warps to span N channels
  static constexpr int kP = N + 4;              // a padded row of N
  static constexpr int kKt = C + 4;             // a padded row of C
  static constexpr int kArr = C * kP;           // one [C][N + 4] array
  static constexpr int kRawBytes = C * N * (4 * (int)sizeof(T) + 4);
  static constexpr int oR = 0, oK = kArr, oV = 2 * kArr, oD = 3 * kArr;
  static constexpr int oW = 4 * kArr;
  static constexpr int oS = 5 * kArr;                 // S_prev [N][kP]
  static constexpr int oG = oS + N * kP;              // G [N][kP]
  // pass B: (Tl k)^T [N][kKt]; pass A: Tl k [C][kP]
  static constexpr int oKt = oG + N * kP;
  static constexpr int oRt = oKt + N * kKt;         // Hd r [C][kP]
  static constexpr int oP = oRt + kArr;               // P [C][N]
  static constexpr int oQ = oP + C * N;               // Q [C][N]
  static constexpr int oZ = oQ + C * N;               // Zv [C][N]
  static constexpr int oA = oZ + C * N;               // A [C][C]
  static constexpr int oAT = oA + C * C;              // A^T [C][C]
  static constexpr int oM = oAT + C * C;              // M [warps][C][C]
  static constexpr int oHdT = oM + kChannelWarps * C * C;  // Hd_t [C][N]
  static constexpr int oHd = oHdT + C * N;            // Hd_{t0+C} [N]
  static constexpr int oGam = oHd + N;                // Gamma [N]
  static constexpr int oU = oGam + N;                 // u [N]
  static constexpr int oDu = oU + N;                  // du's partials [4][N]
  static constexpr int oRuk = oDu + 4 * N;            // sum_n r u k [C]
  static constexpr int kFloats = oRuk + C;
  static constexpr int kSmemBytes = kRawBytes + 4 * kFloats;
  static_assert(N == 32 || N == 64, "head dims 32 and 64");
  static_assert(kArr <= N * kKt, "pass A's Tl k fits in pass B's (Tl k)^T");
  static_assert(kRawBytes % 16 == 0 && kArr % 4 == 0, "16-byte rows");
};

template <typename T, int N>
__global__ void __launch_bounds__(4 * N, 2)
wkv6_bwd_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u,
                      const T* __restrict__ dout,
                      const float* __restrict__ ds, T* __restrict__ dr,
                      T* __restrict__ dk, T* __restrict__ dv,
                      float* __restrict__ dw, float* __restrict__ du_part,
                      float* __restrict__ s_buf, int H, int T_len) {
  using L = Layout<T, N>;
  constexpr int C = kChunk;
  constexpr int NT = L::kThreads, NW = L::kWarps, kP = L::kP, kKt = L::kKt;
  extern __shared__ __align__(16) unsigned char smem[];
  T* raw_r = reinterpret_cast<T*>(smem);
  T* raw_k = raw_r + C * N;
  T* raw_v = raw_k + C * N;
  T* raw_d = raw_v + C * N;
  float* raw_w = reinterpret_cast<float*>(raw_d + C * N);
  float* f = reinterpret_cast<float*>(smem + L::kRawBytes);
  float* fr = f + L::oR;
  float* fk = f + L::oK;
  float* fv = f + L::oV;
  float* fd = f + L::oD;
  float* fw = f + L::oW;
  float* S = f + L::oS;
  float* G = f + L::oG;
  float* Kt = f + L::oKt;
  float* Rt = f + L::oRt;
  float* Pm = f + L::oP;
  float* Qm = f + L::oQ;
  float* Zm = f + L::oZ;
  float* Am = f + L::oA;
  float* AmT = f + L::oAT;
  float* Mm = f + L::oM;
  float* HdT = f + L::oHdT;
  float* HdC = f + L::oHd;
  float* Gam = f + L::oGam;
  float* uS = f + L::oU;
  float* Du = f + L::oDu;
  float* Ruk = f + L::oRuk;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int fg = lane / 4, fq = lane % 4;   // a fragment's row and column
  const int bh = blockIdx.x;
  const int h = bh % H;
  const size_t base = static_cast<size_t>(bh) * T_len * N;
  const int n_chunks = (T_len + C - 1) / C;
  // slot c - 1 holds the state before chunk c (c >= 1)
  float* s_mine = s_buf + static_cast<size_t>(bh) * (n_chunks - 1) * N * N;
  if (tid < N) uS[tid] = u[h * N + tid];

  // copy chunk c's rows (all five arrays, or k, v, w) into the raw buffer:
  // one commit group
  auto fetch = [&](int c, bool all) {
    const int len = min(C, T_len - c * C);
    const size_t off = base + static_cast<size_t>(c) * C * N;
    constexpr int kE = 16 / (int)sizeof(T);
    for (int p = tid; p < len * N / kE; p += NT) {
      cp_async16(raw_k + p * kE, k + off + p * kE);
      cp_async16(raw_v + p * kE, v + off + p * kE);
      if (all) {
        cp_async16(raw_r + p * kE, r + off + p * kE);
        cp_async16(raw_d + p * kE, dout + off + p * kE);
      }
    }
    for (int p = tid; p < len * N / 4; p += NT)
      cp_async16(raw_w + p * 4, w + off + p * 4);
    cp_async_commit();
  };
  // the raw chunk (len steps) to the float32 arrays; steps past len read
  // as r = k = v = do = 0, w = 1
  auto convert = [&](int len, bool all) {
    for (int e = tid; e < C * N / 4; e += NT) {
      const int t = e / (N / 4), c4 = 4 * (e % (N / 4));
      const int dst = t * kP + c4, src = t * N + c4;
      const bool in = t < len;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      store4(fk + dst, in ? load4(raw_k + src) : zero);
      store4(fv + dst, in ? load4(raw_v + src) : zero);
      store4(fw + dst, in ? load4(raw_w + src)
                          : make_float4(1.f, 1.f, 1.f, 1.f));
      if (all) {
        store4(fr + dst, in ? load4(raw_r + src) : zero);
        store4(fd + dst, in ? load4(raw_d + src) : zero);
      }
    }
  };

  // ---- pass A: forward over the chunks; S in the warps' accumulators ----
  // tiles warp + NW i of the (N / 16) x (N / 8) tiles of S, rows first
  constexpr int kSTiles = N / 16;            // a warp's tiles of S or G
  float s[kSTiles][4];
#pragma unroll
  for (int i = 0; i < kSTiles; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  if (n_chunks > 1) fetch(0, false);
  for (int c = 0; c + 1 < n_chunks; ++c) {
    cp_async_wait_all();
    // chunk c landed; every thread is done with chunk c - 1
    __syncthreads();
    convert(C, false);
    if (tid < N) {
      // from the raw chunk: Tl_t k_t ([C][kP]) and the chunk's decay
      float b = 1.f;
      for (int t = C - 1; t >= 0; --t) {
        Kt[t * kP + tid] = b * to_float(raw_k[t * N + tid]);
        b *= raw_w[t * N + tid];
      }
      HdC[tid] = b;
    }
    __syncthreads();
    if (c + 2 < n_chunks) fetch(c + 1, false);
    float* dst = s_mine + static_cast<size_t>(c) * N * N;
#pragma unroll
    for (int i = 0; i < kSTiles; ++i) {
      const int tile = warp + NW * i;
      const int n0 = 16 * (tile % (N / 16)), m0 = 8 * (tile / (N / 16));
      const float h0 = HdC[n0 + fg], h1 = HdC[n0 + fg + 8];
      float e[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tile<C>(
          e, [&](int row, int kk) { return Kt[kk * kP + n0 + row]; },
          [&](int kk, int col) { return fv[kk * kP + m0 + col]; }, lane);
      s[i][0] = fmaf(h0, s[i][0], e[0]);
      s[i][1] = fmaf(h0, s[i][1], e[1]);
      s[i][2] = fmaf(h1, s[i][2], e[2]);
      s[i][3] = fmaf(h1, s[i][3], e[3]);
      // the state before chunk c + 1
      store2(dst + (n0 + fg) * N + m0 + 2 * fq, s[i][0], s[i][1]);
      store2(dst + (n0 + fg + 8) * N + m0 + 2 * fq, s[i][2], s[i][3]);
    }
  }
  // pass A's states are visible to the block's copies below
  __threadfence();
  __syncthreads();

  // ---- pass B: backward over the chunks; G in shared memory ----
  for (int e = tid; e < N * N / 4; e += NT) {
    const int row = e / (N / 4), c4 = 4 * (e % (N / 4));
    store4(G + row * kP + c4,
           ds == nullptr
               ? make_float4(0.f, 0.f, 0.f, 0.f)
               : load4(ds + (static_cast<size_t>(bh) * N + row) * N + c4));
  }
  // S_prev of chunk c into S: copied from pass A's slot, or 0 for chunk 0
  auto fetch_state = [&](int c) {
    if (c == 0) {
      for (int e = tid; e < N * N / 4; e += NT)
        store4(S + (e / (N / 4)) * kP + 4 * (e % (N / 4)),
               make_float4(0.f, 0.f, 0.f, 0.f));
      return;
    }
    const float* src = s_mine + static_cast<size_t>(c - 1) * N * N;
    for (int e = tid; e < N * N / 4; e += NT)
      cp_async16(S + (e / (N / 4)) * kP + 4 * (e % (N / 4)), src + 4 * e);
    cp_async_commit();
  };
  fetch(n_chunks - 1, true);
  fetch_state(n_chunks - 1);
  // the walk's items: channel n, steps g + 8 i and 7 - g + 8 i (the same
  // work in every warp)
  const int n = 32 * (warp % L::kChannelWarps) + lane;
  const int g = warp / L::kChannelWarps;
  const float un = uS[n];
  float du_acc = 0.f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int len = min(C, T_len - c * C);
    const size_t row0 = base + static_cast<size_t>(c) * C * N;
    cp_async_wait_all();
    __syncthreads();
    convert(len, true);
    if (tid < N) {
      // the channel's running products, from the raw chunk: Tl_t k_t
      // ([N][kKt]), Hd_t, Hd_t r_t and Hd_{t0+C}
      float b = 1.f;
      for (int t = C - 1; t >= 0; --t) {
        const bool in = t < len;
        Kt[tid * kKt + t] = in ? b * to_float(raw_k[t * N + tid]) : 0.f;
        b *= in ? raw_w[t * N + tid] : 1.f;
      }
      float hd = 1.f;
      for (int x = 0; x < C; ++x) {
        const bool in = x < len;
        HdT[x * N + tid] = hd;
        Rt[x * kP + tid] = in ? hd * to_float(raw_r[x * N + tid]) : 0.f;
        hd *= in ? raw_w[x * N + tid] : 1.f;
      }
      HdC[tid] = hd;
    }
    __syncthreads();
    if (c > 0) fetch(c - 1, true);

    // II: P_t = S_prev do_t, Q_t = G v_t ([C][N]) and Zv_t = G^T (Tl_t
    // k_t) ([C][N]), (N / 16) x (C / 8) tiles each, and A (and A^T, [C][C]),
    // (C / 16) x (C / 8) tiles; the last warps Gamma and sum_n r u k
    constexpr int kTilesPQ = (N / 16) * (C / 8);
    for (int tile = warp; tile < 3 * kTilesPQ + (C / 16) * (C / 8);
         tile += NW) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      if (tile >= 3 * kTilesPQ) {
        const int i = tile - 3 * kTilesPQ;
        const int s0 = 16 * (i % (C / 16)), x0 = 8 * (i / (C / 16));
        mma_tile<N>(
            d, [&](int row, int kk) { return fv[(s0 + row) * kP + kk]; },
            [&](int kk, int col) { return fd[(x0 + col) * kP + kk]; }, lane);
        store_tile(d, [&](int row, int col, float x) {
          Am[(s0 + row) * C + x0 + col] = x;
          AmT[(x0 + col) * C + s0 + row] = x;
        }, lane);
        continue;
      }
      const int which = tile / kTilesPQ, i = tile % kTilesPQ;
      const int r0 = 16 * (i % (N / 16)), t0 = 8 * (i / (N / 16));
      if (which == 0) {
        mma_tile<N>(
            d, [&](int row, int kk) { return S[(r0 + row) * kP + kk]; },
            [&](int kk, int col) { return fd[(t0 + col) * kP + kk]; }, lane);
      } else if (which == 1) {
        mma_tile<N>(
            d, [&](int row, int kk) { return G[(r0 + row) * kP + kk]; },
            [&](int kk, int col) { return fv[(t0 + col) * kP + kk]; }, lane);
      } else {
        mma_tile<N>(
            d, [&](int row, int kk) { return G[kk * kP + r0 + row]; },
            [&](int kk, int col) { return Kt[kk * kKt + t0 + col]; }, lane);
      }
      float* out = which == 0 ? Pm : which == 1 ? Qm : Zm;
      store_tile(d, [&](int row, int col, float x) {
        out[(t0 + col) * N + r0 + row] = x;
      }, lane);
    }
    if (tid >= NT - N) {
      const int nn = tid - (NT - N);
      float gam = 0.f;
#pragma unroll 4
      for (int m = 0; m < N; m += 4)
        gam = dot4(load4(G + nn * kP + m), load4(S + nn * kP + m), gam);
      Gam[nn] = gam;
    } else if (tid >= NT - N - C) {
      const int t = tid - (NT - N - C);
      float acc = 0.f;
#pragma unroll 4
      for (int m = 0; m < N; ++m)
        acc = fmaf(fr[t * kP + m] * uS[m], fk[t * kP + m], acc);
      Ruk[t] = acc;
    }
    __syncthreads();
    // S_prev is read: the next chunk's may land
    if (c > 0) fetch_state(c - 1);

    // III: the walk, then G's update
    {
      const float gam = Gam[n];
      float* mw = Mm + (warp % L::kChannelWarps) * C * C;
#pragma unroll 1
      for (int it = 0; it < C / 4; ++it) {
        const int t = 8 * (it / 2) + (it % 2 == 0 ? g : 7 - g);
        walk_step<N>(t, n, lane, un, gam, fr, fk, fw, Am, AmT, Pm, Qm,
                        HdT[t * N + n], t < len, dr, dk, dw,
                        row0 + static_cast<size_t>(t) * N + n, mw, du_acc);
      }
      // G <- Hd_{t0+C} G + sum_x (Hd_x r_x) do_x^T
#pragma unroll 1
      for (int i = 0; i < kSTiles; ++i) {
        const int tile = warp + NW * i;
        const int n0 = 16 * (tile % (N / 16)), m0 = 8 * (tile / (N / 16));
        float* g0 = G + (n0 + fg) * kP + m0 + 2 * fq;
        float* g1 = g0 + 8 * kP;
        const float h0 = HdC[n0 + fg], h1 = HdC[n0 + fg + 8];
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tile<C>(
            d, [&](int row, int kk) { return Rt[kk * kP + n0 + row]; },
            [&](int kk, int col) { return fd[kk * kP + m0 + col]; }, lane);
        store2(g0, fmaf(h0, g0[0], d[0]), fmaf(h0, g0[1], d[1]));
        store2(g1, fmaf(h1, g1[0], d[2]), fmaf(h1, g1[1], d[3]));
      }
    }
    __syncthreads();

    // IV: dv_t = Zv_t + (sum_n r_t u k_t) do_t + sum_{x>t} M[t][x] do_x,
    // (C / 16) x (N / 8) tiles
    for (int tile = warp; tile < (C / 16) * (N / 8); tile += NW) {
      const int t0 = 16 * (tile % (C / 16)), m0 = 8 * (tile / (C / 16));
      float d[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t0 + fg + 8 * (j / 2), m = m0 + 2 * fq + j % 2;
        d[j] = fmaf(Ruk[t], fd[t * kP + m], Zm[t * N + m]);
      }
      mma_tile<C>(
          d,
          [&](int row, int kk) {
            float mx = 0.f;
#pragma unroll
            for (int wi = 0; wi < L::kChannelWarps; ++wi)
              mx += Mm[wi * C * C + (t0 + row) * C + kk];
            return mx;
          },
          [&](int kk, int col) { return fd[kk * kP + m0 + col]; }, lane);
      const int ta = t0 + fg, tb = ta + 8;
      if (ta < len)
        store2(dv + row0 + static_cast<size_t>(ta) * N + m0 + 2 * fq, d[0],
               d[1]);
      if (tb < len)
        store2(dv + row0 + static_cast<size_t>(tb) * N + m0 + 2 * fq, d[2],
               d[3]);
    }
  }
  // du: each channel's four partials (one a group of steps), in order
  Du[g * N + n] = du_acc;
  __syncthreads();
  if (tid < N)
    du_part[static_cast<size_t>(bh) * N + tid] =
        ((Du[tid] + Du[N + tid]) + Du[2 * N + tid]) + Du[3 * N + tid];
}

template <typename T, int N>
cudaError_t launch_n(const void* r, const void* k, const void* v,
                     const void* w, const void* u, const void* dout,
                     const void* ds, void* dr, void* dk, void* dv, void* dw,
                     void* du_part, void* s_buf, int B, int H, int steps,
                     cudaStream_t stream) {
  using L = Layout<T, N>;
  auto kernel = wkv6_bwd_chunk_kernel<T, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<B * H, L::kThreads, L::kSmemBytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const T*>(dout),
      static_cast<const float*>(ds), static_cast<T*>(dr),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(dw),
      static_cast<float*>(du_part), static_cast<float*>(s_buf), H, steps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* dout, const void* ds, void* dr,
                   void* dk, void* dv, void* dw, void* du_part, void* s_buf,
                   int B, int H, int steps, int N, cudaStream_t stream) {
  switch (N) {
    case 32:
      return launch_n<T, 32>(r, k, v, w, u, dout, ds, dr, dk, dv, dw,
                             du_part, s_buf, B, H, steps, stream);
    case 64:
      return launch_n<T, 64>(r, k, v, w, u, dout, ds, dr, dk, dv, dw,
                             du_part, s_buf, B, H, steps, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The steps of a chunk: the wrapper's scratch holds (T / chunk - 1) states
// of N x N floats a (b, h), rounded up.
int wkv6_backward_chunk() { return kChunk; }

// dtype of r, k, v, do, dr, dk, dv: 0 = float32, 1 = bfloat16.  ds (the
// final state's gradient, (B, H, N, N) float32) may be null.  s_buf is a
// float32 scratch of B H (ceil(T / chunk) - 1) N N states.  Returns the
// launch's CUDA error code.
int wkv6_backward(const void* r, const void* k, const void* v, const void* w,
                  const void* u, const void* dout, const void* ds, void* dr,
                  void* dk, void* dv, void* dw, void* du_part, void* s_buf,
                  int dtype, int B, int H, int T, int N, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(launch<float>(r, k, v, w, u, dout, ds, dr, dk,
                                          dv, dw, du_part, s_buf, B, H, T, N,
                                          s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(r, k, v, w, u, dout, ds,
                                                  dr, dk, dv, dw, du_part,
                                                  s_buf, B, H, T, N, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
