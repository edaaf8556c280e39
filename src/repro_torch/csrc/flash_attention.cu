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
// and k < Sk always (the tail tile).  Scores are (q . k) * scale in float32,
// softmax is online over KV tiles (running max m, sum l, accumulator acc in
// float32), and the output is acc / max(l, 1e-30) in q's type — what the
// TPU kernel computes.  A masked score gives p = 0 (the TPU kernel's
// exp(-1e30 - m) is 0 as well once a row has seen a visible key), so a row
// that sees no key gives 0.  Given a non-null float32 `lse` (B, H, Sq),
// both kernels also write each row's log-sum-exp of its scaled scores,
// m + log(max(l, 1e-30)) (-1e30 for a row that sees no key), which the
// backward (flash_attention_bwd.cu) reads; the serving path passes null.
//
// Bound: at prefill shapes, operations — 4 * B * H * Sq * Sk * D times the
// visible fraction, against the card's bf16 tensor-core peak (989 TFLOP/s
// on an H100 SXM).  Two kernels compute it:
//
// flash_wgmma_kernel — bfloat16 at head dims 64, 96, 128 and 256: the
// tensor cores.  One block of three warpgroups per (128-row q tile, h, b),
// the q tiles launched heaviest (last) first.  Warpgroup 0 is the producer:
// after `setmaxnreg` gives its registers to the consumers, one thread
// loads the Q tile once and then K and V tiles of BK keys (128 at D <= 128,
// 64 at D = 256) by TMA (3-D tensor maps over (D, S, B * heads)) into a
// 2-stage ring with full and empty mbarriers; the out-of-bounds fill gives
// the zeros past Sq and Sk.  Q and K arrive as column boxes of 64 columns
// (128-byte rows, 128-byte swizzle), and at D = 96 a last box of 32 columns
// (64-byte rows: one 64-byte swizzle atom), so 96 = 64 + 32 with no column
// padded; V arrives as 64-column boxes where 64 divides D, else as 32-column
// ones (three at D = 96), so that one `wgmma` of N = D reads all of a
// 16-key step.  Warpgroups 1 and 2 each own 64 query rows: S = Q K^T by
// `wgmma` with both operands in shared memory (K-major; each 16-column step
// reads its box with that box's swizzle), the scale (times log2 e) applied
// to S in float32, the mask only on tiles that straddle a mask edge, the
// online softmax in registers (row max over the quad by two shuffles, l
// summed per thread from the float32 p and over the quad at the end), O
// rescaled by alpha, then O += P V by `wgmma` with P converted to bf16 in
// place as the register A operand and V read transposed (MN-major) from
// shared memory.  Both walk the same KV tiles — the tiles that hold a
// visible key for some row of the block (the TPU kernel's block skip, as a
// loop range) — and release each stage to the producer.
//
// flash_fwd_kernel — float32 (which the tensor cores' TF32 would round past
// the 2e-5 tolerance) and bfloat16 at head dim 32 (which no arch uses at
// full size): CUDA-core float32 FMAs.  One block (256 threads) per (q-tile
// of BQ rows, h, b) stages its Q tile (pre-scaled, float32) in shared
// memory once, then each visible K/V tile as float32;
// the BQ x BK scores come from a 16 x 16 thread grid (each thread a RQ x RK
// register tile), one warp per row does the online-softmax update, and
// each thread keeps a RQ x RD slice of the output accumulator in
// registers.  Rows are padded by one float so that the column-wise
// shared-memory reads do not conflict.  Bound in practice by shared-memory
// loads (67 TFLOP/s float32 peak), far above the tensor-core bound.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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

// the KV range [k_lo, k_hi) that holds a visible key for some query row in
// [q0, q_last] (the TPU kernel's block skip)
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ lengths,
                 T* __restrict__ out, float* __restrict__ lse, int H, int KH,
                 int Sq, int Sk, int mode, int window, int q_offset,
                 float scale) {
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

  int k_lo, k_hi;
  key_range(mode, q0, min(q0 + G::BQ, Sq) - 1, len, window, q_offset, Sk,
            &k_lo, &k_hi);

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
  // the backward's log-sum-exp, m + log(max(l, 1e-30)); a row that saw no
  // key keeps m = -1e30, and so lse = -1e30
  if (lse != nullptr)
    for (int row = tid; row < G::BQ && q0 + row < Sq; row += kThreads)
      lse[(size_t)(b * H + h) * Sq + q0 + row] =
          m_s[row] + logf(fmaxf(l_s[row], 1e-30f));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, void* lse, int B, int H,
                   int KH, int Sq, int Sk, int mode, int window,
                   int q_offset, float scale, cudaStream_t stream) {
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
      static_cast<T*>(out), static_cast<float*>(lse), H, KH, Sq, Sk, mode,
      window, q_offset, scale);
  return cudaGetLastError();
}

// float32 at each head dim the wrapper takes
cudaError_t launch_f32(int D, const void* q, const void* k, const void* v,
                       const void* lengths, void* out, void* lse, int B,
                       int H, int KH, int Sq, int Sk, int mode, int window,
                       int q_offset, float scale, cudaStream_t s) {
  switch (D) {
    case 32: return launch<float, 32>(q, k, v, lengths, out, lse, B, H,
                                      KH, Sq, Sk, mode, window, q_offset,
                                      scale, s);
    case 64: return launch<float, 64>(q, k, v, lengths, out, lse, B, H,
                                      KH, Sq, Sk, mode, window, q_offset,
                                      scale, s);
    case 96: return launch<float, 96>(q, k, v, lengths, out, lse, B, H,
                                      KH, Sq, Sk, mode, window, q_offset,
                                      scale, s);
    case 128: return launch<float, 128>(q, k, v, lengths, out, lse, B, H,
                                      KH, Sq, Sk, mode, window, q_offset,
                                      scale, s);
    case 256: return launch<float, 256>(q, k, v, lengths, out, lse, B, H,
                                      KH, Sq, Sk, mode, window, q_offset,
                                      scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The tensor-core kernel (bfloat16, head dims 64 / 96 / 128 / 256)
// ---------------------------------------------------------------------------

constexpr int kTcBQ = 128;            // query rows per block
constexpr int kTcThreads = 384;       // producer warpgroup + 2 consumers
constexpr int kProducerRegs = 24;     // setmaxnreg: 128 * 24 + 256 * 240
constexpr int kConsumerRegs = 240;    //   fits the SM's 65,536 registers

// The widths of Q's and K's column boxes, left to right: 64 columns
// (128-byte rows, 128-byte swizzle) each, and where 64 does not divide D a
// last box of 32 (64-byte rows, 64-byte swizzle): 96 = 64 + 32.
__host__ __device__ constexpr int box_cols(int D, int c) {
  return c < D / 64 ? 64 : D % 64;
}
__host__ __device__ constexpr int box_cols_sum(int D) {
  int sum = 0;
  for (int c = 0; c < (D + 63) / 64; ++c) sum += box_cols(D, c);
  return sum;
}

template <int D>
struct TcTile {
  static constexpr int BK = D == 256 ? 64 : 128;   // keys per KV tile
  static constexpr int kBoxes = (D + 63) / 64;     // Q's and K's column boxes
  // V's column boxes: 64 columns where 64 divides D, else 32, so that the
  // boxes share one width (and one swizzle) and a single wgmma of N = D
  // steps over them by its leading byte offset
  static constexpr int kVCols = D % 64 == 0 ? 64 : 32;
  static constexpr int kStages = 2;                // K/V ring depth
  static constexpr int kQBytes = kTcBQ * D * 2;
  static constexpr int kKVBytes = BK * D * 2;
  // Q, K ring, V ring, then the mbarriers; + 1 KB to align the base
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  static constexpr size_t kSmemBytes = kBarOffset + 8 * (1 + 3 * kStages)
                                       + 1024;
  static_assert(kSmemBytes <= 232448, "past a block's 227 KB of shared memory");
  static_assert(D % 64 == 0 || D % 64 == 32, "boxes of 64 and 32 columns");
  static_assert(box_cols_sum(D) == D, "the column boxes cover D");
};


// every (q, k) pair with q in [qa, qb] and k in [k0, k0 + bk) visible: the
// tile needs no mask
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

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tq_last,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tk_last,
                   const __grid_constant__ CUtensorMap tv,
                   const int* __restrict__ lengths,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                   int H, int KH, int Sq, int Sk, int mode, int window,
                   int q_offset, float scale_log2) {
  using G = TcTile<D>;
  constexpr int BK = G::BK;
  constexpr int kVPitch = 2 * G::kVCols;        // V's row in a box, bytes
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_k = s_q + G::kQBytes;                  // stage st at
  const uint32_t s_v = s_k + G::kStages * G::kKVBytes;   //   + st * KV
  const uint32_t bars = s_q + G::kBarOffset;
  const uint32_t q_full = bars;                           // 8 bytes each
  const uint32_t k_full = bars + 8;                       // [kStages]
  const uint32_t v_full = k_full + 8 * G::kStages;        // [kStages]
  const uint32_t kv_empty = v_full + 8 * G::kStages;      // [kStages]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTcBQ;    // heaviest first
  const int len = lengths[b];
  int k_lo, k_hi;
  key_range(mode, q0, min(q0 + kTcBQ, Sq) - 1, len, window, q_offset, Sk,
            &k_lo, &k_hi);
  const int t0 = (k_lo / BK) * BK;
  const int n_tiles = k_hi > t0 ? (k_hi - t0 + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < G::kStages; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(kv_empty + 8 * st, 2 * 128);   // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0 && n_tiles > 0) {
      const int qm = b * H + h, kvm = b * KH + h / (H / KH);
      // box c of a tile of R rows starts at c * R * 128 bytes (the boxes
      // before it are 64 columns wide); the last box has its own map
      mbar_expect_tx(q_full, G::kQBytes);
#pragma unroll
      for (int c = 0; c < G::kBoxes; ++c)
        tma_load3(s_q + c * kTcBQ * 128, c + 1 < G::kBoxes ? &tq : &tq_last,
                  q_full, 64 * c, q0, qm);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % G::kStages;
        mbar_wait(kv_empty + 8 * st, ((i / G::kStages) & 1) ^ 1);
        const int k0 = t0 + i * BK;
        mbar_expect_tx(k_full + 8 * st, G::kKVBytes);
#pragma unroll
        for (int c = 0; c < G::kBoxes; ++c)
          tma_load3(s_k + st * G::kKVBytes + c * BK * 128,
                    c + 1 < G::kBoxes ? &tk : &tk_last, k_full + 8 * st,
                    64 * c, k0, kvm);
        mbar_expect_tx(v_full + 8 * st, G::kKVBytes);
#pragma unroll
        for (int c = 0; c < D / G::kVCols; ++c)
          tma_load3(s_v + st * G::kKVBytes + c * BK * kVPitch, &tv,
                    v_full + 8 * st, G::kVCols * c, k0, kvm);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int ct = threadIdx.x - 128;
    const int g = ct / 128, warp = (ct % 128) / 32, lane = ct % 32;
    const int qa = q0 + 64 * g;                 // this warpgroup's rows
    const int row = qa + 16 * warp + lane / 4;  // and row + 8
    const int col = 2 * (lane % 4);             // + 8 j (+ 1)

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    if (n_tiles > 0) mbar_wait(q_full, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % G::kStages;
      const uint32_t parity = (i / G::kStages) & 1;
      const int k0 = t0 + i * BK;
      const uint32_t k_st = s_k + st * G::kKVBytes;
      const uint32_t v_st = s_v + st * G::kKVBytes;

      // S = Q K^T
      float s[BK / 2];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) s[j] = 0.f;
      mbar_wait(k_full + 8 * st, parity);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // 16 columns of box c, whose rows are `pitch` bytes: 8-row groups
        // SBO = 8 * pitch apart, +32 bytes a step within the swizzle atom;
        // this warpgroup's 64 Q rows start 64 rows into Q's box
        const int c = kk / 4, pitch = 2 * box_cols(D, c);
        const uint32_t off = (kk % 4) * 32;
        Wgmma<BK>::ss(s,
                      smem_desc(s_q + c * kTcBQ * 128 + g * 64 * pitch + off,
                                16, 8 * pitch, pitch),
                      smem_desc(k_st + c * BK * 128 + off, 16, 8 * pitch,
                                pitch),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // scale (log2 units), mask on edge tiles, online softmax
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) s[j] *= scale_log2;
      if (!tile_unmasked(mode, qa, qa + 63, k0, BK, len, window, q_offset,
                         Sk)) {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) {
          const int qi = row + ((j % 4) >= 2 ? 8 : 0);
          const int kj = k0 + 8 * (j / 4) + col + (j % 2);
          if (!visible(mode, qi, kj, len, window, q_offset, Sk))
            s[j] = -INFINITY;
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BK / 2; ++j)
        mx[(j % 4) / 2] = fmaxf(mx[(j % 4) / 2], s[j]);
      float alpha[2], base[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        base[r] = mx[r] == -INFINITY ? 0.f : mx[r];   // no key seen yet
        alpha[r] = exp2f(m[r] - base[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        s[j] = exp2f(s[j] - base[(j % 4) / 2]);
        l[(j % 4) / 2] += s[j];
      }
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o[j] *= alpha[(j % 4) / 2];
      uint32_t p[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }

      // O += P V
      mbar_wait(v_full + 8 * st, parity);
      fence_regs(o);
      wgmma_fence();
      // V MN-major: LBO steps from one column box to the next (BK rows of
      // kVPitch bytes), SBO from one 8-key group to the next, and a k-step
      // is 16 keys
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<D>::rs(o, p[kk], smem_desc(v_st + kk * 16 * kVPitch,
                                          BK * kVPitch, 8 * kVPitch,
                                          kVPitch));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      mbar_arrive(kv_empty + 8 * st);
    }

    // acc / max(l, 1e-30), rows past Sq dropped
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
    }
    __nv_bfloat16* op = out + (size_t)(b * H + h) * Sq * D + col;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row + 8 * r;
      if (qi >= Sq) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(op + (size_t)qi * D + 8 * j) =
            pack_bf16(o[4 * j + 2 * r] / l[r], o[4 * j + 2 * r + 1] / l[r]);
    }
    // the backward's log-sum-exp in natural-log units, m ln 2 + log(l); a
    // row that saw no key (m = -inf) gets -1e30, as the CUDA-core kernel
    if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = row + 8 * r;
        if (qi < Sq)
          lse[(size_t)(b * H + h) * Sq + qi] =
              m[r] == -INFINITY ? kNegInf
                                : m[r] * 0.6931471805599453f + logf(l[r]);
      }
    }
  }
}

// lse = -1e30 over n rows (no key: Sk = 0)
__global__ void fill_lse_kernel(float* lse, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    lse[i] = kNegInf;
}


template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const void* lengths, void* out, void* lse, int B,
                         int H, int KH, int Sq, int Sk, int mode, int window,
                         int q_offset, float scale, cudaStream_t stream) {
  using G = TcTile<D>;
  if (Sk == 0) {  // no key: every row gives 0, and its lse is -1e30
    if (lse != nullptr && B * H * Sq > 0) {
      fill_lse_kernel<<<64, 256, 0, stream>>>(static_cast<float*>(lse),
                                              (size_t)B * H * Sq);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    return cudaMemsetAsync(out, 0, (size_t)B * H * Sq * D * 2, stream);
  }
  // Q's and K's 64-column boxes, their last box (its own width), V's boxes;
  // a map that fails to encode fails the call
  constexpr int last = box_cols(D, G::kBoxes - 1);
  CUtensorMap tq, tq_last, tk, tk_last, tv;
  if (!encode_map(&tq, q, D, Sq, B * H, kTcBQ, 64) ||
      !encode_map(&tq_last, q, D, Sq, B * H, kTcBQ, last) ||
      !encode_map(&tk, k, D, Sk, B * KH, G::BK, 64) ||
      !encode_map(&tk_last, k, D, Sk, B * KH, G::BK, last) ||
      !encode_map(&tv, v, D, Sk, B * KH, G::BK, G::kVCols))
    return cudaErrorInvalidValue;
  auto kernel = flash_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)G::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, (Sq + kTcBQ - 1) / kTcBQ);
  kernel<<<grid, kTcThreads, G::kSmemBytes, stream>>>(
      tq, tq_last, tk, tk_last, tv, static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), H, KH, Sq,
      Sk, mode, window, q_offset, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The CUDA-core kernel: dtype 0 = float32 at D = 32, 64, 96, 128 or 256,
// 1 = bfloat16 at D = 32 (the tensor-core kernel takes bfloat16 at the
// others).  Returns the launch's CUDA error code.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* lengths, void* out, void* lse, int dtype,
                        int B, int H, int KH, int Sq, int Sk, int D, int mode,
                        int window, int q_offset, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KH <= 0 || H % KH != 0 || mode < kCausal || mode > kFull)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(launch_f32(D, q, k, v, lengths, out, lse, B, H,
                                       KH, Sq, Sk, mode, window, q_offset,
                                       scale, s));
  if (dtype == 1 && D == 32)
    return static_cast<int>(launch<__nv_bfloat16, 32>(
        q, k, v, lengths, out, lse, B, H, KH, Sq, Sk, mode, window, q_offset,
        scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core kernel: bfloat16 q, k, v at D = 64, 96, 128 or 256, each
// 16-byte aligned.  Returns the launch's CUDA error code.
int flash_attention_wgmma_fwd(const void* q, const void* k, const void* v,
                              const void* lengths, void* out, void* lse,
                              int B, int H, int KH, int Sq, int Sk, int D,
                              int mode, int window, int q_offset, float scale,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KH <= 0 || H % KH != 0 || mode < kCausal || mode > kFull)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64: return static_cast<int>(launch_wgmma<64>(
        q, k, v, lengths, out, lse, B, H, KH, Sq, Sk, mode, window,
        q_offset, scale, s));
    case 96: return static_cast<int>(launch_wgmma<96>(
        q, k, v, lengths, out, lse, B, H, KH, Sq, Sk, mode, window,
        q_offset, scale, s));
    case 128: return static_cast<int>(launch_wgmma<128>(
        q, k, v, lengths, out, lse, B, H, KH, Sq, Sk, mode, window,
        q_offset, scale, s));
    case 256: return static_cast<int>(launch_wgmma<256>(
        q, k, v, lengths, out, lse, B, H, KH, Sq, Sk, mode, window,
        q_offset, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
