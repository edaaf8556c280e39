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
// that sees no key gives 0.
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

// float32 at each head dim the wrapper takes
cudaError_t launch_f32(int D, const void* q, const void* k, const void* v,
                       const void* lengths, void* out, int B, int H, int KH,
                       int Sq, int Sk, int mode, int window, int q_offset,
                       float scale, cudaStream_t s) {
  switch (D) {
    case 32: return launch<float, 32>(q, k, v, lengths, out, B, H, KH, Sq,
                                      Sk, mode, window, q_offset, scale, s);
    case 64: return launch<float, 64>(q, k, v, lengths, out, B, H, KH, Sq,
                                      Sk, mode, window, q_offset, scale, s);
    case 96: return launch<float, 96>(q, k, v, lengths, out, B, H, KH, Sq,
                                      Sk, mode, window, q_offset, scale, s);
    case 128: return launch<float, 128>(q, k, v, lengths, out, B, H, KH, Sq,
                                        Sk, mode, window, q_offset, scale, s);
    case 256: return launch<float, 256>(q, k, v, lengths, out, B, H, KH, Sq,
                                        Sk, mode, window, q_offset, scale, s);
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
// a wait on an mbarrier that outlasts this many cycles (~9 s) traps, so a
// pipeline fault ends the launch with an error instead of hanging the card
constexpr long long kWatchdogCycles = 1ll << 34;

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > kWatchdogCycles) {
      __trap();
    }
  }
}

// TMA: the box at (c0, c1, c2) of `map` into shared memory at dst; its
// bytes complete a transaction on `bar`
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (all >> 4), and in bits 62-63 the swizzle that TMA wrote into
// rows of `pitch` bytes: layout type 1 (128-byte swizzle) for 128-byte
// rows, 2 (64-byte swizzle) for 64-byte rows
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int pitch) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(pitch == 128 ? 1 : 2) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WGMMA_O4(d, i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WGMMA_O16(d, i) \
  WGMMA_O4(d, i), WGMMA_O4(d, i + 4), WGMMA_O4(d, i + 8), WGMMA_O4(d, i + 12)
#define WGMMA_O32(d, i) WGMMA_O16(d, i), WGMMA_O16(d, i + 16)
#define WGMMA_OUT32(d) WGMMA_O32(d, 0)
#define WGMMA_OUT48(d) WGMMA_O32(d, 0), WGMMA_O16(d, 32)
#define WGMMA_OUT64(d) WGMMA_O32(d, 0), WGMMA_O32(d, 32)
#define WGMMA_OUT128(d) \
  WGMMA_O32(d, 0), WGMMA_O32(d, 32), WGMMA_O32(d, 64), WGMMA_O32(d, 96)

// m64nNk16, bf16 in, float32 accumulators (N / 2 a thread).  _ss: A and B
// from shared-memory descriptors, both K-major; scale_d = 0 overwrites d.
// _rs: A from registers (4 x bf16x2 a thread), B transposed (MN-major).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_OUT32(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_OUT64(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : WGMMA_OUT48(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WGMMA_OUT64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : WGMMA_OUT128(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int N>
struct Wgmma;
template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
    wgmma_ss_n64(d, a, b, scale_d);
  }
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    wgmma_rs_n64(d, a, b);
  }
};
template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void rs(float (&d)[48],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    wgmma_rs_n96(d, a, b);
  }
};
template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int scale_d) {
    wgmma_ss_n128(d, a, b, scale_d);
  }
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    wgmma_rs_n128(d, a, b);
  }
};
template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void rs(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    wgmma_rs_n256(d, a, b);
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

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
                   __nv_bfloat16* __restrict__ out, int H, int KH, int Sq,
                   int Sk, int mode, int window, int q_offset,
                   float scale_log2) {
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
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the library
// does not link libcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a 3-D map over `mats` contiguous (rows, d) bf16 matrices, boxes of
// (box_rows, box_cols) with 64 columns under a 128-byte swizzle or 32 under
// a 64-byte one; out-of-bounds boxes read zeros
bool encode_map(CUtensorMap* map, const void* base, int d, int rows, int mats,
                int box_rows, int box_cols) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)mats};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const void* lengths, void* out, int B, int H, int KH,
                         int Sq, int Sk, int mode, int window, int q_offset,
                         float scale, cudaStream_t stream) {
  using G = TcTile<D>;
  if (Sk == 0)   // no key: every row gives 0
    return cudaMemsetAsync(out, 0, (size_t)B * H * Sq * D * 2, stream);
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
      static_cast<__nv_bfloat16*>(out), H, KH, Sq, Sk, mode, window, q_offset,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The CUDA-core kernel: dtype 0 = float32 at D = 32, 64, 96, 128 or 256,
// 1 = bfloat16 at D = 32 (the tensor-core kernel takes bfloat16 at the
// others).  Returns the launch's CUDA error code.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* lengths, void* out, int dtype, int B,
                        int H, int KH, int Sq, int Sk, int D, int mode,
                        int window, int q_offset, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KH <= 0 || H % KH != 0 || mode < kCausal || mode > kFull)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(launch_f32(D, q, k, v, lengths, out, B, H, KH,
                                       Sq, Sk, mode, window, q_offset, scale,
                                       s));
  if (dtype == 1 && D == 32)
    return static_cast<int>(launch<__nv_bfloat16, 32>(
        q, k, v, lengths, out, B, H, KH, Sq, Sk, mode, window, q_offset,
        scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core kernel: bfloat16 q, k, v at D = 64, 96, 128 or 256, each
// 16-byte aligned.  Returns the launch's CUDA error code.
int flash_attention_wgmma_fwd(const void* q, const void* k, const void* v,
                              const void* lengths, void* out, int B, int H,
                              int KH, int Sq, int Sk, int D, int mode,
                              int window, int q_offset, float scale,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KH <= 0 || H % KH != 0 || mode < kCausal || mode > kFull)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64: return static_cast<int>(launch_wgmma<64>(
        q, k, v, lengths, out, B, H, KH, Sq, Sk, mode, window, q_offset,
        scale, s));
    case 96: return static_cast<int>(launch_wgmma<96>(
        q, k, v, lengths, out, B, H, KH, Sq, Sk, mode, window, q_offset,
        scale, s));
    case 128: return static_cast<int>(launch_wgmma<128>(
        q, k, v, lengths, out, B, H, KH, Sq, Sk, mode, window, q_offset,
        scale, s));
    case 256: return static_cast<int>(launch_wgmma<256>(
        q, k, v, lengths, out, B, H, KH, Sq, Sk, mode, window, q_offset,
        scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
