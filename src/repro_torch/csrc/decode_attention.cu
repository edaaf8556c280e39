// Flash-decode partial for Hopper (sm_90a): one query token per (b, h)
// against one shard of a KV cache, split over thread blocks.
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
// Bound: bytes — the visible K and V rows, q and the outputs, over the
// card's memory bandwidth (3.35 TB/s on an H100 SXM).  The arithmetic is at
// most 8 FMAs per byte of bf16 cache (G = 16 query heads on a KV head of
// 256), so it stays in float32 on the CUDA cores: the partial is held at
// the float32 limit in both types, which bf16 P on the tensor cores would
// miss.
//
// The TPU kernel walks the cache along a sequential grid axis, one query
// head at a time.  Blocks on Hopper run in parallel, so two kernels:
//
// decode_split_kernel, grid (split, KH x head blocks, B): the shard's rows
// are cut into splits of `rows` rows (a multiple of 32, chosen by the
// wrapper from B, KH and S alone, never from the lengths on the card), and
// a block computes the partial of up to kHeadsPerBlock = 16 query heads of
// one KV head over the visible rows of its split, so K and V are read from
// device memory once for all of them (the old kernel re-read a KV head's
// rows once per chunk of 4 query heads, and streamed a whole sequence from
// one block: 128 blocks for 132 SMs at B 16, KH 8, with the longest row
// setting the time).  A block whose split holds no visible row returns at
// once and writes nothing.  One producer warp keeps a ring of kStages
// shared-memory tiles filled by 1-D bulk asynchronous copies (the rows of a
// split are contiguous; each copy completes on an mbarrier, and a wait that
// stalls past ~2^34 cycles traps instead of hanging the card).  Eight
// consumer warps read the tiles with the block's query heads spread over
// them, HPW heads a warp (so registers hold only HPW heads' q and acc), and
// the rows spread over the warps that share heads, KPW rows at a time.  A
// lane holds D/32 elements of a row and dots them with its slice of each
// of its heads; one transposing butterfly sums the KPW x HPW dot products
// over the warp (about 2 shuffles per score where a butterfly per score
// takes 5) and leaves every lane the scores.  Each warp keeps its own
// online softmax, in base 2 (q is scaled by scale * log2 e), and the
// warps of a head merge through shared memory at the end.  The
// partials go to a float32 scratch (B, H, n_split, D + 2) — acc, then m,
// then l.
//
// decode_combine_kernel, grid (B * H, D / cols), cols 64 (32 at head dims
// 32 and 96): merges the splits that hold visible
// rows by the flash-decoding identity, m = max m_s, l = sum l_s 2^(m_s - m),
// acc = sum acc_s 2^(m_s - m), and writes m back in natural units; a row
// with no visible row writes the idle partial without reading the scratch.
// Its threads read the splits' m and l side by side and put the weights in
// shared memory; then each of a block's columns of acc is summed by 4
// threads (8 at 32 columns), each over a quarter of the splits with its loads in
// flight together, so no thread walks the splits one round trip at a time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * (kConsumerWarps + 1);   // + one producer warp
constexpr int kStages = 4;            // shared-memory ring depth
constexpr int KPW = 4;                // rows a warp scores together
constexpr int kHeadsPerBlock = 16;    // query heads a split block serves
constexpr int kSplitQuantum = 32;     // rows per split is a multiple of this
constexpr int kCombineThreads = 256;
constexpr int kCombineCols = 64;      // columns of acc a combine block sums

// The columns of acc a combine block sums: 64, or 32 where 64 does not
// divide D (D is a multiple of 32), so the D / cols blocks cover every
// column (head dim 96 takes three blocks of 32).
__host__ __device__ constexpr int combine_cols(int D) {
  return D % kCombineCols == 0 ? kCombineCols : 32;
}
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// a wait on an mbarrier that outlasts this many cycles (~9 s) traps, so a
// pipeline fault ends the launch with an error instead of hanging the card
constexpr long long kWatchdogCycles = 1ll << 34;

// The largest power of two <= n (n >= 1).
constexpr int floor_pow2(int n) { return n < 2 ? 1 : 2 * floor_pow2(n / 2); }

// The shared-memory tile: kRows cache rows of K and of V per ring stage,
// at most 8 KB each; kRows is a power of two, so it divides kSplitQuantum
// (float32 at head dim 96 fits 21 rows in 8 KB and takes 16).
template <typename T, int D>
struct Tile {
  static constexpr int kRowBytes = D * (int)sizeof(T);
  static constexpr int kRows = floor_pow2(8192 / kRowBytes < kSplitQuantum
                                              ? 8192 / kRowBytes
                                              : kSplitQuantum);
  static constexpr int kBytes = kRows * kRowBytes;
  static constexpr int kBarOffset = 2 * kStages * kBytes;     // K ring, V ring
  static constexpr int kSmemBytes = kBarOffset + 16 * kStages;
  static_assert(kSplitQuantum % kRows == 0, "a tile must divide a split");
  // the warps' partials reuse the ring at the end
  static_assert(kConsumerWarps * 4 * (D + 2) * 4 <= kBarOffset,
                "merge scratch past the ring");
  static_assert(kRows % KPW == 0, "a tile holds whole row steps");
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

// a 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global memory into shared memory at dst, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

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

__device__ __forceinline__ void unpack_bf16x2(uint32_t w, float* o) {
  o[0] = __uint_as_float(w << 16);
  o[1] = __uint_as_float(w & 0xffff0000u);
}

template <int N>
__device__ __forceinline__ void load_n(const __nv_bfloat16* p, float* o) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      const uint4 x = *reinterpret_cast<const uint4*>(p + i);
      unpack_bf16x2(x.x, o + i);
      unpack_bf16x2(x.y, o + i + 2);
      unpack_bf16x2(x.z, o + i + 4);
      unpack_bf16x2(x.w, o + i + 6);
    }
  } else if constexpr (N == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    unpack_bf16x2(x.x, o);
    unpack_bf16x2(x.y, o + 2);
  } else if constexpr (N == 2) {
    unpack_bf16x2(*reinterpret_cast<const uint32_t*>(p), o);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = __bfloat162float(p[i]);
  }
}

// Sums each of the N values (N a power of two, <= 32) over the warp and
// leaves every lane all N sums.  The first log2 N butterfly steps each
// send half of a lane's values and keep the other half, so lane L ends
// with the sum of value L >> (5 - log2 N) after N - 1 + 5 - log2 N
// shuffles (a butterfly per value would take 5 N); N more broadcast them.
template <int N>
__device__ __forceinline__ void warp_sum_all(float (&v)[N]) {
  constexpr int kLog = N >= 32 ? 5 : N >= 16 ? 4 : N >= 8 ? 3 : N >= 4 ? 2
                       : N >= 2 ? 1 : 0;
  static_assert((1 << kLog) == N, "N must be a power of two <= 32");
  const int lane = threadIdx.x % 32;
  float x[N];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = v[i];
#pragma unroll
  for (int step = 0; step < kLog; ++step) {
    const int o = 16 >> step, half = N >> (step + 1);
    const bool hi = lane & o;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = hi ? x[i] : x[i + half];
      const float keep = hi ? x[i + half] : x[i];
      x[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
#pragma unroll
  for (int o = 16 >> kLog; o > 0; o >>= 1)
    x[0] += __shfl_xor_sync(0xffffffffu, x[0], o);
#pragma unroll
  for (int i = 0; i < N; ++i)
    v[i] = __shfl_sync(0xffffffffu, x[0], i << (5 - kLog));
}

// this shard's visible rows [*j_lo, *j_hi) of row b (empty if j_hi <= j_lo)
__device__ __forceinline__ void visible_rows(int len, int S, int window,
                                             int kpos_offset, int* j_lo,
                                             int* j_hi) {
  const int lo = window > 0 ? len - window : 0;
  *j_lo = max(0, lo - kpos_offset);
  *j_hi = min(S, len - kpos_offset);
}

template <typename T, int D, int HPW>
__global__ void __launch_bounds__(kThreads, 2)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ part, int H, int KH, int S, int rows,
                    int n_split, int head_blocks, int window,
                    int kpos_offset, float scale_log2) {
  using Tl = Tile<T, D>;
  constexpr int EPL = D / 32;                      // row elements per lane
  extern __shared__ __align__(128) unsigned char smem[];

  const int kvh = blockIdx.y / head_blocks;
  const int g0 = (blockIdx.y % head_blocks) * kHeadsPerBlock;
  const int b = blockIdx.z;
  const int G = H / KH;
  const int gn = min(kHeadsPerBlock, G - g0);      // this block's heads
  int j_lo, j_hi;
  visible_rows(lengths[b], S, window, kpos_offset, &j_lo, &j_hi);
  // with a window the grid covers only the splits a window can reach,
  // counted from the first visible one
  const int split = blockIdx.x + (window > 0 ? max(j_lo, 0) / rows : 0);
  j_lo = max(j_lo, split * rows);
  j_hi = min(j_hi, split * rows + rows);
  if (j_hi <= j_lo) return;                        // the combine skips it
  const int n_tiles = (j_hi - j_lo + Tl::kRows - 1) / Tl::kRows;

  const uint32_t ring = smem_u32(smem);
  const uint32_t full = ring + Tl::kBarOffset;     // [kStages], 8 bytes each
  const uint32_t empty = full + 8 * kStages;       // [kStages]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warps' heads: chunks of HPW, the rows spread over the row groups
  const int hc_count = (gn + HPW - 1) / HPW;       // <= kConsumerWarps
  const int rg_count = kConsumerWarps / hc_count;
  const int hc = warp % hc_count, rg = warp / hc_count;
  float m[HPW], l[HPW], acc[HPW][EPL];
#pragma unroll
  for (int e = 0; e < HPW; ++e) {
    m[e] = kNegInf;
    l[e] = 0.f;
#pragma unroll
    for (int x = 0; x < EPL; ++x) acc[e][x] = 0.f;
  }

  if (warp == kConsumerWarps) {
    // ---- producer: one lane issues every copy ----
    if (lane == 0) {
      const T* kp = k + ((size_t)b * KH + kvh) * S * D;
      const T* vp = v + ((size_t)b * KH + kvh) * S * D;
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(empty + 8 * st, ((i / kStages) & 1) ^ 1);
        const int r0 = j_lo + i * Tl::kRows;
        const uint32_t bytes = min(Tl::kRows, j_hi - r0) * Tl::kRowBytes;
        mbar_expect_tx(full + 8 * st, 2 * bytes);
        bulk_load(ring + st * Tl::kBytes, kp + (size_t)r0 * D, bytes,
                  full + 8 * st);
        bulk_load(ring + (kStages + st) * Tl::kBytes, vp + (size_t)r0 * D,
                  bytes, full + 8 * st);
      }
    }
  } else {
    // ---- consumers ----
    const bool active = rg < rg_count;
    float qr[HPW][EPL];
#pragma unroll
    for (int e = 0; e < HPW; ++e) {
      const int g = hc * HPW + e;
      float x[EPL];
      if (active && g < gn) {
        load_n<EPL>(q + ((size_t)b * H + (size_t)kvh * G + g0 + g) * D +
                        lane * EPL, x);
      } else {
#pragma unroll
        for (int i = 0; i < EPL; ++i) x[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < EPL; ++i) qr[e][i] = x[i] * scale_log2;
    }

    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      mbar_wait(full + 8 * st, (i / kStages) & 1);
      const int nr = min(Tl::kRows, j_hi - (j_lo + i * Tl::kRows));
      const T* ks = reinterpret_cast<const T*>(smem + st * Tl::kBytes);
      const T* vs =
          reinterpret_cast<const T*>(smem + (kStages + st) * Tl::kBytes);
      for (int r0 = rg * KPW; active && r0 < nr; r0 += rg_count * KPW) {
        float s[KPW * HPW];              // s[ii * HPW + e]
#pragma unroll
        for (int ii = 0; ii < KPW; ++ii) {
          float kf[EPL];
          if (r0 + ii < nr) {
            load_n<EPL>(ks + (r0 + ii) * D + lane * EPL, kf);
          } else {
#pragma unroll
            for (int x = 0; x < EPL; ++x) kf[x] = 0.f;
          }
#pragma unroll
          for (int e = 0; e < HPW; ++e) {
            float dot = 0.f;
#pragma unroll
            for (int x = 0; x < EPL; ++x) dot = fmaf(qr[e][x], kf[x], dot);
            s[ii * HPW + e] = dot;
          }
        }
        warp_sum_all<KPW * HPW>(s);
#pragma unroll
        for (int e = 0; e < HPW; ++e) {
          float mx = kNegInf;
#pragma unroll
          for (int ii = 0; ii < KPW; ++ii) {
            if (r0 + ii >= nr) s[ii * HPW + e] = kNegInf;
            mx = fmaxf(mx, s[ii * HPW + e]);
          }
          const float m_new = fmaxf(m[e], mx);
          const float alpha = exp2f(m[e] - m_new);
          l[e] *= alpha;
#pragma unroll
          for (int x = 0; x < EPL; ++x) acc[e][x] *= alpha;
          m[e] = m_new;
        }
#pragma unroll
        for (int ii = 0; ii < KPW; ++ii) {
          if (r0 + ii < nr) {
            float vf[EPL];
            load_n<EPL>(vs + (r0 + ii) * D + lane * EPL, vf);
#pragma unroll
            for (int e = 0; e < HPW; ++e) {
              const float p = exp2f(s[ii * HPW + e] - m[e]);
              l[e] += p;
#pragma unroll
              for (int x = 0; x < EPL; ++x)
                acc[e][x] = fmaf(p, vf[x], acc[e][x]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }
  }

  // merge the row groups' partials of each head through shared memory (the
  // ring is free: every copy landed and every tile was read)
  __syncthreads();
  float* w_acc = reinterpret_cast<float*>(smem);   // [warp][HPW][D]
  float* w_m = w_acc + kConsumerWarps * HPW * D;   // [warp][HPW]
  float* w_l = w_m + kConsumerWarps * HPW;
  if (warp < kConsumerWarps) {
#pragma unroll
    for (int e = 0; e < HPW; ++e) {
#pragma unroll
      for (int x = 0; x < EPL; ++x)
        w_acc[(warp * HPW + e) * D + lane * EPL + x] = acc[e][x];
      if (lane == 0) {
        w_m[warp * HPW + e] = m[e];
        w_l[warp * HPW + e] = l[e];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < gn * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;    // head g = hc * HPW + e lives in
    float mm = kNegInf;                     // slot g of row group r's warps
    for (int r = 0; r < rg_count; ++r)
      mm = fmaxf(mm, w_m[r * hc_count * HPW + g]);
    float a = 0.f, ll = 0.f;
    for (int r = 0; r < rg_count; ++r) {
      const int w = r * hc_count * HPW + g;
      const float f = exp2f(w_m[w] - mm);
      a = fmaf(w_acc[w * D + d], f, a);
      ll = fmaf(w_l[w], f, ll);
    }
    const size_t h = (size_t)b * H + (size_t)kvh * G + g0 + g;
    float* out = part + (h * n_split + split) * (D + 2);
    out[d] = a;
    if (d == 0) {
      out[D] = mm;
      out[D + 1] = ll;
    }
  }
}

template <typename Op>
__device__ __forceinline__ float block_reduce(float x, Op op, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = op(x, __shfl_xor_sync(0xffffffffu, x, o));
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = x;
  __syncthreads();
  x = scratch[0];
  for (int w = 1; w < kCombineThreads / 32; ++w) x = op(x, scratch[w]);
  __syncthreads();
  return x;
}

__global__ void __launch_bounds__(kCombineThreads)
decode_combine_kernel(const float* __restrict__ part,
                      const int* __restrict__ lengths,
                      float* __restrict__ acc_out, float* __restrict__ m_out,
                      float* __restrict__ l_out, int H, int S, int D,
                      int rows, int n_split, int window, int kpos_offset) {
  __shared__ float f[kCombineThreads];       // a chunk of splits' weights
  __shared__ float sums[kCombineThreads];
  __shared__ float scratch[kCombineThreads / 32];
  const int bh = blockIdx.x, b = bh / H, tid = threadIdx.x;
  // this block's columns, and the thread's group of splits
  const int cols = combine_cols(D), groups = kCombineThreads / cols;
  const int col = blockIdx.y * cols + tid % cols, grp = tid / cols;
  const bool first = blockIdx.y == 0 && tid == 0;   // writes m and l
  int j_lo, j_hi;
  visible_rows(lengths[b], S, window, kpos_offset, &j_lo, &j_hi);
  float* acc = acc_out + (size_t)bh * D;
  if (j_hi <= j_lo) {                 // no visible row: the idle partial
    if (grp == 0) acc[col] = 0.f;
    if (first) {
      m_out[bh] = kNegInf;
      l_out[bh] = 0.f;
    }
    return;
  }
  // the splits with visible rows, each (acc[D], m, l)
  const int s_lo = j_lo / rows, n_vis = (j_hi - 1) / rows - s_lo + 1;
  const float* p = part + ((size_t)bh * n_split + s_lo) * (D + 2);
  float mm = kNegInf;
  for (int i = tid; i < n_vis; i += kCombineThreads)
    mm = fmaxf(mm, p[(size_t)i * (D + 2) + D]);
  mm = block_reduce(mm, [](float x, float y) { return fmaxf(x, y); },
                    scratch);
  // the splits' weights 2^(m_s - m), a chunk at a time in shared memory;
  // the thread sums its column over its group's splits, loads in flight
  // together, and the groups' sums add up at the end
  float a = 0.f, ll = 0.f;
  for (int c0 = 0; c0 < n_vis; c0 += kCombineThreads) {
    const int i = c0 + tid;
    float fi = 0.f;
    if (i < n_vis) {
      const float* ps = p + (size_t)i * (D + 2);
      fi = exp2f(ps[D] - mm);
      ll = fmaf(ps[D + 1], fi, ll);
    }
    f[tid] = fi;
    __syncthreads();
    const int n = min(kCombineThreads, n_vis - c0);
    const float* pc = p + (size_t)c0 * (D + 2) + col;
#pragma unroll 4
    for (int j = grp; j < n; j += groups)
      a = fmaf(pc[(size_t)j * (D + 2)], f[j], a);
    __syncthreads();
  }
  sums[tid] = a;
  ll = block_reduce(ll, [](float x, float y) { return x + y; }, scratch);
  if (grp == 0) {
    for (int g = 1; g < groups; ++g) a += sums[g * cols + tid];
    acc[col] = a;
  }
  if (first) {
    m_out[bh] = mm * kLn2;
    l_out[bh] = ll;
  }
}

template <typename T, int D, int HPW>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* part, int B, int H, int KH,
                   int S, int rows, int n_split, int head_blocks, int window,
                   int kpos_offset, float scale, cudaStream_t stream) {
  using Tl = Tile<T, D>;
  auto kernel = decode_split_kernel<T, D, HPW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kSmemBytes);
  if (err != cudaSuccess) return err;
  // a window's rows reach at most window / rows + 1 splits
  const int reach = window > 0 ? min(n_split, (window + rows - 1) / rows + 1)
                               : n_split;
  const dim3 grid(reach, KH * head_blocks, B);
  kernel<<<grid, kThreads, Tl::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<float*>(part), H, KH, S, rows, n_split, head_blocks,
      window, kpos_offset, scale * kLog2e);
  return cudaGetLastError();
}

// heads per warp: all of a block's heads up to 2, else 4 (2 at head dim
// 256, which registers hold at 2 blocks an SM), so a KV row read from
// shared memory serves several heads; 16 heads spread over 4 or 8 warps
template <typename T, int D>
cudaError_t launch_g(const void* q, const void* k, const void* v,
                     const void* lengths, void* part, int B, int H, int KH,
                     int S, int rows, int n_split, int window,
                     int kpos_offset, float scale, cudaStream_t s) {
  const int G = H / KH;
  const int head_blocks = (G + kHeadsPerBlock - 1) / kHeadsPerBlock;
  const int gb = G < kHeadsPerBlock ? G : kHeadsPerBlock;
  if (gb > 2 && D < 256)
    return launch<T, D, 4>(q, k, v, lengths, part, B, H, KH, S, rows,
                           n_split, head_blocks, window, kpos_offset, scale,
                           s);
  if (gb >= 2)
    return launch<T, D, 2>(q, k, v, lengths, part, B, H, KH, S, rows,
                           n_split, head_blocks, window, kpos_offset, scale,
                           s);
  return launch<T, D, 1>(q, k, v, lengths, part, B, H, KH, S, rows, n_split,
                         head_blocks, window, kpos_offset, scale, s);
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const void* lengths, void* part, int B, int H, int KH,
                     int S, int rows, int n_split, int window,
                     int kpos_offset, float scale, cudaStream_t s) {
  switch (D) {
    case 32: return launch_g<T, 32>(q, k, v, lengths, part, B, H, KH, S,
                                    rows, n_split, window, kpos_offset,
                                    scale, s);
    case 64: return launch_g<T, 64>(q, k, v, lengths, part, B, H, KH, S,
                                    rows, n_split, window, kpos_offset,
                                    scale, s);
    case 96: return launch_g<T, 96>(q, k, v, lengths, part, B, H, KH, S,
                                    rows, n_split, window, kpos_offset,
                                    scale, s);
    case 128: return launch_g<T, 128>(q, k, v, lengths, part, B, H, KH, S,
                                      rows, n_split, window, kpos_offset,
                                      scale, s);
    case 256: return launch_g<T, 256>(q, k, v, lengths, part, B, H, KH, S,
                                      rows, n_split, window, kpos_offset,
                                      scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The split pass: every visible split's partial into part (B, H, n_split,
// D + 2) float32.  dtype: 0 = float32, 1 = bfloat16.  Returns the launch's
// CUDA error code.
int decode_split(const void* q, const void* k, const void* v,
                 const void* lengths, void* part, int dtype, int B, int H,
                 int KH, int S, int D, int rows, int n_split, int window,
                 int kpos_offset, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KH <= 0 || H % KH != 0 || rows <= 0 || rows % kSplitQuantum != 0 ||
      (long long)rows * n_split < S)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(launch_d<float>(D, q, k, v, lengths, part, B, H,
                                            KH, S, rows, n_split, window,
                                            kpos_offset, scale, s));
  if (dtype == 1)
    return static_cast<int>(launch_d<__nv_bfloat16>(
        D, q, k, v, lengths, part, B, H, KH, S, rows, n_split, window,
        kpos_offset, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The combine pass: the splits' partials merged into acc (B, H, 1, D), m
// and l (B, H, 1, 1), float32.  Returns the launch's CUDA error code.
int decode_combine(const void* part, const void* lengths, void* acc, void* m,
                   void* l, int B, int H, int S, int D, int rows, int n_split,
                   int window, int kpos_offset, void* stream) {
  if (rows <= 0 || (long long)rows * n_split < S || D % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cols = combine_cols(D);
  decode_combine_kernel<<<dim3(B * H, D / cols), kCombineThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<const int*>(lengths),
      static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), H, S, D, rows, n_split, window, kpos_offset);
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
