// RG-LRU recurrence (Griffin / RecurrentGemma) for Hopper (sm_90a).
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
// decay of a 32-step chunk; these kernels need no such range.)
//
// Bound: bytes — a and u read once, h written once, the final state written
// once, at the card's 3.35 TB/s (two operations per element are nothing
// beside them).  The recurrence is elementwise in d and sequential in t, so
// one thread owns one (b, d) and walks t in order in both kernels (a split
// of T with an affine composition of chunks would round otherwise).
//
// rglru_ring_kernel, grid (D / kTileD, B), the kernel of every row of D
// elements that is a multiple of 16 bytes: a block owns kTileD = 64
// channels of one batch row.  One producer lane keeps a ring of shared-
// memory stages full, each holding kChunk = 32 steps of the tile's a and u:
// one TMA copy of a (32 x 64) box per operand and stage, over a tensor map
// of (B, T, D) that reads zeros past T and D.  A copy completes on the stage's
// full mbarrier, and a wait that stalls past ~2^34 cycles traps instead of
// hanging the card.  Two consumer warps, a thread a channel, walk the stage
// from shared memory, store h straight to device memory (a warp's step is
// one 128- or 256-byte coalesced row) and release the stage on its empty
// mbarrier.  The ring is 64 KB (4 stages in float32, 8 in bf16), so a block
// keeps up to 64 KB of loads in flight and the loads of the next chunks run
// while one is walked; at B 4, D 4,096 the 256 blocks sit two to an SM.
// A first version issued a 1-D bulk copy per step row (64 a stage): on an
// H100 it took nearly as long in bf16 as in float32, bound by the number
// of copies rather than their bytes; one box an operand and stage is
// faster in both types, most in bf16 (PERF.md).  A tensor map needs
// 16-byte-aligned rows, hence the rule on D.
//
// rglru_kernel, grid (D / 64, B), for the other D: each thread loads
// kUnroll steps of its channel's a and u from device memory into registers,
// then walks them.  Loads are in flight only about half of the time, and
// at most ~16 KB an SM: it reached half of the bytes bound at B 4, D 4,096.
// The wrapper's dispatch table (kernels/rglru/ops.py::variant) picks one
// of the two from the type and D; neither falls back to the other.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 16;

constexpr int kTileD = 64;                 // channels a ring block owns
constexpr int kChunk = 32;                 // steps a ring stage holds
constexpr int kRingBytes = 64 * 1024;      // the ring, over all stages
constexpr int kRingThreads = kTileD + 32;  // consumers + one producer warp
constexpr int kConsumerWarps = kTileD / 32;
// a wait on an mbarrier that outlasts this many cycles (~9 s) traps, so a
// pipeline fault ends the launch with an error instead of hanging the card
constexpr long long kWatchdogCycles = 1ll << 34;

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

// ---- the ring kernel -------------------------------------------------------

// One ring stage: kChunk rows of kTileD elements of a, then of u.
template <typename T>
struct Ring {
  static constexpr int kRowBytes = kTileD * (int)sizeof(T);
  static constexpr int kStageBytes = 2 * kChunk * kRowBytes;
  static constexpr int kStages = kRingBytes / kStageBytes;
  static constexpr int kSmemBytes = kRingBytes + 16 * kStages;  // + barriers
  static_assert(kStages >= 2 && kRingBytes % kStageBytes == 0,
                "the ring holds whole stages");
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

template <typename T>
__global__ void __launch_bounds__(kRingThreads)
rglru_ring_kernel(const __grid_constant__ CUtensorMap ma,
                  const __grid_constant__ CUtensorMap mu,
                  T* __restrict__ h, float* __restrict__ h_last, int T_len,
                  int D) {
  using R = Ring<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int d0 = blockIdx.x * kTileD;
  const int b = blockIdx.y;
  const int cols = min(kTileD, D - d0);           // this tile's channels
  const int n_chunks = (T_len + kChunk - 1) / kChunk;
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = ring + kRingBytes;        // [kStages], 8 bytes each
  const uint32_t empty = full + 8 * R::kStages;   // [kStages]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int st = 0; st < R::kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer: one lane copies a chunk's box of a and of u ----
    if (lane == 0) {
      for (int k = 0; k < n_chunks; ++k) {
        const int st = k % R::kStages;
        if (k >= R::kStages)
          mbar_wait(empty + 8 * st, ((k / R::kStages) & 1) ^ 1);
        const uint32_t dst = ring + st * R::kStageBytes;
        mbar_expect_tx(full + 8 * st, R::kStageBytes);   // zeros count too
        tma_load3(dst, &ma, full + 8 * st, d0, k * kChunk, b);
        tma_load3(dst + R::kStageBytes / 2, &mu, full + 8 * st, d0,
                  k * kChunk, b);
      }
    }
    return;
  }

  // ---- consumers: thread c walks channel d0 + c ----
  const int c = threadIdx.x;
  const bool live = c < cols;
  T* hp = h + static_cast<size_t>(b) * T_len * D + d0 + c;
  float hv = 0.f;
  for (int k = 0; k < n_chunks; ++k) {
    const int st = k % R::kStages;
    mbar_wait(full + 8 * st, (k / R::kStages) & 1);
    const T* ta = reinterpret_cast<const T*>(smem + st * R::kStageBytes) + c;
    const T* tu = ta + kChunk * kTileD;
    const int t0 = k * kChunk;
    const int rows = min(kChunk, T_len - t0);
    if (live) {
      T* hr = hp + static_cast<size_t>(t0) * D;
      if (rows == kChunk) {
#pragma unroll
        for (int r = 0; r < kChunk; ++r) {
          hv = __fadd_rn(__fmul_rn(to_float(ta[r * kTileD]), hv),
                         to_float(tu[r * kTileD]));
          hr[static_cast<size_t>(r) * D] = from_float<T>(hv);
        }
      } else {
        for (int r = 0; r < rows; ++r) {
          hv = __fadd_rn(__fmul_rn(to_float(ta[r * kTileD]), hv),
                         to_float(tu[r * kTileD]));
          hr[static_cast<size_t>(r) * D] = from_float<T>(hv);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }
  if (live) h_last[static_cast<size_t>(b) * D + d0 + c] = hv;
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

// a 3-D map over (B, T, D), boxes of (1, kChunk, kTileD), no swizzle;
// out-of-bounds parts of a box read zeros
template <typename T>
bool encode_map(CUtensorMap* map, const void* base, int B, int steps, int D) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)steps,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)D * sizeof(T),
                                 (cuuint64_t)steps * D * sizeof(T)};
  const cuuint32_t box[3] = {kTileD, kChunk, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            3, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
cudaError_t launch_ring(const void* a, const void* u, void* h, void* h_last,
                        int B, int steps, int D, cudaStream_t stream) {
  // a tensor map's rows: whole 16-byte units from a 16-byte-aligned base
  if ((D * sizeof(T)) % 16 != 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(u) % 16)
    return cudaErrorMisalignedAddress;
  CUtensorMap ma = {}, mu = {};   // T 0: no copy, the maps stay unread
  if (steps > 0 && (!encode_map<T>(&ma, a, B, steps, D) ||
                    !encode_map<T>(&mu, u, B, steps, D)))
    return cudaErrorInvalidValue;
  auto kernel = rglru_ring_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Ring<T>::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((D + kTileD - 1) / kTileD, B);
  kernel<<<grid, kRingThreads, Ring<T>::kSmemBytes, stream>>>(
      ma, mu, static_cast<T*>(h), static_cast<float*>(h_last), steps, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of a, u and h: 0 = float32, 1 = bfloat16.  Returns the launch's CUDA
// error code.  rglru_forward launches rglru_kernel (any D);
// rglru_ring_forward launches rglru_ring_kernel (D * element size a
// multiple of 16 bytes, a and u 16-byte aligned).
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

int rglru_ring_forward(const void* a, const void* u, void* h, void* h_last,
                       int dtype, int B, int T, int D, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || D <= 0 || T < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(launch_ring<float>(a, u, h, h_last, B, T, D, s));
  if (dtype == 1)
    return static_cast<int>(launch_ring<__nv_bfloat16>(a, u, h, h_last, B, T,
                                                       D, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
