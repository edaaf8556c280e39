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
// card's 3.35 TB/s (0.10 ms in bf16).
//
// rglru_bwd_ring_kernel, grid (D / kTileD, B), the kernel of every row of D
// elements that is a multiple of 16 bytes: the forward's rglru_ring_kernel
// run backward in time.  A block owns kTileD = 64 channels of one batch
// row.  One producer lane keeps a ring of shared-memory stages full, from
// the last chunk of kChunkT = 32 steps to the first: one TMA box of a and
// one of dh at rows t0 .. t0 + 31, and one of h at rows t0 - 1 .. t0 + 30,
// so that the walk reads h_{t-1} beside a_t; tiled TMA coordinates are
// signed, and the rows before 0 and past T read zeros (h_0 = 0).  A copy
// completes on the stage's full mbarrier; a wait that stalls past ~2^34
// cycles traps instead of hanging the card.  Two consumer warps, a thread
// a channel, walk the stage from its last row to its first, store da and
// du straight to device memory (a warp's step is one coalesced 128- or
// 256-byte row) and release the stage on its empty mbarrier.  Three
// operands fill a stage (the forward's two), so the ring is 96 KB: 4
// stages in float32, 8 in bf16, and two blocks an SM.  A tensor map needs
// 16-byte-aligned rows, hence the rule on D.
//
// rglru_bwd_kernel, grid (D / 64, B), for the other D: each thread loads
// kUnroll steps of its channel's a, dh and h_{t-1} from device memory into
// registers, then walks them backward.  Few bytes are in flight (the
// direct forward's fault before its ring: PERF.md).  The wrapper's
// dispatch table (kernels/rglru/ops.py::variant) picks one of the two from
// the type and D; neither falls back to the other.
#include "hopper.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 16;

constexpr int kTileD = 64;                 // channels a ring block owns
constexpr int kChunkT = 32;                // steps a ring stage holds
constexpr int kRingBytes = 96 * 1024;      // the ring, over all stages
constexpr int kRingThreads = kTileD + 32;  // consumers + one producer warp
constexpr int kConsumerWarps = kTileD / 32;

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

// ---- the ring kernel -------------------------------------------------------

// One ring stage: kChunkT rows of kTileD elements of a, of dh, then of h
// (one step earlier).
template <typename T>
struct Ring {
  static constexpr int kBoxBytes = kChunkT * kTileD * (int)sizeof(T);
  static constexpr int kStageBytes = 3 * kBoxBytes;
  static constexpr int kStages = kRingBytes / kStageBytes;
  static constexpr int kSmemBytes = kStages * kStageBytes + 16 * kStages;
  static_assert(kStages >= 4 && kRingBytes % kStageBytes == 0,
                "the ring holds whole stages, at least 4");
};

template <typename T>
__global__ void __launch_bounds__(kRingThreads)
rglru_bwd_ring_kernel(const __grid_constant__ CUtensorMap ma,
                      const __grid_constant__ CUtensorMap mdh,
                      const __grid_constant__ CUtensorMap mh,
                      const float* __restrict__ dh_last, T* __restrict__ da,
                      T* __restrict__ du, int T_len, int D) {
  using R = Ring<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int d0 = blockIdx.x * kTileD;
  const int b = blockIdx.y;
  const int cols = min(kTileD, D - d0);           // this tile's channels
  const int n_chunks = (T_len + kChunkT - 1) / kChunkT;
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = ring + R::kStages * R::kStageBytes;  // [kStages]
  const uint32_t empty = full + 8 * R::kStages;               // [kStages]
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
    // ---- producer: one lane copies the chunks, last first ----
    if (lane == 0) {
      for (int i = 0; i < n_chunks; ++i) {
        const int st = i % R::kStages;
        if (i >= R::kStages)
          mbar_wait(empty + 8 * st, ((i / R::kStages) & 1) ^ 1);
        const int t0 = (n_chunks - 1 - i) * kChunkT;
        const uint32_t dst = ring + st * R::kStageBytes;
        mbar_expect_tx(full + 8 * st, R::kStageBytes);   // zeros count too
        tma_load3(dst, &ma, full + 8 * st, d0, t0, b);
        tma_load3(dst + R::kBoxBytes, &mdh, full + 8 * st, d0, t0, b);
        tma_load3(dst + 2 * R::kBoxBytes, &mh, full + 8 * st, d0, t0 - 1,
                  b);
      }
    }
    return;
  }

  // ---- consumers: thread c walks channel d0 + c backward ----
  const int c = threadIdx.x;
  const bool live = c < cols;
  const size_t off = static_cast<size_t>(b) * T_len * D + d0 + c;
  float carry = live && dh_last != nullptr
                    ? dh_last[static_cast<size_t>(b) * D + d0 + c]
                    : 0.f;
  for (int i = 0; i < n_chunks; ++i) {
    const int st = i % R::kStages;
    mbar_wait(full + 8 * st, (i / R::kStages) & 1);
    const T* ta = reinterpret_cast<const T*>(smem + st * R::kStageBytes) + c;
    const T* tg = ta + kChunkT * kTileD;
    const T* th = tg + kChunkT * kTileD;      // row r holds h_{t0 + r - 1}
    const int t0 = (n_chunks - 1 - i) * kChunkT;
    const int rows = min(kChunkT, T_len - t0);
    if (live) {
      T* ar = da + off + static_cast<size_t>(t0) * D;
      T* ur = du + off + static_cast<size_t>(t0) * D;
      auto step = [&](int r) {
        const float g = __fadd_rn(to_float(tg[r * kTileD]), carry);
        ur[static_cast<size_t>(r) * D] = from_float<T>(g);
        ar[static_cast<size_t>(r) * D] =
            from_float<T>(__fmul_rn(g, to_float(th[r * kTileD])));
        carry = __fmul_rn(to_float(ta[r * kTileD]), g);
      };
      if (rows == kChunkT) {
#pragma unroll
        for (int r = kChunkT - 1; r >= 0; --r) step(r);
      } else {
        for (int r = rows - 1; r >= 0; --r) step(r);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
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

// a 3-D map over (B, T, D), boxes of (1, kChunkT, kTileD), no swizzle;
// out-of-bounds parts of a box (rows before 0 or past T, channels past D)
// read zeros
template <typename T>
bool encode_rows(CUtensorMap* map, const void* base, int B, int steps,
                 int D) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)steps,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)D * sizeof(T),
                                 (cuuint64_t)steps * D * sizeof(T)};
  const cuuint32_t box[3] = {kTileD, kChunkT, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            3, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
cudaError_t launch_ring(const void* a, const void* h, const void* dh,
                        const void* dh_last, void* da, void* du, int B,
                        int steps, int D, cudaStream_t stream) {
  // a tensor map's rows: whole 16-byte units from a 16-byte-aligned base
  if ((D * sizeof(T)) % 16 != 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(h) % 16 ||
      reinterpret_cast<uintptr_t>(dh) % 16)
    return cudaErrorMisalignedAddress;
  CUtensorMap ma = {}, mdh = {}, mh = {};
  if (!encode_rows<T>(&ma, a, B, steps, D) ||
      !encode_rows<T>(&mdh, dh, B, steps, D) ||
      !encode_rows<T>(&mh, h, B, steps, D))
    return cudaErrorInvalidValue;
  auto kernel = rglru_bwd_ring_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Ring<T>::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((D + kTileD - 1) / kTileD, B);
  kernel<<<grid, kRingThreads, Ring<T>::kSmemBytes, stream>>>(
      ma, mdh, mh, static_cast<const float*>(dh_last), static_cast<T*>(da),
      static_cast<T*>(du), steps, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of a, h, dh, da and du: 0 = float32, 1 = bfloat16.  dh_last
// ((B, D) float32) may be null.  Returns the launch's CUDA error code.
// rglru_backward launches rglru_bwd_kernel (any D); rglru_ring_backward
// launches rglru_bwd_ring_kernel (D * element size a multiple of 16 bytes,
// a, h and dh 16-byte aligned).
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

int rglru_ring_backward(const void* a, const void* h, const void* dh,
                        const void* dh_last, void* da, void* du, int dtype,
                        int B, int T, int D, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || D <= 0 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(launch_ring<float>(a, h, dh, dh_last, da, du, B,
                                               T, D, s));
  if (dtype == 1)
    return static_cast<int>(launch_ring<__nv_bfloat16>(a, h, dh, dh_last, da,
                                                       du, B, T, D, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
