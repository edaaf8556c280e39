// Chain-VM kernels for Hopper (sm_90a): batches of single-WQ RDMA work-request
// chains, one client context per thread block.
//
// Replaces the JAX package's TPU kernels in src/repro/kernels/chain_vm/kernel.py:
//   * run_managed  <- _managed_vm_kernel / run_managed_pallas (managed WQ:
//     ENABLE-gated head, WAIT on self, RECV scatter from staged messages,
//     client-response SEND, CAS/ADD return-old, MAX/MIN);
//   * run_chains   <- _vm_kernel / run_chains_pallas (the straight-line subset
//     for a fixed number of steps, a context freezing once it HALTs).
// The loop is the plain PyTorch versions' (repro_torch/kernels/chain_vm/ref.py)
// step for step, with the JAX reference's index rules: a read wraps a negative
// index once and clamps it into the image, a scalar write past the end is
// dropped, and a 16-word copy block's start is wrapped and clamped into
// [0, M - 16].  int32 arithmetic wraps (done in unsigned).
//
// Bound: every image has to be read and written once, 2 * n * M * 4 bytes over
// the card's memory bandwidth (3.35 TB/s on an H100 SXM); the chain itself
// touches a few hundred words.  Design: the whole block copies its context's
// image to the output with 16-byte loads (the part that meets the bound), then
// one thread walks the chain in global memory (a latency-bound scalar loop,
// like the NIC's processing unit walking a WQ).  Staging the walked words in
// shared memory is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWrWords = 8;
constexpr int kMaxCopy = 16;
constexpr int kMaxScatter = 16;
constexpr int kMsgWords = 16;
constexpr int kNumOpcodes = 13;
constexpr int kIdBits = 24;
constexpr int kThreads = 256;

enum Opcode {
  NOOP = 0, WRITE = 1, WRITE_IMM = 2, READ = 3, SEND = 4, RECV = 5, CAS = 6,
  ADD = 7, MAX = 8, MIN = 9, WAIT = 10, ENABLE = 11, HALT = 12
};

enum Field { F_CTRL = 0, F_FLAGS = 1, F_SRC = 2, F_DST = 3, F_LEN = 4,
             F_OPA = 5, F_OPB = 6, F_AUX = 7 };

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ int floor_mod(int a, int b) {
  int r = a % b;
  return r < 0 ? r + b : r;
}

// gather rule: a negative index counts from the end, then clamp
__device__ __forceinline__ int read_index(int i, int len) {
  if (i < 0) i += len;
  return i < 0 ? 0 : (i > len - 1 ? len - 1 : i);
}

// dynamic_slice rule for a block of `size` words
__device__ __forceinline__ int block_start(int s, int len, int size) {
  if (s < 0) s += len;
  return s < 0 ? 0 : (s > len - size ? len - size : s);
}

__device__ __forceinline__ int rd(const int* m, int len, int i) {
  return m[read_index(i, len)];
}

// scalar store at a non-negative address; dropped past the image
__device__ __forceinline__ void store(int* m, int len, int a, int v) {
  if (a >= 0 && a < len) m[a] = v;
}

__device__ __forceinline__ void masked_copy(int* m, int len, int src, int dst,
                                            int ln) {
  ln = ln < 0 ? 0 : (ln > kMaxCopy ? kMaxCopy : ln);
  if (ln == 0) return;
  const int cs = block_start(src, len, kMaxCopy);
  const int cd = block_start(dst, len, kMaxCopy);
  int blk[kMaxCopy];
  for (int k = 0; k < ln; ++k) blk[k] = m[cs + k];   // read before writing
  for (int k = 0; k < ln; ++k) m[cd + k] = blk[k];
}

// One WR at `addr`.  MANAGED selects run_managed's verb set; otherwise SEND,
// RECV, WAIT and ENABLE are no-ops and CAS/ADD return nothing.  Returns 1 on
// HALT.
template <bool MANAGED>
__device__ int step_wr(int* m, int len, int addr, const int* payload,
                       int* enable) {
  int op = (rd(m, len, addr + F_CTRL) >> kIdBits) & 0x7F;
  op = op > kNumOpcodes - 1 ? kNumOpcodes - 1 : op;
  const int src = rd(m, len, addr + F_SRC);
  const int dst = rd(m, len, addr + F_DST);
  const int ln = rd(m, len, addr + F_LEN);
  const int opa = rd(m, len, addr + F_OPA);
  const int opb = rd(m, len, addr + F_OPB);
  const int aux = rd(m, len, addr + F_AUX);
  const int d = dst < 0 ? 0 : dst;
  switch (op) {
    case WRITE:
    case READ:
      masked_copy(m, len, src, d, ln);
      break;
    case SEND:
      if (MANAGED && opb < 0) masked_copy(m, len, src, d, ln);
      break;
    case WRITE_IMM:
      store(m, len, d, opa);
      break;
    case CAS: {
      const int old = rd(m, len, d);
      store(m, len, d, old == opa ? opb : old);
      if (MANAGED && src >= 0) store(m, len, src, old);
      break;
    }
    case ADD: {
      const int old = rd(m, len, d);
      store(m, len, d, wrap_add(old, opa));
      if (MANAGED && src >= 0) store(m, len, src, old);
      break;
    }
    case MAX:
      if (d < len) m[d] = max(m[d], opa);
      break;
    case MIN:
      if (d < len) m[d] = min(m[d], opa);
      break;
    case RECV:
      if (MANAGED) {
        const int a = aux < 0 ? 0 : aux;
        int n = rd(m, len, a);
        n = n < 0 ? 0 : (n > kMaxScatter ? kMaxScatter : n);
        for (int i = 0; i < n; ++i) {
          int dd = rd(m, len, wrap_add(a, 1 + i));
          store(m, len, dd < 0 ? 0 : dd, payload[i]);
        }
      }
      break;
    case ENABLE:
      if (MANAGED) *enable = max(*enable, opa);
      break;
    default:
      break;
  }
  return op == HALT;
}

// the block copies its context's image; 16-byte accesses when aligned
__device__ void copy_image(const int* __restrict__ src, int* __restrict__ dst,
                           int len) {
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst))
       & 15) == 0) {
    const int n4 = len / 4;
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int i = threadIdx.x; i < n4; i += blockDim.x) d4[i] = s4[i];
    for (int i = n4 * 4 + threadIdx.x; i < len; i += blockDim.x)
      dst[i] = src[i];
  } else {
    for (int i = threadIdx.x; i < len; i += blockDim.x) dst[i] = src[i];
  }
}

// init / stats layouts of repro_torch/kernels/chain_vm/ref.py
enum { INIT_HEAD = 0, INIT_TAIL, INIT_ENABLE, INIT_COMPLETIONS, INIT_MSG_HEAD,
       INIT_MSG_TAIL, INIT_FUEL, INIT_HALTED };

__global__ void __launch_bounds__(kThreads)
run_managed_kernel(const int* __restrict__ mems, const int* __restrict__ msgs,
                   const int* __restrict__ inits, int* __restrict__ out,
                   int* __restrict__ stats, int len, int msg_words,
                   int wq_base, int n_wrs, int managed, int max_steps) {
  const size_t row = blockIdx.x;
  int* m = out + row * static_cast<size_t>(len);
  copy_image(mems + row * static_cast<size_t>(len), m, len);
  __syncthreads();
  if (threadIdx.x != 0) return;

  const int* init = inits + row * 8;
  const int* msg = msgs + row * static_cast<size_t>(msg_words);
  const int cap = msg_words / kMsgWords;
  const int head0 = init[INIT_HEAD], tail = init[INIT_TAIL];
  const int msg_tail = init[INIT_MSG_TAIL], fuel = init[INIT_FUEL];
  int head = head0, enable = init[INIT_ENABLE];
  int comps = init[INIT_COMPLETIONS], mhead = init[INIT_MSG_HEAD];
  int resps = 0;
  bool halted = init[INIT_HALTED] > 0;
  bool stopped = halted;
  for (int it = 0; it < max_steps && !stopped; ++it) {
    const int addr = wq_base + floor_mod(head, n_wrs) * kWrWords;
    int op = (rd(m, len, addr + F_CTRL) >> kIdBits) & 0x7F;
    op = op > kNumOpcodes - 1 ? kNumOpcodes - 1 : op;
    const int flags = rd(m, len, addr + F_FLAGS);
    const int opa = rd(m, len, addr + F_OPA);
    const int opb = rd(m, len, addr + F_OPB);
    const int limit = managed ? min(tail, enable) : tail;
    const bool runnable = head < limit && (op != WAIT || comps >= opa) &&
                          (op != RECV || mhead < msg_tail) &&
                          wrap_sub(head, head0) < fuel;
    if (!runnable) {
      stopped = true;
      break;
    }
    const int* payload = msg + floor_mod(mhead, cap) * kMsgWords;
    const int halt = step_wr<true>(m, len, addr, payload, &enable);
    if ((flags & 1) == 0) comps = wrap_add(comps, 1);
    if (op == RECV) mhead = wrap_add(mhead, 1);
    if (op == SEND && opb < 0) resps += 1;
    head = wrap_add(head, 1);
    if (halt) {
      halted = true;
      stopped = true;
    }
  }
  int* st = stats + row * 8;
  st[0] = head;
  st[1] = enable;
  st[2] = comps;
  st[3] = mhead;
  st[4] = halted ? 1 : 0;
  st[5] = stopped ? 1 : 0;
  st[6] = resps;
  st[7] = 0;
}

__global__ void __launch_bounds__(kThreads)
run_chains_kernel(const int* __restrict__ mems, int* __restrict__ out, int len,
                  int wq_base, int n_wrs, int max_steps) {
  const size_t row = blockIdx.x;
  int* m = out + row * static_cast<size_t>(len);
  copy_image(mems + row * static_cast<size_t>(len), m, len);
  __syncthreads();
  if (threadIdx.x != 0) return;
  int head = 0;
  int unused = 0;
  for (int it = 0; it < max_steps; ++it) {
    const int addr = wq_base + floor_mod(head, n_wrs) * kWrWords;
    const int halt = step_wr<false>(m, len, addr, nullptr, &unused);
    head += 1;
    if (halt) break;
  }
}

}  // namespace

extern "C" {

int chain_vm_run_managed(const void* mems, const void* msgs, const void* inits,
                         void* out, void* stats, int n, int len, int msg_words,
                         int wq_base, int n_wrs, int managed, int max_steps,
                         void* stream) {
  if (n <= 0) return 0;
  run_managed_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(mems), static_cast<const int*>(msgs),
      static_cast<const int*>(inits), static_cast<int*>(out),
      static_cast<int*>(stats), len, msg_words, wq_base, n_wrs, managed,
      max_steps);
  return static_cast<int>(cudaGetLastError());
}

int chain_vm_run_chains(const void* mems, void* out, int n, int len,
                        int wq_base, int n_wrs, int max_steps, void* stream) {
  if (n <= 0) return 0;
  run_chains_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(mems), static_cast<int*>(out), len, wq_base,
      n_wrs, max_steps);
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
