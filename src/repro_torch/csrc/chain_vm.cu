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
// touches a few hundred words, but its steps depend on each other (a chain
// rewrites its own WRs), so a long chain is bound by the latency of a step.
//
// run_managed's design: one warp walks the chain out of shared memory, as the
// TPU kernel walks it out of VMEM.  Every lane reads the head WR's 8 fields
// where they lie in shared memory in order (else lane f routes field f and
// shuffles broadcast the fields).  A copy of up to 16 words is one read round
// by lanes k < len, __syncwarp(), then one write round (the source is read
// before anything is written); a scalar verb reads and writes on lane 0; a
// RECV scatters on lanes i < n when no store lands on its scatter table and
// no two stores share a word, else on lane 0 in order.  The verbs are
// predicated rather than switched on: a lone warp's step is a chain of
// dependent instructions, and each branch lengthens it.  Index rules are
// applied to the image index before a word is routed, and __syncwarp() ends
// each step, so the next fetch sees what the step wrote.  Two routes, by
// image size:
//   * whole image (M <= kWholeWords, 64 KB): the block stages the image in
//     shared memory with 16-byte loads, the warp walks it, and the block
//     stores it;
//   * window (larger images, such as a get server's 2 MiB): the ring of WRs
//     is staged, a word outside it that the chain writes goes to a write log
//     in shared memory (an open-addressed table, updated in place), and a
//     read tries the ring, the log, then the input image.  Meanwhile the
//     block's other warps copy the input image to the output, so the walk
//     hides under the copy; at the end the block writes the ring and the log
//     over the output.  When the log has no room for a step's writes, the
//     walker waits on a named barrier for the copy warps and writes the rest
//     of its out-of-ring words straight to the output.
// run_chains keeps one thread walking the copied image in global memory.
//
// chain_vm_chase measures what bounds a chain step: the latency of one
// dependent load in shared memory and in L2, in SM cycles (clock64).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWrWords = 8;
constexpr int kMaxCopy = 16;
constexpr int kMaxScatter = 16;
constexpr int kMsgWords = 16;
constexpr int kNumOpcodes = 13;
constexpr int kIdBits = 24;
constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

// run_managed's routes: images up to kWholeWords words (64 KB) are staged
// whole; a larger image stages at most kWindowWords of its ring and logs up
// to kLogCap out-of-ring words in a table of kLogSlots.
constexpr int kWholeWords = 16384;
constexpr int kWholeThreads = 128;
constexpr int kWindowWords = 8192;
constexpr int kWindowThreads = 512;
constexpr int kLogBits = 10;
constexpr int kLogSlots = 1 << kLogBits;
constexpr int kLogCap = kLogSlots / 2;
constexpr int kEmpty = -1;             // an unused log slot (addresses >= 0)
constexpr int kCopyBarrier = 1;        // named barrier: the copy is done

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

__device__ __forceinline__ int clamp_len(int n, int hi) {
  return n < 0 ? 0 : (n > hi ? hi : n);
}

__device__ __forceinline__ int opcode_of(int ctrl) {
  const int op = (ctrl >> kIdBits) & 0x7F;
  return op > kNumOpcodes - 1 ? kNumOpcodes - 1 : op;
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
  ln = clamp_len(ln, kMaxCopy);
  if (ln == 0) return;
  const int cs = block_start(src, len, kMaxCopy);
  const int cd = block_start(dst, len, kMaxCopy);
  int blk[kMaxCopy];
  for (int k = 0; k < ln; ++k) blk[k] = m[cs + k];   // read before writing
  for (int k = 0; k < ln; ++k) m[cd + k] = blk[k];
}

// One straight-line WR at `addr` (run_chains: SEND, RECV, WAIT and ENABLE
// are no-ops, CAS/ADD return nothing).  Returns 1 on HALT.
__device__ int step_wr(int* m, int len, int addr) {
  const int op = opcode_of(rd(m, len, addr + F_CTRL));
  const int src = rd(m, len, addr + F_SRC);
  const int dst = rd(m, len, addr + F_DST);
  const int ln = rd(m, len, addr + F_LEN);
  const int opa = rd(m, len, addr + F_OPA);
  const int d = dst < 0 ? 0 : dst;
  switch (op) {
    case WRITE:
    case READ:
      masked_copy(m, len, src, d, ln);
      break;
    case WRITE_IMM:
      store(m, len, d, opa);
      break;
    case CAS: {
      const int old = rd(m, len, d);
      store(m, len, d, old == opa ? rd(m, len, addr + F_OPB) : old);
      break;
    }
    case ADD:
      store(m, len, d, wrap_add(rd(m, len, d), opa));
      break;
    case MAX:
      if (d < len) m[d] = max(m[d], opa);
      break;
    case MIN:
      if (d < len) m[d] = min(m[d], opa);
      break;
    default:
      break;
  }
  return op == HALT;
}

// threads t, t + nt, ... copy `len` words; 16-byte accesses when both ends
// are aligned, four in flight a thread
__device__ void copy_words(const int* __restrict__ src, int* __restrict__ dst,
                           int len, int t, int nt) {
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst))
       & 15) == 0) {
    const int n4 = len / 4;
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    int i = t;
    for (; i + 3 * nt < n4; i += 4 * nt) {
      const int4 a = s4[i], b = s4[i + nt], c = s4[i + 2 * nt],
                 e = s4[i + 3 * nt];
      d4[i] = a;
      d4[i + nt] = b;
      d4[i + 2 * nt] = c;
      d4[i + 3 * nt] = e;
    }
    for (; i < n4; i += nt) d4[i] = s4[i];
    for (i = n4 * 4 + t; i < len; i += nt) dst[i] = src[i];
  } else {
    for (int i = t; i < len; i += nt) dst[i] = src[i];
  }
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(n) : "memory");
}

// ---------------------------------------------------------------------------
// run_managed: the images a walking warp reads and writes, by route.  Indices
// reaching load / put lie in [0, len).
// ---------------------------------------------------------------------------

struct WholeImage {
  int* s;                     // the staged image
  __device__ void before_step() {}
  // whether words [addr, addr + 8) lie in shared memory in order; at(i)
  // reads one of them
  __device__ bool staged(int addr, int len) const {
    return addr >= 0 && addr <= len - kWrWords;
  }
  __device__ int at(int i) const { return s[i]; }
  __device__ int load(int i) const { return s[i]; }
  __device__ void put(int i, int v) { s[i] = v; }
};

struct WindowImage {
  const int* in;               // the context's input image (read-only)
  int* out;                    // its output image (the copy warps fill it)
  int* win;                    // the staged ring: image words [w0, w0 + wn)
  int w0, wn;
  int* keys;                   // the write log: address per slot or kEmpty
  int* vals;
  int* count;                  // entries in the log
  int nthreads;
  bool direct;                 // the copy is done: unlogged words in `out`

  __device__ static unsigned home(int i) {
    return (static_cast<unsigned>(i) * 2654435761u) >> (32 - kLogBits);
  }
  __device__ bool in_window(int i) const {
    return static_cast<unsigned>(i - w0) < static_cast<unsigned>(wn);
  }
  __device__ bool staged(int addr, int) const {
    return addr >= w0 && addr <= w0 + wn - kWrWords;
  }
  __device__ int at(int i) const { return win[i - w0]; }
  // the log's slot of address i, or -1 (linear probing; nothing leaves)
  __device__ int find(int i) const {
    for (unsigned s = home(i);; s = (s + 1) & (kLogSlots - 1)) {
      const int k = keys[s];
      if (k == i) return s;
      if (k == kEmpty) return -1;
    }
  }
  // A step adds at most kMaxCopy entries; when they might not fit, wait for
  // the copy warps and write unlogged words through to `out` from now on.
  // The whole warp calls this (the count is read after the last __syncwarp).
  __device__ void before_step() {
    if (direct) return;
    const int n = __shfl_sync(kFullMask, *count, 0);
    if (n > kLogCap - kMaxCopy) {
      bar_sync(kCopyBarrier, nthreads);
      direct = true;
    }
  }
  __device__ int load(int i) const {
    if (in_window(i)) return win[i - w0];
    const int s = find(i);
    if (s >= 0) return vals[s];
    return direct ? out[i] : __ldg(in + i);
  }
  // Lanes of one round put distinct addresses: a lane that loses a slot to
  // another lane's atomicCAS probes on.
  __device__ void put(int i, int v) {
    if (in_window(i)) {
      win[i - w0] = v;
      return;
    }
    for (unsigned s = home(i);; s = (s + 1) & (kLogSlots - 1)) {
      int k = keys[s];
      if (k == kEmpty) {
        if (direct) {
          out[i] = v;
          return;
        }
        k = atomicCAS(&keys[s], kEmpty, i);
        if (k == kEmpty) {
          vals[s] = v;
          atomicAdd(count, 1);
          return;
        }
      }
      if (k == i) {
        vals[s] = v;
        return;
      }
    }
  }
};

// RECV: n = [a], then payload[i] -> [max([a + 1 + i], 0)] for i < n, each
// store before the next destination is read
template <class Img>
__device__ __forceinline__ void warp_recv(Img& img, int len, int a,
                                          const int* payload, int lane) {
  int n = 0;
  if (lane == 0) n = img.load(read_index(a, len));
  n = clamp_len(__shfl_sync(kFullMask, n, 0), kMaxScatter);
  if (n == 0) return;
  const int p = lane < kMsgWords ? payload[lane] : 0;
  // in parallel only when the table [a, a + n] lies in the image unclamped,
  // no store lands on it and no two stores share a word
  if (a <= len - 1 - n) {
    int dd = 0;
    if (lane < n) dd = max(img.load(a + 1 + lane), 0);
    const bool stores = lane < n && dd < len;
    const unsigned same = __match_any_sync(kFullMask, stores ? dd : -1 - lane);
    const bool clash = stores && ((dd >= a && dd <= a + n) ||
                                  __popc(same) > 1);
    if (!__any_sync(kFullMask, clash)) {
      __syncwarp();
      if (stores) img.put(dd, p);
      return;
    }
  }
  for (int i = 0; i < n; ++i) {
    const int pi = __shfl_sync(kFullMask, p, i);
    if (lane == 0) {
      const int dd = max(img.load(read_index(wrap_add(a, 1 + i), len)), 0);
      if (dd < len) img.put(dd, pi);
    }
  }
}

// init / stats layouts of repro_torch/kernels/chain_vm/ref.py
enum { INIT_HEAD = 0, INIT_TAIL, INIT_ENABLE, INIT_COMPLETIONS, INIT_MSG_HEAD,
       INIT_MSG_TAIL, INIT_FUEL, INIT_HALTED };

// One context's managed chain, walked by the whole calling warp (every lane
// holds the same head, counters and fields).
template <class Img>
__device__ __forceinline__ void walk_managed(
    Img& img, int len, const int* msg, int cap, const int* init, int* st,
    int wq_base, int n_wrs, int managed, int max_steps) {
  const int lane = threadIdx.x & 31;
  const int head0 = init[INIT_HEAD], tail = init[INIT_TAIL];
  const int msg_tail = init[INIT_MSG_TAIL], fuel = init[INIT_FUEL];
  int head = head0, enable = init[INIT_ENABLE];
  int comps = init[INIT_COMPLETIONS], mhead = init[INIT_MSG_HEAD];
  int resps = 0;
  bool halted = init[INIT_HALTED] > 0;
  bool stopped = halted;
  int slot = floor_mod(head, n_wrs);
  for (int it = 0; it < max_steps && !stopped; ++it) {
    img.before_step();
    const int addr = wq_base + slot * kWrWords;
    // the head WR's fields: every lane reads them where they lie in shared
    // memory in order, else lane f routes field f and shuffles share them
    int f[kWrWords];
    if (img.staged(addr, len)) {
#pragma unroll
      for (int k = 0; k < kWrWords; ++k) f[k] = img.at(addr + k);
    } else {
      int mine = 0;
      if (lane < kWrWords) mine = img.load(read_index(addr + lane, len));
#pragma unroll
      for (int k = 0; k < kWrWords; ++k)
        f[k] = __shfl_sync(kFullMask, mine, k);
    }
    const int op = opcode_of(f[F_CTRL]), flags = f[F_FLAGS];
    const int src = f[F_SRC], dst = f[F_DST], ln = f[F_LEN];
    const int opa = f[F_OPA], opb = f[F_OPB], aux = f[F_AUX];
    const int limit = managed ? min(tail, enable) : tail;
    const bool runnable = head < limit && (op != WAIT || comps >= opa) &&
                          (op != RECV || mhead < msg_tail) &&
                          wrap_sub(head, head0) < fuel;
    if (!runnable) {
      stopped = true;
      break;
    }
    // The verb, with as few branches as the walk's latency allows: a copy
    // of up to 16 words reads block [cs, cs + n) on lanes k < n, then
    // writes [cd, cd + n) (the source is read before anything is
    // written); a scalar verb reads its old word and writes on lane 0.
    const int d = dst < 0 ? 0 : dst;
    const bool copy = op == WRITE || op == READ || (op == SEND && opb < 0);
    const bool scalar = op == WRITE_IMM || (op >= CAS && op <= MIN);
    const int n = copy ? clamp_len(ln, kMaxCopy) : 0;
    const bool rd_copy = lane < n;
    const bool on_scalar = scalar && lane == 0;
    int v = 0;
    if (rd_copy || on_scalar)
      v = img.load(rd_copy ? block_start(src, len, kMaxCopy) + lane
                           : read_index(d, len));
    __syncwarp();
    if (rd_copy) img.put(block_start(d, len, kMaxCopy) + lane, v);
    if (on_scalar) {
      const int nv = op == WRITE_IMM ? opa
                     : op == CAS     ? (v == opa ? opb : v)
                     : op == ADD     ? wrap_add(v, opa)
                     : op == MAX     ? max(v, opa)
                                     : min(v, opa);
      if (d < len) img.put(d, nv);
      if ((op == CAS || op == ADD) && src >= 0 && src < len) img.put(src, v);
    }
    if (op == RECV)
      warp_recv(img, len, aux < 0 ? 0 : aux,
                msg + floor_mod(mhead, cap) * kMsgWords, lane);
    if (op == ENABLE) enable = max(enable, opa);
    __syncwarp();                 // the next fetch sees this step's writes
    if ((flags & 1) == 0) comps = wrap_add(comps, 1);
    if (op == RECV) mhead = wrap_add(mhead, 1);
    if (op == SEND && opb < 0) resps += 1;
    head = wrap_add(head, 1);
    // floor_mod(head, n_wrs), also for a head that wrapped past INT_MAX
    slot = slot + 1 == n_wrs ? 0 : slot + 1;
    if (__builtin_expect(head == INT_MIN, 0)) slot = floor_mod(head, n_wrs);
    if (op == HALT) {
      halted = true;
      stopped = true;
    }
  }
  if (lane == 0) {
    st[0] = head;
    st[1] = enable;
    st[2] = comps;
    st[3] = mhead;
    st[4] = halted ? 1 : 0;
    st[5] = stopped ? 1 : 0;
    st[6] = resps;
    st[7] = 0;
  }
}

struct ManagedArgs {
  const int* mems;
  const int* msgs;
  const int* inits;
  int* out;
  int* stats;
  int len, msg_words, wq_base, n_wrs, managed, max_steps;
};

template <class Img>
__device__ __forceinline__ void walk_row(const ManagedArgs& a, size_t row,
                                         Img& img) {
  walk_managed(img, a.len, a.msgs + row * static_cast<size_t>(a.msg_words),
               a.msg_words / kMsgWords, a.inits + row * 8, a.stats + row * 8,
               a.wq_base, a.n_wrs, a.managed, a.max_steps);
}

__global__ void __launch_bounds__(kWholeThreads)
managed_whole_kernel(ManagedArgs a) {
  extern __shared__ int4 smem4[];
  int* s = reinterpret_cast<int*>(smem4);
  const size_t row = blockIdx.x;
  const size_t off = row * static_cast<size_t>(a.len);
  copy_words(a.mems + off, s, a.len, threadIdx.x, blockDim.x);
  __syncthreads();
  if (threadIdx.x < 32) {
    WholeImage img{s};
    walk_row(a, row, img);
  }
  __syncthreads();
  copy_words(s, a.out + off, a.len, threadIdx.x, blockDim.x);
}

__global__ void __launch_bounds__(kWindowThreads)
managed_window_kernel(ManagedArgs a, int w0, int wn) {
  extern __shared__ int4 smem4[];
  int* win = reinterpret_cast<int*>(smem4);
  __shared__ int keys[kLogSlots];
  __shared__ int vals[kLogSlots];
  __shared__ int count;
  const size_t row = blockIdx.x;
  const int* in = a.mems + row * static_cast<size_t>(a.len);
  int* out = a.out + row * static_cast<size_t>(a.len);
  for (int i = threadIdx.x; i < kLogSlots; i += blockDim.x) keys[i] = kEmpty;
  if (threadIdx.x == 0) count = 0;
  for (int i = threadIdx.x; i < wn; i += blockDim.x) win[i] = in[w0 + i];
  __syncthreads();
  if (threadIdx.x < 32) {
    WindowImage img{in, out, win, w0, wn, keys, vals, &count,
                    static_cast<int>(blockDim.x), false};
    walk_row(a, row, img);
    if (!img.direct) bar_sync(kCopyBarrier, blockDim.x);
  } else {
    copy_words(in, out, a.len, threadIdx.x - 32, blockDim.x - 32);
    bar_arrive(kCopyBarrier, blockDim.x);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < wn; i += blockDim.x) out[w0 + i] = win[i];
  for (int i = threadIdx.x; i < kLogSlots; i += blockDim.x)
    if (keys[i] != kEmpty) out[keys[i]] = vals[i];
}

__global__ void __launch_bounds__(kThreads)
run_chains_kernel(const int* __restrict__ mems, int* __restrict__ out, int len,
                  int wq_base, int n_wrs, int max_steps) {
  const size_t row = blockIdx.x;
  int* m = out + row * static_cast<size_t>(len);
  copy_words(mems + row * static_cast<size_t>(len), m, len, threadIdx.x,
             blockDim.x);
  __syncthreads();
  if (threadIdx.x != 0) return;
  int head = 0;
  for (int it = 0; it < max_steps; ++it) {
    const int addr = wq_base + floor_mod(head, n_wrs) * kWrWords;
    const int halt = step_wr(m, len, addr);
    head += 1;
    if (halt) break;
  }
}

// One thread times `steps` dependent loads (after as many to warm up) over a
// ring of `words` words, each holding the index of the next, `stride` words
// on: in shared memory (where == 0) or in `buf` through L2 (ld.global.cg).
__global__ void chase_kernel(int* __restrict__ buf,
                             long long* __restrict__ out, int words,
                             int stride, int steps, int where) {
  extern __shared__ int ring_s[];
  int* ring = where == 0 ? ring_s : buf;
  for (int i = threadIdx.x; i < words; i += blockDim.x)
    ring[i] = (i + stride) % words;
  __threadfence_block();
  __syncthreads();
  if (threadIdx.x != 0) return;
  const unsigned base =
      static_cast<unsigned>(__cvta_generic_to_shared(ring_s));
  int j = 0;
  long long t0 = 0;
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) asm volatile("mov.u64 %0, %%clock64;" : "=l"(t0));
    for (int k = 0; k < steps; ++k) {
      if (where == 0)
        asm volatile("ld.shared.u32 %0, [%1];"
                     : "=r"(j) : "r"(base + 4u * static_cast<unsigned>(j)));
      else
        asm volatile("ld.global.cg.u32 %0, [%1];" : "=r"(j) : "l"(buf + j));
    }
  }
  long long t1;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t1));
  out[0] = t1 - t0;
  out[1] = j;
}

}  // namespace

extern "C" {

int chain_vm_run_managed(const void* mems, const void* msgs, const void* inits,
                         void* out, void* stats, int n, int len, int msg_words,
                         int wq_base, int n_wrs, int managed, int max_steps,
                         void* stream) {
  if (n <= 0) return 0;
  const ManagedArgs a{static_cast<const int*>(mems),
                      static_cast<const int*>(msgs),
                      static_cast<const int*>(inits), static_cast<int*>(out),
                      static_cast<int*>(stats), len, msg_words, wq_base, n_wrs,
                      managed, max_steps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (len <= kWholeWords) {
    // past 48 KB a block's dynamic shared memory needs the attribute, set
    // once a device
    static bool raised[64];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (!raised[dev]) {
      err = cudaFuncSetAttribute(managed_whole_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kWholeWords * 4);
      if (err != cudaSuccess) return static_cast<int>(err);
      raised[dev] = true;
    }
    const size_t smem = (static_cast<size_t>(len) * 4 + 15) / 16 * 16;
    managed_whole_kernel<<<n, kWholeThreads, smem, s>>>(a);
  } else {
    // the ring [wq_base, wq_base + 8 n_wrs), clamped into the image and to
    // kWindowWords words
    long long lo = wq_base, hi = wq_base + 8LL * n_wrs;
    lo = lo < 0 ? 0 : (lo > len ? len : lo);
    hi = hi < lo ? lo : (hi > len ? len : hi);
    if (hi - lo > kWindowWords) hi = lo + kWindowWords;
    const int wn = static_cast<int>(hi - lo);
    managed_window_kernel<<<n, kWindowThreads, static_cast<size_t>(wn) * 4,
                            s>>>(a, static_cast<int>(lo), wn);
  }
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

// where 0: a ring of `words` ints in shared memory; 1: in `buf` (through L2)
int chain_vm_chase(void* buf, void* out, int words, int stride, int steps,
                   int where, void* stream) {
  const size_t smem = where == 0 ? static_cast<size_t>(words) * 4 : 0;
  chase_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(buf), static_cast<long long*>(out), words, stride,
      steps, where);
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
