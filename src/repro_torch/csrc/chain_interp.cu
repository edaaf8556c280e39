// Chain-VM interpreter kernel for Hopper (sm_90a): every row (client context)
// of a batched VMState runs to its own stop in one launch, in place.
//
// Replaces no TPU kernel.  It is the counterpart of the JAX package's
// machine.run (src/repro/core/machine.py:447), a lax.while_loop inside jit
// that runs on the device, vmapped over contexts by run_batch, and of
// run_scheduled's lax.scan of per-writer while loops: a whole batch runs to
// quiescence as one device program, with no host round trip.  The plain
// version is the port's host loop (repro_torch/core/machine.py::_run_rows,
// one WR a row a step, a host read of the row flags each step), which the
// kernel matches bit for bit, latency clocks included:
//   * a WQ is eligible when head < (managed ? min(tail, enable_limit) : tail)
//     and its head WR is neither a WAIT whose target's completions are below
//     opa nor a RECV with an empty message queue (the opcode unclipped here),
//     and, under a schedule, the WQ is the current writer's;
//   * the row stops when nothing is eligible, on HALT, at steps >= max_steps,
//     at a kill fault (steps >= kill) or at its quota for the current
//     (round, writer);
//   * the eligible WQ with the least clock runs next, the lowest index on a
//     tie (an ineligible WQ's clock counts as +inf); the WR's 8 fields are
//     read before any write of the step and its opcode is clipped to [0, 12]
//     (13..127 execute as HALT);
//   * a suppress fault turns the WR scheduled at step `suppress` into a NOOP
//     that signals no completion; the CAS and ENABLE faults index the CAS and
//     ENABLE verbs executed after suppression (counted here, per row);
//   * float32 clocks: t = (clock + fetch) + exec as two rounded adds, WAIT
//     then max(t, last_comp_time[target]); the tables come from core/cost.py;
//   * int32 arithmetic wraps (done in unsigned), % is floor-mod, a read wraps
//     a negative index once and clamps it into the image, a scalar store past
//     the image is dropped, a 16-word block's start is wrapped and clamped
//     into [0, L - 16].
//
// The image.  A row's image of L words may be split (machine.SharedBatch):
// the words [lo, hi), the shared window, are read from its shard's image
// base[row / per], which every context of the shard reads and none writes;
// the other P = L - (hi - lo) words are the row's private segment, (B, P).
// A full batch (P = L) runs the instances without a window.  Every access
// first applies the index rules above over the virtual length L, then one
// translation maps the word to the private segment or to base (a copy
// block straddling lo or hi is translated word by word, a lane a word).  A
// store that would change a window word is not made: it flags the row, and
// the wrapper raises; a store of the value the word holds changes nothing.
// So a run that is not refused equals the full-copy run bit for bit.
//
// Staging.  A split batch's private words are copied into shared memory at
// launch (opted in past 48 KB, with the per-WQ arrays) and back at the
// end, so the head WRs, the chosen WR and every private read-modify-write
// are shared-memory trips; only window reads (the probe READs and value
// rows of a GET) reach L2.  A full batch runs in global memory: its whole
// images staged the same way ran slower on the card (fewer blocks
// resident, and an image that small is served from L1 anyway).
//
// Bound: a step is a chain of dependent round trips (the head WRs' words
// for eligibility, the argmin's shuffles, the chosen WR's fields, the
// read-modify-write or scatter, the store), so a row is bound by its steps
// times those latencies: a serial floor, not bytes or operations.  Rows are
// independent machines, one block each, spread over the SMs.
//
// Design: one block a row, one thread a WQ (rounded up to warps, at most
// 1,024).  The per-WQ counters and clocks sit in shared memory for the whole
// run; the message queues stay in global memory.  A step: each
// thread tests its own WQ, an argmin over (clock, index) by shuffles (and
// across warps through shared memory) picks the WR, and warp 0 executes it:
// 16 lanes for a copy block or a SEND's payload, lane 0 for the scalar
// effects, the RECV scatter (walked in order: entry i is read after the
// stores of entries < i) and the bookkeeping.  The verbs' micro-effects are
// exclusive by opcode, so each step runs one of them.  Programs of at most 32
// WQs run as one warp with __syncwarp alone; larger ones take two
// __syncthreads a step.  The row's scalars (steps, halted, the fault
// ordinals) live in registers, updated alike by every thread.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWrWords = 8;
constexpr int kMaxCopy = 16;
constexpr int kMaxScatter = 16;
constexpr int kMsgWords = 16;
constexpr int kNumOpcodes = 13;
constexpr int kIdBits = 24;
constexpr int kOrderings = 3;
constexpr int kMaxWqs = 1024;
constexpr int kWqWords = 9;            // shared words a WQ
// the cost table: fetch by ordering, exec by opcode, then the doorbell
constexpr int kExecAt = kOrderings;
constexpr int kDoorbellAt = kOrderings + kNumOpcodes;
constexpr int kCostWords = kDoorbellAt + 1;
constexpr unsigned kFullMask = 0xffffffffu;

enum Opcode {
  NOOP = 0, WRITE = 1, WRITE_IMM = 2, READ = 3, SEND = 4, RECV = 5, CAS = 6,
  ADD = 7, MAX = 8, MIN = 9, WAIT = 10, ENABLE = 11, HALT = 12
};

enum Field { F_CTRL = 0, F_FLAGS = 1, F_SRC = 2, F_DST = 3, F_LEN = 4,
             F_OPA = 5, F_OPB = 6, F_AUX = 7 };

struct InterpArgs {
  int* mem;                // (B, P): each row's private words
  const int* base;         // (G, L): the shards' images (the window); or null
  int* changed;            // (B,): 1 where a store would change the window
  int* head;               // (B, N)
  const int* tail;         // (B, N), never written
  int* enable_limit;       // (B, N)
  int* completions;        // (B, N)
  float* last_comp_time;   // (B, N)
  int* msg_buf;            // (B, N, CAP, 16)
  int* msg_head;           // (B, N)
  int* msg_tail;           // (B, N)
  float* clock;            // (B, N)
  int* steps;              // (B,)
  unsigned char* halted;   // (B,) bool storage
  int* verb_counts;        // (B, 13)
  int* responses;          // (B,)
  const int* geometry;     // (4, N): WR base, WR slots, ordering, managed
  const float* costs;      // kCostWords
  const int* faults;       // (B, 4): kill, suppress, cas, enable; or null
  const int* quota;        // (R, W) a row, rows quota_stride apart; or null
  const int* slices;       // (W, 2): writer w owns WQs [lo, hi)
  int quota_stride;
  int n_rounds;
  int n_writers;
  int n_wq;
  int len;                 // L, the virtual image length
  int cap;
  int max_steps;
  int per;                 // rows a base image
  int lo;                  // the window [lo, hi) of base, or L, L
  int hi;
  int priv;                // P = L - (hi - lo)
};

// A row's image: split, words [lo, hi) in its shard's image `base`,
// read-only, and the rest in `priv` (staged in shared memory), in image
// order; else all of it in `priv` (global memory).  Indices are in [0, L),
// after the index rules.
template <bool kSplit>
struct Image {
  int* priv;
  const int* base;
  int lo;
  int hi;

  __device__ __forceinline__ int ld(int i) const {
    if constexpr (kSplit) {
      if (i >= hi) return priv[i - (hi - lo)];
      if (i >= lo) return base[i];
    }
    return priv[i];
  }

  // store v at i; returns whether it would change a window word (then it
  // is not made)
  __device__ __forceinline__ bool st(int i, int v) const {
    if constexpr (kSplit) {
      if (i >= hi) {
        priv[i - (hi - lo)] = v;
        return false;
      }
      if (i >= lo) return base[i] != v;
    }
    priv[i] = v;
    return false;
  }
};

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// b > 0
__device__ __forceinline__ int floor_mod(int a, int b) {
  const int r = a % b;
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

__device__ __forceinline__ int clamp_to(int n, int lo, int hi) {
  return n < lo ? lo : (n > hi ? hi : n);
}

// (key, idx, addr) of the least key, the lowest idx on a tie, left in lane 0
__device__ __forceinline__ void warp_argmin(float& key, int& idx, int& addr) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ok = __shfl_down_sync(kFullMask, key, off);
    const int oi = __shfl_down_sync(kFullMask, idx, off);
    const int oa = __shfl_down_sync(kFullMask, addr, off);
    if (ok < key || (ok == key && oi < idx)) {
      key = ok;
      idx = oi;
      addr = oa;
    }
  }
}

// kSplit: a split batch, its private words staged in shared memory
template <bool kOneWarp, bool kSplit>
__global__ void __launch_bounds__(kMaxWqs, 1)
    chain_interp_kernel(const InterpArgs a) {
  extern __shared__ int wq_s[];
  __shared__ float cost_s[kCostWords];
  __shared__ int verbs_s[kNumOpcodes];
  __shared__ float red_key_s[32];
  __shared__ int red_idx_s[32];
  __shared__ int red_addr_s[32];
  __shared__ int red_any_s[32];
  __shared__ int pick_s[2];              // the step's WQ (-1: none), opcode

  const int nq = a.n_wq;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int L = a.len;
  const long long row = blockIdx.x;
  const long long rq = row * nq;
  int* head_s = wq_s;
  int* tail_s = head_s + nq;
  int* en_s = tail_s + nq;
  int* comp_s = en_s + nq;
  int* mhead_s = comp_s + nq;
  int* mtail_s = mhead_s + nq;
  int* ord_s = mtail_s + nq;
  float* clock_s = reinterpret_cast<float*>(ord_s + nq);
  float* lct_s = clock_s + nq;
  int* priv_s = reinterpret_cast<int*>(lct_s + nq);
  int* row_mem = a.mem + row * a.priv;
  const int* shard = kSplit ? a.base + row / a.per * L : nullptr;
  const Image<kSplit> img{kSplit ? priv_s : row_mem, shard, a.lo, a.hi};
  bool dirty = false;                    // a store would change the window
  int* msgs = a.msg_buf + rq * a.cap * kMsgWords;

  int base = 0, size = 1, managed = 0;
  if (tid < nq) {
    base = a.geometry[tid];
    size = a.geometry[nq + tid];
    ord_s[tid] = a.geometry[2 * nq + tid];
    managed = a.geometry[3 * nq + tid];
    head_s[tid] = a.head[rq + tid];
    tail_s[tid] = a.tail[rq + tid];
    en_s[tid] = a.enable_limit[rq + tid];
    comp_s[tid] = a.completions[rq + tid];
    mhead_s[tid] = a.msg_head[rq + tid];
    mtail_s[tid] = a.msg_tail[rq + tid];
    clock_s[tid] = a.clock[rq + tid];
    lct_s[tid] = a.last_comp_time[rq + tid];
  }
  if (tid < kCostWords) cost_s[tid] = a.costs[tid];
  if (tid < kNumOpcodes) verbs_s[tid] = a.verb_counts[row * kNumOpcodes + tid];
  // the row's scalars, alike in every thread (responses: warp 0's)
  int steps = a.steps[row];
  bool halted = a.halted[row] != 0;
  int responses = a.responses[row];
  int kill = -1, suppress_at = -1, fail_cas = -1, zero_enable = -1;
  if (a.faults != nullptr) {
    kill = a.faults[row * 4];
    suppress_at = a.faults[row * 4 + 1];
    fail_cas = a.faults[row * 4 + 2];
    zero_enable = a.faults[row * 4 + 3];
  }
  int cas_seen = 0, enable_seen = 0;
  if (kSplit)
    for (int i = tid; i < a.priv; i += blockDim.x) priv_s[i] = row_mem[i];
  if (kOneWarp) __syncwarp(); else __syncthreads();

  const int segments = a.quota != nullptr ? a.n_rounds * a.n_writers : 1;
  for (int g = 0; g < segments; ++g) {
    int quota = -1, lo = 0, hi = nq;
    if (a.quota != nullptr) {
      quota = a.quota[row * a.quota_stride + g];
      if (quota == 0) continue;
      const int writer = g % a.n_writers;
      lo = a.slices[2 * writer];
      hi = a.slices[2 * writer + 1];
    }
    for (int k = 0; quota < 0 || k < quota; ++k) {
      if (halted || steps >= a.max_steps || (kill >= 0 && steps >= kill))
        break;
      // 1. this thread's WQ: eligible?  (key +inf when not)
      float key = INFINITY;
      int idx = tid < nq ? tid : INT_MAX;
      // every WQ's head address, eligible or not: when every key is +inf
      // the argmin picks the lowest WQ, and the plain loop runs its head WR
      int addr = 0;
      bool eligible = false;
      if (tid < nq)
        addr = wrap_add(base, wrap_mul(floor_mod(head_s[tid], size),
                                       kWrWords));
      if (tid < nq && tid >= lo && tid < hi) {
        const int h = head_s[tid];
        const int limit = managed ? min(tail_s[tid], en_s[tid]) : tail_s[tid];
        if (h < limit) {
          const int ctrl = img.ld(read_index(addr, L));
          const int opa = img.ld(read_index(wrap_add(addr, F_OPA), L));
          const int opb = img.ld(read_index(wrap_add(addr, F_OPB), L));
          const int op = (ctrl >> kIdBits) & 0x7F;
          eligible = (op != WAIT || comp_s[clamp_to(opb, 0, nq - 1)] >= opa)
                     && (op != RECV || mtail_s[tid] > mhead_s[tid]);
          if (eligible) key = clock_s[tid];
        }
      }
      // 2. the argmin over the block, into warp 0
      warp_argmin(key, idx, addr);
      bool any = __ballot_sync(kFullMask, eligible) != 0;
      if (!kOneWarp) {
        if (lane == 0) {
          red_key_s[warp] = key;
          red_idx_s[warp] = idx;
          red_addr_s[warp] = addr;
          red_any_s[warp] = any;
        }
        __syncthreads();
        if (warp == 0) {
          const bool mine = lane < static_cast<int>(blockDim.x >> 5);
          key = mine ? red_key_s[lane] : INFINITY;
          idx = mine ? red_idx_s[lane] : INT_MAX;
          addr = mine ? red_addr_s[lane] : 0;
          any = __ballot_sync(kFullMask, mine && red_any_s[lane] != 0) != 0;
          warp_argmin(key, idx, addr);
        }
      }
      // 3. warp 0 executes the WR
      int w = -1, op = NOOP;
      if (warp == 0 && any) {
        w = __shfl_sync(kFullMask, idx, 0);
        addr = __shfl_sync(kFullMask, addr, 0);
        int word = 0;
        if (lane < kWrWords) word = img.ld(read_index(wrap_add(addr, lane), L));
        const int ctrl = __shfl_sync(kFullMask, word, F_CTRL);
        const int flags = __shfl_sync(kFullMask, word, F_FLAGS);
        const int src = __shfl_sync(kFullMask, word, F_SRC);
        const int dst = __shfl_sync(kFullMask, word, F_DST);
        const int ln = __shfl_sync(kFullMask, word, F_LEN);
        const int opa = __shfl_sync(kFullMask, word, F_OPA);
        const int opb = __shfl_sync(kFullMask, word, F_OPB);
        const int aux = __shfl_sync(kFullMask, word, F_AUX);
        op = min((ctrl >> kIdBits) & 0x7F, kNumOpcodes - 1);
        const bool suppress = suppress_at >= 0 && steps == suppress_at;
        if (suppress) op = NOOP;
        const bool spur = fail_cas >= 0 && op == CAS && cas_seen == fail_cas;
        const bool zero = zero_enable >= 0 && op == ENABLE &&
                          enable_seen == zero_enable;
        const int tgt = clamp_to(opb, 0, nq - 1);
        if (op == WRITE || op == READ || (op == SEND && opb < 0)) {
          // the block copy: the source block read whole, then written
          const int n = clamp_to(ln, 0, kMaxCopy);
          const int cs = block_start(src, L, kMaxCopy);
          const int cd = block_start(dst, L, kMaxCopy);
          int v = 0;
          if (lane < n) v = img.ld(cs + lane);
          __syncwarp();
          if (lane < n) dirty |= img.st(cd + lane, v);
          if (op == SEND) responses = wrap_add(responses, 1);
        } else if (op == WRITE_IMM || op == CAS || op == ADD || op == MAX ||
                   op == MIN) {
          // the read-modify-write store, then the atomics' return-old
          if (lane == 0) {
            const int d = max(dst, 0);
            const int old = img.ld(min(d, L - 1));
            int v = opa;
            if (op == CAS) v = old == opa && !spur ? opb : old;
            if (op == ADD) v = wrap_add(old, opa);
            if (op == MAX) v = max(old, opa);
            if (op == MIN) v = min(old, opa);
            if (d < L) dirty |= img.st(d, v);
            if ((op == CAS || op == ADD) && src >= 0 && src < L)
              dirty |= img.st(src, old);
          }
        } else if (op == RECV) {
          // the head message scattered through the table at aux, in order
          if (lane == 0) {
            const int* pay =
                msgs + (static_cast<long long>(w) * a.cap +
                        floor_mod(mhead_s[w], a.cap)) * kMsgWords;
            const int at = max(aux, 0);
            const int n = clamp_to(img.ld(read_index(at, L)), 0, kMaxScatter);
            for (int i = 0; i < n; ++i) {
              const int sd = max(img.ld(read_index(wrap_add(at, 1 + i), L)), 0);
              if (sd < L) dirty |= img.st(sd, pay[i]);
            }
            mhead_s[w] = wrap_add(mhead_s[w], 1);
          }
        } else if (op == SEND) {
          // to WQ opb's message queue: a 16-word payload from src
          const int ps = block_start(max(src, 0), L, kMsgWords);
          const int slot = floor_mod(mtail_s[tgt], a.cap);
          if (lane < kMsgWords)
            msgs[(static_cast<long long>(tgt) * a.cap + slot) * kMsgWords +
                 lane] = img.ld(ps + lane);
          __syncwarp();
          if (lane == 0) mtail_s[tgt] = wrap_add(mtail_s[tgt], 1);
        }
        __syncwarp();
        if (lane == 0) {
          // ENABLE, then the bookkeeping: head, completions, clock, stats
          if (op == ENABLE && !zero) en_s[tgt] = max(en_s[tgt], opa);
          const int h = head_s[w];
          const bool parked = op == WAIT || op == RECV;
          const float fetch = h == 0 ? (parked ? 0.0f : cost_s[kDoorbellAt])
                                     : cost_s[ord_s[w]];
          float t = __fadd_rn(__fadd_rn(clock_s[w], fetch),
                              cost_s[kExecAt + op]);
          if (op == WAIT) t = fmaxf(t, lct_s[tgt]);
          if ((flags & 1) == 0 && !suppress) {
            comp_s[w] = wrap_add(comp_s[w], 1);
            lct_s[w] = t;
          }
          head_s[w] = wrap_add(h, 1);
          clock_s[w] = t;
          verbs_s[op] = wrap_add(verbs_s[op], 1);
        }
      }
      if (kOneWarp) {
        __syncwarp();
      } else {
        if (tid == 0) {
          pick_s[0] = w;
          pick_s[1] = op;
        }
        __syncthreads();
        w = pick_s[0];
        op = pick_s[1];
      }
      if (w < 0) break;
      steps = wrap_add(steps, 1);
      halted = halted || op == HALT;
      cas_seen += op == CAS;
      enable_seen += op == ENABLE;
    }
  }

  if (kOneWarp) __syncwarp(); else __syncthreads();
  if (kSplit)
    for (int i = tid; i < a.priv; i += blockDim.x) row_mem[i] = priv_s[i];
  // only warp 0 stores
  if (kSplit && warp == 0) dirty = __any_sync(kFullMask, dirty);
  if (tid < nq) {
    a.head[rq + tid] = head_s[tid];
    a.enable_limit[rq + tid] = en_s[tid];
    a.completions[rq + tid] = comp_s[tid];
    a.msg_head[rq + tid] = mhead_s[tid];
    a.msg_tail[rq + tid] = mtail_s[tid];
    a.clock[rq + tid] = clock_s[tid];
    a.last_comp_time[rq + tid] = lct_s[tid];
  }
  if (tid < kNumOpcodes) a.verb_counts[row * kNumOpcodes + tid] = verbs_s[tid];
  if (tid == 0) {
    a.steps[row] = steps;
    a.halted[row] = halted;
    a.responses[row] = responses;
    if (kSplit) a.changed[row] = dirty;
  }
}

template <bool kSplit>
cudaError_t launch(const InterpArgs& a, int batch, int threads, size_t smem,
                   cudaStream_t s) {
  if (threads == 32)
    chain_interp_kernel<true, kSplit><<<batch, threads, smem, s>>>(a);
  else
    chain_interp_kernel<false, kSplit><<<batch, threads, smem, s>>>(a);
  return cudaGetLastError();
}

// past 48 KB a block's dynamic shared memory needs the attribute
cudaError_t allow_smem(int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      chain_interp_kernel<true, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(chain_interp_kernel<false, true>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// the dynamic shared memory a split block may take: the device's opt-in
// limit less the kernel's static arrays (alike in every instance)
cudaError_t staged_budget(int* out) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes one, many;
  err = cudaFuncGetAttributes(&one, chain_interp_kernel<true, true>);
  if (err != cudaSuccess) return err;
  err = cudaFuncGetAttributes(&many, chain_interp_kernel<false, true>);
  if (err != cudaSuccess) return err;
  const size_t fixed = one.sharedSizeBytes > many.sharedSizeBytes
                           ? one.sharedSizeBytes : many.sharedSizeBytes;
  *out = optin - static_cast<int>(fixed);
  return cudaSuccess;
}

}  // namespace

extern "C" {

int chain_interp_run(void* mem, void* head, const void* tail,
                     void* enable_limit, void* completions,
                     void* last_comp_time, void* msg_buf, void* msg_head,
                     void* msg_tail, void* clock, void* steps, void* halted,
                     void* verb_counts, void* responses, const void* geometry,
                     const void* costs, const void* faults, const void* quota,
                     const void* slices, const void* base, void* changed,
                     int quota_stride, int n_rounds, int n_writers, int batch,
                     int n_wq, int len, int cap, int max_steps, int per,
                     int lo, int hi, void* stream) {
  if (batch <= 0) return 0;
  // split: a base image every `per` rows, a window, a flag a row
  const bool split = base != nullptr;
  if (n_wq < 1 || n_wq > kMaxWqs || per < 1 || lo < 0 || lo > hi ||
      hi > len || split != (changed != nullptr) || (!split && lo != hi))
    return static_cast<int>(cudaErrorInvalidValue);
  const int priv = len - (hi - lo);
  const InterpArgs a{
      static_cast<int*>(mem), static_cast<const int*>(base),
      static_cast<int*>(changed), static_cast<int*>(head),
      static_cast<const int*>(tail), static_cast<int*>(enable_limit),
      static_cast<int*>(completions), static_cast<float*>(last_comp_time),
      static_cast<int*>(msg_buf), static_cast<int*>(msg_head),
      static_cast<int*>(msg_tail), static_cast<float*>(clock),
      static_cast<int*>(steps), static_cast<unsigned char*>(halted),
      static_cast<int*>(verb_counts), static_cast<int*>(responses),
      static_cast<const int*>(geometry), static_cast<const float*>(costs),
      static_cast<const int*>(faults), static_cast<const int*>(quota),
      static_cast<const int*>(slices), quota_stride, n_rounds, n_writers,
      n_wq, len, cap, max_steps, per, lo, hi, priv};
  const int threads = (n_wq + 31) / 32 * 32;
  size_t smem = static_cast<size_t>(n_wq) * kWqWords * 4;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!split) return static_cast<int>(launch<false>(a, batch, threads, smem,
                                                    s));
  // the split instances may take the whole budget, set once a device
  static int budget[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (budget[dev] == 0) {
    int b = 0;
    err = staged_budget(&b);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = allow_smem(b);
    if (err != cudaSuccess) return static_cast<int>(err);
    budget[dev] = b;
  }
  smem += static_cast<size_t>(priv) * 4;
  if (smem > static_cast<size_t>(budget[dev]))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<true>(a, batch, threads, smem, s));
}

// the dynamic shared memory a split block may take on the current device
int chain_interp_staged_budget(int* out) {
  return static_cast<int>(staged_budget(out));
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
