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
//
// The walk kernel (chain_walk_kernel).  Replaces no TPU kernel either: it is
// the counterpart of the JAX package's lax.scan of a write stage's step over
// each owner's receive window (src/repro/rdma/transport.py:196, :202, :271,
// :274), which builds the owner's image from the carry, runs the chain and
// commits, inside the store's jitted programs.  One block an owner, the
// step above (run_steps, shared with chain_interp_kernel, so the clocks, the
// argmin's ties, the index rules and the fault ordinals are one code), and
// the owner's image in global memory for the whole stage, built once from
// the carry.  Each window position in order: a row whose first word is 0 is
// skipped; state0's per-WQ fields are restored and the request delivered as
// machine.deliver_many does; the chain runs to its stop under the row's
// budget and fault row, every store's address logged (a step stores at most
// 16 words, so the fuel bounds the log); then the commit of the program's
// WalkLayout (core/programs.py): where the row's fault row is armed or its
// status commits, each logged carry word keeps the run's write (a mirrored
// row's primary copy winning, both copies set, a new key's home distance
// into the pad words), else it is restored, and every other logged word is
// restored, from a shadow of the image as it stood at the position's start.
// So every position starts from device_state(carry) bit for bit, and the
// plain version (kernels/chain_interp/ref.py::plain_walk, which commits by
// the same rule over whole images) is matched exactly.  Bound: the serial
// floor, the sum over positions of the owners' most steps times a step's
// round trips; an owner's positions cannot overlap.
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
  static constexpr bool kLogged = false;
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
  __device__ __forceinline__ bool st(int i, int v, int) const {
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

  __device__ __forceinline__ void advance(int) {}
};

// A walk's image in global memory, every store's address logged: a step's
// stores go to log[n + slot], slot < 16, and the step then advances n by
// their count (warp 0's registers).
struct LogImage {
  static constexpr bool kLogged = true;
  int* mem;
  int* log;
  int n;

  __device__ __forceinline__ int ld(int i) const { return mem[i]; }

  __device__ __forceinline__ bool st(int i, int v, int slot) const {
    mem[i] = v;
    log[n + slot] = i;
    return false;
  }

  __device__ __forceinline__ void advance(int k) { n += k; }
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

template <bool kOneWarp>
__device__ __forceinline__ void block_sync() {
  if (kOneWarp) __syncwarp(); else __syncthreads();
}

// The per-WQ counters and clocks, in shared memory for a whole run.
struct WqArrays {
  int* head;
  int* tail;
  int* en;
  int* comp;
  int* mhead;
  int* mtail;
  int* ord;
  float* clock;
  float* lct;
};

__device__ __forceinline__ WqArrays carve(int* wq_s, int nq) {
  WqArrays q;
  q.head = wq_s;
  q.tail = q.head + nq;
  q.en = q.tail + nq;
  q.comp = q.en + nq;
  q.mhead = q.comp + nq;
  q.mtail = q.mhead + nq;
  q.ord = q.mtail + nq;
  q.clock = reinterpret_cast<float*>(q.ord + nq);
  q.lct = q.clock + nq;
  return q;
}

// The block's argmin slots across warps and the step's pick, in shared
// memory.
struct Reduce {
  float* key;
  int* idx;
  int* addr;
  int* any;
  int* pick;                             // the step's WQ (-1: none), opcode
};

// What a run reads and does not change: the image length, the message
// slots, the fuel, this thread's WQ geometry, the cost table and the verb
// histogram (shared), and the row's message queues (N, CAP, 16).
struct StepEnv {
  int nq;
  int len;
  int cap;
  int max_steps;
  int base;
  int size;
  int managed;
  const float* cost;
  int* verbs;
  int* msgs;
};

// The row's scalars, alike in every thread (responses: warp 0's).
struct RowScalars {
  int steps;
  bool halted;
  int responses;
  int kill;
  int suppress_at;
  int fail_cas;
  int zero_enable;
  int cas_seen;
  int enable_seen;
};

// The step, shared by both kernels: run the row until it stops, at most
// `quota` steps (negative: no quota), only WQs [lo, hi) eligible.  Every
// thread of the block calls it alike.  `dirty` collects warp 0's window
// flags (split images).
template <bool kOneWarp, class Img>
__device__ __forceinline__ void run_steps(const StepEnv& e, const WqArrays& q,
                                          const Reduce& red, RowScalars& r,
                                          Img& img, bool& dirty, int quota,
                                          int lo, int hi) {
  const int nq = e.nq;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int L = e.len;
  for (int k = 0; quota < 0 || k < quota; ++k) {
    if (r.halted || r.steps >= e.max_steps ||
        (r.kill >= 0 && r.steps >= r.kill))
      break;
    // 1. this thread's WQ: eligible?  (key +inf when not)
    float key = INFINITY;
    int idx = tid < nq ? tid : INT_MAX;
    // every WQ's head address, eligible or not: when every key is +inf
    // the argmin picks the lowest WQ, and the plain loop runs its head WR
    int addr = 0;
    bool eligible = false;
    if (tid < nq)
      addr = wrap_add(e.base, wrap_mul(floor_mod(q.head[tid], e.size),
                                       kWrWords));
    if (tid < nq && tid >= lo && tid < hi) {
      const int h = q.head[tid];
      const int limit = e.managed ? min(q.tail[tid], q.en[tid]) : q.tail[tid];
      if (h < limit) {
        const int ctrl = img.ld(read_index(addr, L));
        const int opa = img.ld(read_index(wrap_add(addr, F_OPA), L));
        const int opb = img.ld(read_index(wrap_add(addr, F_OPB), L));
        const int op = (ctrl >> kIdBits) & 0x7F;
        eligible = (op != WAIT || q.comp[clamp_to(opb, 0, nq - 1)] >= opa)
                   && (op != RECV || q.mtail[tid] > q.mhead[tid]);
        if (eligible) key = q.clock[tid];
      }
    }
    // 2. the argmin over the block, into warp 0
    warp_argmin(key, idx, addr);
    bool any = __ballot_sync(kFullMask, eligible) != 0;
    if (!kOneWarp) {
      if (lane == 0) {
        red.key[warp] = key;
        red.idx[warp] = idx;
        red.addr[warp] = addr;
        red.any[warp] = any;
      }
      __syncthreads();
      if (warp == 0) {
        const bool mine = lane < static_cast<int>(blockDim.x >> 5);
        key = mine ? red.key[lane] : INFINITY;
        idx = mine ? red.idx[lane] : INT_MAX;
        addr = mine ? red.addr[lane] : 0;
        any = __ballot_sync(kFullMask, mine && red.any[lane] != 0) != 0;
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
      const bool suppress = r.suppress_at >= 0 && r.steps == r.suppress_at;
      if (suppress) op = NOOP;
      const bool spur = r.fail_cas >= 0 && op == CAS &&
                        r.cas_seen == r.fail_cas;
      const bool zero = r.zero_enable >= 0 && op == ENABLE &&
                        r.enable_seen == r.zero_enable;
      const int tgt = clamp_to(opb, 0, nq - 1);
      int added = 0;                     // stores made (lane 0's count)
      if (op == WRITE || op == READ || (op == SEND && opb < 0)) {
        // the block copy: the source block read whole, then written
        const int n = clamp_to(ln, 0, kMaxCopy);
        const int cs = block_start(src, L, kMaxCopy);
        const int cd = block_start(dst, L, kMaxCopy);
        int v = 0;
        if (lane < n) v = img.ld(cs + lane);
        __syncwarp();
        if (lane < n) dirty |= img.st(cd + lane, v, lane);
        added = n;
        if (op == SEND) r.responses = wrap_add(r.responses, 1);
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
          if (d < L) dirty |= img.st(d, v, added++);
          if ((op == CAS || op == ADD) && src >= 0 && src < L)
            dirty |= img.st(src, old, added++);
        }
      } else if (op == RECV) {
        // the head message scattered through the table at aux, in order
        if (lane == 0) {
          const int* pay =
              e.msgs + (static_cast<long long>(w) * e.cap +
                        floor_mod(q.mhead[w], e.cap)) * kMsgWords;
          const int at = max(aux, 0);
          const int n = clamp_to(img.ld(read_index(at, L)), 0, kMaxScatter);
          for (int i = 0; i < n; ++i) {
            const int sd = max(img.ld(read_index(wrap_add(at, 1 + i), L)), 0);
            if (sd < L) dirty |= img.st(sd, pay[i], added++);
          }
          q.mhead[w] = wrap_add(q.mhead[w], 1);
        }
      } else if (op == SEND) {
        // to WQ opb's message queue: a 16-word payload from src
        const int ps = block_start(max(src, 0), L, kMsgWords);
        const int slot = floor_mod(q.mtail[tgt], e.cap);
        if (lane < kMsgWords)
          e.msgs[(static_cast<long long>(tgt) * e.cap + slot) * kMsgWords +
                 lane] = img.ld(ps + lane);
        __syncwarp();
        if (lane == 0) q.mtail[tgt] = wrap_add(q.mtail[tgt], 1);
      }
      if constexpr (Img::kLogged)
        img.advance(__shfl_sync(kFullMask, added, 0));
      __syncwarp();
      if (lane == 0) {
        // ENABLE, then the bookkeeping: head, completions, clock, stats
        if (op == ENABLE && !zero) q.en[tgt] = max(q.en[tgt], opa);
        const int h = q.head[w];
        const bool parked = op == WAIT || op == RECV;
        const float fetch = h == 0 ? (parked ? 0.0f : e.cost[kDoorbellAt])
                                   : e.cost[q.ord[w]];
        float t = __fadd_rn(__fadd_rn(q.clock[w], fetch),
                            e.cost[kExecAt + op]);
        if (op == WAIT) t = fmaxf(t, q.lct[tgt]);
        if ((flags & 1) == 0 && !suppress) {
          q.comp[w] = wrap_add(q.comp[w], 1);
          q.lct[w] = t;
        }
        q.head[w] = wrap_add(h, 1);
        q.clock[w] = t;
        e.verbs[op] = wrap_add(e.verbs[op], 1);
      }
    }
    if (kOneWarp) {
      __syncwarp();
    } else {
      if (tid == 0) {
        red.pick[0] = w;
        red.pick[1] = op;
      }
      __syncthreads();
      w = red.pick[0];
      op = red.pick[1];
    }
    if (w < 0) break;
    r.steps = wrap_add(r.steps, 1);
    r.halted = r.halted || op == HALT;
    r.cas_seen += op == CAS;
    r.enable_seen += op == ENABLE;
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
  __shared__ int pick_s[2];

  const int nq = a.n_wq;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int L = a.len;
  const long long row = blockIdx.x;
  const long long rq = row * nq;
  const WqArrays q = carve(wq_s, nq);
  const Reduce red{red_key_s, red_idx_s, red_addr_s, red_any_s, pick_s};
  int* priv_s = reinterpret_cast<int*>(q.lct + nq);
  int* row_mem = a.mem + row * a.priv;
  const int* shard = kSplit ? a.base + row / a.per * L : nullptr;
  Image<kSplit> img{kSplit ? priv_s : row_mem, shard, a.lo, a.hi};
  bool dirty = false;                    // a store would change the window

  int base = 0, size = 1, managed = 0;
  if (tid < nq) {
    base = a.geometry[tid];
    size = a.geometry[nq + tid];
    q.ord[tid] = a.geometry[2 * nq + tid];
    managed = a.geometry[3 * nq + tid];
    q.head[tid] = a.head[rq + tid];
    q.tail[tid] = a.tail[rq + tid];
    q.en[tid] = a.enable_limit[rq + tid];
    q.comp[tid] = a.completions[rq + tid];
    q.mhead[tid] = a.msg_head[rq + tid];
    q.mtail[tid] = a.msg_tail[rq + tid];
    q.clock[tid] = a.clock[rq + tid];
    q.lct[tid] = a.last_comp_time[rq + tid];
  }
  if (tid < kCostWords) cost_s[tid] = a.costs[tid];
  if (tid < kNumOpcodes) verbs_s[tid] = a.verb_counts[row * kNumOpcodes + tid];
  const StepEnv e{nq, L, a.cap, a.max_steps, base, size, managed, cost_s,
                  verbs_s, a.msg_buf + rq * a.cap * kMsgWords};
  RowScalars r{a.steps[row], a.halted[row] != 0, a.responses[row],
               -1, -1, -1, -1, 0, 0};
  if (a.faults != nullptr) {
    r.kill = a.faults[row * 4];
    r.suppress_at = a.faults[row * 4 + 1];
    r.fail_cas = a.faults[row * 4 + 2];
    r.zero_enable = a.faults[row * 4 + 3];
  }
  if (kSplit)
    for (int i = tid; i < a.priv; i += blockDim.x) priv_s[i] = row_mem[i];
  block_sync<kOneWarp>();

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
    run_steps<kOneWarp>(e, q, red, r, img, dirty, quota, lo, hi);
  }

  block_sync<kOneWarp>();
  if (kSplit)
    for (int i = tid; i < a.priv; i += blockDim.x) row_mem[i] = priv_s[i];
  // only warp 0 stores
  if (kSplit && warp == 0) dirty = __any_sync(kFullMask, dirty);
  if (tid < nq) {
    a.head[rq + tid] = q.head[tid];
    a.enable_limit[rq + tid] = q.en[tid];
    a.completions[rq + tid] = q.comp[tid];
    a.msg_head[rq + tid] = q.mhead[tid];
    a.msg_tail[rq + tid] = q.mtail[tid];
    a.clock[rq + tid] = q.clock[tid];
    a.last_comp_time[rq + tid] = q.lct[tid];
  }
  if (tid < kNumOpcodes) a.verb_counts[row * kNumOpcodes + tid] = verbs_s[tid];
  if (tid == 0) {
    a.steps[row] = r.steps;
    a.halted[row] = r.halted;
    a.responses[row] = r.responses;
    if (kSplit) a.changed[row] = dirty;
  }
}

// ---------------------------------------------------------------------------
// the walk kernel
// ---------------------------------------------------------------------------

constexpr int kMaxFrames = 2;
constexpr int kFrameInts = 7;
constexpr int kMaxCommit = 4;
constexpr int kFaultWords = 4;
constexpr unsigned kHashMult = 2654435761u;

struct WalkArgs {
  int* mem;                // (S, L): each owner's image
  int* shadow;             // (S, L): the image at the position's start
  int* msg_buf;            // (S, N, CAP, 16)
  int* log;                // (S, log_cap): the run's store addresses
  int* vals;               // (S, log_cap): a logged carry word's value
  const int* rows;         // (S, P, width): the window
  const int* faults;       // (S, P, 4), or null
  int* resp;               // (S, P, resp_words)
  int* steps;              // (S, P)
  const int* head0;        // (N,) state0's fields
  const int* tail0;
  const int* en0;
  const int* comp0;
  const float* lct0;
  const int* mhead0;
  const int* mtail0;
  const float* clock0;
  const int* geometry;     // (4, N): WR base, WR slots, ordering, managed
  const float* costs;      // kCostWords
  // per frame: table base, values base, carry rows n, image rows, value
  // words, pad carried, home-distance pad (0: none)
  int frames[kMaxFrames * kFrameInts];
  int commit[kMaxCommit];
  int n_frames;
  int n_commit;
  int positions;
  int width;
  int n_wq;
  int len;
  int cap;
  int max_steps;
  int resp_region;
  int resp_words;
  int recv_wq;
  int log_cap;
  int steps0;
  int halted0;
  int responses0;
};

// A logged address as a carry word: its primary and mirror (-1: none)
// addresses, its carry row, and for a key of a home-distance frame the
// frame's carry rows and an empty row's pad; primary -1: no carry word.
struct CarryWord {
  int primary;
  int mirror;
  int row;
  int n;
  int home_pad;
};

__device__ __forceinline__ CarryWord carry_word(const WalkArgs& a, int addr) {
  CarryWord w{-1, -1, 0, 0, 0};
#pragma unroll
  for (int f = 0; f < kMaxFrames; ++f) {
    if (f >= a.n_frames || w.primary >= 0) continue;
    const int tb = a.frames[f * kFrameInts];
    const int vb = a.frames[f * kFrameInts + 1];
    const int n = a.frames[f * kFrameInts + 2];
    const int rows = a.frames[f * kFrameInts + 3];
    const int vl = a.frames[f * kFrameInts + 4];
    const int pad_carried = a.frames[f * kFrameInts + 5];
    const int home_pad = a.frames[f * kFrameInts + 6];
    const int t = addr - tb;
    const int u = addr - vb;
    if (t >= 0 && t < 3 * rows) {
      const int r = t / 3;
      const int c = t - 3 * r;
      if (c == 0 || (c == 1 && pad_carried)) {
        w.row = r < n ? r : r - n;
        w.primary = tb + 3 * w.row + c;
        w.mirror = w.row < rows - n ? w.primary + 3 * n : -1;
        w.n = n;
        w.home_pad = c == 0 ? home_pad : 0;
      }
    } else if (u >= 0 && u < vl * rows) {
      const int r = u / vl;
      w.row = r < n ? r : r - n;
      w.primary = vb + vl * w.row + (u - vl * r);
      w.mirror = w.row < rows - n ? w.primary + vl * n : -1;
    }
  }
  return w;
}

// a bucket row's home distance (the displacer's pad word)
__device__ __forceinline__ int home_distance(int key, int row, int n,
                                             int empty) {
  if (key == 0) return empty;
  const int home = static_cast<int>(static_cast<unsigned>(key) * kHashMult %
                                    static_cast<unsigned>(n));
  return floor_mod(row - home, n);
}

// One block an owner: its window's positions in order over its image.
template <bool kOneWarp>
__global__ void __launch_bounds__(kMaxWqs, 1)
    chain_walk_kernel(const WalkArgs a) {
  extern __shared__ int wq_s[];
  __shared__ float cost_s[kCostWords];
  __shared__ int verbs_s[kNumOpcodes];
  __shared__ float red_key_s[32];
  __shared__ int red_idx_s[32];
  __shared__ int red_addr_s[32];
  __shared__ int red_any_s[32];
  __shared__ int pick_s[2];
  __shared__ int logged_s;

  const int nq = a.n_wq;
  const int tid = threadIdx.x;
  const int L = a.len;
  const long long owner = blockIdx.x;
  const WqArrays q = carve(wq_s, nq);
  const Reduce red{red_key_s, red_idx_s, red_addr_s, red_any_s, pick_s};
  int* mem = a.mem + owner * L;
  int* shadow = a.shadow + owner * L;
  int* log = a.log + owner * a.log_cap;
  int* vals = a.vals + owner * a.log_cap;
  int* msgs = a.msg_buf + owner * nq * a.cap * kMsgWords;

  int base = 0, size = 1, managed = 0;
  if (tid < nq) {
    base = a.geometry[tid];
    size = a.geometry[nq + tid];
    q.ord[tid] = a.geometry[2 * nq + tid];
    managed = a.geometry[3 * nq + tid];
  }
  if (tid < kCostWords) cost_s[tid] = a.costs[tid];
  if (tid < kNumOpcodes) verbs_s[tid] = 0;
  const StepEnv e{nq, L, a.cap, a.max_steps, base, size, managed, cost_s,
                  verbs_s, msgs};
  const int slot0 = floor_mod(a.mtail0[a.recv_wq], a.cap);

  for (int p = 0; p < a.positions; ++p) {
    const long long at = owner * a.positions + p;
    const int* req = a.rows + at * a.width;
    if (req[0] == 0) continue;           // answers zeros, in 0 steps
    // 1. state0's fields, and the request delivered to the receive WQ
    if (tid < nq) {
      q.head[tid] = a.head0[tid];
      q.tail[tid] = a.tail0[tid];
      q.en[tid] = a.en0[tid];
      q.comp[tid] = a.comp0[tid];
      q.mhead[tid] = a.mhead0[tid];
      q.mtail[tid] = tid == a.recv_wq ? wrap_add(a.mtail0[tid], 1)
                                      : a.mtail0[tid];
      q.clock[tid] = a.clock0[tid];
      q.lct[tid] = a.lct0[tid];
    }
    if (tid < kMsgWords)
      msgs[(a.recv_wq * a.cap + slot0) * kMsgWords + tid] =
          tid < a.width ? req[tid] : 0;
    RowScalars r{a.steps0, a.halted0 != 0, a.responses0, -1, -1, -1, -1, 0, 0};
    if (a.faults != nullptr) {
      r.kill = a.faults[at * kFaultWords];
      r.suppress_at = a.faults[at * kFaultWords + 1];
      r.fail_cas = a.faults[at * kFaultWords + 2];
      r.zero_enable = a.faults[at * kFaultWords + 3];
    }
    block_sync<kOneWarp>();
    // 2. the chain run to its stop, every store logged
    LogImage img{mem, log, 0};
    bool dirty = false;
    run_steps<kOneWarp>(e, q, red, r, img, dirty, -1, 0, nq);
    if (tid == 0) logged_s = img.n;
    block_sync<kOneWarp>();
    // 3. the response, the steps, and whether the carry keeps the run's
    // writes: an armed fault row, or a status that commits
    const int status = mem[a.resp_region];
    bool keep = r.kill >= 0 || r.suppress_at >= 0 || r.fail_cas >= 0 ||
                r.zero_enable >= 0;
#pragma unroll
    for (int i = 0; i < kMaxCommit; ++i)
      keep = keep || (i < a.n_commit && status == a.commit[i]);
    if (tid < a.resp_words)
      a.resp[at * a.resp_words + tid] = mem[a.resp_region + tid];
    if (tid == 0) a.steps[at] = r.steps;
    const int logged = logged_s;
    // 4. each logged carry word's value (reads only): the primary copy's
    // write, else the mirror's, else the value at the position's start
    for (int i = tid; i < logged; i += blockDim.x) {
      const CarryWord w = carry_word(a, log[i]);
      if (w.primary < 0) continue;
      const int pre = shadow[w.primary];
      int v = pre;
      if (keep) {
        const int cur = mem[w.primary];
        if (cur != pre)
          v = cur;
        else if (w.mirror >= 0)
          v = mem[w.mirror];
      }
      vals[i] = v;
    }
    block_sync<kOneWarp>();
    // 5. every other logged word back to its value at the position's start
    for (int i = tid; i < logged; i += blockDim.x) {
      const int addr = log[i];
      if (carry_word(a, addr).primary < 0) mem[addr] = shadow[addr];
    }
    block_sync<kOneWarp>();
    // 6. the carry words, both copies, in the image and its shadow, and a
    // new key's home distance
    for (int i = tid; i < logged; i += blockDim.x) {
      const CarryWord w = carry_word(a, log[i]);
      if (w.primary < 0) continue;
      const int v = vals[i];
      mem[w.primary] = v;
      shadow[w.primary] = v;
      if (w.mirror >= 0) {
        mem[w.mirror] = v;
        shadow[w.mirror] = v;
      }
      if (w.home_pad > 0) {
        const int pad = home_distance(v, w.row, w.n, w.home_pad);
        mem[w.primary + 1] = pad;
        shadow[w.primary + 1] = pad;
        if (w.mirror >= 0) {
          mem[w.mirror + 1] = pad;
          shadow[w.mirror + 1] = pad;
        }
      }
    }
    block_sync<kOneWarp>();
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

template <bool kOneWarp>
cudaError_t launch_walk(const WalkArgs& a, int owners, int threads,
                        size_t smem, cudaStream_t s) {
  chain_walk_kernel<kOneWarp><<<owners, threads, smem, s>>>(a);
  return cudaGetLastError();
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

// One launch a stage: owner s's window rows[s] (P positions of `width`
// words) walked over its image mem[s], in place.  `layout`: kMaxFrames
// frames of kFrameInts ints, then kMaxCommit commit statuses.
int chain_walk_run(void* mem, void* shadow, void* msg_buf, void* log,
                   void* vals, const void* rows, const void* faults,
                   void* resp, void* steps, const void* head0,
                   const void* tail0, const void* en0, const void* comp0,
                   const void* lct0, const void* mhead0, const void* mtail0,
                   const void* clock0, const void* geometry,
                   const void* costs, const int* layout, int n_frames,
                   int n_commit, int owners, int positions, int width,
                   int n_wq, int len, int cap, int max_steps,
                   int resp_region, int resp_words, int recv_wq, int log_cap,
                   int steps0, int halted0, int responses0, void* stream) {
  if (owners <= 0 || positions <= 0) return 0;
  if (n_wq < 1 || n_wq > kMaxWqs || n_frames < 1 || n_frames > kMaxFrames ||
      n_commit < 1 || n_commit > kMaxCommit || width < 1 ||
      width > kMsgWords || cap < 1 || len < kMaxCopy || max_steps < 0 ||
      recv_wq < 0 || recv_wq >= n_wq || resp_region < 0 || resp_words < 1 ||
      resp_region > len - resp_words ||
      static_cast<long long>(max_steps) * kMaxCopy > log_cap)
    return static_cast<int>(cudaErrorInvalidValue);
  WalkArgs a{};
  a.mem = static_cast<int*>(mem);
  a.shadow = static_cast<int*>(shadow);
  a.msg_buf = static_cast<int*>(msg_buf);
  a.log = static_cast<int*>(log);
  a.vals = static_cast<int*>(vals);
  a.rows = static_cast<const int*>(rows);
  a.faults = static_cast<const int*>(faults);
  a.resp = static_cast<int*>(resp);
  a.steps = static_cast<int*>(steps);
  a.head0 = static_cast<const int*>(head0);
  a.tail0 = static_cast<const int*>(tail0);
  a.en0 = static_cast<const int*>(en0);
  a.comp0 = static_cast<const int*>(comp0);
  a.lct0 = static_cast<const float*>(lct0);
  a.mhead0 = static_cast<const int*>(mhead0);
  a.mtail0 = static_cast<const int*>(mtail0);
  a.clock0 = static_cast<const float*>(clock0);
  a.geometry = static_cast<const int*>(geometry);
  a.costs = static_cast<const float*>(costs);
  for (int i = 0; i < kMaxFrames * kFrameInts; ++i) a.frames[i] = layout[i];
  for (int i = 0; i < kMaxCommit; ++i)
    a.commit[i] = layout[kMaxFrames * kFrameInts + i];
  a.n_frames = n_frames;
  a.n_commit = n_commit;
  a.positions = positions;
  a.width = width;
  a.n_wq = n_wq;
  a.len = len;
  a.cap = cap;
  a.max_steps = max_steps;
  a.resp_region = resp_region;
  a.resp_words = resp_words;
  a.recv_wq = recv_wq;
  a.log_cap = log_cap;
  a.steps0 = steps0;
  a.halted0 = halted0;
  a.responses0 = responses0;
  const int threads = (n_wq + 31) / 32 * 32;
  const size_t smem = static_cast<size_t>(n_wq) * kWqWords * 4;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(threads == 32
                              ? launch_walk<true>(a, owners, threads, smem, s)
                              : launch_walk<false>(a, owners, threads, smem,
                                                   s));
}

// the dynamic shared memory a split block may take on the current device
int chain_interp_staged_budget(int* out) {
  return static_cast<int>(staged_budget(out));
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
