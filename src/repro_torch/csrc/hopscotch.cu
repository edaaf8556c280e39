// Batched hopscotch GET for Hopper (sm_90a): a group of lanes per query.
//
// Replaces the JAX package's TPU kernel src/repro/kernels/hopscotch/kernel.py
// (_probe_kernel / hopscotch_lookup_pallas).  The query's home bucket is
// (uint32(q) * 2654435761 mod 2^32) mod N; of the H buckets [home, home + H)
// (wrapping at the table end) the FIRST whose key equals the query wins, and
// that bucket's value row is copied as exact int32 words.  A miss, and a
// query of key 0 (the empty marker), give found = false and a zero row.
// This is what the plain lookup computes
// (repro_torch/kvstore/hopscotch.py::lookup); the TPU kernel's float32 one-hot
// matmul gather was exact only for |value| < 2^24 and for a key present once
// in its neighborhood.
//
// Bound: bytes — each query reads its key, the probed keys up to its first hit
// (H for a miss) and, on a hit, one value row, and writes found plus a row;
// over the card's memory bandwidth (3.35 TB/s on an H100 SXM).  The kernel
// does no arithmetic worth counting, and at a few thousand queries a launch
// lasts far longer than those bytes take: its time is the launch's fixed
// cost plus the latency of its chain of dependent loads.  Design: a group of
// G lanes serves one query, G the neighborhood rounded up to a power of two
// and at most 32 (H 8: four queries a warp).  The group reads the
// neighborhood's keys in one coalesced step, a ballot over the group's bits
// and a find-first-set pick the first hit, and the group's lanes copy the
// row's words together; H > 32 walks 32-bucket windows in order, so the
// first hit still wins.  The chain is three loads (the query, the keys, the
// row) where one thread a query walked up to H dependent key loads and then
// the row's words.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr uint32_t kMult = 2654435761u;

__global__ void __launch_bounds__(kThreads)
probe_kernel(const int* __restrict__ keys, const int* __restrict__ values,
             const int* __restrict__ queries, bool* __restrict__ found,
             int* __restrict__ out, int n_buckets, int val_words, int batch,
             int neighborhood, int group) {
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  const long long b = tid / group;                // the group's query
  if (b >= batch) return;                         // the whole group leaves
  const int lane = threadIdx.x % 32;
  const int gl = lane & (group - 1);              // lane within the group
  const int g0 = lane - gl;                       // the group's first lane
  const uint32_t gmask =
      group == 32 ? 0xffffffffu : ((1u << group) - 1) << g0;
  const int q = queries[b];
  int row = -1;
  if (q != 0) {
    const uint32_t home =
        (static_cast<uint32_t>(q) * kMult) % static_cast<uint32_t>(n_buckets);
    for (int w = 0; w < neighborhood; w += group) {
      const int d = w + gl;
      const bool hit = d < neighborhood &&
          keys[(home + d) % static_cast<uint32_t>(n_buckets)] == q;
      const uint32_t bits = __ballot_sync(gmask, hit) & gmask;
      if (bits) {
        const int first = __ffs(bits >> g0) - 1;
        row = static_cast<int>((home + w + first) %
                               static_cast<uint32_t>(n_buckets));
        break;
      }
    }
  }
  if (gl == 0) found[b] = row >= 0;
  int* o = out + b * val_words;
  if (row >= 0) {
    const int* v = values + static_cast<size_t>(row) * val_words;
    for (int k = gl; k < val_words; k += group) o[k] = v[k];
  } else {
    for (int k = gl; k < val_words; k += group) o[k] = 0;
  }
}

}  // namespace

extern "C" {

int hopscotch_lookup(const void* keys, const void* values, const void* queries,
                     void* found, void* out, int n_buckets, int val_words,
                     int batch, int neighborhood, void* stream) {
  if (batch <= 0) return 0;
  if (n_buckets <= 0 || val_words < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int group = 1;                // lanes a query: H up to a power of two, <= 32
  while (group < neighborhood && group < 32) group *= 2;
  const long long threads = static_cast<long long>(batch) * group;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  probe_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), static_cast<const int*>(values),
      static_cast<const int*>(queries), static_cast<bool*>(found),
      static_cast<int*>(out), n_buckets, val_words, batch, neighborhood,
      group);
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
