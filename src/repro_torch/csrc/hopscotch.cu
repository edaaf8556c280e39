// Batched hopscotch GET for Hopper (sm_90a): one thread per query.
//
// Replaces the JAX package's TPU kernel src/repro/kernels/hopscotch/kernel.py
// (_probe_kernel / hopscotch_lookup_pallas).  The query's home bucket is
// (uint32(q) * 2654435761 mod 2^32) mod N; the thread probes the H buckets
// [home, home + H) (wrapping at the table end) in order, takes the FIRST
// bucket whose key equals the query, and copies that bucket's value row as
// exact int32 words.  A miss, and a query of key 0 (the empty marker), give
// found = false and a zero row.  This is what the plain lookup computes
// (repro_torch/kvstore/hopscotch.py::lookup); the TPU kernel's float32 one-hot
// matmul gather was exact only for |value| < 2^24 and for a key present once
// in its neighborhood.
//
// Bound: bytes — each query reads its key, the probed keys up to its first hit
// (H for a miss) and, on a hit, one value row, and writes found plus a row;
// over the card's memory bandwidth (3.35 TB/s on an H100 SXM).  The kernel
// does no arithmetic worth counting.  Design: the probes of one thread are
// dependent scalar loads (latency-bound at small batches); neighbouring
// threads hold unrelated queries, so loads do not coalesce.  Cooperative
// probing (one warp per query, a ballot over the neighborhood) is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kMult = 2654435761u;

__global__ void __launch_bounds__(kThreads)
probe_kernel(const int* __restrict__ keys, const int* __restrict__ values,
             const int* __restrict__ queries, bool* __restrict__ found,
             int* __restrict__ out, int n_buckets, int val_words, int batch,
             int neighborhood) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const int q = queries[b];
  int row = -1;
  if (q != 0) {
    const uint32_t home =
        (static_cast<uint32_t>(q) * kMult) % static_cast<uint32_t>(n_buckets);
    for (int d = 0; d < neighborhood; ++d) {
      const int i = static_cast<int>((home + d) % n_buckets);
      if (keys[i] == q) {
        row = i;
        break;
      }
    }
  }
  found[b] = row >= 0;
  int* o = out + static_cast<size_t>(b) * val_words;
  if (row >= 0) {
    const int* v = values + static_cast<size_t>(row) * val_words;
    for (int k = 0; k < val_words; ++k) o[k] = v[k];
  } else {
    for (int k = 0; k < val_words; ++k) o[k] = 0;
  }
}

}  // namespace

extern "C" {

int hopscotch_lookup(const void* keys, const void* values, const void* queries,
                     void* found, void* out, int n_buckets, int val_words,
                     int batch, int neighborhood, void* stream) {
  if (batch <= 0) return 0;
  const int blocks = (batch + kThreads - 1) / kThreads;
  probe_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), static_cast<const int*>(values),
      static_cast<const int*>(queries), static_cast<bool*>(found),
      static_cast<int*>(out), n_buckets, val_words, batch, neighborhood);
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
