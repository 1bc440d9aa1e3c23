// Owner-routed fixed-fanout neighbor sampling from one clique's sharded
// topology cache for Hopper (sm_90a).
//
// Replaces the TPU kernel `routed_neighbor_sample` of the reference package
// (src/repro/kernels/gather.py), the routed neighbor exchange of the sharded
// topology cache.  There, inside `shard_map` over the clique axis, every
// device all-gathers the clique's frontier, samples the rows it owns from
// its own CSR shard (the Pallas row gather on a D = 1 int32 column), and one
// `psum` of the +1-shifted samples delivers them to the requesters.  Here
// the whole clique's CSR stacks are addressable from one process, so the
// exchange is one pass that decodes the routing itself, per (row i, draw j):
//
//   o     = min(owner[i], K_g - 1)
//   l     = clamp(local[i], 0, R)          (indptr rows are R + 1 long)
//   start = indptr[o, l]
//   deg   = indptr[o, min(l + 1, R)] - start
//   out[i, j] = indices[o, clamp(start + rand[i, j] mod deg, 0, E - 1)]
//                       if owner[i] >= 0 and deg > 0
//             = -1      otherwise (a topology miss, or an isolated vertex)
//
// `mod` is the floored remainder (the sign of the divisor), as Python,
// NumPy, JAX and PyTorch compute `%`; the draws are in [0, 2^31), where it
// equals C's `%`.  The clamps are the reference's (its dense oracle
// `routed_neighbor_sample_dense`, XLA's clamping gather), and the plain
// version in kernels/ref.py makes the same ones, so the three agree bit for
// bit on any input.  Each shard stores its vertices' adjacency in host
// order, so owned rows equal `host_sample_level` on the same draws.
//
// What bounds it: device-memory bytes.  It does integer arithmetic only, a
// few operations per output.  Per row it reads the routing (8 bytes) and two
// indptr entries (16 bytes), per output one draw (8 bytes) and one neighbor
// id (4 bytes), and writes the output (4 bytes).  At the GraphSAGE cell's
// hop 1 (50,000 frontier rows x 10 draws) that is about 9.2 MB, or about
// 3 us at 3.35 TB/s, so the launch itself costs as much.
//
// Design: one thread per output (i, j), grid-stride; a row's routing and
// indptr loads are repeated by its f threads, which read neighbouring
// addresses and hit in L1.  Integer-only, so the result is exact.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Grid cap, in blocks per SM: each output waits on a chain of dependent
// loads (routing, indptr, neighbor id), so many threads in flight hide it.
constexpr int kBlocksPerSm = 16;

__global__ void routed_neighbor_sample_kernel(
    const int64_t* __restrict__ indptr, const int32_t* __restrict__ indices,
    const int32_t* __restrict__ owner, const int32_t* __restrict__ local,
    const int64_t* __restrict__ rand, int32_t* __restrict__ out, int64_t n,
    int64_t f, int64_t k_g, int64_t indptr_len, int64_t n_indices) {
  const int64_t total = n * f;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int64_t i = t / f;
    const int64_t o_raw = owner[i];
    int32_t v = -1;
    if (o_raw >= 0) {
      const int64_t o = o_raw < k_g ? o_raw : k_g - 1;
      int64_t l = local[i];
      l = l < 0 ? 0 : (l >= indptr_len ? indptr_len - 1 : l);
      const int64_t l1 = l + 1 < indptr_len ? l + 1 : indptr_len - 1;
      const int64_t* row = indptr + o * indptr_len;
      const int64_t start = row[l];
      const int64_t deg = row[l1] - start;
      if (deg > 0) {
        int64_t r = rand[t] % deg;
        if (r < 0) r += deg;
        int64_t idx = start + r;
        idx = idx < 0 ? 0 : (idx >= n_indices ? n_indices - 1 : idx);
        v = indices[o * n_indices + idx];
      }
    }
    out[t] = v;
  }
}

}  // namespace

// C entry point, loaded with ctypes.  Returns the cudaError_t of the launch
// (0 = cudaSuccess); the caller raises on anything else.  k_g, indptr_len
// (R + 1) and n_indices (E) must be >= 1; the caller checks shapes, types and
// contiguity.
extern "C" int routed_neighbor_sample(const void* indptr, const void* indices,
                                      const void* owner, const void* local,
                                      const void* rand, void* out, int64_t n,
                                      int64_t f, int64_t k_g,
                                      int64_t indptr_len, int64_t n_indices,
                                      void* stream) {
  const int64_t total = n * f;
  if (total == 0) return (int)cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t want = (total + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * kBlocksPerSm;
  const int blocks = (int)(want < cap ? want : cap);
  routed_neighbor_sample_kernel<<<blocks, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(indptr), static_cast<const int32_t*>(indices),
      static_cast<const int32_t*>(owner), static_cast<const int32_t*>(local),
      static_cast<const int64_t*>(rand), static_cast<int32_t*>(out), n, f, k_g,
      indptr_len, n_indices);
  return (int)cudaGetLastError();
}
