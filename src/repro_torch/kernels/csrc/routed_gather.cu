// Owner-routed row gather from one clique's shard stack for Hopper (sm_90a).
//
// Replaces the TPU kernel `routed_gather` of the reference package
// (src/repro/kernels/gather.py), the sharded executor's intra-clique
// exchange.  There, inside `shard_map` over the clique axis, every device
// all-gathers the clique's (owner, local) requests, serves the rows it owns
// from its own shard with the Pallas row gather, and one `psum` routes each
// row back to its requester.  Here the whole clique's shard stack is
// addressable from one process (every mesh position is bound to a device of
// this host), so the exchange is one gather that decodes the routing itself:
//
//   out[i] = shards[min(owner[i], K_g - 1), clamp(local[i], 0, R - 1)]
//                                          if owner[i] >= 0
//          = 0                             otherwise (a host-fill miss)
//
// An owner past K_g - 1 is clamped, not rejected, and so is a local slot
// outside [0, R): that is what the reference's dense oracle
// (`routed_gather_dense`, XLA's clamping gather) does, and the plain version
// in kernels/ref.py does the same, so the two agree bit for bit on any input.
//
// Bitwise parity with the reference's shard_map form: its psum adds the
// owner's row to K_g - 1 zero rows, which turns a -0.0 element into +0.0
// when K_g >= 2.  The sharded step adds the host-staged miss rows (0.0 at
// every cached row) right after this gather, and -0.0 + 0.0 is +0.0 as
// well, so the step's `feats` agree bit for bit; the raw gather agrees with
// the dense oracle, not with the psum.
//
// What bounds it: device-memory bytes.  It does no arithmetic.  At the
// sharded GraphSAGE cell (batch 8000 = 2000 seeds per mesh position,
// fanouts (25, 10), 128 f32 columns) one position requests n_pad rows, most
// of them cached in its clique: each distinct owned row is read once, the
// two routing maps once, and every output row is written once.
//
// Design: one warp per output row, grid-stride, as gather_rows.cu.  The warp
// reads its row's owner and local slot, clamps them, and copies the 512-byte
// row with 16-byte vector loads and stores when the row width and both base
// pointers allow it, else 4-byte words, else single bytes (f32 and bf16 at
// any width take the same code).  On one card the peer shard is plain device
// memory; a multi-card clique would read it over NVLink with peer access.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
// Grid cap, in blocks per SM (see gather_rows.cu): each warp's copy waits on
// two dependent loads (the routing, then the row), so many warps in flight
// hide that latency.
constexpr int kBlocksPerSm = 64;

template <typename V>
__global__ void routed_gather_kernel(const char* __restrict__ shards,
                                     const int32_t* __restrict__ owner,
                                     const int32_t* __restrict__ local,
                                     char* __restrict__ out, int64_t n_rows,
                                     int64_t k_g, int64_t n_shard_rows,
                                     int64_t row_bytes) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kWarpsPerBlock;
  const int64_t n_vec = row_bytes / (int64_t)sizeof(V);
  for (int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       row < n_rows; row += warps) {
    const int64_t o = __ldg(owner + row);
    V* dst = reinterpret_cast<V*>(out + row * row_bytes);
    if (o >= 0) {
      int64_t l = __ldg(local + row);
      l = l < 0 ? 0 : (l >= n_shard_rows ? n_shard_rows - 1 : l);
      const int64_t s_row = (o < k_g ? o : k_g - 1) * n_shard_rows + l;
      const V* s = reinterpret_cast<const V*>(shards + s_row * row_bytes);
      for (int64_t j = lane; j < n_vec; j += 32) dst[j] = __ldg(s + j);
    } else {
      const V zero{};
      for (int64_t j = lane; j < n_vec; j += 32) dst[j] = zero;
    }
  }
}

template <typename V>
cudaError_t launch(const void* shards, const void* owner, const void* local,
                   void* out, int64_t n_rows, int64_t k_g,
                   int64_t n_shard_rows, int64_t row_bytes,
                   cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t want = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t cap = (int64_t)sms * kBlocksPerSm;
  const int blocks = (int)(want < cap ? want : cap);
  routed_gather_kernel<V><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      static_cast<const char*>(shards), static_cast<const int32_t*>(owner),
      static_cast<const int32_t*>(local), static_cast<char*>(out), n_rows, k_g,
      n_shard_rows, row_bytes);
  return cudaGetLastError();
}

bool aligned(const void* p, int64_t a) {
  return reinterpret_cast<uintptr_t>(p) % (uintptr_t)a == 0;
}

}  // namespace

// C entry point, loaded with ctypes.  Returns the cudaError_t of the launch
// (0 = cudaSuccess); the caller raises on anything else.  k_g and
// n_shard_rows must be >= 1; the caller checks shapes, types and contiguity.
extern "C" int routed_gather(const void* shards, const void* owner,
                             const void* local, void* out, int64_t n_rows,
                             int64_t k_g, int64_t n_shard_rows,
                             int64_t row_bytes, void* stream) {
  if (n_rows == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto fits = [&](int64_t w) {
    return row_bytes % w == 0 && aligned(shards, w) && aligned(out, w);
  };
  if (fits(16))
    return (int)launch<uint4>(shards, owner, local, out, n_rows, k_g,
                              n_shard_rows, row_bytes, s);
  if (fits(4))
    return (int)launch<uint32_t>(shards, owner, local, out, n_rows, k_g,
                                 n_shard_rows, row_bytes, s);
  return (int)launch<uint8_t>(shards, owner, local, out, n_rows, k_g,
                              n_shard_rows, row_bytes, s);
}
