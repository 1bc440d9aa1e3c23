// Owner-routed row gather over one clique's cache shards for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `routed_gather` of the reference package
// (src/repro/kernels/gather.py), the sharded executor's intra-clique
// exchange.  There, inside `shard_map` over the clique axis, every device
// all-gathers the clique's (owner, local) requests, serves the rows it owns
// from its own shard with the Pallas row gather, and one `psum` routes each
// row back to its requester.  Here each shard is its own allocation, on the
// card of the mesh position that owns it, and the requesting position reads
// its own shard and its peers' through a table of the K_g shard base
// pointers (a peer card's memory over NVLink once peer access is on; on one
// card, plain device memory), so the exchange is one gather that decodes the
// routing itself:
//
//   out[i] = base[min(owner[i], K_g - 1)] row clamp(local[i], 0, R - 1)
//                                          if owner[i] >= 0
//          = 0                             otherwise (a host-fill miss)
//
// An owner past K_g - 1 is clamped, not rejected, and so is a local slot
// outside [0, R): that is what the reference's dense oracle
// (`routed_gather_dense`, XLA's clamping gather) does, and the plain
// versions in kernels/ref.py (`routed_gather_peer`, and
// `routed_gather_dense` over the stacked shards) do the same, so they agree
// bit for bit on any input.
//
// Bitwise parity with the reference's shard_map form: its psum adds the
// owner's row to K_g - 1 zero rows, which turns a -0.0 element into +0.0
// when K_g >= 2.  The sharded step adds the host-staged miss rows (0.0 at
// every cached row) right after this gather, and -0.0 + 0.0 is +0.0 as
// well, so the step's `feats` agree bit for bit; the raw gather agrees with
// the dense oracle, not with the psum.
//
// What bounds it: device-memory bytes (NVLink's where a shard lies on a
// peer card).  It does no arithmetic.  At the sharded GraphSAGE cell (batch
// 8000 = 2000 seeds per mesh position, fanouts (25, 10), 128 f32 columns)
// one position requests n_pad rows, most of them cached in its clique: each
// distinct owned row is read once, the two routing maps once, and every
// output row is written once.
//
// Design: one warp per output row, grid-stride, as gather_rows.cu.  The
// shard table (at most kMaxShards base pointers) is a `__grid_constant__`
// kernel argument: it lives in the parameter space, every lane of a warp
// reads the same entry (one row, one owner), and it costs no memory trip.
// The warp reads its row's owner and local slot, clamps them, and copies
// the 512-byte row with 16-byte vector loads and stores when the row width
// and every base pointer allow it, else 4-byte words, else single bytes
// (f32 and bf16 at any width take the same code).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
// Grid cap, in blocks per SM (see gather_rows.cu): each warp's copy waits on
// two dependent loads (the routing, then the row), so many warps in flight
// hide that latency.
constexpr int kBlocksPerSm = 64;
// The most shards one table holds: the largest NVLink clique of one host.
constexpr int kMaxShards = 8;

// The clique's shard base pointers, shard gi's (R, row_bytes) rows at
// base[gi]; passed by value as a `__grid_constant__` argument.
struct ShardTable {
  const char* base[kMaxShards];
};

template <typename V>
__global__ void routed_gather_kernel(const __grid_constant__ ShardTable t,
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
      const char* base = t.base[o < k_g ? o : k_g - 1];
      const V* s = reinterpret_cast<const V*>(base + l * row_bytes);
      for (int64_t j = lane; j < n_vec; j += 32) dst[j] = __ldg(s + j);
    } else {
      const V zero{};
      for (int64_t j = lane; j < n_vec; j += 32) dst[j] = zero;
    }
  }
}

template <typename V>
cudaError_t launch(const ShardTable& t, const void* owner, const void* local,
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
      t, static_cast<const int32_t*>(owner),
      static_cast<const int32_t*>(local), static_cast<char*>(out), n_rows, k_g,
      n_shard_rows, row_bytes);
  return cudaGetLastError();
}

bool aligned(const void* p, int64_t a) {
  return reinterpret_cast<uintptr_t>(p) % (uintptr_t)a == 0;
}

}  // namespace

// C entry point, loaded with ctypes.  `shards` is a host array of the k_g
// shard base pointers (device addresses, on this card or on a peer card
// with peer access on), 1 <= k_g <= kMaxShards.  Returns the cudaError_t of
// the launch (0 = cudaSuccess; cudaErrorInvalidValue for k_g out of range);
// the caller raises on anything else.  n_shard_rows must be >= 1; the caller
// checks shapes, types and contiguity.
extern "C" int routed_gather(const void* const* shards, const void* owner,
                             const void* local, void* out, int64_t n_rows,
                             int64_t k_g, int64_t n_shard_rows,
                             int64_t row_bytes, void* stream) {
  if (k_g < 1 || k_g > kMaxShards) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ShardTable t{};
  for (int64_t gi = 0; gi < k_g; ++gi)
    t.base[gi] = static_cast<const char*>(shards[gi]);
  auto fits = [&](int64_t w) {
    if (row_bytes % w != 0 || !aligned(out, w)) return false;
    for (int64_t gi = 0; gi < k_g; ++gi)
      if (!aligned(t.base[gi], w)) return false;
    return true;
  };
  if (fits(16))
    return (int)launch<uint4>(t, owner, local, out, n_rows, k_g,
                              n_shard_rows, row_bytes, s);
  if (fits(4))
    return (int)launch<uint32_t>(t, owner, local, out, n_rows, k_g,
                                 n_shard_rows, row_bytes, s);
  return (int)launch<uint8_t>(t, owner, local, out, n_rows, k_g,
                              n_shard_rows, row_bytes, s);
}
