// Owner-routed fixed-fanout neighbor sampling from one clique's sharded
// topology cache for Hopper (sm_90a).
//
// Replaces the TPU kernel `routed_neighbor_sample` of the reference package
// (src/repro/kernels/gather.py), the routed neighbor exchange of the sharded
// topology cache.  There, inside `shard_map` over the clique axis, every
// device all-gathers the clique's frontier, samples the rows it owns from
// its own CSR shard (the Pallas row gather on a D = 1 int32 column), and one
// `psum` of the +1-shifted samples delivers them to the requesters.  Here
// each CSR shard is its own pair of allocations on the card of the mesh
// position that owns it, and the sampling position reads its own shard and
// its peers' through a table of base pointers (the K_g `indptr` and the K_g
// `indices` bases: a peer card's memory over NVLink once peer access is on;
// on one card, plain device memory), so the exchange is one pass that
// decodes the routing itself, per (row i, draw j):
//
//   o     = min(owner[i], K_g - 1)
//   l     = clamp(local[i], 0, R)          (indptr rows are R + 1 long)
//   start = indptr[o][l]
//   deg   = indptr[o][min(l + 1, R)] - start
//   out[i, j] = indices[o][clamp(start + rand[i, j] mod deg, 0, E - 1)]
//                       if owner[i] >= 0 and deg > 0
//             = -1      otherwise (a topology miss, or an isolated vertex)
//
// `mod` is the floored remainder (the sign of the divisor), as Python,
// NumPy, JAX and PyTorch compute `%`; the draws are in [0, 2^31), where it
// equals C's `%`.  The clamps are the reference's (its dense oracle
// `routed_neighbor_sample_dense`, XLA's clamping gather), and the plain
// versions in kernels/ref.py (`routed_neighbor_sample_peer`, and the dense
// form over the stacked shards) make the same ones, so they agree bit for
// bit on any input.  Every shard of a clique has the clique's common R + 1
// and E, as each device's array does under the reference's shard_map.
// Each shard stores its vertices' adjacency in host order, so owned rows
// equal `host_sample_level` on the same draws.
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
// addresses and hit in L1.  Integer-only, so the result is exact.  The
// shard table (at most kMaxShards pairs of base pointers) is a
// `__grid_constant__` kernel argument: it lives in the parameter space and
// costs no memory trip; threads of one warp that route to different shards
// read different entries, which the constant cache serves one after the
// other (at most K_g of them).
//
// The chain entry, `routed_neighbor_sample_chain`, runs every hop of one
// device-sampling chain (`CliqueCache.device_sample_chain`) in ONE launch
// and decodes the vertex -> (owner, slot) routing itself, which the per-hop
// entry leaves to its caller.  Per hop k, for frontier row v (the seeds at
// hop 0, hop k-1's flattened output after):
//
//   v < 0                         -> a miss (hit 0), f_k outputs of -1
//   o = topo_owner[min(v, N - 1)] -> a miss if o < 0, else the routing above
//                                    with local = topo_local[min(v, N - 1)]
//
// which is the reference's glue (`device_sample_cached` in sharded mode,
// src/repro/core/unified_cache.py) composed with the formula above: a -1
// parent gives a child miss, degree 0 gives -1, an empty topology cache
// (every owner -1) gives all -1.  Each hop's neighbors (n_k, f_k) int32 and
// its hit flags (n_k,) uint8 go to one packed buffer, which the caller reads
// back with one copy.
// The routing tables (`topo_owner`, `topo_local`: every card of the clique
// holds a copy) and the packed buffer lie on the sampling position's card;
// the CSR shards are read through the same shard table as the per-hop
// entry's, a member of the chain's `__grid_constant__` arguments.
//
// What bounds the chain: latency.  Each seed's sampling tree is
// independent, and at fanouts (25, 10) a whole chain is 7 dependent memory
// trips (the seed, its routing, its indptr entries, the neighbor id, then
// routing, indptr and neighbor ids again for the next hop) over a few MB:
// the byte bound is about 2-3 us, the trips on a cold L2 several times
// that.  Design: one launch for the whole chain, no barrier and no shared
// memory.  A thread owns up to 4 outputs of one row of the last hop and
// walks that row's path from its seed, hop by hop (the rows on the path
// follow from the thread's index by division by the fanouts); every draw
// it needs is loaded before the walk starts, so only the 7 trips are
// serial.  The threads of one subtree sit next to each other, so the
// ancestors they share are loaded once from device memory and then hit in
// L1; the first thread below a row writes that row's hit flag and its
// parent's output.  The rows on the path are unsigned 32-bit (the caller
// keeps the last hop's rows times threads per row below 2^31), and `mod` is an
// unsigned 32-bit remainder where the draw and the degree fit 32 bits
// (the sampler's draws are below 2^31; for a non-negative draw it is the
// floored remainder exactly), else the 64-bit floored one.  (A first
// design sampled each hop into shared memory between barriers; every
// barrier waited for the slowest load of its block, and it was slower.)

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Grid cap, in blocks per SM: each output waits on a chain of dependent
// loads (routing, indptr, neighbor id), so many threads in flight hide it.
constexpr int kBlocksPerSm = 16;
// The most shards one table holds: the largest NVLink clique of one host.
constexpr int kMaxShards = 8;

// One clique's CSR shards: shard gi's (R + 1) offsets at indptr[gi] and its
// E neighbor ids at indices[gi]; passed by value as a `__grid_constant__`
// argument (the per-hop kernel's, and a member of the chain's).
struct CsrTable {
  const int64_t* indptr[kMaxShards];
  const int32_t* indices[kMaxShards];
};

__global__ void routed_neighbor_sample_kernel(
    const __grid_constant__ CsrTable csr, const int32_t* __restrict__ owner,
    const int32_t* __restrict__ local, const int64_t* __restrict__ rand,
    int32_t* __restrict__ out, int64_t n,
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
      const int64_t* row = csr.indptr[o];
      const int64_t start = row[l];
      const int64_t deg = row[l1] - start;
      if (deg > 0) {
        int64_t r = rand[t] % deg;
        if (r < 0) r += deg;
        int64_t idx = start + r;
        idx = idx < 0 ? 0 : (idx >= n_indices ? n_indices - 1 : idx);
        v = csr.indices[o][idx];
      }
    }
    out[t] = v;
  }
}

constexpr int kMaxHops = 4;
constexpr int kChainThreads = 256;
constexpr int kChunk = 4;  // last-hop outputs per thread, at most

struct ChainArgs {
  CsrTable csr;
  const int32_t* topo_owner;
  const int64_t* topo_local;
  const int64_t* seeds;
  const int64_t* rand[kMaxHops];  // hop k's (n_k, f_k) draws
  int32_t* out[kMaxHops];         // hop k's (n_k, f_k) neighbors
  uint8_t* hit[kMaxHops];         // hop k's (n_k,) hit flags
  int64_t n_vertices, k_g, indptr_len, n_indices;
  uint32_t fanout[kMaxHops];
  uint32_t n_threads;  // rows of the last hop x threads per row
  uint32_t per_row;    // threads per row of the last hop
  uint32_t chunk;      // the last hop's outputs per thread
};

// A frontier vertex's routing: owner shard (-1: a miss), CSR start, degree.
struct Route {
  int32_t o;
  int64_t start, deg;
};

__device__ __forceinline__ Route route(const ChainArgs& a, int64_t v) {
  Route r{-1, 0, 0};
  if (v < 0) return r;
  v = v < a.n_vertices ? v : a.n_vertices - 1;
  const int32_t o = __ldg(a.topo_owner + v);
  int64_t l = __ldg(a.topo_local + v);
  if (o < 0) return r;
  const int64_t R = a.indptr_len - 1;
  r.o = o < a.k_g ? o : (int32_t)(a.k_g - 1);
  l = l < 0 ? 0 : (l > R ? R : l);
  const int64_t* row = a.csr.indptr[r.o];
  r.start = __ldg(row + l);
  r.deg = __ldg(row + (l + 1 < R ? l + 1 : R)) - r.start;
  return r;
}

// floored `draw mod deg` for deg > 0
__device__ __forceinline__ int64_t floored_mod(int64_t draw, int64_t deg) {
  if ((uint64_t)draw <= 0xffffffffull && deg <= 0xffffffffll)
    return (int64_t)((uint32_t)draw % (uint32_t)deg);
  const int64_t r = draw % deg;
  return r < 0 ? r + deg : r;
}

__device__ __forceinline__ int32_t neighbor(const ChainArgs& a,
                                            const Route& r, int64_t draw) {
  if (r.o < 0 || r.deg <= 0) return -1;
  int64_t i = r.start + floored_mod(draw, r.deg);
  i = i < 0 ? 0 : (i >= a.n_indices ? a.n_indices - 1 : i);
  return __ldg(a.csr.indices[r.o] + i);
}

// `__grid_constant__`: the helpers take the arguments by reference, which
// must not copy them to local memory
template <int H>
__global__ void __launch_bounds__(kChainThreads)
routed_neighbor_sample_chain_kernel(const __grid_constant__ ChainArgs a) {
  const uint32_t t = blockIdx.x * (uint32_t)kChainThreads + threadIdx.x;
  if (t >= a.n_threads) return;
  // this thread's row at every hop, and whether it is the first thread
  // below that row (which writes its hit flag and its parent's output)
  uint32_t row[H];
  bool first[H];
  const uint32_t c = t % a.per_row;
  row[H - 1] = t / a.per_row;
  first[H - 1] = c == 0;
#pragma unroll
  for (int k = H - 2; k >= 0; --k) {
    row[k] = row[k + 1] / a.fanout[k];
    first[k] = first[k + 1] && row[k + 1] == row[k] * a.fanout[k];
  }
  // every draw first: the hops' draws on the path, the last hop's chunk
  int64_t d[H > 1 ? H - 1 : 1];
#pragma unroll
  for (int k = 0; k + 1 < H; ++k) d[k] = __ldg(a.rand[k] + row[k + 1]);
  const uint32_t f = a.fanout[H - 1];
  const uint32_t j0 = c * a.chunk;
  const uint32_t nj = j0 >= f ? 0 : (f - j0 < a.chunk ? f - j0 : a.chunk);
  const int64_t base = (int64_t)row[H - 1] * f + j0;
  int64_t last[kChunk];
#pragma unroll
  for (uint32_t j = 0; j < kChunk; ++j)
    last[j] = j < nj ? __ldg(a.rand[H - 1] + base + j) : 0;
  // the walk
  int64_t v = __ldg(a.seeds + row[0]);
#pragma unroll
  for (int k = 0; k + 1 < H; ++k) {
    const Route r = route(a, v);
    if (first[k]) a.hit[k][row[k]] = r.o >= 0;
    const int32_t nb = neighbor(a, r, d[k]);
    if (first[k + 1]) a.out[k][row[k + 1]] = nb;
    v = nb;
  }
  const Route r = route(a, v);
  if (first[H - 1]) a.hit[H - 1][row[H - 1]] = r.o >= 0;
  int32_t nb[kChunk];
#pragma unroll
  for (uint32_t j = 0; j < kChunk; ++j)
    nb[j] = j < nj ? neighbor(a, r, last[j]) : -1;
#pragma unroll
  for (uint32_t j = 0; j < kChunk; ++j)
    if (j < nj) a.out[H - 1][base + j] = nb[j];
}

template <int H>
cudaError_t launch_chain(const ChainArgs& a, cudaStream_t stream) {
  const uint32_t blocks = (a.n_threads + kChainThreads - 1) / kChainThreads;
  routed_neighbor_sample_chain_kernel<H>
      <<<blocks, kChainThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// The shard table from host arrays of k_g base pointers; false when k_g is
// out of [1, kMaxShards].
bool csr_table(CsrTable* t, const void* const* indptr,
               const void* const* indices, int64_t k_g) {
  if (k_g < 1 || k_g > kMaxShards) return false;
  for (int64_t gi = 0; gi < k_g; ++gi) {
    t->indptr[gi] = static_cast<const int64_t*>(indptr[gi]);
    t->indices[gi] = static_cast<const int32_t*>(indices[gi]);
  }
  return true;
}

}  // namespace

// C entry point, loaded with ctypes.  `indptr` and `indices` are host arrays
// of the k_g shards' base pointers (device addresses, on this card or on a
// peer card with peer access on), 1 <= k_g <= kMaxShards.  Returns the
// cudaError_t of the launch (0 = cudaSuccess; cudaErrorInvalidValue for k_g
// out of range); the caller raises on anything else.  indptr_len (R + 1) and
// n_indices (E) must be >= 1; the caller checks shapes, types and
// contiguity.
extern "C" int routed_neighbor_sample(const void* const* indptr,
                                      const void* const* indices,
                                      const void* owner, const void* local,
                                      const void* rand, void* out, int64_t n,
                                      int64_t f, int64_t k_g,
                                      int64_t indptr_len, int64_t n_indices,
                                      void* stream) {
  CsrTable csr{};
  if (!csr_table(&csr, indptr, indices, k_g))
    return (int)cudaErrorInvalidValue;
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
      csr, static_cast<const int32_t*>(owner),
      static_cast<const int32_t*>(local), static_cast<const int64_t*>(rand),
      static_cast<int32_t*>(out), n, f, k_g, indptr_len, n_indices);
  return (int)cudaGetLastError();
}

// C entry point of the chain, loaded with ctypes.  `indptr` and `indices`
// are host arrays of the k_g shards' base pointers, as for the per-hop
// entry; `topo_owner` and `topo_local` lie on this card.  `rands` and
// `fanouts` are host arrays of `hops` entries (1 <= hops <= 4): the device
// pointer of hop
// k's (n_k, f_k) int64 draws and f_k.  `out` gets every hop's (n_k, f_k)
// int32 neighbors one after the other, `hit` every hop's (n_k,) uint8 hit
// flags.  Returns the cudaError_t of the launch (cudaErrorInvalidValue when
// k_g is out of [1, kMaxShards] or the last hop's rows times threads per row
// reach 2^31: the caller checks both first, with shapes, types and
// contiguity).
extern "C" int routed_neighbor_sample_chain(
    const void* const* indptr, const void* const* indices,
    const void* topo_owner, const void* topo_local, const void* seeds,
    const void* const* rands,
    const int32_t* fanouts, int32_t hops, void* out, void* hit,
    int64_t n_seeds, int64_t n_vertices, int64_t k_g, int64_t indptr_len,
    int64_t n_indices, void* stream) {
  if (hops < 1 || hops > kMaxHops) return (int)cudaErrorInvalidValue;
  ChainArgs a{};
  if (!csr_table(&a.csr, indptr, indices, k_g))
    return (int)cudaErrorInvalidValue;
  if (n_seeds == 0) return (int)cudaSuccess;
  a.topo_owner = static_cast<const int32_t*>(topo_owner);
  a.topo_local = static_cast<const int64_t*>(topo_local);
  a.seeds = static_cast<const int64_t*>(seeds);
  a.n_vertices = n_vertices;
  a.k_g = k_g;
  a.indptr_len = indptr_len;
  a.n_indices = n_indices;
  // the hops' blocks in the packed buffers; the walk stops after the first
  // hop of fanout 0 (the hops after it have no rows)
  int64_t rows = n_seeds, out_off = 0, hit_off = 0;
  int walk = 0;
  for (int k = 0; k < hops; ++k) {
    if (fanouts[k] < 0) return (int)cudaErrorInvalidValue;
    a.rand[k] = static_cast<const int64_t*>(rands[k]);
    a.out[k] = static_cast<int32_t*>(out) + out_off;
    a.hit[k] = static_cast<uint8_t*>(hit) + hit_off;
    a.fanout[k] = (uint32_t)fanouts[k];
    out_off += rows * fanouts[k];
    hit_off += rows;
    rows *= fanouts[k];
    if (walk == 0 && (fanouts[k] == 0 || k + 1 == hops)) walk = k + 1;
  }
  // rows of the last walked hop, threads per row, outputs per thread
  rows = n_seeds;
  for (int k = 0; k + 1 < walk; ++k) rows *= fanouts[k];
  const int64_t f = fanouts[walk - 1];
  const int64_t per_row = f > kChunk ? (f + kChunk - 1) / kChunk : 1;
  if (rows * per_row >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  a.n_threads = (uint32_t)(rows * per_row);
  a.per_row = (uint32_t)per_row;
  a.chunk = (uint32_t)((f + per_row - 1) / per_row);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (walk) {
    case 1: return (int)launch_chain<1>(a, s);
    case 2: return (int)launch_chain<2>(a, s);
    case 3: return (int)launch_chain<3>(a, s);
    default: return (int)launch_chain<4>(a, s);
  }
}
