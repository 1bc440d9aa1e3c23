// Fused cached-row gather + miss overlay for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_gather_overlay_pallas` of the reference
// package (src/repro/kernels/fused_batch.py), which stages one candidate
// row from each source per grid step through scalar-prefetched maps and
// selects between them in VMEM.
//
//   out[i] = miss_rows[miss_inv[i]]  if miss_inv[i] >= 0
//          = table[idx[i]]           else if idx[i] >= 0
//          = 0                       otherwise (bucket padding)
//
// What bounds it: device-memory bytes.  It does no arithmetic; every output
// row is one row copy or one zero fill.  At the serving shape (B = 70,656
// rows of 128 f32, about 28k of them real) it reads about 14.4 MB of source
// rows and 0.57 MB of indices and writes 36.2 MB: about 51 MB, or about
// 15 us at the H100's 3.35 TB/s.
//
// Design (an earlier one gave each warp one row at a time, so each warp
// had one 512-byte row in flight behind two dependent map loads, and its
// grid ran in about 8 waves): a persistent grid, as many blocks as are
// resident on the card, whose warps take runs of kRun = 8 output rows, so
// that the real rows, which a bucket-padded batch holds at its front, are
// spread over most warps.  Lane l < 8 loads both map entries of row r0 + l
// (one coalesced load per map per run, the next run's issued before this
// run's rows) and picks that row's source row, or none; the warp then
// copies the run's output bytes, which are contiguous, as a flat stream
// of vectors: each lane issues kLoads vector loads (from the source row
// the vector's row names, its pointer broadcast by `__shfl_sync`) before
// any of their stores, so a warp keeps kLoads x 512 bytes in flight (a
// whole run of 512-byte rows), and rows of any
// width (D = 100 included, wider than 512 bytes too) pack the lanes
// densely.  Padding rows store zeros without loading.  The vector is 16
// bytes when the row width and every base pointer allow it, else 4, else
// 1.  Only the chosen source is read (the TPU kernel streamed both).
// Because it copies bytes it serves any element type (f32, bf16) by
// element size.  Indices are clamped into range as XLA's gather clamps
// them, so the kernel and the plain version agree bit for bit on any
// input.  The miss source wins when both maps claim a row.  Stores are
// plain: the forward reads the block next, and at the serving shape it
// fits the 50 MB L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kRun = 8;     // output rows per warp run (lanes < kRun map)
constexpr int kLoads = 8;   // vector loads in flight per lane

template <typename V>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
fused_gather_overlay_kernel(
    const char* __restrict__ table, const char* __restrict__ miss_rows,
    const int32_t* __restrict__ idx, const int32_t* __restrict__ miss_inv,
    char* __restrict__ out, int64_t n_rows, int64_t n_table, int64_t n_miss,
    int64_t row_bytes) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kWarpsPerBlock;
  const int64_t n_runs = (n_rows + kRun - 1) / kRun;
  const uint32_t n_vec = (uint32_t)(row_bytes / (int64_t)sizeof(V));
  int64_t run = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  // lane l < kRun holds the two map entries of row r0 + l; the next run's
  // are loaded while this run's rows are in flight
  int32_t inv = -1, slot = -1;
  if (lane < kRun && run * kRun + lane < n_rows) {
    inv = __ldg(miss_inv + run * kRun + lane);
    slot = __ldg(idx + run * kRun + lane);
  }
  for (; run < n_runs; run += warps) {
    const int64_t r0 = run * kRun;
    const char* src = nullptr;
    if (inv >= 0) {
      src = miss_rows + (int64_t)min(inv, (int32_t)(n_miss - 1)) * row_bytes;
    } else if (slot >= 0) {
      src = table + (int64_t)min(slot, (int32_t)(n_table - 1)) * row_bytes;
    }
    const int64_t next = (run + warps) * kRun + lane;
    inv = slot = -1;
    if (lane < kRun && next < n_rows) {
      inv = __ldg(miss_inv + next);
      slot = __ldg(idx + next);
    }
    const int64_t left = n_rows - r0;
    const uint32_t n_elem = (uint32_t)(left < kRun ? left : kRun) * n_vec;
    V* dst = reinterpret_cast<V*>(out + r0 * row_bytes);
    // n_elem is the same on every lane, so every lane takes every shuffle
    for (uint32_t base = lane; base < n_elem + lane; base += 32 * kLoads) {
      V v[kLoads];
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const uint32_t e = base + 32 * i;
        const uint32_t r = e / n_vec;
        const unsigned long long s = __shfl_sync(
            0xffffffffu, reinterpret_cast<unsigned long long>(src),
            (int)(r < kRun ? r : kRun - 1));
        v[i] = V{};
        if (e < n_elem && s != 0ull)
          v[i] = __ldg(reinterpret_cast<const V*>(s) + (e - r * n_vec));
      }
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const uint32_t e = base + 32 * i;
        if (e < n_elem) dst[e] = v[i];
      }
    }
  }
}

template <typename V>
cudaError_t launch(const void* table, const void* miss_rows, const void* idx,
                   const void* miss_inv, void* out, int64_t n_rows,
                   int64_t n_table, int64_t n_miss, int64_t row_bytes,
                   cudaStream_t stream) {
  // resident blocks on the card, once per vector width
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fused_gather_overlay_kernel<V>, 32 * kWarpsPerBlock, 0);
    if (err != cudaSuccess) return err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t runs = (n_rows + kRun - 1) / kRun;
  const int64_t want = (runs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int blocks = (int)(want < resident ? want : resident);
  fused_gather_overlay_kernel<V><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      static_cast<const char*>(table), static_cast<const char*>(miss_rows),
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(miss_inv),
      static_cast<char*>(out), n_rows, n_table, n_miss, row_bytes);
  return cudaGetLastError();
}

bool aligned(const void* p, int64_t a) {
  return reinterpret_cast<uintptr_t>(p) % (uintptr_t)a == 0;
}

}  // namespace

// C entry point, loaded with ctypes.  Returns the cudaError_t of the launch
// (0 = cudaSuccess); the caller raises on anything else.  n_table and n_miss
// must be >= 1; the caller checks shapes, types and contiguity.
extern "C" int fused_gather_overlay(const void* table, const void* miss_rows,
                                    const void* idx, const void* miss_inv,
                                    void* out, int64_t n_rows, int64_t n_table,
                                    int64_t n_miss, int64_t row_bytes,
                                    void* stream) {
  if (n_rows == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto fits = [&](int64_t w) {
    return row_bytes % w == 0 && aligned(table, w) && aligned(miss_rows, w) &&
           aligned(out, w);
  };
  if (fits(16))
    return (int)launch<uint4>(table, miss_rows, idx, miss_inv, out, n_rows,
                              n_table, n_miss, row_bytes, s);
  if (fits(4))
    return (int)launch<uint32_t>(table, miss_rows, idx, miss_inv, out, n_rows,
                                 n_table, n_miss, row_bytes, s);
  return (int)launch<uint8_t>(table, miss_rows, idx, miss_inv, out, n_rows,
                              n_table, n_miss, row_bytes, s);
}
