// Peer access between two cards of one host, for the sharded executor's
// routed kernels (routed_gather.cu, routed_neighbor_sample.cu), which read a
// peer card's cache shard through a plain device pointer.  No kernel: a
// plain C entry point around `cudaDeviceEnablePeerAccess`, loaded with
// ctypes by kernels/_build.py (`enable_peer_access`), which calls it once
// per ordered pair of distinct cards in one NVLink clique.
//
// Peer access is a property of the device's primary context, which every
// CUDA runtime of the process (this library's static one and PyTorch's)
// shares, so enabling it here enables it for the kernels launched from any
// of them.  PyTorch may have enabled it already (its own peer copies do):
// cudaErrorPeerAccessAlreadyEnabled counts as success.

#include <cuda_runtime.h>

// Lets kernels running on `device` read and write memory of `peer`.
// Returns the cudaError_t of the call (0 = cudaSuccess); the current device
// of the calling thread is restored.
extern "C" int enable_peer_access(int device, int peer) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();  // not sticky; clear it
      err = cudaSuccess;
    }
  }
  const cudaError_t back = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : back);
}
