// Grid sizes for kernels whose warps stay resident and walk their work
// (fused_wire.cu, wire_quant.cu).
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>

namespace occupancy {

constexpr int kMaxDevices = 64;

// As many blocks of kKernel (``threads`` a block, always the same for a
// kernel; no dynamic shared memory) as are resident at once on the
// current device, and no more than ``want``.  The occupancy is asked once
// a device and kept.
template <auto kKernel>
cudaError_t resident_blocks(int threads, int want, int* grid) {
  static std::atomic<int> resident[kMaxDevices];   // 0: not asked yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int n = dev < kMaxDevices ? resident[dev].load(std::memory_order_relaxed)
                            : 0;
  if (n == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernel,
                                                          threads, 0);
    if (err != cudaSuccess) return err;
    n = std::max(1, sms * per_sm);
    if (dev < kMaxDevices) resident[dev].store(n, std::memory_order_relaxed);
  }
  *grid = std::max(1, std::min(want, n));
  return cudaSuccess;
}

}  // namespace occupancy
