// An empty kernel, the floor under any kernel's time as chip_smoke.py
// measures it (CUDA events around one launch queued behind a sleep
// kernel): no kernel launched the same way can take less.  A measuring
// aid only; no wrapper of the port launches it.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel(int) {}

}  // namespace

extern "C" {

// grid blocks of 256 threads on ``stream``: an ordinary launch
// (cooperative = 0) or a cooperative one, as token_position.cu makes.
int empty_launch(int grid, int cooperative, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int unused = 0;
  if (!cooperative) {
    empty_kernel<<<grid, 256, 0, s>>>(unused);
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {&unused};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(empty_kernel), dim3(grid), dim3(256),
      args, 0, s));
}

}  // extern "C"
