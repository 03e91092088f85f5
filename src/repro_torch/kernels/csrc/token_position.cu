// positions_in_expert for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/token_position.py:
// positions_in_expert_pallas (body _kernel): the stable, token-major rank of
// each routed entry within its expert, plus the uncapped per-expert counts.
// Ids outside [0, E) get position 0 and are counted nowhere.
//
// Bound on the H100: bytes.  The op reads F int32 ids and writes F int32
// positions and E int32 counts, a few hundred kB at most, so the floor is
// well under a microsecond; what it really costs is latency.  The Pallas
// grid is sequential and carries the counts from tile to tile; Hopper blocks
// run in no order, so this simple design is ONE block that walks F in tiles
// of 1024 entries in order and keeps the running counts in shared memory.
// Inside a tile each warp ranks equal ids with __match_any_sync and a popc
// under the lane mask, a per-warp histogram in shared memory gives the
// prefix over warps, and the running counts carry over to the next tile.
// Integer arithmetic only, so the result is bitwise that of the plain
// version.  A multi-block version (tile histograms, a scan, then a rank) is
// later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
positions_in_expert_kernel(const int* __restrict__ ids, int F, int E,
                           int* __restrict__ pos, int* __restrict__ counts) {
  extern __shared__ int smem[];
  int* running = smem;        // [E] counts of all earlier tiles
  int* hist = smem + E;       // [kWarps][E] this tile, then its warp prefix
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lanemask_lt = (1u << lane) - 1u;

  for (int e = tid; e < E; e += kThreads) running[e] = 0;

  for (int base = 0; base < F; base += kThreads) {
    for (int i = tid; i < kWarps * E; i += kThreads) hist[i] = 0;
    __syncthreads();

    const int f = base + tid;
    const int id = f < F ? ids[f] : -1;
    const bool valid = f < F && id >= 0 && id < E;
    // lanes of this warp holding the same id (all lanes take part)
    const unsigned peers = __match_any_sync(0xffffffffu, id);
    const int rank = __popc(peers & lanemask_lt);
    if (valid && rank == 0) hist[warp * E + id] = __popc(peers);
    __syncthreads();

    // exclusive prefix over warps, per expert, on top of the running count
    for (int e = tid; e < E; e += kThreads) {
      int run = running[e];
      for (int w = 0; w < kWarps; ++w) {
        const int c = hist[w * E + e];
        hist[w * E + e] = run;
        run += c;
      }
      running[e] = run;
    }
    __syncthreads();

    if (f < F) pos[f] = valid ? hist[warp * E + id] + rank : 0;
    __syncthreads();   // hist is cleared for the next tile
  }
  for (int e = tid; e < E; e += kThreads) counts[e] = running[e];
}

}  // namespace

extern "C" {

// E may be at most 227 KB / ((kWarps + 1) * 4 bytes) = 1760; the Python
// wrapper checks it.
int positions_in_expert_launch(const void* ids, int F, int E, void* pos,
                               void* counts, void* stream) {
  const size_t smem = sizeof(int) * static_cast<size_t>(E) * (kWarps + 1);
  if (smem > 48 * 1024) {   // above 48 KB only after an explicit opt-in
    cudaError_t err = cudaFuncSetAttribute(
        positions_in_expert_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  positions_in_expert_kernel<<<1, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), F, E, static_cast<int*>(pos),
      static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
