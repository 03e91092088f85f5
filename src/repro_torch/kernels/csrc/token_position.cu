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
// grid is sequential and carries the counts from tile to tile.
//
// Design: F is cut into tiles of kThreads entries, one entry a thread, and
// each block of a cooperative grid (at most one block an SM) owns a run of
// consecutive tiles.  Inside a tile each warp ranks equal ids with
// __match_any_sync and a popc under the lane mask, and a per-warp
// histogram in shared memory gives the prefix over the warps in warp
// order.
//   phase 1: each block counts its tiles' ids by expert and writes the
//     [E] totals to its row of a [grid, E] int32 scratch;
//   grid.sync();
//   phase 2: each block adds the rows of the earlier blocks (integer
//     adds, so their order does not matter) to get its base, then walks
//     its tiles in order, placing each entry at base + the counts of the
//     earlier tiles and warps + its rank in the warp.  The last block's
//     running counts are the totals: it writes counts.
// A block keeps its first tile's ranks and warp histogram from phase 1,
// so at the training shape (F = 32768, 128 blocks of one tile) no id is
// read twice.  A call of one tile (the decode shape) is one ordinary
// launch of one block, with no scratch and no grid barrier.  Every
// position comes from the entries' order, never from an atomic
// increment, so the result is bitwise that of the plain version.
//
// The first version was one block of 1024 threads that walked all tiles
// in order (0.0552 ms at the training shape, 131 SMs idle).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;   // = the entries of a tile
constexpr int kWarps = kThreads / 32;

// One tile's ids into the warp histogram hist[kWarps][E] (zero before):
// returns this thread's entry's id (-1 past F or out of range) and sets
// its rank among the equal ids of earlier lanes of its warp.
__device__ __forceinline__ int rank_tile(const int* __restrict__ ids,
                                         long long f, long long F, int E,
                                         int* hist, int* rank) {
  int id = f < F ? ids[f] : -1;
  if (id < 0 || id >= E) id = -1;
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(0xffffffffu, id);
  *rank = __popc(peers & ((1u << lane) - 1u));
  if (id >= 0 && *rank == 0)
    hist[(threadIdx.x >> 5) * E + id] = __popc(peers);
  return id;
}

// hist[w][e] becomes run[e] + the counts of warps before w, and run[e]
// the count after the whole tile.
__device__ __forceinline__ void prefix_tile(int* hist, int* run, int E) {
  for (int e = threadIdx.x; e < E; e += kThreads) {
    int r = run[e];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = hist[w * E + e];
      hist[w * E + e] = r;
      r += c;
    }
    run[e] = r;
  }
}

__device__ __forceinline__ void clear(int* p, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) p[i] = 0;
}

// Block b owns tiles [b * per_block, min((b + 1) * per_block, tiles)).
// kCoop: launched cooperatively with gridDim.x blocks; otherwise one block.
template <bool kCoop>
__global__ void __launch_bounds__(kThreads)
positions_in_expert_kernel(const int* __restrict__ ids, long long F, int E,
                           int per_block, int* __restrict__ pos,
                           int* __restrict__ counts, int* scratch) {
  extern __shared__ int smem[];
  int* run = smem;                   // [E]
  int* hist0 = run + E;              // [kWarps][E] the block's first tile
  int* hist = hist0 + kWarps * E;    // [kWarps][E] any later tile
  const long long tiles = (F + kThreads - 1) / kThreads;
  const long long t0 = static_cast<long long>(blockIdx.x) * per_block;
  const long long t1 = t0 + per_block < tiles ? t0 + per_block : tiles;
  const int warp = threadIdx.x >> 5;

  // the first tile's ranks and warp histogram, kept for phase 2
  clear(run, E);
  clear(hist0, kWarps * E);
  __syncthreads();
  int rank0 = 0;
  const int id0 = t0 < t1 ? rank_tile(ids, t0 * kThreads + threadIdx.x, F,
                                      E, hist0, &rank0)
                          : -1;
  __syncthreads();

  if constexpr (kCoop) {
    // phase 1: the block's totals by expert, to its row of the scratch
    for (int e = threadIdx.x; e < E; e += kThreads) {
      int r = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) r += hist0[w * E + e];
      run[e] = r;
    }
    for (long long t = t0 + 1; t < t1; ++t) {
      clear(hist, kWarps * E);
      __syncthreads();
      int rank;
      rank_tile(ids, t * kThreads + threadIdx.x, F, E, hist, &rank);
      __syncthreads();
      for (int e = threadIdx.x; e < E; e += kThreads) {
        int r = run[e];
#pragma unroll
        for (int w = 0; w < kWarps; ++w) r += hist[w * E + e];
        run[e] = r;
      }
      __syncthreads();
    }
    int* mine = scratch + static_cast<size_t>(blockIdx.x) * E;
    for (int e = threadIdx.x; e < E; e += kThreads) {
      mine[e] = run[e];
      run[e] = 0;
    }
    cg::this_grid().sync();
    // the base: every earlier block's totals (L2 reads: written in this
    // launch), integer adds in any order
    const int n = static_cast<int>(blockIdx.x) * E;
    for (int i = threadIdx.x; i < n; i += kThreads)
      atomicAdd(&run[i % E], __ldcg(scratch + i));
    __syncthreads();
  }

  // phase 2: place the entries, tile by tile in order
  if (t0 < t1) {
    prefix_tile(hist0, run, E);
    __syncthreads();
    const long long f = t0 * kThreads + threadIdx.x;
    if (f < F) pos[f] = id0 >= 0 ? hist0[warp * E + id0] + rank0 : 0;
  }
  for (long long t = t0 + 1; t < t1; ++t) {
    __syncthreads();
    clear(hist, kWarps * E);
    __syncthreads();
    const long long f = t * kThreads + threadIdx.x;
    int rank;
    const int id = rank_tile(ids, f, F, E, hist, &rank);
    __syncthreads();
    prefix_tile(hist, run, E);
    __syncthreads();
    if (f < F) pos[f] = id >= 0 ? hist[warp * E + id] + rank : 0;
  }
  if (blockIdx.x == gridDim.x - 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < E; e += kThreads) counts[e] = run[e];
  }
}

size_t smem_bytes(int E) {
  return sizeof(int) * static_cast<size_t>(E) * (2 * kWarps + 1);
}

template <bool kCoop>
cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;   // above only after an opt-in
  return cudaFuncSetAttribute(positions_in_expert_kernel<kCoop>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" {

// ids, pos: [F] int32; counts: [E] int32; scratch: [grid, E] int32 (contents
// on entry unused; may be null when grid == 1).  grid blocks of per_block
// tiles of 256 entries must cover F, and grid may be at most the card's
// SM count, so that the cooperative launch is resident at once.  E may be
// at most 227 KB / ((2 * 8 + 1) * 4 bytes) = 3418; the Python wrapper
// checks it and sizes the grid.
int positions_in_expert_launch(const void* ids, long long F, int E, int grid,
                               int per_block, void* pos, void* counts,
                               void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(E);
  const int* i = static_cast<const int*>(ids);
  int* p = static_cast<int*>(pos);
  int* c = static_cast<int*>(counts);
  int* sc = static_cast<int*>(scratch);
  cudaError_t err;
  if (grid == 1) {
    err = allow_smem<false>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    positions_in_expert_kernel<false><<<1, kThreads, smem, s>>>(
        i, F, E, per_block, p, c, sc);
    return static_cast<int>(cudaGetLastError());
  }
  err = allow_smem<true>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&i, &F, &E, &per_block, &p, &c, &sc};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(positions_in_expert_kernel<true>),
      dim3(grid), dim3(kThreads), args, smem, s);
  return static_cast<int>(err);
}

}  // extern "C"
