// The row indexing of a dispatch-buffer block, for dispatch_scatter
// (scatter_gather.cu).  (dispatch_scatter_quantize, fused_wire.cu, builds
// its row index once for all blocks instead.)
//
// A block owns the rows [c0, c0 + rows) of expert e's buffer.  index_rows
// (phase 1) reads the ids and positions of all F entries (8 bytes an
// entry, from L2 after the first block, eight loads in flight a thread)
// and keeps, for each of its rows, the index of the FIRST entry that lands
// there and how many do (shared-memory integer atomicMin / atomicAdd: their
// results do not depend on the order the threads arrive in).  A row that
// several entries hit (duplicates are allowed by the op's contract; plans
// from build_dispatch_plan never have one) is summed in entry order: a
// block with such rows also lists their entries in entry order in shared
// memory (phase 1b: a warp ballot ranks a warp's entries, a prefix over the
// warps places them), and for_later walks that list, or the entries in
// device memory past its capacity.  So the sums have a fixed order and no
// float atomics.
#pragma once

#include <climits>

namespace scatter_rows {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 128;        // buffer rows of one expert per block
constexpr int kIndexUnroll = 8;   // phase-1 entry loads in flight
constexpr int kDupList = 2048;    // duplicate entries a block keeps

struct Shared {
  int first[kRows];
  int count[kRows];
  int list_f[kDupList];
  int list_r[kDupList];
  int warp[kWarps];
  int dup;
};

// Phases 1 and 1b, with all kThreads threads of the block.  Returns the
// number of entries of duplicate rows (all listed when <= kDupList).
__device__ __forceinline__ int index_rows(const int* __restrict__ ids,
                                          const int* __restrict__ pos, int F,
                                          int e, int c0, int rows,
                                          Shared& s) {
  const int tid = threadIdx.x;
  for (int r = tid; r < kRows; r += kThreads) {
    s.first[r] = INT_MAX;
    s.count[r] = 0;
  }
  if (tid == 0) s.dup = 0;
  __syncthreads();
  for (int base = tid; base < F; base += kIndexUnroll * kThreads) {
    int id[kIndexUnroll], p[kIndexUnroll];
#pragma unroll
    for (int k = 0; k < kIndexUnroll; ++k) {
      const int f = base + k * kThreads;
      id[k] = f < F ? ids[f] : -1;
      p[k] = f < F ? pos[f] : -1;
    }
#pragma unroll
    for (int k = 0; k < kIndexUnroll; ++k) {
      const int r = p[k] - c0;
      if (id[k] == e && r >= 0 && r < rows) {
        atomicMin(&s.first[r], base + k * kThreads);
        atomicAdd(&s.count[r], 1);
      }
    }
  }
  __syncthreads();
  for (int r = tid; r < rows; r += kThreads)
    if (s.count[r] > 1) s.dup = 1;
  __syncthreads();

  int n_list = 0;
  if (s.dup) {
    const int lane = tid & 31;
    const int warp = tid >> 5;
    for (int base = 0; base < F; base += kThreads) {
      const int f = base + tid;
      const int r = f < F ? pos[f] - c0 : -1;
      const bool dup = f < F && ids[f] == e && r >= 0 && r < rows &&
                       s.count[r] > 1;
      const unsigned ballot = __ballot_sync(0xffffffffu, dup);
      if (lane == 0) s.warp[warp] = __popc(ballot);
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        before += w < warp ? s.warp[w] : 0;
        total += s.warp[w];
      }
      const int at = n_list + before + __popc(ballot & ((1u << lane) - 1u));
      if (dup && at < kDupList) {
        s.list_f[at] = f;
        s.list_r[at] = r;
      }
      n_list += total;
      __syncthreads();
    }
  }
  return n_list;
}

// fn(f) for each entry of row r after its first, in entry order.
template <typename Fn>
__device__ __forceinline__ void for_later(const Shared& s, int n_list,
                                          const int* __restrict__ ids,
                                          const int* __restrict__ pos, int e,
                                          int c0, int r, int first, int count,
                                          Fn fn) {
  if (count < 2) return;
  if (n_list <= kDupList) {
    for (int m = 0, seen = 1; seen < count; ++m) {
      if (s.list_r[m] != r || s.list_f[m] == first) continue;
      fn(s.list_f[m]);
      ++seen;
    }
  } else {
    for (int f = first + 1, seen = 1; seen < count; ++f) {
      if (ids[f] != e || pos[f] != c0 + r) continue;
      fn(f);
      ++seen;
    }
  }
}

}  // namespace scatter_rows
