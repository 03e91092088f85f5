// dispatch_scatter and combine_gather for Hopper (sm_90a).
//
// dispatch_scatter replaces the TPU kernel repro/kernels/scatter_gather.py:
// dispatch_scatter_pallas (body _scatter_kernel): buf[e, c] = sum of src[f]
// over the entries with (id, pos) == (e, c), [E, C, H] f32; entries with an
// id outside [0, E) or a position outside [0, C) contribute nothing.
// combine_gather replaces combine_gather_pallas (body _gather_kernel):
// out[f] = w[f] * buf[id_f, pos_f], [F, H] f32, and exactly 0 for an entry
// out of range.
//
// Bound on the H100: bytes.  The scatter reads the ids and positions and the
// rows of src that land in the buffer, and writes the whole [E, C, H] f32
// buffer; the gather reads ids, positions, weights and one buffer row per
// in-range entry, and writes [F, H] f32.  Neither does arithmetic worth
// counting.  The TPU kernels contract one-hot masks on the MXU only because
// a TPU has no fast scatter; here both directions are direct indexed loads
// and stores.
//
// Scatter design: grid (E, row chunks of scatter_rows::kRows, column
// chunks; one column chunk unless the grid is small, as at decode).  Block
// (e, chunk) owns buf[e, c0:c0+kRows, cols] and writes every element of it
// exactly once.  Phase 1 finds each of its rows' first entry and count
// (scatter_rows.cuh, which also orders the entries of duplicate rows).
// Phase 2 walks only its own rows: each thread takes (row, 4-column vector)
// items, issues kUnroll independent 16-byte source loads before it stores
// any of them, and writes 0 + src[first] (empty rows get 0), then adds a
// duplicate row's later entries in entry order.  So: no float atomics, a
// fixed summation order, and bitwise the plain version (index_add_ into
// zeros) for unique plans.  The output is written once and never read
// back, so the kernel moves about the bytes of its bound plus the ids
// re-read from L2 by each block.
//
// Gather design.  The gather is a copy with one multiply: it reads a
// buffer row per in-range entry and writes [F, H] f32 once, so bytes bound
// it where the entries are many, and the launch and two dependent memory
// latencies (the entry's index, then its row) where they are few, as at
// decode (F = 8 to 32).  Warp t of the grid owns tile t: entry t / split,
// float4s [j * chunk, (j + 1) * chunk) of its row, j = t % split.  Lane L
// loads float4s L, L + 32, ... of the chunk (up to kGatherLoads in flight,
// all issued before any store, through the non-coherent path: each row is
// read once) and stores each product with __stcs, so a warp's store
// covers 512 contiguous bytes of an output row that is never read back
// here.  The launcher gives one warp to each tile (blocks of 4 warps,
// scheduled as SMs free up) and splits rows only while the entries cannot
// fill the card's resident warps (occupancy.cuh, asked once a device):
// split = ceil(warps / F) for F < warps, at most a 32-float4 chunk a row
// (one load a lane), else 1.  So the training shape (F = 32768, H = 1536)
// gets one tile a row, 12 loads a lane, and jamba's decode step (F = 8, H
// = 8192) 64 tiles a row, one load a lane, 128 blocks.  Resident warps
// walking the tiles, or chunks under 384 float4s at the training shapes,
// measured slower on the H100: whole rows on freshly scheduled warps keep
// the memory busiest.  H % 4 != 0 or unaligned buffers take a
// one-column-a-lane kernel, one warp an entry.  Each output is a single
// __fmul_rn, so the result is bitwise the plain version's; an entry out of
// range writes +0.0f.  Times on one H100 80GB HBM3 at 700 W (chip_smoke.py,
// median of 30 queued calls): 0.137 ms at the training shape, 83.5% of its
// 114.5 us bound and as fast as a contiguous copy of as many floats; 0.0059
// ms at both decode shapes, against 0.0103-0.0106 ms for buf[ids, pos] * w
// and 0.0048 ms for an empty kernel (PERF.md section 6, row 3).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstddef>
#include <cstdint>

#include "occupancy.cuh"
#include "scatter_rows.cuh"

namespace {

constexpr int kGatherThreads = 128;                  // 4 warps a block
constexpr int kGatherWarps = kGatherThreads / 32;
constexpr int kGatherLoads = 16;   // float4s a lane has in flight a tile
constexpr int kChunkMin = 32;      // float4s: one load a lane
constexpr int kScatterThreads = scatter_rows::kThreads;
constexpr int kScatterRows = scatter_rows::kRows;
constexpr int kUnroll = 4;          // phase-2 row loads in flight

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kScatterThreads)
dispatch_scatter_kernel(const int* __restrict__ ids,
                        const int* __restrict__ pos,
                        const T* __restrict__ src, int F, int C, int H,
                        float* __restrict__ out) {
  __shared__ scatter_rows::Shared sh;
  const int e = blockIdx.x;
  const int c0 = blockIdx.y * kScatterRows;
  const int rows = min(kScatterRows, C - c0);
  const int tid = threadIdx.x;
  const int n_list = scatter_rows::index_rows(ids, pos, F, e, c0, rows, sh);

  // Phase 2: every (row, column vector) of the block written once; the
  // block's column vectors are [v0, v0 + nvec) of the row's H / VEC.
  const int per_chunk = (H / VEC + gridDim.z - 1) / gridDim.z;
  const int v0 = blockIdx.z * per_chunk;
  const int nvec = min(per_chunk, H / VEC - v0);
  const int items = rows * nvec;
  float* out_e = out + (static_cast<size_t>(e) * C + c0) * H + v0 * VEC;
  src += v0 * VEC;
  for (int i0 = tid; i0 < items; i0 += kUnroll * kScatterThreads) {
    Vec<T, VEC> s[kUnroll];
    int first[kUnroll], count[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int i = i0 + k * kScatterThreads;
      count[k] = 0;
      first[k] = 0;
      if (i < items) {
        const int r = i / nvec;
        count[k] = sh.count[r];
        first[k] = sh.first[r];
        if (count[k] > 0)
          s[k] = *reinterpret_cast<const Vec<T, VEC>*>(
              src + static_cast<size_t>(first[k]) * H + (i % nvec) * VEC);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int i = i0 + k * kScatterThreads;
      if (i >= items) continue;
      const int r = i / nvec;
      const int col = (i % nvec) * VEC;
      Vec<float, VEC> acc;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        acc.v[j] = count[k] > 0 ? 0.f + to_f32(s[k].v[j]) : 0.f;
      scatter_rows::for_later(
          sh, n_list, ids, pos, e, c0, r, first[k], count[k], [&](int f) {
            const Vec<T, VEC> d = *reinterpret_cast<const Vec<T, VEC>*>(
                src + static_cast<size_t>(f) * H + col);
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc.v[j] += to_f32(d.v[j]);
          });
      *reinterpret_cast<Vec<float, VEC>*>(
          out_e + static_cast<size_t>(r) * H + col) = acc;
    }
  }
}

// The vector path (H % 4 == 0, 16-byte aligned buf and out): warp t of
// the grid owns tile t, entry t / split, float4s [j * chunk, (j + 1) *
// chunk) of the row's ``vecs`` (H / 4), j = t % split.
__global__ void __launch_bounds__(kGatherThreads)
combine_gather_kernel(const int* __restrict__ ids, const int* __restrict__ pos,
                      const float4* __restrict__ buf,
                      const float* __restrict__ w, int F, int E, int C,
                      int vecs, int split, int chunk,
                      float4* __restrict__ out) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kGatherWarps + (threadIdx.x >> 5);
  if (t >= static_cast<long long>(F) * split) return;
  const int lane = threadIdx.x & 31;
  const int f = static_cast<int>(t / split);
  const int id = ids[f];
  const int p = pos[f];
  const float wf = w[f];
  const bool ok = id >= 0 && id < E && p >= 0 && p < C;
  const int v0 = static_cast<int>(t - static_cast<long long>(f) * split) *
                 chunk;
  const int v1 = min(v0 + chunk, vecs);
  const float4* row =
      buf + (static_cast<size_t>(ok ? id : 0) * C + (ok ? p : 0)) * vecs;
  float4* o = out + static_cast<size_t>(f) * vecs;
  for (int c0 = v0; c0 < v1; c0 += 32 * kGatherLoads) {
    float4 v[kGatherLoads];
#pragma unroll
    for (int k = 0; k < kGatherLoads; ++k) {
      const int i = c0 + 32 * k + lane;
      v[k] = ok && i < v1 ? __ldg(row + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < kGatherLoads; ++k) {
      const int i = c0 + 32 * k + lane;
      if (i >= v1) continue;
      __stcs(o + i, ok ? make_float4(__fmul_rn(wf, v[k].x),
                                     __fmul_rn(wf, v[k].y),
                                     __fmul_rn(wf, v[k].z),
                                     __fmul_rn(wf, v[k].w))
                       : make_float4(0.f, 0.f, 0.f, 0.f));
    }
  }
}

// The ragged path (H % 4 != 0 or unaligned buf or out): one warp an entry,
// one column a lane.
__global__ void __launch_bounds__(kGatherThreads)
combine_gather_scalar_kernel(const int* __restrict__ ids,
                             const int* __restrict__ pos,
                             const float* __restrict__ buf,
                             const float* __restrict__ w, int F, int E, int C,
                             int H, float* __restrict__ out) {
  const int f = blockIdx.x * kGatherWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (f >= F) return;
  const int id = ids[f];
  const int p = pos[f];
  const bool ok = id >= 0 && id < E && p >= 0 && p < C;
  const float wf = w[f];
  const float* row =
      buf + (static_cast<size_t>(ok ? id : 0) * C + (ok ? p : 0)) * H;
  float* o = out + static_cast<size_t>(f) * H;
  for (int col = lane; col < H; col += 32)
    o[col] = ok ? __fmul_rn(wf, row[col]) : 0.f;
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, int VEC>
void launch_scatter(const void* ids, const void* pos, const void* src, int F,
                    int E, int C, int H, void* out, cudaStream_t stream) {
  // Few (expert, row chunk) blocks (decode: one chunk per expert) also
  // split the columns, up to about two blocks per SM of the H100's 132, so
  // that each thread has one round of loads in flight, not several in turn.
  const int row_chunks = (C + kScatterRows - 1) / kScatterRows;
  const int vec_rounds = (H / VEC + kScatterThreads - 1) / kScatterThreads;
  const int want = (2 * 132 + E * row_chunks - 1) / (E * row_chunks);
  const dim3 grid(E, row_chunks, max(1, min(want, vec_rounds)));
  dispatch_scatter_kernel<T, VEC><<<grid, kScatterThreads, 0, stream>>>(
      static_cast<const int*>(ids), static_cast<const int*>(pos),
      static_cast<const T*>(src), F, C, H, static_cast<float*>(out));
}

}  // namespace

extern "C" {

// src_is_bf16: 1 for bfloat16 src, 0 for float32.  The 4-wide vector path
// needs H % 4 == 0 and vector-aligned src and out; otherwise one column a
// thread.
int dispatch_scatter_launch(const void* ids, const void* pos, const void* src,
                            int src_is_bf16, int F, int E, int C, int H,
                            void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = H % 4 == 0 && aligned(out, 16) &&
                   aligned(src, src_is_bf16 ? 8 : 16);
  if (src_is_bf16) {
    if (vec) launch_scatter<__nv_bfloat16, 4>(ids, pos, src, F, E, C, H, out, s);
    else launch_scatter<__nv_bfloat16, 1>(ids, pos, src, F, E, C, H, out, s);
  } else {
    if (vec) launch_scatter<float, 4>(ids, pos, src, F, E, C, H, out, s);
    else launch_scatter<float, 1>(ids, pos, src, F, E, C, H, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The vector path's tiling for F entries of H columns on the current
// device: plan = {split, chunk (float4s), grid, resident warps}.  The
// launcher uses it, and chip_smoke.py reports it.
int combine_gather_plan(int F, int H, int* plan) {
  int resident = 0;
  const cudaError_t err = occupancy::resident_blocks<combine_gather_kernel>(
      kGatherThreads, INT_MAX, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps = resident * kGatherWarps;
  const int vecs = std::max(1, H / 4);
  const int most = (vecs + kChunkMin - 1) / kChunkMin;   // chunks a row
  const int want = F > 0 && F < warps ? (warps + F - 1) / F : 1;
  const int pieces = std::min(want, most);
  const int chunk = ((vecs + pieces - 1) / pieces + kChunkMin - 1) /
                    kChunkMin * kChunkMin;
  const int split = (vecs + chunk - 1) / chunk;
  const long long blocks =
      (static_cast<long long>(F) * split + kGatherWarps - 1) / kGatherWarps;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = split;
  plan[1] = chunk;
  plan[2] = static_cast<int>(std::max(1LL, blocks));
  plan[3] = warps;
  return 0;
}

int combine_gather_launch(const void* ids, const void* pos, const void* buf,
                          const void* w, int F, int E, int C, int H, void* out,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(ids);
  const int* p = static_cast<const int*>(pos);
  const float* wt = static_cast<const float*>(w);
  if (H % 4 == 0 && aligned(buf, 16) && aligned(out, 16)) {
    int plan[4];
    const int err = combine_gather_plan(F, H, plan);
    if (err != 0) return err;
    combine_gather_kernel<<<plan[2], kGatherThreads, 0, s>>>(
        i, p, static_cast<const float4*>(buf), wt, F, E, C, H / 4, plan[0],
        plan[1], static_cast<float4*>(out));
  } else {
    combine_gather_scalar_kernel<<<(F + kGatherWarps - 1) / kGatherWarps,
                                   kGatherThreads, 0, s>>>(
        i, p, static_cast<const float*>(buf), wt, F, E, C, H,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
