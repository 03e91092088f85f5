// segment_centroid for Hopper (sm_90a): per-slot means of each group.
//
// Replaces the TPU kernel repro/kernels/segment_centroid.py:
// segment_centroid_pallas (body _kernel): for slots [G, C] int32 and x
// [G, C, H], counts[g, s] = #{c : slots[g, c] == s} and
// centroids[g, s] = sum of x[g, c] over those c / max(count, 1), both f32.
// Slots outside [0, S) (the overflow bin) contribute to nothing.
//
// Bound on the H100: bytes.  It reads the rows of x whose slot is in range
// and writes [G, S, H] f32 centroids and [G, S] counts; one add an element
// read.  At the training shape (G = 40, C = 1024, S = 208, H = 1536):
//   forward, bf16 x, the ~819 occupied rows a group in range (compress
//   sends the others to the overflow bin): 100 MB read + 51 MB written,
//   45 us at 3.35 TB/s;
//   backward of residual_apply, f32 cotangent: decompress clamps the
//   overflow bin into S - 1, so all C rows are in range and the
//   unoccupied ones (about 205 a group, all 1024 for a cold expert) land
//   in that one slot: 252 MB + 51 MB, 90 us.
//
// What held the first version back: grid (group, 8-slot chunk), each
// thread one (slot, 4 columns) item walking the chunk's member list, one
// dependent 16-byte load a member.  A slot of n rows cost one thread n
// serial loads while the rest of the grid idled: 0.09 ms at near-uniform
// slots, but 1.22 ms at the backward's slots of the first MoE layer (a
// slot of 519 rows on average) and 1.04 ms a backward call on average,
// 33 of the 40.6 ms it took a training step.
//
// Design: the work is split by rows, not by slots.  Three kernels on the
// stream, one wrapper launch; the wrapper allocates the scratch.
//   (1) index, one block a group: each warp counts the slots of a
//       contiguous run of entries (__match_any_sync groups a round's equal
//       slots; the group's lowest lane adds its size to a [slot][warp]
//       counter in shared memory); one exclusive scan of the counters in
//       slot-major order gives each slot its start and exact count, and
//       each (slot, warp) its first place; the warps then place their
//       entries in entry order, so the member list of each slot is
//       contiguous and stable.  The same block writes the counts and the
//       work items: each slot's rows cut into items of R rows (an empty
//       slot gets one item of none), and a partial-sum row for each item
//       of a slot with more than one.  R and the most items, slots of
//       several items and partial rows a group can need come from the
//       wrapper (kernels/segment_centroid.work_bounds), which sizes the
//       scratch by them; the kernels only read them.
//   (2) reduce, one block an (item, column tile): a warp spans 32
//       contiguous vectors of a row (16-byte loads), each thread issues
//       the loads of a piece of kPiece rows before it adds them, pieces
//       in order; a slot's only item writes sum / max(count, 1), an item
//       of a longer slot its partial sum.
//   (3) combine, one block a (slot of several items, column tile): the
//       partials added in item order, divided by the count.
// No float atomics; every sum has a fixed order (rows in entry order
// within an item, items in order), so a second call gives the same bits,
// which the checkpoint's recompute needs.  The sums are taken in another
// association than a plain left fold, within 1e-6 of the sum of the
// terms' magnitudes.  Time follows the rows in range, not their spread:
// a slot of 1024 rows is 16 items summed side by side.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kPiece = 8;         // rows whose loads are in flight at once
constexpr int kThreads = 192;     // reduce / combine: 6 warps
constexpr int kIndexSmem = 47 * 1024;   // counters without an opt-in
constexpr int kMaxIndexWarps = 32;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// VEC floats to p: 16-byte stores when VEC is a multiple of 4
template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC / 4; ++k)
      reinterpret_cast<float4*>(p)[k] =
          make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = v[j];
  }
}

// The work layout, per group, as the wrapper gives it.
struct Layout {
  int rows;           // R: rows of a work item, at most kThreads
  int max_items;      // work items
  int max_multi;      // slots of more than R rows
  int max_partials;   // items of such slots, a partial-sum row each
};

// Exclusive prefix of v over the block's threads in order; total gets the
// block's sum.  s_warp: 32 ints of shared memory.
__device__ __forceinline__ int block_scan(int v, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? s_warp[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < nw) s_warp[lane] = w;
  }
  __syncthreads();
  const int before = (warp > 0 ? s_warp[warp - 1] : 0) + x - v;
  total = s_warp[nw - 1];
  __syncthreads();   // s_warp is reused by the next scan
  return before;
}

// (1) the index of group blockIdx.x; blockDim.x = 32 * W, shared memory
// S * W counters.  items: {slot, first place in order, rows, partial row
// or -1}; multi: {slot, first partial row, items, count}.
__global__ void __launch_bounds__(32 * kMaxIndexWarps)
segment_centroid_index_kernel(
    const int* __restrict__ slots, int C, int S, Layout lay,
    float* __restrict__ counts, int4* __restrict__ items,
    int4* __restrict__ multi, int* __restrict__ order,
    int* __restrict__ n_items, int* __restrict__ n_multi) {
  extern __shared__ int cnt[];   // [S][W], slot-major
  __shared__ int s_warp[32];
  const int g = blockIdx.x;
  const int W = blockDim.x >> 5;
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lanemask_lt = (1u << lane) - 1u;
  const int* slots_g = slots + static_cast<size_t>(g) * C;
  const int n = S * W;
  for (int i = tid; i < n; i += T) cnt[i] = 0;
  __syncthreads();

  // (a) each warp counts its run of entries, 32 a round
  const int run = (C + W - 1) / W;
  const int c0 = min(warp * run, C);
  const int c1 = min(c0 + run, C);
  for (int base = c0; base < c1; base += 32) {
    const int c = base + lane;
    const int sl = c < c1 ? slots_g[c] : -1;
    const bool in = sl >= 0 && sl < S;
    const unsigned peers = __match_any_sync(0xffffffffu, in ? sl : -1);
    if (in && (peers & lanemask_lt) == 0) cnt[sl * W + warp] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // (b) exclusive scan of the counters, each thread a contiguous chunk
  {
    const int per = (n + T - 1) / T;
    const int i0 = min(tid * per, n);
    const int i1 = min(i0 + per, n);
    int sum = 0;
    for (int i = i0; i < i1; ++i) sum += cnt[i];
    int total;
    int at = block_scan(sum, s_warp, total);
    for (int i = i0; i < i1; ++i) {
      const int v = cnt[i];
      cnt[i] = at;
      at += v;
    }
    __syncthreads();
    // (c) counts and work items, each thread a contiguous chunk of slots
    const int sper = (S + T - 1) / T;
    const int s0 = min(tid * sper, S);
    const int s1 = min(s0 + sper, S);
    int n_it = 0, n_mu = 0, n_pa = 0;
    for (int s = s0; s < s1; ++s) {
      const int cs = (s + 1 < S ? cnt[(s + 1) * W] : total) - cnt[s * W];
      const int k = max(1, (cs + lay.rows - 1) / lay.rows);
      n_it += k;
      n_mu += k > 1;
      n_pa += k > 1 ? k : 0;
    }
    int t_it, t_mu, t_pa;
    int it = block_scan(n_it, s_warp, t_it);
    int mu = block_scan(n_mu, s_warp, t_mu);
    int pa = block_scan(n_pa, s_warp, t_pa);
    int4* items_g = items + static_cast<size_t>(g) * lay.max_items;
    int4* multi_g = multi + static_cast<size_t>(g) * lay.max_multi;
    for (int s = s0; s < s1; ++s) {
      const int first = cnt[s * W];
      const int cs = (s + 1 < S ? cnt[(s + 1) * W] : total) - first;
      const int k = max(1, (cs + lay.rows - 1) / lay.rows);
      counts[static_cast<size_t>(g) * S + s] = static_cast<float>(cs);
      for (int j = 0; j < k; ++j)
        items_g[it + j] = make_int4(s, first + j * lay.rows,
                                    min(lay.rows, cs - j * lay.rows),
                                    k > 1 ? pa + j : -1);
      it += k;
      if (k > 1) {
        multi_g[mu++] = make_int4(s, pa, k, cs);
        pa += k;
      }
    }
    if (tid == 0) {
      n_items[g] = t_it;
      n_multi[g] = t_mu;
    }
  }
  __syncthreads();

  // (d) stable placement: warp w's entries of slot s go, in entry order,
  // after those of warps before it
  int* order_g = order + static_cast<size_t>(g) * C;
  for (int base = c0; base < c1; base += 32) {
    const int c = base + lane;
    const int sl = c < c1 ? slots_g[c] : -1;
    const bool in = sl >= 0 && sl < S;
    const unsigned peers = __match_any_sync(0xffffffffu, in ? sl : -1);
    if (in) {
      int* cursor = &cnt[sl * W + warp];
      order_g[*cursor + __popc(peers & lanemask_lt)] = c;
    }
    __syncwarp();
    if (in && (peers & lanemask_lt) == 0) cnt[sl * W + warp] += __popc(peers);
    __syncwarp();
  }
}

// (2) one block an (item, column tile): blockIdx.x = g * max_items + item
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
segment_centroid_reduce_kernel(const T* __restrict__ x,
                               const int* __restrict__ order,
                               const int4* __restrict__ items,
                               const int* __restrict__ n_items, int C, int S,
                               int H, Layout lay, float* __restrict__ cent,
                               float* __restrict__ partials) {
  const int g = blockIdx.x / lay.max_items;
  const int i = blockIdx.x - g * lay.max_items;
  if (i >= n_items[g]) return;
  const int4 item = items[blockIdx.x];   // {slot, first, rows, partial}
  __shared__ int rows[kThreads];
  if (threadIdx.x < item.z)
    rows[threadIdx.x] = order[static_cast<size_t>(g) * C + item.y +
                              threadIdx.x];
  __syncthreads();
  const int col = (blockIdx.y * kThreads + threadIdx.x) * VEC;
  if (col >= H) return;
  const T* xg = x + static_cast<size_t>(g) * C * H + col;
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  for (int r0 = 0; r0 < item.z; r0 += kPiece) {
    Vec<T, VEC> v[kPiece];
#pragma unroll
    for (int k = 0; k < kPiece; ++k)
      if (r0 + k < item.z)
        v[k] = *reinterpret_cast<const Vec<T, VEC>*>(
            xg + static_cast<size_t>(rows[r0 + k]) * H);
#pragma unroll
    for (int k = 0; k < kPiece; ++k)
      if (r0 + k < item.z) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] += to_f32(v[k].v[j]);
      }
  }
  if (item.w < 0) {   // the slot's only item: its rows are all the slot's
    const float d = fmaxf(static_cast<float>(item.z), 1.f);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = acc[j] / d;
    store<VEC>(cent + (static_cast<size_t>(g) * S + item.x) * H + col, acc);
  } else {
    store<VEC>(partials + (static_cast<size_t>(g) * lay.max_partials +
                           item.w) * H + col, acc);
  }
}

// (3) one block a (slot of several items, column tile): blockIdx.x =
// g * max_multi + m
template <int VEC>
__global__ void __launch_bounds__(kThreads)
segment_centroid_combine_kernel(const int4* __restrict__ multi,
                                const int* __restrict__ n_multi,
                                const float* __restrict__ partials, int S,
                                int H, Layout lay, float* __restrict__ cent) {
  const int g = blockIdx.x / lay.max_multi;
  const int m = blockIdx.x - g * lay.max_multi;
  if (m >= n_multi[g]) return;
  const int col = (blockIdx.y * kThreads + threadIdx.x) * VEC;
  if (col >= H) return;
  const int4 e = multi[blockIdx.x];      // {slot, first partial, items, count}
  const float* p = partials +
      (static_cast<size_t>(g) * lay.max_partials + e.y) * H + col;
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  for (int k0 = 0; k0 < e.z; k0 += kPiece) {
    Vec<float, VEC> v[kPiece];
#pragma unroll
    for (int k = 0; k < kPiece; ++k)
      if (k0 + k < e.z)
        v[k] = *reinterpret_cast<const Vec<float, VEC>*>(
            p + static_cast<size_t>(k0 + k) * H);
#pragma unroll
    for (int k = 0; k < kPiece; ++k)
      if (k0 + k < e.z) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] += v[k].v[j];
      }
  }
  const float d = fmaxf(static_cast<float>(e.w), 1.f);
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = acc[j] / d;
  store<VEC>(cent + (static_cast<size_t>(g) * S + e.x) * H + col, acc);
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, int VEC>
cudaError_t launch_sums(const void* x, const int* order, const int4* items,
                        const int4* multi, const int* n_items,
                        const int* n_multi, int G, int C, int S, int H,
                        Layout lay, float* cent, float* partials,
                        cudaStream_t s) {
  const int tiles = (H + kThreads * VEC - 1) / (kThreads * VEC);
  segment_centroid_reduce_kernel<T, VEC>
      <<<dim3(G * lay.max_items, tiles), kThreads, 0, s>>>(
          static_cast<const T*>(x), order, items, n_items, C, S, H, lay,
          cent, partials);
  if (lay.max_multi == 0) return cudaGetLastError();
  constexpr int CV = VEC >= 4 ? 4 : 1;   // partials: f32, 16-byte vectors
  const int ctiles = (H + kThreads * CV - 1) / (kThreads * CV);
  segment_centroid_combine_kernel<CV>
      <<<dim3(G * lay.max_multi, ctiles), kThreads, 0, s>>>(
          multi, n_multi, partials, S, H, lay, cent);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// slots: [G, C] int32; x: [G, C, H] bf16 (x_is_bf16 = 1) or f32;
// cent: [G, S, H] f32; counts: [G, S] f32.  The layout (rows of an item,
// at most 192, and per group the most items, slots of several items and
// their items) and the scratch sized by it come from
// kernels/segment_centroid.py: index, G * (4 * max_items + 4 * max_multi
// + C + 2) int32; partials, 16-byte aligned, G * max_partials * H f32.
// S may be at most 57856 (its counters fill shared memory with one
// warp).  16-byte loads need H a multiple of the vector (8 bf16, 4 f32)
// and 16-byte-aligned x, cent and partials; otherwise one column a
// thread.
int segment_centroid_launch(const void* slots, const void* x, int x_is_bf16,
                            int G, int C, int S, int H, void* cent,
                            void* counts, void* index, void* partials,
                            int rows, int max_items, int max_multi,
                            int max_partials, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G == 0 || S == 0) return 0;
  if (rows < 1 || rows > kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay{rows, max_items, max_multi, max_partials};
  int4* items = static_cast<int4*>(index);
  int4* multi = items + static_cast<size_t>(G) * lay.max_items;
  int* order = reinterpret_cast<int*>(multi + static_cast<size_t>(G) *
                                      lay.max_multi);
  int* n_items = order + static_cast<size_t>(G) * C;
  int* n_multi = n_items + G;

  // (1) as many warps as fit S counters each in 47 KB, at least one
  int warps = kIndexSmem / (4 * S);
  warps = warps < 1 ? 1 : (warps > kMaxIndexWarps ? kMaxIndexWarps : warps);
  const size_t smem = sizeof(int) * static_cast<size_t>(S) * warps;
  if (smem > kIndexSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        segment_centroid_index_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  segment_centroid_index_kernel<<<G, 32 * warps, smem, s>>>(
      static_cast<const int*>(slots), C, S, lay, static_cast<float*>(counts),
      items, multi, order, n_items, n_multi);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || H == 0) return static_cast<int>(err);

  float* c = static_cast<float*>(cent);
  float* p = static_cast<float*>(partials);
  const bool cent16 = aligned(cent, 16) && aligned(partials, 16);
  if (x_is_bf16) {
    if (H % 8 == 0 && cent16 && aligned(x, 16))
      err = launch_sums<__nv_bfloat16, 8>(x, order, items, multi, n_items, n_multi, G, C, S, H, lay, c, p, s);
    else
      err = launch_sums<__nv_bfloat16, 1>(x, order, items, multi, n_items, n_multi, G, C, S, H, lay, c, p, s);
  } else {
    if (H % 4 == 0 && cent16 && aligned(x, 16))
      err = launch_sums<float, 4>(x, order, items, multi, n_items, n_multi, G, C, S, H, lay, c, p, s);
    else
      err = launch_sums<float, 1>(x, order, items, multi, n_items, n_multi, G, C, S, H, lay, c, p, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
