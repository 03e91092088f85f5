// segment_centroid for Hopper (sm_90a): per-slot means of each group.
//
// Replaces the TPU kernel repro/kernels/segment_centroid.py:
// segment_centroid_pallas (body _kernel): for slots [G, C] int32 and x
// [G, C, H], counts[g, s] = #{c : slots[g, c] == s} and
// centroids[g, s] = sum of x[g, c] over those c / max(count, 1), both f32.
// Slots outside [0, S) (the overflow bin) contribute to nothing.
//
// Bound on the H100: bytes.  It reads the rows of x whose slot is in range
// (bf16 in the forward pass, f32 cotangents in the backward of
// residual_apply) and writes [G, S, H] f32 centroids and [G, S] counts; the
// adds are one per element read.  At the training shape (G = 40, C = 1024,
// S = 208, H = 1536, bf16) that is about 177 MB, 53 us at 3.35 TB/s.
//
// Design: the TPU kernel contracts a one-hot [S, C] mask on the MXU; here
// the members of each slot are summed directly, with no float atomics, in
// entry order, so a second call gives the same bits (the backward pass
// recomputes the forward under torch.utils.checkpoint and must see the
// same centroids).  Grid (G, slot chunks of kSlots).  Phase 1 compacts, in
// entry order, the entries of group g whose slot falls in the block's chunk
// into shared memory (a warp ballot ranks the entries of a warp, a prefix
// over the warps places them), reading the C slot ids once.  Phase 2 gives
// each thread (slot, 4-column vector) items; a thread walks the compacted
// list, adds the rows of its slot with 16-byte loads, counts them exactly,
// and writes the sum / max(count, 1) once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 8;   // slots per block

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
segment_centroid_kernel(const int* __restrict__ slots,
                        const T* __restrict__ x, int C, int S, int H,
                        float* __restrict__ cent,
                        float* __restrict__ counts) {
  extern __shared__ int smem[];
  int* list_c = smem;          // [C] member entry, in entry order
  int* list_s = smem + C;      // [C] its slot
  __shared__ int s_warp[kWarps];
  const int g = blockIdx.x;
  const int s0 = blockIdx.y * kSlots;
  const int s1 = min(s0 + kSlots, S);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lanemask_lt = (1u << lane) - 1u;
  const int* slots_g = slots + static_cast<size_t>(g) * C;

  // Phase 1: stable compaction of this chunk's members.
  int n = 0;
  for (int base = 0; base < C; base += kThreads) {
    const int c = base + tid;
    const int sl = c < C ? slots_g[c] : -1;
    const bool member = sl >= s0 && sl < s1;
    const unsigned ballot = __ballot_sync(0xffffffffu, member);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int k = s_warp[w];
      before += w < warp ? k : 0;
      total += k;
    }
    if (member) {
      const int at = n + before + __popc(ballot & lanemask_lt);
      list_c[at] = c;
      list_s[at] = sl;
    }
    n += total;
    __syncthreads();   // s_warp is rewritten by the next tile
  }

  // Phase 2: one (slot, column vector) item a thread at a time.
  const int nvec = H / VEC;
  const int items = (s1 - s0) * nvec;
  const T* x_g = x + static_cast<size_t>(g) * C * H;
  for (int i = tid; i < items; i += kThreads) {
    const int s = s0 + i / nvec;
    const int col = (i % nvec) * VEC;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    int count = 0;
    for (int m = 0; m < n; ++m) {
      if (list_s[m] != s) continue;
      const Vec<T, VEC> v = *reinterpret_cast<const Vec<T, VEC>*>(
          x_g + static_cast<size_t>(list_c[m]) * H + col);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] += to_f32(v.v[j]);
      ++count;
    }
    const float d = fmaxf(static_cast<float>(count), 1.f);
    Vec<float, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) o.v[j] = acc[j] / d;
    *reinterpret_cast<Vec<float, VEC>*>(
        cent + (static_cast<size_t>(g) * S + s) * H + col) = o;
    if (col == 0) counts[static_cast<size_t>(g) * S + s] =
        static_cast<float>(count);
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, int VEC>
int launch(const void* slots, const void* x, int G, int C, int S, int H,
           void* cent, void* counts, cudaStream_t stream) {
  const size_t smem = sizeof(int) * 2 * static_cast<size_t>(C);
  if (smem > 48 * 1024) {   // above 48 KB only after an explicit opt-in
    cudaError_t err = cudaFuncSetAttribute(
        segment_centroid_kernel<T, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(G, (S + kSlots - 1) / kSlots);
  segment_centroid_kernel<T, VEC><<<grid, kThreads, smem, stream>>>(
      static_cast<const int*>(slots), static_cast<const T*>(x), C, S, H,
      static_cast<float*>(cent), static_cast<float*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// slots: [G, C] int32; x: [G, C, H] bf16 (x_is_bf16 = 1) or f32;
// cent: [G, S, H] f32; counts: [G, S] f32.  C may be at most
// 227 KB / 8 bytes = 29056 (the wrapper checks).  The 4-wide path needs
// H % 4 == 0 and vector-aligned x and cent; otherwise one column a thread.
int segment_centroid_launch(const void* slots, const void* x, int x_is_bf16,
                            int G, int C, int S, int H, void* cent,
                            void* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = H % 4 == 0 && aligned(cent, 16) &&
                   aligned(x, x_is_bf16 ? 8 : 16);
  if (x_is_bf16)
    return vec ? launch<__nv_bfloat16, 4>(slots, x, G, C, S, H, cent, counts, s)
               : launch<__nv_bfloat16, 1>(slots, x, G, C, S, H, cent, counts, s);
  return vec ? launch<float, 4>(slots, x, G, C, S, H, cent, counts, s)
             : launch<float, 1>(slots, x, G, C, S, H, cent, counts, s);
}

}  // extern "C"
