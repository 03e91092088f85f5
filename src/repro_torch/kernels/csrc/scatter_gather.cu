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
// Scatter design: grid (E, column blocks).  Each block owns buf[e, :, cols]:
// it zero-fills them, then walks the entries f = 0..F-1 IN ORDER (ids and
// positions staged through shared memory, read by every thread as a
// broadcast) and adds src[f, cols] as f32 where id == e and 0 <= pos < C.
// A thread owns its columns, so there are no atomics and the summation order
// is fixed: the result is deterministic, duplicate (e, c) pairs sum in entry
// order, and a plan with unique (e, c) (every plan build_dispatch_plan
// makes) gives bitwise the plain version's buffer.  Each block rereads all F
// ids from L2; compacting the entries per expert first is later work.
//
// Gather design: one block per group of kRows entries, threads across H with
// 16-byte loads and stores.  Each output is a single product, so the result
// is bitwise the plain version's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 2048;   // entries staged in shared memory per pass
constexpr int kRows = 4;       // gather entries per block

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
dispatch_scatter_kernel(const int* __restrict__ ids,
                        const int* __restrict__ pos,
                        const T* __restrict__ src, int F, int C, int H,
                        float* __restrict__ out) {
  __shared__ int s_id[kChunk];
  __shared__ int s_pos[kChunk];
  const int e = blockIdx.x;
  const int col = (blockIdx.y * kThreads + threadIdx.x) * VEC;
  const bool active = col < H;
  float* out_e = out + static_cast<size_t>(e) * C * H + col;

  if (active) {
    Vec<float, VEC> zero;
#pragma unroll
    for (int k = 0; k < VEC; ++k) zero.v[k] = 0.f;
    for (int c = 0; c < C; ++c)
      *reinterpret_cast<Vec<float, VEC>*>(out_e + static_cast<size_t>(c) * H) =
          zero;
  }

  for (int base = 0; base < F; base += kChunk) {
    const int n = min(kChunk, F - base);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      s_id[i] = ids[base + i];
      s_pos[i] = pos[base + i];
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < n; ++j) {
        const int p = s_pos[j];
        if (s_id[j] != e || p < 0 || p >= C) continue;
        const Vec<T, VEC> s = *reinterpret_cast<const Vec<T, VEC>*>(
            src + static_cast<size_t>(base + j) * H + col);
        auto* dst = reinterpret_cast<Vec<float, VEC>*>(
            out_e + static_cast<size_t>(p) * H);
        Vec<float, VEC> acc = *dst;
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc.v[k] += to_f32(s.v[k]);
        *dst = acc;
      }
    }
    __syncthreads();
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
combine_gather_kernel(const int* __restrict__ ids, const int* __restrict__ pos,
                      const float* __restrict__ buf,
                      const float* __restrict__ w, int F, int E, int C, int H,
                      float* __restrict__ out) {
  const int f0 = blockIdx.x * kRows;
  for (int r = 0; r < kRows; ++r) {
    const int f = f0 + r;
    if (f >= F) return;
    const int id = ids[f];
    const int p = pos[f];
    const bool ok = id >= 0 && id < E && p >= 0 && p < C;
    const float wf = w[f];
    const float* row = buf + (static_cast<size_t>(ok ? id : 0) * C +
                              (ok ? p : 0)) * H;
    float* o = out + static_cast<size_t>(f) * H;
    for (int col = threadIdx.x * VEC; col < H; col += kThreads * VEC) {
      Vec<float, VEC> v;
      if (ok) {
        v = *reinterpret_cast<const Vec<float, VEC>*>(row + col);
#pragma unroll
        for (int k = 0; k < VEC; ++k) v.v[k] = wf * v.v[k];
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) v.v[k] = 0.f;
      }
      *reinterpret_cast<Vec<float, VEC>*>(o + col) = v;
    }
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, int VEC>
void launch_scatter(const void* ids, const void* pos, const void* src, int F,
                    int E, int C, int H, void* out, cudaStream_t stream) {
  const dim3 grid(E, (H + kThreads * VEC - 1) / (kThreads * VEC));
  dispatch_scatter_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
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

int combine_gather_launch(const void* ids, const void* pos, const void* buf,
                          const void* w, int F, int E, int C, int H, void* out,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((F + kRows - 1) / kRows);
  const int* i = static_cast<const int*>(ids);
  const int* p = static_cast<const int*>(pos);
  const float* b = static_cast<const float*>(buf);
  const float* wt = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  if (H % 4 == 0 && aligned(buf, 16) && aligned(out, 16))
    combine_gather_kernel<4><<<grid, kThreads, 0, s>>>(i, p, b, wt, F, E, C, H, o);
  else
    combine_gather_kernel<1><<<grid, kThreads, 0, s>>>(i, p, b, wt, F, E, C, H, o);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
