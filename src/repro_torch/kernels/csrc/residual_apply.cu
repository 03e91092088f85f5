// residual_apply for Hopper (sm_90a): the error-compensation gather.
//
// Replaces the TPU kernel repro/kernels/residual_apply.py:
// residual_apply_pallas (body _kernel): out[g, c] = eout[g, slots[g, c]]
// + residual[g, c] (paper Eq. 5), [G, C, H] f32; a slot outside [0, S) (the
// overflow bin) gathers exactly zero.  Without a residual (the backward of
// segment_centroid, whose residual is zero) out[g, c] = eout[g, slot].
//
// Bound on the H100: bytes.  It must read the slot ids, eout (once: its
// rows are re-read from L2) and the residual, and write [G, C, H] f32: at
// the training shape (G = 40, C = 1024, S = 208, H = 1536) about
// 0.2 + 51 + 252 + 252 MB, 167 us at 3.35 TB/s; one add per element.
//
// Design: the TPU kernel contracts a one-hot mask with the VMEM-resident
// eout block on the MXU; on Hopper it is a direct gather.  One block per
// kRows entries, threads across H with 16-byte loads and stores.  Each
// output is a single add of the same two f32 values as the plain version,
// so the result is bitwise the plain version's (up to the sign of a zero).
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 4;

template <int VEC>
struct alignas(4 * VEC) Vec {
  float v[VEC];
};

template <int VEC, bool RESIDUAL>
__global__ void __launch_bounds__(kThreads)
residual_apply_kernel(const int* __restrict__ slots,
                      const float* __restrict__ eout,
                      const float* __restrict__ res, int rows, int C, int S,
                      int H, float* __restrict__ out) {
  const int row0 = blockIdx.x * kRows;
  for (int k = 0; k < kRows; ++k) {
    const int row = row0 + k;   // g * C + c
    if (row >= rows) return;
    const int g = row / C;
    const int sl = slots[row];
    const bool ok = sl >= 0 && sl < S;
    const float* e = eout + (static_cast<size_t>(g) * S + (ok ? sl : 0)) * H;
    const float* r = res + static_cast<size_t>(row) * H;
    float* o = out + static_cast<size_t>(row) * H;
    for (int col = threadIdx.x * VEC; col < H; col += kThreads * VEC) {
      Vec<VEC> v;
      if (ok) {
        v = *reinterpret_cast<const Vec<VEC>*>(e + col);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) v.v[j] = 0.f;
      }
      if (RESIDUAL) {
        const Vec<VEC> rv = *reinterpret_cast<const Vec<VEC>*>(r + col);
#pragma unroll
        for (int j = 0; j < VEC; ++j) v.v[j] += rv.v[j];
      }
      *reinterpret_cast<Vec<VEC>*>(o + col) = v;
    }
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int VEC>
void launch(const int* slots, const float* eout, const float* res, int rows,
            int C, int S, int H, float* out, cudaStream_t stream) {
  const dim3 grid((rows + kRows - 1) / kRows);
  if (res != nullptr)
    residual_apply_kernel<VEC, true><<<grid, kThreads, 0, stream>>>(
        slots, eout, res, rows, C, S, H, out);
  else
    residual_apply_kernel<VEC, false><<<grid, kThreads, 0, stream>>>(
        slots, eout, res, rows, C, S, H, out);
}

}  // namespace

extern "C" {

// slots: [G, C] int32; eout: [G, S, H] f32; res: [G, C, H] f32 or null (no
// residual); out: [G, C, H] f32.  The 4-wide path needs H % 4 == 0 and
// 16-byte-aligned eout, res and out; otherwise one column a thread.
int residual_apply_launch(const void* slots, const void* eout, const void* res,
                          int G, int C, int S, int H, void* out,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sl = static_cast<const int*>(slots);
  const float* e = static_cast<const float*>(eout);
  const float* r = static_cast<const float*>(res);
  float* o = static_cast<float*>(out);
  const bool vec = H % 4 == 0 && aligned(eout, 16) && aligned(out, 16) &&
                   (res == nullptr || aligned(res, 16));
  if (vec) launch<4>(sl, e, r, G * C, C, S, H, o, s);
  else launch<1>(sl, e, r, G * C, C, S, H, o, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
