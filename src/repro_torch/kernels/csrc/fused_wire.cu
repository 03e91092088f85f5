// The wire codec fused into the routing ops, for Hopper (sm_90a).
//
// Replaces the TPU kernels of repro/kernels/fused_wire.py:
//   dispatch_scatter_quantize_pallas (body _scatter_quant_kernel):
//     (q [E, C, H] int8 | fp8, scales [E, C] f32) =
//     wire_quantize(dispatch_scatter(ids, pos, src)), src [F, H] bf16 | f32;
//   dequantize_combine_gather_pallas (body _dequant_gather_kernel):
//     out [F, H] f32 = w[f] * (q * scale)[id_f, pos_f], 0 out of range;
//   dequantize_residual_apply_pallas (_dq_resid_kernel,
//   _dq_resid_base_kernel): out [G, C, H] f32 =
//     ((q * scale) - base)[g, slots[g, c]] + residual[g, c], base optional,
//     a slot outside [0, S) gathering 0.
// Each is bitwise its composition of the unfused ops (wire_quant.cu,
// scatter_gather.cu, residual_apply.cu), the contract of docs/kernels.md.
//
// Bound on the H100: bytes.  At the training shape (F = 32768 entries,
// E = G = 40, C = 1024, S = 208, H = 1536): the scatter-quantize reads the
// ids, positions and the kept bf16 src rows (100 MB) and writes 63 MB of
// payload and the scales, 49 us at 3.35 TB/s, against the 356 MB (106 us)
// of dispatch_scatter plus wire_quantize through an f32 buffer; the
// dequantize-gather reads one payload row and scale an entry (50 MB) and
// writes [F, H] f32 (201 MB), 75 us; the dequantize-residual reads the
// payload (13 MB), base (51 MB) and residual (252 MB) and writes 252 MB,
// 169 us.
//
// Design: the TPU kernels contract one-hot masks on the MXU; here each is a
// direct indexed load.
//   scatter-quantize: three steps on the stream, one wrapper launch.
//     (1) a memset zeroes two int32 [E * C] arrays of the wrapper's
//     scratch; (2) the row index, one thread an entry: for the buffer row
//     (id, pos) of each in-range entry, integer atomicAdd of its count and
//     atomicMax of F - f (so the first entry wins; 0 = no entry), whose
//     results do not depend on the order the threads arrive in; (3) one
//     warp a buffer row: as many warps as are resident walk all E * C
//     rows, each loading its next row's count and first entry while it
//     works on this one; all the first entry's loads of the lane's
//     16-column chunks issued before any reduction, then
//     (rarely; plans from build_dispatch_plan never have one) the row's
//     later entries, found by walking the entries after the first in
//     device memory, added in entry order, then the warp's absmax, the
//     scale and 16-byte payload stores (wire_codec.cuh).  So each row is
//     0 + first + later entries in entry order, dispatch_scatter's f32 row
//     bit for bit, and the f32 buffer never reaches device memory; an empty
//     row gets scale 1 and a zero payload.
//   dequantize-gather: w * (float(q) * scale) in that order, 0 out of
//     range.  Bound: 50 MB in, 201 MB out, 75 us.  The first version, one
//     warp an entry with 16 payload bytes a lane, took 0.167 ms, slower
//     than the plain combine_gather (0.139 ms) that moves 201 MB in: each
//     lane stored its 64 output bytes as four float4s, so every store
//     instruction of a warp wrote 32 pieces at a 64-byte stride, and each
//     entry's index chain (ids -> pos -> scale -> row) came before its
//     loads.  Now lane L takes payload words L, L + 32, ... (4 bytes, 12
//     a lane at H = 1536, all loads issued before any store) and writes
//     each as one float4, so a warp's store is 512 contiguous bytes, as
//     combine_gather's are, streamed past L2 (__stcs); resident warps walk
//     the entries, the next entry's id, position and weight, then its
//     scale, loaded while this entry's payload is in flight.  H not a
//     multiple of 4, or unaligned pointers, take a one-column-a-lane
//     kernel.
//   dequantize-residual: residual_apply.cu's gather, 4 columns a thread,
//     with the dequantize and the base subtraction in registers:
//     (float(q) * scale - base) + residual, in that order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "occupancy.cuh"
#include "wire_codec.cuh"

namespace {

constexpr int kIndexThreads = 256;
constexpr int kRowThreads = 256;                     // 8 buffer rows a block
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kGatherThreads = 256;                  // 8 warps a block
constexpr int kGatherWarps = kGatherThreads / 32;
constexpr int kGatherWords = 12;   // payload words a lane an entry in flight
constexpr int kResidThreads = 128;
constexpr int kResidRows = 4;

// (2) the row index: count[r] entries land in buffer row r, the first of
// them is F - latest[r] (both arrays zero before)
__global__ void __launch_bounds__(kIndexThreads)
index_rows_kernel(const int* __restrict__ ids, const int* __restrict__ pos,
                  int F, int E, int C, int* __restrict__ count,
                  int* __restrict__ latest) {
  const int f = blockIdx.x * kIndexThreads + threadIdx.x;
  if (f >= F) return;
  const int e = ids[f];
  const int c = pos[f];
  if (e < 0 || e >= E || c < 0 || c >= C) return;
  const size_t r = static_cast<size_t>(e) * C + c;
  atomicAdd(&count[r], 1);
  atomicMax(&latest[r], F - f);
}

// (3) one warp a buffer row: f32 row = 0 + src[first] (+ later entries in
// entry order), quantized as wire_quantize does
template <typename T, int FMT, int W, int CACHE>
__device__ __forceinline__ void scatter_quantize_row(
    const int* __restrict__ ids, const int* __restrict__ pos,
    const T* __restrict__ src, int n, int first, int row, int C, int H,
    uint8_t* __restrict__ q, float* __restrict__ scales, int lane) {
  const T* s0 = src + static_cast<size_t>(first) * H;
  uint8_t* qrow = q + static_cast<size_t>(row) * H;
  const int nch = H / W;
  float scale;
  if (n == 0) {
    scale = wire::quantize_row<FMT, W, CACHE>(
        [&](int, float (&v)[W]) {
#pragma unroll
          for (int j = 0; j < W; ++j) v[j] = 0.f;
        },
        nch, qrow, lane);
  } else if (n == 1) {
    scale = wire::quantize_row<FMT, W, CACHE>(
        [&](int ch, float (&v)[W]) {
          wire::load<W>(s0 + ch * W, v);
#pragma unroll
          for (int j = 0; j < W; ++j) v[j] = __fadd_rn(0.f, v[j]);
        },
        nch, qrow, lane);
  } else {
    const int e = row / C;
    const int c = row - e * C;
    scale = wire::quantize_row<FMT, W, CACHE>(
        [&](int ch, float (&v)[W]) {
          wire::load<W>(s0 + ch * W, v);
#pragma unroll
          for (int j = 0; j < W; ++j) v[j] = __fadd_rn(0.f, v[j]);
          for (int f = first + 1, seen = 1; seen < n; ++f) {
            if (ids[f] != e || pos[f] != c) continue;
            float d[W];
            wire::load<W>(src + static_cast<size_t>(f) * H + ch * W, d);
#pragma unroll
            for (int j = 0; j < W; ++j) v[j] = __fadd_rn(v[j], d[j]);
            ++seen;
          }
        },
        nch, qrow, lane);
  }
  if (lane == 0) scales[row] = scale;
}

// Each warp walks rows warp, warp + (all warps), ... of the E * C, the
// next row's count and first entry loaded while this row is worked on.
template <typename T, int FMT, int W, int CACHE>
__global__ void __launch_bounds__(kRowThreads)
scatter_quantize_rows_kernel(const int* __restrict__ ids,
                             const int* __restrict__ pos,
                             const T* __restrict__ src,
                             const int* __restrict__ count,
                             const int* __restrict__ latest, int F, int rows,
                             int C, int H, uint8_t* __restrict__ q,
                             float* __restrict__ scales) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kRowWarps;
  int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  int n = row < rows ? count[row] : 0;
  int first = row < rows ? F - latest[row] : 0;
  for (; row < rows; row += stride) {
    const int next = row + stride;
    const int n_next = next < rows ? count[next] : 0;
    const int first_next = next < rows ? F - latest[next] : 0;
    scatter_quantize_row<T, FMT, W, CACHE>(ids, pos, src, n, first, row, C,
                                           H, q, scales, lane);
    n = n_next;
    first = first_next;
  }
}

// The vector path (H % 4 == 0): as many warps as are resident walk the
// entries f, f + (all warps), ...; lane L of a warp loads payload words L,
// L + 32, ... of the entry's row (kGatherWords of them, all issued before
// any store) and writes each word's four values as one float4, so a
// warp's store covers 512 contiguous bytes of the output row.  While an
// entry's payload is in flight, the next entry's id, position and weight
// are loaded, then its scale.
template <int FMT>
__global__ void __launch_bounds__(kGatherThreads)
dequantize_combine_gather_kernel(const int* __restrict__ ids,
                                 const int* __restrict__ pos,
                                 const uint8_t* __restrict__ q,
                                 const float* __restrict__ scales,
                                 const float* __restrict__ w, int F, int E,
                                 int C, int H, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kGatherWarps;
  const int words = H / 4;
  int f = blockIdx.x * kGatherWarps + (threadIdx.x >> 5);
  int id = f < F ? ids[f] : -1;
  int p = f < F ? pos[f] : -1;
  float wf = f < F ? w[f] : 0.f;
  bool ok = id >= 0 && id < E && p >= 0 && p < C;
  size_t row = ok ? static_cast<size_t>(id) * C + p : 0;
  float scale = ok ? scales[row] : 0.f;
  for (; f < F; f += stride) {
    const int fn = f + stride;
    const int id_n = fn < F ? ids[fn] : -1;
    const int p_n = fn < F ? pos[fn] : -1;
    const float w_n = fn < F ? w[fn] : 0.f;
    bool ok_n = false;
    size_t row_n = 0;
    float scale_n = 0.f;
    const unsigned* qr = reinterpret_cast<const unsigned*>(q + row * H);
    float4* o = reinterpret_cast<float4*>(out + static_cast<size_t>(f) * H);
    for (int w0 = 0; w0 < words; w0 += 32 * kGatherWords) {
      unsigned b[kGatherWords];
#pragma unroll
      for (int k = 0; k < kGatherWords; ++k) {
        const int i = w0 + 32 * k + lane;
        b[k] = ok && i < words ? qr[i] : 0u;
      }
      if (w0 == 0) {   // the next entry's scale, behind this payload
        ok_n = id_n >= 0 && id_n < E && p_n >= 0 && p_n < C;
        row_n = ok_n ? static_cast<size_t>(id_n) * C + p_n : 0;
        scale_n = ok_n ? scales[row_n] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kGatherWords; ++k) {
        const int i = w0 + 32 * k + lane;
        if (i >= words) continue;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = ok ? __fmul_rn(wf, wire::dequant<FMT>(
                                        (b[k] >> (8 * j)) & 0xff, scale))
                    : 0.f;
        __stcs(o + i, make_float4(v[0], v[1], v[2], v[3]));
      }
    }
    id = id_n;
    p = p_n;
    wf = w_n;
    ok = ok_n;
    row = row_n;
    scale = scale_n;
  }
}

// The ragged path (H % 4 != 0 or unaligned pointers): one warp an entry,
// one column a lane.
template <int FMT>
__global__ void __launch_bounds__(kGatherThreads)
dequantize_combine_gather_scalar_kernel(const int* __restrict__ ids,
                                        const int* __restrict__ pos,
                                        const uint8_t* __restrict__ q,
                                        const float* __restrict__ scales,
                                        const float* __restrict__ w, int F,
                                        int E, int C, int H,
                                        float* __restrict__ out) {
  const int f = blockIdx.x * kGatherWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (f >= F) return;
  const int id = ids[f];
  const int p = pos[f];
  const bool ok = id >= 0 && id < E && p >= 0 && p < C;
  const size_t row = ok ? static_cast<size_t>(id) * C + p : 0;
  const float scale = ok ? scales[row] : 0.f;
  const float wf = w[f];
  const uint8_t* qr = q + row * H;
  float* o = out + static_cast<size_t>(f) * H;
  for (int col = lane; col < H; col += 32)
    o[col] = ok ? __fmul_rn(wf, wire::dequant<FMT>(qr[col], scale)) : 0.f;
}

template <int FMT, int VEC, bool BASE>
__global__ void __launch_bounds__(kResidThreads)
dequantize_residual_apply_kernel(const int* __restrict__ slots,
                                 const uint8_t* __restrict__ q,
                                 const float* __restrict__ scales,
                                 const float* __restrict__ base,
                                 const float* __restrict__ res, int rows,
                                 int C, int S, int H,
                                 float* __restrict__ out) {
  const int row0 = blockIdx.x * kResidRows;
  for (int k = 0; k < kResidRows; ++k) {
    const int row = row0 + k;   // g * C + c
    if (row >= rows) return;
    const int g = row / C;
    const int sl = slots[row];
    const bool ok = sl >= 0 && sl < S;
    const size_t srow = static_cast<size_t>(g) * S + (ok ? sl : 0);
    const float scale = ok ? scales[srow] : 0.f;
    const uint8_t* qr = q + srow * H;
    const float* br = BASE ? base + srow * H : nullptr;
    const float* r = res + static_cast<size_t>(row) * H;
    float* o = out + static_cast<size_t>(row) * H;
    for (int col = threadIdx.x * VEC; col < H; col += kResidThreads * VEC) {
      float d[VEC], rv[VEC], bv[VEC];
      if constexpr (VEC == 4) {
        const float4 a = *reinterpret_cast<const float4*>(r + col);
        rv[0] = a.x; rv[1] = a.y; rv[2] = a.z; rv[3] = a.w;
      } else {
        rv[0] = r[col];
      }
      if (ok) {
        if constexpr (VEC == 4) {
          const unsigned b = *reinterpret_cast<const unsigned*>(qr + col);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            d[j] = wire::dequant<FMT>((b >> (8 * j)) & 0xff, scale);
          if (BASE) {
            const float4 a = *reinterpret_cast<const float4*>(br + col);
            bv[0] = a.x; bv[1] = a.y; bv[2] = a.z; bv[3] = a.w;
          }
        } else {
          d[0] = wire::dequant<FMT>(qr[col], scale);
          if (BASE) bv[0] = br[col];
        }
        if (BASE)
#pragma unroll
          for (int j = 0; j < VEC; ++j) d[j] = __fsub_rn(d[j], bv[j]);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) d[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) d[j] = __fadd_rn(d[j], rv[j]);
      if constexpr (VEC == 4)
        *reinterpret_cast<float4*>(o + col) = make_float4(d[0], d[1], d[2], d[3]);
      else
        o[col] = d[0];
    }
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <auto kKernel, typename T>
cudaError_t launch_rows(const int* ids, const int* pos, const T* src,
                        const int* count, const int* latest, int F, int rows,
                        int C, int H, uint8_t* q, float* scales,
                        cudaStream_t s) {
  int grid = 0;
  cudaError_t err = occupancy::resident_blocks<kKernel>(
      kRowThreads, (rows + kRowWarps - 1) / kRowWarps, &grid);
  if (err != cudaSuccess) return err;
  kKernel<<<grid, kRowThreads, 0, s>>>(ids, pos, src, count, latest, F, rows,
                                       C, H, q, scales);
  return cudaGetLastError();
}

template <typename T, int FMT>
cudaError_t launch_scatter_quantize(const void* ids, const void* pos,
                                    const void* src, int F, int E, int C,
                                    int H, void* q, void* scales,
                                    void* scratch, cudaStream_t s) {
  const int rows = E * C;
  const int* i = static_cast<const int*>(ids);
  const int* p = static_cast<const int*>(pos);
  const T* x = static_cast<const T*>(src);
  uint8_t* qb = static_cast<uint8_t*>(q);
  float* sc = static_cast<float*>(scales);
  int* count = static_cast<int*>(scratch);
  int* latest = count + rows;
  cudaError_t err = cudaMemsetAsync(scratch, 0, 2 * sizeof(int) *
                                    static_cast<size_t>(rows), s);
  if (err != cudaSuccess) return err;
  if (F > 0)
    index_rows_kernel<<<(F + kIndexThreads - 1) / kIndexThreads,
                        kIndexThreads, 0, s>>>(i, p, F, E, C, count, latest);
  if (H % 16 == 0 && aligned(src, 16) && aligned(q, 16))
    return launch_rows<scatter_quantize_rows_kernel<T, FMT, 16, 4>>(
        i, p, x, count, latest, F, rows, C, H, qb, sc, s);
  return launch_rows<scatter_quantize_rows_kernel<T, FMT, 1, 16>>(
      i, p, x, count, latest, F, rows, C, H, qb, sc, s);
}

template <int FMT>
cudaError_t launch_gather(const void* ids, const void* pos, const void* q,
                          const void* scales, const void* w, int F, int E,
                          int C, int H, void* out, cudaStream_t s) {
  const int* i = static_cast<const int*>(ids);
  const int* p = static_cast<const int*>(pos);
  const uint8_t* qb = static_cast<const uint8_t*>(q);
  const float* sc = static_cast<const float*>(scales);
  const float* wt = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  const int want = (F + kGatherWarps - 1) / kGatherWarps;
  if (H % 4 == 0 && aligned(q, 4) && aligned(out, 16)) {
    int grid = 0;
    cudaError_t err = occupancy::resident_blocks<
        dequantize_combine_gather_kernel<FMT>>(kGatherThreads, want, &grid);
    if (err != cudaSuccess) return err;
    dequantize_combine_gather_kernel<FMT><<<grid, kGatherThreads, 0, s>>>(
        i, p, qb, sc, wt, F, E, C, H, o);
  } else {
    dequantize_combine_gather_scalar_kernel<FMT>
        <<<want, kGatherThreads, 0, s>>>(i, p, qb, sc, wt, F, E, C, H, o);
  }
  return cudaGetLastError();
}

template <int FMT, int VEC>
void launch_residual(const int* slots, const uint8_t* q, const float* scales,
                     const float* base, const float* res, int rows, int C,
                     int S, int H, float* out, cudaStream_t s) {
  const dim3 grid((rows + kResidRows - 1) / kResidRows);
  if (base != nullptr)
    dequantize_residual_apply_kernel<FMT, VEC, true>
        <<<grid, kResidThreads, 0, s>>>(slots, q, scales, base, res, rows, C,
                                        S, H, out);
  else
    dequantize_residual_apply_kernel<FMT, VEC, false>
        <<<grid, kResidThreads, 0, s>>>(slots, q, scales, base, res, rows, C,
                                        S, H, out);
}

template <int FMT>
void launch_residual_fmt(const void* slots, const void* q, const void* scales,
                         const void* base, const void* res, int G, int C,
                         int S, int H, void* out, cudaStream_t s) {
  const int* sl = static_cast<const int*>(slots);
  const uint8_t* qb = static_cast<const uint8_t*>(q);
  const float* sc = static_cast<const float*>(scales);
  const float* b = static_cast<const float*>(base);
  const float* r = static_cast<const float*>(res);
  float* o = static_cast<float*>(out);
  const bool vec = H % 4 == 0 && aligned(q, 4) && aligned(res, 16) &&
                   aligned(out, 16) && (base == nullptr || aligned(base, 16));
  if (vec) launch_residual<FMT, 4>(sl, qb, sc, b, r, G * C, C, S, H, o, s);
  else launch_residual<FMT, 1>(sl, qb, sc, b, r, G * C, C, S, H, o, s);
}

}  // namespace

extern "C" {

// ids, pos: [F] int32; src: [F, H] f32 (src_is_bf16 = 0) or bf16 (1);
// q: [E, C, H] bytes (int8, or fp8-e4m3 when is_fp8); scales: [E, C] f32;
// scratch: 2 * E * C int32 (the row index; contents on entry unused).
int dispatch_scatter_quantize_launch(const void* ids, const void* pos,
                                     const void* src, int src_is_bf16,
                                     int is_fp8, int F, int E, int C, int H,
                                     void* q, void* scales, void* scratch,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (src_is_bf16) {
    if (is_fp8)
      err = launch_scatter_quantize<__nv_bfloat16, wire::kFp8>(ids, pos, src, F, E, C, H, q, scales, scratch, s);
    else
      err = launch_scatter_quantize<__nv_bfloat16, wire::kInt8>(ids, pos, src, F, E, C, H, q, scales, scratch, s);
  } else {
    if (is_fp8)
      err = launch_scatter_quantize<float, wire::kFp8>(ids, pos, src, F, E, C, H, q, scales, scratch, s);
    else
      err = launch_scatter_quantize<float, wire::kInt8>(ids, pos, src, F, E, C, H, q, scales, scratch, s);
  }
  return static_cast<int>(err);
}

// ids, pos, w: [F]; q: [E, C, H] bytes; scales: [E, C] f32; out: [F, H] f32.
int dequantize_combine_gather_launch(const void* ids, const void* pos,
                                     const void* q, const void* scales,
                                     const void* w, int is_fp8, int F, int E,
                                     int C, int H, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_fp8 ? launch_gather<wire::kFp8>(ids, pos, q, scales, w, F, E, C, H, out, s)
             : launch_gather<wire::kInt8>(ids, pos, q, scales, w, F, E, C, H, out, s));
}

// slots: [G, C] int32; q: [G, S, H] bytes; scales: [G, S] f32; base:
// [G, S, H] f32 or null (no subtraction); res, out: [G, C, H] f32.
int dequantize_residual_apply_launch(const void* slots, const void* q,
                                     const void* scales, const void* base,
                                     const void* res, int is_fp8, int G,
                                     int C, int S, int H, void* out,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_fp8) launch_residual_fmt<wire::kFp8>(slots, q, scales, base, res, G, C, S, H, out, s);
  else launch_residual_fmt<wire::kInt8>(slots, q, scales, base, res, G, C, S, H, out, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
