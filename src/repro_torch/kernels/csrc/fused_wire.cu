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
//   scatter-quantize: grid (E, row chunks of 128).  A block indexes its
//     rows' entries as dispatch_scatter does (scatter_rows.cuh); then one
//     warp takes one buffer row: each lane sums its 16-column chunks of the
//     row's entries in entry order in f32 registers (0 + first, then the
//     later duplicates), the warp takes the absmax, and the row is scaled,
//     encoded and stored with 16-byte stores (wire_codec.cuh).  The f32
//     buffer never reaches device memory; an empty row gets scale 1 and a
//     zero payload.
//   dequantize-gather: one warp per entry, 16 payload bytes a lane per
//     load, w * (float(q) * scale) in that order.
//   dequantize-residual: residual_apply.cu's gather, 4 columns a thread,
//     with the dequantize and the base subtraction in registers:
//     (float(q) * scale - base) + residual, in that order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "scatter_rows.cuh"
#include "wire_codec.cuh"

namespace {

constexpr int kGatherThreads = 256;                  // 8 entries a block
constexpr int kGatherWarps = kGatherThreads / 32;
constexpr int kResidThreads = 128;
constexpr int kResidRows = 4;

template <typename T, int FMT, int W, int CACHE>
__global__ void __launch_bounds__(scatter_rows::kThreads)
dispatch_scatter_quantize_kernel(const int* __restrict__ ids,
                                 const int* __restrict__ pos,
                                 const T* __restrict__ src, int F, int C,
                                 int H, uint8_t* __restrict__ q,
                                 float* __restrict__ scales) {
  __shared__ scatter_rows::Shared sh;
  const int e = blockIdx.x;
  const int c0 = blockIdx.y * scatter_rows::kRows;
  const int rows = min(scatter_rows::kRows, C - c0);
  const int n_list = scatter_rows::index_rows(ids, pos, F, e, c0, rows, sh);
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += scatter_rows::kWarps) {
    const int first = sh.first[r];
    const int count = sh.count[r];
    const size_t row = static_cast<size_t>(e) * C + c0 + r;
    const float scale = wire::quantize_row<FMT, W, CACHE>(
        [&](int ch, float (&v)[W]) {
          const int col = ch * W;
          if (count == 0) {
#pragma unroll
            for (int j = 0; j < W; ++j) v[j] = 0.f;
            return;
          }
          wire::load<W>(src + static_cast<size_t>(first) * H + col, v);
#pragma unroll
          for (int j = 0; j < W; ++j) v[j] = __fadd_rn(0.f, v[j]);
          scatter_rows::for_later(
              sh, n_list, ids, pos, e, c0, r, first, count, [&](int f) {
                float d[W];
                wire::load<W>(src + static_cast<size_t>(f) * H + col, d);
#pragma unroll
                for (int j = 0; j < W; ++j) v[j] = __fadd_rn(v[j], d[j]);
              });
        },
        H / W, q + row * H, lane);
    if (lane == 0) scales[row] = scale;
  }
}

template <int FMT, int W>
__global__ void __launch_bounds__(kGatherThreads)
dequantize_combine_gather_kernel(const int* __restrict__ ids,
                                 const int* __restrict__ pos,
                                 const uint8_t* __restrict__ q,
                                 const float* __restrict__ scales,
                                 const float* __restrict__ w, int F, int E,
                                 int C, int H, float* __restrict__ out) {
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
  for (int col = lane * W; col < H; col += 32 * W) {
    float v[W];
    if constexpr (W == 16) {
      unsigned b[4] = {0u, 0u, 0u, 0u};
      if (ok) {
        const uint4 u = *reinterpret_cast<const uint4*>(qr + col);
        b[0] = u.x;
        b[1] = u.y;
        b[2] = u.z;
        b[3] = u.w;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j)
        v[j] = ok ? __fmul_rn(wf, __fmul_rn(
                        wire::decode<FMT>((b[j / 4] >> (8 * (j % 4))) & 0xff),
                        scale))
                  : 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        reinterpret_cast<float4*>(o + col)[k] =
            make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    } else {
      o[col] = ok ? __fmul_rn(wf, __fmul_rn(wire::decode<FMT>(qr[col]),
                                            scale))
                  : 0.f;
    }
  }
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
            d[j] = wire::decode<FMT>((b >> (8 * j)) & 0xff);
          if (BASE) {
            const float4 a = *reinterpret_cast<const float4*>(br + col);
            bv[0] = a.x; bv[1] = a.y; bv[2] = a.z; bv[3] = a.w;
          }
        } else {
          d[0] = wire::decode<FMT>(qr[col]);
          if (BASE) bv[0] = br[col];
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          d[j] = __fmul_rn(d[j], scale);
          if (BASE) d[j] = __fsub_rn(d[j], bv[j]);
        }
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

template <typename T, int FMT>
void launch_scatter_quantize(const void* ids, const void* pos,
                             const void* src, int F, int E, int C, int H,
                             void* q, void* scales, cudaStream_t s) {
  const dim3 grid(E, (C + scatter_rows::kRows - 1) / scatter_rows::kRows);
  const int* i = static_cast<const int*>(ids);
  const int* p = static_cast<const int*>(pos);
  const T* x = static_cast<const T*>(src);
  uint8_t* qb = static_cast<uint8_t*>(q);
  float* sc = static_cast<float*>(scales);
  if (H % 16 == 0 && aligned(src, 16) && aligned(q, 16))
    dispatch_scatter_quantize_kernel<T, FMT, 16, 4>
        <<<grid, scatter_rows::kThreads, 0, s>>>(i, p, x, F, C, H, qb, sc);
  else
    dispatch_scatter_quantize_kernel<T, FMT, 1, 16>
        <<<grid, scatter_rows::kThreads, 0, s>>>(i, p, x, F, C, H, qb, sc);
}

template <int FMT>
void launch_gather(const void* ids, const void* pos, const void* q,
                   const void* scales, const void* w, int F, int E, int C,
                   int H, void* out, cudaStream_t s) {
  const dim3 grid((F + kGatherWarps - 1) / kGatherWarps);
  const int* i = static_cast<const int*>(ids);
  const int* p = static_cast<const int*>(pos);
  const uint8_t* qb = static_cast<const uint8_t*>(q);
  const float* sc = static_cast<const float*>(scales);
  const float* wt = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  if (H % 16 == 0 && aligned(q, 16) && aligned(out, 16))
    dequantize_combine_gather_kernel<FMT, 16><<<grid, kGatherThreads, 0, s>>>(
        i, p, qb, sc, wt, F, E, C, H, o);
  else
    dequantize_combine_gather_kernel<FMT, 1><<<grid, kGatherThreads, 0, s>>>(
        i, p, qb, sc, wt, F, E, C, H, o);
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
// q: [E, C, H] bytes (int8, or fp8-e4m3 when is_fp8); scales: [E, C] f32.
int dispatch_scatter_quantize_launch(const void* ids, const void* pos,
                                     const void* src, int src_is_bf16,
                                     int is_fp8, int F, int E, int C, int H,
                                     void* q, void* scales, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (src_is_bf16) {
    if (is_fp8)
      launch_scatter_quantize<__nv_bfloat16, wire::kFp8>(ids, pos, src, F, E, C, H, q, scales, s);
    else
      launch_scatter_quantize<__nv_bfloat16, wire::kInt8>(ids, pos, src, F, E, C, H, q, scales, s);
  } else {
    if (is_fp8)
      launch_scatter_quantize<float, wire::kFp8>(ids, pos, src, F, E, C, H, q, scales, s);
    else
      launch_scatter_quantize<float, wire::kInt8>(ids, pos, src, F, E, C, H, q, scales, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// ids, pos, w: [F]; q: [E, C, H] bytes; scales: [E, C] f32; out: [F, H] f32.
int dequantize_combine_gather_launch(const void* ids, const void* pos,
                                     const void* q, const void* scales,
                                     const void* w, int is_fp8, int F, int E,
                                     int C, int H, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_fp8) launch_gather<wire::kFp8>(ids, pos, q, scales, w, F, E, C, H, out, s);
  else launch_gather<wire::kInt8>(ids, pos, q, scales, w, F, E, C, H, out, s);
  return static_cast<int>(cudaGetLastError());
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
