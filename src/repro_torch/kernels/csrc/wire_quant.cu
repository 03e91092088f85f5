// wire_quantize and wire_dequantize for Hopper (sm_90a).
//
// wire_quantize replaces the TPU kernel repro/kernels/wire_quant.py:
// wire_quantize_pallas (body _quant_kernel): x [G, S, H] f32 or bf16 ->
// q [G, S, H] int8 or fp8-e4m3 and scales [G, S] f32, one power-of-two
// absmax scale per (group, slot) row (wire_codec.cuh).  wire_dequantize
// replaces wire_dequantize_pallas (body _dequant_kernel): q * scale, f32.
//
// Bound on the H100: bytes.  The quantize reads x once and writes one byte
// an element plus a scale a row; at the training shape (G = 40, S = 208,
// H = 1536) that is 51 + 13 MB from f32 centroids (19 us at 3.35 TB/s) and
// 26 + 13 MB from bf16 expert outputs (11 us).  The dequantize reads 13 MB
// and writes 51 MB (19 us).  A division and a conversion an element are
// far below the card's rate.
//
// Design: the TPU kernel masks the rows of its padded last [tile_s, H]
// tile before the absmax; here one warp owns one row, so nothing is padded
// and no row past G * S is read.  The vector path (H % 16 == 0, 16-byte
// aligned rows) has each lane load 16 values (one or two 16-byte loads),
// keep them in registers, take the row's absmax with a warp max over the
// values' bits, derive the scale by the reference's integer bit
// arithmetic, encode and store 16 payload bytes at once.  Any other H takes
// one column a lane.
//
// The dequantize is laid out by rows too: as many warps as are resident
// walk the rows, each loading its next row's scale while it works on this
// one, so a scale is read once a row and no index is divided.  On the
// vector path (H % 4 == 0, q 4-byte and out 16-byte aligned) lane L takes
// payload words L, L + 32, ... of the row (kDqUnits of them in flight,
// all loaded before any store) and writes each word's four values as one
// float4, so a warp's load is 128 contiguous bytes and its store 512,
// streamed past L2 (__stcs); one float4 store a thread at a 16-byte
// stride would touch 32 pieces over 2 KB a warp instruction.  Any other H
// takes one byte a lane the same way.  Each value goes through
// wire::dequant (wire_codec.cuh), which flushes a product below 2^-126 to
// a zero of its sign as the reference does.  Both kernels are bitwise the
// plain versions of kernels/ref.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "occupancy.cuh"
#include "wire_codec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDqUnits = 12;   // payload units a lane a row in flight

template <typename T, int FMT, int W, int CACHE>
__global__ void __launch_bounds__(kThreads)
wire_quantize_kernel(const T* __restrict__ x, int rows, int H,
                     uint8_t* __restrict__ q, float* __restrict__ scales) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;   // the whole warp leaves together
  const T* xr = x + static_cast<size_t>(row) * H;
  const float scale = wire::quantize_row<FMT, W, CACHE>(
      [&](int ch, float (&v)[W]) { wire::load<W>(xr + ch * W, v); }, H / W,
      q + static_cast<size_t>(row) * H, lane);
  if (lane == 0) scales[row] = scale;
}

// VEC payload bytes a unit: 4 (one word, one float4 out) on the vector
// path, 1 elsewhere.
template <int VEC>
struct Unit;
template <>
struct Unit<4> {
  using T = unsigned;
  using Out = float4;
};
template <>
struct Unit<1> {
  using T = uint8_t;
  using Out = float;
};

template <int FMT, int VEC>
__global__ void __launch_bounds__(kThreads)
wire_dequantize_kernel(const uint8_t* __restrict__ q,
                       const float* __restrict__ scales, int rows, int H,
                       float* __restrict__ out) {
  using T = typename Unit<VEC>::T;
  using Out = typename Unit<VEC>::Out;
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarps;
  const int units = H / VEC;
  int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  float scale = row < rows ? scales[row] : 0.f;
  for (; row < rows; row += stride) {
    const int next = row + stride;
    float scale_n = 0.f;
    const T* qr = reinterpret_cast<const T*>(q + static_cast<size_t>(row) * H);
    Out* o = reinterpret_cast<Out*>(out + static_cast<size_t>(row) * H);
    for (int u0 = 0; u0 < units; u0 += 32 * kDqUnits) {
      T b[kDqUnits];
#pragma unroll
      for (int k = 0; k < kDqUnits; ++k) {
        const int i = u0 + 32 * k + lane;
        b[k] = i < units ? qr[i] : T(0);
      }
      if (u0 == 0 && next < rows) scale_n = scales[next];
#pragma unroll
      for (int k = 0; k < kDqUnits; ++k) {
        const int i = u0 + 32 * k + lane;
        if (i >= units) continue;
        if constexpr (VEC == 4)
          __stcs(o + i, make_float4(
                            wire::dequant<FMT>(b[k] & 0xff, scale),
                            wire::dequant<FMT>((b[k] >> 8) & 0xff, scale),
                            wire::dequant<FMT>((b[k] >> 16) & 0xff, scale),
                            wire::dequant<FMT>(b[k] >> 24, scale)));
        else
          __stcs(o + i, wire::dequant<FMT>(b[k], scale));
      }
    }
    scale = scale_n;
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, int FMT>
void launch_quantize(const void* x, int rows, int H, void* q, void* scales,
                     cudaStream_t s) {
  const dim3 grid((rows + kWarps - 1) / kWarps);
  const T* xt = static_cast<const T*>(x);
  uint8_t* qb = static_cast<uint8_t*>(q);
  float* sc = static_cast<float*>(scales);
  if (H % 16 == 0 && aligned(x, 16) && aligned(q, 16))
    wire_quantize_kernel<T, FMT, 16, 4><<<grid, kThreads, 0, s>>>(
        xt, rows, H, qb, sc);
  else
    wire_quantize_kernel<T, FMT, 1, 16><<<grid, kThreads, 0, s>>>(
        xt, rows, H, qb, sc);
}

template <auto kKernel>
cudaError_t launch_rows(const uint8_t* q, const float* scales, int rows,
                        int H, float* out, cudaStream_t s) {
  int grid = 0;
  cudaError_t err = occupancy::resident_blocks<kKernel>(
      kThreads, (rows + kWarps - 1) / kWarps, &grid);
  if (err != cudaSuccess) return err;
  kKernel<<<grid, kThreads, 0, s>>>(q, scales, rows, H, out);
  return cudaGetLastError();
}

template <int FMT>
cudaError_t launch_dequantize(const void* q, const void* scales, int rows,
                              int H, void* out, cudaStream_t s) {
  const uint8_t* qb = static_cast<const uint8_t*>(q);
  const float* sc = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  if (H % 4 == 0 && aligned(q, 4) && aligned(out, 16))
    return launch_rows<wire_dequantize_kernel<FMT, 4>>(qb, sc, rows, H, o, s);
  return launch_rows<wire_dequantize_kernel<FMT, 1>>(qb, sc, rows, H, o, s);
}

}  // namespace

extern "C" {

// x: [rows, H] f32 (x_is_bf16 = 0) or bf16 (1); q: [rows, H] bytes (int8,
// or fp8-e4m3 when is_fp8); scales: [rows] f32.
int wire_quantize_launch(const void* x, int x_is_bf16, int is_fp8, int rows,
                         int H, void* q, void* scales, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    if (is_fp8) launch_quantize<__nv_bfloat16, wire::kFp8>(x, rows, H, q, scales, s);
    else launch_quantize<__nv_bfloat16, wire::kInt8>(x, rows, H, q, scales, s);
  } else {
    if (is_fp8) launch_quantize<float, wire::kFp8>(x, rows, H, q, scales, s);
    else launch_quantize<float, wire::kInt8>(x, rows, H, q, scales, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// q: [rows, H] bytes; scales: [rows] f32; out: [rows, H] f32.
int wire_dequantize_launch(const void* q, const void* scales, int is_fp8,
                           int rows, int H, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_fp8 ? launch_dequantize<wire::kFp8>(q, scales, rows, H, out, s)
             : launch_dequantize<wire::kInt8>(q, scales, rows, H, out, s));
}

}  // extern "C"
