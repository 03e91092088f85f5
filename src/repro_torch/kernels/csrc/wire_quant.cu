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
// one column a lane.  The dequantize is one product an element, 16
// elements a thread on the vector path.  Both are bitwise the plain
// versions of kernels/ref.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "wire_codec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

template <int FMT, int W>
__global__ void __launch_bounds__(kThreads)
wire_dequantize_kernel(const uint8_t* __restrict__ q,
                       const float* __restrict__ scales, long long chunks,
                       int H, float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= chunks) return;
  const long long at = i * W;          // a chunk lies inside one row
  const float scale = scales[at / H];
  if constexpr (W == 16) {
    const uint4 b = *reinterpret_cast<const uint4*>(q + at);
    const unsigned w[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float4 o;
      o.x = __fmul_rn(wire::decode<FMT>(w[k] & 0xff), scale);
      o.y = __fmul_rn(wire::decode<FMT>((w[k] >> 8) & 0xff), scale);
      o.z = __fmul_rn(wire::decode<FMT>((w[k] >> 16) & 0xff), scale);
      o.w = __fmul_rn(wire::decode<FMT>(w[k] >> 24), scale);
      reinterpret_cast<float4*>(out + at)[k] = o;
    }
  } else {
    out[at] = __fmul_rn(wire::decode<FMT>(q[at]), scale);
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

template <int FMT>
void launch_dequantize(const void* q, const void* scales, long long n, int H,
                       void* out, cudaStream_t s) {
  const uint8_t* qb = static_cast<const uint8_t*>(q);
  const float* sc = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  if (H % 16 == 0 && aligned(q, 16) && aligned(out, 16)) {
    const long long chunks = n / 16;
    wire_dequantize_kernel<FMT, 16>
        <<<static_cast<unsigned>((chunks + kThreads - 1) / kThreads),
           kThreads, 0, s>>>(qb, sc, chunks, H, o);
  } else {
    wire_dequantize_kernel<FMT, 1>
        <<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
           s>>>(qb, sc, n, H, o);
  }
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
  const long long n = static_cast<long long>(rows) * H;
  if (is_fp8) launch_dequantize<wire::kFp8>(q, scales, n, H, out, s);
  else launch_dequantize<wire::kInt8>(q, scales, n, H, out, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
