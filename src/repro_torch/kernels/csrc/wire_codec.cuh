// The quantized wire codec's arithmetic on Hopper, shared by wire_quant.cu
// and fused_wire.cu: the power-of-two absmax scale of
// repro/kernels/wire_quant.py (po2_scale, _encode) and its decode.
//
// Every result is the plain version's (kernels/ref.py) in f32, with the
// IEEE intrinsics (__fdiv_rn, __fmul_rn, ...) so that nvcc contracts
// nothing into an FMA; the build has no --use_fast_math, so no flush to
// zero either.  The reference runs where subnormals flush to zero, and two
// of its flushes are emulated here, each in one place: a row whose absmax
// is below 2^-126 is empty, with scale 1 (po2_scale); a dequantized value
// below 2^-126 in magnitude is a zero of its sign (dequant).  Every decode
// times scale goes through dequant.  Other f32 arithmetic (the weight of a
// gather, a residual's sum) does not flush, on the card or in the plain
// versions.
//
// A row is processed by one warp in chunks of W columns (W = 16 on the
// vector path: 16-byte payload stores; W = 1 on the scalar path for any H).
// A lane keeps its first CACHE chunks in registers between the absmax pass
// and the encode pass and recomputes any later one (only when
// H > 32 * CACHE * W).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace wire {

constexpr int kInt8 = 0;
constexpr int kFp8 = 1;
constexpr float kTiny = 1.17549435e-38f;   // 2^-126, the smallest normal

template <int FMT>
__device__ __forceinline__ float qmax() {
  return FMT == kInt8 ? 127.f : 448.f;
}

// |x| as its bits: an unsigned max over them is the f32 absmax for finite
// values and propagates a NaN (its bits exceed those of inf), as amax does.
__device__ __forceinline__ unsigned abs_bits(float x) {
  return __float_as_uint(x) & 0x7fffffffu;
}

// Smallest power of two >= absmax / qmax, from the exponent bits of the
// quotient; 1 for an empty row (absmax < 2^-126) or a NaN one.
template <int FMT>
__device__ __forceinline__ float po2_scale(unsigned absmax_bits) {
  const float absmax = __uint_as_float(absmax_bits);
  if (!(absmax >= kTiny)) return 1.f;
  const int bits = __float_as_int(__fdiv_rn(absmax, qmax<FMT>()));
  const int e = ((bits >> 23) & 0xFF) - 127;
  const int frac = (bits & 0x7FFFFF) != 0;
  const int k = min(max(e + frac, -126), 126);
  return __int_as_float((k + 127) << 23);
}

// clamp that keeps a NaN, as torch.clamp does
__device__ __forceinline__ float clip(float y, float lim) {
  return y < -lim ? -lim : (y > lim ? lim : y);
}

// One value of the row, divided by its scale, to its payload byte: int8
// rounds half to even then clips to +-127; fp8-e4m3 clips to +-448 then
// rounds to nearest even (the saturating cast changes no value in range).
// The quotient is taken as x * inv, inv = 1 / scale: the scale is a power
// of two in [2^-126, 2^126], so inv is exact and the product rounds the
// same real number as x / scale, subnormals included (no flush to zero).
template <int FMT>
__device__ __forceinline__ uint8_t encode(float x, float inv) {
  const float y = __fmul_rn(x, inv);
  if (FMT == kInt8)
    return static_cast<uint8_t>(
        static_cast<int8_t>(__float2int_rn(clip(rintf(y), 127.f))));
  return static_cast<uint8_t>(
      __nv_cvt_float_to_fp8(clip(y, 448.f), __NV_SATFINITE, __NV_E4M3));
}

// A payload byte to f32 (exact for both formats).
template <int FMT>
__device__ __forceinline__ float decode(uint8_t b) {
  if (FMT == kInt8) return static_cast<float>(static_cast<int8_t>(b));
  const __half_raw h = __nv_cvt_fp8_to_halfraw(
      static_cast<__nv_fp8_storage_t>(b), __NV_E4M3);
  return __half2float(__half(h));
}

// A payload byte times its row's scale, as the reference computes it:
// a product below 2^-126 in magnitude flushes to a zero of its sign (an
// fp8 payload under a row scale of 2^-117 or less can give one).
template <int FMT>
__device__ __forceinline__ float dequant(uint8_t b, float scale) {
  const float p = __fmul_rn(decode<FMT>(b), scale);
  return fabsf(p) < kTiny ? copysignf(0.f, p) : p;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// W consecutive values of a row to f32: 16-byte loads for W = 16.
template <int W>
__device__ __forceinline__ void load(const float* p, float (&v)[W]) {
  if constexpr (W == 16) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 a = reinterpret_cast<const float4*>(p)[k];
      v[4 * k] = a.x;
      v[4 * k + 1] = a.y;
      v[4 * k + 2] = a.z;
      v[4 * k + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] = p[j];
  }
}

template <int W>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[W]) {
  if constexpr (W == 16) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const uint4 a = reinterpret_cast<const uint4*>(p)[k];
      const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        v[8 * k + 2 * m] = __uint_as_float(w[m] << 16);
        v[8 * k + 2 * m + 1] = __uint_as_float(w[m] & 0xffff0000u);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] = to_f32(p[j]);
  }
}

// W payload bytes of one chunk; one 16-byte store for W = 16.
template <int FMT, int W>
__device__ __forceinline__ void store(uint8_t* p, const float (&v)[W],
                                      float inv) {
  if constexpr (W == 16) {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = static_cast<unsigned>(encode<FMT>(v[4 * k], inv)) |
             static_cast<unsigned>(encode<FMT>(v[4 * k + 1], inv)) << 8 |
             static_cast<unsigned>(encode<FMT>(v[4 * k + 2], inv)) << 16 |
             static_cast<unsigned>(encode<FMT>(v[4 * k + 3], inv)) << 24;
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) p[j] = encode<FMT>(v[j], inv);
  }
}

// Quantize one row of nch chunks with the calling warp (all 32 lanes must
// call it).  chunk(i, v) fills v with the f32 values of chunk i; it is
// called once for each chunk a lane caches, twice for any other.  Writes
// the payload to qrow and returns the row's scale.
template <int FMT, int W, int CACHE, typename Chunk>
__device__ __forceinline__ float quantize_row(Chunk chunk, int nch,
                                              uint8_t* qrow, int lane) {
  float cache[CACHE][W];
  // every cached chunk's loads first, so that they are all in flight
#pragma unroll
  for (int i = 0; i < CACHE; ++i)
    if (lane + 32 * i < nch) chunk(lane + 32 * i, cache[i]);
  unsigned amax = 0;
#pragma unroll
  for (int i = 0; i < CACHE; ++i)
    if (lane + 32 * i < nch)
#pragma unroll
      for (int j = 0; j < W; ++j) amax = max(amax, abs_bits(cache[i][j]));
  for (int ch = lane + 32 * CACHE; ch < nch; ch += 32) {
    float v[W];
    chunk(ch, v);
#pragma unroll
    for (int j = 0; j < W; ++j) amax = max(amax, abs_bits(v[j]));
  }
  const float scale = po2_scale<FMT>(__reduce_max_sync(0xffffffffu, amax));
  const float inv = __frcp_rn(scale);
#pragma unroll
  for (int i = 0; i < CACHE; ++i) {
    const int ch = lane + 32 * i;
    if (ch < nch) store<FMT, W>(qrow + ch * W, cache[i], inv);
  }
  for (int ch = lane + 32 * CACHE; ch < nch; ch += 32) {
    float v[W];
    chunk(ch, v);
    store<FMT, W>(qrow + ch * W, v, inv);
  }
  return scale;
}

}  // namespace wire
