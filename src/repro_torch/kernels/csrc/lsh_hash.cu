// lsh_hash for Hopper (sm_90a): cross-polytope vertex ids.
//
// Replaces the TPU kernel repro/kernels/lsh_hash.py: lsh_hash_pallas (body
// _kernel): for every token t and hash l, v = x[t] . R[l] ([Dr] values) and
// vertex = 2 * argmax|v| + (v[argmax] < 0), [T, L] int32.  The tie rule is
// the plain version's (kernels/ref.py lsh_hash_ref, jnp.argmax): the FIRST
// index among equal |v|, with the sign of that one element.  The Pallas body
// instead sums v over all tied maxima; this kernel does not follow it.  An
// all-zero row (an unfilled dispatch-buffer row) gives vertex 0.
//
// Bound on the H100: operations.  2 * T * H * L * Dr multiply-adds; at the
// training shape (T = 40960, H = 1536, L = 6, Dr = 64) that is 48.3 GFLOP:
// 49 us at the 989 TFLOP/s of the bf16 tensor cores, 0.72 ms at the
// 67 TFLOP/s of f32 FMA, against 38 us for the bytes (x read once in
// bf16).
//
// Two kernels, chosen by what the wrapper sees:
// - bf16 x and bf16 rotations (the training path: the dispatch buffer and
//   the lsh_rot params are bf16), H and Dr multiples of 8: the tensor
//   cores.  Products of bf16 values are exact in f32 and mma.sync
//   accumulates in f32, so this computes the function of the f32 plain
//   version up to the order of the f32 sums.  Grid (L, T / 64), hash
//   fastest, so the L blocks of one 64-row tile of x run together and
//   read it from L2.  Four warps split the 64 rows; each computes 16 rows
//   x 64 columns with m16n8k16 bf16 mma.sync over 32-deep k slices
//   staged in shared memory (the next slice loaded into registers while
//   this one is used).
// - otherwise (f32 inputs, as in an f32 model): f32 FMA, grid (T / 128,
//   L / 2), a [128 tokens, 2 hashes x 64 columns] tile a block with 8-deep
//   k slices in shared memory (the next one prefetched into registers)
//   and an 8 x 8 register tile a thread; each output one FMA chain over h
//   in order.
// Both keep the rotated values out of device memory: the argmax is the
// epilogue, in registers.  The lanes that hold one row's columns scan
// theirs in order and shuffle-reduce with (|v| larger, or equal and index
// smaller).  Both give the same bits on a second call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;   // 16 x 16, an 8 x 8 output tile each
constexpr int BM = 128;         // tokens per block
constexpr int kHashes = 2;      // hashes per block
constexpr int kCols = 64;       // columns per hash (Dr <= 64)
constexpr int BN = kHashes * kCols;
constexpr int BK = 8;           // k slice
constexpr int TM = 8;
constexpr int TN = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lsh_hash_kernel(const T* __restrict__ x, const float* __restrict__ rot,
                int Tn, int H, int L, int Dr, int* __restrict__ out) {
  __shared__ __align__(16) float As[BK][BM + 4];   // +4: no bank conflicts
  __shared__ __align__(16) float Bs[BK][BN];
  constexpr int kA = BM * BK / kThreads;   // x values a thread stages
  constexpr int kB = BK * BN / kThreads;   // R values a thread stages
  const int m0 = blockIdx.x * BM;
  const int l0 = blockIdx.y * kHashes;
  const int tid = threadIdx.x;
  const int tx = tid % 16;        // columns tx * 8 .. + 8
  const int ty = tid / 16;        // rows ty * 8 .. + 8

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // the next k slice is loaded into registers while this one is used
  float pa[kA], pb[kB];
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < kA; ++q) {
      const int i = tid + q * kThreads;
      const int row = m0 + i / BK, col = k0 + i % BK;
      pa[q] = (row < Tn && col < H)
                  ? to_f32(x[static_cast<size_t>(row) * H + col])
                  : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kB; ++q) {
      const int i = tid + q * kThreads;
      const int n = i % BN, hk = k0 + i / BN;
      const int l = l0 + n / kCols, d = n % kCols;
      pb[q] = (l < L && d < Dr && hk < H)
                  ? rot[(static_cast<size_t>(l) * H + hk) * Dr + d]
                  : 0.f;
    }
  };
  load(0);
  for (int k0 = 0; k0 < H; k0 += BK) {
#pragma unroll
    for (int q = 0; q < kA; ++q) {
      const int i = tid + q * kThreads;
      As[i % BK][i / BK] = pa[q];
    }
#pragma unroll
    for (int q = 0; q < kB; ++q) {
      const int i = tid + q * kThreads;
      Bs[i / BN][i % BN] = pb[q];
    }
    __syncthreads();
    if (k0 + BK < H) load(k0 + BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][ty * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * TN]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][tx * TN + 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // argmax epilogue: lanes tx % 8 == 0..7 hold one hash's 64 columns
  const int l = l0 + tx / 8;
  const int d0 = (tx % 8) * TN;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float best = -1.f;      // |v| >= 0, so the first real column wins
    int best_i = INT_MAX;
    float best_v = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if (d0 + j < Dr && fabsf(acc[i][j]) > best) {
        best = fabsf(acc[i][j]);
        best_i = d0 + j;
        best_v = acc[i][j];
      }
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
      const float ov = __shfl_xor_sync(0xffffffffu, best_v, off);
      if (ob > best || (ob == best && oi < best_i)) {
        best = ob;
        best_i = oi;
        best_v = ov;
      }
    }
    const int row = m0 + ty * TM + i;
    if (tx % 8 == 0 && l < L && row < Tn)
      out[static_cast<size_t>(row) * L + l] =
          2 * best_i + (best_v < 0.f ? 1 : 0);
  }
}


// ---------------------------------------------------- bf16 tensor cores --

constexpr int kTcThreads = 128;  // 4 warps x 16 rows
constexpr int TBM = 64;          // tokens per block
constexpr int TBK = 32;          // k slice
constexpr int kPad = 8;          // bf16 of padding a shared row: no conflicts

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kTcThreads)
lsh_hash_tc_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ rot, int Tn, int H,
                   int L, int Dr, int* __restrict__ out) {
  __shared__ __align__(16) __nv_bfloat16 As[TBM][TBK + kPad];   // [m][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[kCols][TBK + kPad]; // [n][k]
  const int l = blockIdx.x;
  const int m0 = blockIdx.y * TBM;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;       // fragment row / column group
  const int t = lane & 3;        // thread in group
  const int wr = (tid >> 5) * 16;
  const __nv_bfloat16* R = rot + static_cast<size_t>(l) * H * Dr;

  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;

  // staging: x as 2 x 16 bytes a thread ([64 rows][4 chunks of 8]), R as
  // 2 x 16 bytes a thread ([32 k][8 chunks of 8 columns])
  uint4 pa[2], pb[2];
  const uint4 zero = make_uint4(0, 0, 0, 0);
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = tid + q * kTcThreads;
      const int row = m0 + i / 4, col = k0 + (i % 4) * 8;
      pa[q] = (row < Tn && col < H)
                  ? *reinterpret_cast<const uint4*>(
                        x + static_cast<size_t>(row) * H + col)
                  : zero;
      const int k = k0 + i / 8, n = (i % 8) * 8;
      pb[q] = (k < H && n < Dr)
                  ? *reinterpret_cast<const uint4*>(
                        R + static_cast<size_t>(k) * Dr + n)
                  : zero;
    }
  };
  load(0);
  for (int k0 = 0; k0 < H; k0 += TBK) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = tid + q * kTcThreads;
      *reinterpret_cast<uint4*>(&As[i / 4][(i % 4) * 8]) = pa[q];
      const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&pb[q]);
#pragma unroll
      for (int j = 0; j < 8; ++j) Bs[(i % 8) * 8 + j][i / 8] = v[j];
    }
    __syncthreads();
    if (k0 + TBK < H) load(k0 + TBK);
#pragma unroll
    for (int kk = 0; kk < TBK; kk += 16) {
      const uint32_t a0 = ld32(&As[wr + g][kk + t * 2]);
      const uint32_t a1 = ld32(&As[wr + g + 8][kk + t * 2]);
      const uint32_t a2 = ld32(&As[wr + g][kk + 8 + t * 2]);
      const uint32_t a3 = ld32(&As[wr + g + 8][kk + 8 + t * 2]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const uint32_t b0 = ld32(&Bs[nt * 8 + g][kk + t * 2]);
        const uint32_t b1 = ld32(&Bs[nt * 8 + g][kk + 8 + t * 2]);
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(acc[nt][0]), "+f"(acc[nt][1]), "+f"(acc[nt][2]),
              "+f"(acc[nt][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
    __syncthreads();
  }

  // argmax epilogue: rows g and g + 8 of the warp's 16; lane t holds
  // columns nt * 8 + t * 2 + {0, 1} (c0, c1 for row g, c2, c3 for g + 8)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float best = -1.f;      // |v| >= 0, so the first real column wins
    int best_i = INT_MAX;
    float best_v = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = nt * 8 + t * 2 + j;
        const float v = acc[nt][h * 2 + j];
        if (d < Dr && fabsf(v) > best) {
          best = fabsf(v);
          best_i = d;
          best_v = v;
        }
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
      const float ov = __shfl_xor_sync(0xffffffffu, best_v, off);
      if (ob > best || (ob == best && oi < best_i)) {
        best = ob;
        best_i = oi;
        best_v = ov;
      }
    }
    const int row = m0 + wr + g + h * 8;
    if (t == 0 && row < Tn)
      out[static_cast<size_t>(row) * L + l] =
          2 * best_i + (best_v < 0.f ? 1 : 0);
  }
}

}  // namespace

extern "C" {

// x: [T, H] bf16 (x_is_bf16 = 1) or f32; rot: [L, H, Dr] bf16 (rot_is_bf16
// = 1, with bf16 x, H % 8 == 0, Dr % 8 == 0 and 16-byte-aligned x and
// rot: the tensor-core kernel) or f32 (the FMA kernel), 1 <= Dr <= 64 (the
// wrapper checks); out: [T, L] int32.
int lsh_hash_launch(const void* x, int x_is_bf16, const void* rot,
                    int rot_is_bf16, int T, int H, int L, int Dr, void* out,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  if (rot_is_bf16) {
    const dim3 grid(L, (T + TBM - 1) / TBM);
    lsh_hash_tc_kernel<<<grid, kTcThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(rot), T, H, L, Dr, o);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((T + BM - 1) / BM, (L + kHashes - 1) / kHashes);
  const float* r = static_cast<const float*>(rot);
  if (x_is_bf16)
    lsh_hash_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), r, T, H, L, Dr, o);
  else
    lsh_hash_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), r, T, H, L, Dr, o);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
