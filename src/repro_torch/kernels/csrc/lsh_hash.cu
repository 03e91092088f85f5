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
//   cores, as one GEMM of x with all L hashes' rotations at once (TMA
//   into 128-byte-swizzled shared memory, a producer warp and two consumer
//   warpgroups issuing wgmma; see the section below).  Products of bf16
//   values are exact and wgmma sums them in f32, so this computes the
//   function of the f32 plain version up to the order and rounding of the
//   sums.
// - otherwise (f32 inputs, as in an f32 model): f32 FMA, grid (T / 128,
//   L / 2), a [128 tokens, 2 hashes x 64 columns] tile a block with 8-deep
//   k slices in shared memory (the next one prefetched into registers)
//   and an 8 x 8 register tile a thread; each output one FMA chain over h
//   in order.
// Both keep the rotated values out of device memory: the argmax is the
// epilogue, in registers.  The lanes that hold one row's columns scan
// theirs in order and shuffle-reduce with (|v| larger, or equal and index
// smaller).  Both give the same bits on a second call (no atomics; each
// output is one thread's fixed sequence of operations).
#include <cuda.h>   // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
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
//
// One GEMM of x [T, H] with the packed rotations [L * Dr, H] (both K-major
// bf16, the wrapper packs R), the argmax in the epilogue.  A block owns 128
// rows of x and kTcBN = 192 columns of packed R: the whole hashes that fit
// (three of 64 at the training shape, so N = 384 is two blocks, adjacent in
// launch order: an x tile comes from device memory once and from L2 once).
// Warp 8 is the producer: its lane 0 keeps TMA loads of 64-deep k slices
// of both tiles in flight through a ring of kTcStages stages in 128-byte-
// swizzled shared memory, each guarded by a "full" mbarrier (TMA bytes
// arrived) and an "empty" one (all eight consumer warps done with it).
// Warps 0-7 are two consumer warpgroups, 64 rows each: per k slice four
// wgmma.mma_async m64n192k16 (bf16 products, f32 sums in registers), one
// group kept in flight while the stage before is released.  TMA fills rows
// past T, columns past L * Dr and k past H with zeros.

constexpr int kTcBM = 128;                    // rows of x a block
constexpr int kTcBN = 192;                    // columns of packed R a block
constexpr int kTcBK = 64;                     // 64 bf16: one 128-byte row
constexpr int kTcStages = 4;
constexpr int kConsumerWarps = 8;             // two warpgroups
constexpr int kTcThreads = 32 * kConsumerWarps + 32;   // + the producer
constexpr int kATile = kTcBM * kTcBK * 2;     // bytes of one stage's x tile
constexpr int kBTile = kTcBN * kTcBK * 2;     // and of its R tile
constexpr int kAcc = kTcBN / 2;               // f32 sums a consumer thread
constexpr int kTcSmem = kTcStages * (kATile + kBTile)
                        + 2 * kTcStages * 8 + 1024;   // + barriers, align

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// TMA: the [box rows, 64] tile of a 2-D tensor map at (k, row) into dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k),
         "r"(row)
      : "memory");
}

// wgmma operand descriptor of a K-major tile of 128-byte rows with the
// 128-byte swizzle: 8-row groups 1024 bytes apart (SBO), LBO unused (1)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

#define LSH_ACC8(i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d += A (64 x 16, K-major, shared) * B (192 x 16, K-major, shared)^T
__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[kAcc], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : LSH_ACC8(0), LSH_ACC8(8), LSH_ACC8(16), LSH_ACC8(24), LSH_ACC8(32),
        LSH_ACC8(40), LSH_ACC8(48), LSH_ACC8(56), LSH_ACC8(64), LSH_ACC8(72),
        LSH_ACC8(80), LSH_ACC8(88)
      : "l"(a), "l"(b), "r"(1));
}

// the accumulators stay where the asynchronous wgmma writes them: no read
// or write of them moves across this point
__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__global__ void __launch_bounds__(kTcThreads, 1)
lsh_hash_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_x,
                      const __grid_constant__ CUtensorMap tmap_r, int Tn,
                      int H, int L, int Dr, int hashes_per_block,
                      int* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on it
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t a_tiles = base;
  const uint32_t b_tiles = base + kTcStages * kATile;
  const uint32_t full = b_tiles + kTcStages * kBTile;     // kTcStages x 8 B
  const uint32_t empty = full + kTcStages * 8;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * kTcBM;
  const int l0 = blockIdx.x * hashes_per_block;
  const int k_tiles = (H + kTcBK - 1) / kTcBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer: stage s is free again once all consumer warps released it
    if (lane == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % kTcStages;
        mbar_wait(empty + 8 * s, ((kt / kTcStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, kATile + kBTile);
        tma_load(a_tiles + s * kATile, &tmap_x, full + 8 * s, kt * kTcBK, m0);
        tma_load(b_tiles + s * kBTile, &tmap_r, full + 8 * s, kt * kTcBK,
                 l0 * Dr);
      }
    }
    return;
  }

  // consumers: warpgroup wg computes rows m0 + 64 wg .. + 64
  const int wg = warp / 4;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  const uint32_t a_wg = a_tiles + wg * 64 * 128;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % kTcStages;
    mbar_wait(full + 8 * s, (kt / kTcStages) & 1);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk)      // 16 bf16 = 32 bytes a step
      wgmma_m64n192k16(acc, wgmma_desc(a_wg + s * kATile + kk * 32),
                       wgmma_desc(b_tiles + s * kBTile + kk * 32));
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    // the slice before this one is done: release its stage
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    if (kt > 0 && lane == 0)
      mbar_arrive(empty + 8 * ((kt - 1) % kTcStages));
    __syncwarp();
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc(acc);

  // argmax epilogue.  wgmma's f32 accumulator: warp w of the warpgroup
  // holds rows 16 w + g and 16 w + g + 8 (g = lane / 4); lane t = lane % 4
  // holds columns 8 j + 2 t + {0, 1} of every n8 group j, in acc[4 j + 0,
  // 1] (row g) and acc[4 j + 2, 3] (row g + 8).  Dr % 8 == 0, so an n8
  // group belongs to one hash.
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = m0 + wg * 64 + (warp & 3) * 16 + g;
  const int nh = min(hashes_per_block, L - l0);
  for (int hl = 0; hl < nh; ++hl) {
    const int c0 = hl * Dr;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float best = -1.f;      // |v| >= 0, so the first real column wins
      int best_i = INT_MAX;
      float best_v = 0.f;
#pragma unroll
      for (int j = 0; j < kTcBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = j * 8 + t * 2 + e - c0;
          const float v = acc[4 * j + 2 * h + e];
          if (d >= 0 && d < Dr && fabsf(v) > best) {
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
      const int row = row0 + h * 8;
      if (t == 0 && row < Tn)
        out[static_cast<size_t>(row) * L + l0 + hl] =
            2 * best_i + (best_v < 0.f ? 1 : 0);
    }
  }
}

// ------------------------------------------------------- host: TMA maps --

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library needs no -lcuda
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a row-major [rows, cols] bf16 matrix read as [box_rows, 64]
// tiles with the 128-byte swizzle; out-of-bounds elements read as zero.
CUresult tile_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                  int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kTcBK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(ptr), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

int launch_wgmma(const void* x, const void* rot_packed, int T, int H, int L,
                 int Dr, int* out, cudaStream_t s) {
  CUtensorMap mx, mr;
  CUresult res = tile_map(&mx, x, T, H, kTcBM);
  if (res == CUDA_SUCCESS) res = tile_map(&mr, rot_packed, L * Dr, H, kTcBN);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  const int hashes = std::min(L, kTcBN / Dr);
  const dim3 grid((L + hashes - 1) / hashes, (T + kTcBM - 1) / kTcBM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(
      lsh_hash_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTcSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  lsh_hash_wgmma_kernel<<<grid, kTcThreads, kTcSmem, s>>>(mx, mr, T, H, L,
                                                          Dr, hashes, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: [T, H] bf16 (x_is_bf16 = 1) or f32; out: [T, L] int32; 1 <= Dr <= 64
// (the wrapper checks).  rot_is_bf16 = 1 (bf16 x, H % 8 == 0, Dr % 8 ==
// 0, 16-byte-aligned x): rot is the packed bf16 [L * Dr, H] (row l * Dr +
// d is R[l, :, d]) and the tensor-core kernel runs; rot_is_bf16 = 0: rot
// is f32 [L, H, Dr] and the FMA kernel runs.  Returns the launch's
// cudaError_t, or a CUresult negated when a tensor map cannot be made.
int lsh_hash_launch(const void* x, int x_is_bf16, const void* rot,
                    int rot_is_bf16, int T, int H, int L, int Dr, void* out,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  if (rot_is_bf16) return launch_wgmma(x, rot, T, H, L, Dr, o, s);
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
