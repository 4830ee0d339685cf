// Direct VMEM-tier GEMM: out = alpha * A @ B + beta * C, written standalone.
//
// Port of benchmarks/direct_impls.py:119, the Pallas `kernel` inside
// direct_vmem_ooc_gemm: the "direct" side of the paper's claims C1 and C4,
// a hand-written kernel that shares no code with the library's block GEMM
// (csrc/block_matmul.cu), as the reference writes its own grid, BlockSpecs
// and padding instead of reusing kernels/.  Its wrapper, argument checks
// and ctypes binding live in src/repro_torch/direct_impls.py.
//
// The reference's grid is (M/bm, N/bn, K/bk) with K innermost and an f32
// VMEM accumulator carried across the sequential K axis; operands are
// zero-padded to block multiples on the host.  Here one CTA owns one
// (TILE_M, TILE_N) output tile and walks K itself; the accumulators live in
// registers, and edge tiles are masked instead of padded, so no operand is
// copied.
//
// What bounds it on an H100: a large f32 product does far more operations
// per byte than the card's ratio, so operations bound it.  f32 must be IEEE
// f32 (the reference holds it to 2e-4, which TF32 does not meet), so the
// ceiling is the CUDA cores' f32 FMA rate.  The design answers with
// register blocking (up to 8 x 8 outputs per thread, 16 FMAs per 128-bit
// shared-memory read pair) and a two-slot shared-memory ring: the global
// loads of the next k step are issued into registers before the current
// step's FMAs and stored into the other slot after them, so one barrier per
// step suffices.  Not done: cp.async/TMA stages, wgmma for bf16/f16.
//
// Numerics.  Every output element is summed over k = 0 .. K-1 in that one
// order with __fmaf_rn.  The k step (16) is the same for every tile
// instance, so masked k values past K (which add fma(0, 0, acc) == acc)
// fall at the same places whatever tile the caller's block= selects: the
// result does not depend on block=, bit for bit.  The epilogue is
// round(alpha * acc) + round(beta * c) with explicit intrinsics, the same
// arithmetic as the plain PyTorch version, then one rounding to the
// output's dtype.
//
// Offsets are 64-bit (device operands may exceed 2^31 elements).  Inputs
// take row strides (unit column stride); the output is a new contiguous
// (M, N) array.  Launch: on the caller's stream, no allocation, returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads per CTA
constexpr int kSide = 16;
constexpr int kStep = 16;      // k values per shared-memory slot, all tiles

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

__device__ __forceinline__ void narrow(float v, float* p) { *p = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void narrow(float v, __half* p) {
  *p = __float2half_rn(v);
}

// Thread (ty, tx) owns rows q * 4 * kSide + ty * 4 + i of the tile (q <
// TILE_M / 64, i < 4), and likewise columns: a quarter-warp's 128-bit
// shared-memory reads of B then cover 128 contiguous bytes, and the A reads
// of a warp are broadcasts.
template <typename T, int TILE_M, int TILE_N>
__global__ void __launch_bounds__(kThreads)
    direct_gemm(const T* __restrict__ A, const T* __restrict__ B,
                const T* __restrict__ C, T* __restrict__ Out, int64_t M,
                int64_t N, int64_t K, int64_t lda, int64_t ldb, int64_t ldc,
                float alpha, float beta) {
  constexpr int RM = TILE_M / kSide;            // rows per thread
  constexpr int RN = TILE_N / kSide;            // columns per thread
  constexpr int LA = TILE_M * kStep / kThreads;  // A loads per thread, step
  constexpr int LB = kStep * TILE_N / kThreads;  // B loads per thread, step
  static_assert(RM % 4 == 0 && RN % 4 == 0, "tiles are multiples of 64");

  // A is kept k-major (transposed) so a thread's rows are contiguous; the
  // +4 keeps each k row 16-byte aligned.
  __shared__ __align__(16) float sa[2][kStep][TILE_M + 4];
  __shared__ __align__(16) float sb[2][kStep][TILE_N];

  const int tid = threadIdx.x;
  const int tx = tid % kSide;
  const int ty = tid / kSide;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * TILE_M;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * TILE_N;

  float ra[LA], rb[LB];
  // global -> registers: A with consecutive threads on consecutive k of a
  // row, B with consecutive threads on consecutive columns; out-of-range
  // values are exact zeros
  auto fetch = [&](int64_t k0) {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int e = tid + l * kThreads;
      const int64_t r = m0 + e / kStep;
      const int64_t k = k0 + e % kStep;
      ra[l] = (r < M && k < K) ? widen(A[r * lda + k]) : 0.0f;
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int e = tid + l * kThreads;
      const int64_t k = k0 + e / TILE_N;
      const int64_t c = n0 + e % TILE_N;
      rb[l] = (k < K && c < N) ? widen(B[k * ldb + c]) : 0.0f;
    }
  };
  auto stash = [&](int slot) {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int e = tid + l * kThreads;
      sa[slot][e % kStep][e / kStep] = ra[l];
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int e = tid + l * kThreads;
      sb[slot][e / TILE_N][e % TILE_N] = rb[l];
    }
  };

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.0f;

  fetch(0);
  stash(0);
  __syncthreads();
  int slot = 0;
  for (int64_t k0 = 0; k0 < K; k0 += kStep) {
    const bool more = k0 + kStep < K;
    if (more) fetch(k0 + kStep);  // in flight during this step's FMAs
#pragma unroll
    for (int kk = 0; kk < kStep; ++kk) {
      float a[RM], b[RN];
#pragma unroll
      for (int q = 0; q < RM / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            &sa[slot][kk][q * 4 * kSide + ty * 4]);
        a[q * 4 + 0] = v.x;
        a[q * 4 + 1] = v.y;
        a[q * 4 + 2] = v.z;
        a[q * 4 + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < RN / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            &sb[slot][kk][q * 4 * kSide + tx * 4]);
        b[q * 4 + 0] = v.x;
        b[q * 4 + 1] = v.y;
        b[q * 4 + 2] = v.z;
        b[q * 4 + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j)
          acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    // the other slot was last read in the previous step, before the
    // barrier that ended it
    if (more) stash(slot ^ 1);
    __syncthreads();
    slot ^= 1;
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t r = m0 + (i / 4) * 4 * kSide + ty * 4 + i % 4;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int64_t c = n0 + (j / 4) * 4 * kSide + tx * 4 + j % 4;
      if (c >= N) continue;
      const float v = __fadd_rn(__fmul_rn(alpha, acc[i][j]),
                                __fmul_rn(beta, widen(C[r * ldc + c])));
      narrow(v, &Out[r * N + c]);
    }
  }
}

template <typename T, int TILE_M, int TILE_N>
cudaError_t launch(const void* A, const void* B, const void* C, void* Out,
                   int64_t M, int64_t N, int64_t K, int64_t lda, int64_t ldb,
                   int64_t ldc, float alpha, float beta,
                   cudaStream_t stream) {
  const int64_t gx = (N + TILE_N - 1) / TILE_N;
  const int64_t gy = (M + TILE_M - 1) / TILE_M;
  if (gx > 0x7fffffff || gy > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  direct_gemm<T, TILE_M, TILE_N><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(Out), M, N, K, lda, ldb, ldc,
      alpha, beta);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_tile(int tile_m, int tile_n, const void* A, const void* B,
                    const void* C, void* Out, int64_t M, int64_t N, int64_t K,
                    int64_t lda, int64_t ldb, int64_t ldc, float alpha,
                    float beta, cudaStream_t s) {
  if (tile_m == 128 && tile_n == 128)
    return launch<T, 128, 128>(A, B, C, Out, M, N, K, lda, ldb, ldc, alpha,
                               beta, s);
  if (tile_m == 128 && tile_n == 64)
    return launch<T, 128, 64>(A, B, C, Out, M, N, K, lda, ldb, ldc, alpha,
                              beta, s);
  if (tile_m == 64 && tile_n == 128)
    return launch<T, 64, 128>(A, B, C, Out, M, N, K, lda, ldb, ldc, alpha,
                              beta, s);
  if (tile_m == 64 && tile_n == 64)
    return launch<T, 64, 64>(A, B, C, Out, M, N, K, lda, ldb, ldc, alpha,
                             beta, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (A, B, C and Out alike).
// tile_m, tile_n: the CTA tile, 64 or 128 each.  Strides are row strides in
// elements; Out is contiguous (M, N).
extern "C" int repro_direct_vmem_gemm(int dtype, int tile_m, int tile_n,
                                      const void* A, const void* B,
                                      const void* C, void* Out, long long M,
                                      long long N, long long K, long long lda,
                                      long long ldb, long long ldc,
                                      float alpha, float beta, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return by_tile<float>(tile_m, tile_n, A, B, C, Out, M, N, K, lda, ldb,
                            ldc, alpha, beta, s);
    case 1:
      return by_tile<__nv_bfloat16>(tile_m, tile_n, A, B, C, Out, M, N, K,
                                    lda, ldb, ldc, alpha, beta, s);
    case 2:
      return by_tile<__half>(tile_m, tile_n, A, B, C, Out, M, N, K, lda, ldb,
                             ldc, alpha, beta, s);
    default:
      return cudaErrorInvalidValue;
  }
}
