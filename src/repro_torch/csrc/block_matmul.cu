// Hopper block GEMM: out = alpha * A @ B + beta * C.
//
// Port of src/repro/kernels/block_matmul.py:_kernel (the Pallas kernel that
// streams (bm, bk) / (bk, bn) blocks HBM->VMEM and carries an fp32
// accumulator across a sequential K grid axis).  On Hopper one CTA owns one
// (BM, BN) output tile and walks K itself, in a loop, with the tiles of A
// and B it needs staged in shared memory (the VMEM tier of the reference);
// the parallel (M, N) grid axes become the CUDA grid.
//
// What bounds it on an H100: at the main path's block shape (6144 x 6144 x
// 24576 f32) the kernel does ~1230 flops per byte it must move, so it is
// bound by operations, not bytes.  f32 must be IEEE f32 (the reference
// tests hold it to 2e-4, which TF32's 10-bit mantissa does not meet), so
// the ceiling is the CUDA cores' f32 FMA rate, not the tensor cores.  The
// design keeps the FMA pipes fed:
//
//   * a ring of kStages shared-memory stages of (BK x BM) A and (BK x BN) B
//     tiles, filled with cp.async while the FMAs consume an earlier stage:
//     B in 16-byte copies where its rows are 16-byte aligned, A in 4-byte
//     copies that store it k-major (transposed) as they land; zero-fill
//     past every edge; one cp.async.wait_group and one barrier per k tile;
//   * a warp-tiled register microtile: 8 warps of 32 x 128 outputs, 8 x 16
//     outputs a thread, so every shared-memory value feeds 8 or 16 FMAs;
//     per k a thread reads its 8 rows of A in two 128-bit loads and its 16
//     columns of B in four, and a warp's reads of either cover contiguous
//     bytes (no bank conflicts);
//   * one 256-thread CTA per SM (__launch_bounds__), whose registers hold
//     the 128 accumulators and the next k's fragments, and a grouped tile
//     order (kGroupM tile rows at a time) so that CTAs resident together
//     share rows of A and columns of B in L2.
//
// bf16 and f16 go through the same pipeline on the CUDA cores, A copied as
// 4-byte pairs of k (k-major pairs), widened to f32 when read from shared
// memory; wgmma for them is later work.
//
// Numerics.  Every output element is summed over k = 0 .. K-1 in that one
// order with __fmaf_rn, starting from 0, whatever M, N, the block's position
// or the caller's block= choice; there is no split-K and no atomic.  Masked
// (out-of-range) k steps read zero-filled A and B and add fma(0, 0, acc) ==
// acc exactly.  The epilogue is round(alpha * acc) + round(beta * c) with
// explicit intrinsics, the same arithmetic as the plain PyTorch version, so
// every dtype's instance rounds alike.  Hence a sub-block computed alone
// equals the same slice of the full product bit for bit, which the
// out-of-core executor relies on.
//
// Out may alias C (the executor updates its C parity buffer in place): each
// element of C is read once, by the thread that then writes that element.
//
// Launch: on the caller's stream, no allocation, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 256, kBK = 16;
constexpr int kStages = 4;
constexpr int kThreads = 256;             // 8 warps: 4 down, 2 across
constexpr int kWarpM = 32, kWarpN = 128;  // one warp's outputs
constexpr int kTM = 8, kTN = 16;          // one thread's outputs
constexpr int kGroupM = 8;                // tile rows per launch-order group

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared; only the first `bytes` are read, the
// rest of the destination is zero-filled (bytes == 0: nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of shared memory at p as 16 / sizeof(T) floats.
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / static_cast<int>(sizeof(T)); ++i)
    out[i] = to_f32(e[i]);
}

// 4 elements at p (shared memory, aligned to their size) as floats.
template <typename T>
__device__ __forceinline__ void load4(const T* p, float* out) {
  if constexpr (sizeof(T) == 4) {
    load16(p, out);
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = to_f32(e[i]);
  }
}

// Shared-memory layout of one stage.  A is k-major in packets of KP = 4 /
// sizeof(T) consecutive k (one 4-byte copy each): packet (kp, m) holds
// A[m][kp * KP .. kp * KP + KP - 1], so 16 bytes at (kp, m .. m + 3) give
// four rows' KP values of k.  The A pitch is BM packets plus 16 bytes,
// which keeps rows 16-byte aligned and spreads a warp's transposing copies
// over the banks.  B is row-major, BN elements a row.
template <typename T>
struct Tiles {
  static constexpr int kKP = 4 / sizeof(T);            // k per A packet
  static constexpr int kVec = 16 / sizeof(T);          // B elements a chunk
  static constexpr int kApitch = kBM + 4;              // packets
  static constexpr int kAStage = (kBK / kKP) * kApitch * kKP;  // elements
  static constexpr int kBStage = kBK * kBN;
  static constexpr int kStage = kAStage + kBStage;
  static constexpr size_t kSmemBytes = size_t(kStages) * kStage * sizeof(T);
};

// Copies the (BM x BK) tile of A at (row0, k0) into as, k-major, and the
// (BK x BN) tile of B at (k0, col0) into bs; elements past M, N or K are
// zero.  AV: A's packets are 4-byte aligned (always in f32; in 16-bit types
// when lda is even and A 4-byte aligned), else plain copies.  BV: B's rows
// are 16-byte aligned, else 4-byte copies (f32) or plain copies.
template <typename T, bool AV, bool BV>
__device__ __forceinline__ void load_stage(
    T* as, T* bs, const T* __restrict__ A, const T* __restrict__ B,
    int64_t M, int64_t N, int64_t K, int64_t lda, int64_t ldb, int64_t row0,
    int64_t col0, int64_t k0, int tid) {
  using L = Tiles<T>;
  constexpr int KP = L::kKP;
  constexpr int APK = kBK / KP;                 // packets per row of a tile
  static_assert(kBM * APK % kThreads == 0, "A packets");
#pragma unroll
  for (int l = 0; l < kBM * APK / kThreads; ++l) {
    const int e = tid + l * kThreads;           // lanes along k: coalesced
    const int r = e / APK;
    const int kp = e % APK;
    const int64_t gr = row0 + r;
    const int64_t gk = k0 + kp * KP;
    T* dst = as + (kp * L::kApitch + r) * KP;
    if constexpr (KP == 1) {
      const bool ok = gr < M && gk < K;
      cp_async4(dst, ok ? A + gr * lda + gk : A, ok ? 4 : 0);
    } else {
      int64_t n = gr < M ? K - gk : 0;
      n = n < 0 ? 0 : (n > KP ? KP : n);
      if constexpr (AV) {
        cp_async4(dst, n > 0 ? A + gr * lda + gk : A,
                  static_cast<int>(n) * static_cast<int>(sizeof(T)));
      } else {
#pragma unroll
        for (int i = 0; i < KP; ++i)
          dst[i] = i < n ? A[gr * lda + gk + i] : from_f32<T>(0.0f);
      }
    }
  }
  if constexpr (BV) {
    constexpr int V = L::kVec;
    constexpr int BCH = kBK * kBN / V;
    static_assert(BCH % kThreads == 0, "B chunks");
#pragma unroll
    for (int l = 0; l < BCH / kThreads; ++l) {
      const int c = tid + l * kThreads;
      const int kk = c / (kBN / V);
      const int cc = (c % (kBN / V)) * V;
      const int64_t gk = k0 + kk;
      const int64_t gc = col0 + cc;
      int64_t n = gk < K ? N - gc : 0;
      n = n < 0 ? 0 : (n > V ? V : n);
      cp_async16(bs + kk * kBN + cc, n > 0 ? B + gk * ldb + gc : B,
                 static_cast<int>(n) * static_cast<int>(sizeof(T)));
    }
  } else {
    static_assert(kBK * kBN % kThreads == 0, "B elements");
#pragma unroll
    for (int l = 0; l < kBK * kBN / kThreads; ++l) {
      const int e = tid + l * kThreads;
      const int kk = e / kBN;
      const int cc = e % kBN;
      const int64_t gk = k0 + kk;
      const int64_t gc = col0 + cc;
      const bool ok = gk < K && gc < N;
      T* dst = bs + kk * kBN + cc;
      if constexpr (sizeof(T) == 4) {
        cp_async4(dst, ok ? B + gk * ldb + gc : B, ok ? 4 : 0);
      } else {
        *dst = ok ? B[gk * ldb + gc] : from_f32<T>(0.0f);
      }
    }
  }
}

// Thread (warp (wm, wn), lane (lm, ln)) owns rows wm*32 + g*16 + lm*4 + i
// (g < 2, i < 4) and columns wn*128 + h*32 + ln*4 + j (h < 4, j < 4) of
// the tile: a warp's A reads cover 64 contiguous bytes of a k row, its B
// reads 128 (f32).
__device__ __forceinline__ int out_row(int wm, int lm, int i) {
  return wm * kWarpM + (i / 4) * 16 + lm * 4 + (i % 4);
}
__device__ __forceinline__ int out_col(int wn, int ln, int j) {
  return wn * kWarpN + (j / 4) * 32 + ln * 4 + (j % 4);
}

template <typename T, bool AV, bool BV>
__global__ void __launch_bounds__(kThreads, 1)
    block_matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
                        const T* C, T* Out, int64_t M, int64_t N, int64_t K,
                        int64_t lda, int64_t ldb, int64_t ldc, int64_t ldo,
                        float alpha, float beta) {
  using L = Tiles<T>;
  constexpr int KP = L::kKP;
  static_assert((kBM / kWarpM) * (kBN / kWarpN) * 32 == kThreads, "warps");
  static_assert((kWarpM / kTM) * (kWarpN / kTN) == 32, "lanes");
  static_assert(kTM % 4 == 0 && kTN % 4 == 0 && kBK % KP == 0, "tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  // grouped launch order: kGroupM tile rows, column by column
  const int64_t tiles_m = (M + kBM - 1) / kBM;
  const int64_t tiles_n = (N + kBN - 1) / kBN;
  const int64_t pid = blockIdx.x;
  const int64_t in_group = kGroupM * tiles_n;
  const int64_t first_m = (pid / in_group) * kGroupM;
  const int64_t group_m =
      tiles_m - first_m < kGroupM ? tiles_m - first_m : kGroupM;
  const int64_t tm = first_m + (pid % in_group) % group_m;
  const int64_t tn = (pid % in_group) / group_m;
  const int64_t row0 = tm * kBM;
  const int64_t col0 = tn * kBN;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / (kBN / kWarpN);
  const int wn = warp % (kBN / kWarpN);
  const int lm = lane / (kWarpN / kTN);
  const int ln = lane % (kWarpN / kTN);

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  const int64_t kt_count = (K + kBK - 1) / kBK;
  auto stage = [&](int64_t s) { return smem + s * L::kStage; };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_count)
      load_stage<T, AV, BV>(stage(s), stage(s) + L::kAStage, A, B, M, N, K,
                            lda, ldb, row0, col0,
                            static_cast<int64_t>(s) * kBK, tid);
    cp_async_commit();
  }

  for (int64_t kt = 0; kt < kt_count; ++kt) {
    cp_async_wait<kStages - 2>();   // this thread's copies of tile kt
    __syncthreads();                // everyone's; and tile kt-1 is consumed
    {
      const int64_t nk = kt + kStages - 1;
      if (nk < kt_count) {
        T* as = stage(nk % kStages);
        load_stage<T, AV, BV>(as, as + L::kAStage, A, B, M, N, K, lda, ldb,
                              row0, col0, nk * kBK, tid);
      }
      cp_async_commit();
    }
    const T* as = stage(kt % kStages);
    const T* bs = as + L::kAStage;
#pragma unroll
    for (int kp = 0; kp < kBK / KP; ++kp) {
      // a[i][q]: row i of this thread, k = kp * KP + q
      float a[kTM][KP];
#pragma unroll
      for (int i = 0; i < kTM; i += 4) {
        float raw[4 * KP];
        load16(as + (kp * L::kApitch + out_row(wm, lm, i)) * KP, raw);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < KP; ++q) a[i + r][q] = raw[r * KP + q];
      }
#pragma unroll
      for (int q = 0; q < KP; ++q) {
        const int kk = kp * KP + q;
        float b[kTN];
#pragma unroll
        for (int j = 0; j < kTN; j += 4)
          load4(bs + kk * kBN + out_col(wn, ln, j), b + j);
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            acc[i][j] = __fmaf_rn(a[i][q], b[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t r = row0 + out_row(wm, lm, i);
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int64_t c = col0 + out_col(wn, ln, j);
      if (c >= N) continue;
      const float cv = to_f32(C[r * ldc + c]);
      const float v =
          __fadd_rn(__fmul_rn(alpha, acc[i][j]), __fmul_rn(beta, cv));
      Out[r * ldo + c] = from_f32<T>(v);
    }
  }
}

template <typename T, bool AV, bool BV>
cudaError_t launch_mode(const void* A, const void* B, const void* C,
                        void* Out, int64_t M, int64_t N, int64_t K,
                        int64_t lda, int64_t ldb, int64_t ldc, int64_t ldo,
                        float alpha, float beta, cudaStream_t stream) {
  auto kern = block_matmul_kernel<T, AV, BV>;
  constexpr size_t smem = Tiles<T>::kSmemBytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int64_t tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(tiles), kThreads, smem, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(Out), M, N, K, lda, ldb, ldc,
      ldo, alpha, beta);
  return cudaGetLastError();
}

template <typename T, bool AV>
cudaError_t launch_b(bool bv, const void* A, const void* B, const void* C,
                     void* Out, int64_t M, int64_t N, int64_t K, int64_t lda,
                     int64_t ldb, int64_t ldc, int64_t ldo, float alpha,
                     float beta, cudaStream_t stream) {
  if (bv)
    return launch_mode<T, AV, true>(A, B, C, Out, M, N, K, lda, ldb, ldc,
                                    ldo, alpha, beta, stream);
  return launch_mode<T, AV, false>(A, B, C, Out, M, N, K, lda, ldb, ldc, ldo,
                                   alpha, beta, stream);
}

template <typename T>
cudaError_t launch(const void* A, const void* B, const void* C, void* Out,
                   int64_t M, int64_t N, int64_t K, int64_t lda, int64_t ldb,
                   int64_t ldc, int64_t ldo, float alpha, float beta,
                   cudaStream_t stream) {
  constexpr int KP = Tiles<T>::kKP;
  constexpr int V = Tiles<T>::kVec;
  const bool av = reinterpret_cast<uintptr_t>(A) % 4 == 0 && lda % KP == 0;
  const bool bv = reinterpret_cast<uintptr_t>(B) % 16 == 0 && ldb % V == 0;
  if (av)
    return launch_b<T, true>(bv, A, B, C, Out, M, N, K, lda, ldb, ldc, ldo,
                             alpha, beta, stream);
  if constexpr (KP > 1)
    return launch_b<T, false>(bv, A, B, C, Out, M, N, K, lda, ldb, ldc, ldo,
                              alpha, beta, stream);
  else
    return cudaErrorInvalidValue;   // unreachable: f32 is 4-byte aligned
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (A, B, C and Out alike).
// Strides are row strides in elements.  One CTA tile: 128 x 256, k tiles
// of 16 in a 4-stage cp.async ring, 8 x 16 outputs per thread.
extern "C" int repro_block_matmul(int dtype, const void* A, const void* B,
                                  const void* C, void* Out, long long M,
                                  long long N, long long K, long long lda,
                                  long long ldb, long long ldc, long long ldo,
                                  float alpha, float beta, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(A, B, C, Out, M, N, K, lda, ldb, ldc, ldo, alpha,
                           beta, s);
    case 1:
      return launch<__nv_bfloat16>(A, B, C, Out, M, N, K, lda, ldb, ldc, ldo,
                                   alpha, beta, s);
    case 2:
      return launch<__half>(A, B, C, Out, M, N, K, lda, ldb, ldc, ldo, alpha,
                            beta, s);
    default:
      return cudaErrorInvalidValue;
  }
}
