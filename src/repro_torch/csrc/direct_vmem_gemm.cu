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
// (128, 256) output tile and walks K itself; the accumulators live in
// registers, and edge tiles are masked instead of padded, so no operand is
// copied.  CTAs take their tiles in a grouped order (kGroupM tile rows at a
// time) so that those resident together share operand rows in L2.
//
// A state-of-the-art direct implementation on this card is written the way
// the best hand-written Hopper GEMMs are, one design per arithmetic unit:
//
// float32 on the CUDA cores.  A large f32 product does far more operations
// per byte than the card's ratio, so operations bound it, and f32 must be
// IEEE f32 (the reference holds it to 2e-4, which TF32 does not meet), so
// the ceiling is the CUDA cores' f32 FMA rate.  A 4-stage cp.async ring of
// BK = 16 tiles (A copied k-major in 4-byte pieces as it lands, B in
// 16-byte copies where its rows allow, zero-fill past every edge), 256
// threads of 8 x 16 outputs each, one CTA per SM.
//
// bfloat16 and float16 on the tensor cores, bound by their rate.  Warpgroup
// 0 fills a 4-stage ring of 128 x 64 A and 64 x 256 B tiles, 128-byte
// swizzled, by TMA (or, where an operand's base or row stride is not
// 16-byte aligned, by element copies into the same layout), with a full and
// an empty mbarrier per stage; warpgroups 1 and 2 each run one
// wgmma.mma_async m64n256k16 (f32 accumulator) per 16 k over 64 rows, A
// K-major and B MN-major (wgmma's transpose bit for B); setmaxnreg moves
// registers to them.
//
// Numerics.  No split-K and no atomic.  f32: every output element is
// summed over k = 0 .. K-1 in that one order with __fmaf_rn, from 0, masked
// k adding fma(0, 0, acc) == acc exactly.  16 bits: every output element is
// accumulated over k steps of 16 in ascending order from k = 0, one
// m64n256k16 instruction a step, zero-filled past K.  The tile and the k
// step do not depend on the caller's block= (which the wrapper only
// checks), and the epilogue is round(alpha * acc) + round(beta * c) with
// explicit intrinsics, the same arithmetic as the plain PyTorch version,
// then one rounding to the output's dtype.
//
// Offsets are 64-bit (device operands may exceed 2^31 elements).  Inputs
// take row strides (unit column stride); the output is a new contiguous
// (M, N) array.  Launch: on the caller's stream, no allocation, returns
// cudaGetLastError() (or 1000 + the CUresult when a tensor map cannot be
// encoded).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kGroupM = 8;                // tile rows per launch-order group

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
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

// The grouped launch order: CTA blockIdx.x -> (tile row, tile column).
__device__ __forceinline__ void tile_of(int64_t M, int64_t N, int bm, int bn,
                                        int64_t* row0, int64_t* col0) {
  const int64_t tiles_m = (M + bm - 1) / bm;
  const int64_t tiles_n = (N + bn - 1) / bn;
  const int64_t pid = blockIdx.x;
  const int64_t in_group = kGroupM * tiles_n;
  const int64_t first_m = (pid / in_group) * kGroupM;
  const int64_t group_m =
      tiles_m - first_m < kGroupM ? tiles_m - first_m : kGroupM;
  *row0 = (first_m + (pid % in_group) % group_m) * bm;
  *col0 = ((pid % in_group) / group_m) * bn;
}

// ===========================================================================
// float32 on the CUDA cores
// ===========================================================================
namespace f32 {

constexpr int kBM = 128, kBN = 256, kBK = 16;
constexpr int kStages = 4;
constexpr int kThreads = 256;             // 8 warps: 4 down, 2 across
constexpr int kWarpM = 32, kWarpN = 128;  // one warp's outputs
constexpr int kTM = 8, kTN = 16;          // one thread's outputs
// A is k-major with a pitch of BM + 4 floats (rows 16-byte aligned, a
// warp's transposing copies spread over the banks); B is row-major.
constexpr int kApitch = kBM + 4;
constexpr int kAStage = kBK * kApitch;
constexpr int kStage = kAStage + kBK * kBN;
constexpr size_t kSmemBytes = size_t(kStages) * kStage * sizeof(float);

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

__device__ __forceinline__ float4 lds128(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Copies the (BM x BK) tile of A at (row0, k0) into as, k-major, and the
// (BK x BN) tile of B at (k0, col0) into bs; elements past M, N or K are
// zero.  BV: B's rows are 16-byte aligned, else 4-byte copies.
template <bool BV>
__device__ __forceinline__ void load_stage(
    float* as, float* bs, const float* __restrict__ A,
    const float* __restrict__ B, int64_t M, int64_t N, int64_t K,
    int64_t lda, int64_t ldb, int64_t row0, int64_t col0, int64_t k0,
    int tid) {
  static_assert(kBM * kBK % kThreads == 0, "A elements");
#pragma unroll
  for (int l = 0; l < kBM * kBK / kThreads; ++l) {
    const int e = tid + l * kThreads;           // lanes along k: coalesced
    const int r = e / kBK;
    const int kk = e % kBK;
    const int64_t gr = row0 + r;
    const int64_t gk = k0 + kk;
    const bool ok = gr < M && gk < K;
    cp_async4(as + kk * kApitch + r, ok ? A + gr * lda + gk : A, ok ? 4 : 0);
  }
  if constexpr (BV) {
    constexpr int BCH = kBK * kBN / 4;
    static_assert(BCH % kThreads == 0, "B chunks");
#pragma unroll
    for (int l = 0; l < BCH / kThreads; ++l) {
      const int c = tid + l * kThreads;
      const int kk = c / (kBN / 4);
      const int cc = (c % (kBN / 4)) * 4;
      const int64_t gk = k0 + kk;
      const int64_t gc = col0 + cc;
      int64_t n = gk < K ? N - gc : 0;
      n = n < 0 ? 0 : (n > 4 ? 4 : n);
      cp_async16(bs + kk * kBN + cc, n > 0 ? B + gk * ldb + gc : B,
                 static_cast<int>(n) * 4);
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
      cp_async4(bs + kk * kBN + cc, ok ? B + gk * ldb + gc : B, ok ? 4 : 0);
    }
  }
}

// Thread (warp (wm, wn), lane (lm, ln)) owns rows wm*32 + g*16 + lm*4 + i
// (g < 2, i < 4) and columns wn*128 + h*32 + ln*4 + j (h < 4, j < 4) of
// the tile: a warp's A reads cover 64 contiguous bytes of a k row, its B
// reads 128.
__device__ __forceinline__ int out_row(int wm, int lm, int i) {
  return wm * kWarpM + (i / 4) * 16 + lm * 4 + (i % 4);
}
__device__ __forceinline__ int out_col(int wn, int ln, int j) {
  return wn * kWarpN + (j / 4) * 32 + ln * 4 + (j % 4);
}

template <bool BV>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                const float* C, float* Out, int64_t M, int64_t N, int64_t K,
                int64_t lda, int64_t ldb, int64_t ldc, int64_t ldo,
                float alpha, float beta) {
  static_assert((kBM / kWarpM) * (kBN / kWarpN) * 32 == kThreads, "warps");
  static_assert((kWarpM / kTM) * (kWarpN / kTN) == 32, "lanes");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);

  int64_t row0, col0;
  tile_of(M, N, kBM, kBN, &row0, &col0);
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
  auto stage = [&](int64_t s) { return smem + s * kStage; };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_count)
      load_stage<BV>(stage(s), stage(s) + kAStage, A, B, M, N, K, lda, ldb,
                     row0, col0, static_cast<int64_t>(s) * kBK, tid);
    cp_async_commit();
  }

  for (int64_t kt = 0; kt < kt_count; ++kt) {
    cp_async_wait<kStages - 2>();   // this thread's copies of tile kt
    __syncthreads();                // everyone's; and tile kt-1 is consumed
    {
      const int64_t nk = kt + kStages - 1;
      if (nk < kt_count) {
        float* as = stage(nk % kStages);
        load_stage<BV>(as, as + kAStage, A, B, M, N, K, lda, ldb, row0, col0,
                       nk * kBK, tid);
      }
      cp_async_commit();
    }
    const float* as = stage(kt % kStages);
    const float* bs = as + kAStage;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; i += 4) {
        const float4 v = lds128(as + kk * kApitch + out_row(wm, lm, i));
        a[i] = v.x;
        a[i + 1] = v.y;
        a[i + 2] = v.z;
        a[i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < kTN; j += 4) {
        const float4 v = lds128(bs + kk * kBN + out_col(wn, ln, j));
        b[j] = v.x;
        b[j + 1] = v.y;
        b[j + 2] = v.z;
        b[j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
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
      Out[r * ldo + c] = __fadd_rn(__fmul_rn(alpha, acc[i][j]),
                                   __fmul_rn(beta, C[r * ldc + c]));
    }
  }
}

template <bool BV>
cudaError_t launch_mode(const float* A, const float* B, const float* C,
                        float* Out, int64_t M, int64_t N, int64_t K,
                        int64_t lda, int64_t ldb, int64_t ldc, int64_t ldo,
                        float alpha, float beta, cudaStream_t stream) {
  auto kern = gemm_kernel<BV>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (e != cudaSuccess) return e;
  const int64_t tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(tiles), kThreads, kSmemBytes, stream>>>(
      A, B, C, Out, M, N, K, lda, ldb, ldc, ldo, alpha, beta);
  return cudaGetLastError();
}

cudaError_t launch(const void* A, const void* B, const void* C, void* Out,
                   int64_t M, int64_t N, int64_t K, int64_t lda, int64_t ldb,
                   int64_t ldc, int64_t ldo, float alpha, float beta,
                   cudaStream_t stream) {
  const float* a = static_cast<const float*>(A);
  const float* b = static_cast<const float*>(B);
  const float* c = static_cast<const float*>(C);
  float* o = static_cast<float*>(Out);
  if (reinterpret_cast<uintptr_t>(B) % 16 == 0 && ldb % 4 == 0)
    return launch_mode<true>(a, b, c, o, M, N, K, lda, ldb, ldc, ldo, alpha,
                             beta, stream);
  return launch_mode<false>(a, b, c, o, M, N, K, lda, ldb, ldc, ldo, alpha,
                            beta, stream);
}

}  // namespace f32

// ===========================================================================
// bfloat16 and float16 on the tensor cores
// ===========================================================================
namespace tc {

constexpr int kBM = 128, kBN = 256, kBK = 64;
constexpr int kStages = 4;
constexpr int kThreads = 384;             // 3 warpgroups
constexpr int kATile = kBM * kBK * 2;     // bytes: 128 rows of 128 B
constexpr int kBBox = kBK * 64 * 2;       // bytes: 64 k rows of 64 columns
constexpr int kStageBytes = kATile + (kBN / 64) * kBBox;
// the element-copy route's loads in flight per producer thread; its 128
// threads cover a 64-wide k row of A and two 128-wide halves of B's rows
constexpr int kCopyBatch = 32;
static_assert(kBK == 64 && kBN == 2 * 128 && kBM % (2 * kCopyBatch) == 0 &&
                  kBK % (kCopyBatch / 2) == 0,
              "copy batches");
constexpr size_t kSmemBytes =
    size_t(kStages) * kStageBytes + 2 * kStages * sizeof(uint64_t) + 1024;

// Byte offset of element (row, col) of a tile whose rows are 128 bytes
// (64 elements) and 128-byte swizzled: the 16-byte chunk index is XORed
// with the row's index within its 8-row, 1024-byte group.  This is where
// TMA's CU_TENSOR_MAP_SWIZZLE_128B puts it, given a 1024-aligned tile.
__device__ __forceinline__ int sw128(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of the given parity to complete.  A wait of more
// than ~2^36 cycles (half a minute) is a fault of the kernel: it traps, so
// that the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 36)) __trap();
  } while (!done);
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// A shared-memory matrix descriptor for wgmma, 128-byte swizzle.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return ((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void keep(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define REPRO_WGMMA_M64N256K16(TY)                                            \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "     \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "     \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "     \
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "     \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "     \
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "     \
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "    \
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "    \
      "%127}, %128, %129, p, 1, 1, 0, 1;\n}\n"                                \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),           \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),      \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),      \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),      \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),      \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),      \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),      \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),      \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),      \
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),      \
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),      \
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),      \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),      \
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),      \
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),      \
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),      \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),               \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),               \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),               \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),               \
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),               \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),               \
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])                \
      : "l"(da), "l"(db), "r"(1))

// d += A (64 x 16, K-major) @ B (16 x 256, MN-major), f32 accumulator.
__device__ __forceinline__ void mma(__nv_bfloat16*, float (&d)[128],
                                    uint64_t da, uint64_t db) {
  REPRO_WGMMA_M64N256K16("bf16");
}
__device__ __forceinline__ void mma(__half*, float (&d)[128], uint64_t da,
                                    uint64_t db) {
  REPRO_WGMMA_M64N256K16("f16");
}
#undef REPRO_WGMMA_M64N256K16

// TMA: the tensor maps of A and B.  Else the producer's 128 threads copy
// element by element (any base, any row stride).
template <typename T, bool TMA>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_kernel(__grid_constant__ const CUtensorMap map_a,
                __grid_constant__ const CUtensorMap map_b,
                const T* __restrict__ A, const T* __restrict__ B, const T* C,
                T* Out, int64_t M, int64_t N, int64_t K, int64_t lda,
                int64_t ldb, int64_t ldc, int64_t ldo, float alpha,
                float beta) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  int64_t row0, col0;
  tile_of(M, N, kBM, kBN, &row0, &col0);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int64_t kt_count = (K + kBK - 1) / kBK;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], TMA ? 1 : 128);
      mbar_init(&empty[s], 2);          // one arrival per consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {                        // the producer
    if constexpr (TMA) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
      if (tid != 0) return;
      for (int64_t kt = 0; kt < kt_count; ++kt) {
        const int s = static_cast<int>(kt % kStages);
        mbar_wait(&empty[s], static_cast<uint32_t>((kt / kStages) & 1) ^ 1);
        unsigned char* st = smem + s * kStageBytes;
        mbar_expect_tx(&full[s], kStageBytes);
        const int k0 = static_cast<int>(kt * kBK);
        tma_load(st, &map_a, &full[s], k0, static_cast<int>(row0));
#pragma unroll
        for (int j = 0; j < kBN / 64; ++j)
          tma_load(st + kATile + j * kBBox, &map_b, &full[s],
                   static_cast<int>(col0) + 64 * j, k0);
      }
    } else {
      const uint16_t* a = reinterpret_cast<const uint16_t*>(A);
      const uint16_t* b = reinterpret_cast<const uint16_t*>(B);
      for (int64_t kt = 0; kt < kt_count; ++kt) {
        const int s = static_cast<int>(kt % kStages);
        mbar_wait(&empty[s], static_cast<uint32_t>((kt / kStages) & 1) ^ 1);
        unsigned char* st = smem + s * kStageBytes;
        const int64_t k0 = kt * kBK;
        // A: thread t copies column t % 64 of rows t / 64, + 2, ...; B:
        // columns t and t + 128 of every k row.  kCopyBatch loads of a
        // thread are in flight before it stores any.
        const int ka = tid % kBK;
        for (int r0 = tid / kBK; r0 < kBM; r0 += 2 * kCopyBatch) {
          uint16_t v[kCopyBatch];
#pragma unroll
          for (int i = 0; i < kCopyBatch; ++i) {
            const int64_t gr = row0 + r0 + 2 * i;
            v[i] = gr < M && k0 + ka < K ? a[gr * lda + k0 + ka]
                                         : uint16_t(0);
          }
#pragma unroll
          for (int i = 0; i < kCopyBatch; ++i)
            *reinterpret_cast<uint16_t*>(st + sw128(r0 + 2 * i, ka)) = v[i];
        }
        for (int kr = 0; kr < kBK; kr += kCopyBatch / 2) {
          uint16_t v[kCopyBatch];
#pragma unroll
          for (int i = 0; i < kCopyBatch; ++i) {
            const int64_t gk = k0 + kr + i / 2, gc = col0 + tid + 128 * (i % 2);
            v[i] = gk < K && gc < N ? b[gk * ldb + gc] : uint16_t(0);
          }
#pragma unroll
          for (int i = 0; i < kCopyBatch; ++i) {
            const int c = tid + 128 * (i % 2);
            *reinterpret_cast<uint16_t*>(st + kATile + (c / 64) * kBBox +
                                         sw128(kr + i / 2, c % 64)) = v[i];
          }
        }
        // generic-proxy stores, read by wgmma through the async proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // a consumer: rows (wg - 1) * 64 .. + 63 of the tile
  if constexpr (TMA) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.0f;
  for (int64_t kt = 0; kt < kt_count; ++kt) {
    const int s = static_cast<int>(kt % kStages);
    mbar_wait(&full[s], static_cast<uint32_t>((kt / kStages) & 1));
    const unsigned char* st = smem + s * kStageBytes;
    keep(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // A: 64 rows from (wg - 1) * 64, k from kk * 16 (32 bytes into each
      // swizzled row); B: k rows kk * 16 .. + 15 of the four 64-column boxes
      const uint64_t da = desc(st + (wg - 1) * 64 * 128 + kk * 32, 16, 1024);
      const uint64_t db = desc(st + kATile + kk * 16 * 128, kBBox, 1024);
      mma(static_cast<T*>(nullptr), d, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    keep(d);
    // the previous stage's products are done: release its buffers
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    keep(d);
    if (kt > 0 && tid % 128 == 0) mbar_arrive(&empty[(kt - 1) % kStages]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  keep(d);

  // d[n8 * 4 + i * 2 + j] is row 16 * warp + lane / 4 + 8 * i, column
  // 8 * n8 + 2 * (lane % 4) + j of this consumer's 64 x 256
  const int lane = tid % 32;
  const int64_t r0 = row0 + (wg - 1) * 64 + ((tid % 128) / 32) * 16 + lane / 4;
  const int64_t cb = col0 + 2 * (lane % 4);
#pragma unroll
  for (int n8 = 0; n8 < kBN / 8; ++n8)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t r = r0 + 8 * i;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int64_t c = cb + 8 * n8 + j;
        if (c >= N) continue;
        const float cv = to_f32(C[r * ldc + c]);
        const float v = __fadd_rn(__fmul_rn(alpha, d[n8 * 4 + i * 2 + j]),
                                  __fmul_rn(beta, cv));
        Out[r * ldo + c] = from_f32<T>(v);
      }
    }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major (rows x cols) 16-bit matrix, row stride ld elements, read in
// (box_rows x 64)-element boxes, 128-byte swizzled, zeros out of bounds.
CUresult encode(CUtensorMap* map, CUtensorMapDataType type, const void* p,
                int64_t rows, int64_t cols, int64_t ld, int box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(p), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <typename T>
int launch(const void* A, const void* B, const void* C, void* Out, int64_t M,
           int64_t N, int64_t K, int64_t lda, int64_t ldb, int64_t ldc,
           int64_t ldo, float alpha, float beta, cudaStream_t stream) {
  const CUtensorMapDataType type = std::is_same<T, __nv_bfloat16>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  // TMA addresses 16-byte aligned bases and row strides, 32-bit coordinates
  const int64_t lim = 0x7fffffff;
  const bool tma = K > 0 && M <= lim && N <= lim && K <= lim &&
                   reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(B) % 16 == 0 &&
                   lda % 8 == 0 && ldb % 8 == 0 && lda >= K && ldb >= N;
  CUtensorMap map_a, map_b;
  memset(&map_a, 0, sizeof(map_a));
  memset(&map_b, 0, sizeof(map_b));
  if (tma) {
    CUresult r = encode(&map_a, type, A, M, K, lda, kBM);
    if (r == CUDA_SUCCESS) r = encode(&map_b, type, B, K, N, ldb, kBK);
    if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  }
  auto kern = tma ? gemm_kernel<T, true> : gemm_kernel<T, false>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (e != cudaSuccess) return e;
  const int64_t tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(tiles), kThreads, kSmemBytes, stream>>>(
      map_a, map_b, static_cast<const T*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(Out), M, N, K, lda, ldb, ldc,
      ldo, alpha, beta);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (A, B, C and Out alike).
// Strides are row strides in elements; Out is contiguous (M, N).
extern "C" int repro_direct_vmem_gemm(int dtype, const void* A, const void* B,
                                      const void* C, void* Out, long long M,
                                      long long N, long long K, long long lda,
                                      long long ldb, long long ldc,
                                      float alpha, float beta, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return f32::launch(A, B, C, Out, M, N, K, lda, ldb, ldc, N, alpha, beta,
                         s);
    case 1:
      return tc::launch<__nv_bfloat16>(A, B, C, Out, M, N, K, lda, ldb, ldc,
                                       N, alpha, beta, s);
    case 2:
      return tc::launch<__half>(A, B, C, Out, M, N, K, lda, ldb, ldc, N,
                                alpha, beta, s);
    default:
      return cudaErrorInvalidValue;
  }
}
