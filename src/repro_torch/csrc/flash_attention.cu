// Hopper flash-decoding: single-token GQA attention over a KV cache, in two
// passes that share one layout of partials.
//
// Port of src/repro/kernels/flash_attention.py:_kernel (the Pallas kernel
// that walks the S blocks of one (batch, kv head) in a sequential grid axis,
// carrying an f32 online-softmax state (m, l, acc) in VMEM).  On the TPU that
// grid runs B * Hkv programs side by side: 8 at B = 1 for llama3.2-3b, which
// would fill 8 of the H100's 132 SMs.  Here the S axis is split instead:
//
//   * partial pass: one CTA of kWarps warps per (batch, kv head, split of
//     block_s positions) computes the split's (m, l, acc) for the G query
//     rows of its group, with no carry between CTAs; kv heads vary fastest
//     in the launch order;
//   * combine pass: one CTA per (batch, query head) folds the splits,
//     optionally starting from an incoming carry, and either writes the
//     carry back (the out-of-core executor's per-block update) or normalises
//     and casts to the output dtype.
//
// What bounds it on an H100: about 4 * H * d flops per position against
// 2 * Hkv * d * sizeof(T) bytes of K and V, i.e. G = H / Hkv flops per byte,
// far below the ridge point.  The bound is bytes: K + V over 3.35 TB/s.  So
// the design keeps bytes in flight and never waits on them:
//
//   * each warp of a partial-pass CTA streams its own tiles of the split
//     (tile t of kSteps * 32 / TPR positions goes to warp t % kWarps)
//     through a private ring of kStages shared-memory slots, filled with
//     16-byte cp.async (zero-fill past the row's length), so the loads of
//     the next tiles are in flight while this one is scored and
//     accumulated; a warp synchronises only with itself (__syncwarp) until
//     its split is done;
//   * one pass per tile: the K rows give the tile's scores, an online
//     softmax carry (m, l, acc) per warp absorbs them, and the V rows of the
//     same positions are accumulated at once: there is no score buffer and
//     no second sweep;
//   * the query rows of a group are a template parameter G (1..8), so no
//     row is padded; more rows than 8 take several passes over the split;
//   * the combine pass spreads each (b, h)'s splits over all warps of its
//     CTA in fixed chunks, then folds the chunks in warp order;
//   * no tensor cores: at G flops per byte there is nothing for them to
//     speed up, and mma would round q to bf16 or f32 K/V to TF32, which
//     neither the plain version nor the reference does.
//
// Numerics.  Scores are (q . k) * scale, the reference's order
// (flash_attention.py:47), summed in f32.  Positions at or beyond
// length[b] get no score and p = 0: they add exactly nothing, and a split
// wholly beyond length[b] reads no K/V and writes (NEG_INF, 0, 0).
// NEG_INF is the finite -1e30 everywhere, so two empty partials meet as
// exp(0) * 0 and never as -inf - -inf.  A split's m is its largest score
// (max is exact in any order); its l and acc are the warps' online sums,
// rescaled to that m and added in warp order.  The combine is the
// arithmetic of merge_attention_partials: m* = max over the carry and the
// splits, then l = sum l_i exp(m_i - m*), acc = sum acc_i exp(m_i - m*),
// the carry first, then each warp's chunk of splits in ascending order;
// normalisation divides by max(l, 1e-20).  Every reduction has a fixed
// order (no atomics), so two runs of one call agree bit for bit.
//
// Launch: on the caller's stream, no allocation, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;                 // warps per partial-pass CTA
constexpr int kThreads = kWarps * 32;
constexpr int kSteps = 4;                 // warp steps per tile
constexpr int kStages = 3;                // ring slots per warp
constexpr int kMaxRows = 8;               // query rows per pass over K/V
constexpr int kMaxHeadDim = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCombineWarps = 8;
constexpr int kCombineThreads = kCombineWarps * 32;
constexpr int kCombineChunk = 1024;       // splits weighed per round
constexpr int kCombineBatch = 8;          // splits a warp loads at once

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
// rest of the destination is zero-filled.
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

// VEC consecutive elements at p (shared memory) as floats: one 16-byte load
// when VEC > 1, else one scalar load.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  if constexpr (VEC == 1) {
    out[0] = to_f32(p[0]);
  } else {
    static_assert(VEC * sizeof(T) == 16, "vector loads are 16 bytes");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f32(e[i]);
  }
}

// Shared memory of one warp: its ring of kStages slots, each the K rows then
// the V rows of one tile of TPW positions; after its last tile the same
// bytes hold the warp's carry: m[G], l[G], acc[G][d] (f32).
template <typename T>
__host__ __device__ __forceinline__ int warp_region_bytes(int tpw, int rows,
                                                          int d) {
  const int ring = kStages * 2 * tpw * d * static_cast<int>(sizeof(T));
  const int carry = (2 * rows + rows * d) * 4;
  const int n = ring > carry ? ring : carry;
  return (n + 15) / 16 * 16;
}

// Lane layout: TPR lanes share one position; lane tl of a position owns
// chunks tl, tl + TPR, ... (CPL of them) of VEC elements each; a warp step
// covers P = 32 / TPR positions and a tile kSteps steps.
template <typename T, int VEC, int TPR, int CPL, int G>
struct PartialShape {
  static constexpr int P = 32 / TPR;
  static constexpr int TPW = P * kSteps;       // positions per tile
  static constexpr int E = CPL * VEC;          // elements a lane owns
  // 16 warps per SM where the carry is small, else 8
  static constexpr int kMinBlocks =
      (G * (2 * E + kSteps) <= 80 ? 16 : 8) / kWarps;
};

template <typename T, int VEC, int TPR, int CPL, int G>
__global__ void __launch_bounds__(
    kThreads, (PartialShape<T, VEC, TPR, CPL, G>::kMinBlocks))
    flash_partial_kernel(const float* __restrict__ q,
                         const T* __restrict__ k, const T* __restrict__ v,
                         const int* __restrict__ length, int64_t len_all,
                         float* __restrict__ m_out, float* __restrict__ l_out,
                         float* __restrict__ acc_out, int64_t S, int d,
                         int hkv, int Gtot, int block_s, int nsplit,
                         int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb,
                         int64_t vss, int64_t vsh, float scale) {
  using PS = PartialShape<T, VEC, TPR, CPL, G>;
  constexpr int P = PS::P;
  constexpr int TPW = PS::TPW;
  constexpr int E = PS::E;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float wt_sh[kWarps][G];     // exp(m_w - m*) per warp and row

  // kv heads vary fastest, so the CTAs that run together read the same
  // positions of every head: whole rows of the cache
  const int kh = static_cast<int>(blockIdx.x % hkv);
  const int split = static_cast<int>(blockIdx.x / hkv);
  const int b = blockIdx.z;
  const int H = hkv * Gtot;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int slot = lane / TPR;
  const int tl = lane % TPR;

  const int64_t s0 = static_cast<int64_t>(split) * block_s;
  int64_t len = length != nullptr ? static_cast<int64_t>(length[b]) : len_all;
  if (len > S) len = S;
  int64_t nv64 = len - s0;
  if (nv64 > block_s) nv64 = block_s;
  const int nv = nv64 > 0 ? static_cast<int>(nv64) : 0;

  // partial (b, h, split) for h = kh * Gtot + g
  const int64_t row0 =
      static_cast<int64_t>(b) * H + static_cast<int64_t>(kh) * Gtot;
  if (nv == 0) {  // wholly masked split: no K/V read
    for (int e = tid; e < Gtot * d; e += kThreads) {
      const int g = e / d;
      acc_out[((row0 + g) * nsplit + split) * d + e % d] = 0.0f;
    }
    for (int g = tid; g < Gtot; g += kThreads) {
      m_out[(row0 + g) * nsplit + split] = kNegInf;
      l_out[(row0 + g) * nsplit + split] = 0.0f;
    }
    return;
  }

  const int region = warp_region_bytes<T>(TPW, G, d);
  unsigned char* mine = smem + warp * region;
  T* ring = reinterpret_cast<T*>(mine);
  const int tile_elems = TPW * d;
  const T* kbase = k + b * ksb + s0 * kss + kh * ksh;
  const T* vbase = v + b * vsb + s0 * vss + kh * vsh;
  const int ntiles = (nv + TPW - 1) / TPW;
  const int my_tiles = warp < ntiles ? (ntiles - 1 - warp) / kWarps + 1 : 0;

  // K and V rows of tile `tile` into ring slot `sl`; rows past nv are zero
  auto issue = [&](int sl, int tile) {
    T* dk = ring + sl * 2 * tile_elems;
    T* dv = dk + tile_elems;
    const int base = tile * TPW;
    if constexpr (VEC > 1) {
      const int per_row = d / VEC;
      for (int c = lane; c < TPW * per_row; c += 32) {
        const int r = c / per_row;
        const int j = (c % per_row) * VEC;
        const bool ok = base + r < nv;
        const int64_t pos = base + r;
        cp_async16(dk + r * d + j, ok ? kbase + pos * kss + j : kbase,
                   ok ? 16 : 0);
        cp_async16(dv + r * d + j, ok ? vbase + pos * vss + j : vbase,
                   ok ? 16 : 0);
      }
    } else {
      for (int e = lane; e < tile_elems; e += 32) {
        const int r = e / d;
        const int j = e % d;
        const bool ok = base + r < nv;
        const int64_t pos = base + r;
        if constexpr (sizeof(T) == 4) {
          cp_async4(dk + e, ok ? kbase + pos * kss + j : kbase, ok ? 4 : 0);
          cp_async4(dv + e, ok ? vbase + pos * vss + j : vbase, ok ? 4 : 0);
        } else {   // 16-bit rows that are not 4-byte aligned: plain copies
          dk[e] = ok ? kbase[pos * kss + j] : from_f32<T>(0.0f);
          dv[e] = ok ? vbase[pos * vss + j] : from_f32<T>(0.0f);
        }
      }
    }
  };

  for (int g0 = 0; g0 < Gtot; g0 += G) {
    const int rows = Gtot - g0 < G ? Gtot - g0 : G;
    float qr[G][E];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < CPL; ++c)
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const int j = (tl + c * TPR) * VEC + i;
          qr[g][c * VEC + i] =
              (g < rows && j < d) ? q[(row0 + g0 + g) * d + j] : 0.0f;
        }
    // the warp's online-softmax carry; m is warp-uniform, l and acc are
    // per position slot until the end
    float m_run[G], l_run[G], acc[G][E];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m_run[g] = kNegInf;
      l_run[g] = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] = 0.0f;
    }

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < my_tiles) issue(s, warp + s * kWarps);
      cp_async_commit();
    }
    for (int it = 0; it < my_tiles; ++it) {
      cp_async_wait<kStages - 2>();   // this lane's copies of tile it
      __syncwarp();                   // every lane's; slot it-1 is free
      {
        const int nt = it + kStages - 1;
        if (nt < my_tiles) issue(nt % kStages, warp + nt * kWarps);
        cp_async_commit();
      }
      const T* ks = ring + (it % kStages) * 2 * tile_elems;
      const T* vs = ks + tile_elems;
      const int base = (warp + it * kWarps) * TPW;

      // scores of this lane's positions: s[g][u] for row slot + P * u
      float s[G][kSteps];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int r = slot + P * u;
        float kr[E];
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int j = (tl + c * TPR) * VEC;
          if (j < d) {
            load_vec<T, VEC>(ks + r * d + j, &kr[c * VEC]);
          } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) kr[c * VEC + i] = 0.0f;
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float dot = 0.0f;
#pragma unroll
          for (int e = 0; e < E; ++e) dot = __fmaf_rn(qr[g][e], kr[e], dot);
#pragma unroll
          for (int off = TPR / 2; off > 0; off >>= 1)
            dot += __shfl_xor_sync(kFull, dot, off);
          s[g][u] = base + r < nv ? dot * scale : kNegInf;
        }
      }
      // fold the tile into the carry: new max, rescale, p = exp(s - m)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mt = s[g][0];
#pragma unroll
        for (int u = 1; u < kSteps; ++u) mt = fmaxf(mt, s[g][u]);
#pragma unroll
        for (int off = TPR; off < 32; off <<= 1)
          mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, off));
        const float mn = fmaxf(m_run[g], mt);
        const float corr = expf(m_run[g] - mn);
        m_run[g] = mn;
        l_run[g] *= corr;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= corr;
#pragma unroll
        for (int u = 0; u < kSteps; ++u) {
          const float p =
              base + slot + P * u < nv ? expf(s[g][u] - mn) : 0.0f;
          s[g][u] = p;
          l_run[g] += p;
        }
      }
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int r = slot + P * u;
        float vr[E];
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int j = (tl + c * TPR) * VEC;
          if (j < d) {
            load_vec<T, VEC>(vs + r * d + j, &vr[c * VEC]);
          } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) vr[c * VEC + i] = 0.0f;
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[g][e] = __fmaf_rn(s[g][u], vr[e], acc[g][e]);
      }
    }

    // fold the warp's position slots (a fixed butterfly), then park the
    // carry in the warp's region: m[G], l[G], acc[G][d]
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int off = TPR; off < 32; off <<= 1) {
        l_run[g] += __shfl_xor_sync(kFull, l_run[g], off);
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[g][e] += __shfl_xor_sync(kFull, acc[g][e], off);
      }
    cp_async_wait<0>();
    __syncwarp();                     // no lane reads the ring any more
    float* carry = reinterpret_cast<float*>(mine);
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        carry[g] = m_run[g];
        carry[G + g] = l_run[g];
      }
    }
    if (slot == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int c = 0; c < CPL; ++c)
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const int j = (tl + c * TPR) * VEC + i;
            if (j < d) carry[2 * G + g * d + j] = acc[g][c * VEC + i];
          }
    }
    __syncthreads();

    // fold the warps in order 0 .. kWarps-1 under the split's max
    auto carry_of = [&](int w) {
      return reinterpret_cast<const float*>(smem + w * region);
    };
    if (tid < rows) {
      const int g = tid;
      float ms = carry_of(0)[g];
      for (int w = 1; w < kWarps; ++w) ms = fmaxf(ms, carry_of(w)[g]);
      float l = 0.0f;
      for (int w = 0; w < kWarps; ++w) {
        const float wt = expf(carry_of(w)[g] - ms);
        wt_sh[w][g] = wt;
        l = __fadd_rn(l, __fmul_rn(carry_of(w)[G + g], wt));
      }
      m_out[(row0 + g0 + g) * nsplit + split] = ms;
      l_out[(row0 + g0 + g) * nsplit + split] = l;
    }
    __syncthreads();
    for (int e = tid; e < rows * d; e += kThreads) {
      const int g = e / d;
      const int j = e % d;
      float a = 0.0f;
      for (int w = 0; w < kWarps; ++w)
        a = __fadd_rn(a, __fmul_rn(carry_of(w)[2 * G + g * d + j],
                                   wt_sh[w][g]));
      acc_out[((row0 + g0 + g) * nsplit + split) * d + j] = a;
    }
    __syncthreads();                  // regions are rings again
  }
}

// One CTA per (query head, batch).  The weights exp(m_i - m*) of a chunk of
// up to kCombineChunk splits are computed once each, into shared memory;
// warp w then folds splits [w * cs, (w + 1) * cs) of the chunk in
// ascending order, lane l owning elements l, l + 32, ... of a slice of
// kMaxHeadDim, loading kCombineBatch splits at once; the warps' sums are
// added in warp order after the carry.
template <typename O>
__global__ void __launch_bounds__(kCombineThreads)
    flash_combine_kernel(const float* __restrict__ m_part,
                         const float* __restrict__ l_part,
                         const float* __restrict__ acc_part, int nsplit,
                         float* m_c, float* l_c, float* acc_c, O* out,
                         int64_t osb, int64_t osh, int H, int d,
                         int normalise) {
  constexpr int R = kMaxHeadDim / 32;
  __shared__ float w_sh[kCombineChunk];
  __shared__ float red_sh[kCombineWarps];
  __shared__ float l_sh[kCombineWarps];
  __shared__ float a_sh[kCombineWarps][kMaxHeadDim];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  const float* mp = m_part + bh * nsplit;
  const float* lp = l_part + bh * nsplit;
  const float* ap = acc_part + bh * nsplit * d;
  const bool carry = m_c != nullptr;
  // every thread reads the carry's m and l before any thread writes them
  const float mc = carry ? m_c[bh] : 0.0f;
  const float lc = carry ? l_c[bh] : 0.0f;

  // m* = max over the carry and the splits (max is exact in any order)
  float mx = carry ? mc : mp[0];
  for (int i = t; i < nsplit; i += kCombineThreads) mx = fmaxf(mx, mp[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  if (lane == 0) red_sh[warp] = mx;
  __syncthreads();
  float m_star = red_sh[0];
  for (int w = 1; w < kCombineWarps; ++w) m_star = fmaxf(m_star, red_sh[w]);
  const float wc = carry ? expf(mc - m_star) : 0.0f;

  for (int j0 = 0; j0 < d; j0 += kMaxHeadDim) {
    // the carry first
    const int j = j0 + t;
    const bool mine = t < kMaxHeadDim && j < d;
    float A = carry && mine ? __fmul_rn(acc_c[bh * d + j], wc) : 0.0f;
    float L = __fmul_rn(lc, wc);
    for (int c0 = 0; c0 < nsplit; c0 += kCombineChunk) {
      const int n = min(kCombineChunk, nsplit - c0);
      __syncthreads();                // w_sh and a_sh are free
      for (int i = t; i < n; i += kCombineThreads)
        w_sh[i] = expf(mp[c0 + i] - m_star);
      __syncthreads();
      const int cs = (n + kCombineWarps - 1) / kCombineWarps;
      const int i0 = min(n, warp * cs);
      const int i1 = min(n, i0 + cs);
      float a[R];
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = 0.0f;
      float l = 0.0f;
      for (int i = i0; i < i1; i += kCombineBatch) {
        float x[kCombineBatch][R];
        float wv[kCombineBatch];
#pragma unroll
        for (int u = 0; u < kCombineBatch; ++u) {
          const bool ok = i + u < i1;
          wv[u] = ok ? w_sh[i + u] : 0.0f;
          const float* ai = ap + static_cast<int64_t>(c0 + i + u) * d + j0;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int jj = lane + 32 * r;
            x[u][r] = ok && j0 + jj < d ? ai[jj] : 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < kCombineBatch; ++u) {
          if (i + u < i1) l = __fadd_rn(l, __fmul_rn(lp[c0 + i + u], wv[u]));
#pragma unroll
          for (int r = 0; r < R; ++r)
            a[r] = __fadd_rn(a[r], __fmul_rn(x[u][r], wv[u]));
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) a_sh[warp][lane + 32 * r] = a[r];
      if (lane == 0) l_sh[warp] = l;
      __syncthreads();
      // the warps' sums in warp order
      for (int w = 0; w < kCombineWarps; ++w) {
        L = __fadd_rn(L, l_sh[w]);
        if (mine) A = __fadd_rn(A, a_sh[w][t]);
      }
    }
    if (mine) {
      if (normalise)
        out[b * osb + h * osh + j] =
            from_f32<O>(__fdiv_rn(A, fmaxf(L, 1e-20f)));
      else
        acc_c[bh * d + j] = A;
    }
    if (!normalise && t == 0 && j0 + kMaxHeadDim >= d) {
      m_c[bh] = m_star;
      l_c[bh] = L;
    }
  }
}

struct PartialArgs {
  const float* q;
  const void* k;
  const void* v;
  const int* length;
  int64_t len_all;
  float* m;
  float* l;
  float* acc;
  int64_t B, S;
  int d, hkv, G, block_s, nsplit;
  int64_t ksb, kss, ksh, vsb, vss, vsh;
  float scale;
};

template <typename T, int VEC, int TPR, int CPL, int G>
cudaError_t launch_partial(const PartialArgs& a, cudaStream_t stream) {
  constexpr int TPW = PartialShape<T, VEC, TPR, CPL, G>::TPW;
  const size_t smem =
      static_cast<size_t>(kWarps) * warp_region_bytes<T>(TPW, G, a.d);
  auto kern = flash_partial_kernel<T, VEC, TPR, CPL, G>;
  // the opt-in is also needed when the static wt_sh tips the total past
  // 48 KiB
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(a.nsplit) * a.hkv, 1,
                  static_cast<unsigned>(a.B));
  kern<<<grid, kThreads, smem, stream>>>(
      a.q, static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.length,
      a.len_all, a.m, a.l, a.acc, a.S, a.d, a.hkv, a.G, a.block_s, a.nsplit,
      a.ksb, a.kss, a.ksh, a.vsb, a.vss, a.vsh, a.scale);
  return cudaGetLastError();
}

// G query rows per pass: the group's own count up to kMaxRows, else
// kMaxRows at a time.
template <typename T, int VEC, int TPR, int CPL>
cudaError_t dispatch_rows(const PartialArgs& a, cudaStream_t s) {
  switch (a.G < kMaxRows ? a.G : kMaxRows) {
    case 1:
      return launch_partial<T, VEC, TPR, CPL, 1>(a, s);
    case 2:
      return launch_partial<T, VEC, TPR, CPL, 2>(a, s);
    case 3:
      return launch_partial<T, VEC, TPR, CPL, 3>(a, s);
    case 4:
      return launch_partial<T, VEC, TPR, CPL, 4>(a, s);
    case 5:
      return launch_partial<T, VEC, TPR, CPL, 5>(a, s);
    case 6:
      return launch_partial<T, VEC, TPR, CPL, 6>(a, s);
    case 7:
      return launch_partial<T, VEC, TPR, CPL, 7>(a, s);
    default:
      return launch_partial<T, VEC, TPR, CPL, kMaxRows>(a, s);
  }
}

// Picks the lane layout: 16-byte chunks when the wrapper allows them (d and
// every stride a multiple of the chunk, pointers 16-byte aligned), with 16
// or 32 lanes per position; otherwise one element per load, 32 lanes, and
// kMaxRows query rows per pass.
template <typename T>
cudaError_t dispatch_partial(const PartialArgs& a, int vec, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (a.d < 1 || a.d > kMaxHeadDim || a.G < 1) return cudaErrorInvalidValue;
  if (!vec) return launch_partial<T, 1, 32, kMaxHeadDim / 32, kMaxRows>(a, s);
  if (a.d % V != 0) return cudaErrorInvalidValue;
  const int chunks = a.d / V;
  if (chunks <= 16) return dispatch_rows<T, V, 16, 1>(a, s);
  if (chunks <= 32) return dispatch_rows<T, V, 32, 1>(a, s);
  if constexpr (V == 4) return dispatch_rows<T, V, 32, 2>(a, s);  // f32
  return cudaErrorInvalidValue;  // unreachable: 16-bit d <= 256 fits above
}

template <typename O>
cudaError_t launch_combine(const float* m, const float* l, const float* acc,
                           int nsplit, float* m_c, float* l_c, float* acc_c,
                           void* out, int64_t osb, int64_t osh, int64_t B,
                           int H, int d, int normalise, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(H), static_cast<unsigned>(B));
  flash_combine_kernel<O><<<grid, kCombineThreads, 0, stream>>>(
      m, l, acc, nsplit, m_c, l_c, acc_c, static_cast<O*>(out), osb, osh, H,
      d, normalise);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (K and V alike); q is f32
// (B, H, d) contiguous.  Strides are in elements, d has unit stride.
// length: (B,) int32 on the device, or null to use len_all for every row.
// Partials: m, l (B, H, nsplit) and acc (B, H, nsplit, d), f32 contiguous.
extern "C" int repro_flash_partial(
    int dtype, int vec, const void* q, const void* k, const void* v,
    const void* length, long long len_all, void* m, void* l, void* acc,
    long long B, long long S, int hkv, int G, int d, int block_s, int nsplit,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, float scale, void* stream) {
  const PartialArgs a{static_cast<const float*>(q),
                      k,
                      v,
                      static_cast<const int*>(length),
                      len_all,
                      static_cast<float*>(m),
                      static_cast<float*>(l),
                      static_cast<float*>(acc),
                      B,
                      S,
                      d,
                      hkv,
                      G,
                      block_s,
                      nsplit,
                      ksb,
                      kss,
                      ksh,
                      vsb,
                      vss,
                      vsh,
                      scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_partial<float>(a, vec, s);
    case 1:
      return dispatch_partial<__nv_bfloat16>(a, vec, s);
    case 2:
      return dispatch_partial<__half>(a, vec, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Folds nsplit partials (B, H, nsplit[, d]) per (b, h) into m*, l, acc,
// starting from the carry (m_c, l_c (B, H); acc_c (B, H, d)) when m_c is
// not null.  normalise = 0: write the carry back in place (it must be
// given).  normalise = 1: out[b, h, :] = acc / max(l, 1e-20) in out_dtype
// (0 f32, 1 bf16, 2 f16), with strides osb, osh and unit stride on d.
extern "C" int repro_flash_combine(int out_dtype, const void* m,
                                   const void* l, const void* acc, int nsplit,
                                   void* m_c, void* l_c, void* acc_c,
                                   void* out, long long osb, long long osh,
                                   long long B, int H, int d, int normalise,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mp = static_cast<const float*>(m);
  const float* lp = static_cast<const float*>(l);
  const float* ap = static_cast<const float*>(acc);
  float* mc = static_cast<float*>(m_c);
  float* lc = static_cast<float*>(l_c);
  float* ac = static_cast<float*>(acc_c);
  if (d < 1 || (mc == nullptr && nsplit < 1) ||
      (!normalise && mc == nullptr))
    return cudaErrorInvalidValue;
  switch (normalise ? out_dtype : 0) {
    case 0:
      return launch_combine<float>(mp, lp, ap, nsplit, mc, lc, ac, out, osb,
                                   osh, B, H, d, normalise, s);
    case 1:
      return launch_combine<__nv_bfloat16>(mp, lp, ap, nsplit, mc, lc, ac, out,
                                           osb, osh, B, H, d, normalise, s);
    case 2:
      return launch_combine<__half>(mp, lp, ap, nsplit, mc, lc, ac, out, osb,
                                    osh, B, H, d, normalise, s);
    default:
      return cudaErrorInvalidValue;
  }
}
