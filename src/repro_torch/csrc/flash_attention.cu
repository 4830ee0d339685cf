// Hopper flash-decoding: single-token GQA attention over a KV cache, in two
// passes that share one layout of partials.
//
// Port of src/repro/kernels/flash_attention.py:_kernel (the Pallas kernel
// that walks the S blocks of one (batch, kv head) in a sequential grid axis,
// carrying an f32 online-softmax state (m, l, acc) in VMEM).  On the TPU that
// grid runs B * Hkv programs side by side: 8 at B = 1 for llama3.2-3b, which
// would fill 8 of the H100's 132 SMs.  Here the S axis is split instead:
//
//   * partial pass: one CTA per (batch, kv head, split of block_s
//     positions) computes the split's (m, l, acc) for the G query rows of its
//     group, with no carry between CTAs;
//   * combine pass: one CTA per (batch, query head) folds the splits in
//     ascending order, optionally starting from an incoming carry, and
//     either writes the carry back (the out-of-core executor's per-block
//     update) or normalises and casts to the output dtype.
//
// What bounds it on an H100: about 4 * H * d flops per position against
// 2 * Hkv * d * sizeof(T) bytes of K and V, i.e. G = H / Hkv flops per byte,
// far below the ridge point.  The bound is bytes: K + V over 3.35 TB/s.  So
// the design keeps bytes in flight rather than feeding tensor cores: K and V
// rows are read once, in their own dtype (f32, bf16 or f16, never widened in
// memory), with 16-byte loads that neighbouring lanes issue on neighbouring
// addresses, four positions per lane unrolled ahead of their use; the split
// of S gives 1,024 CTAs for a 65,536-position block at Hkv = 8.  Not yet
// done: cp.async/TMA stages and mma for the (G x d) x (d x block_s) product.
//
// Numerics.  Scores are (q . k) * scale, the reference's order
// (flash_attention.py:47), summed in f32.  Positions at or beyond
// length[b] get no score and p = 0: they add exactly nothing, and a split
// wholly beyond length[b] reads no K/V and writes (NEG_INF, 0, 0).
// NEG_INF is the finite -1e30 everywhere, so two empty partials meet as
// exp(0) * 0 and never as -inf - -inf.  The combine is the arithmetic of
// merge_attention_partials: m* = max over the carry and the splits, then
// l = sum l_i exp(m_i - m*), acc = sum acc_i exp(m_i - m*), in split order;
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
constexpr int kWarps = 4;                 // warps per partial-pass CTA
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;                  // query rows held per pass over K/V
constexpr int kUnroll = 4;                // positions per lane in flight
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCombineChunk = 1024;       // splits staged per combine round
constexpr int kCombineThreadsMax = 1024;

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

// VEC consecutive elements at p as floats: one 16-byte load when VEC > 1
// (the wrapper checks alignment), else one scalar load.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  if constexpr (VEC == 1) {
    out[0] = to_f32(p[0]);
  } else {
    static_assert(VEC * sizeof(T) == 16, "vector loads are 16 bytes");
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f32(e[i]);
  }
}

// Lane layout of the partial pass: TPR lanes share one position (a "row"
// of d elements); lane tl of a row owns chunks tl, tl + TPR, ... (CPL of
// them) of VEC elements each; a warp covers P = 32 / TPR positions at once.
template <typename T, int VEC, int TPR, int CPL>
__global__ void __launch_bounds__(kThreads)
    flash_partial_kernel(const float* __restrict__ q,
                         const T* __restrict__ k, const T* __restrict__ v,
                         const int* __restrict__ length, int64_t len_all,
                         float* __restrict__ m_out, float* __restrict__ l_out,
                         float* __restrict__ acc_out, int64_t S, int d,
                         int hkv, int G, int block_s, int nsplit, int64_t ksb,
                         int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,
                         int64_t vsh, float scale) {
  constexpr int P = 32 / TPR;
  constexpr int E = CPL * VEC;              // elements a lane owns
  constexpr int kStep = kWarps * P;         // positions per CTA step
  extern __shared__ __align__(16) float smem[];

  const int split = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int H = hkv * G;
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

  // partial (b, h, split) for h = kh * G + g
  const int64_t row0 = static_cast<int64_t>(b) * H + static_cast<int64_t>(kh) * G;
  if (nv == 0) {  // wholly masked split: no K/V read
    for (int e = tid; e < G * d; e += kThreads) {
      const int g = e / d;
      acc_out[((row0 + g) * nsplit + split) * d + e % d] = 0.0f;
    }
    for (int g = tid; g < G; g += kThreads) {
      m_out[(row0 + g) * nsplit + split] = kNegInf;
      l_out[(row0 + g) * nsplit + split] = 0.0f;
    }
    return;
  }

  float* s_sh = smem;                                   // G x block_s
  float* red_sh = s_sh + static_cast<int64_t>(G) * block_s;  // warps x rows x d
  float* m_sh = red_sh + kWarps * kRows * d;            // G
  float* l_sh = m_sh + G;                               // G

  const T* kbase = k + b * ksb + s0 * kss + kh * ksh;
  const T* vbase = v + b * vsb + s0 * vss + kh * vsh;

  // ---- 1. scores s[g][pos] = (q_g . k_pos) * scale ------------------------
  for (int g0 = 0; g0 < G; g0 += kRows) {
    float qr[kRows][E];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < CPL; ++c)
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const int j = (tl + c * TPR) * VEC + i;
          qr[r][c * VEC + i] = (g0 + r < G && j < d)
                                   ? q[(row0 + g0 + r) * d + j]
                                   : 0.0f;
        }
    // the loop bound is uniform across the warp (shuffles below)
    for (int wb = warp * P; wb < nv; wb += kStep * kUnroll) {
      float kr[kUnroll][E];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int pos = wb + u * kStep + slot;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int j = (tl + c * TPR) * VEC;
          if (pos < nv && j < d) {
            load_vec<T, VEC>(kbase + pos * kss + j, &kr[u][c * VEC]);
          } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) kr[u][c * VEC + i] = 0.0f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float dot[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float acc = 0.0f;
#pragma unroll
          for (int e = 0; e < E; ++e) acc = __fmaf_rn(qr[r][e], kr[u][e], acc);
#pragma unroll
          for (int off = TPR / 2; off > 0; off >>= 1)
            acc += __shfl_xor_sync(kFull, acc, off);
          dot[r] = acc;
        }
        const int pos = wb + u * kStep + slot;
        if (tl == 0 && pos < nv) {
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            if (g0 + r < G) s_sh[(g0 + r) * block_s + pos] = dot[r] * scale;
        }
      }
    }
  }
  __syncthreads();

  // ---- 2. per row: m = max s, p = exp(s - m) (in place), l = sum p --------
  for (int g = warp; g < G; g += kWarps) {
    float* sg = s_sh + g * block_s;
    float mx = kNegInf;
    for (int p = lane; p < nv; p += 32) mx = fmaxf(mx, sg[p]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    float sum = 0.0f;
    for (int p = lane; p < nv; p += 32) {
      const float e = expf(sg[p] - mx);
      sg[p] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(kFull, sum, off);
    if (lane == 0) {
      m_sh[g] = mx;
      l_sh[g] = sum;
    }
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    m_out[(row0 + g) * nsplit + split] = m_sh[g];
    l_out[(row0 + g) * nsplit + split] = l_sh[g];
  }

  // ---- 3. acc[g][:] = sum_pos p[g][pos] * v_pos ----------------------------
  for (int g0 = 0; g0 < G; g0 += kRows) {
    float acc[kRows][E];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] = 0.0f;
    for (int wb = warp * P; wb < nv; wb += kStep * kUnroll) {
      float vr[kUnroll][E];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int pos = wb + u * kStep + slot;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int j = (tl + c * TPR) * VEC;
          if (pos < nv && j < d) {
            load_vec<T, VEC>(vbase + pos * vss + j, &vr[u][c * VEC]);
          } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) vr[u][c * VEC + i] = 0.0f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int pos = wb + u * kStep + slot;
        if (pos < nv) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float p = g0 + r < G ? s_sh[(g0 + r) * block_s + pos] : 0.0f;
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[r][e] = __fmaf_rn(p, vr[u][e], acc[r][e]);
          }
        }
      }
    }
    // fold the warp's P position slots, then the warps, in a fixed order
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int e = 0; e < E; ++e)
#pragma unroll
        for (int off = TPR; off < 32; off <<= 1)
          acc[r][e] += __shfl_xor_sync(kFull, acc[r][e], off);
    if (slot == 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < CPL; ++c)
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const int j = (tl + c * TPR) * VEC + i;
            if (j < d) red_sh[(warp * kRows + r) * d + j] = acc[r][c * VEC + i];
          }
    }
    __syncthreads();
    for (int e = tid; e < kRows * d; e += kThreads) {
      const int r = e / d;
      const int j = e % d;
      if (g0 + r >= G) continue;
      float s = red_sh[r * d + j];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) s += red_sh[(w * kRows + r) * d + j];
      acc_out[((row0 + g0 + r) * nsplit + split) * d + j] = s;
    }
    __syncthreads();
  }
}

// One CTA per (query head, batch), thread t owns element t of d.  The
// weights exp(m_i - m*) and the l_i of a chunk of splits are staged in
// shared memory by all threads at once, so the per-thread fold over the
// splits is a run of independent coalesced loads of acc_i.
template <typename O>
__global__ void flash_combine_kernel(const float* __restrict__ m_part,
                                     const float* __restrict__ l_part,
                                     const float* __restrict__ acc_part,
                                     int nsplit, float* m_c, float* l_c,
                                     float* acc_c, O* out, int64_t osb,
                                     int64_t osh, int H, int d,
                                     int normalise) {
  __shared__ float w_sh[kCombineChunk];
  __shared__ float l_sh[kCombineChunk];
  __shared__ float red_sh[kCombineThreadsMax / 32];
  __shared__ float l_fold;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int nwarps = blockDim.x / 32;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  const float* mp = m_part + bh * nsplit;
  const float* lp = l_part + bh * nsplit;
  const float* ap = acc_part + bh * nsplit * d;
  const bool carry = m_c != nullptr;

  // m* = max over the carry and the splits (max is exact in any order)
  float mx = carry ? m_c[bh] : mp[0];
  for (int i = t; i < nsplit; i += blockDim.x) mx = fmaxf(mx, mp[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  if ((t & 31) == 0) red_sh[t >> 5] = mx;
  __syncthreads();
  float m_star = red_sh[0];
  for (int w = 1; w < nwarps; ++w) m_star = fmaxf(m_star, red_sh[w]);

  // the fold, in the order carry, split 0, split 1, ...
  float l = 0.0f;
  float a = 0.0f;
  if (carry) {
    const float w = expf(m_c[bh] - m_star);
    l = __fmul_rn(l_c[bh], w);
    if (t < d) a = __fmul_rn(acc_c[bh * d + t], w);
  }
  for (int i0 = 0; i0 < nsplit; i0 += kCombineChunk) {
    const int n = min(kCombineChunk, nsplit - i0);
    __syncthreads();  // the previous chunk's weights are no longer read
    for (int i = t; i < n; i += blockDim.x) {
      w_sh[i] = expf(mp[i0 + i] - m_star);
      l_sh[i] = lp[i0 + i];
    }
    __syncthreads();
    if (t == 0)
      for (int i = 0; i < n; ++i) l = __fadd_rn(l, __fmul_rn(l_sh[i], w_sh[i]));
    if (t < d) {
      const float* ai = ap + static_cast<int64_t>(i0) * d + t;
#pragma unroll 16
      for (int i = 0; i < n; ++i)
        a = __fadd_rn(a, __fmul_rn(ai[static_cast<int64_t>(i) * d], w_sh[i]));
    }
  }
  if (t == 0) l_fold = l;
  __syncthreads();  // also: every thread has read m_c / l_c / acc_c
  l = l_fold;
  if (normalise) {
    if (t < d)
      out[b * osb + h * osh + t] = from_f32<O>(__fdiv_rn(a, fmaxf(l, 1e-20f)));
    return;
  }
  if (t < d) acc_c[bh * d + t] = a;
  if (t == 0) {
    m_c[bh] = m_star;
    l_c[bh] = l;
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

template <typename T, int VEC, int TPR, int CPL>
cudaError_t launch_partial(const PartialArgs& a, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(a.G) * a.block_s + kWarps * kRows * a.d + 2 * a.G) *
      sizeof(float);
  auto kern = flash_partial_kernel<T, VEC, TPR, CPL>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(static_cast<unsigned>(a.nsplit),
                  static_cast<unsigned>(a.hkv), static_cast<unsigned>(a.B));
  kern<<<grid, kThreads, smem, stream>>>(
      a.q, static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.length,
      a.len_all, a.m, a.l, a.acc, a.S, a.d, a.hkv, a.G, a.block_s, a.nsplit,
      a.ksb, a.kss, a.ksh, a.vsb, a.vss, a.vsh, a.scale);
  return cudaGetLastError();
}

// Picks the lane layout: 16-byte chunks when the wrapper allows them (d and
// every stride a multiple of the chunk, pointers 16-byte aligned), with 16
// or 32 lanes per position; otherwise one element per load, 32 lanes.
template <typename T>
cudaError_t dispatch_partial(const PartialArgs& a, int vec, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (a.d < 1 || a.d > 256) return cudaErrorInvalidValue;
  if (!vec) return launch_partial<T, 1, 32, 8>(a, s);
  if (a.d % V != 0) return cudaErrorInvalidValue;
  const int chunks = a.d / V;
  if (chunks <= 16) return launch_partial<T, V, 16, 1>(a, s);
  if (chunks <= 32) return launch_partial<T, V, 32, 1>(a, s);
  if constexpr (V == 4) return launch_partial<T, V, 32, 2>(a, s);  // f32
  return cudaErrorInvalidValue;  // unreachable: 16-bit d <= 256 fits above
}

template <typename O>
cudaError_t launch_combine(const float* m, const float* l, const float* acc,
                           int nsplit, float* m_c, float* l_c, float* acc_c,
                           void* out, int64_t osb, int64_t osh, int64_t B,
                           int H, int d, int normalise, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(H), static_cast<unsigned>(B));
  const int threads = ((d + 31) / 32) * 32;
  flash_combine_kernel<O><<<grid, threads, 0, stream>>>(
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
  if (d < 1 || d > kCombineThreadsMax || (mc == nullptr && nsplit < 1) ||
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
