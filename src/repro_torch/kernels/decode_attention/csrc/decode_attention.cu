// Split-K flash-decoding for Hopper, sm_90a: one query token per sequence
// against its KV cache.
//
// Replaces the TPU kernel repro/kernels/decode_attention/kernel.py::
// decode_attention_pallas (body _decode_kernel). Same function: per-sequence
// lengths; cache slot t is valid while t < length, or t < min(length,
// window) for a ring (sliding-window) cache; the G = H / KV query heads of one
// KV head share every K/V row they read; float32 softmax statistics and
// accumulator; output in the input dtype.
//
// Translation. The TPU kernel walks the cache in 512-slot blocks in order on
// one core and carries (m, l, acc) in VMEM scratch. Here the cache of each
// (sequence, KV head) is cut into splits of `chunk` slots that run as
// separate CTAs (grid: n_split x KV x B), which is the GPU form the TPU
// kernel's own docstring names. Pass 1 writes each split's partial (m, l,
// acc) in float32 to scratch the wrapper allocates; pass 2 combines the
// partials of a (sequence, KV head) by log-sum-exp. A split that lies past
// the sequence's valid slots reads nothing and is marked with l = 0, and the
// combine skips it, so it contributes nothing (no exp(-1e30 - -1e30) = 1).
//
// What bounds it on this card. Each valid slot's K and V rows are read once
// (2 * KV * D elements per slot) for about 4 * G * D FLOP per KV head: far
// below the ~295 FLOP/byte ridge, so the kernel is bound by memory, by the
// bytes of K and V up to each sequence's length. The design reads only those
// bytes (ragged sequences launch splits that exit at once), reads each row as
// one coalesced warp-wide load, and keeps several rows in flight per warp.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;     // cache rows each warp loads before it computes
constexpr int DMAX = 128;     // each lane holds 4 of the D <= 128 channels
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ int valid_slots(const int* lengths, int b, int W,
                                           int window) {
  int n = lengths[b];
  if (window > 0) n = min(n, window);
  return max(0, min(n, W));
}

// Pass 1. q: (B, 1, H, D) with h = kvh * G + g; caches: (B, W, KV, D).
// Partials: m, l (B, KV, n_split, G); acc (B, KV, n_split, G, D), unnormalised.
// grid: (n_split, KV, B); block: THREADS. GMAX >= G.
template <typename TQ, typename TC, int GMAX>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const TQ* __restrict__ q, const TC* __restrict__ kc,
                    const TC* __restrict__ vc, const int* __restrict__ lengths,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int W, int KV, int G, int D,
                    int chunk, float scale, int window) {
  __shared__ float sm_m[WARPS][GMAX], sm_l[WARPS][GMAX];
  __shared__ float sm_acc[WARPS][GMAX][DMAX];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = split * chunk;
  const int t1 = min(t0 + chunk, valid_slots(lengths, b, W, window));
  const size_t part = ((size_t)b * KV + kvh) * gridDim.x + split;
  float* pm = part_m + part * G;
  float* pl = part_l + part * G;
  float* pa = part_acc + part * G * D;
  if (t0 >= t1) {  // nothing valid here: mark the split empty
    if (tid < G) {
      pm[tid] = NEG_INF;
      pl[tid] = 0.f;
    }
    return;
  }

  const int d0 = 4 * lane;
  const bool active = d0 < D;
  float qv[GMAX][4];
  const TQ* qb = q + ((size_t)b * KV + kvh) * G * D + d0;
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G && active) {
      load4(qb + (size_t)g * D, qv[g]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) qv[g][e] = 0.f;
    }
  }

  float m[GMAX], l[GMAX], acc[GMAX][4];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
  }

  const size_t row = (size_t)KV * D;  // elements between consecutive slots
  const TC* kb = kc + (size_t)b * W * row + (size_t)kvh * D + d0;
  const TC* vb = vc + (size_t)b * W * row + (size_t)kvh * D + d0;

  for (int t = t0 + warp * UNROLL; t < t1; t += WARPS * UNROLL) {
    float kx[UNROLL][4], vx[UNROLL][4];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (t + u < t1 && active) {
        load4(kb + (size_t)(t + u) * row, kx[u]);
        load4(vb + (size_t)(t + u) * row, vx[u]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) kx[u][e] = vx[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (t + u >= t1) break;  // warp-uniform
      float s[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        s[g] = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) s[g] = fmaf(qv[g][e], kx[u][e], s[g]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= G) break;
        const float sc = s[g] * scale;
        const float m_new = fmaxf(m[g], sc);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(sc - m_new);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] = fmaf(p, vx[u][e], acc[g][e] * alpha);
        m[g] = m_new;
      }
    }
  }

  // merge the warps' partials; a warp that saw no slot has l == 0
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
  if (active) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) sm_acc[warp][g][d0 + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i - g * D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      if (sm_l[w][g] > 0.f) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      if (sm_l[w][g] > 0.f) {
        const float f = expf(sm_m[w][g] - M);
        L = fmaf(sm_l[w][g], f, L);
        A = fmaf(sm_acc[w][g][d], f, A);
      }
    }
    pa[(size_t)g * D + d] = A;
    if (d == 0) {
      pm[g] = M;
      pl[g] = L;
    }
  }
}

// Pass 2. out: (B, 1, H, D). grid: (KV, B); block: THREADS.
template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_combine_kernel(const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const float* __restrict__ part_acc, T* __restrict__ out,
                      int KV, int G, int D, int n_split) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  const size_t base = ((size_t)b * KV + kvh) * n_split;
  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    const int g = i / D, d = i - g * D;
    float M = NEG_INF;
    for (int s = 0; s < n_split; ++s) {
      const size_t ps = (base + s) * G + g;
      if (part_l[ps] > 0.f) M = fmaxf(M, part_m[ps]);
    }
    float L = 0.f, A = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const size_t ps = (base + s) * G + g;
      const float ls = part_l[ps];
      if (ls > 0.f) {  // empty splits left their acc unwritten: never read it
        const float f = expf(part_m[ps] - M);
        L = fmaf(ls, f, L);
        A = fmaf(part_acc[ps * D + d], f, A);
      }
    }
    store(out + (((size_t)b * KV + kvh) * G + g) * D + d, A / fmaxf(L, 1e-37f));
  }
}

template <typename TQ, typename TC, int GMAX>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const int* lengths, void* out, float* part_m,
                   float* part_l, float* part_acc, int B, int W, int KV,
                   int G, int D, int chunk, int n_split, float scale,
                   int window, cudaStream_t stream) {
  decode_split_kernel<TQ, TC, GMAX><<<dim3(n_split, KV, B), THREADS, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(kc),
      static_cast<const TC*>(vc), lengths, part_m, part_l, part_acc, W, KV, G,
      D, chunk, scale, window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<TQ><<<dim3(KV, B), THREADS, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<TQ*>(out), KV, G, D, n_split);
  return cudaGetLastError();
}

template <typename TQ, typename TC>
cudaError_t dispatch(const void* q, const void* kc, const void* vc,
                     const int* lengths, void* out, float* part_m,
                     float* part_l, float* part_acc, int B, int W, int KV,
                     int G, int D, int chunk, int n_split, float scale,
                     int window, cudaStream_t stream) {
#define REPRO_DECODE_LAUNCH(GM)                                              \
  return launch<TQ, TC, GM>(q, kc, vc, lengths, out, part_m, part_l, part_acc, B, \
                       W, KV, G, D, chunk, n_split, scale, window, stream)
  if (G <= 1) REPRO_DECODE_LAUNCH(1);
  if (G <= 2) REPRO_DECODE_LAUNCH(2);
  if (G <= 4) REPRO_DECODE_LAUNCH(4);
  REPRO_DECODE_LAUNCH(8);
#undef REPRO_DECODE_LAUNCH
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. q and out share q_dtype; the two
// caches share cache_dtype (a float32 model keeps a bfloat16 cache, as the
// reference does). window <= 0: no sliding window.
// Scratch: part_m, part_l (B*KV*n_split*G floats), part_acc (times D).
// Returns the CUDA error code of the launches (0 on success).
int decode_attention_fwd(const void* q, const void* k_cache,
                         const void* v_cache, const int* lengths, void* out,
                         float* part_m, float* part_l, float* part_acc, int B,
                         int W, int KV, int G, int D, int chunk, int n_split,
                         float scale, int window, int q_dtype,
                         int cache_dtype, void* stream) {
  if (D % 16 != 0 || D > DMAX || G < 1 || G > 8 || chunk < 1 ||
      (long long)n_split * chunk < W)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_DECODE_DISPATCH(TQ, TC)                                        \
  return (int)dispatch<TQ, TC>(q, k_cache, v_cache, lengths, out, part_m,    \
                               part_l, part_acc, B, W, KV, G, D, chunk,      \
                               n_split, scale, window, st)
  if (q_dtype == 0 && cache_dtype == 0) REPRO_DECODE_DISPATCH(float, float);
  if (q_dtype == 1 && cache_dtype == 1)
    REPRO_DECODE_DISPATCH(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == 0 && cache_dtype == 1)
    REPRO_DECODE_DISPATCH(float, __nv_bfloat16);
#undef REPRO_DECODE_DISPATCH
  return (int)cudaErrorInvalidValue;
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
