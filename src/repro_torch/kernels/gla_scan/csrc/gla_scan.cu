// Chunked gated linear-attention scan for Hopper, sm_90a: RWKV6 ("rwkv" mode:
// per-channel decay, exclusive read, strictly causal intra term, bonus u)
// and Mamba2/SSD ("ssd" mode: inclusive read), with a (K, V) float32 state
// carried across chunks from zero, and the final state written once.
//
// Replaces the TPU kernel repro/kernels/gla_scan/kernel.py::gla_scan_pallas
// (body _gla_kernel). Same function, per chunk of C tokens, in float32:
//
//   L      = cumsum(log_w over the chunk)        L_read = L - log_w | L
//   o      = (q * exp(L_read)) @ S                                  inter
//          + att @ v,  att[t,j] = sum_k q[t,k] k[j,k] exp(L_read[t,k] - L[j,k])
//            for j < t (rwkv) | j <= t (ssd)                       intra
//          + (sum_k q u k)[t] * v[t]                          rwkv bonus
//   S      = exp(Lc)^T * S + (k * exp(Lc - L))^T @ v,   Lc = L[last]
//
// Translation. The TPU kernel walks the chunks on a sequential ("arbitrary")
// grid axis and keeps S in VMEM scratch. Here one CTA per (batch, head)
// walks every chunk of its sequence in order and keeps S in shared memory
// (16 KB at K = V = 64). The TPU kernel builds the (C, C, K) pairwise
// log-difference tensor in VMEM (4 MB at C = 128, K = 64); here each
// (t, j) pair's sum over k is one thread's loop, so nothing of that size
// exists, and exp is taken only on the pairs the causal mask keeps: on the
// masked pairs L_read[t] - L[j] is positive and can reach +inf under strong
// decay, and 0 * inf would be NaN. The kernel uses its own chunk tile,
// C = 32 (the `chunk` argument of the wrapper only exists for signature
// parity; the chunk changes rounding only). A smaller tile costs fewer
// exps (the intra term grows with C, the inter term and the update do not)
// and keeps cumulative log decays, and so their rounding, smaller. q, k, v,
// L, L_read, the attention tile and S take 62 KB of dynamic shared memory
// at K = V = 64.
// Inputs and outputs stay in the model layout (B, T, H, .): the kernel
// reads its head's rows with strides, so the wrapper copies nothing. A
// ragged last chunk is masked here: past T, q = k = v = 0 and log_w = 0
// (no decay), which leaves S exact, and no output row is written.
//
// What bounds it on this card. By bytes (q, k, v once, float32 log_w once,
// o and the final state once): ~51 MB at B=1, T=2048, H=32, K=V=64, bf16,
// ~15 us at 3.35 TB/s; the matrix products are ~2 GFLOP. What this design
// pays instead is the ~T * C/2 * K exps of the intra term per head (65 M
// over the 32 heads at the served shape) on CUDA cores in float32, on only
// B * H CTAs (32 of 132 SMs for one RWKV6 prefill). Held back: no tensor
// cores for the three products, full-precision expf, no split of the work
// of one head across CTAs, no cp.async prefetch of the next chunk.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// One CTA per (batch, head) leaves most SMs empty and every thread's sums
// are chains of dependent shared-memory reads: 1024 threads (32 warps) hide
// more of that latency than 256 (times of both in PERF.md). Needs
// THREADS >= K + CHUNK (step b).
constexpr int THREADS = 1024;
constexpr int CHUNK = 32;         // tokens per chunk tile
constexpr int CP = CHUNK + 1;     // padded row of the transposed k and L tiles
constexpr int KMAX = 64;          // K, V: multiples of 16 up to 64

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

size_t smem_floats(int K, int V) {
  return 2 * (size_t)CHUNK * K        // q (later q * exp(L_read)), L_read: [t][k]
         + 2 * (size_t)K * CP         // k (later k * exp(Lc - L)), L: [k][t]
         + (size_t)CHUNK * V          // v: [t][v]
         + (size_t)K * V              // state S: [k][v]
         + (size_t)CHUNK * CHUNK      // att: [t][j]
         + CHUNK;                     // bonus: [t]
}

// q, k, log_w: (B, T, H, K); v, o: (B, T, H, V); u: (H, K) float32 or null;
// state_out: (B, H, K, V) float32. grid: (H, B); block: THREADS.
template <typename T_IN>
__global__ void __launch_bounds__(THREADS)
gla_scan_kernel(const T_IN* __restrict__ q, const T_IN* __restrict__ k,
                const T_IN* __restrict__ v, const float* __restrict__ log_w,
                const float* __restrict__ u, T_IN* __restrict__ o,
                float* __restrict__ state_out, int T, int H, int K, int V,
                int rwkv) {
  extern __shared__ float smem[];
  float* q_s = smem;                       // [CHUNK][K]
  float* lr_s = q_s + CHUNK * K;           // [CHUNK][K]
  float* kt_s = lr_s + CHUNK * K;          // [K][CP]
  float* lt_s = kt_s + K * CP;             // [K][CP]
  float* v_s = lt_s + K * CP;              // [CHUNK][V]
  float* s_s = v_s + CHUNK * V;            // [K][V]
  float* att_s = s_s + K * V;              // [CHUNK][CHUNK]
  float* bonus_s = att_s + CHUNK * CHUNK;  // [CHUNK]

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const bool has_u = rwkv && u != nullptr;
  for (int i = tid; i < K * V; i += THREADS) s_s[i] = 0.f;

  for (int t0 = 0; t0 < T; t0 += CHUNK) {
    // a. load the chunk; rows past T are q = k = v = 0, log_w = 0
    for (int i = tid; i < CHUNK * K; i += THREADS) {
      const int t = i / K, kk = i - t * K;
      float qx = 0.f, kx = 0.f, lw = 0.f;
      if (t0 + t < T) {
        const size_t g = (((size_t)b * T + t0 + t) * H + h) * K + kk;
        qx = to_f(q[g]);
        kx = to_f(k[g]);
        lw = log_w[g];
      }
      q_s[t * K + kk] = qx;
      kt_s[kk * CP + t] = kx;
      lt_s[kk * CP + t] = lw;
    }
    for (int i = tid; i < CHUNK * V; i += THREADS) {
      const int t = i / V, vv = i - t * V;
      v_s[i] = t0 + t < T ? to_f(v[(((size_t)b * T + t0 + t) * H + h) * V + vv])
                          : 0.f;
    }
    __syncthreads();

    // b. cumulative log decay per channel (threads < K) and the bonus
    //    sum_k q u k per token (threads K .. K + CHUNK)
    if (tid < K) {
      float acc = 0.f;
      for (int t = 0; t < CHUNK; ++t) {
        const float lw = lt_s[tid * CP + t];
        acc += lw;
        lt_s[tid * CP + t] = acc;
        lr_s[t * K + tid] = rwkv ? acc - lw : acc;
      }
    } else if (tid < K + CHUNK) {
      const int t = tid - K;
      float acc = 0.f;
      if (has_u)
        for (int kk = 0; kk < K; ++kk)
          acc = fmaf(q_s[t * K + kk] * u[h * K + kk], kt_s[kk * CP + t], acc);
      bonus_s[t] = acc;
    }
    __syncthreads();

    // c. intra-chunk attention, exp only on the pairs the mask keeps
    for (int i = tid; i < CHUNK * CHUNK; i += THREADS) {
      const int t = i / CHUNK, j = i - t * CHUNK;
      float acc = 0.f;
      if (rwkv ? j < t : j <= t) {
        const float* qr = q_s + t * K;
        const float* lr = lr_s + t * K;
#pragma unroll 8
        for (int kk = 0; kk < K; ++kk)
          acc = fmaf(qr[kk] * kt_s[kk * CP + j],
                     expf(lr[kk] - lt_s[kk * CP + j]), acc);
      }
      att_s[i] = acc;
    }
    __syncthreads();

    // d. q * exp(L_read) for the inter term; k * exp(Lc - L) for the update
    for (int i = tid; i < CHUNK * K; i += THREADS) {
      q_s[i] *= expf(lr_s[i]);
      const int kk = i / CHUNK, t = i - kk * CHUNK;
      kt_s[kk * CP + t] *= expf(lt_s[kk * CP + CHUNK - 1] - lt_s[kk * CP + t]);
    }
    __syncthreads();

    // e. o = q_sc @ S + att @ v + bonus * v
    for (int i = tid; i < CHUNK * V; i += THREADS) {
      const int t = i / V, vv = i - t * V;
      if (t0 + t >= T) continue;
      float acc = 0.f;
      for (int kk = 0; kk < K; ++kk) acc = fmaf(q_s[t * K + kk], s_s[kk * V + vv], acc);
      const int jmax = rwkv ? t : t + 1;
      for (int j = 0; j < jmax; ++j) acc = fmaf(att_s[t * CHUNK + j], v_s[j * V + vv], acc);
      acc = fmaf(bonus_s[t], v_s[t * V + vv], acc);
      store(o + (((size_t)b * T + t0 + t) * H + h) * V + vv, acc);
    }
    __syncthreads();

    // f. S = exp(Lc)^T * S + k_dec^T @ v
    for (int i = tid; i < K * V; i += THREADS) {
      const int kk = i / V, vv = i - kk * V;
      float acc = expf(lt_s[kk * CP + CHUNK - 1]) * s_s[i];
      for (int j = 0; j < CHUNK; ++j) acc = fmaf(kt_s[kk * CP + j], v_s[j * V + vv], acc);
      s_s[i] = acc;
    }
    __syncthreads();
  }

  float* so = state_out + ((size_t)b * H + h) * K * V;
  for (int i = tid; i < K * V; i += THREADS) so[i] = s_s[i];
}

template <typename T_IN>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* log_w, const float* u, void* o,
                   float* state_out, int B, int T, int H, int K, int V,
                   int rwkv, cudaStream_t stream) {
  const size_t bytes = smem_floats(K, V) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gla_scan_kernel<T_IN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  gla_scan_kernel<T_IN><<<dim3(H, B), THREADS, bytes, stream>>>(
      static_cast<const T_IN*>(q), static_cast<const T_IN*>(k),
      static_cast<const T_IN*>(v), log_w, u, static_cast<T_IN*>(o),
      state_out, T, H, K, V, rwkv);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 for q, k, v and o; log_w and u are
// float32; u may be null (no bonus). mode_rwkv: 1 = rwkv, 0 = ssd.
// Returns the CUDA error code of the launch (0 on success).
int gla_scan_fwd(const void* q, const void* k, const void* v,
                 const float* log_w, const float* u, void* o,
                 float* state_out, int B, int T, int H, int K, int V,
                 int mode_rwkv, int dtype, void* stream) {
  if (K % 16 != 0 || V % 16 != 0 || K < 16 || V < 16 || K > KMAX ||
      V > KMAX || T < 1 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, log_w, u, o, state_out, B, T, H, K, V,
                              mode_rwkv, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, log_w, u, o, state_out, B, T,
                                      H, K, V, mode_rwkv, st);
  return (int)cudaErrorInvalidValue;
}

const char* gla_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
