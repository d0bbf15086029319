// The MoE layer's capacity dispatch and gate-weighted combine, for Hopper,
// sm_90a.
//
// Replaces no Pallas kernel: the reference leaves the dispatch to XLA's
// gathers and scatters (repro/models/moe.py::_dispatch_row, _combine_row),
// and the port's plain version (ref.py, the old models/moe.py
// _dispatch_rows and _combine_rows) runs some 40 PyTorch operations a layer:
// a stable argsort, a scatter_add, a cumsum, five gathers, a scatter, two
// wheres, a float32 cast, a product and a sum.
//
// Semantics, per batch row of S tokens with K experts each (idx (B, S, K)),
// E experts of capacity C: assignment j = s K + k takes place pos(j) in its
// expert e = idx[s, k], where pos(j) counts the assignments to e earlier in
// flat order (a stable sort by expert); it is kept iff pos(j) < C, in slot
// e C + pos(j). The buffer (B, E, C, D) holds x[s] in each kept slot and
// zeros elsewhere; slot (B, S K) is e C + pos or E C when dropped, kept
// (B, S K) the mask, size (B, E) each expert's assignments. The combine:
// out[s] = sum over k = 0..K-1 in that order of gate[s, k] * buf[slot] for
// kept k, in float32, written once in the output's dtype.
//
// What bounds them on this card: bytes. Neither does arithmetic worth the
// name (the combine K multiply-adds an element). At Qwen3-MoE's mean pool
// prompt (S = 4431, K = 8, E = 128, C = 352, D = 2048, bf16) the buffer is
// 184.5 MB: the dispatch has to write it once and read each kept row once
// (0.33 GB), the combine read S K rows once and write S D once (0.16 GB);
// the plain chain moves 2.5-3 GB a layer through unfused passes. So:
//
//   moe_count_kernel  (prefill only: more than CHUNK assignments a row)
//     one block a chunk of CHUNK assignments, its experts counted in a
//     shared-memory histogram (a warp's equal experts found by
//     __match_any_sync, their leader adds the count), written per chunk.
//   moe_rank_kernel   one block a chunk: the experts' counts in earlier
//     chunks summed (the scan over chunks), then ranks in flat order within
//     the chunk without atomics: each warp's lanes of one expert rank among
//     themselves by match and popc, each warp writes its count per expert
//     into a [warp][expert] table, and one thread an expert turns its column
//     into an exclusive prefix over the warps. Writes slot and kept, the
//     slot's assignment (src, int32 scratch, B E C) for each kept one, and
//     from the row's last chunk, which has seen every count, size and -1 in
//     src for every empty slot.
//   moe_fill_kernel   one warp a slot row: the row of x its assignment
//     names, 16 bytes a lane, or zeros; each slot written once, no
//     dependence on the order the warps run in.
//   moe_combine_kernel  one block a token (and a span of D): the token's K
//     slots, gates and masks staged in shared memory, then each thread reads
//     the K kept rows' 16-byte vectors (eight at a time, all loads issued
//     before the sums) and adds gate * value in float32 in k order, with
//     __fmul_rn / __fadd_rn so that nothing is contracted into an FMA, and
//     stores the sum once in the output's dtype.
//
// Every row the kernels read or write moves in 16-byte words: the wrapper
// makes rows contiguous and holds every address, stride and row to a
// multiple of 16 bytes (D a multiple of 8 in bf16, of 4 in float32; the
// served widths are 2048 and 6144), and the library refuses the rest.
//
// A dispatch is three launches at prefill, two where a row's assignments fit
// one chunk (decode: B = 32 rows of S K = 8 take one block each); a combine
// is one. Their gradients reuse them: x's is a combine of the buffer's
// gradient with unit gates; the combine's (moe_combine_bwd) rebuilds src
// from slot and kept (moe_invert_kernel, over a -1-filled src), then fills
// each kept slot with gate * the output's gradient and zeros elsewhere, and
// the same warp takes the gate's gradient, the dot product of the slot's row
// of the combine's input with that gradient (a fixed shuffle tree: the same
// bits every launch).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int CHUNK = 1024;     // assignments a count / rank block takes, one a thread
// experts the rank block's [warp][expert] table and its column of bases hold
// in the 48 KB of shared memory a launch gets without opting in: 372
constexpr int MAX_E = 48 * 1024 / (static_cast<int>(sizeof(int)) * (CHUNK / 32 + 1));
constexpr int MAX_K = 64;       // experts a token, staged by a combine block
constexpr int FILL_WARPS = 8;   // slot rows a fill block writes, one a warp
constexpr int UNROLL = 4;       // 16-byte loads a lane has in flight in the fill
constexpr int KGROUP = 8;       // rows a combine thread loads before it adds
constexpr int COMBINE_THREADS = 128;

enum Dtype { F32 = 0, BF16 = 1 };

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The raw word of BYTES bytes that one load or store moves: 16 for a
// vector of the input, 8 or 32 for the same count of elements written in
// the other dtype.
struct alignas(32) Pair16 {
  uint4 lo, hi;
};
template <int BYTES> struct WordOf;
template <> struct WordOf<8> { using type = uint2; };
template <> struct WordOf<16> { using type = uint4; };
template <> struct WordOf<32> { using type = Pair16; };

// V elements of T held as one raw word, so that a load or store is one
// 16-byte access (a struct of __nv_bfloat16 members may be copied member by
// member); elements are read and written as float.
template <typename T, int V>
struct Vec {
  typename WordOf<sizeof(T) * V>::type w;
  __device__ __forceinline__ float get(int t) const {
    return to_f(reinterpret_cast<const T*>(&w)[t]);
  }
  __device__ __forceinline__ void set(int t, float f) {
    reinterpret_cast<T*>(&w)[t] = from_f<T>(f);
  }
};

// An expert outside [0, E) (the router never gives one) is dropped, not
// written out of bounds.
__device__ __forceinline__ int expert_of(const long long* __restrict__ idx,
                                         long long off, int E) {
  const long long e = idx[off];
  return (e >= 0 && e < E) ? static_cast<int>(e) : -1;
}

// counts[b][chunk][e]: the chunk's assignments to expert e.
__global__ void __launch_bounds__(CHUNK) moe_count_kernel(
    const long long* __restrict__ idx, long long sib, long long sis,
    long long sik, int S, int K, int E, int* __restrict__ counts) {
  extern __shared__ int hist[];
  const int b = blockIdx.y, chunk = blockIdx.x, tid = threadIdx.x;
  for (int e = tid; e < E; e += blockDim.x) hist[e] = 0;
  __syncthreads();
  const int j = chunk * CHUNK + tid;
  int e = -1;
  if (j < S * K) {
    const int s = j / K, k = j - s * K;
    e = expert_of(idx, b * sib + s * sis + k * sik, E);
  }
  const unsigned peers = __match_any_sync(0xffffffffu, e);
  if (e >= 0 && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&hist[e], __popc(peers));   // a count: its order changes no bit
  __syncthreads();
  int* out = counts + (static_cast<long long>(b) * gridDim.x + chunk) * E;
  for (int x = tid; x < E; x += blockDim.x) out[x] = hist[x];
}

// slot, kept, src (kept slots) for the chunk's assignments; the row's last
// chunk also writes size and src = -1 in the empty slots.
__global__ void __launch_bounds__(CHUNK) moe_rank_kernel(
    const long long* __restrict__ idx, long long sib, long long sis,
    long long sik, int S, int K, int E, int C,
    const int* __restrict__ counts, long long* __restrict__ slot,
    bool* __restrict__ kept, long long* __restrict__ size,
    int* __restrict__ src) {
  extern __shared__ int sm[];
  const int warps = blockDim.x / 32;
  int* table = sm;                 // [warp][expert]: counts, then offsets
  int* base = sm + warps * E;      // [expert]: earlier chunks, then the row's
  const int b = blockIdx.y, chunk = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int SK = S * K;
  const long long EC = static_cast<long long>(E) * C;
  for (int i = tid; i < warps * E; i += blockDim.x) table[i] = 0;
  for (int e = tid; e < E; e += blockDim.x) {
    int n = 0;
    for (int c = 0; c < chunk; ++c)
      n += counts[(static_cast<long long>(b) * gridDim.x + c) * E + e];
    base[e] = n;
  }
  __syncthreads();

  const int j = chunk * CHUNK + tid;
  int e = -1;
  if (j < SK) {
    const int s = j / K, k = j - s * K;
    e = expert_of(idx, b * sib + s * sis + k * sik, E);
  }
  const unsigned peers = __match_any_sync(0xffffffffu, e);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  if (e >= 0 && rank == 0) table[warp * E + e] = __popc(peers);
  __syncthreads();
  for (int x = tid; x < E; x += blockDim.x) {
    int run = base[x];
    for (int w = 0; w < warps; ++w) {
      const int n = table[w * E + x];
      table[w * E + x] = run;
      run += n;
    }
    base[x] = run;
  }
  __syncthreads();

  if (j < SK) {
    long long sl = EC;
    bool keep = false;
    if (e >= 0) {
      const int pos = table[warp * E + e] + rank;
      if (pos < C) {
        keep = true;
        sl = static_cast<long long>(e) * C + pos;
        src[b * EC + sl] = j;
      }
    }
    slot[static_cast<long long>(b) * SK + j] = sl;
    kept[static_cast<long long>(b) * SK + j] = keep;
  }
  if (chunk == gridDim.x - 1) {
    for (int x = tid; x < E; x += blockDim.x) size[static_cast<long long>(b) * E + x] = base[x];
    for (long long i = tid; i < EC; i += blockDim.x) {
      const int x = static_cast<int>(i / C), c = static_cast<int>(i - static_cast<long long>(x) * C);
      if (c >= base[x]) src[b * EC + i] = -1;
    }
  }
}

// buf row r = (b, e, c): x[b, src / K] in 16-byte words, or zeros where
// src < 0.
__global__ void __launch_bounds__(FILL_WARPS * 32) moe_fill_kernel(
    const char* __restrict__ x, long long sxb, long long sxs,
    const int* __restrict__ src, long long rows, long long EC, int K, int nw,
    uint4* __restrict__ buf) {
  using W = uint4;
  const long long r = static_cast<long long>(blockIdx.x) * FILL_WARPS + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const int j = src[r];
  W* dst = buf + r * nw;
  if (j < 0) {
    const W zero{};
    for (int w = lane; w < nw; w += 32) dst[w] = zero;
    return;
  }
  const W* row = reinterpret_cast<const W*>(x + (r / EC) * sxb + static_cast<long long>(j / K) * sxs);
  for (int w0 = lane; w0 < nw; w0 += 32 * UNROLL) {
    W v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (w0 + u * 32 < nw) v[u] = row[w0 + u * 32];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (w0 + u * 32 < nw) dst[w0 + u * 32] = v[u];
  }
}

// out[b, s] = sum_k gate * out_buf[b, slot / C, slot % C] over kept k, in
// k order, in float32; gates == nullptr: unit gates.
template <typename TI, typename TO, int V = static_cast<int>(16 / sizeof(TI))>
__global__ void __launch_bounds__(COMBINE_THREADS) moe_combine_kernel(
    const TI* __restrict__ ob, long long sob, long long soe, long long soc,
    const long long* __restrict__ slot, const bool* __restrict__ kept,
    const float* __restrict__ gates, long long sgb, long long sgs,
    long long sgk, int S, int K, int C, int D, TO* __restrict__ out) {
  __shared__ long long row_at[MAX_K];
  __shared__ float gate_of[MAX_K];
  const long long token = blockIdx.x;
  const long long b = token / S;
  const int s = static_cast<int>(token - b * S);
  if (threadIdx.x < K) {
    const int k = threadIdx.x;
    const long long j = b * S * K + static_cast<long long>(s) * K + k;
    const long long sl = slot[j];
    const bool on = kept[j];
    row_at[k] = on ? b * sob + (sl / C) * soe + (sl % C) * soc : -1;
    gate_of[k] = gates ? gates[b * sgb + s * sgs + k * sgk] : 1.0f;
  }
  __syncthreads();
  const int nvec = D / V;
  for (int v = blockIdx.y * blockDim.x + threadIdx.x; v < nvec; v += gridDim.y * blockDim.x) {
    float acc[V];
#pragma unroll
    for (int t = 0; t < V; ++t) acc[t] = 0.0f;
    for (int k0 = 0; k0 < K; k0 += KGROUP) {
      Vec<TI, V> in[KGROUP];
#pragma unroll
      for (int u = 0; u < KGROUP; ++u) {
        const int k = k0 + u;
        if (k < K && row_at[k] >= 0)
          in[u] = *reinterpret_cast<const Vec<TI, V>*>(ob + row_at[k] + static_cast<long long>(v) * V);
      }
#pragma unroll
      for (int u = 0; u < KGROUP; ++u) {
        const int k = k0 + u;
        if (k < K && row_at[k] >= 0) {
          const float g = gate_of[k];
#pragma unroll
          for (int t = 0; t < V; ++t) acc[t] = __fadd_rn(acc[t], __fmul_rn(g, in[u].get(t)));
        }
      }
    }
    Vec<TO, V> o;
#pragma unroll
    for (int t = 0; t < V; ++t) o.set(t, acc[t]);
    *reinterpret_cast<Vec<TO, V>*>(out + token * D + static_cast<long long>(v) * V) = o;
  }
}

// src[b, slot] = j for each kept assignment j (src filled with -1 before).
__global__ void moe_invert_kernel(const long long* __restrict__ slot,
                                  const bool* __restrict__ kept, long long n,
                                  int SK, long long EC, int* __restrict__ src) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x)
    if (kept[i]) src[(i / SK) * EC + slot[i]] = static_cast<int>(i % SK);
}

// The combine's gradients: grad_buf row r = (b, e, c) is gate[j] *
// grad_out[b, s] for its assignment j = s K + k, or zeros where src < 0;
// with GRAD, grad_gates[b, j] = sum_d ob[b, e, c, d] * grad_out[b, s, d].
template <typename T, bool GRAD, int V = static_cast<int>(16 / sizeof(T))>
__global__ void __launch_bounds__(FILL_WARPS * 32) moe_fill_grad_kernel(
    const T* __restrict__ go, long long sgob, long long sgos,
    const int* __restrict__ src, const float* __restrict__ gates,
    long long sgb, long long sgs, long long sgk, const T* __restrict__ ob,
    long long sob, long long soe, long long soc, long long rows,
    long long EC, int C, int S, int K, int D, T* __restrict__ grad_buf,
    float* __restrict__ grad_gates) {
  const long long r = static_cast<long long>(blockIdx.x) * FILL_WARPS + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const int nvec = D / V;
  const int j = src[r];
  Vec<T, V>* dst = reinterpret_cast<Vec<T, V>*>(grad_buf + r * D);
  if (j < 0) {
    Vec<T, V> zero;
#pragma unroll
    for (int t = 0; t < V; ++t) zero.set(t, 0.0f);
    for (int v = lane; v < nvec; v += 32) dst[v] = zero;
    return;
  }
  const long long b = r / EC, i = r - b * EC;
  const int s = j / K, k = j - s * K;
  const float g = gates[b * sgb + s * sgs + k * sgk];
  const Vec<T, V>* in = reinterpret_cast<const Vec<T, V>*>(go + b * sgob + s * sgos);
  const Vec<T, V>* row = reinterpret_cast<const Vec<T, V>*>(ob + b * sob + (i / C) * soe + (i % C) * soc);
  float dot = 0.0f;
  for (int v = lane; v < nvec; v += 32) {
    const Vec<T, V> a = in[v];
    Vec<T, V> o;
#pragma unroll
    for (int t = 0; t < V; ++t) o.set(t, __fmul_rn(g, a.get(t)));
    dst[v] = o;
    if (GRAD) {
      const Vec<T, V> w = row[v];
#pragma unroll
      for (int t = 0; t < V; ++t) dot = __fadd_rn(dot, __fmul_rn(w.get(t), a.get(t)));
    }
  }
  if (GRAD) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dot = __fadd_rn(dot, __shfl_xor_sync(0xffffffffu, dot, off));
    if (lane == 0) grad_gates[b * S * K + j] = dot;
  }
}

int ceil_div(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

// Whether every address and byte stride given is a multiple of 16.
bool aligned16(std::initializer_list<long long> v) {
  for (long long a : v)
    if (a % 16) return false;
  return true;
}

template <typename TI, typename TO>
void launch_combine(const void* ob, long long sob, long long soe, long long soc,
                    const long long* slot, const bool* kept, const float* gates,
                    long long sgb, long long sgs, long long sgk, int B, int S,
                    int K, int C, int D, void* out, cudaStream_t st) {
  const int nvec = D / static_cast<int>(16 / sizeof(TI));
  const int threads = nvec >= COMBINE_THREADS ? COMBINE_THREADS : ((nvec + 31) / 32) * 32;
  const dim3 grid(static_cast<unsigned>(static_cast<long long>(B) * S), ceil_div(nvec, threads));
  moe_combine_kernel<TI, TO><<<grid, threads, 0, st>>>(
      static_cast<const TI*>(ob), sob, soe, soc, slot, kept, gates, sgb, sgs,
      sgk, S, K, C, D, static_cast<TO*>(out));
}

template <typename T>
void launch_fill_grad(const void* go, long long sgob, long long sgos,
                      const int* src, const float* gates, long long sgb,
                      long long sgs, long long sgk, const void* ob,
                      long long sob, long long soe, long long soc,
                      long long rows, long long EC, int C, int S, int K, int D,
                      void* grad_buf, float* grad_gates, cudaStream_t st) {
  const int blocks = ceil_div(rows, FILL_WARPS);
  if (grad_gates)
    moe_fill_grad_kernel<T, true><<<blocks, FILL_WARPS * 32, 0, st>>>(
        static_cast<const T*>(go), sgob, sgos, src, gates, sgb, sgs, sgk,
        static_cast<const T*>(ob), sob, soe, soc, rows, EC, C, S, K, D,
        static_cast<T*>(grad_buf), grad_gates);
  else
    moe_fill_grad_kernel<T, false><<<blocks, FILL_WARPS * 32, 0, st>>>(
        static_cast<const T*>(go), sgob, sgos, src, gates, sgb, sgs, sgk,
        static_cast<const T*>(ob), sob, soe, soc, rows, EC, C, S, K, D,
        static_cast<T*>(grad_buf), nullptr);
}

}  // namespace

extern "C" {

int moe_dispatch_chunk(void) { return CHUNK; }
int moe_dispatch_max_experts(void) { return MAX_E; }
int moe_dispatch_max_top_k(void) { return MAX_K; }

// x (B, S, D) of esize-byte elements, strides sxb, sxs in elements, the last
// 1; idx (B, S, K) int64, strides in elements. Outputs contiguous: buf
// (B, E, C, D), slot and kept (B, S K), size (B, E); scratch: counts
// (B, chunks, E) int32 where S K > CHUNK (else unused), src (B, E C) int32.
// Returns the CUDA error of the launches (0 on success).
int moe_dispatch_fwd(const void* x, long long sxb, long long sxs, int esize,
                     const long long* idx, long long sib, long long sis,
                     long long sik, int B, int S, int K, int E, int C, int D,
                     int* counts, int* src, void* buf, long long* slot,
                     bool* kept, long long* size, void* stream) {
  const long long row_bytes = static_cast<long long>(D) * esize;
  if (B < 0 || S < 0 || K < 1 || E < 1 || E > MAX_E || C < 1 || D < 0 || esize < 1 ||
      !aligned16({reinterpret_cast<long long>(x), sxb * esize, sxs * esize, row_bytes}))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int SK = S * K;
  const int chunks = SK > CHUNK ? ceil_div(SK, CHUNK) : 1;
  const int threads = SK > CHUNK ? CHUNK : (SK > 0 ? ((SK + 31) / 32) * 32 : 32);
  if (chunks > 1) {
    moe_count_kernel<<<dim3(chunks, B), CHUNK, E * sizeof(int), st>>>(
        idx, sib, sis, sik, S, K, E, counts);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t smem = (static_cast<size_t>(threads / 32) * E + E) * sizeof(int);
  moe_rank_kernel<<<dim3(chunks, B), threads, smem, st>>>(
      idx, sib, sis, sik, S, K, E, C, counts, slot, kept, size, src);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long EC = static_cast<long long>(E) * C;
  const long long rows = B * EC;
  if (row_bytes == 0) return 0;
  moe_fill_kernel<<<ceil_div(rows, FILL_WARPS), FILL_WARPS * 32, 0, st>>>(
      static_cast<const char*>(x), sxb * esize, sxs * esize, src, rows, EC, K,
      static_cast<int>(row_bytes / 16), static_cast<uint4*>(buf));
  return static_cast<int>(cudaGetLastError());
}

// out (B, S, D) contiguous, of out_dtype, = the gate-weighted sum of each
// token's kept rows of ob (B, E, C, D) of in_dtype (strides in elements, the
// last 1); gates (B, S, K) float32 or nullptr (unit gates).
int moe_combine_fwd(const void* ob, long long sob, long long soe, long long soc,
                    int in_dtype, const long long* slot, const bool* kept,
                    const float* gates, long long sgb, long long sgs,
                    long long sgk, int B, int S, int K, int C, int D, void* out,
                    int out_dtype, void* stream) {
  const int esize = in_dtype == BF16 ? 2 : 4;
  if (B < 0 || S < 0 || K < 1 || K > MAX_K || C < 1 || D < 0 ||
      !aligned16({reinterpret_cast<long long>(ob), sob * esize, soe * esize, soc * esize,
                  static_cast<long long>(D) * esize, reinterpret_cast<long long>(out)}))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || D == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define COMBINE(TI, TO) \
  launch_combine<TI, TO>(ob, sob, soe, soc, slot, kept, gates, sgb, sgs, sgk, B, S, K, C, D, out, st)
  if (in_dtype == BF16 && out_dtype == BF16) COMBINE(__nv_bfloat16, __nv_bfloat16);
  else if (in_dtype == BF16 && out_dtype == F32) COMBINE(__nv_bfloat16, float);
  else if (in_dtype == F32 && out_dtype == BF16) COMBINE(float, __nv_bfloat16);
  else if (in_dtype == F32 && out_dtype == F32) COMBINE(float, float);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef COMBINE
  return static_cast<int>(cudaGetLastError());
}

// The combine's gradients. go (B, S, D) and ob (B, E, C, D) of dtype (strides
// in elements, the last 1); slot, kept (B, S K) as the dispatch gave them;
// gates (B, S, K) float32. src (B, E C) int32 scratch filled with -1;
// grad_buf (B, E, C, D) contiguous; grad_gates (B, S, K) float32 contiguous
// and zeroed, or nullptr (not wanted).
int moe_combine_bwd(const void* go, long long sgob, long long sgos, int dtype,
                    const long long* slot, const bool* kept, const float* gates,
                    long long sgb, long long sgs, long long sgk, const void* ob,
                    long long sob, long long soe, long long soc, int B, int S,
                    int K, int E, int C, int D, int* src, void* grad_buf,
                    float* grad_gates, void* stream) {
  const int esize = dtype == BF16 ? 2 : 4;
  if (B < 0 || S < 0 || K < 1 || E < 1 || C < 1 || D < 0 ||
      !aligned16({reinterpret_cast<long long>(go), sgob * esize, sgos * esize,
                  reinterpret_cast<long long>(ob), sob * esize, soe * esize, soc * esize,
                  static_cast<long long>(D) * esize, reinterpret_cast<long long>(grad_buf)}))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || D == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long EC = static_cast<long long>(E) * C;
  const long long n = static_cast<long long>(B) * S * K;
  if (n > 0) {
    const int blocks = ceil_div(n, 256) < 4096 ? ceil_div(n, 256) : 4096;
    moe_invert_kernel<<<blocks, 256, 0, st>>>(slot, kept, n, S * K, EC, src);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long rows = B * EC;
#define FILL_GRAD(T)                                                                     \
  launch_fill_grad<T>(go, sgob, sgos, src, gates, sgb, sgs, sgk, ob, sob, soe, soc, rows, \
                      EC, C, S, K, D, grad_buf, grad_gates, st)
  if (dtype == BF16) FILL_GRAD(__nv_bfloat16);
  else if (dtype == F32) FILL_GRAD(float);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef FILL_GRAD
  return static_cast<int>(cudaGetLastError());
}

const char* moe_dispatch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
