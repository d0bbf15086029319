// Flash-decoding for Hopper, sm_90a: one query token per sequence against
// its KV cache.
//
// Replaces the TPU kernel repro/kernels/decode_attention/kernel.py::
// decode_attention_pallas (body _decode_kernel). Same function: per-sequence
// lengths; cache slot t is valid while t < min(length, window, W) (a ring,
// sliding-window cache when window is given); the G = H / KV query heads of
// one KV head share every K/V row they read; float32 softmax statistics and
// accumulator; output in the input dtype.
//
// Translation. The TPU kernel walks the cache in 512-slot blocks in order on
// one core and carries (m, l, acc) in VMEM scratch. Here the cache of each
// (sequence, KV head) is cut into splits of `chunk` slots that run as
// separate CTAs (grid: n_split x KV x B), the GPU form the TPU kernel's own
// docstring names. Each split's partial (m, l, acc) is combined with the
// others by log-sum-exp. A split that lies past the sequence's valid slots
// reads nothing and exits at once.
//
// What bounds it on this card. Each valid slot's K and V rows are read once
// (2 * KV * D elements per slot) for about 4 * G * D FLOP per KV head: far
// below the ~295 FLOP/byte ridge, so the kernel is bound by memory, by the
// bytes of K and V up to each sequence's valid slots. A kernel that only
// moves bytes has to keep enough of them in flight on every SM and spend few
// instructions on each; two kernels, chosen by dtype in route():
//   - bfloat16 q and cache, at every D (a multiple of 16 up to 128; 128 for
//     Llama-3-8B and the other served models): decode_mma_kernel. A CTA is 4 warps; each warp walks tiles of
//     16 slots of its split (warp w takes tiles w, w + 4, ...) through its
//     own 3-stage ring in shared memory, filled by 16-byte cp.async
//     (cp.async.cg, commit/wait groups), so the loads of tile i + 2 are in
//     flight while tile i is computed and no CTA-wide barrier sits in the
//     loop. Both products run on tensor cores with mma.sync m16n8k16 (bf16
//     in, float32 accumulate): scores S = q K^T with A = q (the G <= 8 heads
//     in rows 0..7 of 16, rows 8..15 zero, kept in registers) and B = K^T
//     (ldmatrix from the K tile), two 8-slot n-tiles per tile; the score
//     fragment of the two n-tiles is, element for element, the B fragment
//     (16 slots x 8 heads) of O^T += V^T P^T, whose A = V^T comes from
//     ldmatrix.trans of the V tile. So P never leaves registers, and the
//     softmax needs two shuffles per tile for the row max, two to hand each
//     thread the rescale of the heads its accumulator holds, and none for
//     the row sum (each thread keeps a partial sum until the end). Rows
//     padded by 16 bytes make every ldmatrix conflict-free. Slots past the
//     valid count in the last tile load a valid row (the last one) and
//     score -inf. Splits come from the host (ops.split_plan), from W, KV
//     and the SM count alone: not the lengths (reading them would sync) and
//     not B (a sequence's rounding must not depend on its batch), sized so
//     that one sequence at its full window gets about one CTA per two SMs;
//     a split is a multiple of the CTA's 64-slot pass. The
//     combine is folded in: every non-empty split of a (sequence, KV head)
//     writes its float32 partial and takes a ticket from an atomic counter;
//     the last one to arrive resets the counter and combines all partials in
//     split order (so the result does not depend on which finished last). A
//     sequence whose valid slots fit in one split writes its output directly.
//     The counters are zero between launches; launches that share them must
//     run in stream order (ops.decode_attention says so to its callers). Budget (ptxas, CUDA 12.8, sm_90a): 141 registers
//     at D = 128 and 89 at D = 64, no spills; dynamic shared memory 104,448
//     bytes at D = 128 (4 warps x 3 stages x 16 slots x K and V rows padded
//     to 136 elements) and 55,296 at D = 64, so two CTAs fit on an SM at
//     D = 128 (__launch_bounds__(128, 2)). chip_smoke.py phase 2 prints both,
//     and those of the other head dims.
//   - float32 q with a float32 or bf16 cache (float32 models keep either):
//     decode_split_kernel + decode_combine_kernel, the first port's split-K
//     kernel (one warp per cache row, lanes split D, float32 FMAs and
//     shuffles, 256-slot splits, a second pass that combines); its query
//     and output are float32 only, since bf16 queries take the route above.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>  // INFINITY
#include <stdint.h>

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


__device__ __forceinline__ int valid_slots(const int* lengths, int b, int W,
                                           int window) {
  int n = lengths[b];
  if (window > 0) n = min(n, window);
  return max(0, min(n, W));
}

// Pass 1. q: (B, 1, H, D) with h = kvh * G + g; caches: (B, W, KV, D).
// Partials: m, l (B, KV, n_split, G); acc (B, KV, n_split, G, D), unnormalised.
// grid: (n_split, KV, B); block: THREADS. GMAX >= G.
template <typename TC, int GMAX>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const float* __restrict__ q, const TC* __restrict__ kc,
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
  const float* qb = q + ((size_t)b * KV + kvh) * G * D + d0;
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
__global__ void __launch_bounds__(THREADS)
decode_combine_kernel(const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const float* __restrict__ part_acc, float* __restrict__ out,
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
    out[(((size_t)b * KV + kvh) * G + g) * D + d] = A / fmaxf(L, 1e-37f);
  }
}

template <typename TC, int GMAX>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const int* lengths, void* out, float* part_m,
                   float* part_l, float* part_acc, int B, int W, int KV,
                   int G, int D, int chunk, int n_split, float scale,
                   int window, cudaStream_t stream) {
  decode_split_kernel<TC, GMAX><<<dim3(n_split, KV, B), THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const TC*>(kc),
      static_cast<const TC*>(vc), lengths, part_m, part_l, part_acc, W, KV, G,
      D, chunk, scale, window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<<<dim3(KV, B), THREADS, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<float*>(out), KV, G, D, n_split);
  return cudaGetLastError();
}

template <typename TC>
cudaError_t dispatch(const void* q, const void* kc, const void* vc,
                     const int* lengths, void* out, float* part_m,
                     float* part_l, float* part_acc, int B, int W, int KV,
                     int G, int D, int chunk, int n_split, float scale,
                     int window, cudaStream_t stream) {
#define REPRO_DECODE_LAUNCH(GM)                                              \
  return launch<TC, GM>(q, kc, vc, lengths, out, part_m, part_l, part_acc, B, \
                       W, KV, G, D, chunk, n_split, scale, window, stream)
  if (G <= 1) REPRO_DECODE_LAUNCH(1);
  if (G <= 2) REPRO_DECODE_LAUNCH(2);
  if (G <= 4) REPRO_DECODE_LAUNCH(4);
  REPRO_DECODE_LAUNCH(8);
#undef REPRO_DECODE_LAUNCH
}


// ---------------------------------------------------------------------------
// bfloat16: tensor-core tiles over a cp.async ring
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int TS = 16;                    // cache slots per warp tile
constexpr int PASS = MMA_WARPS * TS;      // slots a CTA covers per pass
constexpr int STAGES = 3;                 // ring depth per warp
constexpr int KPAD = 8;                   // smem row padding (elements)
constexpr int MAX_SPLIT = 256;
constexpr int NH = 8;                     // query heads on the mma's N

template <int D>
struct MmaSmem {
  static constexpr int ROW = D + KPAD;                 // elements per smem row
  static constexpr int MAT = TS * ROW * 2;             // bytes of a K or V tile
  static constexpr int STAGE = 2 * MAT;                // K tile, then V tile
  static constexpr int WARP = STAGES * STAGE;
  static constexpr int RING = MMA_WARPS * WARP;
  static constexpr int MERGE = MMA_WARPS * NH * (D + 2) * 4;  // after the ring
  static constexpr int FACTORS = MAX_SPLIT * NH * 4;           // after the merge
  static constexpr int BYTES = RING > MERGE ? (RING > FACTORS ? RING : FACTORS)
                                            : (MERGE > FACTORS ? MERGE : FACTORS);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c += a (16x16, row) * b (16x8, col); bf16 inputs, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory; lane L gives the row address of
// matrix L / 8, row L % 8. trans: each matrix transposed.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// One warp copies the K and V rows of slots [ts, ts + TS) into a ring stage,
// 16 bytes per lane per copy. Slots at or past t1 copy row t1 - 1 (valid,
// inside the sequence); their scores are set to -inf.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t stage, const __nv_bfloat16* kb,
                                          const __nv_bfloat16* vb, size_t row,
                                          int ts, int t1, int lane) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < TS * CH / 32; ++it) {
    const int i = it * 32 + lane;
    const int r = i / CH, c = (i % CH) * 8;
    const size_t off = (size_t)min(ts + r, t1 - 1) * row + c;
    const uint32_t dst = stage + (r * MmaSmem<D>::ROW + c) * 2;
    cp_async16(dst, kb + off);
    cp_async16(dst + MmaSmem<D>::MAT, vb + off);
  }
}

// q: (B, 1, H, D) with h = kvh * G + g; caches: (B, W, KV, D); out like q.
// Partials of split s of pair p = b * KV + kvh: part_m, part_l at
// (p * n_split + s) * G + g (m in log2 units), part_acc at that times D,
// unnormalised. counters: one int per pair, zero between launches.
// grid: (n_split, KV, B); block: MMA_THREADS.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS, 2)
decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ kc,
                  const __nv_bfloat16* __restrict__ vc,
                  const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
                  float* __restrict__ part_m, float* __restrict__ part_l,
                  float* __restrict__ part_acc, int* __restrict__ counters, int W,
                  int KV, int G, int chunk, float scale_log2, int window) {
  using L = MmaSmem<D>;
  constexpr int MT = D / 16;  // 16-channel blocks
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, quad = lane & 3;
  const int n_valid = valid_slots(lengths, b, W, window);
  const int t0 = split * chunk;
  const int pair = b * KV + kvh;
  __nv_bfloat16* o_out = out + (size_t)pair * G * D;
  if (t0 >= n_valid) {  // nothing valid here; no valid slot at all: output 0
    if (split == 0)
      for (int i = tid; i < G * D; i += MMA_THREADS) o_out[i] = __float2bfloat16(0.f);
    return;
  }
  const int t1 = min(t0 + chunk, n_valid);
  const int n_active = (n_valid + chunk - 1) / chunk;

  // A fragments of q: head grp in row grp (rows 8..15 and heads >= G zero),
  // channels c * 16 + 2 * quad + {0, 1} and + 8
  uint32_t qa[MT][2];
  const __nv_bfloat16* qrow = q + ((size_t)pair * G + grp) * D + 2 * quad;
#pragma unroll
  for (int c = 0; c < MT; ++c) {
    qa[c][0] = grp < G ? ld_u32(qrow + c * 16) : 0u;
    qa[c][1] = grp < G ? ld_u32(qrow + c * 16 + 8) : 0u;
  }

  // accumulator O^T: o[mt] holds channels mt * 16 + grp (+ 8) of heads
  // 2 * quad and 2 * quad + 1. Row max m and this thread's share of the row
  // sum l are those of head grp, in log2 units.
  float o[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) o[mt][0] = o[mt][1] = o[mt][2] = o[mt][3] = 0.f;
  float m = -INFINITY, l = 0.f;

  const size_t row = (size_t)KV * D;  // elements between consecutive slots
  const __nv_bfloat16* kb = kc + (size_t)b * W * row + (size_t)kvh * D;
  const __nv_bfloat16* vb = vc + (size_t)b * W * row + (size_t)kvh * D;
  const uint32_t ring = smem_u32(smem) + warp * L::WARP;
  const int n_tiles = (t1 - t0 + TS - 1) / TS;
  const int mine = n_tiles > warp ? (n_tiles - warp + MMA_WARPS - 1) / MMA_WARPS : 0;
  // this lane's ldmatrix row: slot 8 * (j / 2) + r, channel 8 * (j % 2) of
  // matrix j = lane / 8; the same address serves K (scores' B, non-trans)
  // and V (P V's A, trans)
  const uint32_t lm = ((8 * (lane >> 4) + (lane & 7)) * L::ROW + 8 * ((lane >> 3) & 1)) * 2;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < mine)
      load_tile<D>(ring + s * L::STAGE, kb, vb, row, t0 + (warp + s * MMA_WARPS) * TS,
                   t1, lane);
    cp_async_commit();
  }
  for (int i = 0; i < mine; ++i) {
    __syncwarp();  // every lane is done with the stage the next copy refills
    const int nx = i + STAGES - 1;
    if (nx < mine)
      load_tile<D>(ring + (nx % STAGES) * L::STAGE, kb, vb, row,
                   t0 + (warp + nx * MMA_WARPS) * TS, t1, lane);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // this lane's copies of tile i have landed
    __syncwarp();                 // and every other lane's
    const uint32_t kt = ring + (i % STAGES) * L::STAGE, vt = kt + L::MAT;
    const int ts = t0 + (warp + i * MMA_WARPS) * TS;

    // scores of slots ts + 8 * nt + 2 * quad + {0, 1} for head grp
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int c = 0; c < MT; ++c) {
      uint32_t kf[4];
      ldmatrix_x4(kf, kt + lm + c * 32);
      mma_bf16(s[0], qa[c][0], 0u, qa[c][1], 0u, kf[0], kf[1]);
      mma_bf16(s[1], qa[c][0], 0u, qa[c][1], 0u, kf[2], kf[3]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = ts + 8 * nt + 2 * quad + e;
        s[nt][e] = t < t1 ? s[nt][e] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[nt][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);  // finite: every tile has a valid slot
    const float alpha = ex2(m - m_new);
    float p[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) p[nt][e] = ex2(s[nt][e] - m_new);
    l = l * alpha + (p[0][0] + p[0][1]) + (p[1][0] + p[1][1]);
    m = m_new;
    // the rescale of heads 2 * quad and 2 * quad + 1, held by lanes 4 * h
    const float a0 = __shfl_sync(0xffffffffu, alpha, 8 * quad);
    const float a1 = __shfl_sync(0xffffffffu, alpha, 8 * quad + 4);
    // P^T as the B fragment: slots 2 * quad + {0, 1} and + 8, head grp
    const uint32_t pb0 = pack_bf16(p[0][0], p[0][1]);
    const uint32_t pb1 = pack_bf16(p[1][0], p[1][1]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, vt + lm + mt * 32);
      o[mt][0] *= a0;
      o[mt][1] *= a1;
      o[mt][2] *= a0;
      o[mt][3] *= a1;
      mma_bf16(o[mt], vf[0], vf[1], vf[2], vf[3], pb0, pb1);
    }
  }
  cp_async_wait<0>();
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);

  // merge the 4 warps' partials in shared memory (the ring is free now); a
  // warp that had no tile has l == 0
  __syncthreads();
  float* sm_m = reinterpret_cast<float*>(smem);  // [MMA_WARPS][NH]
  float* sm_l = sm_m + MMA_WARPS * NH;           // [MMA_WARPS][NH]
  float* sm_o = sm_l + MMA_WARPS * NH;           // [MMA_WARPS][NH][D]
  if (quad == 0) {
    sm_m[warp * NH + grp] = m;
    sm_l[warp * NH + grp] = l;
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sm_o[(warp * NH + 2 * quad + (e & 1)) * D + mt * 16 + grp + 8 * (e >> 1)] = o[mt][e];
  __syncthreads();

  const size_t part = (size_t)pair * gridDim.x + split;
  for (int i = tid; i < G * D; i += MMA_THREADS) {
    const int g = i / D, d = i % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < MMA_WARPS; ++w)
      if (sm_l[w * NH + g] > 0.f) M = fmaxf(M, sm_m[w * NH + g]);
    float Ls = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < MMA_WARPS; ++w) {
      const float lw = sm_l[w * NH + g];
      if (lw > 0.f) {
        const float f = ex2(sm_m[w * NH + g] - M);
        Ls = fmaf(lw, f, Ls);
        A = fmaf(sm_o[(w * NH + g) * D + d], f, A);
      }
    }
    if (n_active == 1) {
      o_out[i] = __float2bfloat16(A / Ls);
    } else {
      part_acc[part * G * D + i] = A;
      if (d == 0) {
        part_m[part * G + g] = M;
        part_l[part * G + g] = Ls;
      }
    }
  }
  if (n_active == 1) return;

  // the last split of this pair to arrive combines every split's partial
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    is_last = atomicAdd(counters + pair, 1) == n_active - 1;
    if (is_last) counters[pair] = 0;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const size_t first = (size_t)pair * gridDim.x;
  float* sm_f = reinterpret_cast<float*>(smem);  // [n_active][NH]: exp2(m - M) / L
  if (tid < G) {
    float M = -INFINITY;
    for (int sp = 0; sp < n_active; ++sp)
      M = fmaxf(M, __ldcg(part_m + (first + sp) * G + tid));
    float Ls = 0.f;
    for (int sp = 0; sp < n_active; ++sp) {
      const float f = ex2(__ldcg(part_m + (first + sp) * G + tid) - M);
      sm_f[sp * NH + tid] = f;
      Ls = fmaf(__ldcg(part_l + (first + sp) * G + tid), f, Ls);
    }
    const float inv = 1.f / Ls;
    for (int sp = 0; sp < n_active; ++sp) sm_f[sp * NH + tid] *= inv;
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += MMA_THREADS) {
    const int g = i / D;
    float A = 0.f;
    for (int sp = 0; sp < n_active; ++sp)
      A = fmaf(sm_f[sp * NH + g], __ldcg(part_acc + (first + sp) * G * D + i), A);
    o_out[i] = __float2bfloat16(A);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* kc, const void* vc,
                       const int* lengths, void* out, float* part_m,
                       float* part_l, float* part_acc, int* counters, int B,
                       int W, int KV, int G, int chunk, int n_split, float scale,
                       int window, cudaStream_t stream) {
  constexpr int smem = MmaSmem<D>::BYTES;
  static unsigned long long configured = 0;  // devices whose limit is raised
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (device & 63);
  if (!(configured & bit)) {
    err = cudaFuncSetAttribute(decode_mma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured |= bit;
  }
  decode_mma_kernel<D><<<dim3(n_split, KV, B), MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kc),
      static_cast<const __nv_bfloat16*>(vc), lengths,
      static_cast<__nv_bfloat16*>(out), part_m, part_l, part_acc, counters, W, KV,
      G, chunk, scale * 1.4426950408889634f, window);
  return cudaGetLastError();
}

// The kernel decode_attention_fwd runs for (q dtype, cache dtype, D), and
// its dynamic shared memory in bytes.
enum Route { ROUTE_NONE, ROUTE_FMA, ROUTE_MMA };

Route route(int q_dtype, int cache_dtype, int D, int* smem) {
  *smem = 0;
  const bool bf16 = q_dtype == 1 && cache_dtype == 1;
  const bool f32 = q_dtype == 0 && (cache_dtype == 0 || cache_dtype == 1);
  if (D % 16 != 0 || D < 16 || D > DMAX || !(bf16 || f32)) return ROUTE_NONE;
  if (!bf16) return ROUTE_FMA;
  switch (D) {
#define REPRO_DECODE_SMEM(DD) \
    case DD: *smem = MmaSmem<DD>::BYTES; break;
    REPRO_DECODE_SMEM(16) REPRO_DECODE_SMEM(32) REPRO_DECODE_SMEM(48)
    REPRO_DECODE_SMEM(64) REPRO_DECODE_SMEM(80) REPRO_DECODE_SMEM(96)
    REPRO_DECODE_SMEM(112) REPRO_DECODE_SMEM(128)
#undef REPRO_DECODE_SMEM
  }
  return ROUTE_MMA;
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. q and out share q_dtype; the two
// caches share cache_dtype (a float32 model keeps a bfloat16 cache, as the
// reference does). window <= 0: no sliding window. The cache of each
// (sequence, KV head) is cut into n_split splits of `chunk` slots.
// scratch: B*KV*n_split*G*(D + 2) floats (part_m, part_l, then part_acc).
// counters: B*KV ints, zero, for the mma.sync route (left zero after it).
// Returns the CUDA error code of the launches (0 on success).
int decode_attention_fwd(const void* q, const void* k_cache,
                         const void* v_cache, const int* lengths, void* out,
                         float* scratch, int* counters, int B, int W, int KV,
                         int G, int D, int chunk, int n_split, float scale,
                         int window, int q_dtype, int cache_dtype,
                         void* stream) {
  int smem = 0;
  const Route r = route(q_dtype, cache_dtype, D, &smem);
  if (r == ROUTE_NONE || G < 1 || G > 8 || chunk < 1 ||
      (long long)n_split * chunk < W)
    return (int)cudaErrorInvalidValue;
  const size_t n_part = (size_t)B * KV * n_split * G;
  float* part_m = scratch;
  float* part_l = scratch + n_part;
  float* part_acc = scratch + 2 * n_part;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r == ROUTE_MMA) {
    if (chunk % PASS != 0 || n_split > MAX_SPLIT || counters == nullptr)
      return (int)cudaErrorInvalidValue;
    switch (D) {
#define REPRO_DECODE_MMA(DD)                                                    \
      case DD:                                                                  \
        return (int)launch_mma<DD>(q, k_cache, v_cache, lengths, out, part_m,  \
                                   part_l, part_acc, counters, B, W, KV, G,    \
                                   chunk, n_split, scale, window, st);
      REPRO_DECODE_MMA(16) REPRO_DECODE_MMA(32) REPRO_DECODE_MMA(48)
      REPRO_DECODE_MMA(64) REPRO_DECODE_MMA(80) REPRO_DECODE_MMA(96)
      REPRO_DECODE_MMA(112) REPRO_DECODE_MMA(128)
#undef REPRO_DECODE_MMA
    }
    return (int)cudaErrorInvalidValue;  // unreachable: route() took D
  }
#define REPRO_DECODE_DISPATCH(TC)                                            \
  return (int)dispatch<TC>(q, k_cache, v_cache, lengths, out, part_m,    \
                               part_l, part_acc, B, W, KV, G, D, chunk,      \
                               n_split, scale, window, st)
  if (cache_dtype == 0) REPRO_DECODE_DISPATCH(float);
  REPRO_DECODE_DISPATCH(__nv_bfloat16);
#undef REPRO_DECODE_DISPATCH
}

// Name of the kernel decode_attention_fwd runs for (q dtype, cache dtype,
// D): "mma.sync" or "fma", or NULL where it refuses them; *smem_bytes is
// that kernel's dynamic shared memory per CTA.
const char* decode_attention_route(int q_dtype, int cache_dtype, int D,
                                   int* smem_bytes) {
  const Route r = route(q_dtype, cache_dtype, D, smem_bytes);
  return r == ROUTE_MMA ? "mma.sync" : r == ROUTE_FMA ? "fma" : nullptr;
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
