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
//   - float32 q with a float32 or bf16 cache (float32 models keep either),
//     at every D: decode_f32_kernel (route "bulk.fma"), one launch with the
//     same splits (ops.split_plan), folded combine and tickets. A CTA is a
//     producer warp and three consumer warps, each consumer owning one
//     stage of a ring of 32-slot tiles in shared memory (float32 at
//     D = 128: 3 stages of 32 KB, two CTAs an SM). Two producer lanes, one
//     for K and one for V, arm a stage's "full" mbarrier with the tile's
//     bytes and ask TMA for its boxes (a 4-D tensor map over the cache,
//     boxes of 128 bytes of a row by 32 slots, 128-byte swizzle), so the
//     copy engine keeps every free stage in flight with no registers or
//     per-byte instructions; the first stages go out before q is read.
//     Each consumer frees its stage's K after the scores and its V after
//     P V, on "empty" mbarriers, so the next K lands while P V runs. The
//     products run on FMAs: at G <= 8 there are at most 2 FMAs per byte
//     read against the card's ~10, so tensor cores (3xTF32 would split
//     every operand) buy nothing here. Lane t scores slot t for every head
//     over the whole of D (its K row read in 16-byte chunks; the swizzle
//     spreads eight lanes over all banks; q broadcast from shared memory),
//     so no score is reduced across lanes. The online softmax runs once
//     per tile: one warp max per head (5 shuffles a head a tile, where a
//     warp-per-row kernel spends 5 a head a row), each lane keeps its
//     share of the row sum, and P goes through shared memory to P V, where
//     lane i accumulates channels 4i..4i+3 over the tile's valid slots in
//     order. Warps' partials merge in warp order, splits' in split order:
//     two launches give the same bits. Query and output are float32 only,
//     since bf16 queries take the route above. What bounds it: the copy
//     engine streams the valid rows at about the rate of a plain reduction
//     over as many bytes (chip_smoke.py phase 3 prints both); the rest is
//     each CTA's start (lengths, q, the first tiles' latency), its
//     consumers' compute holding stages, and its epilogue. A persistent
//     variant (dynamic item queue, per-warp partials, a grid-wide combine)
//     and row-by-row cp.async.bulk copies were slower on the card.
#include <cuda.h>  // CUtensorMap and its enums; no link against libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>  // INFINITY
#include <stdint.h>

namespace {

constexpr int DMAX = 128;     // the largest head_dim either kernel takes

__device__ __forceinline__ int valid_slots(const int* lengths, int b, int W,
                                           int window) {
  int n = lengths[b];
  if (window > 0) n = min(n, window);
  return max(0, min(n, W));
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

// ---------------------------------------------------------------------------
// float32 q: a TMA ring in shared memory, FMA products, one launch
// ---------------------------------------------------------------------------

constexpr int F_TS = 32;                           // cache slots a tile: one a lane
constexpr int F_CONSUMERS = 3;                     // consumer warps, a stage each
constexpr int F_THREADS = 32 * (1 + F_CONSUMERS);  // warp 0 is the producer
constexpr int F_GMAX = 8;                          // query heads a KV head, at most
constexpr int F_BOX = F_TS * 128;                  // bytes of a TMA box: 32 rows of 128

// Byte offsets of the float32 kernel's shared memory for head_dim D, cache
// elements of `es` bytes and `gmax` query heads, from a 1024-byte aligned
// base: the ring (a stage for each consumer warp, the K tile, then the V
// tile; a tile is nb boxes of F_TS rows x 128 bytes, the row's bytes
// j * 128 .. j * 128 + 127 in box j, swizzled by TMA's 128-byte pattern,
// zero past D), q (gmax x D floats, heads past G zero), each consumer
// warp's probabilities (F_TS x gmax floats), then the stages' full and
// empty mbarriers, K's and V's apart. bytes counts 1024 of slack for the
// alignment.
struct F32Smem {
  int nb, mat, stage, q, p, bars, bytes;
};

__host__ __device__ constexpr F32Smem f32_smem(int D, int es, int gmax) {
  F32Smem L{};
  L.nb = (D * es + 127) / 128;
  L.mat = L.nb * F_BOX;
  L.stage = 2 * L.mat;
  L.q = F_CONSUMERS * L.stage;
  L.p = L.q + gmax * D * 4;
  L.bars = L.p + F_CONSUMERS * F_TS * gmax * 4;
  L.bytes = 1024 + L.bars + 4 * F_CONSUMERS * 8;
  return L;
}

// The largest case, float32 at D = 128 and G = 8 (106,592 bytes), leaves
// room for two CTAs on an SM (233,472 bytes, 1 KB of it reserved per CTA).
constexpr int F_BUDGET = 233472 / 2 - 1024;
static_assert(f32_smem(DMAX, 4, F_GMAX).bytes <= F_BUDGET, "two CTAs an SM");

// Byte offset, in a tile, of the 16-byte chunk c of row t: box c / 8, and
// TMA's 128-byte swizzle (chunk bits 4..6 xor row bits 7..9), which spreads
// lanes that read one chunk of eight rows, or eight chunks of one row, over
// all the banks.
__device__ __forceinline__ int swz(int t, int c) {
  return (c >> 3) * F_BOX + t * 128 + (((c & 7) ^ (t & 7)) << 4);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the barrier's phase of parity `parity` has completed. A wait
// that lasts ~2 s (2^32 cycles) is a lost arrival: trap, so that a fault
// ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 32)) __trap();
}

// One box of a 4-D tensor map (D, KV, W, B) at (col, head, slot, batch)
// into shared memory; completion is counted in bytes on `bar`. Slots past W
// and columns past D are zero-filled. The cache is read once a call, so its
// lines go first out of L2 (evict_first: 1-3% faster on the card than the
// default policy).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "{\n.reg .b64 pol;\n"
      "createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%3, %4, %5, %6}], [%2], pol;\n}\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

// The 16 bytes at p as floats: 4 float32 values or 8 bf16.
template <typename TC>
__device__ __forceinline__ void load_chunk(const unsigned char* p,
                                           float (&x)[16 / sizeof(TC)]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  if constexpr (sizeof(TC) == 4) {
    x[0] = __uint_as_float(u.x); x[1] = __uint_as_float(u.y);
    x[2] = __uint_as_float(u.z); x[3] = __uint_as_float(u.w);
  } else {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// Four channels at p as floats: 16 bytes of float32 or 8 of bf16.
template <typename TC>
__device__ __forceinline__ void load4(const unsigned char* p, float (&x)[4]) {
  if constexpr (sizeof(TC) == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    x[0] = __uint_as_float(u.x << 16); x[1] = __uint_as_float(u.x & 0xffff0000u);
    x[2] = __uint_as_float(u.y << 16); x[3] = __uint_as_float(u.y & 0xffff0000u);
  }
}

// GMAX consecutive floats of shared memory, in vector loads and stores.
template <int GMAX>
__device__ __forceinline__ void load_heads(const float* p, float (&x)[GMAX]) {
  if constexpr (GMAX >= 4) {
#pragma unroll
    for (int g = 0; g < GMAX; g += 4) {
      const float4 u = *reinterpret_cast<const float4*>(p + g);
      x[g] = u.x; x[g + 1] = u.y; x[g + 2] = u.z; x[g + 3] = u.w;
    }
  } else if constexpr (GMAX == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    x[0] = u.x; x[1] = u.y;
  } else {
    x[0] = p[0];
  }
}

template <int GMAX>
__device__ __forceinline__ void store_heads(float* p, const float (&x)[GMAX]) {
  if constexpr (GMAX >= 4) {
#pragma unroll
    for (int g = 0; g < GMAX; g += 4)
      *reinterpret_cast<float4*>(p + g) = make_float4(x[g], x[g + 1], x[g + 2], x[g + 3]);
  } else if constexpr (GMAX == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    p[0] = x[0];
  }
}

// q: (B, 1, H, D) float32 with h = kvh * G + g; tk, tv: maps over the
// (B, W, KV, D) caches of TC (float or bf16), boxes of 128 bytes by F_TS
// slots (make_map); out: float32 like q. Partials of split s of pair
// p = b * KV + kvh as decode_mma_kernel's (m in log2 units); counters: one
// int per pair, zero between launches. grid: (n_split, KV, B); block:
// F_THREADS; dynamic shared memory f32_smem(D, sizeof(TC), GMAX).bytes.
// GMAX >= G.
template <typename TC, int GMAX>
__global__ void __launch_bounds__(F_THREADS, 2)
decode_f32_kernel(const float* __restrict__ q, __grid_constant__ const CUtensorMap tk,
                  __grid_constant__ const CUtensorMap tv, const int* __restrict__ lengths,
                  float* __restrict__ out, float* __restrict__ part_m,
                  float* __restrict__ part_l, float* __restrict__ part_acc,
                  int* __restrict__ counters, int W, int KV, int G, int D,
                  int chunk, float scale_log2, int window) {
  constexpr int ES = sizeof(TC);
  constexpr int CH = 16 / ES;  // channels in 16 bytes of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int is_last;

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_valid = valid_slots(lengths, b, W, window);
  const int t0 = split * chunk;
  const int pair = b * KV + kvh;
  float* o_out = out + (size_t)pair * G * D;
  if (t0 >= n_valid) {  // nothing valid here; no valid slot at all: output 0
    if (split == 0)
      for (int i = tid; i < G * D; i += F_THREADS) o_out[i] = 0.f;
    return;
  }
  const int t1 = min(t0 + chunk, n_valid);
  const int n_active = (n_valid + chunk - 1) / chunk;
  const int n_tiles = (t1 - t0 + F_TS - 1) / F_TS;
  const F32Smem L = f32_smem(D, ES, GMAX);
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* sq = reinterpret_cast<float*>(smem + L.q);     // [GMAX][D]
  float* sprob = reinterpret_cast<float*>(smem + L.p);  // [F_CONSUMERS][F_TS][GMAX]
  const uint32_t ring = smem_u32(smem);
  // mbarriers, 8 bytes each: full[0][s] (K), full[1][s] (V), empty[0][s],
  // empty[1][s]; stage s belongs to consumer warp s
  const uint32_t bars = smem_u32(smem + L.bars);
  auto full = [&](int kv, int s) { return bars + 8 * (kv * F_CONSUMERS + s); };
  auto empty = [&](int kv, int s) { return bars + 8 * ((2 + kv) * F_CONSUMERS + s); };
  // Producer: lane 0 of warp 0 loads K tiles, lane 1 V tiles, each arming
  // the stage's full barrier with the tile's bytes and asking TMA for its
  // boxes (whole boxes: slots past the valid ones are read too, and never
  // used). Tile j goes to stage (and consumer warp) j % F_CONSUMERS. The
  // first stages go out before q is in place.
  const int prod = warp == 0 && lane < 2 ? lane : -1;
  auto load_tile = [&](int j) {
    constexpr int COLS = 128 / ES;  // columns of a box
    const int s = j % F_CONSUMERS;
    const uint32_t bar = full(prod, s), dst = ring + s * L.stage + prod * L.mat;
    mbar_expect_tx(bar, L.mat);
    for (int x = 0; x < L.nb; ++x)
      tma_load(dst + x * F_BOX, prod ? &tv : &tk, bar, x * COLS, kvh, t0 + j * F_TS, b);
  };
  if (warp == 0) {
    if (lane == 0) {
      for (int i = 0; i < 4 * F_CONSUMERS; ++i)
        mbar_init(bars + 8 * i, 1);  // full: the producer's arrival, then the
                                     // bytes; empty: the consuming warp's lane 0
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    if (prod >= 0)
      for (int j = 0; j < min(n_tiles, F_CONSUMERS); ++j) load_tile(j);
  }
  const float* qp = q + (size_t)pair * G * D;
  for (int i = tid; i < GMAX * D; i += F_THREADS) sq[i] = i < G * D ? qp[i] : 0.f;
  __syncthreads();

  // Consumer warp c takes tiles c, c + F_CONSUMERS, ... of the split, in
  // its one stage, and frees the stage's K after the scores and its V after
  // P V. m is uniform over a warp's lanes; l and acc are each lane's share
  // (the slots it scored; the channels 4 lane .. 4 lane + 3 it
  // accumulates).
  float m[GMAX], l[GMAX], acc[GMAX][4];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
    acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
  }
  const int cw = warp - 1;
  if (warp == 0) {
    if (prod >= 0)
      for (int j = F_CONSUMERS; j < n_tiles; ++j) {
        mbar_wait(empty(prod, j % F_CONSUMERS), (j / F_CONSUMERS - 1) & 1);
        load_tile(j);
      }
  } else {
    float* pw = sprob + cw * F_TS * GMAX;
    const int nch = D / CH;
    const unsigned char* kt = smem + cw * L.stage;
    const unsigned char* vt = kt + L.mat;
    const int vch = 4 * ES * lane / 16, vo = 4 * ES * lane % 16;  // V chunk, byte
    for (int j = cw; j < n_tiles; j += F_CONSUMERS) {
      const int parity = (j / F_CONSUMERS) & 1;
      mbar_wait(full(0, cw), parity);
      const int ts = t0 + j * F_TS;
      const int rows = min(F_TS, t1 - ts);

      // lane t scores slot ts + t for every head over the whole of D: K's
      // row t chunk by chunk (swizzled: eight lanes, eight banks), q
      // broadcast to the warp
      float sc[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) sc[g] = 0.f;
#pragma unroll 2
      for (int c = 0; c < nch; ++c) {
        float kx[CH];
        load_chunk<TC>(kt + swz(lane, c), kx);
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          const float* qg = sq + g * D + c * CH;
#pragma unroll
          for (int e = 0; e < CH; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qg + e);
            sc[g] = fmaf(qv.x, kx[e], sc[g]);
            sc[g] = fmaf(qv.y, kx[e + 1], sc[g]);
            sc[g] = fmaf(qv.z, kx[e + 2], sc[g]);
            sc[g] = fmaf(qv.w, kx[e + 3], sc[g]);
          }
        }
      }
      __syncwarp();  // every lane is done with K
      if (lane == 0) mbar_arrive(empty(0, cw));

      // the online softmax, once per tile: one max over the warp per head;
      // slots past the valid ones score -inf
      float alpha[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        const float x = lane < rows ? sc[g] * scale_log2 : -INFINITY;
        float mx = x;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[g], mx);  // finite: slot ts is valid
        alpha[g] = ex2(m[g] - m_new);
        sc[g] = ex2(x - m_new);
        l[g] = l[g] * alpha[g] + sc[g];
        m[g] = m_new;
      }
      store_heads<GMAX>(pw + lane * GMAX, sc);
      __syncwarp();
      mbar_wait(full(1, cw), parity);

      // P V: lane i accumulates channels 4 i .. 4 i + 3 over the tile's
      // valid slots, in slot order
      if (4 * lane < D) {
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[g][e] *= alpha[g];
#pragma unroll 4
        for (int t = 0; t < rows; ++t) {
          float vx[4], pt[GMAX];
          load4<TC>(vt + swz(t, vch) + vo, vx);
          load_heads<GMAX>(pw + t * GMAX, pt);
#pragma unroll
          for (int g = 0; g < GMAX; ++g)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[g][e] = fmaf(pt[g], vx[e], acc[g][e]);
        }
      }
      __syncwarp();  // every lane is done with V and with pw
      if (lane == 0) mbar_arrive(empty(1, cw));
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
  }

  // merge the consumer warps' partials in warp order in shared memory (the
  // ring is free: every tile has been consumed); a warp that had no tile
  // has l == 0
  __syncthreads();
  float* sm_o = reinterpret_cast<float*>(smem);  // [F_CONSUMERS][GMAX][D]
  float* sm_m = sm_o + F_CONSUMERS * GMAX * D;            // [F_CONSUMERS][GMAX]
  float* sm_l = sm_m + F_CONSUMERS * GMAX;                // [F_CONSUMERS][GMAX]
  if (warp > 0) {
    if (lane == 0)
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        sm_m[cw * GMAX + g] = m[g];
        sm_l[cw * GMAX + g] = l[g];
      }
    if (4 * lane < D)
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        reinterpret_cast<float4*>(sm_o + (cw * GMAX + g) * D)[lane] =
            make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  }
  __syncthreads();

  const size_t part = (size_t)pair * gridDim.x + split;
  for (int i = tid; i < G * D; i += F_THREADS) {
    const int g = i / D, d = i % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < F_CONSUMERS; ++w)
      if (sm_l[w * GMAX + g] > 0.f) M = fmaxf(M, sm_m[w * GMAX + g]);
    float Ls = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < F_CONSUMERS; ++w) {
      const float lw = sm_l[w * GMAX + g];
      if (lw > 0.f) {
        const float f = ex2(sm_m[w * GMAX + g] - M);
        Ls = fmaf(lw, f, Ls);
        A = fmaf(sm_o[(w * GMAX + g) * D + d], f, A);
      }
    }
    if (n_active == 1) {
      o_out[i] = A / Ls;
    } else {
      part_acc[part * G * D + i] = A;
      if (d == 0) {
        part_m[part * G + g] = M;
        part_l[part * G + g] = Ls;
      }
    }
  }
  if (n_active == 1) return;

  // the last split of this pair to arrive combines every split's partial,
  // in split order
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
  float* sm_f = reinterpret_cast<float*>(smem);  // [n_active][GMAX]: exp2(m - M) / L
  if (tid < G) {
    float M = -INFINITY;
    for (int sp = 0; sp < n_active; ++sp)
      M = fmaxf(M, __ldcg(part_m + (first + sp) * G + tid));
    float Ls = 0.f;
    for (int sp = 0; sp < n_active; ++sp) {
      const float f = ex2(__ldcg(part_m + (first + sp) * G + tid) - M);
      sm_f[sp * GMAX + tid] = f;
      Ls = fmaf(__ldcg(part_l + (first + sp) * G + tid), f, Ls);
    }
    const float inv = 1.f / Ls;
    for (int sp = 0; sp < n_active; ++sp) sm_f[sp * GMAX + tid] *= inv;
  }
  __syncthreads();
  // four channels a thread (D is a multiple of 16), the splits' loads
  // four in flight at a time: this pass is the launch's tail
  const float4* pa = reinterpret_cast<const float4*>(part_acc + first * G * D);
  const int n4 = G * D / 4;
  for (int i = tid; i < n4; i += F_THREADS) {
    const int g = 4 * i / D;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int sp = 0; sp < n_active; ++sp) {
      const float f = sm_f[sp * GMAX + g];
      const float4 v = __ldcg(pa + (size_t)sp * n4 + i);
      A.x = fmaf(f, v.x, A.x);
      A.y = fmaf(f, v.y, A.y);
      A.z = fmaf(f, v.z, A.z);
      A.w = fmaf(f, v.w, A.w);
    }
    reinterpret_cast<float4*>(o_out)[i] = A;
  }
}

// cuTensorMapEncodeTiled lives in libcuda. It is reached through the
// runtime's entry-point query, so the library needs no -lcuda and loads
// wherever the CUDA runtime does.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over a contiguous (B, W, KV, D) cache of float32 (es = 4) or
// bf16, dimensions innermost first: (D, KV, W, B); a box is 128 bytes of a
// row (32 float32 or 64 bf16 columns, zero past D) by F_TS slots, with the
// 128-byte swizzle. W stays its own dimension, so the zero fill past W never
// reads the next sequence's rows.
bool make_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int B,
              int W, int KV, int D, int es) {
  const cuuint64_t e = es;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)KV, (cuuint64_t)W,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * e, (cuuint64_t)KV * D * e,
                                 (cuuint64_t)W * KV * D * e};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / es), 1, (cuuint32_t)F_TS, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, es == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                4, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TC, int GMAX>
cudaError_t launch_f32(const void* q, const void* kc, const void* vc,
                       const int* lengths, void* out, float* part_m,
                       float* part_l, float* part_acc, int* counters, int B,
                       int W, int KV, int G, int D, int chunk, int n_split,
                       float scale, int window, cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap tk, tv;
  if (!make_map(&tk, encode, kc, B, W, KV, D, sizeof(TC)) ||
      !make_map(&tv, encode, vc, B, W, KV, D, sizeof(TC)))
    return cudaErrorInvalidValue;
  static unsigned long long configured = 0;  // devices whose limit is raised
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (device & 63);
  if (!(configured & bit)) {
    err = cudaFuncSetAttribute(decode_f32_kernel<TC, GMAX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, F_BUDGET);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(decode_f32_kernel<TC, GMAX>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured |= bit;
  }
  decode_f32_kernel<TC, GMAX>
      <<<dim3(n_split, KV, B), F_THREADS, f32_smem(D, sizeof(TC), GMAX).bytes, stream>>>(
          static_cast<const float*>(q), tk, tv, lengths, static_cast<float*>(out),
          part_m, part_l, part_acc, counters, W, KV, G, D, chunk,
          scale * 1.4426950408889634f, window);
  return cudaGetLastError();
}

template <typename TC>
cudaError_t dispatch_f32(const void* q, const void* kc, const void* vc,
                         const int* lengths, void* out, float* part_m,
                         float* part_l, float* part_acc, int* counters, int B,
                         int W, int KV, int G, int D, int chunk, int n_split,
                         float scale, int window, cudaStream_t stream) {
#define REPRO_DECODE_F32(GM)                                                    \
  return launch_f32<TC, GM>(q, kc, vc, lengths, out, part_m, part_l, part_acc, \
                            counters, B, W, KV, G, D, chunk, n_split, scale,   \
                            window, stream)
  if (G <= 1) REPRO_DECODE_F32(1);
  if (G <= 2) REPRO_DECODE_F32(2);
  if (G <= 4) REPRO_DECODE_F32(4);
  REPRO_DECODE_F32(8);
#undef REPRO_DECODE_F32
}

// The kernel decode_attention_fwd runs for (q dtype, cache dtype, D), and
// its dynamic shared memory in bytes.
enum Route { ROUTE_NONE, ROUTE_F32, ROUTE_MMA };

Route route(int q_dtype, int cache_dtype, int D, int* smem) {
  *smem = 0;
  const bool bf16 = q_dtype == 1 && cache_dtype == 1;
  const bool f32 = q_dtype == 0 && (cache_dtype == 0 || cache_dtype == 1);
  if (D % 16 != 0 || D < 16 || D > DMAX || !(bf16 || f32)) return ROUTE_NONE;
  if (!bf16) {
    *smem = f32_smem(D, cache_dtype == 0 ? 4 : 2, F_GMAX).bytes;
    return ROUTE_F32;
  }
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
// scratch: B*KV*n_split*G*(D + 2) floats (part_acc, then part_m, part_l).
// counters: B*KV ints, zero (left zero after the launch). Returns the CUDA
// error code of the launch (0 on success).
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
  float* part_acc = scratch;  // first: 16-byte aligned rows of D floats
  float* part_m = scratch + n_part * D;
  float* part_l = part_m + n_part;
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
  if (chunk % F_TS != 0 || n_split > MAX_SPLIT || counters == nullptr)
    return (int)cudaErrorInvalidValue;
  if (cache_dtype == 0)
    return (int)dispatch_f32<float>(q, k_cache, v_cache, lengths, out, part_m, part_l,
                                    part_acc, counters, B, W, KV, G, D, chunk,
                                    n_split, scale, window, st);
  return (int)dispatch_f32<__nv_bfloat16>(q, k_cache, v_cache, lengths, out, part_m,
                                          part_l, part_acc, counters, B, W, KV, G, D,
                                          chunk, n_split, scale, window, st);
}

// Name of the kernel decode_attention_fwd runs for (q dtype, cache dtype,
// D): "mma.sync" or "bulk.fma", or NULL where it refuses them; *smem_bytes
// is that kernel's dynamic shared memory per CTA (bulk.fma: at G = 8).
const char* decode_attention_route(int q_dtype, int cache_dtype, int D,
                                   int* smem_bytes) {
  const Route r = route(q_dtype, cache_dtype, D, smem_bytes);
  return r == ROUTE_MMA ? "mma.sync" : r == ROUTE_F32 ? "bulk.fma" : nullptr;
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
