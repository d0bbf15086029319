// Flash-attention forward (prefill) for Hopper, sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas (body _flash_kernel). Same function: online-softmax
// attention with GQA (query head h reads KV head h / (H / KV)), causal mask
// kpos <= qpos, sliding-window mask kpos > qpos - window, a ragged tail past
// S, float32 running max, denominator and accumulator, and the output written
// once in the input dtype, normalised by 1 / max(l, 1e-37). No backward.
//
// Translation. The TPU grid walks its KV axis in order and carries (m, l,
// acc) in VMEM scratch from one grid step to the next. CUDA blocks run in
// parallel in no order, so one CTA owns one (batch, head, 64-query tile) and
// loops over KV tiles itself, with (m, l, acc) in registers. K/V are read
// straight from the model layout (B, S, KV, D) at head h / G: nothing is
// repeated in memory. The scale 1/sqrt(D) is applied to the scores directly
// (the TPU wrapper's pad-D-to-128-and-rescale-q trick is not needed). KV tiles
// that the causal or window mask hides entirely are skipped.
//
// What bounds it on this card. Causal prefill does about 4 * S^2 * D * H / 2
// FLOP on S * D * (2H + 2KV) elements of input and output: at S >= ~512 the
// work is far above the H100's ~295 FLOP/byte ridge, so it is bound by
// arithmetic, and only the tensor cores reach the card's rate. Two kernels:
//   - bfloat16 (the served model): each warp owns 16 query rows and runs
//     both products, S = Q K^T and O += P V, on the tensor cores with
//     mma.sync m16n8k16 (bf16 in, float32 accumulate); the score
//     accumulators are reused in registers as the A operand of P V, as in
//     FlashAttention-2, so P never touches shared memory. Loads are
//     synchronous and single-buffered; wgmma, TMA and a load pipeline are
//     the work of a later version.
//   - float32 (tests and float32 models): float32 FMAs on shared-memory
//     tiles, which keep full float32 precision (TF32 tensor cores would not).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // key rows per KV tile
constexpr int THREADS = 256;  // 16 x 16 threads; each owns 4 rows x 4 score columns
constexpr int DMAX = 128;
constexpr int NJ = DMAX / 16; // output columns per thread at D = DMAX
constexpr float NEG_INF = -1e30f;

__host__ __device__ constexpr size_t smem_bytes(int D) {
  // Q and K tiles padded to D + 1 columns (conflict-free column reads), V
  // tile unpadded (read along rows), P tile padded to BK + 1.
  return sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) +
                          (size_t)BK * D + (size_t)BQ * (BK + 1));
}

// ---------------------------------------------------------------------------
// float32: FMAs on shared-memory tiles
// ---------------------------------------------------------------------------

// q, o: (B, S, H, D); k, v: (B, S, KV, D); float32, contiguous.
// grid: (ceil(S / BQ), H, B); block: THREADS; dynamic smem: smem_bytes(D).
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S, int H,
                 int KV, int D, float scale, int causal, int window) {
  extern __shared__ float smem[];
  const int ldq = D + 1;
  float* Qs = smem;               // [BQ][D + 1]
  float* Ks = Qs + BQ * ldq;      // [BK][D + 1]
  float* Vs = Ks + BK * ldq;      // [BK][D]
  float* Ps = Vs + BK * D;        // [BQ][BK + 1]

  // heaviest causal tiles (the last query rows) are scheduled first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int nd = D >> 4;

  const size_t q_row = (size_t)H * D, kv_row = (size_t)KV * D;
  const float* qb = q + (size_t)b * S * q_row + (size_t)h * D;
  const float* kb = k + (size_t)b * S * kv_row + (size_t)kvh * D;
  const float* vb = v + (size_t)b * S * kv_row + (size_t)kvh * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i - r * D;
    const int pos = q0 + r;
    Qs[r * ldq + c] = pos < S ? qb[(size_t)pos * q_row + c] : 0.f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  int k_begin = 0, k_end = S;
  if (causal) k_end = min(S, q0 + BQ);
  if (window > 0) k_begin = max(0, q0 - window + 1);
  k_begin = (k_begin / BK) * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done; orders the Q load
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i - r * D;
      const int pos = k0 + r;
      const bool ok = pos < S;
      Ks[r * ldq + c] = ok ? kb[(size_t)pos * kv_row + c] : 0.f;
      Vs[r * D + c] = ok ? vb[(size_t)pos * kv_row + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * ldq + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * ldq + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < S && (!causal || kpos <= qpos) &&
                (window <= 0 || kpos > qpos - window);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row group are lanes of one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // a masked score contributes nothing, also while the row has no
        // unmasked score yet (m_new == NEG_INF)
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * 4 + i) * (BK + 1) + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int t = 0; t < BK; ++t) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * (BK + 1) + t];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < nd) {
          const float vv = Vs[t * D + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-37f);
    float* orow = o + ((size_t)b * S + qpos) * q_row + (size_t)h * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (j < nd) orow[tx + 16 * j] = acc[i][j] * inv;
  }
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B,
                   int S, int H, int KV, int D, float scale, int causal,
                   int window, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  // two CTAs of ~113 KB share an SM only with the whole carveout as shared memory
  err = cudaFuncSetAttribute(flash_fwd_f32_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_f32_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, KV, D, scale,
      causal, window);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16), FlashAttention-2 register layout
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;  // 4 warps x 16 query rows = BQ
constexpr int PAD = 8;            // smem row padding (elements): conflict-free fragments

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16x16, row) * b (16x8, col); bf16 inputs, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices, transposed: from a row-major [k][n] tile, the B
// fragments (k16 x n8) of two neighbouring n8 tiles.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Copy rows [row0, row0 + rows) of a (S, heads, D) tensor at head `head`
// into a [rows][D + PAD] smem tile, 16 bytes per thread per step; rows past
// S are zero (a zero V row times a zero probability stays zero).
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          size_t row_stride, int row0,
                                          int rows, int S) {
  constexpr int CHUNKS = D / 8;
  for (int i = threadIdx.x; i < rows * CHUNKS; i += MMA_THREADS) {
    const int r = i / CHUNKS, c = (i - r * CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * (D + PAD) + c) = val;
  }
}

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(BQ + 2 * BK) * (D + PAD);
}

// q, o: (B, S, H, D); k, v: (B, S, KV, D); bf16, contiguous.
// grid: (ceil(S / BQ), H, B); block: MMA_THREADS; dynamic smem: mma_smem_bytes<D>().
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, int S, int H, int KV,
                      float scale, int causal, int window) {
  constexpr int LDS = D + PAD;
  constexpr int KT = D / 16;   // k-steps of Q K^T over the head dim
  constexpr int NT = BK / 8;   // n8 tiles of scores (keys)
  constexpr int DT = D / 8;    // n8 tiles of the output (channels)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][LDS]
  __nv_bfloat16* Ks = Qs + BQ * LDS;                               // [BK][LDS]
  __nv_bfloat16* Vs = Ks + BK * LDS;                               // [BK][LDS]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment row group, column pair

  const size_t q_row = (size_t)H * D, kv_row = (size_t)KV * D;
  const __nv_bfloat16* qb = q + (size_t)b * S * q_row + (size_t)h * D;
  const __nv_bfloat16* kb = k + (size_t)b * S * kv_row + (size_t)kvh * D;
  const __nv_bfloat16* vb = v + (size_t)b * S * kv_row + (size_t)kvh * D;

  load_tile<D>(Qs, qb, q_row, q0, BQ, S);
  __syncthreads();
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qa[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const __nv_bfloat16* p = Qs + r0 * LDS + kk * 16 + tig * 2;
    qa[kk][0] = ld_u32(p);
    qa[kk][1] = ld_u32(p + 8 * LDS);
    qa[kk][2] = ld_u32(p + 8);
    qa[kk][3] = ld_u32(p + 8 * LDS + 8);
  }

  float oacc[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[t][e] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // rows r0, r0 + 8
  const int qpos0 = q0 + r0, qpos1 = qpos0 + 8;

  int k_begin = 0, k_end = S;
  if (causal) k_end = min(S, q0 + BQ);
  if (window > 0) k_begin = max(0, q0 - window + 1);
  k_begin = (k_begin / BK) * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(Ks, kb, kv_row, k0, BK, S);
    load_tile<D>(Vs, vb, kv_row, k0, BK, S);
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp
    float sacc[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const __nv_bfloat16* p = Ks + (t * 8 + g) * LDS + kk * 16 + tig * 2;
        mma_bf16(sacc[t], qa[kk], ld_u32(p), ld_u32(p + 8));
      }

    // mask and scale; element e of tile t: row r0 + 8 * (e >> 1),
    // key k0 + 8 t + 2 tig + (e & 1)
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + t * 8 + tig * 2 + (e & 1);
        const int qp = (e < 2) ? qpos0 : qpos1;
        const bool ok = key < S && (!causal || key <= qp) &&
                        (window <= 0 || key > qp - window);
        sacc[t][e] = ok ? sacc[t][e] * scale : NEG_INF;
        if (e < 2) mx0 = fmaxf(mx0, sacc[t][e]);
        else mx1 = fmaxf(mx1, sacc[t][e]);
      }
    // a row's 64 scores lie in the 4 lanes of its quad
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // masked scores (NEG_INF) contribute nothing, also while a row has
        // no unmasked score yet
        const float s = sacc[t][e];
        const float p = s > 0.5f * NEG_INF ? expf(s - (e < 2 ? mn0 : mn1)) : 0.f;
        sacc[t][e] = p;
        if (e < 2) rs0 += p;
        else rs1 += p;
      }
    l0 = l0 * alpha0 + rs0;  // per-lane partial sums; the quad is summed at the end
    l1 = l1 * alpha1 + rs1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      oacc[t][0] *= alpha0;
      oacc[t][1] *= alpha0;
      oacc[t][2] *= alpha1;
      oacc[t][3] *= alpha1;
    }

    // O += P V: the score accumulators of key tiles 2j and 2j + 1 are the A
    // fragment of keys [16 j, 16 j + 16)
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(sacc[2 * j][0], sacc[2 * j][1]),
                              pack_bf16(sacc[2 * j][2], sacc[2 * j][3]),
                              pack_bf16(sacc[2 * j + 1][0], sacc[2 * j + 1][1]),
                              pack_bf16(sacc[2 * j + 1][2], sacc[2 * j + 1][3])};
      const __nv_bfloat16* vrow =
          Vs + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS + (lane >> 4) * 8;
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vrow + dp * 16);
        mma_bf16(oacc[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(oacc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-37f), inv1 = 1.f / fmaxf(l1, 1e-37f);
  __nv_bfloat16* o0 = o + ((size_t)b * S + qpos0) * q_row + (size_t)h * D + tig * 2;
  __nv_bfloat16* o1 = o0 + 8 * q_row;
#pragma unroll
  for (int t = 0; t < DT; ++t) {
    if (qpos0 < S)
      *reinterpret_cast<uint32_t*>(o0 + t * 8) = pack_bf16(oacc[t][0] * inv0, oacc[t][1] * inv0);
    if (qpos1 < S)
      *reinterpret_cast<uint32_t*>(o1 + t * 8) = pack_bf16(oacc[t][2] * inv1, oacc[t][3] * inv1);
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int KV, float scale, int causal,
                        int window, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_bf16_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S,
      H, KV, scale, causal, window);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, void* o,
                          int B, int S, int H, int KV, int D, float scale,
                          int causal, int window, cudaStream_t stream) {
  switch (D) {
#define REPRO_FLASH_CASE(DD) \
  case DD: return launch_bf16<DD>(q, k, v, o, B, S, H, KV, scale, causal, window, stream);
    REPRO_FLASH_CASE(16) REPRO_FLASH_CASE(32) REPRO_FLASH_CASE(48)
    REPRO_FLASH_CASE(64) REPRO_FLASH_CASE(80) REPRO_FLASH_CASE(96)
    REPRO_FLASH_CASE(112) REPRO_FLASH_CASE(128)
#undef REPRO_FLASH_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. window <= 0: no sliding window.
// Returns the CUDA error code of the launch (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int KV, int D, float scale,
                        int causal, int window, int dtype, void* stream) {
  if (D % 16 != 0 || D > DMAX || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_f32(q, k, v, o, B, S, H, KV, D, scale, causal, window,
                              st);
  if (dtype == 1)
    return (int)dispatch_bf16(q, k, v, o, B, S, H, KV, D, scale, causal,
                              window, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
