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
// What bounds it on this card. By bytes (q, k, v once, float32 log_w once,
// o and the final state once): ~51 MB at B=1, T=2048, H=32, K=V=64, bf16
// (~84 MB float32), ~15 us (25 us) at 3.35 TB/s; the matrix products are
// ~2 GFLOP (~2 us of bf16 tensor cores, ~12 us of 3xTF32). One design, two
// routes chosen by dtype in route(): three launches, all of them parallel
// over (chunk, head, batch) but the middle one, on chunks of MC = 64 tokens
// cut into four sub-chunks of 16 (one warp's rows, one mma row tile). The
// TPU kernel's sequential chunk axis, with S in VMEM scratch, becomes the
// elementwise launch 2; its (C, C, K) pairwise tensor (4 MB of VMEM at
// C = 128) exists here only as 16 x 16 diagonal sub-blocks, one lane's loop
// over k per pair.
//   1. gla_scan_chunk_state_kernel: each chunk's own state dS_c = (k * 2^(later
//      log2 decays of the chunk))^T v on mma.sync, and its decay 2^(sum of
//      its log2 decays), into float32 scratch (1024 CTAs at the served
//      shape).
//   2. gla_scan_state_prefix_kernel: S_c = decay_c * S_(c-1) + dS_c, elementwise
//      per (k, v): one thread per state element walks the chunks, its loads
//      independent of the recurrence, and leaves in the scratch the state
//      each chunk starts from; the final state goes out once. The serial
//      path is T / MC fused multiply-adds.
//   3. gla_scan_chunk_output_kernel: o of each chunk, warp a for sub-chunk a:
//      - inter: (q * 2^(P_a + Lr)) @ S_(c-1), P_a the log2 decay of the
//        chunk's sub-chunks before a, Lr the local read decay inside a;
//      - off-diagonal sub-blocks b < a, factored at the start of a:
//        A_ab = (q * 2^(Lr + G_ab)) @ (k * 2^(Sloc))^T, G_ab the log2 decay
//        of the sub-chunks strictly between b and a, Sloc the decay of the
//        tokens after j inside b; then A_ab @ v_b;
//      - diagonal sub-block pairwise, 2^(Lr[t] - Ll[j]) on the pairs the mask
//        keeps, Ll the local inclusive log2 decay; the rwkv bonus u takes
//        the place of the decay on its diagonal; then A_aa @ v_a.
//   Stability. Decays enter in log2 units, each token's clamped at -64 (a
//   weight across such a token is below 2^-64 either way). Every exponent
//   is a sum of non-positive decays, or, in the diagonal sub-block, the
//   difference of two local cumulative sums of which the later one extends
//   the earlier, so it is <= 0 in float32 too; masked pairs take -inf.
//   Factors may underflow to 0, never overflow. No cumulative sum spans
//   more than 16 tokens (|sum| <= 1024 after the clamp), so a difference
//   of two keeps ~1e-4 relative accuracy even beside RWKV6's floor of
//   -22026 per token (a form that subtracts chunk-wide sums, ~7e5 there
//   where a float32 ulp is 0.06, is off by whole units).
//   Parallelism: 1024 CTAs per launch at the served shape, not one per
//   (batch, head), and the serial part is one FMA per state element per
//   chunk. Exps: ex2.approx, pairwise only inside the 16-token diagonal
//   sub-blocks (6 of each lane's 8 pairs formed where the mask keeps 4.25),
//   plus the decayed q and k and the sub-chunk factors: ~68 M at the served
//   shape. Loads: 16-byte cp.async of q, k and v rows into padded tiles,
//   log_w by one thread per (sub-chunk, channel), coalesced across
//   channels, every load of a CTA issued before its first use.
//   Scratch: B * H * ceil(T / MC) * (K * V + K) floats of chunk states and
//   decays (16.8 MB at the served shape), allocated by the wrapper at the
//   size gla_scan_scratch_floats reports. Launches per call: 3;
//   gla_scan.launches counts calls. What holds both routes back: the three
//   launches move the chunk states through the scratch (written, rewritten
//   and read) and log_w twice, ~152 MB bf16 (~200 MB float32) at the served
//   shape against the bound's 51 (84).
//
// bfloat16 q, k, v (route "mma"; RWKV6's and Zamba2's prefill): every
//   product on mma.sync m16n8k16 (bf16 in, float32 accumulate), A and B
//   from ldmatrix of 16-byte padded rows (conflict-free) or from registers.
//   Operands that are not bf16 inputs (decayed q and k, the state, the
//   intra scores) go in as a bf16 pair hi + lo with three products (lo @ lo
//   dropped), ~16 bits of mantissa: with one bf16 rounding of any one of
//   them in place of the pair, the 5e-2 tolerance failed at T = 2048 with
//   weak decays (tests/test_torch_gla_design.py mirrors this arithmetic on
//   the CPU). The output kernel keeps 83,472 bytes of tiles at K = V = 64,
//   so two CTAs share an SM.
//
// float32 q, k, v (route "mma.3xtf32"; float32 models): the same kernels
//   with float32 tiles and operands (gla_scan_chunk_state_tf32_kernel,
//   gla_scan_chunk_output_tf32_kernel, the same prefix kernel), every
//   product on mma.sync m16n8k8 in TF32. One TF32 rounding keeps 11 bits of
//   an operand, which misses the 2e-4 tolerance (float32 inputs are not
//   exact in TF32, unlike bf16 ones), so every operand, inputs included, is
//   split after its fragment load: hi = cvt.rna.tf32(x), lo =
//   cvt.rna.tf32(x - hi), three products, lo lo dropped (~2^-22 of |a b|).
//   mma.sync takes A and B from registers, so the split costs no shared
//   memory: no hi/lo copies, no transposed tiles (tests/
//   test_torch_gla_f32_design.py mirrors this arithmetic on the CPU, one
//   TF32 rounding in place of the pair beside it). Accumulation: hi-hi
//   products go to a fresh accumulator per part (the inter term, each
//   A @ v) added in float32, hi-lo and lo-hi to one chain of their own, so
//   no hi-hi chain is longer than 8 k-steps.
//   An accumulator's P feeds the next product's A fragment as it stands: a
//   k-step takes tokens 2 tig and 2 tig + 1 at A columns tig and tig + 4,
//   and v's rows are read in that order. Tiles (Tiles32): 37,888 bytes for
//   the state kernel and 107,024 for the output kernel at K = V = 64, so
//   two output CTAs (8 warps) share an SM. Held back further than the bf16
//   route by 1.6x its bytes and twice its tensor instructions (k = 8 a
//   product instead of 16, each B fragment split in registers).
//
// Inputs and outputs stay in the model layout (B, T, H, .): both paths read
// a head's rows with strides, so the wrapper copies nothing. A ragged last
// chunk is masked here: past T, q = k = v = 0 and log_w = 0 (no decay),
// which leaves S exact, and no output row is written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>  // INFINITY
#include <stdint.h>

namespace {

constexpr int MC = 64;            // tokens per chunk
constexpr int SUB = 16;           // tokens per sub-chunk: one warp's rows
constexpr int NSUB = MC / SUB;    // one warp per sub-chunk
constexpr int MMA_THREADS = 32 * NSUB;
constexpr int PREFIX_THREADS = 256;
constexpr int PREFIX_BATCH = 8;   // chunks whose loads a prefix thread issues at once
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LW2_FLOOR = -64.f;  // per-token log2 decay clamp
constexpr int KMAX = 64;          // K, V: multiples of 16 up to 64

// Shared-memory tiles of one chunk. bf16 rows are padded by 8 elements
// (16 bytes), so the 8 rows of every ldmatrix fall in distinct bank groups;
// float32 rows by 4.
template <int K, int V>
struct Tiles {
  static constexpr int KP = K + 8, VP = V + 8, KF = K + 4;
  static constexpr int TILE_K = MC * KP * 2;     // bytes of a [MC][KP] bf16 tile
  static constexpr int TILE_V = MC * VP * 2;
  static constexpr int TILE_S = K * VP * 2;      // [K][VP] bf16
  static constexpr int LL = MC * KF * 4;         // [MC][KF] float32
  static constexpr int TOT = NSUB * K * 4;       // [NSUB][K] float32
  static constexpr int ZERO = KF * 4;            // one row of zeros
  static constexpr int U = K * 4;                // the bonus u
  // chunk_state: k (then its decayed hi part), decayed lo part, v, totals
  static constexpr int STATE_BYTES = 2 * TILE_K + TILE_V + TOT;
  // chunk_output: q, k, k_suf hi, k_suf lo, v, Ll, totals, a zero row, u,
  // state hi, state lo
  static constexpr int OUTPUT_BYTES =
      4 * TILE_K + TILE_V + LL + TOT + ZERO + U + 2 * TILE_S;
};

// The float32 route's tiles, all float32, no hi/lo copies (operands are
// split in registers). An m16n8k8 fragment load has lane (gid, tig) read row
// gid, column tig of an 8 x 4 block (A from [m][k], B from [n][k]: rows of
// KA = K + 4 floats put the eight rows in distinct bank quads), row tig,
// column gid (A from [k][m], B from [k][n]: rows of K + 8 or V + 8, eight
// banks apart), or row 2 tig (+ 1), column gid (v as the B operand of a
// product whose A is an accumulator, below: rows of V + 4).
template <int K, int V>
struct Tiles32 {
  static constexpr int KA = K + 4, KT = K + 8, VT = V + 8, VP = V + 4;
  // chunk_state: k (then decayed) [MC][KT], v [MC][VT], totals
  static constexpr int STATE_BYTES = 4 * (MC * KT + MC * VT + NSUB * K);
  // chunk_output: q, k, k * 2^Sloc and Ll [MC][KA], v [MC][VP], the state
  // [K][VT], totals, a zero row, u
  static constexpr int OUTPUT_BYTES =
      4 * (4 * MC * KA + MC * VP + K * VT + NSUB * K + KA + K);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Four consecutive values from shared memory: 16 bytes of float32, or 8
// bytes of bf16 widened to float32.
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}

// x as a bf16 pair: hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split_bf16(float x, __nv_bfloat16& hi,
                                           __nv_bfloat16& lo) {
  hi = __float2bfloat16(x);
  lo = __float2bfloat16(x - __bfloat162float(hi));
}

// (x0, x1) as two packed bf16 pairs: hi halves and lo halves.
__device__ __forceinline__ void split_pack(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// c += a (16x16, row) * b (16x8, col); bf16 inputs, float32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += (a_hi + a_lo) (b_hi + b_lo), lo * lo dropped.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma(c, al, bh0, bh1);
  mma(c, ah, bl0, bl1);
  mma(c, ah, bh0, bh1);
}

// c += (a_hi + a_lo) b for an exact bf16 b.
__device__ __forceinline__ void mma2(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t b0,
                                     uint32_t b1) {
  mma(c, al, b0, b1);
  mma(c, ah, b0, b1);
}

// x as a TF32 pair: hi = cvt.rna.tf32(x) (round to nearest, ties away from
// zero, 10 explicit mantissa bits, the low 13 bits 0), lo = cvt.rna.tf32(x - hi).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// c += a (16x8, row) * b (8x8, col); tf32 inputs, float32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: hh += a_hi b_hi and cross += a_hi b_lo + a_lo b_hi (lo lo
// dropped), each float32 factor split into TF32 hi + lo. wgmma truncates
// the sums it accumulates toward zero (flash_attention.cu, "Accumulation"),
// so the cross terms, 2^-11 of the products, keep a chain of their own and
// hh takes one accumulation a k-step.
__device__ __forceinline__ void mma3_tf32(float (&hh)[4], float (&cross)[4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], float b0,
                                          float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(cross, al, bh0, bh1);
  mma_tf32(cross, ah, bl0, bl1);
  mma_tf32(hh, ah, bh0, bh1);
}

// Four 8x8 b16 matrices from shared memory; lane L gives the row address of
// matrix L / 8, row L % 8. trans: each matrix transposed.
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// B fragments of two 8-column n-tiles (n0, n0 + 8) over the 16 rows k0..k0+15
// of a row-major [k][n] bf16 tile with rows of `ld` elements:
// r = {b0, b1} of n-tile n0, then {b0, b1} of n-tile n0 + 8.
__device__ __forceinline__ void ldsm_b_rowmajor(uint32_t (&r)[4],
                                                const __nv_bfloat16* tile,
                                                int ld, int k0, int n0,
                                                int lane) {
  const int row = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int col = n0 + (lane >> 4) * 8;
  ldsm_t(r, smem_u32(tile + row * ld + col));
}

// B fragments of two n-tiles (n0, n0 + 8) over k0..k0+15 of a tile stored
// [n][k] (B^T row-major), same register order.
__device__ __forceinline__ void ldsm_b_colmajor(uint32_t (&r)[4],
                                                const __nv_bfloat16* tile,
                                                int ld, int k0, int n0,
                                                int lane) {
  const int row = n0 + (lane & 7) + (lane >> 4) * 8;
  const int col = k0 + ((lane >> 3) & 1) * 8;
  ldsm(r, smem_u32(tile + row * ld + col));
}

// A fragment (16 x 16) of rows m0..m0+15, columns k0..k0+15 of A = X^T, for
// a tile X stored [k][m] with rows of `ld` elements.
__device__ __forceinline__ void ldsm_a_transposed(uint32_t (&r)[4],
                                                  const __nv_bfloat16* tile,
                                                  int ld, int k0, int m0,
                                                  int lane) {
  const int mi = lane >> 3;
  const int row = k0 + (lane & 7) + (mi >> 1) * 8;
  const int col = m0 + (mi & 1) * 8;
  ldsm_t(r, smem_u32(tile + row * ld + col));
}

// Copy the chunk's MC rows of a (B, T, H, W) bf16 or float32 tensor into a
// [MC][LD] tile; rows past T are zero-filled.
template <int W, int LD = W + 8, typename E>
__device__ __forceinline__ void load_rows(E* tile, const E* src, int b,
                                          int t0, int T, int H, int h,
                                          int tid) {
  constexpr int PIECE = 16 / sizeof(E);  // elements per 16-byte copy
  constexpr int CH = W / PIECE;          // copies per row
#pragma unroll
  for (int i = tid; i < MC * CH; i += MMA_THREADS) {
    const int r = i / CH, c = (i % CH) * PIECE;
    const bool in = t0 + r < T;
    const E* g = src + (in ? (((size_t)b * T + t0 + r) * H + h) * W + c : 0);
    cp_async16(smem_u32(tile + r * LD + c), g, in ? 16 : 0);
  }
}

// The log2 decays of (sub-chunk s, channel ch) tasks: this thread's tasks are
// tid, tid + MMA_THREADS, ... < NSUB * K. load() issues every load of them
// at once (16 clamped log2 decays per task; rows past T have log w = 0);
// scan() then forms each task's local inclusive prefix (written to ll when
// given), its total (written to tot) and, in x, its exclusive suffix.
template <int K>
struct ScanTasks {
  static constexpr int N = (NSUB * K + MMA_THREADS - 1) / MMA_THREADS;
  float x[N][SUB];

  __device__ __forceinline__ void load(const float* __restrict__ log_w, int b,
                                       int t0, int T, int H, int h, int tid) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int task = tid + n * MMA_THREADS;
      const int s = task / K, ch = task % K;
#pragma unroll
      for (int i = 0; i < SUB; ++i) {
        const int t = t0 + s * SUB + i;
        x[n][i] = task < NSUB * K && t < T
                      ? log_w[(((size_t)b * T + t) * H + h) * K + ch]
                      : 0.f;
      }
    }
  }

  __device__ __forceinline__ void scan(int tid, float* ll, float* tot) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int task = tid + n * MMA_THREADS;
      if (task >= NSUB * K) break;
      const int s = task / K, ch = task % K;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < SUB; ++i) {
        x[n][i] = fmaxf(x[n][i] * LOG2E, LW2_FLOOR);
        acc += x[n][i];
        if (ll) ll[(s * SUB + i) * (K + 4) + ch] = acc;
      }
      tot[s * K + ch] = acc;
      acc = 0.f;
#pragma unroll
      for (int i = SUB - 1; i >= 0; --i) {
        const float lw = x[n][i];
        x[n][i] = acc;
        acc += lw;
      }
    }
  }
};

// 1. Chunk-local states. grid: (n_chunks, H, B); block: MMA_THREADS.
// dS_c = (k * 2^(Sloc + R_s))^T v for (K, V), R_s the log2 decay of the
// sub-chunks after s, into states[(b, h, c)]; 2^(chunk's log2 decay) into
// decay[(b, h, c)].
template <int K, int V>
__global__ void __launch_bounds__(MMA_THREADS)
gla_scan_chunk_state_kernel(const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const float* __restrict__ log_w,
                       float* __restrict__ states, float* __restrict__ decay,
                       int T, int H) {
  using Tl = Tiles<K, V>;
  extern __shared__ __align__(16) unsigned char tiles[];
  __nv_bfloat16* kh = reinterpret_cast<__nv_bfloat16*>(tiles);       // [MC][KP]
  __nv_bfloat16* kl = kh + MC * Tl::KP;                              // [MC][KP]
  __nv_bfloat16* vs = kl + MC * Tl::KP;                              // [MC][VP]
  float* tot = reinterpret_cast<float*>(vs + MC * Tl::VP);           // [NSUB][K]

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t0 = c * MC;
  load_rows<K>(kh, k, b, t0, T, H, h, tid);
  load_rows<V>(vs, v, b, t0, T, H, h, tid);
  ScanTasks<K> scan;
  scan.load(log_w, b, t0, T, H, h, tid);
  scan.scan(tid, nullptr, tot);
  cp_async_wait_all();
  __syncthreads();

  // k * 2^(Sloc + R_s) as a bf16 pair, in place of k
#pragma unroll
  for (int n = 0; n < ScanTasks<K>::N; ++n) {
    const int task = tid + n * MMA_THREADS;
    if (task >= NSUB * K) break;
    const int s = task / K, ch = task % K;
    float r = 0.f;
    for (int s2 = s + 1; s2 < NSUB; ++s2) r += tot[s2 * K + ch];
#pragma unroll
    for (int i = 0; i < SUB; ++i) {
      const int row = s * SUB + i;
      const float x = __bfloat162float(kh[row * Tl::KP + ch]) * ex2(scan.x[n][i] + r);
      split_bf16(x, kh[row * Tl::KP + ch], kl[row * Tl::KP + ch]);
    }
  }
  if (tid < K) {
    float lc = 0.f;
    for (int s = 0; s < NSUB; ++s) lc += tot[s * K + tid];
    decay[(((size_t)b * H + h) * gridDim.x + c) * K + tid] = ex2(lc);
  }
  __syncthreads();

  // dS (K x V): items of 16 rows x 16 columns, round-robin over the warps
  float* out = states + (((size_t)b * H + h) * gridDim.x + c) * K * V;
  const int gid = lane >> 2, tig = lane & 3;
  for (int item = warp; item < (K / 16) * (V / 16); item += NSUB) {
    const int m0 = (item / (V / 16)) * 16, n0 = (item % (V / 16)) * 16;
    float acc[2][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < MC; k0 += 16) {
      uint32_t ah[4], al[4], bv[4];
      ldsm_a_transposed(ah, kh, Tl::KP, k0, m0, lane);
      ldsm_a_transposed(al, kl, Tl::KP, k0, m0, lane);
      ldsm_b_rowmajor(bv, vs, Tl::VP, k0, n0, lane);
      mma2(acc[0], ah, al, bv[0], bv[1]);
      mma2(acc[1], ah, al, bv[2], bv[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = n0 + nt * 8 + 2 * tig;
      *reinterpret_cast<float2*>(out + (m0 + gid) * V + col) =
          make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(out + (m0 + gid + 8) * V + col) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

// 2. Prefix over chunks. One thread per (b, h, k, v): states[(b, h, c)]
// holds dS_c on entry and the state chunk c starts from on exit; the final
// state goes to state_out. grid: ceil(B * H * K * V / PREFIX_THREADS).
__global__ void __launch_bounds__(PREFIX_THREADS)
gla_scan_state_prefix_kernel(float* __restrict__ states,
                        const float* __restrict__ decay,
                        float* __restrict__ state_out, int n_bh, int n_chunks,
                        int K, int V) {
  const long long i = (long long)blockIdx.x * PREFIX_THREADS + threadIdx.x;
  const int KV = K * V;
  if (i >= (long long)n_bh * KV) return;
  const int bh = (int)(i / KV), e = (int)(i % KV), kk = e / V;
  float* p = states + (size_t)bh * n_chunks * KV + e;
  const float* d = decay + (size_t)bh * n_chunks * K + kk;
  float s = 0.f;
  for (int c0 = 0; c0 < n_chunks; c0 += PREFIX_BATCH) {
    float ds[PREFIX_BATCH], dc[PREFIX_BATCH];
#pragma unroll
    for (int j = 0; j < PREFIX_BATCH; ++j) {
      const bool in = c0 + j < n_chunks;
      ds[j] = in ? p[(size_t)(c0 + j) * KV] : 0.f;
      dc[j] = in ? d[(size_t)(c0 + j) * K] : 1.f;
    }
#pragma unroll
    for (int j = 0; j < PREFIX_BATCH; ++j) {
      if (c0 + j < n_chunks) p[(size_t)(c0 + j) * KV] = s;
      s = fmaf(dc[j], s, ds[j]);
    }
  }
  state_out[i] = s;
}

// 3. Outputs. grid: (n_chunks, H, B); block: MMA_THREADS, warp a computes the
// 16 rows of sub-chunk a. states[(b, h, c)]: the state chunk c starts from.
template <int K, int V>
__global__ void __launch_bounds__(MMA_THREADS)
gla_scan_chunk_output_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const float* __restrict__ log_w,
                        const float* __restrict__ u,
                        const float* __restrict__ states,
                        __nv_bfloat16* __restrict__ o, int T, int H, int rwkv) {
  using Tl = Tiles<K, V>;
  constexpr int KP = Tl::KP, VP = Tl::VP, KF = Tl::KF;
  extern __shared__ __align__(16) unsigned char tiles[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(tiles);  // [MC][KP]
  __nv_bfloat16* ks = qs + MC * KP;                            // [MC][KP]
  __nv_bfloat16* ksh = ks + MC * KP;                           // k * 2^Sloc, hi
  __nv_bfloat16* ksl = ksh + MC * KP;                          // and lo
  __nv_bfloat16* vs = ksl + MC * KP;                           // [MC][VP]
  float* ll = reinterpret_cast<float*>(vs + MC * VP);          // [MC][KF]
  float* tot = ll + MC * KF;                                   // [NSUB][K]
  float* zero = tot + NSUB * K;                                // [KF]
  float* us = zero + KF;                                       // [K]: u or 0
  __nv_bfloat16* sh = reinterpret_cast<__nv_bfloat16*>(us + K);  // [K][VP]
  __nv_bfloat16* sl = sh + K * VP;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, a = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int t0 = c * MC;
  load_rows<K>(qs, q, b, t0, T, H, h, tid);
  load_rows<K>(ks, k, b, t0, T, H, h, tid);
  load_rows<V>(vs, v, b, t0, T, H, h, tid);
  // issue every load before any use: the state this chunk starts from,
  // the log2 decays, u
  constexpr int NS = (K * V / 4 + MMA_THREADS - 1) / MMA_THREADS;
  const float4* st = reinterpret_cast<const float4*>(
      states + (((size_t)b * H + h) * gridDim.x + c) * K * V);
  float4 sx[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const int i = tid + n * MMA_THREADS;
    sx[n] = i < K * V / 4 ? st[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  ScanTasks<K> scan;
  scan.load(log_w, b, t0, T, H, h, tid);
  for (int i = tid; i < K; i += MMA_THREADS) us[i] = u ? u[(size_t)h * K + i] : 0.f;
  for (int i = tid; i < KF; i += MMA_THREADS) zero[i] = 0.f;
  // the state as a bf16 pair
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const int i = tid + n * MMA_THREADS;
    if (i >= K * V / 4) break;
    const int row = (4 * i) / V, col = (4 * i) % V;
    uint32_t h01, l01, h23, l23;
    split_pack(sx[n].x, sx[n].y, h01, l01);
    split_pack(sx[n].z, sx[n].w, h23, l23);
    *reinterpret_cast<uint2*>(sh + row * VP + col) = make_uint2(h01, h23);
    *reinterpret_cast<uint2*>(sl + row * VP + col) = make_uint2(l01, l23);
  }
  scan.scan(tid, ll, tot);
  cp_async_wait_all();
  __syncthreads();

  // k * 2^Sloc as a bf16 pair (the off-diagonal sub-blocks' B operand)
#pragma unroll
  for (int n = 0; n < ScanTasks<K>::N; ++n) {
    const int task = tid + n * MMA_THREADS;
    if (task >= NSUB * K) break;
    const int s = task / K, ch = task % K;
#pragma unroll
    for (int i = 0; i < SUB; ++i) {
      const int row = s * SUB + i;
      split_bf16(__bfloat162float(ks[row * KP + ch]) * ex2(scan.x[n][i]),
                 ksh[row * KP + ch], ksl[row * KP + ch]);
    }
  }
  __syncthreads();

  // this lane's rows r0, r1 and the local read decay Lr of each: Ll of the
  // row itself (ssd) or of the one before it inside the sub-chunk (rwkv)
  const int r0 = a * SUB + gid, r1 = r0 + 8;
  const float* lr0 = rwkv ? (gid == 0 ? zero : ll + (r0 - 1) * KF) : ll + r0 * KF;
  const float* lr1 = rwkv ? ll + (r1 - 1) * KF : ll + r1 * KF;

  // q * 2^Lr in float32, in A-fragment order: per 16 channels, (r0, c),
  // (r0, c + 1), (r1, c), (r1, c + 1), (r0, c + 8), (r0, c + 9), (r1, c + 8),
  // (r1, c + 9) with c = k0 + 2 tig
  float qf[K / 16][8];
#pragma unroll
  for (int kt = 0; kt < K / 16; ++kt) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int col = kt * 16 + 2 * tig + (e & 1) + (e >> 2) * 8;
      const int row = (e >> 1) & 1;
      const float lr = (row ? lr1 : lr0)[col];
      qf[kt][e] = __bfloat162float(qs[(row ? r1 : r0) * KP + col]) * ex2(lr);
    }
  }
  // This lane's channels, in A-fragment order: col(kt, p) = 16 kt + 2 tig +
  // (p & 1) + 8 (p >> 1). fac: 2^g at them, g the log2 decay of a run of
  // sub-chunks. (q * 2^Lr * fac) as bf16 pairs for the channels 16 kt ..:
  float g[K / 16][4], fac[K / 16][4];
  auto lane_col = [&](int kt, int p) {
    return kt * 16 + 2 * tig + (p & 1) + (p >> 1) * 8;
  };
  auto add_decay = [&](int s) {
#pragma unroll
    for (int kt = 0; kt < K / 16; ++kt)
#pragma unroll
      for (int p = 0; p < 4; ++p) g[kt][p] += tot[s * K + lane_col(kt, p)];
  };
  auto set_factors = [&]() {
#pragma unroll
    for (int kt = 0; kt < K / 16; ++kt)
#pragma unroll
      for (int p = 0; p < 4; ++p) fac[kt][p] = ex2(g[kt][p]);
  };
  auto a_frags = [&](int kt, uint32_t (&ah)[4], uint32_t (&al)[4]) {
#pragma unroll
    for (int p = 0; p < 4; ++p)
      split_pack(qf[kt][2 * p] * fac[kt][(p >> 1) * 2],
                 qf[kt][2 * p + 1] * fac[kt][(p >> 1) * 2 + 1], ah[p], al[p]);
  };

  float acc[V / 8][4] = {};

  // inter: (q * 2^(P_a + Lr)) @ S, P_a = the decay of sub-chunks 0 .. a-1
#pragma unroll
  for (int kt = 0; kt < K / 16; ++kt)
#pragma unroll
    for (int p = 0; p < 4; ++p) g[kt][p] = 0.f;
  for (int s = 0; s < a; ++s) add_decay(s);
  set_factors();
#pragma unroll
  for (int kt = 0; kt < K / 16; ++kt) {
    uint32_t ah[4], al[4];
    a_frags(kt, ah, al);
#pragma unroll
    for (int n0 = 0; n0 < V; n0 += 16) {
      uint32_t bh[4], bl[4];
      ldsm_b_rowmajor(bh, sh, VP, kt * 16, n0, lane);
      ldsm_b_rowmajor(bl, sl, VP, kt * 16, n0, lane);
      mma3(acc[n0 / 8], ah, al, bh[0], bh[1], bl[0], bl[1]);
      mma3(acc[n0 / 8 + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
    }
  }

  // off-diagonal sub-blocks b < a, nearest first: g = the decay of the
  // sub-chunks strictly between b and a
#pragma unroll
  for (int kt = 0; kt < K / 16; ++kt)
#pragma unroll
    for (int p = 0; p < 4; ++p) g[kt][p] = 0.f;
  for (int sb = a - 1; sb >= 0; --sb) {
    set_factors();
    float att[2][4] = {};
#pragma unroll
    for (int kt = 0; kt < K / 16; ++kt) {
      uint32_t ah[4], al[4], bh[4], bl[4];
      a_frags(kt, ah, al);
      ldsm_b_colmajor(bh, ksh, KP, kt * 16, sb * SUB, lane);
      ldsm_b_colmajor(bl, ksl, KP, kt * 16, sb * SUB, lane);
      mma3(att[0], ah, al, bh[0], bh[1], bl[0], bl[1]);
      mma3(att[1], ah, al, bh[2], bh[3], bl[2], bl[3]);
    }
    uint32_t ph[4], pl[4];
    split_pack(att[0][0], att[0][1], ph[0], pl[0]);
    split_pack(att[0][2], att[0][3], ph[1], pl[1]);
    split_pack(att[1][0], att[1][1], ph[2], pl[2]);
    split_pack(att[1][2], att[1][3], ph[3], pl[3]);
#pragma unroll
    for (int n0 = 0; n0 < V; n0 += 16) {
      uint32_t bv[4];
      ldsm_b_rowmajor(bv, vs, VP, sb * SUB, n0, lane);
      mma2(acc[n0 / 8], ph, pl, bv[0], bv[1]);
      mma2(acc[n0 / 8 + 1], ph, pl, bv[2], bv[3]);
    }
    add_decay(sb);
  }

  // diagonal sub-block, pairwise. This lane's pairs, in A-fragment order:
  // rows (gid, gid + 8) x columns (2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9)
  // of the sub-chunk. (gid, 2 tig + 8 | 9) lie above the diagonal for every
  // lane and are never formed; (gid + 8, 2 tig | + 1) lie below it for
  // every lane; the other four are kept where the mask says.
  {
    const int base = a * SUB;
    const int j0 = base + 2 * tig;                    // columns j0, j0 + 1
    const int j1 = j0 + 8;                            // columns j1, j1 + 1
    const bool keep0 = rwkv ? 2 * tig < gid : 2 * tig <= gid;
    const bool keep1 = rwkv ? 2 * tig + 1 < gid : 2 * tig + 1 <= gid;
    const bool diag0 = rwkv && 2 * tig == gid, diag1 = rwkv && 2 * tig + 1 == gid;
    // e: (r0, j0), (r0, j0+1), (r1, j0), (r1, j0+1), -, -, (r1, j1), (r1, j1+1)
    float e0 = 0.f, e1 = 0.f, e2 = 0.f, e3 = 0.f, e6 = 0.f, e7 = 0.f;
    // four channels per step: 8-byte bf16 and 16-byte float32 loads
#pragma unroll 2
    for (int ch = 0; ch < K; ch += 4) {
      float q0[4], q1[4], l0[4], l1[4], kj0[4], kj1[4], kj2[4], kj3[4];
      float m0[4], m1[4], m2[4], m3[4], uu[4];
      load4(qs + r0 * KP + ch, q0);
      load4(qs + r1 * KP + ch, q1);
      load4(lr0 + ch, l0);
      load4(lr1 + ch, l1);
      load4(ks + j0 * KP + ch, kj0);
      load4(ks + (j0 + 1) * KP + ch, kj1);
      load4(ks + j1 * KP + ch, kj2);
      load4(ks + (j1 + 1) * KP + ch, kj3);
      load4(ll + j0 * KF + ch, m0);
      load4(ll + (j0 + 1) * KF + ch, m1);
      load4(ll + j1 * KF + ch, m2);
      load4(ll + (j1 + 1) * KF + ch, m3);
      load4(us + ch, uu);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float w0 = diag0 ? uu[x] : ex2(keep0 ? l0[x] - m0[x] : -INFINITY);
        const float w1 = diag1 ? uu[x] : ex2(keep1 ? l0[x] - m1[x] : -INFINITY);
        const float w6 = diag0 ? uu[x] : ex2(keep0 ? l1[x] - m2[x] : -INFINITY);
        const float w7 = diag1 ? uu[x] : ex2(keep1 ? l1[x] - m3[x] : -INFINITY);
        e0 = fmaf(q0[x] * kj0[x], w0, e0);
        e1 = fmaf(q0[x] * kj1[x], w1, e1);
        e2 = fmaf(q1[x] * kj0[x], ex2(l1[x] - m0[x]), e2);
        e3 = fmaf(q1[x] * kj1[x], ex2(l1[x] - m1[x]), e3);
        e6 = fmaf(q1[x] * kj2[x], w6, e6);
        e7 = fmaf(q1[x] * kj3[x], w7, e7);
      }
    }
    uint32_t ph[4], pl[4];
    split_pack(e0, e1, ph[0], pl[0]);
    split_pack(e2, e3, ph[1], pl[1]);
    ph[2] = pl[2] = 0u;
    split_pack(e6, e7, ph[3], pl[3]);
#pragma unroll
    for (int n0 = 0; n0 < V; n0 += 16) {
      uint32_t bv[4];
      ldsm_b_rowmajor(bv, vs, VP, base, n0, lane);
      mma2(acc[n0 / 8], ph, pl, bv[0], bv[1]);
      mma2(acc[n0 / 8 + 1], ph, pl, bv[2], bv[3]);
    }
  }

  // store rows r0, r1 that lie before T
#pragma unroll
  for (int nt = 0; nt < V / 8; ++nt) {
    const int col = nt * 8 + 2 * tig;
    if (t0 + r0 < T)
      *reinterpret_cast<__nv_bfloat162*>(
          o + (((size_t)b * T + t0 + r0) * H + h) * V + col) =
          __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
    if (t0 + r1 < T)
      *reinterpret_cast<__nv_bfloat162*>(
          o + (((size_t)b * T + t0 + r1) * H + h) * V + col) =
          __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
  }
}

// ---------------------------------------------------------------------------
// float32 route: the same three launches in 3xTF32 on mma.sync
// ---------------------------------------------------------------------------

// A fragment (16 x 8, tf32 hi and lo) of rows m0..m0+15, columns k0..k0+7 of
// A = X^T for a float32 tile X stored [k][m] with rows of `ld` floats.
__device__ __forceinline__ void a_frag_transposed(uint32_t (&ah)[4],
                                                  uint32_t (&al)[4],
                                                  const float* tile, int ld,
                                                  int k0, int m0, int lane) {
  const float* x = tile + (k0 + (lane & 3)) * ld + m0 + (lane >> 2);
  split_tf32(x[0], ah[0], al[0]);            // (gid, tig)
  split_tf32(x[8], ah[1], al[1]);            // (gid + 8, tig)
  split_tf32(x[4 * ld], ah[2], al[2]);       // (gid, tig + 4)
  split_tf32(x[4 * ld + 8], ah[3], al[3]);   // (gid + 8, tig + 4)
}

// 1. Chunk-local states, as gla_scan_chunk_state_kernel. grid: (n_chunks, H,
// B); block: MMA_THREADS.
template <int K, int V>
__global__ void __launch_bounds__(MMA_THREADS)
gla_scan_chunk_state_tf32_kernel(const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 const float* __restrict__ log_w,
                                 float* __restrict__ states,
                                 float* __restrict__ decay, int T, int H) {
  using Tl = Tiles32<K, V>;
  constexpr int KT = Tl::KT, VT = Tl::VT;
  extern __shared__ __align__(16) unsigned char tiles[];
  float* kd = reinterpret_cast<float*>(tiles);  // [MC][KT]: k, then decayed
  float* vs = kd + MC * KT;                     // [MC][VT]
  float* tot = vs + MC * VT;                    // [NSUB][K]

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t0 = c * MC;
  load_rows<K, KT>(kd, k, b, t0, T, H, h, tid);
  load_rows<V, VT>(vs, v, b, t0, T, H, h, tid);
  ScanTasks<K> scan;
  scan.load(log_w, b, t0, T, H, h, tid);
  scan.scan(tid, nullptr, tot);
  cp_async_wait_all();
  __syncthreads();

  // k * 2^(Sloc + R_s) in place
#pragma unroll
  for (int n = 0; n < ScanTasks<K>::N; ++n) {
    const int task = tid + n * MMA_THREADS;
    if (task >= NSUB * K) break;
    const int s = task / K, ch = task % K;
    float r = 0.f;
    for (int s2 = s + 1; s2 < NSUB; ++s2) r += tot[s2 * K + ch];
#pragma unroll
    for (int i = 0; i < SUB; ++i) kd[(s * SUB + i) * KT + ch] *= ex2(scan.x[n][i] + r);
  }
  if (tid < K) {
    float lc = 0.f;
    for (int s = 0; s < NSUB; ++s) lc += tot[s * K + tid];
    decay[(((size_t)b * H + h) * gridDim.x + c) * K + tid] = ex2(lc);
  }
  __syncthreads();

  // dS (K x V) = kd^T v: items of 16 rows x 16 columns, round-robin over the
  // warps, MC / 8 k-steps of three mma each per 8 columns
  float* out = states + (((size_t)b * H + h) * gridDim.x + c) * K * V;
  const int gid = lane >> 2, tig = lane & 3;
  for (int item = warp; item < (K / 16) * (V / 16); item += NSUB) {
    const int m0 = (item / (V / 16)) * 16, n0 = (item % (V / 16)) * 16;
    float hh[2][4] = {}, cross[2][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < MC; k0 += 8) {
      uint32_t ah[4], al[4];
      a_frag_transposed(ah, al, kd, KT, k0, m0, lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float* vb = vs + (k0 + tig) * VT + n0 + nt * 8 + gid;
        mma3_tf32(hh[nt], cross[nt], ah, al, vb[0], vb[4 * VT]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = n0 + nt * 8 + 2 * tig;
      *reinterpret_cast<float2*>(out + (m0 + gid) * V + col) =
          make_float2(hh[nt][0] + cross[nt][0], hh[nt][1] + cross[nt][1]);
      *reinterpret_cast<float2*>(out + (m0 + gid + 8) * V + col) =
          make_float2(hh[nt][2] + cross[nt][2], hh[nt][3] + cross[nt][3]);
    }
  }
}

// 3. Outputs, as gla_scan_chunk_output_kernel: warp a computes the 16 rows
// of sub-chunk a. grid: (n_chunks, H, B); block: MMA_THREADS.
template <int K, int V>
__global__ void __launch_bounds__(MMA_THREADS)
gla_scan_chunk_output_tf32_kernel(const float* __restrict__ q,
                                  const float* __restrict__ k,
                                  const float* __restrict__ v,
                                  const float* __restrict__ log_w,
                                  const float* __restrict__ u,
                                  const float* __restrict__ states,
                                  float* __restrict__ o, int T, int H,
                                  int rwkv) {
  using Tl = Tiles32<K, V>;
  constexpr int KA = Tl::KA, VP = Tl::VP, VT = Tl::VT;
  extern __shared__ __align__(16) unsigned char tiles[];
  float* qs = reinterpret_cast<float*>(tiles);  // [MC][KA]
  float* ks = qs + MC * KA;                     // [MC][KA]
  float* ksuf = ks + MC * KA;                   // [MC][KA]: k * 2^Sloc
  float* ll = ksuf + MC * KA;                   // [MC][KA]
  float* vs = ll + MC * KA;                     // [MC][VP]
  float* ss = vs + MC * VP;                     // [K][VT]: S_(c-1)
  float* tot = ss + K * VT;                     // [NSUB][K]
  float* zero = tot + NSUB * K;                 // [KA]
  float* us = zero + KA;                        // [K]: u or 0

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, a = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int t0 = c * MC;
  load_rows<K, KA>(qs, q, b, t0, T, H, h, tid);
  load_rows<K, KA>(ks, k, b, t0, T, H, h, tid);
  load_rows<V, VP>(vs, v, b, t0, T, H, h, tid);
  // issue every load before any use: the state this chunk starts from,
  // the log2 decays, u
  constexpr int NS = (K * V / 4 + MMA_THREADS - 1) / MMA_THREADS;
  const float4* st = reinterpret_cast<const float4*>(
      states + (((size_t)b * H + h) * gridDim.x + c) * K * V);
  float4 sx[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const int i = tid + n * MMA_THREADS;
    sx[n] = i < K * V / 4 ? st[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  ScanTasks<K> scan;
  scan.load(log_w, b, t0, T, H, h, tid);
  for (int i = tid; i < K; i += MMA_THREADS) us[i] = u ? u[(size_t)h * K + i] : 0.f;
  for (int i = tid; i < KA; i += MMA_THREADS) zero[i] = 0.f;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const int i = tid + n * MMA_THREADS;
    if (i >= K * V / 4) break;
    *reinterpret_cast<float4*>(ss + ((4 * i) / V) * VT + (4 * i) % V) = sx[n];
  }
  scan.scan(tid, ll, tot);
  cp_async_wait_all();
  __syncthreads();

  // k * 2^Sloc (the off-diagonal sub-blocks' B operand)
#pragma unroll
  for (int n = 0; n < ScanTasks<K>::N; ++n) {
    const int task = tid + n * MMA_THREADS;
    if (task >= NSUB * K) break;
    const int s = task / K, ch = task % K;
#pragma unroll
    for (int i = 0; i < SUB; ++i) {
      const int row = s * SUB + i;
      ksuf[row * KA + ch] = ks[row * KA + ch] * ex2(scan.x[n][i]);
    }
  }
  __syncthreads();

  // this lane's rows r0, r1 and the local read decay Lr of each: Ll of the
  // row itself (ssd) or of the one before it inside the sub-chunk (rwkv)
  const int r0 = a * SUB + gid, r1 = r0 + 8;
  const float* lr0 = rwkv ? (gid == 0 ? zero : ll + (r0 - 1) * KA) : ll + r0 * KA;
  const float* lr1 = rwkv ? ll + (r1 - 1) * KA : ll + r1 * KA;

  // This lane's channels, in A-fragment order: col(kt, j) = 8 kt + tig + 4 j.
  // q * 2^Lr in float32 at (r0, col(kt, 0)), (r1, col(kt, 0)), (r0, col(kt,
  // 1)), (r1, col(kt, 1)); fac: 2^g at the lane's channels, g the log2 decay
  // of a run of sub-chunks; (q * 2^Lr * fac) split into tf32 pairs per 8
  // channels.
  float qf[K / 8][4], g[K / 8][2], fac[K / 8][2];
  auto lane_col = [&](int kt, int j) { return kt * 8 + tig + 4 * j; };
#pragma unroll
  for (int kt = 0; kt < K / 8; ++kt)
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int col = lane_col(kt, p >> 1);
      qf[kt][p] = qs[((p & 1) ? r1 : r0) * KA + col] * ex2(((p & 1) ? lr1 : lr0)[col]);
    }
  auto add_decay = [&](int s) {
#pragma unroll
    for (int kt = 0; kt < K / 8; ++kt)
#pragma unroll
      for (int j = 0; j < 2; ++j) g[kt][j] += tot[s * K + lane_col(kt, j)];
  };
  auto clear_decay = [&]() {
#pragma unroll
    for (int kt = 0; kt < K / 8; ++kt)
#pragma unroll
      for (int j = 0; j < 2; ++j) g[kt][j] = 0.f;
  };
  auto set_factors = [&]() {
#pragma unroll
    for (int kt = 0; kt < K / 8; ++kt)
#pragma unroll
      for (int j = 0; j < 2; ++j) fac[kt][j] = ex2(g[kt][j]);
  };
  auto a_frags = [&](int kt, uint32_t (&ah)[4], uint32_t (&al)[4]) {
#pragma unroll
    for (int p = 0; p < 4; ++p) split_tf32(qf[kt][p] * fac[kt][p >> 1], ah[p], al[p]);
  };

  // acc: the hi-hi products, each part summed in an accumulator of its own
  // and added in float32; cross: every hi-lo and lo-hi product
  float acc[V / 8][4] = {}, cross[V / 8][4] = {};

  // acc += P @ v of sub-chunk sb for P (16 x 16 tokens) in accumulator
  // layout, p[nt] = (gid, 8 nt + 2 tig + {0, 1}), (gid + 8, the same): k-step
  // nt takes token 8 nt + 2 tig at A column tig and token 8 nt + 2 tig + 1 at
  // tig + 4, and B reads v's rows in that order.
  auto add_pv = [&](const float (&p)[2][4], int sb) {
    float part[V / 8][4] = {};
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
      uint32_t ah[4], al[4];
      split_tf32(p[kt][0], ah[0], al[0]);
      split_tf32(p[kt][2], ah[1], al[1]);
      split_tf32(p[kt][1], ah[2], al[2]);
      split_tf32(p[kt][3], ah[3], al[3]);
      const float* vb = vs + (sb * SUB + kt * 8 + 2 * tig) * VP + gid;
#pragma unroll
      for (int nt = 0; nt < V / 8; ++nt)
        mma3_tf32(part[nt], cross[nt], ah, al, vb[nt * 8], vb[VP + nt * 8]);
    }
#pragma unroll
    for (int nt = 0; nt < V / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] += part[nt][e];
  };

  // inter: (q * 2^(P_a + Lr)) @ S, P_a = the decay of sub-chunks 0 .. a-1
  clear_decay();
  for (int s = 0; s < a; ++s) add_decay(s);
  set_factors();
#pragma unroll
  for (int kt = 0; kt < K / 8; ++kt) {
    uint32_t ah[4], al[4];
    a_frags(kt, ah, al);
    const float* srow = ss + (kt * 8 + tig) * VT + gid;
#pragma unroll
    for (int nt = 0; nt < V / 8; ++nt)
      mma3_tf32(acc[nt], cross[nt], ah, al, srow[nt * 8], srow[4 * VT + nt * 8]);
  }

  // off-diagonal sub-blocks b < a, nearest first: g = the decay of the
  // sub-chunks strictly between b and a
  clear_decay();
  for (int sb = a - 1; sb >= 0; --sb) {
    set_factors();
    float hh[2][4] = {}, cr[2][4] = {};
#pragma unroll
    for (int kt = 0; kt < K / 8; ++kt) {
      uint32_t ah[4], al[4];
      a_frags(kt, ah, al);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float* kb = ksuf + (sb * SUB + nt * 8 + gid) * KA + kt * 8 + tig;
        mma3_tf32(hh[nt], cr[nt], ah, al, kb[0], kb[4]);
      }
    }
    float p[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[nt][e] = hh[nt][e] + cr[nt][e];
    add_pv(p, sb);
    add_decay(sb);
  }

  // diagonal sub-block, pairwise, as the bf16 kernel: this lane's pairs in
  // accumulator layout, rows (gid, gid + 8) x columns (2 tig, 2 tig + 1,
  // 2 tig + 8, 2 tig + 9) of the sub-chunk; (gid, 2 tig + 8 | 9) lie above
  // the diagonal for every lane and are never formed
  {
    const int base = a * SUB;
    const int j0 = base + 2 * tig;                    // columns j0, j0 + 1
    const int j1 = j0 + 8;                            // columns j1, j1 + 1
    const bool keep0 = rwkv ? 2 * tig < gid : 2 * tig <= gid;
    const bool keep1 = rwkv ? 2 * tig + 1 < gid : 2 * tig + 1 <= gid;
    const bool diag0 = rwkv && 2 * tig == gid, diag1 = rwkv && 2 * tig + 1 == gid;
    // e: (r0, j0), (r0, j0+1), (r1, j0), (r1, j0+1), -, -, (r1, j1), (r1, j1+1)
    float e0 = 0.f, e1 = 0.f, e2 = 0.f, e3 = 0.f, e6 = 0.f, e7 = 0.f;
#pragma unroll 2
    for (int ch = 0; ch < K; ch += 4) {
      float q0[4], q1[4], l0[4], l1[4], kj0[4], kj1[4], kj2[4], kj3[4];
      float m0[4], m1[4], m2[4], m3[4], uu[4];
      load4(qs + r0 * KA + ch, q0);
      load4(qs + r1 * KA + ch, q1);
      load4(lr0 + ch, l0);
      load4(lr1 + ch, l1);
      load4(ks + j0 * KA + ch, kj0);
      load4(ks + (j0 + 1) * KA + ch, kj1);
      load4(ks + j1 * KA + ch, kj2);
      load4(ks + (j1 + 1) * KA + ch, kj3);
      load4(ll + j0 * KA + ch, m0);
      load4(ll + (j0 + 1) * KA + ch, m1);
      load4(ll + j1 * KA + ch, m2);
      load4(ll + (j1 + 1) * KA + ch, m3);
      load4(us + ch, uu);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float w0 = diag0 ? uu[x] : ex2(keep0 ? l0[x] - m0[x] : -INFINITY);
        const float w1 = diag1 ? uu[x] : ex2(keep1 ? l0[x] - m1[x] : -INFINITY);
        const float w6 = diag0 ? uu[x] : ex2(keep0 ? l1[x] - m2[x] : -INFINITY);
        const float w7 = diag1 ? uu[x] : ex2(keep1 ? l1[x] - m3[x] : -INFINITY);
        e0 = fmaf(q0[x] * kj0[x], w0, e0);
        e1 = fmaf(q0[x] * kj1[x], w1, e1);
        e2 = fmaf(q1[x] * kj0[x], ex2(l1[x] - m0[x]), e2);
        e3 = fmaf(q1[x] * kj1[x], ex2(l1[x] - m1[x]), e3);
        e6 = fmaf(q1[x] * kj2[x], w6, e6);
        e7 = fmaf(q1[x] * kj3[x], w7, e7);
      }
    }
    const float p[2][4] = {{e0, e1, e2, e3}, {0.f, 0.f, e6, e7}};
    add_pv(p, a);
  }

  // store rows r0, r1 that lie before T
#pragma unroll
  for (int nt = 0; nt < V / 8; ++nt) {
    const int col = nt * 8 + 2 * tig;
    if (t0 + r0 < T)
      *reinterpret_cast<float2*>(o + (((size_t)b * T + t0 + r0) * H + h) * V + col) =
          make_float2(acc[nt][0] + cross[nt][0], acc[nt][1] + cross[nt][1]);
    if (t0 + r1 < T)
      *reinterpret_cast<float2*>(o + (((size_t)b * T + t0 + r1) * H + h) * V + col) =
          make_float2(acc[nt][2] + cross[nt][2], acc[nt][3] + cross[nt][3]);
  }
}

// The three launches of either route, on q/k/v/o of element type E.
template <typename E>
using StateKernel = void (*)(const E*, const E*, const float*, float*, float*,
                             int, int);
template <typename E>
using OutputKernel = void (*)(const E*, const E*, const E*, const float*,
                              const float*, const float*, E*, int, int, int);

template <typename E>
cudaError_t launch_chunked(StateKernel<E> state_kernel, int state_bytes,
                           OutputKernel<E> output_kernel, int output_bytes,
                           const void* q, const void* k, const void* v,
                           const float* log_w, const float* u, void* o,
                           float* state_out, float* scratch, int B, int T,
                           int H, int K, int V, int rwkv, cudaStream_t stream) {
  const int n_chunks = (T + MC - 1) / MC;
  float* states = scratch;
  float* decay = scratch + (size_t)B * H * n_chunks * K * V;
  const auto* qe = static_cast<const E*>(q);
  const auto* ke = static_cast<const E*>(k);
  const auto* ve = static_cast<const E*>(v);
  cudaError_t err = cudaFuncSetAttribute(
      state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, state_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(output_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               output_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_chunks, H, B);
  state_kernel<<<grid, MMA_THREADS, state_bytes, stream>>>(ke, ve, log_w, states,
                                                           decay, T, H);
  const long long n = (long long)B * H * K * V;
  gla_scan_state_prefix_kernel<<<(unsigned)((n + PREFIX_THREADS - 1) / PREFIX_THREADS),
                            PREFIX_THREADS, 0, stream>>>(
      states, decay, state_out, B * H, n_chunks, K, V);
  output_kernel<<<grid, MMA_THREADS, output_bytes, stream>>>(
      qe, ke, ve, log_w, rwkv ? u : nullptr, states, static_cast<E*>(o), T, H,
      rwkv);
  return cudaGetLastError();
}

// The kernels gla_scan_fwd runs for (dtype, K, V): float32 q, k, v on the
// 3xTF32 kernels, bfloat16 on the bf16-pair kernels.
enum Route { ROUTE_NONE, ROUTE_TF32, ROUTE_MMA };

#define REPRO_GLA_SHAPES(X)                                              \
  X(16, 16) X(16, 32) X(16, 48) X(16, 64) X(32, 16) X(32, 32) X(32, 48)  \
  X(32, 64) X(48, 16) X(48, 32) X(48, 48) X(48, 64) X(64, 16) X(64, 32)  \
  X(64, 48) X(64, 64)

// The route, and in *smem the dynamic shared memory of its largest CTA (the
// output kernel's) in bytes.
Route route(int dtype, int K, int V, int* smem) {
  *smem = 0;
  if (K % 16 != 0 || V % 16 != 0 || K < 16 || V < 16 || K > KMAX || V > KMAX ||
      (dtype != 0 && dtype != 1))
    return ROUTE_NONE;
#define REPRO_GLA_SMEM(KK, VV)                                            \
  if (K == KK && V == VV)                                                 \
    *smem = dtype == 1 ? Tiles<KK, VV>::OUTPUT_BYTES : Tiles32<KK, VV>::OUTPUT_BYTES;
  REPRO_GLA_SHAPES(REPRO_GLA_SMEM)
#undef REPRO_GLA_SMEM
  return dtype == 1 ? ROUTE_MMA : ROUTE_TF32;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 for q, k, v and o; log_w and u are
// float32; u may be null (no bonus). mode_rwkv: 1 = rwkv, 0 = ssd.
// scratch: gla_scan_scratch_floats(dtype, B, T, H, K, V) floats (the chunk
// states, then the chunk decays). Returns the CUDA error code of the
// launches (0 on success).
int gla_scan_fwd(const void* q, const void* k, const void* v,
                 const float* log_w, const float* u, void* o,
                 float* state_out, float* scratch, int B, int T, int H, int K,
                 int V, int mode_rwkv, int dtype, void* stream) {
  int smem = 0;
  const Route r = route(dtype, K, V, &smem);
  if (r == ROUTE_NONE || T < 1 || B < 1 || H < 1 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_GLA_LAUNCH(KK, VV)                                                 \
  if (K == KK && V == VV)                                                        \
    return (int)(r == ROUTE_MMA                                                  \
                     ? launch_chunked<__nv_bfloat16>(                            \
                           gla_scan_chunk_state_kernel<KK, VV>,                  \
                           Tiles<KK, VV>::STATE_BYTES,                           \
                           gla_scan_chunk_output_kernel<KK, VV>,                 \
                           Tiles<KK, VV>::OUTPUT_BYTES, q, k, v, log_w, u, o,    \
                           state_out, scratch, B, T, H, K, V, mode_rwkv, st)     \
                     : launch_chunked<float>(                                    \
                           gla_scan_chunk_state_tf32_kernel<KK, VV>,             \
                           Tiles32<KK, VV>::STATE_BYTES,                         \
                           gla_scan_chunk_output_tf32_kernel<KK, VV>,            \
                           Tiles32<KK, VV>::OUTPUT_BYTES, q, k, v, log_w, u, o,  \
                           state_out, scratch, B, T, H, K, V, mode_rwkv, st));
  REPRO_GLA_SHAPES(REPRO_GLA_LAUNCH)
#undef REPRO_GLA_LAUNCH
  return (int)cudaErrorInvalidValue;  // unreachable: route() took K and V
}

// Name of the kernels gla_scan_fwd runs for (dtype, K, V): "mma" (bfloat16)
// or "mma.3xtf32" (float32), or NULL where it refuses them; *smem_bytes is
// the dynamic shared memory of its largest CTA.
const char* gla_scan_route(int dtype, int K, int V, int* smem_bytes) {
  const Route r = route(dtype, K, V, smem_bytes);
  return r == ROUTE_MMA ? "mma" : r == ROUTE_TF32 ? "mma.3xtf32" : nullptr;
}

// Tokens per chunk tile of the kernels gla_scan_fwd runs for dtype: 64 for
// float32 and bfloat16; 0 for another dtype.
int gla_scan_chunk_tokens(int dtype) {
  return dtype == 0 || dtype == 1 ? MC : 0;
}

// Floats of the scratch gla_scan_fwd needs for these shapes: per (batch,
// head, chunk of MC tokens) a (K, V) state and K decays; -1 where route()
// refuses (dtype, K, V).
long long gla_scan_scratch_floats(int dtype, int B, int T, int H, int K,
                                  int V) {
  int smem = 0;
  if (route(dtype, K, V, &smem) == ROUTE_NONE) return -1;
  return (long long)B * H * ((T + MC - 1) / MC) * ((long long)K * V + K);
}

const char* gla_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
