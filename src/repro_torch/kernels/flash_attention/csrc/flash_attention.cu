// Flash attention for Hopper, sm_90a: the forward (prefill and training)
// and, below it, the backward (training).
//
// The forward replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas (body _flash_kernel). Same function: online-softmax
// attention with GQA (query head h reads KV head h / (H / KV)), causal mask
// kpos <= qpos, sliding-window mask kpos > qpos - window, a ragged tail past
// S, float32 running max, denominator and accumulator, and the output written
// once in the input dtype, normalised by 1 / max(l, 1e-37). Given an lse
// pointer (training) each kernel also writes every row's log-sum-exp, from an
// instantiation of its own (template flag LSE), so the serving forward keeps
// its instructions. The Pallas kernel has no backward; the backward kernels
// replace the reference's XLA custom VJP (see "Backward" below).
//
// Translation. The TPU grid walks its KV axis in order and carries (m, l,
// acc) in VMEM scratch from one grid step to the next. CUDA blocks run in
// parallel in no order, so a CTA owns one (batch, head, query tile) at a
// time and loops over its KV tiles itself, with (m, l, acc) in registers. K/V are read
// straight from the model layout (B, S, KV, D) at head h / G: nothing is
// repeated in memory. The scale 1/sqrt(D) is applied to the scores directly
// (the TPU wrapper's pad-D-to-128-and-rescale-q trick is not needed). KV tiles
// that the causal or window mask hides entirely are skipped.
//
// What bounds it on this card. Causal prefill does about 4 * S^2 * D * H / 2
// FLOP on S * D * (2H + 2KV) elements of input and output: at S >= ~512 the
// work is far above the H100's ~295 FLOP/byte ridge, so it is bound by
// operations, and only wgmma reaches the tensor cores' full rate. But each
// visible (query, key) pair also costs one exp2, and the special-function
// units do 16 a clock per SM against the tensor cores' ~4,096 bf16 flops:
// on those units alone the exp2 take as long as the 4 D flops at D = 64,
// and 2x as long at 32, 4x at 16. Run partly as a cubic on the FMA pipes
// (128 a clock per SM; ~6 instructions an exp2 beside the softmax's ~2 a
// pair), the exp2 can take ~0.57x of that time, as long as the flops at
// D ~ 37: below it the softmax, not the products, bounds the kernel.
// Two kernels, chosen by dtype in flash_attention_fwd:
//   - bfloat16 at every D (16 to 128 in steps of 16; Llama-3-8B and the other
//     served D = 128 models, Zamba2's D = 64, HuBERT's, phi-2's and
//     h2o-danube's D = 80; no served model below 64):
//     flash_fwd_wgmma_kernel, Hopper's shape (FlashAttention-3's). It
//     replaces flash_attention_pallas. A work item is one (batch, head,
//     128-query tile); the grid is persistent, one CTA per SM walking its
//     items heaviest first, so the next item's loads overlap this item's
//     last tiles instead of every CTA paying its load latency and pipeline
//     fill alone. A CTA has three
//     warpgroups. The producer warpgroup gives its registers up (setmaxnreg) and
//     one of its threads loads Q (two buffers: this item's and the next's) and
//     K/V tiles of 128 keys into a 2-stage ring in shared memory with TMA
//     (cp.async.bulk.tensor over 4-D maps (D, heads, S, B), 128-byte swizzle, so
//     a tile is one 64-column box up to D = 64 and two from D = 80 to 128: a
//     box past D (the whole box's tail below 64, the second box's at 80 to
//     112) is filled with zeros in shared memory by TMA, not read from device
//     memory, and the products issue only the D real columns: D / 16 k-steps
//     of Q K^T, an n = D product for P V, which at D = 16, 32 and 48 reads
//     the first D columns of each 128-byte swizzle atom). Each stage has "full" and
//     "empty" mbarriers for K and for V apart, so Q K^T starts before V lands
//     and the next K loads as soon as Q K^T is done: loads run ahead of the
//     tensor cores instead of fencing every tile with __syncthreads. Two
//     consumer warpgroups of 64 query rows run both products on wgmma: S = Q K^T
//     with Q and K from shared memory, O += P V with P kept in registers as the
//     A operand (bf16, in the accumulator layout) and V as an MN-major B
//     operand. Each group issues Q K^T of tile j with P V of tile j - 1 and runs
//     the softmax of tile j while P V is on the tensor cores (FlashAttention-3's
//     intra-warpgroup overlap); the consumers take up to 240 registers
//     (setmaxnreg; ptxas reports the 168 of the launch). Below D = 128 the
//     softmax weighs as much as the products: a tile's 128 x 128 scores are
//     16,384 exp2 on 16 special-function lanes per SM, ~1,000 cycles, against
//     ~1,300 cycles of tensor-core work at D = 80, ~500 at D = 32 and ~250 at
//     16. Softmax runs in exp2 (ex2.approx, one instruction) on scores
//     pre-scaled by scale * log2(e); the causal, window and kpos < S masks run
//     only on tiles that cross a boundary (zero-filled keys past S score 0, so
//     the last tile is masked). Output is stored from registers, rows past S
//     unwritten. The tensor maps are built on the host for each call.
//     At D = 16, 32 and 48 (where it replaced an mma.sync m16n8k16 kernel
//     with synchronous, single-buffered loads and expf on every score) the
//     kernel stays well above that floor: on an H100 the causal forward at
//     S = 2048, GQA 32/8, D = 32 ran 0.046 ms against 0.017 for the exp2 on
//     the special-function units alone. Every exp2 here is ex2.approx; what
//     holds the kernel between the floor and its time is not yet measured.
//   - float32 at every D (float32 models, training in float32; no model
//     below 64): flash_fwd_tf32_kernel, the same shape on the tensor cores
//     in TF32 with every operand split into a hi and a lo part (3xTF32; see
//     "float32: TMA + wgmma in TF32" below): one TF32 pass keeps about
//     three digits, the split float32's. At D = 16, 32 and 48 it replaced
//     float32 FMAs on shared-memory tiles (synchronous loads, no tensor
//     cores), which ran 0.96 / 1.09 / 1.26 ms on an H100 at B = 1, S = 2048,
//     GQA 32/8, causal.
// A refused launch or a failed tensor-map encode returns its error; there is
// no fallback from one kernel to another.
#include <cuda.h>  // CUtensorMap and its enums; no link against libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DMAX = 128;  // the largest head dim

// ---------------------------------------------------------------------------
// bfloat16: TMA ring, warp-specialised wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr int WG_BQ = 128;           // query rows per CTA: two consumer warpgroups of 64
constexpr int WG_BK = 128;           // keys per KV tile (the N of Q K^T's wgmma)
constexpr int WG_STAGES = 2;         // K and V tiles each in the shared-memory ring
constexpr int WG_CONSUMERS = 256;    // two consumer warpgroups; each thread arrives on "empty"
constexpr int WG_THREADS = 384;      // and a producer warpgroup
constexpr int BOX_COLS = 64;         // 128-byte swizzle: boxes of at most 64 bf16 columns
constexpr int Q_BOX = WG_BQ * 128;   // bytes of one [WG_BQ rows][64 columns] box of Q
constexpr int KV_BOX = WG_BK * 128;  // bytes of one [WG_BK rows][64 columns] box of K or V
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Shared memory: two Q tiles (this item's and the next's), then WG_STAGES x
// (K tile, V tile), then the barriers. A tile is NB = ceil(D / 64) boxes of
// [rows][64 columns], each row 128 bytes, 128-byte swizzled by TMA in
// 1024-byte atoms of 8 rows. At D = 80, 96 and 112 the second box holds
// columns 64..D-1 and TMA zero-fills the rest (the map's width is D); at
// D = 16, 32 and 48 the one box holds columns 0..D-1 and the fill. Device
// memory is read for D columns only, and the products never read the fill:
// Q K^T takes D / 16 k-steps and P V an n = D product. An MN-major n = 16,
// 32 or 48 inside one 128-byte swizzle atom reads correctly on the card,
// so the small head dims need no 32- or 64-byte swizzle mode.
template <int D>
struct WgSmem {
  static constexpr int NB = (D + BOX_COLS - 1) / BOX_COLS;
  static constexpr int Q_TILE = NB * Q_BOX;
  static constexpr int KV_TILE = NB * KV_BOX;
  static constexpr int DATA = 2 * Q_TILE + 2 * WG_STAGES * KV_TILE;
  static constexpr int N_BARS = 4 + 4 * WG_STAGES;  // q_full/empty[2], k/v_full/empty[]
  static constexpr int BYTES = 1024 + DATA + 8 * N_BARS;  // 1024: slack to align the base
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
// that lasts ~2 s (2^32 cycles) is a lost arrival, not a slow tile: trap, so
// that a fault ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 32)) __trap();
}

// One box of a 4-D tensor map (D, heads, S, B) at (col, head, row, batch)
// into shared memory; completion is counted in bytes on `bar`. Rows past S
// are zero-filled.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1). Byte
// offsets: lbo between 64-column atoms along MN (MN-major operands only),
// sbo between 8-row groups. The atoms start 1024-byte aligned, so the base
// offset is 0.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// The descriptor `bytes` further on (the start address is its low bits, in
// 16-byte units). The add runs here, at its use, so the compiler does not
// hoist each k-step's descriptor of a loop into registers of its own.
__device__ __forceinline__ uint64_t desc_plus(uint64_t desc, uint32_t bytes) {
  uint64_t r;
  asm volatile("add.s64 %0, %1, %2;\n" : "=l"(r) : "l"(desc), "l"((uint64_t)(bytes >> 4)));
  return r;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous issue and its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x 128, float32) {=, +=} A (64 x 16) * B (16 x 128); A and B in shared
// memory, both K-major. accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N, float32) += A (64 x 16, registers) * B (16 x N, shared memory,
// MN-major: the last immediate, trans-b, is 1), N = D, the head dim. At
// D = 80, 96 and 112 the N columns span one full 64-column swizzle atom and
// part of the next (lbo further on); at D = 16, 32 and 48 they are the first
// D columns of each atom.
#define ACC8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),       \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : ACC8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[24], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
      "%17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46,"
      "%47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<112>(float (&d)[56], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46,"
      "%47, %48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46,"
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      "%62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, float32) {=, +=} A (64 x 16) * B (16 x 64); A and B in shared
// memory, both K-major. accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}
#undef ACC8

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  static_assert(N == 64 || N == 128, "wgmma_ss: N is 64 or 128");
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, accumulate);
  else wgmma_ss_n128(d, da, db, accumulate);
}

// acc (64 x N) = A (64 rows x D) B^T (N rows x D), both K-major tiles of
// 64-column boxes (a_box, b_box bytes apart): D / 16 k-steps (a k-step
// moves 32 bytes along a 128-byte swizzled row, every 4 k-steps to the next
// box: D = 80 takes four k-steps in the first box, one in the second).
// Issued and committed, not waited for.
template <int N, int D>
__device__ __forceinline__ void issue_ss(float (&acc)[N / 2], uint32_t a, uint32_t a_box,
                                         uint32_t b, uint32_t b_box) {
  const uint64_t da = sw128_desc(a, 16, 1024), db = sw128_desc(b, 16, 1024);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss<N>(acc, desc_plus(da, (kk / 4) * a_box + col),
                desc_plus(db, (kk / 4) * b_box + col), kk > 0);
  }
  wgmma_commit();
}

// acc (64 x D) += A (64 x 16 KS, registers) B (16 KS rows x D, MN-major, its
// 64-column boxes b_box bytes apart): a k-step of 16 rows is 2048 bytes of a
// box, and columns 64.. lie one box (lbo) further. Issued and committed.
template <int D, int KS>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2], const uint32_t (&a)[KS][4],
                                         uint32_t b, uint32_t b_box) {
  const uint64_t db = sw128_desc(b, b_box, 1024);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) wgmma_rs<D>(acc, a[kk], desc_plus(db, kk * 2048));
  wgmma_commit();
}

// An accumulator of 64 x N as bf16 A fragments (columns [16 kk, 16 kk + 16)).
template <int N>
__device__ __forceinline__ void pack_a(const float (&acc)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(acc[8 * kk], acc[8 * kk + 1]);
    a[kk][1] = pack_bf16(acc[8 * kk + 2], acc[8 * kk + 3]);
    a[kk][2] = pack_bf16(acc[8 * kk + 4], acc[8 * kk + 5]);
    a[kk][3] = pack_bf16(acc[8 * kk + 6], acc[8 * kk + 7]);
  }
}

// One tile of BK keys of the online softmax for rows row0 and row1 = row0 +
// 8 of a thread (lane = 4 g + t holds keys k0 + 8 j + 2 t, + 1 of every n8
// block j). Masks only when `masked`; updates m (log2 units) and the per-lane
// partial l; leaves the probabilities in sacc (pack_a makes them P V's A
// operand) and returns the factors by which the previous accumulator must
// be scaled. A row with no unmasked score
// yet keeps m = -inf and takes 0 as its exp2 reference, so every exp2 is of
// -inf or of a finite number, never of inf - inf.
template <int BK = WG_BK>
__device__ __forceinline__ void softmax_tile(float (&sacc)[BK / 2],
                                             float& m0, float& m1, float& l0,
                                             float& l1, float& alpha0, float& alpha1,
                                             bool masked, int k0, int row0, int t,
                                             int S, int causal, int window,
                                             float scale_log2) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        const int qp = e < 2 ? row0 : row0 + 8;
        const bool ok = key < S && (!causal || key <= qp) &&
                        (window <= 0 || key > qp - window);
        if (!ok) sacc[4 * j + e] = -INFINITY;
      }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
  }
  // a row's BK scores lie in the 4 lanes of its quad
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0 * scale_log2), mn1 = fmaxf(m1, mx1 * scale_log2);
  const float ref0 = mn0 == -INFINITY ? 0.f : mn0;
  const float ref1 = mn1 == -INFINITY ? 0.f : mn1;
  alpha0 = ex2(m0 - ref0);
  alpha1 = ex2(m1 - ref1);
  m0 = mn0;
  m1 = mn1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    sacc[4 * j] = ex2(fmaf(sacc[4 * j], scale_log2, -ref0));
    sacc[4 * j + 1] = ex2(fmaf(sacc[4 * j + 1], scale_log2, -ref0));
    sacc[4 * j + 2] = ex2(fmaf(sacc[4 * j + 2], scale_log2, -ref1));
    sacc[4 * j + 3] = ex2(fmaf(sacc[4 * j + 3], scale_log2, -ref1));
    rs0 += sacc[4 * j] + sacc[4 * j + 1];
    rs1 += sacc[4 * j + 2] + sacc[4 * j + 3];
  }
  l0 = l0 * alpha0 + rs0;  // per-lane partial sums; the quad is summed at the end
  l1 = l1 * alpha1 + rs1;
}

// One work item: a (batch, query head, 128-query tile), and the KV tiles it
// visits. Items are numbered heaviest first: the last query tiles of every
// (batch, head) come first, since under a causal mask they visit the most
// KV tiles.
struct WorkItem {
  int q0, h, b, kvh, k_begin, n_tiles;
};

template <int BK = WG_BK>  // keys a tile
__device__ __forceinline__ WorkItem work_item(int w, int S, int H, int KV, int HB,
                                              int n_qt, int causal, int window) {
  WorkItem it;
  it.q0 = (n_qt - 1 - w / HB) * WG_BQ;
  const int hb = w % HB;
  it.h = hb % H;
  it.b = hb / H;
  it.kvh = it.h / (H / KV);
  int k_begin = 0, k_end = S;
  if (causal) k_end = min(S, it.q0 + WG_BQ);
  if (window > 0) k_begin = max(0, it.q0 - window + 1);
  it.k_begin = (k_begin / BK) * BK;
  it.n_tiles = (k_end - it.k_begin + BK - 1) / BK;  // >= 1: k_begin <= q0 < k_end
  return it;
}

// The r-th item of this CTA: rounds of gridDim.x items, walked forwards in
// even rounds and backwards in odd ones, so that every CTA gets a like
// share of heavy and light items.
__device__ __forceinline__ int item_index(int r) {
  const int c = (r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  return r * gridDim.x + c;
}

// q, k, v through tensor maps of (D, heads, S, B), boxes of (64, 1, rows, 1),
// 128-byte swizzle; o: (B, S, H, D) bf16, contiguous. Persistent: grid of
// min(items, SMs) CTAs, each walking its items (item_index); block:
// WG_THREADS; dynamic smem: WgSmem<D>::BYTES. scale_log2 = scale * log2(e):
// softmax runs in exp2 on pre-scaled scores. With LSE, lse (B, H, S)
// float32 takes each row's natural-log sum of exp(scale * scores), converted
// once from the exp2 domain: m ln 2 + ln l. Without it (serving) the kernel
// is the same instructions as before lse existed.
template <int D, bool LSE>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                       __grid_constant__ const CUtensorMap tk,
                       __grid_constant__ const CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o, int B, int S, int H, int KV,
                       float scale_log2, int causal, int window,
                       float* __restrict__ lse) {
  using L = WgSmem<D>;
  constexpr int NB = L::NB;  // boxes per tile row
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = (smem_u32(wg_smem) + 1023u) & ~1023u;
  const uint32_t bars = base + L::DATA;
  auto q_tile = [&](int qb) { return base + (uint32_t)(L::Q_TILE * qb); };
  auto k_tile = [&](int s) { return base + (uint32_t)(2 * L::Q_TILE + L::KV_TILE * 2 * s); };
  auto v_tile = [&](int s) { return base + (uint32_t)(2 * L::Q_TILE + L::KV_TILE * (2 * s + 1)); };
  auto q_full = [&](int qb) { return bars + 8u * qb; };
  auto q_empty = [&](int qb) { return bars + 8u * (2 + qb); };
  auto k_full = [&](int s) { return bars + 8u * (4 + s); };
  auto v_full = [&](int s) { return bars + 8u * (4 + WG_STAGES + s); };
  auto k_empty = [&](int s) { return bars + 8u * (4 + 2 * WG_STAGES + s); };
  auto v_empty = [&](int s) { return bars + 8u * (4 + 3 * WG_STAGES + s); };

  const int HB = H * B;
  const int n_qt = (S + WG_BQ - 1) / WG_BQ;
  const int n_items = n_qt * HB;

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(q_full(qb), 1);
      mbar_init(q_empty(qb), WG_CONSUMERS);
    }
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), WG_CONSUMERS);
      mbar_init(v_empty(s), WG_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: one thread keeps the rings full, running ahead across
    // items, so the next item's Q and first K/V tiles load while this
    // item's last tiles are multiplied. The warpgroup hands its registers
    // back (though ptxas still compiles the consumers for 168; see the
    // note at the top).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int g = 0;  // KV tiles loaded so far, over all items
      for (int r = 0; item_index(r) < n_items; ++r) {
        const WorkItem it = work_item(item_index(r), S, H, KV, HB, n_qt, causal, window);
        const int qb = r & 1;
        if (r >= 2) mbar_wait(q_empty(qb), ((r - 2) >> 1) & 1);
        mbar_expect_tx(q_full(qb), L::Q_TILE);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          tma_load(q_tile(qb) + c * Q_BOX, &tq, q_full(qb), c * BOX_COLS, it.h, it.q0, it.b);
        for (int j = 0; j < it.n_tiles; ++j, ++g) {
          const int s = g % WG_STAGES, round = g / WG_STAGES;
          const int k0 = it.k_begin + j * WG_BK;
          if (round > 0) mbar_wait(k_empty(s), (round - 1) & 1);
          mbar_expect_tx(k_full(s), L::KV_TILE);
#pragma unroll
          for (int c = 0; c < NB; ++c)
            tma_load(k_tile(s) + c * KV_BOX, &tk, k_full(s), c * BOX_COLS, it.kvh, k0, it.b);
          if (round > 0) mbar_wait(v_empty(s), (round - 1) & 1);
          mbar_expect_tx(v_full(s), L::KV_TILE);
#pragma unroll
          for (int c = 0; c < NB; ++c)
            tma_load(v_tile(s) + c * KV_BOX, &tv, v_full(s), c * BOX_COLS, it.kvh, k0, it.b);
        }
      }
    }
  } else {
    // Consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63 of each
    // item. Thread (warp w of the group, lane = 4 g + t) holds rows
    // 16 w + g and 16 w + g + 8 of them, and columns 8 j + 2 t, + 1 of every
    // n8 block j (wgmma's accumulator layout). Q K^T of tile j and P V of
    // tile j - 1 are issued together; the softmax of tile j runs while P V
    // is on the tensor cores, and the accumulator is rescaled once P V is
    // done (FlashAttention-3's intra-warpgroup overlap). The first tile is
    // peeled so that no wgmma is issued under a branch: ptxas serialises
    // every wgmma of a kernel where one is. While one group's softmax is on
    // the CUDA cores, the other's products can be on the tensor cores too.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int lane = tid & 31, w = tid >> 5;
    const int t = lane & 3;
    int g = 0;  // KV tiles consumed so far, over all items
    for (int r = 0; item_index(r) < n_items; ++r) {
      const WorkItem it = work_item(item_index(r), S, H, KV, HB, n_qt, causal, window);
      const int qb = r & 1;
      const int qlo = it.q0 + 64 * cw;
      const int row0 = qlo + 16 * w + (lane >> 2);
      const uint32_t q_rows = q_tile(qb) + 64 * cw * 128;  // this group's 64 rows of each Q box

      float oacc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // m in log2 units
      mbar_wait(q_full(qb), (r >> 1) & 1);

      // a tile needs masks only where it crosses the diagonal, the window's
      // edge or S; zero-filled keys past S score 0, not -inf, so the last
      // tile is masked too
      auto masked = [&](int k0) {
        return k0 + WG_BK > S || (causal && k0 + WG_BK - 1 > qlo) ||
               (window > 0 && k0 <= qlo + 63 - window);
      };
      uint32_t pa[WG_BK / 16][4];  // P of the tile whose P V is issued next
      int ps = g % WG_STAGES, pparity = (g / WG_STAGES) & 1;  // and its stage
      {
        float sacc[WG_BK / 2], alpha0, alpha1;
        mbar_wait(k_full(ps), pparity);
        issue_ss<WG_BK, D>(sacc, q_rows, Q_BOX, k_tile(ps), KV_BOX);
        wgmma_wait<0>();
        fence_regs(sacc);
        mbar_arrive(k_empty(ps));
        if (it.n_tiles == 1) mbar_arrive(q_empty(qb));  // Q of this item is read
        softmax_tile(sacc, m0, m1, l0, l1, alpha0, alpha1, masked(it.k_begin),
                     it.k_begin, row0, t, S, causal, window, scale_log2);
        pack_a<WG_BK>(sacc, pa);  // the accumulator is still 0: no rescale
        ++g;
      }
      for (int j = 1; j < it.n_tiles; ++j, ++g) {
        const int s = g % WG_STAGES, parity = (g / WG_STAGES) & 1;
        const int k0 = it.k_begin + j * WG_BK;
        float sacc[WG_BK / 2], alpha0, alpha1;
        mbar_wait(k_full(s), parity);
        mbar_wait(v_full(ps), pparity);
        issue_ss<WG_BK, D>(sacc, q_rows, Q_BOX, k_tile(s), KV_BOX);
        issue_rs<D, WG_BK / 16>(oacc, pa, v_tile(ps), KV_BOX);
        wgmma_wait<1>();  // Q K^T is done; P V may still run
        fence_regs(sacc);
        mbar_arrive(k_empty(s));
        if (j == it.n_tiles - 1) mbar_arrive(q_empty(qb));  // Q of this item is read
        softmax_tile(sacc, m0, m1, l0, l1, alpha0, alpha1, masked(k0), k0, row0, t,
                     S, causal, window, scale_log2);
        wgmma_wait<0>();
        fence_regs(oacc);
        mbar_arrive(v_empty(ps));
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          oacc[4 * jj] *= alpha0;
          oacc[4 * jj + 1] *= alpha0;
          oacc[4 * jj + 2] *= alpha1;
          oacc[4 * jj + 3] *= alpha1;
        }
        pack_a<WG_BK>(sacc, pa);
        ps = s;
        pparity = parity;
      }
      mbar_wait(v_full(ps), pparity);  // the last tile's P V
      issue_rs<D, WG_BK / 16>(oacc, pa, v_tile(ps), KV_BOX);
      wgmma_wait<0>();
      fence_regs(oacc);
      mbar_arrive(v_empty(ps));

#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const float inv0 = 1.f / fmaxf(l0, 1e-37f), inv1 = 1.f / fmaxf(l1, 1e-37f);
      const size_t q_row = (size_t)H * D;
      __nv_bfloat16* o0 =
          o + ((size_t)it.b * S + row0) * q_row + (size_t)it.h * D + 2 * t;
      __nv_bfloat16* o1 = o0 + 8 * q_row;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        if (row0 < S)
          *reinterpret_cast<uint32_t*>(o0 + 8 * jj) =
              pack_bf16(oacc[4 * jj] * inv0, oacc[4 * jj + 1] * inv0);
        if (row0 + 8 < S)
          *reinterpret_cast<uint32_t*>(o1 + 8 * jj) =
              pack_bf16(oacc[4 * jj + 2] * inv1, oacc[4 * jj + 3] * inv1);
      }
      if constexpr (LSE) {
        // m is in log2 units of the scaled scores: sum exp = 2^m l
        float* lrow = lse + ((size_t)it.b * H + it.h) * S;
        if (t == 0 && row0 < S) lrow[row0] = m0 * LN2 + logf(l0);
        if (t == 0 && row0 + 8 < S) lrow[row0 + 8] = m1 * LN2 + logf(l1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward: delta, then dK/dV, then dQ (FlashAttention-2's split, no atomics)
// ---------------------------------------------------------------------------
//
// Replaces repro/models/attention.py::_flash_core's custom VJP
// (_flash_bwd_padded); the Pallas kernel has no backward. Given q, k, v, the
// forward's o and lse (B, H, S) and dO:
//   delta = rowsum(dO o), P = exp(scale q k^T - lse), dP = dO v^T,
//   dS = P (dP - delta) scale, dQ = dS k, dK = dS^T q, dV = P^T dO,
// with dK and dV summed over the G query heads of each KV head. P is
// recomputed from lse tile by tile, so no S x S tensor is ever stored.
// Three launches: flash_bwd_delta_kernel (one warp per (b, s, h) row; a
// quarter warp below D = 64), a dK/dV kernel and a dQ kernel. Every
// output element is summed by one thread in a fixed order, so two launches
// on the same inputs are bit-identical. Masks are the forward's: causal
// kpos <= qpos, window kpos > qpos - window, kpos, qpos < S.
//
// What bounds it: 10 D H flops a visible (query, key) pair (five products of
// 2 D: S, dP, dV, dK, dQ) and one exp2 (P), against the same few bytes as
// the forward, so operations: the tensor cores' at every D (one exp2 a pair
// on the special-function units alone, 16 a clock per SM, takes as long as
// 10 D flops at D = 25.6; split with a cubic on the FMA pipes, as the
// forward's note counts it, at D ~ 15). Without atomics both kernels
// recompute S and dP, and P: they issue 14 D flops and 2 exp2 a pair, so
// they can reach at most 10 / 14 = 71% of the operations bound, and at
// D = 16 and 32 the second exp2 sets the pace (2 exp2 a pair, all
// ex2.approx here, take longer than 14 D flops below D = 37).
// Computing P once would need dQ summed across the dK/dV kernel's CTAs
// (float atomics: launches no longer bit-identical) or dS stored for a
// separate dQ product (4 bytes a pair through device memory, ~4.6x the
// second exp2's time); neither is taken, so the floor of this design is
// 2 exp2 a pair.
//
// bf16 at every D, 16 to 128 (64 and up: every trained head dim): Hopper's
// shape, as the forward's (TMA ring, warp-specialised wgmma, persistent grid
// heaviest first). A CTA is a producer warpgroup (setmaxnreg 24) and two
// consumer warpgroups (240); products are wgmma with float32 accumulators.
//   - flash_bwd_dkdv_wgmma_kernel: an item is one (batch, KV head, 64-key
//     tile). One producer thread loads K and V once per item and, for each
//     of the G heads, the query tiles the mask lets through (BQ = 128
//     queries up to D = 64, 64 above: registers) into a ring of Q and dO
//     tiles; the producer group's other three warps read each tile's lse
//     and delta into the stage with ordinary loads, a stage each (a
//     (B, H, S) row starts 16-byte aligned only when S % 4 == 0, which
//     cp.async.bulk needs; one warp alone, one load round trip a step, set
//     the kernel's pace). The two consumer groups take alternate query
//     tiles of the item, each over all 64 keys:
//     S^T = K Q^T and dP^T = V dO^T smem-smem (dP^T runs under P's exp2),
//     then P^T and dS^T, packed to bf16 in the accumulator layout, are the
//     register A operand of dV += P^T dO and dK += dS^T Q, with dO and Q read
//     MN-major from the same swizzled tiles (as the forward reads V). At the
//     end of an item the groups add their partial sums through shared memory,
//     thread by thread in the accumulator layout (group 0 keeps dV, group 1
//     dK): a fixed order. The ring has an even number of stages and a group
//     takes the steps of its parity, so each group owns its stages: an
//     mbarrier parity wait cannot tell a phase from the one two before it,
//     and a group must not wait on a stage the other group has yet to free.
//     Why not 128-key items, 64 keys a group: under a
//     causal mask key tile 0 sees every query, so an item's work falls with
//     its key tile, and at B = 1 the first items set the time (Llama's
//     widths: 128 items on 132 SMs, the first alone ~0.14 ms at an SM's
//     peak, twice the mean). 64-key items on a whole SM halve the longest
//     item and give twice as many items to balance.
//   - flash_bwd_dq_wgmma_kernel: an item is one (batch, head, 128-query
//     tile), 64 rows a consumer group, as the forward's; K and V tiles of 128
//     keys come through a TMA ring. S = Q K^T and dP = dO V^T smem-smem, dS
//     in registers is the A operand of dQ += dS K with K read MN-major; the
//     lse and delta of a thread's two rows stay in registers.
//   Both take P = exp2(s scale log2 e - lse log2 e) (ex2.approx); a query
//   past S gets lse = +inf, so its P is 0 without a mask; masks run only on
//   tiles that cross the diagonal, the window's edge or (dQ's keys) S; dK
//   and dQ are scaled once, at the store. Each step issues its products
//   unconditionally (a wgmma under a branch serialises every wgmma of the
//   kernel); the two groups' exp2 and products overlap each other's.
// At D = 16, 32 and 48 (no trained model) a tile row is one 64-column box,
// zero-filled by TMA past D, as in the forward: S^T, dP^T (and S, dP) take
// D / 16 k-steps, the MN-major dO, Q and K the first D columns of each
// swizzle atom. They replaced mma.sync m16n8k16 kernels with synchronous,
// single-buffered loads and expf on every score. On an H100 at S = 2048,
// GQA 32/8, causal, D = 32 the three launches take ~0.12 ms (dK/dV 0.062,
// dQ 0.054, delta 0.005) against 0.035 for this design's 2 exp2 a pair on
// the special-function units and 0.022 for the operations; what holds it
// above them is not yet measured. float32 at every D:
// flash_bwd_dkdv_tf32_kernel and flash_bwd_dq_tf32_kernel, the bf16 kernels'
// design in TF32 with the 3xTF32 split (below).

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// o, dout: (B, S, H, D) rows; delta: (B, H, S) float32. LANES threads a row:
// a warp per row, or below D = 64 (a row of 32 to 96 bytes in bf16, 64 to
// 192 in float32) a quarter warp, so that the rows' loads are in flight
// together instead of leaving most of each warp idle (on an H100 at
// S = 2048, GQA 32/8: bf16 D = 16 0.0129 -> 0.0042 ms; float32 D = 16 /
// 32 / 48 0.0129 / 0.0134 / 0.0180 -> 0.0044 / 0.0077 / 0.0120).
__host__ __device__ constexpr int delta_lanes(int D) { return D < 64 ? 8 : 32; }

template <typename T, int LANES = 32>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows, int S, int H, int D) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / LANES;
  const int lane = threadIdx.x % LANES;
  if (LANES == 32 && row >= rows) return;  // whole warps
  const bool in = row < rows;               // below 32: every lane shuffles
  const T* orow = o + (size_t)row * D;
  const T* drow = dout + (size_t)row * D;
  float acc = 0.f;
  for (int d = lane; in && d < D; d += LANES)
    acc = fmaf(to_f32(orow[d]), to_f32(drow[d]), acc);
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (in && lane == 0) {
    const int h = row % H, bs = row / H;  // row = (b S + s) H + h
    delta[((size_t)(bs / S) * H + h) * S + bs % S] = acc;
  }
}

// Launches the delta pass over B S H rows of D columns.
template <typename T>
void launch_delta(const void* o, const void* dout, float* delta, int rows, int S, int H,
                  int D, cudaStream_t stream) {
  const int blocks = (int)(((long long)rows * delta_lanes(D) + 255) / 256);
  const T* ot = static_cast<const T*>(o);
  const T* dt = static_cast<const T*>(dout);
  if (delta_lanes(D) == 8)
    flash_bwd_delta_kernel<T, 8><<<blocks, 256, 0, stream>>>(ot, dt, delta, rows, S, H, D);
  else
    flash_bwd_delta_kernel<T><<<blocks, 256, 0, stream>>>(ot, dt, delta, rows, S, H, D);
}

constexpr int MAX_DEVICES = 64;  // devices the launchers' once-per-device state covers

// ---- bfloat16 at every D, 16 to 128: TMA + wgmma ----

constexpr int BWD_KB = 64;  // keys of a dK/dV item; both consumer groups hold all of them

// Barrier 1 over the two consumer warpgroups (barrier 0 is __syncthreads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// dK/dV shared memory: the K and V tiles of the item (NB boxes of [64 keys]
// [64 columns]), STAGES x (Q tile, dO tile) of BQ query rows, each stage's
// -lse log2 e and delta (BQ floats each), one group's partial sum (64 x D
// floats), then the barriers. STAGES is even: consumer group cw takes the
// steps of parity cw, so each group owns its stages.
template <int D>
struct BwdKvSmem {
  static constexpr int NB = (D + BOX_COLS - 1) / BOX_COLS;
  static constexpr int BQ = D <= 64 ? 128 : 64;       // S^T, dP^T: BQ / 2 floats each a thread
  static constexpr int STAGES = 4;
  static constexpr int K_BOX = BWD_KB * 128;
  static constexpr int Q_BOX = BQ * 128;
  static constexpr int K_TILE = NB * K_BOX;
  static constexpr int Q_TILE = NB * Q_BOX;
  static constexpr int STATS = 2 * K_TILE + 2 * STAGES * Q_TILE;
  static constexpr int RED = STATS + STAGES * 2 * BQ * 4;
  static constexpr int BARS = RED + BWD_KB * D * 4;
  static constexpr int N_BARS = 2 + 2 * STAGES;  // kv_full/empty, full[], empty[]
  static constexpr int BYTES = 1024 + BARS + 8 * N_BARS;  // 1024: slack to align the base
};

// dQ shared memory: the item's Q and dO tiles (128 rows), STAGES x (K tile,
// V tile) of 128 keys, the barriers.
template <int D>
struct BwdQSmem {
  static constexpr int NB = (D + BOX_COLS - 1) / BOX_COLS;
  static constexpr int STAGES = D <= 64 ? 4 : 2;
  static constexpr int Q_TILE = NB * Q_BOX;
  static constexpr int KV_TILE = NB * KV_BOX;
  static constexpr int DATA = 2 * Q_TILE + 2 * STAGES * KV_TILE;
  static constexpr int N_BARS = 2 + 2 * STAGES;  // q_full/empty, kv_full[], kv_empty[]
  static constexpr int BYTES = 1024 + DATA + 8 * N_BARS;
};

template <int D>
constexpr int bwd_wgmma_smem() {
  return BwdKvSmem<D>::BYTES > BwdQSmem<D>::BYTES ? BwdKvSmem<D>::BYTES
                                                  : BwdQSmem<D>::BYTES;
}

// An item of the dK/dV kernel: one (batch, KV head, 64-key tile) and, for
// each of its G heads, the n_qt query tiles of BQ rows from q_begin that can
// see its keys; step i is head kvh G + i / n_qt, tile i % n_qt. Numbered key
// tile first: under a causal mask the first key tiles see the most queries.
struct KvItem {
  int k0, kvh, b, q_begin, n_qt, steps;
};

template <int BQ, int KB = BWD_KB>
__device__ __forceinline__ KvItem kv_item(int w, int B, int S, int KV, int G, int causal,
                                          int window) {
  KvItem it;
  const int hb = w % (KV * B);
  it.k0 = w / (KV * B) * KB;
  it.kvh = hb % KV;
  it.b = hb / KV;
  it.q_begin = causal ? it.k0 : 0;
  const int q_end = window > 0 ? min(S, it.k0 + KB - 1 + window) : S;
  it.n_qt = (q_end - it.q_begin + BQ - 1) / BQ;  // >= 1: q_begin <= k0 < q_end
  it.steps = G * it.n_qt;
  return it;
}

// q, dout through tensor maps of (D, H, S, B) with boxes of (64, 1, BQ, 1);
// k, v of (D, KV, S, B), boxes (64, 1, 64, 1); 128-byte swizzle. lse, delta:
// (B, H, S) float32; dk, dv: (B, S, KV, D) bf16. Persistent: grid of
// min(items, SMs) CTAs walking their items (item_index); block: WG_THREADS;
// dynamic smem: BwdKvSmem<D>::BYTES. scale_log2 = scale * log2(e).
template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dkdv_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                            __grid_constant__ const CUtensorMap tdo,
                            __grid_constant__ const CUtensorMap tk,
                            __grid_constant__ const CUtensorMap tv,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int B, int S, int H,
                            int KV, float scale_log2, float scale, int causal,
                            int window) {
  using L = BwdKvSmem<D>;
  constexpr int NB = L::NB, BQ = L::BQ, ST = L::STAGES;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = (smem_u32(wg_smem) + 1023u) & ~1023u;
  unsigned char* gbase = wg_smem + (base - smem_u32(wg_smem));  // base, as a generic pointer
  const uint32_t k_tile = base, v_tile = base + L::K_TILE;
  auto q_tile = [&](int s) { return base + (uint32_t)(2 * L::K_TILE + 2 * L::Q_TILE * s); };
  auto do_tile = [&](int s) { return q_tile(s) + (uint32_t)L::Q_TILE; };
  // stage s: BQ values of -lse log2 e, then BQ of delta
  auto stats = [&](int s) { return reinterpret_cast<float*>(gbase + L::STATS) + 2 * BQ * s; };
  // [D / 2][128]: one group's partial dV or dK, in its accumulator layout
  float* red = reinterpret_cast<float*>(gbase + L::RED);
  const uint32_t bars = base + L::BARS;
  const uint32_t kv_full = bars, kv_empty = bars + 8;
  auto full = [&](int s) { return bars + 8u * (2 + s); };
  auto empty = [&](int s) { return bars + 8u * (2 + ST + s); };

  const int G = H / KV;
  const int n_items = (S + BWD_KB - 1) / BWD_KB * KV * B;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, WG_CONSUMERS);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 33);   // TMA's lane, and a loader warp's after its lse and delta stores
      mbar_init(empty(s), 128);  // the consumer group that took the step
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer warpgroup, running ahead across items: lane 0 of warp 0
    // issues the TMA loads; warp 1 + (s % 3) reads the lse and delta of
    // the steps in stage s, so that up to three steps' global loads are in
    // flight instead of one load round trip a step. Dealing stages, not
    // steps, keeps each warp's waits on a stage's "empty" barrier in order:
    // a parity wait cannot tell a phase from the one two before it.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
    if (threadIdx.x == 0) {
      int g = 0;  // steps loaded so far, over all items
      for (int r = 0; item_index(r) < n_items; ++r) {
        const KvItem it = kv_item<BQ>(item_index(r), B, S, KV, G, causal, window);
        if (r > 0) mbar_wait(kv_empty, (r - 1) & 1);
        mbar_expect_tx(kv_full, 2 * L::K_TILE);
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          tma_load(k_tile + c * L::K_BOX, &tk, kv_full, c * BOX_COLS, it.kvh, it.k0, it.b);
          tma_load(v_tile + c * L::K_BOX, &tv, kv_full, c * BOX_COLS, it.kvh, it.k0, it.b);
        }
        for (int i = 0; i < it.steps; ++i, ++g) {
          const int s = g % ST, round = g / ST;
          const int h = it.kvh * G + i / it.n_qt;
          const int q0 = it.q_begin + (i % it.n_qt) * BQ;
          if (round > 0) mbar_wait(empty(s), (round - 1) & 1);
          mbar_expect_tx(full(s), 2 * L::Q_TILE);
#pragma unroll
          for (int c = 0; c < NB; ++c) {
            tma_load(q_tile(s) + c * L::Q_BOX, &tq, full(s), c * BOX_COLS, h, q0, it.b);
            tma_load(do_tile(s) + c * L::Q_BOX, &tdo, full(s), c * BOX_COLS, h, q0, it.b);
          }
        }
      }
    } else if (warp > 0) {
      int g = 0;
      for (int r = 0; item_index(r) < n_items; ++r) {
        const KvItem it = kv_item<BQ>(item_index(r), B, S, KV, G, causal, window);
        for (int i = 0; i < it.steps; ++i) {
          const int s = (g + i) % ST, round = (g + i) / ST;
          if (s % 3 != warp - 1) continue;
          const int h = it.kvh * G + i / it.n_qt;
          const int q0 = it.q_begin + (i % it.n_qt) * BQ;
          if (round > 0) mbar_wait(empty(s), (round - 1) & 1);
          // queries past S: lse = +inf makes their P exactly 0
          const size_t row = ((size_t)it.b * H + h) * S;
          float* st = stats(s);
          for (int j = lane; j < BQ; j += 32) {
            const int qp = q0 + j;
            st[j] = qp < S ? -lse[row + qp] * LOG2E : -INFINITY;
            st[BQ + j] = qp < S ? delta[row + qp] : 0.f;
          }
          mbar_arrive(full(s));
        }
        g += it.steps;
      }
    }
  } else {
    // Consumers: group cw takes the steps of parity cw (counted over all
    // items: each group owns the stages of its parity, so its waits on a
    // stage's "full" barrier come in order), each over all 64 keys. Thread
    // (warp w, lane = 4 g + t) holds key rows 16 w + g and + 8, and query
    // columns 8 j + 2 t, + 1 of S^T and dP^T; rows 16 w + g, + 8 and
    // columns 8 j + 2 t, + 1 of dK and dV.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int lane = tid & 31, w = tid >> 5;
    const int t = lane & 3;
    int g = 0;  // steps of earlier items
    for (int r = 0; item_index(r) < n_items; ++r) {
      const KvItem it = kv_item<BQ>(item_index(r), B, S, KV, G, causal, window);
      const int kr0 = it.k0 + 16 * w + (lane >> 2);
      float dka[D / 2], dva[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
      const int first = (cw + g) & 1;  // this group's first step of the item
      if (first < it.steps) mbar_wait(kv_full, r & 1);
      for (int i = first; i < it.steps; i += 2) {
        const int gi = g + i, s = gi % ST;
        const int q0 = it.q_begin + (i % it.n_qt) * BQ;
        float sacc[BQ / 2], dpacc[BQ / 2];
        mbar_wait(full(s), (gi / ST) & 1);
        issue_ss<BQ, D>(sacc, k_tile, L::K_BOX, q_tile(s), L::Q_BOX);
        issue_ss<BQ, D>(dpacc, v_tile, L::K_BOX, do_tile(s), L::Q_BOX);
        wgmma_wait<1>();  // S^T is done; dP^T may still run
        fence_regs(sacc);
        const float* st = stats(s);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 nl = *reinterpret_cast<const float2*>(st + 8 * j + 2 * t);
          sacc[4 * j] = ex2(fmaf(sacc[4 * j], scale_log2, nl.x));
          sacc[4 * j + 1] = ex2(fmaf(sacc[4 * j + 1], scale_log2, nl.y));
          sacc[4 * j + 2] = ex2(fmaf(sacc[4 * j + 2], scale_log2, nl.x));
          sacc[4 * j + 3] = ex2(fmaf(sacc[4 * j + 3], scale_log2, nl.y));
        }
        // keys past S need no mask: their rows of dK and dV are not stored
        if ((causal && q0 < it.k0 + BWD_KB - 1) ||
            (window > 0 && it.k0 <= q0 + BQ - 1 - window)) {
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = kr0 + 8 * (e >> 1), qp = q0 + 8 * j + 2 * t + (e & 1);
              if ((causal && key > qp) || (window > 0 && key <= qp - window))
                sacc[4 * j + e] = 0.f;
            }
        }
        wgmma_wait<0>();
        fence_regs(dpacc);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 dl = *reinterpret_cast<const float2*>(st + BQ + 8 * j + 2 * t);
          dpacc[4 * j] = sacc[4 * j] * (dpacc[4 * j] - dl.x);
          dpacc[4 * j + 1] = sacc[4 * j + 1] * (dpacc[4 * j + 1] - dl.y);
          dpacc[4 * j + 2] = sacc[4 * j + 2] * (dpacc[4 * j + 2] - dl.x);
          dpacc[4 * j + 3] = sacc[4 * j + 3] * (dpacc[4 * j + 3] - dl.y);
        }
        uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
        pack_a<BQ>(sacc, pa);
        pack_a<BQ>(dpacc, dsa);
        issue_rs<D, BQ / 16>(dva, pa, do_tile(s), L::Q_BOX);
        issue_rs<D, BQ / 16>(dka, dsa, q_tile(s), L::Q_BOX);
        wgmma_wait<0>();
        fence_regs(dva);
        fence_regs(dka);
        mbar_arrive(empty(s));
      }
      g += it.steps;
      mbar_arrive(kv_empty);

      // Group 1 hands its dV to group 0, then group 0 its dK to group 1,
      // through one buffer. A thread's partner holds the same elements in
      // the same registers.
      float* part = red + tid;
      if (cw == 1) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) part[i * 128] = dva[i];
      }
      consumers_sync();
      if (cw == 0) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) dva[i] += part[i * 128];
      }
      consumers_sync();
      if (cw == 0) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) part[i * 128] = dka[i];
      }
      consumers_sync();
      if (cw == 1) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) dka[i] += part[i * 128];
      }
      consumers_sync();  // the next item's partial sums may overwrite these

      const size_t kv_row = (size_t)KV * D;
      auto store = [&](const float (&acc)[D / 2], __nv_bfloat16* out, float f) {
        __nv_bfloat16* o0 =
            out + ((size_t)it.b * S + kr0) * kv_row + (size_t)it.kvh * D + 2 * t;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          if (kr0 < S)
            *reinterpret_cast<uint32_t*>(o0 + 8 * jj) =
                pack_bf16(acc[4 * jj] * f, acc[4 * jj + 1] * f);
          if (kr0 + 8 < S)
            *reinterpret_cast<uint32_t*>(o0 + 8 * kv_row + 8 * jj) =
                pack_bf16(acc[4 * jj + 2] * f, acc[4 * jj + 3] * f);
        }
      };
      if (cw == 0)
        store(dva, dv, 1.f);
      else
        store(dka, dk, scale);
    }
  }
}

// q, dout through tensor maps of (D, H, S, B) with boxes of (64, 1, 128, 1);
// k, v of (D, KV, S, B), boxes (64, 1, 128, 1). dq: (B, S, H, D) bf16. An
// item is the forward's (work_item): persistent grid of min(items, SMs)
// CTAs; block: WG_THREADS; dynamic smem: BwdQSmem<D>::BYTES.
template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dq_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                          __grid_constant__ const CUtensorMap tdo,
                          __grid_constant__ const CUtensorMap tk,
                          __grid_constant__ const CUtensorMap tv,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int B, int S, int H, int KV,
                          float scale_log2, float scale, int causal, int window) {
  using L = BwdQSmem<D>;
  constexpr int NB = L::NB, ST = L::STAGES;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = (smem_u32(wg_smem) + 1023u) & ~1023u;
  const uint32_t q_tile = base, do_tile = base + L::Q_TILE;
  auto k_tile = [&](int s) { return base + (uint32_t)(2 * L::Q_TILE + 2 * L::KV_TILE * s); };
  auto v_tile = [&](int s) { return k_tile(s) + (uint32_t)L::KV_TILE; };
  const uint32_t bars = base + L::DATA;
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto kv_full = [&](int s) { return bars + 8u * (2 + s); };
  auto kv_empty = [&](int s) { return bars + 8u * (2 + ST + s); };

  const int HB = H * B;
  const int n_qt = (S + WG_BQ - 1) / WG_BQ;
  const int n_items = n_qt * HB;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, WG_CONSUMERS);
    for (int s = 0; s < ST; ++s) {
      mbar_init(kv_full(s), 1);
      mbar_init(kv_empty(s), WG_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: one thread; the next item's Q and dO wait until this
    // item's last S and dP are done, its K and V tiles run ahead.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int g = 0;  // K/V tiles loaded so far, over all items
      for (int r = 0; item_index(r) < n_items; ++r) {
        const WorkItem it = work_item(item_index(r), S, H, KV, HB, n_qt, causal, window);
        if (r > 0) mbar_wait(q_empty, (r - 1) & 1);
        mbar_expect_tx(q_full, 2 * L::Q_TILE);
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          tma_load(q_tile + c * Q_BOX, &tq, q_full, c * BOX_COLS, it.h, it.q0, it.b);
          tma_load(do_tile + c * Q_BOX, &tdo, q_full, c * BOX_COLS, it.h, it.q0, it.b);
        }
        for (int j = 0; j < it.n_tiles; ++j, ++g) {
          const int s = g % ST, round = g / ST;
          const int k0 = it.k_begin + j * WG_BK;
          if (round > 0) mbar_wait(kv_empty(s), (round - 1) & 1);
          mbar_expect_tx(kv_full(s), 2 * L::KV_TILE);
#pragma unroll
          for (int c = 0; c < NB; ++c) {
            tma_load(k_tile(s) + c * KV_BOX, &tk, kv_full(s), c * BOX_COLS, it.kvh, k0, it.b);
            tma_load(v_tile(s) + c * KV_BOX, &tv, kv_full(s), c * BOX_COLS, it.kvh, k0, it.b);
          }
        }
      }
    }
  } else {
    // Consumers: group cw owns query rows q0 + 64 cw .. + 63 of each item;
    // thread (warp w, lane = 4 g + t) rows 16 w + g and + 8 of them, key
    // columns 8 j + 2 t, + 1 of S and dP, columns of dQ likewise.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int lane = tid & 31, w = tid >> 5;
    const int t = lane & 3;
    int g = 0;  // K/V tiles consumed so far, over all items
    for (int r = 0; item_index(r) < n_items; ++r) {
      const WorkItem it = work_item(item_index(r), S, H, KV, HB, n_qt, causal, window);
      const int qlo = it.q0 + 64 * cw;
      const int row0 = qlo + 16 * w + (lane >> 2);
      const size_t row = ((size_t)it.b * H + it.h) * S;
      // rows past S: lse = +inf makes their P exactly 0
      const float nl0 = row0 < S ? -lse[row + row0] * LOG2E : -INFINITY;
      const float nl1 = row0 + 8 < S ? -lse[row + row0 + 8] * LOG2E : -INFINITY;
      const float d0 = row0 < S ? delta[row + row0] : 0.f;
      const float d1 = row0 + 8 < S ? delta[row + row0 + 8] : 0.f;
      const uint32_t q_rows = q_tile + 64 * cw * 128;  // this group's 64 rows of each box
      const uint32_t do_rows = do_tile + 64 * cw * 128;
      float dqa[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
      mbar_wait(q_full, r & 1);
      for (int j = 0; j < it.n_tiles; ++j, ++g) {
        const int s = g % ST;
        const int k0 = it.k_begin + j * WG_BK;
        float sacc[WG_BK / 2], dpacc[WG_BK / 2];
        mbar_wait(kv_full(s), (g / ST) & 1);
        issue_ss<WG_BK, D>(sacc, q_rows, Q_BOX, k_tile(s), KV_BOX);
        issue_ss<WG_BK, D>(dpacc, do_rows, Q_BOX, v_tile(s), KV_BOX);
        wgmma_wait<1>();  // S is done; dP may still run
        fence_regs(sacc);
#pragma unroll
        for (int jj = 0; jj < WG_BK / 8; ++jj) {
          sacc[4 * jj] = ex2(fmaf(sacc[4 * jj], scale_log2, nl0));
          sacc[4 * jj + 1] = ex2(fmaf(sacc[4 * jj + 1], scale_log2, nl0));
          sacc[4 * jj + 2] = ex2(fmaf(sacc[4 * jj + 2], scale_log2, nl1));
          sacc[4 * jj + 3] = ex2(fmaf(sacc[4 * jj + 3], scale_log2, nl1));
        }
        // zero-filled keys past S score 0, not -inf: the last tile is masked
        if (k0 + WG_BK > S || (causal && k0 + WG_BK - 1 > qlo) ||
            (window > 0 && k0 <= qlo + 63 - window)) {
#pragma unroll
          for (int jj = 0; jj < WG_BK / 8; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = k0 + 8 * jj + 2 * t + (e & 1);
              const int qp = e < 2 ? row0 : row0 + 8;
              if (!(key < S && (!causal || key <= qp) && (window <= 0 || key > qp - window)))
                sacc[4 * jj + e] = 0.f;
            }
        }
        wgmma_wait<0>();
        fence_regs(dpacc);
        if (j == it.n_tiles - 1) mbar_arrive(q_empty);  // Q and dO of this item are read
#pragma unroll
        for (int jj = 0; jj < WG_BK / 8; ++jj) {
          dpacc[4 * jj] = sacc[4 * jj] * (dpacc[4 * jj] - d0);
          dpacc[4 * jj + 1] = sacc[4 * jj + 1] * (dpacc[4 * jj + 1] - d0);
          dpacc[4 * jj + 2] = sacc[4 * jj + 2] * (dpacc[4 * jj + 2] - d1);
          dpacc[4 * jj + 3] = sacc[4 * jj + 3] * (dpacc[4 * jj + 3] - d1);
        }
        uint32_t dsa[WG_BK / 16][4];
        pack_a<WG_BK>(dpacc, dsa);
        issue_rs<D, WG_BK / 16>(dqa, dsa, k_tile(s), KV_BOX);
        wgmma_wait<0>();
        fence_regs(dqa);
        mbar_arrive(kv_empty(s));
      }
      const size_t q_row = (size_t)H * D;
      __nv_bfloat16* o0 = dq + ((size_t)it.b * S + row0) * q_row + (size_t)it.h * D + 2 * t;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        if (row0 < S)
          *reinterpret_cast<uint32_t*>(o0 + 8 * jj) =
              pack_bf16(dqa[4 * jj] * scale, dqa[4 * jj + 1] * scale);
        if (row0 + 8 < S)
          *reinterpret_cast<uint32_t*>(o0 + 8 * q_row + 8 * jj) =
              pack_bf16(dqa[4 * jj + 2] * scale, dqa[4 * jj + 3] * scale);
      }
    }
  }
}

// ---- float32: TMA + wgmma in TF32, 3xTF32 (forward and backward at every
// D) ----
//
// Replaces FMA kernels on shared-memory tiles, the forward's and the
// backward's at every D: the same functions, on the tensor cores. float32
// FMAs reach 67 TFLOP/s on this card, TF32 wgmma 495. One TF32 pass keeps
// 11 bits of each operand, about three digits, and would
// break the float32 tolerances; so every product here is split (3xTF32):
// x = hi + lo with hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), and
// a b = hi hi + hi lo + lo hi, each in TF32 with float32 accumulation (but
// see "Accumulation" below). The dropped lo lo
// and lo's own rounding leave ~2^-22 of |a b| a product, against float32
// FMA's 2^-24: the kernels run at most 495 / 3 = 165 TFLOP/s of the
// function's flops, and their bound here is 3 flops / 495 TFLOP/s.
//
// The structure is the bf16 kernels' (above): persistent grid heaviest
// first, a producer warpgroup and two consumer warpgroups, TMA rings with
// full/empty mbarriers, P and dS in the accumulator layout, no atomics.
// What float32 changes, and what the design does about it:
//   - wgmma reads a tf32 operand from shared memory K-major only (the
//     transpose bits exist for 16-bit types alone), and tf32 has no register
//     B operand. The bf16 kernels read V (P V), K (dS K), dO (P^T dO) and Q
//     (dS^T Q) MN-major as they lie; here those tiles are transposed in
//     shared memory. Every shared-memory operand also needs a hi and a lo
//     copy. So the producer warpgroup's warps 1-3 (the converters) split
//     each tile after its TMA load lands, off the consumers' path: hi over
//     the raw tile in place and lo beside it (K-major, the TMA's 128-byte
//     swizzle), and, for the MN-major uses, hi and lo transposed into
//     [D][rows] tiles without swizzle (8 x 16-byte core matrices), then
//     fence.proxy.async and arrive on the stage's "full" barrier. The tensor
//     core never sees an unrounded float, so nothing rests on how it would
//     drop the low bits.
//   - A operands come from registers: P, dS, P^T and dS^T from the
//     accumulators; the item's fixed tiles (Q and dO in the forward and dQ,
//     K and V in dK/dV) from their raw TMA tiles, split in registers two
//     k-steps at a time (two buffers, one commit group a chunk), so they
//     need neither a hi/lo copy nor a transposed one in shared memory. A
//     tf32 A fragment holds columns t and t + 4 of an 8-column k-step, an
//     accumulator columns 2t and 2t + 1: the transposed tiles store row r of
//     a k-step at position r / 2 (even r) or 4 + r / 2 (odd), so the
//     accumulator's registers are the A fragment as they stand.
//   - Shared memory: float32 tiles are twice bf16's, and hi/lo doubles them
//     again; at D = 128 a 128-key stage of K and V^T would need 256 KB. The
//     tiles and ring depths below fit 227 KB
//     (FwdTf32Smem, BwdQTf32Smem, BwdKvTf32Smem; flash_attention_tf32_plan
//     reports them): the forward's key tiles 128 to D = 32, 64 at 48 and
//     64, 32 above; dQ's 64 to D = 32, 32 at 48 and 64, 16 above; dK/dV
//     items of 128 keys from D = 64 to 96 (32-query steps at 64, 16 above)
//     and of 64 keys elsewhere (D = 16, 32 and 48: the last two notes).
//   - Splitting costs the converters more instructions and shared-memory
//     traffic than the products cost the tensor cores: a dK/dV step splits
//     four tiles (Q, dO, Q^T, dO^T) for S^T, dP^T, dV and dK. With 64-key
//     items whose two groups take alternate steps the split set the pace
//     (on an H100: dK/dV 3.97 ms of a 5.70 ms backward at smollm-360m's
//     training shape); with 128 keys, 64 a group, both groups share every
//     step's split and it fell to 2.34 ms.
//   - TMA: a 128-byte box is 32 float32 columns, so a tile row is f_nb(D)
//     boxes (D = 80 takes three, the last zero-filled past D); a tf32 k-step
//     is 8 columns, so a product issues D / 8 k-steps of three wgmmas.
//   - Registers: a split A operand is two 32-bit words an element, so the
//     item's tiles are split a chunk at a time instead of held; the
//     producer warpgroup keeps 40 registers (the converters need them), the
//     consumers 232.
//   - Accumulation: the tensor core truncates each sum it accumulates
//     toward zero. One chain of 3 D / 8 accumulations for a score, or of
//     3 S / 8 for an output row, drifted by up to 17 float32 ulps on an
//     H100 (lse 6.5e-5 off at scores of +-60, outputs 4.6e-5 at D = 128),
//     past the 2e-5 tolerance, which the split's own error is not. So lo-hi
//     and hi-lo go to an accumulator of their own (2^-11 of the sum: its
//     drift is negligible), hi-hi of S and dP to two chains (even and odd
//     k-steps), and each tile's P V (forward) and dS K (dQ) to a fresh
//     accumulator added to the running sum in float32, round to nearest;
//     so do each step's dV and dK (one chain over an item's steps left a
//     per-leaf gradient gap of 1.9e-4 in a float32 training step, against
//     2.1e-6 for the FMA kernels), in halves of D from 112 (registers).
//   - The backward at D = 16, 32 and 48 (no trained model): a tile row is
//     one 32-column box, two at 48, zero-filled by TMA past D (the map's
//     width is D); products issue D / 8 k-steps, and the n = D products
//     (dV, dK, dQ) m64n16/n32/n48k8. The converters' transposed split
//     writes only D columns; the K-major one splits whole boxes, zeros
//     included (no product reads past D; skipping them, with the
//     transposed split dealt in 8-row units so that D = 16's four column
//     units spread over the three warps, ran 9-29% slower; which of the
//     two cost it is not measured). At this size each
//     visible pair's exp2 and float32 work weigh as much as its products,
//     so the items are planned for balance: under a causal mask dK/dV's
//     key tile 0 sees every query, and at B = 1 S = 2048 KV = 8 128-key
//     items are 128 on 132 SMs, the first walking ~1.9x the mean; 64-key
//     items (both groups on all 64 keys, alternate steps) are 256, the
//     heaviest as long as the mean. On an H100 at that shape (GQA 32/8,
//     causal) dK/dV took 0.50 / 0.69 / 0.88 ms at D = 16 / 32 / 48 with
//     128-key items and 32-query steps, 0.42 / 0.57 / 0.72 with 64-key
//     items; then 64-query steps (D <= 32) 0.35 / 0.49, 48-query steps at
//     48 (two stages of 64 do not fit) 0.68. 16-query steps, 4 stages and
//     128-key items with 64-query steps lost or tied. dQ takes 64-key
//     tiles to D = 32 (0.18 / 0.23 ms against 32-key tiles' 0.20 / 0.26),
//     32 at 48; a fourth stage of either kernel gained nothing.
//   - The forward at D = 16, 32 and 48 (no model): the same carry-down, the
//     forward's Q split in registers D / 16 chunks at a time (one chunk at
//     16, so the chunk buffers' double-buffering never waits), Q K^T in
//     D / 8 k-steps (one per chain at 16), P V an n = D product, V^T split
//     into D rows. Each visible pair's exp2, P split and float32 rescaling
//     weigh about as much as its three products here, so fewer, longer
//     tiles pay: on an H100 at B = 1 S = 2048 GQA 32/8 causal (graph ms,
//     D = 16 / 32 / 48) 64-key tiles took 0.146 / 0.195 / 0.266, 128-key
//     tiles 0.142 / 0.178 (at 32 with a 48-byte spill; at 48 two 128-key
//     stages do not fit 227 KB, nor a third 64-key one), and 3 or 4 stages
//     of 64 keys 0.145 / 0.193. So 128-key tiles to D = 32, 64 at 48, two
//     stages. The FMA kernel it replaced took 0.96 / 1.10 / 1.26.

constexpr int F_BOX = 32;           // 128-byte swizzle: boxes of 32 float32 columns
constexpr int F_CONVERTERS = 96;    // producer warps 1-3 split the tiles
constexpr int F_SMEM_MAX = 232448;  // a block's opt-in shared memory on sm_90

__host__ __device__ constexpr int f_nb(int D) { return (D + F_BOX - 1) / F_BOX; }
// Bytes of one R-row tile as TMA lands it, and of its hi or lo copy: f_nb(D)
// boxes of [R rows][128 bytes], 128-byte swizzled.
__host__ __device__ constexpr int f_nat(int D, int R) { return f_nb(D) * R * 128; }
// Bytes of one transposed tile: D rows of R tf32 values.
__host__ __device__ constexpr int f_trans(int D, int R) { return D * R * 4; }

// Forward: the item's Q (128 rows, raw), then STAGES x (K hi, K lo, V raw,
// V^T hi, V^T lo) of BK keys, then the barriers.
template <int D>
struct FwdTf32Smem {
  static constexpr int NB = f_nb(D);
  static constexpr int BK = D <= 32 ? 128 : D <= 64 ? 64 : 32;
  static constexpr int STAGES = 2;
  static constexpr int Q_TILE = f_nat(D, WG_BQ);
  static constexpr int NAT = f_nat(D, BK), TR = f_trans(D, BK);
  static constexpr int STAGE = 3 * NAT + 2 * TR;
  static constexpr int BARS = Q_TILE + STAGES * STAGE;
  static constexpr int N_BARS = 2 + 3 * STAGES;  // q_full/empty, raw_full[], full[], empty[]
  static constexpr int BYTES = 1024 + BARS + 8 * N_BARS;
  static_assert(BYTES <= F_SMEM_MAX, "forward tiles exceed shared memory");
};

// dQ: the item's Q and dO (128 rows, raw), then STAGES x (K hi, K lo, V hi,
// V lo, K^T hi, K^T lo) of BK keys, then the barriers.
template <int D>
struct BwdQTf32Smem {
  static constexpr int NB = f_nb(D);
  static constexpr int BK = D <= 32 ? 64 : D <= 64 ? 32 : 16;
  static constexpr int STAGES = D <= 96 ? 3 : 2;
  static constexpr int Q_TILE = f_nat(D, WG_BQ);
  static constexpr int NAT = f_nat(D, BK), TR = f_trans(D, BK);
  static constexpr int STAGE = 4 * NAT + 2 * TR;
  static constexpr int BARS = 2 * Q_TILE + STAGES * STAGE;
  static constexpr int N_BARS = 2 + 3 * STAGES;
  static constexpr int BYTES = 1024 + BARS + 8 * N_BARS;
  static_assert(BYTES <= F_SMEM_MAX, "dQ tiles exceed shared memory");
};

// dK/dV: the item's K and V (KB keys, raw), then STAGES x (Q hi, Q lo, dO
// hi, dO lo, Q^T hi, Q^T lo, dO^T hi, dO^T lo) of BQ queries, each stage's
// -lse log2 e and delta, then the barriers. A step's tiles take more
// splitting than its products take time on the tensor cores, so from
// D = 64 to 96 an item is 128 keys, 64 a consumer group, and both groups
// take every step (one split a step for 128 keys). From D = 112 two stages
// of that width do not fit: an item is 64 keys, both groups hold all of
// them and take alternate steps, group cw in the stages of parity cw, and
// at the item's end one group's partial dV or dK passes through K's and
// V's raw tiles. Below D = 64 items are 64 keys too, for balance, with
// 64-query steps to D = 32 and 48 at 48 (see "The backward at D = 16, 32
// and 48" above).
template <int D>
struct BwdKvTf32Smem {
  static constexpr int NB = f_nb(D);
  static constexpr int KB = D >= 64 && D <= 96 ? 2 * BWD_KB : BWD_KB;
  static constexpr int BQ = D <= 32 ? 64 : D < 64 ? 48 : D <= 64 ? 32 : 16;
  static constexpr int STAGES = 2;
  static constexpr int K_TILE = f_nat(D, KB);
  static constexpr int NAT = f_nat(D, BQ), TR = f_trans(D, BQ);
  static constexpr int STAGE = 4 * NAT + 4 * TR;
  static constexpr int STATS = 2 * K_TILE + STAGES * STAGE;
  static constexpr int BARS = STATS + STAGES * 2 * BQ * 4;
  static constexpr int N_BARS = 2 + 3 * STAGES;  // kv_full/empty, raw_full[], full[], empty[]
  static constexpr int BYTES = 1024 + BARS + 8 * N_BARS;
  static_assert(BYTES <= F_SMEM_MAX, "dK/dV tiles exceed shared memory");
  static_assert(KB > BWD_KB || BWD_KB * D * 4 <= 2 * K_TILE, "the partial sum fits over K and V");
};

// float32 -> tf32, rounded to nearest (ties away), low 13 bits 0
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Orders this thread's shared-memory writes before the async proxy's
// (wgmma's, TMA's) accesses that a later barrier lets through.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor without swizzle (layout type 0): 8-row x
// 16-byte core matrices, lbo bytes apart along K, sbo bytes apart along M/N.
__device__ __forceinline__ uint64_t plain_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// Byte offset of (row r, column c) in a TMA tile of R rows (f_nb boxes of
// 32 columns, 128-byte swizzle: 16-byte chunk c / 4 of a row at chunk
// (c / 4) ^ (r % 8)).
__device__ __forceinline__ int nat_off(int R, int r, int c) {
  return (c >> 5) * R * 128 + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

// Byte offset of (row n, k-position k) in a transposed tile of R columns:
// core matrix (n / 8, k / 4) at (n / 8) R 32 + (k / 4) 128, so lbo = 128 and
// sbo = 32 R.
__device__ __forceinline__ int trans_off(int R, int n, int k) {
  return (n >> 3) * (R * 32) + ((k >> 2) << 7) + ((n & 7) << 4) + ((k & 3) << 2);
}

// Split one TMA tile of R rows (its first D columns) into tf32 hi and lo,
// by the F_CONVERTERS threads (ct = 0..95). NAT: hi over the raw values in
// place, lo into `lo` at the same offsets. TRANS: hi and lo transposed into
// thi and tlo, row r of the tile at k-position (r & ~7) + (r & 7) / 2 +
// 4 (r & 1) (see the note above). A warp's 32 stores of a transposed tile
// span 8 rows n and 4 positions k: 32 banks; a warp walks one column
// block's rows, so both offsets step by constants. Pad columns past D are
// not read by any product.
template <int R, int D, bool NAT, bool TRANS>
__device__ __forceinline__ void split_tile(unsigned char* raw, unsigned char* lo,
                                           unsigned char* thi, unsigned char* tlo, int ct) {
  if constexpr (!TRANS) {
    for (int i = ct; i < f_nat(D, R) / 16; i += F_CONVERTERS) {
      const float4 x = reinterpret_cast<const float4*>(raw)[i];
      uint4 h, l;
      split_tf32(x.x, h.x, l.x);
      split_tf32(x.y, h.y, l.y);
      split_tf32(x.z, h.z, l.z);
      split_tf32(x.w, h.w, l.w);
      reinterpret_cast<uint4*>(raw)[i] = h;
      reinterpret_cast<uint4*>(lo)[i] = l;
    }
  } else {
    const int lane = ct & 31;
    // unit u: column block u / 2 (8 columns, lane & 7 of them), rows of
    // parity u & 1 (2 (lane >> 3) + u % 2 of each 8-row block)
    for (int u = ct >> 5; u < D / 4; u += F_CONVERTERS / 32) {
      const int c = (u >> 1) * 8 + (lane & 7), par = u & 1;
      int off = nat_off(R, 2 * (lane >> 3) + par, c);
      int toff = trans_off(R, c, (lane >> 3) + 4 * par);
#pragma unroll 4
      for (int rb = 0; rb < R; rb += 8, off += 8 * 128, toff += 2 * 128) {
        uint32_t h, l;
        split_tf32(*reinterpret_cast<const float*>(raw + off), h, l);
        if constexpr (NAT) {
          *reinterpret_cast<uint32_t*>(raw + off) = h;
          *reinterpret_cast<uint32_t*>(lo + off) = l;
        }
        *reinterpret_cast<uint32_t*>(thi + toff) = h;
        *reinterpret_cast<uint32_t*>(tlo + toff) = l;
      }
    }
  }
}

#define ACC8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),       \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
// d (64 x N, float32) {=, +=} A (64 x 8, tf32 in registers: a0 (row g, col
// t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4) of warp w's 16 rows)
// * B (8 x N, tf32 in shared memory, K-major). accumulate = 0 overwrites d.
// tf32 has no transpose bits: both shared-memory operands are K-major.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t db, int accumulate);
template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8], const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : ACC8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : ACC8(0), ACC8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_tf32<48>(float (&d)[24], const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_tf32<56>(float (&d)[28], const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27"
      "}, {%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_tf32<80>(float (&d)[40], const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_tf32<96>(float (&d)[48], const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_tf32<112>(float (&d)[56], const uint32_t (&a)[4],
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
#undef ACC8

// The tf32 hi/lo A fragment of k-step kk from a raw TMA tile: rows row and
// row + 8 (row % 8 = g) of the 64 that start at `a` (a generic pointer into
// box 0; boxes a_box bytes apart), columns 8 kk + t and 8 kk + t + 4.
__device__ __forceinline__ void load_split_a(const unsigned char* a, int a_box, int row,
                                             int g, int t, int kk, uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
  const unsigned char* p = a + (kk >> 2) * a_box + row * 128 + (t << 2);
  const int c0 = ((2 * (kk & 3)) ^ g) << 4, c1 = ((2 * (kk & 3) + 1) ^ g) << 4;
  split_tf32(*reinterpret_cast<const float*>(p + c0), hi[0], lo[0]);
  split_tf32(*reinterpret_cast<const float*>(p + c0 + 1024), hi[1], lo[1]);
  split_tf32(*reinterpret_cast<const float*>(p + c1), hi[2], lo[2]);
  split_tf32(*reinterpret_cast<const float*>(p + c1 + 1024), hi[3], lo[3]);
}

constexpr int F_KC = 2;  // k-steps of a split A chunk (one commit group)

// Chunk c (k-steps F_KC c ..) of a product A B^T (64 x N): A split from a
// raw tile into this chunk's buffer (hi, lo), B's hi and lo K-major tiles
// of N rows (128-byte swizzle, boxes b_box bytes apart). The tensor core
// truncates each sum it accumulates toward zero, so a long chain of
// accumulations drifts: lo-hi and hi-lo go to their own accumulator `sm`
// (2^-11 of the product: its drift is negligible) and hi-hi to `a`, or with
// TWO, even k-steps to `a` and odd ones to `b`; the caller adds them in
// float32 (round to nearest). Each accumulator's first product overwrites
// it. `cc` counts the chunks of the call: from the third on, the chunk two
// back (which used these registers) is waited for first.
template <int N, bool TWO>
__device__ __forceinline__ void split_chunk(float (&a)[N / 2], float (&b)[N / 2],
                                            float (&sm)[N / 2], uint32_t (&hi)[F_KC][4],
                                            uint32_t (&lo)[F_KC][4], const unsigned char* ar,
                                            int a_box, int row, int g, int t, uint32_t bhi,
                                            uint32_t blo, uint32_t b_box, int c, int cc) {
  if (cc >= 2) wgmma_wait<1>();
#pragma unroll
  for (int i = 0; i < F_KC; ++i)
    load_split_a(ar, a_box, row, g, t, c * F_KC + i, hi[i], lo[i]);
  const uint64_t dh = sw128_desc(bhi, 16, 1024), dl = sw128_desc(blo, 16, 1024);
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < F_KC; ++i) {
    const int kk = c * F_KC + i;
    const uint32_t off = (kk >> 2) * b_box + (kk & 3) * 32;
    wgmma_tf32<N>(sm, hi[i], desc_plus(dl, off), kk > 0);
    wgmma_tf32<N>(sm, lo[i], desc_plus(dh, off), 1);
    if (TWO && i == 1)  // F_KC = 2: an odd k-step
      wgmma_tf32<N>(b, hi[i], desc_plus(dh, off), kk >= 2);
    else
      wgmma_tf32<N>(a, hi[i], desc_plus(dh, off), kk >= (TWO ? 2 : 1));
  }
  wgmma_commit();
}

// acc0 = A0 B0^T and, with PAIR, then acc1 = A1 B1^T (64 x N each over D
// columns, D / 8 k-steps), each as split_chunk's accumulators (acc, b, sm;
// add_chains sums them): A from raw tiles split in registers a chunk at a
// time (two buffers), B from hi/lo K-major tiles. On return at most the
// last two chunks (of the last product) are in flight.
template <int N, int D, bool PAIR, bool TWO>
__device__ __forceinline__ void issue_split(float (&acc0)[N / 2], float (&b0)[N / 2],
                                            float (&sm0)[N / 2], float (&acc1)[N / 2],
                                            float (&b1)[N / 2], float (&sm1)[N / 2],
                                            const unsigned char* a0, const unsigned char* a1,
                                            int a_box, int row, int g, int t, uint32_t b0hi,
                                            uint32_t b0lo, uint32_t b1hi, uint32_t b1lo,
                                            uint32_t b_box) {
  static_assert(F_KC == 2, "TWO deals the two k-steps of a chunk to two chains");
  constexpr int CH = D / 8 / F_KC;
  uint32_t hi[2][F_KC][4], lo[2][F_KC][4];
#pragma unroll
  for (int c = 0; c < CH; ++c)
    split_chunk<N, TWO>(acc0, b0, sm0, hi[c & 1], lo[c & 1], a0, a_box, row, g, t, b0hi, b0lo,
                        b_box, c, c);
  if constexpr (PAIR) {
#pragma unroll
    for (int c = 0; c < CH; ++c)
      split_chunk<N, TWO>(acc1, b1, sm1, hi[(CH + c) & 1], lo[(CH + c) & 1], a1, a_box, row,
                          g, t, b1hi, b1lo, b_box, c, CH + c);
  }
}

// acc += b + sm (with TWO) or acc += sm, in float32, once the products are
// done.
template <int N, bool TWO>
__device__ __forceinline__ void add_chains(float (&acc)[N / 2], const float (&b)[N / 2],
                                           const float (&sm)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = TWO ? acc[i] + b[i] + sm[i] : acc[i] + sm[i];
}

// An accumulator of 64 x N as tf32 hi/lo A fragments, k-step kk = columns
// 8 kk .. 8 kk + 7 in the transposed tiles' order: registers 4 kk and
// 4 kk + 2 (column 2t of rows g, g + 8) at position t, 4 kk + 1 and 4 kk + 3
// (column 2t + 1) at t + 4.
template <int N>
__device__ __forceinline__ void split_acc(const float (&acc)[N / 2], uint32_t (&hi)[N / 8][4],
                                          uint32_t (&lo)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    split_tf32(acc[4 * kk], hi[kk][0], lo[kk][0]);
    split_tf32(acc[4 * kk + 2], hi[kk][1], lo[kk][1]);
    split_tf32(acc[4 * kk + 1], hi[kk][2], lo[kk][2]);
    split_tf32(acc[4 * kk + 3], hi[kk][3], lo[kk][3]);
  }
}

// acc (64 x N) {=, +=} A (64 x 8 KS, split, registers) B (8 KS x N), B a
// transposed tile pair (hi, lo) of N rows and 8 KS positions; with `fresh`
// the first product overwrites acc. Issued and committed, not waited for.
template <int N, int KS>
__device__ __forceinline__ void issue_rs_tf32(float (&acc)[N / 2], const uint32_t (&hi)[KS][4],
                                              const uint32_t (&lo)[KS][4], uint32_t bhi,
                                              uint32_t blo, bool fresh) {
  const uint64_t dh = plain_desc(bhi, 128, 32 * 8 * KS), dl = plain_desc(blo, 128, 32 * 8 * KS);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    wgmma_tf32<N>(acc, hi[kk], desc_plus(dl, kk * 256), kk > 0 || !fresh);
    wgmma_tf32<N>(acc, lo[kk], desc_plus(dh, kk * 256), 1);
    wgmma_tf32<N>(acc, hi[kk], desc_plus(dh, kk * 256), 1);
  }
  wgmma_commit();
}

// Stores rows row0 and row0 + 8 (those below S) of a 64 x D float32
// accumulator times f, at `out` (row0's first column; rows `stride` floats
// apart).
template <int D>
__device__ __forceinline__ void store_rows_f32(const float (&acc)[D / 2], float* out,
                                               size_t stride, int row0, int S, int t, float f) {
  float* o0 = out + 2 * t;
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
    if (row0 < S)
      *reinterpret_cast<float2*>(o0 + 8 * jj) = make_float2(acc[4 * jj] * f, acc[4 * jj + 1] * f);
    if (row0 + 8 < S)
      *reinterpret_cast<float2*>(o0 + 8 * stride + 8 * jj) =
          make_float2(acc[4 * jj + 2] * f, acc[4 * jj + 3] * f);
  }
}

// q through a tensor map of (D, H, S, B) with boxes of (32, 1, 128, 1), k
// and v of (D, KV, S, B) with boxes (32, 1, BK, 1), float32, 128-byte
// swizzle; o: (B, S, H, D) float32; lse as flash_fwd_wgmma_kernel's. An
// item is the bf16 forward's (128 queries, 64 a consumer group) over key
// tiles of BK. Persistent grid of min(items, SMs) CTAs; block WG_THREADS;
// dynamic smem FwdTf32Smem<D>::BYTES.
template <int D, bool LSE>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_tf32_kernel(__grid_constant__ const CUtensorMap tq,
                      __grid_constant__ const CUtensorMap tk,
                      __grid_constant__ const CUtensorMap tv, float* __restrict__ o,
                      int B, int S, int H, int KV, float scale_log2, int causal,
                      int window, float* __restrict__ lse) {
  using L = FwdTf32Smem<D>;
  constexpr int NB = L::NB, BK = L::BK, ST = L::STAGES;
  constexpr int Q_BOXB = WG_BQ * 128, K_BOXB = BK * 128;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = (smem_u32(wg_smem) + 1023u) & ~1023u;
  unsigned char* gbase = wg_smem + (base - smem_u32(wg_smem));
  auto stage = [&](int s) { return (uint32_t)(L::Q_TILE + L::STAGE * s); };  // offsets
  auto k_hi = [&](int s) { return stage(s); };
  auto k_lo = [&](int s) { return stage(s) + L::NAT; };
  auto v_raw = [&](int s) { return stage(s) + 2 * L::NAT; };
  auto vt_hi = [&](int s) { return stage(s) + 3 * L::NAT; };
  auto vt_lo = [&](int s) { return stage(s) + 3 * L::NAT + L::TR; };
  const uint32_t bars = base + L::BARS;
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto raw_full = [&](int s) { return bars + 8u * (2 + s); };
  auto full = [&](int s) { return bars + 8u * (2 + ST + s); };
  auto empty = [&](int s) { return bars + 8u * (2 + 2 * ST + s); };

  const int HB = H * B;
  const int n_qt = (S + WG_BQ - 1) / WG_BQ;
  const int n_items = n_qt * HB;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, WG_CONSUMERS);
    for (int s = 0; s < ST; ++s) {
      mbar_init(raw_full(s), 1);
      mbar_init(full(s), F_CONVERTERS);
      mbar_init(empty(s), WG_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer warpgroup: lane 0 of warp 0 issues the TMA loads, running
    // ahead across items (the next item's Q waits until this item's last
    // Q K^T is done); warps 1-3 split each stage's K (hi in place, lo) and
    // V (V^T hi, lo) once it lands.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int g = 0;  // key tiles loaded so far, over all items
      for (int r = 0; item_index(r) < n_items; ++r) {
        const WorkItem it =
            work_item<BK>(item_index(r), S, H, KV, HB, n_qt, causal, window);
        if (r > 0) mbar_wait(q_empty, (r - 1) & 1);
        mbar_expect_tx(q_full, L::Q_TILE);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          tma_load(base + c * Q_BOXB, &tq, q_full, c * F_BOX, it.h, it.q0, it.b);
        for (int j = 0; j < it.n_tiles; ++j, ++g) {
          const int s = g % ST, round = g / ST;
          const int k0 = it.k_begin + j * BK;
          if (round > 0) mbar_wait(empty(s), (round - 1) & 1);
          mbar_expect_tx(raw_full(s), 2 * L::NAT);
#pragma unroll
          for (int c = 0; c < NB; ++c) {
            tma_load(base + k_hi(s) + c * K_BOXB, &tk, raw_full(s), c * F_BOX, it.kvh, k0, it.b);
            tma_load(base + v_raw(s) + c * K_BOXB, &tv, raw_full(s), c * F_BOX, it.kvh, k0, it.b);
          }
        }
      }
    } else if (threadIdx.x >= 32) {
      const int ct = threadIdx.x - 32;
      int g = 0;
      for (int r = 0; item_index(r) < n_items; ++r) {
        const WorkItem it =
            work_item<BK>(item_index(r), S, H, KV, HB, n_qt, causal, window);
        for (int j = 0; j < it.n_tiles; ++j, ++g) {
          const int s = g % ST;
          mbar_wait(raw_full(s), (g / ST) & 1);
          split_tile<BK, D, true, false>(gbase + k_hi(s), gbase + k_lo(s), nullptr, nullptr, ct);
          split_tile<BK, D, false, true>(gbase + v_raw(s), nullptr, gbase + vt_hi(s),
                                         gbase + vt_lo(s), ct);
          fence_async_smem();
          mbar_arrive(full(s));
        }
      }
    }
  } else {
    // Consumers: group cw owns query rows q0 + 64 cw .. + 63 of each item
    // (thread (warp w, lane = 4 g + t): rows 16 w + g and + 8, accumulator
    // columns 8 j + 2t, + 1). A tile: S = Q K^T (Q split from the raw tile
    // a chunk at a time), the online softmax of the bf16 kernel in exp2, the
    // accumulator rescaled, then O += P V with P split from the
    // accumulator and V^T's hi and lo from the stage. The two groups'
    // products and softmax overlap each other.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int lane = tid & 31, w = tid >> 5;
    const int gr = lane >> 2, t = lane & 3;
    const unsigned char* qa = gbase + 64 * cw * 128;  // this group's rows of Q's box 0
    int g = 0;  // key tiles consumed so far, over all items
    for (int r = 0; item_index(r) < n_items; ++r) {
      const WorkItem it = work_item<BK>(item_index(r), S, H, KV, HB, n_qt, causal, window);
      const int qlo = it.q0 + 64 * cw;
      const int row0 = qlo + 16 * w + gr;
      float oacc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // m in log2 units
      mbar_wait(q_full, r & 1);
      for (int j = 0; j < it.n_tiles; ++j, ++g) {
        const int s = g % ST;
        const int k0 = it.k_begin + j * BK;
        float sacc[BK / 2], sb[BK / 2], ssm[BK / 2], alpha0, alpha1;
        mbar_wait(full(s), (g / ST) & 1);
        issue_split<BK, D, false, true>(sacc, sb, ssm, sacc, sb, ssm, qa, qa, Q_BOXB,
                                        16 * w + gr, gr, t, base + k_hi(s), base + k_lo(s), 0,
                                        0, K_BOXB);
        wgmma_wait<0>();
        fence_regs(sacc);
        fence_regs(sb);
        fence_regs(ssm);
        add_chains<BK, true>(sacc, sb, ssm);
        if (j == it.n_tiles - 1) mbar_arrive(q_empty);  // Q of this item is read
        // zero-filled keys past S score 0, not -inf: the last tile is masked
        const bool masked = k0 + BK > S || (causal && k0 + BK - 1 > qlo) ||
                            (window > 0 && k0 <= qlo + 63 - window);
        softmax_tile<BK>(sacc, m0, m1, l0, l1, alpha0, alpha1, masked, k0, row0, t, S,
                         causal, window, scale_log2);
        // the tile's P V into an accumulator of its own (one chain of
        // truncating accumulations over all of S would drift), then
        // O = alpha O + P V in float32
        uint32_t ph[BK / 8][4], pl[BK / 8][4];
        split_acc<BK>(sacc, ph, pl);
        float pv[D / 2];
        issue_rs_tf32<D, BK / 8>(pv, ph, pl, base + vt_hi(s), base + vt_lo(s), true);
        wgmma_wait<0>();
        fence_regs(pv);
        mbar_arrive(empty(s));
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          oacc[4 * jj] = fmaf(oacc[4 * jj], alpha0, pv[4 * jj]);
          oacc[4 * jj + 1] = fmaf(oacc[4 * jj + 1], alpha0, pv[4 * jj + 1]);
          oacc[4 * jj + 2] = fmaf(oacc[4 * jj + 2], alpha1, pv[4 * jj + 2]);
          oacc[4 * jj + 3] = fmaf(oacc[4 * jj + 3], alpha1, pv[4 * jj + 3]);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const size_t q_row = (size_t)H * D;
      float* o0 = o + ((size_t)it.b * S + row0) * q_row + (size_t)it.h * D;
      const float inv0 = 1.f / fmaxf(l0, 1e-37f), inv1 = 1.f / fmaxf(l1, 1e-37f);
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        if (row0 < S)
          *reinterpret_cast<float2*>(o0 + 8 * jj + 2 * t) =
              make_float2(oacc[4 * jj] * inv0, oacc[4 * jj + 1] * inv0);
        if (row0 + 8 < S)
          *reinterpret_cast<float2*>(o0 + 8 * q_row + 8 * jj + 2 * t) =
              make_float2(oacc[4 * jj + 2] * inv1, oacc[4 * jj + 3] * inv1);
      }
      if constexpr (LSE) {
        float* lrow = lse + ((size_t)it.b * H + it.h) * S;
        if (t == 0 && row0 < S) lrow[row0] = m0 * LN2 + logf(l0);
        if (t == 0 && row0 + 8 < S) lrow[row0 + 8] = m1 * LN2 + logf(l1);
      }
    }
  }
}

// q, dout through tensor maps of (D, H, S, B) with boxes of (32, 1, 128, 1);
// k, v of (D, KV, S, B), boxes (32, 1, BK, 1); float32, 128-byte swizzle.
// dq: (B, S, H, D) float32. An item is the forward's (128 queries, 64 a
// consumer group) over key tiles of BK: S = Q K^T and dP = dO V^T with Q
// and dO split from their raw tiles, K and V from the stage's hi/lo, then
// dQ += dS K with K^T's hi and lo. Persistent grid of min(items, SMs) CTAs;
// block WG_THREADS; dynamic smem BwdQTf32Smem<D>::BYTES.
template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dq_tf32_kernel(__grid_constant__ const CUtensorMap tq,
                         __grid_constant__ const CUtensorMap tdo,
                         __grid_constant__ const CUtensorMap tk,
                         __grid_constant__ const CUtensorMap tv,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dq, int B, int S, int H, int KV,
                         float scale_log2, float scale, int causal, int window) {
  using L = BwdQTf32Smem<D>;
  constexpr int NB = L::NB, BK = L::BK, ST = L::STAGES;
  constexpr int Q_BOXB = WG_BQ * 128, K_BOXB = BK * 128;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = (smem_u32(wg_smem) + 1023u) & ~1023u;
  unsigned char* gbase = wg_smem + (base - smem_u32(wg_smem));
  const uint32_t do_raw = L::Q_TILE;  // offsets; Q's raw tile is at 0
  auto stage = [&](int s) { return (uint32_t)(2 * L::Q_TILE + L::STAGE * s); };
  auto k_hi = [&](int s) { return stage(s); };
  auto k_lo = [&](int s) { return stage(s) + L::NAT; };
  auto v_hi = [&](int s) { return stage(s) + 2 * L::NAT; };
  auto v_lo = [&](int s) { return stage(s) + 3 * L::NAT; };
  auto kt_hi = [&](int s) { return stage(s) + 4 * L::NAT; };
  auto kt_lo = [&](int s) { return stage(s) + 4 * L::NAT + L::TR; };
  const uint32_t bars = base + L::BARS;
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto raw_full = [&](int s) { return bars + 8u * (2 + s); };
  auto full = [&](int s) { return bars + 8u * (2 + ST + s); };
  auto empty = [&](int s) { return bars + 8u * (2 + 2 * ST + s); };

  const int HB = H * B;
  const int n_qt = (S + WG_BQ - 1) / WG_BQ;
  const int n_items = n_qt * HB;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, WG_CONSUMERS);
    for (int s = 0; s < ST; ++s) {
      mbar_init(raw_full(s), 1);
      mbar_init(full(s), F_CONVERTERS);
      mbar_init(empty(s), WG_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: lane 0 of warp 0 loads Q and dO once an item and K, V a
    // tile; warps 1-3 split K (hi in place, lo, K^T hi and lo) and V (hi in
    // place, lo).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int g = 0;
      for (int r = 0; item_index(r) < n_items; ++r) {
        const WorkItem it =
            work_item<BK>(item_index(r), S, H, KV, HB, n_qt, causal, window);
        if (r > 0) mbar_wait(q_empty, (r - 1) & 1);
        mbar_expect_tx(q_full, 2 * L::Q_TILE);
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          tma_load(base + c * Q_BOXB, &tq, q_full, c * F_BOX, it.h, it.q0, it.b);
          tma_load(base + do_raw + c * Q_BOXB, &tdo, q_full, c * F_BOX, it.h, it.q0, it.b);
        }
        for (int j = 0; j < it.n_tiles; ++j, ++g) {
          const int s = g % ST, round = g / ST;
          const int k0 = it.k_begin + j * BK;
          if (round > 0) mbar_wait(empty(s), (round - 1) & 1);
          mbar_expect_tx(raw_full(s), 2 * L::NAT);
#pragma unroll
          for (int c = 0; c < NB; ++c) {
            tma_load(base + k_hi(s) + c * K_BOXB, &tk, raw_full(s), c * F_BOX, it.kvh, k0, it.b);
            tma_load(base + v_hi(s) + c * K_BOXB, &tv, raw_full(s), c * F_BOX, it.kvh, k0, it.b);
          }
        }
      }
    } else if (threadIdx.x >= 32) {
      const int ct = threadIdx.x - 32;
      int g = 0;
      for (int r = 0; item_index(r) < n_items; ++r) {
        const WorkItem it =
            work_item<BK>(item_index(r), S, H, KV, HB, n_qt, causal, window);
        for (int j = 0; j < it.n_tiles; ++j, ++g) {
          const int s = g % ST;
          mbar_wait(raw_full(s), (g / ST) & 1);
          split_tile<BK, D, true, true>(gbase + k_hi(s), gbase + k_lo(s), gbase + kt_hi(s),
                                        gbase + kt_lo(s), ct);
          split_tile<BK, D, true, false>(gbase + v_hi(s), gbase + v_lo(s), nullptr, nullptr, ct);
          fence_async_smem();
          mbar_arrive(full(s));
        }
      }
    }
  } else {
    // Consumers: group cw owns query rows q0 + 64 cw .. + 63 of each item;
    // thread (warp w, lane = 4 g + t) rows 16 w + g and + 8, key columns
    // 8 j + 2 t, + 1 of S and dP, columns of dQ likewise.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int lane = tid & 31, w = tid >> 5;
    const int gr = lane >> 2, t = lane & 3;
    const unsigned char* qa = gbase + 64 * cw * 128;  // this group's rows of box 0
    const unsigned char* da = gbase + do_raw + 64 * cw * 128;
    int g = 0;
    for (int r = 0; item_index(r) < n_items; ++r) {
      const WorkItem it = work_item<BK>(item_index(r), S, H, KV, HB, n_qt, causal, window);
      const int qlo = it.q0 + 64 * cw;
      const int row0 = qlo + 16 * w + gr;
      const size_t row = ((size_t)it.b * H + it.h) * S;
      // rows past S: lse = +inf makes their P exactly 0
      const float nl0 = row0 < S ? -lse[row + row0] * LOG2E : -INFINITY;
      const float nl1 = row0 + 8 < S ? -lse[row + row0 + 8] * LOG2E : -INFINITY;
      const float d0 = row0 < S ? delta[row + row0] : 0.f;
      const float d1 = row0 + 8 < S ? delta[row + row0 + 8] : 0.f;
      float dqa[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
      mbar_wait(q_full, r & 1);
      for (int j = 0; j < it.n_tiles; ++j, ++g) {
        const int s = g % ST;
        const int k0 = it.k_begin + j * BK;
        float sacc[BK / 2], sb[BK / 2], ssm[BK / 2], dpacc[BK / 2], db[BK / 2], dsm[BK / 2];
        mbar_wait(full(s), (g / ST) & 1);
        issue_split<BK, D, true, true>(sacc, sb, ssm, dpacc, db, dsm, qa, da, Q_BOXB,
                                       16 * w + gr, gr, t, base + k_hi(s), base + k_lo(s),
                                       base + v_hi(s), base + v_lo(s), K_BOXB);
        wgmma_wait<1>();  // S is done; dP's last chunk may still run
        fence_regs(sacc);
        fence_regs(sb);
        fence_regs(ssm);
        add_chains<BK, true>(sacc, sb, ssm);
#pragma unroll
        for (int jj = 0; jj < BK / 8; ++jj) {
          sacc[4 * jj] = ex2(fmaf(sacc[4 * jj], scale_log2, nl0));
          sacc[4 * jj + 1] = ex2(fmaf(sacc[4 * jj + 1], scale_log2, nl0));
          sacc[4 * jj + 2] = ex2(fmaf(sacc[4 * jj + 2], scale_log2, nl1));
          sacc[4 * jj + 3] = ex2(fmaf(sacc[4 * jj + 3], scale_log2, nl1));
        }
        // zero-filled keys past S score 0, not -inf: the last tile is masked
        if (k0 + BK > S || (causal && k0 + BK - 1 > qlo) ||
            (window > 0 && k0 <= qlo + 63 - window)) {
#pragma unroll
          for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = k0 + 8 * jj + 2 * t + (e & 1);
              const int qp = e < 2 ? row0 : row0 + 8;
              if (!(key < S && (!causal || key <= qp) && (window <= 0 || key > qp - window)))
                sacc[4 * jj + e] = 0.f;
            }
        }
        wgmma_wait<0>();
        fence_regs(dpacc);
        fence_regs(db);
        fence_regs(dsm);
        add_chains<BK, true>(dpacc, db, dsm);
        if (j == it.n_tiles - 1) mbar_arrive(q_empty);  // Q and dO of this item are read
#pragma unroll
        for (int jj = 0; jj < BK / 8; ++jj) {
          dpacc[4 * jj] = sacc[4 * jj] * (dpacc[4 * jj] - d0);
          dpacc[4 * jj + 1] = sacc[4 * jj + 1] * (dpacc[4 * jj + 1] - d0);
          dpacc[4 * jj + 2] = sacc[4 * jj + 2] * (dpacc[4 * jj + 2] - d1);
          dpacc[4 * jj + 3] = sacc[4 * jj + 3] * (dpacc[4 * jj + 3] - d1);
        }
        uint32_t dh[BK / 8][4], dl[BK / 8][4];
        split_acc<BK>(dpacc, dh, dl);
        float dqt[D / 2];  // the tile's dS K apart, as the forward's P V
        issue_rs_tf32<D, BK / 8>(dqt, dh, dl, base + kt_hi(s), base + kt_lo(s), true);
        wgmma_wait<0>();
        fence_regs(dqt);
        mbar_arrive(empty(s));
#pragma unroll
        for (int i = 0; i < D / 2; ++i) dqa[i] += dqt[i];
      }
      const size_t q_row = (size_t)H * D;
      store_rows_f32<D>(dqa, dq + ((size_t)it.b * S + row0) * q_row + (size_t)it.h * D,
                        q_row, row0, S, t, scale);
    }
  }
}

// q, dout through tensor maps of (D, H, S, B) with boxes of (32, 1, BQ, 1);
// k, v of (D, KV, S, B), boxes (32, 1, KB, 1); float32, 128-byte swizzle.
// dk, dv: (B, S, KV, D) float32. An item is (batch, KV head, KB-key tile)
// over steps of BQ queries (BwdKvTf32Smem: with 128 keys group cw takes
// keys 64 cw .. of every step, with 64 both take all keys and group cw the
// steps of parity cw): S^T = K Q^T and dP^T = V dO^T with K and V split
// from their raw tiles, Q and dO from the stage's hi/lo, then dV += P^T dO
// and dK += dS^T Q with dO^T's and Q^T's hi and lo. Persistent grid of
// min(items, SMs) CTAs; block WG_THREADS; dynamic smem
// BwdKvTf32Smem<D>::BYTES.
template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dkdv_tf32_kernel(__grid_constant__ const CUtensorMap tq,
                           __grid_constant__ const CUtensorMap tdo,
                           __grid_constant__ const CUtensorMap tk,
                           __grid_constant__ const CUtensorMap tv,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv, int B, int S,
                           int H, int KV, float scale_log2, float scale, int causal,
                           int window) {
  using L = BwdKvTf32Smem<D>;
  constexpr int NB = L::NB, BQ = L::BQ, ST = L::STAGES, KB = L::KB;
  constexpr bool WIDE = KB > BWD_KB;  // 128-key items, every step for both groups
  constexpr int NT = D > 96 ? D / 2 : D;  // columns of a step's dV or dK part
  constexpr int K_BOXB = KB * 128, Q_BOXB = BQ * 128;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = (smem_u32(wg_smem) + 1023u) & ~1023u;
  unsigned char* gbase = wg_smem + (base - smem_u32(wg_smem));
  const uint32_t v_raw = L::K_TILE;  // offsets; K's raw tile is at 0
  auto stage = [&](int s) { return (uint32_t)(2 * L::K_TILE + L::STAGE * s); };
  auto q_hi = [&](int s) { return stage(s); };
  auto q_lo = [&](int s) { return stage(s) + L::NAT; };
  auto do_hi = [&](int s) { return stage(s) + 2 * L::NAT; };
  auto do_lo = [&](int s) { return stage(s) + 3 * L::NAT; };
  auto qt_hi = [&](int s) { return stage(s) + 4 * L::NAT; };
  auto qt_lo = [&](int s) { return stage(s) + 4 * L::NAT + L::TR; };
  auto dot_hi = [&](int s) { return stage(s) + 4 * L::NAT + 2 * L::TR; };
  auto dot_lo = [&](int s) { return stage(s) + 4 * L::NAT + 3 * L::TR; };
  // stage s: BQ values of -lse log2 e, then BQ of delta
  auto stats = [&](int s) { return reinterpret_cast<float*>(gbase + L::STATS) + 2 * BQ * s; };
  // [D / 2][128] (64-key items): one group's partial dV or dK, over K's and
  // V's raw tiles
  float* red = reinterpret_cast<float*>(gbase);
  const uint32_t bars = base + L::BARS;
  const uint32_t kv_full = bars, kv_empty = bars + 8;
  auto raw_full = [&](int s) { return bars + 8u * (2 + s); };
  auto full = [&](int s) { return bars + 8u * (2 + ST + s); };
  auto empty = [&](int s) { return bars + 8u * (2 + 2 * ST + s); };

  const int G = H / KV;
  const int n_items = (S + KB - 1) / KB * KV * B;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, WG_CONSUMERS);
    for (int s = 0; s < ST; ++s) {
      mbar_init(raw_full(s), 1);
      mbar_init(full(s), F_CONVERTERS);
      mbar_init(empty(s), WIDE ? WG_CONSUMERS : 128);  // the groups that took the step
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: lane 0 of warp 0 loads K and V once an item (once both
    // groups are done with the last ones, and their partial sums) and
    // each step's Q and dO; warps 1-3 read the step's lse and delta
    // (issued before the wait, so the loads overlap the TMA's) and split Q
    // and dO (hi in place, lo, transposed hi and lo).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int g = 0;
      for (int r = 0; item_index(r) < n_items; ++r) {
        const KvItem it = kv_item<BQ, KB>(item_index(r), B, S, KV, G, causal, window);
        if (r > 0) mbar_wait(kv_empty, (r - 1) & 1);
        mbar_expect_tx(kv_full, 2 * L::K_TILE);
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          tma_load(base + c * K_BOXB, &tk, kv_full, c * F_BOX, it.kvh, it.k0, it.b);
          tma_load(base + v_raw + c * K_BOXB, &tv, kv_full, c * F_BOX, it.kvh, it.k0, it.b);
        }
        for (int i = 0; i < it.steps; ++i, ++g) {
          const int s = g % ST, round = g / ST;
          const int h = it.kvh * G + i / it.n_qt;
          const int q0 = it.q_begin + (i % it.n_qt) * BQ;
          if (round > 0) mbar_wait(empty(s), (round - 1) & 1);
          mbar_expect_tx(raw_full(s), 2 * L::NAT);
#pragma unroll
          for (int c = 0; c < NB; ++c) {
            tma_load(base + q_hi(s) + c * Q_BOXB, &tq, raw_full(s), c * F_BOX, h, q0, it.b);
            tma_load(base + do_hi(s) + c * Q_BOXB, &tdo, raw_full(s), c * F_BOX, h, q0, it.b);
          }
        }
      }
    } else if (threadIdx.x >= 32) {
      const int ct = threadIdx.x - 32;
      int g = 0;
      for (int r = 0; item_index(r) < n_items; ++r) {
        const KvItem it = kv_item<BQ, KB>(item_index(r), B, S, KV, G, causal, window);
        for (int i = 0; i < it.steps; ++i, ++g) {
          const int s = g % ST;
          const int h = it.kvh * G + i / it.n_qt;
          const int q0 = it.q_begin + (i % it.n_qt) * BQ;
          // queries past S: lse = +inf makes their P exactly 0
          float nl = 0.f, dl = 0.f;
          if (ct < BQ) {
            const size_t row = ((size_t)it.b * H + h) * S;
            const int qp = q0 + ct;
            nl = qp < S ? -lse[row + qp] * LOG2E : -INFINITY;
            dl = qp < S ? delta[row + qp] : 0.f;
          }
          mbar_wait(raw_full(s), (g / ST) & 1);
          if (ct < BQ) {
            stats(s)[ct] = nl;
            stats(s)[BQ + ct] = dl;
          }
          split_tile<BQ, D, true, true>(gbase + q_hi(s), gbase + q_lo(s), gbase + qt_hi(s),
                                        gbase + qt_lo(s), ct);
          split_tile<BQ, D, true, true>(gbase + do_hi(s), gbase + do_lo(s), gbase + dot_hi(s),
                                        gbase + dot_lo(s), ct);
          fence_async_smem();
          mbar_arrive(full(s));
        }
      }
    }
  } else {
    // Consumers: with 128-key items group cw takes keys 64 cw .. 64 cw + 63
    // of every step; with 64 it takes all keys of the steps of parity cw
    // (counted over all items). Thread (warp w, lane = 4 g + t) holds key
    // rows 16 w + g and + 8 of the group's, query columns 8 j + 2 t, + 1 of
    // S^T and dP^T, and rows 16 w + g, + 8, columns 8 j + 2 t, + 1 of dK
    // and dV.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int lane = tid & 31, w = tid >> 5;
    const int gr = lane >> 2, t = lane & 3;
    int g = 0;  // steps of earlier items
    for (int r = 0; item_index(r) < n_items; ++r) {
      const KvItem it = kv_item<BQ, KB>(item_index(r), B, S, KV, G, causal, window);
      const int kg0 = it.k0 + (WIDE ? 64 * cw : 0);  // the group's first key
      const int kr0 = kg0 + 16 * w + gr;
      const unsigned char* ka = gbase + (WIDE ? 64 * cw * 128 : 0);  // its rows, box 0
      float dka[D / 2], dva[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
      const int first = WIDE ? 0 : (cw + g) & 1;  // this group's first step of the item
      if (first < it.steps) mbar_wait(kv_full, r & 1);
      for (int i = first; i < it.steps; i += WIDE ? 1 : 2) {
        const int gi = g + i, s = gi % ST;
        const int q0 = it.q_begin + (i % it.n_qt) * BQ;
        float sacc[BQ / 2], ssm[BQ / 2], dpacc[BQ / 2], dsm[BQ / 2];
        mbar_wait(full(s), (gi / ST) & 1);
        issue_split<BQ, D, true, false>(sacc, sacc, ssm, dpacc, dpacc, dsm, ka,
                                        ka + v_raw, K_BOXB, 16 * w + gr, gr, t,
                                        base + q_hi(s), base + q_lo(s), base + do_hi(s),
                                        base + do_lo(s), Q_BOXB);
        wgmma_wait<1>();  // S^T is done; dP^T's last chunk may still run
        fence_regs(sacc);
        fence_regs(ssm);
        add_chains<BQ, false>(sacc, sacc, ssm);
        const float* st = stats(s);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 nl = *reinterpret_cast<const float2*>(st + 8 * j + 2 * t);
          sacc[4 * j] = ex2(fmaf(sacc[4 * j], scale_log2, nl.x));
          sacc[4 * j + 1] = ex2(fmaf(sacc[4 * j + 1], scale_log2, nl.y));
          sacc[4 * j + 2] = ex2(fmaf(sacc[4 * j + 2], scale_log2, nl.x));
          sacc[4 * j + 3] = ex2(fmaf(sacc[4 * j + 3], scale_log2, nl.y));
        }
        // keys past S need no mask: their rows of dK and dV are not stored
        if ((causal && q0 < kg0 + 63) || (window > 0 && kg0 <= q0 + BQ - 1 - window)) {
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = kr0 + 8 * (e >> 1), qp = q0 + 8 * j + 2 * t + (e & 1);
              if ((causal && key > qp) || (window > 0 && key <= qp - window))
                sacc[4 * j + e] = 0.f;
            }
        }
        wgmma_wait<0>();
        fence_regs(dpacc);
        fence_regs(dsm);
        add_chains<BQ, false>(dpacc, dpacc, dsm);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 dl = *reinterpret_cast<const float2*>(st + BQ + 8 * j + 2 * t);
          dpacc[4 * j] = sacc[4 * j] * (dpacc[4 * j] - dl.x);
          dpacc[4 * j + 1] = sacc[4 * j + 1] * (dpacc[4 * j + 1] - dl.y);
          dpacc[4 * j + 2] = sacc[4 * j + 2] * (dpacc[4 * j + 2] - dl.x);
          dpacc[4 * j + 3] = sacc[4 * j + 3] * (dpacc[4 * j + 3] - dl.y);
        }
        uint32_t ph[BQ / 8][4], pl[BQ / 8][4], dh[BQ / 8][4], dlo[BQ / 8][4];
        split_acc<BQ>(sacc, ph, pl);
        split_acc<BQ>(dpacc, dh, dlo);
        // dV += P^T dO and dK += dS^T Q, each step's product in a fresh
        // accumulator added in float32 (one chain over all of an item's
        // steps drifts, as the forward's P V would); NT columns at a time
        // (half of D from 112: registers), rows NT h .. of the transposed
        // tiles
        auto step_part = [&](float (&acc)[D / 2], const uint32_t (&a_hi)[BQ / 8][4],
                             const uint32_t (&a_lo)[BQ / 8][4], uint32_t b_hi, uint32_t b_lo,
                             int h) {
          float part[NT / 2];
          const uint32_t rows = h * NT * BQ * 4;
          issue_rs_tf32<NT, BQ / 8>(part, a_hi, a_lo, b_hi + rows, b_lo + rows, true);
          wgmma_wait<0>();
          fence_regs(part);
#pragma unroll
          for (int i = 0; i < NT / 2; ++i) acc[h * NT / 2 + i] += part[i];
        };
#pragma unroll
        for (int h = 0; h < D / NT; ++h)
          step_part(dva, ph, pl, base + dot_hi(s), base + dot_lo(s), h);
#pragma unroll
        for (int h = 0; h < D / NT; ++h)
          step_part(dka, dh, dlo, base + qt_hi(s), base + qt_lo(s), h);
        mbar_arrive(empty(s));
      }
      g += it.steps;
      if constexpr (WIDE) {
        mbar_arrive(kv_empty);  // this group is done with K's and V's raw tiles
      } else {
        // Both groups are done with K's and V's raw tiles; group 1 hands its
        // dV to group 0, then group 0 its dK to group 1, through them. A
        // thread's partner holds the same elements in the same registers.
        consumers_sync();
        float* part = red + tid;
        if (cw == 1) {
#pragma unroll
          for (int i = 0; i < D / 2; ++i) part[i * 128] = dva[i];
        }
        consumers_sync();
        if (cw == 0) {
#pragma unroll
          for (int i = 0; i < D / 2; ++i) dva[i] += part[i * 128];
        }
        consumers_sync();
        if (cw == 0) {
#pragma unroll
          for (int i = 0; i < D / 2; ++i) part[i * 128] = dka[i];
        }
        consumers_sync();
        if (cw == 1) {
#pragma unroll
          for (int i = 0; i < D / 2; ++i) dka[i] += part[i * 128];
        }
        fence_async_smem();  // the next item's TMA loads K and V over `red`
        consumers_sync();
        mbar_arrive(kv_empty);
      }

      const size_t kv_row = (size_t)KV * D;
      const size_t at = ((size_t)it.b * S + kr0) * kv_row + (size_t)it.kvh * D;
      if (WIDE || cw == 0) store_rows_f32<D>(dva, dv + at, kv_row, kr0, S, t, 1.f);
      if (WIDE || cw == 1) store_rows_f32<D>(dka, dk + at, kv_row, kr0, S, t, scale);
    }
  }
}

// cuTensorMapEncodeTiled is a driver-API call. It is reached through the
// runtime's cudaGetDriverEntryPoint, so the library needs no -lcuda and
// loads wherever the CUDA runtime does.
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

// A 4-D map over a contiguous (B, S, heads, D) bf16 (or, with f32, float32)
// tensor, dimensions innermost first: (D, heads, S, B); a box is 128 bytes
// of a row (64 bf16 or 32 float32 columns) by `rows`. S stays its own
// dimension, so the zero fill past S never reads the next sequence's rows.
bool make_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int B,
              int S, int heads, int D, int rows, bool f32 = false) {
  const cuuint64_t e = f32 ? 4 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * e, (cuuint64_t)heads * D * e,
                                 (cuuint64_t)S * heads * D * e};
  const cuuint32_t box[4] = {f32 ? (cuuint32_t)F_BOX : (cuuint32_t)BOX_COLS, 1,
                             (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                4, const_cast<void*>(ptr),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool LSE>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int S, int H, int KV, float scale,
                         int causal, int window, cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, encode, q, B, S, H, D, WG_BQ) ||
      !make_map(&tk, encode, k, B, S, KV, D, WG_BK) ||
      !make_map(&tv, encode, v, B, S, KV, D, WG_BK))
    return cudaErrorInvalidValue;
  constexpr int smem = WgSmem<D>::BYTES;
  // Once per device, head dim and LSE (they cost host time on every call
  // otherwise): the shared-memory opt-in and the SM count.
  constexpr int MAX_DEVICES = 64;
  static int sms_of[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  int sms = sms_of[device];
  if (sms == 0) {
    err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D, LSE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    sms_of[device] = sms;
  }
  const long long items = (long long)((S + WG_BQ - 1) / WG_BQ) * H * B;
  const int grid = (int)(items < sms ? items : sms);  // one CTA per SM
  flash_fwd_wgmma_kernel<D, LSE><<<grid, WG_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), B, S, H, KV, scale * LOG2E,
      causal, window, lse);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_wgmma(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse, const float* delta,
                             void* dq, void* dk, void* dv, int B, int S, int H, int KV,
                             float scale, int causal, int window, cudaStream_t stream) {
  using LK = BwdKvSmem<D>;
  using LQ = BwdQSmem<D>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  // dK/dV: Q and dO in boxes of BQ rows, K and V of 64; dQ: 128 rows each
  CUtensorMap kq, kdo, kk, kv, qq, qdo, qk, qv;
  if (!make_map(&kq, encode, q, B, S, H, D, LK::BQ) ||
      !make_map(&kdo, encode, dout, B, S, H, D, LK::BQ) ||
      !make_map(&kk, encode, k, B, S, KV, D, BWD_KB) ||
      !make_map(&kv, encode, v, B, S, KV, D, BWD_KB) ||
      !make_map(&qq, encode, q, B, S, H, D, WG_BQ) ||
      !make_map(&qdo, encode, dout, B, S, H, D, WG_BQ) ||
      !make_map(&qk, encode, k, B, S, KV, D, WG_BK) ||
      !make_map(&qv, encode, v, B, S, KV, D, WG_BK))
    return cudaErrorInvalidValue;
  // once per device and head dim: the shared-memory opt-ins and the SM count
  static int sms_of[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  int sms = sms_of[device];
  if (sms == 0) {
    err = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, LK::BYTES);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, LQ::BYTES);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    sms_of[device] = sms;
  }
  using bf = __nv_bfloat16;
  const long long kv_items = (long long)((S + BWD_KB - 1) / BWD_KB) * KV * B;
  flash_bwd_dkdv_wgmma_kernel<D><<<(int)(kv_items < sms ? kv_items : sms), WG_THREADS,
                                   LK::BYTES, stream>>>(
      kq, kdo, kk, kv, lse, delta, static_cast<bf*>(dk), static_cast<bf*>(dv), B, S, H,
      KV, scale * LOG2E, scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long q_items = (long long)((S + WG_BQ - 1) / WG_BQ) * H * B;
  flash_bwd_dq_wgmma_kernel<D><<<(int)(q_items < sms ? q_items : sms), WG_THREADS,
                                 LQ::BYTES, stream>>>(
      qq, qdo, qk, qv, lse, delta, static_cast<bf*>(dq), B, S, H, KV, scale * LOG2E,
      scale, causal, window);
  return cudaGetLastError();
}

// Once per device and kernel (it costs host time on every call otherwise):
// the kernel's shared-memory opt-in, and the SM count into *sms.
template <typename K>
cudaError_t opt_in_once(int (&sms_of)[MAX_DEVICES], K* kernel, int bytes, int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (sms_of[device] == 0) {
    int n = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    sms_of[device] = n;
  }
  *sms = sms_of[device];
  return cudaSuccess;
}

template <int D, bool LSE>
cudaError_t launch_fwd_tf32(const void* q, const void* k, const void* v, void* o,
                            float* lse, int B, int S, int H, int KV, float scale,
                            int causal, int window, cudaStream_t stream) {
  using L = FwdTf32Smem<D>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, encode, q, B, S, H, D, WG_BQ, true) ||
      !make_map(&tk, encode, k, B, S, KV, D, L::BK, true) ||
      !make_map(&tv, encode, v, B, S, KV, D, L::BK, true))
    return cudaErrorInvalidValue;
  static int sms_of[MAX_DEVICES] = {};
  int sms = 0;
  cudaError_t err = opt_in_once(sms_of, flash_fwd_tf32_kernel<D, LSE>, L::BYTES, &sms);
  if (err != cudaSuccess) return err;
  const long long items = (long long)((S + WG_BQ - 1) / WG_BQ) * H * B;
  flash_fwd_tf32_kernel<D, LSE><<<(int)(items < sms ? items : sms), WG_THREADS, L::BYTES,
                                  stream>>>(tq, tk, tv, static_cast<float*>(o), B, S, H, KV,
                                            scale * LOG2E, causal, window, lse);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_tf32(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse, const float* delta,
                            void* dq, void* dk, void* dv, int B, int S, int H, int KV,
                            float scale, int causal, int window, cudaStream_t stream) {
  using LK = BwdKvTf32Smem<D>;
  using LQ = BwdQTf32Smem<D>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  // dK/dV: Q and dO in boxes of BQ rows, K and V of KB; dQ: Q and dO of
  // 128, K and V of BK
  CUtensorMap kq, kdo, kk, kv, qq, qdo, qk, qv;
  if (!make_map(&kq, encode, q, B, S, H, D, LK::BQ, true) ||
      !make_map(&kdo, encode, dout, B, S, H, D, LK::BQ, true) ||
      !make_map(&kk, encode, k, B, S, KV, D, LK::KB, true) ||
      !make_map(&kv, encode, v, B, S, KV, D, LK::KB, true) ||
      !make_map(&qq, encode, q, B, S, H, D, WG_BQ, true) ||
      !make_map(&qdo, encode, dout, B, S, H, D, WG_BQ, true) ||
      !make_map(&qk, encode, k, B, S, KV, D, LQ::BK, true) ||
      !make_map(&qv, encode, v, B, S, KV, D, LQ::BK, true))
    return cudaErrorInvalidValue;
  static int kv_sms_of[MAX_DEVICES] = {}, q_sms_of[MAX_DEVICES] = {};
  int sms = 0;
  cudaError_t err = opt_in_once(kv_sms_of, flash_bwd_dkdv_tf32_kernel<D>, LK::BYTES, &sms);
  if (err == cudaSuccess)
    err = opt_in_once(q_sms_of, flash_bwd_dq_tf32_kernel<D>, LQ::BYTES, &sms);
  if (err != cudaSuccess) return err;
  const long long kv_items = (long long)((S + LK::KB - 1) / LK::KB) * KV * B;
  flash_bwd_dkdv_tf32_kernel<D><<<(int)(kv_items < sms ? kv_items : sms), WG_THREADS,
                                  LK::BYTES, stream>>>(
      kq, kdo, kk, kv, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), B, S, H,
      KV, scale * LOG2E, scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long q_items = (long long)((S + WG_BQ - 1) / WG_BQ) * H * B;
  flash_bwd_dq_tf32_kernel<D><<<(int)(q_items < sms ? q_items : sms), WG_THREADS, LQ::BYTES,
                                stream>>>(qq, qdo, qk, qv, lse, delta, static_cast<float*>(dq),
                                          B, S, H, KV, scale * LOG2E, scale, causal, window);
  return cudaGetLastError();
}

// The float32 (3xTF32) kernels' head dims, both ways: every multiple of 16
// up to DMAX.
#define REPRO_TF32_D(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

template <bool LSE>
cudaError_t dispatch_fwd_tf32(const void* q, const void* k, const void* v, void* o,
                              float* lse, int B, int S, int H, int KV, int D, float scale,
                              int causal, int window, cudaStream_t stream) {
  switch (D) {
#define REPRO_FLASH_CASE(DD) \
  case DD: return launch_fwd_tf32<DD, LSE>(q, k, v, o, lse, B, S, H, KV, scale, causal, window, stream);
    REPRO_TF32_D(REPRO_FLASH_CASE)
#undef REPRO_FLASH_CASE
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_bwd_tf32(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse, const float* delta,
                              void* dq, void* dk, void* dv, int B, int S, int H, int KV,
                              int D, float scale, int causal, int window,
                              cudaStream_t stream) {
  switch (D) {
#define REPRO_FLASH_CASE(DD)                                                       \
  case DD:                                                                         \
    return launch_bwd_tf32<DD>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, KV, \
                               scale, causal, window, stream);
    REPRO_TF32_D(REPRO_FLASH_CASE)
#undef REPRO_FLASH_CASE
    default: return cudaErrorInvalidValue;
  }
}

// The float32 wgmma kernels' plan at head dim D (forward keys a tile and
// stages, dQ keys a tile and stages, dK/dV keys an item, queries a step and
// stages, and the three kernels' dynamic shared memory), or false where D
// has none.
template <int D>
void tf32_plan_of(int (&plan)[10]) {
  using F = FwdTf32Smem<D>;
  using Q = BwdQTf32Smem<D>;
  using K = BwdKvTf32Smem<D>;
  const int p[10] = {F::BK, F::STAGES, Q::BK, Q::STAGES, K::KB, K::BQ, K::STAGES, F::BYTES,
                     Q::BYTES, K::BYTES};
  for (int i = 0; i < 10; ++i) plan[i] = p[i];
}

bool tf32_plan(int D, int (&plan)[10]) {
  switch (D) {
#define REPRO_FLASH_CASE(DD) \
  case DD: tf32_plan_of<DD>(plan); return true;
    REPRO_TF32_D(REPRO_FLASH_CASE)
#undef REPRO_FLASH_CASE
    default: return false;
  }
}

// The head dims of the bf16 wgmma kernels: every multiple of 16 up to DMAX.
#define REPRO_BF16_D(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

// bf16 backward: TMA + wgmma at every D.
cudaError_t dispatch_bwd_bf16(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse, const float* delta,
                              void* dq, void* dk, void* dv, int B, int S, int H,
                              int KV, int D, float scale, int causal, int window,
                              cudaStream_t stream) {
  switch (D) {
#define REPRO_FLASH_CASE(DD)                                                        \
  case DD:                                                                          \
    return launch_bwd_wgmma<DD>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, KV, \
                                scale, causal, window, stream);
    REPRO_BF16_D(REPRO_FLASH_CASE)
#undef REPRO_FLASH_CASE
    default: return cudaErrorInvalidValue;
  }
}

// The kernel flash_attention_fwd runs for (dtype, D), and its dynamic
// shared memory in bytes.
enum Route { ROUTE_NONE, ROUTE_WGMMA, ROUTE_TF32 };

Route route(int dtype, int D, size_t* smem) {
  if (D % 16 != 0 || D < 16 || D > DMAX) return ROUTE_NONE;
  if (dtype == 0) {
    int plan[10];
    if (!tf32_plan(D, plan)) return ROUTE_NONE;
    *smem = plan[7];
    return ROUTE_TF32;
  }
  if (dtype != 1) return ROUTE_NONE;
  // one 64-column box per tile row up to D = 64, two from D = 80 to 128
  *smem = D <= 64 ? WgSmem<64>::BYTES : WgSmem<128>::BYTES;
  return ROUTE_WGMMA;
}

template <bool LSE>
cudaError_t dispatch_wgmma(const void* q, const void* k, const void* v, void* o,
                           float* lse, int B, int S, int H, int KV, int D,
                           float scale, int causal, int window,
                           cudaStream_t stream) {
  switch (D) {
#define REPRO_FLASH_CASE(DD) \
  case DD: return launch_wgmma<DD, LSE>(q, k, v, o, lse, B, S, H, KV, scale, causal, window, stream);
    REPRO_BF16_D(REPRO_FLASH_CASE)
#undef REPRO_FLASH_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. window <= 0: no sliding window. lse:
// NULL (serving), or (B, H, S) float32 for each row's log-sum-exp, which the
// backward reads. Returns the CUDA error code of the launch (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        void* lse, int B, int S, int H, int KV, int D,
                        float scale, int causal, int window, int dtype,
                        void* stream) {
  size_t smem = 0;
  const Route r = route(dtype, D, &smem);
  if (r == ROUTE_NONE || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (r) {
    case ROUTE_TF32:
      return (int)(l ? dispatch_fwd_tf32<true>(q, k, v, o, l, B, S, H, KV, D,
                                               scale, causal, window, st)
                     : dispatch_fwd_tf32<false>(q, k, v, o, l, B, S, H, KV, D,
                                                scale, causal, window, st));
    default:
      return (int)(l ? dispatch_wgmma<true>(q, k, v, o, l, B, S, H, KV, D,
                                            scale, causal, window, st)
                     : dispatch_wgmma<false>(q, k, v, o, l, B, S, H, KV, D,
                                             scale, causal, window, st));
  }
}

// Name of the kernel flash_attention_fwd runs for (dtype, D): "wgmma" (bf16
// at every D) or "wgmma.3xtf32" (float32 at every D), or NULL where it
// refuses them; *smem_bytes is that kernel's dynamic shared memory per CTA.
const char* flash_attention_route(int dtype, int D, int* smem_bytes) {
  size_t smem = 0;
  const Route r = route(dtype, D, &smem);
  *smem_bytes = (int)smem;
  return r == ROUTE_WGMMA ? "wgmma" : r == ROUTE_TF32 ? "wgmma.3xtf32" : nullptr;
}

// The float32 wgmma kernels' tiles at head dim D: plan = {forward keys a
// tile, forward ring stages, dQ keys a tile, dQ stages, dK/dV keys an
// item, dK/dV queries a step, dK/dV stages, and the forward's, dQ's and
// dK/dV's dynamic shared memory in bytes}. Returns 0, or -1 where D has no
// such kernels.
int flash_attention_tf32_plan(int D, int* plan) {
  int p[10];
  if (!tf32_plan(D, p)) return -1;
  for (int i = 0; i < 10; ++i) plan[i] = p[i];
  return 0;
}

// The backward of flash_attention_fwd: dq (B, S, H, D), dk and dv (B, S, KV,
// D) in the inputs' dtype from q, k, v, the forward's o and lse, and dout;
// delta is (B, H, S) float32 scratch. Three launches (delta, dK/dV, dQ), no
// atomics. Returns the CUDA error code of the launches (0 on success).
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* lse, const void* dout,
                        void* dq, void* dk, void* dv, void* delta, int B, int S,
                        int H, int KV, int D, float scale, int causal,
                        int window, int dtype, void* stream) {
  if (D % 16 != 0 || D < 16 || D > DMAX || H % KV != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dl = static_cast<float*>(delta);
  const float* l = static_cast<const float*>(lse);
  if (dtype == 0)
    launch_delta<float>(o, dout, dl, B * S * H, S, H, D, st);
  else
    launch_delta<__nv_bfloat16>(o, dout, dl, B * S * H, S, H, D, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0)
    return (int)dispatch_bwd_tf32(q, k, v, dout, l, dl, dq, dk, dv, B, S, H, KV, D,
                                  scale, causal, window, st);
  return (int)dispatch_bwd_bf16(q, k, v, dout, l, dl, dq, dk, dv, B, S, H, KV, D,
                                scale, causal, window, st);
}

// Name of the kernels flash_attention_bwd runs for (dtype, D): "wgmma"
// (bf16 at every D) or "wgmma.3xtf32" (float32 at every D), or NULL where
// it refuses them; *smem_bytes is the larger dynamic shared memory of its
// two tile kernels.
const char* flash_attention_bwd_route(int dtype, int D, int* smem_bytes) {
  *smem_bytes = 0;
  if (D % 16 != 0 || D < 16 || D > DMAX) return nullptr;
  if (dtype == 0) {
    int plan[10];
    if (!tf32_plan(D, plan)) return nullptr;
    *smem_bytes = plan[8] > plan[9] ? plan[8] : plan[9];
    return "wgmma.3xtf32";
  }
  if (dtype != 1) return nullptr;
  switch (D) {
#define REPRO_FLASH_CASE(DD) \
  case DD: *smem_bytes = bwd_wgmma_smem<DD>(); return "wgmma";
    REPRO_BF16_D(REPRO_FLASH_CASE)
#undef REPRO_FLASH_CASE
    default: return nullptr;
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
