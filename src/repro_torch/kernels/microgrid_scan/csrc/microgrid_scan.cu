// The microgrid co-simulation (battery, solar, grid connection) as one serial
// scan per trace, for Hopper, sm_90a.
//
// Replaces repro/core/microgrid.py::simulate, a jax.lax.scan over the steps
// that XLA compiles into one loop (not a Pallas kernel). Per step t, in
// float32, with the constants folded on the host as XLA folds the scan's
// (repro_torch/core/microgrid.py::constants):
//
//   surplus   = solar - load
//   room      = max(soc_hi - soc_wh, 0)
//   charge    = clamp(surplus, 0, min(max_chg, room * k_room))
//   avail     = max(soc_wh - soc_lo, 0)
//   discharge = clamp(-surplus, 0, min(max_dis_w, avail * k_avail))
//   soc_wh    = (soc_wh + charge * k_charge) - discharge * k_discharge
//   grid      = (surplus - charge) + discharge     (> 0 export, < 0 import)
//   traces    : soc_wh * k_soc, max(-grid, 0), max(grid, 0), charge,
//               discharge, (max(-grid, 0) * k_emis) * ci, min(solar, load + charge)
//
// What bounds it on this card. The only carried state is soc_wh, so the
// steps are serial, and nothing else is: bytes (3 inputs and 7 traces of 4
// bytes a step, ~72 KB at Table 2's 1800 steps) and operations are far below
// the chain at the card's rates. Of a step's ~27 operations only those that
// read soc_wh lie on the chain, and two of them do not need to: charge is
// min(max(surplus, 0), min(max_chg, room k_room)), and min is associative
// (max.NaN / min.NaN too, with the operands kept in order), so
// min(min(max(surplus, 0), max_chg), room k_room) is the same bits, and its
// inner min reads no soc; so for discharge and max_dis_w. That leaves seven
// dependent operations a step (sub, max, mul, min, mul, add, sub). No sum is
// reassociated and nothing is contracted into an FMA.
//
// Design: one CTA a trace, B traces a launch. Warp 0 walks: its lane 0
// carries soc_wh alone through each window of WINDOW steps, reading the
// step's two caps (pos = min(max(surplus, 0), max_chg), neg = min(max(-surplus,
// 0), max_dis_w)) from shared memory UNROLL at a time, the next UNROLL
// loaded before the current ones are walked, and writing each step's
// incoming soc_wh back beside them. It stores nothing to device memory and
// waits only for a window's inputs. Warps 1-3 stage and write: they load a
// window's load, solar and ci into a ring of RING windows in shared memory
// and compute its caps, and, LAG windows behind, recompute each walked
// step from its inputs and its incoming soc_wh with the loop's operations in
// the loop's order (so the traces are the plain loop's bits) and store the
// seven traces, consecutive threads on consecutive 4-step quads of each
// plane (16-byte stores when T is a multiple of 4). Named barriers hand the
// windows over: STAGED + slot (stagers arrive, the walker waits) and WALKED
// + slot (the walker arrives, the writers wait), RING of each; each
// instance counts all THREADS threads once, and no thread arrives on a slot's
// barrier again before the other side has passed its previous instance. The
// writers' turn j writes window j - LAG and then stages window j into the
// slot window j - RING left: LAG = RING - 1 keeps that slot's writes one turn
// (and one barrier that every writer joins) back, and LAG >= 2 stages
// window j while the walker walks window j - 1, so it never waits on a
// store. A year at 60 s still runs window after window.
//
// Readings on an H100 (700 W, SM clock 1980 MHz while it ran; graph cycles
// a step at Table 2's 1800 steps / over a year of 525,600). The one-thread
// kernel this replaces (one CTA a trace, 2048-step windows staged before
// one thread walked them and stored the seven traces) took 80.0 / 78.5;
// the same kernel without its seven stores 42.3 / 40.9, and with its
// walker doing only the soc recurrence (8 operations, no traces) 42.9 /
// 41.4: the stores, one-lane scalar writes into seven planes, held the
// other half of its time, the off-chain arithmetic none of it. This
// design: 38.0 / 35.5 at 512-step windows (256: 38.9 / 36.3, 128: 39.8 /
// 37.4; a ring of 4: 40.2 / 37.5), 0.0345 ms at Table 2's trace. Its
// walker's loop is the seven dependent instructions a step (FADD, FMNMX.NAN,
// FMUL, FMNMX.NAN, FMUL, FADD, FADD in the SASS), so ~5 cycles each on
// this card, not 4; the parent's walker took 5.9 cycles a step more for the
// one FMNMX.NAN the fold takes off the chain.
//
// Bitwise equal to the plain loop (ref.py) on the same device: every
// operation is written with __fadd_rn, __fsub_rn and __fmul_rn in the loop's
// order, so nvcc contracts nothing into an FMA, and max and min propagate NaN
// as torch.maximum and torch.minimum do (fmaxf and fminf drop it; max.NaN and
// min.NaN keep it): without a battery k_soc is inf and the soc trace NaN, as
// in the loop.
#include <cuda_runtime.h>

namespace {

constexpr int WINDOW = 512;   // steps a window: the walker's unit of hand-over
constexpr int RING = 3;       // windows in shared memory
constexpr int LAG = RING - 1; // windows the trace writers run behind the stagers
constexpr int THREADS = 128;  // warp 0 walks, warps 1-3 stage and write
constexpr int WRITERS = THREADS - 32;
constexpr int UNROLL = 8;     // steps whose caps the walker loads at once
constexpr int STAGED = 1;     // named barrier ids (0 is __syncthreads'):
constexpr int WALKED = STAGED + RING;  // STAGED + slot, WALKED + slot
static_assert(LAG >= 2 && LAG <= RING - 1, "see the hand-over above");
static_assert(WALKED + RING <= 16, "16 named barriers a CTA");
static_assert(WINDOW % UNROLL == 0 && UNROLL % 4 == 0, "float4 loads");

// the folded constants, in the order of ops.CONSTANTS
struct Constants {
  float soc_init_wh, soc_hi, soc_lo, max_chg, max_dis_w, k_room, k_avail,
      k_charge, k_discharge, k_emis, k_soc;
};

// One window of the ring: the staged inputs, the caps the walker reads and
// the incoming soc_wh it writes.
struct __align__(16) Slot {
  float load[WINDOW], solar[WINDOW], ci[WINDOW], pos[WINDOW], neg[WINDOW],
      soc[WINDOW];
};

// torch.maximum / torch.minimum: NaN where either operand is NaN. PTX's
// max.NaN / min.NaN (sm_80 and later) do that in one instruction, where
// tests and selects around fmaxf / fminf would lengthen the chain.
__device__ __forceinline__ float tmax(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float tmin(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(THREADS) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(THREADS) : "memory");
}

// The chain: soc_wh after one step, from the step's caps. The same bits as
// step()'s soc_wh (the note above).
__device__ __forceinline__ float advance(float soc_wh, float pos, float neg,
                                         const Constants& k) {
  const float charge =
      tmin(pos, __fmul_rn(tmax(__fsub_rn(k.soc_hi, soc_wh), 0.0f), k.k_room));
  const float discharge =
      tmin(neg, __fmul_rn(tmax(__fsub_rn(soc_wh, k.soc_lo), 0.0f), k.k_avail));
  return __fsub_rn(__fadd_rn(soc_wh, __fmul_rn(charge, k.k_charge)),
                   __fmul_rn(discharge, k.k_discharge));
}

// The walker (lane 0 of warp 0): n steps of one staged window from soc_wh;
// writes each step's incoming soc_wh into s.soc and returns the outgoing one.
__device__ __forceinline__ float walk(Slot& s, int n, float soc_wh,
                                      const Constants& k) {
  const float4* pos = reinterpret_cast<const float4*>(s.pos);
  const float4* neg = reinterpret_cast<const float4*>(s.neg);
  float4* soc = reinterpret_cast<float4*>(s.soc);
  float4 p0 = pos[0], p1 = pos[1], n0 = neg[0], n1 = neg[1];
  int i = 0;
  for (; i + UNROLL <= n; i += UNROLL) {
    // the next UNROLL steps' caps (stale past n, never used), in flight
    // while these are walked
    const int nx = min(i + UNROLL, WINDOW - UNROLL) / 4;
    const float4 q0 = pos[nx], q1 = pos[nx + 1], m0 = neg[nx], m1 = neg[nx + 1];
    float4 a, b;
    a.x = soc_wh; soc_wh = advance(soc_wh, p0.x, n0.x, k);
    a.y = soc_wh; soc_wh = advance(soc_wh, p0.y, n0.y, k);
    a.z = soc_wh; soc_wh = advance(soc_wh, p0.z, n0.z, k);
    a.w = soc_wh; soc_wh = advance(soc_wh, p0.w, n0.w, k);
    b.x = soc_wh; soc_wh = advance(soc_wh, p1.x, n1.x, k);
    b.y = soc_wh; soc_wh = advance(soc_wh, p1.y, n1.y, k);
    b.z = soc_wh; soc_wh = advance(soc_wh, p1.z, n1.z, k);
    b.w = soc_wh; soc_wh = advance(soc_wh, p1.w, n1.w, k);
    soc[i / 4] = a;
    soc[i / 4 + 1] = b;
    p0 = q0, p1 = q1, n0 = m0, n1 = m1;
  }
  for (; i < n; ++i) {
    s.soc[i] = soc_wh;
    soc_wh = advance(soc_wh, s.pos[i], s.neg[i], k);
  }
  return soc_wh;
}

// One step from its incoming soc_wh, as the plain loop computes it: the
// seven traces into t, in TRACE_KEYS order.
__device__ __forceinline__ void step(float ld, float sol, float c, float soc_wh,
                                     const Constants& k, float (&t)[7]) {
  const float surplus = __fsub_rn(sol, ld);
  const float room = tmax(__fsub_rn(k.soc_hi, soc_wh), 0.0f);
  const float charge = tmin(tmax(surplus, 0.0f),
                            tmin(k.max_chg, __fmul_rn(room, k.k_room)));
  const float avail = tmax(__fsub_rn(soc_wh, k.soc_lo), 0.0f);
  const float max_dis = tmin(k.max_dis_w, __fmul_rn(avail, k.k_avail));
  const float discharge = tmin(tmax(-surplus, 0.0f), max_dis);
  soc_wh = __fsub_rn(__fadd_rn(soc_wh, __fmul_rn(charge, k.k_charge)),
                     __fmul_rn(discharge, k.k_discharge));
  const float grid = __fadd_rn(__fsub_rn(surplus, charge), discharge);
  const float grid_import = tmax(-grid, 0.0f);
  t[0] = __fmul_rn(soc_wh, k.k_soc);
  t[1] = grid_import;
  t[2] = tmax(grid, 0.0f);
  t[3] = charge;
  t[4] = discharge;
  t[5] = __fmul_rn(__fmul_rn(grid_import, k.k_emis), c);
  t[6] = tmin(sol, __fadd_rn(ld, charge));
}

// Stagers (ct = 0..WRITERS-1): the window's n steps of input from x + w0,
// and their caps.
__device__ __forceinline__ void stage(Slot& s, const float* __restrict__ load,
                                      const float* __restrict__ solar,
                                      const float* __restrict__ ci, int n,
                                      const Constants& k, int ct) {
  for (int i = ct; i < n; i += WRITERS) {
    const float ld = load[i], sol = solar[i];
    s.load[i] = ld;
    s.solar[i] = sol;
    s.ci[i] = ci[i];
    const float surplus = __fsub_rn(sol, ld);
    s.pos[i] = tmin(tmax(surplus, 0.0f), k.max_chg);
    s.neg[i] = tmin(tmax(-surplus, 0.0f), k.max_dis_w);
  }
}

// Writers: the seven traces of the window's n walked steps at o (step 0 of
// the window in plane 0; planes `plane` floats apart), a 4-step quad a
// thread; vec: o and plane are multiples of 4 floats.
__device__ __forceinline__ void write(const Slot& s, float* __restrict__ o,
                                      size_t plane, int n, bool vec,
                                      const Constants& k, int ct) {
  for (int i = 4 * ct; i < n; i += 4 * WRITERS) {
    float t[4][7];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i + u < n) step(s.load[i + u], s.solar[i + u], s.ci[i + u], s.soc[i + u], k, t[u]);
    if (vec && i + 4 <= n) {
#pragma unroll
      for (int p = 0; p < 7; ++p)
        *reinterpret_cast<float4*>(o + p * plane + i) =
            make_float4(t[0][p], t[1][p], t[2][p], t[3][p]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i + u < n)
#pragma unroll
          for (int p = 0; p < 7; ++p) o[p * plane + i + u] = t[u][p];
    }
  }
}

// out: (7, B, T), the traces in TRACE_KEYS order
__global__ void __launch_bounds__(THREADS)
microgrid_scan_kernel(const float* __restrict__ load,
                      const float* __restrict__ solar,
                      const float* __restrict__ ci, float* __restrict__ out,
                      int B, int T, Constants k) {
  __shared__ Slot ring[RING];
  const size_t row = (size_t)blockIdx.x * T;
  const size_t plane = (size_t)B * T;
  const int n_win = (T + WINDOW - 1) / WINDOW;
  if (threadIdx.x < 32) {
    float soc_wh = k.soc_init_wh;
    for (int w = 0; w < n_win; ++w) {
      const int slot = w % RING;
      bar_sync(STAGED + slot);
      if (threadIdx.x == 0) soc_wh = walk(ring[slot], min(WINDOW, T - w * WINDOW), soc_wh, k);
      __syncwarp();
      bar_arrive(WALKED + slot);
    }
  } else {
    const int ct = threadIdx.x - 32;
    const bool vec = T % 4 == 0;
    for (int j = 0; j < n_win + LAG; ++j) {
      if (j >= LAG) {
        const int w = j - LAG, slot = w % RING;
        bar_sync(WALKED + slot);
        write(ring[slot], out + row + (size_t)w * WINDOW, plane,
              min(WINDOW, T - w * WINDOW), vec, k, ct);
      }
      if (j < n_win) {
        const size_t at = row + (size_t)j * WINDOW;
        stage(ring[j % RING], load + at, solar + at, ci + at,
              min(WINDOW, T - j * WINDOW), k, ct);
        bar_arrive(STAGED + j % RING);
      }
    }
  }
}

}  // namespace

extern "C" {

// load, solar, ci: (B, T) float32, contiguous; out: (7, B, T) float32.
// The eleven constants in the order of struct Constants. Returns the CUDA
// error code of the launch (0 on success); B = 0 or T = 0 launches nothing.
int microgrid_scan_fwd(const float* load, const float* solar, const float* ci,
                       float* out, int B, int T, float soc_init_wh,
                       float soc_hi, float soc_lo, float max_chg,
                       float max_dis_w, float k_room, float k_avail,
                       float k_charge, float k_discharge, float k_emis,
                       float k_soc, void* stream) {
  if (B < 0 || T < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  const Constants k{soc_init_wh, soc_hi,   soc_lo,      max_chg,
                    max_dis_w,   k_room,   k_avail,     k_charge,
                    k_discharge, k_emis,   k_soc};
  microgrid_scan_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      load, solar, ci, out, B, T, k);
  return (int)cudaGetLastError();
}

// Steps a shared-memory window: the unit the walker and the trace writers
// hand over.
int microgrid_scan_window(void) { return WINDOW; }

const char* microgrid_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
