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
// steps are serial: each carries a chain of eight dependent float32
// operations (sub, max, mul, min, min, mul, add, sub), ~4 cycles each,
// ~0.03 ms for Table 2's 1800 steps. Bytes
// (3 inputs and 7 traces of 4 bytes a step, ~72 KB) and operations are far
// below that at the card's rates. So one CTA walks one trace: its threads
// stage load, solar and ci into shared memory a window of WINDOW steps at a
// time (a year at 60 s still fits, window after window), and one thread
// walks the window and stores the seven traces. It reads UNROLL steps'
// inputs into registers before it computes them, so one shared-memory
// latency serves UNROLL steps instead of stalling every step.
// The launch takes a leading batch of B traces, one CTA (one walking thread)
// each.
//
// Bitwise equal to the plain loop (ref.py) on the same device: every
// operation is written with __fadd_rn, __fsub_rn and __fmul_rn in the loop's
// order, so nvcc contracts nothing into an FMA, and max and min propagate NaN
// as torch.maximum and torch.minimum do (fmaxf and fminf drop it; max.NaN and
// min.NaN keep it): without a battery k_soc is inf and the soc trace NaN, as
// in the loop.
#include <cuda_runtime.h>

namespace {

constexpr int WINDOW = 2048;  // steps of the three inputs staged per window
constexpr int THREADS = 128;  // threads that stage a window
constexpr int UNROLL = 8;     // steps whose inputs the walker loads at once

// the folded constants, in the order of ops.CONSTANTS
struct Constants {
  float soc_init_wh, soc_hi, soc_lo, max_chg, max_dis_w, k_room, k_avail,
      k_charge, k_discharge, k_emis, k_soc;
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

// One step: advances soc_wh and stores step i's seven traces at o + j * plane.
__device__ __forceinline__ void step(float ld, float sol, float c,
                                     float& soc_wh, const Constants& k,
                                     float* __restrict__ o, size_t plane,
                                     int i) {
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
  o[i] = __fmul_rn(soc_wh, k.k_soc);
  o[plane + i] = grid_import;
  o[2 * plane + i] = tmax(grid, 0.0f);
  o[3 * plane + i] = charge;
  o[4 * plane + i] = discharge;
  o[5 * plane + i] = __fmul_rn(__fmul_rn(grid_import, k.k_emis), c);
  o[6 * plane + i] = tmin(sol, __fadd_rn(ld, charge));
}

// out: (7, B, T), the traces in TRACE_KEYS order
__global__ void __launch_bounds__(THREADS)
microgrid_scan_kernel(const float* __restrict__ load,
                      const float* __restrict__ solar,
                      const float* __restrict__ ci, float* __restrict__ out,
                      int B, int T, Constants k) {
  __shared__ float s_load[WINDOW];
  __shared__ float s_solar[WINDOW];
  __shared__ float s_ci[WINDOW];
  const size_t row = (size_t)blockIdx.x * T;
  const size_t plane = (size_t)B * T;
  float soc_wh = k.soc_init_wh;
  for (int w0 = 0; w0 < T; w0 += WINDOW) {
    const int n = min(WINDOW, T - w0);
    __syncthreads();  // the walker is done with the previous window
    for (int i = threadIdx.x; i < n; i += THREADS) {
      s_load[i] = load[row + w0 + i];
      s_solar[i] = solar[row + w0 + i];
      s_ci[i] = ci[row + w0 + i];
    }
    __syncthreads();
    if (threadIdx.x != 0) continue;
    float* o = out + row + w0;
    int i = 0;
    for (; i + UNROLL <= n; i += UNROLL) {
      float ld[UNROLL], sol[UNROLL], c[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        ld[u] = s_load[i + u];
        sol[u] = s_solar[i + u];
        c[u] = s_ci[i + u];
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        step(ld[u], sol[u], c[u], soc_wh, k, o, plane, i + u);
    }
    for (; i < n; ++i) step(s_load[i], s_solar[i], s_ci[i], soc_wh, k, o, plane, i);
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

// Steps staged per shared-memory window.
int microgrid_scan_window(void) { return WINDOW; }

const char* microgrid_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
