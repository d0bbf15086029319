"""Device-batched whole-grid evaluation (sweep ``--mode device``).

One torch program on ``torch_device`` evaluates EVERY trace group's
post-simulation passes at once: the groups' ``StageTrace`` composition
columns are zero-padded and ragged-stacked into one ``(G, S)`` tensor
set, and the batched roofline (the same ``_roofline`` kernel
``stage_cost_batch`` runs), the Eq. 1-3 power/energy reductions and
the Eq. 4 emissions — including the per-group scenario fan-out over
the ``pue`` / ``grid_ci`` axes as a stacked ``(G, K)`` axis — run as
one sequence of batched tensor operations for the whole grid, instead
of one numpy pass per group (``repro_torch.sweep.vectorized``).

Counterpart of ``repro.sweep.device``, whose ``_group_kernel`` is one
``jit(vmap)`` program; here the group axis is written out as the
leading dimension of every tensor, and PyTorch runs the program
eagerly: there is no compile, no compilation cache and no compile
span. The reference's ``pmap`` split of the group axis over several
local devices is not ported yet (one device: ``DeviceStats.devices``
is 1).

Trace acquisition composes with ``repro_torch.sweep.divergence``:
groups whose configs differ only in device/TP/PP and provably cannot
diverge in admission timing share one composition schedule (replayed
per config, bit-identically to the event loop) — the event loop runs
only for groups the conservative predicate rejects. Record assembly
reuses ``runner.single_site_metrics``, so device-mode records carry
exactly the event-loop columns.

**Tolerance contract**: numpy modes are bit-identical to the event
loop; device mode is NOT — the roofline and the Eq. 2-4 arithmetic are
elementwise float64 (identical IEEE results on either device), but
(a) the trace-level reductions (``sum(P_i*dt_i)``, ``sum(dt_i)``,
``sum(MFU_i*dt_i)``) reassociate — a pairwise halving tree over each
zero-padded row (``_row_sums``) vs numpy's pairwise summation, ~1e-14
relative — and (b) the Eq. 1 power curve is
evaluated in float32 (mirroring ``core.power.power`` op for op) where
the device's ``pow`` may differ from the host's by a few float32 ulps,
~1e-7 relative on the power factor. ``DEVICE_MODE_RTOL`` bounds both
with margin; columns that never pass through the device program
(latency percentiles, throughput, MFU/batch averages, stage counts)
come from the host-side trace and stay bitwise.

**Batch invariance**: a group's records do not depend on which other
groups share its batch or on how far the batch pads it. Every operation
of the program is elementwise except the row sums, and ``_row_sums``
adds a row's padding only as exact zeros: so the remote backend's
workers, each evaluating a subset of the grid, give the records of one
in-process run over the whole grid bit for bit on the same device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.carbon import reports_from_arrays
from repro_torch.core.energy import reports_from_sums
from repro_torch.core.power import DEVICE_MODE_RTOL, DEVICES
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fleet.config import FleetConfig
from repro_torch.obs.spans import PROFILER
from repro_torch.sim.execmodel import (PARAMS_FIELDS, _Params, _roofline,
                                       cached_execution_model)
from repro_torch.sweep import divergence
from repro_torch.sweep.grid import Scenario
from repro_torch.sweep.vectorized import group_by_trace

__all__ = ["DEVICE_MODE_RTOL", "DeviceStats", "execute_device_grid",
           "records_max_rel_err"]


@dataclasses.dataclass
class DeviceStats:
    """How the device mode acquired and evaluated its traces."""
    trace_groups: int = 0
    event_loops: int = 0     # groups driven through the event loop
    replayed: int = 0        # groups served by divergence replay
    devices: int = 1         # accelerators the program ran on


def _next_pow2(n: int) -> int:
    """Padding bucket: shapes quantize to powers of two, as the
    reference's jit buckets do."""
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


def _row_sums(x: torch.Tensor) -> torch.Tensor:
    """Row sums of a ``(G, S)`` tensor, ``S`` a power of two, by a fixed
    pairwise halving tree: each level adds the upper half of every row
    onto its lower half. A library reduction may split a row over
    threads and blocks by the tensor's whole shape; here the order
    depends on ``S`` alone, and the levels above a row's own stages add
    its zero padding exactly, so its sum has the same bits at any ``G``
    and any padded width (see the module docstring)."""
    while x.shape[1] > 1:
        half = x.shape[1] // 2
        x = x[:, :half] + x[:, half:]
    return x[:, 0]


def _grid_program(comp, params, powerp, ndev, phi, pues, cis):
    """All groups at once: roofline -> Eq. 1 power -> Eq. 2-3
    reductions -> Eq. 4 terms over the scenario axis.

    comp (4, G, S) float64; params (G, P) float64; powerp (G, 5) float32
    (p_idle, p_max_inst, mfu_sat, gamma, p_max_inst - p_idle); ndev, phi
    (G,) and pues, cis (G, K) float64. Zero-padded rows have tokens ==
    0, which the roofline kernel already masks (all outputs zero), so
    only the power factor needs an explicit ``live`` mask (P(0) =
    p_idle, not 0)."""
    p = _Params(*(params[:, i, None] for i in range(len(PARAMS_FIELDS))))
    t = _roofline(comp[0], comp[1], comp[2], comp[3], p, torch)
    dur_s, mfu = t[0], t[6]
    live = (comp[0] + comp[1]) > 0

    # Eq. 1 in float32, mirroring core.power.power() op for op; the
    # (p_max - p_idle) delta is precomputed host-side in float64
    # (powerp[:, 4]) exactly as the eager path subtracts python floats
    col = lambda j: powerp[:, j, None]
    mfu32 = torch.clamp(mfu.to(torch.float32), min=0.0)
    x = torch.minimum(mfu32, col(2)) / col(2)
    pw = col(0) + col(4) * torch.pow(x, col(3))
    pw64 = torch.where(live, pw.to(torch.float64), 0.0)

    e_sum = _row_sums(pw64 * dur_s)                      # W*s
    m_sum = _row_sums(mfu * dur_s)
    dur = _row_sums(dur_s)
    peak = torch.amax(pw64, dim=1)                       # 0 for empty groups
    gpu_h = dur / 3600.0 * ndev
    energy_wh = (e_sum / 3600.0 * ndev)[:, None] * pues   # (G, K)
    op_g = energy_wh / 1000.0 * cis                      # Eq. 4 operational
    emb_g = gpu_h * phi * 1000.0                         # Eq. 4 embodied
    return e_sum, m_sum, dur, peak, op_g, emb_g


def _acquire_results(scenarios: Sequence[Scenario],
                     single: List[List[int]], stats: DeviceStats
                     ) -> Tuple[list, List[float]]:
    """One SimResult per single-site trace group: divergence-shared
    families replay one composition schedule per config; everything
    else runs the event loop."""
    from repro_torch.sim import run_simulation

    fams: Dict[str, List[int]] = {}
    for gi, g in enumerate(single):
        blob = divergence.family_blob(scenarios[g[0]].cfg)
        fams.setdefault(blob, []).append(gi)

    results: list = [None] * len(single)
    sim_elapsed = [0.0] * len(single)
    for members in fams.values():
        cfgs = [scenarios[single[gi][0]].cfg for gi in members]
        shared = (len(members) > 1
                  and divergence.trace_shareable(cfgs)[0])
        for gi, cfg in zip(members, cfgs):
            t0 = time.perf_counter()
            if shared:
                results[gi] = divergence.replay_result(cfg)
                stats.replayed += 1
            else:
                results[gi] = run_simulation(cfg)
                stats.event_loops += 1
            sim_elapsed[gi] = time.perf_counter() - t0
    return results, sim_elapsed


def execute_device_grid(scenarios: Sequence[Scenario],
                        torch_device: DeviceLike = None
                        ) -> Tuple[List[dict], DeviceStats]:
    """Execute a whole cache-missed grid: fleet scenarios pass through
    their own rollup; every single-site trace group is padded into one
    batched tensor set and evaluated by a single program on
    ``torch_device`` (``None``: the card, raising without one)."""
    from repro_torch.sweep.runner import (_execute_fleet_scenario,
                                          shared_result_metrics,
                                          single_site_metrics,
                                          single_site_record)

    dev = resolve_device(torch_device)
    groups = group_by_trace(scenarios)
    stats = DeviceStats(trace_groups=len(groups))
    records: List[Optional[dict]] = [None] * len(scenarios)

    single: List[List[int]] = []
    for g in groups:
        if isinstance(scenarios[g[0]].cfg, FleetConfig):
            # fleet rollups bake CI signals and PUE into per-site
            # co-sims — no stacked axis; identical to the other modes
            for i in g:
                records[i] = _execute_fleet_scenario(scenarios[i],
                                                     torch_device=dev)
        else:
            single.append(g)
    if not single:
        return [r for r in records if r is not None], stats

    with PROFILER.span("device.acquire_traces"):
        results, sim_elapsed = _acquire_results(scenarios, single, stats)

    # ---- pad + ragged-stack into one (G, S) / (G, K) tensor set ----
    n_g = len(single)
    gp = _next_pow2(n_g)
    sp = _next_pow2(max(max(len(r.stages) for r in results), 1))
    kp = _next_pow2(max(max(len(g) for g in single), 1))
    comp = np.zeros((4, gp, sp))
    params = np.ones((gp, len(PARAMS_FIELDS)))
    powerp = np.zeros((gp, 5), np.float32)
    powerp[:, 2] = 0.5                   # padded groups: x = 0/0 guard
    powerp[:, 3] = 1.0
    ndev = np.ones(gp)
    phi = np.zeros(gp)
    pues = np.zeros((gp, kp))
    cis = np.zeros((gp, kp))
    for gi, (g, res) in enumerate(zip(single, results)):
        cfg = res.cfg
        tr = res.stages
        m = len(tr)
        comp[0, gi, :m] = tr.n_prefill_tokens
        comp[1, gi, :m] = tr.n_decode_tokens
        comp[2, gi, :m] = tr.score_flops
        comp[3, gi, :m] = tr.kv_rw_bytes
        em = cached_execution_model(cfg.model, cfg.device, cfg.tp,
                                    cfg.pp, cfg.execmodel)
        params[gi] = em.params_vector()
        d = DEVICES[cfg.device]
        powerp[gi] = np.asarray(
            [d.p_idle, d.p_max_inst, d.mfu_sat, d.gamma,
             d.p_max_inst - d.p_idle], np.float32)
        ndev[gi] = float(cfg.n_devices)
        phi[gi] = d.embodied_kg_per_hour
        for k, i in enumerate(g):
            pues[gi, k] = scenarios[i].pue
            cis[gi, k] = scenarios[i].grid_ci

    # ---- the single program for the whole grid ----
    with PROFILER.span("device.execute"):
        args = [torch.as_tensor(a, device=dev)
                for a in (comp, params, powerp, ndev, phi, pues, cis)]
        e_sum, m_sum, dur, peak, op_g, emb_g = (
            o.cpu().numpy() for o in _grid_program(*args))
    stats.devices = 1

    # ---- record assembly through the shared single-site path ----
    for gi, (g, res) in enumerate(zip(single, results)):
        scs = [scenarios[i] for i in g]
        cfg = res.cfg
        shared_m = shared_result_metrics(res)
        reps = reports_from_sums(
            float(e_sum[gi]), float(m_sum[gi]), float(dur[gi]),
            float(peak[gi]), n_devices=cfg.n_devices,
            pues=[sc.pue for sc in scs])
        emb = float(emb_g[gi])
        ops = [float(o) for o in op_g[gi, :len(g)]]
        carbons = reports_from_arrays(
            ops, [emb] * len(g), [o + emb for o in ops],
            [sc.grid_ci for sc in scs])
        for i, sc, rep, carbon in zip(g, scs, reps, carbons):
            rec_t0 = time.perf_counter() - sim_elapsed[gi]
            metrics = single_site_metrics(res, sc, rep, carbon=carbon,
                                          shared=shared_m,
                                          torch_device=dev)
            records[i] = single_site_record(
                sc, metrics, rec_t0, mode="device",
                trace_scenarios=len(scs))
    return [r for r in records if r is not None], stats


def records_max_rel_err(recs_a: Sequence[dict], recs_b: Sequence[dict]
                        ) -> float:
    """Worst relative metric divergence between two aligned record
    sets (aligned by cache key) — what the equivalence tests bound by
    ``DEVICE_MODE_RTOL``."""
    by_key = {r["key"]: r for r in recs_b}
    worst = 0.0
    for a in recs_a:
        b = by_key[a["key"]]
        for col, va in a["metrics"].items():
            vb = b["metrics"][col]
            if va == vb:
                continue
            rel = abs(va - vb) / max(abs(va), abs(vb))
            worst = max(worst, rel)
    return worst
