"""Day-scale fleet simulation: epoch-segmented fluid/request hybrid.

``run_fleet_day`` evaluates a whole day (millions of requests) by
partitioning it into fixed epochs (``repro_torch.sim.hybrid``) and driving
each epoch either through the exact continuous-batching event loop or
through the fluid pilot-and-tile approximation — per site, with an
epoch-granular replica-autoscaling plan (``repro_torch.fleet.autoscale``)
and epoch-granular carbon-aware deferral (``repro_torch.schedule.epochs``).

Determinism contract: workload generation, deferral, site assignment,
the replica plan and the epoch classification are all array passes
over the ``ArrivalStream`` that never look at simulation output, so
the ``hybrid`` and ``event_loop`` day modes plan identical epochs —
an epoch the planner marks exact is then evaluated by the identical
code path on identical inputs in both modes and agrees bit-for-bit.

Energy convention (day accounting): stage rows are (replica,
pipeline-stage) grains, so active energy charges each row for its
``tp`` devices; idle energy is the powered-device integral (active +
warm replicas from the autoscale plan) minus busy device-seconds, at
``p_idle`` — warm spares and scale-up latency thus surface directly
in Eq. 2-5 terms. The co-sim load profile bins active stage energy
plus that idle fill at the fleet resolution and runs the usual
solar/battery microgrid scan per site.

Counterpart of ``repro.fleet.day``. Planning, the event loop and the
fluid tiling are host code; each site's Eq. 1 and its microgrid scan run
on ``run_fleet_day``'s ``torch_device`` (``None``: the card).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.cosim import run_cosim
from repro_torch.core.datasets import ci_trace_signal, solar_signal
from repro_torch.core.microgrid import BatteryConfig, MicrogridConfig
from repro_torch.core.power import DEVICES, PowerModel
from repro_torch.core.signals import Signal
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fleet.autoscale import plan_replicas
from repro_torch.fleet.config import FleetConfig, SiteConfig
from repro_torch.fleet.routing import RoundRobinRouter
from repro_torch.fleet.simulation import LoopSite, drive
from repro_torch.obs.spans import PROFILER
from repro_torch.schedule import fleet_ci_forecast, make_forecaster
from repro_torch.schedule.epochs import epoch_deferral
from repro_torch.sim.hybrid import (EXACT, DayConfig, Epoch, EpochEval,
                              concat_traces, epoch_bounds, evaluate_epoch,
                              plan_epochs, weighted_percentile)
from repro_torch.sim.simulator import kv_budget_tokens
from repro_torch.sim.trace import StageTrace
from repro_torch.workloads.stream import ArrivalStream, generate_stream


@dataclasses.dataclass
class DaySiteResult:
    site: SiteConfig
    stream: ArrivalStream              # this site's slice, ready-sorted
    epochs: List[Epoch]
    evals: List[EpochEval]
    trace: StageTrace                  # concatenated (synthetic + exact)
    energy: Dict[str, float]           # active/idle split, device-hours
    cosim: Dict[str, float]
    avg_ci: float
    carbon_active_g: float
    carbon_idle_g: float
    autoscale: Dict[str, float]

    @property
    def carbon_operational_g(self) -> float:
        return self.cosim["net_emissions_kg"] * 1000.0


@dataclasses.dataclass
class DayResult:
    cfg: FleetConfig
    bounds: np.ndarray
    sites: List[DaySiteResult]
    admission_stats: Dict[str, float]
    duration_s: float

    def summary(self) -> Dict[str, float]:
        day = self.cfg.day
        n_req = sum(len(s.stream) for s in self.sites)
        n_sim = sum(ev.n_simulated for s in self.sites for ev in s.evals)
        evals = [ev for s in self.sites for ev in s.evals]
        n_exact = sum(1 for ev in evals if ev.epoch.planned == EXACT)
        reasons: Dict[str, int] = {}
        for ev in evals:
            if ev.epoch.planned == EXACT:
                r = ev.epoch.reason
                reasons[r] = reasons.get(r, 0) + 1
        act_wh = sum(s.energy["active_wh"] for s in self.sites)
        idle_wh = sum(s.energy["idle_wh"] for s in self.sites)
        op_g = sum(s.carbon_operational_g for s in self.sites)
        nosolar_g = sum(s.cosim["total_emissions_nosolar_kg"] * 1000.0
                        for s in self.sites)
        gpu_h = sum(s.energy["powered_dev_s"] for s in self.sites) / 3600.0
        emb_g = sum(s.energy["powered_dev_s"] / 3600.0
                    * DEVICES[s.site.device].embodied_kg_per_hour * 1000.0
                    for s in self.sites)
        ttft = np.concatenate([ev.ttft_s for ev in evals]) \
            if evals else np.empty(0)
        e2e = np.concatenate([ev.e2e_s for ev in evals]) \
            if evals else np.empty(0)
        w_t = np.concatenate([np.full(len(ev.ttft_s), ev.weight)
                              for ev in evals]) if evals else np.empty(0)
        w_e = np.concatenate([np.full(len(ev.e2e_s), ev.weight)
                              for ev in evals]) if evals else np.empty(0)
        deferrable = sum(int(s.stream.deferrable.sum())
                         for s in self.sites)
        out: Dict[str, float] = {
            "n_requests": float(n_req),
            "n_simulated": float(n_sim),
            "sim_fraction": n_sim / max(n_req, 1),
            "n_epochs": float(len(self.bounds) - 1),
            "n_exact_epochs": float(n_exact),
            "n_fluid_epochs": float(len(evals) - n_exact),
            "duration_s": self.duration_s,
            "throughput_qps": n_req / max(self.duration_s, 1e-9),
            "energy_wh": act_wh + idle_wh,
            "energy_active_wh": act_wh,
            "energy_idle_wh": idle_wh,
            "gpu_hours": gpu_h,
            "carbon_active_g": sum(s.carbon_active_g for s in self.sites),
            "carbon_idle_g": sum(s.carbon_idle_g for s in self.sites),
            "carbon_operational_g": op_g,
            "carbon_nosolar_g": nosolar_g,
            "carbon_offset_pct": 100.0 * (nosolar_g - op_g)
            / max(nosolar_g, 1e-9),
            "carbon_embodied_g": emb_g,
            "carbon_total_g": op_g + emb_g,
            "ttft_p50_s": weighted_percentile(ttft, w_t, 50),
            "ttft_p99_s": weighted_percentile(ttft, w_t, 99),
            "e2e_p50_s": weighted_percentile(e2e, w_e, 50),
            "e2e_p99_s": weighted_percentile(e2e, w_e, 99),
            "deferrable_frac_actual": deferrable / max(n_req, 1),
            "scale_ups": sum(s.autoscale.get("scale_ups", 0.0)
                             for s in self.sites),
            "scale_downs": sum(s.autoscale.get("scale_downs", 0.0)
                               for s in self.sites),
            "replica_peak": float(max(
                (ep.n_replicas for s in self.sites for ep in s.epochs),
                default=0)),
            "epoch_s": day.epoch_s,
            **{f"n_exact_{k}": float(v) for k, v in sorted(reasons.items())},
            **self.admission_stats,
        }
        # per-epoch fleet columns: what the day-smoke CI job compares
        # between the hybrid and event_loop modes (planned-exact epochs
        # bit-for-bit, planned-fluid epochs within tolerance)
        n_ep = len(self.bounds) - 1
        for e in range(n_ep):
            evs = [s.evals[e] for s in self.sites if e < len(s.evals)]
            tag = f"e{e:03d}"
            # fraction of sites that planned this epoch exact: 1.0 =>
            # the whole fleet epoch is bit-for-bit comparable across
            # day modes, anything else compares at fluid tolerance
            out[f"{tag}_exact"] = (sum(
                1.0 for ev in evs if ev.epoch.planned == EXACT)
                / max(len(evs), 1))
            out[f"{tag}_n"] = float(sum(ev.n_requests for ev in evs))
            out[f"{tag}_energy_wh"] = sum(
                s.energy["epoch_active_wh"][e]
                + s.energy["epoch_idle_wh"][e] for s in self.sites)
            out[f"{tag}_carbon_g"] = sum(
                s.energy["epoch_carbon_g"][e] for s in self.sites)
            tt = np.concatenate([ev.ttft_s for ev in evs]) \
                if evs else np.empty(0)
            ww = np.concatenate([np.full(len(ev.ttft_s), ev.weight)
                                 for ev in evs]) if evs else np.empty(0)
            out[f"{tag}_ttft_p99_s"] = weighted_percentile(tt, ww, 99)
        for s in self.sites:
            p = s.site.name
            out[f"{p}_n_requests"] = float(len(s.stream))
            out[f"{p}_energy_wh"] = (s.energy["active_wh"]
                                     + s.energy["idle_wh"])
            out[f"{p}_carbon_g"] = s.carbon_operational_g
            out[f"{p}_carbon_active_g"] = s.carbon_active_g
            out[f"{p}_avg_ci"] = s.avg_ci
            out[f"{p}_renewable_share_pct"] = \
                s.cosim["renewable_share_pct"]
        return {k: float(v) for k, v in out.items()}


def _assign_sites(cfg: FleetConfig, stream: ArrivalStream,
                  bounds: np.ndarray, cis: List[Signal],
                  caps_tok_per_s: List[float]) -> np.ndarray:
    """Array-pass site assignment (the day analogue of FleetRouter).

    ``round_robin``/``least_loaded`` interleave rows across sites;
    ``carbon_greedy``/``carbon_slo`` assign per epoch: each epoch's
    rows fill the lowest-CI site up to its capacity share, spilling to
    the next-cheapest (the SLO/capacity bound is the per-epoch token
    budget), so load follows clean grids without saturating them.
    """
    n = len(stream)
    n_sites = len(cfg.sites)
    if cfg.router in ("round_robin", "least_loaded") or n_sites == 1:
        return np.arange(n, dtype=np.int64) % n_sites
    assign = np.empty(n, np.int64)
    order = np.argsort(stream.ready_s, kind="stable")
    ready = stream.ready_s[order]
    tokens = stream.tokens[order].astype(np.float64)
    edges = np.searchsorted(ready, bounds, side="left")
    centers = 0.5 * (bounds[:-1] + bounds[1:])
    for e in range(len(bounds) - 1):
        lo, hi = int(edges[e]), int(edges[e + 1])
        if hi <= lo:
            continue
        dt = bounds[e + 1] - bounds[e]
        rank = sorted(range(n_sites),
                      key=lambda i: (float(cis[i].at(centers[e])), i))
        cum = np.cumsum(tokens[lo:hi])
        sl = np.empty(hi - lo, np.int64)
        sl[:] = rank[-1]               # overflow lands on the last site
        used = 0.0
        start = 0
        for i in rank[:-1]:
            budget = caps_tok_per_s[i] * dt
            cut = int(np.searchsorted(cum, used + budget, side="right"))
            sl[start:cut] = i
            if cut >= hi - lo:
                start = cut
                break
            used = float(cum[cut - 1]) if cut > 0 else used
            start = cut
        if start < hi - lo:
            sl[start:] = rank[-1]
        assign[order[lo:hi]] = sl
    return assign


def _run_site_day(cfg: FleetConfig, site: SiteConfig,
                  sub: ArrivalStream, bounds: np.ndarray,
                  drain_counts: np.ndarray, ci: Signal,
                  probe=None, torch_device: DeviceLike = None
                  ) -> DaySiteResult:
    """``probe`` is already site-tagged (``SiteIndexProbe``) — every
    hook here reports local site 0 and the wrapper re-tags."""
    from repro_torch.sim.execmodel import cached_execution_model

    day = cfg.day
    device = DEVICES[site.device]
    sched = site.scheduler
    if cfg.auto_kv_budget:
        budget = kv_budget_tokens(cfg.model, device, site.tp, site.pp)
        if budget <= 0:
            raise ValueError(
                f"{cfg.model.name} does not fit {site.device} at "
                f"TP={site.tp} PP={site.pp} (site {site.name})")
        sched = dataclasses.replace(sched, kv_budget_tokens=budget)
    em = cached_execution_model(cfg.model, site.device, site.tp,
                                site.pp, cfg.execmodel)
    asc = site.autoscaler
    cap = asc.tokens_per_s

    # predicted per-epoch demand -> replica plan (deterministic, no
    # simulation output involved: both day modes plan identically)
    n_ep = len(bounds) - 1
    counts = sub.counts(bounds).astype(np.float64)
    tok_sums = np.zeros(n_ep)
    if len(sub):
        np.add.at(tok_sums, np.clip(
            np.searchsorted(bounds, sub.ready_s, side="right") - 1,
            0, n_ep - 1), sub.tokens.astype(np.float64))
    util1 = tok_sums / np.maximum(np.diff(bounds), 1e-9) / max(cap, 1e-9)
    ci_mean = np.asarray(ci.at(0.5 * (bounds[:-1] + bounds[1:])),
                         np.float64)
    with PROFILER.span("day.plan"):
        if asc.enabled:
            replica_plan, warm_plan, asc_stats = plan_replicas(
                asc, util1, ci_mean, site.n_replicas)
        else:
            replica_plan = np.full(n_ep, site.n_replicas, int)
            warm_plan = np.zeros(n_ep, int)
            asc_stats = {}

    # The saturation check gets a model-derived capacity floor: the
    # autoscaler's tokens_per_s is a configured estimate, and when it
    # overstates what the roofline can actually serve, a queue-
    # saturated epoch would be misplanned as fluid (the pilot tiles a
    # growing queue and loses the latency tail). The autoscaler's own
    # replica planning above stays on the configured estimate.
    if len(sub):
        cap_model = em.replica_tokens_per_s(
            sched.batch_cap, sched.kv_budget_tokens,
            float(np.mean(sub.prefill_tokens)),
            float(np.mean(sub.decode_tokens)))
    else:
        cap_model = cap
    with PROFILER.span("day.plan"):
        epochs = plan_epochs(sub, bounds, day, cap, replica_plan,
                             warm_plan=warm_plan,
                             scale_latency_s=asc.scale_up_latency_s,
                             drain_counts=drain_counts,
                             sat_tokens_per_s=min(cap, cap_model))

    def run_window(epoch: Epoch, lo: int, hi: int):
        reqs = sub.to_requests(lo, hi)
        router = RoundRobinRouter(epoch.n_replicas, sched)
        ls = LoopSite(router, em, site.pp)
        for k in range(epoch.n_replicas):
            ls.clocks[k] = epoch.t0
        if epoch.cold_from is not None:
            for k in range(epoch.cold_from, epoch.n_replicas):
                ls.clocks[k] = epoch.t0 + epoch.scale_latency_s
        drive([ls], ls.add, reqs, probe=probe)
        return ls.stage_log(), reqs

    force_exact = day.mode == "event_loop"
    with PROFILER.span("day.epoch_eval"):
        evals = [evaluate_epoch(ep, sub, day, run_window,
                                force_exact=force_exact, probe=probe)
                 for ep in epochs]
    trace = concat_traces([ev.trace for ev in evals])

    # ---- per-replica energy accounting (see module docstring) ----
    pm = PowerModel(site.device, torch_device=torch_device)
    pue = cfg.pue
    tp = site.tp
    dpr = site.tp * site.pp            # devices per replica
    row_p = pm.power(trace.mfu).cpu().numpy().astype(np.float64)
    row_wh = row_p * trace.dur_s * tp * pue / 3600.0
    t_end = max(float(bounds[-1]), trace.total_duration())
    dts = np.diff(bounds).copy()
    if n_ep:
        dts[-1] += t_end - float(bounds[-1])
    powered = (replica_plan + warm_plan) * dpr
    # charge each row to the epoch that *produced* it, not its start
    # bin: an exact epoch's service can spill past the boundary, and
    # attributing the spill to the next epoch would break the
    # bit-for-bit hybrid==event_loop agreement on planned-exact epochs
    # (fluid tiling clips at the boundary, exact runs don't)
    ep_idx = np.concatenate(
        [np.full(len(ev.trace), ev.epoch.index, np.int64)
         for ev in evals]) if evals else np.empty(0, np.int64)
    ep_active_wh = np.zeros(n_ep)
    np.add.at(ep_active_wh, ep_idx, row_wh)
    ep_busy_dev_s = np.zeros(n_ep)
    np.add.at(ep_busy_dev_s, ep_idx, trace.dur_s * tp)
    ep_idle_dev_s = np.maximum(powered * dts - ep_busy_dev_s, 0.0)
    ep_idle_wh = pm.dev.p_idle * ep_idle_dev_s * pue / 3600.0
    # per-stage Eq. 4 attribution + CI-integrated idle carbon
    ci_rows = np.asarray(ci.at(trace.start_s), np.float64)
    ep_carbon_act = np.zeros(n_ep)
    np.add.at(ep_carbon_act, ep_idx, row_wh * ci_rows / 1000.0)
    ep_carbon_idle = ep_idle_wh * ci_mean / 1000.0
    energy = {
        "active_wh": float(ep_active_wh.sum()),
        "idle_wh": float(ep_idle_wh.sum()),
        "busy_dev_s": float(ep_busy_dev_s.sum()),
        "powered_dev_s": float((powered * dts).sum()),
        "epoch_active_wh": ep_active_wh,
        "epoch_idle_wh": ep_idle_wh,
        "epoch_carbon_g": ep_carbon_act + ep_carbon_idle,
    }

    # ---- Eq. 5 load profile + microgrid co-sim ----
    res_s = cfg.resolution_s
    n_bins = max(1, int(np.ceil(t_end / res_s)))
    times = np.arange(n_bins) * res_s
    bin_idx = np.clip((trace.start_s / res_s).astype(int), 0, n_bins - 1)
    act_ws = np.zeros(n_bins)
    np.add.at(act_ws, bin_idx, row_p * trace.dur_s * tp)
    busy_dev = np.zeros(n_bins)
    np.add.at(busy_dev, bin_idx, trace.dur_s * tp)
    dev_bins = powered[np.clip(np.searchsorted(bounds, times,
                                               side="right") - 1,
                               0, n_ep - 1)].astype(np.float64)
    idle_dev = np.maximum(dev_bins * res_s - busy_dev, 0.0)
    load = Signal(times, (act_ws + pm.dev.p_idle * idle_dev)
                  / res_s * pue, interp="previous")
    solar = solar_signal(max(t_end / 3600.0, 0.02),
                         capacity_w=site.solar_capacity_w,
                         seed=site.solar_seed,
                         cloudiness=site.cloudiness, step_s=res_s)
    grid_cfg = MicrogridConfig(
        battery=BatteryConfig(capacity_wh=site.battery_capacity_wh,
                              soc_init=site.soc_init,
                              soc_min=site.soc_min,
                              soc_max=site.soc_max),
        step_s=res_s)
    with PROFILER.span("day.cosim"):
        cos = run_cosim(load, solar, ci, grid_cfg,
                        torch_device=torch_device)

    if probe is not None:
        # powered devices step at epoch starts (the autoscale plan),
        # not at in-drive scale events — day replica counts are planned
        probe.on_requests(sub.arrival_s, sub.ready_s)
        probe.on_site_rollup(
            site=0, name=site.name, trace=trace, device=site.device,
            row_devices=tp, pue=pue, ci=ci,
            device_signal=(bounds[:-1], powered.astype(np.float64)),
            t_end_s=t_end,
            energy_wh=float(ep_active_wh.sum()),
            idle_energy_wh=float(ep_idle_wh.sum()),
            carbon_active_g=float(ep_carbon_act.sum()),
            carbon_idle_g=float(ep_carbon_idle.sum()),
            cosim=dict(cos.metrics), load=load)

    return DaySiteResult(
        site=site, stream=sub, epochs=epochs, evals=evals, trace=trace,
        energy=energy, cosim=dict(cos.metrics),
        avg_ci=float(np.mean(ci.at(times))),
        carbon_active_g=float(ep_carbon_act.sum()),
        carbon_idle_g=float(ep_carbon_idle.sum()),
        autoscale=asc_stats)


def run_fleet_day(cfg: FleetConfig, probe=None,
                  torch_device: DeviceLike = None) -> DayResult:
    """Simulate a whole day of the fleet under ``cfg.day``.

    ``probe`` (``repro_torch.obs.Probe``) observes each site's epoch
    evaluations, event-stepped stages and the per-site Eq. 1-5 rollup;
    probe-off runs are bitwise identical. Each site's Eq. 1 and microgrid
    scan run on ``torch_device`` (``None``: the card, raising before the
    simulation starts when there is none)."""
    day: Optional[DayConfig] = cfg.day
    if day is None:
        raise ValueError("run_fleet_day needs cfg.day (a DayConfig)")
    torch_device = resolve_device(torch_device)
    with PROFILER.span("day.workload"):
        stream = generate_stream(cfg.workload)
    wl = cfg.workload
    defer_slack = (wl.deferrable_deadline_s
                   if wl.deferrable_frac > 0.0 else 0.0)
    t_last = float(stream.arrival_s[-1]) if len(stream) else day.epoch_s
    bounds = epoch_bounds(t_last + defer_slack, day.epoch_s)
    horizon_h = float(bounds[-1]) / 3600.0 * 1.1 + 0.5
    cis = [ci_trace_signal(s.ci_trace, horizon_h) for s in cfg.sites]

    # ---- epoch-granular carbon-aware deferral (repro_torch.schedule) ----
    sched = cfg.schedule
    adm_stats = {"n_deferred": 0.0, "deferral_mean_s": 0.0,
                 "deferral_max_s": 0.0}
    drain = np.zeros(len(bounds) - 1)
    if sched.policy != "immediate" and wl.deferrable_frac > 0.0:
        with PROFILER.span("day.admission"):
            forecaster = make_forecaster(sched.forecaster,
                                         **sched.forecaster_params)
            forecast = fleet_ci_forecast(forecaster, cis,
                                         stat=sched.ci_stat)
            drain, adm_stats = epoch_deferral(
                stream, bounds, forecast,
                margin=float(sched.policy_params.get("margin", 0.02)),
                service_margin_s=float(
                    sched.policy_params.get("service_margin_s", 120.0)))

    # trim trailing all-empty epochs (deferral slack the gate never
    # used) so idle accounting doesn't charge hours of dead air
    sorted_all = stream.sorted_by_ready()
    counts = sorted_all.counts(bounds)
    last_busy = int(np.max(np.nonzero(counts)[0])) if counts.any() else 0
    bounds = bounds[:last_busy + 2]
    drain = drain[:last_busy + 1]

    caps = [s.autoscaler.tokens_per_s
            * (s.autoscaler.max_replicas if s.autoscaler.enabled
               else s.n_replicas) * s.autoscaler.target_util
            for s in cfg.sites]
    assign = _assign_sites(cfg, stream, bounds, cis, caps)

    sites_out = []
    for i, site in enumerate(cfg.sites):
        sub = stream.take(np.nonzero(assign == i)[0]).sorted_by_ready()
        released = sub.ready_s > sub.arrival_s
        site_drain = np.zeros(len(bounds) - 1)
        if released.any():
            np.add.at(site_drain, np.clip(
                np.searchsorted(bounds, sub.ready_s[released],
                                side="right") - 1,
                0, len(bounds) - 2), 1.0)
        site_probe = None
        if probe is not None:
            from repro_torch.obs.probe import SiteIndexProbe
            site_probe = SiteIndexProbe(probe, i)
        sites_out.append(_run_site_day(cfg, site, sub, bounds,
                                       site_drain, cis[i],
                                       probe=site_probe,
                                       torch_device=torch_device))

    duration = max([s.trace.total_duration() for s in sites_out]
                   + [float(bounds[-1])])
    return DayResult(cfg=cfg, bounds=bounds, sites=sites_out,
                     admission_stats=adm_stats, duration_s=duration)
