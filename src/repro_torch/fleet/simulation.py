"""Multi-site fleet simulation.

Generalizes the single-site event loop of ``repro_torch.sim.simulator`` to a
heterogeneous fleet: every site runs its own continuous-batching
simulation (reusing ``ReplicaScheduler`` + ``ExecutionModel``), while a
``FleetRouter`` assigns each request to a site *at arrival time*
against the site's live carbon-intensity signal. Afterwards each
site's stage log becomes a load profile via the Eq. 5 aggregation
(``signals.aggregate_power``), runs through that site's microgrid
co-simulation (solar + battery, zero-capacity = pure grid), and the
results roll up into a fleet-level energy/carbon/latency report.

Energy semantics: per-site ``energy`` is the paper's Eq. 2-3 active
(stage-time) energy; the co-sim metrics additionally charge idle power
for bins where a site sits idle while the fleet is still serving.

Counterpart of ``repro.fleet.simulation``. The event loop is host code;
the roll-up's Eq. 1 and microgrid loops run on ``run_fleet_simulation``'s
``torch_device`` (``None``: the card).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.carbon import stage_attributed_carbon
from repro_torch.core.cosim import run_cosim, trace_to_load_signal
from repro_torch.core.datasets import ci_trace_signal, solar_signal
from repro_torch.core.energy import EnergyReport, operational_energy_trace
from repro_torch.core.microgrid import BatteryConfig, MicrogridConfig
from repro_torch.core.power import DEVICES, PowerModel
from repro_torch.core.signals import Signal
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fleet.autoscale import ActiveSetRouter, ReplicaController
from repro_torch.fleet.config import FleetConfig, SiteConfig
from repro_torch.fleet.routing import RoundRobinRouter, make_router
from repro_torch.schedule import (apply_admission, class_stats,
                            fleet_ci_forecast, make_admission,
                            make_forecaster)
from repro_torch.sim.execmodel import ExecutionModel, cached_execution_model
from repro_torch.sim.requests import Request, generate
from repro_torch.sim.simulator import kv_budget_tokens, latency_stats
from repro_torch.sim.trace import StageTrace, StageTraceBuilder


def _signal_horizon_h(requests: List[Request],
                      defer_slack_s: float = 0.0) -> float:
    """CI signals must cover every routing decision — those happen at
    request *release* times, which admission may push up to a deadline
    past the last arrival (``defer_slack_s`` bounds that from the
    workload config, since releases are assigned after the sites'
    signals exist). The post-sim co-sim regenerates longer traces if
    the service tail outruns this (the generators are prefix-stable in
    their seed)."""
    last_h = (max((r.arrival_s for r in requests), default=0.0)
              + defer_slack_s) / 3600.0
    return max(last_h * 1.1 + 0.5, 1.0)


class LoopSite:
    """One site's live state under the shared event loop ``drive``:
    a replica router, an execution model, per-replica clocks, and the
    stage log. ``run_simulation`` drives exactly one of these — the
    single-site simulator is the trivial fleet."""

    def __init__(self, replica_router, exec_model: ExecutionModel,
                 pp: int):
        self.replicas = replica_router
        self.exec_model = exec_model
        self.pp = pp
        self.clocks = [0.0] * len(replica_router.replicas)
        self.routed: List[Request] = []
        # incremental queue-pressure counter (total tokens of routed,
        # not-yet-finished requests) so per-request routing decisions
        # stay O(sites), not O(outstanding requests)
        self._outstanding_tokens = 0
        self.trace = StageTraceBuilder()
        # opt-in observability (repro_torch.obs): the fleet simulation points
        # these at its probe so the autoscale controller can report
        # transitions; None (default) keeps every hook dead
        self.probe = None
        self.site_index = 0

    def add(self, req: Request):
        """Route one request into the site. Replicas that were idle
        fast-forward to the request's ready time (its admission release,
        == arrival when no policy parked it): they cannot start earlier,
        and their stale clocks must not gate fleet-wide admission."""
        self.routed.append(req)
        self._outstanding_tokens += req.prefill_tokens + req.decode_tokens
        idle = {k for k, r in enumerate(self.replicas.replicas)
                if not r.has_work()}
        target = self.replicas.route(req)
        if target is None:          # router doesn't report its choice:
            bump = idle             # conservatively fast-forward all idle
        else:
            bump = {target} & idle
        for k in bump:
            self.clocks[k] = max(self.clocks[k], req.ready_s)

    def note_done(self, done: List[Request]):
        for r in done:
            self._outstanding_tokens -= r.prefill_tokens + r.decode_tokens

    def maybe_control(self, t_s: float) -> bool:
        """Autoscaling hook, polled by ``drive`` at processing events.
        Sites with a ``ReplicaController`` resize their active replica
        set here; the default site has none. Returns whether the
        active set changed (the loop then re-selects its event)."""
        return False

    def stage_log(self) -> StageTrace:
        return self.trace.build()


def drive(sites: List[LoopSite], route, requests: List[Request],
          max_sim_s: float = 10_000_000.0, probe=None) -> None:
    """THE continuous-batching event loop, shared by the single-site
    simulator and the fleet simulation.

    ``route(req)`` assigns one arriving request to a site (calling
    ``LoopSite.add`` on its choice). Admission gating: a request is
    routed once its *ready* time — arrival, or the release an admission
    policy assigned (``repro_torch.schedule``) — precedes the next
    *processing* event, the earliest clock among replicas with work
    (idle replicas don't hold admission back; ``LoopSite.add``
    fast-forwards them, so no request is ever served before it is
    ready).

    ``probe`` (``repro_torch.obs.Probe``) observes committed stages; it is
    read-only and costs nothing when None — probe-off runs are bitwise
    identical to probe-attached ones (the neutrality contract).
    """
    pending = sorted(requests, key=lambda r: r.ready_s)
    pi = 0
    pairs = [(s, i) for s, st in enumerate(sites)
             for i in range(len(st.clocks))]
    stuck = set()       # replicas whose head-of-queue can never admit

    while True:
        candidates = [(s, i) for s, i in pairs if (s, i) not in stuck
                      and sites[s].replicas.replicas[i].has_work()]
        if candidates:
            s, i = min(candidates, key=lambda p: sites[p[0]].clocks[p[1]])
            t_event = sites[s].clocks[i]
        elif pi < len(pending):
            s, t_event = None, pending[pi].ready_s
        else:
            break

        if pi < len(pending) and pending[pi].ready_s <= t_event:
            while pi < len(pending) and pending[pi].ready_s <= t_event:
                route(pending[pi])
                pi += 1
            continue    # re-select: routed work may be an earlier event
        if s is None:
            continue

        st = sites[s]
        if st.maybe_control(t_event):
            continue    # active set changed: re-select the event
        rep = st.replicas.replicas[i]
        now = st.clocks[i]
        prefills, decodes = rep.next_batch()
        if not prefills and not decodes:
            # running empty and waiting blocked on this replica
            if pi < len(pending):
                st.clocks[i] = max(now, pending[pi].ready_s)
            else:
                # nothing will ever free this replica's KV budget;
                # park it instead of stalling the rest of the fleet
                stuck.add((s, i))
            continue

        # chunked prefill (Sarathi) yields mixed iterations: the chunk
        # token counts + offsets come from the scheduler (a chunk at
        # offset o re-reads o tokens of prior-chunk KV), and decodes of
        # already-prefilled sequences ride along in the same stage
        plens = list(rep.last_prefill_tokens)
        offs = list(rep.last_prefill_offsets)
        ctxs = [r.prefill_tokens + r.decoded for r in decodes]
        cost, npt, ndec, f_score, kv_rw = st.exec_model.stage_cost_scalar(
            plens, ctxs, offs)

        # one record per pipeline stage (replica-stage granularity)
        bs = len(prefills) + len(decodes)
        for ps in range(st.pp):
            st.trace.append(
                start_s=now + ps * cost.t_total / max(st.pp, 1),
                dur_s=cost.t_total, flops_mlp=cost.flops_mlp,
                flops_attn=cost.flops_attn, mfu=cost.mfu,
                n_prefill_tokens=npt,
                n_decode_tokens=ndec,
                replica=i * st.pp + ps, batch_size=bs,
                score_flops=f_score,
                kv_rw_bytes=kv_rw)

        if probe is not None:
            probe.on_stage(now, cost.t_total, s, i, rep, npt, ndec, bs)
        now += cost.t_total
        st.clocks[i] = now
        done = rep.complete_iteration(prefills, decodes, now)
        st.note_done(done)
        if probe is not None and done:
            probe.on_complete(now, s, i, done)
        if now > max_sim_s:
            break


class _SiteRuntime(LoopSite):
    """``LoopSite`` plus the fleet-only state: site config, grid CI
    signal, and the routing protocol the ``FleetRouter`` policies
    consume."""

    def __init__(self, cfg: FleetConfig, site: SiteConfig, horizon_h: float):
        self.site = site
        self.device = DEVICES[site.device]
        sched = site.scheduler
        if cfg.auto_kv_budget:
            budget = kv_budget_tokens(cfg.model, self.device, site.tp,
                                      site.pp)
            if budget <= 0:
                raise ValueError(
                    f"{cfg.model.name} does not fit {site.device} at "
                    f"TP={site.tp} PP={site.pp} (site {site.name})")
            sched = dataclasses.replace(sched, kv_budget_tokens=budget)
        self.controller = None
        if site.autoscaler.enabled:
            # allocate the ceiling up front (stable replica indices /
            # trace ids); the controller moves the active-set boundary
            router = ActiveSetRouter(site.max_replicas, sched,
                                     n_active=min(site.n_replicas,
                                                  site.max_replicas))
            self.controller = ReplicaController(site.autoscaler,
                                                site.n_replicas)
        else:
            router = RoundRobinRouter(site.n_replicas, sched)
        super().__init__(router,
                         cached_execution_model(cfg.model, site.device,
                                                site.tp, site.pp,
                                                cfg.execmodel),
                         site.pp)
        self.ci = ci_trace_signal(site.ci_trace, horizon_h)

    def maybe_control(self, t_s: float) -> bool:
        if self.controller is None:
            return False
        return self.controller.maybe_control(self, t_s)

    # ---- FleetRouter protocol ----
    def outstanding_tokens(self) -> int:
        """Total tokens of routed, not-yet-finished requests (O(1);
        maintained incrementally by add/note_done)."""
        return self._outstanding_tokens

    def outstanding_requests(self) -> int:
        return sum(len(rep.waiting) + len(rep.running)
                   for rep in self.replicas.replicas)

    def ci_at(self, t_s: float) -> float:
        return float(self.ci.at(t_s))


def _site_load_signal(stages: StageTrace, pm: PowerModel, n_devices: int,
                      pue: float, resolution_s: float, t_end_s: float,
                      device_signal=None) -> Signal:
    """The table2 Eq. 5 pipeline (``trace_to_load_signal``) padded
    onto the common fleet grid [0, t_end): bins outside this site's
    active span draw idle power while the fleet is still serving.

    ``device_signal`` — an optional ``(times, counts)`` step signal of
    *powered* devices from a replica autoscaler — replaces the fixed
    ``n_devices`` scale: each bin draws its per-device power times the
    devices actually powered then (cold replicas draw nothing, warm
    spares draw idle)."""
    n_bins = max(1, int(math.ceil(t_end_s / resolution_s)))
    times = np.arange(n_bins) * resolution_s
    if device_signal is not None:
        ts, counts = device_signal
        idx = np.clip(np.searchsorted(ts, times, side="right") - 1,
                      0, len(counts) - 1)
        devices = counts[idx].astype(np.float64)
    else:
        devices = np.full(n_bins, float(n_devices))
    vals = pm.dev.p_idle * devices * pue
    if len(stages.start_s):
        # per-device bin power, scaled by the live device count
        sig = trace_to_load_signal(stages, pm, n_devices=1, pue=1.0,
                                   resolution_s=resolution_s)
        off = int(round(sig.times[0] / resolution_s))
        n = min(len(sig.values), n_bins - off)
        if n > 0:
            vals[off:off + n] = (sig.values[:n] * devices[off:off + n]
                                 * pue)
    return Signal(times, vals, interp="previous")


@dataclasses.dataclass
class SiteResult:
    site: SiteConfig
    stages: StageTrace
    requests: List[Request]            # requests routed to this site
    energy: EnergyReport               # Eq. 2-3 active energy
    load: Signal                       # Eq. 5 profile (idle-filled)
    cosim: Dict[str, float]            # microgrid co-sim metrics
    avg_ci: float
    # request-attributable operational emissions: per-stage Eq. 2-3
    # energy x the live grid CI at each stage (no idle fill) — the
    # carbon that temporal/spatial scheduling actually moves, immune to
    # the Eq. 5 bin-quantization of the co-sim totals
    carbon_active_g: float = 0.0
    # replica-autoscaler counters (repro_torch.fleet.autoscale); empty when
    # the site runs a fixed replica set
    autoscale: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def carbon_operational_g(self) -> float:
        """Net grid emissions after solar/battery (gCO2)."""
        return self.cosim["net_emissions_kg"] * 1000.0

    @property
    def carbon_embodied_g(self) -> float:
        dev = DEVICES[self.site.device]
        return self.energy.gpu_hours * dev.embodied_kg_per_hour * 1000.0


@dataclasses.dataclass
class FleetResult:
    cfg: FleetConfig
    sites: List[SiteResult]
    requests: List[Request]
    assignments: np.ndarray            # request rid -> site index
    router_stats: Dict[str, float]
    admission_stats: Dict[str, float]  # repro_torch.schedule.apply_admission
    duration_s: float

    def summary(self) -> Dict[str, float]:
        """Fleet-total + per-site energy/carbon columns (tidy row)."""
        dur = sum(s.energy.duration_s for s in self.sites)
        energy_wh = sum(s.energy.energy_wh for s in self.sites)
        op_g = sum(s.carbon_operational_g for s in self.sites)
        nosolar_g = sum(s.cosim["total_emissions_nosolar_kg"] * 1000.0
                        for s in self.sites)
        emb_g = sum(s.carbon_embodied_g for s in self.sites)
        done = sum(1 for r in self.requests if r.t_done >= 0)
        out: Dict[str, float] = {
            "energy_wh": energy_wh,
            "energy_kwh": energy_wh / 1000.0,
            "avg_power_w": (sum(s.energy.avg_power_w * s.energy.duration_s
                                for s in self.sites) / max(dur, 1e-12)),
            "gpu_hours": sum(s.energy.gpu_hours for s in self.sites),
            "avg_mfu": (sum(s.energy.avg_mfu * s.energy.duration_s
                            for s in self.sites) / max(dur, 1e-12)),
            "duration_s": self.duration_s,
            "throughput_qps": done / max(self.duration_s, 1e-9),
            "carbon_operational_g": op_g,
            "carbon_active_g": sum(s.carbon_active_g for s in self.sites),
            "carbon_embodied_g": emb_g,
            "carbon_total_g": op_g + emb_g,
            "carbon_nosolar_g": nosolar_g,
            "carbon_offset_pct": 100.0 * (nosolar_g - op_g)
            / max(nosolar_g, 1e-9),
            "n_sites": float(len(self.sites)),
            "n_requests_done": float(done),
            "router_switches": self.router_stats.get("switches", 0.0),
            **latency_stats(self.requests),
            # per-workload-class latency/deferral columns (repro_torch.schedule)
            **class_stats(self.requests),
            **self.admission_stats,
        }
        if any(s.autoscale for s in self.sites):
            # autoscaler columns appear only when a site scales, so
            # fixed-replica fleets keep their pre-autoscaler records
            # bit-for-bit (schema-bump pin)
            out["scale_ups"] = sum(s.autoscale.get("scale_ups", 0.0)
                                   for s in self.sites)
            out["scale_downs"] = sum(s.autoscale.get("scale_downs", 0.0)
                                     for s in self.sites)
        for s in self.sites:
            p = s.site.name
            out[f"{p}_n_requests"] = float(len(s.requests))
            out[f"{p}_energy_wh"] = s.energy.energy_wh
            out[f"{p}_carbon_g"] = s.carbon_operational_g
            out[f"{p}_carbon_active_g"] = s.carbon_active_g
            out[f"{p}_avg_ci"] = s.avg_ci
            out[f"{p}_renewable_share_pct"] = s.cosim["renewable_share_pct"]
        # plain floats only: numpy scalars would stringify through the
        # result cache's JSON encoding and break cached == fresh
        return {k: float(v) for k, v in out.items()}


def run_fleet_simulation(cfg: FleetConfig,
                         max_sim_s: float = 10_000_000.0,
                         probe=None,
                         torch_device: DeviceLike = None) -> FleetResult:
    """``probe`` (``repro_torch.obs.Probe``, optional) observes routing,
    stages, autoscaling and the per-site rollup; it never feeds back
    into the simulation (probe-off == probe-on, bitwise). Eq. 1 and the
    microgrid loops run on ``torch_device`` (``None``: the card, raising
    before the simulation starts when there is none)."""
    torch_device = resolve_device(torch_device)
    requests = generate(cfg.workload)
    wl = cfg.workload
    defer_slack = (wl.deferrable_deadline_s
                   if wl.deferrable_frac > 0.0 else 0.0)
    horizon_h = _signal_horizon_h(requests, defer_slack)
    sites = [_SiteRuntime(cfg, s, horizon_h) for s in cfg.sites]

    # ---- temporal admission gate (repro_torch.schedule), ahead of routing ----
    sched = cfg.schedule
    admission_stats: Dict[str, float] = {"n_deferred": 0.0,
                                         "backlog_peak": 0.0}
    if sched.policy != "immediate":
        forecaster = make_forecaster(sched.forecaster,
                                     **sched.forecaster_params)
        policy = make_admission(sched.policy, **sched.policy_params)
        forecast = fleet_ci_forecast(forecaster, [st.ci for st in sites],
                                     stat=sched.ci_stat)
        admission_stats = apply_admission(requests, policy, forecast)

    router = make_router(cfg.router, len(sites), **cfg.router_params)
    assignments = np.full(len(requests), -1, np.int32)

    if probe is not None:
        for idx, st in enumerate(sites):
            st.probe = probe
            st.site_index = idx

    def route(req: Request):
        # the geo decision sees each site's CI at the moment the
        # request becomes routable (its admission release; == arrival
        # under immediate admission)
        target = router.choose(req, req.ready_s, sites)
        assignments[req.rid] = target
        if probe is not None:
            probe.on_route(req.ready_s, req.rid, target)
        sites[target].add(req)

    drive(sites, route, requests, max_sim_s, probe=probe)

    # ---- roll up: Eq. 2-3 energy, Eq. 5 profiles, microgrid co-sim ----
    stage_logs = [st.stage_log() for st in sites]
    t_end = max([log.total_duration() for log in stage_logs]
                + [1.0, cfg.horizon_s or 0.0])
    if t_end / 3600.0 > horizon_h:
        # the service tail outran the arrival-sized CI traces: extend
        # them (prefix-stable generators, so the routed prefix is the
        # same trace the co-sim now integrates against)
        for st in sites:
            st.ci = ci_trace_signal(st.site.ci_trace,
                                    t_end / 3600.0 + 0.5)
    results = []
    for si, (st, log) in enumerate(zip(sites, stage_logs)):
        pm = PowerModel(st.site.device, torch_device=torch_device)
        energy = operational_energy_trace(log, pm,
                                          n_devices=st.site.n_devices,
                                          pue=cfg.pue)
        dev_sig = (st.controller.device_signal(
            t_end, st.site.tp * st.site.pp)
            if st.controller is not None else None)
        load = _site_load_signal(log, pm, st.site.n_devices, cfg.pue,
                                 cfg.resolution_s, t_end,
                                 device_signal=dev_sig)
        solar = solar_signal(max(t_end / 3600.0, 0.02),
                             capacity_w=st.site.solar_capacity_w,
                             seed=st.site.solar_seed,
                             cloudiness=st.site.cloudiness,
                             step_s=cfg.resolution_s)
        grid_cfg = MicrogridConfig(
            battery=BatteryConfig(
                capacity_wh=st.site.battery_capacity_wh,
                soc_init=st.site.soc_init, soc_min=st.site.soc_min,
                soc_max=st.site.soc_max),
            step_s=cfg.resolution_s)
        cos = run_cosim(load, solar, st.ci, grid_cfg,
                        torch_device=torch_device)
        # stage-attributed carbon: same per-record energy convention as
        # operational_energy, weighted by the CI each stage ran under
        active_g = stage_attributed_carbon(log, pm, st.site.n_devices,
                                           cfg.pue, st.ci)
        results.append(SiteResult(
            site=st.site, stages=log, requests=st.routed, energy=energy,
            load=load, cosim=dict(cos.metrics),
            avg_ci=float(np.mean(st.ci.at(load.times))),
            carbon_active_g=active_g,
            autoscale=(st.controller.stats()
                       if st.controller is not None else {})))
        if probe is not None:
            probe.on_site_rollup(
                site=si, name=st.site.name, trace=log,
                device=st.site.device, row_devices=st.site.n_devices,
                pue=cfg.pue, ci=st.ci, total_devices=st.site.n_devices,
                device_signal=dev_sig, t_end_s=t_end,
                energy_wh=energy.energy_wh, carbon_active_g=active_g,
                cosim=dict(cos.metrics), load=load)

    if probe is not None:
        probe.on_requests(
            np.asarray([r.arrival_s for r in requests], np.float64),
            np.asarray([r.ready_s for r in requests], np.float64))

    return FleetResult(cfg=cfg, sites=results, requests=requests,
                       assignments=assignments,
                       router_stats=router.stats(),
                       admission_stats=admission_stats, duration_s=t_end)
