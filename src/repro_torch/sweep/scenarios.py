"""The paper's seven experiments as declarative sweep definitions.

Each ``SweepDef`` is a thin grid declaration (base config + axes) plus
a ``derive`` function that checks the paper's headline claims against
the sweep records. ``--smoke`` variants shrink request counts and grid
resolution so every figure's full pipeline runs in seconds — that is
what CI exercises on every push.

Counterpart of ``repro.sweep.scenarios``: the same twelve sweeps, grids
and derived checks, so each scenario has the reference's key;
``python -m repro_torch.sweep.cli`` drives it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.sim import INTEGRATION_DEFAULT, PAPER_DEFAULT
from repro_torch.sweep.grid import GridSpec, Scenario
from repro_torch.sweep.report import flatten


@dataclasses.dataclass
class SweepDef:
    name: str
    title: str
    build: Callable[..., List[Scenario]]   # build(smoke, n_requests=None)
    derive: Callable[[List[dict]], str]    # records -> paper-claim summary
    rows: Optional[Callable[[List[dict]], list]] = None  # default: flatten

    def make_rows(self, records: List[dict]) -> list:
        return (self.rows or flatten)(records)


def _rows_by(records: List[dict], key: str) -> List[dict]:
    return sorted(flatten(records), key=lambda r: r[key])


# ---------------------------------------------------------------- fig1 ----

def _fig1_build(smoke: bool, n_requests: Optional[int] = None):
    qps = [1.0, 6.45, 10.0] if smoke else [0.5, 1.0, 2.0, 3.0, 5.0, 6.45,
                                           7.9, 10.0, 12.6]
    n = n_requests or (48 if smoke else 512)
    return GridSpec(base=PAPER_DEFAULT, tag="fig1",
                    axes={"workload.qps": qps},
                    fixed={"workload.n_requests": n}).expand()


def _fig1_derive(records: List[dict]) -> str:
    rows = _rows_by(records, "qps")
    sat = [r["avg_mfu"] for r in rows if 5.0 <= r["qps"] <= 7.9]
    return (f"mfu@5-7.9qps={min(sat):.3f}-{max(sat):.3f}"
            f";paper=saturates~0.45")


# ---------------------------------------------------------------- fig2 ----

_FIG2_MODELS = [("phi2-2.7b", 1, 1), ("llama3-8b", 1, 1),
                ("codellama-34b", 1, 1), ("llama3-70b", 2, 2),
                ("qwen-72b", 2, 2)]
_FIG2_SMALL = {"phi2-2.7b", "llama3-8b", "codellama-34b"}


def _fig2_build(smoke: bool, n_requests: Optional[int] = None):
    models = _FIG2_MODELS[:2] if smoke else _FIG2_MODELS
    counts = (48, 96) if smoke else (256, 1024, 4096)
    if n_requests:
        # distinct counts, never exceeding the requested cap, so the
        # energy-vs-count fit stays well-posed
        counts = sorted({max(1, n_requests // f) for f in (4, 2, 1)})
    return GridSpec(base=PAPER_DEFAULT, tag="fig2",
                    axes={"model+tp+pp": models,
                          "workload.n_requests": list(counts)}).expand()


def _fig2_extrapolations(records: List[dict]) -> Dict[str, dict]:
    """Linear energy-in-request-count fit, extrapolated to 2^16."""
    by_model: Dict[str, List[dict]] = {}
    for r in flatten(records):
        by_model.setdefault(r["model"], []).append(r)
    extr = {}
    for model, rs in by_model.items():
        rs = sorted(rs, key=lambda r: r["n_requests"])
        counts = [r["n_requests"] for r in rs]
        energies = [r["energy_wh"] for r in rs]
        if len(set(counts)) >= 2:
            slope = float(np.polyfit(counts, energies, 1)[0])
        else:
            slope = energies[-1] / max(counts[-1], 1)
        extr[model] = {"model": model, "n_requests": 65536,
                       "energy_wh": slope * 65536, "extrapolated": True,
                       "avg_power_w": float(np.mean(
                           [r["avg_power_w"] for r in rs]))}
    return extr


def _fig2_rows(records: List[dict]) -> list:
    return flatten(records) + list(_fig2_extrapolations(records).values())


def _fig2_derive(records: List[dict]) -> str:
    rows = flatten(records)
    small = [r for r in rows if r["model"] in _FIG2_SMALL]
    big = [r for r in rows if r["model"] not in _FIG2_SMALL]
    extr = _fig2_extrapolations(records)
    parts = []
    if small:
        parts.append(f"P_small={min(x['avg_power_w'] for x in small):.0f}-"
                     f"{max(x['avg_power_w'] for x in small):.0f}W"
                     f"(paper:135-155)")
    if big:
        parts.append(f"P_big={min(x['avg_power_w'] for x in big):.0f}-"
                     f"{max(x['avg_power_w'] for x in big):.0f}W"
                     f"(paper:125-127)")
    if "codellama-34b" in extr:
        parts.append(f"E64k_34b={extr['codellama-34b']['energy_wh']/1e3:.1f}"
                     f"kWh(paper~16)")
    if "llama3-70b" in extr:
        parts.append(f"E64k_70b={extr['llama3-70b']['energy_wh']/1e3:.1f}"
                     f"kWh(paper>80)")
    return ";".join(parts)


# ---------------------------------------------------------------- fig3 ----

def _fig3_build(smoke: bool, n_requests: Optional[int] = None):
    lengths = [128, 1024] if smoke else [128, 512, 1024, 4096]
    pds = [20.0, 0.1] if smoke else [50.0, 10.0, 2.0, 1.0, 0.5, 0.1, 0.02]
    n = n_requests or (32 if smoke else 256)
    return GridSpec(
        base=PAPER_DEFAULT, tag="fig3",
        axes={"workload.min_len+workload.max_len": [(L, L) for L in lengths],
              "workload.pd_ratio": pds},
        fixed={"workload.n_requests": n}).expand()


def _fig3_derive(records: List[dict]) -> str:
    rows = flatten(records)
    lengths = sorted({r["min_len"] for r in rows})
    e_by_len = {L: sum(r["energy_wh"] for r in rows if r["min_len"] == L)
                for L in lengths}
    mono = all(e_by_len[lengths[i]] < e_by_len[lengths[i + 1]]
               for i in range(len(lengths) - 1))
    longest = [r for r in rows if r["min_len"] == lengths[-1]]
    # pd_ratio axis runs prefill-heavy -> decode-heavy
    decode_heavier = longest[-1]["energy_wh"] > longest[0]["energy_wh"]
    return (f"energy_monotonic_in_length={mono}(paper:yes);"
            f"decode_heavy_costs_more_at_{lengths[-1]}="
            f"{decode_heavier}(paper:yes)")


# ---------------------------------------------------------------- fig4 ----

def _fig4_build(smoke: bool, n_requests: Optional[int] = None):
    caps = [1, 8, 32] if smoke else [1, 2, 4, 8, 16, 32, 64, 128]
    n = n_requests or (48 if smoke else 256)
    return GridSpec(base=PAPER_DEFAULT, tag="fig4",
                    axes={"scheduler.batch_cap": caps},
                    fixed={"workload.qps": 50.0,
                           "workload.n_requests": n}).expand()


def _fig4_derive(records: List[dict]) -> str:
    rows = _rows_by(records, "batch_cap")
    sub = all(r["avg_batch"] <= r["batch_cap"] for r in rows)
    power_up = rows[-1]["avg_power_w"] > rows[0]["avg_power_w"]
    energy_down = rows[-1]["energy_wh"] < rows[0]["energy_wh"]
    mid = min(rows, key=lambda r: abs(r["batch_cap"] - 16))
    gain_lo = rows[0]["energy_wh"] / mid["energy_wh"]
    gain_hi = mid["energy_wh"] / rows[-1]["energy_wh"]
    return (f"batch_sublinear={sub};power_rises={power_up}(paper:yes);"
            f"energy_drops={energy_down}(paper:yes);"
            f"gain{rows[0]['batch_cap']}->{mid['batch_cap']}={gain_lo:.1f}x;"
            f"gain{mid['batch_cap']}->{rows[-1]['batch_cap']}={gain_hi:.2f}x"
            f"(paper:diminishing past 16)")


# ---------------------------------------------------------------- fig5 ----

def _fig5_build(smoke: bool, n_requests: Optional[int] = None):
    qps = [1.0, 5.0, 10.0] if smoke else [0.5, 1.0, 2.0, 3.2, 5.0, 7.9,
                                          10.0, 12.6]
    n = n_requests or (64 if smoke else 2048)
    return GridSpec(base=PAPER_DEFAULT, tag="fig5",
                    axes={"workload.qps": qps,
                          "workload.n_requests": [n]}).expand()


def _fig5_derive(records: List[dict]) -> str:
    rows = _rows_by(records, "qps")
    n = rows[0]["n_requests"]
    p_sat = [r["avg_power_w"] for r in rows if r["qps"] >= 5.0]
    e_hi = [r["energy_wh"] for r in rows if r["qps"] >= 7.9] or \
           [rows[-1]["energy_wh"]]
    scale = n / 16384
    return (f"P_sat={min(p_sat):.0f}-{max(p_sat):.0f}W(paper:~360);"
            f"E_converged={min(e_hi):.1f}Wh"
            f"(paper~{500 * scale:.0f}Wh at this workload scale)")


# ---------------------------------------------------------------- exp5 ----

def _exp5_build(smoke: bool, n_requests: Optional[int] = None):
    grid = [(1, 1), (2, 1), (1, 2)] if smoke else \
        [(1, 1), (1, 2), (1, 4), (2, 1), (2, 2), (2, 4), (4, 1), (4, 2),
         (4, 4)]
    n = n_requests or (32 if smoke else 256)
    return GridSpec(base=PAPER_DEFAULT, tag="exp5",
                    axes={"tp+pp": grid},
                    fixed={"model": "codellama-34b",
                           "workload.qps": 3.0,
                           "workload.n_requests": n}).expand()


def _exp5_derive(records: List[dict]) -> str:
    rows = flatten(records)
    best = min(rows, key=lambda r: r["energy_wh"])
    pmax = max(rows, key=lambda r: r["avg_power_w"])
    return (f"P_range={min(r['avg_power_w'] for r in rows):.0f}-"
            f"{max(r['avg_power_w'] for r in rows):.0f}W"
            f"(paper:213-355);peak_at=TP{pmax['tp']}PP{pmax['pp']}"
            f"(paper:TP2PP1);best=TP{best['tp']}PP{best['pp']}"
            f"(paper:TP2PP1 or TP1PP2)")


# --------------------------------------------------------------- table2 ---

def _table2_build(smoke: bool, n_requests: Optional[int] = None):
    """Paper deviation (documented in EXPERIMENTS.md §Repro): the stated
    20 QPS on one A100 exceeds the device's peak FLOP/s by ~1.6x for
    this workload; we reproduce the co-sim at 85% of OUR max QPS (5.5),
    preserving the 5.5 h saturated-burst shape and total energy of the
    paper's Table 2."""
    n = n_requests or (1500 if smoke else 110_000)
    return GridSpec(
        base=INTEGRATION_DEFAULT, tag="table2",
        axes={"workload.n_requests": [n]},
        fixed={"workload.qps": 5.5},
        post="microgrid_cosim",
        post_params={"hours": 30.0}).expand()


def _table2_derive(records: List[dict]) -> str:
    m = records[0]["metrics"]
    return (f"renewable_share={m['cosim_renewable_share_pct']:.1f}%"
            f"(paper:70.3);offset={m['cosim_carbon_offset_pct']:.1f}%"
            f"(paper:69.2);E={m['cosim_total_energy_kwh']:.2f}kWh"
            f"(paper:5.90);"
            f"net={m['cosim_net_emissions_kg'] * 1000:.0f}g(paper:759)")


def _table2_rows(records: List[dict]) -> list:
    return {k[len("cosim_"):]: v
            for k, v in records[0]["metrics"].items()
            if k.startswith("cosim_")}


# --------------------------------------------------------------- carbon ---

def _carbon_build(smoke: bool, n_requests: Optional[int] = None):
    """ROADMAP "carbon-aware sweep scenarios": grid CI trace, solar
    capacity and battery sizing as post-processor axes over the
    single-site microgrid co-sim (same Eq. 5 -> co-sim pipeline as
    table2, swept instead of fixed at the paper's Table 1b point)."""
    n = n_requests or (400 if smoke else 20_000)
    traces = ["hydro", "caiso"] if smoke else ["hydro", "wind", "caiso",
                                               "coal"]
    solar = [0.0, 600.0] if smoke else [0.0, 300.0, 600.0, 1200.0]
    batt = [100.0] if smoke else [0.0, 100.0, 400.0]
    return GridSpec(
        base=PAPER_DEFAULT, tag="carbon",
        axes={"post.ci_trace": traces,
              "post.solar_capacity_w": solar,
              "post.battery_capacity_wh": batt},
        fixed={"workload.n_requests": n, "workload.qps": 5.0},
        post="microgrid_cosim",
        # full diurnal window: the load lands at start_hour=8 inside
        # the solar day, so the solar/battery axes actually bite
        post_params={"hours": 24.0}).expand()


def _carbon_derive(records: List[dict]) -> str:
    rows = flatten(records)
    by_trace: Dict[str, List[float]] = {}
    for r in rows:
        by_trace.setdefault(r["ci_trace"], []).append(
            r["cosim_net_emissions_kg"])
    order = sorted(by_trace, key=lambda t: float(np.mean(by_trace[t])))
    solar_off = [r["cosim_net_emissions_kg"] for r in rows
                 if r["solar_capacity_w"] == 0.0]
    solar_on = [r["cosim_net_emissions_kg"] for r in rows
                if r["solar_capacity_w"] > 0.0]
    helps = float(np.mean(solar_on)) < float(np.mean(solar_off))
    return (f"ci_ranking={'<'.join(order)};"
            f"solar_cuts_net_emissions={helps}(expected:True)")


# ---------------------------------------------------------------- fleet ---

_FLEET_DIVERGENT = "hydro+coal"     # the two-region divergent-CI pair


def _fleet_build(smoke: bool, n_requests: Optional[int] = None):
    """Multi-site fleet: site device mix x router policy x two-region
    CI trace pair, each scenario a full in-loop-routed fleet
    simulation (repro_torch.fleet)."""
    from repro_torch.configs.paper_models import LLAMA3_8B
    from repro_torch.fleet.config import FleetConfig, SiteConfig
    from repro_torch.sim.requests import WorkloadConfig
    from repro_torch.sim.scheduler import SchedulerConfig

    n = n_requests or (64 if smoke else 2048)
    routers = (["round_robin", "carbon_greedy"] if smoke
               else ["round_robin", "least_loaded", "carbon_greedy"])
    ci_pairs = ([("hydro", "coal"), ("caiso", "caiso-east")] if smoke
                else [("hydro", "coal"), ("caiso", "caiso-east"),
                      ("wind", "coal")])
    mixes = [("a100", "a100")] if smoke else [("a100", "a100"),
                                              ("a100", "h100")]
    wl = WorkloadConfig(n_requests=n, qps=6.45, min_len=128,
                        max_len=1024 if smoke else 4096, seed=0)
    scenarios = []
    for mix in mixes:
        for pair in ci_pairs:
            for router in routers:
                sites = tuple(
                    SiteConfig(name=f"s{i}-{trace}", device=dev,
                               ci_trace=trace,
                               scheduler=SchedulerConfig(batch_cap=64))
                    for i, (dev, trace) in enumerate(zip(mix, pair)))
                cfg = FleetConfig(model=LLAMA3_8B, sites=sites,
                                  workload=wl, router=router)
                params = {"devices": "+".join(mix),
                          "ci": "+".join(pair), "router": router}
                label = ",".join(f"{k}={v}" for k, v in params.items())
                scenarios.append(Scenario(cfg=cfg, params=params,
                                          tag=f"fleet/{label}",
                                          pue=cfg.pue))
    return scenarios


def _fleet_derive(records: List[dict]) -> str:
    """Headline check: on the divergent two-region pair the
    carbon-greedy geo-router must emit less than round-robin."""
    rows = [r for r in flatten(records) if r["ci"] == _FLEET_DIVERGENT
            and r["devices"] == "a100+a100"]
    by_router = {r["router"]: r for r in rows}
    rr = by_router.get("round_robin")
    cg = by_router.get("carbon_greedy")
    if not (rr and cg):
        return "divergent-pair rows missing"
    save = 100.0 * (1.0 - cg["carbon_operational_g"]
                    / max(rr["carbon_operational_g"], 1e-12))
    return (f"carbon_greedy_vs_round_robin_on_{_FLEET_DIVERGENT}="
            f"-{save:.1f}%_emissions(expected:negative);"
            f"rr={rr['carbon_operational_g']:.2f}g,"
            f"cg={cg['carbon_operational_g']:.2f}g")


# ---------------------------------------------------------------- shift ---

_SHIFT_DIVERGENT = "hydro-evening+coal-evening"
#: deliberately spans the evening CI ramp: arrivals start at 17:00
#: grid-local (the "-evening" traces), so deferral windows reach the
#: post-peak overnight decline within a few hours of sim time
_SHIFT_SPAN_S = {"smoke": 4 * 3600.0, "full": 8 * 3600.0}


def _shift_build(smoke: bool, n_requests: Optional[int] = None):
    """Temporal carbon-aware scheduling (repro_torch.schedule): admission
    policy x CI forecaster x deadline x trace-set x solar axes over
    request-level fleet simulations. Every scenario pins the same
    co-sim horizon, so idle carbon is identical across the policy axis
    and differences isolate what the admission gate moved."""
    from repro_torch.configs.paper_models import LLAMA3_8B
    from repro_torch.fleet.config import FleetConfig, SiteConfig
    from repro_torch.schedule.config import ScheduleConfig
    from repro_torch.sim.requests import WorkloadConfig
    from repro_torch.sim.scheduler import SchedulerConfig

    span = _SHIFT_SPAN_S["smoke" if smoke else "full"]
    n = n_requests or (96 if smoke else 1024)
    policies = ["immediate", "threshold_defer", "forecast_window"]
    forecasters = (["oracle", "persistence"] if smoke
                   else ["oracle", "persistence", "diurnal"])
    deadlines = [7200.0] if smoke else [3600.0, 14400.0]
    # (ci label, site traces, spatial router): carbon_slo on the
    # divergent pair is the temporal x spatial composition and the
    # acceptance pin (its site assignment is invariant to release
    # order, so the policy axis isolates the temporal gate); the same
    # pair under spatially-blind round_robin is the baseline (release
    # order reshuffles its assignments — reported, not pinned); the
    # single-site rows isolate temporal shifting, with the real
    # ElectricityMaps trace exercising the file-backed loader end to end
    site_sets = [(_SHIFT_DIVERGENT, ("hydro-evening", "coal-evening"),
                  "carbon_slo"),
                 (_SHIFT_DIVERGENT, ("hydro-evening", "coal-evening"),
                  "round_robin"),
                 ("caiso-evening", ("caiso-evening",), "round_robin")]
    if not smoke:
        site_sets += [("caiso-em", ("caiso-em",), "round_robin")]
    solars = [(0.0, 0.0)] if smoke else [(0.0, 0.0), (600.0, 100.0)]
    horizon_s = span + max(deadlines) + 3600.0

    scenarios = []
    for ci_label, traces, router in site_sets:
        for policy in policies:
            # immediate admission never consults the forecaster: one
            # row per forecast axis would execute bit-identical sims
            # under distinct cache keys
            for fc in (["oracle"] if policy == "immediate"
                       else forecasters):
                for deadline in deadlines:
                    for solar_w, batt_wh in solars:
                        wl = WorkloadConfig(
                            n_requests=n, qps=n / span, min_len=128,
                            max_len=1024 if smoke else 4096, seed=0,
                            deferrable_frac=0.5,
                            deferrable_deadline_s=deadline,
                            interactive_slo_s=30.0)
                        sites = tuple(
                            SiteConfig(name=f"s{i}-{t}", ci_trace=t,
                                       solar_capacity_w=(solar_w if i == 0
                                                         else 0.0),
                                       battery_capacity_wh=(batt_wh
                                                            if i == 0
                                                            else 0.0),
                                       scheduler=SchedulerConfig(
                                           batch_cap=64))
                            for i, t in enumerate(traces))
                        sched = ScheduleConfig(
                            policy=policy, forecaster=fc,
                            ci_stat=("min" if router == "carbon_slo"
                                     else "mean"))
                        cfg = FleetConfig(model=LLAMA3_8B, sites=sites,
                                          workload=wl, router=router,
                                          schedule=sched,
                                          horizon_s=horizon_s)
                        params = {"policy": policy, "forecaster": fc,
                                  "deadline_s": deadline, "ci": ci_label,
                                  "router": router, "solar_w": solar_w}
                        label = ",".join(f"{k}={v}"
                                         for k, v in params.items())
                        scenarios.append(Scenario(
                            cfg=cfg, params=params, tag=f"shift/{label}",
                            pue=cfg.pue))
    return scenarios


def _shift_derive(records: List[dict]) -> str:
    """Headline: on the divergent evening pair under SLO-bounded
    carbon routing with oracle forecasts, deferral must cut the
    request-attributable operational emissions vs immediate admission
    while interactive p99 TTFT stays within the 30 s SLO."""
    rows = [r for r in flatten(records)
            if r["ci"] == _SHIFT_DIVERGENT and r["router"] == "carbon_slo"
            and r["forecaster"] == "oracle" and r["solar_w"] == 0.0]
    if not rows:
        return "divergent-pair oracle rows missing"
    deadline = max(r["deadline_s"] for r in rows)
    by_policy = {r["policy"]: r for r in rows
                 if r["deadline_s"] == deadline}
    imm = by_policy.get("immediate")
    td = by_policy.get("threshold_defer")
    fw = by_policy.get("forecast_window")
    if not (imm and td and fw):
        return "policy rows missing"

    def save(r, col="carbon_active_g"):
        return 100.0 * (1.0 - r[col] / max(imm[col], 1e-12))

    return (f"active_carbon_cut_on_{_SHIFT_DIVERGENT}: "
            f"threshold_defer=-{save(td):.2f}%(expected:<0),"
            f"forecast_window=-{save(fw):.2f}%(expected:<0);"
            f"cosim_net: defer<=immediate="
            f"{td['carbon_operational_g'] <= imm['carbon_operational_g']};"
            f"deferred_frac={td['deferred_fraction']:.2f};"
            f"interactive_p99: imm={imm['interactive_ttft_p99_s']:.3f}s "
            f"defer={td['interactive_ttft_p99_s']:.3f}s "
            f"(SLO 30s, expected:unchanged+within)")


# ----------------------------------------------------------------- day ----

#: tolerance for fluid-epoch and whole-day metric agreement between the
#: hybrid and event_loop day modes (relative) — the acceptance bound
#: the day-smoke CI job asserts
DAY_FLUID_RTOL = 0.01

#: per-epoch columns compared across day modes. Tail quantiles are
#: deliberately absent: a ~100-request pilot's p99 is order-statistic-
#: limited (the ttft tail sits on discrete queueing modes, so the 99th
#: percentile of a small sample jumps between modes), so the p99
#: agreement bound is asserted on planned-exact epochs (bit-for-bit,
#: below) and on the day-level weighted percentile (_DAY_TOTAL_COLS),
#: where the aggregated sample mass smooths the mode boundary.
_DAY_COMPARE_COLS = ("energy_wh", "carbon_g", "n")
_DAY_EXACT_COLS = _DAY_COMPARE_COLS + ("ttft_p99_s",)
_DAY_TOTAL_COLS = ("energy_wh", "carbon_operational_g", "ttft_p99_s",
                   "e2e_p99_s", "n_requests")


def _day_build(smoke: bool, n_requests: Optional[int] = None):
    """Day-scale fluid/request hybrid (repro_torch.fleet.day): a diurnal +
    bursty arrival stream over a two-site fleet with carbon-aware
    deferral, run under both day modes — ``hybrid`` (fluid epochs with
    exact transients) and ``event_loop`` (every epoch exact) — with
    and without the replica autoscaler. The smoke grid is what the
    day-smoke CI job compares: planned-exact epochs bit-for-bit,
    fluid epochs within ``DAY_FLUID_RTOL``."""
    from repro_torch.configs.paper_models import LLAMA3_8B
    from repro_torch.fleet.autoscale import AutoscalerConfig
    from repro_torch.fleet.config import FleetConfig, SiteConfig
    from repro_torch.schedule.config import ScheduleConfig
    from repro_torch.sim.hybrid import DayConfig
    from repro_torch.sim.requests import WorkloadConfig
    from repro_torch.sim.scheduler import SchedulerConfig

    span = 3600.0 if smoke else 24 * 3600.0
    n = n_requests or (9000 if smoke else 400_000)
    epoch_s = 300.0 if smoke else 900.0
    # full-scale event_loop would step every request (minutes of wall
    # clock); the full sweep keeps the hybrid rows only — the smoke
    # grid carries the cross-mode agreement pin
    modes = ["hybrid", "event_loop"] if smoke else ["hybrid"]
    # fixed request length: the fluid pilot's p99 must estimate the
    # exact epoch's p99 within DAY_FLUID_RTOL, which needs a latency
    # distribution whose tail is set by queueing, not by length-draw
    # sampling noise in a ~100-request pilot
    wl = WorkloadConfig(
        n_requests=n, qps=n / span, min_len=192, max_len=192, seed=0,
        envelope="sinusoidal", envelope_amplitude=0.3,
        envelope_period_h=span / 3600.0,
        burst_gain=2.5, burst_mean_s=span / 15.0,
        burst_idle_mean_s=span / 2.5,
        deferrable_frac=0.3, deferrable_deadline_s=span,
        interactive_slo_s=30.0)
    scenarios = []
    for autoscale in (0, 1):
        # tokens_per_s is the planner's capacity estimate, pitched so
        # the diurnal swing crosses the scale-up threshold (util ~0.5
        # at the trough, ~0.9 at the peak, >1 inside bursts)
        asc = AutoscalerConfig(
            enabled=bool(autoscale), min_replicas=1, max_replicas=3,
            target_util=0.6, scale_up_latency_s=epoch_s / 5.0,
            warm_spares=1, tokens_per_s=160.0 * n / 4000.0 / (span / 3600.0),
            ci_scale_down_g=0.0)
        sites = tuple(
            SiteConfig(name=f"s{i}-{trace}", ci_trace=trace,
                       autoscaler=asc,
                       scheduler=SchedulerConfig(batch_cap=64))
            for i, trace in enumerate(("caiso-night", "coal-night")))
        for mode in modes:
            cfg = FleetConfig(
                model=LLAMA3_8B, sites=sites, workload=wl,
                router="round_robin",
                schedule=ScheduleConfig(policy="forecast_window",
                                        forecaster="oracle",
                                        policy_params={"margin": 0.01}),
                # util_threshold below the default 0.85: the fluid
                # pilot's p99 only estimates the exact epoch's within
                # DAY_FLUID_RTOL when the tail is service-time- rather
                # than queueing-dominated, so epochs the capacity
                # estimate puts past ~60% utilization run exact
                day=DayConfig(mode=mode, epoch_s=epoch_s,
                              pilot_requests=128 if smoke else 256,
                              warmup_requests=32 if smoke else 64,
                              util_threshold=0.6))
            params = {"mode": mode, "autoscale": autoscale}
            label = ",".join(f"{k}={v}" for k, v in params.items())
            scenarios.append(Scenario(cfg=cfg, params=params,
                                      tag=f"day/{label}", pue=cfg.pue))
    return scenarios


def day_agreement(records: List[dict]) -> Dict[str, float]:
    """Hybrid-vs-event_loop agreement stats over paired day records.

    Pairs records on the non-mode params and compares per-epoch fleet
    columns: epochs both modes planned fully exact must match
    bit-for-bit (``exact_max_rel`` stays 0.0), fluid epochs and whole-
    day totals within ``DAY_FLUID_RTOL``. Also checks the two modes
    planned identical epochs (``plans_match``) and reports the hybrid
    speedup. This is what tests/test_torch_day.py
    assert on."""
    by_pair: Dict[tuple, Dict[str, dict]] = {}
    for r in records:
        key = tuple(sorted((k, v) for k, v in r["params"].items()
                           if k != "mode"))
        by_pair.setdefault(key, {})[r["params"]["mode"]] = r
    out = {"n_pairs": 0.0, "plans_match": 1.0, "exact_max_rel": 0.0,
           "fluid_max_rel": 0.0, "total_max_rel": 0.0,
           "n_exact_epochs": 0.0, "n_fluid_epochs": 0.0,
           "speedup": 0.0, "sim_fraction": 1.0}
    speedups = []
    for pair in by_pair.values():
        h, x = pair.get("hybrid"), pair.get("event_loop")
        if not (h and x):
            continue
        hm, xm = h["metrics"], x["metrics"]
        out["n_pairs"] += 1
        if hm["n_epochs"] != xm["n_epochs"]:
            out["plans_match"] = 0.0
            continue
        for e in range(int(hm["n_epochs"])):
            tag = f"e{e:03d}"
            if hm[f"{tag}_exact"] != xm[f"{tag}_exact"]:
                out["plans_match"] = 0.0
            fully_exact = hm[f"{tag}_exact"] == 1.0
            cols = _DAY_EXACT_COLS if fully_exact else _DAY_COMPARE_COLS
            for col in cols:
                a, b = hm[f"{tag}_{col}"], xm[f"{tag}_{col}"]
                rel = abs(a - b) / max(abs(a), abs(b), 1e-12)
                bucket = ("exact_max_rel" if fully_exact
                          else "fluid_max_rel")
                out[bucket] = max(out[bucket], rel)
            if fully_exact:
                out["n_exact_epochs"] += 1
            else:
                out["n_fluid_epochs"] += 1
        for col in _DAY_TOTAL_COLS:
            rel = (abs(hm[col] - xm[col])
                   / max(abs(hm[col]), abs(xm[col]), 1e-12))
            out["total_max_rel"] = max(out["total_max_rel"], rel)
        speedups.append(x["meta"]["elapsed_s"]
                        / max(h["meta"]["elapsed_s"], 1e-9))
        out["sim_fraction"] = min(out["sim_fraction"],
                                  hm["sim_fraction"])
    if speedups:
        out["speedup"] = float(np.mean(speedups))
    return out


def _day_derive(records: List[dict]) -> str:
    agree = day_agreement(records)
    if not agree["n_pairs"]:
        h = [r["metrics"] for r in records
             if r["params"]["mode"] == "hybrid"]
        if not h:
            return "no day records"
        return (f"hybrid_only:n={sum(m['n_requests'] for m in h):.0f};"
                f"sim_fraction={min(m['sim_fraction'] for m in h):.3f};"
                f"exact_epochs={sum(m['n_exact_epochs'] for m in h):.0f}"
                f"/{sum(m['n_epochs'] for m in h):.0f}")
    return (f"pairs={agree['n_pairs']:.0f};"
            f"plans_match={bool(agree['plans_match'])}(expected:True);"
            f"exact_bitwise={agree['exact_max_rel'] == 0.0}"
            f"(expected:True);"
            f"fluid_max_rel={agree['fluid_max_rel']:.2e}"
            f"(tol:{DAY_FLUID_RTOL});"
            f"total_max_rel={agree['total_max_rel']:.2e};"
            f"sim_fraction={agree['sim_fraction']:.3f};"
            f"hybrid_speedup={agree['speedup']:.1f}x")


# ---------------------------------------------------------------- perf ----

def _perf_build(smoke: bool, n_requests: Optional[int] = None):
    """Perf-trajectory grid (``benchmarks/perf_sweep.py``), two planes:

    * plane A — a few QPS points x a dense (PUE x grid-CI) report
      plane: scenario-level axes share traces, so the vectorized
      runner drives one event loop per QPS point and stacks the rest
      (the historical ~1k-scenario grid);
    * plane B — a hardware family (device x TP x PP) over one sparse
      uniform-arrival stream: every point is its own trace group for
      the numpy modes, but the arrivals are provably isolated under
      every config, so device-mode divergence analysis shares one
      composition schedule and replays it per point instead of
      re-running the event loop 8x (``repro_torch.sweep.divergence``).

    The event-loop runner simulates everything; the contrasts are what
    ``BENCH_sweep.json`` tracks."""
    qps = [2.0, 4.0, 6.45, 8.0]
    pues = [round(1.0 + 0.05 * i, 2) for i in range(16)]
    cis = [round(25.0 + 45.0 * i, 1) for i in range(16)]
    n = n_requests or (16 if smoke else 64)
    plane_a = GridSpec(
        base=PAPER_DEFAULT, tag="perf",
        axes={"workload.qps": qps, "pue": pues, "grid_ci": cis},
        fixed={"workload.n_requests": n, "workload.min_len": 64,
               "workload.max_len": 256}).expand()
    hw = [(dev, tp, pp) for dev in ("a100", "h100")
          for tp, pp in ((1, 1), (2, 1), (1, 2), (2, 2))]
    plane_b = GridSpec(
        base=PAPER_DEFAULT, tag="perf",
        axes={"device+tp+pp": hw,
              "pue": [1.1, 1.3], "grid_ci": [100.0, 400.0]},
        fixed={"workload.n_requests": 4 * n, "workload.qps": 0.5,
               "workload.arrival": "uniform", "workload.min_len": 64,
               "workload.max_len": 256}).expand()
    return plane_a + plane_b


def _perf_derive(records: List[dict]) -> str:
    rows = flatten(records)
    traces = len({(r.get("qps"), r.get("device"), r.get("tp"),
                   r.get("pp")) for r in rows})
    return (f"scenarios={len(rows)};unique_traces={traces};"
            f"shared_axis_points={len(rows) // max(traces, 1)}")


# ------------------------------------------------------------- registry ---

SWEEPS: Dict[str, SweepDef] = {
    "fig1": SweepDef("fig1", "QPS saturation (Llama-3-8B MFU plateau)",
                     _fig1_build, _fig1_derive),
    "fig2": SweepDef("fig2", "Request count vs power/energy across models",
                     _fig2_build, _fig2_derive, rows=_fig2_rows),
    "fig3": SweepDef("fig3", "Prefill:decode ratio x request length",
                     _fig3_build, _fig3_derive),
    "fig4": SweepDef("fig4", "Batch cap vs power and energy",
                     _fig4_build, _fig4_derive),
    "fig5": SweepDef("fig5", "QPS vs power and energy (fixed workload)",
                     _fig5_build, _fig5_derive),
    "exp5": SweepDef("exp5", "TP x PP parallelism (CodeLlama-34B)",
                     _exp5_build, _exp5_derive),
    "table2": SweepDef("table2", "Vidur-Vessim microgrid co-simulation",
                       _table2_build, _table2_derive, rows=_table2_rows),
    "carbon": SweepDef("carbon", "CI trace x solar x battery co-sim axes",
                       _carbon_build, _carbon_derive),
    "fleet": SweepDef("fleet",
                      "Multi-site fleet: device mix x router x CI pair",
                      _fleet_build, _fleet_derive),
    "shift": SweepDef("shift",
                      "Temporal shifting: policy x forecaster x deadline "
                      "x CI trace x solar",
                      _shift_build, _shift_derive),
    "day": SweepDef("day",
                    "Day-scale hybrid: diurnal+burst stream, fluid vs "
                    "exact day modes, autoscaler on/off",
                    _day_build, _day_derive),
    "perf": SweepDef("perf",
                     "Perf smoke grid: QPS x PUE x grid-CI (1k scenarios, "
                     "4 traces)",
                     _perf_build, _perf_derive),
}


def run_sweep(name: str, smoke: bool = False,
              n_requests: Optional[int] = None, workers: int = 1,
              cache=None, progress=None, mode: str = "vectorized",
              probe=None, backend: str = "local", remote=None,
              torch_device=None):
    """Expand + execute one named sweep.

    Returns ``(records, stats, derived)``. ``cache`` follows
    ``runner.SweepRunner`` semantics (None disables memoization);
    ``mode`` selects the execution mode (both numpy modes are
    bit-identical); ``probe`` attaches a ``repro_torch.obs.Probe`` to
    executed scenarios (forces serial execution, see ``SweepRunner``);
    ``torch_device`` runs the scenarios' tensor work (``None``: the card,
    raising without one); ``backend="remote"`` fans trace groups out to
    detached workers over a shared-filesystem queue
    (``repro_torch.sweep.remote``, options in ``remote``).
    """
    from repro_torch.sweep.runner import SweepRunner
    if name not in SWEEPS:
        raise KeyError(f"unknown sweep {name!r}; have {sorted(SWEEPS)}")
    sweep = SWEEPS[name]
    scenarios = sweep.build(smoke, n_requests=n_requests)
    records, stats = SweepRunner(cache=cache, workers=workers,
                                 mode=mode, probe=probe, backend=backend,
                                 remote=remote, torch_device=torch_device
                                 ).run(scenarios, progress)
    return records, stats, sweep.derive(records)
