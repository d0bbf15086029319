"""The port's ``fleet/`` against the reference, on the CPU: two-site fleets at
``tests/test_fleet.py``'s configuration (Llama-3-8B, 48 requests at 5 QPS,
prompts of 64-512 tokens, batch cap 16, hydro and coal grid regions),
varied by router, device mix, microgrid, admission gate and autoscaler.

Request conservation and everything the event loop decides is bitwise:
site assignments, each site's requests and stage trace, latencies. The
summary's columns are held at ``DEVICE_MODE_RTOL`` (5e-6) of themselves,
a percentage at 5e-6 of 100: Eq. 1 and the microgrid's float32 loop may
round an ulp apart, and without solar ``carbon_offset_pct`` is the float32
noise of a difference of two equal totals (~1e-5 %).
"""
import dataclasses
import types

import numpy as np
import pytest

import repro.configs.paper_models as r_models
import repro.fleet as r_fleet
import repro.fleet.autoscale as r_auto
import repro.schedule as r_sched
import repro.sim as r_sim
import repro_torch.configs.paper_models as p_models
import repro_torch.fleet as p_fleet
import repro_torch.fleet.autoscale as p_auto
import repro_torch.schedule as p_sched
import repro_torch.sim as p_sim
from repro_torch.core.power import DEVICE_MODE_RTOL

REF = types.SimpleNamespace(fleet=r_fleet, sim=r_sim, models=r_models,
                            sched=r_sched, auto=r_auto)
PORT = types.SimpleNamespace(fleet=p_fleet, sim=p_sim, models=p_models,
                             sched=p_sched, auto=p_auto)

FLEETS = {
    "round_robin": {},
    "carbon_greedy-solar": dict(router="carbon_greedy", solar=True),
    "least_loaded-a100-h100": dict(router="least_loaded",
                                   devices=("a100", "h100")),
    "carbon_slo-deferral": dict(router="carbon_slo", defer=True,
                                traces=("hydro-evening", "coal-evening")),
    "autoscale": dict(autoscale=True, n=96, qps=10.0),
}


def fleet_cfg(pkg, router="round_robin", devices=("a100", "a100"),
              traces=("hydro", "coal"), solar=False, defer=False,
              autoscale=False, n=48, qps=5.0):
    """``tests/test_fleet.py::two_region_fleet``, built from ``pkg``."""
    sites = []
    for i, (d, t) in enumerate(zip(devices, traces)):
        kw = {}
        if solar and i == 0:
            kw = dict(solar_capacity_w=600.0, battery_capacity_wh=100.0)
        if autoscale and i == 0:
            kw["autoscaler"] = pkg.auto.AutoscalerConfig(
                enabled=True, min_replicas=1, max_replicas=3,
                control_interval_s=2.0, scale_up_latency_s=1.0,
                delay_hi_s=0.5, delay_lo_s=0.1, tokens_per_s=300.0)
        sites.append(pkg.fleet.SiteConfig(
            name=f"s{i}-{t}", device=d, ci_trace=t,
            scheduler=pkg.sim.SchedulerConfig(batch_cap=16), **kw))
    workload = pkg.sim.WorkloadConfig(
        n_requests=n, qps=qps, min_len=64, max_len=512, seed=0)
    schedule, horizon_s = pkg.sched.ScheduleConfig(), None
    if defer:   # tests/test_schedule.py's shift shape: 4 h of arrivals
        workload = dataclasses.replace(workload, qps=n / (4 * 3600.0),
                                       deferrable_frac=0.5,
                                       deferrable_deadline_s=7200.0)
        schedule = pkg.sched.ScheduleConfig(policy="forecast_window",
                                            ci_stat="min")
        horizon_s = 4 * 3600.0 + 7200.0 + 3600.0
    return pkg.fleet.FleetConfig(model=pkg.models.LLAMA3_8B, sites=tuple(sites),
                                 workload=workload, router=router,
                                 schedule=schedule, horizon_s=horizon_s)


@pytest.mark.parametrize("name", list(FLEETS))
def test_fleet_matches_reference(name):
    want_cfg, got_cfg = fleet_cfg(REF, **FLEETS[name]), fleet_cfg(PORT, **FLEETS[name])
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(want_cfg)
    want = r_fleet.run_fleet_simulation(want_cfg)
    got = p_fleet.run_fleet_simulation(got_cfg, torch_device="cpu")

    # conservation and the event loop's decisions: bitwise
    np.testing.assert_array_equal(got.assignments, want.assignments)
    assert sorted(r.rid for s in got.sites for r in s.requests) == \
        list(range(want_cfg.workload.n_requests))
    assert [dataclasses.asdict(r) for r in got.requests] == \
        [dataclasses.asdict(r) for r in want.requests]
    assert got.duration_s == want.duration_s
    assert got.router_stats == want.router_stats
    assert got.admission_stats == want.admission_stats
    for g, w in zip(got.sites, want.sites):
        assert [r.rid for r in g.requests] == [r.rid for r in w.requests]
        for f in dataclasses.fields(w.stages):
            np.testing.assert_array_equal(getattr(g.stages, f.name),
                                          getattr(w.stages, f.name))
        np.testing.assert_array_equal(g.load.times, w.load.times)
        np.testing.assert_allclose(g.load.values, w.load.values,
                                   rtol=DEVICE_MODE_RTOL, atol=0)
        assert g.autoscale == w.autoscale

    # the summary: within 5e-6
    want_s, got_s = want.summary(), got.summary()
    assert got_s.keys() == want_s.keys()
    for k, v in want_s.items():
        atol = DEVICE_MODE_RTOL * 100.0 if k.endswith("_pct") else 0.0
        np.testing.assert_allclose(got_s[k], v, rtol=DEVICE_MODE_RTOL,
                                   atol=atol, err_msg=k)
    assert got_s["n_requests_done"] == want_cfg.workload.n_requests


@pytest.mark.parametrize("router", ["round_robin", "least_loaded",
                                    "carbon_greedy", "carbon_slo"])
def test_routers_choose_as_the_reference(router):
    """Each router's choices over a random sequence of site states."""
    class View:
        def __init__(self, tokens, ci):
            self.tokens, self.ci = tokens, ci

        def outstanding_tokens(self):
            return self.tokens

        def outstanding_requests(self):
            return self.tokens // 100

        def ci_at(self, t):
            return self.ci

    rng = np.random.default_rng(1)
    states = [[View(int(rng.integers(0, 5000)), float(rng.uniform(50, 800)))
               for _ in range(3)] for _ in range(200)]
    reqs = r_sim.generate(r_sim.WorkloadConfig(n_requests=200, seed=3))
    choices = []
    for fleet in (r_fleet, p_fleet):
        r = fleet.make_router(router, 3)
        choices.append(([r.choose(q, float(i), v)
                         for i, (q, v) in enumerate(zip(reqs, states))],
                        r.stats()))
    assert choices[1] == choices[0]
