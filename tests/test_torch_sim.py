"""The port's ``sim/``, ``workloads/`` and ``schedule/`` against the reference,
and the paper's Table 1a / Table 2 path end to end, on the CPU.

Host code is bitwise: request streams, scheduler decisions, stage traces,
latencies, admission releases, epoch plans. The roofline's torch backend
(float64) is held at ``TORCH_BACKEND_RTOL`` against the numpy path, and
anything that passes through Eq. 1 (``energy_report``, the Table 2 co-sim
metrics) at ``DEVICE_MODE_RTOL`` (5e-6): torch's and XLA's float32 ``pow``
may differ by an ulp.
"""
import dataclasses
import types

import numpy as np
import pytest

import repro.configs.paper_models as r_models
import repro.core as r_core
import repro.core.datasets as r_data
import repro.schedule as r_sched
import repro.sim as r_sim
import repro.sim.hybrid as r_hybrid
import repro.workloads as r_work
import repro_torch.configs.paper_models as p_models
import repro_torch.core as p_core
import repro_torch.core.datasets as p_data
import repro_torch.schedule as p_sched
import repro_torch.sim as p_sim
import repro_torch.sim.hybrid as p_hybrid
import repro_torch.workloads as p_work
from repro_torch.core.power import DEVICE_MODE_RTOL
from repro_torch.sim.execmodel import TORCH_BACKEND_RTOL

REF = types.SimpleNamespace(sim=r_sim, core=r_core, data=r_data, models=r_models)
PORT = types.SimpleNamespace(sim=p_sim, core=p_core, data=p_data, models=p_models)
CPU = "cpu"


def _rows(objs):
    return [dataclasses.asdict(o) for o in objs]


def _assert_traces_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


# ------------------------------------------------------------ requests ---

WORKLOADS = {
    "paper": dict(n_requests=300, qps=6.45),
    "uniform-fixed": dict(n_requests=200, qps=3.0, arrival="uniform",
                          length_dist="fixed", min_len=256, max_len=256),
    "classes": dict(n_requests=300, qps=2.0, deferrable_frac=0.4, seed=5,
                    min_len=64, max_len=1024),
    "diurnal-bursty": dict(n_requests=400, qps=1.0, envelope="diurnal",
                           envelope_period_h=1.0, burst_gain=3.0,
                           burst_mean_s=60.0, burst_idle_mean_s=240.0, seed=9),
}


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_requests_and_streams_are_bitwise(name):
    want_cfg = r_sim.WorkloadConfig(**WORKLOADS[name])
    got_cfg = p_sim.WorkloadConfig(**WORKLOADS[name])
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(want_cfg)
    assert _rows(p_sim.generate(got_cfg)) == _rows(r_sim.generate(want_cfg))
    want, got = r_work.generate_stream(want_cfg), p_work.generate_stream(got_cfg)
    for f in ("rid", "arrival_s", "ready_s", "prefill_tokens", "decode_tokens",
              "deferrable", "tokens"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert _rows(got.to_requests()) == _rows(want.to_requests())


@pytest.mark.parametrize("envelope", ["none", "sinusoidal", "diurnal"])
@pytest.mark.parametrize("burst_s", [0.0, 90.0])
def test_envelopes_are_bitwise(envelope, burst_s):
    grids = []
    for work in (r_work, p_work):
        burst = work.burst_overlay(3, 2 * 86400.0, 2.5, burst_s, 900.0)
        grids.append(work.rate_on_grid(6.45, envelope, 0.35, 24.0, 2.0, burst,
                                       2 * 86400.0))
    for got, want in zip(grids[1], grids[0]):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------- execmodel ---

@pytest.mark.parametrize("model", ["LLAMA3_8B", "LLAMA2_7B", "CODELLAMA_34B"])
@pytest.mark.parametrize("tp,pp", [(1, 1), (2, 1), (2, 2)])
def test_stage_costs_are_bitwise_and_torch_backend_within_rtol(model, tp, pp):
    models = [getattr(m, model) for m in (r_models, p_models)]
    want_em = r_sim.ExecutionModel(models[0], r_core.DEVICES["a100"], tp, pp)
    got_em = p_sim.ExecutionModel(models[1], p_core.DEVICES["a100"], tp, pp)
    np.testing.assert_array_equal(got_em.params_vector(), want_em.params_vector())
    rng = np.random.default_rng(tp * 10 + pp)
    for _ in range(20):
        plens = list(rng.integers(1, 2048, rng.integers(0, 6)))
        ctxs = list(rng.integers(1, 8192, rng.integers(0, 64)))
        offs = list(rng.integers(0, 512, len(plens)))
        w, g = (em.stage_cost_scalar(plens, ctxs, offs) for em in (want_em, got_em))
        assert dataclasses.asdict(g[0]) == dataclasses.asdict(w[0]) and g[1:] == w[1:]
        assert dataclasses.asdict(got_em.stage_cost(plens, ctxs, offs)) == \
            dataclasses.asdict(want_em.stage_cost(plens, ctxs, offs))
    batch = p_sim.StageBatch(rng.integers(0, 4096, 500).astype(float),
                             rng.integers(0, 128, 500).astype(float),
                             rng.uniform(0, 1e12, 500), rng.uniform(0, 1e10, 500))
    want = want_em.stage_cost_batch(r_sim.StageBatch(*dataclasses.astuple(batch)))
    got = got_em.stage_cost_batch(batch)
    on_torch = got_em.stage_cost_batch(batch, backend="torch", torch_device=CPU)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name))
        assert getattr(on_torch, f.name).dtype == np.float64
        np.testing.assert_allclose(getattr(on_torch, f.name), getattr(want, f.name),
                                   rtol=TORCH_BACKEND_RTOL, atol=0, err_msg=f.name)
    with pytest.raises(ValueError, match="unknown backend"):
        got_em.stage_cost_batch(batch, backend="jax")


# ---------------------------------------------------------- simulator ---

def _sim_cfg(pkg, model="LLAMA3_8B", tp=1, pp=1, n_replicas=1, chunk=None,
             device="a100", n=120):
    return pkg.sim.SimConfig(
        model=getattr(pkg.models, model), device=device, tp=tp, pp=pp,
        n_replicas=n_replicas,
        workload=pkg.sim.WorkloadConfig(n_requests=n, qps=4.0, min_len=64,
                                        max_len=2048, seed=2),
        scheduler=pkg.sim.SchedulerConfig(batch_cap=32, chunk_prefill=chunk))


SIMS = {"base": {}, "tp2-pp2": dict(tp=2, pp=2), "replicas3": dict(n_replicas=3),
        "chunked": dict(chunk=256), "h100-llama2": dict(model="LLAMA2_7B",
                                                        device="h100")}


@pytest.mark.parametrize("name", list(SIMS))
def test_simulations_are_bitwise(name):
    want = r_sim.run_simulation(_sim_cfg(REF, **SIMS[name]))
    got = p_sim.run_simulation(_sim_cfg(PORT, **SIMS[name]))
    _assert_traces_equal(got.stages, want.stages)
    assert _rows(got.requests) == _rows(want.requests)
    assert got.latency_stats() == want.latency_stats()
    assert got.throughput_qps() == want.throughput_qps()
    assert got.avg_mfu() == want.avg_mfu()


def _energy_close(got, want):
    for k, v in dataclasses.asdict(want).items():
        np.testing.assert_allclose(dataclasses.asdict(got)[k], v,
                                   rtol=DEVICE_MODE_RTOL, atol=0, err_msg=k)


@pytest.fixture(scope="module")
def paper_runs():
    """Table 1a: Llama-3-8B on one A100, 1024 requests at 6.45 QPS."""
    return (r_sim.run_simulation(r_sim.PAPER_DEFAULT),
            p_sim.run_simulation(p_sim.PAPER_DEFAULT))


def test_paper_default_is_bitwise_with_energy_within_rtol(paper_runs):
    want, got = paper_runs
    assert dataclasses.asdict(p_sim.PAPER_DEFAULT) == \
        dataclasses.asdict(r_sim.PAPER_DEFAULT)
    assert len(got.stages) == 1475
    _assert_traces_equal(got.stages, want.stages)
    assert _rows(got.requests) == _rows(want.requests)
    for pue in (1.0, p_sim.PAPER_PUE):
        _energy_close(p_sim.energy_report(got, pue, torch_device=CPU),
                      r_sim.energy_report(want, pue))
    carbon = [pkg.stage_attributed_carbon(
        run.stages, pkg.PowerModel("a100", *dev), 1, 1.2,
        data.ci_trace_signal("caiso", 1.0))
        for pkg, data, run, dev in ((r_core, r_data, want, ()),
                                    (p_core, p_data, got, (CPU,)))]
    np.testing.assert_allclose(carbon[1], carbon[0], rtol=DEVICE_MODE_RTOL)


def table2(pkg, res, **kw):
    """Table 2's co-sim recipe (the reference's
    ``sweep/runner.py::_post_microgrid_cosim`` at its defaults): the stage
    log's Eq. 5 load placed from hour 8 of a 30 h, 60 s window with idle
    fill, 600 W solar (seed 3, cloudiness 0.12), CI seed 4, and the
    100 Wh battery at SoC 20-80 %."""
    pm = pkg.core.PowerModel(res.cfg.device, **kw)
    load = pkg.core.stages_to_load_signal(
        res.stages.start_s, res.stages.dur_s, res.stages.mfu, pm,
        n_devices=res.cfg.n_devices, pue=1.2, resolution_s=60.0)
    n_bins, start = int(30 * 3600 / 60), int(8 * 3600 / 60)
    vals = np.full(n_bins, pm.dev.p_idle * res.cfg.n_devices * 1.2)
    n = min(len(load.values), n_bins - start)
    vals[start:start + n] = load.values[:n]
    sig = pkg.core.Signal(np.arange(n_bins) * 60.0, vals, interp="previous")
    grid = pkg.core.MicrogridConfig(battery=pkg.core.BatteryConfig(
        capacity_wh=100.0, soc_init=0.5, soc_min=0.2, soc_max=0.8))
    return pkg.core.run_cosim(
        sig, pkg.data.solar_signal(30.0, capacity_w=600.0, seed=3, cloudiness=0.12),
        pkg.data.carbon_intensity_signal(30.0, seed=4), grid, **kw)


def test_paper_default_table2_cosim_within_rtol(paper_runs):
    want, got = table2(REF, paper_runs[0]), table2(PORT, paper_runs[1],
                                                   torch_device=CPU)
    np.testing.assert_array_equal(got.load.times, want.load.times)
    np.testing.assert_allclose(got.load.values, want.load.values,
                               rtol=DEVICE_MODE_RTOL, atol=0)
    assert got.metrics.keys() == want.metrics.keys()
    for k, v in want.metrics.items():
        np.testing.assert_allclose(float(got.metrics[k]), float(v),
                                   rtol=DEVICE_MODE_RTOL, atol=0, err_msg=k)


# -------------------------------------------------------------- hybrid ---

@pytest.mark.parametrize("seed", range(3))
def test_epoch_plans_are_bitwise(seed):
    cfg = dict(n_requests=1500, qps=1.0, min_len=128, max_len=1024, seed=seed,
               envelope="diurnal", envelope_period_h=0.5, burst_gain=2.5,
               burst_mean_s=120.0, burst_idle_mean_s=600.0)
    streams = [w.generate_stream(s.WorkloadConfig(**cfg)).sorted_by_ready()
               for w, s in ((r_work, r_sim), (p_work, p_sim))]
    plans = []
    for hyb, stream in zip((r_hybrid, p_hybrid), streams):
        bounds = hyb.epoch_bounds(float(stream.ready_s[-1]), 300.0)
        day = hyb.DayConfig(mode="hybrid", epoch_s=300.0, pilot_requests=64)
        replicas = 1 + (np.arange(len(bounds) - 1) % 3 == 2)
        plans.append((bounds, hyb.plan_epochs(stream, bounds, day, 3000.0,
                                              replicas, sat_tokens_per_s=2500.0)))
    np.testing.assert_array_equal(plans[1][0], plans[0][0])
    assert _rows(plans[1][1]) == _rows(plans[0][1])
    rng = np.random.default_rng(seed)
    v, w = rng.uniform(0, 10, 300), rng.uniform(0.1, 3, 300)
    for q in (50.0, 99.0):
        assert p_hybrid.weighted_percentile(v, w, q) == \
            r_hybrid.weighted_percentile(v, w, q)


def test_concat_traces_is_bitwise(paper_runs):
    want, got = paper_runs
    parts = lambda run, cls: [cls(**{f.name: getattr(run.stages, f.name)[a:b]
                                     for f in dataclasses.fields(cls)})
                              for a, b in ((0, 100), (100, 100), (100, 1475))]
    _assert_traces_equal(
        p_hybrid.concat_traces(parts(got, p_sim.StageTrace)),
        r_hybrid.concat_traces(parts(want, r_sim.StageTrace)))


# ------------------------------------------------------------ schedule ---

ADMISSIONS = {
    "threshold_defer": dict(ci_high=300.0, ci_low=150.0, max_backlog=500),
    "forecast_window": dict(service_est_s=300.0, step_s=600.0),
}


@pytest.mark.parametrize("policy", list(ADMISSIONS))
@pytest.mark.parametrize("forecaster", ["oracle", "persistence", "diurnal"])
def test_admission_is_bitwise(policy, forecaster):
    out = []
    for sched, sim, data in ((r_sched, r_sim, r_data), (p_sched, p_sim, p_data)):
        reqs = sim.generate(sim.WorkloadConfig(
            n_requests=200, qps=0.05, seed=1, deferrable_frac=0.5,
            deferrable_deadline_s=6 * 3600.0, min_len=64, max_len=512))
        sigs = [data.ci_trace_signal(t, 12.0) for t in ("caiso-evening", "coal")]
        forecast = sched.fleet_ci_forecast(sched.make_forecaster(forecaster),
                                           sigs, "mean")
        stats = sched.apply_admission(reqs, sched.make_admission(
            policy, **ADMISSIONS[policy]), forecast)
        out.append((stats, _rows(reqs), sched.class_stats(reqs)))
    assert out[1] == out[0]


def test_epoch_deferral_is_bitwise():
    from repro.schedule.epochs import epoch_deferral as r_defer
    from repro_torch.schedule.epochs import epoch_deferral as p_defer
    out = []
    for defer, work, sim, sched, data in (
            (r_defer, r_work, r_sim, r_sched, r_data),
            (p_defer, p_work, p_sim, p_sched, p_data)):
        stream = work.generate_stream(sim.WorkloadConfig(
            n_requests=800, qps=0.05, seed=4, deferrable_frac=0.5,
            deferrable_deadline_s=8 * 3600.0))
        bounds = np.arange(0.0, 6 * 86400.0, 1800.0)
        forecast = sched.fleet_ci_forecast(
            sched.make_forecaster("diurnal", swing_frac=0.3),
            [data.ci_trace_signal("caiso", 150.0)], "mean")
        drain, stats = defer(stream, bounds, forecast)
        out.append((drain, stats, stream.ready_s.copy()))
    np.testing.assert_array_equal(out[1][0], out[0][0])
    assert out[1][1] == out[0][1]
    np.testing.assert_array_equal(out[1][2], out[0][2])
