"""The port's physics-invariant auditor (``repro_torch.obs.audit``) against
the reference's (``repro.obs.audit``), on the CPU.

- The injected-violation streams of ``tests/test_audit.py`` go through both
  auditors: the same synthetic schedulers, requests, traces and loads, and
  the same reports (``to_dict``, ``summary``, every violation's
  ``format`` and ``to_markdown``).
- The port's auditor takes torch tensors at its hooks and reports as the
  reference does on the same numbers as numpy arrays.
- The ``fig1``, ``fleet`` and ``shift`` smoke sweeps (event loop) and the
  day simulation, each package with its own auditor: the port's records
  with and without its auditor are bit-identical, both reports are clean,
  and they observed the same runs and counted the same checks.
- ``python -m repro_torch.sweep.cli --audit`` on the CPU.
"""
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.obs.audit as r_audit
import repro_torch.obs.audit as p_audit
from repro.fleet.day import run_fleet_day as r_run_fleet_day
from repro.sweep import SWEEPS as R_SWEEPS
from repro.sweep import SweepRunner as RSweepRunner
from repro_torch.configs.paper_models import LLAMA3_8B
from repro_torch.core.power import PowerModel
from repro_torch.fleet.config import FleetConfig, SiteConfig
from repro_torch.fleet.day import run_fleet_day as p_run_fleet_day
from repro_torch.obs.probe import MultiProbe
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.sim.hybrid import DayConfig
from repro_torch.sim.requests import WorkloadConfig
from repro_torch.sim.scheduler import SchedulerConfig
from repro_torch.sweep import SWEEPS as P_SWEEPS
from repro_torch.sweep import SweepRunner as PSweepRunner

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"


def test_contracts_and_tolerances_match_reference():
    assert p_audit.CONTRACTS == r_audit.CONTRACTS
    for name in ("EQ23_CLOSURE_RTOL", "EQ45_CLOSURE_RTOL",
                 "POWER_RANGE_RTOL"):
        assert getattr(p_audit, name) == getattr(r_audit, name)


# ---------------------------------------------------------------------------
# synthetic hook streams (tests/test_audit.py's), fed to both auditors
# ---------------------------------------------------------------------------

def _sched(kv=0, budget=4096, cap=64, running=0):
    in_flight = tuple(range(running))

    class _Cfg:
        kv_budget_tokens = budget
        batch_cap = cap

    class _S:
        cfg = _Cfg()
        kv_tokens = kv
        waiting = ()
        running = in_flight
    return _S()


class _Req:
    def __init__(self, rid, arrival=0.0, ready=0.0, first=0.1, done=0.2,
                 prefill=8, decode=8, prefill_done=None, decoded=None):
        self.rid = rid
        self.arrival_s = arrival
        self.ready_s = ready
        self.release_s = ready
        self.t_first_token = first
        self.t_done = done
        self.prefill_tokens = prefill
        self.decode_tokens = decode
        self.prefill_done = prefill if prefill_done is None else prefill_done
        self.decoded = decode if decoded is None else decoded


class _Trace:
    def __init__(self, mfu, dur_s, start_s=None, batch_size=None,
                 n_prefill_tokens=None, n_decode_tokens=None,
                 replica=None):
        self.mfu = np.asarray(mfu, np.float64)
        self.dur_s = np.asarray(dur_s, np.float64)
        self.start_s = (None if start_s is None
                        else np.asarray(start_s, np.float64))
        self.batch_size = (None if batch_size is None
                           else np.asarray(batch_size, np.float64))
        self.n_prefill_tokens = (
            None if n_prefill_tokens is None
            else np.asarray(n_prefill_tokens, np.float64))
        self.n_decode_tokens = (
            None if n_decode_tokens is None
            else np.asarray(n_decode_tokens, np.float64))
        self.replica = (None if replica is None
                        else np.asarray(replica, np.float64))

    def __len__(self):
        return len(self.mfu)


class _Load:
    def __init__(self, times, values):
        self.times = np.asarray(times, np.float64)
        self.values = np.asarray(values, np.float64)


def _stage(probe, t_s, site=0, replica=0, sched=None, prefill=32,
           decode=4, batch=4):
    probe.on_stage(t_s, 0.05, site, replica, sched or _sched(),
                   prefill, decode, batch)


def _begin(A, **kw):
    p = A.AuditProbe(**kw)
    p.on_run_begin("synthetic")
    return p


# each stream drives fresh auditors of module A and returns the reports
# to compare, snapshots included, and the contract of the first
# violation it must show (None: clean)

def s_shuffled_stage_order(A):
    p = _begin(A)
    _stage(p, 1.0)
    _stage(p, 0.5)
    return [p.report()], "clock-monotonic"


def s_decoupled_replica_clocks(A):
    p = _begin(A)
    _stage(p, 1.0, replica=0)
    _stage(p, 0.5, replica=1)
    return [p.report()], None


def s_epoch_eval_resets_floor(A):
    p = _begin(A)
    _stage(p, 100.0, site=0)
    p.on_epoch_eval(0, None)
    _stage(p, 10.0, site=0)
    return [p.report()], None


def s_kv_budget_breach(A):
    p = _begin(A)
    _stage(p, 0.0)
    _stage(p, 1.0, sched=_sched(kv=5000, budget=4096))
    return [p.report()], "kv-budget"


def s_kv_budget_decode_growth(A):
    sched = _sched(kv=4100, budget=4096)
    sched.running = (_Req(0, decoded=3), _Req(1, decoded=2))
    p = _begin(A)
    _stage(p, 0.0, sched=sched)
    clean = p.report()
    sched.running = (_Req(0, decoded=3),)
    _stage(p, 1.0, sched=sched)
    return [clean, p.report()], "kv-budget"


def s_batch_cap_breach(A):
    p = _begin(A)
    _stage(p, 0.0, sched=_sched(cap=8), batch=4)
    p.on_site_rollup(0, "synthetic",
                     _Trace([0.3, 0.4], [0.05, 0.05],
                            start_s=[0.0, 0.1], batch_size=[4, 9]),
                     "a100", 1)
    return [p.report()], "batch-cap"


def s_dropped_request(A):
    p = _begin(A)
    for rid in range(4):
        p.on_route(0.1 * rid, rid, site=0)
    p.on_requests(np.zeros(5), np.zeros(5))
    return [p.report()], "request-conservation"


def s_duplicate_route(A):
    p = _begin(A)
    p.on_route(0.0, 7, site=0)
    p.on_route(0.1, 7, site=1)
    return [p.report()], "request-conservation"


def s_route_order_regression(A):
    p = _begin(A)
    p.on_route(1.0, 0, site=0)
    p.on_route(0.5, 1, site=0)
    return [p.report()], "clock-monotonic"


def s_completions_exceed_admissions(A):
    p = _begin(A)
    p.on_route(0.0, 0, site=0)
    _stage(p, 0.1)
    p.on_complete(0.2, 0, 0, [_Req(0), _Req(1)])
    return [p.report()], "request-conservation"


def s_lifecycle_partial_decode(A):
    p = _begin(A)
    _stage(p, 0.0)
    p.on_complete(0.2, 0, 0, [_Req(0, decode=8, decoded=5)])
    return [p.report()], "request-lifecycle"


def s_token_conservation(A):
    p = _begin(A)
    _stage(p, 0.0, prefill=8, decode=2)
    p.on_complete(0.1, 0, 0, [_Req(0, prefill=8, decode=8)])
    p.on_site_rollup(0, "synthetic",
                     _Trace([0.3], [0.05], start_s=[0.0],
                            n_prefill_tokens=[8], n_decode_tokens=[2]),
                     "a100", 1)
    return [p.report()], "token-conservation"


def s_autoscale_illegal(A):
    p = _begin(A)
    p.on_scale(0.0, 0, 2, 1, "up_warm")
    p.on_scale(1.0, 0, 4, 0, "up_cold")
    p2 = _begin(A)
    p2.on_scale(0.0, 0, 1, 0, "teleport")
    return [p.report(), p2.report()], "autoscale-legality"


def s_admission_before_arrival(A):
    p = _begin(A)
    p.on_requests(np.array([1.0, 2.0]), np.array([1.0, 1.5]))
    return [p.report()], "admission-legality"


def s_mfu_out_of_range(A):
    p = _begin(A)
    p.on_site_rollup(0, "s0", _Trace([0.3, 1.5, 0.2], [1.0, 1.0, 1.0]),
                     "a100", 8)
    return [p.report()], "mfu-range"


def _eq23_energy(mfu, dur):
    p_w = PowerModel("a100", torch_device=CPU).power(
        np.asarray(mfu)).numpy().astype(np.float64)
    return float(np.sum(p_w * np.asarray(dur) * 8 * 1.2 / 3600.0))


def s_eq23_closure(A):
    mfu, dur = [0.2, 0.5, 0.4], [1.0, 2.0, 0.5]
    wh = _eq23_energy(mfu, dur)
    p = _begin(A)
    p.on_site_rollup(0, "s0", _Trace(mfu, dur), "a100", 8, pue=1.2,
                     energy_wh=wh)
    clean = p.report()
    p.on_site_rollup(0, "s0", _Trace(mfu, dur), "a100", 8, pue=1.2,
                     energy_wh=wh * 1.01)
    return [clean, p.report()], "eq23-closure"


def s_eq45_closure(A):
    times = np.arange(0.0, 600.0, 60.0)
    vals = np.full(len(times), 1000.0)
    e_kwh = float(vals.sum()) * 60.0 / 3600.0 / 1000.0
    kg = float(np.sum(vals * 400.0)) * 60.0 / 3600.0 / 1e6
    cosim = {"total_energy_kwh": e_kwh, "total_emissions_nosolar_kg": kg}
    p = _begin(A)
    p.on_site_rollup(0, "s0", _Trace([], []), "a100", 8, ci=400.0,
                     cosim=dict(cosim), load=_Load(times, vals))
    clean = p.report()
    bad = dict(cosim)
    bad["total_energy_kwh"] = e_kwh * (1.0 + 10 * A.EQ45_CLOSURE_RTOL)
    p.on_site_rollup(0, "s0", _Trace([], []), "a100", 8, ci=400.0,
                     cosim=bad, load=_Load(times, vals))
    return [clean, p.report()], "eq45-closure"


def s_strict_mode(A):
    p = _begin(A, strict=True)
    _stage(p, 1.0)
    with pytest.raises(A.AuditError) as ei:
        _stage(p, 0.5)
    assert isinstance(ei.value, AssertionError)
    # the raise is the report's one violation, as it reads
    assert str(ei.value) == ei.value.violation.format()
    return [p.report()], "clock-monotonic"


def s_max_per_contract(A):
    p = _begin(A, max_per_contract=2)
    for k in range(5):
        _stage(p, 0.1 * k, sched=_sched(kv=9999, budget=4096))
    return [p.report()], "kv-budget"


def s_report_serialization(A):
    p = _begin(A)
    _stage(p, 1.0)
    _stage(p, 0.5)
    return [p.report()], "clock-monotonic"


STREAMS = [s_shuffled_stage_order, s_decoupled_replica_clocks,
           s_epoch_eval_resets_floor, s_kv_budget_breach,
           s_kv_budget_decode_growth, s_batch_cap_breach, s_dropped_request,
           s_duplicate_route, s_route_order_regression,
           s_completions_exceed_admissions, s_lifecycle_partial_decode,
           s_token_conservation, s_autoscale_illegal,
           s_admission_before_arrival, s_mfu_out_of_range, s_eq23_closure,
           s_eq45_closure, s_strict_mode, s_max_per_contract,
           s_report_serialization]


def _in_port_words(text: str) -> str:
    """The reference's report text as the port words it: the Eq. 4-5
    carbon detail names the caller's split of the carbon, where the
    reference says "driver split". Nothing else differs."""
    return text.replace("driver split:", "caller split:")


def assert_same_report(got, want):
    want_dict = json.loads(_in_port_words(json.dumps(want.to_dict())))
    assert got.to_dict() == want_dict
    assert got.summary() == _in_port_words(want.summary())
    assert got.to_markdown() == _in_port_words(want.to_markdown())
    assert [v.format() for v in got.violations] == \
        [_in_port_words(v.format()) for v in want.violations]


@pytest.mark.parametrize("stream", STREAMS, ids=lambda f: f.__name__[2:])
def test_synthetic_stream_reports_match_reference(stream):
    want, first = stream(r_audit)
    got, first_p = stream(p_audit)
    assert first_p == first
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_same_report(g, w)
    # the stream showed what it was built to show, in both packages
    last = got[-1]
    if first is None:
        assert last.ok
    else:
        assert last.first.contract == first
    assert set(last.checks) <= set(p_audit.CONTRACTS)


def _tensor_trace(trace):
    out = _Trace([], [])
    for k, v in vars(trace).items():
        setattr(out, k, None if v is None else torch.as_tensor(v))
    return out


def test_tensors_at_the_hooks_read_as_the_reference_reads_arrays():
    """Trace columns, the load signal, the co-sim totals, the Eq. 2-3
    energy and the request arrays handed over as torch tensors give the
    port's auditor the report the reference gives on numpy arrays; the
    tensors are left as they were."""
    mfu, dur = [0.2, 0.5, 0.4, 1.2], [1.0, 2.0, 0.5, 0.25]
    trace = _Trace(mfu, dur, start_s=[0.0, 0.1, 0.05, 0.3],
                   batch_size=[4, 9, 2, 3], n_prefill_tokens=[8, 0, 4, 0],
                   n_decode_tokens=[2, 2, 2, 2], replica=[0, 0, 1, 0])
    times = np.arange(0.0, 600.0, 60.0)
    vals = np.linspace(800.0, 1200.0, len(times))
    cosim = {"total_energy_kwh": 0.17, "total_emissions_nosolar_kg": 0.07}
    wh = _eq23_energy(mfu, dur)

    def drive(A, as_tensors):
        p = _begin(A)
        for t in (0.0, 0.1, 0.3):
            _stage(p, t, sched=_sched(cap=8))
        p.on_complete(0.4, 0, 0, [_Req(0, prefill=16, decode=4)])
        conv = (lambda x: torch.as_tensor(x)) if as_tensors else (lambda x: x)
        tr = _tensor_trace(trace) if as_tensors else trace
        load = _Load(times, vals)
        if as_tensors:
            load.times, load.values = conv(times), conv(vals)
        p.on_requests(conv(np.array([1.0, 2.0])), conv(np.array([1.0, 1.5])))
        p.on_site_rollup(0, "s0", tr, "a100", 8, pue=1.2, ci=400.0,
                         energy_wh=conv(np.float64(wh * 1.001)),
                         cosim={k: conv(np.float64(v))
                                for k, v in cosim.items()}, load=load)
        return p.report(), tr

    want, _ = drive(r_audit, False)
    got, tr = drive(p_audit, True)
    assert_same_report(got, want)
    assert not got.ok and len(got.by_contract()) >= 4
    np.testing.assert_array_equal(tr.mfu.numpy(), np.asarray(mfu))


# ---------------------------------------------------------------------------
# the smoke sweeps and the day simulation, each package with its auditor
# ---------------------------------------------------------------------------

def _assert_records_bit_identical(off, on):
    assert len(off) == len(on)
    for a, b in zip(off, on):
        assert (a["scenario"], a["params"], a["key"]) == \
            (b["scenario"], b["params"], b["key"])
        assert a["metrics"] == b["metrics"], a["scenario"]


CORE = {"clock-monotonic", "kv-budget", "batch-cap", "request-conservation",
        "request-lifecycle", "token-conservation", "admission-legality",
        "mfu-range", "power-range", "eq23-closure"}


@pytest.mark.parametrize("sweep,n_req", [("fig1", 16), ("fleet", 10),
                                         ("shift", 10)])
def test_sweep_audits_clean_with_the_references_checks(sweep, n_req):
    ref = r_audit.AuditProbe()
    RSweepRunner(cache=None, mode="event_loop", probe=ref).run(
        R_SWEEPS[sweep].build(True, n_requests=n_req))
    scenarios = P_SWEEPS[sweep].build(True, n_requests=n_req)
    auditor = p_audit.AuditProbe()
    off, _ = PSweepRunner(cache=None, mode="event_loop",
                          torch_device=CPU).run(scenarios)
    on, _ = PSweepRunner(cache=None, mode="event_loop", probe=auditor,
                         torch_device=CPU).run(scenarios)
    _assert_records_bit_identical(off, on)
    got, want = auditor.report(), ref.report()
    assert got.ok, got.summary()
    assert want.ok, want.summary()
    assert got.runs == want.runs == len(scenarios)
    assert got.checks == want.checks
    assert CORE <= set(got.checks)
    if sweep == "shift":
        assert got.checks.get("eq45-closure", 0) > 0


def day_cfg(pkg, n=1200, span=900.0):
    """tests/test_audit.py's day config, built from ``pkg``'s classes."""
    wl = pkg["WorkloadConfig"](
        n_requests=n, qps=n / span, min_len=192, max_len=192, seed=0,
        envelope="sinusoidal", envelope_amplitude=0.3,
        envelope_period_h=span / 3600.0, burst_gain=2.5,
        burst_mean_s=span / 15.0, burst_idle_mean_s=span / 2.5)
    return pkg["FleetConfig"](
        model=pkg["LLAMA3_8B"],
        sites=(pkg["SiteConfig"](
            name="s0", ci_trace="caiso-night",
            scheduler=pkg["SchedulerConfig"](batch_cap=64)),),
        workload=wl, router="round_robin",
        day=pkg["DayConfig"](mode="hybrid", epoch_s=300.0,
                             pilot_requests=128, warmup_requests=32,
                             util_threshold=0.6))


def _reference_day_classes():
    from repro.configs.paper_models import LLAMA3_8B as R_LLAMA
    from repro.fleet.config import FleetConfig as RF, SiteConfig as RS
    from repro.sim.hybrid import DayConfig as RD
    from repro.sim.requests import WorkloadConfig as RW
    from repro.sim.scheduler import SchedulerConfig as RSC
    return dict(WorkloadConfig=RW, FleetConfig=RF, SiteConfig=RS,
                SchedulerConfig=RSC, DayConfig=RD, LLAMA3_8B=R_LLAMA)


PORT_DAY = dict(WorkloadConfig=WorkloadConfig, FleetConfig=FleetConfig,
                SiteConfig=SiteConfig, SchedulerConfig=SchedulerConfig,
                DayConfig=DayConfig, LLAMA3_8B=LLAMA3_8B)


def test_day_audits_clean_with_the_references_checks():
    ref = r_audit.AuditProbe()
    r_run_fleet_day(day_cfg(_reference_day_classes()), probe=ref)
    cfg = day_cfg(PORT_DAY)
    auditor = p_audit.AuditProbe()
    off = p_run_fleet_day(cfg, torch_device=CPU).summary()
    on = p_run_fleet_day(cfg, probe=auditor, torch_device=CPU).summary()
    assert off == on
    got, want = auditor.report(), ref.report()
    assert got.ok, got.summary()
    assert want.ok, want.summary()
    assert got.checks == want.checks and got.runs == want.runs
    assert got.checks.get("clock-monotonic", 0) > 0
    assert got.checks.get("eq45-closure", 0) > 0


def test_multiprobe_stacks_recorder_and_auditor():
    scenarios = P_SWEEPS["fig1"].build(True, n_requests=12)
    rec = FlightRecorder(resolution_s=30.0, torch_device=CPU)
    auditor = p_audit.AuditProbe()
    off, _ = PSweepRunner(cache=None, mode="event_loop",
                          torch_device=CPU).run(scenarios)
    on, _ = PSweepRunner(cache=None, mode="event_loop", torch_device=CPU,
                         probe=MultiProbe([rec, auditor])).run(scenarios)
    _assert_records_bit_identical(off, on)
    assert rec.n_stage_events > 0
    assert auditor.report().ok and auditor.report().n_checks > 0


def test_sweep_cli_audit_flag_clean_run(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.sweep.cli", "fig1", "--smoke",
         "--n-requests", "8", "--no-cache", "--audit", "--quiet",
         "--torch-device", CPU, "--out", str(tmp_path / "out")],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr
    assert "audit: clean" in out.stdout
    assert not (tmp_path / "results").exists()     # no report when clean


def test_sweep_cli_audit_violation_writes_report_and_exits_1(
        tmp_path, monkeypatch, capsys):
    """A violation (an Eq. 2-3 total scaled by the injected bound)
    writes ``audit.md`` under the port's divergence directory and makes
    the CLI exit 1."""
    from repro_torch.sweep import cli
    real = p_audit.AuditProbe.on_site_rollup

    def scaled(self, *args, energy_wh=None, **kw):
        if energy_wh is not None:
            energy_wh = energy_wh * 1.01
        return real(self, *args, energy_wh=energy_wh, **kw)

    monkeypatch.setattr(p_audit.AuditProbe, "on_site_rollup", scaled)
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["fig1", "--smoke", "--n-requests", "8", "--no-cache",
                   "--audit", "--quiet", "--torch-device", CPU,
                   "--out", str(tmp_path / "out")])
    assert rc == 1
    report = tmp_path / "results" / "torch" / "obs" / "divergence" / "audit.md"
    assert "eq23-closure" in report.read_text()
    assert "audit FAILED" in capsys.readouterr().err
