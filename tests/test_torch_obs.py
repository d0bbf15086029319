"""The port's ``obs/`` against the reference, on the CPU.

- Probe neutrality: records and summaries with a probe attached equal the
  probe-off ones bitwise (single-site, fleet and shift scenarios).
- The flight recorder: what it records from the event loop (stages,
  routes, epochs) equals the reference's bitwise; its per-bin Eq. 1
  timelines lie within ``DEVICE_MODE_RTOL`` of the reference's, their
  binning and device counts bitwise.
- The Chrome trace: the same events as the reference's (names, phases,
  tracks, timestamps), numeric arguments within ``DEVICE_MODE_RTOL``.
- The span profiler (parents, request ids, intervals, counts, its
  disabled path, its ranges under ``torch.profiler``), the logger,
  ``obs.diff``'s tolerance ladder and the ``python -m repro_torch.obs`` CLI.
"""
import json
import logging
import math

import numpy as np
import pytest
import torch

import repro.obs.chrometrace as r_trace
import repro.obs.diff as r_diff
import repro.obs.recorder as r_rec
import repro.sweep.runner as r_runner
import repro.sweep.scenarios as r_scen
import repro_torch.obs.chrometrace as p_trace
import repro_torch.obs.diff as p_diff
import repro_torch.obs.recorder as p_rec
import repro_torch.sweep.runner as p_runner
import repro_torch.sweep.scenarios as p_scen
from repro_torch.core.power import DEVICE_MODE_RTOL
from repro_torch.obs import __main__ as obs_cli
from repro_torch.obs.log import configure, get_logger
from repro_torch.obs.probe import NULL_PROBE, MultiProbe, SiteIndexProbe
from repro_torch.obs.spans import _NULL_SPAN, PROFILER, SpanProfiler

CPU = "cpu"


@pytest.fixture(autouse=True)
def _profiler_clean():
    yield
    PROFILER.disable()
    PROFILER.reset()


def _scenario(pkg_scen, sweep, index=0, n_req=10):
    return pkg_scen.SWEEPS[sweep].build(True, n_requests=n_req)[index]


# ------------------------------------------------------ probe neutrality --

@pytest.mark.parametrize("sweep", ["fig1", "fleet", "shift"])
def test_probe_attached_records_bit_identical(sweep):
    scenarios = p_scen.SWEEPS[sweep].build(True, n_requests=10)[:2]
    off = [p_runner.execute_scenario(sc, torch_device=CPU) for sc in scenarios]
    rec = p_rec.FlightRecorder(resolution_s=30.0, torch_device=CPU)
    for probe in (NULL_PROBE, rec, MultiProbe([rec, NULL_PROBE])):
        on = [p_runner.execute_scenario(sc, probe=probe, torch_device=CPU)
              for sc in scenarios]
        assert [r["metrics"] for r in on] == [r["metrics"] for r in off]
        assert [r["key"] for r in on] == [r["key"] for r in off]
    assert rec.n_stage_events > 0 and rec.timelines


def test_probe_rejected_in_device_mode():
    with pytest.raises(ValueError, match="device"):
        p_runner.SweepRunner(mode="device", probe=NULL_PROBE, torch_device=CPU)


def test_site_index_probe_retags_every_hook():
    rec = p_rec.FlightRecorder(torch_device=CPU)
    wrapped = SiteIndexProbe(rec, site=3)
    wrapped.on_route(1.0, 7, 0)
    wrapped.on_scale(2.0, 0, 2, 1, "up_warm")
    wrapped.on_requests(np.array([0.0, 1.0]), np.array([0.0, 5.0]))
    assert rec.route_table()["site"].tolist() == [3]
    assert rec.scales[0]["site"] == 3
    assert rec.backlog_series()[1].tolist() == [1, 0]


# ------------------------------------------------------- flight recorder --

def _record(pkg_runner, pkg_rec, sc, **kw):
    rec = pkg_rec.FlightRecorder(resolution_s=30.0, **kw)
    extra = {"torch_device": CPU} if kw else {}
    record = pkg_runner.execute_scenario(sc, probe=rec, **extra)
    return rec, record


@pytest.fixture(scope="module", params=[("fleet", 1), ("fig1", 0)],
                ids=["fleet", "fig1"])
def recorded(request):
    """One scenario recorded by both packages' recorders and profilers."""
    sweep, index = request.param
    out = {}
    for name, runner, rec_mod, scen, prof, kw in (
            ("ref", r_runner, r_rec, r_scen, r_trace, {}),
            ("port", p_runner, p_rec, p_scen, p_trace, {"torch_device": CPU})):
        rec, record = _record(runner, rec_mod, _scenario(scen, sweep, index), **kw)
        out[name] = (rec, record, prof.chrome_trace_events(rec))
    return out


def test_recorder_series_match_reference(recorded):
    ref, port = recorded["ref"][0], recorded["port"][0]
    assert port.counts() == ref.counts()
    for table in ("stage_table", "route_table"):
        want, got = getattr(ref, table)(), getattr(port, table)()
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for want, got in zip(ref.backlog_series(), port.backlog_series()):
        np.testing.assert_array_equal(got, want)
    assert port.scales == ref.scales and port.epochs == ref.epochs


def test_recorder_timelines_match_reference(recorded):
    ref, port = recorded["ref"][0], recorded["port"][0]
    assert port.timelines.keys() == ref.timelines.keys() and ref.timelines
    for site, want in ref.timelines.items():
        got = port.timelines[site]
        assert got.keys() == want.keys()
        for k, v in want.items():
            if k in ("power_w", "energy_wh", "carbon_g"):   # through Eq. 1
                np.testing.assert_allclose(got[k], v, rtol=DEVICE_MODE_RTOL,
                                           atol=0, err_msg=k)
            elif isinstance(v, np.ndarray):
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                assert got[k] == v, k


def _close(a, b) -> bool:
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, float) and isinstance(b, float):
        return a == b or abs(a - b) <= DEVICE_MODE_RTOL * max(abs(a), abs(b))
    return a == b


def test_chrome_trace_events_match_reference(recorded):
    want, got = recorded["ref"][2], recorded["port"][2]
    assert len(got) == len(want) > 0
    for e_got, e_want in zip(got, want):
        assert {k: v for k, v in e_got.items() if k != "args"} \
            == {k: v for k, v in e_want.items() if k != "args"}
        assert _close(e_got.get("args"), e_want.get("args")), (e_got, e_want)


def test_trace_and_csv_files(tmp_path, recorded):
    rec = recorded["port"][0]
    PROFILER.enable(reset=True)
    with PROFILER.span("outer"):
        with PROFILER.span("inner"):
            pass
    PROFILER.disable()
    info = p_trace.write_chrome_trace(tmp_path / "t.json", rec, PROFILER)
    payload = json.loads((tmp_path / "t.json").read_text())
    assert len(payload["traceEvents"]) == info["n_events"] > 0
    ts = [e["ts"] for e in payload["traceEvents"] if e["ph"] != "M"]
    assert ts == sorted(ts)
    names = {p.name for p in p_trace.write_csvs(tmp_path / "csv", rec, PROFILER)}
    assert {"stages.csv", "routes.csv", "spans.csv"} <= names
    header = (tmp_path / "csv" / "stages.csv").read_text().splitlines()[0]
    assert tuple(header.split(",")) == p_rec.STAGE_FIELDS


def test_column_builder_grows_and_casts():
    cb = p_rec.ColumnBuilder(("t", "n"), int_fields=("n",), capacity=2)
    for i in range(40):
        cb.append(0.5 * i, i)
    out = cb.build()
    assert out["n"].dtype == np.int64 and out["n"].tolist() == list(range(40))
    np.testing.assert_array_equal(out["t"], 0.5 * np.arange(40))


# ---------------------------------------------------- profiler and logger --

def test_span_profiler_nesting_aggregate_and_merge(tmp_path):
    prof = SpanProfiler()
    with prof.span("off"):
        pass
    assert prof.spans() == []
    prof.enable()
    with prof.span("outer"):
        for _ in range(3):
            with prof.span("inner"):
                pass
    names = [(n, depth) for n, _, _, depth in prof.spans()]
    assert names[0] == ("outer", 0) and names.count(("inner", 1)) == 3
    other = SpanProfiler()
    other.enable()
    with other.span("inner"):
        pass
    other.write_aggregate(tmp_path / "agg.json")
    prof.merge_file(tmp_path / "agg.json")
    agg = prof.aggregate()
    assert agg["inner"]["count"] == 4 and agg["outer"]["count"] == 1
    assert "inner" in prof.format_aggregate()


def test_span_parent_request_interval_and_counts():
    prof = SpanProfiler()
    prof.enable()
    with prof.span("serve.decode", rows=3) as outer:
        with prof.span("model.moe"):
            with prof.span("trace.count"):
                kept = torch.tensor([1, 0, 1]).sum()
            prof.count(kept=kept, d_model=8)
        prof.record("serve.queued", 1.0, 2.5, rid=7)
    with prof.span("serve.prefill", rid=7, prompt=12):
        pass
    prof.record("serve.queued", 3.0, 4.0, rid=8)
    recs = prof.records()
    assert [r.name for r in recs] == ["serve.decode", "model.moe", "trace.count",
                                     "serve.queued", "serve.prefill",
                                     "serve.queued"]
    by_sid = {r.sid: r for r in recs}
    parents = [None if r.parent is None else by_sid[r.parent].name for r in recs]
    assert parents == [None, "serve.decode", "model.moe", "serve.decode", None,
                       None]
    assert [r.depth for r in recs] == [0, 1, 2, 1, 0, 0]
    assert outer.counts == {"rows": 3}
    # a device tensor is kept as it is until the spans are read
    assert isinstance(prof._records[1].counts["kept"], torch.Tensor)
    assert recs[1].counts == {"kept": 2, "d_model": 8}
    assert type(recs[1].counts["kept"]) is int
    assert (recs[3].t0, recs[3].t1, recs[3].rid) == (1.0, 2.5, 7)
    assert recs[4].rid == 7 and recs[4].counts == {"prompt": 12}
    assert all(r.t0 <= r.t1 for r in recs)
    assert recs[0].t0 <= recs[1].t0 <= recs[2].t0 <= recs[2].t1 <= recs[1].t1


def test_disabled_profiler_returns_the_null_span_and_records_nothing():
    prof = SpanProfiler()
    assert prof.span("serve.decode", rid=1, rows=2) is _NULL_SPAN
    with prof.span("model.moe") as s:
        prof.count(kept=3)
        prof.record("serve.queued", 0.0, 1.0, rid=1)
    assert s is _NULL_SPAN
    assert prof.records() == [] and prof.spans() == [] and prof.aggregate() == {}
    prof.enable()
    prof.count(kept=3)          # no span open: nothing to add to
    prof.disable()
    assert prof.records() == []


def test_aggregate_is_unchanged_by_request_ids_and_counts():
    """The sweep pipeline's reading: per name a count and a total, whatever
    else the spans carry; ``spans()`` keeps its (name, t0, dur, depth)."""
    plain, rich = SpanProfiler(), SpanProfiler()
    plain.enable()
    rich.enable()
    for prof, kw in ((plain, {}), (rich, {"rid": 4, "rows": 2})):
        with prof.span("cache.lookup", **kw):
            with prof.span("sim.event_loop"):
                prof.count(kept=1)
    agg_plain, agg_rich = plain.aggregate(), rich.aggregate()
    assert {n: a["count"] for n, a in agg_plain.items()} == \
        {n: a["count"] for n, a in agg_rich.items()} == \
        {"cache.lookup": 1, "sim.event_loop": 1}
    assert all(set(a) == {"count", "total_s"} for a in agg_rich.values())
    assert [(n, d) for n, _, _, d in rich.spans()] == \
        [("cache.lookup", 0), ("sim.event_loop", 1)]


def test_spans_appear_among_the_profilers_host_events():
    """Enabled, each span begun under a profiler session is a
    ``record_function`` range on the profiler's clock, and only such a
    span enters one; disabled, none is."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(8, 8)

    def names(enabled):
        prof = SpanProfiler()
        if enabled:
            prof.enable()
        with profile(activities=[ProfilerActivity.CPU]) as tp:
            with prof.span("serve.decode"):
                with prof.span("model.moe"):
                    x @ x
        return {e.name: e for e in tp.events()}

    on = names(True)
    assert on["serve.decode"].is_user_annotation
    outer, inner = on["serve.decode"].time_range, on["model.moe"].time_range
    assert outer.start <= inner.start <= on["aten::mm"].time_range.start
    assert on["aten::mm"].time_range.end <= inner.end <= outer.end
    off = names(False)
    assert "aten::mm" in off and not {"serve.decode", "model.moe"} & set(off)
    prof = SpanProfiler()
    prof.enable()
    with prof.span("serve.decode") as outside:
        assert outside._rf is None


def test_logger_namespacing_and_verbosity(capsys):
    import io
    stream = io.StringIO()
    root = configure(verbosity=1, stream=stream)
    assert root.name == "repro_torch" and root.level == logging.DEBUG
    log = get_logger("sweep")
    assert log.name == "repro_torch.sweep"
    log.debug("hello %d", 3)
    assert "hello 3" in stream.getvalue()
    assert configure(verbosity=-1, stream=stream).level == logging.WARNING


# --------------------------------------------------------------- diff ---

def test_tolerance_contracts_mirror_the_reference():
    ref = r_diff.tolerance_contracts()
    port = p_diff.tolerance_contracts()
    rename = {"JAX_BACKEND_RTOL": "TORCH_BACKEND_RTOL"}
    assert [rename.get(n, n) for n, _ in ref] == [n for n, _ in port]
    assert [v for _, v in ref] == [v for _, v in port]
    assert p_diff.classify(0.0) == "host-bitwise"
    assert p_diff.classify(1e-7) == "DEVICE_MODE_RTOL"
    assert p_diff.classify(8e-6) == "TORCH_BACKEND_RTOL"
    assert p_diff.classify(math.inf) == "regression"


def test_diff_records_matches_the_reference_explainer():
    """Both explainers walk and classify the same divergent record sets
    alike (the port's Eq. 1 on the CPU against the reference's)."""
    scs_r = r_scen.SWEEPS["fig4"].build(True, n_requests=16)
    scs_p = p_scen.SWEEPS["fig4"].build(True, n_requests=16)
    a = [r_runner.execute_scenario(sc) for sc in scs_r]
    b = [p_runner.execute_scenario(sc, torch_device=CPU) for sc in scs_p]
    want, got = r_diff.diff_records(a, b), p_diff.diff_records(a, b)
    assert not got.has_regression and not got.only_a and not got.only_b
    assert [(c.scenario, c.column, c.contract) for c in got.cells] \
        == [(c.scenario, c.column, c.contract) for c in want.cells]
    assert got.n_compared == want.n_compared


# ------------------------------------------------------------------ CLI ---

def test_obs_cli_list_record_and_diff(tmp_path, capsys):
    assert obs_cli.main(["list", "--smoke"]) == 0
    assert "fig1" in capsys.readouterr().out
    out = tmp_path / "fig1.json"
    assert obs_cli.main(["--quiet", "record", "fig1", "--smoke",
                         "--n-requests", "8", "--torch-device", CPU,
                         "--out", str(out), "--csv-dir",
                         str(tmp_path / "csv")]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["stage_events"] > 0 and summary["has_carbon_timeline"]
    assert json.loads(out.read_text())["traceEvents"]
    recs = p_scen.run_sweep("fig1", smoke=True, n_requests=8,
                            torch_device=CPU)[0]
    for name in ("a", "b"):
        (tmp_path / f"{name}.json").write_text(json.dumps(recs))
    assert obs_cli.main(["--quiet", "diff", str(tmp_path / "a.json"),
                         str(tmp_path / "b.json"), "--report-dir",
                         str(tmp_path / "rep")]) == 0
    assert "identical" in capsys.readouterr().out
    assert obs_cli.main(["--quiet", "record", "nope", "--torch-device",
                         CPU]) == 2
