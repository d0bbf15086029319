"""Chrome trace-event JSON + tidy CSV export for the dual clocks.

One trace file carries both clocks as separate process tracks, viewable
in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``:

* **pid 1 — wall-clock**: the ``SpanProfiler``'s nested spans as
  paired ``B``/``E`` duration events (ts = µs since the profiler
  origin);
* **pid 50 — admission/routing (sim-time)**: the deferral backlog as a
  counter track plus per-request routing instants (capped — see
  ``max_instants``);
* **pid 100+site — sim-time, one process per site**: stage iterations
  as ``X`` complete events on per-replica threads, per-replica queue
  depth / running set / KV-token / batch-occupancy counters, the
  Eq. 1-5 power/CI/carbon timeline counters, autoscaler instants with
  active/warm counters, and the day simulation's epoch windows on a
  dedicated thread.

Sim-time seconds map to trace µs one-to-one (1 sim second = 1e6 ts
units), so both clocks read naturally in the same UI without unit
gymnastics. Events are sorted by ``ts`` (``E`` before ``B`` on ties)
— the monotonicity + pairing contract tests/test_torch_obs.py pins.
"""
from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import List, Optional

WALL_PID = 1
ADMISSION_PID = 50
SITE_PID_BASE = 100
EPOCH_TID = 999

#: route instants beyond this count are dropped from the trace (the
#: backlog counter still covers the full stream); CSV export is uncapped
DEFAULT_MAX_INSTANTS = 5000


def _meta(pid: int, name: str, tid: Optional[int] = None) -> dict:
    if tid is None:
        return {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": name}}
    return {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": name}}


def _counter(pid: int, name: str, ts: float, **values) -> dict:
    return {"ph": "C", "name": name, "pid": pid, "tid": 0, "ts": ts,
            "args": values}


def chrome_trace_events(recorder=None, profiler=None,
                        max_instants: int = DEFAULT_MAX_INSTANTS
                        ) -> List[dict]:
    """Assemble the sorted Chrome trace-event list from either clock
    (both optional)."""
    meta: List[dict] = []
    events: List[dict] = []

    if profiler is not None:
        meta.append(_meta(WALL_PID, "wall-clock (sweep pipeline)"))
        meta.append(_meta(WALL_PID, "spans", tid=1))
        spans = profiler.spans()
        # B events in (start, depth) order so equal-ts parents precede
        # children; E events in (end, -depth) order so children close
        # first — the stable ts sort below preserves both
        for name, t0, dur, depth in sorted(
                spans, key=lambda s: (s[1], s[3])):
            events.append({"ph": "B", "name": name, "pid": WALL_PID,
                           "tid": 1, "ts": t0 * 1e6})
        for name, t0, dur, depth in sorted(
                spans, key=lambda s: (s[1] + s[2], -s[3])):
            events.append({"ph": "E", "name": name, "pid": WALL_PID,
                           "tid": 1, "ts": (t0 + dur) * 1e6})

    if recorder is not None:
        stages = recorder.stage_table()
        site_ids = sorted(
            set(int(s) for s in stages["site"])
            | set(recorder.timelines)
            | set(ev["site"] for ev in recorder.epochs)
            | set(ev["site"] for ev in recorder.scales))
        for s in site_ids:
            tl = recorder.timelines.get(s)
            label = f"sim-time site {s}" + \
                (f" ({tl['name']})" if tl else "")
            meta.append(_meta(SITE_PID_BASE + s, label))
            meta.append(_meta(SITE_PID_BASE + s, "epochs", tid=EPOCH_TID))

        n = len(stages["t_s"])
        for k in range(n):
            pid = SITE_PID_BASE + int(stages["site"][k])
            rep = int(stages["replica"][k])
            ts = float(stages["t_s"][k]) * 1e6
            events.append({
                "ph": "X", "name": "stage", "pid": pid, "tid": rep,
                "ts": ts, "dur": float(stages["dur_s"][k]) * 1e6,
                "args": {"batch": int(stages["batch_size"][k]),
                         "prefill_tokens":
                             int(stages["n_prefill_tokens"][k]),
                         "decode_tokens":
                             int(stages["n_decode_tokens"][k])}})
            events.append(_counter(
                pid, f"queue r{rep}", ts,
                waiting=int(stages["queue_depth"][k]),
                running=int(stages["n_running"][k])))
            events.append(_counter(
                pid, f"batch r{rep}", ts,
                batch=int(stages["batch_size"][k])))
            events.append(_counter(
                pid, f"kv_tokens r{rep}", ts,
                kv=int(stages["kv_tokens"][k])))

        for s, tl in sorted(recorder.timelines.items()):
            pid = SITE_PID_BASE + s
            t_us = tl["t_s"] * 1e6
            for k in range(len(tl["t_s"])):
                events.append(_counter(pid, "power_w", float(t_us[k]),
                                       power_w=float(tl["power_w"][k])))
                events.append(_counter(pid, "devices", float(t_us[k]),
                                       devices=float(tl["devices"][k])))
                if "carbon_g" in tl:
                    events.append(_counter(
                        pid, "ci_g_per_kwh", float(t_us[k]),
                        ci=float(tl["ci_g_per_kwh"][k])))
                    events.append(_counter(
                        pid, "carbon_g", float(t_us[k]),
                        carbon_g=float(tl["carbon_g"][k])))

        for ev in recorder.scales:
            pid = SITE_PID_BASE + ev["site"]
            ts = ev["t_s"] * 1e6
            events.append({"ph": "i", "name": f"scale:{ev['kind']}",
                           "pid": pid, "tid": 0, "ts": ts, "s": "p"})
            events.append(_counter(pid, "replicas", ts,
                                   active=ev["n_active"],
                                   warm=ev["n_warm"]))

        for ev in recorder.epochs:
            pid = SITE_PID_BASE + ev["site"]
            events.append({
                "ph": "X",
                "name": f"epoch {ev['executed']}:{ev['reason']}",
                "pid": pid, "tid": EPOCH_TID, "ts": ev["t0_s"] * 1e6,
                "dur": (ev["t1_s"] - ev["t0_s"]) * 1e6,
                "args": {k: ev[k] for k in
                         ("index", "planned", "executed", "reason",
                          "n_replicas", "n_requests", "n_simulated",
                          "weight")}})

        bt, depth = recorder.backlog_series()
        routes = recorder.route_table()
        if len(bt) or len(routes["t_s"]):
            meta.append(_meta(ADMISSION_PID, "admission/routing "
                                             "(sim-time)"))
        for k in range(len(bt)):
            events.append(_counter(ADMISSION_PID, "deferral_backlog",
                                   float(bt[k]) * 1e6,
                                   backlog=int(depth[k])))
        if len(routes["t_s"]) <= max_instants:
            for k in range(len(routes["t_s"])):
                events.append({
                    "ph": "i", "name": "route", "pid": ADMISSION_PID,
                    "tid": 0, "ts": float(routes["t_s"][k]) * 1e6,
                    "s": "t",
                    "args": {"rid": int(routes["rid"][k]),
                             "site": int(routes["site"][k])}})

    # metadata first, then a stable ts sort with E closing before B
    # opens on ties (keeps duration nesting valid)
    events.sort(key=lambda e: (e["ts"], 0 if e["ph"] == "E" else 1))
    return meta + events


def write_chrome_trace(path, recorder=None, profiler=None,
                       max_instants: int = DEFAULT_MAX_INSTANTS) -> dict:
    """Write ``{"traceEvents": [...]}`` to ``path``; returns counts."""
    events = chrome_trace_events(recorder, profiler,
                                 max_instants=max_instants)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"traceEvents": events,
               "displayTimeUnit": "ms",
               "otherData": {"generator": "repro_torch.obs",
                             "sim_time_unit": "1 sim second = 1e6 ts"}}
    path.write_text(json.dumps(payload) + "\n")
    return {"path": str(path), "n_events": len(events)}


# ------------------------------------------------------------------ CSV --


def _write_csv(path: Path, header: List[str], rows) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)
    return path


def write_csvs(outdir, recorder=None, profiler=None) -> List[Path]:
    """Tidy CSV export: one file per series (stage events, routes,
    scales, epochs, backlog, per-site Eq. 1-5 timelines, wall-clock
    spans)."""
    outdir = Path(outdir)
    paths: List[Path] = []

    if recorder is not None:
        stages = recorder.stage_table()
        fields = list(stages)
        paths.append(_write_csv(
            outdir / "stages.csv", fields,
            zip(*(stages[f] for f in fields))))
        routes = recorder.route_table()
        paths.append(_write_csv(
            outdir / "routes.csv", list(routes),
            zip(*(routes[f] for f in routes))))
        if recorder.scales:
            keys = list(recorder.scales[0])
            paths.append(_write_csv(
                outdir / "scales.csv", keys,
                ([ev[k] for k in keys] for ev in recorder.scales)))
        if recorder.epochs:
            keys = list(recorder.epochs[0])
            paths.append(_write_csv(
                outdir / "epochs.csv", keys,
                ([ev[k] for k in keys] for ev in recorder.epochs)))
        bt, depth = recorder.backlog_series()
        if len(bt):
            paths.append(_write_csv(outdir / "backlog.csv",
                                    ["t_s", "backlog"],
                                    zip(bt, depth)))
        for s, tl in sorted(recorder.timelines.items()):
            cols = ["t_s", "power_w", "energy_wh", "devices",
                    "busy_dev_s"]
            if "carbon_g" in tl:
                cols += ["ci_g_per_kwh", "carbon_g"]
            paths.append(_write_csv(
                outdir / f"timeline_site{s}.csv", cols,
                zip(*(tl[c] for c in cols))))

    if profiler is not None:
        paths.append(_write_csv(
            outdir / "spans.csv", ["name", "t0_s", "dur_s", "depth"],
            profiler.spans()))
    return paths
