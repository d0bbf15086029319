"""Flight-recorder + divergence-explainer CLI (counterpart of
``python -m repro.obs``).

Examples:

    # record the day-smoke config's flight trace + CSVs, Eq. 1 on the CPU
    PYTHONPATH=src python -m repro_torch.obs record day --smoke \\
        --torch-device cpu --out results/torch/obs/day_trace.json \\
        --csv-dir results/torch/obs

    # list recordable scenarios
    PYTHONPATH=src python -m repro_torch.obs list --smoke

    # explain the first divergence between two sweep result sets
    PYTHONPATH=src python -m repro_torch.obs diff \\
        results/a/fig1.json results/b/fig1.json

    # golden-drift gate: ANY divergence fails (exit 1)
    PYTHONPATH=src python -m repro_torch.obs diff \\
        results/sweep/fig1.json golden.json --golden

``record`` executes one scenario from the sweep registry with a
``FlightRecorder`` attached and the wall-clock ``SpanProfiler``
enabled, then writes both clocks to one Chrome trace-event JSON
(open it at https://ui.perfetto.dev) and, optionally, tidy CSVs.
The probe only observes: the scenario's metrics are bit-identical to
an unrecorded run (tests/test_torch_obs.py pins this). The scenario's
tensor work (Eq. 1, the microgrid scan) runs on ``--torch-device``
(default: the card; without one the command raises).

``diff`` compares two artifacts — sweep result JSONs (a ``records``
payload), golden/metrics dicts, or flight-trace ``stages.csv``
exports — walks the columns in Eq. 1-5 dependency order to localize
the *first* divergent (scenario, stage, column) cell, classifies each
divergence against the named tolerance contracts, and writes the
markdown + JSON report under ``results/torch/obs/divergence/``. Exit code:
1 when any cell is a ``regression`` (or, under ``--golden``, on any
divergence at all), else 0.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.obs.chrometrace import write_chrome_trace, write_csvs
from repro_torch.obs.diff import (DIVERGENCE_DIR, diff_golden, diff_records,
                            diff_stage_tables, write_report)
from repro_torch.obs.log import configure, get_logger
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.spans import PROFILER

_log = get_logger("repro_torch.obs")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Sim-time flight recorder + wall-clock profiler "
                    "over single sweep scenarios.")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("--quiet", action="store_true")
    sub = p.add_subparsers(dest="cmd", required=True)

    ls = sub.add_parser("list", help="list recordable sweep scenarios")
    ls.add_argument("--smoke", action="store_true")

    rec = sub.add_parser("record",
                         help="record one scenario's flight trace")
    rec.add_argument("sweep", metavar="SWEEP",
                     help="sweep name from the registry "
                          "(python -m repro_torch.obs list)")
    rec.add_argument("--index", type=int, default=0,
                     help="scenario index within the sweep (default 0)")
    rec.add_argument("--smoke", action="store_true",
                     help="smoke-scale grids (CI mode)")
    rec.add_argument("--n-requests", type=int, default=None)
    rec.add_argument("--resolution", type=float, default=60.0,
                     help="timeline bin width in sim seconds "
                          "(default 60; observer-only, never changes "
                          "the simulation)")
    rec.add_argument("--out", type=Path, default=None,
                     help="Chrome trace JSON path (default "
                          "results/torch/obs/<sweep><index>.trace.json)")
    rec.add_argument("--csv-dir", type=Path, default=None,
                     help="also export tidy CSVs into this directory")
    rec.add_argument("--torch-device", default=None,
                     help="torch device of the scenario's tensor work "
                          "(default: the CUDA card)")

    df = sub.add_parser(
        "diff", help="localize + classify the first divergence "
                     "between two runs")
    df.add_argument("a", metavar="A", type=Path,
                    help="sweep-result JSON, metrics/golden JSON, or "
                         "stage-table CSV")
    df.add_argument("b", metavar="B", type=Path,
                    help="artifact to compare against (same kinds)")
    df.add_argument("--golden", action="store_true",
                    help="treat B as a golden record: bit-exact gate, "
                         "exit 1 on any divergence")
    df.add_argument("--index", type=int, default=0,
                    help="with --golden and a records-file A: which "
                         "record's metrics to gate (default 0)")
    df.add_argument("--name", default="diff",
                    help="report basename (default 'diff')")
    df.add_argument("--report-dir", type=Path, default=None,
                    help=f"report directory (default {DIVERGENCE_DIR})")
    return p


def _cmd_list(args) -> int:
    from repro_torch.sweep.scenarios import SWEEPS
    for name, sweep in SWEEPS.items():
        scs = sweep.build(args.smoke)
        print(f"{name:8s} {len(scs):3d} scenario(s)  {sweep.title}")
    return 0


def _cmd_record(args) -> int:
    from repro_torch.sweep.runner import execute_scenario
    from repro_torch.sweep.scenarios import SWEEPS

    if args.sweep not in SWEEPS:
        print(f"unknown sweep {args.sweep!r}; available: "
              f"{', '.join(SWEEPS)}", file=sys.stderr)
        return 2
    scenarios = SWEEPS[args.sweep].build(args.smoke,
                                         n_requests=args.n_requests)
    if not 0 <= args.index < len(scenarios):
        print(f"--index {args.index} out of range "
              f"(sweep has {len(scenarios)} scenarios)", file=sys.stderr)
        return 2
    sc = scenarios[args.index]
    _log.info("recording %s (scenario %d/%d: %s)", args.sweep,
              args.index, len(scenarios), sc.tag)

    recorder = FlightRecorder(resolution_s=args.resolution,
                              torch_device=args.torch_device)
    PROFILER.enable(reset=True)
    try:
        with PROFILER.span("execute_scenario"):
            record = execute_scenario(sc, probe=recorder,
                                      torch_device=args.torch_device)
    finally:
        PROFILER.disable()

    out = args.out or (Path("results") / "torch" / "obs"
                       / f"{args.sweep}{args.index}.trace.json")
    info = write_chrome_trace(out, recorder, PROFILER)
    counts = recorder.counts()
    summary = {
        "sweep": args.sweep, "index": args.index,
        "scenario": record["scenario"], "key": record["key"],
        **counts,
        "has_carbon_timeline": any("carbon_g" in t for t in
                                   recorder.timelines.values()),
        "trace": info["path"], "trace_events": info["n_events"],
    }
    if args.csv_dir is not None:
        paths = write_csvs(args.csv_dir, recorder, PROFILER)
        summary["csv_files"] = [str(p) for p in paths]
    print(json.dumps(summary, indent=1))
    _log.info("open %s at https://ui.perfetto.dev", info["path"])
    return 0


def _load_artifact(path: Path):
    """Classify + load one diff operand: ``("table", cols)`` for a
    stage-table CSV, ``("records", list)`` for a sweep-result payload,
    ``("metrics", dict)`` for a golden/metrics dict."""
    import csv

    import numpy as np
    if path.suffix.lower() == ".csv":
        with path.open(newline="") as f:
            rows = list(csv.reader(f))
        if not rows:
            return "table", {}
        header, body = rows[0], rows[1:]
        cols = {h: np.asarray([float(r[j]) for r in body], np.float64)
                for j, h in enumerate(header)}
        return "table", cols
    data = json.loads(path.read_text())
    if isinstance(data, list):
        return "records", data
    if isinstance(data, dict) and isinstance(data.get("records"), list):
        return "records", data["records"]
    if isinstance(data, dict) and isinstance(data.get("metrics"), dict):
        return "metrics", data["metrics"]
    if isinstance(data, dict):
        return "metrics", data
    raise ValueError(f"unrecognized artifact shape in {path}")


def _cmd_diff(args) -> int:
    try:
        kind_a, a = _load_artifact(args.a)
        kind_b, b = _load_artifact(args.b)
    except (ValueError, OSError, json.JSONDecodeError) as exc:
        print(f"cannot load artifacts: {exc}", file=sys.stderr)
        return 2
    la, lb = str(args.a), str(args.b)
    if args.golden:
        if kind_b == "table":
            print("--golden expects a metrics/records JSON for B",
                  file=sys.stderr)
            return 2
        if kind_b == "records":
            b = b[args.index].get("metrics", {}) \
                if 0 <= args.index < len(b) else {}
        if kind_a == "records":
            if not 0 <= args.index < len(a):
                print(f"--index {args.index} out of range "
                      f"(A has {len(a)} records)", file=sys.stderr)
                return 2
            a = a[args.index].get("metrics", {})
        elif kind_a == "table":
            print("--golden expects a metrics/records JSON for A",
                  file=sys.stderr)
            return 2
        result = diff_golden(a, b, scenario=args.name,
                             label_a=la, label_b=lb)
    elif kind_a != kind_b:
        print(f"cannot compare {kind_a} ({la}) against {kind_b} ({lb})",
              file=sys.stderr)
        return 2
    elif kind_a == "table":
        result = diff_stage_tables(a, b, scenario=args.name,
                                   label_a=la, label_b=lb)
    elif kind_a == "records":
        result = diff_records(a, b, label_a=la, label_b=lb)
    else:
        result = diff_golden(a, b, scenario=args.name,
                             label_a=la, label_b=lb)
    paths = write_report(result, args.name, outdir=args.report_dir)
    print(result.summary())
    print(f"report: {paths['md']}")
    if args.golden:
        return 0 if result.identical else 1
    return 1 if result.has_regression else 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    configure(verbosity=(-1 if args.quiet else args.verbose))
    if args.cmd == "list":
        return _cmd_list(args)
    if args.cmd == "diff":
        return _cmd_diff(args)
    return _cmd_record(args)


if __name__ == "__main__":
    sys.exit(main())
