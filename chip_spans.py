#!/usr/bin/env python3
"""Serve one benchmark cell with the program's spans on, and read them.

    python3 chip_spans.py --workload <cell> --seed <n> [--seconds 45] [--spans 1|0]

The benchmark's traced run (``bench/run.py --trace 1``: warm-up, the
profiled slice, the measured window, the output check) with
``repro_torch.obs.spans.PROFILER`` enabled, reset at the start of each
profiler attempt, from the end of the warm-up to the close of the window;
the slice's device records less the spans' own annotation ranges
(``bench/spans.py::device_ops``), so that every metric of the benchmark
reads the operations it reads without the spans. Beside the benchmark's
metrics it prints the readings ``bench/spans.py`` takes from the spans:
``queue_wait_p90_ms`` (over the window), ``decode_launches`` and
``moe_roofline.{prefill,decode}`` (over the slice), and the slice's device
seconds, launches and idle gaps by program span. ``--spans 0`` runs the
same with the profiler off: the difference between the two is what the
spans cost. The last line of standard output is the result, as JSON; it
is also written to ``chiprun_out/spans/<cell>-<seed>-<spans>.json``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from unittest import mock  # noqa: E402

ROOT = Path(__file__).resolve().parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def traced(workload: str, seed: int, seconds: float, spans_on: bool):
    """``bench.run.serve`` with the spans on (or off): the served namespace,
    the slice's device and host events and span records, and the window's
    (open, close) and span records."""
    from bench import loop as loop_mod, profile, run, spans
    from repro_torch.obs.spans import PROFILER
    got = {}
    profiled, window = profile.profiled, loop_mod.ClosedLoop.run

    def profiled_with_spans(fn, what, whole=lambda device: True):
        def attempt():
            got["attempts"] = got.get("attempts", 0) + 1
            if spans_on:
                PROFILER.enable(reset=True)
            fn()

        def whole_ops(device):     # reached once no launch lost its record
            got.setdefault("whole", []).append(
                (got["attempts"], whole(spans.device_ops(device))))
            return got["whole"][-1][1]
        out = profiled(attempt, what, whole_ops)
        if out is None:
            return None
        device, host, wall, attempts = out
        got.update(device=device, host=host, slice_records=PROFILER.records())
        return spans.device_ops(device), host, wall, attempts

    def run_window(self, seconds):
        got["window"] = window(self, seconds)
        PROFILER.disable()
        return got["window"]

    with mock.patch.object(profile, "profiled", profiled_with_spans), \
            mock.patch.object(loop_mod.ClosedLoop, "run", run_window):
        s = run.serve(workload, seed, seconds, True)
    got["records"] = PROFILER.records()
    PROFILER.reset()
    return s, got


def readings(got) -> dict:
    """What ``bench/spans.py`` reads from the slice and the window."""
    from bench import profile, spans
    if "device" not in got:
        return {}
    device, host = got["device"], got["host"]
    ops = spans.device_ops(device)
    busy = profile.busy_intervals(ops)
    notes = [e for e in device if spans.is_annotation(e)]
    t_open, t_close = got["window"]
    split = spans.moe_split(device, host)
    table = spans.by_span(device, host)
    return {
        "queue_wait_p90_ms": spans.queue_wait_p90_ms(got["records"], t_open, t_close),
        "decode_launches": spans.decode_launches(host),
        "moe_roofline.prefill": spans.moe_roofline(device, host, got["slice_records"], "prefill"),
        "moe_roofline.decode": spans.moe_roofline(device, host, got["slice_records"], "decode"),
        "by_span": {k: v for k, v in sorted(table.items(), key=lambda kv: -kv[1][0])},
        "idle_by_span": spans.idle_by_span(busy, host),
        "idle_by_host": profile.idle_by_host(busy, host),
        "moe_split": split,
        "moe_device_s": {k: sum(v.values()) for k, v in split.items()},
        "attempts_whole": got.get("whole"),
        "annotations": {"device_ranges": len(notes),
                        "activity_types": sorted({str(getattr(e, "activity_type", None))
                                                  for e in notes}),
                        "host_spans": sum(spans.is_annotation(e) for e in host),
                        "slice_records": len(got["slice_records"]),
                        "window_records": len(got["records"])},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from bench import check, run
    from bench.readers import reader
    if not torch.cuda.is_available():
        print("no result: needs a CUDA card", file=sys.stderr)
        return 1
    print(f"card: {torch.cuda.get_device_name(0)}; nvidia-smi name, power.limit: "
          f"{run.nvidia_smi('name,power.limit')}; torch {torch.__version__}")
    s, got = traced(args.workload, args.seed, args.seconds, bool(args.spans))
    checks = check.check(s.ref, s.W, s.cfg, s.rec.done_in_window,
                         s.limits["check"], np.random.default_rng(args.seed), s.snap)
    metrics = {}
    for m in s.spec["end_to_end"] + s.spec["per_layer"]:
        if args.workload in m.get("workloads", [args.workload]):
            value = reader(m["name"])(s.rec)
            if value is not None:
                metrics[m["name"]] = float(value)
    t = time.perf_counter()
    result = {"workload": args.workload, "seed": args.seed, "spans": args.spans,
              "correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "metrics": metrics, "readings": readings(got),
              "slice": {k: v for k, v in (s.rec.slice or {}).items()
                        if k != "breakdown"},
              "device_ops": (s.rec.slice or {}).get("breakdown", {}).get("device_ops"),
              "checks": checks}
    print(f"spans read in {time.perf_counter() - t:.1f} s; run "
          f"{time.perf_counter() - T_START:.1f} s")
    for key in ("by_span", "idle_by_span", "moe_split"):
        print(f"{key}: {json.dumps(result['readings'].get(key))}")
    out = ROOT / "chiprun_out" / "spans"
    out.mkdir(parents=True, exist_ok=True)
    line = json.dumps(result)
    (out / f"{args.workload}-{args.seed}-{args.spans}.json").write_text(line)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
