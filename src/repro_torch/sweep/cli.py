"""Unified benchmark CLI over the scenario sweep engine (counterpart of
``python -m repro.sweep.cli``, with ``--torch-device``).

Examples:

    # every figure's pipeline at smoke scale, tensor work on the card
    PYTHONPATH=src python -m repro_torch.sweep.cli --smoke all

    # the same on the host's CPU
    PYTHONPATH=src python -m repro_torch.sweep.cli --smoke all --torch-device cpu

    # full Table 2 co-simulation, memoized — a repeat run is served
    # from the cache (results/torch/sweep_cache/<device type>/) and
    # executes zero scenarios
    PYTHONPATH=src python -m repro_torch.sweep.cli table2

    # fig4 across 4 worker processes, custom output dir
    PYTHONPATH=src python -m repro_torch.sweep.cli fig4 --workers 4 --out results/torch/sweep

    # audit every executed scenario (exit 1 on any violation)
    PYTHONPATH=src python -m repro_torch.sweep.cli --smoke fig1 --audit --torch-device cpu

    # the carbon co-sims on two detached workers over a shared work
    # queue (records bit-identical to the local run)
    PYTHONPATH=src python -m repro_torch.sweep.cli carbon --backend remote --remote-workers 2

Without ``--torch-device`` the tensor work (Eq. 1, the microgrid scan,
the fleet and day rollups, the device-mode program) runs on the CUDA
card, and the command raises where there is none; remote workers
compute on the same device type.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from repro_torch.device import resolve_device
from repro_torch.obs.log import configure as configure_logging
from repro_torch.obs.log import get_logger
from repro_torch.obs.spans import PROFILER
from repro_torch.sweep.cache import ResultCache, default_cache_root
from repro_torch.sweep.report import format_table, write_outputs
from repro_torch.sweep.scenarios import SWEEPS, run_sweep

_log = get_logger("repro_torch.sweep")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.sweep.cli",
        description="Run the paper's scenario sweeps through the "
                    "parallel, cache-memoized sweep engine.")
    p.add_argument("sweeps", nargs="*", metavar="SWEEP",
                   help=f"sweep names ({', '.join(SWEEPS)}) or 'all'")
    p.add_argument("--smoke", action="store_true",
                   help="tiny request counts + coarse grids (CI mode)")
    p.add_argument("--n-requests", type=int, default=None,
                   help="override per-scenario request count")
    p.add_argument("--workers", type=int, default=1,
                   help="scenario-level process parallelism (default 1)")
    p.add_argument("--mode", choices=("vectorized", "event_loop", "device"),
                   default="vectorized",
                   help="vectorized: one event-loop run per unique "
                        "config, shared-trace axes (pue/grid_ci/post.*) "
                        "evaluated as stacked array passes; event_loop: "
                        "every scenario through the loop (bit-identical "
                        "results either way); device: one batched torch "
                        "program over all trace groups at once, sharing "
                        "composition traces across device/tp/pp points "
                        "where divergence analysis proves it safe "
                        "(equivalent within a documented ulp-level "
                        "tolerance, see repro_torch.sweep.device)")
    p.add_argument("--backend", choices=("local", "remote"),
                   default="local",
                   help="local: execute in this process (pool); "
                        "remote: publish trace-group shards to a "
                        "shared-filesystem work queue for detached "
                        "repro_torch.sweep.worker processes on the same "
                        "torch device type (requires the cache; see "
                        "repro_torch.sweep.remote)")
    p.add_argument("--remote-workers", type=int, default=2,
                   help="convenience worker processes the coordinator "
                        "spawns on this host (default 2; 0 = rely on "
                        "externally launched workers)")
    p.add_argument("--queue-dir", type=Path, default=None,
                   help="work-queue directory shared with workers "
                        "(default <cache>/.queue)")
    p.add_argument("--lease-s", type=float, default=30.0,
                   help="shard lease: a claim whose heartbeat is "
                        "staler than this is reclaimed and retried "
                        "(default 30)")
    p.add_argument("--remote-verify", type=int, default=0, metavar="N",
                   help="re-run N trace groups in this process and "
                        "assert the remote records are bit-identical")
    p.add_argument("--no-cache", action="store_true",
                   help="disable the on-disk result cache")
    p.add_argument("--cache-dir", type=Path, default=None,
                   help=f"cache root (default {default_cache_root()}, "
                        f"or $REPRO_TORCH_SWEEP_CACHE); records go under "
                        f"<root>/<torch device type>/")
    p.add_argument("--clear-cache", action="store_true",
                   help="drop all cached scenario results, then proceed")
    p.add_argument("--out", type=Path,
                   default=Path("results") / "torch" / "sweep",
                   help="directory for per-sweep CSV/JSON tables")
    p.add_argument("--torch-device", default=None,
                   help="torch device of the scenarios' tensor work "
                        "(default: the CUDA card; 'cpu' runs it on the "
                        "host)")
    p.add_argument("--list", action="store_true", dest="list_sweeps",
                   help="list available sweeps and exit")
    p.add_argument("--quiet", action="store_true",
                   help="suppress per-scenario tables and progress logs")
    p.add_argument("-v", "--verbose", action="count", default=0,
                   help="raise progress-log verbosity (stderr)")
    p.add_argument("--profile", action="store_true",
                   help="profile the sweep pipeline's wall-clock "
                        "phases; per-phase totals print to stderr")
    p.add_argument("--trace-out", type=Path, default=None,
                   help="record a dual-clock Perfetto trace (sim-time "
                        "flight recorder + wall-clock spans) to this "
                        "Chrome trace-event JSON path; forces serial "
                        "execution and is rejected in device mode")
    p.add_argument("--obs-resolution", type=float, default=60.0,
                   help="flight-recorder timeline bin width in sim "
                        "seconds (default 60; observer-only)")
    p.add_argument("--audit", action="store_true",
                   help="attach the physics-invariant auditor "
                        "(repro_torch.obs.audit) to every executed "
                        "scenario: conservation, Eq. 2-5 closure, "
                        "KV/clock/power invariants. Observer-only "
                        "(results stay bitwise identical); violations "
                        "write a report under results/torch/obs/"
                        "divergence/ and exit 1. Forces serial "
                        "execution; rejected in device mode. Stackable "
                        "with --trace-out")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    configure_logging(verbosity=(-1 if args.quiet else args.verbose))

    if args.list_sweeps:
        for name, sweep in SWEEPS.items():
            n = len(sweep.build(args.smoke, n_requests=args.n_requests))
            print(f"{name:8s} {n:3d} scenario(s)  {sweep.title}")
        return 0

    names = list(args.sweeps)
    if not names:
        print("no sweeps given (use names or 'all'); --list shows options",
              file=sys.stderr)
        return 2
    if names == ["all"]:
        names = list(SWEEPS)
    unknown = [n for n in names if n not in SWEEPS]
    if unknown:
        print(f"unknown sweep(s): {', '.join(unknown)}; "
              f"available: {', '.join(SWEEPS)}", file=sys.stderr)
        return 2

    torch_device = str(resolve_device(args.torch_device))
    cache = (None if args.no_cache
             else ResultCache(args.cache_dir, torch_device=torch_device))
    if args.clear_cache and cache is not None:
        print(f"cleared {cache.clear()} cached scenario(s)")

    remote_opts = None
    if args.backend == "remote":
        if cache is None:
            print("--backend remote requires the result cache "
                  "(workers return records through it); drop --no-cache",
                  file=sys.stderr)
            return 2
        from repro_torch.sweep.remote import RemoteOptions
        remote_opts = RemoteOptions(
            queue_dir=args.queue_dir,
            spawn_workers=max(0, args.remote_workers),
            lease_s=args.lease_s,
            verify_groups=max(0, args.remote_verify))

    probe = recorder = auditor = None
    if args.trace_out is not None:
        from repro_torch.obs.recorder import FlightRecorder
        recorder = FlightRecorder(resolution_s=args.obs_resolution,
                                  torch_device=torch_device)
        probe = recorder
    if args.audit:
        from repro_torch.obs.audit import AuditProbe
        auditor = AuditProbe()
        if recorder is not None:
            from repro_torch.obs.probe import MultiProbe
            probe = MultiProbe([recorder, auditor])
        else:
            probe = auditor
    if args.profile or probe is not None:
        PROFILER.enable(reset=True)

    failed = []
    for name in names:
        t0 = time.perf_counter()
        print(f"== {name}: {SWEEPS[name].title}"
              + (" [smoke]" if args.smoke else ""))
        try:
            records, stats, derived = run_sweep(
                name, smoke=args.smoke, n_requests=args.n_requests,
                workers=args.workers, cache=cache, mode=args.mode,
                probe=probe, backend=args.backend, remote=remote_opts,
                torch_device=torch_device,
                progress=lambda msg: _log.info("%s", msg))
        except Exception as exc:           # keep sweeping, report at exit
            failed.append(name)
            print(f"   FAILED: {type(exc).__name__}: {exc}",
                  file=sys.stderr)
            continue
        paths = write_outputs(name, records, args.out, derived=derived)
        if not args.quiet:
            print(format_table(records))
        print(f"   {stats.summary()}")
        if auditor is not None:
            print(f"   audit: {auditor.report().summary()}")
        print(f"   derived: {derived}")
        print(f"   wrote {paths['csv']} {paths['json']} "
              f"({time.perf_counter() - t0:.2f}s)")

    if args.profile or probe is not None:
        PROFILER.disable()
    if args.trace_out is not None:
        from repro_torch.obs.chrometrace import write_chrome_trace
        info = write_chrome_trace(args.trace_out, recorder, PROFILER)
        print(f"   wrote trace {info['path']} "
              f"({info['n_events']} events)")
    if args.profile:
        print("-- wall-clock phases --", file=sys.stderr)
        print(PROFILER.format_aggregate(), file=sys.stderr)

    if failed:
        print(f"failed sweeps: {', '.join(failed)}", file=sys.stderr)
        return 1
    if auditor is not None and not auditor.report().ok:
        from repro_torch.obs.diff import DIVERGENCE_DIR
        report = auditor.report()
        DIVERGENCE_DIR.mkdir(parents=True, exist_ok=True)
        path = DIVERGENCE_DIR / "audit.md"
        path.write_text(report.to_markdown())
        print(f"audit FAILED: {report.summary()}\n"
              f"audit report: {path}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
