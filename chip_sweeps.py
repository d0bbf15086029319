#!/usr/bin/env python3
"""Time the port's full-size sweeps on the card and on the CPU, in one
process, with their wall-clock phases.

    python3 chip_sweeps.py [SWEEP ...] [--order cuda,cpu,cpu,cuda] [--smoke]

Each sweep (default: table2, carbon, day and shift, the sweeps that run
the microgrid co-sim) goes through ``run_sweep`` in vectorized mode,
uncached, once per entry of ``--order``. Each run prints its wall time,
its ``PROFILER`` phases and, on the card, ``microgrid_scan``'s launches;
the card's records are then held against the CPU's as ``chip_smoke.py``'s
phase 12 holds them (host columns bitwise, the rest within
``DEVICE_MODE_RTOL``). One JSON line per sweep; a sweep whose records
disagree exits non-zero after every sweep has run. ``--smoke`` runs the
reference's smoke sizes instead.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import chip_smoke as cs  # puts this checkout's src first on sys.path


def run(name: str, dev: str, smoke: bool) -> dict:
    import torch
    from repro_torch.kernels.microgrid_scan import microgrid_scan
    from repro_torch.obs.spans import PROFILER
    from repro_torch.sweep.scenarios import run_sweep
    PROFILER.enable(reset=True)
    before = microgrid_scan.launches
    t = time.perf_counter()
    records, stats, derived = run_sweep(name, smoke=smoke, torch_device=dev)
    if dev == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    PROFILER.disable()
    phases = {k: round(v["total_s"], 4)
              for k, v in sorted(PROFILER.aggregate().items(),
                                 key=lambda kv: -kv[1]["total_s"])}
    print(f"sweep {name} on {dev}: {len(records)} scenarios, "
          f"{stats.trace_groups} trace groups, wall {wall} s, "
          f"microgrid_scan launches {microgrid_scan.launches - before}; "
          f"phases {phases}; derived: {derived}", flush=True)
    return {"records": records, "derived": derived, "wall_s": wall,
            "phases": phases,
            "launches": microgrid_scan.launches - before}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("sweeps", nargs="*",
                   default=["table2", "carbon", "day", "shift"])
    p.add_argument("--order", default="cuda,cpu,cpu,cuda")
    p.add_argument("--smoke", action="store_true")
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        cs.fail("no CUDA card")
    from repro_torch.sweep.scenarios import run_sweep
    print(f"nvidia-smi name, power.limit: {cs.nvidia_smi('name,power.limit')}")
    order = args.order.split(",")
    for dev in sorted(set(order)):   # build the kernel, load modules, untimed
        run_sweep("table2", smoke=True, torch_device=dev)
    bad = []
    for name in args.sweeps:
        runs = [(dev, run(name, dev, args.smoke)) for dev in order]
        last = {dev: r for dev, r in runs}
        line = {"sweep": name, "smoke": args.smoke,
                "scenarios": len(last[order[0]]["records"]),
                "wall_s": {dev: [r["wall_s"] for d, r in runs if d == dev]
                           for dev in last},
                "phases": {dev: r["phases"] for dev, r in last.items()},
                "launches": [r["launches"] for d, r in runs if d == "cuda"]}
        if {"cuda", "cpu"} <= set(last):
            try:
                line["cells"] = cs.check_sweep(
                    name, "vectorized", last["cuda"]["records"],
                    last["cpu"]["records"])
            except SystemExit as exc:
                bad.append(name)
                line["cells"] = str(exc)
            line["derived_equal"] = (last["cuda"]["derived"]
                                     == last["cpu"]["derived"])
        print(json.dumps(line), flush=True)
    if bad:
        print(f"FAILED: card and CPU disagree in {', '.join(bad)}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
