#!/usr/bin/env python3
"""Train through the launcher on (data, model) meshes of this machine's
cards, each held against the same steps on one card.

    python3 chip_mesh.py [--meshes 2x2,4x1,1x4] [--steps 6]

For each mesh D x M it spawns one process per card (an NCCL group joined
through a ``FileStore``, rank r on ``cuda:r``), each running
``repro_torch.launch.train.main`` at smollm-360m's published widths with
``chip_smoke.py`` phase 17's batch (SyntheticLM seq 2048 batch 8 seed 0,
float32 masters, bf16 compute); then it trains the same steps on one card
with no process group. It prints each run's losses, median step ms over
steps 2..N (each to its ``float(loss)``), peak device memory of rank 0, and
the mesh's gaps to the one-card run: losses (relative) and final masters
(relative Frobenius per leaf, gathered whole). In bf16 a mesh whose
``model`` axis has more than one rank sums partial gradients across ranks
and so rounds apart from one card (the forward does not: row-parallel
products gather their operands), so the gates are loose, 1e-2 on losses
and on every leaf: they catch a wrong program, not rounding. It needs as
many cards as the largest mesh has ranks and exits non-zero without them
or past a gate.

Before the meshes it runs device mode's split of the group axis over the
cards (``repro_torch.sweep.device.local_devices``): the fig4 smoke grid on
every card at once (4 blocks on 4 cards) against one card's run bit for
bit, and against the event loop within ``DEVICE_MODE_RTOL``.
``--meshes ''`` runs the split alone.
"""
from __future__ import annotations

import argparse
import multiprocessing
import queue
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

ARCH = "smollm-360m"
SEQ, BATCH = 2048, 8
GATE = 1e-2


def argv_for(mesh: str, steps: int, ckpt: str) -> list:
    return ["--arch", ARCH, "--seq", str(SEQ), "--batch", str(BATCH),
            "--steps", str(steps), "--mesh", mesh, "--ckpt-dir", ckpt]


def summary(out: dict) -> dict:
    """Losses, step times, rank 0's peak memory and the whole masters on
    the host (a gather every rank joins)."""
    masters = {k: (v.full_tensor() if hasattr(v, "full_tensor") else v)
               .detach().cpu() for k, v in out["params"].items()}
    return {"losses": out["losses"], "step_times": out["step_times"],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "masters": masters}


def rank_main(rank: int, world: int, store: str, argv: list, result: str, errors):
    try:
        import torch.distributed as dist
        from repro_torch.launch import train
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", store=dist.FileStore(store, world),
                                rank=rank, world_size=world, device_id=dev)
        try:
            s = summary(train.main(argv))
            if rank == 0:
                torch.save(s, result)
        finally:
            dist.destroy_process_group()
    except BaseException as e:
        errors.put(f"rank {rank}: {type(e).__name__}: {e}")
        raise


def run_mesh(mesh: str, steps: int, tmp: Path) -> dict:
    d, m = (int(x) for x in mesh.split("x"))
    world = d * m
    ctx = multiprocessing.get_context("spawn")
    errors = ctx.Queue()
    result = tmp / f"{mesh}.pt"
    argv = argv_for(mesh, steps, str(tmp / f"ckpt-{mesh}"))
    t = time.perf_counter()
    procs = [ctx.Process(target=rank_main, args=(r, world, str(tmp / f"store-{mesh}"),
                                                 argv, str(result), errors))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=900)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    try:
        err = errors.get_nowait()
    except queue.Empty:
        err = None
    if err or any(p.exitcode != 0 for p in procs) or not result.exists():
        sys.exit(f"chip_mesh: mesh {mesh} failed: {err} (exit codes "
                 f"{[p.exitcode for p in procs]})")
    print(f"mesh {mesh}: {world} ranks in {time.perf_counter() - t:.1f} s")
    return torch.load(result)


def device_split():
    """Device mode over every card against one card; returns the split."""
    from repro_torch.core.power import DEVICE_MODE_RTOL
    from repro_torch.sweep import device as sweep_device
    from repro_torch.sweep.runner import SweepRunner
    from repro_torch.sweep.scenarios import SWEEPS
    scs = SWEEPS["fig4"].build(True)
    t = time.perf_counter()
    recs, stats = sweep_device.execute_device_grid(scs, torch_device="cuda")
    split_s = time.perf_counter() - t
    found = sweep_device.local_devices
    sweep_device.local_devices = lambda dev: [torch.device("cuda", 0)]
    try:
        one, one_stats = sweep_device.execute_device_grid(scs, torch_device="cuda")
    finally:
        sweep_device.local_devices = found
    metrics = lambda rs: {r["key"]: r["metrics"] for r in rs}
    same = metrics(recs) == metrics(one)
    ev = SweepRunner(mode="event_loop", torch_device="cuda").run(scs)[0]
    err = sweep_device.records_max_rel_err(recs, ev)
    print(f"device mode, fig4 smoke ({len(scs)} scenarios, "
          f"{stats.trace_groups} groups): devices {stats.devices} in "
          f"{split_s:.2f} s vs {one_stats.devices}: records bit for bit "
          f"{same}; vs the event loop {err:.3e} (DEVICE_MODE_RTOL "
          f"{DEVICE_MODE_RTOL:.0e})")
    if not same or not err <= DEVICE_MODE_RTOL:
        sys.exit("chip_mesh: device mode's split differs from one card")
    return stats.devices


def report(name: str, s: dict):
    step_ms = float(np.median(s["step_times"][1:])) * 1e3
    print(f"{name}: losses " + ", ".join(f"{x:.6f}" for x in s["losses"])
          + f"; step {step_ms:.2f} ms (median of steps 2-{len(s['losses'])}); "
          f"rank 0 max_memory_allocated {s['peak_gb']:.2f} GB")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--meshes", default="2x2,4x1,1x4")
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()
    meshes = [m for m in args.meshes.split(",") if m]
    need = max([2] + [int(a) * int(b) for a, b in (s.split("x") for s in meshes)])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        sys.exit(f"chip_mesh: needs {need} CUDA cards, found "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(f"{torch.cuda.device_count()} cards: " + "; ".join(smi)
          + f"; torch {torch.__version__}")
    d = device_split()
    want = 1 << (min(torch.cuda.device_count(), 4).bit_length() - 1)
    if d != want:
        sys.exit(f"chip_mesh: device mode split over {d} cards, not {want}")
    if not meshes:
        return
    with tempfile.TemporaryDirectory(prefix="chip_mesh_") as tmp:
        tmp = Path(tmp)
        runs = {mesh: run_mesh(mesh, args.steps, tmp) for mesh in meshes}
        from repro_torch.launch import train
        torch.cuda.reset_peak_memory_stats()
        one = summary(train.main(argv_for("1x1", args.steps, str(tmp / "ckpt-1x1")),
                                 device="cuda"))
    report("1x1 (one card, no group)", one)
    failed = []
    for mesh, s in runs.items():
        report(f"{mesh}", s)
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(s["losses"], one["losses"]))
        gaps = {k: float(torch.linalg.vector_norm((s["masters"][k] - w).double())
                         / torch.linalg.vector_norm(w.double()))
                for k, w in one["masters"].items()}
        worst = max(gaps, key=gaps.get)
        print(f"{mesh} vs 1x1: losses within {loss_gap:.3e}, masters worst leaf "
              f"{gaps[worst]:.3e} ({worst}; median "
              f"{float(np.median(list(gaps.values()))):.3e}; gate {GATE:.0e})")
        if not (loss_gap <= GATE and gaps[worst] <= GATE):
            failed.append(mesh)
    if failed:
        sys.exit(f"chip_mesh: {failed} past the gate")
    print("chip_mesh: every mesh within the gate")


if __name__ == "__main__":
    main()
