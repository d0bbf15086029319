"""Remote sweep worker: ``python -m repro_torch.sweep.worker <queue_dir>``
(counterpart of ``repro.sweep.worker``, with ``--torch-device``).

One worker process per invocation. It scans the queue directory for
open jobs (published by ``repro_torch.sweep.remote.RemoteCoordinator``),
claims pending shards by atomic rename, evaluates each shard's trace
groups through the existing execution paths (``vectorized`` — exact,
bit-identical to in-process execution — or ``device`` — the batched
torch grid program) on its ``--torch-device`` (default: the CUDA card,
raising without one), and writes the records straight into the shared
``ResultCache`` named by the job. A daemon heartbeat thread refreshes
the claimed shard's lease (mtime) so the coordinator can tell a slow
worker from a dead one, a cold kernel build included.

A worker computes only the jobs of its own device type (the job names
the coordinator's): one without a card never computes a ``cuda`` job on
the host, and a ``cuda`` worker that fails (a build, a launch, a CUDA
error) returns its shard to the queue and exits with the error in its
log — nothing retries that shard on the host.

Run it on any host that shares the queue/cache filesystem; nothing
else is coordinated. ``--once`` drains the current backlog and exits
(CI); without it the worker keeps polling until ``<queue>/stop``
exists, ``--idle-timeout-s`` elapses without work, or it is signalled.

Crash safety: a worker that dies mid-shard simply stops heartbeating;
the coordinator re-pends the shard after ``lease_s`` and another
worker re-executes it. Records it already wrote are bit-identical to
the re-execution's (deterministic sims, content-addressed keys, atomic
cache writes), so partial progress is never torn or duplicated —
``REPRO_WORKER_CRASH_AFTER_GROUPS`` injects exactly that failure for
the retry tests.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import traceback
import uuid
from pathlib import Path
from typing import Optional

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs.spans import PROFILER
from repro_torch.sweep import remote
from repro_torch.sweep.cache import ResultCache
from repro_torch.sweep.grid import SCHEMA_VERSION


def choose_mode(worker_mode: str, payload: dict) -> str:
    """Resolve the shard's execution mode. ``inherit`` (default) uses
    whatever the coordinator ran with — the safe choice, preserving the
    backend's bit-identity contract. ``auto`` picks device for
    single-site shards and vectorized otherwise; an explicit mode
    wins."""
    if worker_mode == "inherit":
        return payload.get("mode", "vectorized")
    if worker_mode == "auto":
        from repro_torch.fleet.config import FleetConfig
        for group in payload["groups"]:
            if isinstance(group[0].cfg, FleetConfig):
                return "vectorized"
        return "device"
    return worker_mode


def execute_shard(payload: dict, cache: ResultCache, mode: str,
                  torch_device: DeviceLike = None,
                  crash_after: Optional[int] = None) -> int:
    """Evaluate one shard's trace groups on ``torch_device`` (the job's
    device type) and persist every record into the shared cache.
    Returns the record count. ``crash_after`` kills the process
    (``os._exit``) after that many completed groups — the
    injected-crash hook exercising lease-expiry retry."""
    from repro_torch.sweep.vectorized import execute_scenario_group

    n_records = 0
    done_groups = 0
    if mode == "device":
        from repro_torch.sweep.device import execute_device_grid
        flat = [sc for group in payload["groups"] for sc in group]
        with PROFILER.span("worker.device_grid"):
            records, _ = execute_device_grid(flat,
                                             torch_device=torch_device)
        with PROFILER.span("cache.store"):
            for rec in records:
                rec["meta"]["cache_hit"] = False
                cache.put(rec["key"], rec)
                n_records += 1
        return n_records

    for group in payload["groups"]:
        records = execute_scenario_group(group, torch_device=torch_device)
        with PROFILER.span("cache.store"):
            for rec in records:
                rec["meta"]["cache_hit"] = False
                cache.put(rec["key"], rec)
                n_records += 1
        done_groups += 1
        if crash_after is not None and done_groups >= crash_after:
            # simulated hard crash: no release, no manifest, no atexit
            os._exit(17)
    return n_records


def _start_heartbeat(running_path: Path, lease_s: float
                     ) -> threading.Event:
    """Refresh the shard lease from a daemon thread every lease_s/4;
    returns the stop event. OSErrors are swallowed — a reclaimed file
    just means the heartbeat is moot."""
    stop = threading.Event()

    def _beat():
        while not stop.wait(max(0.05, lease_s / 4.0)):
            remote.heartbeat(running_path)

    threading.Thread(target=_beat, daemon=True).start()
    return stop


def _open_jobs(queue_dir: Path, device_type: str):
    """Yield (job_dir, job_meta) for jobs still accepting work, oldest
    first. Jobs of another schema are skipped (version skew between a
    worker's checkout and the coordinator's must never produce records
    under the wrong digest), and so are jobs of another device type (a
    worker without a card never computes a ``cuda`` job)."""
    for job_dir in sorted(queue_dir.glob("job-*")):
        try:
            meta = json.loads((job_dir / "job.json").read_text())
        except (OSError, json.JSONDecodeError):
            continue
        if meta.get("status") != "open":
            continue
        if meta.get("schema") != SCHEMA_VERSION:
            continue
        if meta.get("torch_device") != device_type:
            continue
        yield job_dir, meta


def _microgrid_launches() -> int:
    from repro_torch.kernels.microgrid_scan import microgrid_scan
    return microgrid_scan.launches


def _work_one_shard(job_dir: Path, meta: dict, worker_id: str,
                    worker_mode: str, crash_after: Optional[int],
                    torch_device: str) -> bool:
    """Try to claim and complete one shard of this job. Returns True if
    a shard was executed (or claimed-and-failed on the host), False if
    nothing was claimable. A failure releases the shard (retry or
    quarantine); on the card it then re-raises and the worker exits, its
    CUDA context suspect, as it does on an interrupt anywhere."""
    pending = sorted(p.name for p in
                     (job_dir / remote.PENDING).glob("shard-*.pkl"))
    if not pending:
        return False
    # start each worker at a different offset so concurrent claimers
    # mostly don't race for the same file
    offset = hash(worker_id) % len(pending)
    for name in pending[offset:] + pending[:offset]:
        claimed = remote.claim_shard(job_dir, name, worker_id)
        if claimed is None:
            continue
        payload, running_path = claimed
        lease_s = float(meta.get("lease_s", 30.0))
        beat_stop = _start_heartbeat(running_path, lease_s)
        t0 = time.perf_counter()
        launches0 = _microgrid_launches()
        PROFILER.enable(reset=True)
        try:
            cache = ResultCache(Path(meta["cache_root"]),
                                torch_device=torch_device)
            mode = choose_mode(worker_mode, payload)
            n_records = execute_shard(payload, cache, mode,
                                      torch_device=torch_device,
                                      crash_after=crash_after)
        except BaseException as exc:
            PROFILER.disable()
            beat_stop.set()
            outcome = remote.release_shard(
                job_dir, running_path,
                int(meta.get("max_attempts", 3)), repr(exc))
            print(f"[worker {worker_id}] shard {payload['shard']} "
                  f"failed ({outcome}): {exc!r}", flush=True)
            if torch_device.startswith("cuda") \
                    or not isinstance(exc, Exception):
                raise
            traceback.print_exc(file=sys.stdout)
            sys.stdout.flush()
            return True
        PROFILER.disable()
        beat_stop.set()
        remote.complete_shard(job_dir, running_path, {
            "shard": payload["shard"],
            "worker": worker_id,
            "torch_device": torch_device,
            "mode": mode,
            "n_groups": len(payload["groups"]),
            "n_records": n_records,
            "microgrid_scan_launches": _microgrid_launches() - launches0,
            "elapsed_s": round(time.perf_counter() - t0, 4),
            "phases": {k: {"count": int(a["count"]),
                           "total_s": a["total_s"]}
                       for k, a in PROFILER.aggregate().items()},
        })
        return True
    return False


def warm_up(torch_device: str) -> None:
    """Import the simulator and the sweep stack and, on the card, make
    the CUDA context and load ``microgrid_scan`` (building it if no
    library of its sources is there yet)."""
    import torch

    import repro_torch.sim                                      # noqa: F401
    from repro_torch.sweep.device import execute_device_grid    # noqa: F401
    from repro_torch.sweep.vectorized import execute_scenario_group  # noqa: F401
    if torch.device(torch_device).type == "cuda":
        from repro_torch.kernels import _build
        torch.zeros(1, device=torch_device)
        torch.cuda.synchronize(torch_device)
        _build.load("microgrid_scan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sweep.worker",
        description="claim and execute sweep shards from a shared "
                    "work queue (see repro_torch.sweep.remote)")
    ap.add_argument("queue", type=Path,
                    help="queue directory shared with the coordinator")
    ap.add_argument("--mode", default="inherit",
                    choices=("inherit", "auto", "vectorized", "device"),
                    help="per-shard execution mode (default: whatever "
                         "the coordinator ran with)")
    ap.add_argument("--torch-device", default=None,
                    help="torch device of the shards' tensor work "
                         "(default: the CUDA card; 'cpu' runs it on the "
                         "host); only jobs of its type are taken")
    ap.add_argument("--poll-s", type=float, default=0.05,
                    help="idle poll period (default 0.05s)")
    ap.add_argument("--idle-timeout-s", type=float, default=None,
                    help="exit after this long without claimable work")
    ap.add_argument("--once", action="store_true",
                    help="drain the current backlog, then exit")
    ap.add_argument("--worker-id", default=None,
                    help="stable identity in claims/manifests "
                         "(default: host-pid-rand)")
    ap.add_argument("--crash-after-groups", type=int, default=None,
                    help=argparse.SUPPRESS)   # test hook
    args = ap.parse_args(argv)

    device = resolve_device(args.torch_device)
    torch_device = str(device)
    worker_id = args.worker_id or \
        f"{os.uname().nodename}-{os.getpid()}-{uuid.uuid4().hex[:4]}"
    crash_after = args.crash_after_groups
    if crash_after is None and os.environ.get(remote.ENV_CRASH_AFTER_GROUPS):
        crash_after = int(os.environ[remote.ENV_CRASH_AFTER_GROUPS])

    # warm the execution stack BEFORE registering as alive, so
    # wait_for_workers() measures resident-cluster dispatch, not
    # import, context and kernel-load cost
    t0 = time.perf_counter()
    warm_up(torch_device)
    warmup_s = time.perf_counter() - t0

    queue: Path = args.queue
    workers_dir = queue / "workers"
    workers_dir.mkdir(parents=True, exist_ok=True)
    alive = workers_dir / f"{worker_id}.alive"
    alive.write_text(json.dumps({"pid": os.getpid(),
                                 "started": time.time(),
                                 "torch_device": torch_device,
                                 "warmup_s": warmup_s}))
    print(f"[worker {worker_id}] watching {queue} on {torch_device} "
          f"(warm-up {warmup_s:.3f} s)", flush=True)

    last_work = time.monotonic()
    try:
        while True:
            if (queue / "stop").exists():
                print(f"[worker {worker_id}] stop file — exiting",
                      flush=True)
                return 0
            worked = False
            for job_dir, meta in _open_jobs(queue, device.type):
                while _work_one_shard(job_dir, meta, worker_id,
                                      args.mode, crash_after,
                                      torch_device):
                    worked = True
                    last_work = time.monotonic()
            if worked:
                continue
            if args.once:
                return 0
            if args.idle_timeout_s is not None and \
                    time.monotonic() - last_work > args.idle_timeout_s:
                print(f"[worker {worker_id}] idle "
                      f"{args.idle_timeout_s}s — exiting", flush=True)
                return 0
            time.sleep(args.poll_s)
    except KeyboardInterrupt:
        return 0
    finally:
        try:
            alive.unlink()
        except OSError:
            pass


if __name__ == "__main__":
    sys.exit(main())
