"""Cluster-scale sweep backend: a leased trace-group work queue over
the shared ``ResultCache`` (``SweepRunner(backend="remote")``;
counterpart of ``repro.sweep.remote``).

The content-addressed cache layout already IS a shared result store —
writes are atomic (tmp + rename) and keys are config digests — so the
only thing a cluster needs on top of it is a work queue. This module
implements that queue as plain files on the same shared filesystem:

* the **coordinator** enumerates cache-missed scenarios, groups them by
  trace digest (``repro_torch.sweep.vectorized.group_by_trace``), packs the
  groups into size-balanced *shards* (greedy LPT over estimated stage
  counts, ``pack_shards``) and publishes one pickled shard file per
  shard under ``<queue>/job-<id>/pending/``;
* **workers** (``python -m repro_torch.sweep.worker``, same host or any host
  sharing the filesystem) claim shards by atomically renaming them into
  ``running/`` (exactly one rename wins), refresh the lease by touching
  the running file's mtime from a heartbeat thread, evaluate each
  shard's groups through the existing vectorized/device paths, write
  the records straight into the shared cache, and publish a JSON
  completion manifest (per-shard stats + ``SpanProfiler`` phase
  aggregate) under ``done/``;
* the coordinator tails ``done/``, **reclaims expired leases** (a
  crashed or wedged worker's shard is renamed back to ``pending/`` with
  its attempt count bumped — bounded by ``max_attempts``, after which
  the shard is quarantined under ``failed/``), merges the workers'
  phase aggregates and stats counters, and finally assembles the
  records by reading them back from the shared cache.

Correctness under crashes falls out of determinism + content
addressing: re-executing a shard produces bit-identical records under
the same keys, and cache writes are atomic — so a shard that is
executed twice (a slow worker racing its own lease expiry) converges
to exactly one record per scenario, never a torn or duplicated entry.
Records from remote workers are bit-identical to in-process execution
on the same device type (workers run the same
``execute_scenario_group`` / ``execute_device_grid`` paths);
``verify_groups`` makes the coordinator re-run a sample in its own
process and assert that equality per job.

Shard payloads are pickled (trusted shared filesystem, same codebase
on every host — the payload embeds ``SCHEMA_VERSION`` and workers skip
jobs whose schema does not match their own, so version skew degrades
to "no matching worker" instead of silent divergence).

Which device computes a job: ``job.json`` and every shard payload carry
the coordinator's torch device type (``cpu`` or ``cuda``) beside the
schema, and the base cache root, under which each side's
``ResultCache(root, torch_device=...)`` opens the subdirectory of that
type. A worker computes only the jobs of its own device type: one
without a card never computes a ``cuda`` job on the host.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
import uuid
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs.log import get_logger
from repro_torch.obs.spans import PROFILER
from repro_torch.sweep.cache import ResultCache
from repro_torch.sweep.grid import SCHEMA_VERSION, Scenario
from repro_torch.sweep.vectorized import estimate_group_cost, group_by_trace

_log = get_logger("repro_torch.sweep.remote")

#: queue sub-directories a shard file moves through (the directory IS
#: the shard's state; transitions are single atomic renames)
PENDING, RUNNING, DONE, FAILED = "pending", "running", "done", "failed"

#: crash-injection hook for the retry tests: a worker whose environment
#: sets this executes N groups of its first shard, then dies without
#: completing it (``os._exit``) — exercising lease expiry + reclaim
ENV_CRASH_AFTER_GROUPS = "REPRO_WORKER_CRASH_AFTER_GROUPS"


@dataclasses.dataclass
class RemoteOptions:
    """Coordinator knobs for the remote backend."""
    queue_dir: Optional[Path] = None    # default: <cache_root>/.queue
    spawn_workers: int = 0              # local convenience workers
    n_shards: Optional[int] = None      # default: shards_per_worker heur.
    shards_per_worker: int = 4          # over-decompose for work stealing
    lease_s: float = 30.0               # heartbeat staleness => reclaim
    poll_s: float = 0.05                # coordinator/worker poll period
    max_attempts: int = 3               # attempts before quarantine
    timeout_s: float = 3600.0           # whole-job wall-clock guard
    worker_mode: str = "inherit"        # spawned workers' --mode
    verify_groups: int = 0              # re-run N groups here, assert
    # per-spawned-worker extra environment (test hook: crash injection)
    worker_env: Optional[List[Dict[str, str]]] = None


@dataclasses.dataclass
class RemoteStats:
    """What the coordinator observed for one job."""
    shards: int = 0
    trace_groups: int = 0
    lease_expired: int = 0
    retried: int = 0          # re-pended shards (expiry or worker error)
    quarantined: int = 0
    workers: int = 0          # distinct worker ids seen in manifests
    verified_groups: int = 0


# --------------------------------------------------------------------------
# shard packing: greedy LPT over estimated stage counts
# --------------------------------------------------------------------------

def pack_shards(costs: Sequence[float], n_shards: int) -> List[List[int]]:
    """Partition item indices into ``n_shards`` balanced bins by greedy
    LPT (longest processing time first): sort descending, always assign
    to the least-loaded bin. Guarantees makespan <= total/n + max(cost)
    and preserves the exact index multiset (hypothesis-pinned in
    tests/test_remote.py). Deterministic: ties break on index, so every
    coordinator packs identically. Empty bins are dropped."""
    n_shards = max(1, min(int(n_shards), len(costs))) if costs else 1
    order = sorted(range(len(costs)), key=lambda i: (-costs[i], i))
    bins: List[List[int]] = [[] for _ in range(n_shards)]
    loads = [0.0] * n_shards
    for i in order:
        j = min(range(n_shards), key=lambda k: (loads[k], k))
        bins[j].append(i)
        loads[j] += costs[i]
    return [b for b in bins if b]


# --------------------------------------------------------------------------
# filesystem protocol: atomic writes, claims, leases
# --------------------------------------------------------------------------

def _atomic_write_bytes(path: Path, data: bytes) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def same_metrics(a: dict, b: dict) -> bool:
    """Bit-for-bit equality of two records' metrics, NaN equal to NaN (a
    co-sim without a battery has no state of charge): their JSON text,
    which spells every float by its shortest round-tripping repr, so
    -0.0 differs from 0.0 and 1 from 1.0."""
    return (json.dumps(a, sort_keys=True, default=str)
            == json.dumps(b, sort_keys=True, default=str))


def atomic_write_json(path: Path, obj) -> None:
    _atomic_write_bytes(Path(path),
                        json.dumps(obj, indent=1, default=str).encode())


def shard_file_name(shard: int, attempt: int, worker: str = "") -> str:
    suffix = f".{worker}" if worker else ""
    return f"shard-{shard:04d}.a{attempt}{suffix}.pkl"


def parse_shard_name(name: str) -> Tuple[int, int, Optional[str]]:
    """``shard-0007.a2[.worker].pkl`` -> (7, 2, worker|None)."""
    stem = name[:-len(".pkl")]
    head, attempt_part, *rest = stem.split(".", 2)
    shard = int(head.split("-", 1)[1])
    attempt = int(attempt_part[1:])
    return shard, attempt, (rest[0] if rest else None)


def publish_shard(job_dir: Path, shard: int, payload: dict) -> Path:
    path = job_dir / PENDING / shard_file_name(shard, 0)
    _atomic_write_bytes(path, pickle.dumps(
        payload, protocol=pickle.HIGHEST_PROTOCOL))
    return path


def claim_shard(job_dir: Path, name: str, worker_id: str
                ) -> Optional[Tuple[dict, Path]]:
    """Atomically claim one pending shard by renaming it into
    ``running/`` tagged with the worker id — exactly one concurrent
    claimer's rename succeeds; the rest see FileNotFoundError and move
    on. Returns ``(payload, running_path)`` or None if lost the race.
    The running file's mtime is the lease: the claim itself refreshes
    it, the worker's heartbeat keeps refreshing it."""
    shard, attempt, _ = parse_shard_name(name)
    src = job_dir / PENDING / name
    dst = job_dir / RUNNING / shard_file_name(shard, attempt, worker_id)
    try:
        os.rename(src, dst)
    except FileNotFoundError:
        return None
    os.utime(dst)
    try:
        payload = pickle.loads(dst.read_bytes())
    except Exception as exc:     # unreadable payload: quarantine it
        atomic_write_json(job_dir / FAILED / f"shard-{shard:04d}.json",
                          {"shard": shard, "attempts": attempt,
                           "error": f"unreadable payload: {exc!r}"})
        try:
            os.rename(dst, job_dir / FAILED / dst.name)
        except OSError:
            pass
        return None
    return payload, dst


def heartbeat(running_path: Path) -> bool:
    """Refresh a claimed shard's lease; False if it was reclaimed."""
    try:
        os.utime(running_path)
        return True
    except OSError:
        return False


def complete_shard(job_dir: Path, running_path: Path,
                   manifest: dict) -> None:
    """Publish the completion manifest, then release the lease. The
    manifest lands first so a crash between the two steps errs toward
    "done" (the records are already in the cache); a duplicate done
    manifest from a lease-raced re-execution simply overwrites with
    equivalent content (deterministic records)."""
    shard = parse_shard_name(running_path.name)[0]
    atomic_write_json(job_dir / DONE / f"shard-{shard:04d}.json", manifest)
    try:
        running_path.unlink()
    except FileNotFoundError:
        pass                     # reclaimed while we finished: harmless


def release_shard(job_dir: Path, running_path: Path, max_attempts: int,
                  error: str) -> str:
    """Return a claimed shard to ``pending/`` with its attempt count
    bumped, or quarantine it under ``failed/`` once attempts are
    exhausted. Returns "retried" | "quarantined" | "gone" (someone else
    already moved it)."""
    shard, attempt, _ = parse_shard_name(running_path.name)
    nxt = attempt + 1
    if nxt >= max_attempts:
        atomic_write_json(job_dir / FAILED / f"shard-{shard:04d}.json",
                          {"shard": shard, "attempts": nxt,
                           "error": error})
        try:
            os.rename(running_path,
                      job_dir / FAILED / shard_file_name(shard, nxt))
        except FileNotFoundError:
            return "gone"
        return "quarantined"
    try:
        os.rename(running_path,
                  job_dir / PENDING / shard_file_name(shard, nxt))
    except FileNotFoundError:
        return "gone"
    return "retried"


def reclaim_expired(job_dir: Path, lease_s: float, max_attempts: int
                    ) -> Tuple[int, int, int]:
    """Coordinator-side lease sweep over ``running/``: any claim whose
    mtime is staler than ``lease_s`` belongs to a crashed or wedged
    worker — re-pend it (or quarantine after ``max_attempts``).
    Returns (expired, retried, quarantined) counts."""
    expired = retried = quarantined = 0
    now = time.time()
    for path in sorted((job_dir / RUNNING).glob("shard-*.pkl")):
        try:
            age = now - path.stat().st_mtime
        except FileNotFoundError:
            continue             # completed or reclaimed under us
        if age <= lease_s:
            continue
        outcome = release_shard(job_dir, path, max_attempts,
                                f"lease expired after {age:.1f}s")
        if outcome == "gone":
            continue
        expired += 1
        if outcome == "retried":
            retried += 1
        else:
            quarantined += 1
    return expired, retried, quarantined


# --------------------------------------------------------------------------
# worker process management (local convenience spawns + tests)
# --------------------------------------------------------------------------

def spawn_worker(queue_dir: Path, worker_id: Optional[str] = None,
                 mode: str = "inherit", poll_s: float = 0.05,
                 env: Optional[Dict[str, str]] = None,
                 log_path: Optional[Path] = None,
                 torch_device: DeviceLike = None) -> subprocess.Popen:
    """Start a detached ``python -m repro_torch.sweep.worker`` on this
    host, computing on ``torch_device`` (``None``: the card; the worker
    raises without one). Cluster deployments start the same command on
    any host sharing the filesystem; this helper exists for the
    coordinator's ``spawn_workers`` convenience and the tests. The
    worker inherits this process's environment as it is (the visible
    devices included), plus ``env``."""
    import repro_torch
    pkg_root = str(Path(repro_torch.__file__).resolve().parent.parent)
    full_env = dict(os.environ)
    full_env.update(env or {})
    full_env["PYTHONPATH"] = pkg_root + os.pathsep + \
        full_env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "repro_torch.sweep.worker", str(queue_dir),
           "--mode", mode, "--poll-s", str(poll_s)]
    if worker_id:
        cmd += ["--worker-id", worker_id]
    if torch_device is not None:
        cmd += ["--torch-device", str(torch_device)]
    out = open(log_path, "ab") if log_path else subprocess.DEVNULL
    try:
        return subprocess.Popen(cmd, env=full_env, stdout=out,
                                stderr=subprocess.STDOUT)
    finally:
        if log_path:
            out.close()


def wait_for_workers(queue_dir: Path, n: int, timeout_s: float = 120.0
                     ) -> List[str]:
    """Block until ``n`` workers have registered under
    ``<queue>/workers/`` (each worker touches its alive file once its
    execution stack is warm: on the card, its CUDA context made and
    ``microgrid_scan`` loaded) — so a caller times resident-cluster
    dispatch rather than cold starts."""
    deadline = time.monotonic() + timeout_s
    workers_dir = Path(queue_dir) / "workers"
    while True:
        alive = sorted(p.stem for p in workers_dir.glob("*.alive")) \
            if workers_dir.exists() else []
        if len(alive) >= n:
            return alive
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"{len(alive)}/{n} workers registered under "
                f"{workers_dir} within {timeout_s}s")
        time.sleep(0.05)


# --------------------------------------------------------------------------
# coordinator
# --------------------------------------------------------------------------

class RemoteCoordinator:
    """Publish a job's shards, tail completion, merge, fetch.

    ``execute(todo)`` returns ``(records, RemoteStats)`` with records
    aligned to ``todo`` — the drop-in remote counterpart of the local
    execution backends in ``SweepRunner``. The job names the type of
    ``torch_device`` (``None``: the card, raising without one), which
    must be the cache's; ``verify_groups`` re-runs on it.
    """

    def __init__(self, cache: ResultCache, opts: Optional[RemoteOptions]
                 = None, mode: str = "vectorized", note=None,
                 torch_device: DeviceLike = None):
        if cache is None:
            raise ValueError("the remote backend requires a shared "
                             "ResultCache (workers write records into it)")
        if mode not in ("vectorized", "device"):
            raise ValueError(
                f"remote backend ships whole trace groups; mode {mode!r} "
                "is not supported (use 'vectorized' or 'device')")
        dev = resolve_device(torch_device)
        if cache.device_type != dev.type:
            raise ValueError(
                f"the cache holds {cache.device_type} records, but this "
                f"job computes on {dev}")
        self.cache = cache
        self.opts = opts or RemoteOptions()
        self.mode = mode
        self.note = note or (lambda msg: None)
        self.torch_device = str(dev)
        self.device_type = dev.type

    # ---- job setup ----

    def _queue_dir(self) -> Path:
        if self.opts.queue_dir is not None:
            return Path(self.opts.queue_dir)
        return self.cache.root / ".queue"

    def _publish(self, todo: Sequence[Scenario]) -> Tuple[Path, int, int]:
        groups = group_by_trace(todo)
        group_scs = [[todo[i] for i in g] for g in groups]
        costs = [estimate_group_cost(g) for g in group_scs]
        workers_hint = max(self.opts.spawn_workers, 2)
        n_shards = self.opts.n_shards or \
            self.opts.shards_per_worker * workers_hint
        shards = pack_shards(costs, n_shards)

        queue = self._queue_dir()
        job_id = f"{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}-" \
                 f"{uuid.uuid4().hex[:6]}"
        job_dir = queue / f"job-{job_id}"
        for state in (PENDING, RUNNING, DONE, FAILED):
            (job_dir / state).mkdir(parents=True, exist_ok=True)
        atomic_write_json(job_dir / "job.json", {
            "job": job_id, "status": "open", "schema": SCHEMA_VERSION,
            "torch_device": self.device_type,
            "mode": self.mode, "n_shards": len(shards),
            "lease_s": self.opts.lease_s,
            "max_attempts": self.opts.max_attempts,
            # the base root: ResultCache appends the device type itself
            "cache_root": str(Path(self.cache.root).parent.resolve()),
            "created": time.time(),
        })
        with PROFILER.span("remote.publish"):
            for sid, gidxs in enumerate(shards):
                publish_shard(job_dir, sid, {
                    "job": job_id, "shard": sid,
                    "schema": SCHEMA_VERSION,
                    "torch_device": self.device_type, "mode": self.mode,
                    "groups": [group_scs[g] for g in gidxs],
                })
        self.note(f"published {len(shards)} shard(s) covering "
                  f"{len(groups)} trace group(s) to {job_dir}")
        return job_dir, len(shards), len(groups)

    def _spawn(self, queue: Path, job_dir: Path
               ) -> List[subprocess.Popen]:
        procs = []
        envs = list(self.opts.worker_env or [])
        for i in range(self.opts.spawn_workers):
            extra = envs[i] if i < len(envs) else {}
            procs.append(spawn_worker(
                queue, worker_id=f"w{i}", mode=self.opts.worker_mode,
                poll_s=self.opts.poll_s, env=extra,
                log_path=job_dir / f"worker-w{i}.log",
                torch_device=self.device_type))
        return procs

    # ---- completion tail ----

    def _tail(self, job_dir: Path, n_shards: int, stats: RemoteStats,
              procs: Sequence[subprocess.Popen] = ()) -> Dict[int, dict]:
        deadline = time.monotonic() + self.opts.timeout_s
        manifests: Dict[int, dict] = {}
        failed: Dict[int, dict] = {}
        while True:
            for path in sorted((job_dir / DONE).glob("shard-*.json")):
                sid = int(path.stem.split("-", 1)[1])
                if sid not in manifests:
                    manifests[sid] = json.loads(path.read_text())
            exp, ret, quar = reclaim_expired(
                job_dir, self.opts.lease_s, self.opts.max_attempts)
            stats.lease_expired += exp
            stats.retried += ret
            stats.quarantined += quar
            for path in sorted((job_dir / FAILED).glob("shard-*.json")):
                sid = int(path.stem.split("-", 1)[1])
                failed.setdefault(sid, json.loads(path.read_text()))
            # a done shard's stale duplicates (re-pended by an expiry
            # the original worker outran) are dead work: drop them
            for state in (PENDING, RUNNING):
                for path in (job_dir / state).glob("shard-*.pkl"):
                    if parse_shard_name(path.name)[0] in manifests:
                        try:
                            path.unlink()
                        except OSError:
                            pass
            # "failed" only counts if no execution ever completed it
            dead = {sid: m for sid, m in failed.items()
                    if sid not in manifests}
            if len(manifests) + len(dead) >= n_shards:
                if dead:
                    raise RuntimeError(
                        f"{len(dead)} shard(s) quarantined after "
                        f"{self.opts.max_attempts} attempts: " + "; ".join(
                            f"shard {sid}: {m.get('error', '?')}"
                            for sid, m in sorted(dead.items())))
                return manifests
            if (procs and all(p.poll() is not None for p in procs)
                    and not any((job_dir / RUNNING).glob("shard-*.pkl"))):
                # every worker this coordinator spawned has exited (a
                # worker on the card exits on its first error) and no
                # claim is live: nothing will finish the job
                raise RuntimeError(
                    f"all {len(procs)} spawned worker(s) exited with "
                    f"{n_shards - len(manifests)} shard(s) unfinished; "
                    f"see the worker-*.log files in {job_dir}")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"remote job incomplete after {self.opts.timeout_s}s: "
                    f"{len(manifests)}/{n_shards} shards done "
                    f"(queue {job_dir})")
            time.sleep(self.opts.poll_s)

    # ---- record fetch + verification ----

    def _fetch(self, todo: Sequence[Scenario]) -> List[dict]:
        records = []
        with PROFILER.span("remote.collect"):
            for sc in todo:
                rec = self.cache.get(sc.key)
                if rec is None:
                    raise RuntimeError(
                        f"shard manifests complete but record {sc.key} "
                        f"({sc.tag}) is missing from the shared cache")
                records.append({**rec, "meta": dict(rec.get("meta", {}))})
        return records

    def _verify(self, todo: Sequence[Scenario], records: List[dict],
                stats: RemoteStats) -> None:
        """Re-run a sample of trace groups in this process, on this
        coordinator's device and in the job's mode, and assert the
        workers' records are bit-identical. The device mode qualifies
        too: its grid program's per-group sums do not depend on which
        groups share the batch (``repro_torch.sweep.device``)."""
        if not self.opts.verify_groups:
            return
        from repro_torch.sweep.device import execute_device_grid
        from repro_torch.sweep.vectorized import execute_scenario_group
        by_key = {sc.key: rec for sc, rec in zip(todo, records)}
        groups = group_by_trace(todo)
        for g in groups[:self.opts.verify_groups]:
            scs = [todo[i] for i in g]
            if self.mode == "device":
                local = execute_device_grid(
                    scs, torch_device=self.torch_device)[0]
            else:
                local = execute_scenario_group(
                    scs, torch_device=self.torch_device)
            for rec in local:
                remote_rec = by_key[rec["key"]]
                if not same_metrics(rec["metrics"], remote_rec["metrics"]):
                    raise AssertionError(
                        "remote record diverges from in-process execution "
                        f"for {rec['scenario']} (key {rec['key']})")
            stats.verified_groups += 1
        self.note(f"verified {stats.verified_groups} trace group(s) "
                  "bit-identical to in-process execution")

    # ---- the whole job ----

    def execute(self, todo: Sequence[Scenario]
                ) -> Tuple[List[dict], RemoteStats]:
        stats = RemoteStats()
        queue = self._queue_dir()
        job_dir, stats.shards, stats.trace_groups = self._publish(todo)
        procs = self._spawn(queue, job_dir)
        status = "failed"
        try:
            with PROFILER.span("remote.tail"):
                manifests = self._tail(job_dir, stats.shards, stats, procs)
            status = "done"
        finally:
            # flip the job closed first so watch-mode workers stop
            # rescanning it, then reap our own convenience spawns
            meta = json.loads((job_dir / "job.json").read_text())
            meta["status"] = status
            atomic_write_json(job_dir / "job.json", meta)
            for p in procs:
                p.terminate()
            for p in procs:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()

        # merge the workers' wall-clock phase aggregates (cross-process
        # merge: counts and totals only — see repro_torch.obs.spans) and
        # persist the merged profile next to the job for CI artifacts
        merged: Dict[str, Dict[str, float]] = {}
        workers = set()
        for m in manifests.values():
            workers.add(m.get("worker", "?"))
            for name, a in (m.get("phases") or {}).items():
                agg = merged.setdefault(name, {"count": 0, "total_s": 0.0})
                agg["count"] += int(a["count"])
                agg["total_s"] += float(a["total_s"])
        stats.workers = len(workers)
        if PROFILER.enabled and merged:
            PROFILER.merge(merged)
        atomic_write_json(job_dir / "profile.json", merged)

        records = self._fetch(todo)
        self._verify(todo, records, stats)
        atomic_write_json(job_dir / "stats.json",
                          dataclasses.asdict(stats))
        self.note(f"remote job complete: {stats.shards} shard(s) on "
                  f"{stats.workers} worker(s), {stats.lease_expired} "
                  f"expired lease(s), {stats.retried} retried, "
                  f"{stats.quarantined} quarantined")
        return records, stats
