"""The port's remote sweep backend (``repro_torch.sweep.remote`` and
``repro_torch.sweep.worker``) on the CPU.

- ``tests/test_remote.py``'s tier-1 tests against the port: shard packing
  (the reference's bins on the same costs), the queue protocol (claims,
  leases, retries, quarantine), mode choice and the runner's checks.
- What the port adds: jobs and shards name the coordinator's torch device
  type and the base cache root; a worker skips a job of another device
  type; ``spawn_worker`` passes the environment on untouched.
- Device mode's records of a group do not depend on which other groups
  share its batch (the workers evaluate subsets of the grid).
- One end-to-end run through a spawned ``--torch-device cpu`` worker:
  records bit-identical to in-process execution, and against the
  reference's records host columns bitwise and Eq. 1 columns within
  ``DEVICE_MODE_RTOL``.
- The reference's three slow tests, mirrored under ``slow``.
"""
import json
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.obs.diff as r_diff
import repro.sweep.remote as r_remote
from repro.configs.paper_models import LLAMA3_8B as R_LLAMA3_8B
from repro.sim import SchedulerConfig as RSchedulerConfig
from repro.sim import SimConfig as RSimConfig
from repro.sim import WorkloadConfig as RWorkloadConfig
from repro.sweep import GridSpec as RGridSpec
from repro.sweep import SweepRunner as RSweepRunner
from repro_torch.configs.paper_models import LLAMA3_8B
from repro_torch.sim import SchedulerConfig, SimConfig, WorkloadConfig
from repro_torch.sweep import (GridSpec, ResultCache, SweepRunner,
                               pack_shards, remote, worker)
from repro_torch.sweep.device import _row_sums, execute_device_grid
from repro_torch.sweep.remote import (ENV_CRASH_AFTER_GROUPS,
                                      RemoteCoordinator, RemoteOptions,
                                      claim_shard, parse_shard_name,
                                      publish_shard, reclaim_expired,
                                      release_shard, shard_file_name,
                                      spawn_worker, wait_for_workers)
from repro_torch.sweep.scenarios import SWEEPS
from repro_torch.sweep.worker import choose_mode

from _hypothesis_support import given, settings, st

CPU = "cpu"


def tiny_base(n_requests=10, pkg="port"):
    sim, wl, sched, model = (
        (SimConfig, WorkloadConfig, SchedulerConfig, LLAMA3_8B)
        if pkg == "port" else
        (RSimConfig, RWorkloadConfig, RSchedulerConfig, R_LLAMA3_8B))
    return sim(model=model,
               workload=wl(n_requests=n_requests, qps=4.0, min_len=64,
                           max_len=256, seed=0),
               scheduler=sched(batch_cap=8))


def tiny_grid(n_configs=3, n_report=4, pkg="port"):
    """n_configs trace groups x n_report shared-trace scenarios."""
    spec = GridSpec if pkg == "port" else RGridSpec
    return spec(base=tiny_base(pkg=pkg),
                axes={"workload.qps": [2.0 + i for i in range(n_configs)],
                      "pue": [1.0 + 0.1 * k for k in range(n_report)]}
                ).expand()


def cpu_cache(path):
    return ResultCache(path, torch_device=CPU)


# --------------------------------------------------------------------------
# shard packing
# --------------------------------------------------------------------------

@given(costs=st.lists(st.floats(min_value=0.0, max_value=1e6,
                                allow_nan=False), min_size=1,
                      max_size=64),
       n_shards=st.integers(min_value=1, max_value=16))
@settings(max_examples=200, deadline=None)
def test_pack_shards_preserves_multiset_and_lpt_bound(costs, n_shards):
    shards = pack_shards(costs, n_shards)
    assert shards == r_remote.pack_shards(costs, n_shards)
    flat = sorted(i for s in shards for i in s)
    assert flat == list(range(len(costs)))
    assert all(s for s in shards)
    k = max(1, min(n_shards, len(costs)))
    loads = [sum(costs[i] for i in s) for s in shards]
    assert max(loads) <= sum(costs) / k + max(costs) + 1e-6


def test_pack_shards_deterministic_and_balanced():
    costs = [100.0, 1.0, 1.0, 1.0, 50.0, 49.0]
    a = pack_shards(costs, 2)
    assert a == pack_shards(costs, 2) == r_remote.pack_shards(costs, 2)
    loads = sorted(sum(costs[i] for i in s) for s in a)
    assert loads == [101.0, 101.0]


def test_pack_shards_more_shards_than_items():
    shards = pack_shards([3.0, 1.0], 8)
    assert shards == r_remote.pack_shards([3.0, 1.0], 8)
    assert sorted(i for s in shards for i in s) == [0, 1]
    assert len(shards) == 2


# --------------------------------------------------------------------------
# queue protocol: claims, leases, retries, quarantine
# --------------------------------------------------------------------------

def _job_dir(tmp_path):
    job = tmp_path / "job-t"
    for state in (remote.PENDING, remote.RUNNING, remote.DONE,
                  remote.FAILED):
        (job / state).mkdir(parents=True)
    return job


def test_shard_name_roundtrip():
    assert parse_shard_name(shard_file_name(7, 2)) == (7, 2, None)
    assert parse_shard_name(shard_file_name(7, 2, "w0")) == (7, 2, "w0")
    assert shard_file_name(7, 2, "w0") == r_remote.shard_file_name(7, 2, "w0")


def test_claim_is_exclusive(tmp_path):
    job = _job_dir(tmp_path)
    name = publish_shard(job, 0, {"shard": 0, "groups": []}).name
    first = claim_shard(job, name, "w0")
    assert first is not None
    assert claim_shard(job, name, "w1") is None
    payload, running = first
    assert payload["shard"] == 0
    assert running.exists()
    assert parse_shard_name(running.name) == (0, 0, "w0")


def test_lease_expiry_bumps_attempt_then_quarantines(tmp_path):
    job = _job_dir(tmp_path)
    name = publish_shard(job, 3, {"shard": 3, "groups": []}).name
    for expected_attempt in (1, 2):
        _, running = claim_shard(job, name, "w0")
        old = time.time() - 3600
        os.utime(running, (old, old))
        exp, ret, quar = reclaim_expired(job, lease_s=5.0, max_attempts=3)
        assert (exp, ret, quar) == (1, 1, 0)
        pend = list((job / remote.PENDING).glob("shard-*.pkl"))
        assert len(pend) == 1
        name = pend[0].name
        assert parse_shard_name(name)[1] == expected_attempt
    _, running = claim_shard(job, name, "w0")
    outcome = release_shard(job, running, max_attempts=3, error="boom")
    assert outcome == "quarantined"
    assert not list((job / remote.PENDING).glob("shard-*.pkl"))
    manifest = json.loads(
        (job / remote.FAILED / "shard-0003.json").read_text())
    assert manifest["error"] == "boom" and manifest["attempts"] == 3


def test_heartbeat_refreshes_lease(tmp_path):
    job = _job_dir(tmp_path)
    name = publish_shard(job, 0, {"shard": 0, "groups": []}).name
    _, running = claim_shard(job, name, "w0")
    old = time.time() - 3600
    os.utime(running, (old, old))
    assert remote.heartbeat(running)
    assert reclaim_expired(job, lease_s=5.0, max_attempts=3) == (0, 0, 0)
    running.unlink()
    assert not remote.heartbeat(running)


def test_unreadable_payload_is_quarantined(tmp_path):
    job = _job_dir(tmp_path)
    path = job / remote.PENDING / shard_file_name(4, 0)
    path.write_bytes(b"not a pickle")
    assert claim_shard(job, path.name, "w0") is None
    assert (job / remote.FAILED / "shard-0004.json").exists()


def test_choose_mode():
    payload = {"mode": "vectorized",
               "groups": [[type("S", (), {"cfg": tiny_base()})()]]}
    assert choose_mode("inherit", payload) == "vectorized"
    assert choose_mode("device", payload) == "device"
    assert choose_mode("auto", payload) == "device"


# --------------------------------------------------------------------------
# runner integration + validation
# --------------------------------------------------------------------------

def test_remote_backend_requires_cache_and_rejects_probe(tmp_path):
    with pytest.raises(ValueError, match="requires a ResultCache"):
        SweepRunner(cache=None, backend="remote", torch_device=CPU)
    with pytest.raises(ValueError, match="unknown backend"):
        SweepRunner(backend="carrier-pigeon", torch_device=CPU)
    cache = cpu_cache(tmp_path)
    with pytest.raises(ValueError, match="trace groups"):
        SweepRunner(cache=cache, backend="remote", mode="event_loop",
                    torch_device=CPU)
    from repro_torch.obs.probe import NULL_PROBE
    with pytest.raises(ValueError, match="probe"):
        SweepRunner(cache=cache, backend="remote", probe=NULL_PROBE,
                    torch_device=CPU)


def test_coordinator_rejects_fully_quarantined_job(tmp_path):
    """A poison shard that exhausts its attempts fails the job loudly
    instead of returning partial records."""
    scenarios = tiny_grid(n_configs=1, n_report=2)
    cache = cpu_cache(tmp_path / "cache")
    opts = RemoteOptions(queue_dir=tmp_path / "q", spawn_workers=0,
                         n_shards=1, lease_s=0.2, poll_s=0.05,
                         max_attempts=1, timeout_s=60)
    out = {}

    def coordinate():
        try:
            SweepRunner(cache=cache, backend="remote", remote=opts,
                        torch_device=CPU).run(scenarios)
        except RuntimeError as exc:
            out["err"] = exc
    t = threading.Thread(target=coordinate)
    t.start()
    deadline = time.monotonic() + 30
    claimed = None
    while claimed is None and time.monotonic() < deadline:
        for job in sorted((tmp_path / "q").glob("job-*")):
            for p in (job / remote.PENDING).glob("shard-*.pkl"):
                claimed = claim_shard(job, p.name, "dead-worker")
                if claimed:
                    break
        time.sleep(0.05)
    assert claimed is not None
    t.join(timeout=60)
    assert not t.is_alive()
    assert "quarantined" in str(out["err"])


def test_coordinator_raises_once_its_spawned_workers_all_exited(tmp_path):
    """A spawned worker that dies (here the injected crash, as a card
    worker exits on its first error) leaves nothing to finish the job: once
    its lease is reclaimed and no claim is live, the coordinator raises
    instead of waiting out ``timeout_s``."""
    scenarios = tiny_grid(n_configs=2, n_report=2)
    opts = RemoteOptions(queue_dir=tmp_path / "q", spawn_workers=1,
                         n_shards=1, lease_s=0.5, poll_s=0.05,
                         timeout_s=120,
                         worker_env=[{ENV_CRASH_AFTER_GROUPS: "1"}])
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="spawned worker"):
        SweepRunner(cache=cpu_cache(tmp_path / "cache"), backend="remote",
                    remote=opts, torch_device=CPU).run(scenarios)
    assert time.monotonic() - t0 < 60
    job = next((tmp_path / "q").glob("job-*"))
    assert list((job / remote.PENDING).glob("shard-0000.a1.pkl"))


def test_same_metrics_is_bitwise_and_nan_aware():
    nan = float("nan")
    assert remote.same_metrics({"a": 1.5, "b": nan}, {"b": nan, "a": 1.5})
    assert not remote.same_metrics({"a": 0.0}, {"a": -0.0})
    assert not remote.same_metrics({"a": 1}, {"a": 1.0})
    assert not remote.same_metrics({"a": 0.1 + 0.2}, {"a": 0.3})


def test_shard_payload_roundtrips_scenarios(tmp_path):
    scenarios = tiny_grid(n_configs=2, n_report=2)
    job = _job_dir(tmp_path)
    publish_shard(job, 0, {"shard": 0, "groups": [list(scenarios)]})
    payload, _ = claim_shard(job, shard_file_name(0, 0), "w0")
    thawed = payload["groups"][0]
    assert [sc.key for sc in thawed] == [sc.key for sc in scenarios]
    assert [sc.trace_key for sc in thawed] == \
        [sc.trace_key for sc in scenarios]
    assert thawed[0].cfg.workload.qps == scenarios[0].cfg.workload.qps


# --------------------------------------------------------------------------
# what the port adds: the job's device type, the base root, the env
# --------------------------------------------------------------------------

def _write_job(q, name, device_type, cache_root, scenarios):
    job = q / f"job-{name}"
    for state in (remote.PENDING, remote.RUNNING, remote.DONE,
                  remote.FAILED):
        (job / state).mkdir(parents=True)
    meta = {"job": name, "status": "open", "schema": remote.SCHEMA_VERSION,
            "torch_device": device_type, "mode": "vectorized",
            "n_shards": 1, "lease_s": 30.0, "max_attempts": 3,
            "cache_root": str(cache_root)}
    remote.atomic_write_json(job / "job.json", meta)
    publish_shard(job, 0, {"job": name, "shard": 0,
                           "schema": remote.SCHEMA_VERSION,
                           "torch_device": device_type,
                           "mode": "vectorized",
                           "groups": [list(scenarios)]})
    return job


def test_worker_skips_a_job_of_another_device_type(tmp_path):
    """A CPU worker's job scan passes over a ``cuda`` job: it never
    claims a shard there, so a card's job is never computed on the
    host."""
    scenarios = tiny_grid(n_configs=1, n_report=2)
    q = tmp_path / "q"
    card = _write_job(q, "a-card", "cuda", tmp_path / "cache", scenarios)
    host = _write_job(q, "b-host", "cpu", tmp_path / "cache", scenarios)
    assert [j for j, _ in worker._open_jobs(q, "cpu")] == [host]
    assert [j for j, _ in worker._open_jobs(q, "cuda")] == [card]
    # scanning and working the cpu worker's jobs leaves the card's alone
    for job_dir, meta in worker._open_jobs(q, "cpu"):
        while worker._work_one_shard(job_dir, meta, "w-cpu", "inherit",
                                     None, CPU):
            pass
    assert list((card / remote.PENDING).glob("shard-*.pkl"))
    assert not list((card / remote.DONE).glob("*.json"))
    done = json.loads((host / remote.DONE / "shard-0000.json").read_text())
    assert done["torch_device"] == CPU and done["n_records"] == 2
    assert len(cpu_cache(tmp_path / "cache")) == 2
    assert not (tmp_path / "cache" / "cuda").exists()


def test_job_names_its_device_type_and_the_base_cache_root(tmp_path):
    scenarios = tiny_grid(n_configs=2, n_report=2)
    cache = cpu_cache(tmp_path / "cache")
    coord = RemoteCoordinator(cache, RemoteOptions(queue_dir=tmp_path / "q"),
                              torch_device=CPU)
    job_dir, n_shards, n_groups = coord._publish(scenarios)
    assert n_groups == 2 and n_shards == 2
    meta = json.loads((job_dir / "job.json").read_text())
    assert meta["torch_device"] == CPU
    assert Path(meta["cache_root"]) == (tmp_path / "cache").resolve()
    # a worker's cache over that root is the coordinator's, not cpu/cpu/
    assert ResultCache(Path(meta["cache_root"]), torch_device=CPU).root \
        == cache.root.resolve()
    name = sorted(p.name for p in (job_dir / remote.PENDING).iterdir())[0]
    payload, _ = claim_shard(job_dir, name, "w0")
    assert payload["torch_device"] == CPU
    assert payload["schema"] == remote.SCHEMA_VERSION
    with pytest.raises(ValueError, match="cpu records"):
        RemoteCoordinator(cache, torch_device="meta")


def test_spawn_worker_passes_the_environment_on_untouched(monkeypatch,
                                                          tmp_path):
    """The worker gets this process's environment as it is, the visible
    devices included, and its torch device as a flag; no platform is
    forced on it."""
    seen = {}

    class _Popen:
        def __init__(self, cmd, env, stdout, stderr):
            seen.update(cmd=cmd, env=env)

    monkeypatch.setattr(subprocess, "Popen", _Popen)
    for visible in ("3", None):
        if visible is None:
            monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
        else:
            monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
        spawn_worker(tmp_path, "w0", torch_device="cuda",
                     env={"EXTRA": "1"})
        assert seen["env"].get("CUDA_VISIBLE_DEVICES") == visible
        assert seen["env"].get("JAX_PLATFORMS") == \
            os.environ.get("JAX_PLATFORMS")
        assert seen["env"]["EXTRA"] == "1"
        src = str(Path(__file__).resolve().parents[1] / "src")
        assert seen["env"]["PYTHONPATH"].split(os.pathsep)[0] == src
        cmd = seen["cmd"]
        assert cmd[1:4] == ["-m", "repro_torch.sweep.worker", str(tmp_path)]
        assert cmd[cmd.index("--torch-device") + 1] == "cuda"


def test_row_sums_do_not_depend_on_batch_or_padding():
    """Device mode's row sums: the same bits for a row whatever other rows
    share the batch and however far it is padded."""
    rng = np.random.default_rng(0)
    rows = [rng.random(m) * 10.0 ** rng.uniform(-3, 3, m)
            for m in (1, 7, 64, 1000, 3000)]

    def sums(rows, width, extra=0):
        x = torch.zeros(len(rows) + extra, width, dtype=torch.float64)
        for i, r in enumerate(rows):
            x[i, :len(r)] = torch.as_tensor(r)
        return _row_sums(x)[:len(rows)]

    alone = [sums([r], 4096).item() for r in rows]
    for width, extra in ((4096, 0), (8192, 3), (1 << 15, 11)):
        assert sums(rows, width, extra).tolist() == alone
    want = [float(np.sum(r)) for r in rows]
    np.testing.assert_allclose(alone, want, rtol=1e-13)


def test_device_mode_records_of_a_group_do_not_depend_on_its_batch():
    """Each trace group of a perf slice evaluated on its own gives the
    records of the whole slice's run, bit for bit."""
    scs = SWEEPS["perf"].build(True)[::32]
    whole, _ = execute_device_grid(scs, torch_device=CPU)
    by_key = {r["key"]: r["metrics"] for r in whole}
    from repro_torch.sweep.vectorized import group_by_trace
    groups = group_by_trace(scs)
    assert len(groups) > 2
    for g in groups:
        alone, _ = execute_device_grid([scs[i] for i in g], torch_device=CPU)
        assert [r["metrics"] for r in alone] == \
            [by_key[r["key"]] for r in alone]


# --------------------------------------------------------------------------
# end to end: spawned CPU workers
# --------------------------------------------------------------------------

def _stop_worker(q, proc):
    (q / "stop").touch()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def test_remote_run_through_a_spawned_cpu_worker(tmp_path):
    """A 2x2 grid through one spawned ``--torch-device cpu`` worker, in
    vectorized and in device mode: bit-identical to in-process execution
    on the CPU; against the reference's records, host columns bitwise and
    Eq. 1 columns within ``DEVICE_MODE_RTOL``."""
    scenarios = tiny_grid(n_configs=2, n_report=2)
    q = tmp_path / "q"
    proc = spawn_worker(q, "w0", torch_device=CPU,
                        log_path=tmp_path / "w0.log")
    try:
        wait_for_workers(q, 1, timeout_s=120)
        opts = RemoteOptions(queue_dir=q, spawn_workers=0, lease_s=15.0,
                             verify_groups=1, timeout_s=120)
        for mode in ("vectorized", "device"):
            cache = cpu_cache(tmp_path / f"cache-{mode}")
            records, stats = SweepRunner(
                cache=cache, backend="remote", remote=opts, mode=mode,
                torch_device=CPU).run(scenarios)
            assert stats.executed == len(scenarios) == 4
            assert (stats.shards, stats.trace_groups) == (2, 2)
            assert stats.remote_workers == 1
            assert stats.lease_expired == stats.quarantined == 0
            local, _ = SweepRunner(cache=None, mode=mode,
                                   torch_device=CPU).run(scenarios)
            assert [r["key"] for r in records] == [r["key"] for r in local]
            assert [r["metrics"] for r in records] == \
                [r["metrics"] for r in local], mode
            assert "remote: shards=2 workers=1" in stats.summary()
    finally:
        _stop_worker(q, proc)
    assert proc.returncode == 0, (tmp_path / "w0.log").read_text()

    ref, _ = RSweepRunner(cache=None, mode="event_loop").run(
        tiny_grid(n_configs=2, n_report=2, pkg="reference"))
    got = [cpu_cache(tmp_path / "cache-vectorized").get(sc.key)
           for sc in scenarios]
    assert [r["key"] for r in got] == [r["key"] for r in ref]
    res = r_diff.diff_records(ref, got)
    assert not res.only_a and not res.only_b
    for c in res.cells:
        assert c.contract in ("host-bitwise", "DEVICE_MODE_RTOL"), c.format()
        assert c.phase in ("power", "energy", "carbon"), c.format()


# --------------------------------------------------------------------------
# the reference's slow tests
# --------------------------------------------------------------------------

@pytest.mark.slow
def test_remote_run_matches_serial_bitwise(tmp_path):
    scenarios = tiny_grid(n_configs=4, n_report=3)
    cache = cpu_cache(tmp_path / "cache")
    opts = RemoteOptions(queue_dir=tmp_path / "q", spawn_workers=2,
                         lease_s=15.0, verify_groups=1, timeout_s=180)
    records, stats = SweepRunner(cache=cache, backend="remote", remote=opts,
                                 torch_device=CPU).run(scenarios)
    assert stats.executed == len(scenarios)
    assert stats.shards >= 1 and stats.remote_workers >= 1
    assert stats.lease_expired == 0 and stats.quarantined == 0

    ref, _ = SweepRunner(cache=None, mode="vectorized",
                         torch_device=CPU).run(scenarios)
    assert [r["metrics"] for r in records] == [r["metrics"] for r in ref]
    assert all(r["meta"]["cache_hit"] is False for r in records)

    again, stats2 = SweepRunner(cache=cache, backend="remote", remote=opts,
                                torch_device=CPU).run(scenarios)
    assert stats2.executed == 0
    assert stats2.cache_hits == len(scenarios)
    assert [r["metrics"] for r in again] == [r["metrics"] for r in ref]


@pytest.mark.slow
def test_injected_crash_converges_bit_identical(tmp_path):
    scenarios = tiny_grid(n_configs=4, n_report=3)
    cache = cpu_cache(tmp_path / "cache")
    q = tmp_path / "q"
    opts = RemoteOptions(queue_dir=q, spawn_workers=0, n_shards=2,
                         lease_s=1.0, poll_s=0.05, timeout_s=180)

    out = {}

    def coordinate():
        out["res"] = SweepRunner(cache=cache, backend="remote", remote=opts,
                                 torch_device=CPU).run(scenarios)
    t = threading.Thread(target=coordinate)
    t.start()
    try:
        pa = spawn_worker(q, "crashy", env={ENV_CRASH_AFTER_GROUPS: "1"},
                          log_path=tmp_path / "a.log", torch_device=CPU)
        assert pa.wait(timeout=120) == 17
        pb = spawn_worker(q, "steady", log_path=tmp_path / "b.log",
                          torch_device=CPU)
        t.join(timeout=150)
        pb.terminate()
        pb.wait(timeout=10)
    finally:
        (q / "stop").touch()
        t.join(timeout=30)
    assert not t.is_alive()
    records, stats = out["res"]

    assert stats.lease_expired >= 1 and stats.retried >= 1
    assert stats.quarantined == 0

    ref, _ = SweepRunner(cache=None, mode="vectorized",
                         torch_device=CPU).run(scenarios)
    assert [r["metrics"] for r in records] == [r["metrics"] for r in ref]

    keys = list(cache.iter_keys())
    assert sorted(keys) == sorted({sc.key for sc in scenarios})
    for key in keys:
        on_disk = json.loads(cache.path_for(key).read_text())
        assert on_disk["key"] == key


@pytest.mark.slow
def test_worker_skips_schema_mismatched_jobs(tmp_path):
    scenarios = tiny_grid(n_configs=1, n_report=2)
    q = tmp_path / "q"
    job = q / "job-skew"
    for state in (remote.PENDING, remote.RUNNING, remote.DONE,
                  remote.FAILED):
        (job / state).mkdir(parents=True)
    remote.atomic_write_json(job / "job.json", {
        "job": "skew", "status": "open", "schema": -1,
        "torch_device": CPU, "mode": "vectorized", "n_shards": 1,
        "lease_s": 30.0, "max_attempts": 3,
        "cache_root": str(tmp_path / "cache")})
    publish_shard(job, 0, {"job": "skew", "shard": 0, "schema": -1,
                           "torch_device": CPU, "mode": "vectorized",
                           "groups": [list(scenarios)]})
    proc = spawn_worker(q, "w0", log_path=tmp_path / "w.log",
                        torch_device=CPU)
    try:
        wait_for_workers(q, 1, timeout_s=120)
        time.sleep(1.0)
        assert list((job / remote.PENDING).glob("shard-*.pkl"))
        assert not list((job / remote.RUNNING).glob("shard-*.pkl"))
        assert not list((job / remote.DONE).glob("*.json"))
    finally:
        proc.terminate()
        proc.wait(timeout=10)
