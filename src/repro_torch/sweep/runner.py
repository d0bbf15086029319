"""Scenario execution: serial or multiprocessing, cache-memoized.

``execute_scenario`` turns one ``Scenario`` into a flat record of the
paper's energy/carbon summary columns (Eq. 2-4) plus latency and
throughput. ``SweepRunner`` runs a list of scenarios, skipping every
one whose content hash is already in the ``ResultCache`` and fanning
the rest out over a process pool. Scenario seeds live inside the
config (``workload.seed``), so results are bit-identical between
serial and parallel execution and across re-runs.

Execution modes: ``"vectorized"`` (default) groups grid points that
share a simulation trace — identical config, differing only in the
scenario-level PUE / grid-CI / post-processor axes — runs the event
loop once per group, and evaluates the shared-trace axes as stacked
array passes (``repro_torch.sweep.vectorized``); bit-identical to
``"event_loop"``, which executes every scenario through the loop.
``"device"`` additionally pads every trace group into one batched
tensor set and evaluates the roofline/energy/carbon passes as a single
torch program over the whole grid, with divergence analysis sharing
composition traces across device/TP/PP points where provably safe
(``repro_torch.sweep.device``); equivalent to the numpy modes within the
documented ``DEVICE_MODE_RTOL``.

Post-processors extend a scenario with derived analyses that need the
full ``SimResult`` (e.g. the Table 2 microgrid co-simulation); they are
addressed by name so records stay JSON/cache-friendly.

Counterpart of ``repro.sweep.runner``. The event loop and the numpy
roofline run on the host, as in the reference; every scenario's tensor
work (Eq. 1, the microgrid scan, the fleet and day rollups, the device
grid) runs on the runner's ``torch_device`` (``None``: the card, raising
without one), which reaches each pool worker as a string and each
remote worker as the job's device type (``repro_torch.sweep.remote``).
"""
from __future__ import annotations

import dataclasses
import functools
import multiprocessing
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.carbon import emissions
from repro_torch.core.power import DEVICES
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fleet.config import FleetConfig
from repro_torch.obs.spans import PROFILER
from repro_torch.sweep.cache import ResultCache
from repro_torch.sweep.grid import SCHEMA_VERSION, Scenario

EXECUTION_MODES = ("vectorized", "event_loop", "device")
#: where cache-missed scenarios execute: in this process (pool) or on
#: detached workers over a shared-filesystem work queue (sweep.remote)
BACKENDS = ("local", "remote")


# --------------------------------------------------------------------------
# post-processors: name -> fn(SimResult, scenario, torch_device) -> extra
# metric columns
# --------------------------------------------------------------------------

def _post_microgrid_cosim(res, scenario: Scenario,
                          torch_device: DeviceLike = None) -> Dict[str, float]:
    """Table 2 pipeline: stage log -> 1-min power signal placed on a
    diurnal window -> solar+battery microgrid co-sim (paper Table 1b)."""
    from repro_torch.core import MicrogridConfig, PowerModel, Signal, run_cosim
    from repro_torch.core.cosim import stages_to_load_signal
    from repro_torch.core.datasets import (carbon_intensity_signal,
                                     ci_trace_signal, solar_signal)
    from repro_torch.core.microgrid import BatteryConfig

    p = {"hours": 30.0, "start_hour": 8.0, "resolution_s": 60.0,
         "solar_capacity_w": 600.0, "cloudiness": 0.12, "solar_seed": 3,
         "ci_seed": 4, "ci_trace": None, "battery_capacity_wh": 100.0,
         "soc_init": 0.5, "soc_min": 0.2, "soc_max": 0.8}
    p.update(scenario.post_params)

    cfg = scenario.cfg
    pm = PowerModel(cfg.device, torch_device=torch_device)
    load = stages_to_load_signal(res.stages.start_s, res.stages.dur_s,
                                 res.stages.mfu, pm,
                                 n_devices=cfg.n_devices, pue=scenario.pue,
                                 resolution_s=p["resolution_s"])
    n_bins = int(p["hours"] * 3600.0 / p["resolution_s"])
    idle_w = pm.dev.p_idle * cfg.n_devices * scenario.pue
    vals = np.full(n_bins, idle_w)
    start_bin = int(p["start_hour"] * 3600.0 / p["resolution_s"])
    n_active = min(len(load.values), n_bins - start_bin)
    vals[start_bin:start_bin + n_active] = load.values[:n_active]
    times = np.arange(n_bins) * p["resolution_s"]
    load_sig = Signal(times, vals, interp="previous")

    solar = solar_signal(p["hours"], capacity_w=p["solar_capacity_w"],
                         seed=p["solar_seed"], cloudiness=p["cloudiness"])
    if p["ci_trace"]:       # named region (core.datasets.CI_TRACES)
        ci = ci_trace_signal(p["ci_trace"], p["hours"])
    else:
        ci = carbon_intensity_signal(p["hours"], seed=p["ci_seed"])
    grid_cfg = MicrogridConfig(battery=BatteryConfig(
        capacity_wh=p["battery_capacity_wh"], soc_init=p["soc_init"],
        soc_min=p["soc_min"], soc_max=p["soc_max"]))
    out = run_cosim(load_sig, solar, ci, grid_cfg, torch_device=torch_device)
    return {f"cosim_{k}": float(v) for k, v in out.metrics.items()}


POSTPROCESSORS: Dict[str, Callable] = {
    "microgrid_cosim": _post_microgrid_cosim,
}


# --------------------------------------------------------------------------
# single-scenario execution
# --------------------------------------------------------------------------

def _execute_fleet_scenario(scenario: Scenario, probe=None,
                            torch_device: DeviceLike = None) -> dict:
    """Fleet scenarios: run the multi-site simulation and report its
    per-site + fleet-total energy/carbon columns. Configs carrying a
    ``DayConfig`` dispatch to the epoch-segmented day simulation
    (``repro_torch.fleet.day``) — fluid/request hybrid or exact per
    ``day.mode``."""
    from repro_torch.fleet.day import run_fleet_day
    from repro_torch.fleet.simulation import run_fleet_simulation

    if scenario.post is not None:
        raise ValueError(
            "fleet scenarios run their own per-site microgrid co-sim; "
            f"post-processor {scenario.post!r} is not supported")
    t0 = time.perf_counter()
    if probe is not None:
        probe.on_run_begin(scenario.tag)
    if scenario.cfg.day is not None:
        with PROFILER.span("sim.fleet_day"):
            res = run_fleet_day(scenario.cfg, probe=probe,
                                torch_device=torch_device)
    else:
        with PROFILER.span("sim.fleet"):
            res = run_fleet_simulation(scenario.cfg, probe=probe,
                                       torch_device=torch_device)
    cfg = scenario.cfg
    meta = {"schema": SCHEMA_VERSION,
            "elapsed_s": time.perf_counter() - t0,
            "model": cfg.model.name,
            "device": cfg.device,
            "n_devices": cfg.n_devices,
            "pue": cfg.pue,
            "post": None,
            "router": cfg.router,
            "policy": cfg.schedule.policy,
            "forecaster": cfg.schedule.forecaster}
    if cfg.day is not None:
        meta["day_mode"] = cfg.day.mode
    return {
        "scenario": scenario.tag,
        "key": scenario.key,
        "params": dict(scenario.params),
        "metrics": res.summary(),
        "meta": meta,
    }


# result-only columns interleaved into the record head; the rest of
# shared_result_metrics() (latency percentiles) lands after carbon
_SHARED_HEAD = ("avg_mfu", "throughput_qps", "n_stages", "avg_batch")


def shared_result_metrics(res) -> Dict[str, float]:
    """The metric columns that depend only on the ``SimResult`` — in
    the vectorized mode a whole trace group computes these once."""
    stages = res.stages
    return {
        "avg_mfu": res.avg_mfu(),
        "throughput_qps": res.throughput_qps(),
        "n_stages": len(stages.dur_s),
        "avg_batch": float(np.mean(stages.batch_size))
        if len(stages.batch_size) else 0.0,
        **res.latency_stats(),
    }


def single_site_metrics(res, scenario: Scenario, rep, carbon=None,
                        shared=None,
                        torch_device: DeviceLike = None) -> Dict[str, float]:
    """Assemble one scenario's metric columns from a (possibly shared)
    ``SimResult`` and its Eq. 2-3 energy report. Both execution modes
    go through this, so their records agree bit-for-bit. ``carbon``
    and ``shared`` accept precomputed pieces (the vectorized mode's
    stacked CI pass / per-group result metrics); None computes them
    here. The post-processor's tensor work runs on ``torch_device``."""
    if carbon is None:
        carbon = emissions(rep.energy_wh, rep.gpu_hours,
                           DEVICES[scenario.cfg.device],
                           ci=scenario.grid_ci)
    if shared is None:
        shared = shared_result_metrics(res)
    metrics = {
        "energy_wh": rep.energy_wh,
        "energy_kwh": rep.energy_wh / 1000.0,
        "avg_power_w": rep.avg_power_w,
        "peak_power_w": rep.peak_power_w,
        "avg_mfu": shared["avg_mfu"],
        "duration_s": rep.duration_s,
        "gpu_hours": rep.gpu_hours,
        "throughput_qps": shared["throughput_qps"],
        "n_stages": shared["n_stages"],
        "avg_batch": shared["avg_batch"],
        "carbon_operational_g": carbon.operational_g,
        "carbon_embodied_g": carbon.embodied_g,
        "carbon_total_g": carbon.total_g,
        "grid_ci_g_per_kwh": scenario.grid_ci,
        **{k: v for k, v in shared.items() if k not in _SHARED_HEAD},
    }
    if scenario.post is not None:
        if scenario.post not in POSTPROCESSORS:
            raise KeyError(f"unknown post-processor {scenario.post!r}; "
                           f"have {sorted(POSTPROCESSORS)}")
        metrics.update(POSTPROCESSORS[scenario.post](res, scenario,
                                                     torch_device))
    return metrics


def single_site_record(scenario: Scenario, metrics: Dict[str, float],
                       t0: float, **meta) -> dict:
    return {
        "scenario": scenario.tag,
        "key": scenario.key,
        "params": dict(scenario.params),
        "metrics": metrics,
        "meta": {"schema": SCHEMA_VERSION,
                 "elapsed_s": time.perf_counter() - t0,
                 "model": scenario.cfg.model.name,
                 "device": scenario.cfg.device,
                 "n_devices": scenario.cfg.n_devices,
                 "pue": scenario.pue,
                 "post": scenario.post,
                 **meta},
    }


def execute_scenario(scenario: Scenario, probe=None,
                     torch_device: DeviceLike = None) -> dict:
    """Run one scenario to a flat, JSON-able record (event-loop path).

    ``probe`` (``repro_torch.obs.Probe``) observes the simulation and, for
    single-site scenarios, receives the Eq. 1-5 rollup inputs (this
    layer knows the scenario's PUE and grid CI); records stay bitwise
    identical either way. Eq. 1 and the post-processors run on
    ``torch_device`` (``None``: the card, raising without one)."""
    from repro_torch.sim import energy_report, run_simulation

    torch_device = resolve_device(torch_device)
    if isinstance(scenario.cfg, FleetConfig):
        return _execute_fleet_scenario(scenario, probe=probe,
                                       torch_device=torch_device)

    t0 = time.perf_counter()
    if probe is not None:
        probe.on_run_begin(scenario.tag)
    with PROFILER.span("sim.event_loop"):
        res = run_simulation(scenario.cfg, probe=probe)
    rep = energy_report(res, pue=scenario.pue, torch_device=torch_device)
    if probe is not None:
        probe.on_site_rollup(
            site=0, name=scenario.tag, trace=res.stages,
            device=scenario.cfg.device,
            row_devices=scenario.cfg.n_devices, pue=scenario.pue,
            ci=scenario.grid_ci,
            total_devices=scenario.cfg.n_devices,
            energy_wh=rep.energy_wh)
    return single_site_record(
        scenario, single_site_metrics(res, scenario, rep,
                                      torch_device=torch_device), t0)


# --------------------------------------------------------------------------
# sweep runner
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SweepStats:
    total: int = 0
    executed: int = 0
    cache_hits: int = 0
    elapsed_s: float = 0.0
    workers: int = 1
    mode: str = "vectorized"
    trace_groups: int = 0     # unique simulation traces actually driven
    event_loops: int = 0      # device mode: groups run through the loop
    replayed: int = 0         # device mode: groups shared via divergence
    # ResultCache effectiveness over this run (lookup-phase deltas);
    # cache_attached distinguishes a no-cache run from an all-miss one
    cache_attached: bool = False
    cache_memo: int = 0       # hits served from the in-process memo
    cache_disk: int = 0       # hits parsed off disk
    cache_miss: int = 0       # keys with no cached record
    peak_rss_mb: float = 0.0  # process tree high-water RSS (0 off-POSIX)
    backend: str = "local"
    # remote backend (sweep.remote): shard-queue observables
    shards: int = 0
    remote_workers: int = 0   # distinct workers seen in manifests
    lease_expired: int = 0
    retried: int = 0
    quarantined: int = 0

    def summary(self) -> str:
        groups = (f", {self.trace_groups} trace group(s)"
                  if self.mode in ("vectorized", "device") and self.executed
                  else "")
        shared = (f" ({self.event_loops} event loop(s), "
                  f"{self.replayed} replayed)"
                  if self.mode == "device" and self.executed else "")
        eff = (f", cache {self.cache_memo} memo / {self.cache_disk} disk"
               f" / {self.cache_miss} miss"
               if self.cache_attached else "")
        rss = (f", peak RSS {self.peak_rss_mb:.0f} MB"
               if self.peak_rss_mb else "")
        rem = (f", remote: shards={self.shards} "
               f"workers={self.remote_workers} "
               f"expired={self.lease_expired} retried={self.retried} "
               f"quarantined={self.quarantined}"
               if self.backend == "remote" and self.executed else "")
        return (f"{self.total} scenarios: {self.executed} executed, "
                f"{self.cache_hits} cache hits, "
                f"{self.elapsed_s:.2f}s wall, {self.workers} worker(s)"
                f"{groups}{shared}{eff}{rss}{rem}")


def _peak_rss_mb() -> float:
    """Process-tree high-water RSS in MB (``ru_maxrss`` is KB on
    Linux): the max of this process and its reaped children, so
    multiprocessing sweeps report the pool workers' footprint rather
    than just the coordinator's. 0.0 where ``resource`` is
    unavailable."""
    try:
        import resource
    except ImportError:
        return 0.0
    own = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    kids = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    return max(own, kids) / 1024.0


class SweepRunner:
    """Execute scenarios with memoization and optional process fan-out.

    ``mode="vectorized"`` (default) groups uncached scenarios by their
    config digest and drives the event loop once per unique trace,
    fanning *groups* out over workers; ``mode="event_loop"`` executes
    every scenario independently (the historical behavior). Both modes
    produce bit-identical records (pinned by tests/test_torch_sweep.py).
    ``mode="device"`` evaluates all groups in one batched torch program
    (always in-process — the single dispatch IS the parallelism) and
    matches the numpy modes within ``device.DEVICE_MODE_RTOL`` (pinned
    by tests/test_torch_sweep.py).

    ``torch_device`` (``None``: the card, raising without one) runs every
    executed scenario's tensor work; pool workers receive it as a string.
    ``cache``, when given, must hold the records of that device's type.

    ``workers > 1`` uses a spawn-context process pool (a forked child
    cannot use CUDA). ``cache=None`` disables memoization entirely.

    ``probe`` attaches a ``repro_torch.obs.Probe`` to every *executed*
    scenario (cache hits never re-simulate, so they record nothing) —
    stack several with ``repro_torch.obs.MultiProbe`` (e.g. a
    ``FlightRecorder`` plus an ``AuditProbe``). A probe forces serial
    in-process execution — probes are process-local state — and is
    rejected in device mode, whose batched program has no
    event-per-stage structure to observe.

    ``backend="remote"`` ships cache-missed trace groups to detached
    ``repro_torch.sweep.worker`` processes through a shared-filesystem
    work queue (``repro_torch.sweep.remote``): the workers compute on
    the runner's device type, write records straight into the shared
    cache and the coordinator reads them back, so a cache is mandatory
    and the records are bit-identical to local execution in the same
    mode on the same device type. ``remote`` takes a ``RemoteOptions``;
    probes are process-local and therefore rejected.
    """

    def __init__(self, cache: Optional[ResultCache] = None,
                 workers: int = 1, mode: str = "vectorized",
                 probe=None, backend: str = "local", remote=None,
                 torch_device: DeviceLike = None):
        if mode not in EXECUTION_MODES:
            raise ValueError(f"unknown mode {mode!r}; have "
                             f"{EXECUTION_MODES}")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; have "
                             f"{BACKENDS}")
        if backend == "remote":
            if cache is None:
                raise ValueError(
                    "backend='remote' requires a ResultCache — the "
                    "shared cache is how workers return records")
            if probe is not None:
                raise ValueError(
                    "probe recording is not supported on the remote "
                    "backend (probes are process-local state)")
            if mode == "event_loop":
                raise ValueError(
                    "the remote backend ships whole trace groups; use "
                    "mode='vectorized' (exact) or 'device'")
        dev = resolve_device(torch_device)
        if cache is not None and cache.device_type != dev.type:
            raise ValueError(
                f"the cache holds {cache.device_type} records, but this "
                f"runner computes on {dev}")
        if probe is not None and mode == "device":
            raise ValueError(
                "probe recording is not supported in device mode (the "
                "batched grid program exposes no per-stage events); "
                "use mode='vectorized' or 'event_loop'")
        self.cache = cache
        self.workers = max(1, int(workers))
        self.mode = mode
        self.probe = probe
        self.backend = backend
        self.remote = remote
        self.torch_device = str(dev)

    @staticmethod
    def _rebind(record: dict, sc: Scenario) -> dict:
        """Content-addressing means a cached/shared record may come
        from another scenario with an identical config — rebind the
        tag/params to the requesting scenario (metrics are
        config-determined, presentation is not)."""
        record = dict(record)
        record["scenario"] = sc.tag
        record["params"] = dict(sc.params)
        record["meta"] = {**record.get("meta", {}), "cache_hit": True}
        return record

    def run(self, scenarios: Sequence[Scenario],
            progress: Optional[Callable[[str], None]] = None
            ) -> Tuple[List[dict], SweepStats]:
        t0 = time.perf_counter()
        note = progress or (lambda msg: None)
        records: List[Optional[dict]] = [None] * len(scenarios)
        stats = SweepStats(total=len(scenarios), workers=self.workers,
                           mode=self.mode, backend=self.backend,
                           cache_attached=self.cache is not None)

        c0 = dict(self.cache.counters) if self.cache is not None else {}
        misses: List[int] = []          # first index per uncached key
        dup_of: Dict[str, List[int]] = {}   # key -> later same-key idxs
        with PROFILER.span("cache.lookup"):
            for i, sc in enumerate(scenarios):
                hit = (self.cache.get(sc.key)
                       if self.cache is not None else None)
                if hit is not None:
                    records[i] = self._rebind(hit, sc)
                    stats.cache_hits += 1
                elif sc.key in dup_of:  # same config earlier in this run
                    dup_of[sc.key].append(i)
                    stats.cache_hits += 1
                else:
                    dup_of[sc.key] = []
                    misses.append(i)
        if self.cache is not None:
            c1 = self.cache.counters
            stats.cache_memo = c1["memo"] - c0["memo"]
            stats.cache_disk = c1["disk"] - c0["disk"]
            stats.cache_miss = c1["miss"] - c0["miss"]
        if stats.cache_hits:
            note(f"cache: {stats.cache_hits}/{len(scenarios)} hits")

        if misses:
            todo = [scenarios[i] for i in misses]
            if self.backend == "remote":
                fresh = self._run_remote(todo, note, stats)
            elif self.mode == "vectorized":
                fresh, stats.trace_groups = self._run_vectorized(todo, note)
            elif self.mode == "device":
                fresh = self._run_device(todo, note, stats)
            else:
                fresh = self._run_event_loop(todo, note)
            with PROFILER.span("cache.store"):
                for i, record in zip(misses, fresh):
                    record["meta"]["cache_hit"] = False
                    records[i] = record
                    stats.executed += 1
                    # remote workers already persisted their records
                    # into the shared cache — re-putting them here
                    # would only re-serialize identical bytes
                    if self.cache is not None and self.backend != "remote":
                        self.cache.put(record["key"], record)
                    for j in dup_of[scenarios[i].key]:
                        records[j] = self._rebind(record, scenarios[j])

        stats.elapsed_s = time.perf_counter() - t0
        stats.peak_rss_mb = _peak_rss_mb()
        return [r for r in records if r is not None], stats

    # ---- execution backends over the cache-missed scenarios ----

    def _run_event_loop(self, todo: List[Scenario], note) -> List[dict]:
        dev = self.torch_device
        if self.probe is None and self.workers > 1 and len(todo) > 1:
            ctx = multiprocessing.get_context("spawn")
            n = min(self.workers, len(todo))
            note(f"executing {len(todo)} scenarios on {n} processes")
            with PROFILER.span("pool.event_loop"), \
                    ProcessPoolExecutor(max_workers=n,
                                        mp_context=ctx) as pool:
                if PROFILER.enabled:
                    outs = list(pool.map(functools.partial(
                        _execute_scenario_profiled, torch_device=dev), todo))
                    for _, agg in outs:
                        PROFILER.merge(agg)
                    return [rec for rec, _ in outs]
                return list(pool.map(functools.partial(
                    execute_scenario, torch_device=dev), todo))
        note(f"executing {len(todo)} scenarios serially")
        return [execute_scenario(sc, probe=self.probe, torch_device=dev)
                for sc in todo]

    def _run_vectorized(self, todo: List[Scenario], note
                        ) -> Tuple[List[dict], int]:
        from repro_torch.sweep.vectorized import (execute_scenario_group,
                                            execute_scenario_group_profiled,
                                            group_by_trace)
        with PROFILER.span("trace_grouping"):
            groups = group_by_trace(todo)
        group_scs = [[todo[j] for j in g] for g in groups]
        if self.probe is None and self.workers > 1 and len(group_scs) > 1:
            from repro_torch.sweep.vectorized import estimate_group_cost
            ctx = multiprocessing.get_context("spawn")
            n = min(self.workers, len(group_scs))
            note(f"executing {len(todo)} scenarios as {len(groups)} "
                 f"trace group(s) on {n} processes")
            # submit heaviest groups first (LPT order, chunksize 1):
            # group_by_trace yields wildly unbalanced groups, and FIFO
            # submission can strand the biggest trace on the last
            # worker while the rest idle
            order = sorted(range(len(group_scs)),
                           key=lambda i: (-estimate_group_cost(
                               group_scs[i]), i))
            ordered = [group_scs[i] for i in order]
            with PROFILER.span("pool.vectorized"), \
                    ProcessPoolExecutor(max_workers=n,
                                        mp_context=ctx) as pool:
                if PROFILER.enabled:
                    outs = list(pool.map(functools.partial(
                        execute_scenario_group_profiled,
                        torch_device=self.torch_device),
                        ordered, chunksize=1))
                    for _, agg in outs:
                        PROFILER.merge(agg)
                    ordered_recs = [recs for recs, _ in outs]
                else:
                    ordered_recs = list(pool.map(functools.partial(
                        execute_scenario_group,
                        torch_device=self.torch_device),
                        ordered, chunksize=1))
            per_group: List[Optional[List[dict]]] = [None] * len(group_scs)
            for pos, recs in zip(order, ordered_recs):
                per_group[pos] = recs
        else:
            note(f"executing {len(todo)} scenarios as {len(groups)} "
                 f"trace group(s) serially")
            per_group = [execute_scenario_group(
                g, probe=self.probe, torch_device=self.torch_device)
                for g in group_scs]
        fresh: List[Optional[dict]] = [None] * len(todo)
        for idxs, recs in zip(groups, per_group):
            for j, rec in zip(idxs, recs):
                fresh[j] = rec
        return fresh, len(groups)

    def _run_remote(self, todo: List[Scenario], note,
                    stats: SweepStats) -> List[dict]:
        from repro_torch.sweep.remote import RemoteCoordinator
        coord = RemoteCoordinator(self.cache, opts=self.remote,
                                  mode=self.mode, note=note,
                                  torch_device=self.torch_device)
        with PROFILER.span("remote.execute"):
            fresh, rstats = coord.execute(todo)
        stats.trace_groups = rstats.trace_groups
        stats.shards = rstats.shards
        stats.remote_workers = rstats.workers
        stats.lease_expired = rstats.lease_expired
        stats.retried = rstats.retried
        stats.quarantined = rstats.quarantined
        return fresh

    def _run_device(self, todo: List[Scenario], note,
                    stats: SweepStats) -> List[dict]:
        from repro_torch.sweep.device import execute_device_grid
        note(f"executing {len(todo)} scenarios as one device-batched "
             "grid program")
        with PROFILER.span("device.grid"):
            fresh, dstats = execute_device_grid(
                todo, torch_device=self.torch_device)
        stats.trace_groups = dstats.trace_groups
        stats.event_loops = dstats.event_loops
        stats.replayed = dstats.replayed
        return fresh


def _execute_scenario_profiled(sc: Scenario, torch_device: DeviceLike = None
                               ) -> Tuple[dict, dict]:
    """Pool target for profiled event-loop fan-out: runs one scenario
    under the worker-local ``PROFILER`` and ships the per-phase
    aggregate back for the parent's ``merge()``."""
    PROFILER.enable(reset=True)
    try:
        rec = execute_scenario(sc, torch_device=torch_device)
    finally:
        PROFILER.disable()
    return rec, PROFILER.aggregate()


def run_scenarios(scenarios: Sequence[Scenario], workers: int = 1,
                  cache: Optional[ResultCache] = None,
                  progress: Optional[Callable[[str], None]] = None,
                  mode: str = "vectorized", probe=None,
                  backend: str = "local", remote=None,
                  torch_device: DeviceLike = None
                  ) -> Tuple[List[dict], SweepStats]:
    """One-call convenience wrapper around ``SweepRunner``."""
    return SweepRunner(cache=cache, workers=workers, mode=mode,
                       probe=probe, backend=backend, remote=remote,
                       torch_device=torch_device).run(scenarios, progress)
