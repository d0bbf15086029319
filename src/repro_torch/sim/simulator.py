"""Event-driven cluster simulator (the Vidur analogue).

Per replica: continuous-batching iterations timed by the analytical
roofline execution model; every batch stage is logged with its start,
duration, FLOPs split (MLP vs attention) and MFU — exactly the
granularity the paper's Eq. 2-3 energy accounting consumes.

Counterpart of ``repro.sim.simulator``. ``run_simulation`` does no tensor
work and runs on the host; ``energy_report`` evaluates Eq. 1 on its
``torch_device`` (``None``: the card).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.power import DeviceProfile, PowerModel, DEVICES
from repro_torch.device import DeviceLike
from repro_torch.sim.execmodel import ExecModelConfig, cached_execution_model
from repro_torch.sim.requests import Request, WorkloadConfig, generate
from repro_torch.sim.scheduler import SchedulerConfig
from repro_torch.sim.trace import StageTrace

# the stage log became the array-native StageTrace (repro_torch.sim.trace);
# the historical name keeps working for existing callers
StageLog = StageTrace


def kv_budget_tokens(model: ModelConfig, device: DeviceProfile, tp: int,
                     pp: int, mem_frac: float = 0.9,
                     weight_bytes: int = 2) -> int:
    """KV token capacity per replica given device memory: the paper's
    large-model cases (34B on one A100-80GB) are KV-constrained to tiny
    batches, which is what drives their low average power."""
    w_per_gpu = model.param_count() * weight_bytes / (tp * pp)
    room = device.hbm_bytes * mem_frac - w_per_gpu
    kv_per_gpu = model.kv_bytes_per_token() / (tp * pp)
    if room <= 0 or kv_per_gpu <= 0:
        return 0
    return int(room / kv_per_gpu)


def latency_stats(requests) -> Dict[str, float]:
    """TTFT / end-to-end percentiles over served requests (-1 when a
    percentile has no samples). Shared by single-site and fleet
    reports."""
    ttft = [r.t_first_token - r.arrival_s for r in requests
            if r.t_first_token >= 0]
    e2e = [r.t_done - r.arrival_s for r in requests if r.t_done >= 0]
    return {
        "ttft_p50_s": float(np.median(ttft)) if ttft else -1.0,
        "ttft_p99_s": float(np.percentile(ttft, 99)) if ttft else -1.0,
        "e2e_p50_s": float(np.median(e2e)) if e2e else -1.0,
        "e2e_p99_s": float(np.percentile(e2e, 99)) if e2e else -1.0,
    }


@dataclasses.dataclass
class SimConfig:
    model: ModelConfig
    device: str = "a100"
    n_replicas: int = 1
    tp: int = 1
    pp: int = 1
    workload: WorkloadConfig = dataclasses.field(default_factory=WorkloadConfig)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    execmodel: ExecModelConfig = dataclasses.field(default_factory=ExecModelConfig)
    auto_kv_budget: bool = True

    @property
    def n_devices(self) -> int:
        return self.n_replicas * self.tp * self.pp  # G = R * TP * PP (Eq. 2)


@dataclasses.dataclass
class SimResult:
    stages: StageTrace
    requests: List[Request]
    cfg: SimConfig

    # ---- derived metrics ----
    def throughput_qps(self) -> float:
        done = [r for r in self.requests if r.t_done >= 0]
        if not done:
            return 0.0
        return len(done) / max(self.stages.total_duration(), 1e-9)

    def latency_stats(self) -> Dict[str, float]:
        return latency_stats(self.requests)

    def avg_mfu(self) -> float:
        if len(self.stages.dur_s) == 0:
            return 0.0
        return float(np.sum(self.stages.mfu * self.stages.dur_s)
                     / max(self.stages.dur_s.sum(), 1e-12))


def run_simulation(cfg: SimConfig, max_sim_s: float = 10_000_000.0,
                   router=None, probe=None) -> SimResult:
    """Single-site simulation — the trivial fleet.

    The event loop lives in ``repro_torch.fleet.simulation.drive``; this
    drives one ``LoopSite`` over it. ``router`` injects a pre-built
    replica router (anything exposing ``route(req) -> replica index``
    and a ``replicas`` list of ``ReplicaScheduler``); when injected,
    the caller owns scheduler config resolution (``auto_kv_budget`` is
    not applied). Default: round-robin over ``cfg.n_replicas`` fresh
    replicas, the historical behavior. ``probe`` (``repro_torch.obs.Probe``)
    observes stage commits and routing; probe-off is bitwise identical.
    """
    from repro_torch.fleet.simulation import LoopSite, drive

    requests = generate(cfg.workload)
    device = DEVICES[cfg.device]
    if router is None:
        from repro_torch.fleet.routing import RoundRobinRouter
        sched_cfg = cfg.scheduler
        if cfg.auto_kv_budget:
            budget = kv_budget_tokens(cfg.model, device, cfg.tp, cfg.pp)
            if budget <= 0:
                raise ValueError(
                    f"{cfg.model.name} does not fit {cfg.device} at "
                    f"TP={cfg.tp} PP={cfg.pp}")
            import dataclasses as _dc
            sched_cfg = _dc.replace(sched_cfg, kv_budget_tokens=budget)
        router = RoundRobinRouter(cfg.n_replicas, sched_cfg)
    site = LoopSite(router, cached_execution_model(cfg.model, cfg.device,
                                                   cfg.tp, cfg.pp,
                                                   cfg.execmodel), cfg.pp)
    add = site.add
    if probe is not None:
        site.probe = probe

        def add(req):
            probe.on_route(req.ready_s, req.rid, 0)
            site.add(req)
    drive([site], add, requests, max_sim_s, probe=probe)
    if probe is not None:
        probe.on_requests(
            np.asarray([r.arrival_s for r in requests], np.float64),
            np.asarray([r.ready_s for r in requests], np.float64))
    return SimResult(stages=site.stage_log(), requests=requests, cfg=cfg)


def energy_report(res: SimResult, pue: float = 1.2,
                  torch_device: DeviceLike = None):
    """Paper Eq. 2-3 over the simulation's stage trace, Eq. 1 on
    ``torch_device``."""
    from repro_torch.core.energy import operational_energy_trace
    pm = PowerModel(res.cfg.device, torch_device=torch_device)
    return operational_energy_trace(res.stages, pm,
                                    n_devices=res.cfg.n_devices, pue=pue)
