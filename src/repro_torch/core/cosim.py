"""Vidur->Vessim bridge: turn simulator batch-stage logs into a power
signal, run the microgrid co-simulation, and report paper-Table-2
metrics.

Pipeline (paper Section 3.2):
  1. timestamp batch stages (simulator clock)
  2. Eq. 1 power per stage from MFU
  3. Eq. 5 duration-weighted aggregation into fixed bins
  4. microgrid step loop against solar + CI signals

Counterpart of ``repro.core.cosim``. Eq. 1 runs where the ``PowerModel``
says; the microgrid loop runs on ``run_cosim``'s ``torch_device``, on
float32 signals, as the reference's x64-off ``jnp.asarray`` makes them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.microgrid import MicrogridConfig, simulate, summarize
from repro_torch.core.power import PowerModel
from repro_torch.core.signals import Signal, aggregate_power
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class CosimResult:
    load: Signal
    solar: Signal
    ci: Signal
    traces: Dict[str, np.ndarray]
    metrics: Dict[str, float]


def stages_to_load_signal(stage_start_s, stage_dur_s, stage_mfu,
                          power_model: PowerModel, n_devices: int = 1,
                          pue: float = 1.0, resolution_s: float = 60.0,
                          include_idle: bool = True) -> Signal:
    """Stages -> per-bin average power (W, whole deployment)."""
    p = power_model.power(np.asarray(stage_mfu)).cpu().numpy()
    sig = aggregate_power(stage_start_s, stage_dur_s, p, resolution_s)
    vals = sig.values.copy()
    if include_idle:
        # bins with no recorded stage still draw idle power
        vals = np.where(vals > 0, vals, power_model.dev.p_idle)
    return Signal(sig.times, vals * n_devices * pue, interp="previous")


def trace_to_load_signal(trace, power_model: PowerModel,
                         n_devices: int = 1, pue: float = 1.0,
                         resolution_s: float = 60.0,
                         include_idle: bool = True) -> Signal:
    """``stages_to_load_signal`` directly over a ``StageTrace``."""
    return stages_to_load_signal(trace.start_s, trace.dur_s, trace.mfu,
                                 power_model, n_devices=n_devices, pue=pue,
                                 resolution_s=resolution_s,
                                 include_idle=include_idle)


def run_cosim(load: Signal, solar: Signal, ci: Signal,
              cfg: Optional[MicrogridConfig] = None,
              torch_device: DeviceLike = None) -> CosimResult:
    cfg = cfg or MicrogridConfig()
    dev = resolve_device(torch_device)
    # align all signals on the load grid, float32 on the device
    t = load.times
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    lw, sw, cw = f32(load.values), f32(solar.at(t)), f32(ci.at(t))
    tr = simulate(lw, sw, cw, cfg, torch_device=dev)
    tr_np = {k: v.cpu().numpy() for k, v in tr.items()}
    lw, sw, cw = (x.cpu().numpy() for x in (lw, sw, cw))
    metrics = summarize(lw, sw, cw, tr_np, cfg)
    return CosimResult(load=load, solar=Signal(t, sw), ci=Signal(t, cw),
                       traces=tr_np, metrics=metrics)
