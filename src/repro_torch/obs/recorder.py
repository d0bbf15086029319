"""Sim-time flight recorder (counterpart of ``repro.obs.recorder``).

``FlightRecorder`` implements the ``Probe`` protocol and records the
simulation's internal dynamics as columnar time-series — the same
preallocated doubling-buffer idiom as ``repro_torch.sim.trace
.StageTraceBuilder``, generalized to arbitrary field tuples
(``ColumnBuilder``):

* per-(site, replica) **stage series** — batch occupancy, queue depth,
  running set, KV-token usage at every committed iteration;
* **router decisions** (request -> site at ready time) and the
  **admission/deferral backlog** derived from (arrival, release)
  pairs;
* **autoscaler transitions** (active/warm counts per control event)
  and the day simulation's **epoch evaluations** (planned/executed mode,
  pilot sizes, replica plan);
* per-site **Eq. 1-5 timelines**, computed at finalize from the full
  stage trace: per-bin power (Eq. 1 over MFU + idle fill, the Eq. 5
  binning), energy (Eq. 2-3), grid CI, and attributed carbon (Eq. 4);
  Eq. 1 runs on the recorder's ``torch_device`` (``None``: the card),
  the binning in numpy.

The recorder never mutates what it observes: hot-loop hooks copy
scalars out of the live scheduler, finalize hooks compute on fresh
arrays. Probe-off runs are bitwise identical with or without this
module imported (tests/test_torch_obs.py pins probe-attached == probe-off).

Timeline convention: active stage energy bins at each row's *start*
(the ``repro_torch.fleet.day`` idiom); idle fill charges
``p_idle * (powered_devices * bin_s - busy_device_s)`` per bin, where
powered devices come from the autoscaler's device signal when one
exists, else the fixed device count. Both terms scale by PUE. With a
CI signal (or static CI) attached, per-bin carbon is
``energy_wh * ci / 1000`` (Eq. 4 operational term).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs.probe import Probe

# ---------------------------------------------------------------- builder --


class ColumnBuilder:
    """Row accumulator over a preallocated (capacity, n_fields)
    float64 buffer that doubles on overflow — the ``StageTraceBuilder``
    idiom for arbitrary field tuples. ``build()`` returns a dict of
    columnar arrays, integer fields cast to int64."""

    def __init__(self, fields: Tuple[str, ...],
                 int_fields: Tuple[str, ...] = (),
                 capacity: int = 256):
        self.fields = tuple(fields)
        self._int = frozenset(int_fields)
        self._buf = np.empty((max(capacity, 16), len(self.fields)),
                             np.float64)
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def append(self, *vals: float) -> None:
        if self._n == len(self._buf):
            grown = np.empty((2 * len(self._buf), len(self.fields)),
                             np.float64)
            grown[:self._n] = self._buf
            self._buf = grown
        self._buf[self._n] = vals
        self._n += 1

    def build(self) -> Dict[str, np.ndarray]:
        out = {}
        for j, name in enumerate(self.fields):
            col = self._buf[:self._n, j].copy()
            out[name] = col.astype(np.int64) if name in self._int else col
        return out


# ------------------------------------------------------------- recorder --

#: stage-series schema (one row per committed batch iteration)
STAGE_FIELDS = ("t_s", "dur_s", "site", "replica", "batch_size",
                "n_prefill_tokens", "n_decode_tokens", "queue_depth",
                "n_running", "kv_tokens")
_STAGE_INT = ("site", "replica", "batch_size", "n_prefill_tokens",
              "n_decode_tokens", "queue_depth", "n_running", "kv_tokens")

ROUTE_FIELDS = ("t_s", "rid", "site")
_ROUTE_INT = ("rid", "site")


class FlightRecorder(Probe):
    """Recording probe; see the module docstring for what it logs.

    ``resolution_s`` is the observer-owned timeline bin width — it is
    deliberately independent of the simulations' co-sim resolution, so a
    1 s diagnostic timeline never changes what the simulation
    computes. ``torch_device`` evaluates the timelines' Eq. 1
    (``None``: the card; the recorder raises at construction without
    one)."""

    def __init__(self, resolution_s: float = 60.0,
                 torch_device: DeviceLike = None):
        if resolution_s <= 0:
            raise ValueError("resolution_s must be positive")
        self.resolution_s = float(resolution_s)
        self.torch_device = resolve_device(torch_device)
        self._stages = ColumnBuilder(STAGE_FIELDS, _STAGE_INT,
                                     capacity=1024)
        self._routes = ColumnBuilder(ROUTE_FIELDS, _ROUTE_INT,
                                     capacity=1024)
        # low-rate series stay plain lists
        self.scales: List[dict] = []
        self.epochs: List[dict] = []
        self._requests: List[Tuple[int, np.ndarray, np.ndarray]] = []
        #: site index -> Eq. 1-5 timeline dict (see ``on_site_rollup``)
        self.timelines: Dict[int, Dict[str, object]] = {}

    # ---- hot-loop hooks ----

    def on_stage(self, t_s, dur_s, site, replica, scheduler, n_prefill,
                 n_decode, batch_size):
        self._stages.append(t_s, dur_s, site, replica, batch_size,
                            n_prefill, n_decode,
                            len(scheduler.waiting),
                            len(scheduler.running),
                            scheduler.kv_tokens)

    def on_route(self, t_s, rid, site):
        self._routes.append(t_s, rid, site)

    def on_scale(self, t_s, site, n_active, n_warm, kind):
        self.scales.append({"t_s": float(t_s), "site": int(site),
                            "n_active": int(n_active),
                            "n_warm": int(n_warm), "kind": str(kind)})

    # ---- finalize hooks ----

    def on_requests(self, arrival_s, ready_s, site=-1):
        self._requests.append((int(site),
                               np.asarray(arrival_s, np.float64),
                               np.asarray(ready_s, np.float64)))

    def on_epoch_eval(self, site, ev):
        ep = ev.epoch
        self.epochs.append({
            "site": int(site), "index": int(ep.index),
            "t0_s": float(ep.t0), "t1_s": float(ep.t1),
            "planned": str(ep.planned), "executed": str(ev.executed),
            "reason": str(ep.reason),
            "n_replicas": int(ep.n_replicas),
            "n_requests": int(ev.n_requests),
            "n_simulated": int(ev.n_simulated),
            "weight": float(ev.weight)})

    def on_site_rollup(self, site, name, trace, device, row_devices,
                       pue=1.0, ci=None, total_devices=None,
                       device_signal=None, t_end_s=None, energy_wh=None,
                       idle_energy_wh=None, carbon_active_g=None,
                       carbon_idle_g=None, cosim=None, load=None):
        # the caller-reported Eq. 2-5 totals (energy_wh .. load) are
        # audit inputs (the reference's repro.obs.audit); the recorder derives its own
        # timelines from the trace and ignores them
        from repro_torch.core.power import PowerModel

        pm = PowerModel(device, torch_device=self.torch_device)
        res = self.resolution_s
        t_end = float(t_end_s) if t_end_s else trace.total_duration()
        n_bins = max(1, int(math.ceil(max(t_end, res) / res)))
        times = np.arange(n_bins) * res
        act_ws = np.zeros(n_bins)
        busy_dev_s = np.zeros(n_bins)
        if len(trace):
            row_p = pm.power(trace.mfu).cpu().numpy().astype(np.float64) \
                * float(row_devices)
            bin_idx = np.clip((trace.start_s / res).astype(int),
                              0, n_bins - 1)
            np.add.at(act_ws, bin_idx, row_p * trace.dur_s)
            np.add.at(busy_dev_s, bin_idx,
                      trace.dur_s * float(row_devices))
        if device_signal is not None:
            ts, counts = device_signal
            ts = np.asarray(ts, np.float64)
            counts = np.asarray(counts, np.float64)
            idx = np.clip(np.searchsorted(ts, times, side="right") - 1,
                          0, len(counts) - 1)
            devices = counts[idx]
        else:
            devices = np.full(
                n_bins, float(total_devices if total_devices is not None
                              else row_devices))
        idle_dev_s = np.maximum(devices * res - busy_dev_s, 0.0)
        power_w = (act_ws + pm.dev.p_idle * idle_dev_s) / res \
            * float(pue)                                    # Eq. 1-2 + 5
        energy_wh = power_w * res / 3600.0                  # Eq. 2-3
        timeline: Dict[str, object] = {
            "name": str(name), "device": str(device),
            "pue": float(pue), "resolution_s": res,
            "t_s": times, "power_w": power_w, "energy_wh": energy_wh,
            "devices": devices, "busy_dev_s": busy_dev_s,
        }
        if ci is not None:
            ci_vals = (np.asarray(ci.at(times), np.float64)
                       if hasattr(ci, "at")
                       else np.full(n_bins, float(ci)))
            timeline["ci_g_per_kwh"] = ci_vals
            timeline["carbon_g"] = energy_wh * ci_vals / 1000.0  # Eq. 4
        self.timelines[int(site)] = timeline

    # ---- views ----

    @property
    def n_stage_events(self) -> int:
        return len(self._stages)

    @property
    def n_route_events(self) -> int:
        return len(self._routes)

    def stage_table(self) -> Dict[str, np.ndarray]:
        return self._stages.build()

    def route_table(self) -> Dict[str, np.ndarray]:
        return self._routes.build()

    def backlog_series(self) -> Tuple[np.ndarray, np.ndarray]:
        """Admission/deferral backlog over sim-time: step series of
        requests parked between arrival and release, across every
        ``on_requests`` ingest. Empty when no request was deferred."""
        events: List[Tuple[float, int]] = []
        for _, arrival, ready in self._requests:
            held = ready > arrival + 1e-12
            for t in arrival[held]:
                events.append((float(t), 1))
            for t in ready[held]:
                events.append((float(t), -1))
        if not events:
            return np.empty(0), np.empty(0, np.int64)
        events.sort()
        times = np.asarray([t for t, _ in events])
        depth = np.cumsum([d for _, d in events]).astype(np.int64)
        return times, depth

    def counts(self) -> Dict[str, int]:
        """Event counts per series — the record CLI's summary."""
        return {"stage_events": len(self._stages),
                "route_events": len(self._routes),
                "scale_events": len(self.scales),
                "epoch_evals": len(self.epochs),
                "sites_with_timelines": len(self.timelines),
                "timeline_bins": sum(len(t["t_s"])
                                     for t in self.timelines.values())}
