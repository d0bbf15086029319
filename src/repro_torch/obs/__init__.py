"""Dual-clock observability: sim-time flight recorder + wall-clock
sweep profiler, and a first-divergence explainer (``python -m
repro_torch.obs`` for the record/diff CLI).

Counterpart of ``repro.obs``.

Two clocks, one contract:

* **sim-time** — the opt-in ``Probe`` protocol threaded through the
  event loop and the fleet/day simulations; ``FlightRecorder`` logs queue
  depth, batch occupancy, KV usage, routing, autoscaling, epoch
  evaluations and per-bin Eq. 1-5 power/CI/carbon timelines (Eq. 1 on
  the recorder's ``torch_device``); ``AuditProbe`` streams
  physics-invariant checks (conservation, Eq. 2-5 closure) over the
  same hooks. Probe-off runs are bitwise identical to un-instrumented
  ones (neutrality, pinned by tests/test_torch_obs.py and
  tests/test_torch_audit.py).
* **wall-clock** — the ``SpanProfiler`` (module-global ``PROFILER``)
  over the sweep pipeline (cache lookups, trace grouping, event-loop
  runs, stacked passes, the device-mode grid program, worker fan-out) and
  over the served path: a request's wait in the engine's queue, each
  prefill and decode iteration, the model's sublayers and the MoE's
  stages, with request ids and the MoE's counts. Enabled under a
  ``torch.profiler`` session, its spans are also profiler ranges, so the
  trace puts the device's work and idle gaps down to them.

``repro_torch.obs.diff`` localizes the *first* divergent (scenario,
stage, column) cell between two runs — sweep records, golden records
or flight traces — and classifies every divergence against the port's
named tolerance contracts.

Traces serialize to Perfetto-viewable Chrome trace-event JSON and tidy
CSV (``repro_torch.obs.chrometrace``); divergence reports to markdown +
JSON under ``results/torch/obs/divergence/``.
"""
from repro_torch.obs.audit import (AuditError, AuditProbe, AuditReport,
                                   AuditViolation)
from repro_torch.obs.chrometrace import (chrome_trace_events,
                                         write_chrome_trace, write_csvs)
from repro_torch.obs.diff import (DiffResult, DivergentCell, assert_golden,
                                  diff_golden, diff_records,
                                  diff_stage_tables, write_report)
from repro_torch.obs.log import configure as configure_logging
from repro_torch.obs.log import get_logger
from repro_torch.obs.probe import (NULL_PROBE, MultiProbe, NullProbe, Probe,
                                   SiteIndexProbe)
from repro_torch.obs.recorder import ColumnBuilder, FlightRecorder
from repro_torch.obs.spans import PROFILER, SpanProfiler

__all__ = [
    "Probe", "NullProbe", "NULL_PROBE", "MultiProbe", "SiteIndexProbe",
    "FlightRecorder", "ColumnBuilder",
    "AuditProbe", "AuditReport", "AuditViolation", "AuditError",
    "DiffResult", "DivergentCell", "diff_records", "diff_golden",
    "diff_stage_tables", "assert_golden", "write_report",
    "SpanProfiler", "PROFILER",
    "chrome_trace_events", "write_chrome_trace", "write_csvs",
    "get_logger", "configure_logging",
]
