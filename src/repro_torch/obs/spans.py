"""Wall-clock span profiler for the sweep pipeline (counterpart of
``repro.obs.spans``).

``SpanProfiler`` records nestable named spans (cache lookup, trace
grouping, event-loop runs, stacked passes, the device-mode grid
program, worker fan-out) against ``time.perf_counter``. Disabled — the
default — ``span()`` returns a shared no-op context manager, so
instrumented call sites cost one attribute check when profiling is
off.

The module-level ``PROFILER`` is the process-wide instance the sweep
pipeline instruments against; enable it via ``PROFILER.enable()`` (the
CLI's ``--profile`` / ``--trace-out`` flags do). Worker processes in a
sweep's process pool each carry their own (initially disabled)
``PROFILER``; ``repro_torch.sweep.vectorized.execute_scenario_group_profiled``
enables it per task and ships the per-phase aggregate back for
``merge()`` — merged phases contribute to ``aggregate()`` but carry no
span events of their own (cross-process clocks don't share an origin).
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple


class _NullSpan:
    """Shared no-op context manager for the disabled path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_prof", "name", "t0", "depth")

    def __init__(self, prof: "SpanProfiler", name: str):
        self._prof = prof
        self.name = name

    def __enter__(self):
        self.depth = self._prof._depth
        self._prof._depth += 1
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self.t0
        self._prof._depth -= 1
        self._prof._events.append((self.name, self.t0, dur, self.depth))
        return False


class SpanProfiler:
    """Nestable wall-clock spans with per-phase aggregation."""

    def __init__(self):
        self.enabled = False
        self.t_origin = time.perf_counter()
        self._depth = 0
        # (name, t0_abs, dur_s, depth) per completed span
        self._events: List[Tuple[str, float, float, int]] = []
        # phase aggregates merged from other processes
        self._merged: Dict[str, Dict[str, float]] = {}

    def enable(self, reset: bool = False) -> None:
        if reset:
            self.reset()
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        self._events.clear()
        self._merged.clear()
        self._depth = 0
        self.t_origin = time.perf_counter()

    def span(self, name: str):
        """``with PROFILER.span("phase"): ...`` — no-op when
        disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name)

    def spans(self) -> List[Tuple[str, float, float, int]]:
        """Completed spans as (name, t0_s_rel, dur_s, depth), t0
        relative to the profiler origin, chronological."""
        out = [(n, t0 - self.t_origin, d, depth)
               for n, t0, d, depth in self._events]
        out.sort(key=lambda e: (e[1], e[3]))
        return out

    def aggregate(self) -> Dict[str, Dict[str, float]]:
        """Per-phase totals: name -> {count, total_s} (own spans plus
        everything ``merge()``d in)."""
        agg: Dict[str, Dict[str, float]] = {}
        for name, _, dur, _ in self._events:
            a = agg.setdefault(name, {"count": 0, "total_s": 0.0})
            a["count"] += 1
            a["total_s"] += dur
        for name, m in self._merged.items():
            a = agg.setdefault(name, {"count": 0, "total_s": 0.0})
            a["count"] += m["count"]
            a["total_s"] += m["total_s"]
        return agg

    def merge(self, agg: Dict[str, Dict[str, float]]) -> None:
        """Fold another process's ``aggregate()`` into this one."""
        for name, m in agg.items():
            a = self._merged.setdefault(name,
                                        {"count": 0, "total_s": 0.0})
            a["count"] += int(m["count"])
            a["total_s"] += float(m["total_s"])

    def write_aggregate(self, path) -> None:
        """Persist ``aggregate()`` as JSON — the cross-process handoff
        format (remote sweep workers dump it per shard; the coordinator
        folds the files back in via ``merge_file``)."""
        import json
        from pathlib import Path
        Path(path).write_text(json.dumps(self.aggregate(), indent=1))

    def merge_file(self, path) -> None:
        """``merge()`` a JSON aggregate previously written by
        ``write_aggregate`` (possibly on another host)."""
        import json
        with open(path) as f:
            self.merge(json.load(f))

    def format_aggregate(self) -> str:
        """Human-readable per-phase table, longest total first."""
        agg = self.aggregate()
        if not agg:
            return "(no spans recorded)"
        rows = sorted(agg.items(), key=lambda kv: -kv[1]["total_s"])
        width = max(len(n) for n, _ in rows)
        return "\n".join(
            f"{n:<{width}s}  {a['total_s']:9.3f}s  x{a['count']}"
            for n, a in rows)


#: the process-wide profiler the sweep pipeline instruments against
PROFILER = SpanProfiler()
