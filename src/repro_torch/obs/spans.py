"""Wall-clock span profiler for the sweep pipeline and the served path
(counterpart of ``repro.obs.spans``).

``SpanProfiler`` records nestable named spans against
``time.perf_counter``: in the sweep pipeline cache lookup, trace
grouping, event-loop runs, stacked passes, the device-mode grid program
and worker fan-out; on the served path the engine's iterations, the
model's sublayers and the MoE's stages. Each span keeps the span that was
open when it began (its parent), an optional request id, and optional
counts, which may be 0-d device tensors: they are read to the host only
when the spans are read (``records``), never inside a step. ``record``
adds an interval that is not a ``with`` block, such as a request's wait
in a queue.

While enabled, each span begun under a ``torch.profiler`` session also
enters ``torch.profiler.record_function`` of its name, so that the spans
appear among the profiler's host events, on its clock beside the device
records (outside a session such a range records nothing, and costs the
host more than the rest of the span). Disabled — the default — ``span()`` returns a shared no-op
context manager and ``record`` and ``count`` return at once, so
instrumented call sites cost one attribute check when profiling is off.

The module-level ``PROFILER`` is the process-wide instance the sweep
pipeline and the served path instrument against; enable it via
``PROFILER.enable()`` (the CLI's ``--profile`` / ``--trace-out`` flags
do). Worker processes in a sweep's process pool each carry their own
(initially disabled) ``PROFILER``;
``repro_torch.sweep.vectorized.execute_scenario_group_profiled``
enables it per task and ships the per-phase aggregate back for
``merge()`` — merged phases contribute to ``aggregate()`` but carry no
span events of their own (cross-process clocks don't share an origin).
"""
from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Tuple

from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function


class SpanRecord(NamedTuple):
    """One completed span: ``t0``/``t1`` on ``time.perf_counter``'s clock;
    ``sid`` its number in the order spans began, ``parent`` the ``sid`` of
    the span open when it began (None at top level); ``counts`` as given,
    device tensors among them until ``records()`` reads them."""
    name: str
    t0: float
    t1: float
    depth: int
    sid: int
    parent: Optional[int]
    rid: Optional[int]
    counts: Dict[str, object]


class _NullSpan:
    """Shared no-op context manager for the disabled path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_prof", "name", "rid", "counts", "t0", "depth", "sid",
                 "parent", "_rf")

    def __init__(self, prof: "SpanProfiler", name: str, rid, counts):
        self._prof = prof
        self.name = name
        self.rid = rid
        self.counts = counts

    def __enter__(self):
        prof = self._prof
        self.depth = len(prof._stack)
        self.parent = prof._stack[-1].sid if prof._stack else None
        self.sid = prof._opened
        prof._opened += 1
        prof._stack.append(self)
        # a range only a profiler session records: entered only under one
        self._rf = record_function(self.name) if _profiler_enabled() else None
        if self._rf is not None:
            self._rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        prof = self._prof
        prof._stack.pop()
        prof._records.append(SpanRecord(self.name, self.t0, t1, self.depth,
                                        self.sid, self.parent, self.rid,
                                        self.counts))
        return False


def _host(v):
    """A count as a host number: a tensor read by ``item()``."""
    return v.item() if hasattr(v, "item") else v


class SpanProfiler:
    """Nestable wall-clock spans with per-phase aggregation."""

    def __init__(self):
        self.enabled = False
        self.t_origin = time.perf_counter()
        self._stack: List[_Span] = []        # the spans open, outermost first
        self._opened = 0                     # spans begun since the reset
        self._records: List[SpanRecord] = []
        # phase aggregates merged from other processes
        self._merged: Dict[str, Dict[str, float]] = {}

    def enable(self, reset: bool = False) -> None:
        if reset:
            self.reset()
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        self._records.clear()
        self._merged.clear()
        self._stack.clear()
        self._opened = 0
        self.t_origin = time.perf_counter()

    def span(self, name: str, rid: Optional[int] = None, **counts):
        """``with PROFILER.span("phase"): ...`` — no-op when
        disabled. ``rid`` names the request the span serves; ``counts``
        are numbers or 0-d tensors kept with it."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, rid, counts)

    def record(self, name: str, t0: float, t1: float,
               rid: Optional[int] = None, **counts) -> None:
        """Add the span ``name`` from ``t0`` to ``t1`` (``perf_counter``
        times), child of the span open now — for an interval that is not
        a ``with`` block. No-op when disabled."""
        if not self.enabled:
            return
        parent = self._stack[-1].sid if self._stack else None
        self._records.append(SpanRecord(name, t0, t1, len(self._stack),
                                        self._opened, parent, rid, counts))
        self._opened += 1

    def count(self, **counts) -> None:
        """Add ``counts`` to the innermost open span. No-op when disabled
        or when no span is open."""
        if self.enabled and self._stack:
            self._stack[-1].counts.update(counts)

    def records(self) -> List[SpanRecord]:
        """Completed spans in the order they began, their counts read to
        the host (which waits for the device where a count is a device
        tensor)."""
        return sorted((r._replace(counts={k: _host(v)
                                          for k, v in r.counts.items()})
                       for r in self._records), key=lambda r: r.sid)

    def spans(self) -> List[Tuple[str, float, float, int]]:
        """Completed spans as (name, t0_s_rel, dur_s, depth), t0
        relative to the profiler origin, chronological."""
        out = [(r.name, r.t0 - self.t_origin, r.t1 - r.t0, r.depth)
               for r in self._records]
        out.sort(key=lambda e: (e[1], e[3]))
        return out

    def aggregate(self) -> Dict[str, Dict[str, float]]:
        """Per-phase totals: name -> {count, total_s} (own spans plus
        everything ``merge()``d in)."""
        agg: Dict[str, Dict[str, float]] = {}
        for r in self._records:
            a = agg.setdefault(r.name, {"count": 0, "total_s": 0.0})
            a["count"] += 1
            a["total_s"] += r.t1 - r.t0
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
