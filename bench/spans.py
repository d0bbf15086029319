"""The program's spans in a profiled slice, and the per-layer readings they
give.

With ``repro_torch.obs.spans.PROFILER`` enabled, every span of the served
path is also a ``torch.profiler.record_function`` range: a host event
(``user_annotation``) on the launching thread, on the profiler's clock, and
a ``gpu_user_annotation`` record among the device's that stretches over
the gaps between its kernels. ``device_ops`` keeps the latter out of the
device's operations; the rest puts each launch, each device operation and
each idle gap down to the program spans that hold it, and reads the
engine's and the MoE layer's numbers from them and from the span records
(``PROFILER.records()``, on ``time.perf_counter``'s clock).

Every reading returns None where the trace or the records hold no spans:
a program without them is read as before.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from bench.profile import ISSUED
from bench.roofline import HBM_BYTES_PER_S, PEAK_BF16_FLOPS

WEIGHT_BYTES = 2          # bf16 expert weights
COUNTERS = "trace.count"  # the span of the program's own counting ops


def is_annotation(e) -> bool:
    """A ``record_function`` range, on the host or its device twin."""
    return bool(getattr(e, "is_user_annotation", False)) or getattr(
        e, "activity_type", None) in ("user_annotation", "gpu_user_annotation")


def device_ops(device) -> list:
    """The device's operations: its records less the spans' ranges."""
    return [e for e in device if not is_annotation(e)]


def _ranges(host) -> List[Tuple[float, float, str]]:
    """The program spans, (start, end, name) in order of start, outer
    before inner: those of the thread that holds most of them (the served
    path runs on one thread)."""
    threads: Dict[int, List[Tuple[float, float, str]]] = {}
    for e in host:
        if is_annotation(e):
            threads.setdefault(e.thread, []).append(
                (e.time_range.start, e.time_range.end, e.name))
    if not threads:
        return []
    spans = max(threads.values(), key=len)
    return sorted(spans, key=lambda s: (s[0], -s[1]))


def _chains(spans: Sequence[Tuple[float, float, str]],
            times: Sequence[float]) -> List[Tuple[str, ...]]:
    """For each of ``times``, the names of the ``spans`` (nested, in order
    of start) that hold it, outermost first."""
    order = sorted(range(len(times)), key=lambda i: times[i])
    out: List[Tuple[str, ...]] = [()] * len(times)
    stack: List[Tuple[float, float, str]] = []
    j = 0
    for i in order:          # a sweep: the spans of one thread nest
        t = times[i]
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = tuple(s[2] for s in stack)
    return out


def launches(device, host) -> List[Tuple[object, Optional[object], Tuple[str, ...]]]:
    """Each launch and copy the host issued (``profile.ISSUED``): (its
    host event, its device operation by correlation id or None, the
    program spans that held it when it was issued, outermost first). The
    runtime's events are matched to the spans by time alone: a launch
    linked to no PyTorch operation (a kernel library's, through ctypes)
    may carry the runtime's own thread id."""
    ops = {e.id: e for e in device_ops(device)}
    issued = [e for e in host if ISSUED.match(e.name)]
    chains = _chains(_ranges(host), [e.time_range.start for e in issued])
    return [(e, ops.get(e.id), c) for e, c in zip(issued, chains)]


def by_span(device, host) -> Dict[str, List[float]]:
    """Device seconds and launches issued, by the innermost program span
    that issued them (``host`` where none did): name -> [seconds,
    launches]."""
    out: Dict[str, List[float]] = {}
    for _, op, chain in launches(device, host):
        row = out.setdefault(chain[-1] if chain else "host", [0.0, 0])
        row[1] += 1
        if op is not None:
            row[0] += op.time_range.elapsed_us() * 1e-6
    return out


def idle_by_span(busy: List[Tuple[float, float]], host, top: int = 12
                 ) -> List[List]:
    """The idle gaps between device operations, each put to the innermost
    program span open at its middle (``host`` where none is), summed by
    name: the ``top`` largest [name, seconds]."""
    spans = _ranges(host)
    gaps = [((a + b) / 2, (b - a) * 1e-6)
            for (_, a), (b, _) in zip(busy, busy[1:])]
    out: Dict[str, float] = {}
    for (_, seconds), chain in zip(gaps, _chains(spans, [m for m, _ in gaps])):
        name = chain[-1] if chain else "host"
        out[name] = out.get(name, 0.0) + seconds
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:top]]


def moe_split(device, host) -> Dict[str, Dict[str, float]]:
    """Device seconds of the MoE layer's work (under ``model.moe``, not
    under ``trace.count``) by iteration kind and by innermost span
    (``model.moe`` itself for work outside its stages)."""
    out: Dict[str, Dict[str, float]] = {}
    for _, op, chain in launches(device, host):
        kind = _kind(chain)
        if op is None or kind is None or "model.moe" not in chain \
                or COUNTERS in chain:
            continue
        row = out.setdefault(kind, {})
        row[chain[-1]] = row.get(chain[-1], 0.0) + op.time_range.elapsed_us() * 1e-6
    return out


def _kind(chain: Tuple[str, ...]) -> Optional[str]:
    for name, kind in (("serve.prefill", "prefill"), ("serve.decode", "decode")):
        if name in chain:
            return kind
    return None


def decode_launches(host) -> Optional[float]:
    """Launches and copies issued under ``serve.decode`` spans in the
    slice (not under ``trace.count``) over its decode steps."""
    steps = sum(s[2] == "serve.decode" for s in _ranges(host))
    if not steps:
        return None
    n = sum(1 for _, _, chain in launches([], host)
            if "serve.decode" in chain and COUNTERS not in chain)
    return n / steps


def moe_bound_s(counts: Dict[str, float]) -> float:
    """The least time of one MoE layer: each kept assignment's three
    products computed once at the bf16 peak, or each routed expert's three
    matrices read once from HBM, whichever is longer."""
    per_expert = 3 * counts["d_model"] * counts["d_expert"]
    return max(2 * per_expert * counts["kept"] / PEAK_BF16_FLOPS,
               WEIGHT_BYTES * per_expert * counts["routed"] / HBM_BYTES_PER_S)


def moe_roofline(device, host, records, kind: str) -> Optional[float]:
    """%: over the slice's ``kind`` iterations (prefill or decode), the
    MoE layers' least times (``moe_bound_s``) over the device seconds of
    the work issued under their ``model.moe`` spans (not ``trace.count``).
    ``records`` are the span records of the slice (``PROFILER.records()``
    after a reset at its start); the n-th ``model.moe`` record is the n-th
    ``model.moe`` range of the trace. None where the slice holds no such
    span or the two disagree."""
    spans = _ranges(host)
    ranges = [s for s in spans if s[2] == "model.moe"]
    moe = [r for r in records if r.name == "model.moe" and "kept" in r.counts]
    if not ranges or len(moe) < len(ranges):
        return None
    by_sid = {r.sid: r for r in records}
    kinds = _chains(spans, [s[0] for s in ranges])
    bound = 0.0
    for rec, chain in zip(sorted(moe, key=lambda r: r.sid), kinds):
        if _kind(chain) != _record_kind(rec, by_sid):
            return None
        if _kind(chain) == kind:
            bound += moe_bound_s(rec.counts)
    busy = sum(moe_split(device, host).get(kind, {}).values())
    return 100.0 * bound / busy if busy else None


def _record_kind(rec, by_sid) -> Optional[str]:
    chain = []
    while rec.parent is not None:
        rec = by_sid[rec.parent]
        chain.append(rec.name)
    return _kind(tuple(chain))


def queue_wait_p90_ms(records, t_open: float, t_close: float) -> Optional[float]:
    """The 90th percentile (linear between order statistics) of
    ``serve.queued`` over the requests whose prefill started in the window
    [t_open, t_close] (``perf_counter`` times), in ms."""
    import numpy as np
    waits = [(r.t1 - r.t0) * 1e3 for r in records
             if r.name == "serve.queued" and t_open <= r.t1 <= t_close]
    return float(np.percentile(waits, 90)) if waits else None
