"""Fluid/request hybrid day simulation: epoch planning + fluid epochs.

Day-scale workloads (millions of requests) cannot event-step every
request. The hybrid mode partitions the day into fixed epochs, and for
each epoch either

* runs the **exact** continuous-batching event loop over the epoch's
  arrivals (transient epochs: load ramps, burst windows, saturation
  onset, deferral drain bursts, autoscale events), or
* evaluates a **fluid** approximation: event-step only a pilot slice
  of the epoch's arrivals, discard a warmup prefix, and tile the
  steady-state stage block across the epoch — synthesizing a
  representative ``StageTrace`` whose energy/carbon evaluate through
  the same batched array passes as an exact trace, with latency
  percentiles taken from the pilot sample at proportional weight.

Both day modes (``hybrid`` and ``event_loop``) segment the day into
the *same* epochs with fresh replica state at each epoch start, so an
epoch the planner marks exact sees bit-identical inputs in either mode
— transient windows agree bit-for-bit by construction, which is what
the day-smoke CI job pins. A fluid epoch whose pilot covers all its
arrivals degenerates to the exact run (weight 1, no tiling), giving
the fluid==exact property on windows with no transients.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.sim.trace import StageTrace
from repro_torch.workloads.stream import ArrivalStream

DAY_MODES = ("hybrid", "event_loop")

EXACT, FLUID = "exact", "fluid"


@dataclasses.dataclass(frozen=True)
class DayConfig:
    """Epoch segmentation + fluid-approximation knobs for a day run."""
    mode: str = "hybrid"              # hybrid | event_loop
    epoch_s: float = 900.0            # epoch length (s)
    pilot_requests: int = 256         # fluid: sampled requests per epoch
    warmup_requests: int = 64         # fluid: discarded pilot prefix
    ramp_threshold: float = 0.25      # epoch-over-epoch rate change
    burst_threshold: float = 0.5      # within-epoch sub-bin rate swing
    util_threshold: float = 0.85      # saturation onset
    drain_threshold: float = 0.15     # deferral-release mass fraction

    def __post_init__(self):
        if self.mode not in DAY_MODES:
            raise ValueError(f"unknown day mode {self.mode!r}; "
                             f"have {DAY_MODES}")
        if self.epoch_s <= 0:
            raise ValueError("epoch_s must be positive")


@dataclasses.dataclass
class Epoch:
    """One planned epoch of a site's day."""
    index: int
    t0: float
    t1: float
    i0: int                           # stream row range [i0, i1)
    i1: int
    planned: str = FLUID              # exact | fluid (planner label)
    reason: str = "steady"            # why exact / "steady" for fluid
    n_replicas: int = 1               # active replicas this epoch
    n_warm: int = 0                   # warm spares (idle power only)
    cold_from: Optional[int] = None   # replicas >= this index start at
    scale_latency_s: float = 0.0      # t0 + scale_latency_s (cold adds)


def epoch_bounds(t_end: float, epoch_s: float) -> np.ndarray:
    """[0, e, 2e, ...] covering [0, t_end] (at least one epoch)."""
    n = max(1, int(np.ceil(max(t_end, 1e-9) / epoch_s)))
    return np.arange(n + 1, dtype=np.float64) * epoch_s


def plan_epochs(stream: ArrivalStream, bounds: np.ndarray, day: DayConfig,
                tokens_per_s: float, replica_plan: np.ndarray,
                warm_plan: Optional[np.ndarray] = None,
                scale_latency_s: float = 0.0,
                drain_counts: Optional[np.ndarray] = None,
                sat_tokens_per_s: Optional[float] = None) -> List[Epoch]:
    """Classify each epoch exact/fluid from the arrival stream alone.

    ``stream`` must be sorted by ready time. ``tokens_per_s`` is the
    per-replica service-capacity estimate used for the saturation
    check; ``replica_plan``/``warm_plan`` are per-epoch active/warm
    replica counts (the autoscale plan — a count change marks the
    epoch transient). The classification never looks at simulation
    output, so both day modes plan identically.

    ``sat_tokens_per_s`` overrides the capacity used by the saturation
    check only (``util_threshold``). The day planner passes the min of
    the autoscaler's configured estimate and the roofline-derived
    ``ExecutionModel.replica_tokens_per_s`` — an optimistic configured
    estimate must not hide a queue-saturated epoch from the planner
    (the fluid pilot would tile a growing queue, losing the latency
    tail), while the autoscaler itself keeps planning replicas off its
    own estimate.
    """
    n_ep = len(bounds) - 1
    edges = np.searchsorted(stream.ready_s, bounds, side="left")
    counts = np.diff(edges)
    dts = np.diff(bounds)
    rates = counts / np.maximum(dts, 1e-9)
    tok_sums = np.zeros(n_ep)
    np.add.at(tok_sums, np.clip(
        np.searchsorted(bounds, stream.ready_s, side="right") - 1,
        0, n_ep - 1), stream.tokens.astype(np.float64))
    mean_tok = tok_sums / np.maximum(counts, 1)
    util1 = rates * mean_tok / max(tokens_per_s, 1e-9)
    util_sat = (util1 if sat_tokens_per_s is None
                else rates * mean_tok / max(sat_tokens_per_s, 1e-9))
    warm_plan = (np.zeros(n_ep, int) if warm_plan is None
                 else np.asarray(warm_plan))
    drain_counts = (np.zeros(n_ep) if drain_counts is None
                    else np.asarray(drain_counts, np.float64))

    epochs: List[Epoch] = []
    for e in range(n_ep):
        t0, t1 = float(bounds[e]), float(bounds[e + 1])
        i0, i1 = int(edges[e]), int(edges[e + 1])
        n_act = int(replica_plan[e])
        reason = None
        prev_act = int(replica_plan[e - 1]) if e > 0 else n_act
        if n_act != prev_act:
            reason = "autoscale"
        elif util_sat[e] / max(n_act, 1) > day.util_threshold:
            reason = "saturation"
        elif e > 0 and (abs(rates[e] - rates[e - 1])
                        / max(rates[e], rates[e - 1], 1e-9)
                        > day.ramp_threshold):
            reason = "ramp"
        elif drain_counts[e] / max(counts[e], 1) > day.drain_threshold:
            reason = "drain"
        elif counts[e] >= 8:
            sub = np.histogram(stream.ready_s[i0:i1],
                               bins=4, range=(t0, t1))[0]
            if (sub.max() - sub.min()) / max(sub.mean(), 1e-9) \
                    > day.burst_threshold:
                reason = "burst"
        cold = None
        if reason == "autoscale" and n_act > prev_act:
            # replicas beyond the previous active set spin up; warm
            # spares from the previous epoch reactivate instantly,
            # the rest pay the cold-start latency
            warm_prev = int(warm_plan[e - 1]) if e > 0 else 0
            first_cold = prev_act + warm_prev
            cold = first_cold if first_cold < n_act else None
        epochs.append(Epoch(
            index=e, t0=t0, t1=t1, i0=i0, i1=i1,
            planned=EXACT if reason else FLUID,
            reason=reason or "steady", n_replicas=n_act,
            n_warm=int(warm_plan[e]), cold_from=cold,
            scale_latency_s=scale_latency_s))
    return epochs


@dataclasses.dataclass
class EpochEval:
    """One epoch's evaluation: a (synthesized or exact) stage trace
    plus weighted latency samples."""
    epoch: Epoch
    trace: StageTrace
    ttft_s: np.ndarray                # per sampled request
    e2e_s: np.ndarray
    weight: float                     # requests represented per sample
    n_requests: int                   # arrivals accounted to the epoch
    n_simulated: int                  # arrivals actually event-stepped
    executed: str = EXACT             # what actually ran


def _latencies(reqs, skip: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Queueing+service latency, measured from the *ready* time
    (admission release for deferred requests, arrival otherwise) —
    the deferral wait is accounted separately (``deferral_mean_s``/
    ``deferral_max_s`` in the day summary), not folded into the
    service tail. Interactive requests are never deferred, so their
    ready time IS their arrival (the ``interactive_ttft``
    convention)."""
    ttft = np.asarray([r.t_first_token - r.ready_s for r in reqs[skip:]
                       if r.t_first_token >= 0], np.float64)
    e2e = np.asarray([r.t_done - r.ready_s for r in reqs[skip:]
                      if r.t_done >= 0], np.float64)
    return ttft, e2e


def _tile_trace(trace: StageTrace, mask: np.ndarray, t_w: float,
                span: float, t0: float, t1: float) -> StageTrace:
    """Tile the steady-state stage block (rows where ``mask``) across
    [t0, t1): copy j gets start ``(start - t_w) + t0 + j * span``."""
    reps = max(1, int(np.ceil((t1 - t0) / span)))
    base = trace.start_s[mask] - t_w + t0
    starts = np.concatenate([base + j * span for j in range(reps)])
    keep = starts < t1
    cols = {}
    for f in dataclasses.fields(StageTrace):
        col = getattr(trace, f.name)[mask]
        cols[f.name] = (starts if f.name == "start_s"
                        else np.tile(col, reps))[keep]
    return StageTrace(**cols)


def evaluate_epoch(epoch: Epoch, stream: ArrivalStream, day: DayConfig,
                   run_window: Callable, force_exact: bool = False,
                   probe=None) -> EpochEval:
    """Evaluate one epoch. ``run_window(epoch, lo, hi)`` must run the
    exact event loop over stream rows [lo, hi) with fresh replicas
    (clocked from the epoch start) and return ``(StageTrace,
    List[Request])``.

    A fluid epoch whose pilot budget covers every arrival short-
    circuits to the exact run — tiling a complete sample is the
    identity, so hybrid == event_loop bitwise on such epochs.

    ``probe`` (``repro_torch.obs.Probe``) receives ``on_epoch_eval(0, ev)``
    for every evaluation (site 0 — the day loop re-tags through
    ``SiteIndexProbe``); it never affects the result.
    """
    def _emit(ev: EpochEval) -> EpochEval:
        if probe is not None:
            probe.on_epoch_eval(0, ev)
        return ev

    n = epoch.i1 - epoch.i0
    pilot_n = day.warmup_requests + day.pilot_requests
    skip, pilot_end = day.warmup_requests, pilot_n
    exact = (force_exact or epoch.planned == EXACT or n <= pilot_n)
    if not exact:
        # Deferral releases land at a single ready instant. When a
        # sub-threshold drain clump swallows the whole default pilot
        # (t_p == t_w), extend the warmup past the clump to the first
        # organically-spread arrival so the steady-state window keeps
        # positive span — falling back to exact here would silently
        # event-step every epoch the deferral policy targets, which at
        # day scale is most of the overnight trough.
        ready = stream.ready_s[epoch.i0:epoch.i1]
        if ready[pilot_n - 1] - ready[skip] <= 1e-9:
            skip = int(np.searchsorted(ready, ready[skip] + 1e-9))
            pilot_end = skip + day.pilot_requests
            if pilot_end >= n:
                exact = True    # the clump IS the epoch: run it exactly
    if exact:
        trace, reqs = run_window(epoch, epoch.i0, epoch.i1)
        ttft, e2e = _latencies(reqs)
        return _emit(EpochEval(epoch, trace, ttft, e2e, 1.0, n, n,
                               executed=EXACT if (force_exact or
                                                  epoch.planned == EXACT)
                               else FLUID))

    trace, reqs = run_window(epoch, epoch.i0, epoch.i0 + pilot_end)
    t_w = float(reqs[skip].ready_s)
    t_p = float(reqs[-1].ready_s)
    mask = (trace.start_s >= t_w) & (trace.start_s < t_p)
    if t_p - t_w <= 1e-9 or not mask.any():
        # degenerate pilot (clumped arrivals): fall back to exact
        trace, reqs = run_window(epoch, epoch.i0, epoch.i1)
        ttft, e2e = _latencies(reqs)
        return _emit(EpochEval(epoch, trace, ttft, e2e, 1.0, n, n,
                               executed=FLUID))
    synth = _tile_trace(trace, mask, t_w, t_p - t_w, epoch.t0, epoch.t1)
    ttft, e2e = _latencies(reqs, skip=skip)
    n_sample = len(reqs) - skip
    return _emit(EpochEval(epoch, synth, ttft, e2e,
                           weight=n / max(n_sample, 1), n_requests=n,
                           n_simulated=len(reqs), executed=FLUID))


def concat_traces(traces: List[StageTrace]) -> StageTrace:
    cols = {}
    for f in dataclasses.fields(StageTrace):
        parts = [getattr(t, f.name) for t in traces if len(t)]
        cols[f.name] = (np.concatenate(parts) if parts
                        else np.empty(0, np.int64
                                      if f.name in ("n_prefill_tokens",
                                                    "n_decode_tokens",
                                                    "replica", "batch_size")
                                      else np.float64))
    return StageTrace(**cols)


def weighted_percentile(values: np.ndarray, weights: np.ndarray,
                        q: float) -> float:
    """Weighted percentile (q in [0, 100]) via the cumulative-weight
    inverse CDF; -1 when empty (matching ``latency_stats``)."""
    if len(values) == 0:
        return -1.0
    order = np.argsort(values)
    v, w = np.asarray(values)[order], np.asarray(weights)[order]
    cum = np.cumsum(w)
    return float(np.interp(q / 100.0 * cum[-1], cum, v))
