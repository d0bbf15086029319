"""Array-native arrival streams for day-scale workloads.

``ArrivalStream`` is the columnar counterpart of ``List[Request]``: one
numpy row per request (arrival, token split, class, release). Day-scale
simulations (millions of requests) plan epochs, route, and defer as
array passes over the stream, and only *materialize* ``Request``
objects for the slices the exact event loop actually steps.

Arrival placement under a time-varying rate uses the standard
inhomogeneous-Poisson inversion: draw unit-rate exponential gaps, take
their cumulative sum ``u``, and map through the inverse cumulative rate
``Lambda^-1`` (dense-grid trapezoid integral + linear interpolation).
With the ``none`` envelope the legacy constant-rate draw is kept
bit-for-bit, and because the unit-rate path consumes the generator
identically, request *lengths* are per-seed identical across envelopes.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.sim.requests import (DEFERRABLE, INTERACTIVE, Request,
                                WorkloadConfig, zipf_lengths)
from repro_torch.workloads.envelope import (BurstOverlay, burst_overlay,
                                      cumulative_rate, rate_on_grid)


@dataclasses.dataclass
class ArrivalStream:
    """Columnar workload: row i is one request. ``ready_s`` starts as
    a copy of ``arrival_s``; epoch-granular admission (``repro_torch.
    schedule.epochs``) shifts deferrable rows forward in place."""
    cfg: WorkloadConfig
    rid: np.ndarray              # original request ids (int64)
    arrival_s: np.ndarray
    prefill_tokens: np.ndarray
    decode_tokens: np.ndarray
    deferrable: np.ndarray       # bool
    ready_s: np.ndarray
    burst: Optional[BurstOverlay] = None

    def __len__(self) -> int:
        return len(self.arrival_s)

    @property
    def tokens(self) -> np.ndarray:
        return self.prefill_tokens + self.decode_tokens

    def sorted_by_ready(self) -> "ArrivalStream":
        """Stable reorder by ready time (deferral shifts rows forward,
        breaking arrival order); epoch slicing needs sorted ready_s."""
        order = np.argsort(self.ready_s, kind="stable")
        return self.take(order)

    def take(self, idx: np.ndarray) -> "ArrivalStream":
        return ArrivalStream(
            cfg=self.cfg, rid=self.rid[idx],
            arrival_s=self.arrival_s[idx],
            prefill_tokens=self.prefill_tokens[idx],
            decode_tokens=self.decode_tokens[idx],
            deferrable=self.deferrable[idx],
            ready_s=self.ready_s[idx], burst=self.burst)

    def window(self, t0: float, t1: float) -> "tuple[int, int]":
        """[i0, i1) row range with t0 <= ready < t1 (requires rows
        sorted by ready_s)."""
        return (int(np.searchsorted(self.ready_s, t0, side="left")),
                int(np.searchsorted(self.ready_s, t1, side="left")))

    def counts(self, bounds: np.ndarray) -> np.ndarray:
        """Per-interval request counts for sorted epoch ``bounds``
        (len(bounds)-1 intervals; requires rows sorted by ready_s)."""
        edges = np.searchsorted(self.ready_s, bounds, side="left")
        return np.diff(edges)

    def to_requests(self, lo: int = 0, hi: Optional[int] = None
                    ) -> List[Request]:
        """Materialize rows [lo, hi) as event-loop ``Request`` objects
        (identical to what ``repro_torch.sim.requests.generate`` builds)."""
        hi = len(self) if hi is None else hi
        cfg = self.cfg
        out = []
        for i in range(lo, hi):
            arr = float(self.arrival_s[i])
            rdy = float(self.ready_s[i])
            if self.deferrable[i]:
                req = Request(
                    rid=int(self.rid[i]), arrival_s=arr,
                    prefill_tokens=int(self.prefill_tokens[i]),
                    decode_tokens=int(self.decode_tokens[i]),
                    klass=DEFERRABLE,
                    deadline_s=arr + cfg.deferrable_deadline_s)
            else:
                req = Request(
                    rid=int(self.rid[i]), arrival_s=arr,
                    prefill_tokens=int(self.prefill_tokens[i]),
                    decode_tokens=int(self.decode_tokens[i]),
                    klass=INTERACTIVE, slo_s=cfg.interactive_slo_s)
            if rdy > arr:
                req.release_s = rdy
            out.append(req)
        return out


def _invert_arrivals(cfg: WorkloadConfig, u: np.ndarray,
                     burst_seed_horizon: float) -> "tuple[np.ndarray, BurstOverlay]":
    """Map unit-rate cumulative exponentials through Lambda^-1 on a
    dense grid, doubling the grid horizon until Lambda covers u[-1].
    The burst overlay is prefix-stable in its horizon (sequential
    draws from a fresh generator), so extending the grid never moves
    already-placed switches."""
    qps = max(cfg.qps, 1e-9)
    horizon = max(float(u[-1]) / qps * 1.5, burst_seed_horizon, 600.0)
    while True:
        burst = burst_overlay(cfg.seed, horizon, cfg.burst_gain,
                              cfg.burst_mean_s, cfg.burst_idle_mean_s)
        t, lam = rate_on_grid(qps, cfg.envelope, cfg.envelope_amplitude,
                              cfg.envelope_period_h, cfg.envelope_phase_h,
                              burst, horizon)
        lam_cum = cumulative_rate(t, lam)
        if lam_cum[-1] >= u[-1]:
            return np.interp(u, lam_cum, t), burst
        horizon *= 2.0


def generate_stream(cfg: WorkloadConfig) -> ArrivalStream:
    """Deterministic per-seed arrival stream for any envelope.

    Draw order mirrors the legacy ``generate``: arrival gaps first,
    then lengths, then class tags — so lengths and classes are
    per-seed identical whichever envelope modulates the arrivals, and
    ``envelope="none"`` reproduces the legacy stream bit-for-bit.
    """
    n = cfg.n_requests
    rng = np.random.default_rng(cfg.seed)
    burst = None
    if cfg.envelope == "none" and cfg.burst_gain <= 1.0:
        # legacy constant-rate path, bit-identical to pre-envelope code
        if cfg.arrival == "poisson":
            gaps = rng.exponential(1.0 / max(cfg.qps, 1e-9), n)
        else:
            gaps = np.full(n, 1.0 / max(cfg.qps, 1e-9))
        arrivals = np.cumsum(gaps)
    else:
        # unit-rate draws consume the generator exactly like the
        # legacy scale-parameterized draw (numpy scales post-hoc), so
        # the zipf/class draws below see the same stream state
        if cfg.arrival == "poisson":
            u = np.cumsum(rng.exponential(1.0, n))
        else:
            u = np.arange(1, n + 1, dtype=np.float64)
        arrivals, burst = _invert_arrivals(cfg, u, 0.0)

    if cfg.length_dist == "zipf":
        lengths = zipf_lengths(rng, n, cfg.zipf_theta, cfg.min_len,
                               cfg.max_len)
    else:
        lengths = np.full(n, cfg.max_len, int)
    pf = cfg.pd_ratio / (cfg.pd_ratio + 1.0)
    prefills = np.maximum(1, np.round(lengths * pf)).astype(int)
    decodes = np.maximum(1, lengths - prefills).astype(int)
    if cfg.deferrable_frac > 0.0:
        deferrable = rng.random(n) < cfg.deferrable_frac
    else:
        deferrable = np.zeros(n, bool)

    return ArrivalStream(
        cfg=cfg, rid=np.arange(n, dtype=np.int64),
        arrival_s=arrivals.astype(np.float64),
        prefill_tokens=prefills.astype(np.int64),
        decode_tokens=decodes.astype(np.int64),
        deferrable=deferrable, ready_s=arrivals.astype(np.float64).copy(),
        burst=burst)
