"""Workload generation: Poisson arrivals, Zipf request lengths, P:D split.

Matches the paper's Table 1 parameterization: request lengths drawn from
a Zipf distribution over [min_len, max_len] (theta=0.6 in the
integration case study), arrivals Poisson at a configured QPS, and a
prefill:decode token-ratio knob.

Workload classes (``repro_torch.schedule``): a configurable fraction of
requests is tagged ``deferrable`` — batch-style work (evals, embedding
jobs, summarization queues) that tolerates delay up to a per-request
deadline. The rest stay ``interactive`` with a TTFT SLO. Class tags are
drawn *after* the arrival/length streams, so a workload with
``deferrable_frac=0`` is bit-identical to one generated before classes
existed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np

INTERACTIVE = "interactive"
DEFERRABLE = "deferrable"


@dataclasses.dataclass
class Request:
    rid: int
    arrival_s: float
    prefill_tokens: int
    decode_tokens: int
    # workload class (repro_torch.schedule): interactive requests carry a TTFT
    # SLO; deferrable requests carry an absolute completion deadline and
    # may be parked by an admission policy until release_s
    klass: str = INTERACTIVE
    slo_s: float = math.inf           # TTFT SLO (interactive)
    deadline_s: float = math.inf      # absolute completion deadline
    release_s: float = -1.0           # admission release time (<0 = arrival)
    # runtime state
    decoded: int = 0
    prefilled: bool = False
    prefill_done: int = 0        # prompt tokens prefilled so far (chunking)
    t_first_token: float = -1.0
    t_done: float = -1.0

    @property
    def ready_s(self) -> float:
        """When the request becomes visible to routing: its admission
        release time if an admission policy parked it, else arrival."""
        return self.release_s if self.release_s >= 0 else self.arrival_s


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    n_requests: int = 1024
    qps: float = 6.45
    arrival: str = "poisson"          # poisson | uniform
    length_dist: str = "zipf"         # zipf | fixed
    zipf_theta: float = 0.6
    min_len: int = 128
    max_len: int = 4096
    pd_ratio: float = 20.0            # prefill:decode token ratio
    seed: int = 0
    # workload classes (repro_torch.schedule): fraction of requests tagged
    # deferrable, their relative completion deadline, and the TTFT SLO
    # attached to the interactive class
    deferrable_frac: float = 0.0
    deferrable_deadline_s: float = 3600.0
    interactive_slo_s: float = 30.0
    # day-scale rate modulation (repro_torch.workloads): a diurnal envelope
    # over the mean qps plus an MMPP-style burst overlay. The defaults
    # (envelope "none", gain 1.0) keep the legacy constant-rate stream
    # bit-for-bit, pinned by tests/test_workloads.py
    envelope: str = "none"            # none | sinusoidal | diurnal
    envelope_amplitude: float = 0.35
    envelope_period_h: float = 24.0
    envelope_phase_h: float = 0.0
    burst_gain: float = 1.0           # rate multiplier during bursts
    burst_mean_s: float = 0.0         # mean burst duration (0 = off)
    burst_idle_mean_s: float = 3600.0  # mean gap between bursts


def zipf_lengths(rng, n: int, theta: float, lo: int, hi: int) -> np.ndarray:
    support = np.arange(lo, hi + 1, dtype=np.float64)
    probs = support ** (-theta)
    probs /= probs.sum()
    return rng.choice(support, size=n, p=probs).astype(int)


def generate(cfg: WorkloadConfig) -> List[Request]:
    """Materialized request list; arrival placement, length draws and
    class tags live in ``repro_torch.workloads.stream.generate_stream`` (the
    array-native form day-scale simulations consume directly)."""
    from repro_torch.workloads.stream import generate_stream
    return generate_stream(cfg).to_requests()
