"""Array-native stage traces.

``StageTrace`` is the structured log the event loop produces: one row
per (replica, pipeline-stage) iteration, stored as flat numpy arrays so
the energy (Eq. 2-3), carbon (Eq. 4) and co-sim (Eq. 5) accounting run
as single array passes — and so a whole trace can be re-costed through
``ExecutionModel.stage_cost_batch`` without replaying the loop.

``StageTraceBuilder`` accumulates rows into one preallocated, doubling
2-D buffer (no per-stage Python object lists); ``build()`` slices it
into the typed trace.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# column order of the builder buffer
_FIELDS = ("start_s", "dur_s", "flops_mlp", "flops_attn", "mfu",
           "n_prefill_tokens", "n_decode_tokens", "replica", "batch_size",
           "score_flops", "kv_rw_bytes")
# columns that are semantically integer counts/ids
_INT_FIELDS = frozenset({"n_prefill_tokens", "n_decode_tokens", "replica",
                         "batch_size"})


@dataclasses.dataclass
class StageTrace:
    """Batch-stage log of one deployment (or one fleet site).

    The first block of fields is the paper's Eq. 2-3 granularity
    (timing, FLOPs split, MFU); ``score_flops`` / ``kv_rw_bytes`` are
    the stage's batch-composition aggregates (``StageBatch``), kept so
    the roofline is replayable from the trace alone.
    """
    start_s: np.ndarray
    dur_s: np.ndarray
    flops_mlp: np.ndarray
    flops_attn: np.ndarray
    mfu: np.ndarray
    n_prefill_tokens: np.ndarray
    n_decode_tokens: np.ndarray
    replica: np.ndarray
    batch_size: np.ndarray
    score_flops: np.ndarray
    kv_rw_bytes: np.ndarray

    def __post_init__(self):
        n = len(self.start_s)
        for f in dataclasses.fields(self):
            if len(getattr(self, f.name)) != n:
                raise ValueError(
                    f"StageTrace columns must align: {f.name} has "
                    f"{len(getattr(self, f.name))} rows, start_s has {n}")

    def __len__(self) -> int:
        return len(self.start_s)

    def total_duration(self) -> float:
        if len(self.start_s) == 0:
            return 0.0
        return float((self.start_s + self.dur_s).max())

    def iteration_rows(self, pp: int) -> "StageTrace":
        """One row per scheduler iteration.

        The event loop logs ``pp`` rows per iteration (one per
        pipeline stage) sharing the same batch composition, so rows
        ``0, pp, 2*pp, ...`` carry the iteration-level columns. The
        sweep's trace-divergence analysis compares composition across
        device/TP/PP grid points through this view (timing columns
        still differ — only composition is parallelism-invariant).
        """
        if pp <= 1:
            return self
        if len(self) % pp:
            raise ValueError(
                f"trace length {len(self)} is not a multiple of pp={pp}")
        return StageTrace(**{f.name: getattr(self, f.name)[::pp]
                             for f in dataclasses.fields(StageTrace)})


class StageTraceBuilder:
    """Row accumulator over a preallocated (capacity, n_fields) buffer
    that doubles on overflow — the event loop appends scalars, the
    arrays come out columnar."""

    def __init__(self, capacity: int = 1024):
        self._buf = np.empty((max(capacity, 16), len(_FIELDS)), np.float64)
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def append(self, start_s: float, dur_s: float, flops_mlp: float,
               flops_attn: float, mfu: float, n_prefill_tokens: float,
               n_decode_tokens: float, replica: float, batch_size: float,
               score_flops: float, kv_rw_bytes: float) -> None:
        if self._n == len(self._buf):
            grown = np.empty((2 * len(self._buf), len(_FIELDS)), np.float64)
            grown[:self._n] = self._buf
            self._buf = grown
        self._buf[self._n] = (start_s, dur_s, flops_mlp, flops_attn, mfu,
                              n_prefill_tokens, n_decode_tokens, replica,
                              batch_size, score_flops, kv_rw_bytes)
        self._n += 1

    def build(self) -> StageTrace:
        cols = {}
        for j, name in enumerate(_FIELDS):
            col = self._buf[:self._n, j].copy()
            cols[name] = col.astype(np.int64) if name in _INT_FIELDS else col
        return StageTrace(**cols)
