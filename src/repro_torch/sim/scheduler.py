"""vLLM-style continuous-batching scheduler.

Each replica runs iterations ("batch stages"):
  - waiting prompts are admitted FCFS while the running set < batch_cap
    and the KV budget holds;
  - admitted prompts are prefilled (batched prefill iteration), possibly
    chunked (Sarathi-style) when ``chunk_prefill`` is set;
  - otherwise all running sequences decode one token per iteration.

This reproduces Vidur's replica_scheduler=vllm behavior at the fidelity
the energy model needs: batch composition + stage boundaries.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional, Tuple

from repro_torch.sim.requests import Request


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    batch_cap: int = 128              # max running sequences
    max_tokens: int = 4096            # max model len (prompt + gen)
    kv_budget_tokens: int = 512 * 1024  # per-replica KV token capacity
    chunk_prefill: Optional[int] = None  # Sarathi chunk size, None = whole

    def __post_init__(self):
        if self.chunk_prefill is not None and self.chunk_prefill < 1:
            raise ValueError(
                f"chunk_prefill must be None or >= 1, "
                f"got {self.chunk_prefill}")


class ReplicaScheduler:
    def __init__(self, cfg: SchedulerConfig):
        self.cfg = cfg
        self.waiting: Deque[Request] = deque()
        self.running: List[Request] = []
        self.kv_tokens = 0
        # prefill token counts of the batch returned by the last
        # next_batch() call, aligned with its prefills list (== full
        # prompt lengths when chunking is off), and the per-request
        # offsets of already-prefilled prompt tokens (nonzero only for
        # Sarathi chunk continuations — the exec model charges their
        # cross-chunk KV reads)
        self.last_prefill_tokens: List[int] = []
        self.last_prefill_offsets: List[int] = []
        self._chunk_by_rid: dict = {}

    def add(self, req: Request):
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def _admit(self):
        while (self.waiting
               and len(self.running) < self.cfg.batch_cap
               and self.kv_tokens + self.waiting[0].prefill_tokens
               <= self.cfg.kv_budget_tokens):
            r = self.waiting.popleft()
            self.running.append(r)
            self.kv_tokens += r.prefill_tokens

    def next_batch(self) -> Tuple[List[Request], List[Request]]:
        """Returns (prefills, decodes) for the next iteration.

        The per-request prefill token counts of the returned batch are
        exposed as ``self.last_prefill_tokens`` (chunking makes them
        differ from the full prompt lengths).

        Without chunking: prefill-only iterations take priority, then
        decode-only iterations (the seed/vLLM behavior). With
        ``chunk_prefill=C`` (Sarathi-style): each iteration carries at
        most C prompt tokens of prefill work, coalesced with one decode
        token for every already-prefilled running sequence.
        """
        self._admit()
        if self.cfg.chunk_prefill is None:
            prefills = [r for r in self.running if not r.prefilled]
            if prefills:
                self.last_prefill_tokens = [r.prefill_tokens
                                            for r in prefills]
                self.last_prefill_offsets = [r.prefill_done
                                             for r in prefills]
                self._chunk_by_rid = {r.rid: r.prefill_tokens
                                      for r in prefills}
                return prefills, []
            self.last_prefill_tokens = []
            self.last_prefill_offsets = []
            self._chunk_by_rid = {}
            decodes = [r for r in self.running
                       if r.decoded < r.decode_tokens]
            return [], decodes

        budget = self.cfg.chunk_prefill
        prefills: List[Request] = []
        chunks: List[int] = []
        for r in self.running:
            if budget <= 0:
                break
            if not r.prefilled:
                take = min(budget, r.prefill_tokens - r.prefill_done)
                prefills.append(r)
                chunks.append(take)
                budget -= take
        decodes = [r for r in self.running
                   if r.prefilled and r.decoded < r.decode_tokens]
        self.last_prefill_tokens = chunks
        self.last_prefill_offsets = [r.prefill_done for r in prefills]
        self._chunk_by_rid = {r.rid: c for r, c in zip(prefills, chunks)}
        return prefills, decodes

    def complete_iteration(self, prefills: List[Request],
                           decodes: List[Request], now: float):
        # chunk sizes are attributed per request id; anything not in
        # the last next_batch() (direct API use, retries) advances by
        # its full remaining prompt
        chunk_by_rid = self._chunk_by_rid
        self._chunk_by_rid = {}
        for r in prefills:
            took = chunk_by_rid.get(r.rid,
                                    r.prefill_tokens - r.prefill_done)
            r.prefill_done += took
            if r.prefill_done >= r.prefill_tokens:
                r.prefilled = True
                if r.t_first_token < 0:
                    r.t_first_token = now
        done = []
        for r in decodes:
            r.decoded += 1
            self.kv_tokens += 1
            if r.decoded >= r.decode_tokens:
                r.t_done = now
                done.append(r)
        for r in done:
            self.running.remove(r)
            self.kv_tokens -= r.prefill_tokens + r.decoded
        return done


def __getattr__(name):
    # RoundRobinRouter moved to the routing layer (repro_torch.fleet.routing);
    # resolved lazily here to keep the historical import path working
    # without a circular import at module load.
    if name == "RoundRobinRouter":
        from repro_torch.fleet.routing import RoundRobinRouter
        return RoundRobinRouter
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
