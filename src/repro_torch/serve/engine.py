"""Continuous-batching serving engine running the real model on the card.

Counterpart of ``repro.serve.engine``, with the same slot semantics:
``max_slots`` sequences share one decode cache; a free slot is refilled from
the waiting queue by a single-sequence prefill whose K/V go into that slot;
one decode step advances every slot by a token (inactive slots included, as
in the reference, whose ``lengths`` advance for every row). The cache is
the family's: K/V rows for the transformer families (dense, MoE, VLM), the
recurrent states (token-shift and wkv) for RWKV6, and for Zamba2 K/V with a
leading application axis beside the Mamba2 conv and ssm states. Under
M-RoPE the model numbers text tokens itself (all three streams equal).
Decoding is greedy.

Every iteration is logged (start, duration, token counts) so the served
trace can be priced by Eq. 1 and Eq. 4. Each duration ends with the argmax
copied to the host, which waits for the device, so it times the work and not
only its enqueueing.

While ``obs.spans.PROFILER`` is enabled the engine spans its work:
``serve.queued`` from a request's submission to the start of its prefill
(request id), ``serve.prefill`` (request id, ``prompt`` tokens) and
``serve.decode`` (``rows`` served) around each iteration, and
``serve.sample`` around the argmax and its copy to the host.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.lm import Model
from repro_torch.obs.spans import PROFILER


@dataclasses.dataclass
class ServeRequest:
    rid: int
    prompt: np.ndarray                 # (P,) int
    max_new_tokens: int = 16
    # runtime
    generated: Optional[List[int]] = None
    slot: int = -1
    t_submit: float = 0.0
    t_queued: Optional[float] = None   # perf_counter at submit, spans on
    t_first: float = -1.0
    t_done: float = -1.0


@dataclasses.dataclass
class IterationLog:
    start_s: float
    dur_s: float
    kind: str          # prefill | decode
    n_tokens: int
    batch: int


class ServingEngine:
    def __init__(self, model: Model, params, max_slots: int = 8,
                 max_len: int = 512, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.max_slots = max_slots
        self.max_len = max_len
        self.cache = model.init_cache(max_slots, max_len, device=self.device)
        self.slots: List[Optional[ServeRequest]] = [None] * max_slots
        self.waiting: List[ServeRequest] = []
        self.done: List[ServeRequest] = []
        self.logs: List[IterationLog] = []
        self.clock = 0.0

    # -------------- public API --------------
    def submit(self, req: ServeRequest):
        req.generated = []
        req.t_submit = self.clock
        if PROFILER.enabled:
            req.t_queued = time.perf_counter()
        self.waiting.append(req)

    def run(self, max_iters: int = 10_000):
        while (self.waiting or any(self.slots)) and max_iters > 0:
            self.step()
            max_iters -= 1
        return self.done

    # -------------- internals --------------
    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def step(self):
        free = self._free_slots()
        t0 = time.perf_counter()
        if self.waiting and free:
            req = self.waiting.pop(0)
            if req.t_queued is not None:
                PROFILER.record("serve.queued", req.t_queued, t0, rid=req.rid)
            slot = free[0]
            P = len(req.prompt)
            with PROFILER.span("serve.prefill", rid=req.rid, prompt=P):
                tokens = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                         device=self.device)[None]
                # the prompt's K/V (or recurrent states) are written into
                # the slot's cache row in place (the reference rebuilds the
                # whole shared cache on every insert)
                logits, _ = self.model.prefill(self.params, {"tokens": tokens},
                                               self.max_len, cache=self.cache,
                                               slot=slot)
                with PROFILER.span("serve.sample"):
                    tok = int(torch.argmax(logits[0]))
            req.slot = slot
            req.generated.append(tok)
            req.t_first = self.clock
            self.slots[slot] = req
            dur = time.perf_counter() - t0
            self.logs.append(IterationLog(self.clock, dur, "prefill", P, 1))
            self.clock += dur
            self._retire(req)
            return

        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return
        with PROFILER.span("serve.decode", rows=len(active)):
            tokens = np.zeros((self.max_slots, 1), np.int64)
            for i in active:
                tokens[i, 0] = self.slots[i].generated[-1]
            logits, self.cache = self.model.decode_step(
                self.params,
                {"tokens": torch.as_tensor(tokens, device=self.device)},
                self.cache)
            with PROFILER.span("serve.sample"):
                nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        dur = time.perf_counter() - t0
        self.logs.append(IterationLog(self.clock, dur, "decode",
                                      len(active), len(active)))
        self.clock += dur
        for i in active:
            req = self.slots[i]
            req.generated.append(int(nxt[i]))
            self._retire(req)

    def _retire(self, req: ServeRequest):
        if len(req.generated) >= req.max_new_tokens:
            req.t_done = self.clock
            if req.slot >= 0:
                self.slots[req.slot] = None
                # only the length is reset. Stale K/V of a reused slot lie
                # past its length and are masked; stale recurrent states
                # (RWKV6's three, Zamba2's conv and ssm) are overwritten, all
                # of them, by the next prefill into the slot. The reference
                # zeroes them here, but decode goes on advancing every slot,
                # free ones included, so a zeroed state would not stay zero
                # either.
                self.cache["lengths"][req.slot] = 0
            self.done.append(req)
