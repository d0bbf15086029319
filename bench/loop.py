"""The closed loop that drives ``ServingEngine.submit`` / ``step``.

N clients each keep one request outstanding: each submits its next request
from the mix's stream the moment its last one retires. Every request is
timed by the host clock (``time.perf_counter``): from its submission, its
first token at the end of its prefill iteration, each later one at the end
of the decode step that carries it. Each step ends with the engine's copy of
the argmax to the host, which waits for the card.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List


@dataclass
class Iteration:
    t0: float
    t1: float
    kind: str                 # prefill | decode
    tokens: int               # prefill: P + its first token; decode: rows served
    prompt: int = 0           # prefill: P
    keys: List[int] = field(default_factory=list)  # decode: keys each served row's query sees


@dataclass
class Served:
    prompt: object            # (P,) int64
    new_tokens: int
    t_submit: float
    t_first: float = math.nan
    t_done: float = math.nan
    tokens: List[int] = field(default_factory=list)


class ClosedLoop:
    def __init__(self, engine, requests: Iterator, clients: int):
        from repro_torch.serve.engine import ServeRequest
        self._make = ServeRequest
        self.engine = engine
        self.requests = requests
        self.served: Dict[int, Served] = {}
        self.iterations: List[Iteration] = []
        self.first = [self._submit() for _ in range(clients)]

    def _submit(self) -> int:
        r = next(self.requests)
        self.engine.submit(self._make(rid=r.index, prompt=r.prompt,
                                      max_new_tokens=r.new_tokens))
        self.served[r.index] = Served(r.prompt, r.new_tokens,
                                      time.perf_counter())
        return r.index

    def step(self) -> Iteration:
        eng = self.engine
        active = [s for s in eng.slots if s is not None]
        # the engine prefills the first waiting request when a slot is free
        nxt = eng.waiting[0] if eng.waiting and None in eng.slots else None
        n_done = len(eng.done)
        t0 = time.perf_counter()
        eng.step()
        t1 = time.perf_counter()
        log = eng.logs[-1]
        if log.kind == "prefill":
            self.served[nxt.rid].t_first = t1
            it = Iteration(t0, t1, "prefill", log.n_tokens + 1,
                           prompt=log.n_tokens)
        else:
            keys = [len(r.prompt) + len(r.generated) for r in active]
            it = Iteration(t0, t1, "decode", len(active), keys=keys)
        for r in eng.done[n_done:]:
            s = self.served[r.rid]
            s.t_done, s.tokens = t1, list(r.generated)
            self._submit()
        self.iterations.append(it)
        return it

    def warm_up(self):
        """Steps until every client has finished its first request."""
        while not all(math.isfinite(self.served[i].t_done) for i in self.first):
            self.step()

    def run(self, seconds: float):
        """Steps until ``seconds`` have passed; returns (open, close) host
        times: the close is the end of the last step, so every step of the
        window lies whole inside it."""
        start = len(self.iterations)
        t_open = time.perf_counter()
        while time.perf_counter() - t_open < seconds:
            self.step()
        return t_open, (self.iterations[-1].t1 if len(self.iterations) > start
                        else t_open)
