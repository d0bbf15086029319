"""The traffic generator: one for every mix, driven by a mix's data file.

A mix file (``bench/traffic/<mix>.json``) gives the clients and slots of a
closed loop, the cache length a slot holds, and how request lengths are
drawn:

- ``{"total": <dist>, "pd_ratio": r}``: a total length L from <dist>, split
  as the paper's Table 1 traffic is, P = max(1, round(L r/(r+1))) prompt
  tokens and D = max(1, L - P) output tokens;
- ``{"prompt": <dist>, "output": <dist>}``: P and D drawn apart.

A <dist> is ``{"dist": "zipf", "theta", "lo", "hi"}`` (P(n) ~ n^-theta on
lo..hi), ``{"dist": "loguniform", "lo", "hi"}`` or ``{"dist": "fixed",
"value"}``. The lengths come in blocks of ``block`` requests, each block
the distribution's ``block`` quantiles at (i + 1/2)/block in an order drawn
from the seed: every seed serves the same lengths, in another order, so
seeds change which tokens are sent and not how much work they are. The
first block starts with its longest request, so that the warm-up meets the
largest shapes first. Prompt tokens are uniform over 1..V-1.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


# copied from src/repro_torch/sim/requests.py::zipf_lengths (its pmf)
def zipf_probs(theta: float, lo: int, hi: int):
    support = np.arange(lo, hi + 1, dtype=np.float64)
    probs = support ** (-theta)
    probs /= probs.sum()
    return support, probs


# copied from src/repro_torch/workloads/stream.py (generate_stream's split)
def split_pd(lengths: np.ndarray, pd_ratio: float):
    pf = pd_ratio / (pd_ratio + 1.0)
    prefills = np.maximum(1, np.round(lengths * pf)).astype(int)
    decodes = np.maximum(1, lengths - prefills).astype(int)
    return prefills, decodes


def quantiles(dist: Dict, n: int) -> np.ndarray:
    """The ``n`` lengths of ``dist`` at the quantiles (i + 1/2)/n."""
    u = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "fixed":
        return np.full(n, int(dist["value"]))
    if kind == "zipf":
        support, probs = zipf_probs(dist["theta"], dist["lo"], dist["hi"])
        idx = np.searchsorted(np.cumsum(probs), u, side="left")
        return support[np.minimum(idx, len(support) - 1)].astype(int)
    if kind == "loguniform":
        lo, hi = np.log(dist["lo"]), np.log(dist["hi"])
        return np.round(np.exp(lo + u * (hi - lo))).astype(int)
    raise ValueError(f"unknown length distribution {kind!r}")


def block_lengths(mix: Dict):
    """(prompt, output) lengths of one block, in quantile order."""
    n = mix["block"]
    if "total" in mix:
        return split_pd(quantiles(mix["total"], n), mix["pd_ratio"])
    return quantiles(mix["prompt"], n), quantiles(mix["output"], n)


@dataclass
class Request:
    index: int
    prompt: np.ndarray      # (P,) int64
    new_tokens: int


def stream(mix: Dict, seed: int, vocab: int) -> Iterator[Request]:
    """The mix's endless request stream for ``seed``."""
    rng = np.random.default_rng(seed)
    P, D = block_lengths(mix)
    if (P + D - 1 > mix["max_len"]).any():
        raise ValueError("a request does not fit the slots' max_len")
    index = itertools.count()
    for b in itertools.count():
        order = rng.permutation(len(P))
        if b == 0:
            longest = int(np.argmax(P + D))
            order = np.concatenate(([longest], order[order != longest]))
        for j in order:
            yield Request(next(index), rng.integers(1, vocab, int(P[j])),
                          int(D[j]))
