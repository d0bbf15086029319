"""Trace-divergence analysis: when device/TP/PP axes share one trace.

Scenarios that differ only in ``device``/``tp``/``pp`` run the *same*
batch compositions whenever the hardware axes provably cannot change
admission timing — then the expensive part of the event loop (the
scheduling decisions) is config-invariant and each grid point's trace
is reconstructable by re-costing one shared composition, instead of
re-running the loop per point.

The predicate here is deliberately conservative (static, over the
config family + arrival stream only): it requires every request to be
**isolated** — consecutive ready-sorted arrival gaps at least an upper
bound on the previous request's full service time under *every* config
in the family, with every prompt inside every config's resolved KV
budget and no chunked prefill. Under isolation the loop serves one
request at a time, strictly serialized: request ``i`` goes to replica
``i % R`` (round-robin), its replica fast-forwards to the ready time,
and its schedule is exactly one whole-prompt prefill followed by
``decode_tokens`` single-token decode stages at contexts ``L..L+D-1``.
``replay_result`` reconstructs that schedule directly — aggregates via
the same float expressions as ``stage_cost_scalar``, costs via the
batched roofline (bit-identical to the scalar path by construction),
and clocks via the same left-fold accumulation ``drive`` performs — so
the replayed ``SimResult`` is **bit-equal** to what ``run_simulation``
would produce (pinned by the soundness property in
tests/test_torch_sweep.py).

Uniform (non-poisson) arrival streams at sub-service rates satisfy the
predicate by construction; poisson streams rarely do (some gap is
almost always tight), which is the right failure mode for a
conservative analysis: fall back to the event loop.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.sim.execmodel import StageBatch, cached_execution_model
from repro_torch.sim.requests import Request, generate
from repro_torch.sim.simulator import SimConfig, SimResult, kv_budget_tokens
from repro_torch.sim.trace import StageTrace
from repro_torch.core.power import DEVICES
from repro_torch.sweep.grid import config_blob

#: drive()'s default horizon — a shared family must finish inside it
#: (the loop breaks mid-request past this point, which replay cannot
#: represent)
_MAX_SIM_S = 10_000_000.0


def family_blob(cfg) -> str:
    """Canonical config JSON with the hardware axes normalized out —
    configs sharing this blob differ (at most) in device/tp/pp and are
    candidates for one shared composition trace."""
    return config_blob(dataclasses.replace(cfg, device="*", tp=0, pp=0))


def _sorted_stream(cfg: SimConfig) -> Tuple[List[Request], np.ndarray]:
    """The workload draw in drive()'s admission order (stable sort by
    ready time), as (requests-in-rid-order, sorted row indices)."""
    requests = generate(cfg.workload)
    order = np.array(
        sorted(range(len(requests)), key=lambda i: requests[i].ready_s),
        np.int64)
    return requests, order


def _resolved_kv_budget(cfg: SimConfig) -> int:
    if cfg.auto_kv_budget:
        return kv_budget_tokens(cfg.model, DEVICES[cfg.device],
                                cfg.tp, cfg.pp)
    return cfg.scheduler.kv_budget_tokens


def _service_bound(cfg: SimConfig, L: np.ndarray, D: np.ndarray
                   ) -> np.ndarray:
    """Per-request upper bound on full service time under ``cfg``:
    ``t_prefill(L) + (D + 1) * t_decode(ctx = L + D)``. The roofline
    is monotone nondecreasing in context, so the decode term bounds
    every decode stage; the extra ``+1`` decode is slack dwarfing any
    accumulated summation ulps in the exact clock arithmetic."""
    em = cached_execution_model(cfg.model, cfg.device, cfg.tp, cfg.pp,
                                cfg.execmodel)
    n = len(L)
    kvpt = em.kv_bytes_per_token
    w = em.sliding_window
    avg_ctx = np.maximum(np.floor(L / 2.0), 1.0)
    pre = StageBatch(
        prefill_tokens=L, decode_count=np.zeros(n),
        score_flops=L * em._score_per_token(avg_ctx),
        kv_rw_bytes=L * kvpt)
    ub_ctx = L + D                      # one past the last decode context
    dec = StageBatch(
        prefill_tokens=np.zeros(n), decode_count=np.ones(n),
        score_flops=em._score_per_token(ub_ctx),
        kv_rw_bytes=np.minimum(ub_ctx, w) * kvpt + kvpt)
    t = em.stage_cost_batch(StageBatch.concat([pre, dec])).t_total
    return t[:n] + (D + 1.0) * t[n:]


def trace_shareable(cfgs: Sequence[SimConfig]) -> Tuple[bool, str]:
    """Conservative static predicate: may every config in the family
    share one composition trace? Returns (ok, reason)."""
    base = cfgs[0]
    if not isinstance(base, SimConfig):
        return False, "not a single-site config"
    for c in cfgs:
        if not isinstance(c, SimConfig):
            return False, "not a single-site config"
        if c.scheduler.chunk_prefill is not None:
            return False, "chunked prefill schedules depend on timing"
        if c.scheduler.batch_cap < 1:
            return False, "degenerate batch cap"
    if len({family_blob(c) for c in cfgs}) != 1:
        return False, "configs differ beyond device/tp/pp"

    requests, order = _sorted_stream(base)
    if not requests:
        return True, "empty workload"
    L = np.array([requests[i].prefill_tokens for i in order], np.float64)
    D = np.array([requests[i].decode_tokens for i in order], np.float64)
    ready = np.array([requests[i].ready_s for i in order], np.float64)
    if np.any(L < 1) or np.any(D < 1):
        return False, "degenerate request lengths"
    gaps = np.diff(ready)
    for c in cfgs:
        budget = _resolved_kv_budget(c)
        if budget <= 0 or float(L.max()) > budget:
            return False, (f"prompt exceeds KV budget on {c.device}"
                           f"/tp{c.tp}/pp{c.pp}")
        bound = _service_bound(c, L, D)
        if len(gaps) and bool(np.any(gaps < bound[:-1])):
            return False, (f"arrival gaps under service bound on "
                           f"{c.device}/tp{c.tp}/pp{c.pp}")
        if float(ready[-1] + bound[-1]) > _MAX_SIM_S:
            return False, "exceeds the event-loop horizon"
    return True, "isolated arrivals under every config"


def replay_result(cfg: SimConfig) -> SimResult:
    """Reconstruct ``run_simulation(cfg)`` bit-for-bit from the derived
    isolated schedule — valid ONLY when ``trace_shareable`` holds for a
    family containing ``cfg`` (the predicate proves the loop would make
    exactly these scheduling decisions)."""
    em = cached_execution_model(cfg.model, cfg.device, cfg.tp, cfg.pp,
                                cfg.execmodel)
    requests, order = _sorted_stream(cfg)
    n = len(order)
    pp = max(cfg.pp, 1)
    if n == 0:
        empty = {f.name: np.empty(0, np.int64 if f.name in
                                  ("n_prefill_tokens", "n_decode_tokens",
                                   "replica", "batch_size") else np.float64)
                 for f in dataclasses.fields(StageTrace)}
        return SimResult(stages=StageTrace(**empty), requests=requests,
                         cfg=cfg)

    Li = np.array([requests[i].prefill_tokens for i in order], np.int64)
    Di = np.array([requests[i].decode_tokens for i in order], np.int64)
    ready = np.array([requests[i].ready_s for i in order], np.float64)
    Lf = Li.astype(np.float64)

    # ---- iteration-level composition (1 prefill + D decodes/req) ----
    n_it = 1 + Di
    total_it = int(n_it.sum())
    seg0 = np.cumsum(n_it) - n_it                 # first iteration per req
    req_idx = np.repeat(np.arange(n), n_it)
    pos = np.arange(total_it) - seg0[req_idx]     # 0 = prefill, j = decode j
    is_pre = pos == 0
    ctx = Lf[req_idx] + (pos - 1)                 # decode ctx: L..L+D-1

    # aggregates via the same float expressions as stage_cost_scalar
    # (single-element sums are exact, so the vectorized forms match
    # the scalar path bitwise)
    kvpt = em.kv_bytes_per_token
    w = em.sliding_window
    avg_ctx = np.maximum(0.0 + np.floor(Lf / 2.0), 1.0)
    score_pre = Lf * em._score_per_token(avg_ctx)
    npt = np.where(is_pre, Lf[req_idx], 0.0)
    nd = np.where(is_pre, 0.0, 1.0)
    score = np.where(is_pre, score_pre[req_idx],
                     em._score_per_token(ctx))
    kv = np.where(is_pre, Lf[req_idx] * kvpt,
                  np.minimum(ctx, w) * kvpt + kvpt)
    costs = em.stage_cost_batch(
        StageBatch(prefill_tokens=npt, decode_count=nd,
                   score_flops=score, kv_rw_bytes=kv))
    durs = costs.t_total

    # ---- clocks: drive()'s left-fold accumulation per request ----
    starts = np.empty(total_it, np.float64)
    t_first = np.empty(n, np.float64)
    t_done = np.empty(n, np.float64)
    off = 0
    for i in range(n):
        m = int(n_it[i])
        c = np.cumsum(np.concatenate(([ready[i]], durs[off:off + m])))
        starts[off:off + m] = c[:-1]
        t_first[i] = c[1]                 # prefill completion
        t_done[i] = c[-1]
        off += m

    # ---- pipeline-stage row expansion (pp rows per iteration) ----
    rep_durs = np.repeat(durs, pp)
    ps_f = np.tile(np.arange(pp, dtype=np.float64), total_it)
    start_rows = np.repeat(starts, pp) + ps_f * rep_durs / float(pp)
    replica = (np.repeat((np.arange(n, dtype=np.int64) % cfg.n_replicas)
                         [req_idx] * pp, pp)
               + np.tile(np.arange(pp, dtype=np.int64), total_it))
    trace = StageTrace(
        start_s=start_rows, dur_s=rep_durs,
        flops_mlp=np.repeat(costs.flops_mlp, pp),
        flops_attn=np.repeat(costs.flops_attn, pp),
        mfu=np.repeat(costs.mfu, pp),
        n_prefill_tokens=np.repeat(npt, pp).astype(np.int64),
        n_decode_tokens=np.repeat(nd, pp).astype(np.int64),
        replica=replica,
        batch_size=np.ones(total_it * pp, np.int64),
        score_flops=np.repeat(score, pp),
        kv_rw_bytes=np.repeat(kv, pp))

    for i in range(n):
        r = requests[int(order[i])]
        r.prefilled = True
        r.prefill_done = int(Li[i])
        r.decoded = int(Di[i])
        r.t_first_token = float(t_first[i])
        r.t_done = float(t_done[i])
    return SimResult(stages=trace, requests=requests, cfg=cfg)
