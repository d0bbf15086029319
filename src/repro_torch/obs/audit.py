"""Online physics-invariant auditing over the Probe protocol
(counterpart of ``repro.obs.audit``).

``AuditProbe`` rides the same hooks as the ``FlightRecorder`` (stack
them with ``MultiProbe``) and streams conservation-law and sanity
checks while the simulation runs:

* **clock-monotonic** — per-(site, replica) stage start times never go
  backwards (streamed, with epoch-boundary resets), routing instants
  are non-decreasing (requests are routed in ready order), and every
  trace row carries a positive finite duration with per-replica
  non-decreasing start times (vectorized at site rollup);
* **kv-budget** — the live scheduler's KV occupancy stays within
  ``[0, kv_budget_tokens + decode growth]`` at every committed stage
  (the budget gates admission by prompt tokens; decode then grows the
  cache one token per running request per iteration);
* **batch-cap** — recorded batch sizes never exceed ``batch_cap``
  (vectorized over the trace at site rollup);
* **request-conservation** — every request is routed at most once,
  completions never outnumber admissions (admitted = completed +
  in-flight at every event), and at finalize every generated request
  was routed exactly once;
* **request-lifecycle** — a completed request finished after its
  admission release, served its full token counts, and produced its
  first token before it was done;
* **token-conservation** — tokens of completed requests never exceed
  the tokens the stage log actually processed (completion events
  stream in; the exact totals close at site rollup, where the first
  breaching completion instant is localized against the trace);
* **autoscale-legality** — autoscaler transitions carry legal kinds,
  step the active set by exactly one in the advertised direction, and
  keep non-negative warm-spare counts;
* **admission-legality** — admission releases never precede arrivals;
* **mfu-range** / **power-range** — Eq. 1 inputs/outputs stay inside
  ``[0, 1]`` and ``[P_idle, P_peak]`` per device;
* **eq23-closure** — the per-stage attributed energy sums to the
  trace-level ``operational_energy_trace`` figure the caller reported
  (``EQ23_CLOSURE_RTOL``);
* **eq45-closure** — active + idle-bin energy/carbon integrated from
  the Eq. 5 load profile equals the microgrid co-sim totals
  (``EQ45_CLOSURE_RTOL``; the co-sim reduces in float32, hence the
  looser tolerance).

Violations accumulate into a structured ``AuditReport`` — each with
its contract name, run tag, first-violation sim-time, site, stage
index and expected/actual values — instead of raising mid-run, so one
auditor can survey a whole sweep. ``strict=True`` raises ``AuditError``
at the first violation (for tests).

The auditor is an *observer*: it never mutates schedulers, requests or
traces, so audit-on runs stay bitwise identical to probe-off runs
(neutrality, pinned by tests/test_torch_audit.py). Its checks are host
numpy, whatever the run's ``torch_device``: a torch tensor handed to a
hook (on the card or the host) is read back to the host once, by
``_host``, and nothing of the caller's state is moved or changed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.power import DEVICES
from repro_torch.obs.probe import Probe

#: Eq. 2-3 closure: the auditor recomputes the per-stage attributed
#: energy *independently* (Eq. 1 power in float64 numpy) and compares
#: against the caller's trace reduction of float32 torch power on the
#: run's ``torch_device`` — float32 power evaluation bounds the
#: agreement at ~1e-7; 1e-5 leaves two orders of headroom.
EQ23_CLOSURE_RTOL = 1e-5
#: Eq. 4-5 closure: the microgrid co-sim carries its load/CI arrays in
#: float32 torch tensors, so recomputing the same integrals in float64
#: agrees to ~1e-6; 1e-4 leaves two orders of headroom.
EQ45_CLOSURE_RTOL = 1e-4
#: Eq. 1 range check headroom: power is evaluated in float32.
POWER_RANGE_RTOL = 1e-5

#: every contract the auditor can check (report rows appear in this
#: order; diff classes are unrelated — see repro_torch.obs.diff)
CONTRACTS = (
    "clock-monotonic", "kv-budget", "batch-cap",
    "request-conservation", "request-lifecycle", "token-conservation",
    "autoscale-legality", "admission-legality",
    "mfu-range", "power-range", "eq23-closure", "eq45-closure",
)

_SCALE_KINDS = ("init", "up_warm", "up_cold", "down")


def _host(x):
    """A torch tensor (on the card or the host) as a host numpy array;
    anything else as it came. The one place the auditor reads tensor
    memory: a read, never a move or a change of the caller's tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


@dataclasses.dataclass
class AuditViolation:
    """One observed invariant breach, localized to its first offending
    event."""
    contract: str
    run: str                  # scenario tag ("" before any on_run_begin)
    site: int
    stage: int                # per-site stage index (-1: not stage-scoped)
    t_s: float                # sim-time of the event (-1.0: finalize)
    expected: str
    actual: str
    detail: str = ""

    def format(self) -> str:
        where = f"site {self.site}"
        if self.stage >= 0:
            where += f" stage {self.stage}"
        if self.t_s >= 0.0:
            where += f" t={self.t_s:.6g}s"
        run = f" [{self.run}]" if self.run else ""
        tail = f" ({self.detail})" if self.detail else ""
        return (f"{self.contract}{run} @ {where}: expected "
                f"{self.expected}, got {self.actual}{tail}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class AuditError(AssertionError):
    """Raised by ``AuditProbe(strict=True)`` at the first violation."""

    def __init__(self, violation: AuditViolation):
        super().__init__(violation.format())
        self.violation = violation


@dataclasses.dataclass
class AuditReport:
    """Structured audit outcome: every recorded violation (detection
    order — ``first`` is the earliest breach) plus per-contract check
    counters, so "clean" is distinguishable from "never checked"."""
    violations: List[AuditViolation]
    checks: Dict[str, int]          # contract -> checks evaluated
    runs: int                       # run boundaries observed
    dropped: int = 0                # violations beyond the per-contract cap

    @property
    def ok(self) -> bool:
        return not self.violations

    @property
    def first(self) -> Optional[AuditViolation]:
        return self.violations[0] if self.violations else None

    @property
    def n_checks(self) -> int:
        return sum(self.checks.values())

    def by_contract(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for v in self.violations:
            out[v.contract] = out.get(v.contract, 0) + 1
        return out

    def summary(self) -> str:
        if self.ok:
            return (f"clean — {self.n_checks} check(s) across "
                    f"{len(self.checks)} contract(s), "
                    f"{self.runs} run(s)")
        extra = f" (+{self.dropped} beyond cap)" if self.dropped else ""
        return (f"{len(self.violations)} violation(s){extra} in "
                f"{len(self.by_contract())} contract(s); first: "
                f"{self.first.format()}")

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "runs": self.runs,
            "n_checks": self.n_checks,
            "checks": dict(self.checks),
            "dropped": self.dropped,
            "by_contract": self.by_contract(),
            "violations": [v.to_dict() for v in self.violations],
        }

    def to_markdown(self) -> str:
        lines = ["# Audit report", "", f"- result: {self.summary()}",
                 f"- runs observed: {self.runs}", ""]
        lines += ["| contract | checks | violations |",
                  "|---|---:|---:|"]
        by = self.by_contract()
        for c in CONTRACTS:
            if c in self.checks or c in by:
                lines.append(f"| {c} | {self.checks.get(c, 0)} | "
                             f"{by.get(c, 0)} |")
        if self.violations:
            lines += ["", "## Violations (detection order)", "",
                      "| contract | run | site | stage | t_s | "
                      "expected | actual |", "|---|---|---:|---:|---:|"
                      "---|---|"]
            for v in self.violations:
                lines.append(
                    f"| {v.contract} | {v.run} | {v.site} | {v.stage} "
                    f"| {v.t_s:.6g} | {v.expected} | {v.actual} |")
        return "\n".join(lines) + "\n"


class AuditProbe(Probe):
    """Streaming invariant auditor (see module docstring).

    ``strict=True`` raises ``AuditError`` at the first breach;
    ``max_per_contract`` caps stored violations per (run, contract)
    pair so a systematically-broken run can't grow the report without
    bound (overflow is counted in ``AuditReport.dropped``).
    """

    __slots__ = ("strict", "max_per_contract", "_violations", "_checks",
                 "_stored", "_dropped", "_runs", "_run", "_n_stage",
                 "_n_route", "_n_comp_cons", "_n_lifecycle", "_site",
                 "_last_start", "_fsite", "_frep", "_flast", "_fst",
                 "_fsched", "_fkv",
                 "_routed", "_rlog", "_rdrained", "_route_rids",
                 "_epoch_sites", "_last_route_t", "_scale_prev")

    def __init__(self, strict: bool = False, max_per_contract: int = 8):
        self.strict = strict
        self.max_per_contract = max_per_contract
        self._violations: List[AuditViolation] = []
        self._checks: Dict[str, int] = {}     # cold-path contract counts
        self._stored: Dict[tuple, int] = {}   # (run, contract) -> stored
        self._dropped = 0
        self._runs = 0
        self._run = ""
        # hot-loop check counts are *derived*, not incremented per
        # event: stage-event tallies come from the committed trace
        # length at rollup (_audit_trace), completion tallies live in
        # the per-site state lists and route counts in the drained
        # route log, so the report folds them lazily and the hooks
        # touch no counter at all — per-event bookkeeping would
        # otherwise dominate the auditor's cost. The ``_n_*``
        # attributes hold accumulated/folded totals.
        self._n_stage = 0
        self._n_route = 0
        self._n_comp_cons = 0
        self._n_lifecycle = 0
        # run-scoped containers are created once and cleared per run
        # boundary (reset is on the per-scenario path of a sweep)
        self._site: Dict[int, list] = {}
        self._last_start: Dict[tuple, float] = {}
        self._routed: Dict[int, int] = {}
        self._rlog: list = []
        self._route_rids: set = set()
        self._epoch_sites: set = set()
        self._scale_prev: Dict[int, tuple] = {}
        self._reset_run_state()

    # single-entry (site, replica) cache for the monotonic floor and
    # site state: single-site/single-replica runs (the perf grid) hit
    # it on every stage, skipping the dict +
    # tuple-key machinery; fleet runs fall back through
    # _switch_replica on each alternation. The cache key is the
    # *scheduler identity* — each replica owns its Scheduler instance,
    # so one `is` test replaces two equality compares in the hottest
    # hook (epoch boundaries, which reuse a scheduler with a reset
    # clock, invalidate the cache in on_epoch_eval)
    def _switch_replica(self, t_s, site, replica, scheduler):
        if self._frep >= 0:
            self._last_start[(self._fsite, self._frep)] = self._flast
        st = self._site.get(site)
        if st is None:
            # budget/cap are per-site scheduler config (replicas of a
            # site share one SchedulerConfig), captured at first sight
            cfg = scheduler.cfg
            st = self._site[site] = [1, 0, cfg.kv_budget_tokens,
                                     cfg.batch_cap, 0, 0, [], 0]
        else:
            if st[2] is None:             # created by on_complete
                cfg = scheduler.cfg
                st[2] = cfg.kv_budget_tokens
                st[3] = cfg.batch_cap
            st[0] = 1                     # witnessed live (see
        last = self._last_start.get((site, replica))  # _audit_trace)
        self._fsite = site
        self._frep = replica
        self._fst = st
        self._fsched = scheduler
        self._fkv = st[2]
        if last is not None and t_s < last:
            self._violate("clock-monotonic", site, -1, t_s,
                          expected=f"start >= {last:.6g}",
                          actual=f"{t_s:.6g}",
                          detail=f"replica {replica} clock went backwards")
            self._flast = last
        else:
            self._flast = t_s
        return st

    # ---- report access ----

    def report(self) -> AuditReport:
        checks = dict(self._checks)
        ns, nr, ncc, nlc = self._folded_counts()

        def fold(contract: str, n: int) -> None:
            if n:
                checks[contract] = checks.get(contract, 0) + n

        # streamed checks only: the vectorized trace checks (row order,
        # durations, batch-cap, token-conservation) count themselves in
        # _checks at rollup time
        fold("clock-monotonic", ns + nr)
        fold("kv-budget", ns)
        fold("request-conservation", nr + ncc)
        fold("request-lifecycle", nlc)
        return AuditReport(violations=list(self._violations),
                           checks=checks, runs=self._runs,
                           dropped=self._dropped)

    # ---- internals ----

    def _live_routed(self) -> int:
        """Admissions observed in the live run (drains the route log)."""
        if self._rdrained < len(self._rlog):
            self._drain_routes()
        return sum(self._routed.values())

    def _folded_counts(self):
        """Check totals = accumulated/folded runs + the live run.

        Stage-event checks accumulate into ``_n_stage`` at rollup
        (trace length of live-witnessed sites), completions live in
        ``st[1]`` (requests) / ``len(st[6])`` (batches), admissions in
        the route cache + ``_routed`` — summing them here keeps the
        hot hooks free of counter writes.
        """
        ns = self._n_stage
        live = self._live_routed()
        nr = self._n_route + live
        ncc = self._n_comp_cons
        nlc = self._n_lifecycle
        for site, s in self._site.items():
            if s[7] < len(s[6]):    # completions not yet drained by a
                self._drain_completions(site, s)     # rollup: do now
            nlc += s[1]
            if live:      # conservation arms once admissions observed
                ncc += len(s[6])
        return ns, nr, ncc, nlc

    def _reset_run_state(self) -> None:
        if self._site or self._routed or self._rlog:
            # fold the finished run's derived counts into the bases
            (self._n_stage, self._n_route, self._n_comp_cons,
             self._n_lifecycle) = self._folded_counts()
        # site -> [witnessed, completed, kv_budget, cap, done_ptok,
        #          done_dtok, [(t, ptok, dtok) | (t, done), ...],
        #          drained-upto index]
        self._site.clear()
        self._last_start.clear()      # (site, rep) -> t
        self._fsite = -1              # cached floor entry (see
        self._frep = -1               # _switch_replica)
        self._flast = -math.inf
        self._fst: Optional[list] = None
        self._fsched = None
        self._fkv = -1
        self._routed.clear()          # site -> admitted (drained)
        self._rlog.clear()            # raw (t, rid, site) route events
        self._rdrained = 0            # log index processed so far
        self._route_rids.clear()
        self._epoch_sites.clear()
        self._last_route_t = -math.inf
        self._scale_prev.clear()      # site -> (t, act, warm)

    def _violate(self, contract: str, site: int, stage: int, t_s: float,
                 expected: str, actual: str, detail: str = "") -> None:
        key = (self._run, contract)
        stored = self._stored.get(key, 0)
        v = AuditViolation(contract=contract, run=self._run, site=site,
                           stage=stage, t_s=t_s, expected=expected,
                           actual=actual, detail=detail)
        if stored < self.max_per_contract:
            self._stored[key] = stored + 1
            self._violations.append(v)
        else:
            self._dropped += 1
        if self.strict:
            raise AuditError(v)

    def _count(self, contract: str, n: int = 1) -> None:
        self._checks[contract] = self._checks.get(contract, 0) + n

    # ---- run boundary ----

    def on_run_begin(self, tag):
        self._runs += 1
        # reset (which drains any unprocessed completions) BEFORE the
        # tag flips, so late violations carry the run they belong to
        if (self._site or self._routed or self._rlog
                or self._route_rids or self._last_start
                or self._scale_prev or self._epoch_sites):
            self._reset_run_state()
        self._run = str(tag)

    # ---- hot-loop hooks ----

    def on_stage(self, t_s, dur_s, site, replica, scheduler, n_prefill,
                 n_decode, batch_size):
        # hottest hook (every batch iteration): only the checks that
        # NEED live scheduler state run here — the monotonic floor (it
        # resets at epoch boundaries the trace can't show) and the KV
        # occupancy bound (kv_tokens is not a trace column). One fused
        # guard covers cache identity, the floor and the KV bound; the
        # clean path is a single conditional, no counter writes, no
        # allocation (stage-event check totals derive from the trace
        # length at rollup). Durations, batch caps and token staging
        # are audited vectorized from the committed trace at rollup
        # (_audit_trace); cache misses, violations and the decode-
        # grown KV allowance all take _stage_slow.
        if (scheduler is self._fsched and t_s >= self._flast
                and 0 <= scheduler.kv_tokens <= self._fkv):
            self._flast = t_s
            return
        self._stage_slow(t_s, site, replica, scheduler)

    def _stage_slow(self, t_s, site, replica, scheduler):
        if scheduler is self._fsched:
            if t_s >= self._flast:
                self._flast = t_s
            else:
                self._violate(
                    "clock-monotonic", site, -1, t_s,
                    expected=f"start >= {self._flast:.6g}",
                    actual=f"{t_s:.6g}",
                    detail=f"replica {replica} clock went backwards")
            st = self._fst
        else:
            st = self._switch_replica(t_s, site, replica, scheduler)
        kv = scheduler.kv_tokens
        if not 0 <= kv <= st[2]:
            # the budget gates *admission* (prompt tokens); decode
            # steps then grow the cache one token per running request,
            # so occupancy may legally exceed the budget by exactly
            # the decode growth of the running set — the scheduler's
            # true invariant is kv - sum(decoded) <= budget (only
            # computed once the O(1) bound has failed)
            grown = sum(r.decoded for r in scheduler.running)
            if not 0 <= kv <= st[2] + grown:
                self._violate(
                    "kv-budget", site, -1, t_s,
                    expected=f"0 <= kv_tokens <= {st[2]} + "
                             f"{grown} decode-grown",
                    actual=str(kv))

    def on_complete(self, t_s, site, replica, done):
        # per-event work is one append: the scheduler builds a fresh
        # `done` list every iteration and completed requests are
        # immutable, so holding the reference is sound — conservation,
        # lifecycle and token totals are processed in one cache-warm
        # pass per site at rollup/report/reset (_drain_completions)
        if site == self._fsite:     # completion follows its stage: the
            st = self._fst          # floor cache's site-state applies
        else:
            st = self._site.get(site)
            if st is None:
                # budget/cap unknown until the first stage reports its
                # scheduler — _switch_replica fills the None slots then
                st = self._site[site] = [0, 0, None, None, 0, 0, [], 0]
        st[6].append((t_s, done))

    def _drain_completions(self, site, st):
        """Deferred completion checks: lifecycle + conservation.

        Converts the ``(t, done)`` entries recorded by ``on_complete``
        in place to ``(t, ptok, dtok)`` and folds the per-site
        completed/token totals. The conservation compare uses the
        admission counts as of drain time — exact, because every
        admission precedes the rollup/report/reset that triggers the
        drain; a request completing before its own route event would
        still leave the cumulative count above the final admitted
        total. In strict mode the raise surfaces at drain time (the
        violation still carries the event's sim-time).
        """
        comps = st[6]
        i = st[7]
        n = len(comps)
        if self._rdrained < len(self._rlog):
            self._drain_routes()      # admission counts must be final
        # admitted = completed + in-flight at every event: the
        # in-flight term is non-negative iff completions never
        # outnumber admissions (day-mode windows route without the
        # probe, so the check arms only once routes are observed)
        admitted = (self._routed.get(site, 0) if self._routed
                    else -1)                # -1: no admissions observed
        comp = st[1]
        ptot, dtot = st[4], st[5]
        while i < n:
            t_s, done = comps[i]
            comp += len(done)
            if 0 <= admitted < comp:
                self._violate(
                    "request-conservation", site, -1, t_s,
                    expected=f"completed <= {admitted} admitted",
                    actual=f"{comp} completed")
            ptok = dtok = 0
            for r in done:
                ptok += r.prefill_tokens
                dtok += r.decode_tokens
                # first_token vs ready is deliberately NOT checked:
                # replica clocks are decoupled from the router clock,
                # so a lagging replica legally serves a request at
                # local times before its global ready instant (a
                # documented discretization of the event loop, not a
                # conservation breach). ready < arrival is expressed
                # on release_s directly (ready_s is a property; the
                # attribute read is cheaper per request)
                if (0.0 <= r.release_s < r.arrival_s
                        or not 0.0 <= r.t_first_token <= r.t_done
                        or r.decoded != r.decode_tokens
                        or r.prefill_done != r.prefill_tokens):
                    self._violate(
                        "request-lifecycle", site, -1, t_s,
                        expected="arrival <= ready, 0 <= first_token "
                                 "<= done, full token counts served",
                        actual=f"rid {r.rid}: "
                               f"arrival={r.arrival_s:.6g}, "
                               f"ready={r.ready_s:.6g}, "
                               f"first={r.t_first_token:.6g}, "
                               f"done={r.t_done:.6g}, "
                               f"decoded {r.decoded}/{r.decode_tokens}, "
                               f"prefilled {r.prefill_done}/"
                               f"{r.prefill_tokens}")
            ptot += ptok
            dtot += dtok
            comps[i] = (t_s, ptok, dtok)
            i += 1
        st[1] = comp
        st[4] = ptot
        st[5] = dtot
        st[7] = n

    def on_route(self, t_s, rid, site):
        # one append; the admission counts, duplicate-rid and ready-
        # order checks all run in one cache-warm pass at drain time
        # (_drain_routes) — before any consumer of admission state
        self._rlog.append((t_s, rid, site))

    def _drain_routes(self) -> None:
        """Deferred route checks: per-site counts, dup rids, order."""
        rlog = self._rlog
        i = self._rdrained
        n = len(rlog)
        routed = self._routed
        rids = self._route_rids
        prev = self._last_route_t
        while i < n:
            t_s, rid, site = rlog[i]
            routed[site] = routed.get(site, 0) + 1
            if rid in rids:
                self._violate("request-conservation", site, -1, t_s,
                              expected=f"rid {rid} routed once",
                              actual="routed again")
            else:
                rids.add(rid)
            if t_s < prev:
                self._violate(
                    "clock-monotonic", site, -1, t_s,
                    expected=f"route time >= {prev:.6g}",
                    actual=f"{t_s:.6g}",
                    detail="requests must route in ready order")
            else:
                prev = t_s
            i += 1
        self._last_route_t = prev
        self._rdrained = n

    def on_scale(self, t_s, site, n_active, n_warm, kind):
        self._count("autoscale-legality")
        prev = self._scale_prev.get(site)
        bad = None
        if kind not in _SCALE_KINDS:
            bad = f"kind={kind!r}"
        elif n_active < 1 or n_warm < 0:
            bad = f"n_active={n_active}, n_warm={n_warm}"
        elif prev is not None:
            pt, pact, pwarm = prev
            if t_s < pt:
                bad = f"t={t_s:.6g} < previous {pt:.6g}"
            elif kind.startswith("up") and n_active != pact + 1:
                bad = f"{kind}: n_active {pact} -> {n_active}"
            elif kind == "down" and n_active != pact - 1:
                bad = f"down: n_active {pact} -> {n_active}"
            elif kind == "up_warm" and n_warm != pwarm - 1:
                bad = f"up_warm: n_warm {pwarm} -> {n_warm}"
        if bad is not None:
            self._violate("autoscale-legality", site, -1, t_s,
                          expected="legal transition "
                                   f"({'|'.join(_SCALE_KINDS)}, "
                                   "active step of one, warm >= 0)",
                          actual=bad)
        self._scale_prev[site] = (t_s, n_active, n_warm)

    # ---- finalize hooks ----

    def on_requests(self, arrival_s, ready_s, site=-1):
        # callers pass ndarrays (simulator.py builds them); the
        # asarray fallback covers tensors and synthetic/test callers
        arrival = (arrival_s if type(arrival_s) is np.ndarray
                   else np.asarray(_host(arrival_s), np.float64))
        ready = (ready_s if type(ready_s) is np.ndarray
                 else np.asarray(_host(ready_s), np.float64))
        self._count("admission-legality")
        if len(arrival) != len(ready):
            self._violate("admission-legality", site, -1, -1.0,
                          expected="matched arrival/ready arrays",
                          actual=f"{len(arrival)} vs {len(ready)}")
        elif len(ready):
            queue_delay = ready - arrival
            if float(queue_delay.min()) < 0.0:
                i = int(np.argmin(queue_delay))
                self._violate("admission-legality", site, -1,
                              float(ready[i]),
                              expected=f"ready >= arrival "
                                       f"({arrival[i]:.6g})",
                              actual=f"{ready[i]:.6g}",
                              detail=f"request index {i}")
        if self._rlog and site < 0:
            # fleet/single-site simulations report the full request set
            # once at finalize: conservation closes when every
            # generated request was routed exactly once
            self._count("request-conservation")
            routed = self._live_routed()
            if routed != len(arrival):
                self._violate(
                    "request-conservation", site, -1, -1.0,
                    expected=f"{len(arrival)} requests routed",
                    actual=f"{routed} routed",
                    detail="admitted != completed + parked + in-flight")

    def on_epoch_eval(self, site, ev):
        # epoch windows restart replica clocks at the epoch start while
        # an exact epoch's service may spill past it — the monotonic
        # floor resets at the boundary (within a window it still
        # holds), and the site's tiled day trace concatenates epochs
        # whose spill legally rewinds across rows, so the rollup's
        # vectorized start-order check stands down for this site too
        self._epoch_sites.add(site)
        for key in [k for k in self._last_start if k[0] == site]:
            del self._last_start[key]
        if self._fsite == site:           # drop the cached floor too
            self._fsite = -1
            self._frep = -1
            self._flast = -math.inf
            self._fsched = None

    def _audit_trace(self, site, trace, start):
        """Vectorized structural checks over the committed stage log.

        Durations, per-replica start ordering, batch caps and token
        conservation are audited here with a handful of numpy
        reductions instead of per-event Python: the trace columns
        carry the same information once the run rolls up, and keeping
        them out of ``on_stage`` keeps the hot hook cheap (the clean
        path here is reductions only, with array indexing deferred to
        the violation branches).
        Returns the float64 duration column and its sum so the energy
        closure in ``on_site_rollup`` reuses both.
        """
        n = len(start)
        dur = np.asarray(_host(trace.dur_s), np.float64)
        self._count("clock-monotonic", n)
        st = self._site.get(site)
        if st is not None:
            if st[0]:
                # the site was witnessed live: the trace rows are the
                # stage events the streamed floor + KV checks covered,
                # so the per-event check totals derive here instead of
                # a counter write in the hot hook
                self._n_stage += n
            if st[7] < len(st[6]):
                self._drain_completions(site, st)
        # two reductions decide the clean path (the sum doubles as the
        # energy integral's idle term): with every duration positive,
        # any absurd/inf/NaN entry drags the sum past the bound or
        # poisons a compare — NaN fails both
        dursum = float(dur.sum())
        if not (float(dur.min()) > 0.0 and dursum <= 1e30):
            bad = ~((dur > 0.0) & (dur <= 1e30))
            if bad.any():
                i = int(np.argmax(bad))
                self._violate(
                    "clock-monotonic", site, i, float(start[i]),
                    expected="finite stage with dur_s > 0",
                    actual=f"dur_s={float(dur[i])!r}")
        if (n > 1 and (st is None or st[0] == 0)
                and site not in self._epoch_sites
                and float(np.diff(start).min()) < 0.0):
            # start-order is audited from the trace only when the
            # auditor did NOT witness the event stream live (device-
            # mode evaluation emits no on_stage): witnessed streams
            # are already covered per replica by the monotonic floor,
            # and their logs may legally interleave replicas or
            # stagger pipeline stages. Unwitnessed logs are single-
            # pass, so a backwards start is a real ordering breach —
            # still refined per replica before violating.
            rep = getattr(trace, "replica", None)
            rep = (np.zeros(n) if rep is None
                   else np.asarray(_host(rep), np.float64))
            order = np.argsort(rep, kind="stable")
            s2 = start[order]
            back = (np.diff(s2) < 0.0) & (rep[order][1:]
                                          == rep[order][:-1])
            if back.any():
                j = int(np.argmax(back))
                i = int(order[j + 1])
                self._violate(
                    "clock-monotonic", site, i, float(start[i]),
                    expected=f"replica trace start >= "
                             f"{float(s2[j]):.6g}",
                    actual=f"{float(s2[j + 1]):.6g}",
                    detail="trace rows out of start order")
        cap = st[3] if st is not None else None
        bs = _host(getattr(trace, "batch_size", None))
        if cap is not None and bs is not None:
            self._count("batch-cap", n)
            if float(bs.max()) > cap:
                bs = np.asarray(bs, np.float64)
                i = int(np.argmax(bs))
                self._violate("batch-cap", site, i, float(start[i]),
                              expected=f"batch <= {cap}",
                              actual=f"batch={int(bs[i])}")
        comps = st[6] if st is not None else None
        ptoks = _host(getattr(trace, "n_prefill_tokens", None))
        if comps and ptoks is not None:
            self._count("token-conservation", len(comps))
            staged_p = int(ptoks.sum())
            staged_d = int(_host(trace.n_decode_tokens).sum())
            # completions and stages both only accumulate, so the exact
            # totals close the conservation law; a same-event
            # pipeline-parallel stage logs staggered starts while its
            # completion reports at the event's opening instant, which
            # makes finer-than-totals timing legally ambiguous
            if st[4] > staged_p or st[5] > staged_d:
                cum_p = np.cumsum([c[1] for c in comps])
                cum_d = np.cumsum([c[2] for c in comps])
                j = int(np.argmax((cum_p > staged_p)
                                  | (cum_d > staged_d)))
                t = float(comps[j][0])
                stage = int(np.searchsorted(np.sort(start), t,
                                            side="right")) - 1
                self._violate(
                    "token-conservation", site, stage, t,
                    expected=f"completed tokens <= staged "
                             f"({staged_p}p/{staged_d}d)",
                    actual=f"{int(cum_p[j])}p/{int(cum_d[j])}d "
                           f"completed")
        return dur, dursum

    def on_site_rollup(self, site, name, trace, device, row_devices,
                       pue=1.0, ci=None, total_devices=None,
                       device_signal=None, t_end_s=None, energy_wh=None,
                       idle_energy_wh=None, carbon_active_g=None,
                       carbon_idle_g=None, cosim=None, load=None):
        dev = DEVICES[device] if isinstance(device, str) else device
        stage_sum_wh = 0.0
        if len(trace):
            start = getattr(trace, "start_s", None)
            if start is not None:
                dur, dursum = self._audit_trace(
                    site, trace, np.asarray(_host(start), np.float64))
            else:
                dur = np.asarray(_host(trace.dur_s), np.float64)
                dursum = float(dur.sum())
            mfu = np.asarray(_host(trace.mfu), np.float64)
            self._count("mfu-range")
            lo, hi = float(mfu.min()), float(mfu.max())
            if lo < 0.0 or hi > 1.0 + POWER_RANGE_RTOL:
                self._violate("mfu-range", site,
                              int(np.argmax(mfu)), -1.0,
                              expected="0 <= MFU <= 1",
                              actual=f"[{lo:.6g}, {hi:.6g}]")
            # Eq. 1 recomputed independently in float64 numpy (the
            # caller evaluates it in float32 torch on its torch_device —
            # a per-scenario device dispatch here would dominate the
            # auditor's cost; the float32-vs-float64 gap is covered by
            # EQ23_CLOSURE_RTOL)
            sat = dev.mfu_sat
            p_span = dev.p_max_inst - dev.p_idle
            gamma = dev.gamma
            # x^gamma @ dur with x = clip(mfu)/sat; when the clip is a
            # no-op (the common case) the /sat folds out of the array
            # pass: (mfu/sat)^g == mfu^g / sat^g
            if lo >= 0.0 and hi <= sat:
                xg_dot = float(np.power(mfu, gamma) @ dur) \
                    / sat ** gamma
            else:
                x = np.minimum(np.maximum(mfu, 0.0), sat) / sat
                xg_dot = float(np.power(x, gamma) @ dur)
            self._count("power-range")
            # P(u) is monotone in u, so the recomputed extrema follow
            # from the MFU extrema — no second array min/max pass
            xlo = min(max(lo, 0.0), sat) / sat
            xhi = min(max(hi, 0.0), sat) / sat
            pmin = dev.p_idle + p_span * xlo ** dev.gamma
            pmax = dev.p_idle + p_span * xhi ** dev.gamma
            if (pmin < dev.p_idle * (1.0 - POWER_RANGE_RTOL)
                    or pmax > dev.p_max_inst * (1.0 + POWER_RANGE_RTOL)):
                self._violate(
                    "power-range", site, int(np.argmax(mfu)), -1.0,
                    expected=f"{dev.p_idle:.6g} <= P(u) <= "
                             f"{dev.p_max_inst:.6g} W ({device})",
                    actual=f"[{pmin:.6g}, {pmax:.6g}] W")
            # P @ dur distributed over P(u) = P_idle + span*x^gamma:
            # the idle term folds onto the duration sum the trace
            # audit already produced, so no power array materializes
            stage_sum_wh = (dev.p_idle * dursum + p_span * xg_dot) \
                * float(row_devices) * float(pue) / 3600.0
        if energy_wh is not None:
            self._count("eq23-closure")
            ref = float(_host(energy_wh))
            if abs(stage_sum_wh - ref) > \
                    EQ23_CLOSURE_RTOL * max(abs(ref), 1e-9):
                self._violate(
                    "eq23-closure", site, -1, -1.0,
                    expected=f"sum(P_i*dt_i)*G*PUE/3600 == "
                             f"{ref:.12g} Wh",
                    actual=f"{stage_sum_wh:.12g} Wh",
                    detail=f"rtol {EQ23_CLOSURE_RTOL:g}")
        if cosim is not None and load is not None:
            times = np.asarray(_host(load.times), np.float64)
            vals = np.asarray(_host(load.values), np.float64)
            if len(times) >= 2:
                step = float(times[1] - times[0])
                self._count("eq45-closure")
                e_kwh = float(vals.sum()) * step / 3600.0 / 1000.0
                ref_e = float(_host(cosim["total_energy_kwh"]))
                if abs(e_kwh - ref_e) > \
                        EQ45_CLOSURE_RTOL * max(abs(ref_e), 1e-9):
                    self._violate(
                        "eq45-closure", site, -1, -1.0,
                        expected=f"integral(load) == {ref_e:.9g} kWh "
                                 f"(co-sim total)",
                        actual=f"{e_kwh:.9g} kWh",
                        detail=f"rtol {EQ45_CLOSURE_RTOL:g}")
                if ci is not None:
                    self._count("eq45-closure")
                    civ = (np.asarray(_host(ci.at(times)), np.float64)
                           if hasattr(ci, "at")
                           else np.full(len(times), float(ci)))
                    kg = float(np.sum(vals * civ)) * step / 3600.0 / 1e6
                    ref_c = float(_host(cosim["total_emissions_nosolar_kg"]))
                    if abs(kg - ref_c) > \
                            EQ45_CLOSURE_RTOL * max(abs(ref_c), 1e-9):
                        self._violate(
                            "eq45-closure", site, -1, -1.0,
                            expected="active + idle-bin carbon == "
                                     f"{ref_c:.9g} kg (co-sim "
                                     "no-solar total)",
                            actual=f"{kg:.9g} kg",
                            detail=f"rtol {EQ45_CLOSURE_RTOL:g}; "
                                   f"caller split: active_g="
                                   f"{carbon_active_g}, idle_g="
                                   f"{carbon_idle_g}")
