"""First-divergence explainer for sweep records, golden records and
flight-trace stage tables (counterpart of ``repro.obs.diff``).

``repro_torch.obs.diff`` turns an opaque "arrays differ" failure into a
localized explanation: it aligns two runs (by scenario key and stage
index), walks their columns in the paper's dependency order —
composition → roofline time → power → energy → carbon → latency
percentiles — and reports the *first* divergent (scenario, stage,
column) cell, so the earliest broken link in the Eq. 1-5 chain is
named instead of its downstream fallout. Every divergent cell is then
classified against the repo's named tolerance contracts:

* ``host-bitwise`` (rtol 0) — the contract identical cells satisfy;
* ``DEVICE_MODE_RTOL`` — Eq. 1 in float32 on another device or
  library, and the batched device grid, vs host numerics
  (``repro_torch.core.power``, ``repro_torch.sweep.device``);
* ``TORCH_BACKEND_RTOL`` — torch vs numpy roofline backends
  (``repro_torch.sim.execmodel``; the reference names its own
  ``JAX_BACKEND_RTOL``);
* ``DAY_FLUID_RTOL`` — fluid vs exact day epochs
  (``repro_torch.sweep.scenarios``);
* ``regression`` — outside every named contract: a real drift.

Entry points: ``diff_records`` (two sweep result sets),
``diff_golden`` (a metrics dict vs a golden record, bit-exact),
``diff_stage_tables`` (two flight-recorder stage tables),
``assert_golden`` (test helper that raises through the explainer and
writes the report artifact), and ``python -m repro_torch.obs diff A B``.

Reports render as markdown (CI artifact) and machine-readable JSON
(``schema`` 1) under ``results/torch/obs/divergence/``.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: where CI jobs and ``assert_golden`` drop divergence reports
DIVERGENCE_DIR = Path("results") / "torch" / "obs" / "divergence"

#: report JSON schema version (the reference's, pinned by tests/test_diff.py)
REPORT_SCHEMA = 1

#: dependency (walk) order of the Eq. 1-5 chain
PHASES = ("composition", "roofline", "power", "energy", "carbon",
          "latency", "other")

#: phase keyword tables, *matched* in specificity order (latency
#: before carbon before energy ... ) so e.g. ``grid_ci_g_per_kwh``
#: lands in carbon, not energy
_PHASE_KEYWORDS = (
    ("latency", ("ttft", "e2e", "tpot", "p50", "p90", "p95", "p99",
                 "latency", "slo")),
    ("carbon", ("carbon", "emission", "_ci", "ci_", "solar", "grid",
                "renewable", "offset", "soc", "battery", "charging",
                "discharging")),
    ("energy", ("energy", "_wh", "_kwh", "joule")),
    ("power", ("power", "watt")),
    ("roofline", ("duration", "dur", "time", "gpu_hours", "throughput",
                  "qps", "mfu", "t_s", "busy", "idle_s", "weight")),
    ("composition", ("stage", "batch", "prefill", "decode", "token",
                     "request", "queue", "running", "replica", "site",
                     "device", "epoch", "n_", "kv")),
)


def column_phase(column: str) -> str:
    """Map a metric/column name onto its Eq. 1-5 phase."""
    low = column.lower()
    for phase, words in _PHASE_KEYWORDS:
        if any(w in low for w in words):
            return phase
    return "other"


def _phase_rank(column: str) -> Tuple[int, str]:
    return PHASES.index(column_phase(column)), column


def tolerance_contracts() -> List[Tuple[str, float]]:
    """The named tolerance ladder, tightest first. Imported lazily so
    ``repro_torch.obs`` never drags the sweep/sim layers in at import time."""
    from repro_torch.sim.execmodel import TORCH_BACKEND_RTOL
    from repro_torch.sweep.device import DEVICE_MODE_RTOL
    from repro_torch.sweep.scenarios import DAY_FLUID_RTOL
    return [("host-bitwise", 0.0),
            ("DEVICE_MODE_RTOL", DEVICE_MODE_RTOL),
            ("TORCH_BACKEND_RTOL", TORCH_BACKEND_RTOL),
            ("DAY_FLUID_RTOL", DAY_FLUID_RTOL),
            ("regression", math.inf)]


def classify(rel: float,
             contracts: Optional[Sequence[Tuple[str, float]]] = None
             ) -> str:
    """Name the tightest tolerance contract a relative divergence
    satisfies (``host-bitwise`` for identical, ``regression`` beyond
    every named rtol)."""
    for name, rtol in contracts or tolerance_contracts():
        if rel <= rtol:
            return name
    return "regression"


def _rel(a, b) -> float:
    """Relative divergence: 0.0 identical, inf incomparable."""
    if isinstance(a, bool) or isinstance(b, bool) \
            or not isinstance(a, (int, float)) \
            or not isinstance(b, (int, float)):
        return 0.0 if a == b else math.inf
    fa, fb = float(a), float(b)
    if fa == fb:
        return 0.0
    if math.isnan(fa) and math.isnan(fb):
        return 0.0
    if not (math.isfinite(fa) and math.isfinite(fb)):
        return math.inf
    return abs(fa - fb) / max(abs(fa), abs(fb))


@dataclasses.dataclass
class DivergentCell:
    """One (scenario, stage, column) cell where the two sides differ,
    with its contract classification."""
    scenario: str
    stage: int             # stage/row index; -1 for whole-run metrics
    column: str
    a: object
    b: object
    rel: float
    contract: str
    phase: str

    def format(self) -> str:
        where = self.scenario
        if self.stage >= 0:
            where += f" stage {self.stage}"
        rel = "inf" if math.isinf(self.rel) else f"{self.rel:.3g}"
        return (f"({where}, {self.column}) [{self.phase}]: "
                f"{self.a!r} vs {self.b!r} (rel {rel}, {self.contract})")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if isinstance(self.rel, float) and math.isinf(self.rel):
            d["rel"] = "inf"
        return d


@dataclasses.dataclass
class DiffResult:
    """Outcome of one comparison. ``cells`` holds every divergent cell
    in dependency-walk order — ``first`` is the earliest broken link in
    the chain, the cell to debug."""
    kind: str                       # records | golden | stage-table
    label_a: str
    label_b: str
    n_compared: int                 # cells compared
    n_scenarios: int                # aligned scenarios / tables
    cells: List[DivergentCell]
    only_a: List[str] = dataclasses.field(default_factory=list)
    only_b: List[str] = dataclasses.field(default_factory=list)

    @property
    def identical(self) -> bool:
        return not self.cells and not self.only_a and not self.only_b

    @property
    def first(self) -> Optional[DivergentCell]:
        return self.cells[0] if self.cells else None

    @property
    def worst_contract(self) -> str:
        order = [name for name, _ in tolerance_contracts()]
        worst = "host-bitwise"
        for c in self.cells:
            if order.index(c.contract) > order.index(worst):
                worst = c.contract
        return worst

    @property
    def has_regression(self) -> bool:
        return any(c.contract == "regression" for c in self.cells) \
            or bool(self.only_a or self.only_b)

    def by_contract(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for c in self.cells:
            out[c.contract] = out.get(c.contract, 0) + 1
        return out

    def summary(self) -> str:
        if self.identical:
            return (f"identical — {self.n_compared} cell(s) across "
                    f"{self.n_scenarios} scenario(s) (host-bitwise)")
        parts = [f"{n} {name}" for name, n in
                 sorted(self.by_contract().items())]
        extra = ""
        if self.only_a or self.only_b:
            extra = (f"; unmatched: {len(self.only_a)} only in A, "
                     f"{len(self.only_b)} only in B")
        return (f"{len(self.cells)}/{self.n_compared} cell(s) diverge "
                f"({', '.join(parts)}){extra}; first: "
                f"{self.first.format() if self.first else 'n/a'}")

    def to_dict(self) -> dict:
        return {
            "schema": REPORT_SCHEMA,
            "kind": self.kind,
            "a": self.label_a,
            "b": self.label_b,
            "identical": self.identical,
            "has_regression": self.has_regression,
            "worst_contract": self.worst_contract,
            "n_compared": self.n_compared,
            "n_scenarios": self.n_scenarios,
            "by_contract": self.by_contract(),
            "first": self.first.to_dict() if self.first else None,
            "cells": [c.to_dict() for c in self.cells],
            "only_a": list(self.only_a),
            "only_b": list(self.only_b),
        }

    def to_markdown(self) -> str:
        lines = [f"# Divergence report ({self.kind})", "",
                 f"- A: `{self.label_a}`",
                 f"- B: `{self.label_b}`",
                 f"- result: {self.summary()}", ""]
        if self.first is not None:
            lines += ["## First divergence (dependency order: "
                      + " → ".join(PHASES[:-1]) + ")", "",
                      f"`{self.first.format()}`", ""]
        if self.cells:
            lines += ["## Divergent cells", "",
                      "| scenario | stage | column | phase | A | B | "
                      "rel | contract |",
                      "|---|---:|---|---|---|---|---|---|"]
            for c in self.cells:
                rel = "inf" if math.isinf(c.rel) else f"{c.rel:.3g}"
                lines.append(
                    f"| {c.scenario} | {c.stage} | {c.column} | "
                    f"{c.phase} | {c.a} | {c.b} | {rel} | "
                    f"{c.contract} |")
            lines.append("")
        if self.only_a:
            lines += ["## Only in A", ""] + \
                [f"- {k}" for k in self.only_a] + [""]
        if self.only_b:
            lines += ["## Only in B", ""] + \
                [f"- {k}" for k in self.only_b] + [""]
        lines += ["## Tolerance ladder", "",
                  "| contract | rtol |", "|---|---|"]
        for name, rtol in tolerance_contracts():
            lines.append(f"| {name} | {rtol:g} |")
        return "\n".join(lines) + "\n"


# ----------------------------------------------------------- engines --


def _diff_metrics(scenario: str, ma: dict, mb: dict,
                  cells: List[DivergentCell],
                  contracts: Sequence[Tuple[str, float]]) -> int:
    """Walk one scenario's metric columns in dependency order; append
    divergent cells; return cells compared."""
    cols = sorted(set(ma) | set(mb), key=_phase_rank)
    for col in cols:
        a = ma.get(col)
        b = mb.get(col)
        rel = _rel(a, b) if col in ma and col in mb else math.inf
        if rel > 0.0:
            cells.append(DivergentCell(
                scenario=scenario, stage=-1, column=col, a=a, b=b,
                rel=rel, contract=classify(rel, contracts),
                phase=column_phase(col)))
    return len(cols)


def diff_records(recs_a: Sequence[dict], recs_b: Sequence[dict],
                 label_a: str = "A", label_b: str = "B") -> DiffResult:
    """Compare two sweep result sets, aligned by scenario ``key``
    (mode-independent, so event-loop and device runs of one grid
    align); falls back to positional alignment when the key spaces are
    disjoint (e.g. hand-built fixtures)."""
    contracts = tolerance_contracts()
    by_key_b = {r.get("key"): r for r in recs_b}
    common = [r for r in recs_a if r.get("key") in by_key_b]
    if not common and recs_a and recs_b:
        pairs = list(zip(recs_a, recs_b))
        only_a = [r.get("scenario", "?") for r in recs_a[len(pairs):]]
        only_b = [r.get("scenario", "?") for r in recs_b[len(pairs):]]
    else:
        pairs = [(r, by_key_b[r.get("key")]) for r in common]
        keys_a = {r.get("key") for r in recs_a}
        only_a = [r.get("scenario", "?") for r in recs_a
                  if r.get("key") not in by_key_b]
        only_b = [r.get("scenario", "?") for r in recs_b
                  if r.get("key") not in keys_a]
    cells: List[DivergentCell] = []
    n = 0
    for ra, rb in pairs:
        n += _diff_metrics(ra.get("scenario", "?"),
                           ra.get("metrics", {}), rb.get("metrics", {}),
                           cells, contracts)
    return DiffResult(kind="records", label_a=label_a, label_b=label_b,
                      n_compared=n, n_scenarios=len(pairs), cells=cells,
                      only_a=only_a, only_b=only_b)


def diff_golden(metrics: dict, golden: dict, scenario: str = "golden",
                label_a: str = "run", label_b: str = "golden"
                ) -> DiffResult:
    """Compare one metrics dict against a golden record. Golden pins
    are bit-exact (``host-bitwise``), so *any* divergent cell fails the
    guard — the classification then says which execution-path contract
    would have absorbed the drift (a ``DEVICE_MODE_RTOL`` cell points
    at numerics, a ``regression`` cell at semantics)."""
    contracts = tolerance_contracts()
    cells: List[DivergentCell] = []
    # goldens pin a deliberate subset of the metric columns — walk the
    # golden's keys only; a pinned key missing from the run is an
    # incomparable (inf) divergence, extra run columns are not drift
    pinned = {k: metrics[k] for k in golden if k in metrics}
    n = _diff_metrics(scenario, pinned, dict(golden), cells, contracts)
    return DiffResult(kind="golden", label_a=label_a, label_b=label_b,
                      n_compared=n, n_scenarios=1, cells=cells)


def diff_stage_tables(ta: Dict[str, np.ndarray],
                      tb: Dict[str, np.ndarray],
                      scenario: str = "trace",
                      label_a: str = "A", label_b: str = "B"
                      ) -> DiffResult:
    """Compare two flight-recorder stage tables (or any dict of
    equal-length columns). Rows align positionally; for each column —
    dependency order again — the *first* divergent row is reported, so
    the earliest (stage, column) breakage surfaces once instead of
    cascading down the trace."""
    contracts = tolerance_contracts()
    cells: List[DivergentCell] = []
    only_a = sorted(set(ta) - set(tb))
    only_b = sorted(set(tb) - set(ta))
    shared = sorted(set(ta) & set(tb), key=_phase_rank)
    n = 0
    rows_a = rows_b = 0
    for col in shared:
        ca = np.asarray(ta[col], np.float64)
        cb = np.asarray(tb[col], np.float64)
        rows_a, rows_b = len(ca), len(cb)
        m = min(rows_a, rows_b)
        n += m
        if m == 0:
            continue
        a, b = ca[:m], cb[:m]
        with np.errstate(invalid="ignore"):
            neq = ~((a == b) | (np.isnan(a) & np.isnan(b)))
        if not neq.any():
            continue
        i = int(np.argmax(neq))
        rel = _rel(float(a[i]), float(b[i]))
        cells.append(DivergentCell(
            scenario=scenario, stage=i, column=col,
            a=float(a[i]), b=float(b[i]), rel=rel,
            contract=classify(rel, contracts),
            phase=column_phase(col)))
    if rows_a != rows_b:
        only = only_a if rows_a > rows_b else only_b
        only.append(f"rows[{min(rows_a, rows_b)}:"
                    f"{max(rows_a, rows_b)}]")
    # dependency order *within* the run: earliest phase wins, ties
    # broken by the earlier stage row
    cells.sort(key=lambda c: (PHASES.index(c.phase), c.stage, c.column))
    return DiffResult(kind="stage-table", label_a=label_a,
                      label_b=label_b, n_compared=n, n_scenarios=1,
                      cells=cells, only_a=only_a, only_b=only_b)


# ----------------------------------------------------------- reports --


def write_report(result: DiffResult, name: str,
                 outdir: Optional[Path] = None) -> Dict[str, Path]:
    """Write ``<outdir>/<name>.md`` + ``.json`` (default
    ``results/obs/divergence/``) — the CI artifact pair."""
    outdir = Path(outdir) if outdir is not None else DIVERGENCE_DIR
    outdir.mkdir(parents=True, exist_ok=True)
    md = outdir / f"{name}.md"
    js = outdir / f"{name}.json"
    md.write_text(result.to_markdown())
    js.write_text(json.dumps(result.to_dict(), indent=1, default=str))
    return {"md": md, "json": js}


def assert_golden(metrics: dict, golden: dict, name: str,
                  outdir: Optional[Path] = None) -> DiffResult:
    """Golden-drift guard: bit-exact comparison that fails *through*
    the explainer. On any divergence it writes the markdown/JSON
    report (CI uploads it as an artifact) and raises an
    ``AssertionError`` naming the first divergent cell and the report
    path — instead of a bare numpy mismatch."""
    result = diff_golden(metrics, golden, scenario=name)
    if result.identical:
        return result
    paths = write_report(result, name, outdir=outdir)
    raise AssertionError(
        f"golden drift in {name}: {result.summary()}\n"
        f"divergence report: {paths['md']}")
