"""Tidy result tables from sweep records.

A record (see ``runner.execute_scenario``) carries ``params`` (axis
values) and ``metrics`` (energy/carbon/latency columns). Flattening
merges both into one row per scenario — the tidy-data shape the
paper's figures and any downstream pandas/plotting code expect.
"""
from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence


def flatten(records: Sequence[dict]) -> List[Dict[str, object]]:
    """One flat row per scenario: params first, then metrics."""
    rows = []
    for record in records:
        row: Dict[str, object] = {"scenario": record.get("scenario", "")}
        row.update(record.get("params", {}))
        row.update(record.get("metrics", {}))
        meta = record.get("meta", {})
        row["cache_hit"] = bool(meta.get("cache_hit", False))
        rows.append(row)
    return rows


# Per-workload-class scheduling columns (repro_torch.schedule.metrics +
# admission stats): pinned into one contiguous, stably-ordered group in
# CSV/table output so shifting experiments read as tidy data even when
# mixed with non-fleet rows (absent values render empty via restval).
SCHEDULE_COLUMNS = [
    "n_interactive", "n_deferrable", "deferred_fraction", "n_deferred",
    "mean_deferral_delay_s", "max_deferral_delay_s", "backlog_peak",
    "interactive_ttft_p50_s", "interactive_ttft_p99_s",
    "interactive_e2e_p50_s", "interactive_e2e_p99_s",
    "deferrable_e2e_p50_s", "deferrable_e2e_p99_s",
    "interactive_slo_violations", "deadline_violations",
]


def _columns(rows: Sequence[Dict[str, object]]) -> List[str]:
    cols: List[str] = []
    for row in rows:
        for key in row:
            if key not in cols:
                cols.append(key)
    # group the per-class scheduling columns contiguously (in their
    # canonical order) at the position of the first one encountered;
    # cache_hit stays last
    sched = [c for c in SCHEDULE_COLUMNS if c in cols]
    if sched:
        first = min(cols.index(c) for c in sched)
        rest = [c for c in cols if c not in sched]
        cols = rest[:first] + sched + rest[first:]
    if "cache_hit" in cols:
        cols.remove("cache_hit")
        cols.append("cache_hit")
    return cols


def to_csv(records: Sequence[dict], path: Path) -> Path:
    rows = flatten(records)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=_columns(rows),
                                restval="")
        writer.writeheader()
        writer.writerows(rows)
    return path


def to_json(records: Sequence[dict], path: Path,
            derived: Optional[str] = None) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"records": list(records)}
    if derived is not None:
        payload["derived"] = derived
    path.write_text(json.dumps(payload, indent=1, default=str))
    return path


def format_table(records: Sequence[dict],
                 columns: Optional[Sequence[str]] = None,
                 max_width: int = 14) -> str:
    """Plain-text table for CLI output (one row per scenario record)."""
    return format_rows(flatten(records), columns=columns,
                       max_width=max_width)


def format_rows(rows: Sequence[Dict[str, object]],
                columns: Optional[Sequence[str]] = None,
                max_width: int = 14) -> str:
    """Plain-text table over already-flat rows."""
    if not rows:
        return "(no scenarios)"
    cols = list(columns) if columns else _columns(rows)

    def fmt(v) -> str:
        if isinstance(v, float):
            s = f"{v:.4g}"
        else:
            s = str(v)
        return s[:max_width]

    table = [[fmt(row.get(c, "")) for c in cols] for row in rows]
    widths = [max(len(c), *(len(t[i]) for t in table))
              for i, c in enumerate(cols)]
    lines = ["  ".join(c.ljust(w) for c, w in zip(cols, widths))]
    lines.append("  ".join("-" * w for w in widths))
    for t in table:
        lines.append("  ".join(v.ljust(w) for v, w in zip(t, widths)))
    return "\n".join(lines)


def write_outputs(name: str, records: Sequence[dict], outdir: Path,
                  derived: Optional[str] = None) -> Dict[str, Path]:
    """Write ``<outdir>/<name>.csv`` and ``.json``; returns the paths."""
    outdir = Path(outdir)
    return {
        "csv": to_csv(records, outdir / f"{name}.csv"),
        "json": to_json(records, outdir / f"{name}.json", derived=derived),
    }
