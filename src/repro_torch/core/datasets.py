"""Environmental datasets: synthetic generators (offline stand-ins for
Solcast irradiance and WattTime CAISO-North carbon intensity) plus a
loader for real ElectricityMaps/WattTime-style CSV carbon-intensity
exports.

Synthetic traces are generated with documented diurnal structure +
seeded noise so benchmark results are reproducible. Interfaces mirror
the real data: 1-minute resolution W/m^2-scaled solar output and
gCO2/kWh marginal intensity. File-backed traces register alongside the
synthetic ones in ``ci_trace_signal`` and tile periodically to any
requested horizon (prefix-stable, like the generators).
"""
from __future__ import annotations

import csv
from datetime import datetime, timezone
from pathlib import Path
from typing import Dict

import numpy as np

from repro_torch.core.signals import Signal

#: bundled sample traces (``src/repro/core/data``)
DATA_DIR = Path(__file__).resolve().parent / "data"


def solar_signal(hours: float, capacity_w: float = 600.0, seed: int = 0,
                 step_s: float = 60.0, day_offset_h: float = 0.0,
                 cloudiness: float = 0.25) -> Signal:
    """Diurnal solar generation: clear-sky half-sine (6am-6pm) with
    cloud-driven multiplicative noise (Ornstein-Uhlenbeck-ish)."""
    rng = np.random.default_rng(seed)
    t = np.arange(0.0, hours * 3600.0, step_s)
    hod = ((t / 3600.0 + day_offset_h) % 24.0)
    x = (hod - 6.0) / 12.0
    clear = np.where((x >= 0) & (x <= 1), np.sin(np.pi * np.clip(x, 0, 1)),
                     0.0)
    # correlated cloud factor
    n = len(t)
    cloud = np.empty(n)
    c = 0.0
    alpha = step_s / 1800.0     # ~30 min correlation
    for i in range(n):
        c = (1 - alpha) * c + alpha * rng.normal()
        cloud[i] = c
    cloud_factor = np.clip(1.0 - cloudiness * (1 + np.tanh(cloud)), 0.05, 1.0)
    return Signal(t, capacity_w * clear * cloud_factor, interp="linear")


# Named grid regions for fleet/sweep axes: parameterizations of the
# synthetic duck-curve generator below (gCO2/kWh; seeds fixed so every
# sweep samples identical traces). "caiso-east" is the same grid shape
# three timezones ahead, so its evening ramp lands 3 h earlier in
# absolute sim time — a cheap timezone-diversity stand-in. "-evening"
# variants start the trace at 17:00 local, so sim t=0 sits on the
# evening ramp and the overnight decline is within a few hours — the
# window where temporal deferral (repro_torch.schedule) has something to
# shift into.
CI_TRACES = {
    "caiso": dict(base=380.0, swing=120.0, seed=4),
    "caiso-east": dict(base=380.0, swing=120.0, seed=4, day_offset_h=3.0),
    "caiso-evening": dict(base=380.0, swing=120.0, seed=4,
                          day_offset_h=17.0),
    "coal": dict(base=720.0, swing=60.0, seed=11),
    "coal-evening": dict(base=720.0, swing=60.0, seed=11,
                         day_offset_h=17.0),
    "hydro": dict(base=70.0, swing=20.0, seed=12),
    "hydro-evening": dict(base=70.0, swing=20.0, seed=12,
                          day_offset_h=17.0),
    "wind": dict(base=180.0, swing=90.0, seed=13),
    # "-night" variants start just past the 19.5 h duck-curve peak, so
    # CI declines from sim t=0 — short-horizon deferral windows (the
    # day-scale smoke grids) see an immediate carbon gradient to shift
    # into without needing hours of lead-up
    "caiso-night": dict(base=380.0, swing=120.0, seed=4,
                        day_offset_h=20.0),
    "coal-night": dict(base=720.0, swing=60.0, seed=11,
                       day_offset_h=20.0),
}

# File-backed traces (real-world CI exports), registered next to the
# synthetic ones. The bundled sample is a 48 h hourly ElectricityMaps-
# style CAISO export; drop additional CSVs in and register them here or
# via register_ci_trace_file().
CI_TRACE_FILES: Dict[str, Path] = {
    "caiso-em": DATA_DIR / "electricitymaps_caiso_48h.csv",
}


def register_ci_trace_file(name: str, path) -> None:
    """Register an ElectricityMaps/WattTime-style CSV as a named trace.

    Names are cache-relevant (sweep scenarios digest the trace *name*,
    not the file contents), so silently repointing an existing name
    would make cached and fresh results disagree — rebinding requires
    an explicit ``del CI_TRACE_FILES[name]`` first.
    """
    if name in CI_TRACES:
        raise ValueError(f"{name!r} already names a synthetic trace")
    if name in CI_TRACE_FILES:
        raise ValueError(f"{name!r} already names a registered file trace")
    CI_TRACE_FILES[name] = Path(path)


# Recognized CI value columns, in priority order (ElectricityMaps
# exports, WattTime MOER exports, and our own to_csv round-trip).
_CI_VALUE_COLUMNS = ("carbon_intensity_gco2eq_per_kwh", "carbon_intensity",
                     "moer", "value", "ci")
_CI_TIME_COLUMNS = ("datetime", "point_time", "timestamp", "time_s", "time")


def _parse_time_s(raw: str) -> float:
    """ISO-8601 timestamp -> epoch seconds, or plain numeric seconds.
    Timezone-naive timestamps are taken as UTC — localtime would make
    the same file parse differently per host and inject a phantom hour
    at DST transitions."""
    try:
        return float(raw)
    except ValueError:
        dt = datetime.fromisoformat(raw.replace("Z", "+00:00"))
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=timezone.utc)
        return dt.timestamp()


def load_ci_csv(path) -> Signal:
    """Parse an ElectricityMaps/WattTime-style CSV into a ``Signal``.

    Column detection is by name (case-insensitive): time from
    ``datetime``/``point_time``/``time_s``/..., value from
    ``carbon_intensity*``/``moer``/``value``/... Timestamps may be
    ISO-8601 or numeric seconds; the signal's time axis is rebased so
    the first sample sits at t=0 (sim time).
    """
    path = Path(path)
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        cols = {c.lower().strip(): c for c in reader.fieldnames or []}
        tcol = next((cols[c] for c in _CI_TIME_COLUMNS if c in cols), None)
        vcol = next((cols[c] for c in _CI_VALUE_COLUMNS if c in cols), None)
        if tcol is None or vcol is None:
            raise ValueError(
                f"{path}: need a time column ({'/'.join(_CI_TIME_COLUMNS)}) "
                f"and a CI column ({'/'.join(_CI_VALUE_COLUMNS)}); "
                f"have {reader.fieldnames}")
        times, values = [], []
        for row in reader:
            if not row.get(tcol) or not row.get(vcol):
                continue        # skip blank/malformed rows
            try:
                v = float(row[vcol])
            except ValueError:
                continue        # "null"/placeholder cells
            if not np.isfinite(v):
                continue        # "NaN" missing-reading markers
            times.append(_parse_time_s(row[tcol]))
            values.append(v)
    if len(times) < 2:
        raise ValueError(f"{path}: fewer than 2 usable rows")
    t = np.asarray(times, np.float64)
    order = np.argsort(t, kind="stable")
    t = t[order] - t[order[0]]
    return Signal(t, np.asarray(values, np.float64)[order], interp="linear")


def _tile_signal(sig: Signal, hours: float) -> Signal:
    """Extend a finite trace to ``hours`` by periodic tiling (prefix-
    stable: a longer horizon never changes the values of a shorter
    one, matching the synthetic generators' contract).

    The period must preserve time-of-day phase, and exports come in
    two shapes: *endpoint-inclusive* (last sample sits at a whole-day
    offset from the first, i.e. it already starts the next period —
    period = span, drop the duplicate) and *endpoint-exclusive*
    (period = span + one sample step; tiling by the raw span would
    drift the diurnal phase one step per repeat)."""
    span = float(sig.times[-1])
    need_s = hours * 3600.0
    if span <= 0 or span >= need_s:
        return sig
    day_phase = span % 86400.0
    if min(day_phase, 86400.0 - day_phase) < 1e-6:
        period, skip = span, 1      # t=span of copy k == t=0 of k+1
    else:
        step = float(np.median(np.diff(sig.times)))
        period, skip = span + step, 0
    reps = int(np.ceil(need_s / period))
    times = [sig.times]
    values = [sig.values]
    for k in range(1, reps + 1):
        times.append(sig.times[skip:] + k * period)
        values.append(sig.values[skip:])
    return Signal(np.concatenate(times), np.concatenate(values),
                  interp=sig.interp, fill=sig.fill)


def ci_trace_signal(name: str, hours: float, step_s: float = 60.0) -> Signal:
    """Carbon-intensity trace for a named region: synthetic
    (``CI_TRACES``) or file-backed (``CI_TRACE_FILES``, tiled
    periodically to cover the horizon)."""
    if name in CI_TRACES:
        return carbon_intensity_signal(hours, step_s=step_s,
                                       **CI_TRACES[name])
    if name in CI_TRACE_FILES:
        return _tile_signal(load_ci_csv(CI_TRACE_FILES[name]), hours)
    raise KeyError(f"unknown CI trace {name!r}; have "
                   f"{sorted(CI_TRACES) + sorted(CI_TRACE_FILES)}")


def carbon_intensity_signal(hours: float, seed: int = 1,
                            step_s: float = 60.0,
                            base: float = 380.0, swing: float = 120.0,
                            day_offset_h: float = 0.0) -> Signal:
    """CAISO-North-like marginal CI (gCO2/kWh): low mid-day (solar on the
    grid), high evening ramp (duck curve), noisy around the trend."""
    rng = np.random.default_rng(seed)
    t = np.arange(0.0, hours * 3600.0, step_s)
    hod = ((t / 3600.0 + day_offset_h) % 24.0)
    # duck curve: dip at 12h, peak at 19-21h
    dip = -np.exp(-0.5 * ((hod - 13.0) / 2.5) ** 2)
    peak = 0.9 * np.exp(-0.5 * ((hod - 19.5) / 1.8) ** 2)
    trend = base + swing * (dip + peak)
    noise = np.empty(len(t))
    c = 0.0
    alpha = step_s / 3600.0
    for i in range(len(t)):
        c = (1 - alpha) * c + alpha * rng.normal() * 30.0
        noise[i] = c
    return Signal(t, np.clip(trend + noise, 50.0, 900.0), interp="linear")
