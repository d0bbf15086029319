"""Declarative scenario grids over ``SimConfig``.

A sweep is a base config plus named axes of dotted-path overrides
("workload.qps", "scheduler.batch_cap", "tp", "model", ...). Expanding
the grid yields ``Scenario`` objects: a fully-resolved ``SimConfig``,
the flat axis parameters for reporting, and a stable content hash that
keys the on-disk result cache (``repro_torch.sweep.cache``).

Joint axes sweep several fields in lockstep with a ``+``-joined key:

    GridSpec(base=PAPER_DEFAULT,
             axes={"workload.qps": [1.0, 5.0, 10.0],
                   "tp+pp": [(1, 1), (2, 2)]})

expands to 6 scenarios (cardinality = product of axis lengths).

Axes (or ``fixed`` entries) whose path starts with ``post.`` override
the scenario's post-processor parameters instead of the config — e.g.
``"post.solar_capacity_w": [0.0, 600.0]`` sweeps the microgrid co-sim's
solar actor without touching ``SimConfig`` (the carbon-aware axes).

The paths ``pue`` and ``grid_ci`` address the *scenario-level* report
knobs (datacenter PUE, static grid carbon intensity) rather than the
config tree. Scenarios differing only in these axes (or in ``post.*``
parameters) share one simulation trace — the vectorized runner mode
(``repro_torch.sweep.vectorized``) runs the event loop once per unique
config and evaluates such axes as stacked array passes.

Counterpart of ``repro.sweep.grid``. Keys are the reference's: the
config dataclasses keep the reference's fields, defaults and ``str``
forms, and ``SCHEMA_VERSION`` is the reference's, so one scenario has
one key in both packages and their records align under
``repro.obs.diff`` / ``repro_torch.obs.diff``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
from typing import Dict, List, Mapping, Optional, Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.sim.simulator import SimConfig

# Bump when simulator/runner semantics change in a way that invalidates
# previously cached scenario results.
# v2: shared fleet/single-site event loop — admission is gated on the
# next processing event instead of the min clock across all replicas
# (single-replica results are unchanged; multi-replica skew differs).
# v3: config schema extension for repro_torch.schedule (workload classes on
# WorkloadConfig, ScheduleConfig + horizon_s on FleetConfig) changes
# every config's digest even though metrics under the defaults
# (immediate admission, no deferrable class) are numerically identical
# to v2 — pinned by tests/test_schedule.py.
# v4: array-native execution model — the roofline is evaluated by the
# batched kernel (repro_torch.sim.execmodel.stage_cost_batch) whose folded
# constants reassociate a few float products (ulp-level timing shifts
# everywhere), and Sarathi chunked prefill now charges cross-chunk KV
# reads + context-offset score FLOPs (chunked scenarios change
# materially). Vectorized vs event-loop runner modes are bit-identical
# under v4 (tests/test_vectorized.py), so mode is NOT part of the key.
# v5: config schema extension for day-scale workloads (envelope/burst
# fields on WorkloadConfig, AutoscalerConfig on SiteConfig, DayConfig
# on FleetConfig) changes every digest; metrics under the defaults
# (no envelope, autoscaler disabled, day=None) are bit-identical to
# v4 — pinned by tests/test_day.py golden records.
# v6: the day planner's saturation guard gained a model-derived
# capacity floor (min of the autoscaler's tokens_per_s estimate and
# the roofline's replica_tokens_per_s), which can reclassify
# queue-saturated epochs from fluid to exact — day-grid records
# change; everything else is bit-identical to v5, pinned by the
# fig1/fleet/shift golden records in tests/test_day.py.
SCHEMA_VERSION = 6

# Default static grid carbon intensity for the report's carbon columns
# (gCO2eq/kWh; CAISO-ish annual average — the paper's co-sim case study
# uses a time-varying CAISO-North signal instead, via the cosim post).
DEFAULT_GRID_CI = 250.0

# axis paths addressing Scenario-level report knobs rather than the
# config tree (see GridSpec docstring)
_SCENARIO_KNOBS = ("pue", "grid_ci")


def _is_fleet(cfg) -> bool:
    from repro_torch.fleet.config import FleetConfig
    return isinstance(cfg, FleetConfig)


def model_registry() -> Dict[str, ModelConfig]:
    """All paper models, addressable by name in grid axes."""
    from repro_torch.configs import paper_models
    return {m.name: m for m in vars(paper_models).values()
            if isinstance(m, ModelConfig)}


def resolve_model(value) -> ModelConfig:
    if isinstance(value, ModelConfig):
        return value
    models = model_registry()
    if value not in models:
        raise KeyError(f"unknown model {value!r}; have {sorted(models)}")
    return models[value]


def with_overrides(cfg, overrides: Mapping[str, object]):
    """dataclasses.replace along dotted paths ("workload.qps" -> 6.45)."""
    by_head: Dict[str, Dict[str, object]] = {}
    flat: Dict[str, object] = {}
    for path, value in overrides.items():
        head, _, rest = path.partition(".")
        if rest:
            by_head.setdefault(head, {})[rest] = value
        else:
            if head == "model":
                value = resolve_model(value)
            flat[head] = value
    for head, sub in by_head.items():
        flat[head] = with_overrides(getattr(cfg, head), sub)
    return dataclasses.replace(cfg, **flat)


def _jsonable(value):
    if isinstance(value, ModelConfig):
        return value.name
    if isinstance(value, (tuple, list)):
        return [_jsonable(v) for v in value]
    return value


def _canonical_json(obj) -> str:
    return json.dumps(obj, sort_keys=True, default=str,
                      separators=(",", ":"))


def config_blob(cfg) -> str:
    """Canonical JSON of the config tree alone — the expensive part of
    a digest (``dataclasses.asdict`` over the full tree plus the JSON
    encode), shared between a scenario's ``key`` and ``trace_key``."""
    return _canonical_json(dataclasses.asdict(cfg))


def _digest_from_blobs(cfg_json: str, extra_json: str) -> str:
    # assembles the exact bytes json.dumps(payload, sort_keys=True)
    # would produce: the payload keys already sort cfg < extra < schema
    blob = (f'{{"cfg":{cfg_json},"extra":{extra_json},'
            f'"schema":{SCHEMA_VERSION}}}')
    return hashlib.sha256(blob.encode()).hexdigest()


def config_digest(cfg: SimConfig, extra: Optional[Mapping] = None) -> str:
    """Stable content hash of a scenario: canonical JSON of the full
    config tree (+ runner knobs) under the current schema version."""
    return _digest_from_blobs(config_blob(cfg),
                              _canonical_json(dict(extra or {})))


def derive_seed(params: Mapping[str, object]) -> int:
    """Deterministic per-scenario workload seed from the axis values —
    independent of execution order or process, so parallel and serial
    sweeps sample identical workloads."""
    blob = json.dumps({k: _jsonable(v) for k, v in params.items()},
                      sort_keys=True, default=str)
    return int.from_bytes(hashlib.sha256(blob.encode()).digest()[:4],
                          "big") % (2 ** 31)


@dataclasses.dataclass
class Scenario:
    """One fully-resolved point of a sweep.

    ``cfg`` is a ``SimConfig`` or a ``repro_torch.fleet.FleetConfig`` — the
    runner dispatches on the type; both digest identically through
    ``config_digest``.
    """
    cfg: object
    params: Dict[str, object]
    tag: str = "scenario"
    pue: float = 1.2
    grid_ci: float = DEFAULT_GRID_CI
    post: Optional[str] = None            # runner post-processor name
    post_params: Dict[str, object] = dataclasses.field(default_factory=dict)
    # digests are lazily cached: the runner's dedup loop, the trace
    # grouping and record assembly all consult them, and one sha256
    # over the full config tree per consult would dominate the
    # per-scenario cost on large vectorized grids (scenarios are
    # treated as immutable once expanded)
    _key: Optional[str] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    _trace_key: Optional[str] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    _cfg_blob: Optional[str] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def cfg_blob(self) -> str:
        """Canonical config JSON, serialized once per scenario — both
        digests below reuse it (the asdict+encode pass dominates
        per-scenario runner overhead on large stacked grids)."""
        if self._cfg_blob is None:
            self._cfg_blob = config_blob(self.cfg)
        return self._cfg_blob

    @property
    def key(self) -> str:
        if self._key is None:
            self._key = _digest_from_blobs(self.cfg_blob, _canonical_json({
                "pue": self.pue, "grid_ci": self.grid_ci,
                "post": self.post, "post_params": self.post_params,
            }))
        return self._key

    @property
    def trace_key(self) -> str:
        """Digest of the config alone — everything the simulation
        trace depends on, nothing the report knobs touch (the
        vectorized runner's grouping key)."""
        if self._trace_key is None:
            self._trace_key = _digest_from_blobs(self.cfg_blob, "{}")
        return self._trace_key


@dataclasses.dataclass
class GridSpec:
    """Declarative parameter grid over a base SimConfig."""
    base: SimConfig
    axes: Mapping[str, Sequence] = dataclasses.field(default_factory=dict)
    fixed: Mapping[str, object] = dataclasses.field(default_factory=dict)
    tag: str = "sweep"
    pue: float = 1.2
    grid_ci: float = DEFAULT_GRID_CI
    post: Optional[str] = None
    post_params: Mapping[str, object] = dataclasses.field(default_factory=dict)
    seed_per_scenario: bool = False   # derive workload.seed from params

    @property
    def cardinality(self) -> int:
        n = 1
        for values in self.axes.values():
            n *= len(values)
        return n

    def expand(self) -> List[Scenario]:
        keys = list(self.axes.keys())
        value_lists = [self.axes[k] for k in keys]
        scenarios: List[Scenario] = []
        for combo in itertools.product(*value_lists):
            overrides: Dict[str, object] = dict(self.fixed)
            params: Dict[str, object] = {}
            report_only = set()    # param leaves that never touch cfg
            for key, value in zip(keys, combo):
                parts = key.split("+")
                values = value if len(parts) > 1 else (value,)
                if len(parts) != len(values):
                    raise ValueError(
                        f"joint axis {key!r} expects {len(parts)}-tuples, "
                        f"got {value!r}")
                for part, v in zip(parts, values):
                    overrides[part] = v
                    # report under the leaf name ("workload.qps" -> "qps")
                    leaf = part.split(".")[-1]
                    params[leaf] = _jsonable(v)
                    if part.startswith("post.") or part in _SCENARIO_KNOBS:
                        report_only.add(leaf)
            if self.seed_per_scenario and "workload.seed" not in overrides:
                # report-only axes (pue/grid_ci/post.*) never influence
                # the workload draw: scenarios differing only in them
                # must sample identical requests (trace sharing + an
                # unconfounded report axis)
                seed_params = {k: v for k, v in params.items()
                               if k not in report_only}
                overrides["workload.seed"] = derive_seed(seed_params)
            # "post.<key>" paths parameterize the post-processor,
            # "pue"/"grid_ci" the scenario-level report knobs, the
            # rest resolve into the config tree
            post_params = dict(self.post_params)
            scen_knobs = {"pue": self.pue, "grid_ci": self.grid_ci}
            cfg_overrides = {}
            for path, value in overrides.items():
                if path.startswith("post."):
                    post_params[path[len("post."):]] = value
                elif path in scen_knobs:
                    scen_knobs[path] = value
                    if hasattr(self.base, path):
                        # FleetConfig carries its own pue field, read
                        # by the fleet rollup — route the value there
                        # too so a fleet pue axis keeps sweeping it
                        cfg_overrides[path] = value
                    elif _is_fleet(self.base):
                        raise ValueError(
                            f"a {path!r} axis has no effect on fleet "
                            "scenarios (sites carry CI traces); sweep "
                            "site ci_trace instead")
                else:
                    cfg_overrides[path] = value
            cfg = with_overrides(self.base, cfg_overrides)
            label = ",".join(f"{k}={params[k]}" for k in params) or "base"
            scenarios.append(Scenario(
                cfg=cfg, params=params, tag=f"{self.tag}/{label}",
                pue=scen_knobs["pue"], grid_ci=scen_knobs["grid_ci"],
                post=self.post, post_params=post_params))
        return scenarios
