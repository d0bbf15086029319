"""Replica autoscaling: an in-loop controller plus an epoch planner.

Two operating points share one ``AutoscalerConfig``:

* **In-drive controller** (``ReplicaController``) — attached to a
  fleet site, polled by the event loop (``LoopSite.maybe_control``)
  every ``control_interval_s`` of sim time. It estimates queue delay
  from the site's O(1) outstanding-token counter and scales the
  *active set* of replicas up/down between ``min_replicas`` and
  ``max_replicas``. Replicas are never removed from the site's lists
  (index stability for the loop's stuck-set and trace replica ids);
  deactivated replicas drain their queue, then either stay **warm**
  (idle power, instant reactivation) up to ``warm_spares`` or go cold
  (no power, reactivation pays ``scale_up_latency_s``). Scale-down is
  carbon-aware: shedding a warm spare is only worth its restart risk
  when grid CI is at/above ``ci_scale_down_g`` — at clean-grid hours
  idle power is cheap carbon, so spares stay warm.

* **Epoch planner** (``plan_replicas``) — the day-scale hybrid
  simulation decides replica counts per epoch *from predicted demand*
  (arrival-rate x mean tokens vs per-replica capacity), determinis-
  tically and before any simulation runs, so the hybrid and exact day
  modes see the identical plan and autoscale epochs stay bit-for-bit
  comparable.

Warm-spare idle power and scale-up latency are charged through the
established Eq. 2-5 accounting: spares contribute device-seconds at
``p_idle`` to the load profile, and cold replicas' clocks start
``scale_up_latency_s`` after the decision.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.fleet.routing import RoundRobinRouter


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    enabled: bool = False
    min_replicas: int = 1
    max_replicas: int = 8
    target_util: float = 0.6          # epoch planner's sizing target
    control_interval_s: float = 300.0
    scale_up_latency_s: float = 60.0  # cold-start delay
    delay_hi_s: float = 10.0          # est. queue delay to scale up
    delay_lo_s: float = 1.0           # est. queue delay to scale down
    tokens_per_s: float = 4000.0      # per-replica service estimate
    warm_spares: int = 1              # replicas kept warm when shed
    ci_scale_down_g: float = 0.0      # shed spares only at CI >= this


class ActiveSetRouter(RoundRobinRouter):
    """Round-robin over the first ``n_active`` of a fixed replica
    list — the controller moves the boundary, the loop keeps stable
    replica indices."""

    def __init__(self, n_replicas: int, cfg, n_active: int = None):
        super().__init__(n_replicas, cfg)
        self.n_active = len(self.replicas) if n_active is None \
            else n_active

    def route(self, req) -> int:
        target = self._next % max(self.n_active, 1)
        self.replicas[target].add(req)
        self._next = (target + 1) % max(self.n_active, 1)
        return target


@dataclasses.dataclass
class ScaleEvent:
    t_s: float
    n_active: int
    n_warm: int
    kind: str                         # up_warm | up_cold | down


class ReplicaController:
    """Delay-threshold autoscaler over a site's active replica set."""

    def __init__(self, cfg: AutoscalerConfig, n_initial: int):
        self.cfg = cfg
        self.n_active = max(cfg.min_replicas,
                            min(n_initial, cfg.max_replicas))
        self.n_warm = 0
        self._next_control = 0.0
        self.events: List[ScaleEvent] = [
            ScaleEvent(0.0, self.n_active, 0, "init")]

    def maybe_control(self, site, t_s: float) -> bool:
        """One control step if the interval elapsed; returns whether
        the active set changed (the loop then refreshes its replica
        pairing)."""
        if t_s < self._next_control:
            return False
        self._next_control = t_s + self.cfg.control_interval_s
        cfg = self.cfg
        delay = (site.outstanding_tokens()
                 / (cfg.tokens_per_s * max(self.n_active, 1)))
        if delay > cfg.delay_hi_s and self.n_active < cfg.max_replicas:
            warm = self.n_warm > 0
            if warm:
                self.n_warm -= 1
            else:
                # cold start: the new replica is usable only after the
                # scale-up latency — preset its clock
                site.clocks[self.n_active] = max(
                    site.clocks[self.n_active],
                    t_s + cfg.scale_up_latency_s)
            self.n_active += 1
            site.replicas.n_active = self.n_active
            self.events.append(ScaleEvent(
                t_s, self.n_active, self.n_warm,
                "up_warm" if warm else "up_cold"))
            if site.probe is not None:
                site.probe.on_scale(t_s, site.site_index, self.n_active,
                                    self.n_warm,
                                    "up_warm" if warm else "up_cold")
            return True
        if delay < cfg.delay_lo_s and self.n_active > cfg.min_replicas \
                and site.ci_at(t_s) >= cfg.ci_scale_down_g:
            self.n_active -= 1
            self.n_warm = min(self.n_warm + 1, cfg.warm_spares)
            site.replicas.n_active = self.n_active
            self.events.append(ScaleEvent(
                t_s, self.n_active, self.n_warm, "down"))
            if site.probe is not None:
                site.probe.on_scale(t_s, site.site_index, self.n_active,
                                    self.n_warm, "down")
            return True
        return False

    def stats(self) -> dict:
        ups = sum(1 for e in self.events if e.kind.startswith("up"))
        downs = sum(1 for e in self.events if e.kind == "down")
        return {"scale_ups": float(ups), "scale_downs": float(downs)}

    def device_signal(self, t_end: float, devices_per_replica: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """(times, powered device count) step signal — active + warm
        replicas draw power; cold ones don't."""
        ts = np.asarray([e.t_s for e in self.events] + [t_end])
        vals = np.asarray([(e.n_active + e.n_warm) * devices_per_replica
                           for e in self.events] + [0])
        return ts, vals


def plan_replicas(cfg: AutoscalerConfig, util1: np.ndarray,
                  ci_mean: np.ndarray, n_initial: int
                  ) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Per-epoch (active, warm) replica plan from predicted demand.

    ``util1[e]`` is epoch e's utilization if served by ONE replica
    (rate x mean tokens / capacity); the plan sizes the active set to
    hold utilization near ``target_util``, scaling up eagerly and
    down one replica per epoch — and only when the epoch's mean grid
    CI is at/above ``ci_scale_down_g`` (carbon-aware scale-down:
    at clean hours a spare's idle energy is cheap carbon, so it stays
    warm instead).
    """
    n_ep = len(util1)
    active = np.empty(n_ep, int)
    warm = np.zeros(n_ep, int)
    cur = max(cfg.min_replicas, min(n_initial, cfg.max_replicas))
    cur_warm, ups, downs = 0, 0, 0
    for e in range(n_ep):
        need = int(np.ceil(util1[e] / max(cfg.target_util, 1e-9)))
        need = max(cfg.min_replicas, min(need, cfg.max_replicas))
        if need > cur:
            take_warm = min(cur_warm, need - cur)
            cur_warm -= take_warm
            ups += need - cur
            cur = need
        elif need < cur and ci_mean[e] >= cfg.ci_scale_down_g:
            cur -= 1                  # hysteresis: one step per epoch
            cur_warm = min(cur_warm + 1, cfg.warm_spares)
            downs += 1
        active[e] = cur
        warm[e] = cur_warm
    return active, warm, {"scale_ups": float(ups),
                          "scale_downs": float(downs)}
