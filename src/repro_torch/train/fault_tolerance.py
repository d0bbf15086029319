"""Fault-tolerant training runner: checkpoint/restart, failure detection,
straggler mitigation hooks, elastic re-meshing.

Counterpart of ``repro.train.fault_tolerance``, with its semantics: a step's
``dt`` runs from the call to the step function until ``float(loss)`` has
read the loss back, which waits for the card.

On a real multi-pod deployment, failures surface as (a) process exits
(handled by restart-from-latest-commit), (b) NaN/Inf loss spikes (handled
by step rejection + LR cooldown), and (c) stragglers (handled by step-time
watchdog -> reshard decision). All three paths are testable on CPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from repro_torch.train.checkpoint import (CheckpointManager, latest_step,
                                          restore_checkpoint)


@dataclasses.dataclass
class FaultToleranceConfig:
    ckpt_dir: str = "ckpts"
    ckpt_every: int = 50
    keep: int = 3
    max_nan_retries: int = 3
    straggler_factor: float = 2.5    # step slower than median x factor
    straggler_window: int = 20


class StepWatchdog:
    """Detects straggling steps against a rolling median."""

    def __init__(self, factor: float, window: int):
        self.factor = factor
        self.window = window
        self.times = []
        self.straggler_events = 0

    def observe(self, dt: float) -> bool:
        self.times.append(dt)
        hist = self.times[-self.window:]
        if len(hist) >= 5 and dt > self.factor * float(np.median(hist)):
            self.straggler_events += 1
            return True
        return False


class FaultTolerantRunner:
    """Wraps a train_step with checkpoint/restart + NaN rejection.

    The step function must be (params, opt_state, batch) ->
    (params, opt_state, metrics)."""

    def __init__(self, step_fn: Callable, cfg: FaultToleranceConfig):
        self.step_fn = step_fn
        self.cfg = cfg
        self.manager = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep)
        self.watchdog = StepWatchdog(cfg.straggler_factor,
                                     cfg.straggler_window)
        self.nan_rejections = 0

    def try_restore(self, params, opt_state):
        step = latest_step(self.cfg.ckpt_dir)
        if step is None:
            return params, opt_state, 0
        (params, opt_state), manifest = restore_checkpoint(
            self.cfg.ckpt_dir, (params, opt_state))
        return params, opt_state, int(manifest["step"])

    def run(self, params, opt_state, batches, n_steps: int,
            start_step: int = 0, log_every: int = 10,
            log_fn: Callable[[str], None] = print) -> Dict[str, Any]:
        losses = []
        step_times = []
        step = start_step
        while step < n_steps:
            batch = batches(step)
            t0 = time.time()
            new_params, new_opt, metrics = self.step_fn(params, opt_state,
                                                        batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            if not np.isfinite(loss):
                self.nan_rejections += 1
                log_fn(f"[ft] step {step}: non-finite loss, rejecting update "
                       f"({self.nan_rejections}/{self.cfg.max_nan_retries})")
                if self.nan_rejections > self.cfg.max_nan_retries:
                    raise FloatingPointError(
                        f"loss diverged at step {step}")
                step += 1
                continue
            params, opt_state = new_params, new_opt
            if self.watchdog.observe(dt):
                log_fn(f"[ft] step {step}: straggler ({dt:.2f}s vs median "
                       f"{np.median(self.watchdog.times[-20:]):.2f}s)")
            losses.append(loss)
            step_times.append(dt)
            if step % self.cfg.ckpt_every == 0 and step > start_step:
                self.manager.save_async((params, opt_state), step,
                                        extra={"loss": loss})
            if step % log_every == 0:
                log_fn(f"step {step:5d} loss {loss:.4f} "
                       f"({dt*1e3:.0f} ms/step)")
            step += 1
        self.manager.save_async((params, opt_state), step)
        self.manager.wait()
        return {"params": params, "opt_state": opt_state,
                "losses": losses, "step_times": step_times,
                "straggler_events": self.watchdog.straggler_events,
                "final_step": step}
