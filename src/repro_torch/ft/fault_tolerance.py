"""Fault-tolerance runtime: checkpoint/restart, straggler detection and
failure injection (port of ``repro/ft/fault_tolerance.py``).

The mechanisms are the reference's: a deterministic data stream, atomic
checkpoints, a restart from the latest one.  ``TrainRunner`` waits for
each step by reading its loss (the reference calls
``block_until_ready``), so a step's wall time includes the device's work.
``reshard`` (a tree laid out on another mesh) comes with the logical-axis
sharding (ROADMAP.md queue item 9.8).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable

import numpy as np

from repro_torch.checkpoint.ckpt import AsyncCheckpointer, latest_step, restore

log = logging.getLogger("repro_torch.ft")


class FailureInjector:
    """Deterministic failure injection for tests: raises once at step N."""

    def __init__(self, fail_at_steps: tuple[int, ...] = ()):
        self.fail_at = set(fail_at_steps)
        self.fired: set[int] = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected node failure at step {step}")


class StragglerDetector:
    """EMA + z-score over per-step wall times: a step more than ``z``
    standard deviations above the mean of the last ``window`` is a strike,
    and ``patience`` strikes in a row flag it."""

    def __init__(self, window: int = 50, z_threshold: float = 3.0,
                 patience: int = 3):
        self.times: list[float] = []
        self.window = window
        self.z = z_threshold
        self.patience = patience
        self._strikes = 0
        self.flagged: list[int] = []

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step is flagged as a straggler event."""
        hist = self.times[-self.window:]
        self.times.append(dt)
        if len(hist) < 8:
            return False
        mu = float(np.mean(hist))
        sd = float(np.std(hist)) + 1e-9
        if (dt - mu) / sd > self.z:
            self._strikes += 1
            if self._strikes >= self.patience:
                self.flagged.append(step)
                self._strikes = 0
                log.warning("straggler flagged at step %d (%.3fs vs mu %.3fs)",
                            step, dt, mu)
                return True
        else:
            self._strikes = 0
        return False


@dataclasses.dataclass
class RunnerConfig:
    ckpt_dir: str
    checkpoint_every: int = 50
    keep: int = 3
    max_restarts: int = 3


class TrainRunner:
    """Crash-safe training loop.

    ``train_step_fn(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``make_batch(step)``: the step's batch (deterministic in
    step)."""

    def __init__(self, cfg: RunnerConfig, train_step_fn: Callable,
                 make_batch: Callable[[int], Any],
                 injector: FailureInjector | None = None,
                 straggler: StragglerDetector | None = None):
        self.cfg = cfg
        self.train_step = train_step_fn
        self.make_batch = make_batch
        self.injector = injector or FailureInjector()
        self.straggler = straggler or StragglerDetector()
        self.ckpt = AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep)
        self.restarts = 0
        self.metrics_log: list[dict] = []

    def _restore_or(self, params, opt_state):
        step = latest_step(self.cfg.ckpt_dir)
        if step is None:
            return params, opt_state, 0
        (params, opt_state), meta = restore(self.cfg.ckpt_dir, step,
                                            (params, opt_state))
        log.info("restored checkpoint at step %d", step)
        return params, opt_state, int(meta.get("next_step", step))

    def run(self, params, opt_state, n_steps: int):
        params, opt_state, start = self._restore_or(params, opt_state)
        step = start
        while step < n_steps:
            try:
                t0 = time.monotonic()
                self.injector.maybe_fail(step)
                batch = self.make_batch(step)
                params, opt_state, metrics = self.train_step(params, opt_state,
                                                             batch)
                values = {k: float(v) for k, v in metrics.items()}
                dt = time.monotonic() - t0
                self.straggler.observe(step, dt)
                self.metrics_log.append({"step": step, "dt": dt, **values})
                step += 1
                if step % self.cfg.checkpoint_every == 0 or step == n_steps:
                    self.ckpt.save(step, (params, opt_state),
                                   extra_meta={"next_step": step})
            except RuntimeError as e:
                self.restarts += 1
                log.warning("step %d failed (%s); restart %d", step, e,
                            self.restarts)
                if self.restarts > self.cfg.max_restarts:
                    raise
                self.ckpt.wait()
                params, opt_state, step = self._restore_or(params, opt_state)
        self.ckpt.wait()
        return params, opt_state
