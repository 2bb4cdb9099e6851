"""Fault-tolerance runtime: checkpoint/restart, straggler detection and
failure injection (port of ``repro/ft/fault_tolerance.py``).

The mechanisms are the reference's: a deterministic data stream, atomic
checkpoints, a restart from the latest one.  ``TrainRunner`` waits for
each step by reading its loss (the reference calls
``block_until_ready``), so a step's wall time includes the device's work.

On a live mesh (``TrainRunner(..., mesh=, specs=)``) every rank runs the
loop; the checkpoints are the mesh's (``checkpoint.save(mesh=)``: rank 0
writes the manifest, each block its writer), written synchronously, and
a restart restores each rank's blocks.  ``reshard`` lays a tree out on
another mesh (the elastic re-shard).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable

import numpy as np

from repro_torch.checkpoint.ckpt import (AsyncCheckpointer, gc_old,
                                         latest_step, restore, save)
from repro_torch.common import comm
from repro_torch.common.pytree import flatten_with_paths, unflatten_like
from repro_torch.common.sharding import flatten_specs, gather_full, local_shard

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


def reshard(tree, new_mesh, specs, old_mesh=None, old_specs=None):
    """Elastic re-shard: this rank's blocks under ``specs`` on
    ``new_mesh`` of a tree of whole arrays, or, with ``old_mesh`` and
    ``old_specs``, of a tree of blocks on the old mesh (gathered whole
    first: every rank of the old mesh calls it).  None on a rank outside
    the new mesh."""
    leaves = [x for _, x in flatten_with_paths(tree)]
    if old_mesh is not None:
        leaves = [gather_full(x, sp, old_mesh) for x, (_, sp) in
                  zip(leaves, flatten_specs(old_specs))]
    if new_mesh is None:
        return None
    return unflatten_like(tree, [
        local_shard(x, sp, new_mesh).clone()
        for x, (_, sp) in zip(leaves, flatten_specs(specs))])


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
                 straggler: StragglerDetector | None = None,
                 mesh=None, specs=None):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None and mesh.is_live else None
        self.specs = specs
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
                                            (params, opt_state),
                                            mesh=self.mesh, specs=self.specs)
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
                    self._save(step, params, opt_state)
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

    def _save(self, step: int, params, opt_state) -> None:
        meta = {"next_step": step}
        if self.mesh is None:
            self.ckpt.save(step, (params, opt_state), self.specs, meta)
            return
        save(self.cfg.ckpt_dir, step, (params, opt_state), self.specs, meta,
             mesh=self.mesh)
        if self.mesh.rank == 0:
            gc_old(self.cfg.ckpt_dir, self.cfg.keep)
        comm.barrier(self.mesh.group(self.mesh.axis_names))
