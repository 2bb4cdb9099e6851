"""Sweep driving of the port's engine (port of ``repro.core.sweep``).

``SweepRunner`` caches prepared scenarios (``engine._prep`` output on the
device) by content fingerprint, and pads flow and group counts up to the
next power of two (inert padding, see ``engine._prep``) so that schedules
of similar size share one set of shapes, as the reference does for its
compile cache.

* **single runs** — ``run``, ``run_spec``, ``run_specs`` and
  ``run_policies`` run one scenario per call (``Results``);
* **batched lanes** — ``run_batch`` stacks CC parameters,
  ``FabricParams`` leaves and ``FaultSpec`` leaves of one policy on a
  leading lane axis and steps all B lanes in one loop: every kernel launch
  and every op of the step covers the B lanes (the reference's ``vmap``,
  written out).  A stack that injects any fault runs the faulty step on
  every lane (an inert lane stays lossless in value, as in the
  reference);
* **grids** — ``grid`` / ``grid_spec`` enumerate a full-factorial CC x
  fabric x fault grid into one batch; ``grid_from_spec`` draws grid axes
  from a policy's declared ``ParamSpec`` ranges;
* **a batched policy axis** — ``run_policy_axis`` stacks several policies
  into one product policy (``cc.stack_policies``, a per-lane select) and
  runs the comparison as one batch; ``grid(..., policy_axis=[...])``
  crosses it with CC and fabric grids.  Stacked policies run on the op
  path, as in the reference;
* **streaming** — ``chunk_lanes`` splits a large batch into fixed-size
  chunks of lanes, the last one padded by repeating its final lane (the
  padding's results are dropped), and ``dispatch_hook(lo, hi, B)`` is
  called before each chunk;
* **backend calibration** — ``calibrate_backend`` times batched against
  serial runs on a device and caches the crossover table per device type
  (persisted under ``$REPRO_CACHE_DIR``); ``batch_pays_off`` and
  ``policy_axis_pays_off`` advise drivers from it.

* **lanes over a device mesh** — ``SweepRunner(mesh="auto" | n |
  GridMesh)`` (``repro_torch.common.sharding``) lays each chunk's lanes
  over a 1-D mesh of devices of the runner's type, round-robin (lane i to
  mesh position i % n, since grid lanes arrive sorted along the sweep
  axes and blocks of neighbours would pile one regime onto one device),
  the chunk padded to a multiple of the mesh by repeating its final lane.
  Each position's block of lanes runs the batched loop above on its
  device (the kernel path on the card, the op path on the CPU), with its
  own early exit; the scenario's prepared tensors are moved to each
  device once (``Simulator.on``), and the results come back in lane
  order, bit-equal to ``mesh=None`` (each lane equals its serial run bit
  for bit).  Distinct devices overlap through one host thread each (the
  step loop reads the halt flags every step, so no device's chunk can be
  issued ahead of the others' syncs); the blocks of a repeated device run
  one after another in its thread;

Lane isolation: a diverged lane freezes, a deadlocked or budget-exhausted
lane is flagged, and the healthy lanes complete normally
(``BatchResults.lane_status``).  Batched runs never record the queue
timeline.  Not ported: ``compile_stats`` (the port compiles nothing).

    runner = SweepRunner(EngineConfig(dt=2e-6, max_steps=4000,
                                      queue_stride=0))   # device="cuda"
    results = runner.run_policies(topo, sched, ["pfc", "dcqcn", "hpcc"])
    batch = runner.grid(topo, sched, "dcqcn", {"rai_frac": [0.01, 0.1]},
                        fabric_grid={"kmin": [100e3, 400e3]})
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext

import numpy as np
import torch

from repro_torch.common.sharding import resolve_grid_mesh
from repro_torch.core import cc as cc_mod
from repro_torch.core.cc import Policy, stack_policies
from repro_torch.core.engine import (EngineConfig, FabricParams, Results,
                                     Simulator, _as_fabric, _canonical,
                                     _FABRIC_DEFAULTS, _init_carry,
                                     _next_pow2, _tree_map, resolve_device)
from repro_torch.core.faults import (FaultSpec, LaneStatus, _as_fault,
                                     classify_lane, is_faulty)

def _resolve(policy) -> Policy:
    return cc_mod.get_policy(policy) if isinstance(policy, str) else policy


def _bucket(n: int, lo: int = 32) -> int:
    return max(lo, _next_pow2(max(n, 1)))


def _policy_key(policy: Policy):
    """Identity of a policy's logic and defaults (init may bake them)."""
    return (policy.name, float(policy.wire_factor),
            getattr(policy.init, "__code__", policy.init),
            getattr(policy.update, "__code__", policy.update),
            tuple(sorted((k, float(v)) for k, v in policy.params.items())),
            policy.members)


@dataclasses.dataclass
class BatchResults:
    """One batched sweep over B stacked (CC params, FabricParams,
    FaultSpec) sets, with per-lane run-health status.  ``fault`` holds the
    stacked FaultSpec leaves and ``lost`` each lane's dropped bytes per
    flow when the batch injected faults (both empty/None otherwise).
    ``meta`` holds the run's step counts (``steps_executed`` summed over
    chunks; ``lane_steps``, the steps each lane stepped before it halted),
    step path and device."""
    policy: str
    params: dict                  # stacked CC leaves, shape (B,)
    fabric: dict                  # stacked FabricParams leaves, (B,) or (B,C)
    completion_time: np.ndarray   # (B,)
    t_finish: np.ndarray          # (B, F)
    pause_count: np.ndarray       # (B, D)
    delivered: np.ndarray         # (B, F)
    soft_cost: np.ndarray         # (B,)
    finished: np.ndarray          # (B,) bool
    policy_axis: tuple = ()       # per-member policy label (policy sweeps)
    fault: dict = dataclasses.field(default_factory=dict)  # FaultSpec leaves
    diverged: np.ndarray | None = None        # (B,) non-finite lane, frozen
    deadlock_step: np.ndarray | None = None   # (B,) first pause-cycle step
    storm_step: np.ndarray | None = None      # (B,) first pause-storm step
    extend_exhausted: np.ndarray | None = None  # (B,) budget ran out
    lost: np.ndarray | None = None            # (B, F) dropped (faulty)
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def n(self) -> int:
        return len(self.completion_time)

    @property
    def deadlocked(self) -> np.ndarray:
        """(B,) bool: a PFC pause-graph cycle was detected in that lane."""
        if self.deadlock_step is None:
            return np.zeros(self.n, bool)
        return self.deadlock_step >= 0

    def lane_status(self) -> list[LaneStatus]:
        """Per-lane health as ``faults.LaneStatus`` (a ``str`` subclass).
        A deadlocked-but-finished lane still reads ``DEADLOCKED``."""
        dead = self.deadlocked
        div = (np.zeros(self.n, bool) if self.diverged is None
               else self.diverged)
        return [classify_lane(bool(div[i]), bool(dead[i]),
                              bool(self.finished[i]))
                for i in range(self.n)]

    def best(self) -> int:
        """Index of the fastest *finished* member (lowest completion)."""
        if not self.finished.any():
            raise ValueError("no sweep member finished within the step "
                             "budget; raise max_steps/max_extends")
        ct = np.where(self.finished, self.completion_time, np.inf)
        return int(np.argmin(ct))

    def policy_of(self, i: int) -> str:
        """Policy label of member ``i`` (== ``policy`` without an axis)."""
        if self.policy_axis:
            return self.policy_axis[int(np.asarray(
                self.params["_which"])[i])]
        return self.policy

    def param_set(self, i: int) -> dict:
        return {k: float(np.asarray(v)[i]) for k, v in self.params.items()}

    def fabric_set(self, i: int) -> FabricParams:
        return FabricParams(**{k: np.asarray(v)[i]
                               for k, v in self.fabric.items()})

    def fault_set(self, i: int) -> FaultSpec:
        """The FaultSpec lane ``i`` ran under (inert spec if no faults)."""
        if not self.fault:
            return FaultSpec()
        return FaultSpec(**{k: np.asarray(v)[i]
                            for k, v in self.fault.items()})


# unhealthy-lane warning dedupe: one warning per (policy, status-kind set)
# per process; reset_unhealthy_warnings re-arms it
_UNHEALTHY_WARNED: set = set()


def reset_unhealthy_warnings() -> None:
    """Re-arm the deduplicated unhealthy-lane ``RuntimeWarning``."""
    _UNHEALTHY_WARNED.clear()


def _fmt_lane_indices(idx: list, cap: int = 8) -> str:
    head = ", ".join(str(i) for i in idx[:cap])
    return f"[{head}{', ...' if len(idx) > cap else ''}]"


def _warn_unhealthy_lanes(batch: BatchResults, B: int) -> None:
    unhealthy = [(i, s) for i, s in enumerate(batch.lane_status())
                 if s is not LaneStatus.OK]
    if not unhealthy:
        return
    key = (batch.policy, frozenset(s for _, s in unhealthy))
    if key in _UNHEALTHY_WARNED:
        return
    _UNHEALTHY_WARNED.add(key)
    by_status: dict = {}
    for i, s in unhealthy:
        by_status.setdefault(s, []).append(i)
    detail = "; ".join(f"{s}: lanes {_fmt_lane_indices(idx)}"
                       for s, idx in by_status.items())
    warnings.warn(
        f"{len(unhealthy)}/{B} sweep lanes unhealthy ({detail}); healthy "
        "lanes completed normally — inspect BatchResults.lane_status(). "
        "Further identical warnings for this (policy, status) combination "
        "are suppressed (sweep.reset_unhealthy_warnings() re-arms).",
        RuntimeWarning, stacklevel=3)


def grid_from_spec(policy: Policy | str, n_points: int = 3,
                   keys: list | None = None) -> dict:
    """Grid axes from a policy's declared ``ParamSpec`` ranges: each
    selected tunable, bounded param gets ``n_points`` values over [lo, hi],
    geometric where the spec says ``scale="log"``, linear otherwise,
    rounded and deduplicated for integer params."""
    policy = _resolve(policy)
    if keys is None:
        keys = [k for k, s in policy.spec.items()
                if not s.init_baked and s.bounded and not k.startswith("_")]
    else:
        policy.check_tunable(keys)
    axes = {}
    for k in keys:
        s = policy.param_spec(k)
        if not s.bounded:
            raise ValueError(f"{policy.name} param {k!r} declares no "
                             "lo/hi bounds; pass explicit grid values")
        if s.scale == "log":
            vals = np.geomspace(s.lo, s.hi, n_points)
        else:
            vals = np.linspace(s.lo, s.hi, n_points)
        if s.integer:
            vals = np.unique(np.round(vals))
        axes[k] = [float(v) for v in vals]
    if not axes:
        raise ValueError(f"{policy.name} has no bounded tunable params")
    return axes


def _stack_leaves(cls, base, stacked: dict | None, B: int, what: str):
    """Stack a FabricParams/FaultSpec's leaves on a leading B axis; leaves
    absent from ``stacked`` broadcast the base value.  Stacked leaves are
    (B,) scalars-per-lane or (B, N_LINK_CLASSES) per-class arrays."""
    stacked = stacked or {}
    cls.check_fields(stacked)
    leaves = {}
    for f in cls.FIELDS:
        if f in stacked:
            v = np.asarray(stacked[f], np.float32)
            if v.shape[0] != B:
                raise ValueError(f"{what} param {f!r} has leading dim "
                                 f"{v.shape[0]}, expected batch {B}")
        else:
            b = np.asarray(getattr(base, f), np.float32)
            v = np.broadcast_to(b, (B,) + b.shape)
        leaves[f] = v
    return cls(**leaves)


def _stack_fabric(base: FabricParams, stacked: dict | None,
                  B: int) -> FabricParams:
    return _stack_leaves(FabricParams, base, stacked, B, "fabric")


def _stack_fault(base: FaultSpec, stacked: dict | None, B: int) -> FaultSpec:
    return _stack_leaves(FaultSpec, base, stacked, B, "fault")


def stack_policy_axis(policies=None, cc_overrides: list | None = None):
    """The policy-axis inputs without dispatching: the product policy
    (``cc.stack_policies``), its per-lane params (the ``_which`` selector,
    the paired ``_wire`` factors, and ``"<policy>.<param>"`` columns for
    any ``cc_overrides``, aligned with ``policies``; only lane i reads
    member i's params) and the labels.  Returns ``(stacked_policy, params,
    labels)``, ready for ``run_batch(..., policy_axis=labels)``."""
    members = [_resolve(p) for p in (policies or cc_mod.ALL_POLICIES)]
    stacked_pol = stack_policies(members)
    labels = stacked_pol.members
    B = len(members)
    params = {
        "_which": np.arange(B, dtype=np.float32),
        "_wire": np.asarray([m.wire_factor for m in members], np.float32),
    }
    if cc_overrides:
        if len(cc_overrides) != B:
            raise ValueError(f"cc_overrides has {len(cc_overrides)} "
                             f"entries for {B} policies")
        for i, (lab, m, over) in enumerate(
                zip(labels, members, cc_overrides)):
            if not over:
                continue
            m.check_tunable(over)
            for k, v in over.items():
                key = f"{lab}.{k}"
                col = params.get(key)
                if col is None:
                    col = np.full(B, float(m.params[k]), np.float32)
                col[i] = float(v)
                params[key] = col
    return stacked_pol, params, tuple(labels)


# -- backend calibration ----------------------------------------------------

_INF = float("inf")

# Fallback crossover tables (largest n_flows at which the batched path
# still wins wall-clock) used before any measurement has run on a device
# type.  "sweep" = same-policy parameter sweep as one batch vs a serial
# loop; "policy_axis" = the stacked product policy (op path) vs per-policy
# runs (on the card: the kernel path); "sharded" = lanes over a device
# mesh vs one device (only measurable with more than one CUDA device;
# unlisted -> inf, i.e. lay lanes over a mesh whenever one was
# configured).  The "cpu" row is the
# port's own measurement on an 8-core x86 CPU container (torch 2.13.0+cpu,
# 8 intra-op threads; two more quiet runs at 8 and 1 threads gave the
# same table, and of two beside other load one lost the policy axis at
# 96 flows):
#   calibrate_backend(device="cpu", persist=False)   # default probes
#   sweep        96 flows: serial 1.645 s, batched 0.416 s
#              1920 flows: serial 15.618 s, batched 4.005 s
#   policy_axis  96 flows: serial 1.639 s, batched 0.922 s
#              1920 flows: serial 12.643 s, batched 8.831 s
# Batching won at every probe, so the row is inf, unlike the JAX
# package's CPU row.  "cuda" stays unlisted (inf): chip_smoke.py's
# calibrate phase on an NVIDIA H100 80GB HBM3 at 700.00 W (torch
# 2.11.0+cu128), three runs, serial against batched seconds:
#   sweep        96 flows: 2.213 / 1.50 / 2.36 against 0.401 / 0.29 / 0.34
#              1920 flows: 10.755 / 10.64 / 11.04 against 1.964 / 1.63 / 1.83
#   policy_axis  96 flows: 2.793 / 2.54 / 2.94 against 2.842 / 2.43 / 3.08
#              1920 flows: 12.632 / 8.39 / 15.50 against 7.243 / 7.14 / 10.22
# The stacked policy (op path) against six kernel-path runs ties at 96
# flows (lost by 2%, won by 4%, lost by 5%) and wins clearly at 1,920, so
# no probe shows batching losing beyond run-to-run spread.  Device types
# not listed batch everywhere (inf).
DEFAULT_CROSSOVERS: dict = {
    "cpu": {"sweep": _INF, "policy_axis": _INF},
}


def _torch_record() -> dict:
    """What a persisted table was measured under: a table measured under
    another torch version or CUDA device count is not reused."""
    return {"version": torch.__version__,
            "cuda_devices": torch.cuda.device_count()}


@dataclasses.dataclass(frozen=True)
class BackendCalibration:
    """Serial-vs-batched crossover table for one device type ("cpu",
    "cuda"), either measured (``calibrate_backend``) or the
    ``DEFAULT_CROSSOVERS`` fallback.  ``crossover[kind]`` is the largest
    flow count at which the batched path still wins: ``inf`` = batching
    always pays off, ``0.0`` = never."""
    backend: str
    source: str = "default"            # "default" | "measured"
    crossover: dict = dataclasses.field(default_factory=dict)
    probes: tuple = ()                 # (kind, n_flows, serial_s, batched_s)

    def pays_off(self, kind: str, n_flows: int | None = None) -> bool:
        """Should the batched path run for ``kind`` at ``n_flows``?  With
        ``n_flows=None`` (scenario-independent callers) batching is
        recommended only when it wins at *every* scale."""
        thr = float(self.crossover.get(kind, _INF))
        if n_flows is None:
            return thr == _INF
        return n_flows <= thr

    def record(self) -> dict:
        """JSON-safe dict (inf encoded as "inf")."""
        enc = {k: ("inf" if float(v) == _INF else float(v))
               for k, v in self.crossover.items()}
        return {"backend": self.backend, "source": self.source,
                "crossover": enc,
                "probes": [{"kind": k, "n_flows": n, "serial_s": s,
                            "batched_s": b}
                           for k, n, s, b in self.probes]}


_CALIBRATION: dict = {}
# device types for which the on-disk table must NOT be consulted: either
# the load was already attempted once, or reset_calibration() pinned the
# process back to the defaults ("*" = every device type)
_NO_DISK: set = set()


def _backend(backend) -> str:
    """A device type; None is the port's default device, the card."""
    return "cuda" if backend is None else torch.device(backend).type


def calibration_cache_path(backend: str | None = None,
                           cache_dir: str | None = None) -> str:
    """Where ``calibrate_backend`` persists its measured table
    (``$REPRO_CACHE_DIR/repro_torch_calibration_<device type>.json``,
    default ``.cache/``) so fresh processes warm-start instead of
    re-measuring."""
    cache_dir = cache_dir or os.environ.get("REPRO_CACHE_DIR", ".cache")
    return os.path.join(cache_dir,
                        f"repro_torch_calibration_{_backend(backend)}.json")


def save_calibration(cal: BackendCalibration,
                     path: str | None = None) -> str | None:
    """Persist a measured calibration to disk (JSON; inf encoded).  Best
    effort: an unwritable cache dir is silently skipped (returns None).
    Written tmp-file + atomic rename, so a run killed mid-write leaves
    the previous table intact instead of a truncated JSON."""
    path = path or calibration_cache_path(cal.backend)
    rec = cal.record()
    rec["saved_at"] = time.time()
    rec["torch"] = _torch_record()
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(rec, f, indent=1)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    return path


def load_calibration(backend: str | None = None, path: str | None = None,
                     max_age_days: float | None = None
                     ) -> BackendCalibration | None:
    """Load a persisted calibration, or None when absent/stale/invalid.

    A table is rejected when it was measured under a different torch
    version or CUDA device count (both change the crossover), or — with
    ``max_age_days`` — when older than that.  A corrupt or truncated
    file is logged and ignored, never raised — a stale warm-start cache
    must not take down the first sweep of a fresh process."""
    backend = _backend(backend)
    path = path or calibration_cache_path(backend)
    try:
        with open(path) as f:
            rec = json.load(f)
    except OSError:
        return None                     # absent cache: the normal cold start
    except ValueError:
        warnings.warn(f"ignoring corrupt calibration cache {path} "
                      "(unparseable JSON; re-measure or delete it)",
                      RuntimeWarning, stacklevel=2)
        return None
    try:
        if rec.get("backend") != backend:
            return None
        if rec.get("torch") != _torch_record():
            return None
        if max_age_days is not None:
            age = time.time() - float(rec.get("saved_at", 0.0))
            if age > max_age_days * 86400.0:
                return None
        crossover = {k: (_INF if v == "inf" else float(v))
                     for k, v in rec.get("crossover", {}).items()}
        probes = tuple((p["kind"], int(p["n_flows"]), float(p["serial_s"]),
                        float(p["batched_s"])) for p in rec.get("probes", ()))
    except Exception:                   # valid JSON, wrong shape/types
        warnings.warn(f"ignoring malformed calibration cache {path} "
                      "(unexpected record shape; re-measure or delete it)",
                      RuntimeWarning, stacklevel=2)
        return None
    return BackendCalibration(backend=backend,
                              source=rec.get("source", "measured"),
                              crossover=crossover, probes=probes)


def get_calibration(backend: str | None = None) -> BackendCalibration:
    """The active crossover table for a device type (default: "cuda"):
    the cached ``calibrate_backend`` measurement if one exists, else a
    table persisted to disk by a previous process
    (``calibration_cache_path``; disable with REPRO_CALIBRATION_CACHE=0),
    else the ``DEFAULT_CROSSOVERS`` entry (unlisted device types get inf
    thresholds: batching always on)."""
    backend = _backend(backend)
    cal = _CALIBRATION.get(backend)
    if (cal is None and "*" not in _NO_DISK and backend not in _NO_DISK
            and os.environ.get("REPRO_CALIBRATION_CACHE", "1") != "0"):
        _NO_DISK.add(backend)          # one load attempt per process
        cal = load_calibration(backend)
        if cal is not None:
            _CALIBRATION[backend] = cal
    if cal is None:
        table = dict(DEFAULT_CROSSOVERS.get(
            backend, {"sweep": _INF, "policy_axis": _INF}))
        cal = BackendCalibration(backend=backend, crossover=table)
    return cal


def set_calibration(cal: BackendCalibration) -> None:
    """Install a crossover table for ``cal.backend``."""
    _CALIBRATION[cal.backend] = cal


def reset_calibration(backend: str | None = None) -> None:
    """Drop cached calibrations (all device types when ``backend`` is
    None), reverting ``get_calibration`` to the defaults — the on-disk
    table is not reconsulted until the process restarts (tests rely on
    reset meaning *defaults*, not *whatever a previous run persisted*)."""
    if backend is None:
        _CALIBRATION.clear()
        _NO_DISK.add("*")
    else:
        backend = _backend(backend)
        _CALIBRATION.pop(backend, None)
        _NO_DISK.add(backend)


def _measure_crossover(kind: str, n_flows: int, B: int, cfg: EngineConfig,
                       device="cuda") -> tuple:
    """Default calibration probe: time a serial loop against one batch
    for a ``kind`` sweep on a 1D All-Reduce of ~``n_flows`` flows on
    ``device`` (bytes scale with ranks so the step budget stays occupied).
    On the card the serial side of "policy_axis" runs each policy on the
    kernel path and the batched side the stacked policy on the op path:
    exactly the choice the advice makes.  Returns ``(actual_n_flows,
    serial_s, batched_s)``, each side timed after one untimed call (the
    scenarios' ``_prep`` and the kernels' first load excluded)."""
    from repro_torch.core.collectives import allreduce_1d
    from repro_torch.core.topology import single_switch

    # allreduce_1d over R ranks with 4 chunks ~= 8*R*(R-1) flows
    R = max(2, int(round(0.5 + (0.25 + n_flows / 8.0) ** 0.5)))
    topo = single_switch(R)
    sched = allreduce_1d(topo, list(range(R)), 1e6 * R)
    runner = SweepRunner(cfg, device=device)
    if kind == "sweep":
        policy = cc_mod.get_policy("dcqcn")
        scale = np.linspace(0.5, 2.0, B).astype(np.float32)

        def serial():
            for s in scale:
                runner.run(topo, sched, policy,
                           dict(policy.params, rai_frac=float(0.03 * s)))

        def batched():
            runner.run_batch(topo, sched, policy,
                             {"rai_frac": 0.03 * scale})
    elif kind == "policy_axis":
        pols = list(cc_mod.ALL_POLICIES)[:max(2, B)]

        def serial():
            runner.run_policies(topo, sched, pols)

        def batched():
            runner.run_policy_axis(topo, sched, pols)
    elif kind == "sharded":
        # lanes over the mesh of every visible CUDA device vs one device,
        # the same B-lane sweep on both sides ("serial" is the one-device
        # batch)
        sharded = SweepRunner(cfg, mesh="auto", device=device)
        if sharded.mesh is None:
            raise RuntimeError("sharded calibration needs more than one "
                               "CUDA device for mesh='auto' (lay lanes over "
                               "repeated devices with grid_mesh(n, "
                               "devices=[...]) to test the layout)")
        policy = cc_mod.get_policy("dcqcn")
        Bs = max(B, sharded.n_mesh_devices)
        scale = np.linspace(0.5, 2.0, Bs).astype(np.float32)
        stacked = {"rai_frac": 0.03 * scale}

        def serial():
            runner.run_batch(topo, sched, policy, stacked)

        def batched():
            sharded.run_batch(topo, sched, policy, stacked)
    else:
        raise ValueError(f"unknown calibration kind: {kind!r}")

    out = []
    for fn in (serial, batched):
        fn()                                    # warmup: prep, kernel load
        _sync(runner.device)
        t0 = time.perf_counter()
        fn()
        _sync(runner.device)
        out.append(time.perf_counter() - t0)
    return sched.n_flows, out[0], out[1]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def calibrate_backend(probe_flows=(90, 1806), B: int = 6,
                      cfg: EngineConfig | None = None,
                      kinds=None, device="cuda",
                      persist: bool = True,
                      _measure=None) -> BackendCalibration:
    """Measure the serial-vs-batched wall-clock crossover on ``device``
    and cache it for its device type; ``SweepRunner.batch_pays_off`` /
    ``policy_axis_pays_off`` consult the cached table from then on.

    For each ``kind`` the batched path is timed against the serial loop at
    each probe size; the crossover is the geometric mean of the largest
    winning and smallest losing probe (all probes win -> inf, all lose ->
    0.0).  ``kinds=None`` probes "sweep" and "policy_axis", plus
    "sharded" (lanes over every visible CUDA device vs one) when ``device``
    is a CUDA device and more than one is visible.  The measured table is persisted to
    ``calibration_cache_path()`` (``persist=False`` to skip) so later
    processes warm-start via ``get_calibration`` instead of re-measuring.
    ``_measure(kind, n_flows, B, cfg)`` is injectable for tests and
    deterministic benchmarks."""
    device = resolve_device(device)
    cfg = cfg or EngineConfig(dt=2e-6, max_steps=600, max_extends=1,
                              queue_stride=0)
    if kinds is None:
        kinds = ("sweep", "policy_axis")
        if device.type == "cuda" and torch.cuda.device_count() > 1:
            kinds += ("sharded",)
    measure = _measure or functools.partial(_measure_crossover,
                                            device=device)
    probes, table = [], {}
    for kind in kinds:
        wins, losses = [], []
        for n in probe_flows:
            nf, serial_s, batched_s = measure(kind, n, B, cfg)
            probes.append((kind, int(nf), float(serial_s), float(batched_s)))
            (wins if batched_s < serial_s else losses).append(float(nf))
        if not losses:
            table[kind] = _INF
        elif not wins:
            table[kind] = 0.0
        else:
            table[kind] = float((max(wins) * min(losses)) ** 0.5)
    cal = BackendCalibration(backend=device.type, source="measured",
                             crossover=table, probes=tuple(probes))
    set_calibration(cal)
    if persist and _measure is None:    # injected probes are synthetic —
        save_calibration(cal)           # never persist them to disk
    return cal


# the per-lane finals a batch brings back to the host
_FINAL_KEYS = ("t_finish", "done", "pause_count", "delivered", "soft",
               "diverged", "deadlock_step", "storm_step", "lost")


def _run_block(sim: Simulator, idx: np.ndarray, full: dict,
               fab: FabricParams, flt: FaultSpec) -> tuple:
    """Lanes ``idx`` of the stacked inputs as one batched loop on
    ``sim``'s device: ``(host finals, steps_run, steps_executed,
    lane_steps)``."""
    params = {k: v[idx] for k, v in full.items()}
    lane_fab = FabricParams(**{f: np.asarray(getattr(fab, f))[idx]
                               for f in FabricParams.FIELDS})
    lane_flt = FaultSpec(**{f: np.asarray(getattr(flt, f))[idx]
                            for f in FaultSpec.FIELDS})
    carry, steps, executed, lane_steps = sim.run_carry(
        params, lane_fab, len(idx), fault=lane_flt)
    host = {k: carry[k].detach().cpu().numpy() for k in _FINAL_KEYS
            if k in carry}
    return host, steps, executed, np.asarray(lane_steps)


def _device_context(device: torch.device):
    """Make ``device`` the current CUDA device of the calling thread (its
    kernels launch on that device's current stream)."""
    return torch.cuda.device(device) if device.type == "cuda" \
        else nullcontext()


def _run_blocks(sim: Simulator, devices: tuple, blocks: list, full: dict,
                fab: FabricParams, flt: FaultSpec) -> list:
    """Block d of lanes on ``devices[d]``, each on ``sim``'s replica there
    (``Simulator.on``); returns their ``_run_block`` results in block
    order.  The blocks of one device run one after another; distinct
    devices run in one host thread each, and every thread's result is
    read, so an error on any device raises here."""
    by_device: dict = {}
    for d, dev in enumerate(devices):
        by_device.setdefault(_canonical(dev), []).append(d)

    def work(dev, ds):
        with _device_context(dev):
            rep = sim.on(dev)
            return [(d, _run_block(rep, blocks[d], full, fab, flt))
                    for d in ds]
    if len(by_device) == 1:
        done = work(*next(iter(by_device.items())))
    else:
        with ThreadPoolExecutor(len(by_device),
                                thread_name_prefix="sweep-mesh") as pool:
            futures = [pool.submit(work, dev, ds)
                       for dev, ds in by_device.items()]
            done = [r for f in futures for r in f.result()]
    return [out for _, out in sorted(done, key=lambda r: r[0])]


class SweepRunner:
    """Prepare-once, run-many driver for ``repro_torch.core.engine`` on
    ``device`` (the card by default); batches lay their lanes over
    ``mesh`` (``resolve_grid_mesh``: None, "auto", a device count or a
    ``GridMesh`` of devices of ``device``'s type) where one is given."""

    MAX_SIMS = 64
    # chunk_lanes="auto": stream batches of more lanes than this in chunks
    AUTO_CHUNK_PER_DEVICE = 256

    def __init__(self, cfg: EngineConfig | None = None, bucket: bool = True,
                 mesh=None, chunk_lanes: int | str | None = "auto",
                 dispatch_hook=None, device="cuda"):
        self.device = resolve_device(device)
        self.mesh = resolve_grid_mesh(mesh)
        if self.mesh is not None:
            for d in self.mesh.devices:
                if d.type != self.device.type:
                    raise ValueError(f"mesh device {d} is not a "
                                     f"{self.device.type} device like the "
                                     "runner's")
                resolve_device(d)
                if d.type == "cuda" and d.index is not None and \
                        d.index >= torch.cuda.device_count():
                    raise ValueError(f"mesh device {d}: only "
                                     f"{torch.cuda.device_count()} CUDA "
                                     "devices are visible")
        self.cfg = cfg or EngineConfig()
        self.bucket = bucket
        self.chunk_lanes = chunk_lanes
        # called as dispatch_hook(lo, hi, B) just before each lane chunk
        self.dispatch_hook = dispatch_hook
        self._sims: dict = {}

    def share_prep(self, **changes) -> "SweepRunner":
        """A runner like this one (config, bucketing, mesh, chunking, hook,
        device) with ``changes`` applied, sharing this one's prepared
        scenarios: no second ``_prep`` and no second copy of a plan on
        the device."""
        kw = dict(cfg=self.cfg, bucket=self.bucket, mesh=self.mesh,
                  chunk_lanes=self.chunk_lanes,
                  dispatch_hook=self.dispatch_hook, device=self.device)
        sub = SweepRunner(**dict(kw, **changes))
        sub._sims = self._sims
        return sub

    def _pre_dispatch(self, lo: int, hi: int, B: int) -> None:
        if self.dispatch_hook is not None:
            self.dispatch_hook(lo, hi, B)

    @property
    def n_mesh_devices(self) -> int:
        """Mesh positions the lane axis is laid over (1 without a mesh)."""
        return 1 if self.mesh is None else self.mesh.size

    def _chunk_size(self, B: int) -> int:
        """Lanes per dispatched chunk: a multiple of the mesh size, ``B``
        itself (padded up) when no chunking applies."""
        n_dev = self.n_mesh_devices
        pad_to = -(-B // n_dev) * n_dev                   # ceil to mesh
        if self.chunk_lanes in (None, 0):
            return pad_to
        if self.chunk_lanes == "auto":
            limit = self.AUTO_CHUNK_PER_DEVICE * n_dev
        else:
            limit = max(int(self.chunk_lanes), 1)
            limit = -(-limit // n_dev) * n_dev            # ceil to mesh
        return min(pad_to, limit)

    @staticmethod
    def _scenario_key(topo, sched):
        """Content fingerprint of a (topology, schedule) pair."""
        h = hashlib.sha1()
        for a in (sched.path, sched.size, sched.group, sched.dep,
                  sched.delay, topo.cap, topo.lat, topo.src_dev,
                  topo.dst_dev, topo.ecn_on, topo.fabric, topo.link_class,
                  topo.dev_is_switch, topo.dev_buf):
            h.update(np.ascontiguousarray(a).tobytes())
        return (topo.name, sched.n_flows, sched.n_groups, h.hexdigest())

    def simulator(self, topo, sched, policy: Policy,
                  cfg: EngineConfig | None = None) -> Simulator:
        cfg = cfg or self.cfg
        # fabric scalars arrive per run, so configs differing only there
        # share one prepared Simulator
        key = (self._scenario_key(topo, sched),
               dataclasses.replace(cfg, **_FABRIC_DEFAULTS),
               _policy_key(policy))
        sim = self._sims.get(key)
        if sim is None:
            pf = _bucket(sched.n_flows) if self.bucket else None
            pg = _bucket(sched.n_groups, lo=8) if self.bucket else None
            sim = Simulator(topo, sched, policy, cfg, pad_flows=pf,
                            pad_groups=pg, device=self.device)
            while len(self._sims) >= self.MAX_SIMS:
                self._sims.pop(next(iter(self._sims)))
            self._sims[key] = sim
        return sim

    # -- single runs ---------------------------------------------------------
    def run(self, topo, sched, policy: Policy | str,
            cc_params: dict | None = None,
            cfg: EngineConfig | None = None,
            fabric_params: FabricParams | None = None,
            fault_spec: FaultSpec | None = None) -> Results:
        policy = _resolve(policy)
        cfg = cfg or self.cfg
        fab = _as_fabric(fabric_params, cfg)
        return self.simulator(topo, sched, policy, cfg).run(
            cc_params, fabric_params=fab, fault_spec=fault_spec)

    def run_policies(self, topo, sched, policies=None,
                     cfg: EngineConfig | None = None,
                     fabric_params: FabricParams | None = None) -> list:
        """One scenario under each CC policy, serially (``Results`` with
        queue timelines); ``run_policy_axis`` runs them as one batch."""
        return [self.run(topo, sched, p, cfg=cfg, fabric_params=fabric_params)
                for p in (policies or cc_mod.ALL_POLICIES)]

    def batch_pays_off(self, sched) -> bool:
        """Should a *same-policy* parameter sweep over this scenario run
        as one batch or serially?  Decided from the crossover table of
        this runner's device type — the cached ``calibrate_backend``
        measurement, or ``DEFAULT_CROSSOVERS`` when uncalibrated."""
        return get_calibration(self.device.type).pays_off("sweep",
                                                          sched.n_flows)

    def policy_axis_pays_off(self, sched=None) -> bool:
        """Like ``batch_pays_off`` but for the stacked policy axis, which
        runs on the op path and evaluates *every* member's update per
        lane.  Called without ``sched`` the axis is recommended only where
        it wins at every measured scale."""
        return get_calibration(self.device.type).pays_off(
            "policy_axis", None if sched is None else sched.n_flows)

    def sharded_pays_off(self, sched=None) -> bool:
        """Would laying the lanes over the device mesh beat one device?
        False without a mesh; otherwise decided from the crossover table
        of this runner's device type (kind ``"sharded"``, unlisted: inf,
        always).  Advice for drivers deciding whether to build a runner
        with a mesh: ``run_batch`` itself never second-guesses a
        configured mesh (the repeated-device testing layout depends on
        that).  Both layouts give the same lanes bit for bit."""
        if self.mesh is None:
            return False
        return get_calibration(self.device.type).pays_off(
            "sharded", None if sched is None else sched.n_flows)

    def lane_state_bytes(self, topo, sched, policy: Policy | str,
                         cfg: EngineConfig | None = None,
                         faulty: bool = False) -> int:
        """Device bytes one sweep lane's stepping carry occupies, counted
        from the port's carry (``faulty``: with the fault step's three
        per-flow rows).  A chunk of n lanes holds n times this, plus the
        shared prepared scenario."""
        policy = _resolve(policy)
        cfg = dataclasses.replace(cfg or self.cfg, queue_stride=0)
        sim = self.simulator(topo, sched, policy, cfg)
        total = []
        _tree_map(lambda x: total.append(x.numel() * x.element_size()),
                  _init_carry(sim.pp, sim.plan, policy, cfg,
                              faulty=faulty))
        return int(sum(total))

    # -- the batched policy axis --------------------------------------------
    def run_policy_axis(self, topo, sched, policies=None,
                        cc_overrides: list | None = None,
                        cfg: EngineConfig | None = None,
                        fabric_params: FabricParams | None = None,
                        stacked_fabric: dict | None = None,
                        fault_spec: FaultSpec | None = None,
                        stacked_fault: dict | None = None) -> BatchResults:
        """The per-figure policy comparison as one batch: B =
        len(policies) lanes of one product policy, lane i simulating
        member i.  ``cc_overrides`` optionally gives a per-member cc_params
        dict (aligned with ``policies``); ``stacked_fabric`` and
        ``stacked_fault`` may stack per-lane FabricParams and FaultSpec
        leaves (length B) over ``fabric_params`` and ``fault_spec``."""
        stacked_pol, params, labels = stack_policy_axis(policies,
                                                        cc_overrides)
        return self.run_batch(topo, sched, stacked_pol, params,
                              stacked_fabric=stacked_fabric,
                              fabric_params=fabric_params, cfg=cfg,
                              policy_axis=tuple(labels),
                              stacked_fault=stacked_fault,
                              fault_spec=fault_spec)

    # -- declarative scenarios ----------------------------------------------
    def run_spec(self, spec, cfg: EngineConfig | None = None) -> Results:
        """Simulate one ``ScenarioSpec``."""
        if isinstance(spec.policy, (tuple, list)):
            raise ValueError(
                "spec declares a policy axis (tuple policy); run it batched "
                "via grid_spec/run_policy_axis, or pick one member")
        topo, sched, policy = spec.build()
        cc = None
        if spec.cc_params:
            policy.check_tunable(spec.cc_params)
            cc = dict(policy.params, **spec.cc_params)
        return self.run(topo, sched, policy, cc_params=cc, cfg=cfg,
                        fabric_params=spec.fabric_params,
                        fault_spec=spec.fault_spec)

    def run_specs(self, specs, cfg: EngineConfig | None = None) -> list:
        """Simulate a list of ``ScenarioSpec``s; a tuple-policy spec
        (``scenario_matrix(stacked=True)``) runs its policy axis as one
        batch and contributes a ``BatchResults`` entry."""
        return [self.grid_spec(s, cfg=cfg)
                if isinstance(s.policy, (tuple, list))
                else self.run_spec(s, cfg=cfg) for s in specs]

    def grid_spec(self, spec, param_grid: dict | None = None,
                  fabric_grid: dict | None = None,
                  cfg: EngineConfig | None = None,
                  fault_grid: dict | None = None) -> BatchResults:
        """Full-factorial CC x fabric (x fault) grid on one
        ``ScenarioSpec``; a tuple ``policy`` sweeps the policy axis too."""
        topo, sched, policy = spec.build()
        if isinstance(spec.policy, (tuple, list)):
            return self.grid(topo, sched, None, param_grid, fabric_grid,
                             fabric_params=spec.fabric_params,
                             cc_params=spec.cc_params, cfg=cfg,
                             policy_axis=list(spec.policy),
                             fault_grid=fault_grid,
                             fault_spec=spec.fault_spec)
        return self.grid(topo, sched, policy, param_grid, fabric_grid,
                         fabric_params=spec.fabric_params,
                         cc_params=spec.cc_params, cfg=cfg,
                         fault_grid=fault_grid,
                         fault_spec=spec.fault_spec)

    # -- batched parameter sweeps -------------------------------------------
    def _dispatch_lanes(self, sim: Simulator, full: dict, fab: FabricParams,
                        flt: FaultSpec, B: int) -> tuple:
        """Run B stacked lanes in chunks of ``_chunk_size(B)``; the last
        chunk is padded by repeating its final lane and the padding is
        dropped, so callers see exactly B lanes in input order.  With a
        mesh, each chunk is permuted so that block d of it holds the
        round-robin lanes {d, d + n, ...} and block d runs on mesh position
        d (``_run_blocks``); the inverse permutation restores lane order.
        Returns ``(host numpy finals, meta)``."""
        chunk = self._chunk_size(B)
        n_dev = self.n_mesh_devices
        order = np.arange(chunk).reshape(-1, n_dev).T.reshape(-1)
        inv = np.argsort(order)
        devices = (sim.device,) if self.mesh is None else self.mesh.devices
        parts = []
        meta = {"steps_run": 0, "steps_executed": 0, "lane_steps": [],
                "chunks": 0, "chunk_lanes": chunk, "mesh_devices": n_dev,
                "step_impl": sim.step_impl, "device": str(sim.device)}
        for lo in range(0, B, chunk):
            hi = min(lo + chunk, B)
            take = np.arange(lo, hi)
            if hi - lo < chunk:                   # edge-repeat trailing pad
                take = np.concatenate([take,
                                       np.full(chunk - (hi - lo), hi - 1)])
            self._pre_dispatch(lo, hi, B)
            blocks = np.split(take[order], n_dev)
            outs = _run_blocks(sim, devices, blocks, full, fab, flt)
            parts.append({k: np.concatenate([o[0][k] for o in outs])[inv][
                :hi - lo] for k in outs[0][0]})
            lane_steps = np.concatenate([o[3] for o in outs])[inv]
            meta["steps_run"] = max([meta["steps_run"]]
                                    + [o[1] for o in outs])
            meta["steps_executed"] += sum(o[2] for o in outs)
            meta["lane_steps"] += lane_steps[:hi - lo].tolist()
            meta["chunks"] += 1
        out = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        return out, meta

    def run_batch(self, topo, sched, policy: Policy | str,
                  stacked_params: dict | None = None,
                  stacked_fabric: dict | None = None,
                  fabric_params: FabricParams | None = None,
                  cc_params: dict | None = None,
                  cfg: EngineConfig | None = None,
                  policy_axis: tuple = (),
                  stacked_fault: dict | None = None,
                  fault_spec: FaultSpec | None = None) -> BatchResults:
        """Simulate B (CC params, FabricParams) sets in one stepping loop.

        ``stacked_params`` maps CC param name -> length-B array;
        ``stacked_fabric`` maps FabricParams field -> (B,) or (B, C) array;
        ``stacked_fault`` maps FaultSpec field -> (B,) or (B, C) array.
        Missing CC params broadcast from the policy defaults (overridden by
        ``cc_params``); missing fabric fields from ``fabric_params``
        (default: the runner config's scalars); missing fault fields from
        ``fault_spec`` (default: inert).  ``policy_axis`` carries
        the per-lane labels when ``policy`` is a stacked product policy
        (see ``run_policy_axis``)."""
        policy = _resolve(policy)
        stacked_params = stacked_params or {}
        policy.check_tunable(stacked_params)
        if cc_params:
            policy.check_tunable(cc_params)
        sizes = [len(np.asarray(v)) for v in stacked_params.values()]
        sizes += [np.asarray(v).shape[0]
                  for v in (stacked_fabric or {}).values()]
        sizes += [np.asarray(v).shape[0]
                  for v in (stacked_fault or {}).values()]
        if not sizes:
            raise ValueError("empty batch: provide stacked_params, "
                             "stacked_fabric and/or stacked_fault")
        if len(set(sizes)) > 1:
            raise ValueError(f"inconsistent batch sizes {sorted(set(sizes))}")
        B = sizes[0]
        base_cc = dict(policy.params, **(cc_params or {}))
        full = {k: np.asarray(stacked_params.get(k, np.full(B, float(v))),
                              np.float32)
                for k, v in base_cc.items()}
        cfg = dataclasses.replace(cfg or self.cfg, queue_stride=0)
        fab = _stack_fabric(_as_fabric(fabric_params, cfg), stacked_fabric, B)
        flt = _stack_fault(_as_fault(fault_spec), stacked_fault, B)
        faulty = is_faulty(flt)
        sim = self.simulator(topo, sched, policy, cfg)
        out, meta = self._dispatch_lanes(sim, full, fab, flt, B)
        F = sim.plan.n_flows
        t_fin = out["t_finish"][:, :F]
        finished = out["done"][:, :F].all(axis=1)
        diverged = out["diverged"]
        batch = BatchResults(
            policy=policy.name, params=full,
            fabric={k: np.asarray(getattr(fab, k))
                    for k in FabricParams.FIELDS},
            completion_time=np.max(np.where(np.isfinite(t_fin), t_fin, 0.0),
                                   axis=1),
            t_finish=t_fin, pause_count=out["pause_count"],
            delivered=out["delivered"][:, :F], soft_cost=out["soft"],
            finished=finished, policy_axis=tuple(policy_axis),
            fault=({k: np.asarray(getattr(flt, k))
                    for k in FaultSpec.FIELDS} if faulty else {}),
            diverged=diverged, deadlock_step=out["deadlock_step"],
            storm_step=out["storm_step"],
            extend_exhausted=~finished & ~diverged,
            lost=out["lost"][:, :F] if faulty else None, meta=meta,
        )
        _warn_unhealthy_lanes(batch, B)
        return batch

    def grid(self, topo, sched, policy: Policy | str | None = None,
             param_grid: dict | None = None,
             fabric_grid: dict | None = None,
             fabric_params: FabricParams | None = None,
             cc_params: dict | None = None,
             cfg: EngineConfig | None = None,
             policy_axis: list | None = None,
             fault_grid: dict | None = None,
             fault_spec: FaultSpec | None = None) -> BatchResults:
        """Full-factorial joint sweep: CC ``{param: [values...]}`` x fabric
        ``{field: [values...]}`` x fault ``{field: [values...]}`` -> one
        batch.  Fabric/fault axes may list scalars or per-class arrays.
        ``policy_axis`` adds the policy as a grid dimension (``policy``
        must then be None and ``param_grid`` keys member-namespaced,
        ``"dcqcn.rai_frac"``)."""
        param_grid = param_grid or {}
        fabric_grid = fabric_grid or {}
        fault_grid = fault_grid or {}
        FaultSpec.check_fields(fault_grid)
        for a, b, what in ((param_grid, fabric_grid, "CC and fabric"),
                           (param_grid, fault_grid, "CC and fault"),
                           (fabric_grid, fault_grid, "fabric and fault")):
            overlap = set(a) & set(b)
            if overlap:
                raise ValueError(f"params {sorted(overlap)} appear in both "
                                 f"the {what} grids")
        labels, wires = (), None
        if policy_axis is not None:
            if policy is not None:
                raise ValueError("pass either policy or policy_axis, "
                                 "not both")
            members = [_resolve(p) for p in policy_axis]
            wires = np.asarray([m.wire_factor for m in members], np.float32)
            policy = stack_policies(members)
            labels = policy.members
            bad = {k for k in param_grid if "." not in k}
            if bad:
                raise ValueError(
                    f"param_grid keys {sorted(bad)} are not member-"
                    "namespaced; with a policy_axis use '<policy>.<param>' "
                    f"(members: {list(labels)})")
        elif policy is None:
            raise ValueError("policy is required without a policy_axis")
        axes = [np.asarray(v, np.float32)
                for v in list(param_grid.values()) + list(fabric_grid.values())
                + list(fault_grid.values())]
        names = list(param_grid) + list(fabric_grid) + list(fault_grid)
        if policy_axis is not None:
            names.append("_which")
            axes.append(np.arange(len(labels), dtype=np.float32))
        if not axes:
            raise ValueError("empty grid")
        # index-space meshgrid so per-class (point, C)-shaped axes
        # enumerate points along axis 0
        idx = np.meshgrid(*[np.arange(len(a)) for a in axes], indexing="ij")
        flat = [i.reshape(-1) for i in idx]
        stacked = {k: axes[j][flat[j]] for j, k in enumerate(names)}
        stacked_cc = {k: stacked[k] for k in names
                      if k not in fabric_grid and k not in fault_grid}
        if wires is not None:
            # the wire factor is paired with the selected member
            stacked_cc["_wire"] = wires[stacked["_which"].astype(np.int64)]
        return self.run_batch(
            topo, sched, policy, stacked_cc,
            stacked_fabric={k: stacked[k] for k in fabric_grid},
            fabric_params=fabric_params, cc_params=cc_params, cfg=cfg,
            policy_axis=labels,
            stacked_fault={k: stacked[k] for k in fault_grid},
            fault_spec=fault_spec)
