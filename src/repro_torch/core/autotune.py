"""Gradient-descent tuning of CC and fabric parameters through the
simulator (port of ``repro.core.autotune``).

The soft cost (the integral of the undelivered fraction,
``Simulator.soft_cost_fn``) is differentiable w.r.t. the CC policy's
parameters and the fabric's ECN/PFC knobs (``FabricParams``), so they are
tuned by gradient descent instead of a grid search.  Each tuned key's
``ParamSpec`` (``Policy.spec``, ``engine.FABRIC_PARAM_SPECS`` for
``fabric.<field>`` keys) decides how it moves:

* ``scale="log"``    -> descent in log space, ``scale="linear"`` -> in
  value space;
* ``lo``/``hi``      -> every member is projected onto the bounds after
  every step, and each projection is recorded in
  ``TuneResult.history[i]["projected"]``;
* ``integer=True``   -> rejected: sweep count-valued params instead
  (``SweepRunner.grid``).

A population of P members rides the simulator's lane axis: one batched
value and gradient per step (``soft_cost_fn(lanes=P)``), the reference's
``vmap``.  Member 0 starts at the defaults, the others at seeded offsets
in z-space; each step takes a clipped gradient step per member, and a
member whose cost or gradient is not finite takes none and is never
chosen as the best.  Host-side bookkeeping follows the reference's
float32/float64 arithmetic, so the history is the reference's wherever
the decoded values and the gradients agree.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.arith import expf
from repro_torch.core.cc import ParamSpec, Policy
from repro_torch.core.engine import (FABRIC_PARAM_SPECS, EngineConfig,
                                     FabricParams, Simulator, _as_fabric)


@dataclasses.dataclass
class TuneResult:
    params: dict
    history: list
    baseline_cost: float
    tuned_cost: float
    fabric: FabricParams | None = None   # tuned fabric (when fabric_keys set)


_FABRIC_NS = "fabric."


def _tune_spec(policy: Policy, key: str) -> ParamSpec:
    """ParamSpec of one tuned key (CC param or ``fabric.<field>``)."""
    if key.startswith(_FABRIC_NS):
        return FABRIC_PARAM_SPECS[key[len(_FABRIC_NS):]]
    return policy.param_spec(key)


def _check_tunable_by_gradient(policy: Policy, keys) -> None:
    ints = [k for k in keys if _tune_spec(policy, k).integer]
    if ints:
        raise ValueError(
            f"params {sorted(ints)} are integer-valued; gradient autotune "
            "cannot tune them as continuous floats — sweep them instead "
            "(SweepRunner.grid / grid_from_spec)")


def autotune(topo, sched, policy: Policy, tune_keys: list[str],
             steps: int = 12, lr: float = 0.15,
             cfg: EngineConfig | None = None,
             population: int = 1, spread: float = 0.4,
             fabric_params: FabricParams | None = None,
             fabric_keys: list[str] | None = None,
             cc_params: dict | None = None, device="cuda") -> TuneResult:
    """Gradient-descend the selected params of ``policy`` along their
    declared ``ParamSpec`` scales, projecting onto declared bounds.

    ``population`` > 1 tunes that many jittered members as lanes of one
    simulation per step; the best member wins.  ``fabric_keys`` also
    tunes the named scalar ``FabricParams`` fields (e.g. ``["kmin",
    "xoff"]``).  ``cc_params`` overrides the policy defaults for the
    untuned starting point.  Runs on ``device`` (the card by default)
    through the simulator's op path (``Simulator.soft_cost_fn``).
    """
    policy.check_tunable(tune_keys)
    if cc_params:
        policy.check_tunable(cc_params)
    fabric_keys = list(fabric_keys or [])
    FabricParams.check_fields(fabric_keys)
    all_keys = list(tune_keys) + [_FABRIC_NS + k for k in fabric_keys]
    _check_tunable_by_gradient(policy, all_keys)
    specs = {k: _tune_spec(policy, k) for k in all_keys}
    cfg = cfg or EngineConfig(dt=2e-6, max_steps=2500, max_extends=0,
                              queue_stride=0)
    P = max(int(population), 1)
    sim = Simulator(topo, sched, policy, cfg, fabric_params=fabric_params,
                    device=device)
    cost_of_params = sim.soft_cost_fn(lanes=P)
    dev = sim.device

    base = dict(policy.params, **(cc_params or {}))
    base_fab = _as_fabric(fabric_params, cfg)
    for k in fabric_keys:
        if np.asarray(getattr(base_fab, k)).ndim > 0:
            raise ValueError(
                f"fabric param {k!r} holds a per-link-class array; autotune "
                "tunes scalar fabric leaves only — tune a scalar base and "
                "apply with_class afterwards")

    # z-space: log for scale="log" keys (exp as the reference's compiled
    # code evaluates it, arith.expf), identity for linear ones
    def decode(k, z: torch.Tensor) -> torch.Tensor:
        return expf(z) if specs[k].scale == "log" else z

    def decode_np(k, z) -> np.ndarray:
        return decode(k, torch.as_tensor(np.asarray(z, np.float32))).numpy()

    def encode(k, v):
        return np.log(v) if specs[k].scale == "log" else float(v)

    def start_val(k):
        if k.startswith(_FABRIC_NS):
            return float(np.asarray(getattr(base_fab, k[len(_FABRIC_NS):])))
        return float(base[k])

    def project(zp):
        """Clip every member onto the declared bounds; -> (zp, clamped
        key list).  Projection happens in value space, so log- and
        linear-scale keys share one code path."""
        out, clamped = {}, []
        for k, z in zp.items():
            v = decode_np(k, z)
            lo, hi = specs[k].lo, specs[k].hi
            vc = np.clip(v, -np.inf if lo is None else lo,
                         np.inf if hi is None else hi)
            if not np.array_equal(v, vc):
                clamped.append(k)
            out[k] = np.asarray([encode(k, x) for x in vc], np.float32)
        return out, clamped

    # the untuned fabric leaves, stacked once for the P lanes
    fab_lanes = {f: np.broadcast_to(np.asarray(getattr(base_fab, f),
                                               np.float32),
                                    (P,) + np.shape(getattr(base_fab, f)))
                 for f in FabricParams.FIELDS}

    def vg(zp):
        """Every member's cost and z-gradients in one batched run."""
        z = {k: torch.tensor(v, device=dev, requires_grad=True)
             for k, v in zp.items()}
        params = dict(base)
        fab = dict(fab_lanes)
        for k, zk in z.items():
            v = decode(k, zk)
            if k.startswith(_FABRIC_NS):
                fab[k[len(_FABRIC_NS):]] = v
            else:
                params[k] = v
        c = cost_of_params(params, FabricParams(**fab))
        if not z:
            return c.detach().cpu().numpy(), {}
        g = torch.autograd.grad(c.sum(), list(z.values()),
                                allow_unused=True, materialize_grads=True)
        return (c.detach().cpu().numpy(),
                {k: gk.cpu().numpy() for k, gk in zip(z, g)})

    # deterministic z-space jitter; member 0 sits exactly at the defaults
    rng = np.random.default_rng(0)
    offs = np.zeros((P, len(all_keys)), np.float32)
    if P > 1:
        offs[1:] = rng.uniform(-spread, spread, size=(P - 1, len(all_keys)))
    zp = {}
    for i, k in enumerate(all_keys):
        z0 = encode(k, start_val(k))
        if specs[k].scale == "log":
            # a float64 start plus float32 offsets, rounded once
            zp[k] = (np.float64(z0) + offs[:, i].astype(np.float64)) \
                .astype(np.float32)
        else:
            # linear-scale offsets move relative to the param's range
            span = specs[k].hi - specs[k].lo if specs[k].bounded else 1.0
            zp[k] = np.float32(z0) + offs[:, i] * np.float32(span)
    zp, _ = project(zp)           # initial population inside bounds

    hist = []
    baseline = None
    best, best_z = np.inf, None

    def snapshot(i, c, projected, bad):
        j = int(np.argmin(c))
        hist.append({"step": i, "cost": float(c[j]),
                     "population_costs": [float(x) for x in c],
                     "projected": sorted(projected),
                     "nonfinite_members": [int(m) for m in bad],
                     **{k: float(decode_np(k, v)[j]) for k, v in zp.items()}})
        return j

    projected_now: list = []
    for i in range(steps):
        c, g = vg(zp)
        # non-finite guard: a NaN/inf cost or gradient (diverged lane,
        # pathological params) freezes that member this step and is never
        # selected as best
        m_ok = np.isfinite(c)
        for k in g:
            m_ok &= np.all(np.isfinite(g[k]).reshape(P, -1), axis=1)
        bad = np.flatnonzero(~m_ok)
        c = np.where(m_ok, c, np.inf)
        if i == 0:
            baseline = float(c[0])
        j = snapshot(i, c, projected_now, bad)
        if c[j] < best:
            best = float(c[j])
            best_z = {k: float(v[j]) for k, v in zp.items()}
        # clipped-gradient step, every member in parallel, then projection;
        # non-finite members take a zero step (their params stay put)
        gn = {k: np.where(m_ok, np.clip(g[k], np.float32(-10),
                                        np.float32(10)), np.float32(0))
              for k in g}
        zp = {k: zp[k] - np.float32(lr) * gn[k] for k in zp}
        zp, projected_now = project(zp)
    if best_z is None:                       # steps == 0: evaluate once
        c = vg(zp)[0]
        bad = np.flatnonzero(~np.isfinite(c))
        c = np.where(np.isfinite(c), c, np.inf)
        j = snapshot(0, c, [], bad)
        baseline, best = float(c[0]), float(c[j])
        best_z = {k: float(v[j]) for k, v in zp.items()}

    def best_val(k):
        return float(decode_np(k, best_z[k]))

    tuned = {k: best_val(k) for k in best_z if not k.startswith(_FABRIC_NS)}
    tuned_fab = None
    if fabric_keys:
        tuned_fab = base_fab.replace(
            **{k[len(_FABRIC_NS):]: best_val(k)
               for k in best_z if k.startswith(_FABRIC_NS)})
    return TuneResult(params=dict(base, **tuned), history=hist,
                      baseline_cost=baseline, tuned_cost=best,
                      fabric=tuned_fab)


def autotune_spec(spec, tune_keys: list[str], **kw) -> TuneResult:
    """Declarative entry: tune a ``ScenarioSpec``'s policy (and optionally
    fabric) in place of the (topo, sched, policy) triple."""
    topo, sched, policy = spec.build()
    kw.setdefault("fabric_params", spec.fabric_params)
    kw.setdefault("cc_params", spec.cc_params)
    return autotune(topo, sched, policy, tune_keys, **kw)
