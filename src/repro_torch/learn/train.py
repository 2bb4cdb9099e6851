"""Train the ``mlp`` CC policy end to end through the fluid simulator
(port of ``repro.learn.train``).

The objective is the engine's differentiable soft cost (the integral of
the undelivered traffic fraction, ``Simulator.soft_cost_fn``), summed over
a curriculum of ``ScenarioSpec``s spanning topologies, fault regimes
(``FaultSpec``) and fabric corners (``FabricParams``): each scenario's
cost is averaged over its fabric corners, which ride the simulator's lane
axis (the reference's ``vmap``), and normalized by its initial-weights
baseline so no single scenario dominates the gradient.

Mechanics, as in the reference:

* Adam with global-norm gradient clipping, weights projected onto the
  declared ``ParamSpec`` bounds after every step;
* the rematerialized backward pass (``soft_cost_fn(remat=True)``): one
  carry per ``chunk_steps`` steps instead of every step's activations;
* non-finite guard: a NaN/inf loss or gradient freezes that step (no
  weight or optimizer update) and is recorded in
  ``history[i]["nonfinite"]``;
* deterministic: seeded numpy init and float64 Python-scalar optimizer
  arithmetic, so two same-seed runs on the CPU give the same weights bit
  for bit (on the card the backward's scatter-adds use atomics, so the
  last bits of a gradient may differ between runs), and a checkpoint
  (JSON, the reference's format: float64 reprs round-trip exactly)
  resumes bit for bit, the reference's checkpoints included.

The gradients run on the simulator's op path, on the card by default.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time

import numpy as np
import torch

from repro_torch.core import cc as cc_mod
from repro_torch.core.arith import row_sum
from repro_torch.core.engine import (EngineConfig, FabricParams, Simulator,
                                     _as_fabric)
from repro_torch.core.faults import FaultSpec
from repro_torch.core.scenario import (CollectiveSpec, FabricSpec, IncastSpec,
                                       ScenarioSpec)
from repro_torch.learn.net import WEIGHT_KEYS, init_weights, make_mlp


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 80
    lr: float = 0.05
    clip_norm: float = 1.0          # global grad-norm clip
    seed: int = 0
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    remat: bool = True
    out_gain: float = 1.0           # fixed (non-trained) policy knobs
    loss_cut: float = 1.0


@dataclasses.dataclass
class LearnResult:
    weights: dict                   # trained weight params (floats)
    history: list                   # one record per Adam step
    baselines: dict                 # per-task initial-weights cost
    baseline_loss: float            # normalized total at step 0 (= ~1/task)
    final_loss: float
    wall_s: float = 0.0             # cumulative train wall across resumes


# fabric corners every curriculum scenario is averaged over: the default
# tuning, an aggressive early-marking ECN ramp, and a tight PFC threshold
DEFAULT_CORNERS = (None,
                   {"kmin": 100e3, "kmax": 400e3},
                   {"xoff": 0.5e6})


def default_engine_cfg() -> EngineConfig:
    """Short-horizon training config (the autotune operating point):
    2.5k steps at 2us resolve the small curriculum fabrics end to end."""
    return EngineConfig(dt=2e-6, max_steps=2500, max_extends=0,
                        queue_stride=0)


def _single(n):
    return FabricSpec(family="single", n_racks=1, nodes_per_rack=1,
                      gpus_per_node=n)


def _clos(n_racks, nodes_per_rack=1):
    return FabricSpec(family="clos", n_racks=n_racks,
                      nodes_per_rack=nodes_per_rack, gpus_per_node=8,
                      oversubscription=2.0)


def curriculum_default() -> list:
    """(spec, weight) pairs: incast (the paper's Fig-3 microbenchmark),
    a CLOS ring all-reduce, and a lossy-RoCE/IRN incast."""
    return [
        (ScenarioSpec(_single(8), IncastSpec(7, 2e6), "mlp",
                      name="incast8"), 1.0),
        (ScenarioSpec(_clos(2), CollectiveSpec("ring", 8e6, n_chunks=2),
                      "mlp", name="ring16"), 1.0),
        (ScenarioSpec(_single(8), IncastSpec(7, 2e6), "mlp",
                      fault_spec=FaultSpec.lossy_roce(1e-3, "irn"),
                      name="incast8_lossy_irn"), 0.5),
    ]


def heldout_default() -> list:
    """Held-out ScenarioSpecs: topology scales and a fault regime
    (go-back-N recovery) the default curriculum never sees."""
    return [
        ScenarioSpec(_single(16), IncastSpec(15, 2e6), "mlp",
                     name="heldout_incast16"),
        ScenarioSpec(_clos(2, nodes_per_rack=2),
                     CollectiveSpec("ring", 16e6, n_chunks=2), "mlp",
                     name="heldout_ring32"),
        ScenarioSpec(_single(8), IncastSpec(7, 2e6), "mlp",
                     fault_spec=FaultSpec.lossy_roce(1e-3, "gbn"),
                     name="heldout_incast8_lossy_gbn"),
    ]


@dataclasses.dataclass
class Task:
    """One curriculum entry: ``vg(weights) -> (cost, grads)``, floats."""
    name: str
    weight: float
    vg: object


def make_task(spec: ScenarioSpec, weight: float = 1.0,
              engine_cfg: EngineConfig | None = None,
              corners: tuple = DEFAULT_CORNERS, remat: bool = True,
              train_cfg: TrainConfig = TrainConfig(),
              device="cuda") -> Task:
    """One scenario as ``weights -> (mean-corner cost, grad)``.

    The fabric corners are the lanes of one simulation (stacked
    ``FabricParams`` leaves), so a task costs one run however many
    corners it has.
    """
    engine_cfg = engine_cfg or default_engine_cfg()
    topo, sched, _ = spec.build()
    policy = make_mlp(weights=init_weights(train_cfg.seed),
                      out_gain=train_cfg.out_gain,
                      loss_cut=train_cfg.loss_cut)
    sim = Simulator(topo, sched, policy, engine_cfg,
                    fabric_params=spec.fabric_params,
                    fault_spec=spec.fault_spec, device=device)
    cost = sim.soft_cost_fn(remat=remat, lanes=len(corners))
    base_fab = _as_fabric(spec.fabric_params, engine_cfg)
    fabs = [base_fab.replace(**c) if c else base_fab for c in corners]
    stacked = FabricParams(**{
        f: np.stack([np.asarray(getattr(fb, f), np.float32) for fb in fabs])
        for f in FabricParams.FIELDS})
    base_params = dict(policy.params)

    def vg(wts):
        w = {k: torch.tensor(np.float32(wts[k]), device=sim.device,
                             requires_grad=True) for k in WEIGHT_KEYS}
        costs = cost(dict(base_params, **w), stacked)
        # jnp.mean: the lanes summed in order, then divided by their count
        loss = row_sum(costs) / len(corners)
        grads = torch.autograd.grad(loss, list(w.values()),
                                    allow_unused=True, materialize_grads=True)
        return float(loss.detach()), {k: float(g)
                                      for k, g in zip(w, grads)}

    name = spec.name or f"{topo.name}_{sched.n_flows}f"
    return Task(name=name, weight=float(weight), vg=vg)


# ---------------------------------------------------------------------------
# checkpointing (JSON: float64 repr round-trips exactly)
# ---------------------------------------------------------------------------

def save_checkpoint(path: str, state: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(state, f, indent=1)


def load_checkpoint(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def train(cfg: TrainConfig = TrainConfig(), curriculum: list | None = None,
          tasks: list | None = None,
          engine_cfg: EngineConfig | None = None,
          resume: str | dict | None = None,
          checkpoint_path: str | None = None,
          verbose: bool = False, device="cuda") -> LearnResult:
    """Adam on the curriculum's normalized total soft cost.

    ``curriculum`` is a list of ``(ScenarioSpec, weight)`` (default:
    ``curriculum_default()``), simulated on ``device``; ``tasks``
    bypasses spec compilation with prebuilt ``Task``s.  ``resume`` is a
    checkpoint path or dict: training continues bit for bit from its
    step and optimizer state.  ``checkpoint_path`` saves resumable state
    after every step.
    """
    if tasks is None:
        curriculum = curriculum if curriculum is not None \
            else curriculum_default()
        tasks = [make_task(spec, weight=w, engine_cfg=engine_cfg,
                           remat=cfg.remat, train_cfg=cfg, device=device)
                 for spec, w in curriculum]

    if resume is not None:
        ck = load_checkpoint(resume) if isinstance(resume, str) else resume
        if int(ck["seed"]) != cfg.seed:
            raise ValueError(f"checkpoint seed {ck['seed']} != config "
                             f"seed {cfg.seed}")
        wts = {k: float(v) for k, v in ck["weights"].items()}
        m = {k: float(v) for k, v in ck["m"].items()}
        v = {k: float(v) for k, v in ck["v"].items()}
        step0 = int(ck["step"])
        history = list(ck["history"])
        baselines = {k: float(b) for k, b in ck["baselines"].items()}
        wall0 = float(ck.get("wall_s", 0.0))
    else:
        wts = init_weights(cfg.seed)
        m = {k: 0.0 for k in WEIGHT_KEYS}
        v = {k: 0.0 for k in WEIGHT_KEYS}
        step0, history, baselines, wall0 = 0, [], {}, 0.0

    bound = 8.0

    def project(w):
        return {k: float(np.clip(x, -bound, bound)) for k, x in w.items()}

    wts = project(wts)
    t_start = time.time()
    for i in range(step0, cfg.steps):
        per_task, grad = {}, {k: 0.0 for k in WEIGHT_KEYS}
        finite = True
        for task in tasks:
            c, g = task.vg({k: np.float32(wts[k]) for k in WEIGHT_KEYS})
            c = float(c)
            per_task[task.name] = c
            if task.name not in baselines:
                # frozen per-task normalizer from the first evaluation
                baselines[task.name] = max(abs(c), 1e-12) \
                    if math.isfinite(c) else 1.0
            scale = task.weight / baselines[task.name]
            finite &= math.isfinite(c)
            for k in WEIGHT_KEYS:
                gk = float(g[k])
                finite &= math.isfinite(gk)
                grad[k] += scale * gk
        total = sum(task.weight * per_task[task.name]
                    / baselines[task.name] for task in tasks)
        gnorm = math.sqrt(sum(x * x for x in grad.values())) \
            if finite else float("nan")
        rec = {"step": i, "loss": total if finite else float("nan"),
               "per_task": per_task, "grad_norm": gnorm,
               "nonfinite": not finite}
        if finite:
            # global-norm clip -> Adam -> projection onto ParamSpec bounds
            cscale = min(1.0, cfg.clip_norm / max(gnorm, 1e-12))
            rec["clipped"] = cscale < 1.0
            t = i + 1
            for k in WEIGHT_KEYS:
                gk = grad[k] * cscale
                m[k] = cfg.beta1 * m[k] + (1 - cfg.beta1) * gk
                v[k] = cfg.beta2 * v[k] + (1 - cfg.beta2) * gk * gk
                mh = m[k] / (1 - cfg.beta1 ** t)
                vh = v[k] / (1 - cfg.beta2 ** t)
                wts[k] = wts[k] - cfg.lr * mh / (math.sqrt(vh) + cfg.eps)
            wts = project(wts)
        # non-finite steps leave weights AND optimizer moments untouched,
        # exactly as autotune freezes its non-finite members
        history.append(rec)
        if verbose:
            print(f"step {i:3d} loss {rec['loss']:.5f} "
                  f"|g| {gnorm:.3g}{' NONFINITE' if not finite else ''}",
                  flush=True)
        if checkpoint_path:
            save_checkpoint(checkpoint_path, {
                "seed": cfg.seed, "step": i + 1, "weights": wts,
                "m": m, "v": v, "history": history,
                "baselines": baselines,
                "wall_s": round(wall0 + time.time() - t_start, 2)})
    wall = wall0 + time.time() - t_start
    fin = [h["loss"] for h in history if math.isfinite(h["loss"])]
    res = LearnResult(weights=dict(wts), history=history,
                      baselines=dict(baselines),
                      baseline_loss=fin[0] if fin else float("nan"),
                      final_loss=fin[-1] if fin else float("nan"),
                      wall_s=round(wall, 2))
    if history:
        history[-1]["wall_s_total"] = round(wall, 2)
    return res


def train_smoke(steps: int = 5, device="cuda") -> dict:
    """Tiny single-scenario training loop: the loss trajectory and the
    measured Adam steps/s."""
    cfg = TrainConfig(steps=steps, lr=0.08)
    engine_cfg = EngineConfig(dt=2e-6, max_steps=1200, max_extends=0,
                              queue_stride=0)
    spec = ScenarioSpec(_single(8), IncastSpec(7, 1e6), "mlp",
                        name="smoke_incast8")
    task = make_task(spec, engine_cfg=engine_cfg, corners=(None,),
                     remat=True, train_cfg=cfg, device=device)
    t0 = time.time()
    res = train(cfg, tasks=[task])
    wall = time.time() - t0
    losses = [h["loss"] for h in res.history]
    return {"steps": steps, "loss_first": losses[0], "loss_last": losses[-1],
            "loss_decreased": bool(losses[-1] < losses[0]),
            "nonfinite_steps": sum(h["nonfinite"] for h in res.history),
            "steps_per_s": round(steps / wall, 3),
            "wall_s": round(wall, 2)}


# ---------------------------------------------------------------------------
# held-out evaluation: the trained policy vs every classical policy
# ---------------------------------------------------------------------------

def heldout_eval(specs: list | None = None, runner=None,
                 engine_cfg: EngineConfig | None = None,
                 cc_overrides: dict | None = None, device="cuda") -> dict:
    """Evaluate the registered ``mlp`` (trained default weights, or
    ``cc_overrides``) against every classical policy on held-out specs
    via ``run_policy_axis``: one batch per scenario.

    Returns per-scenario completion times plus the acceptance margins:
    ``vs_best_pct`` (mlp over the best classical, negative = mlp faster)
    and ``vs_worst_pct`` (mlp under the worst classical).
    """
    from repro_torch.core.sweep import SweepRunner
    specs = specs if specs is not None else heldout_default()
    engine_cfg = engine_cfg or EngineConfig(dt=2e-6, max_steps=4000,
                                            max_extends=4, queue_stride=0)
    runner = runner or SweepRunner(engine_cfg, device=device)
    pols = list(cc_mod.ALL_POLICIES)
    i_mlp = pols.index("mlp")
    overrides = [cc_overrides if p == "mlp" else None for p in pols] \
        if cc_overrides else None
    out = {"scenarios": [], "policies": pols}
    for spec in specs:
        topo, sched, _ = spec.build()
        batch = runner.run_policy_axis(
            topo, sched, pols, cc_overrides=overrides, cfg=engine_cfg,
            fabric_params=spec.fabric_params, fault_spec=spec.fault_spec)
        ct = {p: float(batch.completion_time[j]) for j, p in enumerate(pols)}
        status = batch.lane_status()
        classical = {p: ct[p] for j, p in enumerate(pols)
                     if p != "mlp" and status[j] == "ok"}
        best = min(classical, key=classical.get)
        worst = max(classical, key=classical.get)
        rec = {
            "scenario": spec.name, "completion_ms":
                {p: round(t * 1e3, 4) for p, t in ct.items()},
            "lane_status": {p: status[j] for j, p in enumerate(pols)},
            "best_classical": best, "worst_classical": worst,
            "vs_best_pct": round((ct["mlp"] / classical[best] - 1) * 100, 2),
            "vs_worst_pct": round((ct["mlp"] / classical[worst] - 1) * 100,
                                  2),
            "mlp_ok": status[i_mlp] == "ok",
        }
        rec["within_5pct_of_best"] = rec["vs_best_pct"] <= 5.0
        rec["beats_worst"] = ct["mlp"] < classical[worst]
        out["scenarios"].append(rec)
    out["all_within_5pct_of_best"] = all(r["within_5pct_of_best"]
                                         for r in out["scenarios"])
    out["all_beat_worst"] = all(r["beats_worst"] for r in out["scenarios"])
    return out
