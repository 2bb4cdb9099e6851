"""The ``mlp`` trainer (``repro_torch.learn.train``) against the
reference's (``repro.learn.train``) on the CPU: the smoke run's losses
and weights, the fabric corners as lanes of one task, determinism,
checkpoint resume (from the port's own checkpoints and the reference's)
and the non-finite guard.

Losses agree within rtol 1e-5 (measured: equal bit for bit on the smoke
run) and weights within rtol 1e-3 (measured: 1.2e-7 relative after its
2 Adam steps); gradients within rtol 1e-3 (gradient norms: 5.5e-8).
"""
import math
import sys

import numpy as np
import pytest
import torch

import repro.learn.train  # noqa: F401  (the module; the package exports train)
import repro_torch.learn.train  # noqa: F401
from repro.core import engine as reng
from repro.core.scenario import IncastSpec as RIncastSpec
from repro.core.scenario import ScenarioSpec as RScenarioSpec
from repro_torch.core import engine as peng
from repro_torch.core.scenario import IncastSpec, ScenarioSpec
from repro_torch.learn.net import WEIGHT_KEYS

rtr = sys.modules["repro.learn.train"]
ptr = sys.modules["repro_torch.learn.train"]

torch.set_num_threads(1)

SMOKE_CFG = dict(dt=2e-6, max_steps=1200, max_extends=0, queue_stride=0)
_CACHE = {}


def _smoke_task(port: bool, cfg):
    """``train_smoke``'s task: the 8-GPU incast of 7 x 1 MB, one corner,
    remat."""
    if port:
        return ptr.make_task(
            ScenarioSpec(ptr._single(8), IncastSpec(7, 1e6), "mlp",
                         name="smoke_incast8"),
            engine_cfg=peng.EngineConfig(**SMOKE_CFG), corners=(None,),
            remat=True, train_cfg=cfg, device="cpu")
    return rtr.make_task(
        RScenarioSpec(rtr._single(8), RIncastSpec(7, 1e6), "mlp",
                      name="smoke_incast8"),
        engine_cfg=reng.EngineConfig(**SMOKE_CFG), corners=(None,),
        remat=True, train_cfg=cfg)


def _smoke(port: bool, steps: int = 2):
    key = (port, steps)
    if key not in _CACHE:
        mod = ptr if port else rtr
        cfg = mod.TrainConfig(steps=steps, lr=0.08)
        _CACHE[key] = mod.train(cfg, tasks=[_smoke_task(port, cfg)])
    return _CACHE[key]


def _close_runs(got, want, bitwise_losses=False):
    assert len(got.history) == len(want.history)
    for hg, hw in zip(got.history, want.history):
        assert hg["nonfinite"] == hw["nonfinite"]
        if bitwise_losses:
            assert hg["loss"] == hw["loss"]
            assert hg["per_task"] == hw["per_task"]
        np.testing.assert_allclose(hg["loss"], hw["loss"], rtol=1e-5)
        for k, v in hw["per_task"].items():
            np.testing.assert_allclose(hg["per_task"][k], v, rtol=1e-5)
        np.testing.assert_allclose(hg["grad_norm"], hw["grad_norm"],
                                   rtol=1e-3)
    for k in WEIGHT_KEYS:
        np.testing.assert_allclose(got.weights[k], want.weights[k],
                                   rtol=1e-3, err_msg=k)


def test_smoke_run_matches_reference():
    got, want = _smoke(True), _smoke(False)
    _close_runs(got, want, bitwise_losses=True)
    assert got.history[-1]["loss"] < got.history[0]["loss"]
    assert got.baselines == want.baselines


def test_train_smoke_entry_point():
    got = ptr.train_smoke(steps=2, device="cpu")
    want = _smoke(False)
    assert got["loss_first"] == want.history[0]["loss"]
    assert got["loss_last"] == want.history[-1]["loss"]
    assert got["loss_decreased"] and got["nonfinite_steps"] == 0


def test_deterministic_bitwise():
    cfg = ptr.TrainConfig(steps=2, lr=0.08)
    again = ptr.train(cfg, tasks=[_smoke_task(True, cfg)])
    first = _smoke(True)
    assert again.weights == first.weights
    assert [h["loss"] for h in again.history] == \
        [h["loss"] for h in first.history]


def test_resume_bitwise(tmp_path):
    ck = str(tmp_path / "ck.json")
    cfg1 = ptr.TrainConfig(steps=1, lr=0.08)
    ptr.train(cfg1, tasks=[_smoke_task(True, cfg1)], checkpoint_path=ck)
    cfg2 = ptr.TrainConfig(steps=2, lr=0.08)
    resumed = ptr.train(cfg2, tasks=[_smoke_task(True, cfg2)], resume=ck)
    straight = _smoke(True)
    assert resumed.weights == straight.weights
    assert [h["loss"] for h in resumed.history] == \
        [h["loss"] for h in straight.history]


def test_resume_from_reference_checkpoint(tmp_path):
    """A checkpoint the reference wrote resumes in the port: its first
    step's record is kept as written and the second step lands on the
    reference's own two-step weights."""
    ck = str(tmp_path / "ref.json")
    cfg1 = rtr.TrainConfig(steps=1, lr=0.08)
    rtr.train(cfg1, tasks=[_smoke_task(False, cfg1)], checkpoint_path=ck)
    cfg2 = ptr.TrainConfig(steps=2, lr=0.08)
    resumed = ptr.train(cfg2, tasks=[_smoke_task(True, cfg2)], resume=ck)
    want = _smoke(False)
    assert resumed.history[0] == rtr.load_checkpoint(ck)["history"][0]
    _close_runs(resumed, want)


def test_corners_ride_the_lane_axis():
    """``make_task``'s default three fabric corners as three lanes of one
    run: the mean cost and its gradient are the reference's ``vmap``
    over the corners."""
    cfg = dict(dt=2e-6, max_steps=600, max_extends=0, queue_stride=0)
    spec_p = ptr.curriculum_default()[0][0]
    spec_r = rtr.curriculum_default()[0][0]
    task_p = ptr.make_task(spec_p, engine_cfg=peng.EngineConfig(**cfg),
                           device="cpu")
    task_r = rtr.make_task(spec_r, engine_cfg=reng.EngineConfig(**cfg))
    w = {k: np.float32(v) for k, v in rtr.init_weights(0).items()}
    c_p, g_p = task_p.vg(w)
    c_r, g_r = task_r.vg(w)
    np.testing.assert_allclose(c_p, float(c_r), rtol=1e-6)
    assert any(g_p[k] != 0.0 for k in WEIGHT_KEYS)
    for k in WEIGHT_KEYS:
        np.testing.assert_allclose(g_p[k], float(g_r[k]), rtol=1e-3,
                                   atol=1e-12, err_msg=k)


def _quad_task(name="quad", nan_at=None):
    """``tests/test_learn.py``'s quadratic bowl; ``nan_at=k`` poisons the
    k-th evaluation as a diverged simulation would."""
    target = {k: 0.3 * ((i % 5) - 2) for i, k in enumerate(WEIGHT_KEYS)}
    calls = {"n": 0}

    def vg(w):
        calls["n"] += 1
        if nan_at is not None and calls["n"] == nan_at:
            return float("nan"), {k: 0.0 for k in WEIGHT_KEYS}
        cst = sum((float(w[k]) - target[k]) ** 2 for k in WEIGHT_KEYS)
        return cst, {k: 2 * (float(w[k]) - target[k]) for k in WEIGHT_KEYS}

    return ptr.Task(name=name, weight=1.0, vg=vg)


def test_nonfinite_guard_and_seed_check(tmp_path):
    """A poisoned step freezes weights and moments (two poisoned steps ==
    one clean step, bit for bit); a checkpoint of another seed is
    refused; the Adam arithmetic is the reference's, bit for bit."""
    cfg = ptr.TrainConfig(steps=2, lr=0.05, seed=3)
    poisoned = ptr.train(cfg, tasks=[_quad_task(nan_at=2)])
    assert [h["nonfinite"] for h in poisoned.history] == [False, True]
    assert math.isnan(poisoned.history[1]["loss"])
    clean = ptr.train(ptr.TrainConfig(steps=1, lr=0.05, seed=3),
                      tasks=[_quad_task()])
    assert poisoned.weights == clean.weights
    ref = rtr.train(rtr.TrainConfig(steps=1, lr=0.05, seed=3),
                    tasks=[rtr.Task(name="quad", weight=1.0,
                                    vg=_quad_task().vg)])
    assert clean.weights == ref.weights
    ck = str(tmp_path / "ck.json")
    ptr.train(ptr.TrainConfig(steps=1, seed=0), tasks=[_quad_task()],
              checkpoint_path=ck)
    with pytest.raises(ValueError, match="seed"):
        ptr.train(ptr.TrainConfig(steps=2, seed=1), tasks=[_quad_task()],
                  resume=ck)
