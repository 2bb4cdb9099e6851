"""The port's checkpoints and fault-tolerant loop (``checkpoint/ckpt.py``,
``ft/fault_tolerance.py``) and ``python -m repro_torch.launch.train`` on
the CPU: ``tests/test_checkpoint_ft.py``'s contracts on the port, a
checkpoint of either package restored in the other, a restart equal to
an uninterrupted run, and ``launch.train`` learning as
``tests/test_system.py`` asks."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.configs import smoke_model as ref_smoke_model
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.train.train_step import init_train_state as ref_init_train_state
from repro_torch import convert
from repro_torch.checkpoint.ckpt import (AsyncCheckpointer, gc_old,
                                         latest_step, restore, save)
from repro_torch.common.pytree import flatten_with_paths
from repro_torch.configs import smoke_model
from repro_torch.configs.base import TrainConfig
from repro_torch.data import lm_batch
from repro_torch.ft.fault_tolerance import (FailureInjector, RunnerConfig,
                                            StragglerDetector, TrainRunner)
from repro_torch.train.train_step import init_train_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"a": torch.randn(8, 4, generator=g),
            "b": {"c": torch.arange(5, dtype=torch.int32),
                  "d": torch.tensor(3.5)},
            "e": [torch.randn(3, generator=g).to(torch.bfloat16)]}


def _equal_trees(a, b):
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert [n for n, _ in fa] == [n for n, _ in fb]
    for (n, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape, n
        assert torch.equal(x, y), n


def test_roundtrip(tmp_path):
    t = _tree()
    save(str(tmp_path), 7, t, extra_meta={"next_step": 7})
    assert latest_step(str(tmp_path)) == 7
    t2, meta = restore(str(tmp_path), 7, t)
    _equal_trees(t, t2)
    assert meta == {"next_step": 7}
    manifest = json.loads((tmp_path / "step_00000007" / "manifest.json")
                          .read_text())
    assert manifest["leaves"]["e.0"]["dtype"] == "bfloat16"
    assert list(manifest["leaves"]) == ["a", "b.c", "b.d", "e.0"]


def test_atomic_no_tmp_left(tmp_path):
    save(str(tmp_path), 1, _tree())
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    # a half-written step (a crash mid-write) is never the latest
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert latest_step(str(tmp_path)) == 1


def test_gc_keeps_latest(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        save(str(tmp_path), s, t)
    gc_old(str(tmp_path), keep=2)
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path))
    assert steps == [4, 5]


def test_async_checkpointer_copies_before_it_returns(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    t = _tree()
    want = {"a": t["a"].clone()}
    ck.save(3, {"a": t["a"]}, extra_meta={"next_step": 3})
    t["a"].add_(1.0)                  # the caller updates in place at once
    ck.wait()
    t2, meta = restore(str(tmp_path), 3, want)
    assert meta["next_step"] == 3
    _equal_trees(want, t2)


def _ref_state():
    m = ref_smoke_model("tinyllama-1.1b")
    return ref_init_train_state(m, jax.random.PRNGKey(0),
                                RefTrainConfig())


def _port_state():
    m = smoke_model("tinyllama-1.1b", device="cpu")
    return init_train_state(m, torch.Generator().manual_seed(0),
                            TrainConfig())


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    rp, rst = _ref_state()
    rst = dict(rst, count=jnp.asarray(7, jnp.int32))
    ref_ckpt.save(str(tmp_path), 4, (rp, rst), extra_meta={"next_step": 4})
    (pp, st), meta = restore(str(tmp_path), 4, _port_state())
    assert meta["next_step"] == 4
    want = (convert.transformer_params_from_numpy(
        jax.tree.map(np.asarray, rp), "cpu"),
        convert.opt_state_from_numpy(jax.tree.map(np.asarray, rst), "cpu"))
    _equal_trees(want, (pp, st))
    assert int(st["count"]) == 7


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    state = _port_state()
    state[1]["count"] = torch.tensor(5, dtype=torch.int32)
    save(str(tmp_path), 2, state, extra_meta={"next_step": 2})
    (rp, rst), meta = ref_ckpt.restore(str(tmp_path), 2, _ref_state())
    assert meta["next_step"] == 2
    names = [n for n, _ in ref_ckpt.flatten_with_paths((rp, rst))]
    assert names == [n for n, _ in flatten_with_paths(state)]
    for (n, a), (_, b) in zip(ref_ckpt.flatten_with_paths((rp, rst)),
                              flatten_with_paths(state)):
        assert str(b.dtype).endswith(str(a.dtype)), n
        np.testing.assert_array_equal(np.asarray(a, np.float32)
                                      if a.dtype == jnp.bfloat16
                                      else np.asarray(a),
                                      b.float().numpy() if
                                      b.dtype == torch.bfloat16 else
                                      b.numpy(), err_msg=n)


def test_bf16_state_roundtrip(tmp_path):
    """A bf16 model's parameters, float32 master and moments survive."""
    import dataclasses
    from repro_torch.models import Model
    m = smoke_model("tinyllama-1.1b", device="cpu")
    m = Model(dataclasses.replace(m.cfg, param_dtype="bfloat16"),
              device="cpu")
    state = init_train_state(m, torch.Generator().manual_seed(1),
                             TrainConfig())
    assert "master" in state[1]
    save(str(tmp_path), 1, state)
    _equal_trees(state, restore(str(tmp_path), 1, state)[0])


def _mk_runner(tmp_path, fail_at=(), ckpt_every=5):
    m = smoke_model("tinyllama-1.1b", device="cpu")
    tcfg = TrainConfig(learning_rate=5e-3, warmup_steps=2, total_steps=30)
    params, opt = init_train_state(m, torch.Generator().manual_seed(0), tcfg)
    step = make_train_step(m, tcfg)

    def make_batch(s):
        return lm_batch(0, s, 4, 32, m.cfg.vocab)

    runner = TrainRunner(RunnerConfig(str(tmp_path),
                                      checkpoint_every=ckpt_every),
                         step, make_batch, injector=FailureInjector(fail_at))
    return runner, params, opt


def test_restart_recovers_and_matches_uninterrupted(tmp_path):
    ra, pa, oa = _mk_runner(tmp_path / "a")
    pa, oa = ra.run(pa, oa, 14)
    rb, pb, ob = _mk_runner(tmp_path / "b", fail_at=(12,))
    pb, ob = rb.run(pb, ob, 14)
    assert rb.restarts == 1 and ra.restarts == 0
    # deterministic data + restart => the same state and log, bit for bit
    _equal_trees((pa, oa), (pb, ob))
    strip = [{k: v for k, v in m.items() if k != "dt"} for m in ra.metrics_log]
    log_b = [{k: v for k, v in m.items() if k != "dt"} for m in rb.metrics_log]
    assert log_b[:12] == strip[:12]
    assert log_b[12:] == strip[10:]          # steps 10, 11 ran twice


def test_straggler_detector_flags_slow_steps():
    det = StragglerDetector(window=20, z_threshold=3.0, patience=2)
    for i in range(30):
        det.observe(i, 0.1 + 0.001 * (i % 3))
    for i in range(30, 34):
        det.observe(i, 1.5)  # sustained straggler
    assert det.flagged, "sustained slow steps must be flagged"


def test_straggler_detector_ignores_one_off():
    det = StragglerDetector(window=20, z_threshold=3.0, patience=3)
    for i in range(25):
        det.observe(i, 0.1)
    det.observe(25, 2.0)  # single spike (e.g. checkpoint write)
    for i in range(26, 30):
        det.observe(i, 0.1)
    assert not det.flagged


def _train_cli(tmp_path, name, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = tmp_path / f"{name}.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--smoke", "--ckpt-dir", str(tmp_path / name), "--metrics-out",
         str(out), *args], capture_output=True, text=True, env=env,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    line = proc.stdout.strip().splitlines()[-1]
    fields = dict(kv.split("=") for kv in line.split())
    return fields, [json.loads(x) for x in out.read_text().splitlines()]


def test_launch_train_lm_learns_and_resumes(tmp_path):
    """40 steps at lr 1e-2 learn (tests/test_system.py); with --fail-at
    the run restarts once and its log ends on the uninterrupted run's."""
    args = ("--arch", "tinyllama-1.1b", "--steps", "40", "--seq", "64",
            "--ckpt-every", "10")
    full, log = _train_cli(tmp_path, "lm", *args)
    assert full["restarts"] == "0" and full["steps"] == "40"
    assert float(full["last_loss"]) < float(full["first_loss"]) - 0.4
    cut, log_cut = _train_cli(tmp_path, "lm_cut", *args, "--fail-at", "25")
    assert cut["restarts"] == "1" and cut["steps"] == "45"
    assert log_cut[:25] + log_cut[30:] == log       # steps 20-24 ran twice


def test_launch_train_dlrm_learns(tmp_path):
    fields, log = _train_cli(tmp_path, "dlrm", "--arch", "dlrm", "--steps",
                             "60", "--batch", "64", "--lr", "3e-3")
    assert fields["steps"] == "60"
    assert float(fields["last_loss"]) < 0.65       # below chance (0.693)


def test_launch_train_builds_on_the_card_by_default():
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--smoke", "--steps", "1"])
