"""The port's training path against the JAX reference on the CPU: the
LM batches and the prefetcher, the learning-rate schedule, AdamW (first
step, clipping, the bf16 master copy), ``Model.loss`` and its gradient on
the smoke configs of every trained family, and ``make_train_step`` over
five steps with and without gradient accumulation.  Same numpy weights
and batches through both packages; float32 activations in both unless
a case says bf16."""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.pytree import flatten_with_paths as ref_flatten
from repro.configs import smoke_config as ref_smoke_config
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.data import pipeline as ref_pipeline
from repro.train import optimizer as ref_opt
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch import convert
from repro_torch.common.pytree import flatten_with_paths
from repro_torch.configs.base import TrainConfig
from repro_torch.data import Prefetcher, lm_batch
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import (init_train_state, make_grad_fn,
                                          make_train_step)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _serve_pairs import pair  # noqa: E402

torch.set_num_threads(1)

FAMILIES = ("tinyllama-1.1b", "gemma2-9b", "deepseek-v2-236b",
            "zamba2-1.2b", "rwkv6-3b")


def _tcfg(**kw):
    return TrainConfig(**kw), RefTrainConfig(**kw)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,B,S,V", [(0, 0, 8, 64, 256),
                                             (3, 17, 4, 34, 32000),
                                             (1, 5, 2, 2048, 50)])
def test_lm_batch_equals_reference(seed, step, B, S, V):
    got = lm_batch(seed, step, B, S, V)
    want = ref_pipeline.lm_batch(seed, step, B, S, V)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_prefetcher_in_order_and_closes():
    pf = Prefetcher(lambda s: lm_batch(0, s, 2, 8, 100), start_step=3,
                    depth=2)
    try:
        for step in range(3, 9):
            np.testing.assert_array_equal(
                next(pf)["tokens"],
                ref_pipeline.lm_batch(0, step, 2, 8, 100)["tokens"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


# ---------------------------------------------------------------------------
# the schedule and AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 55, 100, 150])
def test_lr_schedule_matches_reference(step):
    tcfg, rcfg = _tcfg(learning_rate=3e-4, warmup_steps=10, total_steps=100)
    np.testing.assert_allclose(opt.lr_schedule(tcfg, step),
                               float(ref_opt.lr_schedule(rcfg, step)),
                               rtol=1e-6)


def _adamw_pair(params_np, grads_np, tcfg_kw, keep_master, dtype, steps=1):
    tcfg, rcfg = _tcfg(**tcfg_kw)
    rp = jax.tree.map(lambda a: jnp.asarray(a, dtype), params_np)
    rst = ref_opt.init_opt_state(rp, keep_master=keep_master)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    pp = {k: torch.tensor(v).to(tdt) for k, v in params_np.items()}
    st = opt.init_opt_state(pp, keep_master=keep_master)
    for i in range(steps):
        g_np = {k: v * (i + 1) for k, v in grads_np.items()}
        rp, rst, rm = ref_opt.adamw_update(
            rp, jax.tree.map(jnp.asarray, g_np), rst, rcfg)
        pp, st, m = opt.adamw_update(
            pp, {k: torch.as_tensor(v) for k, v in g_np.items()}, st, tcfg)
    return (rp, rst, rm), (pp, st, m)


def _assert_state(ref, port, rtol):
    (rp, rst, rm), (pp, st, m) = ref, port
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(rm["grad_norm"]), rtol=rtol)
    np.testing.assert_allclose(m["lr"], float(rm["lr"]), rtol=rtol)
    assert int(st["count"]) == int(rst["count"])
    for key in [k for k in ("mu", "nu", "master") if k in rst]:
        for (n, a), (n2, b) in zip(ref_flatten(rst[key]),
                                   flatten_with_paths(st[key])):
            assert n == n2
            np.testing.assert_allclose(b.float().numpy(),
                                       np.asarray(a, np.float32), rtol=rtol,
                                       atol=1e-30)
    for (n, a), (n2, b) in zip(ref_flatten(rp), flatten_with_paths(pp)):
        assert n == n2 and str(b.dtype).endswith(str(a.dtype))
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32), rtol=rtol)


def test_adamw_first_step_matches_reference():
    rng = np.random.default_rng(0)
    p = {"w": rng.normal(size=(7, 5)).astype(np.float32),
         "b": rng.normal(size=(5,)).astype(np.float32)}
    g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p.items()}
    ref, port = _adamw_pair(p, g, dict(learning_rate=0.1, weight_decay=0.0,
                                       warmup_steps=1, total_steps=10,
                                       grad_clip=1e9),
                            keep_master=False, dtype=jnp.float32)
    _assert_state(ref, port, rtol=1e-6)
    # bias-corrected Adam's first step is -lr * g / (|g| + eps)
    lr = opt.lr_schedule(TrainConfig(learning_rate=0.1, warmup_steps=1,
                                     total_steps=10), 1)
    np.testing.assert_allclose(port[0]["w"].numpy(),
                               p["w"] - lr * g["w"] / (np.abs(g["w"]) + 1e-8),
                               rtol=1e-5)


def test_adamw_clipping_matches_reference():
    rng = np.random.default_rng(1)
    p = {"a": rng.normal(size=(4, 3)).astype(np.float32),
         "z": {"c": rng.normal(size=(6,)).astype(np.float32)}}
    g = {"a": np.full((4, 3), 100.0, np.float32),
         "z": {"c": rng.normal(size=(6,)).astype(np.float32) * 50}}
    rp = jax.tree.map(jnp.asarray, p)
    rst = ref_opt.init_opt_state(rp, keep_master=False)
    tcfg, rcfg = _tcfg(learning_rate=1.0, weight_decay=0.1, warmup_steps=1,
                       total_steps=10, grad_clip=0.1)
    rp, rst, rm = ref_opt.adamw_update(rp, jax.tree.map(jnp.asarray, g), rst,
                                       rcfg)
    tp = convert.transformer_params_from_numpy(p, device="cpu")
    st = opt.init_opt_state(tp, keep_master=False)
    tp, st, m = opt.adamw_update(
        tp, convert.transformer_params_from_numpy(g, device="cpu"), st, tcfg)
    _assert_state((rp, rst, rm), (tp, st, m), rtol=1e-6)
    assert float(m["grad_norm"]) > 100


def test_adamw_bf16_master_roundtrip_matches_reference():
    rng = np.random.default_rng(2)
    p = {"w": rng.normal(size=(16, 8)).astype(np.float32)}
    g = {"w": (rng.normal(size=(16, 8)) * 1e-3).astype(np.float32)}
    ref, port = _adamw_pair(p, g, dict(learning_rate=1e-3, warmup_steps=1,
                                       total_steps=100),
                            keep_master=True, dtype=jnp.bfloat16, steps=3)
    _assert_state(ref, port, rtol=1e-6)
    pp, st, _ = port
    assert pp["w"].dtype == torch.bfloat16
    assert st["master"]["w"].dtype == torch.float32
    # the master accumulates updates below a bf16 ulp
    assert not torch.equal(st["master"]["w"], pp["w"].float())


def test_adamw_chunks_a_large_leaf(monkeypatch):
    """A leaf of several chunks updates as one: chunking is elementwise."""
    rng = np.random.default_rng(3)
    p = {"t": rng.normal(size=(5, 37)).astype(np.float32)}
    g = {"t": rng.normal(size=(5, 37)).astype(np.float32)}
    tcfg = TrainConfig(learning_rate=0.01, warmup_steps=1, total_steps=10)
    outs = []
    for chunk in (opt.CHUNK, 16):
        monkeypatch.setattr(opt, "CHUNK", chunk)
        tp = {"t": torch.as_tensor(p["t"]).to(torch.bfloat16)}
        st = opt.init_opt_state(tp, keep_master=False)
        tp, st, m = opt.adamw_update(tp, {"t": torch.as_tensor(g["t"])}, st,
                                     tcfg)
        outs.append((tp["t"], st["mu"]["t"], st["nu"]["t"]))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the loss and its gradient
# ---------------------------------------------------------------------------

def _grads_close(ref_grads, grads, tol):
    """Each leaf within ``tol`` of that leaf's largest magnitude."""
    for (n, a), (n2, b) in zip(ref_flatten(ref_grads),
                               flatten_with_paths(grads)):
        assert n == n2
        a = np.asarray(a, np.float32)
        b = b.float().numpy()
        scale = max(float(np.abs(a).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= tol * scale, (n, np.abs(a - b)
                                                           .max(), scale)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grad_match_reference(arch):
    r_model, rp, model, pp = pair(ref_smoke_config(arch), seed=3, f32=True)
    toks = np.random.default_rng(0).integers(0, model.cfg.vocab, (2, 24),
                                             dtype=np.int32)
    batch = {"tokens": toks}
    if arch == "tinyllama-1.1b":
        batch["loss_mask"] = (np.arange(24)[None] % 5 != 0).astype(
            np.float32).repeat(2, 0)
    rl, rg = jax.jit(jax.value_and_grad(r_model.loss))(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = make_grad_fn(model)(pp, batch)
    np.testing.assert_allclose(float(loss), float(rl), rtol=1e-5)
    _grads_close(rg, grads, 1e-4)


def test_sliding_window_past_the_window_trains():
    """Gemma-2's local layers past their window take ``local_attention``,
    whose chunks are written into one output in place: autograd through
    those writes matches the reference's gradient."""
    r_model, rp, model, pp = pair(ref_smoke_config("gemma2-9b"), seed=9,
                                  f32=True)
    assert model.cfg.window == 32
    toks = np.random.default_rng(4).integers(0, model.cfg.vocab, (2, 72),
                                             dtype=np.int32)
    rl, rg = jax.jit(jax.value_and_grad(r_model.loss))(
        rp, {"tokens": jnp.asarray(toks)})
    loss, grads = make_grad_fn(model)(pp, {"tokens": toks})
    np.testing.assert_allclose(float(loss), float(rl), rtol=1e-5)
    _grads_close(rg, grads, 1e-4)


def test_loss_bf16_matches_reference():
    """bf16 activations (the models' default): two frameworks' roundings,
    rtol 2e-2."""
    r_model, rp, model, pp = pair(ref_smoke_config("tinyllama-1.1b"),
                                  seed=4, f32=False)
    toks = np.random.default_rng(1).integers(0, model.cfg.vocab, (2, 32),
                                             dtype=np.int32)
    rl = jax.jit(r_model.loss)(rp, {"tokens": jnp.asarray(toks)})
    loss, grads = make_grad_fn(model)(pp, {"tokens": toks})
    np.testing.assert_allclose(float(loss), float(rl), rtol=2e-2)
    assert all(bool(torch.isfinite(g).all())
               for _, g in flatten_with_paths(grads))


def test_loss_is_the_teacher_forced_cross_entropy():
    """``loss`` is the mean next-token cross-entropy of
    ``prefill(all_logits=True)``'s logits."""
    _, _, model, pp = pair(ref_smoke_config("tinyllama-1.1b"), seed=5,
                           f32=True)
    toks = np.random.default_rng(2).integers(0, model.cfg.vocab, (3, 16),
                                             dtype=np.int32)
    logits, _ = model.prefill(pp, {"tokens": toks}, all_logits=True)
    want = torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, logits.shape[-1]),
        torch.as_tensor(toks[:, 1:]).long().reshape(-1))
    np.testing.assert_allclose(float(model.loss(pp, {"tokens": toks})),
                               float(want), rtol=1e-5)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatch", [None, 2])
def test_train_step_matches_reference(microbatch):
    r_cfg = ref_smoke_config("tinyllama-1.1b")
    r_model, rp, model, pp = pair(r_cfg, seed=6, f32=True)
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10,
              microbatch=microbatch)
    tcfg, rcfg = _tcfg(**kw)
    rst = ref_opt.init_opt_state(rp, keep_master=False)
    st = opt.init_opt_state(pp, keep_master=False)
    r_step = jax.jit(ref_make_train_step(r_model, rcfg))
    step = make_train_step(model, tcfg)
    for i in range(5):
        b = lm_batch(0, i, 4, 32, r_cfg.vocab)
        rp, rst, rm = r_step(rp, rst, {"tokens": jnp.asarray(b["tokens"])})
        pp, st, m = step(pp, st, b)
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-4)
    # Adam's first step is sign-like: a tiny gradient difference flips
    # the +-lr direction of a near-zero entry (tests/test_system.py)
    for (n, a), (_, b) in zip(ref_flatten(rp), flatten_with_paths(pp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=2 * kw["learning_rate"], err_msg=n)


def test_accumulation_equals_whole_batch():
    """The microbatched step's loss and gradient norm equal the whole
    batch's (tests/test_system.py::test_grad_accumulation_equivalent)."""
    _, _, model, pp = pair(ref_smoke_config("tinyllama-1.1b"), seed=7,
                           f32=True)
    b = lm_batch(0, 0, 8, 32, model.cfg.vocab)
    outs = []
    for mb in (None, 2):
        tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1,
                           total_steps=10, microbatch=mb)
        p = convert.transformer_params_from_numpy(
            convert.tree_to_numpy(pp), device="cpu")
        st = opt.init_opt_state(p, keep_master=False)
        _, _, m = make_train_step(model, tcfg)(p, st, b)
        outs.append(m)
    np.testing.assert_allclose(float(outs[0]["loss"]),
                               float(outs[1]["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(outs[0]["grad_norm"]),
                               float(outs[1]["grad_norm"]), rtol=1e-4)


def test_init_train_state_keeps_a_master_for_bf16():
    from repro_torch.configs import smoke_model
    m = smoke_model("tinyllama-1.1b", device="cpu")
    bf16 = dataclasses.replace(m.cfg, param_dtype="bfloat16")
    from repro_torch.models import Model
    for cfg, master in ((m.cfg, False), (bf16, True)):
        params, st = init_train_state(Model(cfg, device="cpu"),
                                      torch.Generator().manual_seed(0),
                                      TrainConfig())
        assert ("master" in st) == master
        assert int(st["count"]) == 0 and st["count"].dtype == torch.int32
        assert all(v.dtype == torch.float32
                   for _, v in flatten_with_paths(st["mu"]))
