"""The trainable DLRM on the CPU: the bags' plain backward against
``jax.grad`` of the reference's jnp bags, the DLRM smoke's loss gradient
and train steps against the reference's, the kernel wrappers' CPU
dispatch and order (the sums the CUDA kernel adds, one value a row a
pass), and the DLRM learning through ``make_train_step``.

Tolerances: the reference's scatter-add rounds every add in bf16 where
the port sums in float32 and rounds once: a row named once or twice lies
within one bf16 ulp of its scale, a row named n times within (n - 1) / 2
ulps of its absolute mass (the bound of n - 1 rounded adds).  Whole-model
gradients and losses: rtol 2e-2 + atol 2e-3 of each leaf's scale, the
slack of bf16 activations through the MLPs (``tests/test_torch_dlrm.py``'s
logits)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.pytree import flatten_with_paths as ref_flatten
from repro.configs import smoke_config as r_smoke_config
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.data.pipeline import dlrm_batch as r_dlrm_batch
from repro.models.dlrm import DLRM as RDLRM
from repro.train.train_step import (init_train_state as r_init_train_state,
                                    make_train_step as r_make_train_step)
from repro_torch import convert
from repro_torch.common.pytree import flatten_with_paths
from repro_torch.configs.base import TrainConfig
from repro_torch.data import dlrm_batch
from repro_torch.kernels.embedding_bag import ops, ref
from repro_torch.models import DLRM, DLRMConfig
from repro_torch.train.train_step import (init_train_state, make_grad_fn,
                                          make_train_step)

RTOL, ATOL = 2e-2, 2e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(r_cfg) -> DLRMConfig:
    return DLRMConfig(**{f.name: getattr(r_cfg, f.name)
                         for f in dataclasses.fields(r_cfg)
                         if f.name != "use_pallas_embedding"})


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The bf16 ulp at |x| (the spacing of bf16 values there)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return np.exp2(e - 7)


def _ref_bags_grad(tables_f32, idx, dpooled):
    """``jax.grad`` of the reference's jnp bags in bf16."""
    def pooled(tab):
        return RDLRM(r_smoke_config("dlrm"))._embed_bags(tab, idx)
    tab = jnp.asarray(tables_f32, jnp.bfloat16)
    _, vjp = jax.vjp(pooled, tab)
    return np.asarray(vjp(jnp.asarray(dpooled, jnp.bfloat16))[0], np.float32)


@pytest.mark.parametrize("T,R,D,B,P", [(4, 100, 8, 64, 5),
                                       (3, 7, 16, 9, 13),
                                       (2, 1000, 64, 16, 60)])
def test_plain_backward_matches_jax_grad(T, R, D, B, P):
    rng = np.random.default_rng(T + R)
    tables = rng.normal(size=(T, R, D)).astype(np.float32)
    idx = rng.integers(0, R, (B, T, P), dtype=np.int32)
    dpooled = rng.normal(size=(B, T, D)).astype(np.float32)
    want = _ref_bags_grad(tables, jnp.asarray(idx), dpooled)
    dp = torch.tensor(dpooled).to(torch.bfloat16)
    got = ref.embedding_bag_stacked_backward_ref(dp, torch.tensor(idx), R,
                                                 torch.bfloat16)
    assert got.shape == (T, R, D) and got.dtype == torch.bfloat16
    got = got.float().numpy()
    # untouched rows are exactly zero in both
    touched = np.zeros((T, R), bool)
    for t in range(T):
        touched[t, np.unique(idx[:, t])] = True
    assert not got[~touched].any() and not want[~touched].any()
    # the port: the exact sums of the bf16 dpooled, rounded once
    vals = np.repeat(dp.float().numpy().reshape(B * T, D), P, axis=0)
    rows = (idx + np.arange(T)[None, :, None] * R).reshape(-1)
    exact, mass = np.zeros((T * R, D)), np.zeros((T * R, D))
    np.add.at(exact, rows, vals)
    np.add.at(mass, rows, np.abs(vals))
    np.testing.assert_allclose(got.reshape(T * R, D), exact, rtol=2 ** -8,
                               atol=0)
    # the reference rounds each of a row's n - 1 adds to bf16: within
    # (n - 1) / 2 ulps of the row's absolute mass, plus the port's own
    # half ulp; a row named once or twice within one ulp of its scale
    n = np.bincount(rows, minlength=T * R).reshape(T, R, 1)
    err = np.abs(got - want)
    bound = ((n - 1) / 2 * _bf16_ulp(mass.reshape(T, R, D))
             + _bf16_ulp(exact.reshape(T, R, D)) / 2)
    assert np.all(err <= bound)
    few = (n[..., 0] <= 2) & touched
    row_scale = np.abs(want).max(-1, keepdims=True)
    assert np.all((err <= _bf16_ulp(row_scale))[few])


def test_backward_sums_in_the_kernel_order():
    """Row by row, then (b, p) order: the plain backward equals a float32
    loop over the entries in that order, rounded once, bit for bit."""
    rng = np.random.default_rng(0)
    T, R, D, B, P = 2, 5, 4, 6, 9           # many repeats a row
    idx = rng.integers(0, R, (B, T, P), dtype=np.int32)
    dp = torch.tensor(rng.normal(size=(B, T, D)).astype(np.float32) * 1e3)
    got = ref.embedding_bag_stacked_backward_ref(dp, torch.tensor(idx), R,
                                                 torch.float32)
    want = np.zeros((T, R, D), np.float32)
    for t in range(T):
        for r in range(R):
            acc = np.zeros(D, np.float32)
            for b in range(B):
                for p in range(P):
                    if idx[b, t, p] == r:
                        acc = acc + dp[b, t].numpy()
            want[t, r] = acc
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    rng = np.random.default_rng(1)
    T, R, D, B, P = 3, 50, 8, 7, 6
    tab = torch.tensor(rng.normal(size=(T, R, D)).astype(np.float32)
                       ).to(torch.bfloat16)
    idx = torch.tensor(rng.integers(0, R, (B, T, P), dtype=np.int32))
    dp = torch.tensor(rng.normal(size=(B, T, D)).astype(np.float32))
    ops.reset_launches()
    want = ref.embedding_bag_stacked_backward_ref(dp, idx, R, torch.bfloat16)
    got = ops.embedding_bag_stacked_backward(dp, idx, R, torch.bfloat16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    # autograd through both bag functions gives the plain backward
    for fn in (ops.embedding_bag_stacked, ops.embedding_bag_stacked_plain):
        t = tab.clone().requires_grad_()
        out = fn(t, idx)
        assert torch.equal(out, ref.embedding_bag_stacked_ref(tab, idx))
        g, = torch.autograd.grad(out, t, dp.to(torch.bfloat16))
        assert torch.equal(g, ref.embedding_bag_stacked_backward_ref(
            dp.to(torch.bfloat16), idx, R, torch.bfloat16))
    assert ops.LAUNCHES == {"embedding_bag_rows": 0,
                            "embedding_bag_backward": 0}
    with pytest.raises(ValueError, match="dpooled"):
        ops.embedding_bag_stacked_backward(dp[:, :1], idx, R)
    with pytest.raises(IndexError):
        ops.embedding_bag_stacked_backward(dp, idx + R, R)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.embedding_bag_rows(tab.view(T * R, D).clone().requires_grad_(),
                               idx.view(B * T, P))


def _pair(seed=3):
    r_cfg = r_smoke_config("dlrm")
    params = RDLRM(r_cfg).init(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    model = DLRM(_port_cfg(r_cfg), device="cpu",
                 params=convert.dlrm_params_from_numpy(tree, "cpu"))
    return r_cfg, params, model


def _close(a, b, what):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = float(np.abs(a).max())
    assert np.abs(a - b).max() <= ATOL * max(scale, 1.0) + RTOL * scale, (
        what, float(np.abs(a - b).max()), scale)


def test_loss_gradient_matches_reference():
    r_cfg, params, model = _pair()
    batch = r_dlrm_batch(5, 2, 32, r_cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rl, rg = jax.jit(jax.value_and_grad(RDLRM(r_cfg).loss))(params, jb)
    loss, grads = make_grad_fn(model)(model.param_tree(), batch)
    np.testing.assert_allclose(float(loss), float(rl), rtol=RTOL, atol=ATOL)
    assert float(loss) == float(model.loss(batch))
    for (n, a), (n2, b) in zip(ref_flatten(rg), flatten_with_paths(grads)):
        assert n == n2 and b.dtype == (torch.bfloat16 if n == "tables"
                                       else torch.float32)
        _close(a, b.float().numpy(), n)
    assert not model.tables.requires_grad
    assert grads["tables"].abs().sum() > 0


def test_train_steps_match_reference():
    r_cfg, params, model = _pair(seed=4)
    kw = dict(learning_rate=3e-3, warmup_steps=2, total_steps=20)
    r_params, r_opt = r_init_train_state(RDLRM(r_cfg), jax.random.PRNGKey(4),
                                         RefTrainConfig(**kw))
    assert "master" not in r_opt
    p, st = init_train_state(model, None, TrainConfig(**kw))
    assert "master" not in st and p["tables"].dtype == torch.bfloat16
    r_step = jax.jit(r_make_train_step(RDLRM(r_cfg), RefTrainConfig(**kw)))
    step = make_train_step(model, TrainConfig(**kw))
    for i in range(3):
        b = dlrm_batch(0, i, 32, model.cfg)
        r_params, r_opt, rm = r_step(r_params, r_opt,
                                     {k: jnp.asarray(v) for k, v in b.items()})
        p, st, m = step(p, st, b)
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=5e-2)
    # the module's weights are the trained tree (shared storage)
    assert torch.equal(model.tables.detach(), p["tables"])


def test_dlrm_learns():
    """tests/test_system.py::test_dlrm_trains on the port."""
    from repro_torch.configs import smoke_model
    m = smoke_model("dlrm", device="cpu")
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=5, total_steps=80)
    params, opt = init_train_state(m, None, tcfg)
    step = make_train_step(m, tcfg)
    losses = []
    for i in range(60):
        b = {k: torch.as_tensor(v) for k, v in
             dlrm_batch(0, i, 64, m.cfg).items()}
        params, opt, metrics = step(params, opt, b)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < 0.65, losses[-1]     # below chance (0.693)
