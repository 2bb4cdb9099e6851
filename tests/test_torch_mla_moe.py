"""MLA and MoE (DeepSeek-V2/V3) of the port's serving path, on the CPU,
against the reference's ``repro.models.mla`` and ``repro.models.moe``.

Layer functions take float32 numpy inputs and the reference's own init
(its zero-init norm scales drawn instead, so that they matter) and hold
the port within rtol 1e-4, atol 1e-5 (the latter times the largest
reference value where that exceeds 1): ``mla_train`` (dense and
blockwise), ``mla_decode`` (the absorbed form over a latent cache), the
router, ``_moe_dense``, ``_moe_chunked`` (the halving rule) and the
capacity helpers ``_positions``, ``_scatter_slots``, ``_gather_slots``
(equal).  The DeepSeek-V2 and -V3 smoke models (numpy weights at the true
fan-in, carried by ``repro_torch.convert``): prefill and 8 teacher-forced
decode steps within 1e-4 of the reference's largest logit, activations in
float32 (``tests/_serve_pairs.py``), and ``ServeEngine``'s tokens equal to
the reference's.  MoE over a mesh raises.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _serve_pairs as sp
from repro.common.pytree import materialize
from repro.configs import smoke_config as r_smoke_config
from repro.models import mla as RMLA
from repro.models import moe as RMOE
from repro_torch import convert
from repro_torch.models import mla as PMLA
from repro_torch.models import moe as PMOE

RTOL, ATOL = 1e-4, 1e-5
ARCHS = ("deepseek-v2-236b", "deepseek-v3-671b")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _params(defs, seed):
    """The reference's init of ``defs`` with every zero-init leaf drawn
    at 0.1 instead; (jax tree, port tree)."""
    tree = jax.tree.map(np.array, materialize(defs, jax.random.PRNGKey(seed)))
    leaves, treedef = jax.tree.flatten(tree)
    leaves = [a if np.any(a) else _rand(a.shape, seed + i, 0.1)
              for i, a in enumerate(leaves)]
    tree = jax.tree.unflatten(treedef, leaves)
    return (jax.tree.map(jnp.asarray, tree),
            convert.transformer_params_from_numpy(tree, device="cpu"))


def _close(got, want):
    """rtol 1e-4, atol 1e-5 at unit scale (times the largest |want| where
    that exceeds 1: a float32 sum's error grows with its terms)."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=RTOL,
        atol=ATOL * max(1.0, float(np.abs(want).max())))


def _cfgs(arch, **over):
    r = dataclasses.replace(r_smoke_config(arch), **over)
    return r, sp.port_cfg(r)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S,block", [(12, 512), (2560, 512)])
def test_mla_train_matches_reference(arch, S, block):
    """S = 2,560 takes the blockwise prefill (above 2,048)."""
    r_cfg, p_cfg = _cfgs(arch, block_q=block, block_k=block)
    jp, pp = _params(RMLA.mla_defs(r_cfg), 1)
    B = 1 if S > 100 else 2
    x = _rand((B, S, r_cfg.d_model), 2, 0.5)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    want = RMLA.mla_train(jp, jnp.asarray(x), r_cfg, jnp.asarray(pos))
    got = PMLA.mla_train(pp, torch.from_numpy(x), p_cfg,
                         torch.from_numpy(np.array(pos)))
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("length", [0, 5, 15])
def test_mla_decode_matches_reference(arch, length):
    """The absorbed decode at ``length`` over a latent cache of 16 whose
    entry at ``length`` the step has written; the reference masks the
    rest, the port reads only positions 0 .. length."""
    r_cfg, p_cfg = _cfgs(arch)
    jp, pp = _params(RMLA.mla_defs(r_cfg), 3)
    B, Smax = 2, 16
    x = _rand((B, 1, r_cfg.d_model), 4, 0.5)
    c = _rand((B, Smax, r_cfg.kv_lora_rank), 5)
    pe = _rand((B, Smax, r_cfg.qk_rope_head_dim), 6)
    want = RMLA.mla_decode(jp, jnp.asarray(x), r_cfg, jnp.asarray(c),
                           jnp.asarray(pe), length=length)
    got = PMLA.mla_decode(pp, torch.from_numpy(x), p_cfg,
                          torch.from_numpy(c), torch.from_numpy(pe),
                          length=length)
    _close(got, want)


def test_mla_prefill_cache_matches_reference():
    r_cfg, p_cfg = _cfgs("deepseek-v2-236b")
    jp, pp = _params(RMLA.mla_defs(r_cfg), 7)
    x = _rand((2, 9, r_cfg.d_model), 8)
    pos = np.broadcast_to(np.arange(9)[None], (2, 9))
    for w, g in zip(RMLA.mla_prefill_cache(jp, jnp.asarray(x), r_cfg,
                                           jnp.asarray(pos)),
                    PMLA.mla_prefill_cache(pp, torch.from_numpy(x), p_cfg,
                                           torch.from_numpy(np.array(pos)))):
        _close(g, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_router_matches_reference(arch):
    r_cfg, p_cfg = _cfgs(arch, router_scale=3.0)
    jp, pp = _params(RMOE.moe_defs(r_cfg), 9)
    x = _rand((64, r_cfg.d_model), 10)
    g_w, i_w = RMOE._router(jp["router"], jnp.asarray(x), r_cfg)
    g, i = PMOE._router(pp["router"], torch.from_numpy(x), p_cfg)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_w))
    _close(g, g_w)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_matches_reference(arch):
    r_cfg, p_cfg = _cfgs(arch)
    jp, pp = _params(RMOE.moe_defs(r_cfg), 11)
    x = _rand((24, r_cfg.d_model), 12)
    _close(PMOE._moe_dense(pp, torch.from_numpy(x), p_cfg),
           RMOE._moe_dense(jp, jnp.asarray(x), r_cfg))
    _close(PMOE.moe_apply(pp, torch.from_numpy(x), p_cfg),
           RMOE.moe_apply(jp, jnp.asarray(x), r_cfg))


# moe_chunks against token counts: 8 | 24 -> 8 chunks; 24 % 16 -> 8;
# 6 % 8, 6 % 4 -> 2; 7 -> 1
@pytest.mark.parametrize("chunks,T", [(8, 24), (16, 24), (8, 6), (4, 7)])
def test_moe_chunked_matches_reference(chunks, T):
    r_cfg, p_cfg = _cfgs("deepseek-v2-236b", moe_chunks=chunks)
    jp, pp = _params(RMOE.moe_defs(r_cfg), 13)
    x = _rand((T, r_cfg.d_model), 14)
    calls = []

    def fn(xs):
        calls.append(xs.shape[0])
        return PMOE._moe_dense(pp, xs, p_cfg)
    got = PMOE._moe_chunked(fn, torch.from_numpy(x), p_cfg)
    want = RMOE._moe_chunked(lambda xs: RMOE._moe_dense(jp, xs, r_cfg),
                             jnp.asarray(x), r_cfg)
    _close(got, want)
    n = chunks
    while n > 1 and T % n:
        n //= 2
    assert calls == [T // max(n, 1)] * max(n, 1)


@pytest.mark.parametrize("cap", [1, 3, 8])
def test_capacity_helpers_match_reference(cap):
    T, k, E, D = 10, 2, 4, 6
    rng = np.random.default_rng(cap)
    idx = rng.integers(0, E, (T, k)).astype(np.int32)
    keep = rng.random((T, k)) < 0.8
    x = _rand((T, D), 15)
    gates = _rand((T, k), 16)
    pos_w, kept_w = RMOE._positions(jnp.asarray(idx), jnp.asarray(keep), E,
                                    cap)
    pos, kept = PMOE._positions(torch.from_numpy(idx), torch.from_numpy(keep),
                                E, cap)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(pos_w))
    np.testing.assert_array_equal(kept.numpy(), np.asarray(kept_w))
    buf_w = RMOE._scatter_slots(jnp.asarray(x), jnp.asarray(idx), pos_w,
                                kept_w, E, cap)
    buf = PMOE._scatter_slots(torch.from_numpy(x), torch.from_numpy(idx),
                              pos, kept, E, cap)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(buf_w))
    back_w = RMOE._gather_slots(buf_w, jnp.asarray(idx), pos_w, kept_w,
                                jnp.asarray(gates))
    back = PMOE._gather_slots(buf, torch.from_numpy(idx), pos, kept,
                              torch.from_numpy(gates))
    _close(back, back_w)


def test_moe_over_a_mesh_raises():
    """The mesh bodies run on a live mesh (``tests/test_torch_mesh_moe.py``
    holds them against the reference): an abstract mesh raises; the
    ``dense`` impl over a mesh is the dense path, as in the reference."""
    import dataclasses

    from repro_torch.common.sharding import abstract_mesh
    r_cfg, p_cfg = _cfgs("deepseek-v3-671b")
    _, pp = _params(RMOE.moe_defs(r_cfg), 17)
    mesh = abstract_mesh((2, 2), ("data", "model"))
    x = torch.randn((4, p_cfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    for impl in ("ep_a2a", "tp"):
        with pytest.raises(ValueError, match="live mesh"):
            PMOE.moe_apply(pp, x, dataclasses.replace(p_cfg, moe_impl=impl),
                           mesh=mesh)
    assert torch.equal(PMOE.moe_apply(pp, x, p_cfg, mesh=mesh),
                       PMOE.moe_apply(pp, x, p_cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_model_matches_reference(arch):
    r_model, params, model, pp = sp.pair(r_smoke_config(arch))
    sp.check_logits(sp.teacher_forced(r_model, params, model, pp, 16, 8),
                    1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_param_trees_match_reference(arch):
    r_model, params, model, pp = sp.pair(r_smoke_config(arch))
    assert sp.signature(pp) == sp.signature(params)
    assert sp.signature(model.init_cache(2, 20)["layers"]) == sp.signature(
        r_model.init_cache(2, 20)["layers"])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_matches_reference(arch):
    r_model, params, model, pp = sp.pair(r_smoke_config(arch))
    want, got, eng = sp.engine_tokens(r_model, params, model, pp)
    for a, b in zip(got, want):
        assert a.rid == b.rid
        np.testing.assert_array_equal(a.tokens, b.tokens)
