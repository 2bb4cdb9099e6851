"""Mamba-2 (Zamba2) and RWKV-6 of the port's serving path, on the CPU,
against the reference's ``repro.models.ssm`` and ``repro.models.rwkv``.

Layer functions take float32 numpy inputs and the reference's own init
(its zero-init leaves drawn instead, so that they matter) and hold the
port within rtol 1e-4, atol 1e-5 (the latter times the largest reference
value where that exceeds 1): Mamba-2's causal conv with its carried state,
``_ssd_chunked`` (one chunk, several, a ragged tail, a carried state) and
the exact S == 1 recurrence, and RWKV-6's token scan, its chunked form
and the channel mix, prefill and decode states included.  The Zamba2 and
RWKV-6 smoke models (numpy weights at the true fan-in, carried by
``repro_torch.convert``): prefill and 8 teacher-forced decode steps within
1e-4 of the reference's largest logit (Zamba2 2^-8, one bf16 ulp: its
bf16 KV cache, ``CASES``), activations in float32 (``tests/_serve_pairs.py``), and
``ServeEngine``'s tokens equal to the reference's.
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
from repro.models import rwkv as RRWKV
from repro.models import ssm as RSSM
from repro_torch import convert
from repro_torch.models import rwkv as PRWKV
from repro_torch.models import ssm as PSSM

RTOL, ATOL = 1e-4, 1e-5


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
    at 0.3 instead; (jax tree, port tree)."""
    tree = jax.tree.map(np.array, materialize(defs, jax.random.PRNGKey(seed)))
    leaves, treedef = jax.tree.flatten(tree)
    leaves = [a if np.any(a) else _rand(a.shape, seed + i, 0.3)
              for i, a in enumerate(leaves)]
    tree = jax.tree.unflatten(treedef, leaves)
    return (jax.tree.map(jnp.asarray, tree),
            convert.transformer_params_from_numpy(tree, device="cpu"))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=RTOL,
        atol=ATOL * max(1.0, float(np.abs(want).max())))


def _cfgs(arch, **over):
    r = dataclasses.replace(r_smoke_config(arch), **over)
    return r, sp.port_cfg(r)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


# --------------------------------------------------------------- Mamba-2

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    r_cfg, _ = _cfgs("zamba2-1.2b")
    C = r_cfg.d_inner + 2 * r_cfg.ssm_state
    xbc = _rand((2, 9, C), 1)
    w = _rand((r_cfg.ssm_conv, C), 2, 0.5)
    b = _rand((C,), 3, 0.1)
    st = _rand((2, r_cfg.ssm_conv - 1, C), 4) if with_state else None
    want = RSSM._causal_conv(jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(b),
                             None if st is None else jnp.asarray(st))
    got = PSSM._causal_conv(torch.from_numpy(xbc), torch.from_numpy(w),
                            torch.from_numpy(b),
                            None if st is None else torch.from_numpy(st))
    for g, w_ in zip(got, want):
        _close(g, w_)


# S against ssm_chunk 8: one chunk, several, a ragged tail
@pytest.mark.parametrize("S", [5, 16, 21])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(S, with_state):
    r_cfg, p_cfg = _cfgs("zamba2-1.2b")
    nh, hd, ds = r_cfg.ssm_nheads, r_cfg.ssm_headdim, r_cfg.ssm_state
    xh = _rand((2, S, nh, hd), 5)
    dt = np.log1p(np.exp(_rand((2, S, nh), 6)))
    A = -np.exp(_rand((nh,), 7, 0.3))
    Bc, Cc = _rand((2, S, ds), 8), _rand((2, S, ds), 9)
    s0 = _rand((2, nh, ds, hd), 10) if with_state else None
    args = (xh, dt, A, Bc, Cc)
    want = RSSM._ssd_chunked(*map(jnp.asarray, args), r_cfg,
                             None if s0 is None else jnp.asarray(s0))
    got = PSSM._ssd_chunked(*map(torch.from_numpy, args), p_cfg,
                            None if s0 is None else torch.from_numpy(s0))
    for g, w in zip(got, want):
        _close(g, w)


def test_mamba2_prefill_then_steps_match_reference():
    """A 20-token prefill from the zero state, then 4 single steps (the
    exact recurrence), each carrying the last state."""
    r_cfg, p_cfg = _cfgs("zamba2-1.2b")
    jp, pp = _params(RSSM.mamba2_defs(r_cfg), 11)
    x = _rand((2, 24, r_cfg.d_model), 12, 0.5)
    zero = materialize(RSSM.mamba2_state_defs(r_cfg, 2),
                       jax.random.PRNGKey(0))
    r_state, p_state = zero, _t(zero)
    for lo, hi in ((0, 20), (20, 21), (21, 22), (22, 23), (23, 24)):
        want, r_state = RSSM.mamba2_apply(jp, jnp.asarray(x[:, lo:hi]),
                                          r_cfg, r_state)
        got, p_state = PSSM.mamba2_apply(pp, torch.from_numpy(x[:, lo:hi]),
                                         p_cfg, p_state)
        _close(got, want)
        for k in ("conv", "ssm"):
            _close(p_state[k], r_state[k])


# ---------------------------------------------------------------- RWKV-6

@pytest.mark.parametrize("chunk", [0, 4, 8])
def test_rwkv6_time_mix_matches_reference(chunk):
    """The token scan (``rwkv_chunk`` 0, and 5 tokens that 4 does not
    divide), the chunked form (16 tokens), then two decode steps."""
    r_cfg, p_cfg = _cfgs("rwkv6-3b", rwkv_chunk=chunk)
    jp, pp = _params(RRWKV.rwkv6_defs(r_cfg)["time"], 13)
    S = 5 if chunk == 4 else 16
    x = _rand((2, S + 2, r_cfg.d_model), 14, 0.5)
    r_state, p_state = None, None
    for lo, hi in ((0, S), (S, S + 1), (S + 1, S + 2)):
        want, r_state = RRWKV.rwkv6_time_mix(jp, jnp.asarray(x[:, lo:hi]),
                                             r_cfg, r_state)
        got, p_state = PRWKV.rwkv6_time_mix(pp, torch.from_numpy(x[:, lo:hi]),
                                            p_cfg, p_state)
        _close(got, want)
        for k in ("S", "tok"):
            _close(p_state[k], r_state[k])


def test_rwkv6_chunked_form_against_the_scan():
    """The port's chunked form against its own token scan (the reference's
    test_blocks.py holds its two forms at 2e-3)."""
    _, p_cfg = _cfgs("rwkv6-3b")
    r_cfg, _ = _cfgs("rwkv6-3b")
    _, pp = _params(RRWKV.rwkv6_defs(r_cfg)["time"], 15)
    x = torch.from_numpy(_rand((2, 32, p_cfg.d_model), 16, 0.5))
    scan, s1 = PRWKV.rwkv6_time_mix(pp, x, p_cfg, None)
    chunked, s2 = PRWKV.rwkv6_time_mix(
        pp, x, dataclasses.replace(p_cfg, rwkv_chunk=8), None)
    np.testing.assert_allclose(chunked.numpy(), scan.numpy(), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(s2["S"].numpy(), s1["S"].numpy(), rtol=2e-3,
                               atol=2e-3)


def test_rwkv6_channel_mix_matches_reference():
    r_cfg, p_cfg = _cfgs("rwkv6-3b")
    jp, pp = _params(RRWKV.rwkv6_defs(r_cfg)["channel"], 17)
    x = _rand((2, 7, r_cfg.d_model), 18)
    r_state, p_state = None, None
    for lo, hi in ((0, 6), (6, 7)):
        want, r_state = RRWKV.rwkv6_channel_mix(jp, jnp.asarray(x[:, lo:hi]),
                                                r_cfg, r_state)
        got, p_state = PRWKV.rwkv6_channel_mix(
            pp, torch.from_numpy(x[:, lo:hi]), p_cfg, p_state)
        _close(got, want)
        _close(p_state["tok"], r_state["tok"])


# ---------------------------------------------------------------- models

# (config overrides, tolerance).  Zamba2's shared block writes its K/V to
# a bf16 cache in both packages: where the two float32 activations differ
# by an ulp, an element may round to the neighbouring bf16 value, one bf16
# ulp (2^-8) of itself (6-10 of the 2,048 elements of this run), and the
# step whose own key does so moves the logits by up to 1e-3 of their
# largest: one bf16 ulp of it, 2^-8, there
CASES = {"zamba2-1.2b": ({}, 2.0 ** -8), "rwkv6-3b": ({}, 1e-4),
         "rwkv6-3b/chunk8": ({"rwkv_chunk": 8}, 1e-4)}


@pytest.mark.parametrize("case", list(CASES))
def test_smoke_model_matches_reference(case):
    over, rtol = CASES[case]
    r_cfg = dataclasses.replace(r_smoke_config(case.split("/")[0]), **over)
    r_model, params, model, pp = sp.pair(r_cfg)
    sp.check_logits(sp.teacher_forced(r_model, params, model, pp, 16, 8),
                    rtol)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-3b"])
def test_cache_and_param_trees_match_reference(arch):
    r_model, params, model, pp = sp.pair(r_smoke_config(arch))
    assert sp.signature(pp) == sp.signature(params)
    assert sp.signature(model.init_cache(2, 20)["layers"]) == sp.signature(
        r_model.init_cache(2, 20)["layers"])
    if arch == "zamba2-1.2b":
        assert "shared_block" in pp


def test_states_are_written_in_place():
    _, _, model, pp = sp.pair(r_smoke_config("zamba2-1.2b"))
    toks = np.arange(20, dtype=np.int32).reshape(2, 10) % model.cfg.vocab
    _, cache = model.prefill(pp, {"tokens": toks[:, :8]}, max_len=12)
    ssm = cache["layers"][0]["l0"]["ssm"]
    before = ssm.clone()
    assert bool(before.abs().amax() > 0)
    _, cache = model.decode_step(pp, cache, toks[:, 8:9])
    assert cache["layers"][0]["l0"]["ssm"] is ssm
    assert not torch.equal(ssm, before)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-3b"])
def test_serve_engine_matches_reference(arch):
    r_model, params, model, pp = sp.pair(r_smoke_config(arch))
    want, got, eng = sp.engine_tokens(r_model, params, model, pp)
    for a, b in zip(got, want):
        assert a.rid == b.rid
        np.testing.assert_array_equal(a.tokens, b.tokens)
