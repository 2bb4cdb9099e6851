"""The port's CC policies (``repro_torch.core.cc``) against the
reference's (``repro.core.cc``) on the same random state and signals.

The reference's update runs compiled (``jax.jit``), as inside its engine
step, where the CPU backend contracts multiply-adds into FMAs; the port
rounds the same multiply-adds once (``repro_torch.core.arith``).  Which
of two products the compiler fuses can depend on the surrounding code,
so single values may differ by an ulp: tolerance rtol 1e-6 (1e-5 for
DCQCN, whose p_cnp = 1 - exp(...) feeds a cut).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cc as rcc
from repro_torch.core import cc as pcc

F = 4096
POLICIES = list(pcc.ALL_POLICIES)


def _params(name, scale):
    pol = rcc.get_policy(name)
    return {k: float(v) * (scale if not pol.spec[k].init_baked else 1.0)
            for k, v in pol.params.items()}


def _inputs(name, lossy, seed):
    rng = np.random.default_rng(seed)
    line = np.full(F, 25e9, np.float32)
    bdp = (line * rng.uniform(1e-6, 2e-5, F)).astype(np.float32)
    fanin = rng.integers(1, 8, F).astype(np.float32)
    st = rcc.get_policy(name).init(rcc.FlowCtx.make(
        jnp.asarray(line), jnp.asarray(bdp), jnp.asarray(fanin)))
    st = {k: (np.asarray(v) * rng.uniform(0.5, 1.5, F)).astype(np.float32)
          for k, v in st.items()}
    for k in ("t_cut", "t_inc", "t_alpha", "t_rtt", "t_upd"):
        if k in st:
            st[k] = rng.uniform(0, 2e-4, F).astype(np.float32)
    for k, hi in (("inc_count", 15), ("stage", 8), ("neg_count", 8)):
        if k in st:
            st[k] = rng.integers(0, hi, F).astype(np.float32)
    sig = dict(ecn=rng.uniform(0, 0.3, F) * (rng.random(F) < 0.7),
               rtt=rng.uniform(2e-6, 5e-4, F), util=rng.uniform(0, 3, F),
               line=line, base_rtt=rng.uniform(1e-6, 2e-5, F),
               loss=(rng.uniform(0, 0.05, F) * (rng.random(F) < 0.5)
                     if lossy else None))
    sig = {k: (None if v is None else np.asarray(v, np.float32))
           for k, v in sig.items()}
    return st, sig


def _ref_update(name, params, st, sig, t):
    pol = rcc.get_policy(name)
    kw = {k: jnp.asarray(v) for k, v in sig.items() if v is not None}

    def upd(params, st, kw, t):
        s = rcc.Signals(t=t, dt=jnp.float32(1e-6), **kw)
        return pol.update(params, st, s)
    out = jax.jit(upd)({k: jnp.float32(v) for k, v in params.items()},
                       {k: jnp.asarray(v) for k, v in st.items()}, kw,
                       jnp.float32(t))
    return ({k: np.asarray(v) for k, v in out[0].items()},
            np.broadcast_to(np.asarray(out[1]), (F,)),
            np.broadcast_to(np.asarray(out[2]), (F,)))


def _port_update(name, params, st, sig, t, loss=None):
    pol = pcc.get_policy(name)
    kw = {k: torch.from_numpy(v) for k, v in sig.items() if v is not None}
    if loss is not None:
        kw["loss"] = loss
    s = pcc.Signals(t=float(np.float32(t)), dt=1e-6, **kw)
    out = pol.update(params, {k: torch.from_numpy(v.copy())
                              for k, v in st.items()}, s)
    return ({k: v.numpy() for k, v in out[0].items()},
            out[1].expand(F).numpy(), out[2].expand(F).numpy())


@pytest.mark.parametrize("scale", [1.0, 1.3], ids=["default", "x1.3"])
@pytest.mark.parametrize("lossy", [False, True], ids=["lossless", "lossy"])
@pytest.mark.parametrize("name", POLICIES)
def test_update_matches_reference(name, lossy, scale):
    params = _params(name, scale)
    st, sig = _inputs(name, lossy, seed=hash((name, lossy)) % 2**31)
    rtol = 1e-5 if name == "dcqcn" else 1e-6
    for t in (1.3e-4, 7.7e-4):
        r_st, r_rate, r_win = _ref_update(name, params, st, sig, t)
        p_st, p_rate, p_win = _port_update(name, params, st, sig, t)
        np.testing.assert_allclose(p_rate, r_rate, rtol=rtol)
        np.testing.assert_allclose(p_win, r_win, rtol=rtol)
        assert set(p_st) == set(r_st)
        for k in r_st:
            np.testing.assert_allclose(p_st[k], r_st[k], rtol=rtol,
                                       err_msg=f"state[{k!r}]")


@pytest.mark.parametrize("name", POLICIES)
def test_zero_loss_branch_is_bitwise_noop(name):
    """A loss tensor of zeros gives bitwise the lossless (scalar 0.0)
    update."""
    st, sig = _inputs(name, False, seed=5)
    params = _params(name, 1.0)
    a = _port_update(name, params, st, sig, 3e-4)
    b = _port_update(name, params, st, sig, 3e-4, loss=torch.zeros(F))
    for x, y in zip((a[1], a[2]), (b[1], b[2])):
        assert np.array_equal(x, y)
    for k in a[0]:
        assert np.array_equal(a[0][k], b[0][k]), k


@pytest.mark.parametrize("name", POLICIES)
def test_init_matches_reference_at_paper_scale(name):
    """Bitwise at F = 131,072, where DCQCN's float32 timer jitter
    (arange * 7919 % 97) passes 2^24 and rounds."""
    n = 131072
    rng = np.random.default_rng(1)
    line = rng.choice([25e9, 200e9], n).astype(np.float32)
    bdp = (line * rng.uniform(1e-6, 2e-5, n)).astype(np.float32)
    fanin = rng.integers(1, 64, n).astype(np.float32)
    r = rcc.get_policy(name).init(rcc.FlowCtx.make(
        jnp.asarray(line), jnp.asarray(bdp), jnp.asarray(fanin)))
    p = pcc.get_policy(name).init(pcc.FlowCtx.make(
        torch.from_numpy(line), torch.from_numpy(bdp),
        torch.from_numpy(fanin)))
    assert set(r) == set(p)
    for k in r:
        assert np.array_equal(np.asarray(r[k]), p[k].numpy()), k


@pytest.mark.parametrize("name", POLICIES)
def test_kernel_abi_matches_reference(name):
    r, p = rcc.get_policy(name), pcc.get_policy(name)
    assert pcc.kernel_state_keys(p) == rcc.kernel_state_keys(r)
    assert pcc.kernel_param_keys(p) == rcc.kernel_param_keys(r)
    assert p.kernel_id == pcc.KERNEL_POLICY_ID[name]
    st = p.init(pcc.FlowCtx.make(torch.full((6,), 25e9),
                                 torch.full((6,), 1e5)))
    packed = pcc.pack_state(p, st, n_flows=6)
    assert packed.shape == (max(len(st), 1), 6)
    if st:
        back = pcc.unpack_state(p, packed)
        assert all(torch.equal(back[k], st[k]) for k in st)
    ref_pp = np.asarray(rcc.pack_params(r, None))
    assert np.array_equal(pcc.pack_params(p, None).numpy(), ref_pp)


def test_registry_lists_what_the_port_runs():
    assert tuple(pcc.REGISTRY) == tuple(rcc.REGISTRY)
    assert pcc.ALL_POLICIES == rcc.ALL_POLICIES
    assert pcc.get_policy("mlp").kernel_id == pcc.KERNEL_POLICY_ID["mlp"]
    with pytest.raises(KeyError, match="unknown policy"):
        pcc.get_policy("nope")


@pytest.mark.parametrize("name", POLICIES)
def test_registry_invariants(name):
    """The reference's Policy-API invariants (tests/test_cc_policies.py)
    hold in the port: spec table, defaults, flags, bounded outputs."""
    r, p = rcc.get_policy(name), pcc.get_policy(name)
    assert p.params == r.params
    assert (p.kind, p.wire_factor, p.loss_aware) == \
        (r.kind, r.wire_factor, r.loss_aware)
    for k, s in p.spec.items():
        assert isinstance(s, pcc.ParamSpec)
        assert (s.lo, s.hi, s.scale, s.integer, s.init_baked) == \
            (r.spec[k].lo, r.spec[k].hi, r.spec[k].scale,
             r.spec[k].integer, r.spec[k].init_baked)
        if s.bounded:
            assert s.lo <= s.default <= s.hi
    rng = np.random.default_rng(42)
    st = p.init(pcc.FlowCtx.make(torch.full((4,), 25e9),
                                 torch.full((4,), 5e4)))
    for i in range(25):
        sig = pcc.Signals(
            ecn=torch.as_tensor(rng.uniform(0, 1, 4), dtype=torch.float32),
            rtt=torch.as_tensor(rng.uniform(1e-7, 1e-2, 4),
                                dtype=torch.float32),
            util=torch.as_tensor(rng.uniform(1e-3, 10, 4),
                                 dtype=torch.float32),
            t=float(np.float32((i + 1) * 13e-6)), dt=1e-6,
            line=torch.full((4,), 25e9), base_rtt=torch.full((4,), 2e-6))
        st, rate, win = p.update(p.params, st, sig)
        assert torch.all(rate > 0) and torch.all(rate <= 25e9 * 1.0001)
        assert torch.all(win > 0)


def test_check_tunable_and_param_spec_validation():
    p = pcc.get_policy("static_window")
    assert set(p.init_params) == {"margin", "headroom", "min_w"}
    with pytest.raises(ValueError, match="consumed by init"):
        p.check_tunable(["margin"])
    with pytest.raises(ValueError, match="unknown"):
        p.check_tunable(["nope"])
    with pytest.raises(ValueError, match="positive lo"):
        pcc.ParamSpec(1.0, lo=0.0, hi=2.0, scale="log")
    assert pcc.make_dcqcn(rai_frac=0.07).spec["rai_frac"].default == \
        pytest.approx(0.07)
