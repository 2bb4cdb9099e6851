"""The plain version of the port's DCQCN update kernel
(``repro_torch.kernels.cc_update``) against the reference's
``dcqcn_update`` (the Pallas kernel, in interpret mode as
``tests/test_kernels.py`` runs it) and the reference's ``make_dcqcn``
policy update (compiled with ``jax.jit``).

The port's kernel computes the policy's update, so its plain version is
the port's ``make_dcqcn`` update: bit-equal to the reference policy with
the default parameters.  Where ``g`` is not a power of two, the
reference's update compiled alone contracts ``1 - g * p_cnp`` otherwise
than inside its engine step (which the port follows): a few alpha values
differ by one ulp (counted, rtol 1e-6).  Against the Pallas kernel, whose
body writes the multiply-adds unfused: rtol 1e-5, atol 1e-6
(``tests/test_kernels.py``'s own tolerance), wherever that kernel
computes the flow at all: its grid drops the tail tiles when
``ceil(F / 128)`` is above 8 and not a multiple of 8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cc as rcc
from repro.kernels.cc_update.ops import dcqcn_update as r_dcqcn_update
from repro_torch.core import cc as pcc
from repro_torch.core.arith import row_prod
from repro_torch.kernels.cc_update import ops, ref
from repro_torch.kernels.engine_step import ref as es_ref

ORDER = ops.ORDER
T = 2e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw(F, seed, varied):
    """State as ``tests/test_kernels.py:82-85`` draws it (rc scaled by
    U(0.05, 1), alpha U(0.1, 1), ecn U(0, 0.4)), with numpy; ``varied``
    also spreads the timers and counters so every branch runs."""
    rng = np.random.default_rng(seed)
    line = np.full(F, 25e9, np.float32)
    st = {k: np.asarray(v) for k, v in rcc.make_dcqcn().init(
        rcc.FlowCtx.make(jnp.asarray(line), jnp.asarray(line * 2e-6))).items()}
    st["rc"] = (st["rc"] * rng.uniform(0.05, 1.0, F)).astype(np.float32)
    st["alpha"] = rng.uniform(0.1, 1.0, F).astype(np.float32)
    if varied:
        for k in ("t_cut", "t_inc", "t_alpha"):
            st[k] = rng.uniform(0, T, F).astype(np.float32)
        st["inc_count"] = rng.integers(0, 15, F).astype(np.float32)
        st["rt"] = (st["rt"] * rng.uniform(0.05, 1.0, F)).astype(np.float32)
    ecn = rng.uniform(0, 0.4, F) * (rng.random(F) < (0.6 if varied else 1.0))
    return st, ecn.astype(np.float32), line


def _port(st, ecn, line, params):
    out = ops.dcqcn_update({k: torch.from_numpy(v.copy())
                            for k, v in st.items()},
                           torch.from_numpy(ecn), torch.from_numpy(line), T,
                           params)
    return {k: v.numpy() for k, v in out.items()}


def _ref_policy(st, ecn, line, params):
    pol = rcc.make_dcqcn()

    def upd(p, st, ecn, line, t):
        z = jnp.zeros_like(ecn)
        s = rcc.Signals(ecn=ecn, rtt=z, util=z, t=t, dt=jnp.float32(1e-6),
                        line=line, base_rtt=z)
        return pol.update(p, st, s)[0]
    out = jax.jit(upd)({k: jnp.float32(v) for k, v in params.items()},
                       {k: jnp.asarray(v) for k, v in st.items()},
                       jnp.asarray(ecn), jnp.asarray(line), jnp.float32(T))
    return {k: np.asarray(v) for k, v in out.items()}


def _ref_pallas(st, ecn, line, params):
    out = r_dcqcn_update({k: jnp.asarray(v) for k, v in st.items()},
                         jnp.asarray(ecn), jnp.asarray(line), T, params)
    return {k: np.asarray(v) for k, v in out.items()}


def _params(scale):
    return {k: float(v) * scale for k, v in rcc.make_dcqcn().params.items()}


@pytest.mark.parametrize("varied", [False, True], ids=["ref-draw", "varied"])
@pytest.mark.parametrize("F", [7, 128, 300, 1000])
def test_plain_matches_pallas_interpret(F, varied):
    st, ecn, line = _draw(F, F + varied, varied)
    got = _port(st, ecn, line, _params(1.0))
    want = _ref_pallas(st, ecn, line, _params(1.0))
    for k in ORDER:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("varied", [False, True], ids=["ref-draw", "varied"])
@pytest.mark.parametrize("F", [7, 128, 300, 1000, 1500, 7936])
def test_plain_equals_reference_policy(F, varied):
    st, ecn, line = _draw(F, F + varied, varied)
    got = _port(st, ecn, line, _params(1.0))
    want = _ref_policy(st, ecn, line, _params(1.0))
    for k in ORDER[:7]:
        assert np.array_equal(got[k], want[k]), k
    assert np.array_equal(got["jit"], st["jit"])


@pytest.mark.parametrize("F", [1000, 7936])
def test_non_default_params_match_reference_policy(F):
    """g = 1.3/256: the product g * p_cnp rounds, and the standalone
    compiled reference contracts the alpha update otherwise than the
    engine step does (see the module docstring)."""
    st, ecn, line = _draw(F, F + 1, True)
    params = _params(1.3)
    got = _port(st, ecn, line, params)
    want = _ref_policy(st, ecn, line, params)
    n_diff = 0
    for k in ORDER[:7]:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
        n_diff += int(np.sum(got[k] != want[k]))
    assert n_diff <= F // 1000 + 2
    assert np.array_equal(got["rc"], want["rc"])


@pytest.mark.parametrize("F", [1500, 7936])
def test_plain_equals_fused_kernel_plain_version(F):
    """The same DCQCN update through the fused step kernel's plain version
    (signals from one marking hop, packed state and params)."""
    st, _, line = _draw(F, 3 * F, True)
    rng = np.random.default_rng(F)
    B, H = 1, 4
    hm = np.zeros((B, H, F), np.float32)
    hm[:, 0] = 1.0
    q = (rng.uniform(0, 3e6, (B, H, F)) * hm).astype(np.float32)
    hop = dict(q_d=q, tx_d=np.zeros_like(q), caps=np.full_like(q, 25e9),
               ecn_mask=hm, hopmask=hm, kmin_h=np.full_like(q, 4e5),
               kmax_h=np.full_like(q, 1.6e6), pmax_h=np.full_like(q, 0.2))
    hop = {k: torch.from_numpy(v) for k, v in hop.items()}
    flat = dict(base_rtt=torch.full((B, F), 5e-6),
                line=torch.from_numpy(line[None].copy()),
                loss=torch.zeros((B, F)))
    pol = pcc.make_dcqcn()
    state = pcc.pack_state(pol, {k: torch.from_numpy(v.copy())
                                 for k, v in st.items()})[None]
    params = pcc.pack_params(pol, None)[None]
    st_out, _, _ = es_ref.fused_signals_policy_ref(
        pol, *hop.values(), *flat.values(), state, params, T, 1e-5, 1e-6)
    fused = pcc.unpack_state(pol, st_out[0])
    # the ECN signal the fused plain version computed from the hop inputs
    mark = torch.clamp((hop["q_d"] - hop["kmin_h"])
                       / torch.clamp_min(hop["kmax_h"] - hop["kmin_h"], 1.0),
                       0.0, 1.0) * hop["pmax_h"] * hop["ecn_mask"]
    ecn = (1.0 - row_prod((1.0 - mark)[0].T)).numpy()
    got = _port(st, ecn, line, None)
    for k in ORDER:
        assert np.array_equal(got[k], fused[k].numpy()), k


def test_reference_pallas_drops_tail_tiles():
    """A fact of the reference, not of the port: at F=1500 (ceil(F/128) =
    12 tiles, grid 12 // 8 = 1 block of 8) the Pallas kernel never
    computes flows 1024-1499; below 1024 it agrees with its policy."""
    F = 1500
    st, ecn, line = _draw(F, 11, False)
    pallas = _ref_pallas(st, ecn, line, _params(1.0))
    policy = _ref_policy(st, ecn, line, _params(1.0))
    port = _port(st, ecn, line, _params(1.0))
    wrong = np.zeros(F, bool)
    for k in ORDER[:7]:
        wrong |= ~np.isclose(pallas[k], policy[k], rtol=1e-5, atol=1e-6)
        assert np.array_equal(port[k], policy[k]), k
    assert not wrong[:1024].any()
    assert wrong[1024:].all()
    assert int(wrong.sum()) == 476


def test_params_and_layout_checks():
    st, ecn, line = _draw(8, 0, False)
    with pytest.raises(ValueError, match="unknown dcqcn"):
        _port(st, ecn, line, {"bogus": 1.0})
    assert ops.PARAM_ORDER == pcc.kernel_param_keys(pcc.make_dcqcn())
    assert set(ORDER) == set(pcc.kernel_state_keys(pcc.make_dcqcn()))
    assert ops.LAUNCHES == {"dcqcn_update": 0}      # CPU: no launch
    assert ref.dcqcn_params({"g": 0.1})["g"] == float(np.float32(0.1))
