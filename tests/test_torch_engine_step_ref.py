"""The plain versions of the engine-step kernels (``repro_torch.kernels.
engine_step.ref``) and their wrappers on CPU tensors, against the
reference's ``repro.kernels.engine_step.ref`` (and, at F = 200 where it
is right, the reference's Pallas kernel in interpret mode).

F = 1500 and F = 7936 are the sizes at which the reference's Pallas grid
drops tail tiles; the port's versions have no tiles.  Tolerances: rtol
1e-5 on the fused step (the reference's oracle runs op by op, the port
rounds contracted multiply-adds once); rtol 1e-6 on the segment sums,
with ``paused`` exact away from the thresholds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cc as rcc
from repro.kernels.engine_step import ops as r_ops
from repro.kernels.engine_step import ref as r_ref
from repro_torch.core import cc as pcc
from repro_torch.kernels.engine_step import ops as p_ops
from repro_torch.kernels.engine_step import ref as p_ref

HOP_KEYS = ("q_d", "tx_d", "caps", "ecn_mask", "hopmask", "kmin_h",
            "kmax_h", "pmax_h")


def _case(n, lossy, seed):
    rng = np.random.default_rng(seed)
    H = 4
    hm = (rng.random((n, H)) < 0.7).astype(np.float32)
    hm[:, 0] = 1.0
    case = dict(
        q_d=rng.uniform(0, 3e6, (n, H)) * hm,
        tx_d=rng.uniform(0, 50e9, (n, H)) * hm,
        caps=rng.uniform(10e9, 50e9, (n, H)),
        ecn_mask=(rng.random((n, H)) < 0.8) * hm, hopmask=hm,
        kmin_h=np.full((n, H), 400e3), kmax_h=np.full((n, H), 1600e3),
        pmax_h=np.full((n, H), 0.2),
        base_rtt=rng.uniform(2e-6, 20e-6, n), line=np.full(n, 25e9),
        loss=(rng.uniform(0, 0.05, n) * (rng.random(n) < 0.5) if lossy
              else np.zeros(n)))
    case = {k: np.asarray(v, np.float32) for k, v in case.items()}
    return case, rng


def _state(name, n, rng):
    line = np.full(n, 25e9, np.float32)
    st = rcc.get_policy(name).init(rcc.FlowCtx(
        line=jnp.asarray(line), bdp=jnp.asarray(line * 5e-6),
        fanin=jnp.full((n,), 4.0, jnp.float32), n_flows=n))
    st = {k: (np.asarray(v) * rng.uniform(0.5, 1.5, n)).astype(np.float32)
          for k, v in st.items()}
    for k in ("t_cut", "t_inc", "t_alpha", "t_rtt", "t_upd"):
        if k in st:
            st[k] = rng.uniform(0, 3e-4, n).astype(np.float32)
    return st


def _compare(got, want, rtol):
    g_st, g_rate, g_win = got
    w_st, w_rate, w_win = want
    n = g_rate.shape[0]
    np.testing.assert_allclose(g_rate, np.broadcast_to(w_rate, (n,)),
                               rtol=rtol)
    np.testing.assert_allclose(g_win, np.broadcast_to(w_win, (n,)),
                               rtol=rtol)
    assert set(g_st) == set(w_st)
    for k in w_st:
        np.testing.assert_allclose(g_st[k], np.broadcast_to(w_st[k], (n,)),
                                   rtol=rtol, err_msg=f"state[{k!r}]")


def _port(name, case, st, t):
    out = p_ref.fused_step_ref(
        pcc.get_policy(name), state={k: torch.from_numpy(v.copy())
                                     for k, v in st.items()},
        params=None, t=t, dt=1e-6, t_base_util=1e-5,
        **{k: torch.from_numpy(v) for k, v in case.items()})
    return ({k: v.numpy() for k, v in out[0].items()}, out[1].numpy(),
            out[2].numpy())


def _reference(name, case, st, t, pallas=False):
    fn = r_ops.fused_step if pallas else r_ref.fused_step_ref
    kw = {"interpret": True} if pallas else {}
    out = fn(rcc.get_policy(name), state={k: jnp.asarray(v)
                                          for k, v in st.items()},
             params=None, t=np.float32(t), dt=1e-6, t_base_util=1e-5,
             **{k: jnp.asarray(v) for k, v in case.items()}, **kw)
    return ({k: np.asarray(v) for k, v in out[0].items()},
            np.asarray(out[1]), np.asarray(out[2]))


@pytest.mark.parametrize("n", [200, 1500, 7936])
@pytest.mark.parametrize("lossy", [False, True], ids=["lossless", "lossy"])
@pytest.mark.parametrize("name", list(pcc.ALL_POLICIES))
def test_fused_step_ref_matches_reference(name, lossy, n):
    case, rng = _case(n, lossy, seed=n + lossy)
    st = _state(name, n, rng)
    _compare(_port(name, case, st, 3.3e-4),
             _reference(name, case, st, 3.3e-4), rtol=1e-5)


@pytest.mark.parametrize("name", list(pcc.ALL_POLICIES))
def test_fused_step_ref_matches_pallas_interpret_at_200(name):
    case, rng = _case(200, True, seed=9)
    st = _state(name, 200, rng)
    _compare(_port(name, case, st, 3.3e-4),
             _reference(name, case, st, 3.3e-4, pallas=True), rtol=1e-5)


@pytest.mark.parametrize("name", ["dcqcn", "timely", "pfc", "mlp"])
def test_wrapper_on_cpu_is_the_plain_version(name):
    """The wrapper in the kernel's layout (B lanes, hop-major, packed
    state and per-lane params) equals the flat plain version per lane."""
    pol = pcc.get_policy(name)
    B, n = 2, 333
    lanes = [_case(n, True, seed=20 + b) for b in range(B)]
    states = [_state(name, n, lane[1]) for lane in lanes]
    hop = [torch.from_numpy(np.stack([lane[0][k].T for lane in lanes]))
           .contiguous() for k in HOP_KEYS]
    flat = [torch.from_numpy(np.stack([lane[0][k] for lane in lanes]))
            for k in ("base_rtt", "line", "loss")]
    packed = torch.stack([pcc.pack_state(pol, {k: torch.from_numpy(v)
                                               for k, v in s.items()},
                                         n_flows=n) for s in states])
    params = torch.stack([pcc.pack_params(
        pol, {k: v * (1 + 0.1 * b) for k, v in pol.params.items()})
        for b in range(B)])
    before = dict(p_ops.LAUNCHES)
    st_out, rate, win = p_ops.fused_signals_policy(
        pol, *hop, *flat, packed, params, 3.3e-4, 1e-5, 1e-6)
    assert p_ops.LAUNCHES == before        # plain versions never count
    keys = pcc.kernel_state_keys(pol)
    for b in range(B):
        par = dict(zip(pcc.kernel_param_keys(pol), params[b].tolist()))
        want = p_ref.fused_step_ref(
            pol, state={k: torch.from_numpy(states[b][k]) for k in keys},
            params=par, t=3.3e-4, dt=1e-6, t_base_util=1e-5,
            **{k: torch.from_numpy(v) for k, v in lanes[b][0].items()})
        assert torch.equal(rate[b], want[1].expand(n))
        assert torch.equal(win[b], want[2].expand(n))
        for j, k in enumerate(keys):
            assert torch.equal(st_out[b, j], want[0][k]), k


@pytest.mark.parametrize("C", [4, 16, 32, 64])
def test_segment_reduce_matches_reference(C):
    rng = np.random.default_rng(C)
    n_in, n_out = 777, 21
    vals = rng.uniform(0, 1e6, n_in).astype(np.float32)
    idx = np.minimum(rng.integers(0, n_in + 50, n_out * C), n_in)
    want = np.asarray(r_ref.segment_reduce_ref(
        jnp.asarray(vals), jnp.asarray(idx, jnp.int32), n_out, C))
    got = p_ref.segment_reduce_ref(torch.from_numpy(vals),
                                   torch.as_tensor(idx, dtype=torch.int32),
                                   n_out, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # the wrapper's CPU branch with a lane axis
    got2 = p_ops.segment_reduce(torch.from_numpy(vals)[None],
                                torch.as_tensor(idx, dtype=torch.int32),
                                n_out, C)
    assert torch.equal(got2[0], got)


def test_segment_reduce_pfc_matches_reference():
    rng = np.random.default_rng(5)
    n_in, n_out, C = 512, 17, 32
    vals = rng.uniform(0, 2e6, n_in).astype(np.float32)
    idx = rng.integers(0, n_in, n_out * C).astype(np.int32)
    xoff = rng.uniform(5e6, 20e6, n_out).astype(np.float32)
    xon = (xoff * 0.8).astype(np.float32)
    can = rng.random(n_out) < 0.5
    prev = rng.random(n_out) < 0.5
    q_r, p_r = r_ref.segment_reduce_pfc_ref(
        jnp.asarray(vals), jnp.asarray(idx), n_out, C, jnp.asarray(xoff),
        jnp.asarray(xon), jnp.asarray(can), jnp.asarray(prev))
    q, paused = p_ops.segment_reduce_pfc(
        torch.from_numpy(vals)[None], torch.from_numpy(idx), n_out, C,
        torch.from_numpy(xoff)[None], torch.from_numpy(xon)[None],
        torch.from_numpy(can)[None], torch.from_numpy(prev)[None])
    np.testing.assert_allclose(q[0].numpy(), np.asarray(q_r), rtol=1e-6)
    q_r = np.asarray(q_r)
    clear = (np.abs(q_r - xoff) > 1e-5 * q_r) & (np.abs(q_r - xon)
                                                  > 1e-5 * q_r)
    assert clear.sum() > n_out // 2
    np.testing.assert_array_equal(paused[0].numpy()[clear],
                                  np.asarray(p_r)[clear])
