"""Gradients through the port's simulator (``Simulator.soft_cost_fn``)
against the reference's (``repro.core.engine``), on the CPU.

The reference differentiates its fixed-length scan with ``jax.grad``; the
port runs the same steps under autograd.  Forward values are held bit for
bit; gradients within rtol 1e-3 (measured: at most 6.4e-6 relative on
these cases, where a gradient is not zero).  What makes the two agree,
each held here on its own:

* the tie rule: ``jnp.maximum``/``jnp.minimum``/``jnp.clip`` give each
  side half the gradient of a tie, ``torch.clamp`` all of it to ``x``, so
  the port's ``_max``/``_min``/``_clip`` take ``torch.maximum``/
  ``torch.minimum`` against a tensor bound;
* the scalar functions: ``expf``, ``tanhf``, ``sigmoidf`` emulate XLA's
  expansions bit for bit, but are differentiated by JAX's rules for
  ``exp``, ``tanh`` and the logistic, and the subnormal flush ``ftz`` is
  straight-through;
* halted lanes: under ``vmap`` the reference's step gate is a select, so
  a lane that halts early is frozen while the others step.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cc as rcc
from repro.core import engine as reng
from repro.core.collectives import incast as rincast
from repro.core.faults import FaultSpec as RFaultSpec
from repro.core.topology import single_switch as rsingle
from repro.learn import net as rnet
from repro_torch.core import cc as pcc
from repro_torch.core import engine as peng
from repro_torch.core.arith import expf, ftz, sigmoidf, tanhf
from repro_torch.core.collectives import incast
from repro_torch.core.faults import FaultSpec
from repro_torch.core.topology import single_switch
from repro_torch.learn import net as pnet

torch.set_num_threads(1)

RTOL = 1e-3


# ---------------------------------------------------------------------------
# tie rules and scalar functions
# ---------------------------------------------------------------------------

_TIES = [
    # (port fn, reference fn, x, bound): a tie, below and above the bound
    (pcc._max, jnp.maximum, v, b) for v, b in ((1.0, 1.0), (0.5, 1.0),
                                                (2.0, 1.0), (0.0, 0.0))
] + [
    (pcc._min, jnp.minimum, v, b) for v, b in ((1.0, 1.0), (0.5, 1.0),
                                                (2.0, 1.0), (1e-9, 1e-9))
]


@pytest.mark.parametrize("tensor_bound", [False, True])
@pytest.mark.parametrize("pfn,rfn,x,b", _TIES)
def test_max_min_tie_rule(pfn, rfn, x, b, tensor_bound):
    want_x, want_b = jax.grad(rfn, argnums=(0, 1))(jnp.float32(x),
                                                   jnp.float32(b))
    xt = torch.tensor(x, dtype=torch.float32, requires_grad=True)
    bt = torch.tensor(b, dtype=torch.float32, requires_grad=True)
    y = pfn(xt, bt if tensor_bound else b)
    assert float(y) == float(rfn(jnp.float32(x), jnp.float32(b)))
    y.backward()
    assert float(xt.grad) == float(want_x)
    if tensor_bound:
        assert float(bt.grad) == float(want_b)


@pytest.mark.parametrize("x", [-0.5, 0.0, 0.25, 1.0, 1.5])
def test_clip_tie_rule(x):
    want = float(jax.grad(lambda v: jnp.clip(v, 0.0, 1.0))(jnp.float32(x)))
    xt = torch.tensor(x, dtype=torch.float32, requires_grad=True)
    pcc._clip(xt, 0.0, 1.0).backward()
    assert float(xt.grad) == want
    # without a gradient to carry, the same values in one clamp
    assert float(pcc._clip(torch.tensor(x), 0.0, 1.0)) == float(
        jnp.clip(jnp.float32(x), 0.0, 1.0))


def _inputs(n=20_000, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(0, 3, n), rng.uniform(-90, 90, n // 4),
                           np.float32([0.0, 4e-4, -4e-4, 1e-38, 8.0, -8.0])]
                          ).astype(np.float32)


@pytest.mark.parametrize("name", ["exp", "tanh", "sigmoid", "ftz"])
def test_scalar_function_gradients(name):
    """Values bit-equal to the reference's, gradients by its rules:
    ``g*out`` (equal to jax's bit for bit), ``(g + g*out)*(1 - out)``
    (within 1.2e-7 of jax's, which rounds its own way), ``g*out*(1-out)``
    and the identity."""
    x = _inputs()
    if name == "exp":
        x = x[x < 80]
    pfn, rfn = {"exp": (expf, jnp.exp), "tanh": (tanhf, jnp.tanh),
                "sigmoid": (sigmoidf, jax.nn.sigmoid),
                "ftz": (ftz, lambda v: v)}[name]
    xt = torch.tensor(x, requires_grad=True)
    y = pfn(xt)
    y.backward(torch.ones_like(y))
    want = np.asarray(jax.vmap(jax.grad(rfn))(jnp.asarray(x)))
    if name != "ftz":
        assert np.array_equal(y.detach().numpy(), np.asarray(rfn(x)))
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=0, atol=1.2e-7)
    # the forward-only path is the emulation itself
    assert not pfn(torch.tensor(x)).requires_grad


# ---------------------------------------------------------------------------
# soft cost: value and gradient against the reference
# ---------------------------------------------------------------------------

CFG_GBN = dict(dt=2e-6, max_steps=900, max_extends=0, queue_stride=0)
CFG_DCQCN = dict(dt=2e-6, max_steps=500, max_extends=0, queue_stride=0)
FAB_KEYS = ("kmin", "kmax", "pmax")

_REF = {}


def _gbn_weights():
    w = rnet.init_weights(0)
    w["b2_0"] = -4.0
    w["b2_1"] = 0.0
    return w


def _case(name):
    """``(reference sim, port sim, cc keys)`` of a case: the lossy
    go-back-N incast of ``tests/test_learn.py`` under ``mlp``, or the
    DCQCN incast of ``tests/test_scenario.py``."""
    if name == "mlp_gbn":
        w = _gbn_weights()
        r = reng.Simulator(rsingle(8), rincast(rsingle(8), list(range(1, 8)),
                                               0, 2e6),
                           rnet.make_mlp(weights=w),
                           reng.EngineConfig(**CFG_GBN),
                           fault_spec=RFaultSpec.lossy_roce(2e-3, "gbn"))
        p = peng.Simulator(single_switch(8),
                           incast(single_switch(8), list(range(1, 8)), 0,
                                  2e6),
                           pnet.make_mlp(weights=w),
                           peng.EngineConfig(**CFG_GBN),
                           fault_spec=FaultSpec.lossy_roce(2e-3, "gbn"),
                           device="cpu")
        return r, p, ("b2_0", "b2_1", "w1_01", "w2_12", "b1_3")
    r = reng.Simulator(rsingle(8), rincast(rsingle(8), list(range(1, 8)), 0,
                                           3e6),
                       rcc.get_policy("dcqcn"), reng.EngineConfig(**CFG_DCQCN))
    p = peng.Simulator(single_switch(8),
                       incast(single_switch(8), list(range(1, 8)), 0, 3e6),
                       pcc.get_policy("dcqcn"),
                       peng.EngineConfig(**CFG_DCQCN), device="cpu")
    return r, p, ("rai_frac", "rhai_frac", "g")


def _reference(name):
    """The reference's soft cost and its gradients w.r.t. the case's CC
    keys and fabric keys (non-remat scan), cached per case."""
    if name not in _REF:
        rsim, psim, keys = _case(name)
        params = dict(rsim.policy.params)
        cost = rsim.soft_cost_fn()

        def f(p, fab):
            return cost(dict(params, **p), fab)

        v, (g, gf) = jax.value_and_grad(f, argnums=(0, 1))(
            {k: jnp.float32(params[k]) for k in keys}, reng.FabricParams())
        _REF[name] = (psim, keys, float(v), {k: float(g[k]) for k in keys},
                      {k: float(getattr(gf, k)) for k in FAB_KEYS})
    return _REF[name]


def _port(psim, keys, remat):
    params = {k: torch.tensor(np.float32(psim.policy.params[k]),
                              requires_grad=True) for k in keys}
    fab = {k: torch.tensor(np.float32(getattr(peng.FabricParams(), k)),
                           requires_grad=True) for k in FAB_KEYS}
    v = psim.soft_cost_fn(remat=remat)(params, peng.FabricParams(**fab))
    v.backward()
    return v, {k: float(t.grad) for k, t in params.items()}, \
        {k: float(t.grad) for k, t in fab.items()}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", ["mlp_gbn", "dcqcn"])
def test_soft_cost_value_and_gradient(name, remat):
    psim, keys, want, want_g, want_gf = _reference(name)
    v, g, gf = _port(psim, keys, remat)
    assert float(v) == want                     # bit for bit
    # the forward-only run's soft cost, the same bits
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # budget warning
        assert psim.run().soft_cost == want
    assert any(g[k] != 0.0 for k in keys)
    for k in keys:
        np.testing.assert_allclose(g[k], want_g[k], rtol=RTOL, err_msg=k)
    for k in FAB_KEYS:
        assert want_gf[k] != 0.0
        np.testing.assert_allclose(gf[k], want_gf[k], rtol=RTOL, err_msg=k)


def test_remat_forward_bitwise_and_chunk_independent():
    psim, keys, want, *_ = _reference("mlp_gbn")
    for chunk in (64, 256, 900):
        cfg = dataclasses.replace(psim.cfg, chunk_steps=chunk)
        s = peng.Simulator(psim.topo, psim.sched, psim.policy, cfg,
                           fault_spec=psim.fault, device="cpu")
        with torch.no_grad():
            assert float(s.soft_cost_fn(remat=True)()) == want


def test_remat_rejects_early_exit():
    psim = _reference("dcqcn")[0]
    with pytest.raises(ValueError, match="remat"):
        peng._run_remat(None, [], psim.cfg, early_exit=True)


def test_cuda_step_impl_raises_for_gradients():
    """The kernels have no backward: an explicit ``step_impl="cuda"``
    refuses the differentiable entry point (checked without a card by
    setting the config after construction); ``"auto"`` takes the op
    path."""
    psim = _reference("dcqcn")[0]
    sim = peng.Simulator(psim.topo, psim.sched, psim.policy, psim.cfg,
                         device="cpu")
    sim.cfg = dataclasses.replace(sim.cfg, step_impl="cuda")
    with pytest.raises(NotImplementedError, match="backward kernels"):
        sim.soft_cost_fn()
    with pytest.raises(NotImplementedError, match="backward kernels"):
        sim.soft_cost()


def test_tensor_inputs_keep_the_graph():
    """``_lane_params``, ``_class_table`` and ``pack_params`` take tensors
    without a numpy round trip."""
    pol = pcc.get_policy("dcqcn")
    g = torch.tensor(0.01, requires_grad=True)
    cols = peng._lane_params(pol, {"g": g}, 3, "cpu")
    assert cols["g"].shape == (3, 1) and cols["g"].requires_grad
    tab = peng._class_table(torch.tensor([1.0, 2.0], requires_grad=True),
                            2, "cpu")
    assert tab.shape == (2, peng.N_LINK_CLASSES) and tab.requires_grad
    packed = pcc.pack_params(pol, {"g": g})
    assert packed.requires_grad
    assert torch.equal(packed.detach(), pcc.pack_params(pol, {"g": 0.01}))


# ---------------------------------------------------------------------------
# lanes: the reference's vmapped fixed-length scan
# ---------------------------------------------------------------------------

LANE_CFG = dict(dt=1e-6, max_steps=500, max_extends=0, queue_stride=0)
# lane 1 (slow recovery under early, certain marking) halts about 100
# steps after lane 0 (the defaults)
LANE_CC = {"rai_frac": np.float32([0.03, 1e-4]), "g": np.float32([1 / 256,
                                                                  1.0]),
           "timer": np.float32([55e-6, 200e-6])}
LANE_FAB = {"kmin": np.float32([400e3, 5e3]),
            "kmax": np.float32([1600e3, 20e3]), "pmax": np.float32([0.2, 1.0])}


def test_two_lanes_one_halting_early():
    """Two lanes of one DCQCN incast, the first halting about 100 steps
    before the second: each lane's value and gradients equal the
    reference's ``vmap`` of its fixed-length cost.  The first lane's
    gradients (w.r.t. kmin, kmax, pmax; the rest are zero) pass through
    the steps it sits frozen while the second lane steps."""
    rt = rsingle(4)
    rsim = reng.Simulator(rt, rincast(rt, [1, 2, 3], 0, 2e6),
                          rcc.get_policy("dcqcn"),
                          reng.EngineConfig(**LANE_CFG))
    pt = single_switch(4)
    psim = peng.Simulator(pt, incast(pt, [1, 2, 3], 0, 2e6),
                          pcc.get_policy("dcqcn"),
                          peng.EngineConfig(**LANE_CFG), device="cpu")
    base = dict(rsim.policy.params)
    cost = rsim.soft_cost_fn()
    fab0 = reng.FabricParams()

    def f(rai, kmin, g, timer, kmax, pmax):
        return cost(dict(base, rai_frac=rai, g=g, timer=timer),
                    fab0.replace(kmin=kmin, kmax=kmax, pmax=pmax))

    args = [jnp.asarray(v) for v in (LANE_CC["rai_frac"], LANE_FAB["kmin"],
                                     LANE_CC["g"], LANE_CC["timer"],
                                     LANE_FAB["kmax"], LANE_FAB["pmax"])]
    want, grads = jax.vmap(jax.value_and_grad(f, argnums=tuple(range(6))))(
        *args)
    ends = []
    for i in range(2):
        r = psim.run(cc_params={k: float(v[i]) for k, v in LANE_CC.items()},
                     fabric_params=peng.FabricParams(
                         **{k: float(v[i]) for k, v in LANE_FAB.items()}))
        assert r.finished
        ends.append(r.completion_time / LANE_CFG["dt"])
    assert ends[1] - ends[0] > 90

    cc = {k: torch.tensor(v, requires_grad=True) for k, v in LANE_CC.items()}
    fl = {k: torch.tensor(v, requires_grad=True) for k, v in LANE_FAB.items()}
    fab = peng.FabricParams(xoff=np.float32([1e6] * 2),
                            xon=np.float32([0.8e6] * 2), **fl)
    got = psim.soft_cost_fn(lanes=2)(cc, fab)
    got.sum().backward()
    assert np.array_equal(got.detach().numpy(), np.asarray(want))
    ts = [cc["rai_frac"], fl["kmin"], cc["g"], cc["timer"], fl["kmax"],
          fl["pmax"]]
    nonzero = 0
    for t, g in zip(ts, grads):
        g = np.asarray(g)
        nonzero += int((g != 0).sum())
        # no graph path (timer only gates comparisons): a zero gradient
        got_g = np.zeros(2) if t.grad is None else t.grad.numpy()
        np.testing.assert_allclose(got_g, g, rtol=RTOL)
    assert nonzero >= 3


def test_select_gate_runs_on_while_a_lane_diverged():
    """A diverged lane keeps the batched loop running to the full length
    (the reference's select computes every step); a finished batch
    stops."""
    B = 2
    done = torch.ones((B, 3), dtype=torch.bool)
    carry = {"done": done, "diverged": torch.tensor([False, False])}
    assert peng._gate(carry, select=True)[0]
    carry["diverged"] = torch.tensor([False, True])
    stop, live, stepping = peng._gate(carry, select=True)
    assert not stop and not live.any() and not stepping.any()
    assert peng._gate(carry, select=False)[0]
