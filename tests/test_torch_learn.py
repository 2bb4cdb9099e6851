"""The learned policy ``mlp`` (``repro_torch.learn.net``) against the
reference's (``repro.learn.net``): its elementary functions, its update
inside the engine step, its weights and registry entry, and
``examples/learn_cc.py``'s curriculum scenarios.

The update is held bit for bit: the reference's compiled step evaluates
``tanh`` and the logistic by its own expansions (``arith.tanhf``,
``arith.sigmoidf``), rewrites ``(q / b) / (1 + qd)`` as ``q / (b * (1 +
qd))`` and contracts the dot products and the tracking updates into
FMAs, and the port does the same.
"""
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cc as rcc
from repro.core import engine as reng
from repro.core import sweep as rsweep
from repro.core.faults import FaultSpec as RFaultSpec
from repro.core.scenario import FabricSpec as RFabricSpec
from repro.core.scenario import IncastSpec as RIncastSpec
from repro.core.scenario import ScenarioSpec as RScenarioSpec
from repro.core.topology import clos, single_switch
from repro.core.collectives import allreduce_1d, incast
from repro.learn import net as rnet
from repro_torch import convert
from repro_torch.core import cc as pcc
from repro_torch.core import engine as peng
from repro_torch.core import sweep as psweep
from repro_torch.core.arith import sigmoidf, tanhf
from repro_torch.core.faults import FaultSpec
from repro_torch.core.scenario import FabricSpec, IncastSpec, ScenarioSpec
from repro_torch.learn import net as pnet

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _values(n=100_000, seed=0):
    rng = np.random.default_rng(seed)
    x = np.concatenate([
        rng.uniform(-10, 10, n), rng.uniform(-4e-4, 4e-4, n // 5),
        rng.normal(0, 1, n), rng.uniform(-100, 100, n // 5),
        np.float32([0.0, -0.0, 7.9988117, 8.0, -8.0, 4e-4, -4e-4, 1e-38,
                    1e-45, 88.0, -88.0, 104.0, -104.0, np.inf, -np.inf])])
    return x.astype(np.float32)


@pytest.mark.parametrize("name", ["tanh", "sigmoid"])
def test_elementary_functions_bit_equal(name):
    x = _values()
    assert np.sum(np.abs(x) < 4e-4) > 10_000 and np.sum(np.abs(x) > 8) > 10_000
    got = (tanhf if name == "tanh" else sigmoidf)(torch.from_numpy(x))
    want = (jnp.tanh if name == "tanh" else jax.nn.sigmoid)(jnp.asarray(x))
    assert np.array_equal(got.numpy().view(np.int32),
                          np.asarray(want).view(np.int32))
    assert torch.isnan(tanhf(torch.tensor([float("nan")]))).all()


def _flat(c):
    out = {}
    for k, v in c.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": np.asarray(vv) for kk, vv in v.items()})
        else:
            out[k] = np.asarray(v)
    return out


@pytest.mark.parametrize("case", ["incast_lossless", "incast_gbn",
                                  "clos_lossless"])
def test_update_bit_equal_inside_the_step(case):
    """Every step from the reference's carry: the port's op-path step
    gives the reference's compiled step's ``mlp`` state, rate-driven
    injection and (lossy) loss signal bit for bit."""
    if case.startswith("incast"):
        topo = single_switch(8)
        sched = incast(topo, list(range(1, 8)), 0, 5e6)
    else:
        topo = clos(n_racks=2, nodes_per_rack=1, gpus_per_node=4)
        sched = allreduce_1d(topo, list(range(8)), 4e6)
    fault = (dict(loss_rate=1e-3, gbn=1.0, pfc_on=1.0)
             if case == "incast_gbn" else {})
    faulty = bool(fault)
    cfg = reng.EngineConfig(dt=1e-6, max_steps=1500, max_extends=3,
                            queue_stride=0, step_impl="jnp")
    rpol = rcc.get_policy("mlp")
    pp, plan = reng._prep(topo, sched, cfg)
    carry = reng._init_carry(pp, plan, rpol, cfg, rpol.params, faulty)
    step = jax.jit(reng._make_step(rpol, cfg, plan, faulty))
    fab, flt = reng.FabricParams.from_config(cfg), RFaultSpec(**fault)
    params = {k: jnp.float32(v) for k, v in rpol.params.items()}
    sim = peng.Simulator(convert.topology_from_numpy(topo),
                         convert.schedule_from_numpy(sched),
                         pcc.get_policy("mlp"), peng.EngineConfig(
                             dt=1e-6, max_steps=1500, max_extends=3,
                             queue_stride=0), device="cpu",
                         fault_spec=FaultSpec(**fault))
    pstep = peng._make_step(sim.policy, sim.cfg, sim.plan, sim.pp, None,
                            sim.fabric, False, 1, sim.fault)
    keys = ["cc.rate", "cc.win", "cc.bdp", "cc.fanin", "injected"]
    keys += ["lost", "dup", "loss_sig"] if faulty else []
    for it in range(150):
        new = step(carry, jnp.int32(it), pp, params, fab, flt)
        lane = convert.carry_from_numpy(jax.tree_util.tree_map(
            lambda x: np.asarray(x)[None], carry))
        got = _flat(convert.carry_to_numpy(pstep(lane, it)))
        want = _flat(new)
        for k in keys:
            assert np.array_equal(got[k][0].view(np.int32),
                                  want[k].view(np.int32)), (it, k)
        carry = new


def test_weights_json_is_the_reference_copy():
    mine = os.path.join(REPO, "src", "repro_torch", "learn",
                        "mlp_weights.json")
    theirs = os.path.join(REPO, "src", "repro", "learn", "mlp_weights.json")
    assert filecmp.cmp(mine, theirs, shallow=False)
    assert pnet.default_weights() == rnet.default_weights()


def test_make_mlp_matches_reference_and_checks_weights():
    assert pnet.WEIGHT_KEYS == rnet.WEIGHT_KEYS
    assert (pnet.N_FEATURES, pnet.HIDDEN) == (rnet.N_FEATURES, rnet.HIDDEN)
    assert pnet.init_weights(3) == rnet.init_weights(3)
    p, r = pnet.make_mlp(), rnet.make_mlp()
    assert p.params == r.params
    assert (p.kind, p.loss_aware, p.wire_factor) == \
        (r.kind, r.loss_aware, r.wire_factor)
    assert pcc.kernel_param_keys(p) == rcc.kernel_param_keys(r)
    assert pcc.kernel_state_keys(p) == rcc.kernel_state_keys(r)
    assert len(pcc.kernel_param_keys(p)) == 40
    w = dict(pnet.default_weights(), w1_00=20.0)
    assert pnet.make_mlp(w).params["w1_00"] == 8.0 == \
        rnet.make_mlp(w).params["w1_00"]
    with pytest.raises(ValueError, match="cover exactly"):
        pnet.make_mlp({k: 0.0 for k in pnet.WEIGHT_KEYS[:-1]})
    with pytest.raises(ValueError, match="cover exactly"):
        pnet.make_mlp(dict(pnet.default_weights(), w9_99=0.0))
    p2 = pnet.make_mlp(out_gain=0.5, loss_cut=2.0)
    assert p2.params == rnet.make_mlp(out_gain=0.5, loss_cut=2.0).params
    assert pcc.get_policy("mlp").params == p.params


def test_stack_policies_with_mlp():
    """``mlp`` as a policy-axis member: namespaced params, and a batch
    lane equal to the reference's vmapped lane and to the serial run."""
    st = pcc.stack_policies(["dcqcn", "mlp"])
    assert st.members == ("dcqcn", "mlp")
    assert "mlp.w1_00" in st.spec and "mlp.out_gain" in st.spec
    assert st.loss_aware
    topo = single_switch(8)
    sched = incast(topo, list(range(1, 8)), 0, 1e6)
    cfg = dict(dt=2e-6, max_steps=800, max_extends=0, queue_stride=0)
    pt, ps = (convert.topology_from_numpy(topo),
              convert.schedule_from_numpy(sched))
    runner = psweep.SweepRunner(peng.EngineConfig(**cfg), device="cpu")
    batch = runner.run_policy_axis(pt, ps, ["dcqcn", "mlp"],
                                   cc_overrides=[None, {"out_gain": 0.5}])
    ref = rsweep.SweepRunner(reng.EngineConfig(**cfg, step_impl="jnp")) \
        .run_policy_axis(topo, sched, ["dcqcn", "mlp"],
                         cc_overrides=[None, {"out_gain": 0.5}])
    assert np.array_equal(batch.t_finish, np.asarray(ref.t_finish))
    serial = runner.run(pt, ps, "mlp", cc_params={"out_gain": 0.5})
    assert np.array_equal(serial.t_finish, batch.t_finish[1])
    assert np.array_equal(serial.delivered, batch.delivered[1])


CURRICULUM = {"incast8": None,
              "incast8_gbn": ("lossy_roce", 1e-3, "gbn")}


@pytest.mark.parametrize("name", list(CURRICULUM))
def test_learn_cc_curriculum_scenarios(name):
    """``examples/learn_cc.py``'s two curriculum scenarios under the
    committed weights, against the reference, on the op path and on the
    kernel path's plain versions (bit for bit)."""
    cfg = dict(dt=2e-6, max_steps=1500, max_extends=0, queue_stride=0)
    fault = CURRICULUM[name]
    rspec = RScenarioSpec(RFabricSpec(family="single", n_racks=1,
                                      nodes_per_rack=1, gpus_per_node=8),
                          RIncastSpec(7, 2e6), "mlp", name=name,
                          fault_spec=(None if fault is None else
                                      RFaultSpec.lossy_roce(*fault[1:])))
    pspec = ScenarioSpec(FabricSpec(family="single", n_racks=1,
                                    nodes_per_rack=1, gpus_per_node=8),
                         IncastSpec(7, 2e6), "mlp", name=name,
                         fault_spec=(None if fault is None else
                                     FaultSpec.lossy_roce(*fault[1:])))
    ref = rsweep.SweepRunner(reng.EngineConfig(**cfg, step_impl="jnp")) \
        .run_spec(rspec)
    runs = {impl: psweep.SweepRunner(peng.EngineConfig(**cfg, step_impl=impl)
                                     if impl == "torch" else
                                     peng.EngineConfig(**cfg), device="cpu")
            .run_spec(pspec) for impl in ("torch",)}
    got = runs["torch"]
    assert got.finished == ref.finished
    assert np.array_equal(got.t_finish, ref.t_finish)
    assert np.array_equal(got.delivered, ref.delivered)
    if fault is not None:
        assert np.array_equal(got.lost, ref.lost) and got.lost.sum() > 0
    # the kernel path's plumbing (plain versions on CPU tensors)
    topo, sched, pol = pspec.build()
    sim = peng.Simulator(topo, sched, pol, peng.EngineConfig(**cfg),
                         device="cpu", fault_spec=pspec.fault_spec)
    sim.step_impl = "cuda"
    kern = sim.run()
    assert np.array_equal(kern.t_finish, got.t_finish)
    assert np.array_equal(kern.delivered, got.delivered)
