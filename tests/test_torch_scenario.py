"""Scenario specs and the serial sweep runner of the port against the
reference's: the same spec gives the same result (tolerances of
``tests/test_torch_engine.py``)."""
import dataclasses

import numpy as np
import pytest

from repro.core import engine as reng
from repro.core import scenario as rscen
from repro.core.sweep import SweepRunner as RSweepRunner
from repro_torch import convert
from repro_torch.core import engine as peng
from repro_torch.core import scenario as pscen
from repro_torch.core.sweep import SweepRunner, _bucket
from test_torch_engine import assert_runs_agree

CFG = dict(dt=2e-6, max_steps=1500, max_extends=1, queue_stride=0)


def _specs(mod, policy, **kw):
    return mod.ScenarioSpec(
        fabric=mod.FabricSpec("clos", n_racks=1, nodes_per_rack=2,
                              gpus_per_node=4),
        workload=mod.CollectiveSpec("ring", 8e6), policy=policy, **kw)


@pytest.mark.parametrize("policy,cc_params", [
    ("dcqcn", None), ("hpcc", {"eta": 0.9}), ("timely", {"beta": 0.6})])
def test_run_spec_matches_reference(policy, cc_params):
    ref = RSweepRunner(reng.EngineConfig(step_impl="jnp", **CFG)).run_spec(
        _specs(rscen, policy, cc_params=cc_params))
    port = SweepRunner(peng.EngineConfig(**CFG), device="cpu").run_spec(
        _specs(pscen, policy, cc_params=convert.cc_params(cc_params)))
    assert_runs_agree(port, ref, CFG["dt"])
    assert port.meta["steps_run"] == ref.meta["steps_run"]


def test_bucketing_and_simulator_cache():
    runner = SweepRunner(peng.EngineConfig(**CFG), device="cpu")
    topo, sched, pol = _specs(pscen, "pfc").build()
    sim = runner.simulator(topo, sched, pol)
    assert sim.plan.n_flows_pad == _bucket(sched.n_flows)
    assert sim.plan.n_groups_pad == _bucket(sched.n_groups, lo=8)
    # fabric scalars arrive per run: one prepared simulator serves both
    other = dataclasses.replace(runner.cfg, kmin=200e3)
    assert runner.simulator(topo, sched, pol, other) is sim
    results = runner.run_policies(topo, sched, ["pfc", "static_window"])
    assert [r.meta["policy"] for r in results] == ["pfc", "static_window"]
    assert all(r.finished for r in results)


def test_policy_axis_belongs_to_the_batched_slice():
    """A tuple policy runs batched (``grid_spec``, ``test_torch_sweep*``);
    ``run_spec`` refuses it, as the reference's does."""
    spec = _specs(pscen, ("dcqcn", "hpcc"))
    with pytest.raises(ValueError, match="policy axis"):
        SweepRunner(peng.EngineConfig(**CFG), device="cpu").run_spec(spec)
    assert spec.build()[2].members == ("dcqcn", "hpcc")
    (stacked,) = pscen.scenario_matrix([pscen.FabricSpec()],
                                       [pscen.CollectiveSpec("1d", 1e6)],
                                       ["pfc", "dcqcn"], stacked=True)
    assert stacked.policy == ("pfc", "dcqcn")
    assert stacked.name == "clos32_1d_stack"


def test_scenario_matrix_and_specs_match_reference():
    fabs = [pscen.FabricSpec(n_racks=1), pscen.FabricSpec(n_racks=2)]
    wls = [pscen.CollectiveSpec("1d", 1e6), pscen.IncastSpec(3, 1e6)]
    specs = pscen.scenario_matrix(fabs, wls, ["pfc", "dcqcn"])
    rspecs = rscen.scenario_matrix(
        [rscen.FabricSpec(n_racks=1), rscen.FabricSpec(n_racks=2)],
        [rscen.CollectiveSpec("1d", 1e6), rscen.IncastSpec(3, 1e6)],
        ["pfc", "dcqcn"])
    assert [s.name for s in specs] == [s.name for s in rspecs]
    for s, r in zip(specs[::3], rspecs[::3]):
        topo, sched, pol = s.build()
        rtopo, rsched, rpol = r.build()
        assert pol.name == rpol.name
        assert np.array_equal(topo.cap, rtopo.cap)
        assert np.array_equal(sched.path, rsched.path)
    assert pscen.FabricSpec(oversubscription=2.0).spine_count == 8
    with pytest.raises(ValueError, match="senders"):
        pscen.IncastSpec(99, 1e6).build_schedule(
            pscen.FabricSpec(n_racks=1).build())
