"""Run-health lanes, spec-driven grids and input checks of the port's
batched sweeps against the reference's (helpers and tolerances of
``test_torch_sweep.py``).

The unhealthy lanes are ``tests/test_faults.py:273-318``'s: a PFC
deadlock on a 3-switch ring, a NaN ``g`` that diverges, and lanes that
run out of step budget, each beside a healthy lane, with the
deduplicated unhealthy-lane warning.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro.core import cc as rcc
from repro.core import scenario as rscen
from repro.core import sweep as rsweep
from repro.core.collectives import Schedule as RSchedule
from repro.core.topology import NIC_BW, NIC_LAT, SWITCH_BUF, _Builder
from repro_torch import convert
from repro_torch.core import cc as pcc
from repro_torch.core import engine as peng
from repro_torch.core import scenario as pscen
from repro_torch.core import sweep as psweep
from repro_torch.core import FaultSpec
from test_torch_sweep import CFG, _case, _runners, assert_batches_agree


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _rearm_unhealthy_warning():
    rsweep.reset_unhealthy_warnings()
    psweep.reset_unhealthy_warnings()


def _ring_case(size=2e6):
    """``tests/test_faults.py``'s 3-switch directed ring (a PFC deadlock
    with small thresholds)."""
    b = _Builder("ring3")
    for g in range(3):
        b.add_dev(f"gpu{g}", False)
    sw = [b.add_dev(f"sw{i}", True, SWITCH_BUF) for i in range(3)]
    up = [b.add_link(g, sw[g], NIC_BW, NIC_LAT, ecn=False) for g in range(3)]
    ring = [b.add_link(sw[i], sw[(i + 1) % 3], NIC_BW, NIC_LAT, ecn=True,
                       cls="tor_up") for i in range(3)]
    down = [b.add_link(sw[g], g, NIC_BW, NIC_LAT, ecn=True, cls="tor_down")
            for g in range(3)]
    topo = b.build(3, up, {"kind": "ring", "switches": sw})
    path = np.full((3, 4), -1, np.int32)
    for i in range(3):
        path[i] = [up[i], ring[i], ring[(i + 1) % 3], down[(i + 2) % 3]]
    sched = RSchedule(path, np.full(3, 4, np.int32),
                      np.full(3, size, np.float32), np.zeros(3, np.int32),
                      np.full(3, -1, np.int32), np.zeros(3, np.float32),
                      n_groups=1, group_names=["g0"])
    return (topo, sched), (convert.topology_from_numpy(topo),
                           convert.schedule_from_numpy(sched))


def _unhealthy(kind):
    """``tests/test_faults.py:273-318``: (case, cfg, call, statuses)."""
    if kind == "deadlocked":
        return (_ring_case(), dict(max_steps=600, max_extends=0),
                lambda r, t, s: r.run_batch(t, s, "pfc", stacked_fabric={
                    "xoff": np.asarray([30e3, 32e6], np.float32),
                    "xon": np.asarray([15e3, 16e6], np.float32)}),
                ["deadlocked", "ok"])
    if kind == "diverged":
        return (_case(2e6), dict(max_steps=1500, max_extends=3),
                lambda r, t, s: r.run_batch(t, s, "dcqcn", {
                    "g": np.asarray([np.nan, 1 / 256], np.float32)}),
                ["diverged", "ok"])
    return (_case(5e6), dict(max_steps=10, max_extends=0),
            lambda r, t, s: r.grid(t, s, "dcqcn", {"g": [1 / 256, 1 / 128]}),
            ["exhausted", "exhausted"])


@pytest.mark.parametrize("kind", ["deadlocked", "diverged", "exhausted"])
def test_unhealthy_lanes(kind):
    ((rt, rs), (pt, ps)), cfg, call, statuses = _unhealthy(kind)
    rr, pr = _runners(dt=1e-6, queue_stride=0, **cfg)
    with pytest.warns(RuntimeWarning, match="lanes unhealthy"):
        ref = call(rr, rt, rs)
    with pytest.warns(RuntimeWarning, match=f"lanes unhealthy.*{kind}"):
        port = call(pr, pt, ps)
    assert port.lane_status() == statuses
    assert_batches_agree(port, ref, 1e-6)
    if kind == "diverged":
        assert np.all(np.isfinite(port.t_finish[1]))
        assert port.best() == 1
    # deduplicated: the same unhealthy regime warns once per process
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        call(pr, pt, ps)
    assert port.extend_exhausted.tolist() == ref.extend_exhausted.tolist()


def _spec(mod, policy):
    return mod.ScenarioSpec(
        fabric=mod.FabricSpec(family="single", n_racks=1, nodes_per_rack=1,
                              gpus_per_node=8),
        workload=mod.IncastSpec(n_senders=7, size_each=2e6), policy=policy)


def test_grid_spec_policy_tuple_and_stacked_matrix():
    """``test_policy_api.py::test_grid_spec_with_policy_tuple``, and
    ``scenario_matrix(stacked=True)`` through ``run_specs``."""
    rr, pr = _runners(**CFG)
    axis = ("pfc", "dcqcn", "hpcc")
    ref = rr.grid_spec(_spec(rscen, axis), fabric_grid={"xoff": [0.5e6,
                                                                 2e6]})
    port = pr.grid_spec(_spec(pscen, axis), fabric_grid={"xoff": [0.5e6,
                                                                  2e6]})
    assert port.n == 6 and port.policy_axis == axis
    assert port.finished.all()
    assert assert_batches_agree(port, ref, CFG["dt"]) == 6
    fab = pscen.FabricSpec(family="single", n_racks=1, nodes_per_rack=1,
                           gpus_per_node=8)
    specs = pscen.scenario_matrix([fab], [pscen.IncastSpec(7, 2e6)],
                                  ["pfc", "dcqcn"], stacked=True)
    rspecs = rscen.scenario_matrix(
        [rscen.FabricSpec(family="single", n_racks=1, nodes_per_rack=1,
                          gpus_per_node=8)], [rscen.IncastSpec(7, 2e6)],
        ["pfc", "dcqcn"], stacked=True)
    assert [s.name for s in specs] == [s.name for s in rspecs]
    assert specs[0].policy == ("pfc", "dcqcn")
    (got,) = pr.run_specs(specs)
    (want,) = rr.run_specs(rspecs)
    assert isinstance(got, psweep.BatchResults)
    assert assert_batches_agree(got, want, CFG["dt"]) == 2
    assert np.array_equal(specs[0].run(pr).t_finish, got.t_finish)


def test_input_validation():
    """``test_scenario.py::test_grid_input_validation`` and
    ``test_policy_api.py:129-160``, plus what the port leaves out."""
    _, (pt, ps) = _case(1e6, n=4)
    r = psweep.SweepRunner(peng.EngineConfig(dt=1e-6, max_steps=100,
                                             max_extends=0, queue_stride=0),
                           device="cpu")
    with pytest.raises(ValueError, match="unknown fabric params"):
        r.run_batch(pt, ps, "dcqcn",
                    stacked_fabric={"koff": np.array([1.0, 2.0])})
    with pytest.raises(ValueError, match="inconsistent batch"):
        r.run_batch(pt, ps, "dcqcn", {"rai_frac": np.array([0.01, 0.02])},
                    stacked_fabric={"xoff": np.array([1e6, 2e6, 3e6])})
    with pytest.raises(ValueError, match="empty"):
        r.grid(pt, ps, "dcqcn", {})
    with pytest.raises(ValueError, match="not both"):
        r.grid(pt, ps, "dcqcn", {"rai_frac": [0.01]},
               policy_axis=["dcqcn", "hpcc"])
    with pytest.raises(ValueError, match="member-namespaced"):
        r.grid(pt, ps, param_grid={"rai_frac": [0.01, 0.05]},
               policy_axis=["dcqcn", "hpcc"])
    with pytest.raises(ValueError, match="policy is required"):
        r.grid(pt, ps, param_grid={"rai_frac": [0.01]})
    with pytest.raises(ValueError, match="policy axis"):
        r.run_spec(_spec(pscen, ("pfc", "dcqcn")))
    with pytest.raises(ValueError, match="at least two"):
        pcc.stack_policies(["dcqcn"])
    with pytest.raises(ValueError, match="unknown fault params"):
        r.grid(pt, ps, "dcqcn", fault_grid={"lossy": [0.0, 1e-3]})
    with pytest.raises(ValueError, match="inconsistent batch sizes"):
        r.run_batch(pt, ps, "pfc",
                    stacked_fabric={"xoff": np.array([1e6, 2e6])},
                    stacked_fault={"loss_rate": np.array([0.0, 1e-3,
                                                          1e-3])})
    # faults run now (tests/test_torch_faults.py): the stack is reported
    faulty = r.run_batch(pt, ps, "pfc",
                         stacked_fabric={"xoff": np.array([1e6, 2e6])},
                         fault_spec=FaultSpec.lossy_roce(1e-3))
    assert faulty.fault_set(1).pfc_on == 0.0 and faulty.lost is not None
    # mesh="auto" takes every visible CUDA device: none here, so the
    # runner lays its lanes on its one device
    auto = psweep.SweepRunner(mesh="auto", device="cpu")
    assert auto.mesh is None and auto.n_mesh_devices == 1


def test_stack_policies_and_spec_grids_match_reference():
    """``stack_policies``' namespaced spec, ``stack_labels``,
    ``grid_from_spec`` and ``lane_state_bytes`` against the reference."""
    p, r = pcc.stack_policies(["dcqcn", "hpcc"]), \
        rcc.stack_policies(["dcqcn", "hpcc"])
    assert p.members == r.members == ("dcqcn", "hpcc")
    assert p.params == pytest.approx(r.params)
    assert {k: dataclasses.astuple(s) for k, s in p.spec.items()} == \
        {k: dataclasses.astuple(s) for k, s in r.spec.items()}
    assert pcc.stack_labels(["dcqcn", "dcqcn", "hpcc"]) == \
        rcc.stack_labels(["dcqcn", "dcqcn", "hpcc"])
    for name in pcc.ALL_POLICIES:
        if any(not s.init_baked and s.bounded
               for s in pcc.get_policy(name).spec.values()):
            assert psweep.grid_from_spec(name, 3) == \
                rsweep.grid_from_spec(name, 3), name
    (rt, rs), (pt, ps) = _case(2e6)
    rr, pr = _runners(**CFG)
    for pol in ("dcqcn", "hpcc"):
        assert pr.lane_state_bytes(pt, ps, pol) == \
            rr.lane_state_bytes(rt, rs, pol)
    params = pcc.pack_params(pcc.get_policy("dcqcn"), {
        "g": np.asarray([0.1, 0.2], np.float32)}, lanes=2)
    assert params.shape == (2, 9)
    assert np.array_equal(params[:, 3].numpy(),
                          np.asarray([0.1, 0.2], np.float32))
    assert np.array_equal(params[0, :3].numpy(),
                          np.asarray(rcc.pack_params(
                              rcc.get_policy("dcqcn"), None))[:3])
