"""Fault stacks on batched lanes (``repro_torch.core.sweep`` with
``stacked_fault``/``fault_grid``) against the reference's vmapped runs,
and against the port's own serial runs: run health under faults
(deadlocked, diverged, exhausted lanes), the CLOS fault sweep in one
batch, ``lane_state_bytes(faulty=True)`` and ``ScenarioSpec.fault_spec``.
Tolerances as ``tests/test_torch_faults.py``; every lane of a batch is
bit-equal to its serial run.
"""
import numpy as np
import torch

from repro.core import engine as reng
from repro.core import faults as rfaults
from repro.core import sweep as rsweep
from repro.core.scenario import CollectiveSpec as RCollectiveSpec
from repro.core.scenario import FabricSpec as RFabricSpec
from repro.core.scenario import IncastSpec as RIncastSpec
from repro.core.scenario import ScenarioSpec as RScenarioSpec
from repro_torch import convert
from repro_torch.core import cc as pcc
from repro_torch.core import engine as peng
from repro_torch.core import faults as pfaults
from repro_torch.core import sweep as psweep
from repro_torch.core.scenario import (CollectiveSpec, FabricSpec,
                                       IncastSpec, ScenarioSpec)
from test_torch_faults import (STEP_TOL, _cfg, _incast, _quiet, _ring,
                               assert_bit_equal, steps)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# run health under faults, lane by lane against the reference's batch
# ---------------------------------------------------------------------------

def _batches(topo, sched, pol, cfg, **kw):
    ref = _quiet(rsweep.SweepRunner(reng.EngineConfig(**cfg, step_impl="jnp"))
                 .run_batch, topo, sched, pol, **kw)
    port = _quiet(psweep.SweepRunner(peng.EngineConfig(**cfg),
                                     device="cpu").run_batch,
                  convert.topology_from_numpy(topo),
                  convert.schedule_from_numpy(sched), pol, **kw)
    return port, ref


def _lane_agree(port, ref, dt):
    assert port.lane_status() == ref.lane_status()
    assert np.array_equal(port.finished, ref.finished)
    for i in range(port.n):
        assert abs(steps(port.completion_time[i], dt)
                   - steps(ref.completion_time[i], dt)) <= STEP_TOL
        np.testing.assert_allclose(port.delivered[i].sum(),
                                   ref.delivered[i].sum(), rtol=1e-4)
        np.testing.assert_allclose(port.pause_count[i], ref.pause_count[i],
                                   rtol=1e-3, atol=1.0)


def test_deadlocked_lane_under_loss():
    topo, sched = _ring()
    cfg = _cfg(max_steps=600, max_extends=0)
    port, ref = _batches(
        topo, sched, "pfc", cfg,
        stacked_fabric={"xoff": np.float32([30e3, 32e6]),
                        "xon": np.float32([15e3, 16e6])},
        stacked_fault={"loss_rate": np.float32([1e-4, 1e-4])})
    assert port.lane_status() == ["deadlocked", "ok"]
    _lane_agree(port, ref, cfg["dt"])
    assert port.lost is not None and port.lost[1].sum() > 0


def test_diverged_lane_under_loss_is_isolated():
    topo, sched = _incast(2e6)
    cfg = _cfg()
    port, ref = _batches(topo, sched, "dcqcn", cfg,
                         stacked_params={"g": np.float32([np.nan, 1 / 256])},
                         stacked_fault={"loss_rate": np.float32([1e-4,
                                                                 1e-4]),
                                        "pfc_on": np.float32([0.0, 0.0])})
    assert port.lane_status() == ["diverged", "ok"]
    assert port.best() == 1
    _lane_agree(port, ref, cfg["dt"])


def test_exhausted_lanes_under_loss():
    topo, sched = _incast()
    cfg = _cfg(max_steps=10, max_extends=0)
    port, ref = _batches(topo, sched, "dcqcn", cfg,
                         stacked_params={"g": np.float32([1 / 256, 1 / 128])},
                         stacked_fault={"loss_rate": np.float32([1e-3, 0.0]),
                                        "gbn": np.float32([1.0, 0.0])})
    assert port.lane_status() == ["exhausted", "exhausted"]
    assert port.extend_exhausted.tolist() == [True, True]
    _lane_agree(port, ref, cfg["dt"])


def test_faulty_lanes_equal_their_serial_runs():
    """Each lane of a fault stack is bit-equal to the serial run of its
    own FaultSpec (an inert lane runs the faulty step, and stays lossless
    in value)."""
    topo, sched = _incast(1e6)
    cfg = _cfg(max_steps=800, max_extends=1)
    lanes = {"loss_rate": np.float32([0.0, 1e-3, 1e-3, 0.0]),
             "gbn": np.float32([0.0, 0.0, 1.0, 0.0]),
             "ecn_scale": np.float32([1.0, 1.0, 0.5, 0.0]),
             "flap_period": np.float32([0.0, 0.0, 0.0, 200e-6]),
             "flap_down": np.float32([0.0, 0.0, 0.0, 50e-6])}
    runner = psweep.SweepRunner(peng.EngineConfig(**cfg), device="cpu")
    ptopo = convert.topology_from_numpy(topo)
    psched = convert.schedule_from_numpy(sched)
    batch = _quiet(runner.run_batch, ptopo, psched, "dcqcn",
                   stacked_fault=lanes)
    assert batch.fault and batch.lost.shape == (4, sched.n_flows)
    for i in range(4):
        fs = batch.fault_set(i)
        assert fs.loss_rate == lanes["loss_rate"][i]
        r = _quiet(runner.run, ptopo, psched, "dcqcn", fault_spec=fs)
        assert np.array_equal(r.t_finish, batch.t_finish[i])
        assert np.array_equal(r.delivered, batch.delivered[i])
        assert np.array_equal(r.pause_count, batch.pause_count[i])
        if r.lost is not None:
            assert np.array_equal(r.lost, batch.lost[i])
        else:
            assert batch.lost[i].sum() == 0


def test_clos_allreduce_fault_sweep_one_batch():
    """tests/test_faults.py's acceptance sweep: loss {0, 1e-5, 1e-3} x
    {IRN, go-back-N} x 3 policies over a CLOS all-reduce as one batch,
    lane by lane against the reference's vmapped run."""
    kw = dict(fault_grid={"loss_rate": [0.0, 1e-5, 1e-3], "gbn": [0.0, 1.0]})
    cfg = _cfg(max_steps=2000, max_extends=2)
    rspec = RScenarioSpec(fabric=RFabricSpec(family="clos", n_racks=2,
                                             nodes_per_rack=1,
                                             gpus_per_node=4),
                          workload=RCollectiveSpec("1d", 4e6),
                          policy=("dcqcn", "hpcc", "timely"))
    pspec = ScenarioSpec(fabric=FabricSpec(family="clos", n_racks=2,
                                           nodes_per_rack=1,
                                           gpus_per_node=4),
                         workload=CollectiveSpec("1d", 4e6),
                         policy=("dcqcn", "hpcc", "timely"))
    ref = _quiet(rsweep.SweepRunner(reng.EngineConfig(
        **cfg, step_impl="jnp")).grid_spec, rspec, **kw)
    port = _quiet(psweep.SweepRunner(peng.EngineConfig(**cfg),
                                     device="cpu").grid_spec, pspec, **kw)
    assert port.n == ref.n == 18
    assert [port.policy_of(i) for i in range(18)] == \
        [ref.policy_of(i) for i in range(18)]
    for k in ("loss_rate", "gbn"):
        np.testing.assert_array_equal(port.fault[k], ref.fault[k])
    _lane_agree(port, ref, cfg["dt"])
    loss, gbn = port.fault["loss_rate"], port.fault["gbn"]
    # loss-free lanes are bitwise insensitive to the recovery model
    for i in range(18):
        for j in range(18):
            if (loss[i] == 0.0 and loss[j] == 0.0 and gbn[i] != gbn[j]
                    and port.policy_of(i) == port.policy_of(j)):
                assert np.array_equal(port.t_finish[i], port.t_finish[j])


def test_lane_state_bytes_counts_the_fault_rows():
    topo, sched = _incast()
    cfg = _cfg()
    port = psweep.SweepRunner(peng.EngineConfig(**cfg), device="cpu")
    ref = rsweep.SweepRunner(reng.EngineConfig(**cfg, step_impl="jnp"))
    pt, ps = convert.topology_from_numpy(topo), convert.schedule_from_numpy(
        sched)
    for pol in ("dcqcn", "mlp"):
        lossless = port.lane_state_bytes(pt, ps, pol)
        faulty = port.lane_state_bytes(pt, ps, pol, faulty=True)
        Fp = port.simulator(pt, ps, pcc.get_policy(pol)).plan.n_flows_pad
        assert faulty - lossless == 3 * 4 * Fp
        assert faulty == ref.lane_state_bytes(topo, sched, pol, faulty=True)


def test_scenario_spec_carries_fault_spec():
    topo, _ = _incast()
    cfg = _cfg()
    fault = pfaults.FaultSpec.lossy_roce(1e-3, "gbn", pfc_on=True)
    ptopo = convert.topology_from_numpy(topo)
    runner = psweep.SweepRunner(peng.EngineConfig(**cfg), device="cpu")
    ok = runner.run_spec(ScenarioSpec(fabric=ptopo,
                                      workload=IncastSpec(7, 5e6),
                                      policy="pfc"))
    bad = _quiet(runner.run_spec, ScenarioSpec(
        fabric=ptopo, workload=IncastSpec(7, 5e6), policy="pfc",
        fault_spec=fault))
    assert ok.finished and bad.finished
    assert bad.completion_time > ok.completion_time
    ref = _quiet(rsweep.SweepRunner(reng.EngineConfig(
        **cfg, step_impl="jnp")).run_spec, RScenarioSpec(
        fabric=topo, workload=RIncastSpec(7, 5e6), policy="pfc",
        fault_spec=rfaults.FaultSpec.lossy_roce(1e-3, "gbn", pfc_on=True)))
    assert_bit_equal(bad, ref)
