"""The port's batched sweeps (``repro_torch.core.sweep``: ``run_batch``,
``grid``, ``run_policy_axis``; op path on the CPU) against the
reference's vmapped ones, lane by lane.  Run-health lanes, spec grids and
input checks are in ``test_torch_sweep_health.py``; lanes against the
port's own serial runs, chunking and the kernel path's lane layout in
``test_torch_sweep_serial.py``.

Tolerances are the repository's (``tests/test_engine_equiv.py``):
``t_finish`` within one step (event times are step-quantised),
``completion_time`` rtol 1e-5, delivered sums rtol 1e-4, PAUSE frames
rtol 1e-3 + atol 1; ``finished``, ``diverged``, ``deadlocked`` and
``lane_status`` equal.  Each comparison also counts the lanes that are
bit-equal to the reference's (t_finish, PAUSE and delivered arrays): on
these cases, every lane.
"""
import numpy as np
import pytest
import torch

from repro.core import engine as reng
from repro.core import sweep as rsweep
from repro.core.collectives import incast as r_incast
from repro.core.topology import single_switch as r_single_switch
from repro_torch import convert
from repro_torch.core import cc as pcc
from repro_torch.core import engine as peng
from repro_torch.core import sweep as psweep

# tests/test_policy_api.py's engine config
CFG = dict(dt=1e-6, max_steps=1500, max_extends=2, queue_stride=0)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The op path is thousands of small ops: one intra-op thread is
    faster than many, and does not fight the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _rearm_unhealthy_warning():
    rsweep.reset_unhealthy_warnings()
    psweep.reset_unhealthy_warnings()


def _runners(**cfg):
    return (rsweep.SweepRunner(reng.EngineConfig(**cfg)),
            psweep.SweepRunner(peng.EngineConfig(**cfg), device="cpu"))


def _case(size, n=8):
    """The n-port incast of ``tests/test_policy_api.py``: reference
    arrays, and the same arrays for the port."""
    topo = r_single_switch(n)
    sched = r_incast(topo, list(range(1, n)), 0, size)
    return (topo, sched), (convert.topology_from_numpy(topo),
                           convert.schedule_from_numpy(sched))


def _steps(t, dt):
    t = np.asarray(t, np.float64)
    return np.where(np.isfinite(t), np.rint(t / dt), -1.0)


def assert_batches_agree(port, ref, dt) -> int:
    """Lane by lane at the repository's tolerances; returns the number of
    bit-equal lanes."""
    assert port.n == ref.n
    assert port.policy_axis == ref.policy_axis
    assert port.finished.tolist() == ref.finished.tolist()
    assert port.diverged.tolist() == ref.diverged.tolist()
    assert port.deadlocked.tolist() == ref.deadlocked.tolist()
    assert port.lane_status() == ref.lane_status()
    live = ~ref.diverged
    np.testing.assert_allclose(_steps(port.t_finish[live], dt),
                               _steps(ref.t_finish[live], dt), rtol=0,
                               atol=1)
    np.testing.assert_allclose(port.completion_time[live],
                               ref.completion_time[live], rtol=1e-5)
    np.testing.assert_allclose(port.delivered[live].sum(1),
                               ref.delivered[live].sum(1), rtol=1e-4)
    np.testing.assert_allclose(port.pause_count[live],
                               ref.pause_count[live], rtol=1e-3, atol=1.0)
    for k in ref.params:
        assert np.array_equal(port.params[k], ref.params[k],
                              equal_nan=True), k
    for k in ref.fabric:
        assert np.array_equal(port.fabric[k], ref.fabric[k]), k
    return sum(np.array_equal(port.t_finish[i], ref.t_finish[i])
               and np.array_equal(port.pause_count[i], ref.pause_count[i])
               and np.array_equal(port.delivered[i], ref.delivered[i])
               for i in range(port.n))


def test_grid_cc_and_fabric():
    """``tests/test_scenario.py::test_grid_joint_cc_and_fabric_matches_serial``:
    2 rai_frac x 2 xoff = 4 lanes."""
    (rt, rs), (pt, ps) = _case(2e6)
    cfg = dict(dt=1e-6, max_steps=900, max_extends=1, queue_stride=0)
    rr, pr = _runners(**cfg)
    grid = dict(param_grid={"rai_frac": [0.01, 0.05]},
                fabric_grid={"xoff": [0.3e6, 1e6]})
    ref = rr.grid(rt, rs, "dcqcn", **grid)
    port = pr.grid(pt, ps, "dcqcn", **grid)
    assert port.n == 4 and port.finished.all()
    assert assert_batches_agree(port, ref, cfg["dt"]) == 4
    assert port.meta["step_impl"] == "torch" and port.meta["chunks"] == 1


def test_policy_axis_all_policies():
    """``test_policy_api.py::test_run_policy_axis_matches_serial_all_policies``
    over the seven ported policies."""
    (rt, rs), (pt, ps) = _case(3e6)
    rr, pr = _runners(**CFG)
    pols = pcc.ALL_POLICIES
    ref = rr.run_policy_axis(rt, rs, pols)
    port = pr.run_policy_axis(pt, ps, pols)
    assert port.policy_axis == pols and port.finished.all()
    assert [port.policy_of(i) for i in range(port.n)] == list(pols)
    assert assert_batches_agree(port, ref, CFG["dt"]) == len(pols)


def test_policy_axis_cc_overrides():
    """``test_policy_api.py::test_run_policy_axis_cc_overrides_per_member``."""
    (rt, rs), (pt, ps) = _case(3e6)
    rr, pr = _runners(**CFG)
    over = [None, {"rai_frac": 0.2}]
    ref = rr.run_policy_axis(rt, rs, ["pfc", "dcqcn"], cc_overrides=over)
    port = pr.run_policy_axis(pt, ps, ["pfc", "dcqcn"], cc_overrides=over)
    assert port.params["dcqcn.rai_frac"].tolist() == \
        pytest.approx([0.03, 0.2])
    assert assert_batches_agree(port, ref, CFG["dt"]) == 2
    with pytest.raises(ValueError, match="cc_overrides has"):
        pr.run_policy_axis(pt, ps, ["pfc", "dcqcn"], cc_overrides=[{}])
    with pytest.raises(ValueError, match="unknown dcqcn"):
        pr.run_policy_axis(pt, ps, ["pfc", "dcqcn"],
                           cc_overrides=[None, {"bogus": 1.0}])


def test_policy_param_fabric_grid():
    """``test_policy_api.py::test_policy_param_fabric_grid_zero_recompiles``
    (without its compile counter): 3 policies x 2 CC points x 2 fabric
    points = 12 lanes."""
    (rt, rs), (pt, ps) = _case(3e6)
    rr, pr = _runners(**CFG)
    kw = dict(param_grid={"dcqcn.rai_frac": [0.01, 0.05]},
              fabric_grid={"xoff": [0.5e6, 1e6]},
              policy_axis=["dcqcn", "dctcp", "hpcc"])
    ref = rr.grid(rt, rs, **kw)
    port = pr.grid(pt, ps, **kw)
    assert port.n == 12 and port.finished.all()
    assert {port.policy_of(i) for i in range(12)} == {"dcqcn", "dctcp",
                                                      "hpcc"}
    assert assert_batches_agree(port, ref, CFG["dt"]) == 12
