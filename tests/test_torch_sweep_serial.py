"""Lanes of the port's batched sweeps against the port's own serial runs
(bit for bit: a lane of a batch does the same float32 operations as a
serial run), chunked lanes against one batch, and the kernel path's
batched lane layout on the CPU against the op path.  The cases are
``test_torch_sweep.py``'s first two: the CC x fabric grid and the policy
axis over the seven ported policies.
"""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import cc as pcc
from repro_torch.core import engine as peng
from repro_torch.core import sweep as psweep
from test_torch_sweep import CFG, _case, _runners


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_lanes_equal_serial(runner, topo, sched, batch, policy_of=None):
    """Every lane bit-equal to the port's serial run of its params and
    fabric."""
    for i in range(batch.n):
        pol = pcc.get_policy(policy_of(i) if policy_of else batch.policy)
        params = batch.param_set(i)
        if policy_of:
            lab = batch.policy_of(i)
            params = {k: params[f"{lab}.{k}"] for k in pol.spec}
        serial = runner.run(topo, sched, pol, cc_params=params,
                            fabric_params=batch.fabric_set(i))
        assert serial.finished == bool(batch.finished[i])
        assert np.array_equal(serial.t_finish, batch.t_finish[i]), i
        assert np.array_equal(serial.pause_count, batch.pause_count[i]), i
        assert np.array_equal(serial.delivered, batch.delivered[i]), i
        assert serial.soft_cost == batch.soft_cost[i]
        # a lane's own steps are those of its serial run
        assert batch.meta["lane_steps"][i] == serial.meta["steps_executed"]


def test_grid_lanes_equal_serial():
    _, (pt, ps) = _case(2e6)
    _, pr = _runners(dt=1e-6, max_steps=900, max_extends=1, queue_stride=0)
    batch = pr.grid(pt, ps, "dcqcn", {"rai_frac": [0.01, 0.05]},
                    fabric_grid={"xoff": [0.3e6, 1e6]})
    assert_lanes_equal_serial(pr, pt, ps, batch)


def test_policy_axis_lanes_equal_serial():
    _, (pt, ps) = _case(3e6)
    _, pr = _runners(**CFG)
    batch = pr.run_policy_axis(pt, ps, pcc.ALL_POLICIES,
                               cc_overrides=[None, {"rai_frac": 0.2}]
                               + [None] * 6)
    assert batch.params["dcqcn.rai_frac"][1] == np.float32(0.2)
    assert_lanes_equal_serial(pr, pt, ps, batch, policy_of=batch.policy_of)


def test_chunked_lanes_equal_one_batch():
    """``chunk_lanes=2`` over B=5: three chunks, the last padded by its
    final lane; bit for bit the unchunked batch."""
    _, (pt, ps) = _case(1e6, n=4)
    cfg = peng.EngineConfig(dt=1e-6, max_steps=900, max_extends=1,
                            queue_stride=0)
    seen = []
    chunked = psweep.SweepRunner(cfg, device="cpu", chunk_lanes=2,
                                 dispatch_hook=lambda *a: seen.append(a))
    whole = psweep.SweepRunner(cfg, device="cpu", chunk_lanes=None)
    grid = {"rai_frac": [0.01, 0.02, 0.05, 0.1, 0.3]}
    a = chunked.grid(pt, ps, "dcqcn", grid)
    b = whole.grid(pt, ps, "dcqcn", grid)
    assert seen == [(0, 2, 5), (2, 4, 5), (4, 5, 5)]
    assert a.meta["chunks"] == 3 and b.meta["chunks"] == 1
    assert a.meta["lane_steps"] == b.meta["lane_steps"]
    assert len(b.meta["lane_steps"]) == 5
    for f in ("t_finish", "pause_count", "delivered", "soft_cost",
              "finished", "diverged", "deadlock_step", "storm_step"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def test_kernel_path_lane_layout_on_cpu():
    """``_make_step(use_kernels=True)`` on CPU tensors runs the kernel
    wrappers' plain versions in the kernels' batched layout: three lanes
    of different fabric and CC params equal the op path bit for bit."""
    _, (pt, ps) = _case(3e6)
    cfg = peng.EngineConfig(**CFG)
    pol = pcc.get_policy("dcqcn")
    sim = peng.Simulator(pt, ps, pol, cfg, device="cpu", pad_flows=32)
    B = 3
    params = {"rai_frac": np.asarray([0.01, 0.03, 0.2], np.float32),
              "g": np.asarray([1 / 256, 1 / 64, 1 / 16], np.float32)}
    fab = psweep._stack_fabric(peng.FabricParams(), {
        "xoff": np.asarray([0.3e6, 1e6, 2e6], np.float32),
        "kmin": np.asarray([100e3, 400e3, 800e3], np.float32)}, B)
    carries = []
    for use_kernels in (False, True):
        step = peng._make_step(pol, cfg, sim.plan, sim.pp, params, fab,
                               use_kernels, lanes=B)
        c = peng._init_carry(sim.pp, sim.plan, pol, cfg, params, lanes=B)
        for it in range(400):
            c = step(c, it)
        carries.append(convert.carry_to_numpy(c))
    got, want = carries[1], carries[0]
    assert want["pause_count"].sum() > 0
    for k, v in want.items():
        if isinstance(v, dict):
            for kk in v:
                assert np.array_equal(got[k][kk], v[kk]), f"{k}.{kk}"
        else:
            assert np.array_equal(got[k], v), k
