"""The fixed-order backward of the step's gathers (``engine._scatter_fixed``),
on the CPU.

Under autograd the op path gathers the delayed signals
``hist[:, slot * (Lk + 1) + path]`` and each hop's share
``frac[:, path[:, h]]`` (``engine._GatherCols``).  On the CPU the backward
adds with ``index_add_``; on the card it sums through static segment plans
(the delayed signals' grouped by delay class, each hop's the hop's demand
plan), one ``segment_reduce`` launch each, in an order that depends on
neither the launch nor the lane count.  On CPU tensors the segment
wrapper returns its plain version, so these tests hold what the card
computes: the fixed-order sums against ``index_add_`` within rtol 1e-6 of
each column's sum of magnitudes (the two add in other orders), the null
link's columns (which the step never reads back) left 0, and a lane's sums
bit-equal whether it runs alone or as each of 3 lanes.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import CollectiveSpec, EngineConfig, FabricSpec, ScenarioSpec
from repro_torch.core import engine as peng

RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def prepared():
    """A 2-rack CLOS 2D all-reduce at a step short enough that its paths
    fall into several delay classes."""
    topo, sched, _ = ScenarioSpec(
        FabricSpec("clos", n_racks=2, nodes_per_rack=1, gpus_per_node=4,
                   oversubscription=2.0),
        CollectiveSpec("2d", 8e6), "dcqcn").build()
    cfg = EngineConfig(dt=2e-7, max_steps=100, queue_stride=0)
    pp, plan = peng._prep(topo, sched, cfg, pad_flows=sched.n_flows + 5)
    return pp, plan


def _index_add(g, idx, n):
    out = g.new_zeros((g.shape[0], n))
    return out.index_add_(1, idx.reshape(-1), g)


def _close(got, want, g_abs_sums):
    err = (got - want).abs()
    assert bool((err <= RTOL * g_abs_sums).all()), float(err.max())


def _delay_scatter(pp, plan, it):
    classes, strategy, arrs = peng._delay_class_plan(pp, plan)
    Lk = plan.n_links
    return classes, (strategy, arrs, tuple(
        max(it - d, 0) % plan.ring * (Lk + 1) for d in classes), Lk + 1)


def test_scenario_has_several_delay_classes(prepared):
    pp, plan = prepared
    classes = peng._delay_class_plan(pp, plan)[0]
    assert len(classes) >= 2
    assert list(classes) == sorted(classes)
    assert plan.ring > max(classes)


# it = 0 and 1: every class clamped onto ring row 0 (rows coincide); later
# steps: one row per class
@pytest.mark.parametrize("it", [0, 1, 2, 7, 40])
def test_delayed_signal_backward_matches_index_add(prepared, it):
    pp, plan = prepared
    Lk = plan.n_links
    n = plan.ring * (Lk + 1)
    slot = torch.clamp_min(it - pp["delay_steps"], 0) % plan.ring
    flat = slot[:, None] * (Lk + 1) + pp["path"]
    g = torch.from_numpy(np.random.default_rng(it).standard_normal(
        (3, flat.numel()), np.float32))
    _, scatter = _delay_scatter(pp, plan, it)
    got = peng._scatter_fixed(g, scatter, n)
    want = _index_add(g, flat, n)
    mag = _index_add(g.abs(), flat, n)
    null = (torch.arange(n) % (Lk + 1)) == Lk
    _close(got[:, ~null], want[:, ~null], mag[:, ~null])
    assert bool((got[:, null] == 0).all())
    # every valid entry lands somewhere: the totals agree
    valid = pp["hopmask"].reshape(-1)
    assert torch.allclose(got.sum(1), g[:, valid].sum(1), rtol=1e-5,
                          atol=1e-4)


@pytest.mark.parametrize("h", [0, 1, 2, 3])
def test_hop_share_backward_matches_index_add(prepared, h):
    pp, plan = prepared
    if plan.hop[h][0] == "empty":
        pytest.skip(f"no flow uses hop {h}")
    Lk = plan.n_links
    idx = pp["path"][:, h]
    g = torch.from_numpy(np.random.default_rng(10 + h).standard_normal(
        (2, idx.numel()), np.float32))
    got = peng._scatter_fixed(g, (plan.hop[h], pp["r_hop"][h], (0,), Lk + 1),
                              Lk + 1)
    # the hop's demand plan drops the flows without a hop h: their column
    # is the null link's
    valid = pp["hopmask"][:, h]
    want = _index_add(g[:, valid], idx[valid], Lk + 1)
    _close(got, want, _index_add(g.abs()[:, valid], idx[valid], Lk + 1))
    assert bool((got[:, Lk] == 0).all())


@pytest.mark.parametrize("it", [0, 9])
def test_a_lane_alone_and_among_three_is_bit_equal(prepared, it):
    pp, plan = prepared
    Lk = plan.n_links
    n = plan.ring * (Lk + 1)
    _, scatter = _delay_scatter(pp, plan, it)
    g1 = torch.from_numpy(np.random.default_rng(100 + it).standard_normal(
        (1, pp["path"].numel()), np.float32))
    one = peng._scatter_fixed(g1, scatter, n)
    three = peng._scatter_fixed(g1.expand(3, -1).contiguous(), scatter, n)
    for b in range(3):
        assert torch.equal(three[b], one[0])
    hop = (plan.hop[0], pp["r_hop"][0], (0,), Lk + 1)
    g1 = g1[:, :plan.n_flows_pad]
    one = peng._scatter_fixed(g1, hop, Lk + 1)
    three = peng._scatter_fixed(g1.expand(3, -1).contiguous(), hop, Lk + 1)
    for b in range(3):
        assert torch.equal(three[b], one[0])


def test_the_class_plan_is_made_once_and_kept(prepared):
    pp, plan = prepared
    assert peng._delay_class_plan(pp, plan) is peng._delay_class_plan(pp, plan)


def test_cpu_gradients_keep_index_add(prepared):
    """On the CPU the gathers' backward is ``index_add_`` (no plan)."""
    x = torch.arange(6.0).reshape(1, 6).requires_grad_()
    idx = torch.tensor([[0, 2], [2, 5]])
    y = peng._gather_cols(x, idx)
    y.backward(torch.ones_like(y))
    assert x.grad.tolist() == [[1.0, 0.0, 2.0, 0.0, 0.0, 1.0]]
