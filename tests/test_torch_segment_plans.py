"""Reduction plans on the segment kernels' path, on the CPU.

The kernel path sends every non-empty reduction plan of the step, the
one-row "gather" plans and the split-row "gather2" plans alike, to
``segment_reduce`` or ``segment_reduce_pfc`` as one launch.  On CPU
tensors the wrappers return their plain versions, so these tests hold
what the kernels must compute: the plain split-row sums against the JAX
reference's ``_reduce`` (plans built by each package from the same
numpy-seeded ids and drop masks), the kernels' block-offset layout
against the padded plan, the dispatch of every plan kind, the kernel
path's step against the op path, and every plan of ``chip_smoke.py``'s
scenarios within the kernels' limits.  Tolerance everywhere: equality
(0 ulp), since the sums add in the reference's order.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import _reduce as r_reduce
from repro.core.engine import _reduce_plan as r_plan
from repro_torch import convert
from repro_torch.core import CollectiveSpec, FabricSpec, ScenarioSpec
from repro_torch.core import cc as pcc
from repro_torch.core import engine as peng
from repro_torch.core.arith import row_sum
from repro_torch.kernels.engine_step import ops as es_ops
from repro_torch.kernels.engine_step import ref as es_ref

# second-level width C2 -> (n_in, n_out, members forced into segment 0);
# C2 = 1 is a "gather" plan (one block a segment in the kernels' view),
# the others split-row plans
C2_CASES = {1: (3000, 200, 40), 2: (3000, 200, 100), 4: (5000, 300, 200),
            16: (20000, 641, 1000), 32: (20000, 641, 2000),
            64: (30000, 300, 4000), 256: (40000, 50, 12000)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plans(C2: int):
    """The reference's and the port's plans of one seeded case, and its
    strategy (the same in both)."""
    n_in, n_out, fan = C2_CASES[C2]
    rng = np.random.default_rng(C2)
    ids = rng.integers(0, n_out, n_in)
    ids[:fan] = 0                         # one hot segment
    drop = rng.random(n_in) < 0.1
    r_arrs, strat = r_plan(ids, n_in, n_out, drop=drop)
    p_arrs, p_strat = peng._reduce_plan(ids, n_in, n_out, drop=drop)
    assert p_strat == strat
    if C2 == 1:
        assert strat[0] == "gather"
    else:
        assert strat[0] == "gather2" and strat[3] == C2
    return r_arrs, p_arrs, strat


def _vals(n_in: int, B: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1e6, (B, n_in))
            * (rng.random((B, n_in)) < 0.7)).astype(np.float32)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("C2", list(C2_CASES))
def test_plain_reductions_match_reference(C2, B):
    """The op path's ``_reduce`` and the kernel path's ``_reduce_kernel``
    (the wrappers' plain versions on CPU tensors) against the reference's
    jitted ``_reduce``, lane by lane: equal."""
    r_arrs, p_arrs, strat = _plans(C2)
    n_in = C2_CASES[C2][0]
    vals = _vals(n_in, B, 100 + C2)
    fn = jax.jit(lambda v, a: r_reduce(strat, a, v))
    want = np.stack([np.asarray(fn(jnp.asarray(v), r_arrs)) for v in vals])
    arrs = peng._plan_tensors(p_arrs, "cpu")
    tv = torch.from_numpy(vals)
    np.testing.assert_array_equal(peng._reduce(strat, arrs, tv).numpy(),
                                  want)
    np.testing.assert_array_equal(
        peng._reduce_kernel(strat, arrs, tv).numpy(), want)
    # the PFC variant's occupancy is the same sum; its hysteresis the
    # op path's
    rng = np.random.default_rng(C2)
    n_out = strat[1]
    xoff = torch.from_numpy(want * rng.uniform(0.5, 1.5, (B, n_out))
                            .astype(np.float32))
    xon = xoff * 0.8
    can = torch.from_numpy(rng.random((B, n_out)) < 0.7)
    prev = torch.from_numpy(rng.random((B, n_out)) < 0.5)
    idx, n_out, C, *split = peng._kernel_plan(strat, arrs)
    q, paused = es_ops.segment_reduce_pfc(tv, idx, n_out, C, xoff, xon, can,
                                          prev, *split)
    np.testing.assert_array_equal(q.numpy(), want)
    q_t = torch.from_numpy(want)
    want_p = torch.where((q_t > xoff) & can, True,
                         torch.where(q_t < xon, False, prev))
    assert torch.equal(paused, want_p)


@pytest.mark.parametrize("C2", list(C2_CASES))
def test_block_offsets_match_padded_plan(C2):
    """The kernels' layout of a split-row plan (``perm`` + ``boff``)
    rebuilds the padded second level ``bidx`` exactly and sums to the
    padded plan's bits; a gather plan read as one block a segment
    (``boff = 0..n_out``, C2 = 1) sums to the gather plan's bits."""
    _, p_arrs, strat = _plans(C2)
    arrs = peng._plan_tensors(p_arrs, "cpu")
    vals = torch.from_numpy(_vals(C2_CASES[C2][0], 2, C2))
    want = peng._reduce(strat, arrs, vals)
    if strat[0] == "gather":
        _, n_out, C = strat
        boff = torch.arange(n_out + 1, dtype=torch.int32)
        got = es_ref.segment_reduce_ref(vals, arrs["idx32"], n_out, C, boff,
                                        1)
    else:
        _, n_out, n_blocks, c2 = strat
        boff = arrs["boff32"]
        assert boff.shape == (n_out + 1,) and int(boff[-1]) == n_blocks
        counts = (boff[1:] - boff[:-1]).numpy()
        assert counts.min() >= 0 and counts.max() <= c2
        assert torch.equal(es_ref.block_rows(boff, c2, n_blocks),
                           arrs["bidx"])
        assert torch.equal(arrs["perm32"].long(), arrs["perm"])
        got = es_ops.segment_reduce(vals, arrs["perm32"], n_out,
                                    peng._SPLIT_C, boff, c2, arrs["ctas32"])
    assert torch.equal(got, want)


def test_reduce_kernel_sends_every_plan_to_the_kernel(monkeypatch):
    """``_reduce_kernel`` hands every non-empty plan to the wrapper (one
    call each, counted by a monkeypatched wrapper) and never to the op
    path; an empty plan is zeros without a call."""
    cases = [_plans(1)[1:], _plans(4)[1:], _plans(256)[1:],
             peng._reduce_plan(np.zeros(5, np.int64), 5, 7,
                               drop=np.ones(5, bool))]
    assert [s[0] for _, s in cases] == ["gather", "gather2", "gather2",
                                        "empty"]
    vals = {}
    want = {}
    for i, (arrs, strat) in enumerate(cases):
        n_in = 5 if strat[0] == "empty" else C2_CASES[(1, 4, 256)[i]][0]
        vals[i] = torch.from_numpy(_vals(n_in, 3, i))
        cases[i] = (peng._plan_tensors(arrs, "cpu"), strat)
        want[i] = peng._reduce(strat, cases[i][0], vals[i])
    calls = []
    real = es_ops.segment_reduce

    def counting(v, idx, n_out, C, boff=None, C2=1, ctas=None):
        calls.append((n_out, C, boff is not None, C2))
        return real(v, idx, n_out, C, boff, C2, ctas)

    def op_path(strategy, arrs, v):
        if strategy[0] != "empty":
            raise AssertionError(f"{strategy} ran on the op path")
        return v.new_zeros(v.shape[:-1] + (strategy[1],))

    monkeypatch.setattr(es_ops, "segment_reduce", counting)
    monkeypatch.setattr(peng, "_reduce", op_path)
    for i, (arrs, strat) in enumerate(cases):
        got = peng._reduce_kernel(strat, arrs, vals[i])
        assert torch.equal(got, want[i]), strat
    g = cases[0][1]
    assert calls == [(g[1], g[2], False, 1), (300, 64, True, 4),
                     (50, 64, True, 256)]
    assert torch.equal(want[3], torch.zeros(3, 7))


def _small_a2a():
    """A 16-GPU, 2-rack CLOS all-to-all whose step runs both plan kinds:
    gather and split-row hop plans, split-row qlink, qport and group."""
    fab = FabricSpec("clos", n_racks=2, nodes_per_rack=1, gpus_per_node=8,
                     oversubscription=2.0)
    return ScenarioSpec(fab, CollectiveSpec("a2a", 1e6), "dcqcn").build()


def test_kernel_step_runs_every_plan_through_the_kernels(monkeypatch):
    """``_make_step(use_kernels=True)`` on CPU tensors, 2 lanes of
    different xoff: each step calls ``segment_reduce`` once per non-empty
    plan but qport, ``segment_reduce_pfc`` once for qport, the op path's
    ``_reduce`` never; the carries equal the op path's bit for bit."""
    topo, sched, _ = _small_a2a()
    cfg = peng.EngineConfig(dt=1e-6, max_steps=900, max_extends=1,
                            queue_stride=4)
    pol = pcc.get_policy("dcqcn")
    sim = peng.Simulator(topo, sched, pol, cfg, device="cpu")
    plan = sim.plan
    kinds = {s[0] for s in plan.hop + (plan.qlink, plan.qport, plan.group)}
    assert kinds == {"gather", "gather2"} and plan.qport[0] == "gather2"
    B = 2
    fab = peng.FabricParams()
    from repro_torch.core import sweep as psweep
    fab = psweep._stack_fabric(fab, {"xoff": np.asarray([0.05e6, 1e6],
                                                        np.float32)}, B)
    n_steps = 120
    step = peng._make_step(pol, cfg, plan, sim.pp, None, fab, False,
                           lanes=B)
    c = peng._init_carry(sim.pp, plan, pol, cfg, None, lanes=B)
    for it in range(n_steps):
        c = step(c, it)
    want = convert.carry_to_numpy(c)

    calls = {"segment_reduce": 0, "segment_reduce_pfc": 0}
    for name in calls:
        real = getattr(es_ops, name)

        def counting(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(es_ops, name, counting)

    def op_path(strategy, arrs, v):
        if strategy[0] != "empty":
            raise AssertionError(f"{strategy} ran on the op path")
        return v.new_zeros(v.shape[:-1] + (strategy[1],))
    monkeypatch.setattr(peng, "_reduce", op_path)
    step = peng._make_step(pol, cfg, plan, sim.pp, None, fab, True, lanes=B)
    c = peng._init_carry(sim.pp, plan, pol, cfg, None, lanes=B)
    for it in range(n_steps):
        c = step(c, it)
    got = convert.carry_to_numpy(c)
    per_step = (sum(s[0] != "empty" for s in plan.hop) + 3)  # qlink, pause,
    qdev_steps = len(range(0, n_steps, cfg.queue_stride))     # group; qdev
    assert calls == {"segment_reduce": per_step * n_steps + qdev_steps,
                     "segment_reduce_pfc": n_steps}
    assert want["pause_count"].sum() > 0
    for k, v in want.items():
        if isinstance(v, dict):
            for kk in v:
                assert np.array_equal(got[k][kk], v[kk]), f"{k}.{kk}"
        else:
            assert np.array_equal(got[k], v), k


def _assert_ctas(boff: np.ndarray, ctas: np.ndarray, C2: int) -> None:
    """A split-row CTA table covers every segment once, in order, and each
    CTA holds at most ``split_chunk(C2)`` blocks or one segment."""
    assert ctas[0] == 0 and ctas[-1] == len(boff) - 1
    assert np.all(np.diff(ctas) >= 1)
    held = boff[ctas[1:]] - boff[ctas[:-1]]
    alone = np.diff(ctas) == 1
    assert np.all(alone | (held <= es_ops.split_chunk(C2)))


@pytest.mark.parametrize("C2", list(C2_CASES)[1:])
def test_split_ctas_pack_segments(C2):
    """``split_ctas`` packs consecutive segments into CTAs of at most
    ``split_chunk(C2)`` blocks (a wider segment alone), greedily: no two
    neighbouring CTAs fit into one."""
    _, p_arrs, strat = _plans(C2)
    arrs = peng._plan_tensors(p_arrs, "cpu")
    boff, ctas = p_arrs["boff"], arrs["ctas32"].numpy()
    _assert_ctas(boff, ctas, C2)
    held = boff[ctas[1:]] - boff[ctas[:-1]]
    assert np.all(held[:-1] + held[1:] > es_ops.split_chunk(C2))
    assert es_ops.split_chunk(C2) == (32 if C2 <= 32 else 128)
    assert es_ops.SPLIT_W == peng._SPLIT_C
    # empty segments before a wide one: the wide one still goes alone
    boff = np.array([0, 0, 0, 40, 40, 45, 45], np.int64)
    for chunk in (8, 16, 32):
        ctas = es_ops.split_ctas(boff, 64, chunk)
        held = boff[ctas[1:]] - boff[ctas[:-1]]
        assert np.all((np.diff(ctas) == 1) | (held <= chunk)), ctas


def _smoke_scenarios():
    """``chip_smoke.py``'s simulated scenarios as ``(topo, sched)``: the
    128-GPU 1D and 32-GPU 2D all-reduces (Fig 13 and the faulty runs use
    these fabrics), Fig 12's all-to-all, the 128-GPU DLRM iteration."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke  # numpy only at import
    from repro_torch.core import DLRMCommSpec, build_dlrm_iteration
    clos128 = FabricSpec("clos", n_racks=8, nodes_per_rack=2,
                         gpus_per_node=8, oversubscription=2.0)
    clos32 = FabricSpec("clos", n_racks=2, nodes_per_rack=2,
                        gpus_per_node=8, oversubscription=2.0)
    out = {}
    for label, fab, wl in (("clos128_1d", clos128, CollectiveSpec("1d",
                                                                  128e6)),
                           ("clos32_2d", clos32, CollectiveSpec("2d",
                                                                128e6))):
        out[label] = ScenarioSpec(fab, wl, "dcqcn").build()[:2]
    out["fig12"] = chip_smoke.fig12_scenario()[:2]
    topo = clos128.build()
    out["dlrm_iteration"] = (topo, build_dlrm_iteration(
        topo, list(range(clos128.n_gpus)),
        comm=DLRMCommSpec(allreduce_algo="2d")))
    return out


def test_smoke_scenario_plans_within_kernel_limits():
    """Every non-empty plan of the scenarios ``chip_smoke.py`` simulates
    passes the wrappers' checks: gather rows of at most 64, split-row
    second levels of at most ``MAX_C2`` blocks (256 at most today), each
    segment within its C2."""
    from repro_torch.core.topology import MAXHOP
    widest = 0
    for label, (topo, sched) in _smoke_scenarios().items():
        pp, plan = peng._prep(topo, sched, peng.EngineConfig(dt=4e-6))
        Fp, Lk = plan.n_flows_pad, plan.n_links
        named = [(plan.hop[h], pp["r_hop"][h], Fp) for h in range(MAXHOP)]
        named += [(plan.qlink, pp["r_qlink"], Fp * MAXHOP),
                  (plan.qport, pp["r_qport"], Fp * MAXHOP),
                  (plan.group, pp["r_group"], Fp),
                  (plan.pause, pp["r_pause"], Lk),
                  (plan.qdev, pp["r_qdev"], Lk)]
        for strat, arrs, n_in in named:
            if strat[0] == "empty":
                continue
            kplan = peng._kernel_plan(strat, arrs)
            es_ops._check_seg(torch.zeros((1, n_in)), *kplan)
            _, n_out, _, boff, C2, ctas = kplan
            if boff is not None:
                assert int((boff[1:] - boff[:-1]).max()) <= C2, label
                _assert_ctas(boff.numpy(), ctas.numpy(), C2)
            widest = max(widest, C2)
    assert widest == 256 <= es_ops.MAX_C2


@pytest.mark.parametrize("bad", ["C2 over the limit", "C2 not a power of two",
                                 "C over 64", "C2 without boff",
                                 "boff of the wrong length",
                                 "split row without ctas",
                                 "split row of 32-wide blocks"])
def test_wrapper_checks_reject_plans_outside_the_limits(bad):
    """The checks a CUDA call runs before its launch (here on CPU tensors)
    raise on a plan the kernels do not take."""
    vals = torch.zeros((2, 100))
    perm = torch.zeros(64 * 4, dtype=torch.int32)
    boff = torch.tensor([0, 2, 4], dtype=torch.int32)
    ctas = torch.tensor([0, 1, 2], dtype=torch.int32)
    es_ops._check_seg(vals, perm, 2, 64, boff, 2, ctas)
    args = {"C2 over the limit": (perm, 2, 64, boff, 2 * es_ops.MAX_C2,
                                  ctas),
            "C2 not a power of two": (perm, 2, 64, boff, 3, ctas),
            "C over 64": (perm, 2, 128, boff, 2, ctas),
            "C2 without boff": (perm[:128], 2, 64, None, 2, None),
            "boff of the wrong length": (perm, 3, 64, boff, 2, ctas),
            "split row without ctas": (perm, 2, 64, boff, 2, None),
            "split row of 32-wide blocks": (perm, 2, 32, boff, 2, ctas)}[bad]
    with pytest.raises(ValueError):
        es_ops._check_seg(vals, *args)


def _strided_row_sum(v: np.ndarray) -> np.float32:
    """engine_step.cu's strided_row_sum, transliterated (float32)."""
    C = len(v)
    V = min(C, 8)
    acc = [v[k] if k < V else np.float32(0) for k in range(8)]
    for j in range(V, C, V):
        for k in range(V):
            acc[k] = np.float32(acc[k] + v[j + k])
    h = 4
    while h >= 1:
        for k in range(4):
            if k < h and 2 * h <= V:
                acc[k] = np.float32(acc[k] + acc[k + h])
        h //= 2
    return acc[0]


def _kernel_row_sum(v: np.ndarray, lanes: bool) -> np.float32:
    """engine_step.cu's order over a row: first_level_sum (lanes False)
    or the second level (strided_row_sum, or run32 totals)."""
    C = len(v)
    if C <= 16 and not lanes:
        s = v[0]
        for x in v[1:]:
            s = np.float32(s + x)
        return s
    if C <= 32:
        return _strided_row_sum(v)
    runs = []
    for r in range(0, C, 32):
        s = v[r]
        for x in v[r + 1:r + 32]:
            s = np.float32(s + x)
        runs.append(s)
    s = runs[0]
    for x in runs[1:]:
        s = np.float32(s + x)
    return s


@pytest.mark.parametrize("lanes", [False, True], ids=["first", "second"])
def test_kernel_order_is_row_sum(lanes):
    """The kernels' order of additions, written out as engine_step.cu
    writes it, equals ``arith.row_sum`` on rows of every power-of-two
    width up to 256, to the bit."""
    rng = np.random.default_rng(5)
    for C in (1, 2, 4, 8, 16, 32, 64, 128, 256):
        rows = (rng.uniform(0, 1e6, (20, C))
                * (rng.random((20, C)) < 0.8)).astype(np.float32)
        want = row_sum(torch.from_numpy(rows), lanes=lanes).numpy()
        got = np.array([_kernel_row_sum(r, lanes) for r in rows])
        np.testing.assert_array_equal(got, want, err_msg=f"C={C}")


@pytest.mark.parametrize("per", [None, 512], ids=["one", "split"])
def test_lane_sum_plan_adds_each_lane_as_its_serial_run(per, monkeypatch):
    """The soft cost's per-lane sum on the card (``_lane_sum_plan``, one
    segment of every real flow, or consecutive segments of ``MAX_C2``
    blocks added left to right, here forced small): each lane of a 5-lane
    call equal to its call alone bit for bit on both step paths (the
    kernel's plain version here), close to the float64 sum of its real
    flows (rtol 1e-6), padded flows left out; under autograd a gradient
    of one on every real flow and zero on the pads; the kernel plan within
    the wrappers' limits."""
    if per is not None:
        monkeypatch.setattr(es_ops, "MAX_C2", per // peng._SPLIT_C)
    topo, sched, pol = _small_a2a()
    sim = peng.Simulator(topo, sched, pol, peng.EngineConfig(dt=1e-6),
                         pad_flows=3000, device="cpu")
    plan = sim.plan
    F, Fp = plan.n_flows, plan.n_flows_pad
    assert Fp == 3000 > F > (per or 0)
    lane_plan = peng._lane_sum_plan(plan, "cpu")
    strat, arrs = lane_plan
    assert strat[0] == "gather2" and strat[1] == (1 if per is None else 2)
    vals = torch.from_numpy(_vals(Fp, 5, 11))
    want = vals[:, :F].double().sum(-1)
    for reduce_ in (peng._reduce, peng._reduce_kernel):
        got = peng._lane_sum(reduce_, lane_plan, vals)
        torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=0)
        for b in range(5):
            alone = peng._lane_sum(reduce_, lane_plan, vals[b:b + 1])
            assert torch.equal(alone, got[b:b + 1])
    x = vals.clone().requires_grad_(True)
    peng._lane_sum(peng._reduce, lane_plan, x).sum().backward()
    assert torch.equal(x.grad[:, :F], torch.ones(5, F))
    assert torch.equal(x.grad[:, F:], torch.zeros(5, Fp - F))
    es_ops._check_seg(vals, *peng._kernel_plan(strat, arrs))
