"""The port's CUDA kernels against their plain PyTorch versions, on the
card (``repro_torch.kernels.engine_step``, ``repro_torch.kernels.cc_update``,
``repro_torch.kernels.embedding_bag`` and
``repro_torch.kernels.flash_decode``).

Needs an NVIDIA Hopper card with ``nvcc``; everywhere else every test
skips (the kernels have no CPU mode).  On the card, run without the
repository's conftest (which imports jax, absent there):

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import (EngineConfig, FaultSpec, Simulator,
                              get_policy, incast, single_switch)
from repro_torch.core import cc
from repro_torch.core import engine as peng
from repro_torch.core import sweep as psweep
from repro_torch.common import init as init_mod
from repro_torch.common.pytree import tree_map
from repro_torch.configs import smoke_config
from repro_torch.data import dlrm_batch
from repro_torch.kernels.cc_update import ops as ccu_ops
from repro_torch.kernels.cc_update import ref as ccu_ref
from repro_torch.kernels.embedding_bag import ops as emb_ops
from repro_torch.kernels.embedding_bag import ref as emb_ref
from repro_torch.kernels.engine_step import ops, ref
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode import ref as fd_ref
from repro_torch.models import DLRM, Model
from repro_torch.serve import Request, ServeEngine

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (numpy only at import: the shared weights)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _case(policy, F, B, lossy, seed, dev):
    rng = np.random.default_rng(seed)
    H = 4
    hm = (rng.random((B, H, F)) < 0.7).astype(np.float32)
    hm[:, 0] = 1.0
    case = [rng.uniform(0, 3e6, (B, H, F)) * hm,
            rng.uniform(0, 50e9, (B, H, F)) * hm,
            rng.uniform(10e9, 50e9, (B, H, F)),
            (rng.random((B, H, F)) < 0.8) * hm, hm,
            np.full((B, H, F), 400e3), np.full((B, H, F), 1600e3),
            np.full((B, H, F), 0.2),
            rng.uniform(2e-6, 20e-6, (B, F)), np.full((B, F), 25e9),
            (rng.uniform(0, 0.05, (B, F)) if lossy else np.zeros((B, F)))]
    case = [torch.as_tensor(np.ascontiguousarray(x, np.float32), device=dev)
            for x in case]
    line = torch.full((F,), 25e9)
    st = policy.init(cc.FlowCtx(line=line, bdp=line * 5e-6,
                                fanin=torch.full((F,), 4.0), n_flows=F))
    st = {k: v * torch.as_tensor(rng.uniform(0.5, 1.5, F),
                                 dtype=torch.float32) for k, v in st.items()}
    state = torch.stack([cc.pack_state(policy, st, n_flows=F)] * B).to(dev)
    params = torch.stack([
        cc.pack_params(policy, {k: v * (1 + 0.2 * b)
                                for k, v in policy.params.items()
                                if not policy.spec[k].init_baked})
        for b in range(B)]).to(dev)
    return case, state.contiguous(), params.contiguous()


EDGE_FLOWS = (1, 255, 256, 257, 1500, 7936, 130049, 131072)


@pytest.mark.parametrize("lossy", [False, True], ids=["lossless", "lossy"])
@pytest.mark.parametrize("name", cc.ALL_POLICIES)
def test_fused_kernel_matches_plain(dev, name, lossy):
    """Every output bit-equal to the plain version at one flow, the edges
    of the 128-flow tile, the 128-GPU counts and their neighbours, and 1,
    3 and 9 lanes (one launch counted each); counts that are not a
    multiple of 4 copy the tile rows 4 bytes at a time, the others 16
    bytes at a time."""
    policy = cc.get_policy(name)
    routes = set()
    for F in EDGE_FLOWS:
        for B in (1, 3, 9):
            case, state, params = _case(policy, F, B, lossy, F + B, dev)
            args = (*case, state, params)
            routes.add(ops.vector_copies(F,
                                         [x.data_ptr() for x in args[:12]]))
            before = ops.LAUNCHES["fused_signals_policy"]
            got = ops.fused_signals_policy(policy, *args, 3.3e-4, 1e-5, 4e-6)
            want = ref.fused_signals_policy_ref(policy, *args, 3.3e-4, 1e-5,
                                                4e-6)
            torch.cuda.synchronize()
            assert ops.LAUNCHES["fused_signals_policy"] == before + 1
            for g, w in zip(got, want):
                assert torch.equal(g, w.expand_as(g)), (F, B)
    assert routes == {False, True}


@pytest.mark.parametrize("B", [1, 3, 9])
@pytest.mark.parametrize("F", [1500, 7936, 131072])
def test_mlp_kernel_matches_plain_lossy(dev, F, B):
    """The ``mlp`` body at the main path's padded flow counts (130,048
    flows pad to 131,072) and 1, 3 and 9 lanes, with a live loss input
    on half the flows: bit-equal, as every policy's body."""
    policy = cc.get_policy("mlp")
    case, state, params = _case(policy, F, B, True, F + B, dev)
    assert params.shape == (B, 40) and state.shape[1] == 4
    got = ops.fused_signals_policy(policy, *case, state, params, 3.3e-4,
                                   1e-5, 4e-6)
    want = ref.fused_signals_policy_ref(policy, *case, state, params,
                                        3.3e-4, 1e-5, 4e-6)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w.expand_as(g))


@pytest.mark.parametrize("name", ["dcqcn", "mlp"])
def test_fused_kernel_unaligned_inputs_take_cp_async(dev, name):
    """Inputs one float past a 16-byte boundary at F = 1,500 (a multiple
    of 4) take the 4-byte cp.async route and stay bit-equal."""
    policy = cc.get_policy(name)
    case, state, params = _case(policy, 1500, 3, True, 11, dev)
    args = [chip_smoke.shifted_copy(x) for x in (*case, state, params)]
    assert not ops.vector_copies(1500, [x.data_ptr() for x in args[:12]])
    assert ops.vector_copies(1500, [x.data_ptr() for x in (*case, state)])
    got = ops.fused_signals_policy(policy, *args, 3.3e-4, 1e-5, 4e-6)
    want = ref.fused_signals_policy_ref(policy, *args, 3.3e-4, 1e-5, 4e-6)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w.expand_as(g))


@pytest.mark.parametrize("blocks", [1, 3, 133])
def test_fused_kernel_any_block_count(dev, blocks):
    """The persistent walk is right for any grid: one block taking every
    tile (both ring stages reused many times), a few, and more blocks than
    one per SM; direct calls of the entry point with the plan's tiles."""
    policy = cc.get_policy("mlp")
    B, F = 3, 7936
    case, state, params = _case(policy, F, B, True, 5, dev)
    ins = (*case, state, params)
    outs = (torch.empty_like(state), torch.empty_like(case[9]),
            torch.empty_like(case[9]))
    args = ops.launch_args(policy.kernel_id, ins, outs, 3.3e-4, 1e-5, 4e-6)
    args[-3] = blocks
    stream = torch.cuda.current_stream().cuda_stream
    assert ops.kernel_function("fused_signals_policy")(*args, stream) == 0
    want = ref.fused_signals_policy_ref(policy, *ins, 3.3e-4, 1e-5, 4e-6)
    torch.cuda.synchronize()
    for g, w in zip(outs, want):
        assert torch.equal(g, w.expand_as(g))


def test_fused_plan_on_the_card(dev):
    """The occupancy query gives whole waves of blocks, and the launch
    refuses a plan that does not match F or misaligned 16-byte copies."""
    policy = cc.get_policy("dcqcn")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n = ops.resident_blocks(policy.kernel_id, 8)
    assert n >= sms and n % sms == 0
    case, state, params = _case(policy, 1500, 1, False, 2, dev)
    ins = (*case, state, params)
    outs = (torch.empty_like(state), torch.empty_like(case[9]),
            torch.empty_like(case[9]))
    fn = ops.kernel_function("fused_signals_policy")
    stream = torch.cuda.current_stream().cuda_stream
    args = ops.launch_args(policy.kernel_id, ins, outs, 0.0, 1e-5, 4e-6)
    assert args[-1] == 1
    for i, bad in ((-2, 11), (-3, 0)):
        wrong = list(args)
        wrong[i] = bad
        assert fn(*wrong, stream) != 0
    shifted = [chip_smoke.shifted_copy(x) for x in ins]
    wrong = ops.launch_args(policy.kernel_id, shifted, outs, 0.0, 1e-5, 4e-6)
    assert wrong[-1] == 0
    wrong[-1] = 1
    assert fn(*wrong, stream) != 0


SPECIAL = np.float32([0.0, -0.0, 1e-45, -1e-45, 1e-40, -1e-40, 1.1754942e-38,
                      -1.1754942e-38, 1.1754944e-38, 7.99881172, -7.99881172,
                      7.9988122, -7.9988122, 0.0004, -0.0004, 0.00039999998,
                      -0.00039999998, 0.00040000002, 88.7, -88.7, 87.8,
                      -87.8, 88.8, -88.8, 89.0, -104.0, np.inf, -np.inf,
                      np.nan])


@pytest.mark.parametrize("name", list(ops.SCALAR_FNS))
def test_scalar_functions_bit_equal(dev, name):
    """The policies' scalar device functions against their plain versions
    (``arith``) on the card: every 4,093rd float32 bit pattern and the
    special values (+-0, subnormals, the smallest normal, tanh's clamp
    edges +-7.99881172 and +-0.0004, exp's clamps near +-88.7, +-inf,
    NaN); equal in bits, any NaN equal to any NaN.  chip_smoke.py's
    scalar_exhaustive runs all 2^32 inputs."""
    bits = torch.arange(-(1 << 31), 1 << 31, 4093, dtype=torch.int64)
    x = torch.cat([bits.to(torch.int32).view(torch.float32),
                   torch.from_numpy(SPECIAL)]).to(dev)
    got = ops.scalar_fn(name, x)
    want = ops.scalar_fn(name, x.cpu()).to(dev)
    plain = getattr(ops.arith, name)(x)
    torch.cuda.synchronize()
    for w in (want, plain):
        same = (got.view(torch.int32) == w.view(torch.int32)) | (
            torch.isnan(got) & torch.isnan(w))
        assert bool(same.all()), x[~same][:8].tolist()


@pytest.mark.parametrize("pol,fault", [
    ("dcqcn", dict(loss_rate=1e-4, gbn=0.0, pfc_on=1.0, ecn_scale=0.5)),
    ("mlp", dict(loss_rate=1e-3, gbn=1.0, pfc_on=0.0)),
    ("pfc", dict(degrade=0.5, degrade_t1=5e-4, flap_period=300e-6,
                 flap_down=50e-6))], ids=["dcqcn_irn_ecn", "mlp_gbn",
                                          "pfc_degrade_flap"])
def test_engine_cuda_matches_op_path_lossy(dev, pol, fault):
    """A small lossy scenario on the card, kernel path against op path:
    completion within 2 steps, delivered and lost rtol 1e-4, PAUSE rtol
    1e-3 + 1 (under an ECN scale the kernel folds it into pmax, the op
    path multiplies after the clip)."""
    topo = single_switch(8)
    sched = incast(topo, list(range(1, 8)), 0, 2e6)
    cfg = EngineConfig(dt=1e-6, max_steps=1500, max_extends=2,
                       queue_stride=0)
    runs = {}
    for impl in ("cuda", "torch"):
        ops.reset_launches()
        runs[impl] = Simulator(topo, sched, get_policy(pol),
                               dataclasses.replace(cfg, step_impl=impl),
                               fault_spec=FaultSpec(**fault),
                               device="cuda").run()
        runs[impl + "_launches"] = dict(ops.LAUNCHES)
    a, b = runs["cuda"], runs["torch"]
    assert runs["cuda_launches"]["fused_signals_policy"] == \
        a.meta["steps_executed"]
    assert not any(runs["torch_launches"].values())
    assert a.finished
    chip_smoke.compare_fault_runs(a, b, cfg.dt, f"{pol} lossy")


@pytest.mark.parametrize("C", [4, 16, 32, 64])
def test_segment_kernels_match_plain(dev, C):
    """Same summation order as the plain version: equal to the bit."""
    rng = np.random.default_rng(C)
    n_in, n_out, B = 900, 37, 2
    vals = torch.as_tensor(rng.uniform(0, 1e6, (B, n_in)),
                           dtype=torch.float32, device=dev)
    idx = torch.as_tensor(np.minimum(rng.integers(0, n_in + 60, n_out * C),
                                     n_in), dtype=torch.int32, device=dev)
    got = ops.segment_reduce(vals, idx, n_out, C)
    want = ref.segment_reduce_ref(vals, idx, n_out, C)
    assert torch.equal(got, want)
    xoff = (want * 1.1).contiguous()
    xoff[:, ::3] = want[:, ::3] * 0.9
    xon = (xoff * 0.8).contiguous()
    can = torch.as_tensor(rng.random((B, n_out)) < 0.7, device=dev)
    prev = torch.as_tensor(rng.random((B, n_out)) < 0.5, device=dev)
    q, paused = ops.segment_reduce_pfc(vals, idx, n_out, C, xoff, xon, can,
                                       prev)
    q_r, paused_r = ref.segment_reduce_pfc_ref(vals, idx, n_out, C, xoff,
                                               xon, can, prev)
    assert torch.equal(q, q_r)
    assert torch.equal(paused, paused_r)


def _split_plan(C2: int, dev, n_out: int = 300):
    """A split-row plan of second-level width ``C2`` (segment 0 hot, a
    tenth of the entries dropped) in the kernels' layout, and its input
    width."""
    n_in = max(4000, 64 * C2 + 2000)
    rng = np.random.default_rng(C2)
    ids = rng.integers(0, n_out, n_in)
    ids[:64 * C2 * 3 // 4] = 0
    arrs, strat = peng._reduce_plan(ids, n_in, n_out,
                                    drop=rng.random(n_in) < 0.1)
    assert strat[0] == "gather2" and strat[3] == C2
    return peng._kernel_plan(strat, peng._plan_tensors(arrs, dev)), n_in


@pytest.mark.parametrize("B", [1, 9])
@pytest.mark.parametrize("C2", [2, 4, 16, 32, 64, 256, 1024, 4096])
def test_segment_kernels_split_row_bit_equal(dev, C2, B):
    """Split-row ("gather2") plans, up to the widest second level the
    kernels take: sums equal to the plain version's to the bit (max abs
    err 0.0), ``paused`` equal everywhere, also on strided lanes."""
    kplan, n_in = _split_plan(C2, dev)
    idx, n_out, C, *split = kplan
    rng = np.random.default_rng(C2 + B)
    x = rng.uniform(0, 2e6, (B, n_in)) * (rng.random((B, n_in)) < 0.7)
    vals = torch.as_tensor(x, dtype=torch.float32, device=dev)
    wide = torch.zeros((B, n_in, 4), dtype=torch.float32, device=dev)
    wide[..., 2] = vals
    for v in (vals, wide[..., 2]):
        got = ops.segment_reduce(v, *kplan)
        want = ref.segment_reduce_ref(v, *kplan)
        assert torch.equal(got, want)
    assert float(want[:, 0].min()) > 0
    xoff = (want * torch.as_tensor(rng.uniform(0.5, 1.5, (B, n_out)),
                                   dtype=torch.float32, device=dev))
    xoff[:, ::3] = want[:, ::3]
    xon = (xoff * 0.8).contiguous()
    can = torch.as_tensor(rng.random((B, n_out)) < 0.7, device=dev)
    prev = torch.as_tensor(rng.random((B, n_out)) < 0.5, device=dev)
    q, paused = ops.segment_reduce_pfc(wide[..., 2], idx, n_out, C,
                                       xoff.contiguous(), xon, can, prev,
                                       *split)
    q_r, paused_r = ref.segment_reduce_pfc_ref(vals, idx, n_out, C, xoff,
                                               xon, can, prev, *split)
    assert torch.equal(q, q_r)
    assert torch.equal(paused, paused_r)


def test_segment_kernels_reject_plans_outside_their_limits(dev):
    """A second level wider than ``MAX_C2``, plan arrays of the wrong type
    or on another device, a gather plan with C2 > 1: the wrappers raise
    and launch nothing."""
    (idx, n_out, C, boff, C2, ctas), n_in = _split_plan(4, dev)
    vals = torch.zeros((2, n_in), device=dev)
    ops.reset_launches()
    with pytest.raises(ValueError):
        ops.segment_reduce(vals, idx, n_out, C, boff, 2 * ops.MAX_C2, ctas)
    with pytest.raises(TypeError):
        ops.segment_reduce(vals, idx.long(), n_out, C, boff, C2, ctas)
    with pytest.raises(TypeError):
        ops.segment_reduce(vals, idx, n_out, C, boff.long(), C2, ctas)
    with pytest.raises(TypeError):
        ops.segment_reduce(vals.double(), idx, n_out, C, boff, C2, ctas)
    with pytest.raises(ValueError):
        ops.segment_reduce(vals, idx, n_out, C, boff.cpu(), C2, ctas)
    with pytest.raises(ValueError):
        ops.segment_reduce(vals, idx, n_out, C, boff, C2, None)
    with pytest.raises(ValueError):
        ops.segment_reduce(vals, idx[:n_out * C], n_out, C, None, C2)
    flags = torch.zeros((2, n_out), dtype=torch.bool, device=dev)
    x = torch.zeros((2, n_out), device=dev)
    with pytest.raises(ValueError):
        ops.segment_reduce_pfc(vals, idx, n_out, C, x, x, flags, flags,
                               boff, 2 * ops.MAX_C2, ctas)
    assert not any(ops.LAUNCHES.values())
    # the CTA table's chunk is the kernel's
    for c2 in (1, 2, 32, 64, 256, ops.MAX_C2):
        assert ops.kernel_function("segment_split_chunk")(c2) == \
            ops.split_chunk(c2)
    assert ops.kernel_function("segment_split_chunk")(3) == -1


def test_wrappers_reject_bad_inputs(dev):
    vals = torch.zeros((1, 10), device=dev)
    idx = torch.zeros(3 * 8, dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        ops.segment_reduce(vals, idx, 3, 8)
    with pytest.raises(ValueError):
        ops.segment_reduce(vals, idx.int(), 3, 12)
    with pytest.raises(ValueError):
        ops.segment_reduce(vals.cpu(), idx.int(), 3, 8)


@pytest.mark.parametrize("pol", ["dcqcn", "hpcc", "pfc"])
def test_engine_cuda_matches_op_path(dev, pol):
    """Whole run on the card: kernel path vs op path."""
    topo = single_switch(8)
    sched = incast(topo, list(range(1, 8)), 0, 5e6)
    cfg = EngineConfig(dt=1e-6, max_steps=1500, max_extends=2,
                       queue_stride=0)
    runs = {}
    for impl in ("cuda", "torch"):
        ops.reset_launches()
        runs[impl] = Simulator(topo, sched, get_policy(pol),
                               dataclasses.replace(cfg, step_impl=impl),
                               device="cuda").run()
        runs[impl + "_launches"] = dict(ops.LAUNCHES)
    a, b = runs["cuda"], runs["torch"]
    assert runs["cuda_launches"]["fused_signals_policy"] == \
        a.meta["steps_executed"]
    assert not any(runs["torch_launches"].values())
    assert a.finished == b.finished
    np.testing.assert_allclose(np.rint(a.t_finish / cfg.dt),
                               np.rint(b.t_finish / cfg.dt), rtol=0, atol=1)
    np.testing.assert_allclose(a.delivered.sum(), b.delivered.sum(),
                               rtol=1e-4)
    np.testing.assert_allclose(a.pause_count, b.pause_count, rtol=1e-3,
                               atol=1.0)


def test_batched_kernel_step_matches_op_path(dev):
    """One kernel-path step of B=3 lanes (different fabric and CC params)
    from a mid-run state against one op-path step from the same state:
    float leaves within rtol 1e-5 (the kernels' check tolerance), flags
    equal."""
    topo = single_switch(8)
    sched = incast(topo, list(range(1, 8)), 0, 5e6)
    cfg = EngineConfig(dt=1e-6, max_steps=1500, max_extends=2,
                       queue_stride=0)
    pol = get_policy("dcqcn")
    sim = Simulator(topo, sched, pol, cfg, device="cuda")
    B = 3
    params = {"rai_frac": np.asarray([0.01, 0.03, 0.2], np.float32),
              "g": np.asarray([1 / 256, 1 / 64, 1 / 16], np.float32)}
    fab = psweep._stack_fabric(sim.fabric, {
        "xoff": np.asarray([0.3e6, 1e6, 2e6], np.float32),
        "kmin": np.asarray([100e3, 400e3, 800e3], np.float32)}, B)
    steps = {k: peng._make_step(pol, cfg, sim.plan, sim.pp, params, fab,
                                k == "cuda", lanes=B)
             for k in ("cuda", "torch")}
    carry = peng._init_carry(sim.pp, sim.plan, pol, cfg, params, lanes=B)
    for it in range(300):
        carry = steps["torch"](carry, it)
    ops.reset_launches()
    got = steps["cuda"](peng._tree_map(torch.clone, carry), 300)
    assert ops.LAUNCHES["fused_signals_policy"] == 1
    want = steps["torch"](peng._tree_map(torch.clone, carry), 300)
    assert float(want["pause_count"].sum()) > 0
    want = dict(_leaves(want))
    for k, a in _leaves(got):
        if a.is_floating_point():
            torch.testing.assert_close(a, want[k], rtol=1e-5, atol=1e-3,
                                       msg=k)
        else:
            assert torch.equal(a, want[k]), k


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_lanes_equal_serial_runs_and_mesh_on_the_card(dev, impl):
    """On the card, on both step paths: 5 lanes of a 16-GPU all-to-all
    as one batch, over a mesh of the card twice (blocks of 3, one pad
    lane) and as 5 serial runs, every array bit for bit, the soft cost
    included (a CUDA sum over the flows of several lanes at once would
    add in an order that follows the lane count)."""
    from repro_torch.common.sharding import grid_mesh
    from repro_torch.core import SweepRunner, alltoall
    topo = single_switch(16)
    sched = alltoall(topo, list(range(16)), 16e6)
    cfg = EngineConfig(dt=1e-6, max_steps=800, max_extends=1,
                       queue_stride=0, step_impl=impl)
    rai = np.geomspace(0.01, 0.3, 5).astype(np.float32)
    plain = SweepRunner(cfg, device="cuda")
    card = torch.device("cuda", torch.cuda.current_device())
    mesh = plain.share_prep(mesh=grid_mesh(2, devices=[card, card]))
    a = plain.run_batch(topo, sched, "dcqcn", {"rai_frac": rai})
    b = mesh.run_batch(topo, sched, "dcqcn", {"rai_frac": rai})
    assert b.meta["mesh_devices"] == 2 and b.meta["chunk_lanes"] == 6
    for k in ("completion_time", "t_finish", "pause_count", "delivered",
              "soft_cost", "finished"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    pol = get_policy("dcqcn")
    for i, r in enumerate(rai):
        s = plain.run(topo, sched, pol, dict(pol.params, rai_frac=float(r)))
        assert np.array_equal(s.t_finish, a.t_finish[i]), i
        assert np.array_equal(s.delivered, a.delivered[i]), i
        assert s.soft_cost == a.soft_cost[i], i


def _leaves(carry, prefix=""):
    for k, v in carry.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("F", [7, 1500, 7936, 130048])
def test_dcqcn_update_kernel_bit_equal(dev, F):
    """The DCQCN update kernel against its plain version, bit for bit,
    with default and non-default parameters and two state draws."""
    for seed, varied in ((F, False), (F + 1, True)):
        st, ecn, line = chip_smoke.dcqcn_state(F, seed, varied, dev)
        for scale in (1.0, 1.3):
            params = {k: v * scale
                      for k, v in cc.make_dcqcn().params.items()}
            before = ccu_ops.LAUNCHES["dcqcn_update"]
            got = ccu_ops.dcqcn_update(st, ecn, line, 2e-3, params)
            assert ccu_ops.LAUNCHES["dcqcn_update"] == before + 1
            want = ccu_ref.dcqcn_update_ref(st, ecn, line, 2e-3, params)
            for k in ccu_ops.ORDER:
                assert torch.equal(got[k], want[k]), (k, seed, scale)


def test_dcqcn_update_wrapper_rejects(dev):
    st, ecn, line = chip_smoke.dcqcn_state(64, 0, False, dev)
    with pytest.raises(TypeError):
        ccu_ops.dcqcn_update(st, ecn.double(), line, 2e-3)
    with pytest.raises(ValueError):
        ccu_ops.dcqcn_update(st, ecn[:32], line, 2e-3)
    with pytest.raises(ValueError):
        ccu_ops.dcqcn_update(st, ecn.cpu(), line, 2e-3)
    with pytest.raises(ValueError):
        ccu_ops.dcqcn_update(
            dict(st, rc=torch.stack([st["rc"], st["rc"]], 1)[:, 0]),
            ecn, line, 2e-3)


def _bf16_table(shape, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_mod.make(shape, "normal", torch.bfloat16, gen, dev)


def _bits_equal(a, b) -> bool:
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


# (T, R, D): the smoke width, Table II's width at both table sizes (8 GB
# at 64 x 1,000,000: byte offsets past 2^31), a wide row, an odd width
@pytest.mark.parametrize("T,R,D", [(3, 1000, 8), (3, 1000, 64),
                                   (64, 1_000_000, 64), (64, 1000, 128),
                                   (3, 1000, 33)])
def test_embedding_bag_kernel_bit_equal(dev, T, R, D):
    """Same float32 sums in the same order, one rounding: equal to the
    bit, for every pooling factor and batch of chip_smoke.py."""
    tab = _bf16_table((T, R, D), T + D, dev)
    rng = np.random.default_rng(R + D)
    for P in (1, 5, 60):
        for B in (1, 7, 256):
            idx = torch.as_tensor(rng.integers(0, R, (B, T, P),
                                               dtype=np.int32), device=dev)
            before = emb_ops.LAUNCHES["embedding_bag_rows"]
            got = emb_ops.embedding_bag_stacked(tab, idx)
            assert emb_ops.LAUNCHES["embedding_bag_rows"] == before + 1
            want = emb_ref.embedding_bag_stacked_ref(tab, idx)
            assert got.dtype == torch.bfloat16 and got.shape == (B, T, D)
            assert _bits_equal(got, want), (P, B)
            rows = idx.view(B * T, P) + 0          # rows of table 0 only
            got = emb_ops.embedding_bag_rows(tab[0], rows)
            want = emb_ref.embedding_bag_rows_ref(tab[0], rows)
            assert got.dtype == torch.float32 and torch.equal(got, want)
    torch.cuda.synchronize()


def test_embedding_bag_unaligned_table_takes_the_scalar_path(dev):
    base = _bf16_table((1 + 500 * 64,), 1, dev)
    tab = base[1:].view(500, 64)           # 2 bytes off a 4-byte boundary
    rows = torch.as_tensor(np.random.default_rng(0).integers(
        0, 500, (300, 60), dtype=np.int32), device=dev)
    assert torch.equal(emb_ops.embedding_bag_rows(tab, rows),
                       emb_ref.embedding_bag_rows_ref(tab, rows))


def test_embedding_bag_wrapper_rejects(dev):
    tab = _bf16_table((2, 10, 8), 0, dev)
    idx = torch.zeros((1, 2, 3), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        emb_ops.embedding_bag_stacked(tab, idx.long())
    with pytest.raises(TypeError):
        emb_ops.embedding_bag_stacked(tab.float(), idx)
    with pytest.raises(ValueError):
        emb_ops.embedding_bag_stacked(tab, idx.cpu())
    # the stacked bags are differentiable (the backward kernel); the
    # rows entry point stays forward-only
    grad_tab = tab.clone().requires_grad_(True)
    out = emb_ops.embedding_bag_stacked(grad_tab, idx)
    assert out.requires_grad
    with pytest.raises(RuntimeError, match="forward-only"):
        emb_ops.embedding_bag_rows(grad_tab.view(20, 8), idx.view(2, 3))
    with torch.no_grad():
        emb_ops.embedding_bag_stacked(grad_tab, idx)
    dp = torch.zeros((1, 2, 8), device=dev)
    with pytest.raises(TypeError):
        emb_ops.embedding_bag_stacked_backward(dp.half(), idx, 10)
    with pytest.raises(ValueError):
        emb_ops.embedding_bag_stacked_backward(dp[:, :1], idx, 10)
    with pytest.raises(ValueError, match="int32 rows"):
        emb_ops.embedding_bag_stacked_backward(dp, idx, 2 ** 30)


# (T, R, D, P, B, dpooled dtype, tables dtype): Table II's shape (8 GB of
# output), many repeats a row (R=100), an odd and a wide width, float32
@pytest.mark.parametrize("T,R,D,P,B,dt_in,dt_out", [
    (64, 1_000_000, 64, 60, 256, torch.bfloat16, torch.bfloat16),
    (64, 100, 64, 60, 256, torch.bfloat16, torch.bfloat16),
    (3, 1000, 33, 5, 7, torch.bfloat16, torch.bfloat16),
    (4, 500, 128, 60, 64, torch.float32, torch.float32),
    (2, 7, 8, 13, 9, torch.float32, torch.bfloat16)])
def test_embedding_bag_backward_kernel_bit_equal(dev, T, R, D, P, B, dt_in,
                                                 dt_out):
    """The float32 sums by row, then (b, p), rounded once: equal to the
    plain version and to a second launch."""
    rng = np.random.default_rng(T * R + D)
    gen = torch.Generator(device=dev).manual_seed(D + P)
    dp = torch.randn((B, T, D), generator=gen, device=dev).to(dt_in)
    idx = torch.as_tensor(rng.integers(0, R, (B, T, P), dtype=np.int32),
                          device=dev)
    want = emb_ref.embedding_bag_stacked_backward_ref(dp, idx, R, dt_out)
    before = emb_ops.LAUNCHES["embedding_bag_backward"]
    got = emb_ops.embedding_bag_stacked_backward(dp, idx, R, dt_out)
    again = emb_ops.embedding_bag_stacked_backward(dp, idx, R, dt_out)
    assert emb_ops.LAUNCHES["embedding_bag_backward"] == before + 2
    assert got.dtype == dt_out and got.shape == (T, R, D)
    assert _bits_equal(got, want)
    assert _bits_equal(again, got)
    del got, again
    torch.cuda.synchronize()


def test_embedding_bag_backward_unaligned_dpooled_takes_the_scalar_path(dev):
    base = torch.randn(1 + 5 * 3 * 64, device=dev).to(torch.bfloat16)
    dp = base[1:].view(5, 3, 64)             # 2 bytes off a 4-byte boundary
    idx = torch.as_tensor(np.random.default_rng(1).integers(
        0, 40, (5, 3, 11), dtype=np.int32), device=dev)
    assert _bits_equal(
        emb_ops.embedding_bag_stacked_backward(dp, idx, 40),
        emb_ref.embedding_bag_stacked_backward_ref(dp, idx, 40,
                                                   torch.bfloat16))


def test_dlrm_training_kernel_path_matches_plain_path(dev):
    """Three AdamW steps of the smoke DLRM: the kernels' path (forward and
    backward bags) equals the plain bags' path bit for bit, one launch of
    each kernel a step."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train.train_step import init_train_state, make_train_step
    cfg = smoke_config("dlrm")
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=10)
    runs = []
    for impl in ("cuda", "torch"):
        model = DLRM(dataclasses.replace(cfg, embedding_impl=impl),
                     device="cuda", seed=0)
        params, opt = init_train_state(model, None, tcfg)
        step = make_train_step(model, tcfg)
        losses = []
        emb_ops.reset_launches()
        for i in range(3):
            params, opt, m = step(params, opt, dlrm_batch(0, i, 64, cfg))
            losses.append(float(m["loss"]))
        launches = dict(emb_ops.LAUNCHES)
        runs.append((losses, params, opt, launches))
    (l_k, p_k, o_k, n_k), (l_p, p_p, o_p, n_p) = runs
    assert n_k == {"embedding_bag_rows": 3, "embedding_bag_backward": 3}
    assert n_p == {"embedding_bag_rows": 0, "embedding_bag_backward": 0}
    assert l_k == l_p
    from repro_torch.common.pytree import tree_leaves
    for x, y in zip(tree_leaves([p_k, o_k["mu"], o_k["nu"]]),
                    tree_leaves([p_p, o_p["mu"], o_p["nu"]])):
        assert _bits_equal(x, y)


def test_dlrm_kernel_path_matches_plain_path(dev):
    cfg = smoke_config("dlrm")
    model = DLRM(cfg, device="cuda", seed=0)
    assert model.embedding_impl == "cuda"
    plain = DLRM(dataclasses.replace(cfg, embedding_impl="torch"),
                 device="cuda", params={
                     "tables": model.tables.data,
                     "bot": {k: v.data for k, v in model.bot.items()},
                     "top": {k: v.data for k, v in model.top.items()}})
    batch = dlrm_batch(0, 0, 64, cfg)
    emb_ops.reset_launches()
    got = model(batch)
    assert emb_ops.LAUNCHES["embedding_bag_rows"] == 1
    want = plain(batch)
    assert emb_ops.LAUNCHES["embedding_bag_rows"] == 1
    assert _bits_equal(got, want)


def _fd_inputs(B, S, Hkv, G, D, dtype, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, Hkv, G, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(dtype)
    return q, k, v


def _fd_assert(q, k, v, length, max_length, softcap=None):
    """One launch against the plain version at the tolerance, and the
    launch with ``max_length`` omitted (the cache's whole split) equal to it
    bit for bit."""
    before = fd_ops.LAUNCHES["flash_decode"]
    got = fd_ops.flash_decode(q, k, v, length, max_length=max_length,
                              softcap=softcap)
    assert fd_ops.LAUNCHES["flash_decode"] == before + 1
    want = fd_ref.flash_decode_ref(q, k, v, length, softcap)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs()
    assert bool((err <= chip_smoke.fd_tolerance(q, k, v, length, want,
                                                softcap)).all()), \
        float(err.max())
    # the split's size does not change the result
    again = fd_ops.flash_decode(q, k, v, length, softcap=softcap)
    assert torch.equal(again, got)
    return got


# (B, S, Hkv, G, D): TinyLlama's heads at one and many chunks, D = 128,
# an S and D that take the scalar loads, G = 16, D = 128 and 256 at G = 8
# and 4
@pytest.mark.parametrize("B,S,Hkv,G,D", [
    (8, 2080, 4, 8, 64), (3, 100, 4, 8, 64), (2, 1000, 2, 4, 128),
    (1, 1, 4, 8, 64), (3, 517, 1, 3, 36), (2, 700, 2, 16, 64),
    (2, 1000, 2, 8, 128), (2, 600, 2, 8, 256), (1, 300, 1, 4, 256)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_flash_decode_kernel_matches_plain(dev, B, S, Hkv, G, D, dtype):
    q, k, v = _fd_inputs(B, S, Hkv, G, D, dtype, S + D, dev)
    lens = [S, max(S - 17, 1), 1, max(S // 3, 1)]
    length = torch.tensor([lens[b % 4] for b in range(B)], dtype=torch.int32,
                          device=dev)
    _fd_assert(q, k, v, length, max(lens[:B]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_flash_decode_lengths_at_chunk_edges(dev, dtype):
    """Rows of CHUNK - 1, CHUNK and CHUNK + 1 keys (and the same around two
    chunks): the last chunk partly, exactly or barely filled."""
    C = fd_ops.CHUNK
    lens = [C - 1, C, C + 1, 2 * C - 1, 2 * C, 2 * C + 1]
    q, k, v = _fd_inputs(len(lens), 4 * C + 5, 4, 8, 64, dtype, 31, dev)
    length = torch.tensor(lens, dtype=torch.int32, device=dev)
    _fd_assert(q, k, v, length, max(lens))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_flash_decode_unaligned_cache_takes_the_scalar_loads(dev, dtype):
    """K and V as views one element into a larger buffer (a sliced cache):
    not 16-byte aligned, so the kernel fills its tiles by scalar loads."""
    B, S, Hkv, G, D = 2, 500, 2, 8, 64
    n = B * S * Hkv * D
    gen = torch.Generator(device=dev).manual_seed(17)
    buf = torch.randn((2 * n + 2,), generator=gen, device=dev).to(dtype)
    k = buf[1:1 + n].view(B, S, Hkv, D)
    v = buf[n + 2:].view(B, S, Hkv, D)
    q = torch.randn((B, Hkv, G, D), generator=gen, device=dev).to(dtype)
    assert k.is_contiguous() and not fd_ops.vector_loads(k, v)
    length = torch.tensor([300, 500], dtype=torch.int32, device=dev)
    _fd_assert(q, k, v, length, 500)


def test_flash_decode_max_length_omitted_is_bit_equal(dev):
    """At S = 32,768 (decode_32k's cache) with ``max_length`` omitted the
    grid covers 512 chunks a row, of which these rows use 33 and 5: the
    output equals the call split to the lengths, bit for bit."""
    q, k, v = _fd_inputs(2, 32768, 4, 8, 64, torch.bfloat16, 5, dev)
    length = torch.tensor([2111, 300], dtype=torch.int32, device=dev)
    _fd_assert(q, k, v, length, 2111)


# (B, S, Hkv, G, D) of Gemma-2 (softcap 50), Gemma-3 and Phi-4-mini's
# decode, at a cut length
@pytest.mark.parametrize("B,S,Hkv,G,D", [(2, 4096, 8, 2, 256),
                                         (2, 1024, 16, 2, 128),
                                         (2, 700, 8, 3, 128)])
@pytest.mark.parametrize("softcap", [None, 50.0, 1.0])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_flash_decode_softcap_matches_plain(dev, B, S, Hkv, G, D, softcap,
                                            dtype):
    """The softcap's instantiations (cap 50: Gemma-2's; cap 1 bends most
    scores) against the plain version; without it, the kernel as before.
    Scores are scaled up 4x so that the cap bites."""
    q, k, v = _fd_inputs(B, S, Hkv, G, D, dtype, S + G, dev)
    q = (q.float() * 4).to(dtype)
    length = torch.tensor([S, max(S // 3, 1)][:B], dtype=torch.int32,
                          device=dev)
    got = _fd_assert(q, k, v, length, S, softcap)
    if softcap is not None:
        plain = fd_ops.flash_decode(q, k, v, length)
        assert not torch.equal(plain, got)


def test_flash_decode_over_a_ring(dev):
    """A ring decode is the kernel at length = max_length = min(pos + 1,
    Wr) over the ring's first slots: against the plain version, softcap
    50, before and after the ring wraps."""
    B, Wr, Hkv, G, D = 2, 1024, 8, 2, 256
    q, k, v = _fd_inputs(B, Wr, Hkv, G, D, torch.bfloat16, 3, dev)
    for pos in (5, 1023, 1024, 5000):
        n = min(pos + 1, Wr)
        length = torch.full((B,), n, dtype=torch.int32, device=dev)
        _fd_assert(q, k, v, length, n, 50.0)


def test_flash_decode_wrapper_rejects(dev):
    q, k, v = _fd_inputs(2, 64, 2, 4, 64, torch.bfloat16, 0, dev)
    length = torch.full((2,), 64, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        fd_ops.flash_decode(q, k.float(), v, length)
    with pytest.raises(TypeError):
        fd_ops.flash_decode(q, k, v, length.long())
    with pytest.raises(ValueError):
        fd_ops.flash_decode(q, k, v, length.cpu())
    with pytest.raises(ValueError, match="limits"):
        qq, kk, vv = _fd_inputs(1, 8, 1, 32, 64, torch.bfloat16, 0, dev)
        fd_ops.flash_decode(qq, kk, vv, length[:1])
    for bad in (0.0, -50.0, float("nan")):
        with pytest.raises(ValueError, match="softcap"):
            fd_ops.flash_decode(q, k, v, length, softcap=bad)
    # the C entry point refuses a negative cap itself
    args = fd_ops.kernel_args(q, k, v, length, torch.empty_like(q), 1, None,
                              None, -1.0)
    assert fd_ops.kernel_function()(
        *args, torch.cuda.current_stream().cuda_stream) != 0


@pytest.mark.parametrize("arch", ["gemma2-9b", "gemma3-27b",
                                  "phi4-mini-3.8b"])
def test_sliding_window_serving_kernel_path_matches_torch_path(dev, arch):
    """The smoke configs on the card, prompt 40 past the 32-slot window
    (local_attention, the ring filled wrapped), then 12 decode steps: one
    launch per layer and step, global and ring layers alike, softcap
    included; the kernel path's logits against the torch path's."""
    cfg = smoke_config(arch)
    model = Model(cfg, device="cuda")
    shapes = tree_map(lambda d: d.shape, model.param_defs())
    params = tree_map(lambda a: torch.from_numpy(a).to(dev),
                      chip_smoke.transformer_numpy_params(shapes, 5, False))
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 52),
                                             dtype=np.int32)
    _, cache_c = model.prefill(params, {"tokens": toks[:, :40]}, max_len=60)
    _, cache_t = model.prefill(params, {"tokens": toks[:, :40]}, max_len=60)
    for t in range(40, 52):
        fd_ops.reset_launches()
        got, cache_c = model.decode_step(params, cache_c, toks[:, t:t + 1])
        assert fd_ops.LAUNCHES["flash_decode"] == cfg.n_layers
        want, cache_t = model.decode_step(params, cache_t, toks[:, t:t + 1],
                                          "torch")
        rel = float((got - want).norm() / want.norm())
        assert rel <= 2e-2, (t, rel)


def test_serving_kernel_path_matches_torch_path(dev):
    """Smoke TinyLlama on the card: 22 -> 2 layers, so 2 launches per
    decode step; the kernel path's logits against the torch path's, on
    numpy weights at the true fan-in (tests/test_torch_serve.py)."""
    cfg = smoke_config("tinyllama-1.1b")
    model = Model(cfg, device="cuda")
    assert model.decode_impl == "cuda"
    shapes = tree_map(lambda d: d.shape, model.param_defs())
    params = tree_map(lambda a: torch.from_numpy(a).to(dev),
                      chip_smoke.transformer_numpy_params(shapes, 5, False))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (3, 20),
                                             dtype=np.int32)
    _, cache_c = model.prefill(params, {"tokens": toks[:, :12]}, max_len=40)
    _, cache_t = model.prefill(params, {"tokens": toks[:, :12]}, max_len=40)
    for t in range(12, 20):
        fd_ops.reset_launches()
        got, cache_c = model.decode_step(params, cache_c, toks[:, t:t + 1])
        assert fd_ops.LAUNCHES["flash_decode"] == cfg.n_layers
        want, cache_t = model.decode_step(params, cache_t, toks[:, t:t + 1],
                                          "torch")
        assert fd_ops.LAUNCHES["flash_decode"] == cfg.n_layers
        rel = float((got - want).norm() / want.norm())
        assert rel <= 2e-2, (t, rel)
    eng = ServeEngine(model, params, batch_slots=2, max_len=32)
    fd_ops.reset_launches()
    res = eng.run([Request(i, toks[i, :10], 5) for i in range(3)])
    assert [r.tokens.shape for r in res] == [(5,)] * 3
    assert fd_ops.LAUNCHES["flash_decode"] == cfg.n_layers * 4 * 2


# ------------------------------------------------------------ the int8 cache

def _fd_int8_inputs(B, S, Hkv, G, D, seed, dev, qscale=1.0):
    """bf16 q over an int8 K/V cache quantised from random bf16 rows."""
    from repro_torch.models.layers import quantize_kv
    q, k, v = _fd_inputs(B, S, Hkv, G, D, torch.bfloat16, seed, dev)
    q = (q.float() * qscale).to(torch.bfloat16)
    k8, ks = quantize_kv(k)
    v8, vs = quantize_kv(v)
    return q, k8, v8, ks, vs


# (B, S, Hkv, G, D): TinyLlama's heads, D = 128 and 256, a D that takes the
# scalar loads (no 16-byte int8 rows); with the softcap and without
@pytest.mark.parametrize("B,S,Hkv,G,D", [
    (8, 2080, 4, 8, 64), (3, 100, 4, 8, 64), (2, 1000, 2, 4, 128),
    (2, 600, 2, 8, 256), (3, 517, 1, 3, 40), (1, 1, 4, 8, 64)])
@pytest.mark.parametrize("softcap", [None, 50.0])
def test_flash_decode_int8_matches_plain(dev, B, S, Hkv, G, D, softcap):
    q, k8, v8, ks, vs = _fd_int8_inputs(B, S, Hkv, G, D, S + D, dev,
                                        4.0 if softcap else 1.0)
    lens = [S, max(S - 17, 1), 1, max(S // 3, 1)]
    length = torch.tensor([lens[b % 4] for b in range(B)], dtype=torch.int32,
                          device=dev)
    fd_ops.reset_launches()
    got = fd_ops.flash_decode(q, k8, v8, length, max_length=max(lens[:B]),
                              softcap=softcap, k_scale=ks, v_scale=vs)
    assert fd_ops.LAUNCHES["flash_decode"] == 1
    want = fd_ref.flash_decode_quant_ref(q, k8, v8, ks, vs, length, softcap)
    err = (got.float() - want.float()).abs()
    tol = chip_smoke.fd_tolerance(q, k8, v8, length, want, softcap, (ks, vs))
    assert bool((err <= tol).all()), float(err.max())
    again = fd_ops.flash_decode(q, k8, v8, length, softcap=softcap,
                                k_scale=ks, v_scale=vs)
    assert torch.equal(again, got)


def test_flash_decode_int8_unaligned_cache(dev):
    """An int8 cache one element into a larger buffer: the scalar loads."""
    q, k8, v8, ks, vs = _fd_int8_inputs(2, 500, 2, 8, 64, 9, dev)
    n = k8.numel()
    buf = torch.zeros(2 * n + 2, dtype=torch.int8, device=dev)
    buf[1:1 + n], buf[n + 2:] = k8.reshape(-1), v8.reshape(-1)
    k8, v8 = buf[1:1 + n].view(k8.shape), buf[n + 2:].view(v8.shape)
    assert not fd_ops.vector_loads(k8, v8)
    length = torch.tensor([300, 500], dtype=torch.int32, device=dev)
    got = fd_ops.flash_decode(q, k8, v8, length, k_scale=ks, v_scale=vs)
    want = fd_ref.flash_decode_quant_ref(q, k8, v8, ks, vs, length)
    tol = chip_smoke.fd_tolerance(q, k8, v8, length, want, None, (ks, vs))
    assert bool(((got.float() - want.float()).abs() <= tol).all())


def test_flash_decode_int8_wrapper_rejects(dev):
    q, k8, v8, ks, vs = _fd_int8_inputs(2, 64, 2, 4, 64, 0, dev)
    length = torch.full((2,), 64, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="int8 cache"):
        fd_ops.flash_decode(q, k8, v8, length)
    with pytest.raises(TypeError, match="bf16"):
        fd_ops.flash_decode(q.float(), k8, v8, length, k_scale=ks,
                            v_scale=vs)
    with pytest.raises(ValueError, match="v_scale"):
        fd_ops.flash_decode(q, k8, v8, length, k_scale=ks,
                            v_scale=vs.double())
    # the C entry point refuses one scale pointer without the other
    args = fd_ops.kernel_args(q, k8, v8, length, torch.empty_like(q), 1,
                              None, None, None, ks, None)
    assert fd_ops.kernel_function()(
        *args, torch.cuda.current_stream().cuda_stream) != 0


def test_int8_cache_serving_kernel_path_matches_torch_path(dev):
    """Smoke TinyLlama with the int8 cache on the card: one launch of the
    int8 instantiation per layer and decode step; the kernel path's logits
    against the torch path's ``decode_attention_quant``."""
    cfg = dataclasses.replace(smoke_config("tinyllama-1.1b"),
                              kv_quant_int8=True)
    model = Model(cfg, device="cuda")
    shapes = tree_map(lambda d: d.shape, model.param_defs())
    params = tree_map(lambda a: torch.from_numpy(a).to(dev),
                      chip_smoke.transformer_numpy_params(shapes, 5, False))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (3, 20),
                                             dtype=np.int32)
    _, cache_c = model.prefill(params, {"tokens": toks[:, :12]}, max_len=40)
    _, cache_t = model.prefill(params, {"tokens": toks[:, :12]}, max_len=40)
    assert cache_c["layers"][0]["l0"]["k"].dtype == torch.int8
    for t in range(12, 20):
        fd_ops.reset_launches()
        got, cache_c = model.decode_step(params, cache_c, toks[:, t:t + 1])
        assert fd_ops.LAUNCHES["flash_decode"] == cfg.n_layers
        want, cache_t = model.decode_step(params, cache_t, toks[:, t:t + 1],
                                          "torch")
        rel = float((got - want).norm() / want.norm())
        assert rel <= 2e-2, (t, rel)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-3b",
                                  "deepseek-v2-236b"])
def test_new_families_serve_on_the_card(dev, arch):
    """The smoke configs of the new families on the card: Zamba2's shared
    block through the kernel (one launch per application and step), RWKV-6
    and MLA + MoE with no kernel; the kernel path's logits against the
    torch path's, each step from the kernel path's cache (the recurrent
    states would carry one step's rounding into every later one)."""
    cfg = smoke_config(arch)
    model = Model(cfg, device="cuda")
    shapes = tree_map(lambda d: d.shape, model.param_defs())
    params = tree_map(lambda a: torch.from_numpy(a).to(dev),
                      chip_smoke.transformer_numpy_params(shapes, 5, False))
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 24),
                                             dtype=np.int32)
    attn = sum(k[0] == "shared_gqa" for g in model.groups for _ in range(g.n)
               for k in g.kinds)
    _, cache_c = model.prefill(params, {"tokens": toks[:, :16]}, max_len=30)
    for t in range(16, 24):
        cache_t = {"layers": tree_map(lambda x: x.clone(),
                                      cache_c["layers"]),
                   "pos": cache_c["pos"]}
        fd_ops.reset_launches()
        got, cache_c = model.decode_step(params, cache_c, toks[:, t:t + 1])
        assert fd_ops.LAUNCHES["flash_decode"] == attn
        want, cache_t = model.decode_step(params, cache_t, toks[:, t:t + 1],
                                          "torch")
        rel = float((got - want).norm() / want.norm())
        assert rel <= 2e-2, (t, rel)


# --------------------------------------------- the gradients' fixed order

def test_soft_cost_gradient_repeats_bit_for_bit(dev):
    """The op path's gradient on the card, twice in one process: the
    backward sums the gathers' gradients through the fixed-order segment
    plans (``segment_reduce``, no atomics), so the gradients
    are equal bit for bit; and within rtol 1e-5 of the CPU's
    ``index_add_`` backward."""
    from repro_torch.core import CollectiveSpec, FabricSpec, ScenarioSpec
    topo, sched, pol = ScenarioSpec(
        FabricSpec("clos", n_racks=2, nodes_per_rack=1, gpus_per_node=4,
                   oversubscription=2.0),
        CollectiveSpec("2d", 16e6), "dcqcn").build()
    cfg = EngineConfig(dt=1e-6, max_steps=1500, max_extends=2,
                       queue_stride=0)    # delay classes of 1 and 4 steps
    grads = []
    for device in ("cuda", "cuda", "cpu"):
        sim = Simulator(topo, sched, pol, cfg, device=device)
        leaves = {k: torch.tensor(np.float32(pol.params[k]), device=device,
                                  requires_grad=True)
                  for k in ("rai_frac", "g")}
        before = dict(ops.LAUNCHES)
        v = sim.soft_cost_fn()(leaves)
        g = torch.autograd.grad(v, list(leaves.values()))
        seg = ops.LAUNCHES["segment_reduce"] - before["segment_reduce"]
        if device == "cuda":
            assert seg > 0
            assert ops.LAUNCHES["fused_signals_policy"] == \
                before["fused_signals_policy"]
        grads.append([float(x) for x in g] + [float(v)])
    assert grads[0] == grads[1]
    np.testing.assert_allclose(grads[0], grads[2], rtol=1e-5)
