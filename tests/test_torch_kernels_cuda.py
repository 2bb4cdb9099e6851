"""The port's CUDA kernels against their plain PyTorch versions, on the
card (``repro_torch.kernels.engine_step`` and
``repro_torch.kernels.embedding_bag``).

Needs an NVIDIA Hopper card with ``nvcc``; everywhere else every test
skips (the kernels have no CPU mode).  On the card, run without the
repository's conftest (which imports jax, absent there):

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import (EngineConfig, Simulator, get_policy, incast,
                              single_switch)
from repro_torch.core import cc
from repro_torch.common import init as init_mod
from repro_torch.configs import smoke_config
from repro_torch.data import dlrm_batch
from repro_torch.kernels.embedding_bag import ops as emb_ops
from repro_torch.kernels.embedding_bag import ref as emb_ref
from repro_torch.kernels.engine_step import ops, ref
from repro_torch.models import DLRM

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


@pytest.mark.parametrize("lossy", [False, True], ids=["lossless", "lossy"])
@pytest.mark.parametrize("name", cc.ALL_POLICIES)
def test_fused_kernel_matches_plain(dev, name, lossy):
    """rtol 1e-5: both evaluate the same float32 operations; the plain
    version emulates fmaf in float64, which rounds twice in rare ties."""
    policy = cc.get_policy(name)
    case, state, params = _case(policy, 1500, 3, lossy, 3, dev)
    before = ops.LAUNCHES["fused_signals_policy"]
    got = ops.fused_signals_policy(policy, *case, state, params, 3.3e-4,
                                   1e-5)
    want = ref.fused_signals_policy_ref(policy, *case, state, params,
                                        3.3e-4, 1e-5)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_signals_policy"] == before + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(),
                                   w.expand_as(g).cpu().numpy(), rtol=1e-5)


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
    grad_tab = tab.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        emb_ops.embedding_bag_stacked(grad_tab, idx)
    with torch.no_grad():
        emb_ops.embedding_bag_stacked(grad_tab, idx)


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
