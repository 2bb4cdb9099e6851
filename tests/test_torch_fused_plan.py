"""The fused engine-step kernel's launch plan (``repro_torch.kernels.
engine_step.ops``): the persistent blocks' walk over (lane, flow-tile) work
items covers every (lane, flow) exactly once, the copy route, the C entry
point's argument layout, and the scalar check's CPU route.  Plain Python
on the CPU; the kernel itself is held against its plain version on the
card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``)."""
import re

import numpy as np
import pytest
import torch

from repro_torch.core import arith, cc
from repro_torch.kernels import build
from repro_torch.kernels.engine_step import ops

SRC = build.SOURCES["engine_step"].read_text()

FLOWS = [1, 127, 128, 129, 255, 256, 257, 1500, 7936, 65024, 130049,
         131072]
RESIDENT = [1, 2, 7, 132, 660, 1 << 20]


def _cover(B, F, blocks, tiles):
    seen = np.zeros((B, F), np.int64)
    for mine in ops.plan_items(B, F, blocks, tiles):
        for b, f0, n in mine:
            assert 1 <= n <= ops.TILE and f0 % ops.TILE == 0
            seen[b, f0:f0 + n] += 1
    return seen


@pytest.mark.parametrize("B", [1, 3, 9])
@pytest.mark.parametrize("F", FLOWS)
def test_plan_covers_every_flow_once(B, F):
    for resident in RESIDENT:
        blocks, tiles = ops.fused_plan(B, F, resident)
        assert tiles == -(-F // ops.TILE)
        assert blocks == min(resident, B * tiles) >= 1
        seen = _cover(B, F, blocks, tiles)
        assert (seen == 1).all(), (B, F, resident)


@pytest.mark.parametrize("blocks", [1, 5, 64, 1000])
def test_plan_walk_is_strided_and_lane_major(blocks):
    """Block i takes items i, i + blocks, ...; item j is lane j // tiles,
    tile j % tiles; a lane's last tile is the short one."""
    B, F = 4, 1000
    tiles = -(-F // ops.TILE)
    walk = ops.plan_items(B, F, blocks, tiles)
    assert len(walk) == blocks
    for i, mine in enumerate(walk):
        items = list(range(i, B * tiles, blocks))
        assert [(b, f0) for b, f0, _ in mine] == [
            (j // tiles, (j % tiles) * ops.TILE) for j in items]
        for b, f0, n in mine:
            assert n == (F - f0 if f0 == (tiles - 1) * ops.TILE
                         else ops.TILE)


def test_plan_rejects_empty():
    for B, F, r in [(0, 10, 5), (1, 0, 5), (1, 10, 0)]:
        with pytest.raises(ValueError):
            ops.fused_plan(B, F, r)


@pytest.mark.parametrize("F,offset,vec", [
    (131072, 0, True), (1500, 0, True), (1500, 16, True), (1500, 8, False),
    (1500, 4, False), (130049, 0, False), (257, 0, False), (1, 0, False)])
def test_copy_route(F, offset, vec):
    """16-byte copies only where every row starts and ends on 16 bytes:
    F a multiple of 4 and every base pointer (here the sixth, shifted by
    ``offset`` bytes) 16-byte aligned."""
    ptrs = [4096 * k for k in range(12)]
    ptrs[5] += offset
    assert ops.vector_copies(F, ptrs) is vec


@pytest.mark.parametrize("name", ["dcqcn", "mlp", "pfc"])
def test_launch_args_match_the_c_signature(name, monkeypatch):
    """The wrapper's argument list has one entry per ctypes argtype but the
    stream, with the plan (blocks, tiles_per_lane, vec) last."""
    policy = cc.get_policy(name)
    K = max(len(ops.KERNEL_ABI[name][0]), 1)
    P = max(len(ops.KERNEL_ABI[name][1]), 1)
    monkeypatch.setattr(ops, "resident_blocks", lambda pid, k: 660)
    B, F = 3, 1500
    ins = [torch.zeros(B, 4, F) for _ in range(8)]
    ins += [torch.zeros(B, F) for _ in range(3)]
    ins += [torch.zeros(B, K, F), torch.zeros(B, P)]
    outs = (torch.zeros(B, K, F), torch.zeros(B, F), torch.zeros(B, F))
    args = ops.launch_args(policy.kernel_id, ins, outs, 3.3e-4, 1e-5, 4e-6)
    assert len(args) == len(ops._SIGNATURES["fused_signals_policy"]) - 1
    assert args[0] == policy.kernel_id
    assert args[17:21] == [B, F, K, P]
    assert args[-3:-1] == [min(660, B * 12), 12]
    assert args[-1] == int(ops.vector_copies(F, args[1:13]))


def test_source_constants_match_the_wrapper():
    """TILE and the widest param row in engine_step.cu agree with ops; the
    scalar functions' indices agree with SCALAR_FNS."""
    assert int(re.search(r"constexpr int TILE = (\d+);", SRC).group(1)) \
        == ops.TILE
    maxp = int(re.search(r"constexpr int MAXP = (\d+);", SRC).group(1))
    assert maxp == max(len(p) for _, p in ops.KERNEL_ABI.values())
    body = SRC[SRC.index("scalar_fn_kernel"):]
    order = re.findall(r"(cephes_expf|xla_tanhf|xla_sigmoidf|ftz)\(v\)",
                       body)
    assert order == ["cephes_expf", "xla_tanhf", "xla_sigmoidf", "ftz"]
    assert list(ops.SCALAR_FNS.items()) == [("expf", 0), ("tanhf", 1),
                                            ("sigmoidf", 2), ("ftz", 3)]


@pytest.mark.parametrize("name", list(ops.SCALAR_FNS))
def test_scalar_fn_on_cpu_is_the_plain_version(name):
    x = torch.tensor([0.0, -0.0, 1e-40, 3e-4, 4e-4, 0.5, -3.0, 7.99881172,
                      88.7, -88.7, 100.0, float("inf"), float("-inf"),
                      float("nan")], dtype=torch.float32)
    got = ops.scalar_fn(name, x)
    want = getattr(arith, name)(x)
    assert torch.equal(got.view(torch.int32)[:-1],
                       want.view(torch.int32)[:-1])
    assert torch.isnan(got[-1]) and torch.isnan(want[-1])
