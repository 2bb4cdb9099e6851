"""The port's embedding bag (``repro_torch.kernels.embedding_bag``, plain
versions on the CPU) against the reference's: the Pallas kernel in
interpret mode (``embedding_bag_stacked``, ``embedding_bag_rows``) and the
jnp oracle (``embedding_bag_stacked_ref``, ``embedding_bag_rows_ref``).

The same seeded numpy tables and ids go through both.  The pooled bags
must be equal to the bit: both sum the rows in float32 in the order j = 0
.. P-1 and round once to bf16.  The float32 row sums equal the Pallas
kernel's to the bit; the jnp oracle's XLA reduction picks its own order at
some widths, so there the tolerance is float32 rounding of the sum
(1e-6 x sum |rows|).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.embedding_bag import (
    embedding_bag_rows as r_rows)
from repro.kernels.embedding_bag.ops import embedding_bag_stacked as r_stack
from repro.kernels.embedding_bag.ref import (embedding_bag_rows_ref,
                                             embedding_bag_stacked_ref)
from repro_torch.kernels.embedding_bag import ops, ref

# (B, T, P, D, R): the DLRM smoke config, Table II widths with few bags,
# odd widths and a wide row; B * T * P stays under 10k (interpret mode runs
# one grid step per (bag, j))
CASES = [(3, 4, 5, 8, 100), (2, 8, 60, 64, 1000), (5, 3, 7, 33, 50),
         (4, 16, 37, 128, 300), (1, 2, 1, 64, 10)]
IDS = [f"B{b}_T{t}_P{p}_D{d}_R{r}" for b, t, p, d, r in CASES]


def _bf16_pair(shape, seed):
    """The same bf16 table for both packages (numpy bits -> each)."""
    rng = np.random.default_rng(seed)
    f = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    j = jnp.asarray(f).astype(jnp.bfloat16)
    bits = np.asarray(j).view(np.int16).copy()
    return j, torch.from_numpy(bits).view(torch.bfloat16)


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


@pytest.mark.parametrize("B,T,P,D,R", CASES, ids=IDS)
def test_stacked_bit_equal_to_both_reference_paths(B, T, P, D, R):
    tab_j, tab_t = _bf16_pair((T, R, D), seed=B * 1000 + D)
    idx = np.random.default_rng(P).integers(0, R, (B, T, P), dtype=np.int32)
    got = ops.embedding_bag_stacked(tab_t, torch.from_numpy(idx))
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, D)
    pallas = r_stack(tab_j, jnp.asarray(idx))          # interpret mode
    oracle = embedding_bag_stacked_ref(tab_j, jnp.asarray(idx))
    np.testing.assert_array_equal(_bits(got), _bits(pallas))
    np.testing.assert_array_equal(_bits(got), _bits(oracle))


@pytest.mark.parametrize("B,T,P,D,R", CASES, ids=IDS)
def test_rows_float32_sums(B, T, P, D, R):
    tab_j, tab_t = _bf16_pair((R, D), seed=D + P)
    rows = np.random.default_rng(B).integers(0, R, (B * T, P),
                                             dtype=np.int32)
    got = ops.embedding_bag_rows(tab_t, torch.from_numpy(rows)).numpy()
    assert got.dtype == np.float32 and got.shape == (B * T, D)
    Dp = max(128, -(-D // 128) * 128)                   # the TPU lane pad
    padded = jnp.pad(tab_j, ((0, 0), (0, Dp - D)))
    pallas = np.asarray(r_rows(padded, jnp.asarray(rows)))[:, :D]
    np.testing.assert_array_equal(got, pallas)
    oracle = np.asarray(embedding_bag_rows_ref(tab_j, jnp.asarray(rows)))
    mag = ref.embedding_bag_rows_ref(tab_t.abs(),
                                     torch.from_numpy(rows)).numpy()
    assert np.all(np.abs(got - oracle) <= 1e-6 * mag)


def test_plain_versions_add_in_pallas_order():
    """Summing in another order gives other bits: the loop order is what
    makes the plain version (and the kernel) equal the reference."""
    tab = torch.tensor([[1.0], [2.0 ** -24], [-1.0], [2.0 ** -24]])
    rows = torch.tensor([[0, 1, 2, 3]], dtype=torch.int32)
    got = ref.embedding_bag_rows_ref(tab, rows)
    acc = torch.zeros(1)
    for j in range(4):
        acc = acc + tab[rows[0, j].item()]
    assert torch.equal(got[0], acc)       # 1 + 2^-24 rounds to 1: 2^-24
    assert float(got[0, 0]) == 2.0 ** -24


def test_cpu_wrappers_check_the_id_range():
    tab = torch.zeros((2, 10, 8), dtype=torch.bfloat16)
    ok = torch.zeros((1, 2, 3), dtype=torch.int32)
    assert ops.embedding_bag_stacked(tab, ok).shape == (1, 2, 8)
    for bad in (10, -1):
        idx = ok.clone()
        idx[0, 1, 2] = bad
        with pytest.raises(IndexError, match=r"\[0, 10\)"):
            ops.embedding_bag_stacked(tab, idx)
    with pytest.raises(IndexError, match=r"\[0, 20\)"):
        ops.embedding_bag_rows(tab.view(20, 8),
                               torch.tensor([[0, 20]], dtype=torch.int32))
    with pytest.raises(ValueError, match="tables"):
        ops.embedding_bag_stacked(tab, torch.zeros((1, 3, 3),
                                                   dtype=torch.int32))


def test_cpu_path_never_counts_a_launch():
    ops.reset_launches()
    tab = torch.zeros((2, 10, 8), dtype=torch.bfloat16)
    ops.embedding_bag_stacked(tab, torch.zeros((1, 2, 3), dtype=torch.int32))
    ops.embedding_bag_stacked_backward(torch.zeros((1, 2, 8)),
                                       torch.zeros((1, 2, 3),
                                                   dtype=torch.int32), 10)
    assert ops.LAUNCHES == {"embedding_bag_rows": 0,
                            "embedding_bag_backward": 0}
