"""The port's plain flash decode (``repro_torch.kernels.flash_decode``, on
the CPU) against the reference's Pallas kernel in interpret mode
(``repro.kernels.flash_decode.ops.gqa_decode_attention``) and its jnp
oracle (``flash_decode_ref``), on the same numpy inputs.

Tolerances (the CUDA kernel is held to the same ones on the card):
float32 outputs within 1e-5 of the softmax-weighted sum of |v| (the
scale of the terms the output sums, so an output that cancels to near 0
is not held to a relative bound it cannot meet); bf16 outputs within 1
bf16 ulp plus that bound (the float32 results differ in their last bits,
and each is rounded once to bf16: equal or 1 ulp apart unless the output
cancels).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode.ops import gqa_decode_attention as r_gqa_decode
from repro.kernels.flash_decode.ref import flash_decode_ref as r_flash_decode_ref
from repro_torch.kernels.flash_decode import LAUNCHES, flash_decode, gqa_decode_attention
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode import ref as fd_ref

F32_TOL = 1e-5

# tests/test_kernels.py's shapes, TinyLlama's (Hkv 4, G 8, D 64), and
# S = 131, which no block_s divides (the Pallas wrapper halves block_s to 1)
SHAPES = [(1, 256, 1, 1, 128), (2, 512, 2, 4, 128), (2, 384, 4, 2, 64),
          (1, 1024, 2, 8, 128), (3, 300, 4, 8, 64), (2, 131, 4, 8, 64)]


def _inputs(B, S, Hkv, G, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hkv, G, D), np.float32)
    k = rng.standard_normal((B, S, Hkv, D), np.float32)
    v = rng.standard_normal((B, S, Hkv, D), np.float32)
    length = np.array([S - 17, S, 1][:B] if B <= 3 else [S] * B, np.int32)
    length = np.maximum(length, 1)
    return q, k, v, length


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each (float32) value."""
    return np.spacing(np.abs(x).astype(np.float32)) * 65536


def _torch(x, dtype):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _jnp(x, dtype):
    return jnp.asarray(x).astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hkv,G,D", SHAPES,
                         ids=[f"B{b}S{s}H{h}G{g}D{d}" for b, s, h, g, d in SHAPES])
def test_plain_matches_pallas_and_oracle(B, S, Hkv, G, D, dtype):
    q, k, v, length = _inputs(B, S, Hkv, G, D, S + D)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tq, tk, tv = (_torch(x, tdt) for x in (q, k, v))
    before = LAUNCHES["flash_decode"]
    got = flash_decode(tq, tk, tv, torch.from_numpy(length))
    assert LAUNCHES["flash_decode"] == before       # the plain version
    assert got.dtype == tdt and got.shape == (B, Hkv, G, D)
    jq, jk, jv = (_jnp(x, jdt) for x in (q, k, v))
    jl = jnp.asarray(length)
    oracle = r_flash_decode_ref(jq, jk, jv, jl)
    pallas = r_gqa_decode(jq.reshape(B, 1, Hkv * G, D), jk, jv, jl,
                          block_s=256).reshape(B, Hkv, G, D)
    # the terms' scale: the same softmax over |v|
    scale = fd_ref.flash_decode_ref(tq.float(), tk.float(), tv.float().abs(),
                                    torch.from_numpy(length)).numpy()
    for want in (oracle, pallas):
        want = np.asarray(want.astype(jnp.float32))
        tol = F32_TOL * scale
        if dtype == "bfloat16":
            tol = tol + _bf16_ulp(want)
        err = np.abs(got.float().numpy() - want)
        assert np.all(err <= tol), float((err / tol).max())


def test_gqa_layout_matches_reference():
    """(B, 1, Hq, D) in and out, the cache longer than the lengths."""
    B, S, Hkv, G, D = 3, 200, 2, 4, 64
    q, k, v, length = _inputs(B, S, Hkv, G, D, 1)
    q = q.reshape(B, 1, Hkv * G, D)
    got = gqa_decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(length),
                               max_length=int(length.max()))
    want = r_gqa_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(length), block_s=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_TOL)


def test_cpu_wrapper_checks_lengths():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(2, 16, 1, 2, 8, 0))
    for bad in ([0, 16], [1, 17]):
        with pytest.raises(ValueError, match="lengths must lie"):
            flash_decode(q, k, v, torch.tensor(bad, dtype=torch.int32))
    with pytest.raises(ValueError, match="span devices"):
        flash_decode(q, k, v, torch.ones(2, dtype=torch.int32,
                                         device="meta"))


def test_cpu_wrapper_refuses_max_length_below_a_length():
    """The card reads only the first ``max_length`` positions, so a
    ``max_length`` below some row's length is refused on the CPU rather
    than attended in full; at or above the longest row it is the plain
    result."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(2, 16, 1, 2, 8, 0))
    length = torch.tensor([5, 12], dtype=torch.int32)
    with pytest.raises(ValueError, match="max_length 11 is below"):
        flash_decode(q, k, v, length, max_length=11)
    want = flash_decode(q, k, v, length)
    for ok in (12, 16):
        assert torch.equal(flash_decode(q, k, v, length, max_length=ok),
                           want)


# lengths across the kernel's chunk boundaries (CHUNK and its multiples)
C = fd_ops.CHUNK
PLAN_LENGTHS = [1, C - 1, C, C + 1, 2 * C - 1, 2 * C, 2 * C + 1, 5 * C + 3]


@pytest.mark.parametrize("use_max_length", [False, True],
                         ids=["max_length_none", "max_length_max"])
def test_split_plan(use_max_length):
    """How many chunks each row reads (ceil(length / CHUNK)), the grid's
    split count and the scratch shapes, from ``ops.split_plan``."""
    S = 8 * C + 5
    shape = (len(PLAN_LENGTHS), 4, 8, 64)
    max_length = max(PLAN_LENGTHS) if use_max_length else None
    plan = fd_ops.split_plan(PLAN_LENGTHS, S, max_length, shape)
    splits = -(-(max_length or S) // C)
    assert plan["n_splits"] == splits == fd_ops.n_splits(S, max_length)
    assert plan["chunks_read"] == [1, 1, 1, 2, 2, 2, 3, 6]
    assert plan["merge"] is True
    assert plan["acc"] == (len(PLAN_LENGTHS), 4, splits, 8, 64)
    assert plan["ml"] == (len(PLAN_LENGTHS), 4, splits, 2, 8)
    # what each row reads does not depend on max_length
    other = fd_ops.split_plan(PLAN_LENGTHS, S, None if use_max_length
                              else max(PLAN_LENGTHS))
    assert other["chunks_read"] == plan["chunks_read"]


def test_split_plan_one_chunk_and_clamps():
    """One chunk writes the output (no scratch, no merge); lengths above S
    read S positions; length 0 reads no chunk."""
    plan = fd_ops.split_plan([C, 1], 3 * C, C, (2, 1, 4, 16))
    assert plan == {"n_splits": 1, "chunks_read": [1, 1], "merge": False,
                    "acc": None, "ml": None}
    plan = fd_ops.split_plan([10 * C, 0], 3 * C + 1)
    assert plan["n_splits"] == 4 and plan["chunks_read"] == [4, 0]
    q = torch.zeros((2, 1, 4, 16))
    assert fd_ops.scratch(q, 1) == (None, None)
    acc, ml = fd_ops.scratch(q, 3)
    assert acc.shape == (2, 1, 3, 4, 16) and ml.shape == (2, 1, 3, 2, 4)
    assert acc.dtype == ml.dtype == torch.float32


# (B, S, Hkv, G, D, lengths): rows on both sides of one, two and several
# chunk boundaries; S a multiple of 256 so that the Pallas kernel's grid
# keeps block_s = 256
MERGE_CASES = [(4, 768, 2, 4, 64, [C - 1, C, C + 1, 700]),
               (2, 512, 1, 8, 32, [1, 2 * C + 1]),
               (3, 256, 2, 3, 36, [2 * C, 2 * C - 1, 256])]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hkv,G,D,lengths", MERGE_CASES,
                         ids=[f"B{c[0]}S{c[1]}G{c[3]}D{c[4]}" for c in MERGE_CASES])
def test_chunked_merge_model_matches_ref_and_pallas(B, S, Hkv, G, D, lengths,
                                                    dtype):
    """The plain model of the kernel's split and merge (fixed-CHUNK
    partials merged in split order, ``ref.flash_decode_chunked_ref``), on
    the plan's chunks, against ``flash_decode_ref`` and the Pallas kernel
    in interpret mode, at the tolerance the card holds the kernel to."""
    q, k, v, _ = _inputs(B, S, Hkv, G, D, S + D + 7)
    length = np.asarray(lengths, np.int32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tq, tk, tv = (_torch(x, tdt) for x in (q, k, v))
    tl = torch.from_numpy(length)
    plan = fd_ops.split_plan(lengths, S)
    got = fd_ref.flash_decode_chunked_ref(tq, tk, tv, tl, C,
                                          plan["chunks_read"])
    # the same model split to the lengths: the same result, bit for bit
    again = fd_ref.flash_decode_chunked_ref(
        tq, tk, tv, tl, C, fd_ops.split_plan(lengths, S, max(lengths))[
            "chunks_read"])
    assert torch.equal(got, again)
    assert got.dtype == tdt and got.shape == (B, Hkv, G, D)
    jq, jk, jv = (_jnp(x, jdt) for x in (q, k, v))
    pallas = r_gqa_decode(jq.reshape(B, 1, Hkv * G, D), jk, jv,
                          jnp.asarray(length), block_s=256
                          ).reshape(B, Hkv, G, D)
    scale = fd_ref.flash_decode_ref(tq.float(), tk.float(), tv.float().abs(),
                                    tl).numpy()
    for want in (fd_ref.flash_decode_ref(tq, tk, tv, tl).float().numpy(),
                 np.asarray(pallas.astype(jnp.float32))):
        tol = F32_TOL * scale
        if dtype == "bfloat16":
            tol = tol + _bf16_ulp(want)
        err = np.abs(got.float().numpy() - want)
        assert np.all(err <= tol), float((err / tol).max())
