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


# ---------------------------------------------------------------------------
# the log-sum-exp pair: a cache split along the sequence, merged exactly
# ---------------------------------------------------------------------------

LSE_KINDS = ["bf16", "int8", "softcap"]
LSE_CASES = [(3, 256, 2, 4, 64, 2, (250, 100, 1)),
             (2, 384, 4, 2, 16, 4, (384, 95)),
             (1, 192, 1, 8, 256, 3, (100,))]


def _lse_inputs(kind, B, S, Hkv, G, D, seed):
    rng = np.random.default_rng(seed)
    q = _torch(rng.standard_normal((B, Hkv, G, D), np.float32),
               torch.bfloat16)
    k = rng.standard_normal((B, S, Hkv, D), np.float32)
    v = rng.standard_normal((B, S, Hkv, D), np.float32)
    extra = {"softcap": 5.0 if kind == "softcap" else None}
    if kind == "int8":
        from repro_torch.models.layers import quantize_kv
        kq, ks = quantize_kv(torch.from_numpy(k))
        vq, vs = quantize_kv(torch.from_numpy(v))
        return q, kq, vq, dict(extra, k_scale=ks, v_scale=vs)
    return q, _torch(k, torch.bfloat16), _torch(v, torch.bfloat16), extra


def _block(extra, lo, hi):
    return {n: (t[:, lo:hi] if isinstance(t, torch.Tensor) else t)
            for n, t in extra.items()}


def _merge(parts):
    """The exact merge of (out, lse) pairs, in float32."""
    lse = torch.stack([p[1] for p in parts])
    m = lse.amax(0)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lse - m)[..., None]
    o = torch.stack([p[0] for p in parts])
    return (w * o).sum(0) / w.sum(0)


@pytest.mark.parametrize("kind", LSE_KINDS)
@pytest.mark.parametrize("B,S,Hkv,G,D,n,lengths", LSE_CASES,
                         ids=[f"B{c[0]}S{c[1]}D{c[4]}n{c[5]}"
                              for c in LSE_CASES])
def test_lse_merge_of_split_blocks_equals_unsplit(kind, B, S, Hkv, G, D, n,
                                                  lengths):
    """Each block's (out, lse) from the CPU wrapper of the log-sum-exp
    instantiation (blocks past a row's length at local length 0: out 0,
    lse -inf), merged exactly, equals the unsplit plain result to float32
    rounding (``F32_TOL`` of the weighted |v|), and its lse the unsplit
    one's (1e-5)."""
    q, k, v, extra = _lse_inputs(kind, B, S, Hkv, G, D, S + n)
    length = torch.tensor(lengths, dtype=torch.int32)
    whole_o, whole_lse = fd_ops.flash_decode_lse(q, k, v, length, **extra)
    Sr = S // n
    parts = []
    for r in range(n):
        local = torch.clamp(length - r * Sr, 0, Sr).to(torch.int32)
        o, lse = fd_ops.flash_decode_lse(
            q, k[:, r * Sr:(r + 1) * Sr].contiguous(),
            v[:, r * Sr:(r + 1) * Sr].contiguous(), local,
            **_block(extra, r * Sr, (r + 1) * Sr))
        assert o.dtype == lse.dtype == torch.float32
        empty = local == 0
        assert torch.all(o[empty] == 0) and torch.all(
            torch.isneginf(lse[empty]))
        parts.append((o, lse))
    assert any(bool((torch.clamp(length - r * Sr, 0, Sr) == 0).any())
               for r in range(n))
    merged = _merge(parts)
    # the scale of the summed terms: the softmax-weighted |v|
    vmag = (v.float().abs() if kind != "int8" else
            v.float().abs() * extra["v_scale"][..., None])
    scale = torch.einsum("bhgs,bshd->bhgd", torch.softmax(torch.where(
        torch.arange(S)[None, None, None] < length[:, None, None, None],
        torch.zeros(B, Hkv, G, S), -1e30), -1), vmag)
    assert torch.all((merged - whole_o).abs() <= F32_TOL * (scale + 1)), (
        float((merged - whole_o).abs().max()))
    m = torch.stack([p[1] for p in parts]).amax(0)
    got_lse = m + torch.log(torch.stack([torch.exp(p[1] - m)
                                         for p in parts]).sum(0))
    torch.testing.assert_close(got_lse, whole_lse, rtol=1e-5, atol=1e-5)
    # the pair's output, cast, is the plain flash_decode's
    want = (fd_ref.flash_decode_quant_ref(q, k, v, extra["k_scale"],
                                          extra["v_scale"], length,
                                          extra["softcap"])
            if kind == "int8" else
            fd_ref.flash_decode_ref(q, k, v, length, extra["softcap"]))
    torch.testing.assert_close(whole_o.to(torch.bfloat16), want, rtol=0,
                               atol=float(_bf16_ulp(np.float32(
                                   whole_o.abs().max())))
                               + F32_TOL)


@pytest.mark.parametrize("kind", LSE_KINDS)
def test_lse_pair_matches_the_layers_plain_version(kind):
    """The wrapper's pair in the model's (B, 1, Hq, D) layout
    (``gqa_decode_attention_lse``, which ``transformer._split_decode``
    calls), cast to bf16, equals the unsplit layer's plain decode
    (``layers.decode_attention``, ``decode_attention_quant`` over the
    int8 cache) within one bf16 ulp plus ``F32_TOL``, and its lse the
    log-sum-exp of the layer's scaled (softcapped) scores (1e-5); a block
    at length 0 gives 0 and -inf.  ``ref.gqa_decode_lse_ref`` (the path
    of ``decode_impl="torch"``, reading the first n positions) gives the
    same pair."""
    from repro_torch.models import layers as L
    B, S, Hkv, G, D = 2, 96, 2, 4, 64
    q, k, v, extra = _lse_inputs(kind, B, S, Hkv, G, D, 3)
    qh = q.reshape(B, 1, Hkv * G, D)
    cap = extra["softcap"]
    for n in (0, 1, 70, S):
        o, lse = fd_ops.gqa_decode_attention_lse(
            qh, k, v, torch.full((B,), n, dtype=torch.int32), **extra)
        assert o.shape == (B, 1, Hkv * G, D) and lse.shape == (B, 1, Hkv * G)
        assert o.dtype == lse.dtype == torch.float32
        o2, lse2 = fd_ref.gqa_decode_lse_ref(
            qh, k, v, n, cap, **{s: extra[s] for s in ("k_scale", "v_scale")
                                  if s in extra})
        torch.testing.assert_close(o2, o, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(lse2, lse, rtol=1e-5, atol=1e-5)
        if n == 0:
            assert torch.all(o == 0) and torch.all(torch.isneginf(lse))
            continue
        if kind == "int8":
            want = L.decode_attention_quant(
                qh, k, v, extra["k_scale"], extra["v_scale"], length=n,
                softcap=cap)
            s = torch.einsum("bhgd,bkhd->bhgk", q.float(), k[:, :n].float())
            s = s * torch.movedim(extra["k_scale"][:, :n], 2, 1)[:, :, None]
        else:
            want = L.decode_attention(qh, k, v, length=n, softcap=cap)
            s = torch.einsum("bhgd,bkhd->bhgk", q.float(), k[:, :n].float())
        s = L._softcap(s / D ** 0.5, cap)
        torch.testing.assert_close(
            o.to(torch.bfloat16), want, rtol=0,
            atol=float(_bf16_ulp(np.float32(o.abs().max()))) + F32_TOL)
        torch.testing.assert_close(
            lse, torch.logsumexp(s, -1).reshape(B, 1, Hkv * G), rtol=1e-5,
            atol=1e-5)


def test_lse_wrapper_takes_length_zero_and_checks_the_rest():
    q, k, v, _ = _lse_inputs("bf16", 1, 32, 1, 2, 16, 0)
    o, lse = fd_ops.flash_decode_lse(q, k, v,
                                     torch.zeros(1, dtype=torch.int32),
                                     max_length=0)
    assert torch.all(o == 0) and torch.all(torch.isneginf(lse))
    with pytest.raises(ValueError):
        fd_ops.flash_decode_lse(q, k, v, torch.tensor([33], dtype=torch.int32))
    with pytest.raises(ValueError):
        fd_ops.flash_decode_lse(q, k, v, torch.tensor([-1], dtype=torch.int32))
