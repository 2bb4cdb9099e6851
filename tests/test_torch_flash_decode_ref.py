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
