"""The int8 KV cache (``kv_quant_int8``) of the port's serving path, on
the CPU, against the reference's (``repro.models.layers.quantize_kv``,
``decode_attention_quant``, ``Model`` with the int8 cache).

Inputs are numpy draws from a seed.  ``quantize_kv`` must give the
reference's int8 values and float32 scales bit for bit (max |x| / 127
floored at 1e-8, round half to even, clip to +-127).  Decode attention
over the int8 cache, and ``flash_decode``'s int8 plain version in the
kernel's (B, Hkv, G, D) layout, within rtol 1e-5, atol 1e-6 of
``decode_attention_quant`` (float32 inputs: the same sums in another
order).  The TinyLlama smoke model with the int8 cache: prefill and 8
teacher-forced decode steps within 1e-4 of the reference's largest logit,
activations in float32 (``tests/_serve_pairs.py``); with bf16 activations
at the serving rule of ``tests/test_torch_serve.py`` (rel. L2 3e-2).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _serve_pairs as sp
from repro.configs import smoke_config as r_smoke_config
from repro.models import layers as RL
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode import ref as fd_ref
from repro_torch.models import layers as PL


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [1e-12, 1.0, 300.0])
def test_quantize_kv_is_bit_equal(dtype, scale):
    x = _rand((2, 37, 4, 64), 0, scale)
    x[0, 0, 0] = 0.0                       # the 1e-8 floor
    x[1, 3, 2, :4] = [127.0, 0.5, -2.5, 1.5]   # ties of the rounding
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    rq, rs = RL.quantize_kv(jx)
    pq, ps = PL.quantize_kv(tx)
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(rq), pq.numpy())
    np.testing.assert_array_equal(np.asarray(rs), ps.numpy())


def _quant_case(B, S, Hkv, G, D, seed):
    q = _rand((B, 1, Hkv * G, D), seed)
    k = _rand((B, S, Hkv, D), seed + 1)
    v = _rand((B, S, Hkv, D), seed + 2)
    kq, ks = RL.quantize_kv(jnp.asarray(k))
    vq, vs = RL.quantize_kv(jnp.asarray(v))
    return q, *(np.array(a) for a in (kq, ks, vq, vs))


@pytest.mark.parametrize("length", [1, 17, 64])
@pytest.mark.parametrize("softcap", [None, 5.0])
def test_decode_attention_quant_matches_reference(length, softcap):
    q, kq, ks, vq, vs = _quant_case(2, 64, 2, 4, 32, length)
    want = RL.decode_attention_quant(jnp.asarray(q), jnp.asarray(kq),
                                     jnp.asarray(vq), jnp.asarray(ks),
                                     jnp.asarray(vs), length=length,
                                     softcap=softcap)
    got = PL.decode_attention_quant(*(torch.from_numpy(a) for a in
                                      (q, kq, vq, ks, vs)), length=length,
                                    softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("softcap", [None, 5.0])
def test_flash_decode_int8_plain_version_matches_reference(softcap):
    """``flash_decode`` on CPU tensors of an int8 cache (rows of different
    lengths) is ``ref.flash_decode_quant_ref``, held row by row against
    ``decode_attention_quant``."""
    B, S, Hkv, G, D = 3, 80, 2, 4, 64
    q, kq, ks, vq, vs = _quant_case(B, S, Hkv, G, D, 40)
    lengths = [1, 65, 80]
    got = fd_ops.gqa_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kq), torch.from_numpy(vq),
        torch.tensor(lengths, dtype=torch.int32), max_length=80,
        softcap=softcap, k_scale=torch.from_numpy(ks),
        v_scale=torch.from_numpy(vs))
    for b, n in enumerate(lengths):
        want = RL.decode_attention_quant(
            *(jnp.asarray(a[b:b + 1]) for a in (q, kq, vq, ks, vs)),
            length=n, softcap=softcap)
        np.testing.assert_allclose(got[b:b + 1].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def test_flash_decode_int8_checks():
    q, kq, ks, vq, vs = (torch.from_numpy(a) for a in
                         _quant_case(1, 16, 2, 2, 16, 3))
    q = q.reshape(1, 2, 2, 16)
    n = torch.tensor([16], dtype=torch.int32)
    with pytest.raises(TypeError, match="int8 cache"):
        fd_ops.flash_decode(q, kq, vq, n)                 # no scales
    with pytest.raises(TypeError, match="int8 cache"):
        fd_ops.flash_decode(q, kq.float(), vq.float(), n, k_scale=ks,
                            v_scale=vs)                   # scales, no int8
    with pytest.raises(ValueError, match="k_scale"):
        fd_ops.flash_decode(q, kq, vq, n, k_scale=ks[:, :8], v_scale=vs)
    plain = fd_ref.flash_decode_quant_ref(q, kq, vq, ks, vs, n)
    assert torch.equal(fd_ops.flash_decode(q, kq, vq, n, k_scale=ks,
                                           v_scale=vs), plain)


def _int8_cfg():
    return dataclasses.replace(r_smoke_config("tinyllama-1.1b"),
                               kv_quant_int8=True)


def test_cache_defs_match_reference():
    r_model, _, model, _ = sp.pair(_int8_cfg())
    want = r_model.init_cache(2, 40)["layers"]
    got = model.init_cache(2, 40)["layers"]
    for wg, gg in zip(want, got):
        assert set(wg) == set(gg)
        for lj in wg:
            assert set(wg[lj]) == {"k", "v", "k_s", "v_s"} == set(gg[lj])
            for name, leaf in wg[lj].items():
                assert tuple(gg[lj][name].shape) == leaf.shape
                assert str(gg[lj][name].dtype).split(".")[-1] == str(
                    leaf.dtype)


def test_smoke_model_matches_reference_float32():
    r_model, params, model, pp = sp.pair(_int8_cfg())
    sp.check_logits(sp.teacher_forced(r_model, params, model, pp, 16, 8),
                    1e-4)


def test_smoke_model_matches_reference_bf16():
    r_model, params, model, pp = sp.pair(_int8_cfg(), f32=False)
    for want, got in sp.teacher_forced(r_model, params, model, pp, 16, 8):
        assert np.linalg.norm(got - want) <= 3e-2 * np.linalg.norm(want)


def test_the_cache_is_written_in_place_as_int8():
    _, _, model, pp = sp.pair(_int8_cfg())
    toks = np.arange(20, dtype=np.int32).reshape(2, 10)
    _, cache = model.prefill(pp, {"tokens": toks[:, :8]}, max_len=12)
    layer = cache["layers"][0]["l0"]
    k_before = layer["k"]
    assert k_before.dtype == torch.int8 and layer["k_s"].dtype == torch.float32
    assert bool((layer["k_s"][:, :, 8:] == 0).all())
    _, cache = model.decode_step(pp, cache, toks[:, 8:9])
    assert cache["layers"][0]["l0"]["k"] is k_before
    assert bool((layer["k_s"][:, :, 8] > 0).all())
    assert int(layer["k"][:, :, 8].abs().amax()) == 127


def test_serve_engine_matches_reference():
    r_model, params, model, pp = sp.pair(_int8_cfg())
    want, got, eng = sp.engine_tokens(r_model, params, model, pp)
    assert eng.decode_impl == "torch"
    for a, b in zip(got, want):
        assert a.rid == b.rid
        np.testing.assert_array_equal(a.tokens, b.tokens)
