"""Sliding-window and softcapped serving in the port (``repro_torch.
models``: ``dense_attention(window=)``, ``local_attention``,
``decode_attention(window=, softcap=)``, the ring cache's ``_ring_fill``
and ``_ring_decode``; ``repro_torch.kernels.flash_decode`` with a
softcap; the Gemma-2, Gemma-3 and Phi-4-mini configs) against the
reference, on the CPU.

Inputs and weights (``chip_smoke.transformer_numpy_params``, at the true
fan-in) are made with numpy from a seed; weights cross by
``repro_torch.convert.transformer_params_from_numpy``, post-norms,
qk-norm, GeGLU and tied embeddings included.  Tolerances are
``tests/test_torch_serve.py``'s: layers on float32 inputs within 2e-6 of
the output's scale, on bf16 inputs 2 bf16 ulps; model logits within
relative L2 3e-2 and 0.15 absolute (``_check_logits``), at the prefill
and at every teacher-forced decode step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as r_smoke_config
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.models.model_api import Model as RModel
from repro_torch import configs, convert
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode import ref as fd_ref
from repro_torch.models import Model
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from repro_torch.serve import Request, ServeEngine
from test_torch_serve import (LOGIT_REL_L2, _check_logits, _close,
                              _port_cfg, _rand, chip_smoke)

ARCHS = ("gemma2-9b", "gemma3-27b", "phi4-mini-3.8b")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(B, S, Hq, Hkv, D, dtype, seed):
    q, jq = _rand((B, S, Hq, D), seed, dtype)
    k, jk = _rand((B, S, Hkv, D), seed + 1, dtype)
    v, jv = _rand((B, S, Hkv, D), seed + 2, dtype)
    return (q, k, v), (jq, jk, jv)


def _vscale(v):
    return float(np.abs(v.float().numpy()).max())


# --------------------------------------------------------------------- layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window, softcap", [(8, None), (8, 50.0),
                                             (1, None), (40, 2.0)])
def test_dense_attention_window(window, softcap, dtype):
    (q, k, v), (jq, jk, jv) = _qkv(2, 40, 4, 2, 16, dtype, 10)
    got = PL.dense_attention(q, k, v, causal=True, window=window,
                             softcap=softcap)
    want = RL.dense_attention(jq, jk, jv, causal=True, window=window,
                              softcap=softcap)
    _close(got, want, dtype, scale=_vscale(v))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S, W, softcap", [(64, 16, None), (70, 16, 50.0),
                                           (33, 32, None), (20, 32, 30.0),
                                           (96, 32, None)])
def test_local_attention(S, W, softcap, dtype):
    """Past the window (padded to whole chunks, 2-6 chunks), at one chunk
    and a position over, and below it (the dense path with the window)."""
    (q, k, v), (jq, jk, jv) = _qkv(2, S, 6, 2, 16, dtype, 20)
    got = PL.local_attention(q, k, v, window=W, softcap=softcap)
    want = jax.jit(lambda a, b, c: RL.local_attention(
        a, b, c, window=W, softcap=softcap))(jq, jk, jv)
    assert got.shape == q.shape and got.dtype == q.dtype
    _close(got, want, dtype, scale=_vscale(v))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length, window, softcap", [
    (217, None, 50.0), (217, 64, None), (217, 64, 30.0), (40, 64, None),
    (300, 1, None)])
def test_decode_attention_window_softcap(length, window, softcap, dtype):
    q, jq = _rand((3, 1, 16, 64), 6, dtype)
    k, jk = _rand((3, 300, 2, 64), 7, dtype)
    v, jv = _rand((3, 300, 2, 64), 8, dtype)
    got = PL.decode_attention(q, k, v, length=length, window=window,
                              softcap=softcap)
    want = RL.decode_attention(jq, jk, jv, length=length, window=window,
                               softcap=softcap)
    _close(got, want, dtype, scale=_vscale(v))


# ------------------------------------------------------------- the ring cache

@pytest.mark.parametrize("S, Wr", [(5, 8), (8, 8), (13, 8), (40, 8)])
def test_ring_fill_matches_reference(S, Wr):
    """The last ``Wr`` positions in ring order (slot = position % Wr),
    bit for bit, whatever the prompt's length."""
    _, k, v = (_rand((2, S, 2, 16), s, "bfloat16")[0] for s in (0, 1, 2))
    jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
              for t in (k, v))
    cache = {n: torch.zeros((2, Wr, 2, 16), dtype=torch.bfloat16)
             for n in ("k", "v")}
    rcache = {n: jnp.zeros((2, Wr, 2, 16), jnp.bfloat16) for n in ("k", "v")}
    PT._ring_fill(cache, k, v, S, Wr)
    kc, vc = RT._ring_fill(rcache, jk, jv, S, Wr)
    for got, want in ((cache["k"], kc), (cache["v"], vc)):
        assert np.array_equal(got.float().numpy(),
                              np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("pos, Wr, softcap", [(3, 8, None), (7, 8, 50.0),
                                              (8, 8, None), (21, 8, 30.0),
                                              (100, 16, 50.0)])
def test_ring_decode_matches_reference(pos, Wr, softcap):
    """Before the ring fills, as it fills, and after it wrapped."""
    q, jq = _rand((2, 1, 4, 32), pos, "bfloat16")
    kc, jkc = _rand((2, Wr, 2, 32), pos + 1, "bfloat16")
    vc, jvc = _rand((2, Wr, 2, 32), pos + 2, "bfloat16")
    got = PT._ring_decode(q, kc, vc, pos, Wr, softcap)
    want = RT._ring_decode(jq, jkc, jvc, jnp.int32(pos), Wr, softcap)
    _close(got, want, "bfloat16", scale=_vscale(vc))


@pytest.mark.parametrize("pos, Wr, softcap", [(5, 16, 50.0), (15, 16, None),
                                              (40, 16, 50.0), (70, 64, 30.0)])
def test_flash_decode_plain_version_over_a_ring(pos, Wr, softcap):
    """The kernel's plain version (what ``decode_impl="cuda"`` runs on the
    card) over the ring at length = max_length = min(pos + 1, Wr), against
    the reference's ``_ring_decode`` in float32; and the same through
    ``gqa_decode_attention`` and the kernel's chunk-and-merge model."""
    B, Hkv, G, D = 3, 2, 3, 32
    q, jq = _rand((B, 1, Hkv * G, D), pos, "float32")
    kc, jkc = _rand((B, Wr, Hkv, D), pos + 1, "float32")
    vc, jvc = _rand((B, Wr, Hkv, D), pos + 2, "float32")
    n = min(pos + 1, Wr)
    length = torch.full((B,), n, dtype=torch.int32)
    want = np.asarray(RT._ring_decode(jq, jkc, jvc, jnp.int32(pos), Wr,
                                      softcap))
    got = fd_ops.gqa_decode_attention(q, kc, vc, length, max_length=n,
                                      softcap=softcap)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-6 * _vscale(vc))
    q4 = q.reshape(B, Hkv, G, D)
    plan = fd_ops.split_plan(length.tolist(), Wr, n)
    model = fd_ref.flash_decode_chunked_ref(q4, kc, vc, length,
                                            fd_ops.CHUNK,
                                            plan["chunks_read"], softcap)
    np.testing.assert_allclose(model.reshape(B, 1, Hkv * G, D).numpy(),
                               want, rtol=0, atol=2e-6 * _vscale(vc))


def test_flash_decode_softcap_checks():
    """A softcap is a positive finite float or None (0 is the C entry
    point's "none", never the caller's)."""
    q = torch.zeros((1, 1, 2, 8))
    k = torch.zeros((1, 4, 1, 8))
    length = torch.full((1,), 4, dtype=torch.int32)
    for bad in (0.0, -1.0, float("inf"), float("nan")):
        with pytest.raises(ValueError, match="softcap"):
            fd_ops.flash_decode(q, k, k, length, softcap=bad)
    args = fd_ops.kernel_args(q, k, k, length, q, 1, None, None)
    assert args[12] == 0.0 and len(args) == len(fd_ops._SIGNATURE) - 1
    assert fd_ops.kernel_args(q, k, k, length, q, 1, None, None,
                              50.0)[12] == 50.0


# ---------------------------------------------------------------------- models

def _pair(arch, seed=0, **over):
    """The smoke config's reference model and port model, both on
    float32 ``chip_smoke.transformer_numpy_params`` draws at the true
    fan-in (with the reference's init, the head count as the fan-in of
    ``wq``/``wk``/``wv``, these configs' attention is nearly one-hot and
    a bf16 ulp in layer 1 moves the logits by several percent: 4-16%
    measured on Gemma-2's)."""
    r_cfg = dataclasses.replace(r_smoke_config(arch), **over)
    r_model = RModel(r_cfg)
    shapes = jax.tree.map(lambda d: d.shape, r_model.param_defs(),
                          is_leaf=lambda x: hasattr(x, "init"))
    tree = chip_smoke.transformer_numpy_params(shapes, seed, bf16=False)
    params = jax.tree.map(jnp.asarray, tree)
    model = Model(_port_cfg(r_cfg), device="cpu")
    pp = convert.transformer_params_from_numpy(tree, device="cpu")
    return r_model, params, model, pp


def test_configs_build_and_cache_shapes_match_reference():
    """Every sub-layer kind of the three configs is ported; the caches are
    the reference's: global layers of max_len, local rings of
    min(window, max_len)."""
    for arch in ARCHS:
        cfg = configs.smoke_config(arch)
        PT.check_supported(cfg)
        model = Model(cfg, device="cpu")
        r_model = RModel(r_smoke_config(arch))
        for max_len in (16, 48):
            got = model.cache_defs(2, max_len)["layers"]
            want = r_model.cache_defs(2, max_len)["layers"]
            assert jax.tree.map(lambda d: tuple(d.shape), want,
                                is_leaf=lambda x: hasattr(x, "init")) == \
                PT.tree_map(lambda d: tuple(d.shape), got)
        cache = model.init_cache(2, 48)
        kinds = [k for g in model.groups for k in g.kinds]
        assert ("gqa_l", "mlp") in kinds or arch.startswith("phi4")
    assert configs.get_config("gemma2-9b").logit_softcap == 50.0
    assert cache["pos"] == 0


# (arch, prompt, decode steps): the smoke window is 32.  A prompt past it
# takes local_attention and fills the ring wrapped; a shorter one fills it
# in order and the decode wraps it
MODEL_CASES = [("gemma2-9b", 40, 6), ("gemma2-9b", 24, 12),
               ("gemma3-27b", 40, 6), ("gemma3-27b", 26, 10),
               ("phi4-mini-3.8b", 24, 6)]


@pytest.mark.parametrize("arch, S, N", MODEL_CASES)
def test_prefill_and_decode_past_the_window_match_reference(arch, S, N):
    """Teacher-forced: both take the same tokens at every step."""
    r_model, params, model, pp = _pair(arch)
    B = 2
    toks = np.random.default_rng(S).integers(0, model.cfg.vocab, (B, S + N),
                                             dtype=np.int32)
    max_len = S + N + 2
    r_logits, r_cache = jax.jit(lambda p, b: r_model.prefill(
        p, b, max_len=max_len))(params, {"tokens": jnp.asarray(toks[:, :S])})
    logits, cache = model.prefill(pp, {"tokens": toks[:, :S]},
                                  max_len=max_len)
    _check_logits(r_logits, logits, "prefill")
    r_decode = jax.jit(r_model.decode_step)
    for t in range(S, S + N):
        r_logits, r_cache = r_decode(params, r_cache,
                                     jnp.asarray(toks[:, t:t + 1]))
        logits, cache = model.decode_step(pp, cache, toks[:, t:t + 1])
        _check_logits(r_logits, logits, f"decode at {t}")
    # every cache holds the reference's keys slot for slot (bf16 keys of
    # activations rounded at other places: the logits' relative L2, 3e-2;
    # measured up to 1.05e-2; a slot out of order would give about 1.4)
    for gi, g in enumerate(model.groups):
        for j, kind in enumerate(g.kinds):
            for n in ("k", "v"):
                got = cache["layers"][gi][f"l{j}"][n].float().numpy()
                want = np.asarray(r_cache["layers"][gi][f"l{j}"][n].astype(
                    jnp.float32))
                assert got.shape == want.shape, (kind, got.shape)
                rel = np.linalg.norm(got - want) / np.linalg.norm(want)
                assert rel <= LOGIT_REL_L2, (kind, n, rel)


def test_serve_engine_serves_gemma2_past_the_window():
    """``ServeEngine`` on the smoke Gemma-2 with the torch decode path:
    prompts of 28 tokens, 12 new each, so every row's decode wraps the
    32-slot ring; the tokens equal the model's own greedy steps."""
    _, _, model, pp = _pair("gemma2-9b", seed=1)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, model.cfg.vocab, 28, dtype=np.int32)
               for _ in range(3)]
    eng = ServeEngine(model, pp, batch_slots=2, max_len=48)
    res = eng.run([Request(i, p, 12) for i, p in enumerate(prompts)])
    assert [t["decode_steps"] for t in eng.timings] == [11, 11]
    batch = np.stack(prompts[:2])
    logits, cache = model.prefill(pp, {"tokens": batch}, max_len=48)
    want = [logits.argmax(-1)]
    for _ in range(11):
        logits, cache = model.decode_step(pp, cache, want[-1][:, None].numpy())
        want.append(logits.argmax(-1))
    want = torch.stack(want, 1).numpy()
    for i in range(2):
        assert np.array_equal(res[i].tokens, want[i])


@pytest.mark.parametrize("local, pos", [(True, 10), (True, 31), (True, 45),
                                        (False, 45)])
def test_kernel_branch_of_the_decode_matches_the_torch_branch(local, pos):
    """The ``decode_impl="cuda"`` branch of a layer's decode, on CPU
    tensors (the wrapper's plain version in the kernel's place): the ring
    at length = max_length = min(pos + 1, slots), or the global cache at
    pos + 1, with Gemma-2's softcap; the same output as the torch branch
    (float32 p.v there against bf16 p.v here: 2 bf16 ulps), and the same
    cache writes."""
    cfg = dataclasses.replace(configs.smoke_config("gemma2-9b"),
                              param_dtype="bfloat16")
    model = Model(cfg, device="cpu")
    p = model.init(torch.Generator().manual_seed(2))["groups"][0]["l0"]
    p = PT.tree_map(lambda t: t[0], p)["attn"]
    kind = ("gqa_l" if local else "gqa_g", "mlp")
    x, _ = _rand((2, 1, cfg.d_model), pos, "bfloat16")
    outs, caches = [], []
    for impl in ("cuda", "torch"):
        cache = PT.tree_map(lambda t: t[0], model.init_cache(2, 48)[
            "layers"][0]["l0" if local else "l1"])
        g = torch.Generator().manual_seed(9)
        for n in ("k", "v"):
            cache[n].copy_(torch.randn(cache[n].shape, generator=g))
        step = PT.DecodeStep(pos, impl, 2, torch.device("cpu"))
        o, cache = PT._gqa_attend(cfg, p, x, local=local,
                                  positions=torch.full((2, 1), pos),
                                  mode="decode", cache=cache,
                                  softcap=cfg.logit_softcap,
                                  theta=cfg.rope_theta, decode=step)
        outs.append(o)
        caches.append(cache)
        if impl == "cuda":
            n = min(pos + 1, 32) if local else pos + 1
            assert list(step._lengths) == [n]
    assert kind in PT.SUPPORTED_KINDS
    for n in ("k", "v"):
        assert torch.equal(caches[0][n], caches[1][n])
    want = outs[1].float().numpy()
    tol = 2 * np.spacing(np.float32(np.abs(want).max())) * 65536
    assert np.abs(outs[0].float().numpy() - want).max() <= tol
