"""The port's serving path (``repro_torch.models``, ``repro_torch.serve``,
on the CPU) against the reference's (``repro.models``, ``repro.serve``).

Inputs are made with numpy from a seed; weights cross by
``repro_torch.convert.transformer_params_from_numpy``.  At the smoke
config the weights are the reference's own init.  At the narrow config
(TinyLlama's GQA ratio 8 and head_dim 64 at d_model 256, 4 layers, bf16
weights) they are ``chip_smoke.transformer_numpy_params`` draws at the
true fan-in: with the reference's init rule (fan-in = ``shape[-2]``, the
head count for ``wq``/``wk``/``wv``) the softmax is nearly one-hot and an
ulp in layer 1 flips tokens a few layers up, so logits there compare
nothing but chaos.

Tolerances: layers on float32 inputs within 2e-6 (both compute in float32,
in another order); on bf16 inputs 2 bf16 ulps at the output's scale.
Model logits (bf16 activations through every layer, rounded at other
places by XLA and PyTorch; measured 0.4-1.5% relative L2): relative L2 at
most 3e-2 and max |delta| at most 0.15 on logits of magnitude about 4, at
every prefill and teacher-forced decode step.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.pytree import count_params as r_count_params
from repro.common.pytree import tree_bytes as r_tree_bytes
from repro.configs import get_config as r_get_config
from repro.configs import smoke_config as r_smoke_config
from repro.models import layers as RL
from repro.models.model_api import Model as RModel
from repro.serve.engine import Request as RRequest
from repro.serve.engine import ServeEngine as RServeEngine
from repro_torch import configs, convert
from repro_torch.common.pytree import count_params, tree_bytes
from repro_torch.configs.base import ModelConfig
from repro_torch.models import Model
from repro_torch.models import layers as PL
from repro_torch.serve import Request, ServeEngine

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (numpy only at import: the shared weights)

LOGIT_REL_L2, LOGIT_ATOL = 3e-2, 0.15
NARROW = dict(n_layers=4, d_model=256, n_heads=16, n_kv_heads=2, head_dim=64,
              d_ff=688, vocab=1000, param_dtype="bfloat16")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small ops: one intra-op thread is faster, and does not fight the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(r_cfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(r_cfg, f.name)
                          for f in dataclasses.fields(r_cfg)})


def _is_def(x):
    return hasattr(x, "init") and hasattr(x, "axes")


def _pair(name):
    """(reference model, its params, port model, port params)."""
    r_cfg = r_smoke_config("tinyllama-1.1b")
    if name == "smoke":
        r_model = RModel(r_cfg)
        params = r_model.init(jax.random.PRNGKey(3))
        tree = jax.tree.map(np.asarray, params)
    else:
        r_cfg = dataclasses.replace(r_cfg, **NARROW)
        r_model = RModel(r_cfg)
        shapes = jax.tree.map(lambda d: d.shape, r_model.param_defs(),
                              is_leaf=_is_def)
        bits = chip_smoke.transformer_numpy_params(shapes, 5, bf16=True)
        tree = jax.tree.map(lambda a: a.view(jnp.bfloat16), bits)
        params = jax.tree.map(jnp.asarray, tree)
    model = Model(_port_cfg(r_cfg), device="cpu")
    return r_model, params, model, convert.transformer_params_from_numpy(
        tree, device="cpu")


@pytest.fixture(scope="module", params=["smoke", "narrow"])
def pair(request):
    return _pair(request.param)


def _check_logits(want, got, what):
    want = np.asarray(want, np.float32)
    got = got.numpy()
    assert got.shape == want.shape, what
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= LOGIT_REL_L2, (what, rel)
    assert np.abs(got - want).max() <= LOGIT_ATOL, (what, np.abs(got - want).max())


# --------------------------------------------------------------------- layers

def _rand(shape, seed, dtype):
    x = np.random.default_rng(seed).standard_normal(shape, np.float32)
    return torch.from_numpy(x).to(getattr(torch, dtype)), \
        jnp.asarray(x).astype(getattr(jnp, dtype))


def _close(got, want, dtype, scale=None):
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    if dtype == "float32":
        tol = 2e-6 * (np.abs(want).max() if scale is None else scale)
    else:
        tol = 2 * np.spacing(np.float32(np.abs(want).max())) * 65536
    assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_and_rope(dtype):
    x, jx = _rand((2, 7, 3, 64), 0, dtype)
    s, js = _rand((64,), 1, "float32")
    _close(PL.rmsnorm_apply({"scale": s}, x),
           RL.rmsnorm_apply({"scale": js}, jx), dtype)
    b, jb = _rand((64,), 2, "float32")
    _close(PL.layernorm_apply({"scale": s, "bias": b}, x),
           RL.layernorm_apply({"scale": js, "bias": jb}, jx), dtype)
    pos = np.arange(7 * 2).reshape(2, 7) * 300          # angles up to 3,900
    _close(PL.apply_rope(x, torch.from_numpy(pos), 10_000.0),
           RL.apply_rope(jx, jnp.asarray(pos), 10_000.0), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,fn,causal", [
    (40, "dense", True), (40, "dense", False), (2048, "blockwise", True),
    (4096, "blockwise", True)])
def test_prefill_attention(S, fn, causal, dtype):
    """Dense below 1,024 tokens; blockwise above (at 2,048 the wedge split
    hands over to the scan over blocks, at 4,096 it splits once and merges
    a dense rectangle)."""
    q, jq = _rand((1, S, 4, 16), 3, dtype)
    k, jk = _rand((1, S, 2, 16), 4, dtype)
    v, jv = _rand((1, S, 2, 16), 5, dtype)
    if fn == "dense":
        got = PL.dense_attention(q, k, v, causal=causal)
        want = RL.dense_attention(jq, jk, jv, causal=causal)
    else:
        got = PL.blockwise_attention(q, k, v, causal=causal)
        want = jax.jit(lambda a, b, c: RL.blockwise_attention(
            a, b, c, causal=causal))(jq, jk, jv)
    assert got.dtype == q.dtype
    _close(got, want, dtype, scale=float(np.abs(v.float().numpy()).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention(dtype):
    q, jq = _rand((3, 1, 16, 64), 6, dtype)
    k, jk = _rand((3, 300, 2, 64), 7, dtype)
    v, jv = _rand((3, 300, 2, 64), 8, dtype)
    got = PL.decode_attention(q, k, v, length=217)
    want = RL.decode_attention(jq, jk, jv, length=217)
    _close(got, want, dtype, scale=float(np.abs(v.float().numpy()).max()))
    with pytest.raises(ValueError, match="outside"):
        PL.decode_attention(q, k, v, length=301)


# ---------------------------------------------------------------------- model

def test_param_tree_matches_reference(pair):
    r_model, params, model, pp = pair
    defs = model.param_defs()
    assert count_params(defs) == r_count_params(r_model.param_defs())
    assert tree_bytes(defs) == r_tree_bytes(r_model.param_defs())
    want = jax.tree.map(lambda a: a.shape, params)
    got = jax.tree.map(lambda t: tuple(t.shape), pp)
    assert got == want
    init = model.init(torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda t: (tuple(t.shape), t.dtype), init) == \
        jax.tree.map(lambda t: (tuple(t.shape), t.dtype), pp)


def test_prefill_and_decode_match_reference(pair):
    """Teacher-forced: both take the same tokens at every step."""
    r_model, params, model, pp = pair
    B, S, N = 2, 24, 6
    toks = np.random.default_rng(0).integers(0, model.cfg.vocab, (B, S + N),
                                             dtype=np.int32)
    r_logits, r_cache = jax.jit(lambda p, b: r_model.prefill(
        p, b, max_len=S + N + 2))(params, {"tokens": jnp.asarray(toks[:, :S])})
    logits, cache = model.prefill(pp, {"tokens": toks[:, :S]},
                                  max_len=S + N + 2)
    _check_logits(r_logits, logits, "prefill")
    assert cache["pos"] == S
    r_decode = jax.jit(r_model.decode_step)
    for t in range(S, S + N):
        r_logits, r_cache = r_decode(params, r_cache,
                                     jnp.asarray(toks[:, t:t + 1]))
        logits, cache = model.decode_step(pp, cache, toks[:, t:t + 1])
        _check_logits(r_logits, logits, f"decode at {t}")
    assert cache["pos"] == S + N


# the options of the ported layers that TinyLlama does not use
VARIANTS = {
    "geglu_qknorm_postnorm": dict(mlp_kind="geglu", qk_norm=True,
                                  post_norm=True),
    "gelu_layernorm_tied": dict(mlp_kind="gelu", norm_kind="layer",
                                tie_embeddings=True, embed_scale=True,
                                final_softcap=30.0),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_config_variants_match_reference(variant):
    r_cfg = dataclasses.replace(r_smoke_config("tinyllama-1.1b"),
                                **VARIANTS[variant])
    r_model = RModel(r_cfg)
    params = r_model.init(jax.random.PRNGKey(4))
    model = Model(_port_cfg(r_cfg), device="cpu")
    pp = convert.transformer_params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu")
    toks = np.random.default_rng(3).integers(0, r_cfg.vocab, (2, 18),
                                             dtype=np.int32)
    r_logits, r_cache = jax.jit(lambda p, b: r_model.prefill(
        p, b, max_len=24))(params, {"tokens": jnp.asarray(toks[:, :16])})
    logits, cache = model.prefill(pp, {"tokens": toks[:, :16]}, max_len=24)
    _check_logits(r_logits, logits, "prefill")
    r_decode = jax.jit(r_model.decode_step)
    for t in (16, 17):
        r_logits, r_cache = r_decode(params, r_cache,
                                     jnp.asarray(toks[:, t:t + 1]))
        logits, cache = model.decode_step(pp, cache, toks[:, t:t + 1])
        _check_logits(r_logits, logits, f"decode at {t}")


def test_long_prefill_matches_reference():
    """A 2,048-token prompt at the narrow config: the blockwise prefill
    through the model, then one decode step over its cache."""
    r_model, params, model, pp = _pair("narrow")
    S = 2048
    toks = np.random.default_rng(1).integers(0, model.cfg.vocab, (1, S + 1),
                                             dtype=np.int32)
    r_logits, r_cache = jax.jit(lambda p, b: r_model.prefill(
        p, b, max_len=S + 4))(params, {"tokens": jnp.asarray(toks[:, :S])})
    logits, cache = model.prefill(pp, {"tokens": toks[:, :S]}, max_len=S + 4)
    _check_logits(r_logits, logits, "prefill")
    r_logits, _ = jax.jit(r_model.decode_step)(params, r_cache,
                                               jnp.asarray(toks[:, S:]))
    logits, _ = model.decode_step(pp, cache, toks[:, S:])
    _check_logits(r_logits, logits, "decode")


def test_prefill_decode_consistency(pair):
    """decode_step after prefill(S) against prefill(S+1)'s last logits, as
    tests/test_models_smoke.py holds the reference (same bounds)."""
    _, _, model, pp = pair
    B, S = 2, 24
    toks = np.random.default_rng(2).integers(0, model.cfg.vocab, (B, S + 1),
                                             dtype=np.int32)
    _, cache = model.prefill(pp, {"tokens": toks[:, :S]}, max_len=S + 8)
    step, _ = model.decode_step(pp, cache, toks[:, S:])
    full, _ = model.prefill(pp, {"tokens": toks}, max_len=S + 9)
    a, b = step.numpy(), full.numpy()
    assert np.mean(np.abs(a - b)) < 0.05
    assert (np.argmax(a, -1) == np.argmax(b, -1)).mean() >= 0.5


# -------------------------------------------------------------------- serving

def test_serve_engine_matches_reference():
    """tests/test_system.py's case (smoke TinyLlama, reference init from
    PRNGKey(0), 6 requests of 12 tokens, 4 new each, 4 slots, max_len
    32): the same tokens, except after a step where the reference's top
    two logits lie within the logit tolerance of each other (a near-tie),
    which the test counts; a row that parts there is not compared after."""
    r_model = RModel(r_smoke_config("tinyllama-1.1b"))
    params = r_model.init(jax.random.PRNGKey(0))
    model = Model(_port_cfg(r_model.cfg), device="cpu")
    pp = convert.transformer_params_from_numpy(jax.tree.map(np.asarray, params),
                                               device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, r_model.cfg.vocab, 12, dtype=np.int32)
               for _ in range(6)]
    want = RServeEngine(r_model, params, batch_slots=4, max_len=32).run(
        [RRequest(i, p, 4) for i, p in enumerate(prompts)])
    eng = ServeEngine(model, pp, batch_slots=4, max_len=32)
    got = eng.run([Request(i, p, 4) for i, p in enumerate(prompts)])
    assert [r.rid for r in got] == [r.rid for r in want]
    assert [t["decode_steps"] for t in eng.timings] == [3, 3]
    # the reference's top-2 margins along its own tokens
    r_prefill = jax.jit(lambda p, b: r_model.prefill(p, b, max_len=32))
    r_decode = jax.jit(r_model.decode_step)
    margins = {}
    for g in range(0, 6, 4):
        rows = want[g:g + 4]
        toks = np.stack([r.tokens for r in rows])
        batch = np.stack([prompts[r.rid] for r in rows]
                         + [prompts[rows[-1].rid]] * (4 - len(rows)))
        logits, cache = r_prefill(params, {"tokens": jnp.asarray(batch)})
        for t in range(4):
            top2 = np.sort(np.asarray(logits), -1)[:, -2:]
            for i, r in enumerate(rows):
                margins[r.rid, t] = float(top2[i, 1] - top2[i, 0])
            if t < 3:
                nxt = np.concatenate([toks[:, t], toks[-1:, t].repeat(
                    4 - len(rows))])[:, None]
                logits, cache = r_decode(params, cache, jnp.asarray(nxt))
    near_ties = 0
    for a, b in zip(got, want):
        assert a.tokens.shape == b.tokens.shape == (4,)
        for t in range(4):
            if a.tokens[t] != b.tokens[t]:
                assert margins[b.rid, t] <= LOGIT_ATOL, (b.rid, t)
                near_ties += 1
                break
    print(f"near-ties: {near_ties} of {len(want)} rows")


def test_serve_driver_runs_on_cpu():
    from repro_torch.launch.serve import main
    out = main(["--smoke", "--device", "cpu", "--requests", "5",
                "--slots", "2"])
    assert out["engine"].decode_impl == "torch"
    assert len(out["results"]) == 5
    for r in out["results"]:
        assert r.tokens.shape == (8,) and r.latency_s > 0
        assert np.all((0 <= r.tokens) & (r.tokens < out["model"].cfg.vocab))


# ------------------------------------------------------ registry and dispatch

def test_registry_matches_reference():
    for get, r_get in ((configs.get_config, r_get_config),
                       (configs.smoke_config, r_smoke_config)):
        for arch in configs.ARCHS:
            got, want = get(arch), r_get(arch)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert configs.ARCHS == ("tinyllama-1.1b", "phi4-mini-3.8b",
                             "gemma2-9b", "gemma3-27b", "deepseek-v2-236b",
                             "deepseek-v3-671b", "zamba2-1.2b", "rwkv6-3b")
    m = configs.smoke_model("tinyllama-1.1b", device="cpu")
    assert isinstance(m, Model) and m.decode_impl == "torch"
    assert configs.smoke_model("dlrm", device="cpu").cfg.name == "dlrm"
    with pytest.raises(KeyError, match="ROADMAP"):
        configs.get_model("whisper-base", device="cpu")


# the encoder-decoder and VLM configs (ROADMAP.md item 9.5) raise; flash
# attention for training, on an MLA and on an RWKV-6 config, is ported
@pytest.mark.parametrize("arch", ["paligemma-3b", "deepseek-v2-236b",
                                  "rwkv6-3b", "whisper-base"])
def test_unported_configs_raise(arch):
    r_cfg = r_smoke_config(arch)
    if arch in ("deepseek-v2-236b", "rwkv6-3b"):
        r_cfg = dataclasses.replace(r_cfg, flash_attention=True)
        assert Model(_port_cfg(r_cfg), device="cpu").cfg.flash_attention
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(_port_cfg(r_cfg), device="cpu")


def test_cuda_decode_on_cpu_raises():
    with pytest.raises(ValueError, match="needs a CUDA device"):
        Model(configs.smoke_config("tinyllama-1.1b"), device="cpu",
              decode_impl="cuda")
    m = configs.smoke_model("tinyllama-1.1b", device="cpu")
    pp = m.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="needs a CUDA device"):
        ServeEngine(m, pp, decode_impl="cuda")
    _, cache = m.prefill(pp, {"tokens": np.zeros((1, 4), np.int32)},
                         max_len=8)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        m.decode_step(pp, cache, np.zeros((1, 1), np.int32), "cuda")
    with pytest.raises(ValueError, match="decode_impl"):
        m.decode_step(pp, cache, np.zeros((1, 1), np.int32), "pallas")


def test_models_are_built_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        configs.smoke_model("tinyllama-1.1b")


def test_bf16_leaves_cross_bit_for_bit():
    r_model = RModel(dataclasses.replace(r_smoke_config("tinyllama-1.1b"),
                                         param_dtype="bfloat16"))
    params = jax.tree.map(np.asarray, r_model.init(jax.random.PRNGKey(1)))
    pp = convert.transformer_params_from_numpy(params, device="cpu")
    for a, t in zip(jax.tree.leaves(params), jax.tree.leaves(
            jax.tree.map(lambda x: x, pp))):
        assert t.dtype == torch.bfloat16
        assert np.array_equal(a.view(np.int16), t.view(torch.int16).numpy())
    with pytest.raises(TypeError, match="expected bfloat16 or float32"):
        convert.transformer_params_from_numpy({"w": np.zeros(3, np.int8)},
                                              device="cpu")

