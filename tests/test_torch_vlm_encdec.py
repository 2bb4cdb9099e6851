"""The VLM (PaliGemma-3B) and encoder-decoder (Whisper-base) families in
the port (``repro_torch.models``: ``sinusoidal_at``/``sinusoidal_pos``,
the prefix-LM mask of ``dense_attention`` and ``blockwise_attention``,
the ``enc_attn`` and ``dec_attn`` mixers, ``Model.encode``, ``loss``,
``prefill``, ``decode_step``; ``ServeEngine``; the train step) against the
reference, on the CPU.

Inputs, image embeddings, frames and weights (``chip_smoke.
transformer_numpy_params``, at the true fan-in) are made with numpy from a
seed and fed to both packages; models run float32 activations
(``tests/_serve_pairs.py``).  Tolerances: float32 outputs within 1e-5 of
the output's largest magnitude where it is above 1 (absolute 1e-5 below);
bf16 attention within 2 bf16 ulps (``test_torch_serve._close``); logits
within 1e-4 of the largest, losses rtol 1e-5, gradients 1e-4 of each
leaf's largest (``test_torch_train``'s).

Two facts of the reference are pinned: Whisper's decoder is
``build_groups``' causal stack, which never reads the encoder (its loss
does not depend on the frames, and the encoder's gradient is exactly 0 in
both packages), and the serving budget leaves a VLM's image prefix out
(the reference clamps decode writes past its cache onto the last slot;
the port raises).
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.pytree import flatten_with_paths as ref_flatten
from repro.common.pytree import materialize as r_materialize
from repro.configs import smoke_config as r_smoke_config
from repro.configs.base import TrainConfig as RTrainConfig
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.serve.engine import Request as RRequest
from repro.serve.engine import ServeEngine as RServeEngine
from repro.train import optimizer as ref_opt
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch import configs, convert
from repro_torch.common.pytree import flatten_with_paths, materialize
from repro_torch.configs.base import TrainConfig
from repro_torch.data import lm_batch
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_grad_fn, make_train_step

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _serve_pairs as sp  # noqa: E402
from test_torch_serve import _close, _rand  # noqa: E402

ARCHS = ("paligemma-3b", "whisper-base")
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _near(got, want, atol=ATOL):
    """Within ``atol`` of the output's largest magnitude above 1."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape
    tol = atol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


def _extras(cfg, B: int, S: int, seed: int = 11) -> dict:
    """Seeded numpy image embeddings (VLM) or frames (encoder-decoder)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.vlm_prefix_len:
        out["img"] = rng.standard_normal((B, cfg.vlm_prefix_len, cfg.d_model),
                                         np.float32)
    if cfg.enc_dec:
        out["frames"] = rng.standard_normal((B, S, cfg.d_model), np.float32)
    return out


def _jnp(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


# --------------------------------------------------------------------- layers

@pytest.mark.parametrize("seq, dim, offset", [(24, 64, 0), (1500, 512, 0),
                                              (7, 16, 1493), (3, 2048, 40000)])
def test_sinusoidal_matches_reference(seq, dim, offset):
    _near(PL.sinusoidal_pos(seq, dim, offset),
          RL.sinusoidal_pos(seq, dim, offset))
    for pos in (0, offset + seq - 1):
        _near(PL.sinusoidal_at(pos, dim),
              RL.sinusoidal_at(jnp.asarray(pos, jnp.int32), dim))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S, prefix", [(24, 8), (40, 1), (40, 39), (33, 0)])
def test_dense_attention_prefix(S, prefix, dtype):
    q, jq = _rand((2, S, 4, 16), 30, dtype)
    k, jk = _rand((2, S, 1, 16), 31, dtype)
    v, jv = _rand((2, S, 1, 16), 32, dtype)
    got = PL.dense_attention(q, k, v, causal=True, prefix_len=prefix)
    want = RL.dense_attention(jq, jk, jv, causal=True, prefix_len=prefix)
    _close(got, want, dtype)


@pytest.mark.parametrize("S, prefix, causal, block", [
    (1152, 300, True, 64),     # the prefix spans kv blocks 1-4 past q block 0
    (1152, 1100, True, 64),    # nearly all of it: the last kv block is not
    (1152, 64, True, 64),      # a whole block
    (1152, 0, True, 64),       # no prefix: the wedge split
    (1500, 0, False, 500)])    # Whisper's encoder at 1,500 frames
def test_blockwise_attention_prefix(S, prefix, causal, block):
    """Past 1,024 positions, in float32; also against the dense path: the
    port's block skip must keep kv blocks that hold prefix keys, and the
    wedge split is taken only without a prefix."""
    q, jq = _rand((1, S, 2, 16), 40, "float32")
    k, jk = _rand((1, S, 1, 16), 41, "float32")
    v, jv = _rand((1, S, 1, 16), 42, "float32")
    got = PL.blockwise_attention(q, k, v, causal=causal, prefix_len=prefix,
                                 block_q=block, block_k=block)
    want = jax.jit(lambda a, b, c: RL.blockwise_attention(
        a, b, c, causal=causal, prefix_len=prefix, block_q=block,
        block_k=block))(jq, jk, jv)
    _near(got, want)
    _near(got, PL.dense_attention(q, k, v, causal=causal, prefix_len=prefix))


# --------------------------------------------------------------------- mixers

def _layer(arch, kind, seed=3, **over):
    """(reference cfg, port cfg, reference layer params, port's) of one
    ``kind`` layer of ``arch``'s smoke config."""
    r_cfg = dataclasses.replace(r_smoke_config(arch), **over)
    shapes = jax.tree.map(lambda d: d.shape, RT.layer_defs(r_cfg, kind),
                          is_leaf=sp._is_def)
    tree = sp.chip_smoke.transformer_numpy_params(shapes, seed, bf16=False)
    return (r_cfg, sp.port_cfg(r_cfg), jax.tree.map(jnp.asarray, tree),
            convert.transformer_params_from_numpy(tree, device="cpu"))


@pytest.mark.parametrize("S, block", [(24, 512), (1152, 64)])
def test_enc_attn_matches_reference(S, block):
    """Bidirectional, no positions in the projections: dense up to 1,024
    positions, blockwise above."""
    kind = ("enc_attn", "mlp")
    r_cfg, cfg, rp, pp = _layer("whisper-base", kind, block_q=block,
                                block_k=block)
    x = np.random.default_rng(1).standard_normal((2, S, cfg.d_model),
                                                 np.float32)
    pos = np.tile(np.arange(S)[None], (2, 1))
    want, _ = RT._apply_layer(r_cfg, kind, rp, jnp.asarray(x), mesh=None,
                              positions=jnp.asarray(pos), mode="train",
                              cache=None, prefix_len=0)
    got, cache = PT._apply_layer(cfg, kind, pp, torch.from_numpy(x),
                                 positions=torch.from_numpy(pos),
                                 mode="train", cache=None)
    assert cache is None and PT._cache_defs_for(cfg, kind, 2, S) is None
    _near(got, want)


def test_dec_attn_matches_reference():
    """Causal self-attention then cross-attention over the encoder's
    output: train; prefill (the KV cache and the cross cache ``xk``/``xv``
    filled from ``enc_out``); three decode steps (the cross-attention
    from the cache)."""
    kind = ("dec_attn", "mlp")
    r_cfg, cfg, rp, pp = _layer("whisper-base", kind)
    B, S, N, max_len = 2, 10, 3, 16
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S + N, cfg.d_model), np.float32)
    enc = rng.standard_normal((B, cfg.enc_len, cfg.d_model), np.float32)
    pos = np.tile(np.arange(S)[None], (B, 1))
    for mode in ("train", "prefill"):
        rc = (None if mode == "train" else r_materialize(
            RT._cache_defs_for(r_cfg, kind, B, max_len),
            jax.random.PRNGKey(0)))
        c = (None if mode == "train" else materialize(
            PT._cache_defs_for(cfg, kind, B, max_len), None, "cpu"))
        want, rc = RT._apply_layer(r_cfg, kind, rp, jnp.asarray(x[:, :S]),
                                   mesh=None, positions=jnp.asarray(pos),
                                   mode=mode, cache=rc, prefix_len=0,
                                   enc_out=jnp.asarray(enc))
        got, c = PT._apply_layer(cfg, kind, pp, torch.from_numpy(x[:, :S]),
                                 positions=torch.from_numpy(pos), mode=mode,
                                 cache=c, enc_out=torch.from_numpy(enc))
        _near(got, want)
    assert sorted(c) == sorted(rc) == ["k", "v", "xk", "xv"]
    for name in c:
        _near(c[name].float(), np.asarray(rc[name], np.float32))
    for t in range(S, S + N):
        p1 = np.full((B, 1), t)
        want, rc = RT._apply_layer(r_cfg, kind, rp, jnp.asarray(x[:, t:t + 1]),
                                   mesh=None, positions=jnp.asarray(p1),
                                   mode="decode", cache=rc, prefix_len=0)
        got, c = PT._apply_layer(cfg, kind, pp, torch.from_numpy(
            x[:, t:t + 1]), positions=torch.from_numpy(p1), mode="decode",
            cache=c, decode=PT.DecodeStep(t, "torch", B, None))
        _near(got, want)
    with pytest.raises(ValueError, match="cross cache"):
        PT._apply_layer(cfg, kind, pp, torch.from_numpy(x[:, :S]),
                        positions=torch.from_numpy(pos), mode="prefill",
                        cache=c, enc_out=torch.from_numpy(enc[:, :5]))


# ---------------------------------------------------------------------- model

@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    return sp.pair(r_smoke_config(request.param), seed=4)


def test_trees_match_reference(fam):
    r_model, params, model, pp = fam
    assert sp.signature(pp) == sp.signature(params)
    assert sp.signature(model.init_cache(2, 20)["layers"]) == sp.signature(
        r_model.init_cache(2, 20)["layers"])
    back = convert.tree_to_numpy(pp)
    for (n, a), (n2, b) in zip(ref_flatten(params), ref_flatten(back)):
        assert n == n2
        np.testing.assert_array_equal(np.asarray(a), b)
    if model.cfg.enc_dec:
        assert len(pp["enc_groups"]) == 1 and "enc_norm" in pp


@pytest.mark.parametrize("T, block", [(24, 512), (1500, 500)])
def test_encode_matches_reference(T, block):
    """The encoder's output at the smoke width, at 24 frames (dense) and
    at Whisper's 1,500 (blockwise, in tiles of 500: the default 512 does
    not divide 1,500)."""
    r_cfg = dataclasses.replace(r_smoke_config("whisper-base"),
                                block_q=block, block_k=block)
    r_model, params, model, pp = sp.pair(r_cfg, seed=6)
    frames = _extras(model.cfg, 2, T)["frames"]
    want = jax.jit(r_model._encode)(params, jnp.asarray(frames))
    _near(model.encode(pp, frames), want)


def test_loss_and_grad_match_reference(fam):
    r_model, params, model, pp = fam
    B, S = 2, 20
    batch = {"tokens": np.random.default_rng(0).integers(
        0, model.cfg.vocab, (B, S), dtype=np.int32),
        **_extras(model.cfg, B, S)}
    rl, rg = jax.jit(jax.value_and_grad(r_model.loss))(params, _jnp(batch))
    loss, grads = make_grad_fn(model)(pp, batch)
    np.testing.assert_allclose(float(loss), float(rl), rtol=1e-5)
    for (n, a), (n2, b) in zip(ref_flatten(rg), flatten_with_paths(grads)):
        assert n == n2
        a = np.asarray(a, np.float32)
        scale = max(float(np.abs(a).max()), 1e-30)
        assert float(np.abs(a - b.numpy()).max()) <= 1e-4 * scale, n


def test_prefill_and_decode_match_reference(fam):
    r_model, params, model, pp = fam
    steps = sp.teacher_forced(r_model, params, model, pp, 12, 6,
                              extras=_extras(model.cfg, 2, 12))
    sp.check_logits(steps, 1e-4)


def test_serve_engine_matches_reference(fam):
    r_model, params, model, pp = fam
    want, got, eng = sp.engine_tokens(r_model, params, model, pp)
    assert eng.timings and len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.rid == b.rid
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_image_prefix_reaches_the_logits():
    """The VLM's logits depend on the image embeddings (the prefix-LM reads
    them), through the loss and the prefill alike."""
    _, _, model, pp = sp.pair(r_smoke_config("paligemma-3b"), seed=8)
    toks = np.random.default_rng(3).integers(0, model.cfg.vocab, (2, 10),
                                             dtype=np.int32)
    img = _extras(model.cfg, 2, 10)["img"]
    a, _ = model.prefill(pp, {"tokens": toks, "img": img})
    b, _ = model.prefill(pp, {"tokens": toks, "img": img * 3 + 1})
    assert float((a - b).abs().max()) > 1e-3
    assert float(model.loss(pp, {"tokens": toks, "img": img})) != float(
        model.loss(pp, {"tokens": toks, "img": img * 3 + 1}))


def test_whisper_decoder_never_reads_the_encoder():
    """Pinned fact of the reference: ``Model`` builds Whisper's decoder
    from ``build_groups`` (causal GQA, no cross-attention), so its loss is
    the same under any frames and the encoder's gradient is exactly 0 in
    both packages (the decoder's is not)."""
    r_model, params, model, pp = sp.pair(r_smoke_config("whisper-base"),
                                         seed=9)
    assert [g.kinds for g in model.groups] == [(("gqa_g", "mlp"),)]
    assert [g.kinds for g in r_model.groups] == [(("gqa_g", "mlp"),)]
    toks = np.random.default_rng(5).integers(0, model.cfg.vocab, (2, 16),
                                             dtype=np.int32)
    frames = _extras(model.cfg, 2, 16)["frames"]
    grad_fn = make_grad_fn(model)
    losses, r_losses = [], []
    for f in (frames, frames * 3 + 1):
        batch = {"tokens": toks, "frames": f}
        loss, grads = grad_fn(pp, batch)
        rl, rg = jax.value_and_grad(r_model.loss)(params, _jnp(batch))
        losses.append(float(loss))
        r_losses.append(float(rl))
        for tree, leaves in ((grads["enc_groups"], flatten_with_paths),
                             (rg["enc_groups"], ref_flatten)):
            assert all(float(np.abs(np.asarray(g)).max()) == 0.0
                       for _, g in leaves(tree))
        assert float(grads["groups"][0]["l0"]["attn"]["wq"].abs().max()) > 0
    assert losses[0] == losses[1] and r_losses[0] == r_losses[1]
    # the encoder itself does read the frames
    assert float((model.encode(pp, frames) - model.encode(
        pp, frames * 3 + 1)).abs().max()) > 1e-3


def test_positions_past_the_cache_raise():
    """Where the image prefix, the prompt and the decode steps outgrow the
    cache, the reference's prefill fails or its decode writes are clamped
    onto the cache's last slot (its budget leaves the prefix out); the
    port raises, before the prefill in ``ServeEngine``, and in
    ``prefill``/``decode_step`` themselves."""
    r_model, params, model, pp = sp.pair(r_smoke_config("paligemma-3b"),
                                         seed=10)
    prompt = np.arange(12, dtype=np.int32)
    # 8 prefix + 12 prompt positions fit 22, the 3 decode steps do not
    want = RServeEngine(r_model, params, batch_slots=1, max_len=22).run(
        [RRequest(0, prompt, 4)])
    assert want[0].tokens.shape == (4,)          # the reference clamps
    with pytest.raises(ValueError, match="max_len is 22"):
        ServeEngine(model, pp, batch_slots=1, max_len=22).run(
            [Request(0, prompt, 4)])
    got = ServeEngine(model, pp, batch_slots=1, max_len=23).run(
        [Request(0, prompt, 4)])
    assert got[0].tokens.shape == (4,)
    img = np.zeros((1, 8, model.cfg.d_model), np.float32)
    with pytest.raises(ValueError, match="does not fit"):
        model.prefill(pp, {"tokens": prompt[None], "img": img}, max_len=19)
    _, cache = model.prefill(pp, {"tokens": prompt[None], "img": img},
                             max_len=21)
    _, cache = model.decode_step(pp, cache, prompt[None, :1])
    with pytest.raises(ValueError, match="outside the cache"):
        model.decode_step(pp, cache, prompt[None, :1])


# ----------------------------------------------------------------- train step

@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_with_microbatches_matches_reference(arch):
    """Three AdamW steps on batches of 4 in microbatches of 2: ``img`` and
    ``frames`` are split along their rows with the tokens."""
    r_cfg = r_smoke_config(arch)
    r_model, rp, model, pp = sp.pair(r_cfg, seed=12)
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10,
              microbatch=2)
    rst = ref_opt.init_opt_state(rp, keep_master=False)
    st = opt.init_opt_state(pp, keep_master=False)
    r_step = jax.jit(ref_make_train_step(r_model, RTrainConfig(**kw)))
    step = make_train_step(model, TrainConfig(**kw))
    whole = make_train_step(model, TrainConfig(**dict(kw, microbatch=None)))
    for i in range(3):
        b = {**lm_batch(0, i, 4, 16, r_cfg.vocab),
             **_extras(model.cfg, 4, 16, seed=20 + i)}
        if i == 0:
            p1 = convert.transformer_params_from_numpy(
                convert.tree_to_numpy(pp), device="cpu")
            _, _, m_whole = whole(p1, opt.init_opt_state(p1, keep_master=False),
                                  b)
        rp, rst, rm = r_step(rp, rst, _jnp(b))
        pp, st, m = step(pp, st, b)
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-4)
        if i == 0:
            np.testing.assert_allclose(float(m["loss"]),
                                       float(m_whole["loss"]), rtol=1e-5)


# ------------------------------------------------------------------- registry

def test_configs_build_on_the_card_by_default():
    for arch in ARCHS:
        assert configs.get_model(arch, device="cpu").cfg.name == arch
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                configs.get_model(arch)
