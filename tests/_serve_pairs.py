"""Shared helpers of the serving-family tests: the reference's and the
port's model of one config, fed the same numpy weights, and a teacher-
forced comparison of their prefill and decode logits.

Weights: ``chip_smoke.transformer_numpy_params`` at the true fan-in
(float32 leaves), carried across by ``repro_torch.convert``.  With
``f32=True`` both models run their activations in float32 (each
``Model.compute_dtype`` set to float32; caches keep their dtypes), so a
comparison holds the algorithm at float32 rounding, not two frameworks'
bf16 roundings."""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models.model_api import Model as RModel
from repro_torch import convert
from repro_torch.configs.base import ModelConfig
from repro_torch.models import Model

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (numpy only at import: the shared weights)


def port_cfg(r_cfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(r_cfg, f.name)
                          for f in dataclasses.fields(r_cfg)})


def _is_def(x):
    return hasattr(x, "init") and hasattr(x, "axes")


def signature(tree) -> list:
    """(path, "shape dtype") of every leaf of a jax or torch tree."""
    def one(a):
        return f"{tuple(a.shape)} {str(a.dtype).split('.')[-1]}"
    return [(jax.tree_util.keystr(p), one(a))
            for p, a in jax.tree.leaves_with_path(tree)]


def numpy_weights(r_model, seed: int):
    """The reference's parameter tree of float32 numpy draws."""
    shapes = jax.tree.map(lambda d: d.shape, r_model.param_defs(),
                          is_leaf=_is_def)
    return chip_smoke.transformer_numpy_params(shapes, seed, bf16=False)


def pair(r_cfg, seed: int = 5, f32: bool = True):
    """(reference model, its params, port model, port params)."""
    r_model = RModel(r_cfg)
    tree = numpy_weights(r_model, seed)
    params = jax.tree.map(jnp.asarray, tree)
    model = Model(port_cfg(r_cfg), device="cpu")
    if f32:
        r_model.compute_dtype = jnp.float32
        model.compute_dtype = torch.float32
    return r_model, params, model, convert.transformer_params_from_numpy(
        tree, device="cpu")


def teacher_forced(r_model, params, model, pp, S: int, N: int, seed: int = 0,
                   B: int = 2):
    """Both models' logits on the same tokens: prefill of S, then N decode
    steps; [(reference (B, V), port (B, V)), ...]."""
    toks = np.random.default_rng(seed).integers(0, model.cfg.vocab,
                                                (B, S + N), dtype=np.int32)
    max_len = S + N + 2
    r_logits, r_cache = jax.jit(lambda p, b: r_model.prefill(
        p, b, max_len=max_len))(params, {"tokens": jnp.asarray(toks[:, :S])})
    logits, cache = model.prefill(pp, {"tokens": toks[:, :S]},
                                  max_len=max_len)
    out = [(np.asarray(r_logits, np.float32), logits.numpy())]
    r_decode = jax.jit(r_model.decode_step)
    for t in range(S, S + N):
        r_logits, r_cache = r_decode(params, r_cache,
                                     jnp.asarray(toks[:, t:t + 1]))
        logits, cache = model.decode_step(pp, cache, toks[:, t:t + 1])
        out.append((np.asarray(r_logits, np.float32), logits.numpy()))
    assert cache["pos"] == S + N
    return out


def check_logits(steps, rtol: float):
    """Every step's logits within ``rtol`` of the reference's largest
    |logit| (logits near 0 have no relative error to hold)."""
    for i, (want, got) in enumerate(steps):
        assert got.shape == want.shape, i
        err = float(np.abs(got - want).max())
        assert err <= rtol * float(np.abs(want).max()), (i, err)


def engine_tokens(r_model, params, model, pp, n_req: int = 3,
                  prompt: int = 12, new: int = 4, slots: int = 2,
                  max_len: int = 32):
    """``ServeEngine`` of each package on the same requests: (reference
    results, port results, port engine)."""
    from repro.serve.engine import Request as RRequest
    from repro.serve.engine import ServeEngine as RServeEngine
    from repro_torch.serve import Request, ServeEngine
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, model.cfg.vocab, prompt, dtype=np.int32)
               for _ in range(n_req)]
    want = RServeEngine(r_model, params, batch_slots=slots,
                        max_len=max_len).run(
        [RRequest(i, p, new) for i, p in enumerate(prompts)])
    eng = ServeEngine(model, pp, batch_slots=slots, max_len=max_len)
    got = eng.run([Request(i, p, new) for i, p in enumerate(prompts)])
    return want, got, eng
