"""``models/flash.py``: the port's flash attention (forward and its
recomputing backward, a ``torch.autograd.Function``) against the
reference's ``jax.custom_vjp`` on the cases of ``tests/test_flash.py``,
and the model's train path through it past 1,024 positions."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models.flash import flash_attention as ref_flash
from repro_torch.models import flash as F
from repro_torch.models import layers as L

torch.set_num_threads(1)


def _qkv(B, S, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, h, D)).astype(np.float32)
            for h in (Hq, Hkv, Hkv)]


def _torch(arrs):
    return [torch.tensor(a, requires_grad=True) for a in arrs]


@pytest.mark.parametrize("S,bq,bk", [(256, 64, 64), (512, 128, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_and_grads_match_reference(S, bq, bk, causal):
    q, k, v = _qkv(2, S, 4, 2, 32)
    w = np.random.default_rng(1).normal(size=q.shape).astype(np.float32)

    def ref_loss(q, k, v):
        return (ref_flash(q, k, v, causal, bq, bk) * w).sum()

    r_out = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal, bq, bk)
    r_grads = jax.grad(ref_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _torch((q, k, v))
    out = F.flash_attention(tq, tk, tv, causal, bq, bk)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(r_out),
                               rtol=1e-5, atol=1e-6)
    grads = torch.autograd.grad((out * torch.as_tensor(w)).sum(),
                                (tq, tk, tv))
    for g, rg in zip(grads, r_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(rg), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(rg).max()))


def test_grads_match_blockwise_autograd():
    """The recomputing backward equals autograd through the port's own
    blockwise attention (what ``chip_smoke.py`` checks on the card)."""
    q, k, v = _qkv(1, 256, 4, 2, 16, seed=2)
    tq, tk, tv = _torch((q, k, v))
    a = F.flash_attention(tq, tk, tv, True, 64, 64)
    ga = torch.autograd.grad(a.square().sum(), (tq, tk, tv))
    tq, tk, tv = _torch((q, k, v))
    b = L.blockwise_attention(tq, tk, tv, causal=True, block_q=64,
                              block_k=64)
    gb = torch.autograd.grad(b.square().sum(), (tq, tk, tv))
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    for x, y in zip(ga, gb):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(y.abs().max()))


def test_bf16_inputs_keep_their_dtype():
    q, k, v = _qkv(1, 128, 2, 1, 16, seed=3)
    tq, tk, tv = (torch.tensor(a).to(torch.bfloat16).requires_grad_()
                  for a in (q, k, v))
    out = F.flash_attention(tq, tk, tv, True, 64, 64)
    assert out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out.float().sum(), (tq, tk, tv))
    assert all(g.dtype == torch.bfloat16 for g in grads)


def test_blocks_must_divide():
    q, k, v = _torch(_qkv(1, 96, 2, 1, 8))
    with pytest.raises(ValueError, match="multiple of the blocks"):
        F.flash_attention(q, k, v, True, 64, 64)


def test_model_trains_through_flash(monkeypatch):
    """A flash-enabled smoke model past the dense cutoff (S = 2048) takes
    the flash path in its loss, and its loss and gradient match the
    reference's (float32 activations)."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from _serve_pairs import pair
    from repro.common.pytree import flatten_with_paths as ref_flatten
    from repro_torch.common.pytree import flatten_with_paths
    from repro_torch.models import transformer as T
    from repro_torch.train.train_step import make_grad_fn
    r_cfg = dataclasses.replace(ref_smoke_config("tinyllama-1.1b"),
                                n_layers=1, flash_attention=True,
                                block_q=512, block_k=512)
    r_model, rp, model, pp = pair(r_cfg, seed=8, f32=True)
    calls = []

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return F.flash_attention(*a, **kw)
    monkeypatch.setattr(T, "flash_attention", counted)
    toks = np.random.default_rng(3).integers(0, r_cfg.vocab, (1, 2048),
                                             dtype=np.int32)
    rl, rg = jax.jit(jax.value_and_grad(r_model.loss))(
        rp, {"tokens": jnp.asarray(toks)})
    loss, grads = make_grad_fn(model)(pp, {"tokens": toks})
    assert calls, "the flash path was not taken"
    np.testing.assert_allclose(float(loss), float(rl), rtol=1e-5)
    for (n, a), (_, b) in zip(ref_flatten(rg), flatten_with_paths(grads)):
        a = np.asarray(a)
        assert np.abs(a - b.numpy()).max() <= 1e-4 * np.abs(a).max(), n
