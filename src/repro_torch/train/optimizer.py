"""AdamW with mixed-precision master weights (port of
``repro/train/optimizer.py``; no optimizer library).

* Parameters may live in bf16; the optimizer then keeps a float32 master
  copy, and the working parameters are re-cast from it every step.  The
  moments are in ``opt_dtype`` (float32 unless a config says bf16).
* One global-norm clip over every gradient, bias correction, decoupled
  weight decay, the reference's warmup + cosine schedule.

The reference returns a new tree of every array.  The port updates the
parameters, the moments and the master copy in place, leaf by leaf, and a
large leaf in chunks of ``CHUNK`` elements: the arithmetic is elementwise,
so chunking changes no bit, and the float32 temporaries of one chunk are
all the update adds (the Table II DLRM's tables hold 4.1 G elements: one
float32 temporary of them is 16.4 GB).  The global norm sums each chunk's
squares and adds the chunk sums in order.

``zero1_spec`` and ``opt_state_specs`` take a mesh's ``PartitionSpec``s:
they come with the logical-axis sharding (ROADMAP.md queue item 9.8).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.pytree import flatten_with_paths, tree_map

CHUNK = 1 << 26        # elements a chunk of a large leaf (256 MB in float32)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def lr_schedule(tcfg, step) -> float:
    """Linear warmup to ``learning_rate`` over ``warmup_steps``, then a
    cosine from 1 down to 0.1 of it at ``total_steps``; in float32 as the
    reference computes it."""
    f32 = np.float32
    step = f32(step)
    warm = min(step / f32(max(tcfg.warmup_steps, 1)), f32(1.0))
    prog = np.clip((step - f32(tcfg.warmup_steps))
                   / f32(max(tcfg.total_steps - tcfg.warmup_steps, 1)),
                   f32(0.0), f32(1.0))
    cos = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * prog, dtype=f32))
    return float(f32(tcfg.learning_rate) * f32(warm)
                 * (f32(0.1) + f32(0.9) * cos))


def init_opt_state(params, opt_dtype=torch.float32,
                   keep_master: bool = True) -> dict:
    """Zero moments ``mu``, ``nu`` in ``opt_dtype`` beside every parameter,
    ``count`` 0 (an int32 scalar) and, with ``keep_master``, a float32
    copy of the parameters (``master``)."""
    state = {
        "mu": tree_map(lambda x: torch.zeros(x.shape, dtype=opt_dtype,
                                             device=x.device), params),
        "nu": tree_map(lambda x: torch.zeros(x.shape, dtype=opt_dtype,
                                             device=x.device), params),
        "count": torch.zeros((), dtype=torch.int32),
    }
    if keep_master:
        state["master"] = tree_map(lambda x: x.detach().float().clone(),
                                   params)
    return state


def _chunks(x: torch.Tensor):
    """Views of ``x``'s elements in order, ``CHUNK`` at a time (a
    non-contiguous gradient is read through a contiguous copy)."""
    flat = x.view(-1) if x.is_contiguous() else x.reshape(-1)
    for i in range(0, flat.numel(), CHUNK):
        yield flat[i:i + CHUNK]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over every leaf of its float32 squares (a float32
    scalar on the leaves' device), leaves in the reference's order."""
    total = None
    for _, x in flatten_with_paths(tree):
        for part in _chunks(x.detach()):
            s = torch.sum(torch.square(part.float()))
            total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, state, tcfg):
    """One AdamW step: the parameters, the moments and the master copy
    updated in place.  Returns (params, state, metrics) as the reference
    does, ``metrics`` holding ``lr`` (a float) and ``grad_norm`` (a
    float32 scalar on the device)."""
    count = int(state["count"]) + 1
    lr = lr_schedule(tcfg, count)
    gnorm = global_norm(grads)
    clip = torch.clamp(tcfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                       max=1.0)
    b1, b2, eps, wd = tcfg.beta1, tcfg.beta2, tcfg.eps, tcfg.weight_decay
    f32 = np.float32
    bc1 = float(f32(1) - f32(b1) ** f32(count))
    bc2 = float(f32(1) - f32(b2) ** f32(count))

    leaves = [x for _, x in flatten_with_paths(params)]
    flat_g = [x for _, x in flatten_with_paths(grads)]
    flat_mu = [x for _, x in flatten_with_paths(state["mu"])]
    flat_nu = [x for _, x in flatten_with_paths(state["nu"])]
    flat_m = ([x for _, x in flatten_with_paths(state["master"])]
              if "master" in state else leaves)
    for p, g, mu, nu, m in zip(leaves, flat_g, flat_mu, flat_nu, flat_m):
        for pc, gc, muc, nuc, mc in zip(_chunks(p), _chunks(g), _chunks(mu),
                                        _chunks(nu), _chunks(m)):
            g32 = gc.float() * clip
            mu2 = b1 * muc.float() + (1 - b1) * g32
            nu2 = b2 * nuc.float() + (1 - b2) * g32 * g32
            step_ = (mu2 / bc1) / (torch.sqrt(nu2 / bc2) + eps)
            m32 = mc.float()
            m_new = m32 - lr * (step_ + wd * m32)
            muc.copy_(mu2)
            nuc.copy_(nu2)
            if mc is not pc:
                mc.copy_(m_new)
            pc.copy_(m_new)
    state["count"] = torch.tensor(count, dtype=torch.int32)
    return params, state, {"lr": lr, "grad_norm": gnorm}
