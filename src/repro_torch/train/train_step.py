"""The train step: loss and gradient (with accumulation) + AdamW +
metrics (port of ``repro/train/train_step.py``).

``make_train_step(model, tcfg)`` serves both kinds of model the port
trains: a ``Model`` (a functional parameter tree: ``model.loss(params,
batch)``) and a ``DLRM`` (an ``nn.Module``: its loss runs through
``torch.func.functional_call`` over the given tree, ``DLRM.loss(batch,
params=...)``).  The gradient is autograd's, taken with respect to
detached aliases of the parameters, so the caller's tensors never
require grad; ``adamw_update`` then writes them in place.  On the card the
loss and its backward run with cuBLAS's bf16 products reduced in float32
(``float32_reduction``), as the reference's dots are.

With ``tcfg.microbatch`` set below the batch, the batch is split into
``n_acc = batch // microbatch`` microbatches run one after the other (the
reference's ``lax.scan``): each adds ``g / n_acc`` into a float32 carry
and ``loss / n_acc`` into the loss, in the reference's order and
roundings (``g / n_acc`` in the gradient's dtype).  ``grad_specs`` (a
layout of the carry over a mesh) comes with the logical-axis sharding
(ROADMAP.md queue item 9.8).
"""
from __future__ import annotations

import torch

from repro_torch.common.precision import float32_reduction
from repro_torch.common.pytree import tree_leaves, tree_map
from repro_torch.train.optimizer import DTYPES, adamw_update, init_opt_state


def make_loss_fn(model):
    """``loss_fn(params, batch)``: ``Model.loss`` or, for an
    ``nn.Module`` (the DLRM), its ``loss`` over ``params``."""
    if isinstance(model, torch.nn.Module):
        return lambda params, batch: model.loss(batch, params=params)
    return model.loss


def make_grad_fn(model):
    """``grad_fn(params, batch) -> (loss, grads)``: the loss (a float32
    scalar) and its gradient tree, each leaf in its parameter's dtype."""
    loss_fn = make_loss_fn(model)

    def grad_fn(params, batch):
        alias = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad(), float32_reduction():
            loss = loss_fn(alias, batch)
            leaves = tree_leaves(alias)
            grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        return loss.detach(), tree_map(lambda _: next(it), alias)
    return grad_fn


def _batch_size(batch: dict) -> int:
    return next(iter(batch.values())).shape[0]


def accumulate_grads(grad_fn, params, batch, microbatch):
    """The loss and gradient of ``batch``, over microbatches of
    ``microbatch`` rows when it is set below the batch."""
    bsz = _batch_size(batch)
    if not microbatch or microbatch >= bsz:
        return grad_fn(params, batch)
    n_acc = bsz // microbatch
    loss_c = None
    g_c = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    for i in range(n_acc):
        micro = {k: v[i * microbatch:(i + 1) * microbatch]
                 for k, v in batch.items()}
        loss, g = grad_fn(params, micro)
        for acc, gi in zip(tree_leaves(g_c), tree_leaves(g)):
            acc.add_(gi / n_acc)
        del g
        part = loss / n_acc
        loss_c = part if loss_c is None else loss_c + part
    return loss_c, g_c


def make_train_step(model, tcfg):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``; ``metrics``: ``loss`` and ``grad_norm`` (float32
    scalars on the device) and ``lr``.  The parameters and the optimizer
    state are updated in place (and returned)."""
    grad_fn = make_grad_fn(model)

    def train_step(params, opt_state, batch):
        loss, grads = accumulate_grads(grad_fn, params, batch,
                                       tcfg.microbatch)
        params, opt_state, metrics = adamw_update(params, grads, opt_state,
                                                  tcfg)
        return params, opt_state, dict(metrics, loss=loss)

    return train_step


def init_train_state(model, generator: torch.Generator | None, tcfg):
    """(params, opt_state): the parameters, ``Model.init(generator)`` or a
    DLRM's own weights (drawn from its seed when it was built; the
    reference's tree ``{"tables", "bot", "top"}`` sharing their storage),
    and a zero AdamW state with a float32 master copy when the config's
    parameters are not float32, the moments in its ``opt_dtype``."""
    params = (model.param_tree() if isinstance(model, torch.nn.Module)
              else model.init(generator))
    keep_master = DTYPES[model.cfg.param_dtype] != torch.float32
    opt_dtype = DTYPES[getattr(model.cfg, "opt_dtype", "float32")]
    return params, init_opt_state(params, opt_dtype, keep_master)
