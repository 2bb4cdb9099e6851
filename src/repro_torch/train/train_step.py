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
roundings (``g / n_acc`` in the gradient's dtype).

**On a live mesh** (the model built with ``mesh=``; every rank runs the
step on the *global* batch, the same on every rank, and its own blocks of
the parameters and the optimizer state):

* each leaf is gathered whole for the compute (``gather_full``), but the
  leaves the model reads as blocks (``model.mesh_local``: the DLRM's
  tables, the MoE experts); the model's ``mesh_loss`` gives this rank's
  share of the loss from its rows of the batch;
* the gradients are summed over the batch axes into ``grad_specs``'
  layout (the parameters' by default): a ``psum_scatter`` over the batch
  axes a layout shards a dim over (the reference's
  ``with_sharding_constraint`` to the ZeRO-1 layout), a ``psum`` over the
  others, a local slice over the non-batch axes (every rank of those
  computed the same gradient);
* the loss is the ``psum`` of the shares; accumulation slices
  microbatches of the global batch in the reference's order, each rank
  keeping its block of the carry;
* AdamW updates each rank's blocks (``optimizer.MeshLayout``).
"""
from __future__ import annotations

import torch

from repro_torch.common import comm
from repro_torch.common.precision import float32_reduction
from repro_torch.common.pytree import (flatten_with_paths, map_with_specs,
                                       tree_leaves, tree_map, unflatten_like)
from repro_torch.common.sharding import P, gather_full, local_shard
from repro_torch.train.optimizer import (DTYPES, MeshLayout, _refine,
                                         _spec_leaves, adamw_update,
                                         init_opt_state, opt_state_specs)


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


def _live_mesh(model):
    mesh = getattr(model, "mesh", None)
    return mesh if mesh is not None and mesh.is_live else None


def make_train_step(model, tcfg, grad_specs=None):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``; ``metrics``: ``loss`` and ``grad_norm`` (float32
    scalars on the device) and ``lr``.  The parameters and the optimizer
    state are updated in place (and returned).  On a live mesh, ``batch``
    is the global batch and the leaves are this rank's blocks (the
    optimizer state's from ``init_train_state``); ``grad_specs`` is the
    layout the gradients are reduced into (``opt_state_specs``' mu for
    ZeRO-1's reduce-scatter)."""
    if _live_mesh(model) is not None:
        return _mesh_train_step(model, tcfg, grad_specs)
    grad_fn = make_grad_fn(model)

    def train_step(params, opt_state, batch):
        loss, grads = accumulate_grads(grad_fn, params, batch,
                                       tcfg.microbatch)
        params, opt_state, metrics = adamw_update(params, grads, opt_state,
                                                  tcfg)
        return params, opt_state, dict(metrics, loss=loss)

    return train_step


def _keep_master(model) -> bool:
    return DTYPES[model.cfg.param_dtype] != torch.float32


def _param_defs(model):
    if isinstance(model, torch.nn.Module):
        from repro_torch.models.dlrm import param_defs
        return param_defs(model.cfg)
    return model.param_defs()


def mesh_layout(model, tcfg, grad_specs=None) -> MeshLayout:
    """The blocks' specs of a model on a live mesh: parameters, gradients
    (``grad_specs``, else the parameters'), moments (ZeRO-1's when
    ``tcfg.zero1``)."""
    mesh = _live_mesh(model)
    specs = model.param_specs()
    opt = opt_state_specs(specs, _param_defs(model), mesh, zero1=tcfg.zero1,
                          keep_master=_keep_master(model))
    return MeshLayout(mesh, specs, grad_specs or specs, opt["mu"])


def _batch_axes(model) -> tuple:
    """The mesh axes the batch rows are sharded over."""
    return model.rules().pspec(("batch",)).axes(0)


def reduce_grad(g, have: P, want: P, sum_axes: tuple, mesh):
    """A gradient held in layout ``have`` (``P()``: whole), whose
    contributions are still to be summed over the batch axes
    ``sum_axes``, summed and laid out as ``want`` (which refines
    ``have``): ``psum_scatter`` where ``want`` shards a dim over summed
    axes, a local slice where over others, a ``psum`` over the rest."""
    todo = [a for a in mesh.axis_names if a in sum_axes]
    for i in range(g.dim()):
        a, b = have.axes(i), want.axes(i)
        if a == b:
            continue
        if a:
            raise ValueError(f"layout {want} does not refine {have}")
        if all(x in todo for x in b):
            g = comm.psum_scatter(g, mesh, b, dim=i)
            todo = [x for x in todo if x not in b]
            continue
        both = tuple(x for x in todo if x in b)
        if both:
            g = comm.psum(g, mesh, both)
            todo = [x for x in todo if x not in both]
        n = g.shape[i] // mesh.axis_size(b)
        g = g.narrow(i, mesh.axis_index(b) * n, n)
    if todo:
        g = comm.psum(g, mesh, tuple(todo))
    return g


def _mesh_train_step(model, tcfg, grad_specs=None):
    layout = mesh_layout(model, tcfg, grad_specs)
    mesh = layout.mesh
    b_axes = _batch_axes(model)
    whole = P()

    def grad_fn(params, batch):
        """(loss, gradient blocks in ``layout.grads``) of a global
        (micro)batch."""
        aliases = []

        def compute(p, spec, path):
            if model.mesh_local(path):
                t = p.detach().requires_grad_()
            else:
                t = gather_full(p.detach(), spec, mesh).requires_grad_()
            aliases.append((t, spec, path))
            return t
        tree = map_with_specs(compute, params, layout.params)
        with torch.enable_grad(), float32_reduction():
            share = model.mesh_loss(tree, batch)
            grads = torch.autograd.grad(share, [t for t, _, _ in aliases])
        by_path = {}
        for (t, spec, path), g in zip(aliases, grads):
            have = spec if model.mesh_local(path) else whole
            todo = tuple(a for a in b_axes if a not in have.used_axes())
            by_path[path] = (g, have, todo)
        # reduce in the spec tree's (sorted-path) order on every rank
        out = map_with_specs(lambda p, spec, path: reduce_grad(
            by_path[path][0], by_path[path][1], spec, by_path[path][2],
            mesh), params, layout.grads)
        loss = comm.psum(share.detach(), mesh, b_axes) if b_axes else \
            share.detach()
        return loss, out

    def train_step(params, opt_state, batch):
        mb = tcfg.microbatch
        bsz = next(iter(batch.values())).shape[0]
        if not mb or mb >= bsz:
            loss, grads = grad_fn(params, batch)
        else:
            n_acc = bsz // mb
            loss, grads = None, None
            for i in range(n_acc):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                li, gi = grad_fn(params, micro)
                if grads is None:
                    grads = tree_map(lambda g: torch.zeros(
                        g.shape, dtype=torch.float32, device=g.device), gi)
                for acc, g in zip(tree_leaves(grads), tree_leaves(gi)):
                    acc.add_(g / n_acc)
                part = li / n_acc
                loss = part if loss is None else loss + part
        params, opt_state, metrics = adamw_update(params, grads, opt_state,
                                                  tcfg, layout=layout)
        return params, opt_state, dict(metrics, loss=loss)

    train_step.layout = layout
    return train_step


def init_train_state(model, generator: torch.Generator | None, tcfg,
                     grad_specs=None):
    """(params, opt_state): the parameters, ``Model.init(generator)`` or a
    DLRM's own weights (drawn from its seed when it was built; the
    reference's tree ``{"tables", "bot", "top"}`` sharing their storage),
    and a zero AdamW state with a float32 master copy when the config's
    parameters are not float32, the moments in its ``opt_dtype``.  On a
    live mesh: this rank's blocks (a ``Model``'s cut from the whole draw)
    and the state's blocks under ZeRO-1's specs when ``tcfg.zero1``."""
    keep_master = _keep_master(model)
    opt_dtype = DTYPES[getattr(model.cfg, "opt_dtype", "float32")]
    mesh = _live_mesh(model)
    if isinstance(model, torch.nn.Module):
        params = model.param_tree()
    else:
        params = model.init(generator)
        if mesh is not None:
            params = map_with_specs(lambda x, sp, _: local_shard(x, sp, mesh)
                                    .clone(), params, model.param_specs())
    if mesh is None:
        return params, init_opt_state(params, opt_dtype, keep_master)
    layout = mesh_layout(model, tcfg, grad_specs)
    return params, init_mesh_opt_state(params, layout, opt_dtype,
                                       keep_master)


def init_mesh_opt_state(params, layout: MeshLayout, opt_dtype=torch.float32,
                        keep_master: bool = True) -> dict:
    """The AdamW state's blocks of this rank: zero moments under
    ``layout.moments``, ``count`` 0 and, with ``keep_master``, a float32
    copy of the parameters' blocks under the same specs."""
    blocks = unflatten_like(params, [
        _refine(p.detach(), a, b, layout.mesh) for p, a, b in zip(
            [x for _, x in flatten_with_paths(params)],
            _spec_leaves(layout.params),
            _spec_leaves(layout.moments))])
    state = {
        "mu": tree_map(lambda x: torch.zeros(x.shape, dtype=opt_dtype,
                                             device=x.device), blocks),
        "nu": tree_map(lambda x: torch.zeros(x.shape, dtype=opt_dtype,
                                             device=x.device), blocks),
        "count": torch.zeros((), dtype=torch.int32),
    }
    if keep_master:
        state["master"] = tree_map(lambda x: x.float().clone(), blocks)
    return state
