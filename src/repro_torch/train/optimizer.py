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

**ZeRO-1** (``zero1_spec``, ``opt_state_specs``, the reference's):
optimizer-state specs get the ``data`` mesh axis on their first
unsharded, divisible dim, so the moments and the master copy are sharded
across data parallelism.  On a live mesh (``adamw_update(...,
layout=MeshLayout(...))``) every leaf is this rank's block: each rank
updates only its block of the moments, from its block of the gradient;
where the moments' spec shards a dim the parameter's does not, the
updated parameter blocks are all-gathered over that axis (the
reduce-scatter / all-gather pattern of ZeRO-1).  The clip's global norm
sums each leaf's squares over its *distinct* blocks (one ``psum`` over the
axes that shard it, a replicated leaf counted once, not once a rank): it
equals the unsharded ``global_norm`` up to the order of the sums.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.common import comm
from repro_torch.common.pytree import (flatten_with_paths, map_with_specs,
                                       tree_map)
from repro_torch.common.sharding import P, flatten_specs

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


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """The leaves of a live mesh's rank: the parameters' blocks under
    ``params`` (a spec tree), the gradients' under ``grads``, the moments'
    and the master copy's under ``moments`` (``opt_state_specs``' mu)."""
    mesh: object
    params: object
    grads: object
    moments: object


def _leaves(tree) -> list:
    return [x for _, x in flatten_with_paths(tree)]


def _spec_leaves(tree) -> list:
    """The specs of a spec tree in ``flatten_with_paths`` order."""
    return [sp for _, sp in flatten_specs(tree)]


def _refine(x: torch.Tensor, src: P, dst: P, mesh) -> torch.Tensor:
    """This rank's block under ``dst`` of an array it holds as its block
    under ``src``, where ``dst`` shards every dim as ``src`` does or, on a
    dim ``src`` leaves whole, over more axes (a view)."""
    for i in range(x.dim()):
        a, b = src.axes(i), dst.axes(i)
        if a == b:
            continue
        if a:
            raise ValueError(f"layout {dst} does not refine {src} on dim {i}")
        n = x.shape[i] // mesh.axis_size(b)
        x = x.narrow(i, mesh.axis_index(b) * n, n)
    return x


def _coarsen(x: torch.Tensor, src: P, dst: P, mesh) -> torch.Tensor:
    """The inverse of ``_refine``: blocks all-gathered over the axes
    ``src`` adds."""
    for i in range(x.dim()):
        a, b = src.axes(i), dst.axes(i)
        if a != b:
            x = comm.all_gather(x, mesh, a, dim=i)
    return x


def sharded_global_norm(grads, specs, mesh) -> torch.Tensor:
    """The unsharded tree's ``global_norm`` from this rank's blocks:
    leaves grouped by the axes that shard them, one ``psum`` over those
    axes a group, the groups added in a fixed order."""
    buckets: dict = {}
    for x, sp in zip(_leaves(grads), _spec_leaves(specs)):
        axes = tuple(a for a in mesh.axis_names if a in sp.used_axes())
        for part in _chunks(x.detach()):
            s = torch.sum(torch.square(part.float()))
            buckets[axes] = s if axes not in buckets else buckets[axes] + s
    total = None
    for axes in sorted(buckets, key=lambda a: (len(a), a)):
        s = comm.psum(buckets[axes], mesh, axes) if axes else buckets[axes]
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, state, tcfg, layout: MeshLayout | None = None):
    """One AdamW step: the parameters, the moments and the master copy
    updated in place.  Returns (params, state, metrics) as the reference
    does, ``metrics`` holding ``lr`` (a float) and ``grad_norm`` (a
    float32 scalar on the device).  With ``layout`` every leaf is a block
    of a live mesh (``MeshLayout``)."""
    count = int(state["count"]) + 1
    lr = lr_schedule(tcfg, count)
    gnorm = (global_norm(grads) if layout is None else
             sharded_global_norm(grads, layout.grads, layout.mesh))
    clip = torch.clamp(tcfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                       max=1.0)

    leaves = _leaves(params)
    flat_g = _leaves(grads)
    flat_mu = _leaves(state["mu"])
    flat_nu = _leaves(state["nu"])
    flat_m = _leaves(state["master"]) if "master" in state else None
    n = len(leaves)
    if layout is None:
        sp = [None] * n
        sg = sz = sp
    else:
        sp, sg, sz = (_spec_leaves(t) for t in (layout.params, layout.grads,
                                                layout.moments))
    for i in range(n):
        p, g, mu, nu = leaves[i], flat_g[i], flat_mu[i], flat_nu[i]
        m = p if flat_m is None else flat_m[i]
        if layout is None or sp[i] == sz[i]:
            if layout is not None:
                g = _refine(g, sg[i], sz[i], layout.mesh)
            _update(p, g, mu, nu, m, clip, lr, count, tcfg)
            continue
        # the moments' blocks are finer than the parameter's: update this
        # rank's block (a copy of it without a master) and gather it back
        mesh = layout.mesh
        g = _refine(g, sg[i], sz[i], mesh)
        if flat_m is None:
            m = _refine(p, sp[i], sz[i], mesh).float().clone()
        _update(m, g, mu, nu, m, clip, lr, count, tcfg)
        p.copy_(_coarsen(m.to(p.dtype), sz[i], sp[i], mesh))
    state["count"] = torch.tensor(count, dtype=torch.int32)
    return params, state, {"lr": lr, "grad_norm": gnorm}


def _update(p, g, mu, nu, m, clip, lr, count, tcfg) -> None:
    """AdamW on one leaf's elements, in chunks, in place: ``mu``, ``nu``,
    ``m`` (the master, or ``p`` itself) and ``p``."""
    b1, b2, eps, wd = tcfg.beta1, tcfg.beta2, tcfg.eps, tcfg.weight_decay
    f32 = np.float32
    bc1 = float(f32(1) - f32(b1) ** f32(count))
    bc2 = float(f32(1) - f32(b2) ** f32(count))
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


# ---------------------------------------------------------------------------
# ZeRO-1 sharding of optimizer state
# ---------------------------------------------------------------------------

def zero1_spec(pspec: P, shape: tuple, mesh, axis: str = "data") -> P:
    """Add ``axis`` to the first dim that is unsharded and divisible."""
    if mesh is None or axis not in mesh.axis_names:
        return pspec
    n = mesh.shape[axis]
    used = set()
    for e in pspec:
        if e is None:
            continue
        for a in (e if isinstance(e, tuple) else (e,)):
            used.add(a)
    if axis in used:
        return pspec
    parts = list(pspec) + [None] * (len(shape) - len(pspec))
    for i, (e, dim) in enumerate(zip(parts, shape)):
        if e is None and dim % n == 0 and dim >= n:
            parts[i] = axis
            return P(*parts)
    return pspec


def opt_state_specs(param_specs, param_defs, mesh, zero1: bool = True,
                    keep_master: bool = True) -> dict:
    """The optimizer state's spec tree: ``mu``, ``nu`` (and ``master``)
    under ZeRO-1's specs, ``count`` replicated."""
    moment_specs = map_with_specs(
        lambda pd, ps, _: zero1_spec(ps, pd.shape, mesh) if zero1 else ps,
        param_defs, param_specs)
    out = {"mu": moment_specs, "nu": moment_specs, "count": P()}
    if keep_master:
        out["master"] = moment_specs
    return out
