"""Declarative parameter trees (port of ``repro/common/pytree.py``).

A model declares its parameters once as a tree (nested dicts and lists)
of :class:`ParamDef` leaves; ``materialize`` turns the tree into the same
tree of tensors, drawn by the rules of ``common/init.py``.
``flatten_with_paths`` names a tree's leaves as the reference's
``jax.tree_util`` paths do (the checkpoint layout's file names).
``specs_of`` gives the tree's ``PartitionSpec``s under a ``MeshRules``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.common import init as init_mod


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """One parameter: shape, logical axes (one per dim, None for
    unsharded), init rule (``common/init.py``: zeros, ones, normal,
    scaled) and dtype."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in length")


def tree_map(fn, tree):
    """``fn`` on every leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def materialize(defs, generator: torch.Generator | None, device):
    """The tree of ``defs`` with every ParamDef leaf drawn on ``device``
    from ``generator``, leaf after leaf (other leaves kept).  PyTorch's
    stream, not JAX's: weights that must equal the reference's cross by
    ``repro_torch.convert``."""
    def one(d):
        if not isinstance(d, ParamDef):
            return d
        return init_mod.make(d.shape, d.init, d.dtype, generator, device)
    return tree_map(one, defs)


def map_with_specs(fn, tree, specs, path: tuple = ()):
    """``fn(leaf, spec, path)`` over the leaves of ``tree`` and the
    matching leaves of ``specs`` (a tree of the same structure whose
    leaves may be tuples, as ``PartitionSpec``s are), ``path`` the tuple
    of keys and indices down to the leaf."""
    if isinstance(tree, dict):
        return {k: map_with_specs(fn, tree[k], specs[k], path + (str(k),))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_specs(fn, v, sp, path + (str(i),))
                          for i, (v, sp) in enumerate(zip(tree, specs)))
    return fn(tree, specs, path)


def specs_of(defs, rules):
    """PartitionSpec tree via ``MeshRules`` (duck-typed: no import
    cycle).  Shape-aware: non-divisible assignments fall back to
    replication."""
    return tree_map(lambda d: rules.pspec(d.axes, d.shape)
                    if isinstance(d, ParamDef) else d, defs)


def _numel(shape) -> int:
    return math.prod(shape)


def count_params(defs_or_params) -> int:
    total = 0
    for leaf in tree_leaves(defs_or_params):
        if isinstance(leaf, (ParamDef, torch.Tensor)):
            total += _numel(leaf.shape)
    return total


def tree_bytes(defs_or_params) -> int:
    total = 0
    for leaf in tree_leaves(defs_or_params):
        if isinstance(leaf, (ParamDef, torch.Tensor)):
            total += _numel(leaf.shape) * leaf.dtype.itemsize
    return total


def _path_leaves(tree, prefix: tuple):
    """(path, leaf) in ``jax.tree_util``'s order: a dict's keys sorted,
    a list's or tuple's items by index; None holds no leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _path_leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _path_leaves(v, prefix + (str(i),))
    else:
        yield prefix, tree


def flatten_with_paths(tree) -> list:
    """[(dot.path, leaf)] as the reference's
    ``repro.common.pytree.flatten_with_paths`` names them, in its order:
    a checkpoint of either package names its files alike."""
    return [(".".join(path), leaf) for path, leaf in _path_leaves(tree, ())]


def unflatten_like(like, leaves):
    """The tree of ``like`` with its leaves replaced, in
    ``flatten_with_paths`` order, by ``leaves``."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            vals = {k: build(node[k]) for k in sorted(node)}
            return {k: vals[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
