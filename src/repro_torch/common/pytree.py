"""Declarative parameter trees (port of ``repro/common/pytree.py``).

A model declares its parameters once as a tree (nested dicts and lists)
of :class:`ParamDef` leaves; ``materialize`` turns the tree into the same
tree of tensors, drawn by the rules of ``common/init.py``.  The sharding
side of the reference (``specs_of``, ``abstract``) comes with the mesh.
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
