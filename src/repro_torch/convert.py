"""Carry the reference's objects across into the port's.

Each function reads its argument by attribute (or key) as numpy and
imports nothing of the JAX package, so a caller holding a
``repro.core.topology.Topology``, ``Schedule``, ``FabricParams`` or an
engine carry dict gets the port's equivalent, and the port and the
reference can be fed exactly the same scenario and the same mid-run state.
``dlrm_params_from_numpy`` and ``transformer_params_from_numpy`` do the
same for a DLRM's and a transformer's parameter trees.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.collectives import Schedule
from repro_torch.core.engine import FabricParams
from repro_torch.core.topology import Topology

_TOPO_ARRAYS = ("cap", "lat", "src_dev", "dst_dev", "ecn_on", "fabric",
                "link_class", "dev_is_switch", "dev_buf", "up_link")
_SCHED_ARRAYS = ("path", "n_hops", "size", "group", "dep", "delay")


def _np_tree(x):
    """Nested dict/list/tuple with array leaves -> the same with numpy
    leaves (any ``__array__`` leaf converts)."""
    if isinstance(x, dict):
        return {k: _np_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_np_tree(v) for v in x)
    if hasattr(x, "__array__") and not isinstance(x, np.ndarray):
        return np.asarray(x)
    return x


def topology_from_numpy(obj) -> Topology:
    return Topology(
        name=str(obj.name), n_devices=int(obj.n_devices),
        dev_name=list(obj.dev_name), n_gpus=int(obj.n_gpus),
        meta=_np_tree(dict(obj.meta)),
        **{k: np.array(getattr(obj, k)) for k in _TOPO_ARRAYS})


def schedule_from_numpy(obj) -> Schedule:
    return Schedule(n_groups=int(obj.n_groups),
                    group_names=list(obj.group_names),
                    **{k: np.array(getattr(obj, k)) for k in _SCHED_ARRAYS})


def fabric_params_from_numpy(obj) -> FabricParams:
    """Scalar leaves become Python floats, per-class leaves float32
    arrays."""
    out = {}
    for f in FabricParams.FIELDS:
        v = np.asarray(getattr(obj, f))
        out[f] = float(v) if v.ndim == 0 else v.astype(np.float32)
    return FabricParams(**out)


def cc_params(params: dict | None) -> dict | None:
    """CC parameters as plain Python floats."""
    if params is None:
        return None
    return {k: float(np.asarray(v)) for k, v in params.items()}


def carry_from_numpy(carry: dict, device="cpu") -> dict:
    """An engine carry dict (leaves anything ``np.asarray`` takes, nested
    ``cc`` dict included) -> the port's carry of tensors on ``device``."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        a = np.array(x)
        return torch.as_tensor(a, device=device)
    return {k: conv(v) for k, v in carry.items()}


def carry_to_numpy(carry: dict) -> dict:
    """The port's carry -> nested dict of numpy arrays."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return x.detach().cpu().numpy()
    return {k: conv(v) for k, v in carry.items()}


def _leaf_to_torch(a, device) -> torch.Tensor:
    """A numpy leaf -> tensor with the same bits.  bf16 leaves come out of
    JAX as the ``bfloat16`` extension dtype, which ``torch.from_numpy``
    rejects: they cross as their 16-bit patterns."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.array(a).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    if a.dtype != np.float32:
        raise TypeError(f"parameter of dtype {a.dtype}: expected "
                        "bfloat16 or float32")
    return torch.from_numpy(np.array(a)).to(device)


def dlrm_params_from_numpy(tree: dict, device="cuda") -> dict:
    """The reference's DLRM parameter tree (``{"tables", "bot": {...},
    "top": {...}}``, leaves anything ``np.asarray`` takes) -> the same tree
    of tensors on ``device``, bit for bit, for
    ``repro_torch.models.DLRM(cfg, params=...)``."""
    return {k: (dlrm_params_from_numpy(v, device) if isinstance(v, dict)
                else _leaf_to_torch(v, device))
            for k, v in tree.items()}


def transformer_params_from_numpy(tree, device="cuda"):
    """The reference's transformer parameter tree (``embed``,
    ``final_norm``, ``groups[i]["l{j}"]...``, ``lm_head``; dicts and lists,
    bf16 or float32 leaves anything ``np.asarray`` takes) -> the same tree
    of tensors on ``device``, bit for bit, for
    ``repro_torch.models.Model.prefill``/``decode_step``.  Every leaf
    crosses by its key, so the Gemma and Phi-4-mini trees come across
    whole: post-norms (``ln1_post``, ``ln2_post``), qk-norm (``q_norm``,
    ``k_norm``), GeGLU's ``w3`` and tied embeddings (no ``lm_head``)."""
    if isinstance(tree, dict):
        return {k: transformer_params_from_numpy(v, device)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [transformer_params_from_numpy(v, device) for v in tree]
    return _leaf_to_torch(tree, device)
