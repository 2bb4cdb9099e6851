"""Mixture-of-Experts FFN (DeepSeek-style: shared + routed top-k), port of
``repro/models/moe.py`` for one device.

The reference has three implementations (``cfg.moe_impl``): ``dense``
(every expert computed for every token, combined by gate weights),
``tp`` and ``ep_a2a`` (experts over a device mesh, capacity dispatch by a
local scatter or by all-to-all).  Without a mesh it takes the dense path
whatever ``moe_impl`` says, so DeepSeek's ``ep_a2a`` serves densely on
one device there; the port does the same.  A mesh raises
``NotImplementedError``: the mesh bodies come with ROADMAP.md queue item
9.8.  The dense path computes all E experts for every token, E / top_k
times the routed work (the reference's single-device semantics).

Token-choice top-k routing in float32 (softmax, top-k, gates renormalised
over the kept top-k).  The capacity helpers ``_positions``,
``_scatter_slots`` and ``_gather_slots`` (GShard dispatch slot by slot,
never a (T * k, D) repeat) are ported for the mesh bodies to come.

No kernel: the reference runs the MoE as plain array code (no Pallas
kernel reaches it), under either ``decode_impl``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common.pytree import ParamDef
from repro_torch.models.layers import silu

_MESH = ("MoE over a device mesh (moe_impl 'tp' or 'ep_a2a' bodies) comes "
         "with ROADMAP.md queue item 9.8")


def moe_defs(cfg) -> dict:
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    d = {
        "router": ParamDef((D, E), ("embed", None), init="scaled"),
        "w1": ParamDef((E, D, Fd), ("expert", "embed", "mlp"), init="scaled"),
        "w3": ParamDef((E, D, Fd), ("expert", "embed", "mlp"), init="scaled"),
        "w2": ParamDef((E, Fd, D), ("expert", "mlp", "embed"), init="scaled"),
    }
    if cfg.n_shared_experts:
        Fs = cfg.moe_d_ff * cfg.n_shared_experts
        d["shared"] = {
            "w1": ParamDef((D, Fs), ("embed", "mlp"), init="scaled"),
            "w3": ParamDef((D, Fs), ("embed", "mlp"), init="scaled"),
            "w2": ParamDef((Fs, D), ("mlp", "embed"), init="scaled"),
        }
    return d


def _router(router_w, x, cfg):
    """x: (T, D) -> (gates, idx): (T, k).  Float32 routing."""
    logits = (x.float() @ router_w.float()) * cfg.router_scale
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return gates, idx


def _expert_ffn(w1, w3, w2, xb):
    """xb: (E_loc, C, D); weights (E_loc, D, F) / (E_loc, F, D)."""
    h = torch.einsum("ecd,edf->ecf", xb, w1.to(xb.dtype))
    g = torch.einsum("ecd,edf->ecf", xb, w3.to(xb.dtype))
    h = silu(h) * g
    return torch.einsum("ecf,efd->ecd", h, w2.to(xb.dtype))


def _shared_ffn(p, x):
    h = silu(x @ p["w1"].to(x.dtype)) * (x @ p["w3"].to(x.dtype))
    return h @ p["w2"].to(x.dtype)


# ---------------------------------------------------------------------------
# slot-wise capacity dispatch helpers
# ---------------------------------------------------------------------------

def _positions(idx2d, keep2d, n_buckets: int, cap: int):
    """Per-(token, slot) position within its destination bucket, in
    row-major arrival order.  idx2d/keep2d: (T, k) -> (pos2d, kept2d)."""
    T, k = idx2d.shape
    keep = keep2d.reshape(-1)
    oh = F.one_hot(idx2d.reshape(-1).long(), n_buckets) * keep.long()[:, None]
    pre = torch.cumsum(oh, dim=0) - oh
    pos = (pre * oh).sum(-1)
    kept = keep & (pos < cap)
    return pos.reshape(T, k), kept.reshape(T, k)


def _scatter_slots(x, idx2d, pos2d, kept2d, n_buckets: int, cap: int):
    """k scatters of (T, D) rows into (n_buckets, cap, D), no (T * k, D);
    rows whose position falls outside the buffer are dropped (the
    reference's ``mode="drop"``)."""
    buf = x.new_zeros((n_buckets, cap, x.shape[-1]))
    for j in range(idx2d.shape[1]):
        e, pos = idx2d[:, j].long(), pos2d[:, j].long()
        inside = (e >= 0) & (e < n_buckets) & (pos >= 0) & (pos < cap)
        rows = x * kept2d[:, j, None].to(x.dtype)
        buf.index_put_((e[inside], pos[inside]), rows[inside], accumulate=True)
    return buf


def _gather_slots(y, idx2d, pos2d, kept2d, gates):
    """Inverse of ``_scatter_slots``, weighted by gates: (T, D).  An index
    outside ``y`` reads its nearest row (the reference's clamped gather);
    such a slot is never kept, so its weight is 0."""
    out = y.new_zeros((idx2d.shape[0], y.shape[-1]))
    for j in range(idx2d.shape[1]):
        w = (kept2d[:, j].to(y.dtype) * gates[:, j].to(y.dtype))[:, None]
        e = idx2d[:, j].long().clamp(0, y.shape[0] - 1)
        pos = pos2d[:, j].long().clamp(0, y.shape[1] - 1)
        out = out + y[e, pos] * w
    return out


# ---------------------------------------------------------------------------
# the dense path
# ---------------------------------------------------------------------------

def _moe_dense(p, x, cfg):
    gates, idx = _router(p["router"], x, cfg)
    h = torch.einsum("td,edf->tef", x, p["w1"].to(x.dtype))
    g = torch.einsum("td,edf->tef", x, p["w3"].to(x.dtype))
    y = torch.einsum("tef,efd->ted", silu(h) * g, p["w2"].to(x.dtype))
    sel = torch.take_along_dim(y, idx[:, :, None], dim=1)    # (T, k, D)
    return (sel * gates[:, :, None].to(x.dtype)).sum(1)


def _moe_chunked(fn, x2d, cfg):
    """Tokens through ``fn`` in ``cfg.moe_chunks`` microchunks, to bound
    the dispatch buffers; the count halves until it divides the tokens
    (one device: no token-sharding factor)."""
    n = cfg.moe_chunks
    T = x2d.shape[0]
    while n > 1 and T % n != 0:
        n //= 2
    if n <= 1:
        return fn(x2d)
    return torch.cat([fn(xc) for xc in x2d.reshape(n, T // n, -1)])


def moe_apply(p, x2d, cfg, mesh=None):
    """x2d: (T, D) -> (T, D).  Routed experts (the dense path) plus the
    shared experts."""
    if mesh is not None:
        raise NotImplementedError(_MESH)
    if cfg.moe_impl not in ("tp", "ep_a2a", "dense"):
        raise ValueError(f"unknown moe_impl {cfg.moe_impl}")
    routed = _moe_chunked(lambda xs: _moe_dense(p, xs, cfg), x2d, cfg)
    if cfg.n_shared_experts:
        routed = routed + _shared_ffn(p["shared"], x2d)
    return routed
