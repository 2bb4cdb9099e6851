"""Mixture-of-Experts FFN (DeepSeek-style: shared + routed top-k), port
of ``repro/models/moe.py``.

Three implementations (``cfg.moe_impl``), as in the reference:

* ``dense``  -- every expert computed for every token, combined by gate
  weights: E / top_k times the routed work.  Without a mesh, or on a mesh
  with no ``model`` axis, the reference takes this path whatever
  ``moe_impl`` says (the reference's ``models/moe.py:201``); so does the port.
* ``tp``     -- experts sharded over ``model``, tokens replicated over it:
  a local capacity scatter on each rank, the combine a ``psum`` over
  ``model`` (``_moe_tp_local``).
* ``ep_a2a`` -- experts sharded over ``data`` (the token axis) and their
  d_ff over ``model``: dispatch and combine each one tiled
  ``all_to_all`` over ``data`` (with the expert ids riding along in a
  second one), the experts' partial outputs summed over ``model``
  (``_moe_ep_local``): the All-To-All traffic the paper studies.

The mesh bodies are the reference's ``shard_map`` bodies run by every
rank of a live mesh (``repro_torch.launch.mesh``) on its own tokens and
expert shards, their collectives through ``repro_torch.common.comm``.
Token-choice top-k routing in float32 (softmax, top-k, gates
renormalised over the kept top-k); per-expert capacity drops as GShard's
(``_positions``, ``_scatter_slots``, ``_gather_slots``: slot by slot,
never a (T * k, D) repeat).  Inside ``with count_dropped() as d`` the
mesh bodies add the slots they drop (at dispatch and, under ``ep_a2a``,
at the receiving rank's expert buffers) to ``d``, on the device; outside
one they count nothing.

One departure: ``cfg.moe_chunks`` splits each rank's own tokens on a
mesh, where the reference splits the global token array and each chunk
then over the ranks.  Without drops the two compute the same function;
with drops, only ``moe_chunks=1`` drops exactly the reference's slots.

No kernel: the reference runs the MoE as plain array code (no Pallas
kernel reaches it).
"""
from __future__ import annotations

import contextvars

import torch
import torch.nn.functional as F

from repro_torch.common import comm
from repro_torch.common.pytree import ParamDef
from repro_torch.models.layers import silu

_DROPS: contextvars.ContextVar = contextvars.ContextVar("moe_drops",
                                                        default=None)


class count_dropped:
    """``with count_dropped() as d:`` the slots the mesh bodies drop in
    the block, summed on the device (no host sync a call); ``int(d)``
    reads them once, after the run."""

    def __init__(self):
        self.slots = None
        self._token = None

    def add(self, lost: torch.Tensor) -> None:
        n = lost.sum()
        self.slots = n if self.slots is None else self.slots + n

    def __int__(self) -> int:
        return 0 if self.slots is None else int(self.slots)

    def __enter__(self):
        self._token = _DROPS.set(self)
        return self

    def __exit__(self, *exc):
        _DROPS.reset(self._token)


def _count_dropped(lost: torch.Tensor) -> None:
    counter = _DROPS.get()
    if counter is not None:
        counter.add(lost)


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


# ---------------------------------------------------------------------------
# TP MoE: experts over "model", tokens replicated over "model"
# ---------------------------------------------------------------------------

def _moe_tp_local(router_w, w1, w3, w2, x, *, cfg, n_model, mesh):
    """Per-rank body.  x: (T_loc, D) replicated over ``model``; w*: this
    rank's expert slices (E_loc, ...)."""
    E = cfg.n_experts
    E_loc = E // n_model
    my = comm.axis_index(mesh, "model")
    gates, idx = _router(router_w, x, cfg)   # full-E routing, alike on ranks
    mine = (idx >= my * E_loc) & (idx < (my + 1) * E_loc)
    e_local = torch.clamp(idx - my * E_loc, 0, E_loc - 1)
    Tk = idx.numel()
    cap = max(1, int(cfg.capacity_factor * Tk / max(n_model * E_loc, 1)))
    pos, kept = _positions(e_local, mine, E_loc, cap)
    _count_dropped(mine & ~kept)
    buf = _scatter_slots(x, e_local, pos, kept, E_loc, cap)
    y = _expert_ffn(w1, w3, w2, buf)
    out = _gather_slots(y, e_local, pos, kept, gates)
    return comm.psum(out, mesh, "model")


# ---------------------------------------------------------------------------
# EP MoE: experts over "data", dispatch via all_to_all
# ---------------------------------------------------------------------------

def _add_meta(meta, dst, pos, vals):
    """``meta.at[dst, pos].add(vals, mode="drop")``: out-of-range slots
    dropped."""
    n, cap = meta.shape
    inside = (dst >= 0) & (dst < n) & (pos >= 0) & (pos < cap)
    meta.index_put_((dst[inside].long(), pos[inside].long()),
                    vals[inside].to(meta.dtype), accumulate=True)


def _moe_ep_local(router_w, w1, w3, w2, x, *, cfg, n_data, mesh):
    """Per-rank body.  x: (T_loc, D), this rank's tokens; experts sharded
    over ``data`` (E_loc a rank), their d_ff over ``model`` (a ``psum``
    combines).  Dispatch and combine are each one tiled ``all_to_all``
    over ``data``."""
    E = cfg.n_experts
    E_loc = E // n_data
    D = x.shape[-1]
    gates, idx = _router(router_w, x, cfg)
    dst = idx // E_loc                        # destination data rank (T, k)
    Tk = idx.numel()
    cap = max(1, int(cfg.capacity_factor * Tk / n_data))
    pos, kept = _positions(dst, torch.ones_like(dst, dtype=torch.bool),
                           n_data, cap)
    send = _scatter_slots(x, dst, pos, kept, n_data, cap)
    # metadata rides along: the local expert id at the destination, + 1 so
    # that empty slots (0) mark invalid rows after the exchange
    meta = torch.zeros((n_data, cap), dtype=torch.int32, device=x.device)
    for j in range(idx.shape[1]):
        _add_meta(meta, dst[:, j], pos[:, j],
                  torch.where(kept[:, j], idx[:, j] % E_loc + 1, 0))
    recv = comm.all_to_all(send, mesh, "data")
    meta_r = comm.all_to_all(meta, mesh, "data")

    rows = recv.reshape(-1, D)                       # (n_data * cap, D)
    e_of_row = meta_r.reshape(-1)                    # 0 empty, else e + 1
    valid = (e_of_row > 0)[:, None]
    e_row = torch.clamp(e_of_row - 1, 0, E_loc - 1)[:, None]
    cap2 = max(1, int(cfg.capacity_factor * rows.shape[0] / max(E_loc, 1)))
    pos2, kept2 = _positions(e_row, valid, E_loc, cap2)
    _count_dropped(~kept)
    _count_dropped(valid & ~kept2)
    buf = _scatter_slots(rows, e_row, pos2, kept2, E_loc, cap2)
    y = _expert_ffn(w1, w3, w2, buf)                 # partial over model
    y = comm.psum(y, mesh, "model")
    ones = torch.ones((rows.shape[0], 1), dtype=y.dtype, device=y.device)
    back_rows = _gather_slots(y, e_row, pos2, kept2, ones)
    back = back_rows.reshape(n_data, cap, D)
    ret = comm.all_to_all(back, mesh, "data")
    return _gather_slots(ret, dst, pos, kept, gates)


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def _moe_chunked(fn, x2d, cfg):
    """Tokens through ``fn`` in ``cfg.moe_chunks`` microchunks, to bound
    the dispatch buffers; the count halves until it divides the tokens
    (on a mesh: this rank's tokens, so every rank runs as many chunks)."""
    n = cfg.moe_chunks
    T = x2d.shape[0]
    while n > 1 and T % n != 0:
        n //= 2
    if n <= 1:
        return fn(x2d)
    return torch.cat([fn(xc) for xc in x2d.reshape(n, T // n, -1)])


# the layout each mesh body reads its expert weights in (leading layers
# dim of the stacked tree excluded)
BODY_SPECS = {"tp": {"w1": ("model",), "w3": ("model",), "w2": ("model",)},
              "ep_a2a": {"w1": ("data", None, "model"),
                         "w3": ("data", None, "model"),
                         "w2": ("data", "model")}}


def uses_mesh(cfg, mesh) -> bool:
    """Whether ``moe_apply`` runs a mesh body (else the dense path)."""
    return (mesh is not None and cfg.moe_impl != "dense"
            and "model" in mesh.axis_names)


def moe_apply(p, x2d, cfg, mesh=None):
    """x2d: (T, D) -> (T, D): routed experts plus the shared experts.  On
    a live mesh with a ``model`` axis (``tp``, ``ep_a2a``): this rank's
    tokens, and ``p``'s ``w1``/``w3``/``w2`` this rank's expert shards in
    the ``BODY_SPECS`` layout."""
    impl = cfg.moe_impl
    if impl not in ("tp", "ep_a2a", "dense"):
        raise ValueError(f"unknown moe_impl {impl}")
    if not uses_mesh(cfg, mesh):
        routed = _moe_chunked(lambda xs: _moe_dense(p, xs, cfg), x2d, cfg)
    elif not mesh.is_live:
        raise ValueError(f"moe_impl {impl!r} over {mesh} runs on a live "
                         "mesh (repro_torch.launch.mesh)")
    elif impl == "tp":
        def fn(xs):
            return _moe_tp_local(p["router"], p["w1"], p["w3"], p["w2"], xs,
                                 cfg=cfg, n_model=mesh.shape["model"],
                                 mesh=mesh)
        routed = _moe_chunked(fn, x2d, cfg)
    else:
        def fn(xs):
            return _moe_ep_local(p["router"], p["w1"], p["w3"], p["w2"], xs,
                                 cfg=cfg, n_data=mesh.shape["data"],
                                 mesh=mesh)
        routed = _moe_chunked(fn, x2d, cfg)
    if cfg.n_shared_experts:
        routed = routed + _shared_ffn(p["shared"], x2d)
    return routed


def moe_param_overrides(cfg) -> dict | None:
    """Sharding-rule overrides the chosen impl needs (``ep_a2a``: the
    expert dim over ``data``, its d_ff over ``model``)."""
    if cfg.moe_impl == "ep_a2a":
        return {"expert": ("data",)}
    return None
