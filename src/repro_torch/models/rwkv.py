"""RWKV-6 "Finch" block (arXiv:2404.05892), port of ``repro/models/rwkv.py``:
attention-free time mixing with a data-dependent per-channel decay, and
squared-ReLU channel mixing.

Recurrence per head (state S: (d_k, d_v)):
    out_t = r_t . (S_t + diag(u) k_t^T v_t)
    S_t+1 = diag(w_t) S_t + k_t^T v_t
with w_t = exp(-exp(w0 + lora(x_t))) (the data-dependent decay).

Prefill: the token scan (the reference's ``lax.scan``, a Python loop
here), or the chunk-parallel form when ``cfg.rwkv_chunk`` divides S.
Decode: one recurrence step.  As in the reference, the r/k/v/g token-shift
lerps use static learned mixes (the decay keeps its data-dependent LoRA).

**Tensor-parallel** (``tp``, a live mesh's ``transformer.TP``, where
``d_model`` and ``d_ff`` divide over ``model``): the time mix's ``wr``,
``wk``, ``wv``, ``wg`` are this rank's column blocks and ``wo`` its row
block (a partial sum); the token-shift mixes, ``w0``, the decay LoRA and
the group norm's ``ln_scale``/``ln_bias`` are read through ``tp.rep`` on
this rank's columns.  Where the heads divide over ``model`` the WKV
recurrence (token scan or chunked) and the group norm run on this rank's
heads, with its block of ``u`` and of the state ``S``.  Where they do not
(RWKV-6-3B's 40 heads on 16, 160 columns a rank) the recurrence runs on
this rank's value columns, as the reference's GSPMD splits it: r, k and
the decay all-gathered, v and g this rank's columns, each column a head
of one value (``_column_wkv``; the whole state held, this rank's columns
of it updated), the group norm's per-head sums over ``model``.  The
channel mix's ``wk`` is column-parallel and ``wv`` row-parallel (their
product summed over ``model``), the receptance ``wr`` column-parallel
and its output all-gathered: the block's output is whole on every rank.

No kernel: the reference runs RWKV-6 as plain array code (no Pallas
kernel reaches it), and so does the port under either ``decode_impl``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common import comm
from repro_torch.common.pytree import ParamDef
from repro_torch.models.layers import silu

LORA_RANK = 64


def rwkv6_defs(cfg) -> dict:
    D = cfg.d_model
    H = cfg.n_heads
    dk = D // H
    return {
        "time": {
            "mu_r": ParamDef((D,), ("embed",), init="zeros"),
            "mu_k": ParamDef((D,), ("embed",), init="zeros"),
            "mu_v": ParamDef((D,), ("embed",), init="zeros"),
            "mu_w": ParamDef((D,), ("embed",), init="zeros"),
            "mu_g": ParamDef((D,), ("embed",), init="zeros"),
            "wr": ParamDef((D, D), ("embed", "heads"), init="scaled"),
            "wk": ParamDef((D, D), ("embed", "heads"), init="scaled"),
            "wv": ParamDef((D, D), ("embed", "heads"), init="scaled"),
            "wg": ParamDef((D, D), ("embed", "heads"), init="scaled"),
            "w0": ParamDef((D,), ("embed",), init="zeros"),
            "w_lora_a": ParamDef((D, LORA_RANK), ("embed", None), init="scaled"),
            "w_lora_b": ParamDef((LORA_RANK, D), (None, "embed"), init="zeros"),
            "u": ParamDef((H, dk), ("heads", None), init="zeros"),
            "ln_scale": ParamDef((D,), ("embed",), init="ones"),
            "ln_bias": ParamDef((D,), ("embed",), init="zeros"),
            "wo": ParamDef((D, D), ("heads", "embed"), init="scaled"),
        },
        "channel": {
            "mu_k": ParamDef((D,), ("embed",), init="zeros"),
            "mu_r": ParamDef((D,), ("embed",), init="zeros"),
            "wk": ParamDef((D, cfg.d_ff), ("embed", "mlp"), init="scaled"),
            "wv": ParamDef((cfg.d_ff, D), ("mlp", "embed"), init="scaled"),
            "wr": ParamDef((D, D), ("embed", "heads"), init="scaled"),
        },
    }


def _shift(x, prev_tok):
    """Token shift: x_{t-1}; prev_tok (B,D) seeds t=0 (the decode carry)."""
    if x.shape[1] == 1:
        return prev_tok[:, None]
    return torch.cat([prev_tok[:, None], x[:, :-1]], dim=1)


def _lerp(x, xs, mu):
    return x + (xs - x) * mu.to(x.dtype)


def heads_split(cfg, n: int) -> bool:
    """Whether the WKV recurrence runs on this rank's heads over ``n``
    ranks (else on this rank's value columns)."""
    return cfg.n_heads % n == 0


def _wkv(rh, kh, vh, wh, u, s0, Q: int):
    """The WKV recurrence over (B, S, H, d) inputs (v's last dim dv): the
    chunked form where ``Q`` divides S, else the token scan.  Returns (the
    final state (B, H, dk, dv), y (B, S, H, dv))."""
    S = rh.shape[1]
    if Q and S > Q and S % Q == 0:
        return _chunked_time_mix(rh, kh, vh, wh, u, s0, Q)
    S_c, outs = s0, []
    for t in range(S):
        r_t, k_t, v_t, w_t = rh[:, t], kh[:, t], vh[:, t], wh[:, t]
        kv = k_t[..., :, None] * v_t[..., None, :]           # (B,H,dk,dv)
        outs.append(torch.einsum("bhk,bhkv->bhv", r_t,
                                 S_c + u[None, :, :, None] * kv))
        S_c = w_t[..., :, None] * S_c + kv
    return S_c, torch.stack(outs, dim=1)


def _column_wkv(r, k, v, w, u, state, tp, H: int, dk: int, Q: int):
    """The recurrence on this rank's value columns (heads that do not
    divide over ``model``, as the reference's GSPMD splits it): each of
    its columns c (of head c // dk, value index c % dk) is a head of one
    value, r, k and the decay read whole.  r, k, w (B, S, D) whole; v
    (B, S, D_l) this rank's columns; ``state`` the whole (B, H, dk, dk)
    state or None.  Returns (the whole state with this rank's columns
    updated, y (B, S, D_l))."""
    B, S, D_l = v.shape
    cols = torch.arange(tp.i * D_l, (tp.i + 1) * D_l, device=v.device)
    head, vi = cols // dk, cols % dk

    def per_col(t):                                  # (B, S, D_l, dk)
        return t.reshape(B, S, H, dk).index_select(2, head)
    # a column's state S[:, head, :, vi] (as (H, dv, B, dk) rows)
    s0 = (v.new_zeros((B, D_l, dk, 1), dtype=torch.float32) if state is None
          else state.float().permute(1, 3, 0, 2)[head, vi].permute(
              1, 0, 2)[..., None])
    S_f, y = _wkv(per_col(r).float(), per_col(k).float(),
                  v.float()[..., None], per_col(w), u.float()[head], s0, Q)
    if state is not None:
        whole = state.float().clone()
        whole.permute(1, 3, 0, 2)[head, vi] = S_f[..., 0].permute(1, 0, 2)
        S_f = whole
    return S_f, y[..., 0]


def _column_group_norm(y, tp, H: int, dk: int):
    """The per-head group norm of this rank's value columns y (B, S,
    D_l): each head's mean and variance summed over ``model`` (the
    reference's two all-reduces)."""
    B, S, D_l = y.shape
    head = torch.arange(tp.i * D_l, (tp.i + 1) * D_l, device=y.device) // dk

    def head_sum(t):                                 # (B, S, H) over model
        out = t.new_zeros((B, S, H)).index_add(2, head, t)
        return tp.sum(out)
    mu_ = head_sum(y).index_select(2, head) / dk
    var = head_sum(torch.square(y - mu_)).index_select(2, head) / dk
    return (y - mu_) * torch.rsqrt(var + 64e-5)


def rwkv6_time_mix(p, x, cfg, state, tp=None):
    """x: (B,S,D); state: {"S": (B,H,dk,dv), "tok": (B,D)} or None.
    Returns (out, new_state).  Under ``tp`` (the module docstring) ``p``
    holds this rank's blocks and ``out`` is a partial sum."""
    B, S, D = x.shape
    H = cfg.n_heads
    dk = D // H
    prev = (x.new_zeros((B, D)) if state is None
            else state["tok"].to(x.dtype))
    xs = _shift(x, prev)
    mode = "whole"
    if tp is not None:
        p = dict(p, **{k: tp.rep(p[k]) for k in (
            "mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "w0", "w_lora_a",
            "w_lora_b", "ln_scale", "ln_bias")})
        for k in ("ln_scale", "ln_bias", "w0", "w_lora_b"):
            p[k] = tp.cols(p[k])
        if heads_split(cfg, tp.n):         # this rank's heads
            mode = "heads"
        else:                              # this rank's value columns
            mode = "columns"
            p["u"] = tp.rep(p["u"])

    r = _lerp(x, xs, p["mu_r"]) @ p["wr"].to(x.dtype)
    k = _lerp(x, xs, p["mu_k"]) @ p["wk"].to(x.dtype)
    v = _lerp(x, xs, p["mu_v"]) @ p["wv"].to(x.dtype)
    g = _lerp(x, xs, p["mu_g"]) @ p["wg"].to(x.dtype)
    xw = _lerp(x, xs, p["mu_w"])
    w_log = (p["w0"].float()
             + torch.tanh(xw.float() @ p["w_lora_a"].float())
             @ p["w_lora_b"].float())
    w = torch.exp(-torch.exp(w_log))  # (B,S,D) in (0,1)
    s_in = None if state is None else state["S"]

    if mode == "columns":
        S_f, y = _column_wkv(tp.gather(r), tp.gather(k), v, tp.gather(w),
                             p["u"], s_in, tp, H, dk, cfg.rwkv_chunk)
        y = _column_group_norm(y, tp, H, dk)
    else:
        H = r.shape[-1] // dk
        shape = (B, S, H, dk)
        s0 = (x.new_zeros((B, H, dk, dk), dtype=torch.float32)
              if s_in is None else s_in.float())
        S_f, y = _wkv(r.reshape(shape).float(), k.reshape(shape).float(),
                      v.reshape(shape).float(), w.reshape(shape),
                      p["u"].float(), s0, cfg.rwkv_chunk)
        # per-head group norm
        mu_ = y.mean(-1, keepdim=True)
        var = y.var(-1, keepdim=True, unbiased=False)
        y = ((y - mu_) * torch.rsqrt(var + 64e-5)).reshape(B, S, H * dk)
    y = y * p["ln_scale"].float() + p["ln_bias"].float()
    y = y.to(x.dtype) * silu(g)
    out = y @ p["wo"].to(x.dtype)
    return out, {"S": S_f, "tok": x[:, -1].float()}


def _chunked_time_mix(rh, kh, vh, wh, u, s0, Q: int):
    """Chunk-parallel RWKV-6 (GLA-style): a loop over S/Q chunks with the
    within-chunk parallel form.  Every decay exponent is relative
    (la_{t-1} - la_s <= 0 for s < t; la_Q - la_s <= 0), so everything is
    bounded.  Returns (final state, y (B,S,H,dk))."""
    B, S, H, dk = rh.shape
    mask = (torch.arange(Q, device=rh.device)[:, None]
            > torch.arange(Q, device=rh.device)[None, :])
    S_c, ys = s0, []
    for c in range(S // Q):
        r, k, v, w = (a[:, c * Q:(c + 1) * Q] for a in (rh, kh, vh, wh))
        la = torch.cumsum(torch.log(torch.clamp_min(w, 1e-30)), dim=1)
        la_prev = torch.cat([torch.zeros_like(la[:, :1]), la[:, :-1]], dim=1)
        # inter-chunk: r_t decayed against the incoming state
        q_eff = r * torch.exp(la_prev)
        y_inter = torch.einsum("bthd,bhdv->bthv", q_eff, S_c)
        # intra-chunk: scores[t,s] = sum_d r_t k_s exp(la_prev_t - la_s), s<t
        E = torch.exp(torch.clamp(la_prev[:, :, None] - la[:, None, :],
                                  -60.0, 0.0))
        M = torch.einsum("bthd,bshd,btshd->bths", r, k, E)
        M = M * mask[None, :, None, :]                  # M: (B, t, H, s)
        y_intra = torch.einsum("bths,bshv->bthv", M, v)
        # diagonal bonus: (r_t . (u * k_t)) v_t
        bonus = torch.einsum("bthd,bthd->bth", r, u[None, None] * k)
        ys.append(y_inter + y_intra + bonus[..., None] * v)
        # state to the end of the chunk
        decay_end = torch.exp(la[:, -1][:, None] - la)         # <= 1
        S_c = (S_c * torch.exp(la[:, -1])[..., None]
               + torch.einsum("bshd,bshv->bhdv", k * decay_end, v))
    return S_c, torch.cat(ys, dim=1)


def rwkv6_channel_mix(p, x, cfg, state, tp=None):
    """Squared-ReLU channel mixing; state: {"tok": (B,D)} or None.  Under
    ``tp`` (the module docstring) ``p`` holds this rank's blocks; the
    output is whole on every rank."""
    B, S, D = x.shape
    prev = (x.new_zeros((B, D)) if state is None
            else state["tok"].to(x.dtype))
    xs = _shift(x, prev)
    if tp is not None:
        p = dict(p, mu_k=tp.rep(p["mu_k"]), mu_r=tp.rep(p["mu_r"]))
    kx = _lerp(x, xs, p["mu_k"])
    rx = _lerp(x, xs, p["mu_r"])
    k = torch.square(F.relu(kx @ p["wk"].to(x.dtype)))
    r = rx @ p["wr"].to(x.dtype)
    kv = k @ p["wv"].to(x.dtype)
    if tp is not None:
        r = comm.all_gather(r, tp.mesh, "model", dim=r.dim() - 1)
        kv = comm.psum(kv, tp.mesh, "model")
    out = torch.sigmoid(r) * kv
    return out, {"tok": x[:, -1].float()}


def rwkv6_state_defs(cfg, batch: int) -> dict:
    D = cfg.d_model
    H = cfg.n_heads
    dk = D // H
    return {
        "time": {
            "S": ParamDef((batch, H, dk, dk), ("batch", "heads", None, None), init="zeros"),
            "tok": ParamDef((batch, D), ("batch", "embed"), init="zeros"),
        },
        "channel": {
            "tok": ParamDef((batch, D), ("batch", "embed"), init="zeros"),
        },
    }
