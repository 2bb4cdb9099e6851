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

No kernel: the reference runs RWKV-6 as plain array code (no Pallas
kernel reaches it), and so does the port under either ``decode_impl``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


def rwkv6_time_mix(p, x, cfg, state):
    """x: (B,S,D); state: {"S": (B,H,dk,dv), "tok": (B,D)} or None.
    Returns (out, new_state)."""
    B, S, D = x.shape
    H = cfg.n_heads
    dk = D // H
    prev = (x.new_zeros((B, D)) if state is None
            else state["tok"].to(x.dtype))
    xs = _shift(x, prev)

    r = _lerp(x, xs, p["mu_r"]) @ p["wr"].to(x.dtype)
    k = _lerp(x, xs, p["mu_k"]) @ p["wk"].to(x.dtype)
    v = _lerp(x, xs, p["mu_v"]) @ p["wv"].to(x.dtype)
    g = _lerp(x, xs, p["mu_g"]) @ p["wg"].to(x.dtype)
    xw = _lerp(x, xs, p["mu_w"])
    w_log = (p["w0"].float()
             + torch.tanh(xw.float() @ p["w_lora_a"].float())
             @ p["w_lora_b"].float())
    w = torch.exp(-torch.exp(w_log))  # (B,S,D) in (0,1)

    rh = r.reshape(B, S, H, dk).float()
    kh = k.reshape(B, S, H, dk).float()
    vh = v.reshape(B, S, H, dk).float()
    wh = w.reshape(B, S, H, dk)
    u = p["u"].float()

    s0 = (x.new_zeros((B, H, dk, dk), dtype=torch.float32) if state is None
          else state["S"].float())

    Q = cfg.rwkv_chunk
    if Q and S > Q and S % Q == 0:
        S_f, y = _chunked_time_mix(rh, kh, vh, wh, u, s0, Q)
    else:
        S_c, outs = s0, []
        for t in range(S):
            r_t, k_t, v_t, w_t = rh[:, t], kh[:, t], vh[:, t], wh[:, t]
            kv = k_t[..., :, None] * v_t[..., None, :]           # (B,H,dk,dv)
            outs.append(torch.einsum("bhk,bhkv->bhv", r_t,
                                     S_c + u[None, :, :, None] * kv))
            S_c = w_t[..., :, None] * S_c + kv
        S_f, y = S_c, torch.stack(outs, dim=1)

    # per-head group norm
    yh = y.reshape(B, S, H, dk)
    mu_ = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, unbiased=False)
    yh = (yh - mu_) * torch.rsqrt(var + 64e-5)
    y = yh.reshape(B, S, D) * p["ln_scale"].float() + p["ln_bias"].float()
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


def rwkv6_channel_mix(p, x, cfg, state):
    """Squared-ReLU channel mixing; state: {"tok": (B,D)} or None."""
    B, S, D = x.shape
    prev = (x.new_zeros((B, D)) if state is None
            else state["tok"].to(x.dtype))
    xs = _shift(x, prev)
    kx = _lerp(x, xs, p["mu_k"])
    rx = _lerp(x, xs, p["mu_r"])
    k = torch.square(F.relu(kx @ p["wk"].to(x.dtype)))
    out = torch.sigmoid(rx @ p["wr"].to(x.dtype)) * (k @ p["wv"].to(x.dtype))
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
