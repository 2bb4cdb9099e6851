"""Mamba-2 block (SSD, arXiv:2405.21060), port of ``repro/models/ssm.py``.

Prefill: the "minimal SSD" chunked algorithm, quadratic within a chunk and
linear state passing between chunks (the reference's ``lax.scan`` over
chunks is a Python loop here).  Decode: the exact single-step recurrence
on (conv_state, ssm_state).

No kernel: the reference runs Mamba-2 as plain array code (no Pallas
kernel reaches it), and so does the port under either ``decode_impl``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common.pytree import ParamDef
from repro_torch.models.layers import rmsnorm_apply, silu


def mamba2_defs(cfg) -> dict:
    D = cfg.d_model
    Din = cfg.d_inner
    ds = cfg.ssm_state
    nh = cfg.ssm_nheads
    k = cfg.ssm_conv
    conv_dim = Din + 2 * ds  # x + B + C (single group)
    return {
        # in_proj -> [z (Din), x (Din), B (ds), C (ds), dt (nh)]
        "w_in": ParamDef((D, 2 * Din + 2 * ds + nh), ("embed", "mlp"), init="scaled"),
        "conv_w": ParamDef((k, conv_dim), (None, "mlp"), init="scaled"),
        "conv_b": ParamDef((conv_dim,), ("mlp",), init="zeros"),
        "A_log": ParamDef((nh,), (None,), init="zeros"),
        "dt_bias": ParamDef((nh,), (None,), init="zeros"),
        "D_skip": ParamDef((nh,), (None,), init="ones"),
        "out_norm": {"scale": ParamDef((Din,), ("mlp",), init="zeros")},
        "w_out": ParamDef((Din, D), ("mlp", "embed"), init="scaled"),
    }


def _split_proj(cfg, zxbcdt):
    Din, ds = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :Din]
    xbc = zxbcdt[..., Din:Din + Din + 2 * ds]
    dt = zxbcdt[..., Din + Din + 2 * ds:]
    return z, xbc, dt


def _causal_conv(xbc, w, b, state=None):
    """Depthwise causal conv1d of kernel k.  xbc: (B,S,C); state: (B,k-1,C),
    the last k-1 inputs before xbc (zeros when None).  Returns (silu(conv
    + b), the new state)."""
    k = w.shape[0]
    S = xbc.shape[1]
    pad = (torch.zeros_like(xbc[:, :k - 1]) if state is None
           else state.to(xbc.dtype))
    xp = torch.cat([pad, xbc], dim=1)
    out = sum(xp[:, i:i + S] * w[i].to(xbc.dtype) for i in range(k))
    new_state = (xp[:, -(k - 1):] if k > 1
                 else xbc.new_zeros((xbc.shape[0], 0, xbc.shape[2])))
    return silu(out + b.to(xbc.dtype)), new_state


def _ssd_chunked(xh, dt, A, Bc, Cc, cfg, init_state=None):
    """SSD chunk scan.

    xh: (B,S,nh,hd); dt: (B,S,nh) (post-softplus); A: (nh,) negative;
    Bc/Cc: (B,S,ds).  Returns (y: (B,S,nh,hd), final_state:
    (B,nh,ds,hd) float32)."""
    Bsz, S, nh, hd = xh.shape
    ds = Bc.shape[-1]
    Q = min(cfg.ssm_chunk, S)
    S_orig = S
    pad = (-S) % Q
    if pad:  # zero-pad: dt = 0 on pads => identity state transition
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bc = F.pad(Bc, (0, 0, 0, pad))
        Cc = F.pad(Cc, (0, 0, 0, pad))
        S = S + pad
    C = S // Q

    xq = xh.reshape(Bsz, C, Q, nh, hd).float()
    dtq = dt.reshape(Bsz, C, Q, nh).float()
    Bq = Bc.reshape(Bsz, C, Q, ds).float()
    Cq = Cc.reshape(Bsz, C, Q, ds).float()

    dA = dtq * A[None, None, None, :]                      # (B,C,Q,nh) negative
    dA_cum = torch.cumsum(dA, dim=2)                       # within-chunk cumsum

    # within-chunk (quadratic in Q): L[i,j] = exp(dA_cum_i - dA_cum_j), j<=i
    diff = dA_cum[:, :, :, None, :] - dA_cum[:, :, None, :, :]   # (B,C,Q,Q,nh)
    ii = torch.arange(Q, device=xh.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    Lm = torch.where(causal, torch.exp(diff), 0.0)
    sc = torch.einsum("bcqs,bcks->bcqk", Cq, Bq)
    M = sc[..., None] * Lm                                 # (B,C,Q,Q,nh)
    y_diag = torch.einsum("bcqkh,bckhe,bckh->bcqhe", M, xq, dtq)

    # chunk states: S_c = sum_j exp(dA_cum_Q - dA_cum_j) * dt_j * B_j x_j^T
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)   # (B,C,Q,nh)
    states = torch.einsum("bcqh,bcqh,bcqs,bcqhe->bchse",
                          decay_to_end, dtq, Bq, xq)
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])           # (B,C,nh)

    s_prev = (xh.new_zeros((Bsz, nh, ds, hd), dtype=torch.float32)
              if init_state is None else init_state.float())
    s_prevs = []
    for c in range(C):
        s_prevs.append(s_prev)
        s_prev = s_prev * chunk_decay[:, c, :, None, None] + states[:, c]
    s_prevs = torch.stack(s_prevs, dim=1)                  # (B,C,nh,ds,hd)

    # inter-chunk contribution: y_off = C_i . exp(dA_cum_i) S_prev
    y_off = torch.einsum("bcqs,bcqh,bchse->bcqhe", Cq, torch.exp(dA_cum),
                         s_prevs)
    y = (y_diag + y_off).reshape(Bsz, S, nh, hd)[:, :S_orig]
    return y.to(xh.dtype), s_prev


def mamba2_apply(p, x, cfg, state=None):
    """x: (B,S,D) -> (B,S,D).  ``state``: None, or {"conv", "ssm"} to
    carry (decode; a zeroed one in prefill).  Returns (y, new_state)."""
    Bsz, S, _ = x.shape
    nh, hd, ds = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    zxbcdt = x @ p["w_in"].to(x.dtype)
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    conv_state = None if state is None else state["conv"]
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xs = xbc[..., :cfg.d_inner].reshape(Bsz, S, nh, hd)
    Bc = xbc[..., cfg.d_inner:cfg.d_inner + ds]
    Cc = xbc[..., cfg.d_inner + ds:]
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    if S == 1:  # decode: exact single-step recurrence
        s_prev = (x.new_zeros((Bsz, nh, ds, hd), dtype=torch.float32)
                  if state is None else state["ssm"].float())
        dA = torch.exp(dt[:, 0] * A[None, :])                     # (B,nh)
        dBx = torch.einsum("bh,bs,bhe->bhse", dt[:, 0], Bc[:, 0].float(),
                           xs[:, 0].float())
        s_new = s_prev * dA[..., None, None] + dBx
        y = torch.einsum("bs,bhse->bhe", Cc[:, 0].float(), s_new)
        y = y[:, None].to(x.dtype)
        final = s_new
    else:
        init = None if state is None else state["ssm"]
        y, final = _ssd_chunked(xs, dt, A, Bc, Cc, cfg, init)

    y = y + xs * p["D_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(Bsz, S, cfg.d_inner)
    y = rmsnorm_apply(p["out_norm"], y) * silu(z)
    out = y @ p["w_out"].to(x.dtype)
    return out, {"conv": new_conv.float(), "ssm": final}


def mamba2_state_defs(cfg, batch: int) -> dict:
    """The decode state's shapes (float32 zeros)."""
    k = cfg.ssm_conv
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": ParamDef((batch, k - 1, conv_dim), ("batch", None, "mlp"), init="zeros"),
        "ssm": ParamDef((batch, cfg.ssm_nheads, cfg.ssm_state, cfg.ssm_headdim),
                        ("batch", None, None, None), init="zeros"),
    }
