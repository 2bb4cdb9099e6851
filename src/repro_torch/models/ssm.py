"""Mamba-2 block (SSD, arXiv:2405.21060), port of ``repro/models/ssm.py``.

Prefill: the "minimal SSD" chunked algorithm, quadratic within a chunk and
linear state passing between chunks (the reference's ``lax.scan`` over
chunks is a Python loop here).  Decode: the exact single-step recurrence
on (conv_state, ssm_state).

**Tensor-parallel** (``tp``, a live mesh's ``transformer.TP``, where the
heads, ``d_inner`` and the conv channels divide over ``model``): ``w_in``
is this rank's column block and ``w_out`` its row block, ``conv_w``,
``conv_b`` and ``out_norm.scale`` blocks over ``mlp``.  The projection's
columns ``[z | x | B | C | dt]`` are all-gathered (the reference's GSPMD
moves each segment's pieces by collective-permutes), the depthwise conv
runs on this rank's conv channels with its block of the conv state and is
all-gathered, and the SSD scan or the S == 1 recurrence runs on this
rank's heads (B and C whole; ``A_log``, ``dt_bias`` and ``D_skip`` read
through ``tp.rep``); ``out_norm``'s sum of squares over the whole
``d_inner`` is summed over ``model``; ``w_out`` gives a partial sum.  The
``ssm`` state's spec is whole: a rank updates its heads' part of it.

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


def tp_divides(cfg, n: int) -> bool:
    """Whether the tensor-parallel form runs over ``n`` ranks: the heads,
    the conv channels and the projection's columns divide."""
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return (cfg.ssm_nheads % n == 0 and conv_dim % n == 0
            and (conv_dim + cfg.d_inner + cfg.ssm_nheads) % n == 0)


def mamba2_apply(p, x, cfg, state=None, tp=None):
    """x: (B,S,D) -> (B,S,D).  ``state``: None, or {"conv", "ssm"} to
    carry (decode; a zeroed one in prefill).  Returns (y, new_state).
    Under ``tp`` (the module docstring) ``p`` holds this rank's blocks, y
    is a partial sum over ``model`` and ``state["conv"]`` this rank's
    channels."""
    Bsz, S, _ = x.shape
    nh, hd, ds = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    Din = cfg.d_inner
    zxbcdt = x @ p["w_in"].to(x.dtype)
    if tp is not None:
        zxbcdt = tp.gather(zxbcdt)
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    conv_state = None if state is None else state["conv"]
    heads = slice(None)
    if tp is None:
        xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                     conv_state)
        dt_bias, A_log, D_skip = p["dt_bias"], p["A_log"], p["D_skip"]
    else:
        conv, new_conv = _causal_conv(tp.cols(xbc), p["conv_w"],
                                      p["conv_b"], conv_state)
        xbc = tp.gather(conv)
        nh = nh // tp.n
        heads = slice(tp.i * nh, (tp.i + 1) * nh)
        dt = dt[..., heads]
        z = tp.cols(z)
        dt_bias, A_log, D_skip = (tp.rep(p[k])[heads]
                                  for k in ("dt_bias", "A_log", "D_skip"))
    xs = (xbc[..., :Din] if tp is None else tp.cols(xbc, Din)
          ).reshape(Bsz, S, nh, hd)
    Bc = xbc[..., Din:Din + ds]
    Cc = xbc[..., Din + ds:]
    dt = F.softplus(dt.float() + dt_bias.float())
    A = -torch.exp(A_log.float())

    if S == 1:  # decode: exact single-step recurrence
        s_prev = (x.new_zeros((Bsz, nh, ds, hd), dtype=torch.float32)
                  if state is None else state["ssm"][:, heads].float())
        dA = torch.exp(dt[:, 0] * A[None, :])                     # (B,nh)
        dBx = torch.einsum("bh,bs,bhe->bhse", dt[:, 0], Bc[:, 0].float(),
                           xs[:, 0].float())
        s_new = s_prev * dA[..., None, None] + dBx
        y = torch.einsum("bs,bhse->bhe", Cc[:, 0].float(), s_new)
        y = y[:, None].to(x.dtype)
        final = s_new
    else:
        init = None if state is None else state["ssm"][:, heads]
        y, final = _ssd_chunked(xs, dt, A, Bc, Cc, cfg, init)

    y = y + xs * D_skip.to(x.dtype)[None, None, :, None]
    y = y.reshape(Bsz, S, nh * hd)
    if tp is None:
        y = rmsnorm_apply(p["out_norm"], y)
    else:                        # a norm over the whole d_inner
        yf = y.float()
        var = tp.sum(torch.square(yf).sum(-1, keepdim=True)) / Din
        y = (yf * torch.rsqrt(var + 1e-6)
             * (1.0 + p["out_norm"]["scale"].float())).to(y.dtype)
    out = (y * silu(z)) @ p["w_out"].to(x.dtype)
    if tp is not None and state is not None:
        whole = state["ssm"].float().clone()
        whole[:, heads] = final
        final = whole
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
