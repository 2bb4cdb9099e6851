"""Multi-head Latent Attention (DeepSeek-V2/V3, arXiv:2405.04434 §2.1), port
of ``repro/models/mla.py``.

KV is compressed to a ``kv_lora_rank`` latent plus a small shared RoPE
key; the decode cache stores only (c_kv, k_rope) per token, 576 dims
instead of 2 * H * head_dim.  Prefill materialises per-head K/V (the
non-absorbed form); decode uses the *absorbed* form (W_UK folded into the
query, W_UV applied to the latent context), so attention runs on the
latent cache directly.

No kernel: the reference runs MLA as plain array code on every backend
(no Pallas kernel reaches it), and so does the port, under either
``decode_impl``.  There is no kernel to fall back from.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.common.pytree import ParamDef
from repro_torch.models import layers as L
from repro_torch.models.flash import flash_attention


def mla_defs(cfg) -> dict:
    D, H = cfg.d_model, cfg.n_heads
    r_kv, d_nope, d_rope, d_v = (cfg.kv_lora_rank, cfg.qk_nope_head_dim,
                                 cfg.qk_rope_head_dim, cfg.v_head_dim)
    d = {
        "wkv_a": ParamDef((D, r_kv + d_rope), ("embed", "mla_latent"), init="scaled"),
        "kv_norm": {"scale": ParamDef((r_kv,), (None,), init="zeros")},
        "wkv_b": ParamDef((r_kv, H, d_nope + d_v), (None, "heads", None), init="scaled"),
        "wo": ParamDef((H, d_v, D), ("heads", None, "embed"), init="scaled"),
    }
    if cfg.q_lora_rank:
        r_q = cfg.q_lora_rank
        d["wq_a"] = ParamDef((D, r_q), ("embed", None), init="scaled")
        d["q_norm"] = {"scale": ParamDef((r_q,), (None,), init="zeros")}
        d["wq_b"] = ParamDef((r_q, H, d_nope + d_rope), (None, "heads", None),
                             init="scaled")
    else:
        d["wq"] = ParamDef((D, H, d_nope + d_rope), ("embed", "heads", None),
                           init="scaled")
    return d


def _queries(p, x, cfg, positions):
    d_nope = cfg.qk_nope_head_dim
    if cfg.q_lora_rank:
        q_lat = x @ p["wq_a"].to(x.dtype)
        q_lat = L.rmsnorm_apply(p["q_norm"], q_lat)
        q = L._project(q_lat, p["wq_b"])
    else:
        q = L._project(x, p["wq"])
    q_nope, q_pe = q[..., :d_nope], q[..., d_nope:]
    q_pe = L.apply_rope(q_pe, positions, cfg.rope_theta)
    return q_nope, q_pe


def _latent_kv(p, x, cfg, positions):
    """Returns (c_kv normalized, k_pe roped): exactly what the cache
    stores."""
    r_kv = cfg.kv_lora_rank
    kv_a = x @ p["wkv_a"].to(x.dtype)
    c_kv, k_pe = kv_a[..., :r_kv], kv_a[..., r_kv:]
    c_kv = L.rmsnorm_apply(p["kv_norm"], c_kv)
    k_pe = L.apply_rope(k_pe[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_pe


def mla_train(p, x, cfg, positions):
    """Non-absorbed form for train and prefill: materialise per-head K/V
    and run causal attention, dense up to 2,048 positions and blockwise
    (or flash, with ``cfg.flash_attention``) above, with V padded to the
    qk head dim so that one attention serves both.  (The reference's
    prefix-LM option comes with the VLM config.)"""
    B, S, _ = x.shape
    H = cfg.n_heads
    d_nope, d_rope, d_v = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_pe = _queries(p, x, cfg, positions)
    c_kv, k_pe = _latent_kv(p, x, cfg, positions)
    kv = L._project(c_kv, p["wkv_b"])
    k_nope, v = kv[..., :d_nope], kv[..., d_nope:]
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(B, S, H, d_rope)], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    if d_v < d_nope + d_rope:
        v = F.pad(v, (0, d_nope + d_rope - d_v))
    if S <= 2048:
        o = L.dense_attention(q, k, v, causal=True)
    elif cfg.flash_attention:
        o = flash_attention(q, k, v, True, cfg.block_q, cfg.block_k)
    else:
        o = L.blockwise_attention(q, k, v, causal=True, block_q=cfg.block_q,
                                  block_k=cfg.block_k)
    return L.gqa_out(p, o[..., :d_v], x.dtype)


def mla_prefill_cache(p, x, cfg, positions):
    """(c_kv, k_pe) to stash in the decode cache."""
    return _latent_kv(p, x, cfg, positions)


def mla_decode(p, x, cfg, c_cache, pe_cache, *, length: int):
    """Absorbed decode: x (B,1,D) at position ``length``, whose entry the
    cache already holds; cache c (B,Smax,r_kv), pe (B,Smax,d_rope).

    score_h(t) = q_nope_h . (W_UK_h c_t) + q_pe_h . k_pe_t
               = (W_UK_h^T q_nope_h) . c_t + q_pe_h . k_pe_t
    ctx_h = W_UV_h^T (sum_t p_t c_t)

    Positions 0 .. ``length`` are valid; the reference masks the rest of
    Smax, whose terms add exact zeros, and the port reads only those."""
    B = x.shape[0]
    d_nope, d_rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    n = length + 1
    if not 1 <= n <= c_cache.shape[1]:
        raise ValueError(f"decode position {length} outside the cache of "
                         f"{c_cache.shape[1]}")
    positions = torch.full((B, 1), length, device=x.device)
    q_nope, q_pe = _queries(p, x, cfg, positions)            # (B,1,H,*)
    w_uk = p["wkv_b"][..., :d_nope].to(x.dtype)               # (r, H, d_nope)
    w_uv = p["wkv_b"][..., d_nope:].to(x.dtype)               # (r, H, d_v)
    q_eff = torch.einsum("bhe,rhe->bhr", q_nope[:, 0], w_uk)  # (B,H,r)
    c, pe = c_cache[:, :n].to(x.dtype), pe_cache[:, :n].to(x.dtype)
    scale = 1.0 / math.sqrt(d_nope + d_rope)
    s = (L._scores(q_eff, c, "bhr,bkr->bhk")
         + L._scores(q_pe[:, 0], pe, "bhe,bke->bhk")) * scale
    pr = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhk,bkr->bhr", pr.to(x.dtype), c)
    o = torch.einsum("bhr,rhe->bhe", ctx, w_uv)               # (B,H,d_v)
    return torch.einsum("bhe,hed->bd", o, p["wo"].to(x.dtype))[:, None]
