"""Multi-head Latent Attention (DeepSeek-V2/V3, arXiv:2405.04434 §2.1), port
of ``repro/models/mla.py``.

KV is compressed to a ``kv_lora_rank`` latent plus a small shared RoPE
key; the decode cache stores only (c_kv, k_rope) per token, 576 dims
instead of 2 * H * head_dim.  Prefill materialises per-head K/V (the
non-absorbed form); decode uses the *absorbed* form (W_UK folded into the
query, W_UV applied to the latent context), so attention runs on the
latent cache directly.  A latent cache split along the sequence over
the mesh (``decode_seq_shard``, ``cache_shard="seq"``) decodes by
``mla_decode_split``: each rank's block, the blocks' log-sum-exp pairs
merged exactly.

No kernel: the reference runs MLA as plain array code on every backend
(no Pallas kernel reaches it), and so does the port, under either
``decode_impl``.  There is no kernel to fall back from.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.common import comm
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


def tp_params(p, tp):
    """``p`` with the replicated leaves a head-split MLA reads through
    ``tp.rep`` (None: ``p``)."""
    if tp is None:
        return p
    p = dict(p, kv_norm={"scale": tp.rep(p["kv_norm"]["scale"])})
    if "wq_a" in p:
        p["wq_a"] = tp.rep(p["wq_a"])
        p["q_norm"] = {"scale": tp.rep(p["q_norm"]["scale"])}
    return p


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


def _latent_kv(p, x, cfg, positions, tp=None):
    """Returns (c_kv normalized, k_pe roped): exactly what the cache
    stores (whole; under ``tp`` the column block's output all-gathered)."""
    r_kv = cfg.kv_lora_rank
    kv_a = x @ p["wkv_a"].to(x.dtype)
    if tp is not None and kv_a.shape[-1] < r_kv + cfg.qk_rope_head_dim:
        kv_a = tp.gather(kv_a)
    c_kv, k_pe = kv_a[..., :r_kv], kv_a[..., r_kv:]
    c_kv = L.rmsnorm_apply(p["kv_norm"], c_kv)
    k_pe = L.apply_rope(k_pe[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_pe


def mla_train(p, x, cfg, positions, tp=None):
    """Non-absorbed form for train and prefill: materialise per-head K/V
    and run causal attention, dense up to 2,048 positions and blockwise
    (or flash, with ``cfg.flash_attention``) above, with V padded to the
    qk head dim so that one attention serves both.  (The reference's
    prefix-LM option comes with the VLM config.)"""
    B, S, _ = x.shape
    H = p["wkv_b"].shape[-2]               # this rank's heads under tp
    d_nope, d_rope, d_v = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_pe = _queries(p, x, cfg, positions)
    c_kv, k_pe = _latent_kv(p, x, cfg, positions, tp)
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


def mla_prefill_cache(p, x, cfg, positions, tp=None):
    """(c_kv, k_pe) to stash in the decode cache (whole)."""
    return _latent_kv(p, x, cfg, positions, tp)


def mla_decode(p, x, cfg, c_cache, pe_cache, *, length: int, tp=None):
    """Absorbed decode: x (B,1,D) at position ``length``, whose entry the
    cache already holds; cache c (B,Smax,r_kv), pe (B,Smax,d_rope).

    score_h(t) = q_nope_h . (W_UK_h c_t) + q_pe_h . k_pe_t
               = (W_UK_h^T q_nope_h) . c_t + q_pe_h . k_pe_t
    ctx_h = W_UV_h^T (sum_t p_t c_t)

    Positions 0 .. ``length`` are valid; the reference masks the rest of
    Smax, whose terms add exact zeros, and the port reads only those.
    Under ``tp`` ``c_cache`` holds this rank's latent columns: its valid
    positions are all-gathered; the output is a partial sum."""
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
    c, pe = c_cache[:, :n], pe_cache[:, :n].to(x.dtype)
    if tp is not None and c.shape[-1] < cfg.kv_lora_rank:
        c = comm.all_gather(c.contiguous(), tp.mesh, "model", dim=2)
    c = c.to(x.dtype)
    scale = 1.0 / math.sqrt(d_nope + d_rope)
    s = (L._scores(q_eff, c, "bhr,bkr->bhk")
         + L._scores(q_pe[:, 0], pe, "bhe,bke->bhk")) * scale
    pr = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhk,bkr->bhr", pr.to(x.dtype), c)
    o = torch.einsum("bhr,rhe->bhe", ctx, w_uv)               # (B,H,d_v)
    return torch.einsum("bhe,hed->bd", o, p["wo"].to(x.dtype))[:, None]


def mla_decode_split(p, x, cfg, c_cache, pe_cache, c_new, pe_new, decode,
                     tp=None):
    """Absorbed decode over this rank's block of a latent cache split
    along the sequence over ``decode.seq_axes`` (block ``decode.seq_index``
    of ``S_r`` positions, every latent column of them where the sequence
    splits over ``model``), ``_split_decode``'s pattern: the rank whose
    block holds ``decode.pos`` writes ``c_new`` (B, r) and ``pe_new`` (B,
    d_rope) there; where the heads and the sequence both split over
    ``model``, the q side (``q_eff = W_UK^T q_nope`` and ``q_pe``) is
    all-gathered over it; each rank scores every head it holds the q side
    of over its ``clamp(pos + 1 - index * S_r, 0, S_r)`` positions and
    forms its partial ``sum_t p_t c_t`` with its log-sum-exp in float32
    (a block of no position gives 0 and -inf); ``layers.merge_split``
    merges the ranks' pairs exactly; this rank's heads then go through
    ``W_UV`` and ``wo`` (a partial sum under ``tp``, as ``mla_decode``'s).
    Under ``tp`` with ``c_cache`` holding a block of the latent columns,
    the valid positions' columns are all-gathered over ``model``."""
    B = x.shape[0]
    d_nope, d_rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    pos, S_r = decode.pos, c_cache.shape[1]
    lo = decode.seq_index * S_r
    if lo <= pos < lo + S_r:
        c_cache[:, pos - lo] = c_new.to(c_cache.dtype)
        pe_cache[:, pos - lo] = pe_new.to(pe_cache.dtype)
    n = min(max(pos + 1 - lo, 0), S_r)
    positions = torch.full((B, 1), pos, device=x.device)
    q_nope, q_pe = _queries(p, x, cfg, positions)            # (B,1,H,*)
    H = q_nope.shape[2]
    w_uk = p["wkv_b"][..., :d_nope].to(x.dtype)               # (r, H, d_nope)
    w_uv = p["wkv_b"][..., d_nope:].to(x.dtype)               # (r, H, d_v)
    q_eff = torch.einsum("bhe,rhe->bhr", q_nope[:, 0], w_uk)  # (B,H,r)
    q_pe = q_pe[:, 0]
    gather = (tp is not None and "model" in decode.seq_axes
              and H < cfg.n_heads)
    if gather:
        q_eff = comm.all_gather(q_eff, tp.mesh, "model", dim=1)
        q_pe = comm.all_gather(q_pe, tp.mesh, "model", dim=1)
    c, pe = c_cache[:, :n], pe_cache[:, :n].to(x.dtype)
    if tp is not None and n and c.shape[-1] < cfg.kv_lora_rank:
        c = comm.all_gather(c.contiguous(), tp.mesh, "model", dim=2)
    c = c.to(x.dtype)
    Hq = q_eff.shape[1]
    if n:
        s = (L._scores(q_eff, c, "bhr,bkr->bhk")
             + L._scores(q_pe, pe, "bhe,bke->bhk")) * (
                 1.0 / math.sqrt(d_nope + d_rope))
        lse = torch.logsumexp(s, dim=-1)                       # (B,Hq)
        ctx = torch.einsum("bhk,bkr->bhr", torch.exp(s - lse[..., None]),
                           c.float())
    else:
        lse = torch.full((B, Hq), float("-inf"), device=x.device)
        ctx = torch.zeros((B, Hq, cfg.kv_lora_rank), device=x.device)
    ctx = L.merge_split(ctx[:, None], lse[:, None], decode.mesh,
                        decode.seq_axes)[:, 0]
    if gather:
        ctx = ctx.narrow(1, tp.i * H, H)
    o = torch.einsum("bhr,rhe->bhe", ctx.to(x.dtype), w_uv)  # (B,H,d_v)
    return torch.einsum("bhe,hed->bd", o, p["wo"].to(x.dtype))[:, None]
