"""Building blocks of the transformer zoo (port of
``repro/models/layers.py``): norms, rotary and sinusoidal positions,
attention and the GQA projections.

Each block is a pair: ``*_defs(cfg) -> tree of ParamDef`` and a function
that applies it.  Attention comes in four flavours, as in the reference:

* ``dense_attention``     -- one einsum, the prefill for S <= 1024 (with
                             a sliding window on local layers, a
                             bidirectional prefix for the VLM)
* ``blockwise_attention`` -- online softmax over (block_q, block_k) tiles,
                             with the causal wedge split, for longer prompts
                             (and the encoder's bidirectional attention)
* ``local_attention``     -- exact sliding-window attention by the
                             two-chunk method, for prompts past the window
* ``decode_attention``    -- one query token over a KV cache (and
                             ``decode_attention_quant`` over an int8 one,
                             written by ``quantize_kv``)

Layouts are the reference's: activations (B, S, H, D), caches
(B, S_max, H_kv, D).  Where the reference asks for
``preferred_element_type=float32`` (the attention scores), the port
computes in float32 from the bf16 operands (the products are exact there);
elsewhere a bf16 product gives a bf16 result, as in the reference.
"""
from __future__ import annotations

import math

import torch

from repro_torch.common import comm
from repro_torch.common.pytree import ParamDef
from repro_torch.core.arith import expf

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_defs(dim: int) -> dict:
    return {"scale": ParamDef((dim,), ("embed",), init="zeros")}


def rmsnorm_apply(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    # gemma-style (1 + scale): zero-init scale == identity
    return (x * (1.0 + p["scale"].float())).to(dtype)


def layernorm_defs(dim: int) -> dict:
    return {
        "scale": ParamDef((dim,), ("embed",), init="ones"),
        "bias": ParamDef((dim,), ("embed",), init="zeros"),
    }


def layernorm_apply(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * (1 / (1 + exp(-x))), every op rounded to x's dtype: the
    reference's ``jax.nn.silu`` as it lowers (negate, exp, add, divide,
    multiply), bit for bit in bf16 on the CPU.  ``F.silu`` rounds once and
    lies half a bf16 ulp away on 40% of inputs, which a deep random stack
    amplifies.  The MoE experts, Mamba-2 and RWKV-6 use it; the swiglu MLP
    keeps ``F.silu`` (with this SiLU there, a top-k near-tie flipped in
    DeepSeek-V2's MoE layer and its logits moved 3.5% from the reference's,
    against 1.3% with ``F.silu``: PERF.md)."""
    return x * (1 / (1 + torch.exp(-x)))


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    dtype = x.dtype
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                   # (d/2,)
    ang = positions[..., None].float() * freqs               # (..., S, d/2)
    cos = torch.cos(ang)[..., None, :]                       # (..., S, 1, d/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)


def _sinusoid_div(dim: int, device=None) -> torch.Tensor:
    """The frequencies exp(-2i ln(10000) / dim), through ``arith.expf``
    (the reference's compiled exp, bit for bit): ``torch.exp`` lies an
    ulp away on a tenth of them, which moves the angle at position 1,499
    by 1.5e-4."""
    return expf(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                * (-math.log(10000.0) / dim))


def sinusoidal_at(pos: int, dim: int, device=None) -> torch.Tensor:
    """Sinusoidal embedding of one position: (dim,) float32, sin(pos * div)
    in the even columns and cos in the odd ones."""
    return sinusoidal_pos(1, dim, offset=pos, device=device)[0]


def sinusoidal_pos(seq: int, dim: int, offset: int = 0,
                   device=None) -> torch.Tensor:
    """(seq, dim) float32 sinusoidal embeddings of positions offset ..
    offset + seq - 1."""
    pos = torch.arange(offset, offset + seq, dtype=torch.float32,
                       device=device)[:, None]
    ang = pos * _sinusoid_div(dim, device)
    pe = torch.zeros((seq, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe


# ---------------------------------------------------------------------------
# attention cores
# ---------------------------------------------------------------------------

def _softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def _scores(q: torch.Tensor, k: torch.Tensor, spec: str) -> torch.Tensor:
    """A float32 einsum of two (bf16 or float32) operands."""
    return torch.einsum(spec, q.float(), k.float())


def dense_attention(q, k, v, *, causal: bool, window: int | None = None,
                    softcap: float | None = None,
                    prefix_len: int = 0) -> torch.Tensor:
    """q: (B,Sq,Hq,D), k/v: (B,Sk,Hkv,D).  Exact reference path; query i
    sees key j where j <= i or j < ``prefix_len`` (``causal``; the
    prefix-LM's bidirectional prefix), and j > i - ``window``."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qr = q.reshape(B, Sq, Hkv, G, D)
    scores = _scores(qr, k, "bqhgd,bkhd->bhgqk")
    scores = _softcap(scores / math.sqrt(D), softcap)
    if causal or window is not None:
        qi = torch.arange(Sq, device=q.device)[:, None]
        ki = torch.arange(Sk, device=q.device)[None, :]
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask = ki <= qi
            if prefix_len > 0:
                mask = mask | (ki < prefix_len)
        if window is not None:
            mask = mask & (ki > qi - window)
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, Hq, D)


def blockwise_attention(q, k, v, *, causal: bool, softcap: float | None = None,
                        prefix_len: int = 0, block_q: int = 512,
                        block_k: int = 512,
                        split_wedge: bool = True) -> torch.Tensor:
    """Online-softmax blockwise attention (flash-style).

    Memory: O(block_q * block_k) per step instead of O(S^2).  For causal
    masks without a prefix ``split_wedge`` takes the reference's recursive
    wedge split (``_wedge_attention``).  ``prefix_len``: under ``causal``
    every query also sees the first ``prefix_len`` keys (the prefix-LM).
    A kv block that the mask hides from every query of a q block (it
    starts past the block's last query and past the prefix) is skipped:
    in the reference's scan it adds exactly 0 to the sums and scales them
    by exactly 1, so skipping it leaves the result bit for bit as it is.
    """
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    nq = S // block_q
    nk = S // block_k
    if nq * block_q != S or nk * block_k != S:
        raise ValueError(f"S={S} is not a multiple of the blocks "
                         f"({block_q}, {block_k})")

    if causal and split_wedge and prefix_len == 0 and nq >= 4 and nq % 2 == 0:
        return _wedge_attention(q, k, v, softcap=softcap, block_q=block_q,
                                block_k=block_k)

    qb = q.reshape(B, nq, block_q, Hkv, G, D)
    scale = 1.0 / math.sqrt(D)
    outs = []
    for qi in range(nq):
        q_i = qb[:, qi]
        qpos = qi * block_q + torch.arange(block_q, device=q.device)
        m = torch.full((B, Hkv, G, block_q), NEG_INF, device=q.device)
        l = torch.zeros((B, Hkv, G, block_q), device=q.device)
        acc = torch.zeros((B, Hkv, G, block_q, D), device=q.device)
        # the last key any query of this block sees
        last_k = max((qi + 1) * block_q - 1, prefix_len - 1)
        for ki in range(nk):
            if causal and ki * block_k > last_k:
                break            # hidden from every query of this block
            k_j = k[:, ki * block_k:(ki + 1) * block_k]
            v_j = v[:, ki * block_k:(ki + 1) * block_k]
            s = _scores(q_i, k_j, "bqhgd,bkhd->bhgqk") * scale
            s = _softcap(s, softcap)
            if causal:
                kpos = ki * block_k + torch.arange(block_k, device=q.device)
                mask = kpos[None, :] <= qpos[:, None]
                if prefix_len > 0:
                    mask = mask | (kpos[None, :] < prefix_len)
                s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(v_j.dtype), v_j).float()
            m = m_new
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])
    return _assemble(torch.stack(outs), B, S, Hq, D).to(q.dtype)


def _assemble(outs, B, S, Hq, D):
    # outs: (nq, B, Hkv, G, bq, D)
    out = torch.movedim(outs, 0, 1)                    # (B, nq, Hkv, G, bq, D)
    out = torch.movedim(out, (2, 3), (3, 4))           # (B, nq, bq, Hkv, G, D)
    return out.reshape(B, S, Hq, D)


def _wedge_attention(q, k, v, *, softcap, block_q, block_k,
                     min_len: int = 2048):
    """Causal attention via recursive wedge split: FLOPs ~ S^2/2 exactly.

    attn(q[:h], k[:h]) causal  |  attn(q[h:], k[:h]) dense + attn(q[h:], k[h:]) causal
    The dense rectangle needs a softmax-merge with the causal part.
    """
    S = q.shape[1]
    h = S // 2
    if S <= min_len or S % 2 != 0:
        return blockwise_attention(q, k, v, causal=True, softcap=softcap,
                                   block_q=min(block_q, S),
                                   block_k=min(block_k, S), split_wedge=False)
    top = _wedge_attention(q[:, :h], k[:, :h], v[:, :h], softcap=softcap,
                           block_q=block_q, block_k=block_k, min_len=min_len)
    # bottom: merge dense-rectangle (kv first half) with causal second half
    bot = _merge_two(q[:, h:], k[:, :h], v[:, :h], k[:, h:], v[:, h:],
                     softcap=softcap, block_k=block_k)
    return torch.cat([top, bot], dim=1)


def _partial_dense(q, k, v, *, softcap, mask=None):
    """Returns (out_unnormalized fp32, m, l) for softmax merging."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qr = q.reshape(B, Sq, Hkv, G, D)
    s = _scores(qr, k, "bqhgd,bkhd->bhgqk") / math.sqrt(D)
    s = _softcap(s, softcap)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    lsum = p.sum(-1)
    out = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype), v).float()
    return out, m, lsum


def _merge_two(q, k1, v1, k2, v2, *, softcap, block_k):
    """softmax-merge: dense attn over (k1,v1) + causal attn over (k2,v2)."""
    B, Sq, Hq, D = q.shape
    Hkv = k1.shape[2]
    G = Hq // Hkv
    # part 1: dense rectangle, chunked over kv to bound memory
    nchunk = max(1, k1.shape[1] // max(block_k, 1))
    if k1.shape[1] % nchunk:
        raise ValueError(f"{k1.shape[1]} keys do not split into {nchunk} "
                         "chunks")
    size = k1.shape[1] // nchunk
    m = torch.full((B, Hkv, G, Sq), NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), device=q.device)
    acc = torch.zeros((B, Hkv, G, Sq, D), device=q.device)
    for c in range(nchunk):
        o, m2, l2 = _partial_dense(q, k1[:, c * size:(c + 1) * size],
                                   v1[:, c * size:(c + 1) * size],
                                   softcap=softcap)
        m_new = torch.maximum(m, m2)
        c1, c2 = torch.exp(m - m_new), torch.exp(m2 - m_new)
        l = l * c1 + l2 * c2
        acc = acc * c1[..., None] + o * c2[..., None]
        m = m_new

    # part 2: causal within the second half (both halves share the offset)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(k2.shape[1], device=q.device)[None, :]
    o2, m2, l2 = _partial_dense(q, k2, v2, softcap=softcap, mask=kpos <= qpos)
    m_new = torch.maximum(m, m2)
    c1, c2 = torch.exp(m - m_new), torch.exp(m2 - m_new)
    l_f = l * c1 + l2 * c2
    acc_f = acc * c1[..., None] + o2 * c2[..., None]
    out = acc_f / torch.clamp_min(l_f, 1e-30)[..., None]
    out = torch.movedim(out, 3, 1)  # (B, Sq, Hkv, G, D)
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def local_attention(q, k, v, *, window: int,
                    softcap: float | None = None) -> torch.Tensor:
    """Exact sliding-window causal attention by the reference's two-chunk
    method: the sequence is padded to chunks of ``window`` positions, and
    each query chunk attends (previous chunk ++ own chunk) under the exact
    (kpos <= qpos) & (kpos > qpos - window) mask; FLOPs 2 * S * window a
    head pair, no quadratic term.

    The reference computes every chunk of every row in one einsum, whose
    (B, C, Hkv, G, W, 2W) float32 scores take 128 MiB a row, chunk and
    query head at W = 4,096; the port loops over rows and chunks, which
    are independent, so that one (Hkv, G, W, 2W) block is live at a
    time.  The result is the same."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    W = window
    if S <= W:
        return dense_attention(q, k, v, causal=True, window=W,
                               softcap=softcap)
    pad = (-S) % W
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                   for t in (q, k, v))
    C = q.shape[1] // W
    G = Hq // Hkv
    qpos = torch.arange(W, device=q.device)[:, None] + W   # in the 2W frame
    kpos = torch.arange(2 * W, device=q.device)[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - W)
    first = mask & (kpos >= W)               # the first chunk has no past
    out = torch.empty_like(q)
    for b in range(B):
        for c in range(C):
            own = slice(c * W, (c + 1) * W)
            if c:
                prev = slice((c - 1) * W, c * W)
                kk = torch.cat([k[b, prev], k[b, own]])       # (2W, Hkv, D)
                vv = torch.cat([v[b, prev], v[b, own]])
            else:
                kk = torch.cat([torch.zeros_like(k[b, own]), k[b, own]])
                vv = torch.cat([torch.zeros_like(v[b, own]), v[b, own]])
            qr = q[b, own].reshape(W, Hkv, G, D)
            s = _scores(qr, kk, "qhgd,khd->hgqk") / math.sqrt(D)
            s = _softcap(s, softcap)
            s = torch.where(mask if c else first, s, NEG_INF)
            p = torch.softmax(s, dim=-1).to(vv.dtype)
            o = torch.einsum("hgqk,khd->qhgd", p, vv)
            out[b, own] = o.reshape(W, Hq, D)
    return out[:, :S]


def decode_attention(q, k_cache, v_cache, *, length: int,
                     window: int | None = None,
                     softcap: float | None = None) -> torch.Tensor:
    """q: (B,1,Hq,D) against cache (B,Smax,Hkv,D); ``length`` = #valid
    tokens (every row); with ``window``, only the last ``window`` of them.

    The reference masks the cache positions outside
    [length - window, length) and sums over all of ``Smax``; they add
    exact zeros, so the port reads only the positions inside (the same
    softmax, summed over fewer terms)."""
    B, _, Hq, D = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    if not 1 <= length <= Smax:
        raise ValueError(f"length {length} outside [1, {Smax}]")
    lo = 0 if window is None else max(0, length - window)
    k_cache, v_cache = k_cache[:, lo:length], v_cache[:, lo:length]
    G = Hq // Hkv
    qr = q.reshape(B, Hkv, G, D)
    s = _scores(qr, k_cache, "bhgd,bkhd->bhgk") / math.sqrt(D)
    s = _softcap(s, softcap)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    lsum = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgk,bkhd->bhgd",
                     (p / torch.clamp_min(lsum, 1e-30)).to(v_cache.dtype),
                     v_cache)
    return o.reshape(B, 1, Hq, D)


def quantize_kv(x: torch.Tensor) -> tuple:
    """(B,S,H,D) -> (int8 values, per-(token, head) float32 scales):
    scale = max|x| / 127 (float32), floored at 1e-8; values x / scale
    rounded half to even and clipped to +-127 (the reference's bits)."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(-1) / 127.0, 1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def decode_attention_quant(q, k_q, v_q, k_s, v_s, *, length: int,
                           softcap: float | None = None) -> torch.Tensor:
    """Decode attention over an int8 KV cache without a dequantized copy:
    the key scales fold into the logits, the value scales into the
    probability weights.  q: (B,1,Hq,D); k_q/v_q: (B,S,Hkv,D) int8;
    k_s/v_s: (B,S,Hkv) float32; ``length`` valid positions (every row).

    As ``decode_attention``, the port reads only the first ``length``
    positions (the reference's masked ones add exact zeros)."""
    B, _, Hq, D = q.shape
    Smax, Hkv = k_q.shape[1], k_q.shape[2]
    if not 1 <= length <= Smax:
        raise ValueError(f"length {length} outside [1, {Smax}]")
    G = Hq // Hkv
    qr = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qr, k_q[:, :length].float())
    s = s * torch.movedim(k_s[:, :length], 2, 1)[:, :, None, :] / math.sqrt(D)
    s = _softcap(s, softcap)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / torch.clamp_min(p.sum(-1, keepdim=True), 1e-30)
    pw = p * torch.movedim(v_s[:, :length], 2, 1)[:, :, None, :]
    o = torch.einsum("bhgk,bkhd->bhgd", pw, v_q[:, :length].float())
    return o.reshape(B, 1, Hq, D).to(q.dtype)


def merge_split(o: torch.Tensor, lse: torch.Tensor, mesh, axes) -> tuple:
    """The exact merge of the ranks' (out, lse) pairs of a cache split
    along the sequence over ``axes``, in float32: M = pmax(lse), out =
    psum(exp(lse - M) out) / psum(exp(lse - M)) (one ``psum`` of both).
    o (B,1,H,D), lse (B,1,H) -> (B,1,H,D) float32."""
    m = comm.pmax(lse, mesh, axes)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lse - m)[..., None]
    both = comm.psum(torch.cat([o * w, w], dim=-1), mesh, axes)
    return both[..., :-1] / both[..., -1:]


# ---------------------------------------------------------------------------
# GQA attention layer (projections + rope)
# ---------------------------------------------------------------------------

def gqa_defs(cfg) -> dict:
    D, Hq, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    d = {
        "wq": ParamDef((D, Hq, Dh), ("embed", "heads", None), init="scaled"),
        "wk": ParamDef((D, Hkv, Dh), ("embed", "kv_heads", None), init="scaled"),
        "wv": ParamDef((D, Hkv, Dh), ("embed", "kv_heads", None), init="scaled"),
        "wo": ParamDef((Hq, Dh, D), ("heads", None, "embed"), init="scaled"),
    }
    if cfg.qk_norm:
        d["q_norm"] = {"scale": ParamDef((Dh,), (None,), init="zeros")}
        d["k_norm"] = {"scale": ParamDef((Dh,), (None,), init="zeros")}
    return d


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhe->bshe", x, w) in x's dtype."""
    B, S, D = x.shape
    y = torch.matmul(x, w.to(x.dtype).reshape(D, -1))
    return y.view(B, S, *w.shape[1:])


def gqa_project(p, x, cfg, positions, theta):
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm_apply(p["q_norm"], q)
        k = rmsnorm_apply(p["k_norm"], k)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    return q, k, v


def gqa_out(p, o, x_dtype):
    """einsum("bshe,hed->bsd", o, wo) in o's dtype, cast to ``x_dtype``."""
    B, S, H, E = o.shape
    wo = p["wo"].to(o.dtype).reshape(H * E, -1)
    return torch.matmul(o.reshape(B, S, H * E), wo).to(x_dtype)
