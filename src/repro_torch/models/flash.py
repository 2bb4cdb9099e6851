"""Memory-efficient causal attention with a flash-style backward (port of
``repro/models/flash.py``, its ``jax.custom_vjp`` as a
``torch.autograd.Function``).

Autograd through ``layers.blockwise_attention`` would save every
(block_q, block_k) probability tile for the backward.  This version saves
only the output and the softmax statistics (m, l) of each row, and
recomputes the probabilities tile by tile in the backward (Dao et al.,
FlashAttention): about 30% more attention FLOPs for none of the S^2
residual traffic.  It runs where the reference's does: train and prefill
with ``cfg.flash_attention`` set, no logit softcap, and more than 1,024
positions (2,048 for MLA).

The arithmetic is the reference's, tile for tile: scores in float32 from
the operands, the probabilities cast to V's dtype for the forward's
product, the backward in float32 throughout.  A key tile that the causal
mask hides from every query of a query tile adds exact zeros (and scales
by exactly 1) in the reference's loops; the port skips it, which leaves
every bit as it is.  Plain PyTorch: a hand-written Hopper kernel for it
is later work (ROADMAP.md).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _blocks(S: int, bq: int, bk: int) -> tuple:
    nq, nk = S // bq, S // bk
    if nq * bq != S or nk * bk != S:
        raise ValueError(f"S={S} is not a multiple of the blocks "
                         f"({bq}, {bk})")
    return nq, nk


def _visible(qi: int, ki: int, bq: int, bk: int, causal: bool) -> bool:
    """Whether any query of q tile ``qi`` sees a key of k tile ``ki``."""
    return not causal or ki * bk <= (qi + 1) * bq - 1


def _tile_scores(q_i, k_j, qi, ki, bq, bk, causal, scale):
    """(B, Hkv, G, bq, bk) float32 scaled scores, masked causally."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q_i.float(), k_j.float()) * scale
    if causal:
        qpos = qi * bq + torch.arange(bq, device=s.device)
        kpos = ki * bk + torch.arange(bk, device=s.device)
        s = torch.where(kpos[None, :] <= qpos[:, None], s, NEG_INF)
    return s


def _forward(q, k, v, causal, bq, bk):
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    nq, nk = _blocks(S, bq, bk)
    scale = 1.0 / math.sqrt(D)
    qb = q.reshape(B, nq, bq, Hkv, G, D)
    outs, ms, ls = [], [], []
    for qi in range(nq):
        q_i = qb[:, qi]
        m = torch.full((B, Hkv, G, bq), NEG_INF, device=q.device)
        l = torch.zeros((B, Hkv, G, bq), device=q.device)
        acc = torch.zeros((B, Hkv, G, bq, D), device=q.device)
        for ki in range(nk):
            if not _visible(qi, ki, bq, bk, causal):
                break
            k_j = k[:, ki * bk:(ki + 1) * bk]
            v_j = v[:, ki * bk:(ki + 1) * bk]
            s = _tile_scores(q_i, k_j, qi, ki, bq, bk, causal, scale)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(v_j.dtype), v_j).float()
            m = m_new
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])
        ms.append(m)
        ls.append(l)
    out = torch.stack(outs, 1)                     # (B, nq, Hkv, G, bq, D)
    out = torch.movedim(out, (2, 3), (3, 4)).reshape(B, S, Hq, D)
    return out.to(q.dtype), torch.stack(ms), torch.stack(ls)


def _backward(q, k, v, out, ms, ls, dout, causal, bq, bk):
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    nq, nk = _blocks(S, bq, bk)
    scale = 1.0 / math.sqrt(D)
    qb = q.reshape(B, nq, bq, Hkv, G, D)
    ob = out.reshape(B, nq, bq, Hkv, G, D)
    dob = dout.reshape(B, nq, bq, Hkv, G, D)
    dk = torch.zeros((B, S, Hkv, D), device=q.device)
    dv = torch.zeros((B, S, Hkv, D), device=q.device)
    dqs = []
    for qi in range(nq):
        q_i = qb[:, qi]
        do_i = torch.movedim(dob[:, qi], 1, 3).float()     # (B,Hkv,G,bq,D)
        o_i = torch.movedim(ob[:, qi], 1, 3).float()
        delta = (do_i * o_i).sum(-1)                        # (B,Hkv,G,bq)
        m_i, l_i = ms[qi], ls[qi]
        dq_i = torch.zeros((B, bq, Hkv, G, D), device=q.device)
        for ki in range(nk):
            if not _visible(qi, ki, bq, bk, causal):
                break
            sl = slice(ki * bk, (ki + 1) * bk)
            k_j, v_j = k[:, sl].float(), v[:, sl].float()
            s = _tile_scores(q_i, k_j, qi, ki, bq, bk, causal, scale)
            p = (torch.exp(s - m_i[..., None])
                 / torch.clamp_min(l_i, 1e-30)[..., None])
            dp = torch.einsum("bhgqd,bkhd->bhgqk", do_i, v_j)
            ds = p * (dp - delta[..., None]) * scale
            dv[:, sl] += torch.einsum("bhgqk,bhgqd->bkhd", p, do_i)
            dk[:, sl] += torch.einsum("bhgqk,bqhgd->bkhd", ds, q_i.float())
            dq_i = dq_i + torch.einsum("bhgqk,bkhd->bqhgd", ds, k_j)
        dqs.append(dq_i)
    dq = torch.stack(dqs, 1).reshape(B, S, Hq, D)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        out, ms, ls = _forward(q, k, v, causal, block_q, block_k)
        ctx.save_for_backward(q, k, v, out, ms, ls)
        ctx.blocks = (causal, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, ms, ls = ctx.saved_tensors
        causal, bq, bk = ctx.blocks
        dq, dk, dv = _backward(q, k, v, out, ms, ls, dout, causal, bq, bk)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, block_q: int = 512,
                    block_k: int = 512) -> torch.Tensor:
    """q: (B, S, Hq, D); k/v: (B, S, Hkv, D) -> (B, S, Hq, D) in q's
    dtype; S a multiple of both blocks."""
    return _FlashAttention.apply(q, k, v, causal, block_q, block_k)
