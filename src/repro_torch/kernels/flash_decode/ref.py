"""Plain PyTorch version of the flash-decode kernel (port of
``repro/kernels/flash_decode/ref.py::flash_decode_ref``).

Float32 scores over the whole cache (through ``softcap * tanh(s /
softcap)`` where a softcap is given, as the reference's
``layers.decode_attention``), positions at or past ``length`` masked,
softmax, float32 p.v, cast to q's dtype; ``flash_decode_quant_ref`` the
same over an int8 cache with its scales (``decode_attention_quant``). The
wrapper in ``ops.py`` calls it for CPU tensors; the tests and
``chip_smoke.py`` hold the CUDA kernel against it.
``flash_decode_chunked_ref`` models the kernel's split into fixed chunks
and their merge, for the CPU tests.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _softcap(s, cap):
    return s if cap is None else cap * torch.tanh(s / cap)


def flash_decode_ref(q, k, v, length, softcap=None):
    """q: (B,Hkv,G,D); k/v: (B,S,Hkv,D); length (B,) -> (B,Hkv,G,D)."""
    D = q.shape[-1]
    S = k.shape[1]
    logits = torch.einsum("bhgd,bshd->bhgs", q.float(), k.float()) / (D ** 0.5)
    logits = _softcap(logits, softcap)
    mask = (torch.arange(S, device=q.device)[None, None, None, :]
            < length.to(q.device)[:, None, None, None])
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return out.to(q.dtype)


def flash_decode_quant_ref(q, k, v, k_scale, v_scale, length, softcap=None):
    """The int8 cache's version (``layers.decode_attention_quant``'s math
    in the kernel's layout): q (B,Hkv,G,D); k/v (B,S,Hkv,D) int8; scales
    (B,S,Hkv) float32; float32 scores (q . k) * k_scale / sqrt(D),
    softcapped where given, positions at or past ``length`` masked,
    softmax, p weighted by v_scale, float32 p.v, cast to q's dtype."""
    D = q.shape[-1]
    S = k.shape[1]
    s = torch.einsum("bhgd,bshd->bhgs", q.float(), k.float())
    s = s * torch.movedim(k_scale, 2, 1)[:, :, None, :] / (D ** 0.5)
    s = _softcap(s, softcap)
    mask = (torch.arange(S, device=q.device)[None, None, None, :]
            < length.to(q.device)[:, None, None, None])
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1) * torch.movedim(v_scale, 2, 1)[:, :, None, :]
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return out.to(q.dtype)


def flash_decode_chunked_ref(q, k, v, length, chunk: int, chunks_read,
                             softcap=None):
    """Plain model of the kernel's split and merge: for each row b, the
    positions below ``length[b]`` in fixed chunks of ``chunk`` keys, of
    which the first ``chunks_read[b]`` (``ops.split_plan``) each give a
    partial (m = max s, l = sum p, acc = p . v with p = exp(s - m); float32
    scores s = (q . k) * float32(1 / sqrt(D)), softcapped where given);
    the partials merged in
    split order, M = max m, L = sum l exp(m - M), out = sum acc exp(m - M)
    / max(L, 1e-30), cast to q's dtype."""
    B, Hkv, G, D = q.shape
    scale = torch.tensor(1.0 / D ** 0.5, dtype=torch.float32)
    out = torch.zeros((B, Hkv, G, D), dtype=torch.float32, device=q.device)
    for b in range(B):
        n = int(length[b])
        M = torch.full((Hkv, G), NEG_INF, device=q.device)
        parts = []
        for c in range(chunks_read[b]):
            lo, hi = c * chunk, min((c + 1) * chunk, n)
            s = torch.einsum("hgd,thd->hgt", q[b].float(),
                             k[b, lo:hi].float()) * scale
            s = _softcap(s, softcap)
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum(
                "hgt,thd->hgd", p, v[b, lo:hi].float())))
            M = torch.maximum(M, m)
        L = torch.zeros((Hkv, G), device=q.device)
        A = torch.zeros((Hkv, G, D), device=q.device)
        for m, l, acc in parts:
            w = torch.exp(m - M)
            L = L + l * w
            A = A + acc * w[..., None]
        out[b] = A / torch.clamp(L, min=1e-30)[..., None]
    return out.to(q.dtype)
