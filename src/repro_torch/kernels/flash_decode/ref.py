"""Plain PyTorch version of the flash-decode kernel (port of
``repro/kernels/flash_decode/ref.py::flash_decode_ref``).

Float32 scores over the whole cache, positions at or past ``length``
masked, softmax, float32 p.v, cast to q's dtype.  The wrapper in
``ops.py`` calls it for CPU tensors; the tests and ``chip_smoke.py`` hold
the CUDA kernel against it.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_decode_ref(q, k, v, length):
    """q: (B,Hkv,G,D); k/v: (B,S,Hkv,D); length (B,) -> (B,Hkv,G,D)."""
    D = q.shape[-1]
    S = k.shape[1]
    logits = torch.einsum("bhgd,bshd->bhgs", q.float(), k.float()) / (D ** 0.5)
    mask = (torch.arange(S, device=q.device)[None, None, None, :]
            < length.to(q.device)[:, None, None, None])
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return out.to(q.dtype)
