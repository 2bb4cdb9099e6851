"""Plain PyTorch versions of the embedding-bag kernel (port of
``repro/kernels/embedding_bag/ref.py``).

Both sum in float32 and add the rows in the order the Pallas kernel adds
them, j = 0, 1, ..., P-1 (``torch.sum`` over the pooling axis would pick its
own order); the CUDA kernel adds in the same order, so the two agree to the
bit.  The wrappers in ``ops.py`` call these for CPU tensors, and
``chip_smoke.py`` holds the kernel against them on the card.
"""
from __future__ import annotations

import torch


def _pool(table2d: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    rows = rows.long()
    acc = torch.zeros((rows.shape[0], table2d.shape[1]),
                      dtype=torch.float32, device=table2d.device)
    for j in range(rows.shape[1]):
        acc += table2d[rows[:, j]].float()
    return acc


def embedding_bag_rows_ref(table2d: torch.Tensor,
                           rows: torch.Tensor) -> torch.Tensor:
    """(n_rows, D), (NB, P) row ids -> (NB, D) float32 sum-pool."""
    return _pool(table2d, rows)


def embedding_bag_stacked_ref(tables: torch.Tensor,
                              idx: torch.Tensor) -> torch.Tensor:
    """tables (T, R, D), idx (B, T, P) -> (B, T, D) in tables.dtype, rounded
    once from the float32 sums."""
    T, R, D = tables.shape
    B, _, P = idx.shape
    rows = idx.long() + torch.arange(T, device=idx.device)[None, :, None] * R
    out = _pool(tables.reshape(T * R, D), rows.reshape(B * T, P))
    return out.to(tables.dtype).reshape(B, T, D)
