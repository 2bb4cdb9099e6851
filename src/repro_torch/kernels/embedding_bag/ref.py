"""Plain PyTorch versions of the embedding-bag kernels (port of
``repro/kernels/embedding_bag/ref.py``, and the bags' backward).

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


def embedding_bag_stacked_ref(tables: torch.Tensor, idx: torch.Tensor,
                              out_dtype=None) -> torch.Tensor:
    """tables (T, R, D), idx (B, T, P) -> (B, T, D) in ``out_dtype``
    (default tables.dtype), rounded once from the float32 sums."""
    T, R, D = tables.shape
    B, _, P = idx.shape
    rows = idx.long() + torch.arange(T, device=idx.device)[None, :, None] * R
    out = _pool(tables.reshape(T * R, D), rows.reshape(B * T, P))
    return out.to(out_dtype or tables.dtype).reshape(B, T, D)


def embedding_bag_stacked_backward_ref(dpooled: torch.Tensor,
                                       idx: torch.Tensor, rows_per_table: int,
                                       dtype=torch.bfloat16) -> torch.Tensor:
    """dpooled (B, T, D), idx (B, T, P) -> dtables (T, R, D) in ``dtype``:
    row t * R + r is the float32 sum of ``dpooled[b, t]`` over every
    (b, p) with ``idx[b, t, p] == r``, repeats counted, added in (b, p)
    order and rounded once; untouched rows are 0.  The order is the
    backward kernel's: the entries' global rows sorted stably, then the
    k-th entry of every row added in pass k (one value a row a pass, so
    no two adds race).  ``jax.grad`` of the reference's jnp bags gives
    the same sums, added in bf16."""
    B, T, P = idx.shape
    D = dpooled.shape[-1]
    R = rows_per_table
    offset = torch.arange(T, device=idx.device)[None, :, None] * R
    flat = (idx.long() + offset).reshape(-1)
    rows, perm = torch.sort(flat, stable=True)
    n = rows.numel()
    out = torch.zeros((T * R, D), dtype=dtype, device=dpooled.device)
    if n == 0:
        return out.view(T, R, D)
    new = torch.ones(n, dtype=torch.bool, device=rows.device)
    new[1:] = rows[1:] != rows[:-1]
    pos = torch.arange(n, device=rows.device)
    start = torch.cummax(torch.where(new, pos, 0), 0).values
    rank = pos - start                      # place within the row's run
    seg = torch.cumsum(new.long(), 0) - 1   # the run's number
    vals = dpooled.reshape(B * T, D).float()[perm // P]
    acc = torch.zeros((int(seg[-1]) + 1, D), dtype=torch.float32,
                      device=dpooled.device)
    for k in range(int(rank.max()) + 1):
        sel = rank == k
        acc[seg[sel]] += vals[sel]
    out[rows[new]] = acc.to(dtype)
    return out.view(T, R, D)
