"""Deterministic synthetic batches (port of ``dlrm_batch`` of
``repro/data/pipeline.py``; numpy only).

Every batch is a pure function of (seed, step), and its arrays are
identical to the reference's.  The background prefetcher and mesh
sharding wait for the training slice.
"""
from __future__ import annotations

import numpy as np


def dlrm_batch(seed: int, step: int, global_batch: int, cfg) -> dict:
    rng = np.random.default_rng(np.uint64(seed) * np.uint64(999_983)
                                + np.uint64(step))
    dense = rng.normal(size=(global_batch, cfg.n_dense)).astype(np.float32)
    idx = rng.integers(0, cfg.rows_per_table,
                       (global_batch, cfg.n_tables, cfg.pooling),
                       dtype=np.int32)
    # clickthrough depends on a dense projection -> learnable
    w = np.asarray(np.sin(np.arange(cfg.n_dense)), np.float32)
    label = (dense @ w > 0).astype(np.float32)
    return {"dense": dense, "sparse_idx": idx, "label": label}
