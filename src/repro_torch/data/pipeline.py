"""Deterministic synthetic batches with background prefetch (port of
``repro/data/pipeline.py``; numpy only).

Every batch is a pure function of (seed, step), so a restart reproduces
the exact stream (what checkpoint/restart equivalence rests on), and its
arrays are identical to the reference's.  ``Prefetcher`` builds the
stream ahead on a background thread.  ``shard_batch(batch, mesh,
pspecs)`` gives a rank of a live mesh its rows of the global batch (every
rank builds the same global batch from the seed and step), and without a
mesh the batch as tensors.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np


def lm_batch(seed: int, step: int, global_batch: int, seq: int,
             vocab: int) -> dict:
    rng = np.random.default_rng(np.uint64(seed) * np.uint64(1_000_003)
                                + np.uint64(step))
    toks = rng.integers(0, vocab, (global_batch, seq), dtype=np.int32)
    # inject learnable structure: token t+1 correlates with token t
    toks[:, 1::2] = (toks[:, 0::2] * 31 + 7) % vocab
    return {"tokens": toks}


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


def shard_batch(batch: dict, mesh, pspecs: dict) -> dict:
    """This rank's block of each array of the global ``batch`` under
    ``pspecs`` (a view of a tensor; numpy arrays become tensors); without
    a mesh, every array as a tensor."""
    import torch

    from repro_torch.common.sharding import local_shard
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        out[k] = t if mesh is None else local_shard(t, pspecs[k], mesh)
    return out


class Prefetcher:
    """Background-thread prefetch of the (deterministic) batch stream:
    ``make_batch(step)`` for step = start_step, start_step + 1, ...,
    at most ``depth`` ahead; iterate to take them in order."""

    def __init__(self, make_batch: Callable[[int], dict], start_step: int = 0,
                 depth: int = 2):
        self._make = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self._q.put(self._make(step), timeout=0.1)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
