"""Atomic, asynchronous checkpointing (port of
``repro/checkpoint/ckpt.py`` without the mesh).

Layout, the reference's:  <dir>/step_<N>/{manifest.json, <dot.path>.npy ...}

* leaf names: ``common.pytree.flatten_with_paths``, the reference's names
  in its order, so a checkpoint written by either package restores in
  the other (a ``(params, opt_state)`` tuple: ``0.embed``, ...,
  ``1.count``, ``1.mu...``);
* dtypes: numpy has no bf16, so a bf16 leaf is stored as its lossless
  float32 widening and the manifest records the logical ``bfloat16``;
* atomic: written to ``step_<N>.tmp`` and renamed, so a crash mid-write
  never corrupts the latest checkpoint;
* async: ``AsyncCheckpointer`` copies every tensor to the host on the
  caller's thread (the train step updates its tensors in place after it
  returns) and writes on a worker thread.

The elastic restore onto a mesh (``mesh``/``specs``) comes with the
logical-axis sharding (ROADMAP.md queue item 9.8): ``restore`` puts each
leaf on the device of the leaf it replaces.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.common.pytree import (flatten_with_paths, tree_map,
                                       unflatten_like)

_TORCH = {"float32": torch.float32, "float64": torch.float64,
          "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
          "bfloat16": torch.bfloat16, "float16": torch.float16,
          "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16}


def _to_numpy(leaf) -> tuple:
    """(array, logical dtype name) of a leaf: a tensor, a numpy array or a
    number; a bf16 leaf as its float32 widening."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.float().numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":       # a reference array handed over
        return arr.astype(np.float32), "bfloat16"
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree: Any,
         extra_meta: dict | None = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": {}, "meta": extra_meta or {}}
    for name, leaf in flatten_with_paths(tree):
        arr, logical = _to_numpy(leaf)
        fn = name.replace("/", "_") + ".npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"][name] = {"file": fn, "shape": list(arr.shape),
                                    "dtype": logical}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(ckpt_dir: str) -> int | None:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, like: Any, device=None):
    """``like``: a tree of the target structure (its values are not read;
    each leaf's device is where the restored leaf goes, unless
    ``device`` is given).  Returns (tree of tensors, meta)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = []
    for name, old in flatten_with_paths(like):
        entry = manifest["leaves"][name]
        arr = np.load(os.path.join(path, entry["file"]))
        dev = device if device is not None else (
            old.device if isinstance(old, torch.Tensor) else "cpu")
        t = torch.from_numpy(np.array(arr))
        leaves.append(t.to(device=dev, dtype=_TORCH[entry["dtype"]]))
    return unflatten_like(like, leaves), manifest["meta"]


def gc_old(ckpt_dir: str, keep: int):
    for s in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


class AsyncCheckpointer:
    """Fire-and-forget checkpoint writes on a worker thread."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        self._pending: threading.Thread | None = None
        self._err: Exception | None = None

    def save(self, step: int, tree, extra_meta=None):
        self.wait()
        # a host copy of every tensor, a CPU one too: the train step
        # updates its tensors in place while the worker writes
        host_tree = tree_map(lambda x: x.detach().to("cpu", copy=True)
                             if isinstance(x, torch.Tensor) else x, tree)

        def work():
            try:
                save(self.dir, step, host_tree, extra_meta)
                gc_old(self.dir, self.keep)
            except Exception as e:  # surfaced on the next wait()
                self._err = e

        self._pending = threading.Thread(target=work, daemon=True)
        self._pending.start()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err
