"""Atomic, asynchronous checkpointing with elastic restore (port of
``repro/checkpoint/ckpt.py``).

Layout, the reference's:  <dir>/step_<N>/{manifest.json, <dot.path>.npy ...}

* leaf names: ``common.pytree.flatten_with_paths``, the reference's names
  in its order, so a checkpoint written by either package restores in
  the other (a ``(params, opt_state)`` tuple: ``0.embed``, ...,
  ``1.count``, ``1.mu...``);
* dtypes: numpy has no bf16, so a bf16 leaf is stored as its lossless
  float32 widening and the manifest records the logical ``bfloat16``;
* specs: with ``specs`` each leaf's entry records its ``pspec`` in the
  reference's JSON form (a list; a tuple of axes as a list);
* atomic: written to ``step_<N>.tmp`` and renamed, so a crash mid-write
  never corrupts the latest checkpoint;
* async: ``AsyncCheckpointer`` copies every tensor to the host on the
  caller's thread (the train step updates its tensors in place after it
  returns) and writes on a worker thread.

**On a live mesh** (``save(..., specs=, mesh=)``, every rank of the mesh
calls it with its blocks): the files hold the global arrays in the
reference's layout, as a single process writes them.  Rank 0 writes the
manifest, every file's header and the replicated leaves; a leaf whose
blocks are contiguous runs of its file (sharded on its leading dim) is
written by the ranks that hold its blocks (one rank a block), each at its
offset; any other leaf is gathered whole and written by rank 0.
``restore(..., mesh=, specs=)`` reads each rank's block under the *new*
mesh and specs (the elastic restore: a checkpoint of one mesh restores
onto any other factorisation, or into one process), a leaf at a time and
in chunks, so no rank holds more than its blocks.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.common import comm
from repro_torch.common.pytree import (flatten_with_paths, tree_map,
                                       unflatten_like)
from repro_torch.common.sharding import (P, flatten_specs, gather_full,
                                         shard_slices)

CHUNK_BYTES = 1 << 28        # host bytes a chunk of a large leaf's I/O

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


def _spec_to_json(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def spec_from_json(entry) -> P:
    return P(*(tuple(e) if isinstance(e, list) else e for e in entry))


def save(ckpt_dir: str, step: int, tree: Any, specs: Any | None = None,
         extra_meta: dict | None = None, mesh=None) -> str:
    """Write ``tree`` (whole arrays; on a live ``mesh`` this rank's blocks
    under ``specs``) as step ``step`` of ``ckpt_dir``."""
    if mesh is not None and mesh.is_live:
        return _save_mesh(ckpt_dir, step, tree, specs, extra_meta, mesh)
    final, tmp = _fresh(ckpt_dir, step)
    spec_of = dict(flatten_specs(specs)) if specs is not None else {}
    manifest = {"step": step, "leaves": {}, "meta": extra_meta or {}}
    for name, leaf in flatten_with_paths(tree):
        arr, logical = _to_numpy(leaf)
        fn = name.replace("/", "_") + ".npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"][name] = _entry(fn, arr.shape, logical,
                                          spec_of.get(name))
    _finish(tmp, final, manifest)
    return final


def _fresh(ckpt_dir: str, step: int) -> tuple:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    return final, tmp


def _entry(fn: str, shape, logical: str, spec) -> dict:
    entry = {"file": fn, "shape": list(shape), "dtype": logical}
    if spec is not None:
        entry["pspec"] = _spec_to_json(spec)
    return entry


def _finish(tmp: str, final: str, manifest: dict) -> None:
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def _logical(t: torch.Tensor) -> str:
    return "bfloat16" if t.dtype == torch.bfloat16 else \
        str(t.dtype).replace("torch.", "")


def _file_dtype(t: torch.Tensor):
    return np.float32 if t.dtype == torch.bfloat16 else \
        torch.empty(0, dtype=t.dtype).numpy().dtype


def _contiguous_block(spec: P, ndim: int) -> bool:
    """Whether each block of a leaf of ``spec`` is one run of its file:
    only the leading dim sharded."""
    return all(not spec.axes(i) for i in range(1, ndim))


def _writer(spec: P, mesh) -> bool:
    """Whether this rank writes its block: the first of its replicas."""
    c = mesh.coords()
    used = set(spec.used_axes())
    return all(c[a] == 0 for a in mesh.axis_names if a not in used)


def _write_at(path: str, offset: int, t: torch.Tensor) -> None:
    """``t``'s elements (bf16 widened to float32) at byte ``offset`` of
    the file ``path``, in chunks of its leading dim."""
    flat = t.detach().reshape(-1)
    dtype = np.float32 if t.dtype == torch.bfloat16 else None
    step = max(1, CHUNK_BYTES // max(1, flat.element_size() * 2))
    with open(path, "r+b") as f:
        f.seek(offset)
        for i in range(0, flat.numel(), step):
            part = flat[i:i + step].cpu()
            arr = part.float().numpy() if dtype is not None else part.numpy()
            f.write(arr.tobytes())


def _save_mesh(ckpt_dir, step, tree, specs, extra_meta, mesh) -> str:
    group = mesh.group(mesh.axis_names)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    leaves = flatten_with_paths(tree)
    spec_list = [s for _, s in flatten_specs(specs)]
    if len(spec_list) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves, {len(spec_list)} specs")
    entries = {}
    for (name, leaf), spec in zip(leaves, spec_list):
        shape = tuple(np.asarray(leaf).shape) if not isinstance(
            leaf, torch.Tensor) else _global_shape(leaf, spec, mesh)
        entries[name] = (name.replace("/", "_") + ".npy", shape, spec)
    if mesh.rank == 0:
        _fresh(ckpt_dir, step)
        for (name, leaf), spec in zip(leaves, spec_list):
            fn, shape, _ = entries[name]
            t = torch.as_tensor(leaf)
            np.lib.format.open_memmap(os.path.join(tmp, fn), mode="w+",
                                      dtype=_file_dtype(t),
                                      shape=shape).flush()
    comm.barrier(group)
    for (name, leaf), spec in zip(leaves, spec_list):
        fn, shape, _ = entries[name]
        path = os.path.join(tmp, fn)
        t = torch.as_tensor(leaf)
        if spec.used_axes() and _contiguous_block(spec, t.dim()):
            if _writer(spec, mesh):
                start = shard_slices(shape, spec, mesh)[0].start if \
                    t.dim() else 0
                row = int(np.prod(shape[1:])) if t.dim() else 1
                _write_at(path, _data_offset(path)
                          + start * row * np.dtype(_file_dtype(t)).itemsize,
                          t)
            continue
        whole = gather_full(t, spec, mesh) if spec.used_axes() else t
        if mesh.rank == 0:
            _write_at(path, _data_offset(path), whole)
    comm.barrier(group)
    if mesh.rank == 0:
        manifest = {"step": step, "meta": extra_meta or {}, "leaves": {
            name: _entry(fn, shape, _logical(torch.as_tensor(leaf)), spec)
            for (name, leaf), (fn, shape, spec) in zip(
                leaves, (entries[n] for n, _ in leaves))}}
        _finish(tmp, final, manifest)
    comm.barrier(group)
    return final


def _global_shape(t: torch.Tensor, spec: P, mesh) -> tuple:
    return tuple(n * (mesh.axis_size(spec.axes(i)) if spec.axes(i) else 1)
                 for i, n in enumerate(t.shape))


def _data_offset(path: str) -> int:
    """The byte offset of a ``.npy`` file's data (past its header)."""
    return int(np.load(path, mmap_mode="r").offset)


def _steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(ckpt_dir: str) -> int | None:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, like: Any, mesh=None,
            specs: Any | None = None, device=None):
    """``like``: a tree of the target structure (its values are not read;
    each leaf's device is where the restored leaf goes, unless
    ``device`` is given).  On a live ``mesh`` each leaf is this rank's
    block under ``specs`` (the elastic restore).  Returns (tree of
    tensors, meta)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    live = mesh is not None and mesh.is_live
    spec_list = ([s for _, s in flatten_specs(specs)] if specs is not None
                 else None)
    leaves = []
    for i, (name, old) in enumerate(flatten_with_paths(like)):
        entry = manifest["leaves"][name]
        dev = device if device is not None else (
            old.device if isinstance(old, torch.Tensor) else
            (mesh.device if live and mesh.device is not None else "cpu"))
        index = None
        if live and spec_list is not None:
            index = shard_slices(tuple(entry["shape"]), spec_list[i], mesh)
        leaves.append(_read(os.path.join(path, entry["file"]), index,
                            _TORCH[entry["dtype"]], dev))
    return unflatten_like(like, leaves), manifest["meta"]


def _read(path: str, index, dtype, device) -> torch.Tensor:
    """The block ``index`` (every element when None) of a ``.npy`` file as
    a tensor of ``dtype`` on ``device``, read in chunks of its leading
    dim."""
    mm = np.load(path, mmap_mode="r")
    block = mm if index is None else mm[index]
    if block.ndim == 0:
        return torch.as_tensor(np.array(block)).to(device=device,
                                                   dtype=dtype)
    out = torch.empty(block.shape, dtype=dtype, device=device)
    row = max(1, block[0].nbytes) if len(block) else 1
    step = max(1, CHUNK_BYTES // row)
    for i in range(0, len(block), step):
        part = torch.from_numpy(np.array(block[i:i + step]))
        out[i:i + step].copy_(part.to(device=device).to(dtype))
    return out


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

    def save(self, step: int, tree, specs=None, extra_meta=None):
        self.wait()
        # a host copy of every tensor, a CPU one too: the train step
        # updates its tensors in place while the worker writes
        host_tree = tree_map(lambda x: x.detach().to("cpu", copy=True)
                             if isinstance(x, torch.Tensor) else x, tree)

        def work():
            try:
                save(self.dir, step, host_tree, specs, extra_meta)
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
