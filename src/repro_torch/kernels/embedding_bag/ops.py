"""Wrappers of the embedding-bag CUDA kernel (``csrc/embedding_bag.cu``),
the counterparts of ``repro/kernels/embedding_bag/embedding_bag.py::
embedding_bag_rows`` and ``repro/kernels/embedding_bag/ops.py::
embedding_bag_stacked``.

For tensors on the CPU each wrapper checks that every id is in range and
returns the plain version from ``ref.py``.  For CUDA tensors it checks
device, dtype (a bf16 table, int32 ids), shape and contiguity, allocates
the output, launches on PyTorch's current stream, raises if the launch
returns a CUDA error, and adds one to ``LAUNCHES["embedding_bag_rows"]``.
There is no fallback: a CUDA tensor either goes through the kernel or
raises.  On the card the ids are not range-checked (that would wait for
the device): the kernel clamps them into their table, and ids outside
``[0, R)`` are not supported.

The kernel is forward-only: it raises if autograd would record the call
(grad mode on and a table that requires grad).  The bags' backward comes
with DLRM training.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.checks import check, on_cuda
from repro_torch.kernels.embedding_bag import ref

# kernel launches since the last reset_launches(); the plain versions never
# count
LAUNCHES = {"embedding_bag_rows": 0}

_SIGNATURE = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
              ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
              ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_function():
    """The C entry point of the built library (argtypes set).  Calling it
    directly bypasses the wrapper's checks and launch count;
    ``chip_smoke.py`` does so only to time back-to-back launches."""
    fn = build.load("embedding_bag").embedding_bag
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
    return fn


def kernel_args(table2d, ids, T: int, R: int, out) -> list:
    """The C arguments (stream excluded) for bags ``ids (NB, P)`` over
    ``T`` stacked tables of ``R`` rows in ``table2d (T*R, D)``, into
    ``out (NB, D)`` (float32 or bf16)."""
    NB, P = ids.shape
    D = table2d.shape[1]
    pairs = D % 2 == 0 and table2d.data_ptr() % 4 == 0
    return [table2d.data_ptr(), ids.data_ptr(), NB, P, D, T, R, int(pairs),
            int(out.dtype == torch.bfloat16), out.data_ptr()]


def _check_ids_in_range(ids: torch.Tensor, n: int, what: str) -> None:
    if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= n):
        raise IndexError(f"{what}: ids must lie in [0, {n}), got "
                         f"[{int(ids.min())}, {int(ids.max())}]")


def _launch(table2d, ids, T: int, R: int, out_dtype) -> torch.Tensor:
    if torch.is_grad_enabled() and table2d.requires_grad:
        raise RuntimeError("embedding_bag: the CUDA kernel is forward-only; "
                           "run under torch.no_grad() or with a table that "
                           "does not require grad")
    NB, P = ids.shape
    D = table2d.shape[1]
    check(table2d, "table", (T * R, D), torch.bfloat16)
    check(ids, "ids", (NB, P), torch.int32)
    if R > 2 ** 31:
        raise ValueError(f"tables of {R} rows exceed the kernel's int32 ids")
    out = torch.empty((NB, D), dtype=out_dtype, device=table2d.device)
    if NB == 0:
        return out
    stream = torch.cuda.current_stream().cuda_stream
    err = kernel_function()(*kernel_args(table2d, ids, T, R, out), stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag: CUDA launch failed with "
                           f"cudaError_t {err}")
    LAUNCHES["embedding_bag_rows"] += 1
    return out


def embedding_bag_rows(table2d: torch.Tensor,
                       rows: torch.Tensor) -> torch.Tensor:
    """``table2d (n_rows, D)``, ``rows (NB, P)`` int32 -> ``(NB, D)``
    float32 sum-pooled bags."""
    if not on_cuda((table2d, rows)):
        _check_ids_in_range(rows, table2d.shape[0], "embedding_bag_rows")
        return ref.embedding_bag_rows_ref(table2d, rows)
    return _launch(table2d, rows, 1, table2d.shape[0], torch.float32)


def embedding_bag_stacked(tables: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """``tables (T, R, D)``, ``idx (B, T, P)`` int32 ids into each table ->
    ``(B, T, D)`` in ``tables.dtype``, rounded once from float32 sums.  The
    kernel reads the rows in place from the ``(T*R, D)`` view of the
    tables: no copy, no padding."""
    T, R, D = tables.shape
    B, T_idx, P = idx.shape
    if T_idx != T:
        raise ValueError(f"idx has {T_idx} tables, the stack {T}")
    if not on_cuda((tables, idx)):
        _check_ids_in_range(idx, R, "embedding_bag_stacked")
        return ref.embedding_bag_stacked_ref(tables, idx)
    if not (tables.is_contiguous() and idx.is_contiguous()):
        raise ValueError("embedding_bag_stacked: tables and idx must be "
                         "contiguous")
    out = _launch(tables.view(T * R, D), idx.view(B * T, P), T, R,
                  tables.dtype)
    return out.view(B, T, D)
