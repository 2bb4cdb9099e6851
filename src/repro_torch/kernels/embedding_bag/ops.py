"""Wrappers of the embedding-bag CUDA kernels: the forward
(``csrc/embedding_bag.cu``), the counterparts of
``repro/kernels/embedding_bag/embedding_bag.py::embedding_bag_rows`` and
``repro/kernels/embedding_bag/ops.py::embedding_bag_stacked``, and the
bags' backward (``csrc/embedding_bag_backward.cu``), which no Pallas
kernel has: the reference trains through jnp bags and ``jax.grad``.

For tensors on the CPU each wrapper checks that every id is in range and
returns the plain version from ``ref.py``.  For CUDA tensors it checks
device, dtype, shape and contiguity, allocates the output, launches on
PyTorch's current stream, raises if the launch returns a CUDA error, and
adds one to ``LAUNCHES[<kernel>]``.  There is no fallback: a CUDA tensor
either goes through the kernel or raises.  On the card the ids are not
range-checked (that would wait for the device): the forward clamps them
into their table, and ids outside ``[0, R)`` are not supported.

``embedding_bag_stacked`` is differentiable in its tables: under
autograd it runs as ``_Bags``, whose forward is the forward kernel and
whose backward is ``embedding_bag_stacked_backward`` (a CPU table: both
plain versions).  ``embedding_bag_stacked_plain`` is the same function
through the plain versions in both directions on any device (the DLRM's
``embedding_impl="torch"``).  ``embedding_bag_rows`` stays forward-only:
it raises if autograd would record it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.checks import check, on_cuda
from repro_torch.kernels.embedding_bag import ref

# kernel launches since the last reset_launches(); the plain versions never
# count
LAUNCHES = {"embedding_bag_rows": 0, "embedding_bag_backward": 0}

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
    float32 sum-pooled bags (forward only)."""
    if torch.is_grad_enabled() and table2d.requires_grad:
        raise RuntimeError("embedding_bag_rows is forward-only; train "
                           "through embedding_bag_stacked, whose tables "
                           "get the backward kernel's gradient")
    if not on_cuda((table2d, rows)):
        _check_ids_in_range(rows, table2d.shape[0], "embedding_bag_rows")
        return ref.embedding_bag_rows_ref(table2d, rows)
    return _launch(table2d, rows, 1, table2d.shape[0], torch.float32)


def embedding_bag_stacked(tables: torch.Tensor, idx: torch.Tensor,
                          out_dtype=None) -> torch.Tensor:
    """``tables (T, R, D)``, ``idx (B, T, P)`` int32 ids into each table ->
    ``(B, T, D)`` in ``out_dtype`` (bf16 or float32; default
    ``tables.dtype``), rounded once from float32 sums.  The kernel reads
    the rows in place from the ``(T*R, D)`` view of the tables: no copy,
    no padding.  Differentiable in ``tables`` (the backward kernel)."""
    out_dtype = out_dtype or tables.dtype
    if torch.is_grad_enabled() and tables.requires_grad:
        return _Bags.apply(tables, idx, out_dtype, False)
    return _stacked(tables, idx, out_dtype)


def embedding_bag_stacked_plain(tables: torch.Tensor, idx: torch.Tensor,
                                out_dtype=None) -> torch.Tensor:
    """``embedding_bag_stacked`` through the plain versions on any
    device, the backward included (launches nothing)."""
    out_dtype = out_dtype or tables.dtype
    if torch.is_grad_enabled() and tables.requires_grad:
        return _Bags.apply(tables, idx, out_dtype, True)
    return ref.embedding_bag_stacked_ref(tables, idx, out_dtype)


def _stacked(tables: torch.Tensor, idx: torch.Tensor,
             out_dtype) -> torch.Tensor:
    T, R, D = tables.shape
    B, T_idx, P = idx.shape
    if T_idx != T:
        raise ValueError(f"idx has {T_idx} tables, the stack {T}")
    if not on_cuda((tables, idx)):
        _check_ids_in_range(idx, R, "embedding_bag_stacked")
        return ref.embedding_bag_stacked_ref(tables, idx, out_dtype)
    if not (tables.is_contiguous() and idx.is_contiguous()):
        raise ValueError("embedding_bag_stacked: tables and idx must be "
                         "contiguous")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"embedding_bag_stacked: bf16 or float32 out, got "
                        f"{out_dtype}")
    out = _launch(tables.view(T * R, D), idx.view(B * T, P), T, R,
                  out_dtype)
    return out.view(B, T, D)


class _Bags(torch.autograd.Function):
    """Sum-pooled bags differentiable in the tables: the forward and
    backward wrappers (``plain``: both plain versions)."""

    @staticmethod
    def forward(ctx, tables, idx, out_dtype, plain):
        ctx.save_for_backward(idx)
        ctx.meta = (tables.shape[1], tables.dtype, plain)
        return (ref.embedding_bag_stacked_ref(tables, idx, out_dtype)
                if plain else _stacked(tables, idx, out_dtype))

    @staticmethod
    def backward(ctx, dpooled):
        idx, = ctx.saved_tensors
        R, dtype, plain = ctx.meta
        fn = (ref.embedding_bag_stacked_backward_ref if plain
              else embedding_bag_stacked_backward)
        return fn(dpooled.contiguous(), idx, R, dtype), None, None, None


_BWD_SIGNATURE = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                  ctypes.c_void_p]


def backward_functions():
    """The C entry points of the backward's library (argtypes set):
    ``(embedding_bag_backward, embedding_bag_zero)``.  Calling them
    directly bypasses the wrapper's checks and launch count;
    ``chip_smoke.py`` does so only to time back-to-back launches, and to
    time the library's own zero fill against ``torch.zeros``, which the
    wrapper takes (the faster on the card: PERF.md)."""
    lib = build.load("embedding_bag_backward")
    fn, zero = lib.embedding_bag_backward, lib.embedding_bag_zero
    if fn.argtypes is None:
        fn.argtypes = _BWD_SIGNATURE
        fn.restype = ctypes.c_int
        zero.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        zero.restype = ctypes.c_int
    return fn, zero


def backward_index(idx: torch.Tensor, rows_per_table: int) -> tuple:
    """The backward's index preparation: the entries' global rows
    ``t * R + idx[b, t, p]`` in flat (b, t, p) order, sorted stably, and
    the entry at each sorted position, both int32 (``torch.sort``)."""
    B, T, P = idx.shape
    offset = (torch.arange(T, dtype=torch.int32, device=idx.device)
              * rows_per_table)
    flat = (idx + offset[None, :, None]).reshape(-1)
    rows, perm = torch.sort(flat, stable=True)
    return rows, perm.to(torch.int32)


def backward_args(dpooled, rows, perm, P: int, out) -> list:
    """The C arguments (stream excluded) of ``embedding_bag_backward``."""
    D = dpooled.shape[-1]
    in_bf16 = dpooled.dtype == torch.bfloat16
    pairs = D % 2 == 0 and dpooled.data_ptr() % (4 if in_bf16 else 8) == 0
    return [dpooled.data_ptr(), rows.data_ptr(), perm.data_ptr(),
            rows.numel(), P, D, int(pairs), int(in_bf16),
            int(out.dtype == torch.bfloat16), out.data_ptr()]


def embedding_bag_stacked_backward(dpooled: torch.Tensor, idx: torch.Tensor,
                                   rows_per_table: int,
                                   dtype=torch.bfloat16) -> torch.Tensor:
    """The gradient of ``embedding_bag_stacked`` in its tables: ``dpooled
    (B, T, D)`` (bf16 or float32), ``idx (B, T, P)`` int32 ->
    ``dtables (T, rows_per_table, D)`` in ``dtype``: each row the float32
    sum of the ``dpooled[b, t]`` of every (b, p) naming it, in (b, p)
    order, rounded once; rows no bag names are 0 (``torch.zeros``)."""
    B, T, P = idx.shape
    D = dpooled.shape[-1]
    R = rows_per_table
    if tuple(dpooled.shape) != (B, T, D):
        raise ValueError(f"dpooled: expected shape {(B, T, D)}, got "
                         f"{tuple(dpooled.shape)}")
    if not on_cuda((dpooled, idx)):
        _check_ids_in_range(idx, R, "embedding_bag_stacked_backward")
        return ref.embedding_bag_stacked_backward_ref(dpooled, idx, R, dtype)
    if dpooled.dtype not in (torch.bfloat16, torch.float32) or \
            dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"embedding_bag_stacked_backward: bf16 or float32, "
                        f"got {dpooled.dtype} -> {dtype}")
    check(dpooled, "dpooled", (B, T, D), dpooled.dtype)
    check(idx, "idx", (B, T, P), torch.int32)
    if T * R >= 2 ** 31:
        raise ValueError(f"{T} tables of {R} rows exceed the kernel's "
                         "int32 rows")
    fn, _ = backward_functions()
    out = torch.zeros((T, R, D), dtype=dtype, device=dpooled.device)
    rows, perm = backward_index(idx, R)
    err = fn(*backward_args(dpooled, rows, perm, P, out),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag_backward: CUDA launch failed "
                           f"with cudaError_t {err}")
    LAUNCHES["embedding_bag_backward"] += 1
    return out
