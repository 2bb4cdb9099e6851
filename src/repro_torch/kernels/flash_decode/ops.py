"""Wrappers of the flash-decode CUDA kernel (``csrc/flash_decode.cu``), the
counterparts of ``repro/kernels/flash_decode/flash_decode.py::flash_decode``
and ``repro/kernels/flash_decode/ops.py::gqa_decode_attention``.

For tensors on the CPU each wrapper checks that every length lies in ``[1,
S]`` and returns the plain version from ``ref.py``. For CUDA tensors it
checks device, dtype (q, k and v all bf16 or all float32, or bf16 q over
an int8 cache with its float32 scales; int32 lengths), shapes, contiguity
and the kernel's limits (G <= 16, D <= 256, G * D <= 2048), allocates the
output and the split pass's scratch, launches on PyTorch's current stream,
raises if the launch returns a CUDA error, and adds one to
``LAUNCHES["flash_decode"]``. There is no fallback: a CUDA tensor either
goes through the kernel or raises. On the card the lengths are not
range-checked (that would wait for the device): lengths above S read S
positions, and lengths below 1 are not supported.

Any S is taken (the Pallas kernel needs S % block_s == 0).  The kernel
splits the first ``max_length`` cache positions into fixed chunks of
``CHUNK`` keys, computes each chunk's partial softmax sums (one warp per
chunk), and merges them in a second pass; ``max_length`` (at least the
largest length, S by default) only sizes that split, and the result does
not depend on it: a chunk that starts at or past its row's length writes
nothing, and the merge reads only the row's first ``ceil(length /
CHUNK)`` partials (``split_plan``).

``softcap`` (a positive float, or None for none) passes the scaled scores
through ``softcap * tanh(s / softcap)`` before the softmax, as the
reference's ``layers.decode_attention`` does for Gemma-2: a template flag
of the kernel, so that the code without it is unchanged.

An int8 cache (the reference's ``kv_quant_int8``): ``k``/``v`` int8 with
``k_scale``/``v_scale`` (B, S, Hkv) float32, one scale per (position, kv
head), and q bf16.  The kernel's int8 instantiation (a template flag
beside the softcap's) folds the key scales into the scores and the value
scales into the probability weights, as the reference's
``layers.decode_attention_quant``; on the CPU the wrapper returns
``ref.flash_decode_quant_ref``.  An int8 CUDA tensor goes through that
instantiation or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.checks import check, on_cuda
from repro_torch.kernels.flash_decode import ref

# kernel launches since the last reset_launches(); the plain version never
# counts
LAUNCHES = {"flash_decode": 0}

CHUNK = 64           # cache positions per partial of the split pass
MAX_G, MAX_D, MAX_GD = 16, 256, 2048

_SIGNATURE = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_function():
    """The C entry point of the built library (argtypes set).  Calling it
    directly bypasses the wrapper's checks and launch count;
    ``chip_smoke.py`` does so only to time back-to-back launches."""
    fn = build.load("flash_decode").flash_decode
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
    return fn


def n_splits(S: int, max_length: int | None) -> int:
    """Chunks of ``CHUNK`` positions covering ``min(max_length, S)``."""
    span = S if max_length is None else max(1, min(int(max_length), S))
    return -(-span // CHUNK)


def scratch_shapes(shape: tuple, splits: int) -> tuple:
    """The float32 scratch shapes ``(acc, m_and_l)`` of the split pass
    for ``q`` of ``shape (B, Hkv, G, D)`` over ``splits`` chunks, or
    ``(None, None)`` for one chunk (its block writes the output)."""
    if splits == 1:
        return None, None
    B, Hkv, G, D = shape
    return (B, Hkv, splits, G, D), (B, Hkv, splits, 2, G)


def split_plan(lengths, S: int, max_length: int | None = None,
               shape: tuple | None = None) -> dict:
    """The kernel's split, in plain Python, for rows of ``lengths`` over a
    cache of ``S`` positions: ``n_splits`` chunk blocks per (kv head, row)
    in the grid; ``chunks_read[b]``, the chunks of row b that hold keys
    (``ceil(length / CHUNK)``, at most ``n_splits``): only their blocks
    write a partial and the merge reads only those; ``merge``, whether the
    merge pass runs; and, for ``shape = (B, Hkv, G, D)``, the scratch
    shapes ``acc`` and ``ml`` (``scratch_shapes``)."""
    splits = n_splits(S, max_length)
    reads = [min(splits, -(-min(max(int(n), 0), S) // CHUNK))
             for n in lengths]
    acc, ml = (None, None) if shape is None else scratch_shapes(shape, splits)
    return {"n_splits": splits, "chunks_read": reads, "merge": splits > 1,
            "acc": acc, "ml": ml}


def scratch(q: torch.Tensor, splits: int) -> tuple:
    """The split pass's float32 partial sums ``(acc, m_and_l)`` for
    ``splits`` chunks, or ``(None, None)`` for one chunk."""
    return tuple(None if shp is None else torch.empty(
        shp, dtype=torch.float32, device=q.device)
        for shp in scratch_shapes(tuple(q.shape), splits))


def vector_loads(k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the kernel fills its shared-memory tiles with 16-byte
    copies (D a multiple of 16 bytes and K, V 16-byte aligned) or, where
    not, with scalar loads (the kernel decides the same way)."""
    per16 = 16 // k.element_size()
    return (k.shape[-1] % per16 == 0 and k.data_ptr() % 16 == 0
            and v.data_ptr() % 16 == 0)


def kernel_args(q, k, v, length, out, splits: int, part_acc, part_ml,
                softcap: float | None = None, k_scale=None,
                v_scale=None) -> list:
    """The C arguments (stream excluded) for ``q (B, Hkv, G, D)`` over
    ``k``/``v (B, S, Hkv, D)`` into ``out``; the softcap goes as 0 for
    none, the scales of an int8 cache as null for none."""
    B, Hkv, G, D = q.shape
    ptr = (lambda t: 0 if t is None else t.data_ptr())
    return [q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(), B,
            k.shape[1], Hkv, G, D, int(q.dtype == torch.float32), CHUNK,
            splits, float(softcap or 0.0), ptr(k_scale), ptr(v_scale),
            ptr(part_acc), ptr(part_ml), out.data_ptr()]


def _check_softcap(softcap) -> None:
    if softcap is not None and not (0.0 < float(softcap) < float("inf")):
        raise ValueError(f"flash_decode: softcap must be a positive finite "
                         f"float or None, got {softcap}")


def _check_lengths(length: torch.Tensor, S: int) -> None:
    if length.numel() and (int(length.min()) < 1 or int(length.max()) > S):
        raise ValueError(f"flash_decode: lengths must lie in [1, {S}], got "
                         f"[{int(length.min())}, {int(length.max())}]")


def _check_max_length(length: torch.Tensor, max_length: int) -> None:
    if length.numel() and max_length < int(length.max()):
        raise ValueError(f"flash_decode: max_length {max_length} is below "
                         f"the longest row's length {int(length.max())}; "
                         "the kernel reads only the first max_length "
                         "positions")


def _check_quant(q, k, v, k_scale, v_scale) -> bool:
    """Whether the cache is int8; raises where the scales and the cache's
    dtype disagree, or their shapes or dtypes are off."""
    quant = k.dtype == torch.int8
    if quant != (k_scale is not None) or (k_scale is None) != (
            v_scale is None) or (v.dtype == torch.int8) != quant:
        raise TypeError("flash_decode: an int8 cache (k and v int8) takes "
                        "k_scale and v_scale, a bf16 or float32 one neither; "
                        f"got k {k.dtype}, v {v.dtype}, scales "
                        f"{k_scale is not None}, {v_scale is not None}")
    if quant:
        B, S, Hkv, _ = k.shape
        for t, name in ((k_scale, "k_scale"), (v_scale, "v_scale")):
            if t.shape != (B, S, Hkv) or t.dtype != torch.float32:
                raise ValueError(f"flash_decode: {name} must be ({B}, {S}, "
                                 f"{Hkv}) float32, got {tuple(t.shape)} "
                                 f"{t.dtype}")
    return quant


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 length: torch.Tensor, max_length: int | None = None,
                 softcap: float | None = None,
                 k_scale: torch.Tensor | None = None,
                 v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """``q (B, Hkv, G, D)``; ``k``/``v (B, S, Hkv, D)``; ``length (B,)``
    int32 -> ``(B, Hkv, G, D)`` attention output in ``q.dtype``.

    ``max_length`` bounds the positions read: the kernel splits only the
    first ``max_length`` positions into chunks, so it must be at least
    ``max(length)`` (None reads up to S).  The card does not check it,
    which would read ``length`` back to the host on every call; the CPU
    path raises where it is below ``max(length)``.  ``softcap`` and the
    int8 cache's ``k_scale``/``v_scale``: see the module docstring."""
    B, Hkv, G, D = q.shape
    S = k.shape[1]
    _check_softcap(softcap)
    quant = _check_quant(q, k, v, k_scale, v_scale)
    tensors = (q, k, v, length) + ((k_scale, v_scale) if quant else ())
    if not on_cuda(tensors):
        _check_lengths(length, S)
        if max_length is not None:
            _check_max_length(length, max_length)
        if quant:
            return ref.flash_decode_quant_ref(q, k, v, k_scale, v_scale,
                                              length, softcap)
        return ref.flash_decode_ref(q, k, v, length, softcap)
    if q.dtype not in ((torch.bfloat16,) if quant
                       else (torch.bfloat16, torch.float32)):
        raise TypeError(f"flash_decode: q must be bf16{'' if quant else ' or float32'}"
                        f", got {q.dtype}")
    if not (G <= MAX_G and D <= MAX_D and G * D <= MAX_GD):
        raise ValueError(f"flash_decode: G={G}, D={D} outside the kernel's "
                         f"limits (G <= {MAX_G}, D <= {MAX_D}, G * D <= "
                         f"{MAX_GD})")
    check(q, "q", (B, Hkv, G, D), q.dtype)
    check(k, "k", (B, S, Hkv, D), k.dtype if quant else q.dtype)
    check(v, "v", (B, S, Hkv, D), k.dtype if quant else q.dtype)
    check(length, "length", (B,), torch.int32)
    if quant:
        check(k_scale, "k_scale", (B, S, Hkv), torch.float32)
        check(v_scale, "v_scale", (B, S, Hkv), torch.float32)
    if max_length is not None and max_length < 1:
        raise ValueError(f"flash_decode: max_length {max_length} < 1")
    out = torch.empty_like(q)
    if B == 0:
        return out
    splits = n_splits(S, max_length)
    part_acc, part_ml = scratch(q, splits)
    stream = torch.cuda.current_stream().cuda_stream
    err = kernel_function()(*kernel_args(q, k, v, length, out, splits,
                                         part_acc, part_ml, softcap, k_scale,
                                         v_scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_decode: CUDA launch failed with "
                           f"cudaError_t {err}")
    LAUNCHES["flash_decode"] += 1
    return out


def gqa_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, length: torch.Tensor,
                         max_length: int | None = None,
                         softcap: float | None = None,
                         k_scale: torch.Tensor | None = None,
                         v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B, 1, Hq, D) over cache (B, S, Hkv, D); length (B,) int32.
    Returns (B, 1, Hq, D).  Drop-in for ``models.layers.decode_attention``
    (and, with an int8 cache and its scales, for
    ``decode_attention_quant``) with ``length`` on the device."""
    B, _, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    out = flash_decode(q.reshape(B, Hkv, Hq // Hkv, D), k_cache, v_cache,
                       length, max_length, softcap, k_scale, v_scale)
    return out.reshape(B, 1, Hq, D)
