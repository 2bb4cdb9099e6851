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

**The log-sum-exp instantiation** (``flash_decode_lse``: the C entry
point given an ``lse`` output): the same attention over each rank's
block of a cache split along the sequence, returning the output in float32,
normalised by the row's own sum, and each row's log-sum-exp (B, Hkv, G)
float32, so that the ranks merge exactly (``models.layers.merge_split``).
A length of 0 is taken (a rank whose block lies past the decode position):
the row's output is 0 and its lse -inf.  bf16 or int8 caches, softcap
included; q bf16 on the card; ``LAUNCHES["flash_decode_lse"]`` counts it.
On the CPU it returns ``ref.flash_decode_ref(..., lse=True)`` (or the
int8 version).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.checks import check, on_cuda
from repro_torch.kernels.flash_decode import ref

# kernel launches since the last reset_launches(); the plain version never
# counts
LAUNCHES = {"flash_decode": 0, "flash_decode_lse": 0}

CHUNK = 64           # cache positions per partial of the split pass
MAX_G, MAX_D, MAX_GD = 16, 256, 2048

_SIGNATURE = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_void_p]


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
                v_scale=None, lse=None) -> list:
    """The C arguments (stream excluded) for ``q (B, Hkv, G, D)`` over
    ``k``/``v (B, S, Hkv, D)`` into ``out``; the softcap goes as 0 for
    none, the scales of an int8 cache and the log-sum-exp output ``lse``
    (which takes the log-sum-exp route, ``out`` float32) as null for
    none."""
    B, Hkv, G, D = q.shape
    ptr = (lambda t: 0 if t is None else t.data_ptr())
    return [q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(), B,
            k.shape[1], Hkv, G, D, int(q.dtype == torch.float32), CHUNK,
            splits, float(softcap or 0.0), ptr(k_scale), ptr(v_scale),
            ptr(part_acc), ptr(part_ml), out.data_ptr(), ptr(lse)]


def _check_softcap(softcap) -> None:
    if softcap is not None and not (0.0 < float(softcap) < float("inf")):
        raise ValueError(f"flash_decode: softcap must be a positive finite "
                         f"float or None, got {softcap}")


def _check_lengths(length: torch.Tensor, S: int, lo: int = 1) -> None:
    if length.numel() and (int(length.min()) < lo or int(length.max()) > S):
        raise ValueError(f"flash_decode: lengths must lie in [{lo}, {S}], "
                         f"got [{int(length.min())}, {int(length.max())}]")


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


def _card_checks(name: str, q, k, v, length, k_scale, v_scale, quant,
                 dtypes: tuple) -> None:
    """The CUDA path's checks of ``flash_decode``'s arguments (q's dtype
    among ``dtypes``)."""
    B, Hkv, G, D = q.shape
    S = k.shape[1]
    if q.dtype not in dtypes:
        names = {torch.bfloat16: "bf16", torch.float32: "float32"}
        raise TypeError(f"{name}: q must be "
                        f"{' or '.join(names[t] for t in dtypes)}, got "
                        f"{q.dtype}")
    if not (G <= MAX_G and D <= MAX_D and G * D <= MAX_GD):
        raise ValueError(f"{name}: G={G}, D={D} outside the kernel's "
                         f"limits (G <= {MAX_G}, D <= {MAX_D}, G * D <= "
                         f"{MAX_GD})")
    check(q, "q", (B, Hkv, G, D), q.dtype)
    check(k, "k", (B, S, Hkv, D), k.dtype if quant else q.dtype)
    check(v, "v", (B, S, Hkv, D), k.dtype if quant else q.dtype)
    check(length, "length", (B,), torch.int32)
    if quant:
        check(k_scale, "k_scale", (B, S, Hkv), torch.float32)
        check(v_scale, "v_scale", (B, S, Hkv), torch.float32)


def _plain(q, k, v, length, max_length, softcap, k_scale, v_scale, quant,
           lse: bool, lo: int):
    """The CPU path: the lengths checked (from ``lo``), the plain
    version."""
    _check_lengths(length, k.shape[1], lo)
    if max_length is not None:
        _check_max_length(length, max_length)
    if quant:
        return ref.flash_decode_quant_ref(q, k, v, k_scale, v_scale, length,
                                          softcap, lse=lse)
    return ref.flash_decode_ref(q, k, v, length, softcap, lse=lse)


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
    _check_softcap(softcap)
    quant = _check_quant(q, k, v, k_scale, v_scale)
    if not on_cuda((q, k, v, length) + ((k_scale, v_scale) if quant
                                         else ())):
        return _plain(q, k, v, length, max_length, softcap, k_scale,
                      v_scale, quant, False, 1)
    _card_checks("flash_decode", q, k, v, length, k_scale, v_scale, quant,
                 (torch.bfloat16,) if quant
                 else (torch.bfloat16, torch.float32))
    if max_length is not None and max_length < 1:
        raise ValueError(f"flash_decode: max_length {max_length} < 1")
    out = torch.empty_like(q)
    if q.shape[0] == 0:
        return out
    splits = n_splits(k.shape[1], max_length)
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


def flash_decode_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: torch.Tensor, max_length: int | None = None,
                     softcap: float | None = None,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None) -> tuple:
    """``flash_decode``'s arguments (lengths from 0) -> ``(out (B, Hkv, G,
    D) float32, lse (B, Hkv, G) float32)``: the log-sum-exp instantiation
    (the module docstring).  On the card q is bf16 and the tensors take
    16-byte copies (D a multiple of 8, of 16 with int8; 16-byte aligned),
    else it raises."""
    B, Hkv, G, D = q.shape
    _check_softcap(softcap)
    quant = _check_quant(q, k, v, k_scale, v_scale)
    if not on_cuda((q, k, v, length) + ((k_scale, v_scale) if quant
                                         else ())):
        return _plain(q, k, v, length, max_length, softcap, k_scale,
                      v_scale, quant, True, 0)
    _card_checks("flash_decode_lse", q, k, v, length, k_scale, v_scale,
                 quant, (torch.bfloat16,))
    if D % (16 if quant else 8) or not (vector_loads(k, v)
                                        and q.data_ptr() % 16 == 0):
        raise ValueError("flash_decode_lse: the kernel takes 16-byte copies "
                         f"only (D={D}, q, k, v 16-byte aligned)")
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((B, Hkv, G), dtype=torch.float32, device=q.device)
    if B == 0:
        return out, lse
    splits = n_splits(k.shape[1], None if max_length is None
                      else max(1, max_length))
    part_acc, part_ml = scratch(q, splits)
    stream = torch.cuda.current_stream().cuda_stream
    err = kernel_function()(*kernel_args(q, k, v, length, out, splits,
                                         part_acc, part_ml, softcap, k_scale,
                                         v_scale, lse), stream)
    if err != 0:
        raise RuntimeError(f"flash_decode_lse: CUDA launch failed with "
                           f"cudaError_t {err}")
    LAUNCHES["flash_decode_lse"] += 1
    return out, lse


def gqa_decode_attention_lse(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, length: torch.Tensor,
                             max_length: int | None = None,
                             softcap: float | None = None,
                             k_scale: torch.Tensor | None = None,
                             v_scale: torch.Tensor | None = None) -> tuple:
    """q: (B, 1, Hq, D) over this rank's block (B, S_r, Hkv, D) of a cache
    split along the sequence; length (B,) int32 from 0.  Returns (out
    (B, 1, Hq, D) float32, lse (B, 1, Hq) float32), the pair
    ``models.layers.merge_split`` merges across the ranks."""
    B, _, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    out, lse = flash_decode_lse(q.reshape(B, Hkv, Hq // Hkv, D), k_cache,
                                v_cache, length, max_length, softcap,
                                k_scale, v_scale)
    return out.reshape(B, 1, Hq, D), lse.reshape(B, 1, Hq)
