"""Wrapper of the DCQCN update kernel (``csrc/cc_update.cu``), behind the
reference's entry point ``dcqcn_update`` (``repro.kernels.cc_update.ops``).

For tensors on the CPU it returns the plain version from ``ref.py``; for
CUDA tensors it checks device, dtype, shape and contiguity, allocates the
outputs, launches on PyTorch's current stream, raises if the launch
returns a CUDA error, and adds one to ``LAUNCHES["dcqcn_update"]``.
There is no fallback: a CUDA tensor either goes through the kernel or
raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.cc import kernel_param_keys, make_dcqcn
from repro_torch.kernels import build
from repro_torch.kernels.cc_update import ref
from repro_torch.kernels.cc_update.ref import ORDER
from repro_torch.kernels.checks import check as _check
from repro_torch.kernels.checks import on_cuda as _on_cuda

# kernel launches since the last reset_launches(); only the CUDA branch
# counts, the plain version never does
LAUNCHES = {"dcqcn_update": 0}

# the parameter order of the C interface (make_dcqcn's kernel_param_keys)
PARAM_ORDER = ("cut_gap", "ecn_thresh", "fast_rounds", "g", "hai_after",
               "mss", "rai_frac", "rhai_frac", "timer")

_P = ctypes.c_void_p
_SIGNATURE = [_P] * 10 + [ctypes.c_float] * 10 + [ctypes.c_int] + [_P] * 8


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_function():
    """The C entry point of the built library (argtypes set).  Calling it
    directly bypasses the wrapper's checks and launch count;
    ``chip_smoke.py`` does so only to time back-to-back launches."""
    fn = build.load("cc_update").dcqcn_update
    if fn.argtypes is None:
        if tuple(kernel_param_keys(make_dcqcn())) != PARAM_ORDER:
            raise ValueError("make_dcqcn's parameter order differs from "
                             f"the kernel's {PARAM_ORDER}")
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
    return fn


def dcqcn_update(state: dict, ecn: torch.Tensor, line: torch.Tensor, t,
                 params: dict | None = None) -> dict:
    """``state``: dict of (F,) float32 tensors (the ``cc.make_dcqcn``
    layout, keys ``ORDER``); ``ecn`` and ``line`` (F,) float32; ``t`` the
    simulated time; ``params`` DCQCN parameters (defaults for the ones
    left out).  Returns the updated state dict (``jit`` passes through;
    the rate is the updated ``rc``)."""
    tensors = [state[k] for k in ORDER] + [ecn, line]
    if not _on_cuda(tensors):
        return ref.dcqcn_update_ref(state, ecn, line, t, params)
    if ecn.dim() != 1:
        raise ValueError(f"ecn must be (F,), got {tuple(ecn.shape)}")
    F = ecn.shape[0]
    for name, x in zip(ORDER + ("ecn", "line"), tensors):
        _check(x, name, (F,), torch.float32)
    p = ref.dcqcn_params(params)
    outs = [torch.empty_like(ecn) for _ in ORDER[:7]]
    stream = torch.cuda.current_stream().cuda_stream
    err = kernel_function()(*(x.data_ptr() for x in tensors),
                            float(t),
                            *(p[k] for k in PARAM_ORDER), F,
                            *(o.data_ptr() for o in outs), stream)
    if err != 0:
        raise RuntimeError(f"dcqcn_update: CUDA launch failed with "
                           f"cudaError_t {err}")
    LAUNCHES["dcqcn_update"] += 1
    new = dict(zip(ORDER[:7], outs))
    new["jit"] = state["jit"]
    return new
