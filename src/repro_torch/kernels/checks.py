"""Input checks shared by the kernel wrappers (``*/ops.py``)."""
from __future__ import annotations

import torch


def on_cuda(tensors) -> bool:
    """True if every tensor is on one CUDA device, False if all are on the
    CPU; raises on a mix."""
    devs = {x.device for x in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs span devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return True


def check(x: torch.Tensor, name: str, shape: tuple, dtype) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
