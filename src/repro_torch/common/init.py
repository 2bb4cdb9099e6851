"""Parameter initialisers (port of the init rules of
``repro/common/pytree.py::_init_one`` that the port's models use).

    zeros   -- 0
    ones    -- 1
    normal  -- 0.02 * N(0, 1)
    scaled  -- N(0, 1) / sqrt(fan_in) (lecun normal), fan_in = shape[-2]
               (shape[-1] for a vector)

Draws come from an explicit ``torch.Generator`` on the parameter's device,
in float32, and are rounded once to the parameter's dtype.  The stream is
PyTorch's, not JAX's: a model initialised here does not reproduce the
reference's weights (carry those across with ``repro_torch.convert``).
"""
from __future__ import annotations

import math

import torch

RULES = ("zeros", "ones", "normal", "scaled")


def init_scale(rule: str, shape: tuple) -> float:
    """The standard deviation ``rule`` draws with for a parameter of
    ``shape`` (0 for the constants ``zeros`` and ``ones``)."""
    if rule in ("zeros", "ones"):
        return 0.0
    if rule == "normal":
        return 0.02
    if rule == "scaled":
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        return 1.0 / math.sqrt(max(fan_in, 1))
    raise ValueError(f"unknown init {rule!r}; choose from {RULES}")


def fill_(x: torch.Tensor, rule: str,
          generator: torch.Generator | None) -> torch.Tensor:
    """Initialise ``x`` in place by ``rule``.  A stack (3 or more dims) is
    drawn one leading slice at a time, so the float32 draw never holds more
    than one slice: an (T, R, D) bf16 table stack of 8 GB needs 256 MB of
    scratch, not a 16 GB float32 copy."""
    std = init_scale(rule, tuple(x.shape))
    if rule == "zeros":
        return x.zero_()
    if rule == "ones":
        return x.fill_(1)
    slices = x if x.dim() >= 3 else (x,)
    for part in slices:
        draw = torch.randn(part.shape, generator=generator,
                           dtype=torch.float32, device=x.device)
        part.copy_(draw.mul_(std))
    return x


def make(shape: tuple, rule: str, dtype, generator: torch.Generator | None,
         device) -> torch.Tensor:
    """A new tensor of ``shape`` and ``dtype`` on ``device``, initialised
    by ``rule``."""
    return fill_(torch.empty(shape, dtype=dtype, device=device), rule,
                 generator)
