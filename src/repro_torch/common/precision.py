"""Matmul precision shared by the port's models."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def float32_reduction():
    """Turn off ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_
    reduction`` (on by default, which lets cuBLAS add a bf16 product's
    partial sums in bf16) for the duration, and restore it after: the
    reference's dots reduce in float32."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = saved
