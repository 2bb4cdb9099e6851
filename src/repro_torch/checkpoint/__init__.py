"""Atomic, asynchronous checkpoints (port of ``repro.checkpoint``)."""
from repro_torch.checkpoint.ckpt import (AsyncCheckpointer, gc_old,  # noqa: F401
                                         latest_step, restore, save)
