# Engine-step kernels: ops.py (wrappers the engine dispatches to), ref.py
# (plain PyTorch versions), csrc/engine_step.cu (CUDA C++ for sm_90a).
from repro_torch.kernels.engine_step.ops import (  # noqa: F401
    LAUNCHES, fused_signals_policy, reset_launches, segment_reduce,
    segment_reduce_pfc)
