# DCQCN per-flow update kernel: ops.py (wrapper, the reference's entry
# point dcqcn_update), ref.py (plain PyTorch version), csrc/cc_update.cu
# (CUDA C++ for sm_90a).
from repro_torch.kernels.cc_update.ops import (  # noqa: F401
    LAUNCHES, ORDER, dcqcn_update, reset_launches)
