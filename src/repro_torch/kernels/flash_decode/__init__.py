# Flash-decode kernel of the serving path: ops.py (wrappers the model
# dispatches to), ref.py (plain PyTorch version), csrc/flash_decode.cu
# (CUDA C++ for sm_90a).
from repro_torch.kernels.flash_decode.ops import (  # noqa: F401
    LAUNCHES, flash_decode, gqa_decode_attention, reset_launches)
