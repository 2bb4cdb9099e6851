# Embedding-bag kernel of the DLRM forward: ops.py (wrappers the model
# dispatches to), ref.py (plain PyTorch versions), csrc/embedding_bag.cu
# (CUDA C++ for sm_90a).
from repro_torch.kernels.embedding_bag.ops import (  # noqa: F401
    LAUNCHES, embedding_bag_rows, embedding_bag_stacked, reset_launches)
