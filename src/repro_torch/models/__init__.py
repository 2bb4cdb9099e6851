"""The port's models: the paper's DLRM (forward only)."""
from repro_torch.models.dlrm import (DLRM, DLRMConfig,  # noqa: F401
                                     comm_profile, param_shapes,
                                     resolve_embedding_impl)
