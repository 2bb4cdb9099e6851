"""The port's models: the paper's DLRM (forward only) and the
global-attention GQA transformers of the serving path."""
from repro_torch.models.dlrm import (DLRM, DLRMConfig,  # noqa: F401
                                     comm_profile, param_shapes,
                                     resolve_embedding_impl)
from repro_torch.models.model_api import Model, resolve_decode_impl  # noqa: F401
