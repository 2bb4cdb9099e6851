"""The port's models: the paper's DLRM and the transformer zoo
(``Model``: GQA with global and sliding-window layers, MLA + MoE,
Mamba-2, RWKV-6), each trainable and the zoo servable."""
from repro_torch.models.dlrm import (DLRM, DLRMConfig,  # noqa: F401
                                     comm_profile, param_shapes,
                                     resolve_embedding_impl)
from repro_torch.models.model_api import Model, resolve_decode_impl  # noqa: F401
