"""DLRM with the paper's Table II parameters (the paper's own workload;
port of ``repro/configs/dlrm.py``)."""
import dataclasses

from repro_torch.models.dlrm import DLRMConfig

CONFIG = DLRMConfig()


def smoke():
    return dataclasses.replace(
        CONFIG, n_dense=16, n_tables=4, emb_dim=8, pooling=5,
        rows_per_table=100, bot_mlp=(32, 32), top_mlp=(32, 32))
