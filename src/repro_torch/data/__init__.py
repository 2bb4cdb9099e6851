"""Deterministic synthetic batches (port of ``repro.data``)."""
from repro_torch.data.pipeline import (Prefetcher, dlrm_batch,  # noqa: F401
                                       lm_batch, shard_batch)
