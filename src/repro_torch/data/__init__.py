"""Deterministic synthetic batches (port of ``repro.data``)."""
from repro_torch.data.pipeline import dlrm_batch  # noqa: F401
