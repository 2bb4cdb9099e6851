"""Batched serving (port of ``repro.serve``)."""
from repro_torch.serve.engine import Request, Result, ServeEngine  # noqa: F401
