"""Drivers (port of ``repro.launch``): ``python -m repro_torch.launch.serve``
and ``python -m repro_torch.launch.run_campaign``."""
