"""Drivers (port of ``repro.launch``): ``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train`` and ``python -m
repro_torch.launch.run_campaign``."""
