"""Architecture registry (port of ``repro.configs``): ``get_config(name)``,
``smoke_config(name)``, ``get_model(name)`` and ``smoke_model(name)``.

Only ``"dlrm"`` is ported; the transformer architectures of the reference
come with the serving slice (ROADMAP.md, queue item 9) and raise
``KeyError`` here.  Models are built on the card unless ``device="cpu"``.
"""
from __future__ import annotations

from repro_torch.configs import dlrm as _dlrm

_MODULES = {"dlrm": _dlrm}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"architecture {name!r} is not ported yet (ported: "
                       f"{sorted(_MODULES)}); the others come with ROADMAP.md "
                       "queue item 9, the training and serving stack")
    return _MODULES[name]


def get_config(name: str):
    return _module(name).CONFIG


def smoke_config(name: str):
    return _module(name).smoke()


def get_model(name: str, device="cuda", seed: int = 0):
    from repro_torch.models.dlrm import DLRM
    return DLRM(get_config(name), device=device, seed=seed)


def smoke_model(name: str, device="cuda", seed: int = 0):
    from repro_torch.models.dlrm import DLRM
    return DLRM(smoke_config(name), device=device, seed=seed)
