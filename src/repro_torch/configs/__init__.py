"""Architecture registry (port of ``repro.configs``): ``get_config(name)``,
``smoke_config(name)``, ``get_model(name)`` and ``smoke_model(name)``.

Ported: ``"dlrm"`` (family ``recsys``, built as ``models.DLRM``) and,
built as ``models.Model`` (the serving path), the ``dense`` family's
``"tinyllama-1.1b"``, ``"phi4-mini-3.8b"`` (global GQA), ``"gemma2-9b"``
and ``"gemma3-27b"`` (sliding-window and global layers), the ``moe``
family's ``"deepseek-v2-236b"`` and ``"deepseek-v3-671b"`` (MLA + MoE),
``"zamba2-1.2b"`` (Mamba-2 with a shared attention block) and
``"rwkv6-3b"``.  The reference's encoder-decoder and VLM architectures
(``"whisper-base"``, ``"paligemma-3b"``) raise ``KeyError``: they come
with ROADMAP.md queue item 9.5.  Models are built on the card unless
``device="cpu"``.
"""
from __future__ import annotations

from repro_torch.configs import deepseek_v2_236b as _dsv2
from repro_torch.configs import deepseek_v3_671b as _dsv3
from repro_torch.configs import dlrm as _dlrm
from repro_torch.configs import gemma2_9b as _gemma2
from repro_torch.configs import gemma3_27b as _gemma3
from repro_torch.configs import phi4_mini_3_8b as _phi4
from repro_torch.configs import rwkv6_3b as _rwkv6
from repro_torch.configs import tinyllama_1_1b as _tinyllama
from repro_torch.configs import zamba2_1_2b as _zamba2
from repro_torch.configs.base import ModelConfig, ShapeConfig  # noqa: F401

_MODULES = {"tinyllama-1.1b": _tinyllama, "phi4-mini-3.8b": _phi4,
            "gemma2-9b": _gemma2, "gemma3-27b": _gemma3,
            "deepseek-v2-236b": _dsv2, "deepseek-v3-671b": _dsv3,
            "zamba2-1.2b": _zamba2, "rwkv6-3b": _rwkv6, "dlrm": _dlrm}

ARCHS = tuple(k for k in _MODULES if k != "dlrm")


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"architecture {name!r} is not ported yet (ported: "
                       f"{sorted(_MODULES)}); the encoder-decoder and VLM "
                       "architectures come with ROADMAP.md queue item 9.5")
    return _MODULES[name]


def get_config(name: str):
    return _module(name).CONFIG


def smoke_config(name: str):
    return _module(name).smoke()


def build_model(cfg, device="cuda", seed: int = 0):
    """The model of ``cfg``'s family on ``device``.  A DLRM draws its
    weights from ``seed`` at construction; a transformer ``Model`` holds
    none (``Model.init(generator)`` makes them, as in the reference)."""
    if cfg.family == "recsys":
        from repro_torch.models.dlrm import DLRM
        return DLRM(cfg, device=device, seed=seed)
    from repro_torch.models.model_api import Model
    return Model(cfg, device=device)


def get_model(name: str, device="cuda", seed: int = 0):
    return build_model(get_config(name), device=device, seed=seed)


def smoke_model(name: str, device="cuda", seed: int = 0):
    return build_model(smoke_config(name), device=device, seed=seed)
