"""Public Model API for the serving path (port of
``repro/models/model_api.py``): ``param_defs``, ``init``, ``cache_defs``,
``init_cache``, ``prefill`` and ``decode_step``, for the GQA configs of
``models/transformer.py`` (global and sliding-window layers; a local
layer's cache is a ring of ``min(window, max_len)`` slots).

As in the reference, a ``Model`` holds no weights: ``init(generator)``
makes the parameter tree (the reference's tree, key for key:
``embed``, ``final_norm``, ``groups[i]["l{j}"]...`` stacked on a leading
layers dim, ``lm_head`` when embeddings are untied), and ``prefill`` and
``decode_step`` take it.  Activations are bf16; the logits are computed in
float32 from the bf16 operands, as the reference's
``preferred_element_type=float32`` einsum; ``prefill`` and ``decode_step``
turn off cuBLAS's bf16 reduced-precision reduction while they run (the
reference's dots reduce in float32).

``decode_impl`` ("auto", "torch" or "cuda") picks decode attention:
"torch" is the port of ``layers.decode_attention``, "cuda" the
``flash_decode`` kernel; "auto" gives "cuda" on the card and "torch" on
the CPU, and "cuda" on the CPU raises.  The cache's position ``pos`` is a
Python int (the reference keeps an int32 scalar on the device), and its
K/V tensors are written in place.  Training (``loss``), the mesh and its
specs come with a later slice.
"""
from __future__ import annotations

import math

import torch

from repro_torch.common.precision import float32_reduction
from repro_torch.common.pytree import ParamDef, materialize, tree_map
from repro_torch.core.engine import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.transformer import Group, _apply_layer, _norm_apply, _norm_defs

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
DECODE_IMPLS = ("auto", "torch", "cuda")


def resolve_decode_impl(impl: str, device) -> str:
    """``"auto"`` -> ``"cuda"`` on a CUDA device, ``"torch"`` on the CPU;
    ``"cuda"`` on a CPU device raises."""
    dev = torch.device(device)
    if impl not in DECODE_IMPLS:
        raise ValueError(f"decode_impl must be one of {DECODE_IMPLS}, got "
                         f"{impl!r}")
    if impl == "auto":
        return "cuda" if dev.type == "cuda" else "torch"
    if impl == "cuda" and dev.type != "cuda":
        raise ValueError("decode_impl='cuda' runs the flash_decode kernel and "
                         f"needs a CUDA device, got {dev}")
    return impl


def _group_defs(cfg, g: Group) -> dict:
    return {f"l{j}": T._stack_defs(T.layer_defs(cfg, kind), g.n)
            for j, kind in enumerate(g.kinds)}


class Model:
    """A GQA transformer (global and sliding-window layers) on ``device``
    (the card by default)."""

    def __init__(self, cfg, device="cuda", decode_impl: str = "auto"):
        T.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.decode_impl = resolve_decode_impl(decode_impl, self.device)
        self.groups = T.build_groups(cfg)
        self.compute_dtype = torch.bfloat16
        self.param_dtype = DTYPES[cfg.param_dtype]

    # ------------------------------------------------------------------ defs
    def param_defs(self) -> dict:
        cfg = self.cfg
        pd = self.param_dtype
        d: dict = {
            "embed": ParamDef((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                              init="normal"),
            "final_norm": _norm_defs(cfg),
            "groups": [_group_defs(cfg, g) for g in self.groups],
        }
        if not cfg.tie_embeddings:
            d["lm_head"] = ParamDef((cfg.d_model, cfg.vocab), ("embed", "vocab"),
                                    init="scaled")
        return tree_map(lambda x: ParamDef(x.shape, x.axes, init=x.init,
                                           dtype=pd), d)

    def init(self, generator: torch.Generator | None = None) -> dict:
        """The parameter tree drawn on the model's device from
        ``generator`` (a ``torch.Generator`` on that device)."""
        return materialize(self.param_defs(), generator, self.device)

    # -------------------------------------------------------------- plumbing
    def _embed(self, params, tokens):
        cfg = self.cfg
        x = params["embed"][tokens].to(self.compute_dtype)
        if cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(cfg.d_model),
                                 dtype=self.compute_dtype, device=x.device)
        return x

    def _logits(self, params, x):
        cfg = self.cfg
        if cfg.tie_embeddings:
            w = params["embed"].to(x.dtype).float().T
        else:
            w = params["lm_head"].to(x.dtype).float()
        logits = torch.matmul(x.float(), w)
        if cfg.tie_embeddings and cfg.embed_scale:
            logits = logits / math.sqrt(cfg.d_model)
        if cfg.final_softcap is not None:
            logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
        return logits

    def _run_groups(self, pgroups, x, *, mode, caches, positions,
                    decode: T.DecodeStep | None = None):
        """Every layer in order; ``caches`` (the stacked cache tree) is
        written in place."""
        cfg = self.cfg
        for gi, g in enumerate(self.groups):
            for i in range(g.n):
                for j, kind in enumerate(g.kinds):
                    p = tree_map(lambda t: t[i], pgroups[gi][f"l{j}"])
                    c = tree_map(lambda t: t[i], caches[gi][f"l{j}"])
                    x, _ = _apply_layer(cfg, kind, p, x, positions=positions,
                                        mode=mode, cache=c, decode=decode)
        return x

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    # ------------------------------------------------------------------ serve
    def cache_defs(self, batch: int, max_len: int):
        cfg = self.cfg
        layers = [{f"l{j}": T._stack_defs(T._cache_defs_for(cfg, kind, batch,
                                                            max_len), g.n)
                   for j, kind in enumerate(g.kinds)} for g in self.groups]
        return {"layers": layers,
                "pos": ParamDef((), (), init="zeros", dtype=torch.int32)}

    def init_cache(self, batch: int, max_len: int):
        """Zeroed K/V caches on the model's device, at position 0: a
        global layer's of ``max_len`` positions, a local layer's a ring of
        ``min(window, max_len)``."""
        defs = self.cache_defs(batch, max_len)
        return {"layers": materialize(defs["layers"], None, self.device),
                "pos": 0}

    def prefill(self, params, batch, max_len: int | None = None):
        """Forward over the prompt ``batch["tokens"]`` (B, S), building
        the decode cache.  Returns (last_logits (B, V) float32, cache)."""
        with float32_reduction():
            tokens = self._tokens(batch["tokens"])
            B, S = tokens.shape
            x = self._embed(params, tokens)
            max_len = max_len or S
            positions = torch.arange(S, device=self.device)[None].expand(B, S)
            cache = self.init_cache(B, max_len)
            x = self._run_groups(params["groups"], x, mode="prefill",
                                 caches=cache["layers"], positions=positions)
            x = _norm_apply(self.cfg, params["final_norm"], x)
            logits = self._logits(params, x[:, -1:])[:, 0]
            return logits, {"layers": cache["layers"], "pos": S}

    def decode_step(self, params, cache, tokens, decode_impl: str | None = None):
        """tokens (B, 1) at position ``cache["pos"]``.  Returns (logits
        (B, V) float32, cache at the next position); the K/V tensors are
        the same, written in place.  ``decode_impl`` overrides the
        model's."""
        impl = resolve_decode_impl(decode_impl or self.decode_impl,
                                   self.device)
        with float32_reduction():
            tokens = self._tokens(tokens)
            B = tokens.shape[0]
            pos = cache["pos"]
            x = self._embed(params, tokens)
            positions = torch.full((B, 1), pos, device=self.device)
            x = self._run_groups(params["groups"], x, mode="decode",
                                 caches=cache["layers"], positions=positions,
                                 decode=T.DecodeStep(pos, impl, B,
                                                     self.device))
            x = _norm_apply(self.cfg, params["final_norm"], x)
            logits = self._logits(params, x)[:, 0]
            return logits, {"layers": cache["layers"], "pos": pos + 1}
