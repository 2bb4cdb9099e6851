"""Public Model API for the serving path (port of
``repro/models/model_api.py``): ``param_defs``, ``init``, ``cache_defs``,
``init_cache``, ``prefill`` and ``decode_step``, for the configs of
``models/transformer.py``: GQA with global and sliding-window layers (a
local layer's cache is a ring of ``min(window, max_len)`` slots) and an
optional int8 KV cache, MLA with a dense or MoE FFN (DeepSeek), Mamba-2
with Zamba2's shared attention block, and RWKV-6.

As in the reference, a ``Model`` holds no weights: ``init(generator)``
makes the parameter tree (the reference's tree, key for key: ``embed``,
``final_norm``, ``groups[i]["l{j}"]...`` stacked on a leading layers dim,
``lm_head`` when embeddings are untied, ``shared_block`` for Zamba2), and
``prefill`` and ``decode_step`` take it. Activations are bf16; the logits
are computed in float32 from the bf16 operands, as the reference's
``preferred_element_type=float32`` einsum; ``prefill`` and ``decode_step``
turn off cuBLAS's bf16 reduced-precision reduction while they run (the
reference's dots reduce in float32).

``decode_impl`` ("auto", "torch" or "cuda") picks decode attention:
"torch" is the port of ``layers.decode_attention``, "cuda" the
``flash_decode`` kernel; "auto" gives "cuda" on the card and "torch" on
the CPU, and "cuda" on the CPU raises. The cache's position ``pos`` is a
Python int (the reference keeps an int32 scalar on the device), and its
K/V tensors, latent caches and recurrent states are written in place.

``loss(params, batch)`` is the reference's next-token cross-entropy with
an optional ``loss_mask``: the stack in ``mode="train"`` (the prefill's
math without a cache), each stacked period rematerialised in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``), the
logits, log-sum-exp and gather in float32.  The VLM and encoder-decoder
extras come with ROADMAP.md queue item 9.5.

**On a mesh** (``Model(cfg, mesh=...)``): ``rules``, ``param_specs``,
``input_specs`` (shapes and dtypes), ``batch_pspecs`` and ``cache_rules``
are the reference's, spec for spec (MoE configs under ``ep_a2a`` take
``moe_param_overrides``).  On a live mesh ``loss``, ``prefill`` and
``decode_step`` take this rank's shards of the parameters (the
``param_specs`` layout) and its rows of the batch (``shard_batch``): every
leaf is gathered whole for the compute, but the MoE experts' ``w1``,
``w3``, ``w2``, which the mesh bodies read as shards (``models/moe.py``).
A Megatron-style layout that keeps dense layers sharded through the
compute is later work.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.precision import float32_reduction
from repro_torch.common.pytree import (ParamDef, map_with_specs, materialize,
                                       specs_of, tree_map)
from repro_torch.common.sharding import MeshRules, P, gather_full
from repro_torch.core.engine import resolve_device
from repro_torch.models import moe as MOE
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


class ShapeDtype(tuple):
    """(shape, dtype) of a model input: the reference's
    ``jax.ShapeDtypeStruct`` without an array library."""

    def __new__(cls, shape, dtype):
        return super().__new__(cls, (tuple(shape), dtype))

    @property
    def shape(self) -> tuple:
        return self[0]

    @property
    def dtype(self):
        return self[1]


def _abstract(defs):
    return tree_map(lambda d: ShapeDtype(d.shape, d.dtype)
                    if isinstance(d, ParamDef) else d, defs)


def _is_expert_leaf(path: tuple) -> bool:
    return len(path) >= 2 and path[-2] == "moe" and path[-1] in BODY_LEAVES


BODY_LEAVES = ("w1", "w3", "w2")


class Model:
    """A model of the serving zoo (``transformer.SUPPORTED_KINDS``) on
    ``device`` (the card by default), over ``mesh`` when one is given."""

    def __init__(self, cfg, device="cuda", decode_impl: str = "auto",
                 mesh=None):
        T.check_supported(cfg)
        self.cfg = cfg
        self.mesh = mesh
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
        if cfg.shared_attn_period:
            d["shared_block"] = T.layer_defs(cfg, ("gqa_g", "mlp"))
        return tree_map(lambda x: ParamDef(x.shape, x.axes, init=x.init,
                                           dtype=pd), d)

    def init(self, generator: torch.Generator | None = None) -> dict:
        """The parameter tree drawn on the model's device from
        ``generator`` (a ``torch.Generator`` on that device)."""
        return materialize(self.param_defs(), generator, self.device)

    # ----------------------------------------------------------------- mesh
    def rules(self) -> MeshRules:
        if self.mesh is None:
            raise ValueError("rules() needs Model(cfg, mesh=...)")
        overrides = MOE.moe_param_overrides(self.cfg) or {}
        return MeshRules.create(self.mesh, overrides)

    def param_specs(self, rules: MeshRules | None = None):
        return specs_of(self.param_defs(), rules or self.rules())

    def input_specs(self, shape) -> dict:
        """(shape, dtype) of every model input of a shape cell."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        if cfg.vlm_prefix_len or cfg.enc_dec:
            raise NotImplementedError(f"{cfg.name}: the VLM and encoder-"
                                      "decoder inputs come with ROADMAP.md "
                                      "queue item 9.5")
        if shape.kind in ("train", "prefill"):
            return {"tokens": ShapeDtype((B, S), torch.int32)}
        return {"tokens": ShapeDtype((B, 1), torch.int32),
                "cache": _abstract(self.cache_defs(B, S))}

    def batch_pspecs(self, shape, rules: MeshRules | None = None):
        rules = rules or self.rules()
        B = shape.global_batch
        specs = self.input_specs(shape)
        if shape.kind in ("train", "prefill"):
            s = specs["tokens"]
            return {"tokens": rules.pspec(("batch",) + (None,)
                                          * (len(s.shape) - 1), s.shape)}
        cache_rules = self.cache_rules(shape)
        return {"tokens": cache_rules.pspec(("batch", None), (B, 1)),
                "cache": specs_of(self.cache_defs(B, shape.seq_len),
                                  cache_rules)}

    def cache_rules(self, shape) -> MeshRules:
        overrides = dict(MOE.moe_param_overrides(self.cfg) or {})
        if shape.cache_shard == "seq":
            overrides.update({"batch": (), "seq": ("pod", "data")})
        elif self.cfg.decode_seq_shard:
            overrides.update({"seq": ("model",), "kv_heads": ()})
        else:
            overrides.update({"seq": ()})
        return MeshRules.create(self.mesh, overrides)

    def _live(self) -> bool:
        return self.mesh is not None and self.mesh.is_live

    def compute_params(self, params):
        """The tree the layers read: on a live mesh every leaf gathered
        whole from this rank's shard (the MoE experts' ``w1``/``w3``/``w2``
        kept as shards, checked against their mesh body's layout);
        ``params`` itself otherwise."""
        if not self._live():
            return params
        specs = self.param_specs()
        body = MOE.BODY_SPECS.get(self.cfg.moe_impl, {})
        moe_mesh = MOE.uses_mesh(self.cfg, self.mesh)

        def one(node, spec, path):
            if moe_mesh and _is_expert_leaf(path):
                want = P(None, *body[path[-1]])     # the layers dim first
                if spec != want:
                    raise ValueError(f"{'.'.join(path)}: spec {spec}, the "
                                     f"{self.cfg.moe_impl} body reads {want}")
                return node
            return gather_full(node, spec, self.mesh)
        return map_with_specs(one, params, specs)

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

    def _run_groups(self, params, x, *, mode, caches, positions,
                    decode: T.DecodeStep | None = None):
        """Every layer in order; ``caches`` (the stacked cache tree) is
        written in place; a shared block takes ``params["shared_block"]``.
        In ``mode="train"`` there is no cache, and each period (one index
        of a group's stack, all its sub-layers) is checkpointed: its
        activations are recomputed in the backward."""
        cfg = self.cfg
        pgroups, shared = params["groups"], params.get("shared_block")
        for gi, g in enumerate(self.groups):
            for i in range(g.n):
                def period(x, gi=gi, g=g, i=i):
                    for j, kind in enumerate(g.kinds):
                        p = tree_map(lambda t: t[i], pgroups[gi][f"l{j}"])
                        c = (None if caches is None else
                             tree_map(lambda t: t[i], caches[gi][f"l{j}"]))
                        x, _ = _apply_layer(cfg, kind, p, x,
                                            positions=positions, mode=mode,
                                            cache=c, decode=decode,
                                            shared_params=shared,
                                            mesh=self.mesh)
                    return x
                if mode == "train":
                    x = checkpoint(period, x, use_reentrant=False)
                else:
                    x = period(x)
        return x

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    # ------------------------------------------------------------------ train
    def loss(self, params, batch) -> torch.Tensor:
        """Next-token cross-entropy (a float32 scalar) of
        ``batch["tokens"]`` (B, S), over the positions ``batch["loss_mask"]``
        (B, S) keeps when it is given."""
        return self._loss(self.compute_params(params), batch)

    def mesh_local(self, path: tuple) -> bool:
        """Whether the mesh step hands ``mesh_loss`` this leaf as this
        rank's block (the MoE experts under a mesh body) rather than
        whole."""
        return MOE.uses_mesh(self.cfg, self.mesh) and _is_expert_leaf(path)

    def mesh_loss(self, params, batch) -> torch.Tensor:
        """This rank's share of the global batch's loss (the shares sum,
        over the batch axes, to ``loss`` of the whole batch when every
        row counts as many tokens): ``params`` whole but the
        ``mesh_local`` leaves, ``batch`` the global batch."""
        from repro_torch.data.pipeline import shard_batch
        if "loss_mask" in batch:
            raise NotImplementedError(
                "a loss_mask over a mesh: the shares of a masked mean do not "
                "add up to the global mean")
        tokens = torch.as_tensor(batch["tokens"])
        spec = self.rules().pspec(("batch", None), tuple(tokens.shape))
        axes = spec.axes(0)
        n_b = self.mesh.axis_size(axes) if axes else 1
        mine = shard_batch(batch, self.mesh, {"tokens": spec})
        return self._loss(params, mine) / n_b

    def _loss(self, params, batch) -> torch.Tensor:
        cfg = self.cfg
        with float32_reduction():
            tokens = self._tokens(batch["tokens"])
            B, S = tokens.shape
            x = self._embed(params, tokens)
            positions = torch.arange(S, device=self.device)[None].expand(B, S)
            x = self._run_groups(params, x, mode="train", caches=None,
                                 positions=positions)
            x = _norm_apply(cfg, params["final_norm"], x)
            logits = self._logits(params, x)
            tgt = tokens[:, 1:]
            lg = logits[:, :-1].float()
            mask = batch.get("loss_mask")
            mask = (torch.ones(tgt.shape, device=self.device) if mask is None
                    else torch.as_tensor(mask, device=self.device)[:, 1:]
                    .float())
            lse = torch.logsumexp(lg, dim=-1)
            picked = torch.take_along_dim(lg, tgt[..., None], dim=-1)[..., 0]
            nll = (lse - picked) * mask
            return nll.sum() / torch.clamp_min(mask.sum(), 1.0)

    # ------------------------------------------------------------------ serve
    def cache_defs(self, batch: int, max_len: int):
        cfg = self.cfg
        layers = [{f"l{j}": T._stack_defs(T._cache_defs_for(cfg, kind, batch,
                                                            max_len), g.n)
                   for j, kind in enumerate(g.kinds)} for g in self.groups]
        return {"layers": layers,
                "pos": ParamDef((), (), init="zeros", dtype=torch.int32)}

    def init_cache(self, batch: int, max_len: int):
        """Zeroed caches on the model's device, at position 0: a global
        layer's K/V of ``max_len`` positions (int8 with scales under
        ``kv_quant_int8``), a local layer's a ring of ``min(window,
        max_len)``, MLA's latent of ``max_len``, and the Mamba-2 and
        RWKV-6 recurrent states."""
        defs = self.cache_defs(batch, max_len)
        return {"layers": materialize(defs["layers"], None, self.device),
                "pos": 0}

    def prefill(self, params, batch, max_len: int | None = None,
                all_logits: bool = False):
        """Forward over the prompt ``batch["tokens"]`` (B, S), building
        the decode cache.  Returns (last_logits (B, V) float32, cache);
        with ``all_logits``, every position's logits (B, S, V) in their
        place (a teacher-forced yardstick for the decode steps)."""
        params = self.compute_params(params)
        with float32_reduction():
            tokens = self._tokens(batch["tokens"])
            B, S = tokens.shape
            x = self._embed(params, tokens)
            max_len = max_len or S
            positions = torch.arange(S, device=self.device)[None].expand(B, S)
            cache = self.init_cache(B, max_len)
            x = self._run_groups(params, x, mode="prefill",
                                 caches=cache["layers"], positions=positions)
            x = _norm_apply(self.cfg, params["final_norm"], x)
            logits = (self._logits(params, x) if all_logits
                      else self._logits(params, x[:, -1:])[:, 0])
            return logits, {"layers": cache["layers"], "pos": S}

    def decode_step(self, params, cache, tokens, decode_impl: str | None = None):
        """tokens (B, 1) at position ``cache["pos"]``.  Returns (logits
        (B, V) float32, cache at the next position); the K/V tensors are
        the same, written in place.  ``decode_impl`` overrides the
        model's."""
        impl = resolve_decode_impl(decode_impl or self.decode_impl,
                                   self.device)
        params = self.compute_params(params)
        with float32_reduction():
            tokens = self._tokens(tokens)
            B = tokens.shape[0]
            pos = cache["pos"]
            x = self._embed(params, tokens)
            positions = torch.full((B, 1), pos, device=self.device)
            x = self._run_groups(params, x, mode="decode",
                                 caches=cache["layers"], positions=positions,
                                 decode=T.DecodeStep(pos, impl, B,
                                                     self.device))
            x = _norm_apply(self.cfg, params["final_norm"], x)
            logits = self._logits(params, x)[:, 0]
            return logits, {"layers": cache["layers"], "pos": pos + 1}
