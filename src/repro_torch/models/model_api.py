"""Public Model API (port of ``repro/models/model_api.py``):
``param_defs``, ``init``, ``loss``, ``encode``, ``cache_defs``,
``init_cache``, ``prefill`` and ``decode_step``, for the configs of
``models/transformer.py``: GQA with global and sliding-window layers (a
local layer's cache is a ring of ``min(window, max_len)`` slots) and an
optional int8 KV cache, MLA with a dense or MoE FFN (DeepSeek), Mamba-2
with Zamba2's shared attention block, RWKV-6, the VLM (PaliGemma) and the
encoder-decoder (Whisper).

As in the reference, a ``Model`` holds no weights: ``init(generator)``
makes the parameter tree (the reference's tree, key for key: ``embed``,
``final_norm``, ``groups[i]["l{j}"]...`` stacked on a leading layers dim,
``lm_head`` when embeddings are untied, ``shared_block`` for Zamba2,
``enc_groups`` and ``enc_norm`` for an encoder-decoder), and ``prefill``
and ``decode_step`` take it. Activations are bf16; the logits
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
logits, log-sum-exp and gather in float32.  On a mesh ``mesh_loss`` gives
a rank's share of it; with a ``loss_mask``, its rows' masked sum over the
mask's count on the whole batch (a ``psum`` over the batch axes).

The VLM and encoder-decoder extras are the reference's, fact for fact.
A VLM batch carries ``img`` (B, ``vlm_prefix_len``, d_model): the image
embeddings go before the text's (cast to the compute dtype), every query
sees them (the prefix-LM mask), the loss reads only the text's logits,
and the cache holds the prefix's positions too, so a prefill of S text
tokens fills ``vlm_prefix_len + S`` of them.  An encoder-decoder batch
carries ``frames`` (B, T, d_model): ``encode`` runs the bidirectional
encoder over them (sinusoidal positions added), and sinusoidal positions
are added to the decoder's embeddings on top of its RoPE.  As in the
reference, the decoder is ``build_groups``' causal GQA stack, which never
reads the encoder's output: the loss and the logits do not depend on the
frames, and the encoder's gradient is exactly 0.

**On a mesh** (``Model(cfg, mesh=...)``): ``rules``, ``param_specs``,
``input_specs`` (shapes and dtypes), ``batch_pspecs`` and ``cache_rules``
are the reference's, spec for spec (MoE configs under ``ep_a2a`` take
``moe_param_overrides``).  On a live mesh ``loss``, ``prefill`` and
``decode_step`` take this rank's shards of the parameters (the
``param_specs`` layout) and its rows of the batch (``shard_batch``), and
keep as this rank's blocks over ``model`` every leaf the reference's
GSPMD keeps sharded there (``tp_leaf``, ``transformer.tp_leaves``): the
GQA mixers' (the encoder's too) ``wq``, ``wk``, ``wv``, ``wo``, every
MLP's ``w1``, ``w3``, ``w2`` and the MoE's shared experts', MLA's heads
and latent columns, Mamba-2's projections, conv and ``out_norm``, RWKV-6's
time and channel mixes run tensor-parallel (``models/transformer.py``,
``mla.py``, ``ssm.py``, ``rwkv.py``, ``moe.moe_block_tp``), ``embed``
and ``lm_head`` vocab-parallel: a lookup reads zero outside the rank's
vocab block and is summed over ``model``; the cross-entropy takes the
maximum, the sum of exponentials and the target's logit over ``model``;
``prefill`` and ``decode_step`` all-gather the logits' vocab at the end.
The MoE experts' ``w1``, ``w3``, ``w2`` are the mesh bodies' blocks
(``models/moe.py``).  A leaf whose kind's tensor-parallel form does not
divide over ``model`` is gathered whole (``gathered_leaves``; none on the
production meshes).  A decode cache on a live mesh is the rank's block
under ``cache_rules`` of a shape cell (``init_cache(..., shape)``,
``cache_block_shape``): its rows, its kv heads, MLA's latent columns,
Mamba-2's conv channels and RWKV-6's heads where they split over
``model``, and a global layer's sequence where the cell splits it
(``cache_shard="seq"`` over ``("pod", "data")``, ``decode_seq_shard``
over ``model``: ``cache["seq"]`` names the axes; each rank attends over
its block and the ranks merge, ``transformer._split_decode``, MLA's
absorbed form ``mla.mla_decode_split``); ``prefill`` fills such a cache
(``prefill(..., shape=...)``: its K/V handed into the ranks' blocks).  With
``cfg.seq_parallel`` the training stack keeps the residual as this
rank's slice of the sequence between blocks of every kind (the
reference's constraint to ``P(batch, "model", None)``).
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.precision import float32_reduction
from repro_torch.common.pytree import (ParamDef, map_with_specs, materialize,
                                       specs_of, tree_leaves, tree_map)
from repro_torch.common import comm
from repro_torch.common.sharding import MeshRules, P, gather_full, shard_shape
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.engine import resolve_device
from repro_torch.models import layers as L
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
        self.enc_groups = T.enc_groups(cfg) if cfg.enc_dec else []
        self.cfg = cfg
        self.mesh = mesh
        # "meta" traces shapes only (the dry run, launch/dryrun.py)
        self.device = (torch.device("meta") if str(device) == "meta"
                       else resolve_device(device))
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
        if cfg.enc_dec:
            d["enc_groups"] = [_group_defs(cfg, g) for g in self.enc_groups]
            d["enc_norm"] = _norm_defs(cfg)
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
        if shape.kind in ("train", "prefill"):
            S_text = S - cfg.vlm_prefix_len if cfg.vlm_prefix_len else S
            d = {"tokens": ShapeDtype((B, S_text), torch.int32)}
            if cfg.vlm_prefix_len:
                d["img"] = ShapeDtype((B, cfg.vlm_prefix_len, cfg.d_model),
                                      torch.bfloat16)
            if cfg.enc_dec:
                d["frames"] = ShapeDtype((B, S, cfg.d_model), torch.bfloat16)
            return d
        return {"tokens": ShapeDtype((B, 1), torch.int32),
                "cache": _abstract(self.cache_defs(B, S))}

    def batch_pspecs(self, shape, rules: MeshRules | None = None):
        rules = rules or self.rules()
        B = shape.global_batch
        specs = self.input_specs(shape)
        if shape.kind in ("train", "prefill"):
            return {name: rules.pspec(("batch",) + (None,)
                                      * (len(s.shape) - 1), s.shape)
                    for name, s in specs.items()}
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

    def tp_leaf(self, path: tuple) -> bool:
        """Whether the leaf at ``path`` runs tensor- or vocab-parallel on
        a live mesh (kept as this rank's block over ``model``): ``embed``,
        ``lm_head``, and the leaves ``transformer.tp_leaves`` names for
        each layer kind (decoder, shared block and encoder)."""
        if path[0] in ("embed", "lm_head"):
            return len(path) == 1
        if path[0] == "shared_block":
            kind, rel = ("shared_gqa", "mlp"), tuple(path[1:])
        elif path[0] in ("groups", "enc_groups"):
            groups = self.groups if path[0] == "groups" else self.enc_groups
            kind = groups[int(path[1])].kinds[int(path[2][1:])]
            rel = tuple(path[3:])
        else:
            return False
        return rel in T.tp_leaves(kind, self.cfg,
                                  self.mesh.shape.get("model", 1))

    def mesh_local(self, path: tuple) -> bool:
        """Whether the mesh step reads this leaf as this rank's block
        (``tp_leaf``, and the MoE experts under a mesh body) rather than
        whole."""
        return self.tp_leaf(path) or (MOE.uses_mesh(self.cfg, self.mesh)
                                      and _is_expert_leaf(path))

    def gathered_leaves(self) -> list:
        """The dot paths of the leaves a rank gathers whole on a mesh
        (every one its spec shards)."""
        out = []

        def one(node, spec, path):
            if spec.used_axes() and not self.mesh_local(path):
                out.append(".".join(path))
            return node
        map_with_specs(one, self.param_defs(), self.param_specs())
        return out

    def compute_params(self, params):
        """The tree the layers read: on a live mesh this rank's blocks of
        the ``mesh_local`` leaves (the MoE experts checked against their
        mesh body's layout) and every other leaf gathered whole from this
        rank's shard; ``params`` itself otherwise."""
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
            if self.tp_leaf(path):
                if any(a != "model" for a in spec.used_axes()):
                    raise ValueError(f"{'.'.join(path)}: spec {spec}, a "
                                     "tensor-parallel leaf splits over "
                                     "model only")
                return node
            return gather_full(node, spec, self.mesh)
        return map_with_specs(one, params, specs)

    def _tp(self, mode: str = "prefill"):
        """The ``TP`` of this model's live mesh (None without a ``model``
        axis), sequence-parallel in training under ``cfg.seq_parallel``."""
        seq = mode == "train" and self.cfg.seq_parallel
        return T.tp_of(self.mesh if self._live() else None, seq)

    # -------------------------------------------------------------- plumbing
    def _embed(self, params, tokens, tp: T.TP | None = None):
        """The tokens' embeddings; with ``embed`` split over ``model``
        (``tp``), each rank looks up its vocab block (zero outside it)
        and the lookups are summed (one term a token is not zero: exact)."""
        cfg = self.cfg
        w = params["embed"]
        if tp is not None and w.shape[0] < cfg.vocab:
            n = w.shape[0]
            local = tokens - tp.i * n
            inside = ((local >= 0) & (local < n))[..., None]
            x = (w[local.clamp(0, n - 1)] * inside.to(w.dtype)).to(
                self.compute_dtype)
            x = comm.psum(x, tp.mesh, "model")
        else:
            x = w[tokens].to(self.compute_dtype)
        if cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(cfg.d_model),
                                 dtype=self.compute_dtype, device=x.device)
        return x

    def _logits(self, params, x, tp: T.TP | None = None):
        """The logits of ``x``: under ``tp`` with the vocab split, this
        rank's vocab block of them (``x`` entering a column-parallel
        product; all-gathered along the sequence first under ``tp.seq``)."""
        cfg = self.cfg
        if cfg.tie_embeddings:
            w = params["embed"].to(x.dtype).float().T
        else:
            w = params["lm_head"].to(x.dtype).float()
        if tp is not None:
            if w.shape[1] < cfg.vocab:
                x = tp.enter(x, True)
            elif tp.seq:
                x = comm.all_gather(x, tp.mesh, "model", dim=1)
        logits = torch.matmul(x.float(), w)
        if cfg.tie_embeddings and cfg.embed_scale:
            logits = logits / math.sqrt(cfg.d_model)
        if cfg.final_softcap is not None:
            logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
        return logits

    def _whole_vocab(self, logits, tp: T.TP | None):
        """The logits over the whole vocab (an all-gather of the blocks
        where ``tp`` splits it)."""
        if tp is None or logits.shape[-1] == self.cfg.vocab:
            return logits
        return comm.all_gather(logits, tp.mesh, "model", dim=logits.dim() - 1)

    def _run_groups(self, params, x, *, mode, caches, positions,
                    decode: T.DecodeStep | None = None, prefix_len: int = 0,
                    enc_out=None, encoder: bool = False,
                    tp: T.TP | None = None, seq: T.SeqSplit | None = None):
        """Every layer in order (the encoder's, ``params["enc_groups"]``,
        with ``encoder``); ``caches`` (the stacked cache tree) is written
        in place (a prefill's global layers into this rank's block of the
        sequence under ``seq``); a shared block takes
        ``params["shared_block"]``; the decoder's GQA and MLP layers run
        over ``tp`` where given.  In
        ``mode="train"`` there is no cache, and where autograd records the
        stack (grad mode on, and the input or a weight requiring grad)
        each period (one index of a group's stack, all its sub-layers) is
        checkpointed: its activations are recomputed in the backward.
        Elsewhere, as ``encode`` serves, it runs as it is: the first
        checkpoint of a process took 10.75 s on the card's host."""
        cfg = self.cfg
        shared = params.get("shared_block")
        pgroups, groups = ((params["enc_groups"], self.enc_groups) if encoder
                           else (params["groups"], self.groups))
        remat = mode == "train" and torch.is_grad_enabled() and (
            x.requires_grad or any(t.requires_grad
                                   for t in tree_leaves(pgroups)))
        for gi, g in enumerate(groups):
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
                                            mesh=self.mesh,
                                            prefix_len=prefix_len,
                                            enc_out=enc_out, tp=tp, seq=seq)
                    return x
                if remat:
                    x = checkpoint(period, x, use_reentrant=False)
                else:
                    x = period(x)
        return x

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _extra(self, batch, name: str) -> torch.Tensor:
        """``batch[name]`` (``img`` or ``frames``) on the device in the
        compute dtype (bf16 values cross exactly)."""
        return torch.as_tensor(batch[name], device=self.device).to(
            self.compute_dtype)

    def _inputs(self, params, batch, tp: T.TP | None = None):
        """The decoder's input embeddings of ``batch``: the image prefix
        before the text's (VLM), the sinusoidal positions added (encoder-
        decoder); and (tokens, x, prefix_len, enc_out)."""
        cfg = self.cfg
        tokens = self._tokens(batch["tokens"])
        x = self._embed(params, tokens, tp)
        prefix_len, enc_out = 0, None
        if cfg.vlm_prefix_len:
            x = torch.cat([self._extra(batch, "img"), x], dim=1)
            prefix_len = cfg.vlm_prefix_len
        if cfg.enc_dec:
            if self._reads_encoder():
                enc_out = self._encode(params, self._extra(batch, "frames"),
                                       tp)
            x = x + L.sinusoidal_pos(x.shape[1], cfg.d_model,
                                     device=self.device).to(x.dtype)[None]
        return tokens, x, prefix_len, enc_out

    def encode(self, params, frames) -> torch.Tensor:
        """The encoder's output (B, T, d_model) over ``frames`` (B, T,
        d_model): sinusoidal positions added, the bidirectional encoder
        layers, the final ``enc_norm`` (the reference's ``_encode``)."""
        if not self.cfg.enc_dec:
            raise ValueError(f"{self.cfg.name} has no encoder")
        params = self.compute_params(params)
        with float32_reduction():
            return self._encode(params, torch.as_tensor(
                frames, device=self.device).to(self.compute_dtype),
                self._tp())

    def _reads_encoder(self) -> bool:
        """Whether a decoder layer reads the encoder's output (a
        ``dec_attn`` layer).  The reference's ``Model`` builds the
        decoder from ``build_groups``, whose causal GQA layers do not, and
        its compiled loss drops the unread encoder; so does the port."""
        return any(k[0] == "dec_attn" for g in self.groups for k in g.kinds)

    def _encode(self, params, x, tp: T.TP | None = None):
        cfg = self.cfg
        B, Tn = x.shape[:2]
        x = x + L.sinusoidal_pos(Tn, cfg.d_model, device=self.device).to(
            x.dtype)[None]
        positions = torch.arange(Tn, device=self.device)[None].expand(B, Tn)
        x = self._run_groups(params, x, mode="train", caches=None,
                             positions=positions, encoder=True,
                             tp=None if tp is None else
                             dataclasses.replace(tp, seq=False))
        return _norm_apply(cfg, params["enc_norm"], x)

    # ------------------------------------------------------------------ train
    def loss(self, params, batch) -> torch.Tensor:
        """Next-token cross-entropy (a float32 scalar) of
        ``batch["tokens"]`` (B, S), over the positions ``batch["loss_mask"]``
        (B, S) keeps when it is given; a VLM's batch carries ``img``, an
        encoder-decoder's ``frames`` (see the module docstring)."""
        return self._loss(self.compute_params(params), batch)

    def mesh_loss(self, params, batch) -> torch.Tensor:
        """This rank's share of the global batch's loss (the shares sum,
        over the batch axes, to ``loss`` of the whole batch): ``params``
        whole but the ``mesh_local`` leaves, ``batch`` the global batch.
        Without a ``loss_mask`` every row counts as many tokens, and the
        share is this rank's mean over its rows divided by the number of
        batch shards; with one, the share is its rows' masked NLL sum
        divided by the mask's count over the whole batch (a ``psum`` over
        the batch axes, floored at 1), the reference's global masked
        mean cut by rows."""
        from repro_torch.data.pipeline import shard_batch
        rules = self.rules()
        specs = {}
        for name, v in batch.items():
            shape = tuple(torch.as_tensor(v).shape)
            specs[name] = rules.pspec(("batch",) + (None,) * (len(shape) - 1),
                                      shape)
        axes = specs["tokens"].axes(0)
        n_b = self.mesh.axis_size(axes) if axes else 1
        mine = shard_batch(batch, self.mesh, specs)
        if "loss_mask" not in batch:
            return self._loss(params, mine) / n_b
        nll, count = self._loss(params, mine, parts=True)
        if axes:
            count = comm.psum(count, self.mesh, axes)
        return nll / torch.clamp_min(count, 1.0)

    def _loss(self, params, batch, parts: bool = False):
        """The masked mean NLL of ``batch``; with ``parts``, its sum and
        the mask's count, apart."""
        cfg = self.cfg
        tp = self._tp("train")
        with float32_reduction():
            tokens, x, prefix_len, enc_out = self._inputs(params, batch, tp)
            B, S = x.shape[:2]
            positions = torch.arange(S, device=self.device)[None].expand(B, S)
            if tp is not None and tp.seq:
                x = comm.tp_split(x, tp.mesh, "model", dim=1)
            x = self._run_groups(params, x, mode="train", caches=None,
                                 positions=positions, prefix_len=prefix_len,
                                 enc_out=enc_out, tp=tp)
            x = (_norm_apply(cfg, params["final_norm"], x) if tp is None
                 else tp.norm(cfg, params["final_norm"], x))
            logits = self._logits(params, x, tp)
            if cfg.vlm_prefix_len:
                logits = logits[:, cfg.vlm_prefix_len:]
            tgt = tokens[:, 1:]
            lg = logits[:, :-1].float()
            mask = batch.get("loss_mask")
            mask = (torch.ones(tgt.shape, device=self.device) if mask is None
                    else torch.as_tensor(mask, device=self.device)[:, 1:]
                    .float())
            nll = self._nll(lg, tgt, tp) * mask
            if parts:
                return nll.sum(), mask.sum()
            return nll.sum() / torch.clamp_min(mask.sum(), 1.0)

    def _nll(self, lg, tgt, tp: T.TP | None):
        """-log p(target) at each position from float32 logits over the
        vocab or, under ``tp`` with the vocab split, this rank's block of
        it: the maximum (no gradient: log-sum-exp's shift), the sum of
        exponentials and the target's logit taken over ``model``."""
        if tp is None or lg.shape[-1] == self.cfg.vocab:
            lse = torch.logsumexp(lg, dim=-1)
            return lse - torch.take_along_dim(lg, tgt[..., None],
                                              dim=-1)[..., 0]
        n = lg.shape[-1]
        m = comm.pmax(lg.amax(-1), tp.mesh, "model")
        se = comm.psum(torch.exp(lg - m[..., None]).sum(-1), tp.mesh, "model")
        local = tgt - tp.i * n
        inside = (local >= 0) & (local < n)
        mine = torch.take_along_dim(lg, local.clamp(0, n - 1)[..., None],
                                    dim=-1)[..., 0] * inside
        return torch.log(se) + m - comm.psum(mine, tp.mesh, "model")

    # ------------------------------------------------------------------ serve
    def cache_defs(self, batch: int, max_len: int):
        cfg = self.cfg
        layers = []
        for g in self.groups:
            gd = {}
            for j, kind in enumerate(g.kinds):
                cd = T._cache_defs_for(cfg, kind, batch, max_len)
                gd[f"l{j}"] = {} if cd is None else T._stack_defs(cd, g.n)
            layers.append(gd)
        return {"layers": layers,
                "pos": ParamDef((), (), init="zeros", dtype=torch.int32)}

    def cache_seq_axes(self, shape=None, max_len: int | None = None) -> tuple:
        """The mesh axes a global layer's decode cache splits its sequence
        of ``max_len`` positions (the cell's by default) over in the shape
        cell ``shape`` (``cache_rules``: ``("pod", "data")`` under
        ``cache_shard="seq"``, ``model`` under ``decode_seq_shard``; none
        for the batch cell, the default)."""
        if not self._live():
            return ()
        shape = shape or _BATCH_CACHE
        return self.cache_rules(shape).pspec(
            ("seq",), (max_len or shape.seq_len,)).axes(0)

    def init_cache(self, batch: int, max_len: int, shape=None):
        """Zeroed caches on the model's device, at position 0: a global
        layer's K/V of ``max_len`` positions (int8 with scales under
        ``kv_quant_int8``), a local layer's a ring of ``min(window,
        max_len)``, MLA's latent of ``max_len``, and the Mamba-2 and
        RWKV-6 recurrent states.  On a live mesh, ``batch`` rows of this
        rank's block (``cache_block_shape``) under the cache rules of the
        shape cell ``shape`` (by default the batch cell): a global layer's
        sequence split over ``cache_seq_axes(shape)`` (``"seq"``, which
        ``decode_step`` reads)."""
        defs = self.cache_defs(batch, max_len)["layers"]
        seq = ()
        if self._live():
            shape = shape or _BATCH_CACHE
            rules = self.cache_rules(shape)
            defs = tree_map(lambda d: ParamDef(
                cache_block_shape(d, rules.pspec(d.axes, d.shape), self.mesh,
                                  cut_batch=False), d.axes, init=d.init,
                dtype=d.dtype), defs)
            seq = self.cache_seq_axes(shape, max_len)
        return {"layers": materialize(defs, None, self.device), "pos": 0,
                "seq": seq}

    def prefill(self, params, batch, max_len: int | None = None,
                all_logits: bool = False, shape=None):
        """Forward over the prompt ``batch["tokens"]`` (B, S) (after the
        image prefix ``batch["img"]`` of a VLM; an encoder-decoder's
        ``batch["frames"]`` through the encoder), building the decode
        cache of ``max_len`` positions (by default the prompt's, the
        prefix included).  Returns (last_logits (B, V) float32, cache);
        with ``all_logits``, every position's logits (B, S, V) in their
        place (a teacher-forced yardstick for the decode steps; a VLM's
        prefix positions included).

        On a live mesh the cache is this rank's block under the cache
        rules of the shape cell ``shape`` (``init_cache``; by default the
        batch cell).  Where its global layers split the sequence
        (``cache["seq"]``, which ``decode_step`` continues from) the
        prefill computes what it computes unsplit and hands each global
        layer's K/V (MLA's latent) into this rank's block of positions:
        over ``model`` (``decode_seq_shard``) by one all-to-all a layer
        from this rank's kv heads at every position to every kv head at
        its block's (``transformer._fill_split``), over ``("pod",
        "data")`` (``cache_shard="seq"``, rows whole) by keeping its
        slice.  Positions past the prompt stay zero; a block that starts
        past it holds nothing.  The hand-off's collectives are counted in
        ``comm``'s ``"handoff"`` section."""
        params = self.compute_params(params)
        tp = self._tp()
        with float32_reduction():
            _, x, prefix_len, enc_out = self._inputs(params, batch, tp)
            B, S = x.shape[:2]
            max_len = max_len or S
            positions = torch.arange(S, device=self.device)[None].expand(B, S)
            cache = self.init_cache(B, max_len, shape)
            seq = (T.SeqSplit(self.mesh, cache["seq"],
                              self.mesh.axis_index(cache["seq"]))
                   if cache["seq"] else None)
            x = self._run_groups(params, x, mode="prefill",
                                 caches=cache["layers"], positions=positions,
                                 prefix_len=prefix_len, enc_out=enc_out,
                                 tp=tp, seq=seq)
            x = _norm_apply(self.cfg, params["final_norm"], x)
            logits = (self._logits(params, x, tp) if all_logits
                      else self._logits(params, x[:, -1:], tp)[:, 0])
            return (self._whole_vocab(logits, tp),
                    {"layers": cache["layers"], "pos": S,
                     "seq": cache["seq"]})

    def decode_step(self, params, cache, tokens, decode_impl: str | None = None):
        """tokens (B, 1) at position ``cache["pos"]``.  Returns (logits
        (B, V) float32, cache at the next position); the K/V tensors are
        the same, written in place.  ``decode_impl`` overrides the
        model's.  ``cache["seq"]`` (``init_cache``; none where absent)
        names the mesh axes its global layers split the sequence over."""
        impl = resolve_decode_impl(decode_impl or self.decode_impl,
                                   self.device)
        params = self.compute_params(params)
        tp = self._tp()
        with float32_reduction():
            tokens = self._tokens(tokens)
            B = tokens.shape[0]
            pos = cache["pos"]
            seq = tuple(cache.get("seq", ()))
            x = self._embed(params, tokens, tp)
            if self.cfg.enc_dec:
                x = x + L.sinusoidal_at(pos, self.cfg.d_model,
                                        device=self.device).to(x.dtype)
            positions = torch.full((B, 1), pos, device=self.device)
            x = self._run_groups(params, x, mode="decode",
                                 caches=cache["layers"], positions=positions,
                                 decode=T.DecodeStep(
                                     pos, impl, B, self.device, self.mesh,
                                     seq, self.mesh.axis_index(seq)
                                     if seq else 0), tp=tp)
            x = _norm_apply(self.cfg, params["final_norm"], x)
            logits = self._logits(params, x, tp)[:, 0]
            return (self._whole_vocab(logits, tp),
                    {"layers": cache["layers"], "pos": pos + 1, "seq": seq})


# a decode cache split by batch rows (``cache_rules``' default cell)
_BATCH_CACHE = ShapeConfig("batch_cache", seq_len=1, global_batch=1,
                           kind="decode", cache_shard="batch")


def cache_read_spec(d: ParamDef, spec, cut_batch: bool = True):
    """The part of a cache leaf's spec the port's layers read as a block:
    all of it (the kv heads, a global layer's sequence under
    ``cache_shard="seq"`` or ``decode_seq_shard``, MLA's latent columns,
    Mamba-2's conv channels, RWKV-6's heads), the rows only with
    ``cut_batch``."""
    return P(*[None if ax == "batch" and not cut_batch else
               (spec[i] if i < len(spec) else None)
               for i, ax in enumerate(d.axes)])


def cache_block_shape(d: ParamDef, spec, mesh, cut_batch: bool = True):
    """The shape of a rank's block of the cache leaf ``d`` under ``spec``
    as the port's layers read it (``cache_read_spec``)."""
    return shard_shape(d.shape, cache_read_spec(d, spec, cut_batch), mesh)
