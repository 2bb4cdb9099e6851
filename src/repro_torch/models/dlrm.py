"""DLRM (Naumov et al., arXiv:1906.00091) with the paper's Table II sizes
(port of ``repro/models/dlrm.py``).

bottom-MLP(dense 1600 -> 1024 x (5+2) -> 64)  ||  64 embedding tables
(dim 64, pooling factor 60)  ->  pairwise dot interaction -> top-MLP(2048 x
(10+2) -> 1) -> CTR logit.

Parameters keep the reference's tree and layout: ``tables`` (T, R, D) in
``emb_dtype``; ``bot`` and ``top`` hold ``w{i}`` (in, out), ``b{i}``,
``w_out`` and ``b_out`` in ``param_dtype``, so ``x @ w`` reads as in the
reference.  Compute follows the reference: bf16 activations, weights cast
to bf16 at use, ReLU; the interaction's dot products in float32.  The
forward reduces its bf16 products in float32, as the reference's dots do:
it turns off ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_
reduction`` (on by default, which lets cuBLAS add partial sums in bf16)
while it runs, and restores it after.

The multi-hot pooled lookup runs in the embedding-bag CUDA kernel on the
card (``embedding_impl="cuda"``, the default there) or in its plain
version (``"torch"``, the default on the CPU).  Both are differentiable
in the tables: under autograd the kernel path's gradient is the
``embedding_bag_backward`` kernel, the plain path's the plain backward,
which sums in the kernel's order.  The module's own parameters do not
require grad (scoring records nothing); training passes its tree in
(``loss(batch, params=...)``, ``param_tree``; ``repro_torch.train``).

**On a mesh** (``DLRM(cfg, mesh=...)``): ``param_specs``, ``input_specs``
and ``batch_pspecs`` are the reference's (tables over ``expert``, the
MLPs over ``embed``/``mlp``).  ``mesh_loss`` is the paper's hybrid
parallelism on a live mesh, one rank a mesh position holding its block
of the tables and its rows of the global batch:

* tables over the batch axes (the reference's specs with ``{"expert":
  ("data",)}``: the classic DLRM layout): each rank pools *every* row of
  the global batch through *its own* tables (one ``embedding_bag`` launch;
  every rank builds the same global batch from its seed and step), and
  one tiled ``all_to_all`` sends each row's bags to the row's owner; under
  autograd the bags' gradients come back by one ``all_to_all`` and into
  the ``embedding_bag_backward`` kernel on the rank's own tables;
* tables over ``model`` (the default rules): each rank pools its own rows
  through its tables and the bags are all-gathered over ``model`` (the
  reference's "All-To-All / All-Gather traffic").

The bottom and top MLPs run on the rank's rows with their weights whole.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.func import functional_call

from repro_torch.common import comm
from repro_torch.common import init as init_mod
from repro_torch.common.precision import float32_reduction
from repro_torch.common.pytree import ParamDef, specs_of
from repro_torch.common.sharding import MeshRules, P, shard_shape
from repro_torch.core.engine import resolve_device
from repro_torch.kernels.embedding_bag import ops as emb_ops

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm"
    family: str = "recsys"
    n_dense: int = 1600           # dense features (paper Table II)
    n_tables: int = 64            # sparse features
    emb_dim: int = 64             # embedding dimension
    pooling: int = 60             # multi-hot lookups per table per sample
    rows_per_table: int = 1_000_000
    bot_mlp: tuple[int, ...] = (1024,) * 7    # 5+2 layers @ 1024
    top_mlp: tuple[int, ...] = (2048,) * 12   # 10+2 layers @ 2048
    emb_dtype: str = "bfloat16"   # 16-bit embedding data (paper)
    param_dtype: str = "float32"
    opt_dtype: str = "float32"
    embedding_impl: str = "auto"  # "auto" | "torch" | "cuda"


def resolve_embedding_impl(cfg: DLRMConfig, device) -> str:
    """``"auto"`` -> ``"cuda"`` on a CUDA device, ``"torch"`` on the CPU;
    ``"cuda"`` on a CPU device raises."""
    impl = cfg.embedding_impl
    dev = torch.device(device)
    if impl == "auto":
        return "cuda" if dev.type == "cuda" else "torch"
    if impl not in ("torch", "cuda"):
        raise ValueError(f"embedding_impl must be 'auto', 'torch' or "
                         f"'cuda', got {impl!r}")
    if impl == "cuda" and dev.type != "cuda":
        raise ValueError("embedding_impl='cuda' runs the CUDA kernel and "
                         f"needs a CUDA device, got {dev}")
    return impl


def _mlp_shapes(sizes, d_in: int, d_out: int) -> dict:
    """name -> (shape, init rule), in the reference's order."""
    shapes = {}
    prev = d_in
    for i, h in enumerate(sizes):
        shapes[f"w{i}"] = ((prev, h), "scaled")
        shapes[f"b{i}"] = ((h,), "zeros")
        prev = h
    shapes["w_out"] = ((prev, d_out), "scaled")
    shapes["b_out"] = ((d_out,), "zeros")
    return shapes


def _mlp_apply(p, x: torch.Tensor, n_hidden: int) -> torch.Tensor:
    for i in range(n_hidden):
        x = torch.relu(x @ p[f"w{i}"].to(x.dtype) + p[f"b{i}"].to(x.dtype))
    return x @ p["w_out"].to(x.dtype) + p["b_out"].to(x.dtype)


def param_shapes(cfg: DLRMConfig) -> dict:
    """The parameter tree as ``{leaf: (shape, init rule, dtype name)}``,
    nested like the reference's ``param_defs``."""
    n_int = cfg.n_tables + 1   # tables + bottom-mlp output
    d_interact = n_int * (n_int - 1) // 2 + cfg.emb_dim
    mlp = {
        "bot": _mlp_shapes(cfg.bot_mlp, cfg.n_dense, cfg.emb_dim),
        "top": _mlp_shapes(cfg.top_mlp, d_interact, 1),
    }
    tree = {"tables": ((cfg.n_tables, cfg.rows_per_table, cfg.emb_dim),
                       "normal", cfg.emb_dtype)}
    for part, leaves in mlp.items():
        tree[part] = {k: (shape, rule, cfg.param_dtype)
                      for k, (shape, rule) in leaves.items()}
    return tree


def param_defs(cfg: DLRMConfig) -> dict:
    """``param_shapes``' tree as ``ParamDef``s with the reference's
    logical axes (tables ``("expert", None, None)``; MLP weights
    ``("embed", "mlp")``, ``w_out`` ``("mlp", "embed")``)."""
    def leaf(name, shape, rule, dt):
        if name == "tables":
            axes = ("expert", None, None)
        elif name.startswith("w"):
            axes = ("mlp", "embed") if name == "w_out" else ("embed", "mlp")
        else:
            axes = ("embed",) if name == "b_out" else ("mlp",)
        return ParamDef(tuple(shape), axes, rule, _DTYPES[dt])
    out = {}
    for name, v in param_shapes(cfg).items():
        out[name] = (leaf(name, *v) if not isinstance(v, dict) else
                     {k: leaf(k, *lv) for k, lv in v.items()})
    return out


def param_specs(cfg: DLRMConfig, rules: MeshRules):
    return specs_of(param_defs(cfg), rules)


def input_specs(cfg: DLRMConfig, global_batch: int) -> dict:
    """(shape, dtype) of each input of a global batch."""
    return {"dense": ((global_batch, cfg.n_dense), torch.float32),
            "sparse_idx": ((global_batch, cfg.n_tables, cfg.pooling),
                           torch.int32),
            "label": ((global_batch,), torch.float32)}


def batch_pspecs(rules: MeshRules) -> dict:
    bt = rules.pspec(("batch",))
    b = bt[0] if len(bt) else None
    return {"dense": P(b, None), "sparse_idx": P(b, None, None),
            "label": P(b)}


class DLRM(nn.Module):
    """The DLRM on ``device`` (the card by default).  ``params`` (a nested
    dict of tensors shaped as ``param_shapes``, e.g. from
    ``repro_torch.convert.dlrm_params_from_numpy``) gives the weights;
    without it they are drawn from ``seed`` by the reference's init rules,
    the tables one at a time in place."""

    def __init__(self, cfg: DLRMConfig, device="cuda", seed: int = 0,
                 params: dict | None = None, mesh=None,
                 rules_overrides: dict | None = None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        self.rules_overrides = rules_overrides
        self.device = resolve_device(device)
        self.embedding_impl = resolve_embedding_impl(cfg, self.device)
        self.compute_dtype = torch.bfloat16
        shapes = param_shapes(cfg)
        if mesh is not None and mesh.is_live:
            # this rank's blocks: the module holds what it is given
            if params is None:
                raise ValueError("a DLRM on a live mesh takes its blocks of "
                                 "the weights (params=)")
            specs = self.param_specs()
            shapes = {k: ((shard_shape(v[0], specs[k], mesh),) + v[1:]
                          if not isinstance(v, dict) else
                          {n: (shard_shape(lv[0], specs[k][n], mesh),)
                           + lv[1:] for n, lv in v.items()})
                      for k, v in shapes.items()}
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = {}
            for name, leaf in shapes.items():
                if isinstance(leaf, dict):
                    params[name] = {k: init_mod.make(s, rule, _DTYPES[dt],
                                                     gen, self.device)
                                    for k, (s, rule, dt) in leaf.items()}
                else:
                    s, rule, dt = leaf
                    params[name] = init_mod.make(s, rule, _DTYPES[dt], gen,
                                                 self.device)
        self.tables = self._param(params["tables"], shapes["tables"])
        self.bot = nn.ParameterDict({k: self._param(params["bot"][k], v)
                                     for k, v in shapes["bot"].items()})
        self.top = nn.ParameterDict({k: self._param(params["top"][k], v)
                                     for k, v in shapes["top"].items()})

    def _param(self, x: torch.Tensor, leaf) -> nn.Parameter:
        shape, _, dt = leaf
        if tuple(x.shape) != tuple(shape) or x.dtype != _DTYPES[dt]:
            raise ValueError(f"parameter of shape {tuple(x.shape)} and "
                             f"{x.dtype}, expected {tuple(shape)} and {dt}")
        return nn.Parameter(x.to(self.device), requires_grad=False)

    def _as_tensor(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(dtype)

    def forward(self, batch: dict) -> torch.Tensor:
        """batch: dense (B, n_dense) f32, sparse_idx (B, T, pooling) int32
        (tensors or numpy) -> logits (B,) in bf16."""
        with float32_reduction():
            return self._forward(batch)

    def _forward(self, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        dense = self._as_tensor(batch["dense"], self.compute_dtype)
        idx = self._as_tensor(batch["sparse_idx"], torch.int32).contiguous()
        z_bot = _mlp_apply(self.bot, dense, len(cfg.bot_mlp))   # (B, dim)
        pooled = self.embed_bags(idx)                           # (B, T, dim)
        return self._interact_top(self.top, z_bot, pooled)

    def _interact_top(self, top, z_bot, pooled) -> torch.Tensor:
        """The pairwise dot interaction and the top MLP -> logits (B,)."""
        cfg = self.cfg
        feats = torch.cat([z_bot[:, None], pooled], dim=1)      # (B, T+1, dim)
        f32 = feats.float()   # bf16 products are exact in float32
        inter = torch.bmm(f32, f32.transpose(1, 2))
        n = feats.shape[1]
        iu = torch.triu_indices(n, n, 1, device=self.device)
        flat = inter[:, iu[0], iu[1]].to(self.compute_dtype)
        x = torch.cat([flat, z_bot], dim=-1)
        return _mlp_apply(top, x, len(cfg.top_mlp))[:, 0]

    def param_tree(self) -> dict:
        """The weights as the reference's tree ``{"tables", "bot": {...},
        "top": {...}}``, sharing the module's storage."""
        return {"tables": self.tables.detach(),
                "bot": {k: v.detach() for k, v in self.bot.items()},
                "top": {k: v.detach() for k, v in self.top.items()}}

    def loss(self, batch: dict, params: dict | None = None) -> torch.Tensor:
        """Mean binary cross-entropy on the logits (float32); with
        ``params`` (a tree shaped as ``param_tree``'s) the forward runs on
        them in place of the module's own (``functional_call``)."""
        if params is None:
            logit = self.forward(batch).float()
        else:
            flat = {"tables": params["tables"],
                    **{f"{part}.{k}": v for part in ("bot", "top")
                       for k, v in params[part].items()}}
            logit = functional_call(self, flat, (batch,)).float()
        return self._bce(logit, batch["label"])

    def _bce(self, logit, label) -> torch.Tensor:
        y = self._as_tensor(label, torch.float32)
        return torch.mean(torch.clamp_min(logit, 0) - logit * y
                          + torch.log1p(torch.exp(-torch.abs(logit))))

    # ----------------------------------------------------------------- mesh
    def rules(self) -> MeshRules:
        if self.mesh is None:
            raise ValueError("rules() needs DLRM(cfg, mesh=...)")
        return MeshRules.create(self.mesh, self.rules_overrides)

    def param_specs(self, rules: MeshRules | None = None):
        return param_specs(self.cfg, rules or self.rules())

    def input_specs(self, global_batch: int) -> dict:
        return input_specs(self.cfg, global_batch)

    def batch_pspecs(self, rules: MeshRules | None = None) -> dict:
        return batch_pspecs(rules or self.rules())

    def mesh_local(self, path: tuple) -> bool:
        """Whether the mesh step hands ``mesh_loss`` this leaf as this
        rank's block (the tables) rather than whole."""
        return path == ("tables",)

    def mesh_loss(self, params: dict, batch: dict) -> torch.Tensor:
        """This rank's share of the global batch's loss (the shares sum,
        over the batch axes, to ``loss`` of the whole batch): ``params``
        holds this rank's block of ``tables`` and the MLPs whole;
        ``batch`` is the global batch, the same on every rank."""
        with float32_reduction():
            return self._mesh_loss(params, batch)

    def _mesh_loss(self, params: dict, batch: dict) -> torch.Tensor:
        from repro_torch.data.pipeline import shard_batch
        cfg, mesh = self.cfg, self.mesh
        t_axes = self.param_specs()["tables"].axes(0)
        bspecs = self.batch_pspecs()
        b_axes = bspecs["dense"].axes(0)
        n_b = mesh.axis_size(b_axes) if b_axes else 1
        mine = shard_batch(batch, mesh, bspecs)
        dense = self._as_tensor(mine["dense"], self.compute_dtype)
        z_bot = _mlp_apply(params["bot"], dense, len(cfg.bot_mlp))
        tables = params["tables"]
        T_loc = tables.shape[0]
        t0 = (mesh.axis_index(t_axes) if t_axes else 0) * T_loc
        if t_axes and t_axes == b_axes:
            # every row through this rank's tables, then to the rows' owners
            idx = self._as_tensor(batch["sparse_idx"], torch.int32)
            pooled = self._bags(tables, idx[:, t0:t0 + T_loc].contiguous())
            pooled = comm.all_to_all(pooled, mesh, b_axes)
            n = mesh.axis_size(b_axes)
            B_loc = pooled.shape[0] // n
            pooled = (pooled.reshape(n, B_loc, T_loc, -1).transpose(0, 1)
                      .reshape(B_loc, n * T_loc, -1))
        elif not set(t_axes) & set(b_axes):
            idx = self._as_tensor(mine["sparse_idx"], torch.int32)
            pooled = self._bags(tables, idx[:, t0:t0 + T_loc].contiguous())
            if t_axes:
                pooled = comm.all_gather(pooled, mesh, t_axes, dim=1)
        else:
            raise ValueError(f"tables over {t_axes} and rows over {b_axes}: "
                             "the mesh step takes tables over the batch "
                             "axes or over none of them")
        logit = self._interact_top(params["top"], z_bot, pooled).float()
        return self._bce(logit, mine["label"]) / n_b

    def _bags(self, tables, idx) -> torch.Tensor:
        if self.embedding_impl == "cuda":
            return emb_ops.embedding_bag_stacked(tables, idx,
                                                 self.compute_dtype)
        return emb_ops.embedding_bag_stacked_plain(tables, idx,
                                                   self.compute_dtype)

    def embed_bags(self, idx: torch.Tensor) -> torch.Tensor:
        """idx (B, T, pooling) int32 -> pooled (B, T, dim) in the compute
        dtype, rounded once from the float32 sums (the reference sums the
        tables cast to its compute dtype)."""
        return self._bags(self.tables, idx)

    # --- the paper's communication profile (Fig 10): bytes per iteration ---
    def comm_profile(self) -> dict:
        """All-Reduce bytes (DP MLP grads) + All-To-All bytes (embedding)."""
        return comm_profile(self.cfg)


def comm_profile(cfg: DLRMConfig) -> dict:
    """All-Reduce bytes (bf16 grads of every MLP parameter) and the
    paper's 8 MB of All-To-All per iteration."""
    mlp_params = 0
    prev = cfg.n_dense
    for h in cfg.bot_mlp:
        mlp_params += prev * h + h
        prev = h
    mlp_params += prev * cfg.emb_dim + cfg.emb_dim
    n_int = cfg.n_tables + 1
    prev = n_int * (n_int - 1) // 2 + cfg.emb_dim
    for h in cfg.top_mlp:
        mlp_params += prev * h + h
        prev = h
    mlp_params += prev + 1
    return {
        "allreduce_bytes": mlp_params * 2,  # bf16 grads
        "alltoall_bytes": 8 * 2 ** 20,      # paper: 8 MB per iteration
    }
