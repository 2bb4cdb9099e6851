"""DLRM (Naumov et al., arXiv:1906.00091) with the paper's Table II sizes
(port of ``repro/models/dlrm.py``, forward only).

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
version (``"torch"``, the default on the CPU).  The kernel is forward-only,
so the parameters do not require grad: training, with the bags' backward,
comes later.  Mesh sharding (``param_specs``, ``input_specs``,
``batch_pspecs``) is not ported.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.common import init as init_mod
from repro_torch.common.precision import float32_reduction
from repro_torch.core.engine import resolve_device
from repro_torch.kernels.embedding_bag import ops as emb_ops
from repro_torch.kernels.embedding_bag import ref as emb_ref

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


class DLRM(nn.Module):
    """The DLRM on ``device`` (the card by default).  ``params`` (a nested
    dict of tensors shaped as ``param_shapes``, e.g. from
    ``repro_torch.convert.dlrm_params_from_numpy``) gives the weights;
    without it they are drawn from ``seed`` by the reference's init rules,
    the tables one at a time in place."""

    def __init__(self, cfg: DLRMConfig, device="cuda", seed: int = 0,
                 params: dict | None = None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.embedding_impl = resolve_embedding_impl(cfg, self.device)
        self.compute_dtype = torch.bfloat16
        shapes = param_shapes(cfg)
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

    def embed_bags(self, idx: torch.Tensor) -> torch.Tensor:
        """idx (B, T, pooling) int32 -> pooled (B, T, dim) in the tables'
        dtype."""
        if self.embedding_impl == "cuda":
            return emb_ops.embedding_bag_stacked(self.tables, idx)
        return emb_ref.embedding_bag_stacked_ref(self.tables, idx)

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
        pooled = self.embed_bags(idx).to(self.compute_dtype)    # (B, T, dim)
        feats = torch.cat([z_bot[:, None], pooled], dim=1)      # (B, T+1, dim)
        f32 = feats.float()   # bf16 products are exact in float32
        inter = torch.bmm(f32, f32.transpose(1, 2))
        n = feats.shape[1]
        iu = torch.triu_indices(n, n, 1, device=self.device)
        flat = inter[:, iu[0], iu[1]].to(self.compute_dtype)
        x = torch.cat([flat, z_bot], dim=-1)
        return _mlp_apply(self.top, x, len(cfg.top_mlp))[:, 0]

    def loss(self, batch: dict) -> torch.Tensor:
        """Mean binary cross-entropy on the logits (float32)."""
        logit = self.forward(batch).float()
        y = self._as_tensor(batch["label"], torch.float32)
        return torch.mean(torch.clamp_min(logit, 0) - logit * y
                          + torch.log1p(torch.exp(-torch.abs(logit))))

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
