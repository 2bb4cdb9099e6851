"""Config dataclasses (port of ``repro/configs/base.py``): ``ModelConfig``
and ``ShapeConfig``, field for field, so that config files port verbatim.
The mesh and training configs come with the training slice."""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm | recsys
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    # --- block composition -------------------------------------------------
    block_kind: str = "attn"          # attn | mamba2 | rwkv6
    # attention locality pattern, cycled over layers ("l"=local sliding
    # window, "g"=global). gemma2: ("l","g"); gemma3: 5xl + g.
    attn_pattern: tuple[str, ...] = ("g",)
    window: int | None = None

    # --- attention ---------------------------------------------------------
    attn_kind: str = "gqa"            # gqa | mla
    logit_softcap: float | None = None
    final_softcap: float | None = None
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_theta_local: float | None = None

    # --- MLA (deepseek) ----------------------------------------------------
    q_lora_rank: int | None = None
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # --- MoE ---------------------------------------------------------------
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "tp"              # tp | ep_a2a | dense (tiny smoke)
    moe_chunks: int = 1               # token microchunks through the MoE ffn
    router_scale: float = 1.0

    # --- MLP ---------------------------------------------------------------
    mlp_kind: str = "swiglu"          # swiglu | geglu | gelu

    # --- SSM (mamba2) / hybrid (zamba2) -------------------------------------
    ssm_state: int = 64
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128
    shared_attn_period: int = 0       # zamba2: apply shared attn block every N

    # --- enc-dec (whisper) ---------------------------------------------------
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_len: int = 1500               # fixed encoder memory length for decode

    # --- VLM (paligemma) -----------------------------------------------------
    vlm_prefix_len: int = 0           # image patch tokens; prefix-LM mask

    # --- norms / misc --------------------------------------------------------
    norm_kind: str = "rms"            # rms | layer
    post_norm: bool = False           # gemma2/3 sandwich norms
    tie_embeddings: bool = True
    embed_scale: bool = True          # gemma-style sqrt(d) embedding scale
    param_dtype: Any = "bfloat16"
    # attention blocking for blockwise/flash paths
    block_q: int = 512
    block_k: int = 512
    # int8 KV cache for global-attention decode (beyond-paper §Perf lever:
    # halves the decode memory term; scales stored per (token, kv_head))
    kv_quant_int8: bool = False
    # flash-style custom-VJP attention for training (recomputes probs in
    # the backward; kills the S^2 residual HBM traffic — §Perf lever).
    # Applies to causal global attention without softcap/prefix masks.
    flash_attention: bool = False
    # chunk-parallel RWKV-6 time mixing (0 = token-level lax.scan). §Perf
    # lever: S/Q chunk steps instead of S scan steps in the backward.
    rwkv_chunk: int = 0
    # Megatron-style sequence parallelism: constrain the residual stream's
    # token dim onto the "model" axis between blocks, so TP all-reduces
    # lower to reduce-scatter + all-gather pairs (§Perf lever).
    seq_parallel: bool = False
    # shard batched-decode KV caches on the SEQUENCE dim over "model"
    # (instead of kv_heads): the fit story for archs whose kv_heads <
    # model-axis size (e.g. gemma2's 8 kv heads on a 16-way model axis)
    decode_seq_shard: bool = False
    # optimizer state dtype override (bf16 for the 100B+ MoE cells)
    opt_dtype: str = "float32"

    def layer_kind(self, i: int) -> str:
        """'l' or 'g' for attention layer i."""
        return self.attn_pattern[i % len(self.attn_pattern)]

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # train | prefill | decode
    # how to shard the KV cache for decode: "batch" (many requests) or
    # "seq" (single huge context -> sequence parallel cache)
    cache_shard: str = "batch"
