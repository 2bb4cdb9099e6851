"""Zamba2-1.2B [arXiv:2411.15242; hf:Zyphra/Zamba2-1.2B].

38 Mamba2 blocks, d_model=2048, ssm_state=64, + a shared transformer block
(GQA 32H kv=32, d_ff=8192) applied every 6 mamba blocks; vocab=32000.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    block_kind="mamba2",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    ssm_chunk=64,
    shared_attn_period=6,
    mlp_kind="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    embed_scale=False,
)


def smoke():
    return dataclasses.replace(
        CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, ssm_state=16, ssm_headdim=16, ssm_chunk=8,
        shared_attn_period=2, param_dtype="float32")
