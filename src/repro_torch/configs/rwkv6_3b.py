"""RWKV-6 "Finch" 3B [arXiv:2404.05892; hf:RWKV/rwkv-6-world-3b].

32L d_model=2560 (attention-free, 40 heads of 64) d_ff=8960 vocab=65536;
data-dependent decay linear attention.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    block_kind="rwkv6",
    n_layers=32,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab=65536,
    tie_embeddings=False,
    embed_scale=False,
)


def smoke():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, param_dtype="float32")
