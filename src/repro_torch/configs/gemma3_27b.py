"""Gemma-3 27B [hf:google/gemma-3-27b-pt (family: google/gemma-3-1b-pt)].

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144;
5:1 local(1024):global pattern, qk-norm, dual rope theta
(10k local / 1M global), 128k context.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab=262144,
    mlp_kind="geglu",
    attn_pattern=("l", "l", "l", "l", "l", "g"),
    window=1024,
    qk_norm=True,
    post_norm=True,
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    tie_embeddings=True,
    embed_scale=True,
)


def smoke():
    return dataclasses.replace(
        CONFIG, n_layers=7, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, window=32, param_dtype="float32")
