"""TinyLlama-1.1B [arXiv:2401.02385; hf:TinyLlama/TinyLlama-1.1B].

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000, llama2 arch.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab=32000,
    mlp_kind="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=False,
    embed_scale=False,
)


def smoke():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, param_dtype="float32")
