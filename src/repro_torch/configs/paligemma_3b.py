"""PaliGemma-3B [arXiv:2407.07726; hf:google/paligemma-3b-pt-224].

Backbone: gemma-2B decoder — 18L d_model=2048 8H (GQA kv=1) d_ff=16384
vocab=257216.  SigLIP frontend is a STUB: input_specs() provides 256
precomputed patch embeddings; attention is prefix-LM (bidirectional over
the image prefix, causal over text).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=257216,
    mlp_kind="geglu",
    vlm_prefix_len=256,
    rope_theta=10_000.0,
    tie_embeddings=True,
    embed_scale=True,
)


def smoke():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=256, vlm_prefix_len=8, param_dtype="float32")
