"""Gemma-2 9B [arXiv:2408.00118; hf:google/gemma-2-9b].

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000;
alternating local(4096)/global attention, logit softcaps (50 attn / 30
final), sandwich (pre+post) RMSNorm, GeGLU.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab=256000,
    mlp_kind="geglu",
    attn_pattern=("l", "g"),
    window=4096,
    logit_softcap=50.0,
    final_softcap=30.0,
    post_norm=True,
    rope_theta=10_000.0,
    tie_embeddings=True,
    embed_scale=True,
)


def smoke():
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, window=32, param_dtype="float32")
