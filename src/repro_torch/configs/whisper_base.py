"""Whisper-base [arXiv:2212.04356; openai/whisper].

Enc-dec: 6L+6L d_model=512 8H d_ff=2048 vocab=51865.  The conv frontend is
a STUB: input_specs() provides precomputed frame embeddings (B, T, 512).
Sinusoidal positions, bidirectional encoder, causal decoder + cross-attn.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    n_enc_layers=6,
    enc_dec=True,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab=51865,
    mlp_kind="gelu",
    norm_kind="layer",
    enc_len=1500,
    tie_embeddings=True,
    embed_scale=False,
)


def smoke():
    return dataclasses.replace(
        CONFIG, n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab=256, enc_len=24, param_dtype="float32")
