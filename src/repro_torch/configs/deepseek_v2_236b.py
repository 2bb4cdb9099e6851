"""DeepSeek-V2 236B [arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2].

60L d_model=5120 128H MLA (kv_lora=512, q_lora=1536) vocab=102400;
MoE: 2 shared + 160 routed experts, top-6, expert d_ff=1536; first layer
dense (d_ff=12288).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=12288,               # dense layers
    vocab=102400,
    attn_kind="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    moe=True,
    n_experts=160,
    top_k=6,
    n_shared_experts=2,
    moe_d_ff=1536,
    first_dense_layers=1,
    moe_impl="ep_a2a",
    moe_chunks=8,
    mlp_kind="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=False,
    embed_scale=False,
    opt_dtype="bfloat16",
)


def smoke():
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, q_lora_rank=32, kv_lora_rank=24,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        n_experts=8, top_k=2, n_shared_experts=2, moe_d_ff=32,
        first_dense_layers=1, moe_impl="dense", moe_chunks=1,
        param_dtype="float32")
