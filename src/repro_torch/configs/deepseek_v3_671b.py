"""DeepSeek-V3 671B [arXiv:2412.19437; hf:deepseek-ai/DeepSeek-V3].

61L d_model=7168 128H MLA (kv_lora=512, q_lora=1536, rope 64) vocab=129280;
MoE: 1 shared + 256 routed experts, top-8, expert d_ff=2048; first 3 layers
dense (d_ff=18432).  MTP head omitted (training objective detail).
EP via all-to-all dispatch (the paper's A2A traffic); bf16 optimizer state
(DESIGN.md §5 memory note).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=18432,               # dense layers
    vocab=129280,
    attn_kind="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    moe=True,
    n_experts=256,
    top_k=8,
    n_shared_experts=1,
    moe_d_ff=2048,
    first_dense_layers=3,
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
        n_experts=8, top_k=2, moe_d_ff=32, first_dense_layers=1,
        moe_impl="dense", moe_chunks=1, param_dtype="float32")
