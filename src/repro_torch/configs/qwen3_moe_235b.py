"""qwen3-moe-235b-a22b [moe] — 128 experts, top-8, QK-norm, head_dim=128.

94L d_model=4096 64H (GQA kv=4) expert d_ff=1536 vocab=151936, MoE 128e top-8
[hf:Qwen/Qwen3-235B-A22B family; config per assignment]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    qk_norm=True,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=1000000.0,
    tie_embeddings=False,
    n_experts=128,
    experts_per_token=8,
    moe_d_ff=1536,
    capacity_factor=1.25,
    router_group_size=4096,
    param_dtype="bfloat16",
    activation_dtype="bfloat16",
    loss_chunk=1024,
    attn_chunk=512,
    source="hf:Qwen/Qwen3-30B-A3B scaled per assignment",
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab_size=256,
    qk_norm=True,
    norm="rmsnorm",
    mlp="swiglu",
    tie_embeddings=False,
    n_experts=8,
    experts_per_token=2,
    moe_d_ff=96,
    capacity_factor=2.0,
    router_group_size=64,
)
