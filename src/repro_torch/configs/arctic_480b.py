"""arctic-480b [moe] — 128 experts top-2 with a dense-FFN residual stream.

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2 +
dense residual  [hf:Snowflake/snowflake-arctic-base]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    norm="rmsnorm",
    mlp="swiglu",
    tie_embeddings=False,
    n_experts=128,
    experts_per_token=2,
    moe_d_ff=4864,
    dense_residual=True,
    capacity_factor=1.25,
    router_group_size=4096,
    param_dtype="bfloat16",
    activation_dtype="bfloat16",
    loss_chunk=1024,
    attn_chunk=512,
    source="hf:Snowflake/snowflake-arctic-base",
)

SMOKE = ModelConfig(
    name="arctic-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab_size=256,
    norm="rmsnorm",
    mlp="swiglu",
    tie_embeddings=False,
    n_experts=8,
    experts_per_token=2,
    moe_d_ff=96,
    dense_residual=True,
    capacity_factor=2.0,
    router_group_size=64,
)
