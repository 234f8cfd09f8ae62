"""chatglm3-6b [dense] — 2D/partial RoPE (fraction 0.5), GQA kv=2, QKV bias.

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024
[arXiv:2406.12793; hf]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope_fraction=0.5,
    qkv_bias=True,
    norm="rmsnorm",
    mlp="swiglu",
    tie_embeddings=False,
    param_dtype="bfloat16",
    activation_dtype="bfloat16",
    loss_chunk=1024,
    attn_chunk=512,
    source="arXiv:2406.12793; hf:THUDM/chatglm3-6b",
)

SMOKE = ModelConfig(
    name="chatglm3-smoke",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    rope_fraction=0.5,
    qkv_bias=True,
    norm="rmsnorm",
    mlp="swiglu",
    tie_embeddings=False,
)
