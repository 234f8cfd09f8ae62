"""qwen1.5-0.5b [dense] — QKV bias, RMSNorm, SwiGLU.

24L d_model=1024 16H (GQA kv=16 = MHA) d_ff=2816 vocab=151936
[hf:Qwen/Qwen1.5-0.5B]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=1000000.0,
    tie_embeddings=True,
    param_dtype="bfloat16",
    activation_dtype="bfloat16",
    loss_chunk=1024,
    attn_chunk=512,
    source="hf:Qwen/Qwen1.5-0.5B",
)

SMOKE = ModelConfig(
    name="qwen1.5-smoke",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=160,
    vocab_size=256,
    qkv_bias=True,
    norm="rmsnorm",
    mlp="swiglu",
    tie_embeddings=True,
)
