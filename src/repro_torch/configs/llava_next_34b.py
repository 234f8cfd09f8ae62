"""llava-next-34b [vlm] — transformer backbone only; anyres vision frontend
is a STUB (input_specs() provides precomputed patch embeddings).

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000
[hf:llava-hf/llava-v1.6-34b-hf backbone (Yi-34B); unverified]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=5000000.0,
    tie_embeddings=False,
    input_mode="embeddings",
    param_dtype="bfloat16",
    activation_dtype="bfloat16",
    loss_chunk=1024,
    attn_chunk=512,
    source="hf:llava-hf/llava-v1.6-34b-hf (Yi-34B backbone); unverified",
)

SMOKE = ModelConfig(
    name="llava-smoke",
    family="vlm",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    norm="rmsnorm",
    mlp="swiglu",
    tie_embeddings=False,
    input_mode="embeddings",
)
