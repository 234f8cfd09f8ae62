"""olmo-1b [dense] — non-parametric LayerNorm, SwiGLU, RoPE, no biases.

16L d_model=2048 16H (GQA kv=16 = MHA) d_ff=8192 vocab=50304
[arXiv:2402.00838; hf]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm="layernorm_np",
    mlp="swiglu",
    tie_embeddings=True,
    param_dtype="bfloat16",
    activation_dtype="bfloat16",
    loss_chunk=1024,
    attn_chunk=512,
    source="arXiv:2402.00838; hf:allenai/OLMo-1B",
)

SMOKE = ModelConfig(
    name="olmo-smoke",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    norm="layernorm_np",
    mlp="swiglu",
    tie_embeddings=True,
)
