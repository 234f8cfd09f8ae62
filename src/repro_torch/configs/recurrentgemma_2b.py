"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1 attn : 2 recurrent.

26L d_model=2560 10H (MQA kv=1, head_dim=256) d_ff=7680 vocab=256000,
window=2048, rnn_width=2560  [arXiv:2402.19427; hf]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    pattern=("rglru", "rglru", "local"),
    window=2048,
    norm="rmsnorm",
    mlp="geglu",
    embed_scale=True,
    tie_embeddings=True,
    rnn_width=2560,
    conv_width=4,
    param_dtype="bfloat16",
    activation_dtype="bfloat16",
    loss_chunk=1024,
    attn_chunk=512,
    source="arXiv:2402.19427; hf:google/recurrentgemma-2b",
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke",
    family="hybrid",
    n_layers=5,                  # 1 full cycle + (rglru, rglru) remainder
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    pattern=("rglru", "rglru", "local"),
    window=16,
    norm="rmsnorm",
    mlp="geglu",
    embed_scale=True,
    tie_embeddings=True,
    rnn_width=64,
    conv_width=4,
)
