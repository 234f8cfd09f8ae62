"""gemma2-2b [dense] — local+global alternating attention, logit softcaps.

26L d_model=2304 8H (GQA kv=4, head_dim=256) d_ff=9216 vocab=256000
[arXiv:2408.00118; hf]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    pattern=("local", "global"),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    norm="rmsnorm",
    post_norm=True,
    mlp="geglu",
    embed_scale=True,
    tie_embeddings=True,
    param_dtype="bfloat16",
    activation_dtype="bfloat16",
    loss_chunk=1024,
    attn_chunk=512,
    source="arXiv:2408.00118; hf:google/gemma-2-2b",
)

SMOKE = ModelConfig(
    name="gemma2-smoke",
    family="dense",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    pattern=("local", "global"),
    window=16,
    attn_softcap=50.0,
    final_softcap=30.0,
    norm="rmsnorm",
    post_norm=True,
    mlp="geglu",
    embed_scale=True,
    tie_embeddings=True,
)
