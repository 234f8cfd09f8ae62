"""musicgen-large [audio] — decoder-only transformer over EnCodec tokens.
The EnCodec frontend is a STUB (input_specs() provides precomputed frame
embeddings); the backbone decodes audio-codebook tokens (vocab 2048).

48L d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=2048
[arXiv:2306.05284; hf:facebook/musicgen-large]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    norm="layernorm",
    mlp="gelu",
    pos_emb="sinusoidal",
    tie_embeddings=False,
    input_mode="embeddings",
    param_dtype="bfloat16",
    activation_dtype="bfloat16",
    loss_chunk=1024,
    attn_chunk=512,
    source="arXiv:2306.05284; hf:facebook/musicgen-large",
)

SMOKE = ModelConfig(
    name="musicgen-smoke",
    family="audio",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=128,
    norm="layernorm",
    mlp="gelu",
    pos_emb="sinusoidal",
    tie_embeddings=False,
    input_mode="embeddings",
)
