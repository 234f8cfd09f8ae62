"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.

48L d_model=2048 (attn-free) d_ff=0 vocab=50280, ssm_state=128,
expand=2, headdim=64, chunk=128  [arXiv:2405.21060; unverified]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,            # attention-free; SSD heads derived from expand/headdim
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    pattern=("mamba2",),
    norm="rmsnorm",
    pos_emb="none",
    tie_embeddings=True,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=128,
    param_dtype="bfloat16",
    activation_dtype="bfloat16",
    loss_chunk=1024,
    source="arXiv:2405.21060 (mamba2-1.3b); unverified",
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=3,
    d_model=64,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab_size=256,
    pattern=("mamba2",),
    norm="rmsnorm",
    pos_emb="none",
    tie_embeddings=True,
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=16,
    ssm_chunk=8,
)
