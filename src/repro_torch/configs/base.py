"""Model configuration schema: a copy of the JAX package's ``ModelConfig``.

One ``ModelConfig`` describes any architecture of the zoo (dense, MoE,
hybrid-recurrent, SSM, modality stub), and the port runs each of them
(:mod:`repro_torch.models.transformer`).  The fields, their
defaults and ``param_count`` are those of ``repro/configs/base.py``, so a
configuration means the same thing in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default: d_model // n_heads

    # layer pattern: cycled over depth.  kinds: global, local, rglru, mamba2
    pattern: Tuple[str, ...] = ("global",)
    window: int = 4096               # local-attention window
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0       # chatglm applies RoPE to half the head dim
    pos_emb: str = "rope"            # rope | sinusoidal | none
    qkv_bias: bool = False
    qk_norm: bool = False            # qwen3-style per-head RMS norm on q/k
    attn_softcap: Optional[float] = None    # gemma2: 50.0
    final_softcap: Optional[float] = None   # gemma2: 30.0
    norm: str = "rmsnorm"            # rmsnorm | layernorm | layernorm_np
    post_norm: bool = False          # gemma2 extra post-block norms
    mlp: str = "swiglu"              # swiglu | geglu | gelu
    embed_scale: bool = False        # gemma-style sqrt(d_model) input scaling
    tie_embeddings: bool = True

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    dense_residual: bool = False     # arctic: dense FFN parallel to MoE
    capacity_factor: float = 1.25
    router_group_size: int = 4096    # tokens per dispatch group

    # recurrent (RG-LRU / Griffin)
    rnn_width: Optional[int] = None  # default d_model
    conv_width: int = 4

    # mamba2 / SSD
    ssm_state: int = 128
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128

    # modality frontend: tokens, or precomputed embeddings (vlm/audio stubs)
    input_mode: str = "tokens"

    # numerics
    param_dtype: str = "float32"
    activation_dtype: str = "float32"
    loss_chunk: int = 0              # chunked-vocab loss; 0 = unchunked
    attn_chunk: int = 0              # q-chunked attention; 0 = full

    # notes for DESIGN/EXPERIMENTS (provenance of the numbers)
    source: str = ""

    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def rnn_width_(self) -> int:
        return self.rnn_width if self.rnn_width is not None else self.d_model

    def layer_kinds(self) -> Tuple[str, ...]:
        """Concrete kind of each of the n_layers layers (pattern cycled)."""
        p = self.pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + layers), exact per shape."""
        d, hd = self.d_model, self.head_dim_
        total = self.vocab_size * d
        if not self.tie_embeddings:
            total += self.vocab_size * d
        for kind in self.layer_kinds():
            if kind in ("global", "local"):
                qkv = d * hd * (self.n_heads + 2 * self.n_kv_heads)
                if self.qkv_bias:
                    qkv += hd * (self.n_heads + 2 * self.n_kv_heads)
                total += qkv + self.n_heads * hd * d
            elif kind == "rglru":
                w = self.rnn_width_
                # two input projections, depthwise conv, dense a/i gates,
                # per-channel Λ and biases, output projection
                total += 2 * d * w + self.conv_width * w + 2 * w * w + 3 * w + w * d
            elif kind == "mamba2":
                d_in = self.ssm_expand * d
                h = d_in // self.ssm_headdim
                total += d * (2 * d_in + 2 * self.ssm_state + h) + d_in * d
            # FFN
            if self.n_experts and kind != "rglru" and kind != "mamba2":
                total += self.n_experts * self._ffn_params(self.moe_d_ff)
                total += d * self.n_experts  # router
                if self.dense_residual:
                    total += self._ffn_params(self.d_ff)
            elif kind in ("global", "local"):
                total += self._ffn_params(self.d_ff)
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k experts only)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        per_layer_moe = self.n_experts * self._ffn_params(self.moe_d_ff)
        active_moe = self.experts_per_token * self._ffn_params(self.moe_d_ff)
        n_moe_layers = sum(1 for k in self.layer_kinds() if k in ("global", "local"))
        return total - n_moe_layers * (per_layer_moe - active_moe)

    def _ffn_params(self, ff: int) -> int:
        mult = 3 if self.mlp in ("swiglu", "geglu") else 2
        return mult * self.d_model * ff


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One language-model shape cell: a copy of the JAX package's ``ShapeConfig``."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


# the production shape cells of the launch tools (the JAX package's ``configs/base.py``)
TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


@dataclasses.dataclass(frozen=True)
class GPShapeConfig:
    """Problem sizes of the paper's own (GP) cells: a copy of the JAX package's ``GPShapeConfig``."""

    name: str
    n_train: int
    n_test: int
    tile_size: int

    @property
    def m_tiles(self) -> int:
        assert self.n_train % self.tile_size == 0
        return self.n_train // self.tile_size
