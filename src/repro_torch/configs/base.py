"""Model/config schema shared by all 10 assigned architectures.

A ModelConfig is hashable (jit-static) and fully describes the network;
shape profiles (seq_len x batch cells) live in ``shapes.py``. Reduced
("smoke") variants are derived with ``cfg.smoke()`` for CPU tests.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None   # default d_model // n_heads
    block_pattern: Tuple[str, ...] = ("attn",)
    norm: str = "rmsnorm"            # rmsnorm | layernorm | nonparametric
    activation: str = "silu"         # silu (SwiGLU) | gelu (GeGLU)
    gated_mlp: bool = True

    rope_style: str = "rope"         # rope | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()
    pos_embed: str = "none"          # none | sinusoidal (whisper)

    attn_bias: bool = False
    qk_norm: bool = False
    sliding_window: Optional[int] = None   # SWA on 'attn' layers (danube)
    local_window: int = 2048               # window for 'local' layers (griffin)

    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.001

    # Encoder-decoder (whisper)
    enc_dec: bool = False
    n_encoder_layers: int = 0
    encoder_len: int = 1500          # precomputed frame embeddings (stub)

    # VLM (qwen2-vl): first `visual_prefix` positions are patch embeddings
    visual_prefix: int = 0

    rnn_width: Optional[int] = None  # RG-LRU width (default d_model)
    tie_embeddings: bool = True
    embed_scale: bool = False        # multiply embeddings by sqrt(d) (gemma)
    dtype: str = "bfloat16"          # params + activations
    mlstm_chunk: int = 256

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % self.n_kv_heads == 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    @property
    def attention_free(self) -> bool:
        return all(k in ("mlstm", "slstm", "rglru") for k in self.layer_kinds)

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k? (SSM/hybrid/windowed only.)"""
        full_attn = any(
            k == "attn" and self.sliding_window is None
            for k in self.layer_kinds)
        return not full_attn and not self.enc_dec

    def smoke(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        period = len(self.block_pattern)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=max(2, min(2 * period, 2 * period)),
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab_size=256,
            n_experts=8 if self.is_moe else 0,
            moe_top_k=2 if self.is_moe else 0,
            moe_d_ff=32 if self.is_moe else 0,
            n_encoder_layers=2 if self.enc_dec else 0,
            encoder_len=16 if self.enc_dec else self.encoder_len,
            visual_prefix=4 if self.visual_prefix else 0,
            mrope_sections=(4, 2, 2) if self.mrope_sections else (),
            sliding_window=16 if self.sliding_window else None,
            local_window=16,
            rnn_width=64 if self.rnn_width else None,
            dtype="float32",
            mlstm_chunk=8,
        )


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (architecture x input-shape) dry-run cell."""

    name: str                        # train_4k | prefill_32k | ...
    kind: str                        # train | prefill | decode
    seq_len: int
    global_batch: int


LM_SHAPES = (
    ShapeCell("train_4k", "train", 4096, 256),
    ShapeCell("prefill_32k", "prefill", 32768, 32),
    ShapeCell("decode_32k", "decode", 32768, 128),
    ShapeCell("long_500k", "decode", 524288, 1),
)
