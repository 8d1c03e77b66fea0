"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) expert_ff=768
vocab=151936, MoE 128 experts top-8, per-head QK-norm.
[hf:Qwen/Qwen3-30B-A3B; hf]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,
    vocab_size=151936,
    head_dim=128,
    rope_theta=1e6,
    qk_norm=True,
    n_experts=128,
    moe_top_k=8,
    moe_d_ff=768,
    tie_embeddings=False,
)
