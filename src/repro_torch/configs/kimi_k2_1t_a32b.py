"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) expert_ff=2048
vocab=163840, MoE 384 experts top-8. Trillion-parameter MoE (paper-table
config): the FSDP/EP stress case of the dry-run matrix.
[arXiv:2501.kimi2; unverified]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    head_dim=128,
    n_experts=384,
    moe_top_k=8,
    moe_d_ff=2048,
    tie_embeddings=False,
)
