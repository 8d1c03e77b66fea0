"""qwen2-vl-2b [vlm] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960 v=151936.

M-RoPE (3-D multimodal rotary, sections 16/24/24 over head_dim=128) and
dynamic resolution. The ViT frontend is a STUB: input_specs provides
precomputed patch embeddings for the first ``visual_prefix`` positions.
QKV biases per the HF config. [arXiv:2409.12191; hf]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    rope_style="mrope",
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    attn_bias=True,
    visual_prefix=64,
    tie_embeddings=True,
)
