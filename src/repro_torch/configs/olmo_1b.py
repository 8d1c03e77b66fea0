"""olmo-1b [dense] — 16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304.

Non-parametric LayerNorm (no scale/bias — OLMo's signature choice).
[arXiv:2402.00838; hf]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm="nonparametric",
    gated_mlp=True,
    tie_embeddings=True,
)
