"""gemma-7b [dense] — 28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000.

GeGLU MLP, head_dim=256 (16*256 = 4096 > d_model — faithful), embeddings
scaled by sqrt(d), tied LM head, huge vocab. [arXiv:2403.08295; hf]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    d_ff=24576,
    vocab_size=256000,
    head_dim=256,
    activation="gelu",
    embed_scale=True,
    tie_embeddings=True,
)
