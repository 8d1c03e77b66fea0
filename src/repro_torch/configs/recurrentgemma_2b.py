"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000. RG-LRU + local attention at 1:2 (pattern rglru, rglru,
local-attn; 26 = 8 full periods + 2 remainder). Window 2048, GeGLU,
embeddings scaled. [arXiv:2402.19427; hf]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    block_pattern=("rglru", "rglru", "local"),
    local_window=2048,
    activation="gelu",
    embed_scale=True,
    rnn_width=2560,
    tie_embeddings=True,
)
