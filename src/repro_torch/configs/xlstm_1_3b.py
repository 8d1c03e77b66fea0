"""xlstm-1.3b [ssm] — 48L d_model=2048 4H d_ff=0 vocab=50304.

sLSTM + mLSTM blocks at the xLSTM[7:1] ratio (one sLSTM per 8-layer
period). d_ff=0: xLSTM blocks carry their own up/down projections, no
separate FFN. [arXiv:2405.04517; unverified]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=512,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    norm="layernorm",
    rope_style="none",
    tie_embeddings=True,
)
