"""whisper-base [audio] — 6L d_model=512 8H d_ff=2048 vocab=51865.

Encoder-decoder; the mel/conv frontend is a STUB (input_specs provides
1500 precomputed frame embeddings). Sinusoidal positions on both stacks
(deviation: whisper uses learned decoder positions; sinusoidal keeps the
32k decode cell parameter-free — noted in DESIGN.md). Plain (non-gated)
GELU MLP, LayerNorm. [arXiv:2212.04356; unverified]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    norm="layernorm",
    activation="gelu",
    gated_mlp=False,
    rope_style="none",
    pos_embed="sinusoidal",
    enc_dec=True,
    n_encoder_layers=6,
    encoder_len=1500,
    tie_embeddings=True,
)
