"""Public kernel API, shaped like ``repro/kernels/ops.py``.

The backend follows the tensors: CPU tensors run the plain versions in
``kernels/ref.py``, CUDA tensors the hand-written kernels (K1
``flash_attention``, K2 ``paged_decode_attention``, K3
``paged_verify_attention``). Each kernel masks its own ragged edge, so
nothing is padded to block multiples here.
"""

from __future__ import annotations

import math

from .flash_attention import flash_attention
from .paged_attention import paged_decode_attention as _paged_decode
from .paged_attention import paged_verify_attention as _paged_verify

__all__ = ["flash_attention", "paged_attention"]


def paged_attention(q, pool, block_table, lengths, *, mode="decode",
                    window=None, scale=None):
    """Paged attention over a per-layer pool dict ``{"k", "v"}``.

    ``mode="decode"``: q (B, Hq, D), one query row per slot at position
    ``lengths[b] - 1`` (kernel K2). ``mode="verify"``: q (B, K1, Hq, D),
    K1 query rows per slot at positions ``lengths[b] + j``, ``lengths``
    counting the tokens cached BEFORE the window (kernel K3). The softmax
    scale derives from q's (logical) head dim. Quantized pools
    (``k_scale`` / ``v_scale`` leaves, kernel K4) are not ported yet.
    """
    if mode not in ("decode", "verify"):
        raise ValueError(f"mode must be 'decode' or 'verify', got {mode!r}")
    if "k_scale" in pool:
        raise NotImplementedError(
            "quantized paged pool: kernel K4 is not ported yet (ROADMAP "
            "queue 1: 'K4 quantized pool')")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    fn = _paged_decode if mode == "decode" else _paged_verify
    return fn(q, pool["k"], pool["v"], block_table, lengths, window=window,
              scale=scale)
