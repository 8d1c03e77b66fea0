"""Public kernel API, shaped like ``repro/kernels/ops.py``.

The backend follows the tensors: CPU tensors run the plain versions in
``kernels/ref.py``, CUDA tensors the hand-written kernels (K1
``flash_attention``, K2 ``paged_decode_attention``). Each kernel masks
its own ragged edge, so nothing is padded to block multiples here.
"""

from __future__ import annotations

import math

from .flash_attention import flash_attention
from .paged_attention import paged_decode_attention as _paged_decode

__all__ = ["flash_attention", "paged_attention"]


def paged_attention(q, pool, block_table, lengths, *, mode="decode",
                    window=None, scale=None):
    """Paged attention over a per-layer pool dict ``{"k", "v"}``.

    ``mode="decode"``: q (B, Hq, D), one query row per slot at position
    ``lengths[b] - 1``. The softmax scale derives from q's (logical) head
    dim. The verify mode (kernel K3) and quantized pools (``k_scale`` /
    ``v_scale`` leaves, kernel K4) are not ported yet.
    """
    if mode != "decode":
        raise NotImplementedError(
            f"paged_attention mode={mode!r}: the verify kernel (K3) is "
            "not ported yet (ROADMAP queue 1: 'K3 + speculative verify')")
    if "k_scale" in pool:
        raise NotImplementedError(
            "quantized paged pool: kernel K4 is not ported yet (ROADMAP "
            "queue 1: 'K4 quantized pool')")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _paged_decode(q, pool["k"], pool["v"], block_table, lengths,
                         window=window, scale=scale)
