"""Public kernel API, shaped like ``repro/kernels/ops.py``.

The backend follows the tensors: CPU tensors run the plain versions in
``kernels/ref.py``, CUDA tensors the hand-written kernels (K1
``flash_attention``, K2 ``paged_decode_attention``, K3
``paged_verify_attention``, K4 their quantized-pool path, K5
``rglru_scan``, K6 ``stx_matmul``, K7 ``stencil2d`` / ``stencil3d``, K8
``vrp_dot`` / ``vrp_sum``). Each kernel masks its own ragged edge, so
nothing is padded to block multiples here. ``flash_attention`` and
``rglru_scan`` are differentiable: inputs that require grad go through
their ``autograd.Function``s (K1's backward kernel; K5 on the reversed
sequence).
"""

from __future__ import annotations

import math

from . import ref as _ref
from . import stx_matmul as _k6
from . import vrp_dot as _k8
from .flash_attention import flash_attention
from . import paged_attention as _pa
from .rglru_scan import rglru_scan
from .stx_stencil import stencil2d, stencil3d

__all__ = ["flash_attention", "paged_attention", "rglru_scan", "stx_matmul",
           "stencil2d", "stencil3d", "vrp_dot", "vrp_sum"]


def paged_attention(q, pool, block_table, lengths, *, mode="decode",
                    window=None, scale=None, kv_format=None, sharding=None,
                    kv_heads=None):
    """Paged attention over a per-layer pool dict (JAX ops.py
    ``paged_attention``).

    ``mode="decode"``: q (B, Hq, D), one query row per slot at position
    ``lengths[b] - 1`` (kernel K2). ``mode="verify"``: q (B, K1, Hq, D),
    K1 query rows per slot at positions ``lengths[b] + j``, ``lengths``
    counting the tokens cached BEFORE the window (kernel K3).

    ``pool``: ``{"k", "v"}`` of (NB, BS, Hkv, Dp); a quantized pool also
    carries ``k_scale`` / ``v_scale`` (NB, BS, Hkv) f32 leaves, detected
    here and dequantized inside whichever backend runs (kernel K4 on the
    card). A pool wider than q's head dim (a padded pool) is read at q's
    logical width (the plain version drops the zero tail; the kernel
    wrappers zero-pad q to the pool's width and slice the output back);
    the softmax scale always derives from q's logical head dim.
    ``kv_format``, the pool's ``paged_kv.PoolSpec`` or None, is checked
    against the pool: its head dims and quantization must match.
    ``sharding`` (a ``launch.sharding.ShardCtx``) marks q and the pool as
    this rank's heads of a head-sharded pool: the ``*_headshard``
    wrappers run (the same kernels on the rank's heads); with
    ``kv_heads`` (first, count) the pool is whole (replicated KV) and the
    rank's q heads read that range of its kv heads.
    """
    if mode not in ("decode", "verify"):
        raise ValueError(f"mode must be 'decode' or 'verify', got {mode!r}")
    k_scale, v_scale = pool.get("k_scale"), pool.get("v_scale")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("a quantized pool carries both k_scale and "
                         f"v_scale; got leaves {sorted(pool)}")
    D = q.shape[-1]
    Dp = pool["k"].shape[-1]
    if kv_format is not None and (
            (kv_format.head_dim, kv_format.pool_head_dim) != (D, Dp)
            or kv_format.quantized != (k_scale is not None)):
        raise ValueError(
            f"pool (head dim {Dp}, leaves {sorted(pool)}) and q (head dim "
            f"{D}) do not match kv_format {kv_format}")
    if scale is None:
        scale = 1.0 / math.sqrt(D)       # logical head dim
    kw = dict(window=window, scale=scale, k_scale=k_scale, v_scale=v_scale)
    if sharding is not None:
        fn = _pa.paged_decode_attention_headshard if mode == "decode" \
            else _pa.paged_verify_attention_headshard
        kw.update(shard=sharding, kv_heads=kv_heads)
    else:
        fn = _pa.paged_decode_attention if mode == "decode" \
            else _pa.paged_verify_attention
    return fn(q, pool["k"], pool["v"], block_table, lengths, **kw)


def stx_matmul(x, w, *, out_dtype=None):
    """(..., K) @ (K, N) through the STX tile (kernel K6), the products
    summed in f32, cast to ``out_dtype`` (default x's)."""
    out = _k6.stx_matmul(x.reshape(-1, x.shape[-1]), w.contiguous(),
                         out_dtype=out_dtype)
    return out.reshape(*x.shape[:-1], w.shape[-1])


# Compensated tree over per-lane (8, 128, 2) partials -> (2,), in torch
# ops: the plain version of K8's finalize kernel (JAX ops.py's name).
_finalize_expansion = _ref.vrp_finalize


def vrp_dot(x, y):
    """Double-word dot of float32 vectors -> (2,) expansion [hi, lo]
    (kernel K8a, then a compensated tree over its lanes: on the card one
    call launching the lane kernel and the finalize kernel)."""
    return _k8.vrp_dot(x.reshape(-1), y.reshape(-1))


def vrp_sum(x):
    """Double-word sum of a float32 vector -> (2,) expansion [hi, lo]
    (kernel K8b, then a compensated tree over its lanes)."""
    return _k8.vrp_sum(x.reshape(-1))
