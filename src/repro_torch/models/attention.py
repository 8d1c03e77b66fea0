"""Attention blocks: GQA/MQA projections, prefill attention, paged decode.

Counterpart of ``repro/models/attention.py`` for the full-attention
path: prefill runs kernel K1 through ``kernels/ops.flash_attention``,
decode appends the new K/V row to the block pool and runs kernel K2
through ``kernels/ops.paged_attention``. Projections are bias-optional
(qwen2-vl) with optional per-head QK-norm (qwen3).
"""

from __future__ import annotations

import torch

from ..kernels import ops as kops
from . import layers
from .paged_kv import write_kv_rows


def init_attention(gen, cfg, dtype, lead=()):
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": layers.truncated_normal_init(gen, (d, hq * hd), dtype,
                                           lead=lead),
        "wk": layers.truncated_normal_init(gen, (d, hkv * hd), dtype,
                                           lead=lead),
        "wv": layers.truncated_normal_init(gen, (d, hkv * hd), dtype,
                                           lead=lead),
        "wo": layers.truncated_normal_init(gen, (hq * hd, d), dtype,
                                           lead=lead),
    }
    lead = tuple(lead)
    if cfg.attn_bias:
        for name, n in (("bq", hq), ("bk", hkv), ("bv", hkv)):
            p[name] = torch.zeros(lead + (n * hd,), dtype=dtype,
                                  device=gen.device)
    if cfg.qk_norm:
        p["q_norm"] = layers.init_norm("rmsnorm", hd, dtype, gen.device, lead)
        p["k_norm"] = layers.init_norm("rmsnorm", hd, dtype, gen.device, lead)
    return p


def _project_qkv(params, cfg, xq, xkv):
    B, Sq, _ = xq.shape
    Skv = xkv.shape[1]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = xq @ params["wq"]
    k = xkv @ params["wk"]
    v = xkv @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, Sq, hq, hd)
    k = k.reshape(B, Skv, hkv, hd)
    v = v.reshape(B, Skv, hkv, hd)
    if "q_norm" in params:
        q = layers.apply_norm("rmsnorm", params["q_norm"], q)
        k = layers.apply_norm("rmsnorm", params["k_norm"], k)
    return q, k, v


def attend(params, cfg, x, positions):
    """Causal full-sequence (prefill) self-attention through kernel K1.

    x: (B, S, d). Returns ``(output, {"k", "v"})`` with the rotated
    (B, S, Hkv, D) keys and values for the prefill cache. q/k/v enter K1
    as transposed views, without a copy.
    """
    q, k, v = _project_qkv(params, cfg, x, x)
    if cfg.rope_style == "rope":
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    out = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=True)
    B, S, _ = x.shape
    out = out.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.head_dim)
    return out @ params["wo"], {"k": k, "v": v}


def decode_attend_paged(params, cfg, x, pool, block_table, lengths):
    """Single-token decode against a block-paged KV pool.

    x: (B, 1, d); pool: {"k", "v"} of (NB, BS, Hkv, D) for this layer;
    block_table: (B, NBMAX) int32; lengths: (B,) int32 tokens already
    cached per slot. The new token lands at position ``lengths[b]`` in
    block ``block_table[b, lengths[b] // BS]``, which the scheduler must
    have allocated (retired slots point at the null block 0, whose
    contents are only ever read masked). The pool is updated IN PLACE
    (JAX's version returns a new pool); it is also returned.
    Returns (out (B, 1, d), pool).
    """
    B = x.shape[0]
    hq, hd = cfg.n_heads, cfg.head_dim
    bs = pool["k"].shape[1]
    q, k, v = _project_qkv(params, cfg, x, x)
    if cfg.rope_style == "rope":
        posb = lengths[:, None]
        q = layers.apply_rope(q, posb, cfg.rope_theta)
        k = layers.apply_rope(k, posb, cfg.rope_theta)
    bidx = torch.arange(B, device=x.device)
    logical = (lengths // bs).clamp(0, block_table.shape[1] - 1)
    phys = block_table[bidx, logical.long()]
    write_kv_rows(pool, phys, lengths % bs, k[:, 0], v[:, 0])
    out = kops.paged_attention(q.reshape(B, hq, hd), pool, block_table,
                               lengths + 1, mode="decode")
    out = out.reshape(B, 1, hq * hd).to(x.dtype)
    return out @ params["wo"], pool
