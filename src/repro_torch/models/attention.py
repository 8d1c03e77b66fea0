"""Attention blocks: GQA/MQA projections, prefill attention, paged decode
and verify, dense decode.

Counterpart of ``repro/models/attention.py`` for full, windowed and
cross attention: prefill runs kernel K1 through
``kernels/ops.flash_attention`` (causal, with its window for
sliding-window and local layers; bidirectional for whisper's exact-length
encoder), and so does training, where ``attend``'s cache is dropped
and K1 runs under autograd (its backward kernel on the card); paged
decode appends the new K/V row to the block pool and runs kernel K2,
the speculative verify (and suffix prefill) appends K1 rows and runs
kernel K3, both through ``kernels/ops.paged_attention``.
With a quantized ``kv_spec`` the rows are quantized where they enter the
pool and dequantized inside the kernels (K4). The decode over per-slot
caches (the linear caches of the draft model and of dense decode, the
ring buffers of windowed layers) is plain torch, as JAX computes it in
plain jnp. Projections are bias-optional (qwen2-vl) with optional
per-head QK-norm (qwen3); qwen2-vl rotates by M-RoPE.

Tensor parallelism (``shard``, a ``launch.sharding.ShardCtx``), by the
plan's ``attn`` (``launch.sharding.TPPlan``):

* ``"heads"``: a rank holds the column slices of wq / wk / wv (whole
  heads: its Hq / T query and Hkv / T kv heads) and the row slice of wo,
  so the functions read the head counts from the weights, attend over
  the rank's heads alone (K1, and K2 / K3 through the ``*_headshard``
  wrappers over the rank's head-sharded pool or ring), and all-reduce
  the output projection's partial sums (``layers.tp_reduce``);
* ``"kv_replicated"`` (kv heads that do not divide T): wk / wv whole,
  so every rank computes and writes every kv head into a pool or ring
  it holds whole, and its Hq / T query heads attend over the range of kv
  heads they read (``TPPlan.kv_heads``: a head view for K1 and the
  rings, the kernels' kv-head offset for K2 / K3); wo row-parallel and
  all-reduced;
* ``"whole"`` (query heads that do not divide T): the layer whole on
  every rank, no collective.

The encoder-decoder takes the same plan for its encoder
(``attend_masked``, ``attend`` non-causal), its decoder and its
cross-attention (``encode_cross_kv`` projects the kv heads the rank
holds, from the weights; ``attend_cross`` / ``attend_cross_masked`` read
the rank's kv-head range of a whole arena under ``"kv_replicated"``).

Cross-attention (whisper's decoder over the encoder's K/V):
``attend_cross``, the dense path's, runs K1 non-causal (Sq query rows
over all F encoder positions); JAX pins this call to its plain
``mode="ref"`` oracle, and on the CPU the port runs K1's plain version,
which is that oracle. The serving engine's encoder (``attend_masked``)
and its cross-attention over the arena (``attend_cross_masked``) mask
right-padded keys per row and stay plain torch on both devices, as
JAX's stay plain jnp: f32 einsums, a ``1/sqrt(hd)`` scale, pad keys at
-inf, and a fully masked row (a batch filler, an empty decode slot on
the null arena row) set to zeros by a ``where``, never NaN and never a
value read back to the host.
"""

from __future__ import annotations

import math

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


def _proj(params, x, name, heads, hd):
    """x (B, S, d) @ ``w<name>`` (+ ``b<name>`` where the config has
    biases) as (B, S, heads, hd)."""
    y = x @ params["w" + name]
    if "b" + name in params:
        y = y + params["b" + name]
    return y.reshape(x.shape[0], x.shape[1], heads, hd)


def _heads(params, name, hd) -> int:
    """Heads of projection ``w<name>``: the config's, or this rank's share
    of them under tensor parallelism."""
    return params["w" + name].shape[-1] // hd


def _tp(shard):
    """(the ``shard`` the output projection all-reduces over, or None for
    a layer every rank computes whole; the (first, count) range of kv
    heads this rank's query heads read where every rank holds them all,
    else None)."""
    if shard is None or shard.tp_size == 1 or shard.plan.attn == "whole":
        return None, None
    if shard.plan.attn == "kv_replicated":
        return shard, shard.plan.kv_heads
    return shard, None


def _kv_view(t, kv):
    """The kv heads ``kv`` = (first, count) of a (B, S, Hkv, D) ``t``, a
    view (all of them for None)."""
    return t if kv is None else t.narrow(2, kv[0], kv[1])


def _project_qkv(params, cfg, xq, xkv):
    hd = cfg.head_dim
    hq, hkv = _heads(params, "q", hd), _heads(params, "k", hd)
    q = _proj(params, xq, "q", hq, hd)
    k = _proj(params, xkv, "k", hkv, hd)
    v = _proj(params, xkv, "v", hkv, hd)
    if "q_norm" in params:
        q = layers.apply_norm("rmsnorm", params["q_norm"], q)
        k = layers.apply_norm("rmsnorm", params["k_norm"], k)
    return q, k, v


def _rotate_qk(cfg, q, k, positions, mrope_positions):
    """RoPE at ``positions`` or M-RoPE at ``mrope_positions`` (3, B, S),
    by the config's ``rope_style``; none leaves q and k alone."""
    if cfg.rope_style == "mrope":
        return (layers.apply_mrope(q, mrope_positions, cfg.mrope_sections,
                                   cfg.rope_theta),
                layers.apply_mrope(k, mrope_positions, cfg.mrope_sections,
                                   cfg.rope_theta))
    if cfg.rope_style == "rope":
        return (layers.apply_rope(q, positions, cfg.rope_theta),
                layers.apply_rope(k, positions, cfg.rope_theta))
    return q, k


def attend(params, cfg, x, positions, window=None, causal=True,
           mrope_positions=None, shard=None):
    """Full-sequence (prefill) self-attention through kernel K1: causal,
    over the last ``window`` positions when set (SWA, local layers), or
    bidirectional (``causal=False``: whisper's exact-length encoder).

    x: (B, S, d). Returns ``(output, {"k", "v"})`` with the rotated
    (B, S, Hkv, D) keys and values for the prefill cache. q/k/v enter K1
    as transposed views, without a copy.
    """
    shard, kv = _tp(shard)
    q, k, v = _project_qkv(params, cfg, x, x)
    q, k = _rotate_qk(cfg, q, k, positions, mrope_positions)
    out = kops.flash_attention(q.transpose(1, 2),
                               _kv_view(k, kv).transpose(1, 2),
                               _kv_view(v, kv).transpose(1, 2),
                               causal=causal, window=window)
    B, S, _ = x.shape
    out = out.transpose(1, 2).reshape(B, S, -1)
    return layers.tp_reduce(out @ params["wo"], shard), {"k": k, "v": v}


def _cross_kv(kv, kvr):
    """The kv heads ``kvr`` = (first, count) of a cross K/V ``{"k", "v"}``
    of (B, Hkv, F, D), views (all of them for None)."""
    if kvr is None:
        return kv["k"], kv["v"]
    return kv["k"].narrow(1, *kvr), kv["v"].narrow(1, *kvr)


def attend_cross(params, cfg, x, kv, shard=None):
    """Cross-attention of x (B, Sq, d) over the encoder's K/V
    ``{"k", "v"}`` of (B, Hkv, F, D), every position visible: kernel K1,
    non-causal (its plain version on the CPU). With ``shard``: the rank's
    query heads over its kv heads, the output all-reduced."""
    shard, kvr = _tp(shard)
    B, Sq, _ = x.shape
    hd = cfg.head_dim
    q = _proj(params, x, "q", _heads(params, "q", hd), hd).transpose(1, 2)
    k, v = _cross_kv(kv, kvr)
    out = kops.flash_attention(q, k, v, causal=False)
    out = out.transpose(1, 2).reshape(B, Sq, -1)
    return layers.tp_reduce(out @ params["wo"], shard)


def _masked_softmax_attend(q, k, v, lengths, dtype):
    """q (B, Sq, Hq, D); k, v (B, Hkv, Skv, D) of which the first
    ``lengths[b]`` keys are real. f32 math with pad keys at -inf; a row
    with no real key gives zeros. Returns (B, Sq, Hq * D) in ``dtype``."""
    B, Sq, hq, hd = q.shape
    group = hq // k.shape[1]
    kx = k.repeat_interleave(group, dim=1).float()
    vx = v.repeat_interleave(group, dim=1).float()
    logits = torch.einsum("bqhd,bhkd->bhqk", q.float(), kx) \
        * float(1.0 / math.sqrt(hd))
    valid = torch.arange(k.shape[2], device=q.device)[None, :] \
        < lengths[:, None]                                   # (B, Skv)
    logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(valid.any(-1)[:, None, None, None], probs, 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vx)
    return out.transpose(1, 2).reshape(B, Sq, hq * hd).to(dtype)


def attend_masked(params, cfg, x, lengths, shard=None):
    """Bidirectional self-attention over a right-padded batch (the
    serving encoder): x (B, S, d) of which the first ``lengths[b]`` rows
    are real. Pad keys carry no mass; pad query rows are computed and
    never read. Plain torch (see the module docstring). With ``shard``:
    the rank's query heads over the kv heads they read, the output
    all-reduced."""
    shard, kv = _tp(shard)
    q, k, v = _project_qkv(params, cfg, x, x)
    out = _masked_softmax_attend(q, _kv_view(k, kv).transpose(1, 2),
                                 _kv_view(v, kv).transpose(1, 2), lengths,
                                 x.dtype)
    return layers.tp_reduce(out @ params["wo"], shard)


def attend_cross_masked(params, cfg, x, kv, enc_lengths, shard=None):
    """Cross-attention of x (B, Sq, d) over ``{"k", "v"}`` (B, Hkv, F, D)
    of which the first ``enc_lengths[b]`` positions are real (the rest is
    frame-bucket padding or arena capacity). Plain torch (see the module
    docstring). With ``shard``: the rank's query heads over its kv heads
    (its range of a whole arena under ``"kv_replicated"``), the output
    all-reduced."""
    shard, kvr = _tp(shard)
    hd = cfg.head_dim
    q = _proj(params, x, "q", _heads(params, "q", hd), hd)
    k, v = _cross_kv(kv, kvr)
    out = _masked_softmax_attend(q, k, v, enc_lengths, x.dtype)
    return layers.tp_reduce(out @ params["wo"], shard)


def encode_cross_kv(params, cfg, enc_out):
    """The cross-attention K/V of encoder output (B, F, d): ``{"k",
    "v"}`` of (B, Hkv, F, D), transposed views of the projections. The
    kv heads are the weights' (a rank's under tensor parallelism, all of
    them where the plan keeps ``wk`` / ``wv`` whole)."""
    hd = cfg.head_dim
    return {n: _proj(params, enc_out, n, _heads(params, n, hd),
                     hd).transpose(1, 2) for n in ("k", "v")}


def decode_attend_paged(params, cfg, x, pool, block_table, lengths, *,
                        kv_spec=None, shard=None):
    """Single-token decode against a block-paged KV pool.

    x: (B, 1, d); pool: {"k", "v"} of (NB, BS, Hkv, D) for this layer
    (plus ``k_scale`` / ``v_scale`` when ``kv_spec`` is a quantized
    ``paged_kv.PoolSpec``: the new row is quantized at this write
    frontier and dequantized inside the kernel);
    block_table: (B, NBMAX) int32; lengths: (B,) int32 tokens already
    cached per slot. The new token lands at position ``lengths[b]`` in
    block ``block_table[b, lengths[b] // BS]``, which the scheduler must
    have allocated (retired slots point at the null block 0, whose
    contents are only ever read masked). The pool is updated IN PLACE
    (JAX's version returns a new pool); it is also returned. With
    ``shard`` the pool is this rank's head shard (K2 through
    ``paged_decode_attention_headshard``) and the output all-reduced.
    Returns (out (B, 1, d), pool).
    """
    shard, kv = _tp(shard)
    B = x.shape[0]
    hd = cfg.head_dim
    bs = pool["k"].shape[1]
    q, k, v = _project_qkv(params, cfg, x, x)
    if cfg.rope_style == "rope":
        posb = lengths[:, None]
        q = layers.apply_rope(q, posb, cfg.rope_theta)
        k = layers.apply_rope(k, posb, cfg.rope_theta)
    bidx = torch.arange(B, device=x.device)
    logical = (lengths // bs).clamp(0, block_table.shape[1] - 1)
    phys = block_table[bidx, logical.long()]
    write_kv_rows(pool, phys, lengths % bs, k[:, 0], v[:, 0], kv_spec)
    out = kops.paged_attention(q.reshape(B, -1, hd), pool, block_table,
                               lengths + 1, mode="decode", kv_format=kv_spec,
                               sharding=shard, kv_heads=kv)
    out = out.reshape(B, 1, -1).to(x.dtype)
    return layers.tp_reduce(out @ params["wo"], shard), pool


def verify_attend_paged(params, cfg, x, pool, block_table, lengths, *,
                        kv_spec=None, shard=None):
    """Multi-token decode (speculative verify, suffix prefill) against a
    paged KV pool, through kernel K3.

    x: (B, K1, d): the last accepted token plus K draft tokens per slot
    (or a prompt suffix); lengths: (B,) tokens already cached, so fed
    token j lands at position ``lengths[b] + j``. All K1 rows are written
    first (IN PLACE), then every row attends causally within the window.
    A write whose logical block lies past the table (a pad row of a slot
    near max_len) goes to the null block 0, never clipped into the
    slot's own last block, which holds live K/V. With a quantized
    ``kv_spec`` all K1 rows quantize at the write frontier. With
    ``shard``: K3 over this rank's head shard, the output all-reduced.
    Returns (out (B, K1, d), pool).
    """
    shard, kv = _tp(shard)
    B, K1, _ = x.shape
    bs = pool["k"].shape[1]
    q, k, v = _project_qkv(params, cfg, x, x)
    pos = lengths.long()[:, None] \
        + torch.arange(K1, device=x.device)[None, :]        # (B, K1)
    if cfg.rope_style == "rope":
        q = layers.apply_rope(q, pos, cfg.rope_theta)
        k = layers.apply_rope(k, pos, cfg.rope_theta)
    logical = pos // bs
    nbmax = block_table.shape[1]
    phys = torch.where(
        logical < nbmax,
        block_table.gather(1, logical.clamp(0, nbmax - 1)),
        0)
    write_kv_rows(pool, phys, pos % bs, k, v, kv_spec)
    out = kops.paged_attention(q.contiguous(), pool, block_table, lengths,
                               mode="verify", kv_format=kv_spec,
                               sharding=shard, kv_heads=kv)
    out = out.reshape(B, K1, -1).to(x.dtype)
    return layers.tp_reduce(out @ params["wo"], shard), pool


def init_kv_cache(cfg, batch: int, max_len: int, dtype, device, lead=(),
                  window=None):
    """Zeroed cache {"k", "v"} of ``lead + (batch, size, Hkv, D)``: a ring
    buffer of ``size = min(window, max_len)`` for windowed layers, a
    linear cache of ``max_len`` otherwise."""
    size = min(window, max_len) if window else max_len
    shape = tuple(lead) + (batch, size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attend_batched(params, cfg, x, cache, pos, window=None,
                          mrope_positions=None, shard=None):
    """Single-token decode over a per-slot cache with PER-SLOT positions.

    x: (B, 1, d); cache: {"k", "v"} of (B, size, Hkv, D), written IN
    PLACE; pos: (B,) int each slot's current position (its cached
    length); ``mrope_positions`` (3, B, 1) the new token's M-RoPE ids
    (qwen2-vl). A linear cache takes the new K/V row at ``pos`` (clipped
    to the cache) and row b attends slots <= pos[b]. A ring (``window``
    set) takes it at ``pos % size`` and, once the ring has wrapped, every
    slot holds an in-window position: RoPE is applied at write time, so
    ring order does not matter. Plain torch, the jnp math of JAX's
    version. With ``shard`` the cache holds this rank's kv heads (the
    static backend's over a mesh) and the output is all-reduced. Returns
    (out (B, 1, d), cache).
    """
    shard, kv = _tp(shard)
    B = x.shape[0]
    hd = cfg.head_dim
    q, k, v = _project_qkv(params, cfg, x, x)
    hq, hkv = q.shape[2], (kv[1] if kv else k.shape[2])
    q, k = _rotate_qk(cfg, q, k, pos[:, None], mrope_positions)
    size = cache["k"].shape[1]
    p = pos.long()
    slot = torch.remainder(p, size) if window else p.clamp(0, size - 1)
    bidx = torch.arange(B, device=x.device)
    cache["k"][bidx, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, slot] = v[:, 0].to(cache["v"].dtype)
    valid = torch.arange(size, device=x.device)[None, :] <= p[:, None]
    if window:
        valid = valid | ((p[:, None] + 1) >= size)
    qg = q.float().reshape(B, hkv, hq // hkv, hd)
    kf = _kv_view(cache["k"], kv).float().transpose(1, 2)  # (B, Hkv, S, D)
    vf = _kv_view(cache["v"], kv).float().transpose(1, 2)
    logits = torch.einsum("bhgd,bhsd->bhgs", qg, kf) / math.sqrt(hd)
    logits = logits.masked_fill(~valid[:, None, None, :], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", probs, vf)
    out = out.reshape(B, 1, hq * hd).to(x.dtype)
    return layers.tp_reduce(out @ params["wo"], shard), cache


def ring_from_prefill(kv, size, length):
    """Length-aware ring-cache extraction for right-padded prefill.

    kv: (B, S, Hkv, D) full-sequence keys or values whose first
    ``length[b]`` positions are real (the rest is bucket padding); size:
    ring capacity; length: (B,) int true lengths. Returns the (B, size,
    Hkv, D) ring holding positions [max(0, length - size), length) at
    slot ``pos % size``, the layout ``decode_attend_batched`` continues
    from, with never-written slots zeroed (masked by the decode validity
    predicate).
    """
    B = kv.shape[0]
    s = torch.arange(size, device=kv.device)[None, :]
    last = length.long()[:, None] - 1                        # (B, 1)
    # largest position p < length with p % size == s (negative: unset)
    p = last - torch.remainder(last - s, size)
    pc = p.clamp(0, kv.shape[1] - 1)
    ring = kv[torch.arange(B, device=kv.device)[:, None], pc]
    return ring.masked_fill((p < 0)[..., None, None], 0)
