"""LM assembly: the decoder-only stack over stacked per-group params.

Counterpart of ``repro/models/transformer.py`` for the ``attn`` block
kind without a sliding window (the olmo/yi/gemma main path). The layer
layout stays JAX's: layers are grouped into repeating *pattern periods*
and every leaf of ``params["groups"]["g0"]["p0"]`` (and of the paged
pools) is stacked ``(count, ...)``, so the weight bridge and the pool
comparisons line up leaf for leaf. Where JAX runs ``lax.scan`` over the
stacked leaves, this module runs a Python loop over the layer index.

Phases sharing one param set:
  prefill  — full (right-padded) sequence, returns a dense cache
  decode   — one token per slot against the block-paged pool (K2)
  verify   — a K1-token window per slot against the pool in one pass
             (K3): the speculative verify step and the suffix prefill
  dense decode — one token per slot over linear per-slot caches (the
             draft model's), plain torch
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import attention as attn_lib
from . import layers, paged_kv

_NOT_PORTED = {
    "local": "SWA rings",
    "rglru": "K5 RG-LRU and recurrent kinds",
    "mlstm": "K5 RG-LRU and recurrent kinds",
    "slstm": "K5 RG-LRU and recurrent kinds",
}


@dataclasses.dataclass(frozen=True)
class RunCtx:
    """Per-call model context, the counterpart of JAX's ``RunCtx``.

    Kernel dispatch needs no field here: the backend follows the tensors'
    device (``kernels/ops.py``). ``kv_spec`` is the paged pool's
    ``paged_kv.PoolSpec`` (None: a pool in the model dtype), threaded to
    the pool's write frontiers and kernels. The sharding fields of JAX's
    context arrive with their slice.
    """

    kv_spec: object = None


def check_supported(cfg) -> None:
    """Raise NotImplementedError (naming the ROADMAP queue 1 item) for a
    config this slice cannot run: only full-attention ``attn`` layers of
    a decoder-only model with RoPE or no positions."""
    for kind in dict.fromkeys(cfg.block_pattern):     # pattern order
        if kind != "attn":
            raise NotImplementedError(
                f"{cfg.name}: block kind {kind!r} is not ported yet "
                f"(ROADMAP queue 1: '{_NOT_PORTED.get(kind, kind)}')")
    if cfg.sliding_window:
        raise NotImplementedError(
            f"{cfg.name}: sliding-window attention is not ported yet "
            "(ROADMAP queue 1: 'SWA rings')")
    if cfg.is_moe or cfg.enc_dec or cfg.visual_prefix \
            or cfg.rope_style not in ("rope", "none") \
            or cfg.pos_embed != "none":
        raise NotImplementedError(
            f"{cfg.name}: MoE, encoder-decoder and VLM configs are not "
            "ported yet (ROADMAP queue 1: 'MoE / enc-dec')")


# ---------------------------------------------------------------------------
# Layer walk over the stacked-group structure
# ---------------------------------------------------------------------------


def layer_groups(cfg):
    """[(pattern tuple, repeat count), ...] covering all layers in order."""
    p = tuple(cfg.block_pattern)
    full, rem = divmod(cfg.n_layers, len(p))
    groups = []
    if full:
        groups.append((p, full))
    if rem:
        groups.append((p[:rem], 1))
    return groups


def layer_walk(cfg):
    """Yield ``(group_key, pattern, count)`` per stacked group, in order;
    the one place the ``g{g}``/``p{pi}`` keying is defined."""
    for g, (pattern, count) in enumerate(layer_groups(cfg)):
        yield f"g{g}", pattern, count


def map_layer_tree(cfg, fn):
    """Build ``{gk: {pk: fn(gk, pk, kind, count)}}`` over ``layer_walk``."""
    return {gk: {f"p{pi}": fn(gk, f"p{pi}", kind, count)
                 for pi, kind in enumerate(pattern)}
            for gk, pattern, count in layer_walk(cfg)}


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked subtree: every leaf indexed at ``[i]``.
    The leaves are views, so writes into a sliced pool land in the
    stacked pool."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _layers(cfg, *trees):
    """Walk every layer in execution order, yielding ``(kind, slices)``
    with layer ``i`` of each stacked tree (``trees[t][gk][pk]``)."""
    for gk, pattern, count in layer_walk(cfg):
        for i in range(count):
            for pi, kind in enumerate(pattern):
                yield kind, [layer_slice(t[gk][f"p{pi}"], i) for t in trees]


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def model_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_block(gen, cfg, dtype, count: int):
    """Stacked ``(count, ...)`` params of one ``attn`` pattern position."""
    lead = (count,)
    p = {"ln1": layers.init_norm(cfg.norm, cfg.d_model, dtype, gen.device,
                                 lead),
         "attn": attn_lib.init_attention(gen, cfg, dtype, lead),
         "ln2": layers.init_norm(cfg.norm, cfg.d_model, dtype, gen.device,
                                 lead)}
    if cfg.d_ff > 0:
        p["mlp"] = layers.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype,
                                   gated=cfg.gated_mlp, lead=lead)
    return p


def init_lm(gen, cfg):
    """Random params from the ``torch.Generator`` ``gen`` on its device,
    with JAX's distributions (truncated normal on [-2, 2], stddev
    1/sqrt(fan_in), embed stddev 1.0) and JAX's tree layout. The values
    differ from ``repro``'s ``PRNGKey`` draws; to hold the port against
    JAX, carry the JAX params over with ``models/weights.py``."""
    check_supported(cfg)
    dtype = model_dtype(cfg)
    params = {"embed": layers.truncated_normal_init(
        gen, (cfg.vocab_size, cfg.d_model), dtype, stddev=1.0)}
    params["groups"] = map_layer_tree(
        cfg, lambda gk, pk, kind, count: init_block(gen, cfg, dtype, count))
    params["final_norm"] = layers.init_norm(cfg.norm, cfg.d_model, dtype,
                                            gen.device)
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.truncated_normal_init(
            gen, (cfg.d_model, cfg.vocab_size), dtype)
    return params


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _ffn_part(p, cfg, x):
    """Pre-norm MLP + residual."""
    if "mlp" in p:
        xn = layers.apply_norm(cfg.norm, p["ln2"], x)
        x = x + layers.apply_mlp(p["mlp"], xn, cfg.activation)
    return x


def apply_block(p, cfg, x, positions):
    """Full-sequence ``attn`` block. Returns (x, {"k", "v"}) with the
    layer's rotated (B, S, Hkv, D) keys and values."""
    xn = layers.apply_norm(cfg.norm, p["ln1"], x)
    out, kv = attn_lib.attend(p["attn"], cfg, xn, positions)
    return _ffn_part(p, cfg, x + out), kv


def apply_block_decode_paged(p, cfg, x, pool, block_table, lengths,
                             kv_spec=None):
    """One-token ``attn`` block over the paged pool (written in place)."""
    xn = layers.apply_norm(cfg.norm, p["ln1"], x)
    out, _ = attn_lib.decode_attend_paged(p["attn"], cfg, xn, pool,
                                          block_table, lengths,
                                          kv_spec=kv_spec)
    return _ffn_part(p, cfg, x + out)


def apply_block_verify_paged(p, cfg, x, pool, block_table, lengths,
                             kv_spec=None):
    """K1-token ``attn`` block for the verify window: ONE multi-query
    pass over the paged pool (written in place). The pool commits by
    construction: the host rewinds the length pointer over a rejected
    tail, no block is copied."""
    xn = layers.apply_norm(cfg.norm, p["ln1"], x)
    out, _ = attn_lib.verify_attend_paged(p["attn"], cfg, xn, pool,
                                          block_table, lengths,
                                          kv_spec=kv_spec)
    return _ffn_part(p, cfg, x + out)


def apply_block_decode(p, cfg, x, cache, pos):
    """One-token ``attn`` block over a linear per-slot cache (written in
    place); ``pos`` (B,) per-slot positions."""
    xn = layers.apply_norm(cfg.norm, p["ln1"], x)
    out, _ = attn_lib.decode_attend_batched(p["attn"], cfg, xn, cache, pos)
    return _ffn_part(p, cfg, x + out)


# ---------------------------------------------------------------------------
# The LM
# ---------------------------------------------------------------------------


def _embed(params, cfg, tokens):
    x = params["embed"][tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def _logits(params, cfg, x):
    """``x @ head`` in the model dtype, then upcast to f32 (JAX's order)."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ head).float()


def prefill_supports_ragged(cfg) -> bool:
    """True when right-padded (bucketed) prefill is exact: causal
    attention hides pad keys from every real query, and positions are
    relative (rope) or absent."""
    return (set(cfg.block_pattern) == {"attn"} and not cfg.enc_dec
            and not cfg.visual_prefix
            and cfg.rope_style in ("rope", "none")
            and cfg.pos_embed == "none")


def prefill(params, cfg, tokens, ctx: RunCtx, max_len=None, length=None,
            rows=None):
    """Prefill: logits plus a dense decode cache of width ``max_len``.

    tokens: (B, S). ``length`` ((B,) int) marks RIGHT-padded prompts:
    row b's real tokens are ``tokens[b, :length[b]]``; causal attention
    keeps the pad tail invisible to every real query, and cache entries
    past ``length`` are never read unmasked. ``rows`` ((B,) int) selects
    one position per row whose logits to return, (B, V) f32 — the
    scheduler asks for ``length - 1`` only; None returns all (B, S, V).
    The cache mirrors ``params["groups"]``: {"k", "v"} leaves of
    (count, B, max_len, Hkv, D), zero past S.
    """
    del ctx, length        # pad keys are masked by causality alone
    check_supported(cfg)
    B, S = tokens.shape
    cache_len = max_len or S
    x = _embed(params, cfg, tokens)
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    dtype = model_dtype(cfg)
    caches = map_layer_tree(cfg, lambda gk, pk, kind, count: {
        name: torch.zeros((count, B, cache_len, cfg.n_kv_heads,
                           cfg.head_dim), dtype=dtype, device=x.device)
        for name in ("k", "v")})
    for _, (lp, lc) in _layers(cfg, params["groups"], caches):
        x, kv = apply_block(lp, cfg, x, positions)
        lc["k"][:, :S] = kv["k"]
        lc["v"][:, :S] = kv["v"]
    if rows is not None:
        x = x[torch.arange(B, device=x.device), rows.long()][:, None]
    x = layers.apply_norm(cfg.norm, params["final_norm"], x)
    logits = _logits(params, cfg, x)
    return (logits[:, 0] if rows is not None else logits), caches


def init_cache(cfg, batch: int, max_len: int, device):
    """Stacked linear decode caches {"k", "v"} of (count, batch, max_len,
    Hkv, D) mirroring the group structure (zero-filled)."""
    check_supported(cfg)
    dtype = model_dtype(cfg)
    return map_layer_tree(cfg, lambda gk, pk, kind, count:
                          attn_lib.init_kv_cache(cfg, batch, max_len, dtype,
                                                 device, lead=(count,)))


def init_paged_cache(cfg, layout, device, spec=None):
    """Stacked per-layer block pools for the paged serving engine
    (zero-filled; block tables and lengths live with the scheduler).
    ``spec`` (a ``paged_kv.PoolSpec``) selects the block format: a
    quantized spec stores int8/fp8 payloads plus scale leaves."""
    check_supported(cfg)
    dtype = model_dtype(cfg)
    return map_layer_tree(cfg, lambda gk, pk, kind, count:
                          paged_kv.init_layer_pool(cfg, layout, dtype,
                                                   device, lead=(count,),
                                                   spec=spec))


def pack_prefill_into_paged(cfg, layout, pools, dense_caches, block_ids,
                            spec=None):
    """Install a batch of prefilled dense caches (``prefill`` with
    ``max_len == block_ids.shape[1] * block_size``) into the pools, IN
    PLACE. ``block_ids`` (N, nbp): per prefill row the physical
    destinations of its cache blocks, pad tails at the null block.
    ``spec`` quantizes the rows on the way in (scales land alongside)."""
    for gk, pattern, _ in layer_walk(cfg):
        for pi in range(len(pattern)):
            pk = f"p{pi}"
            paged_kv.pack_prefill_kv(pools[gk][pk], dense_caches[gk][pk],
                                     block_ids, layout.block_size,
                                     spec=spec)
    return pools


def decode_step_paged(params, cfg, pools, block_table, lengths, tokens,
                      ctx: RunCtx):
    """Continuous-batching decode step.

    tokens: (B, 1) — one token per decode slot; lengths: (B,) int32
    tokens already cached per slot (the new token's position);
    block_table: (B, NBMAX) int32. Retired slots ride along pointed at
    the null block, their outputs discarded by the scheduler. The new
    K/V rows are written into ``pools`` IN PLACE. Returns
    (logits (B, V) f32, pools).
    """
    x = _embed(params, cfg, tokens)
    for _, (lp, pool) in _layers(cfg, params["groups"], pools):
        x = apply_block_decode_paged(lp, cfg, x, pool, block_table, lengths,
                                     ctx.kv_spec)
    x = layers.apply_norm(cfg.norm, params["final_norm"], x)
    return _logits(params, cfg, x)[:, 0], pools


def select_verify_state(cfg, cands, commit):
    """Commit a verify window's per-slot state at the accept boundary.

    JAX's version selects the candidate state after fed token
    ``commit - 1`` for every per-slot leaf (windowed rings, SSM carries)
    and keeps pool leaves as they are (length-pointer rollback). Every
    layer this port serves is a full-attention ``attn`` layer whose state
    is a pool leaf, so the pools are already final and are returned.
    """
    del commit
    check_supported(cfg)
    return cands


def decode_verify_paged(params, cfg, pools, block_table, lengths, tokens,
                        commit_fn, ctx: RunCtx):
    """Speculative-decode verify: score a K1-token window in ONE pass.

    tokens: (B, K1): per slot, the last accepted token followed by K
    draft tokens; fed token j is cached at position ``lengths[b] + j``
    (IN PLACE) and logits row j scores the NEXT position, so row j is
    what ``decode_step_paged`` would return after feeding tokens 0..j.
    ``commit_fn(logits (B, K1, V) f32) -> (out_tokens, commit)`` is the
    accept rule (``engine/sampling.verify_accept``); ``commit[b]`` in
    [1, K1] counts the fed tokens whose cache state to keep. Returns
    (out_tokens, commit, pools).
    """
    x = _embed(params, cfg, tokens)
    for _, (lp, pool) in _layers(cfg, params["groups"], pools):
        x = apply_block_verify_paged(lp, cfg, x, pool, block_table, lengths,
                                     ctx.kv_spec)
    x = layers.apply_norm(cfg.norm, params["final_norm"], x)
    out_tokens, commit = commit_fn(_logits(params, cfg, x))
    return out_tokens, commit, select_verify_state(cfg, pools, commit)


def decode_step(params, cfg, cache, tokens, pos, ctx: RunCtx):
    """Dense decode step: tokens (B, 1) at per-slot positions ``pos``
    (B,) over ``init_cache`` caches (written IN PLACE) -> (logits (B, V)
    f32, cache)."""
    del ctx
    x = _embed(params, cfg, tokens)
    for _, (lp, lc) in _layers(cfg, params["groups"], cache):
        x = apply_block_decode(lp, cfg, x, lc, pos)
    x = layers.apply_norm(cfg.norm, params["final_norm"], x)
    return _logits(params, cfg, x)[:, 0], cache
