"""LM assembly: the decoder-only stack over stacked per-group params.

Counterpart of ``repro/models/transformer.py`` for the block kinds
``attn`` (full or sliding-window), ``local`` (windowed, griffin),
``rglru`` (the RG-LRU recurrence) and xLSTM's ``mlstm`` / ``slstm``,
with a dense gated MLP or the dropless MoE (``moe.py``) after an
attention block. The layer layout stays JAX's: layers are grouped into
repeating *pattern periods* (recurrentgemma's (rglru, rglru, local),
xLSTM's seven mlstm and one slstm) and every leaf of
``params["groups"]["g0"]["p0"]`` (and of the caches and paged pools) is
stacked ``(count, ...)``, so the
weight bridge and the pool comparisons line up leaf for leaf. Where JAX
runs ``lax.scan`` over the stacked leaves, this module runs a Python
loop over the layer index.

Per-layer decode state follows the kind (``_is_pool_kind``): a
full-attention layer's K/V lives in the shared block pool, a windowed
layer keeps a per-slot ring buffer of ``min(window, max_len)`` rows, an
RG-LRU layer a per-slot f32 carry ``h`` and a conv tail, an mLSTM layer
its f32 ``C`` / ``n`` / ``m`` and a conv tail, an sLSTM layer its f32
``h`` / ``c`` / ``n`` / ``m``. An mLSTM or sLSTM block has no second
norm and no FFN after it (``x + out``).

Phases sharing one param set:
  prefill  — full (right-padded) sequence, returns a dense cache;
             attention through K1 (with the window), RG-LRU through K5,
             mLSTM chunkwise and sLSTM cell by cell in plain torch
  decode   — one token per slot: full attention over the block-paged
             pool (K2), rings and recurrent steps in plain torch
  verify   — a K1-token window per slot: full attention in one pass
             over the pool (K3); rings and recurrent layers scan the
             decode cell and keep one candidate state per position,
             selected at the accept boundary (``select_verify_state``)
  dense decode — one token per slot over per-slot caches (the draft
             model's, the static backend's and the VLM's), plain torch
  train    — full sequence, no cache (``forward_hidden``, ``forward``,
             ``loss_fn``) for every kind: K1 and K5 under autograd
             (their ``autograd.Function``s: K1's backward kernel, K5 run
             on the reversed sequence), the mLSTM chunkwise and the sLSTM
             cell by cell in plain torch, the MoE routed with the
             capacity factor and its aux loss summed over the layers;
             nothing autograd saves is written in place (the MoE fills a
             fresh dispatch buffer), so autograd can differentiate it

Tensor parallelism (``RunCtx.shard``, a ``launch.sharding.ShardCtx``
with its per-block ``TPPlan``): every rank runs these functions on its
slices of the params (``sharding.shard_params``) and its slice of the
pools and caches (``init_paged_cache`` / ``init_cache`` with ``shard``,
JAX's cache specs): the embedding is a vocab-parallel lookup, attention
runs over the rank's heads (its kv-head shard, or the kv heads they
read of a replicated pool or ring), the RG-LRU over its channels
(K5 on them), the mLSTM / sLSTM over its heads, the MoE over its
experts; row-parallel products all-reduce, and the head's vocab slices
are all-gathered, so every rank holds the whole logits
(``TPPlan.step_collectives`` collectives a decode step: 2 L + 2 for a
dense stack). A block whose dimension does not divide T runs whole.
Training stays single-device.

The VLM (qwen2-vl) runs the dense path only, as in JAX (no paged decode:
``ServingCaps.paged_decode``): its prefill splices ``visual_embeds`` over
the first ``visual_prefix`` token embeddings and rotates q / k by M-RoPE
at caller-given ``mrope_positions`` (3, B, S); its decode takes the new
token's (3, B, 1) ids. The encoder-decoder (whisper) has its own
assembly, ``encdec.py``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.utils.checkpoint

from ..kernels import ops as kops
from . import attention as attn_lib
from . import layers, moe, paged_kv, ssm

KINDS = ("attn", "local", "rglru", "mlstm", "slstm")


@dataclasses.dataclass(frozen=True)
class RunCtx:
    """Per-call model context, the counterpart of JAX's ``RunCtx``.

    Kernel dispatch needs no field here: the backend follows the tensors'
    device (``kernels/ops.py``). ``kv_spec`` is the paged pool's
    ``paged_kv.PoolSpec`` (None: a pool in the model dtype), threaded to
    the pool's write frontiers and kernels. ``remat`` and ``ce_chunk``
    shape the training forms (``loss_fn``) with JAX's defaults:
    ``remat="full"`` recomputes each layer's activations in the backward
    pass (``torch.utils.checkpoint``, where JAX uses ``jax.checkpoint``),
    ``ce_chunk > 0`` takes the cross-entropy over sequence chunks of
    that many positions. ``shard`` (a ``launch.sharding.ShardCtx``) runs
    the serving functions tensor-parallel over its mesh, by its plan;
    the Engine sets ``decode_head_shard`` where the plan splits the pool
    by kv heads (``TPPlan.attn`` "heads"), and leaves it False for the
    replicated-KV and whole-attention plans.
    """

    kv_spec: object = None
    remat: str = "none"             # none | full
    ce_chunk: int = 0               # >0: CE over seq chunks
    shard: object = None            # launch.sharding.ShardCtx or None
    decode_head_shard: bool = False


def check_supported(cfg) -> None:
    """Raise ValueError for a config the port cannot run: an unknown
    block kind, rotary style or position embedding."""
    for kind in dict.fromkeys(cfg.block_pattern):     # pattern order
        if kind not in KINDS:
            raise ValueError(f"{cfg.name}: unknown block kind {kind!r}")
    if cfg.rope_style not in ("rope", "mrope", "none") \
            or cfg.pos_embed not in ("none", "sinusoidal"):
        raise ValueError(f"{cfg.name}: unknown positions "
                         f"{cfg.rope_style!r} / {cfg.pos_embed!r}")


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


def init_block(gen, cfg, kind, dtype, count: int):
    """Stacked ``(count, ...)`` params of one pattern position, JAX's
    tree: attention blocks carry ``ln2`` and the MoE (an MoE config) or
    the MLP; an RG-LRU block ``ln2`` and the MLP when ``d_ff > 0``; an
    mLSTM / sLSTM block only its mixer ``mix``."""
    lead = (count,)

    def norm():
        return layers.init_norm(cfg.norm, cfg.d_model, dtype, gen.device,
                                lead)

    def mlp():
        return layers.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype,
                               gated=cfg.gated_mlp, lead=lead)

    p = {"ln1": norm()}
    if kind in ("attn", "local"):
        p["attn"] = attn_lib.init_attention(gen, cfg, dtype, lead)
        p["ln2"] = norm()
        if cfg.is_moe:
            p["moe"] = moe.init_moe(gen, cfg, dtype, lead)
        elif cfg.d_ff > 0:
            p["mlp"] = mlp()
    elif kind == "rglru":
        p["rec"] = ssm.init_rglru_block(gen, cfg, dtype, lead)
        if cfg.d_ff > 0:
            p["ln2"] = norm()
            p["mlp"] = mlp()
    elif kind == "mlstm":
        p["mix"] = ssm.init_mlstm_block(gen, cfg, dtype, lead)
    elif kind == "slstm":
        p["mix"] = ssm.init_slstm_block(gen, cfg, dtype, lead)
    else:
        raise ValueError(kind)
    return p


def init_lm(gen, cfg, keep=None, per_layer: bool = False):
    """Random params from the ``torch.Generator`` ``gen`` on its device,
    with JAX's distributions (truncated normal on [-2, 2], stddev
    1/sqrt(fan_in), embed stddev 1.0, the RG-LRU's ``lam`` and the MoE
    router in f32) and
    JAX's tree layout. The values differ from ``repro``'s ``PRNGKey``
    draws; to hold the port against JAX, carry the JAX params over with
    ``models/weights.py``.

    Each pattern position of a layer group is drawn stacked, all its
    layers at once; ``per_layer`` draws each layer on its own (other
    values) and copies it into the stacked leaves as it is drawn, so a
    draw holds one layer's f32 values at a time. ``keep`` (default: the
    identity) maps each drawn block (stacked, or one layer) and each
    top-level leaf (as a one-key dict) to what is kept of it:
    ``sharding.init_rank_params`` keeps a rank's slices, so a rank never
    holds the whole tree; ``keep`` changes no value."""
    check_supported(cfg)
    keep = keep or (lambda tree: tree)
    dtype = model_dtype(cfg)

    def block(kind, count):
        if not per_layer:
            return keep(init_block(gen, cfg, kind, dtype, count))
        return _stack_layers(
            lambda: keep(init_block(gen, cfg, kind, dtype, 1)), count)

    params = keep({"embed": layers.truncated_normal_init(
        gen, (cfg.vocab_size, cfg.d_model), dtype, stddev=1.0)})
    params["groups"] = map_layer_tree(
        cfg, lambda gk, pk, kind, count: block(kind, count))
    params.update(keep({"final_norm": layers.init_norm(
        cfg.norm, cfg.d_model, dtype, gen.device)}))
    if not cfg.tie_embeddings:
        params.update(keep({"lm_head": layers.truncated_normal_init(
            gen, (cfg.d_model, cfg.vocab_size), dtype)}))
    return params


def _stack_layers(draw, count: int):
    """One tree of ``(count, ...)`` leaves from ``count`` calls of
    ``draw`` (a tree of ``(1, ...)`` leaves each), each copied in as it
    is drawn."""
    out = None
    for i in range(count):
        part = draw()
        if out is None:
            out = _tree_map(lambda t: t.new_empty((count,) + t.shape[1:]),
                            part)
        _tree_map(lambda o, t: o[i].copy_(t[0]), out, part)
    return out


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _window_for(cfg, kind):
    if kind == "local":
        return cfg.local_window
    return cfg.sliding_window


def _is_pool_kind(cfg, kind) -> bool:
    """True for layer kinds whose decode state lives in the shared block
    pool (full attention); windowed rings and recurrent carries are
    per-slot."""
    return kind in ("attn", "local") and _window_for(cfg, kind) is None


def _ffn_part(p, cfg, x, dropless: bool = True, shard=None):
    """Pre-norm MoE or MLP + residual; an mLSTM / sLSTM block has
    neither and passes ``x`` through. Returns (x, aux). Every serving
    path runs the MoE ``dropless``, as JAX's do, and its aux is 0.0 (no
    statistics are computed for it); the training form passes
    ``dropless=False``: the MoE routes with the capacity factor and aux
    is its Switch loss, an f32 scalar. ``shard``: the MoE over the
    rank's experts (``moe.apply_moe_sharded``), the MLP's row-parallel
    reduce, where the plan splits them."""
    aux = 0.0
    if "moe" in p:
        xn = layers.apply_norm(cfg.norm, p["ln2"], x)
        if not dropless:
            delta, aux = moe.apply_moe_train(p["moe"], cfg, xn)
        elif layers.split_over(shard, "moe"):
            delta = moe.apply_moe_sharded(p["moe"], cfg, xn, shard)
        else:
            delta = moe.apply_moe(p["moe"], cfg, xn)
        x = x + delta
    elif "mlp" in p:
        xn = layers.apply_norm(cfg.norm, p["ln2"], x)
        mlp_shard = shard if layers.split_over(shard, "mlp") else None
        x = x + layers.apply_mlp(p["mlp"], xn, cfg.activation, mlp_shard)
    return x, aux


def apply_block(p, cfg, kind, x, positions, cache_len=None, length=None,
                mrope_positions=None, shard=None):
    """Full-sequence block that also emits the layer's decode cache.
    Returns (x, cache). ``mrope_positions`` (3, B, S): the M-RoPE ids of
    an mrope config's attention layers.

    ``length`` ((B,) int) marks RIGHT-padded prefill: only the first
    ``length[b]`` tokens of row b are real. Causal masking keeps pad keys
    out of every real query's window, so the forward math needs no
    change, but the emitted caches capture state at the true length:
    rings are rebuilt from the true tail, the RG-LRU state is gathered
    at ``length - 1`` and its conv tail rebuilt from the real inputs,
    the mLSTM scan is frozen past it by gate masking and the sLSTM by
    carry selection.
    """
    xn = layers.apply_norm(cfg.norm, p["ln1"], x)
    if kind in ("attn", "local"):
        out, cache = _attend_with_cache(p["attn"], cfg, xn, positions,
                                        _window_for(cfg, kind), cache_len,
                                        length, mrope_positions, shard)
    elif kind == "rglru":
        out, cache = _rglru_with_cache(p["rec"], cfg, xn, length, shard)
    elif kind == "mlstm":
        out, cache = _mlstm_with_cache(p["mix"], cfg, xn, length, shard)
    elif kind == "slstm":
        out, cache = _slstm_with_cache(p["mix"], cfg, xn, length, shard)
    else:
        raise ValueError(kind)
    return _ffn_part(p, cfg, x + out, shard=shard)[0], cache


def _attend_with_cache(params, cfg, xn, positions, window, cache_len,
                       length=None, mrope_positions=None, shard=None):
    """Attention through K1 plus the layer's cache: the rotated (B, S,
    Hkv, D) K/V for a linear cache, else a ring of ``min(window,
    cache_len)`` rows in ring order (slot = pos % size)."""
    out, kv = attn_lib.attend(params, cfg, xn, positions, window=window,
                              mrope_positions=mrope_positions, shard=shard)
    S = xn.shape[1]
    if not window:
        return out, kv
    size = min(window, cache_len or S)
    if length is not None:
        # Right-padded prefill: the ring comes from the true per-row
        # tail, not the padded one.
        return out, {n: attn_lib.ring_from_prefill(t, size, length)
                     for n, t in kv.items()}
    if S >= size:
        return out, {n: torch.roll(t[:, -size:], S % size, dims=1)
                     for n, t in kv.items()}
    return out, kv                       # zero tail filled by the caller


def _rglru_with_cache(params, cfg, xn, length=None, shard=None):
    """RG-LRU mixing with its scan through K5, plus the decode state:
    the f32 carry after the last real token and the conv tail of the
    last (width - 1) real inputs (zero-prefixed for short prompts). Under
    a ``shard`` whose plan splits the channels, K5 scans the rank's
    contiguous (B, S, dr / T) a and b, and the state is its channels'."""
    gate, xb, conv_state, a, b, ch = ssm.rglru_mix(params, xn, shard)
    h = kops.rglru_scan(a, b)
    out = ssm.rglru_out(params, gate, h.to(xn.dtype), ch, shard)
    if length is None:
        return out, {"h": h[:, -1].float(), "conv": conv_state}
    B = xn.shape[0]
    last = (length.long() - 1).clamp(min=0)
    h_true = h[torch.arange(B, device=xn.device), last]
    conv_true = layers.conv_state_at(xb, params["conv"]["w"].shape[0],
                                     length)
    return out, {"h": h_true.float(), "conv": conv_true}


def _mlstm_with_cache(params, cfg, xn, length=None, shard=None):
    """Chunkwise mLSTM mixing plus the decode state (C, n, m) and conv
    tail. Right-padded rows freeze the scan past their true length
    (``ssm.freeze_gates_past``), so the carried state is the state at
    ``length``; pad-position outputs are never read. The chunk is
    ``min(cfg.mlstm_chunk, S)`` of the padded width S, as in JAX. Under a
    ``shard`` whose plan splits the heads: the rank's heads and their
    channels of the conv tail."""
    S = xn.shape[1]
    q, k, v, ig, fg, z, conv_state = ssm.mlstm_qkv_gates(
        params, cfg, xn, length=length, shard=shard)
    if length is not None:
        ig, fg = ssm.freeze_gates_past(ig, fg, length)
    h, (C, n, m) = ssm.mlstm_chunkwise(q, k, v, ig, fg,
                                       chunk=min(cfg.mlstm_chunk, S))
    return ssm.mlstm_output(params, cfg, h, z, shard), \
        {"C": C, "n": n, "m": m, "conv": conv_state}


def _slstm_with_cache(params, cfg, xn, length=None, shard=None):
    """The sLSTM over the sequence, one cell a token, plus the final
    (h, c, n, m); on right-padded rows frozen at each true length
    (``ssm.slstm_sequence``; the rank's heads under ``shard``)."""
    return ssm.slstm_sequence(params, cfg, xn, length, shard)


def _recurrent_decode(p, cfg, kind, xn, cache, shard=None):
    """One-token step of an RG-LRU, mLSTM or sLSTM layer on its per-slot
    state (the rank's slice of it under ``shard``), written IN PLACE;
    returns the mixer's output."""
    if kind == "rglru":
        return ssm.apply_rglru_decode(p["rec"], cfg, xn, cache, shard)[0]
    if kind == "mlstm":
        return ssm.apply_mlstm_decode(p["mix"], cfg, xn, cache, shard)[0]
    if kind == "slstm":
        return ssm.apply_slstm_decode(p["mix"], cfg, xn, cache, shard)[0]
    raise ValueError(kind)


def apply_block_decode_paged(p, cfg, kind, x, cache, block_table, lengths,
                             kv_spec=None, shard=None):
    """One-token block step with PER-SLOT positions ``lengths``: full
    attention over the paged pool, a windowed layer over its per-slot
    ring, a recurrent layer on its per-slot state; the cache is written
    IN PLACE."""
    xn = layers.apply_norm(cfg.norm, p["ln1"], x)
    if kind in ("attn", "local"):
        window = _window_for(cfg, kind)
        if window is None:
            out, _ = attn_lib.decode_attend_paged(
                p["attn"], cfg, xn, cache, block_table, lengths,
                kv_spec=kv_spec, shard=shard)
        else:
            out, _ = attn_lib.decode_attend_batched(
                p["attn"], cfg, xn, cache, lengths, window=window,
                shard=shard)
    else:
        out = _recurrent_decode(p, cfg, kind, xn, cache, shard)
    return _ffn_part(p, cfg, x + out, shard=shard)[0]


def _decode_window_scan(p, cfg, kind, x, cache, block_table, lengths,
                        kv_spec=None, shard=None):
    """Run the single-token decode cell over a K1-token verify window,
    keeping the per-position state as candidates.

    x: (B, K1, d). The cell runs on a copy of the per-slot state, so the
    committed state is untouched until ``select_verify_state``. Returns
    (out (B, K1, d), candidates) where every cache leaf gains a K1 axis
    after its batch axis: candidate j is the state after fed tokens
    0..j. The cells are causal, so candidate j does not depend on a
    rejected token after j, and each position's math is the plain decode
    step's (same cells, same order).
    """
    B, K1 = x.shape[:2]
    work = {n: t.clone() for n, t in cache.items()}
    cands = {n: t.new_empty((B, K1) + t.shape[1:]) for n, t in cache.items()}
    outs = []
    for j in range(K1):
        xo = apply_block_decode_paged(p, cfg, kind, x[:, j:j + 1], work,
                                      block_table, lengths + j, kv_spec,
                                      shard)
        outs.append(xo)
        for n, t in work.items():
            cands[n][:, j] = t
    return torch.cat(outs, dim=1), cands


def apply_block_verify_paged(p, cfg, kind, x, cache, block_table, lengths,
                             kv_spec=None, shard=None):
    """K1-token block step for the verify window. A full-attention layer
    runs ONE multi-query pass over the paged pool (written in place; the
    pool commits by construction: the host rewinds the length pointer
    over a rejected tail, no block is copied) and returns the pool;
    rings and recurrent layers scan the decode cell and return
    per-position candidate states (``_decode_window_scan``)."""
    if not _is_pool_kind(cfg, kind):
        return _decode_window_scan(p, cfg, kind, x, cache, block_table,
                                   lengths, kv_spec, shard)
    xn = layers.apply_norm(cfg.norm, p["ln1"], x)
    out, _ = attn_lib.verify_attend_paged(p["attn"], cfg, xn, cache,
                                          block_table, lengths,
                                          kv_spec=kv_spec, shard=shard)
    return _ffn_part(p, cfg, x + out, shard=shard)[0], cache


def apply_block_decode(p, cfg, kind, x, cache, pos, mrope_positions=None,
                       shard=None):
    """One-token block over a per-slot cache (linear or ring; recurrent
    state), written in place; ``pos`` (B,) per-slot positions,
    ``mrope_positions`` (3, B, 1) an mrope config's ids."""
    xn = layers.apply_norm(cfg.norm, p["ln1"], x)
    if kind in ("attn", "local"):
        out, _ = attn_lib.decode_attend_batched(
            p["attn"], cfg, xn, cache, pos, window=_window_for(cfg, kind),
            mrope_positions=mrope_positions, shard=shard)
    else:
        out = _recurrent_decode(p, cfg, kind, xn, cache, shard)
    return _ffn_part(p, cfg, x + out, shard=shard)[0]


def init_block_cache(cfg, kind, batch: int, max_len: int, dtype, device,
                     lead=()):
    """Zeroed per-slot decode state of one layer kind: a linear or ring
    K/V cache, or a recurrent layer's carries and conv tail."""
    if kind in ("attn", "local"):
        return attn_lib.init_kv_cache(cfg, batch, max_len, dtype, device,
                                      lead, window=_window_for(cfg, kind))
    init = {"rglru": ssm.init_rglru_cache, "mlstm": ssm.init_mlstm_cache,
            "slstm": ssm.init_slstm_cache}[kind]
    return init(cfg, batch, dtype, device, lead)


# ---------------------------------------------------------------------------
# The LM
# ---------------------------------------------------------------------------


def _embed(params, cfg, tokens, visual_embeds=None, pos_offset=None,
           shard=None):
    """Token embeddings (scaled for gemma); a VLM's first
    ``visual_prefix`` positions replaced by ``visual_embeds`` cast to the
    model dtype; a sinusoidal config's table added at ``pos_offset``
    ((B,) int, default 0) + the position in the sequence. ``shard``: the
    table is this rank's vocab slice (``layers.vocab_parallel_lookup``)."""
    x = layers.vocab_parallel_lookup(params["embed"], tokens, shard)
    if cfg.embed_scale:
        # the scale rounded to the model dtype, by a device-side fill
        # (torch.tensor would copy from the host: no capture, a sync)
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=x.dtype,
                           device=x.device)
    if cfg.visual_prefix and visual_embeds is not None:
        x = torch.cat([visual_embeds.to(x.dtype), x[:, cfg.visual_prefix:]],
                      dim=1)
    if cfg.pos_embed == "sinusoidal":
        positions = torch.arange(x.shape[1], device=x.device)[None]
        if pos_offset is not None:
            positions = pos_offset.long()[:, None] + positions
        x = x + layers.sinusoidal_embed(positions, cfg.d_model, x.dtype)
    return x


def _logits(params, cfg, x, shard=None):
    """``x @ head`` in the model dtype, then upcast to f32 (JAX's order).
    ``shard``: the head is this rank's vocab slice, and the slices are
    all-gathered (before the exact upcast), so every rank holds the whole
    logits and samples the same token."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return layers.tp_gather_vocab(x @ head, shard).float()


def prefill_supports_ragged(cfg) -> bool:
    """True when right-padded (bucketed) prefill is exact for this
    architecture (JAX's predicate): every decoder-only block kind
    captures its decode state at the true length (rings and RG-LRU by
    gather / recompute; mlstm and slstm by gate freezing and carry
    selection), and positions are relative (rope) or absent."""
    return (set(cfg.block_pattern) <= set(KINDS)
            and not cfg.enc_dec and not cfg.visual_prefix
            and cfg.rope_style in ("rope", "none")
            and cfg.pos_embed == "none")


def _store(dst, src):
    """Copy a layer's emitted cache into the leading corner of its
    zeroed slot (a linear cache of S rows into max_len rows; a short
    ring into its full size)."""
    for name, t in src.items():
        dst[name][tuple(slice(0, n) for n in t.shape)] = t


def prefill(params, cfg, tokens, ctx: RunCtx, max_len=None, length=None,
            rows=None, visual_embeds=None, mrope_positions=None):
    """Prefill: logits plus a dense decode cache of width ``max_len``.

    tokens: (B, S). ``length`` ((B,) int) marks RIGHT-padded prompts:
    row b's real tokens are ``tokens[b, :length[b]]``; causal attention
    keeps the pad tail invisible to every real query, and the emitted
    per-slot state (rings, recurrent carries) is taken at the true length.
    ``rows`` ((B,) int) selects one position per row whose logits to
    return, (B, V) f32 — the scheduler asks for ``length - 1`` only; None
    returns all (B, S, V). The cache is ``init_cache``-shaped with batch
    B: linear {"k", "v"} of (count, B, max_len, Hkv, D), zero past S;
    rings of (count, B, min(window, max_len), Hkv, D); RG-LRU {"h",
    "conv"}; mLSTM {"C", "n", "m", "conv"}; sLSTM {"h", "c", "n", "m"}.
    A VLM takes ``visual_embeds`` (B, visual_prefix, d) and, being
    mrope, ``mrope_positions`` (3, B, S); it has no right-padded form
    (``length`` raises, as in JAX).
    """
    shard = ctx.shard
    check_supported(cfg)
    if length is not None and not prefill_supports_ragged(cfg):
        raise NotImplementedError(
            f"{cfg.name}: padded prefill needs a decoder-only stack "
            "with relative/absent positions")
    B, S = tokens.shape
    cache_len = max_len or S
    x = _embed(params, cfg, tokens, visual_embeds, shard=shard)
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    caches = init_cache(cfg, B, cache_len, x.device, shard)
    for kind, (lp, lc) in _layers(cfg, params["groups"], caches):
        x, cache = apply_block(lp, cfg, kind, x, positions, cache_len,
                               length, mrope_positions, shard)
        _store(lc, cache)
    if rows is not None:
        x = x[torch.arange(B, device=x.device), rows.long()][:, None]
    x = layers.apply_norm(cfg.norm, params["final_norm"], x)
    logits = _logits(params, cfg, x, shard)
    return (logits[:, 0] if rows is not None else logits), caches


def init_cache(cfg, batch: int, max_len: int, device, shard=None):
    """Stacked per-slot decode caches mirroring the group structure
    (zero-filled): linear or ring K/V per attention layer, the carries
    (and conv tail) per recurrent layer. ``shard``: this rank's slice of
    each leaf by the cache rules (``sharding.batch_specs``: K/V split
    over kv heads), allocated at its local shape."""
    check_supported(cfg)
    if shard is not None:
        from ..launch import sharding
        meta = init_cache(cfg, batch, max_len, torch.device("meta"))
        return sharding.local_zeros(meta, sharding.batch_specs(meta, shard),
                                    shard, device)
    dtype = model_dtype(cfg)
    return map_layer_tree(cfg, lambda gk, pk, kind, count: init_block_cache(
        cfg, kind, batch, max_len, dtype, device, lead=(count,)))


def init_paged_cache(cfg, layout, device, spec=None, shard=None):
    """Stacked per-layer caches for the paged serving engine
    (zero-filled; block tables and lengths live with the scheduler).
    Full-attention layers share a block pool, whose format ``spec`` (a
    ``paged_kv.PoolSpec``) selects: a quantized spec stores int8/fp8
    payloads plus scale leaves. Windowed and recurrent layers keep
    per-slot state in the model dtype (the carries in f32), as in
    ``init_cache``. ``shard``: this rank's slice of every leaf
    (``paged_cache_specs``: each pool's kv-head shard, scales with it;
    rings by kv heads, RG-LRU state by channels, mLSTM / sLSTM state by
    heads; whole where the dimension does not divide the model axis),
    allocated at its local shape, never whole."""
    check_supported(cfg)
    if shard is not None:
        from ..launch import sharding
        meta = init_paged_cache(cfg, layout, torch.device("meta"), spec)
        return sharding.local_zeros(
            meta, paged_cache_specs(cfg, layout, shard, spec), shard, device)
    dtype = model_dtype(cfg)

    def one(gk, pk, kind, count):
        if _is_pool_kind(cfg, kind):
            return paged_kv.init_layer_pool(cfg, layout, dtype, device,
                                            lead=(count,), spec=spec)
        return init_block_cache(cfg, kind, layout.num_slots, layout.max_len,
                                dtype, device, lead=(count,))

    return map_layer_tree(cfg, one)


def paged_pool_mask(cfg, layout, spec=None):
    """Same-structure tree of kind strings over ``init_paged_cache``:
    ``"pool"`` on full-attention block-pool leaves (block axis at axis
    1, after the stacked layer-count axis; a quantized pool's scale
    leaves too) and ``"slot"`` on per-slot state (windowed rings,
    recurrent carries, conv tails; slot axis also at axis 1). Classified
    by layer KIND, never by shape, so a ring whose slot count equals the
    pool's block count cannot be taken for a pool. The tree's structure
    comes from a pool built on the meta device (no memory). Drives KV
    migration (``paged_kv.extract_blocks`` / ``insert_blocks``)."""
    shapes = init_paged_cache(cfg, layout, torch.device("meta"), spec)

    def tag(tree, kind):
        if isinstance(tree, dict):
            return {k: tag(v, kind) for k, v in tree.items()}
        return kind

    return map_layer_tree(cfg, lambda gk, pk, kind, count: tag(
        shapes[gk][pk], "pool" if _is_pool_kind(cfg, kind) else "slot"))


def paged_cache_specs(cfg, layout, shard, spec=None):
    """Specs of the ``init_paged_cache`` tree under a mesh (JAX's): block
    pools head-sharded over the model axis (``sharding.paged_pool_spec``;
    a quantized pool's scale leaves on the same head axis), rings and
    recurrent state on the per-slot cache rules. Pool leaves are found by
    layer KIND, never by shape."""
    from ..launch import sharding

    shapes = init_paged_cache(cfg, layout, torch.device("meta"), spec)

    def one(gk, pk, kind, count):
        sub = shapes[gk][pk]
        if _is_pool_kind(cfg, kind):
            return {n: sharding.paged_pool_spec(t.shape, shard)
                    for n, t in sub.items()}
        return sharding.batch_specs(sub, shard)

    return map_layer_tree(cfg, one)


def pack_prefill_into_paged(cfg, layout, pools, dense_caches, row_of_slot,
                            valid, block_ids, spec=None):
    """Install a batch of prefilled dense caches (``prefill`` with
    ``max_len == block_ids.shape[1] * block_size``) into the paged tree,
    IN PLACE. ``block_ids`` (N, nbp): per prefill row the physical
    destinations of its pool blocks, pad tails at the null block;
    ``spec`` quantizes those rows on the way in (scales land alongside).
    ``row_of_slot`` ((num_slots,) int) and ``valid`` ((num_slots,) bool)
    map slots to rows for the per-slot state (rings, recurrent carries,
    conv tails): slot s takes row ``row_of_slot[s]`` where ``valid[s]``,
    so a batch filler row never overwrites a live slot."""
    for gk, pattern, _ in layer_walk(cfg):
        for pi, kind in enumerate(pattern):
            pk = f"p{pi}"
            pool, dense = pools[gk][pk], dense_caches[gk][pk]
            if _is_pool_kind(cfg, kind):
                paged_kv.pack_prefill_kv(pool, dense, block_ids,
                                         layout.block_size, spec=spec)
            elif kind in ("attn", "local"):
                for name in ("k", "v"):
                    paged_kv.pack_prefill_ring(pool[name], dense[name],
                                               row_of_slot, valid)
            else:
                paged_kv.pack_prefill_state(pool, dense, row_of_slot, valid)
    return pools


def decode_step_paged(params, cfg, pools, block_table, lengths, tokens,
                      ctx: RunCtx):
    """Continuous-batching decode step.

    tokens: (B, 1) — one token per decode slot; lengths: (B,) int32
    tokens already cached per slot (the new token's position);
    block_table: (B, NBMAX) int32. Retired slots ride along pointed at
    the null block, their outputs discarded by the scheduler. Pool
    rows, ring rows and recurrent states are written into ``pools`` IN
    PLACE. Returns (logits (B, V) f32, pools).
    """
    shard = ctx.shard
    x = _embed(params, cfg, tokens, shard=shard)
    for kind, (lp, pool) in _layers(cfg, params["groups"], pools):
        x = apply_block_decode_paged(lp, cfg, kind, x, pool, block_table,
                                     lengths, ctx.kv_spec, shard)
    x = layers.apply_norm(cfg.norm, params["final_norm"], x)
    return _logits(params, cfg, x, shard)[:, 0], pools


def select_verify_state(cfg, cands, commit):
    """Commit a verify window's per-slot state at the accept boundary.

    ``cands`` mirrors the paged tree: full-attention pool leaves are
    already final (length-pointer rollback); every other leaf is
    (count, B, K1, ...), candidate j being the state after fed token j.
    ``commit``: (B,) int in [1, K1]: keep the state after fed token
    ``commit - 1``. Returns the committed tree (pool leaves as they
    are, per-slot leaves (count, B, ...))."""
    idx = (commit.long() - 1).clamp(min=0)
    bidx = torch.arange(idx.shape[0], device=idx.device)

    def one(gk, pk, kind, count):
        sub = cands[gk][pk]
        if _is_pool_kind(cfg, kind):
            return sub
        return {n: t[:, bidx, idx] for n, t in sub.items()}

    return map_layer_tree(cfg, one)


def decode_verify_paged(params, cfg, pools, block_table, lengths, tokens,
                        commit_fn, ctx: RunCtx):
    """Speculative-decode verify: score a K1-token window in ONE pass.

    tokens: (B, K1): per slot, the last accepted token followed by K
    draft tokens; fed token j is cached at position ``lengths[b] + j``
    and logits row j scores the NEXT position, so row j is what
    ``decode_step_paged`` would return after feeding tokens 0..j.
    ``commit_fn(logits (B, K1, V) f32) -> (out_tokens, commit)`` is the
    accept rule (``engine/sampling.verify_accept``); ``commit[b]`` in
    [1, K1] counts the fed tokens whose cache state to keep. Pools are
    written in place; per-slot state is selected at the accept boundary
    (``select_verify_state``). Returns (out_tokens, commit, pools).
    """
    shard = ctx.shard
    x = _embed(params, cfg, tokens, shard=shard)
    per_layer = map_layer_tree(cfg, lambda gk, pk, kind, count: [])
    for gk, pattern, count in layer_walk(cfg):
        for i in range(count):
            for pi, kind in enumerate(pattern):
                pk = f"p{pi}"
                x, c = apply_block_verify_paged(
                    layer_slice(params["groups"][gk][pk], i), cfg, kind, x,
                    layer_slice(pools[gk][pk], i), block_table, lengths,
                    ctx.kv_spec, shard)
                per_layer[gk][pk].append(c)

    def stacked(gk, pk, kind, count):
        if _is_pool_kind(cfg, kind):
            return pools[gk][pk]
        cs = per_layer[gk][pk]
        return {n: torch.stack([c[n] for c in cs]) for n in cs[0]}

    cands = map_layer_tree(cfg, stacked)
    x = layers.apply_norm(cfg.norm, params["final_norm"], x)
    out_tokens, commit = commit_fn(_logits(params, cfg, x, shard))
    return out_tokens, commit, select_verify_state(cfg, cands, commit)


def decode_step(params, cfg, cache, tokens, pos, ctx: RunCtx,
                mrope_positions=None):
    """Dense decode step: tokens (B, 1) at per-slot positions ``pos``
    (B,) over ``init_cache`` caches (written IN PLACE) -> (logits (B, V)
    f32, cache). An mrope config takes the tokens' ``mrope_positions``
    (3, B, 1). ``ctx.shard``: the cache is this rank's slice (the static
    backend over a mesh)."""
    shard = ctx.shard
    x = _embed(params, cfg, tokens, pos_offset=pos, shard=shard)
    for kind, (lp, lc) in _layers(cfg, params["groups"], cache):
        x = apply_block_decode(lp, cfg, kind, x, lc, pos, mrope_positions,
                               shard)
    x = layers.apply_norm(cfg.norm, params["final_norm"], x)
    return _logits(params, cfg, x, shard)[:, 0], cache


# ---------------------------------------------------------------------------
# Training forms (no cache)
# ---------------------------------------------------------------------------

def apply_block_train(p, cfg, kind, x, positions, mrope_positions=None):
    """Full-sequence block, no cache (JAX's ``apply_block`` with
    ``with_cache=False``): attention through K1 (its window for SWA and
    local layers), the RG-LRU through K5, then the MLP or the MoE routed
    with the capacity factor; an mLSTM / sLSTM block is ``x + out``.
    Returns (x, aux): the MoE's Switch aux loss, else 0.0."""
    xn = layers.apply_norm(cfg.norm, p["ln1"], x)
    if kind in ("attn", "local"):
        out, _ = attn_lib.attend(p["attn"], cfg, xn, positions,
                                 window=_window_for(cfg, kind),
                                 mrope_positions=mrope_positions)
    elif kind == "rglru":
        out = ssm.apply_rglru_block(p["rec"], cfg, xn)
    elif kind == "mlstm":
        out = ssm.apply_mlstm_block(p["mix"], cfg, xn)
    elif kind == "slstm":
        out = ssm.apply_slstm_block(p["mix"], cfg, xn)
    else:
        raise ValueError(kind)
    return _ffn_part(p, cfg, x + out, dropless=False)


def forward_hidden(params, cfg, tokens, ctx: RunCtx, visual_embeds=None,
                   mrope_positions=None):
    """tokens: (B, S) -> final-norm hidden (B, S, d), aux scalar f32 (the
    MoE layers' aux losses summed, JAX's ``_apply_groups`` total; 0 for
    every other config). ``ctx.remat == "full"`` recomputes each layer
    in the backward pass; the MoE's routing is a pure function of the
    layer's input, so the recomputed layer drops what the first pass
    dropped."""
    check_supported(cfg)
    B, S = tokens.shape
    x = _embed(params, cfg, tokens, visual_embeds)
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, (lp,) in _layers(cfg, params["groups"]):
        if ctx.remat == "full":
            x, a = torch.utils.checkpoint.checkpoint(
                apply_block_train, lp, cfg, kind, x, positions,
                mrope_positions, use_reentrant=False)
        else:
            x, a = apply_block_train(lp, cfg, kind, x, positions,
                                     mrope_positions)
        aux = aux + a
    return layers.apply_norm(cfg.norm, params["final_norm"], x), aux


def forward(params, cfg, tokens, ctx: RunCtx, visual_embeds=None,
            mrope_positions=None):
    """tokens: (B, S) -> logits (B, S, V) f32, aux scalar."""
    x, aux = forward_hidden(params, cfg, tokens, ctx, visual_embeds,
                            mrope_positions)
    return _logits(params, cfg, x), aux


def _ce_sum(x, head, tgt):
    logits = (x @ head).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tgt.long()[..., None])[..., 0]
    return logz - gold


def _ce_from_hidden(params, cfg, x, tgt, ctx: RunCtx):
    """Cross-entropy from hidden states; ``ctx.ce_chunk > 0`` (dividing
    S, and less than S) sums it over sequence chunks, so the full
    (B, S, V) logits never exist at once in the forward pass."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    C = ctx.ce_chunk
    B, S, _ = x.shape
    if not C or S % C != 0 or S == C:
        return torch.mean(_ce_sum(x, head, tgt))
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, C):
        total = total + torch.sum(_ce_sum(x[:, c0:c0 + C], head,
                                          tgt[:, c0:c0 + C]))
    return total / (B * S)


def loss_fn(params, cfg, batch, ctx: RunCtx):
    """batch: {tokens (B, S), targets (B, S)} (a VLM also
    ``visual_embeds``, ``mrope_positions``) -> (loss, metrics)."""
    x, aux = forward_hidden(params, cfg, batch["tokens"], ctx,
                            batch.get("visual_embeds"),
                            batch.get("mrope_positions"))
    ce = _ce_from_hidden(params, cfg, x, batch["targets"], ctx)
    loss = ce + cfg.moe_aux_coef * aux
    return loss, {"ce": ce, "aux": aux, "loss": loss}
