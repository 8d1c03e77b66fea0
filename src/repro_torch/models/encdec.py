"""Encoder-decoder assembly (whisper-base backbone).

Counterpart of ``repro/models/encdec.py``. The conv / mel frontend is a
stub, as in JAX: the encoder takes precomputed frame embeddings (B, F,
d). Both stacks add sinusoidal positions; a decoder block is
self-attention, cross-attention over the encoder's K/V and the MLP.
The params are JAX's tree: ``embed`` (tied head), ``enc`` and ``dec``
stacks with every leaf led by the layer count, ``enc_norm``,
``final_norm``. Where JAX runs ``lax.scan`` over a stack, this module
runs a Python loop over the layer index.

Three paths share the params:

* **dense** (``prefill`` / ``decode_step``): the exact-length encoder
  bidirectional through kernel K1, the decoder's causal self-attention
  through K1, its cross-attention through K1 non-causal
  (``attention.attend_cross``); decode over a linear self-KV cache and
  the prefill's cross K/V, plain torch for the self-attention;
* **paged** (``prefill_paged`` / ``decode_step_paged``, what the
  ``Engine`` runs): a right-padded admission whose encoder masks pad
  frames per row and whose cross-attention masks them too (plain
  torch, ``attend_masked`` / ``attend_cross_masked``), the decoder's
  self-attention through K1 (causal attention hides pad keys) and its
  K/V packed into the block pool, the cross K/V written into the
  request's arena row; the decode step reads the pool through K2 and
  gathers each slot's arena row, masked to its true frame count;
* **training** (``forward`` / ``loss_fn``): the dense path's exact-length
  encoder and decoder without a cache, K1 and its backward kernel under
  autograd, the cross-entropy over the full logits.

Everything writes its pools and arena IN PLACE, so the captured decode
step (``launch/engine/step_graph.py``) replays over fixed storage.

Tensor parallelism (``ctx.shard``, the serving paths): the encoder, the
decoder's self-attention and the cross-attention run by the plan's one
attention mode (``launch.sharding.plan_tp``): on the rank's heads, its
pool and arena split by kv heads (``"heads"``), or its query heads over
a pool and arena every rank writes whole (``"kv_replicated"``); the MLPs
by ``d_ff``, the embedding and tied head by vocabulary where it divides
T. Each row-parallel product is all-reduced (``layers.tp_reduce``).
``paged_cache_specs`` gives the tree's layout, JAX's.
"""

from __future__ import annotations

import torch

from . import attention as attn_lib
from . import layers, paged_kv
from .transformer import _logits, layer_slice, model_dtype

ENC_KEYS = ("ln1", "attn", "ln2", "mlp")
DEC_KEYS = ("ln1", "attn", "lnx", "xattn", "ln2", "mlp")


def init_encdec(gen, cfg):
    """Random params from the ``torch.Generator`` ``gen`` on its device,
    with JAX's tree and distributions (the values differ from JAX's
    ``PRNGKey`` draws: carry those over with ``models/weights.py``)."""
    dtype = model_dtype(cfg)

    def norm(*lead):
        return layers.init_norm(cfg.norm, cfg.d_model, dtype, gen.device,
                                lead)

    def attn(n):
        return attn_lib.init_attention(gen, cfg, dtype, (n,))

    def mlp(n):
        return layers.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype,
                               gated=cfg.gated_mlp, lead=(n,))

    ne, nd = cfg.n_encoder_layers, cfg.n_layers
    return {"embed": layers.truncated_normal_init(
                gen, (cfg.vocab_size, cfg.d_model), dtype, stddev=1.0),
            "enc": {"ln1": norm(ne), "attn": attn(ne), "ln2": norm(ne),
                    "mlp": mlp(ne)},
            "enc_norm": norm(),
            "dec": {"ln1": norm(nd), "attn": attn(nd), "lnx": norm(nd),
                    "xattn": attn(nd), "ln2": norm(nd), "mlp": mlp(nd)},
            "final_norm": norm()}


def _mlp_part(p, cfg, x, shard=None):
    xn = layers.apply_norm(cfg.norm, p["ln2"], x)
    mlp_shard = shard if layers.split_over(shard, "mlp") else None
    return x + layers.apply_mlp(p["mlp"], xn, cfg.activation, mlp_shard)


def encode(params, cfg, frames, enc_lengths=None, shard=None):
    """frames (B, F, d) -> encoder output (B, F, d) in the model dtype.

    The frames are cast to the model dtype BEFORE the sinusoidal table
    is added in that dtype (JAX's order). ``enc_lengths`` ((B,) int)
    masks right-padded frames (``attend_masked``); None runs the
    exact-length encoder through K1, bidirectional. ``shard``: this
    rank's heads and MLP columns, each block's output all-reduced.
    """
    x = frames.to(model_dtype(cfg))
    positions = torch.arange(x.shape[1], device=x.device)
    x = x + layers.sinusoidal_embed(positions, cfg.d_model, x.dtype)
    for i in range(cfg.n_encoder_layers):
        p = layer_slice(params["enc"], i)
        xn = layers.apply_norm(cfg.norm, p["ln1"], x)
        if enc_lengths is None:
            out, _ = attn_lib.attend(p["attn"], cfg, xn, positions,
                                     causal=False, shard=shard)
        else:
            out = attn_lib.attend_masked(p["attn"], cfg, xn, enc_lengths,
                                         shard)
        x = _mlp_part(p, cfg, x + out, shard)
    return layers.apply_norm(cfg.norm, params["enc_norm"], x)


def _embed(params, cfg, tokens, positions, shard=None):
    """Token embeddings (``shard``: from this rank's vocab slice,
    ``layers.vocab_parallel_lookup``) plus the sinusoidal table at
    ``positions`` (broadcast against tokens' (B, S))."""
    x = layers.vocab_parallel_lookup(params["embed"], tokens, shard)
    return x + layers.sinusoidal_embed(positions, cfg.d_model, x.dtype)


def _select_rows(x, rows):
    """One position per batch row ((B,) int ``rows``) of x (B, S, d) as
    (B, 1, d), or x itself when ``rows`` is None."""
    if rows is None:
        return x
    return x[torch.arange(x.shape[0], device=x.device), rows.long()][:, None]


def _decoder_prefill(params, cfg, tokens, enc_out, cross_fn, shard=None):
    """The decoder over a full (right-padded) prompt: per layer K1
    causal self-attention, then ``cross_fn(p_xattn, xn, cross_kv)``, then
    the MLP. Returns (hidden (B, S, d), per-layer [(k, v)] with k, v
    (B, S, Hkv, D), per-layer cross K/V). ``shard``: the rank's heads
    (K1 on them) and MLP columns, and its kv heads' K/V."""
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)
    x = _embed(params, cfg, tokens, positions, shard)
    self_kv, cross = [], []
    for i in range(cfg.n_layers):
        p = layer_slice(params["dec"], i)
        xkv = attn_lib.encode_cross_kv(p["xattn"], cfg, enc_out)
        xn = layers.apply_norm(cfg.norm, p["ln1"], x)
        out, kv = attn_lib.attend(p["attn"], cfg, xn, positions,
                                  shard=shard)
        x = x + out
        xn = layers.apply_norm(cfg.norm, p["lnx"], x)
        x = _mlp_part(p, cfg, x + cross_fn(p["xattn"], xn, xkv), shard)
        self_kv.append(kv)
        cross.append(xkv)
    return x, self_kv, cross


def forward(params, cfg, tokens, frames, ctx=None):
    """The training forward (no cache): tokens (B, S) and frames (B, F,
    d) -> (logits (B, S, V) f32, aux 0.0). The exact-length encoder runs
    K1 bidirectional, each decoder layer K1 causal and its
    cross-attention K1 non-causal (S query rows over F keys), all under
    autograd. JAX's enc-dec trains with neither ``remat`` nor
    ``ce_chunk``, and ``ctx`` is ignored here too."""
    del ctx
    enc_out = encode(params, cfg, frames)
    x, _, _ = _decoder_prefill(
        params, cfg, tokens, enc_out,
        lambda p, xn, kv: attn_lib.attend_cross(p, cfg, xn, kv))
    x = layers.apply_norm(cfg.norm, params["final_norm"], x)
    return _logits(params, cfg, x), \
        torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params, cfg, batch, ctx=None):
    """batch: {tokens (B, S), targets (B, S), frames (B, F, d)} ->
    (loss, {"ce", "aux", "loss"}): the mean cross-entropy over the full
    logits, aux 0 (JAX's ``encdec.loss_fn``)."""
    logits, aux = forward(params, cfg, batch["tokens"], batch["frames"],
                          ctx)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        batch["targets"].long()[..., None])[..., 0]
    ce = torch.mean(logz - gold)
    return ce, {"ce": ce, "aux": aux, "loss": ce}


def _stack(kvs):
    return {n: torch.stack([kv[n] for kv in kvs]) for n in ("k", "v")}


def init_cache(cfg, batch: int, max_len: int, device):
    """Zeroed dense decode state: a linear self-KV cache per decoder
    layer ``{"k", "v"}`` of (L, batch, max_len, Hkv, D), and cross K/V
    of (L, batch, Hkv, encoder_len, D)."""
    dtype = model_dtype(cfg)
    L, hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    self_c = attn_lib.init_kv_cache(cfg, batch, max_len, dtype, device,
                                    lead=(L,))
    cross = {n: torch.zeros((L, batch, hkv, cfg.encoder_len, hd),
                            dtype=dtype, device=device) for n in ("k", "v")}
    return {"self": self_c, "cross": cross}


def prefill(params, cfg, tokens, frames, ctx=None, max_len=None,
            rows=None):
    """Exact-length encode + decoder prefill (the dense path).

    tokens (B, S); frames (B, F, d). Returns (logits, cache): logits (B,
    S, V) f32, or (B, V) at one position per row when ``rows`` ((B,)
    int) is given; cache ``{"self": {"k", "v"} (L, B, max_len, Hkv, D)
    zero past S, "cross": {"k", "v"} (L, B, Hkv, F, D)}``.
    """
    del ctx
    B, S = tokens.shape
    enc_out = encode(params, cfg, frames)
    x, self_kv, cross = _decoder_prefill(
        params, cfg, tokens, enc_out,
        lambda p, xn, kv: attn_lib.attend_cross(p, cfg, xn, kv))
    cache = attn_lib.init_kv_cache(cfg, B, max_len or S, model_dtype(cfg),
                                   tokens.device, lead=(cfg.n_layers,))
    for name, t in _stack(self_kv).items():
        cache[name][:, :, :S] = t
    x = layers.apply_norm(cfg.norm, params["final_norm"],
                          _select_rows(x, rows))
    logits = _logits(params, cfg, x)
    return (logits[:, 0] if rows is not None else logits), \
        {"self": cache, "cross": _stack(cross)}


def decode_step(params, cfg, cache, tokens, pos, ctx=None):
    """One decoder token per row over the dense cache: tokens (B, 1) at
    positions ``pos`` ((B,) int, each row's cached length). The self-KV
    row is written IN PLACE; the cross K/V is read as it is. Returns
    (logits (B, V) f32, cache)."""
    del ctx
    x = _embed(params, cfg, tokens, pos.long()[:, None])
    for i in range(cfg.n_layers):
        p = layer_slice(params["dec"], i)
        sc = layer_slice(cache["self"], i)
        xkv = layer_slice(cache["cross"], i)
        xn = layers.apply_norm(cfg.norm, p["ln1"], x)
        out, _ = attn_lib.decode_attend_batched(p["attn"], cfg, xn, sc, pos)
        x = x + out
        xn = layers.apply_norm(cfg.norm, p["lnx"], x)
        x = _mlp_part(p, cfg,
                      x + attn_lib.attend_cross(p["xattn"], cfg, xn, xkv))
    x = layers.apply_norm(cfg.norm, params["final_norm"], x)
    return _logits(params, cfg, x)[:, 0], cache


# ---------------------------------------------------------------------------
# Paged serving: self-KV in the block pool, cross-KV in the arena
# ---------------------------------------------------------------------------


def init_paged_cache(cfg, layout, device, shard=None):
    """``{"self": {"k", "v"}, "cross": {"k", "v"}}``: the decoder's
    self-KV in a block pool of (L, NB, BS, Hkv, D), the cross K/V in the
    arena (``paged_kv.init_cross_arena``). Block tables, lengths, arena
    rows and frame counts live with the scheduler. ``shard``: this
    rank's slice of each leaf (``paged_cache_specs``), allocated at its
    local shape."""
    if shard is not None:
        from ..launch import sharding
        meta = init_paged_cache(cfg, layout, torch.device("meta"))
        return sharding.local_zeros(meta, paged_cache_specs(cfg, layout,
                                                            shard),
                                    shard, device)
    dtype = model_dtype(cfg)
    return {"self": paged_kv.init_layer_pool(cfg, layout, dtype, device,
                                             lead=(cfg.n_layers,)),
            "cross": paged_kv.init_cross_arena(cfg, layout, dtype, device)}


def paged_cache_specs(cfg, layout, shard):
    """Specs of the ``init_paged_cache`` tree over ``shard``'s mesh
    (JAX's ``encdec.paged_cache_specs``): the self pool head-sharded like
    every full-attention pool (``sharding.paged_pool_spec``), the cross
    arena (L, A+1, Hkv, F, D) on its kv-head axis where the kv heads
    divide the model axis, else whole (its rows stay whole: A+1 is off
    any power-of-two grid)."""
    from ..launch import sharding

    shapes = init_paged_cache(cfg, layout, torch.device("meta"))
    tp = shard.tp_axis if cfg.n_kv_heads % shard.tp_size == 0 else None
    return {"self": {n: sharding.paged_pool_spec(t.shape, shard)
                     for n, t in shapes["self"].items()},
            "cross": {n: (None, None, tp, None, None)
                      for n in shapes["cross"]}}


def paged_pool_mask(cfg, layout):
    """Kind strings over ``init_paged_cache``: the decoder self-KV is
    ``"pool"`` (block axis at axis 1), the cross arena ``"cross"``
    (arena-row axis at axis 1). Drives KV migration."""
    return {"self": {"k": "pool", "v": "pool"},
            "cross": {"k": "cross", "v": "cross"}}


def prefill_paged(params, cfg, pools, tokens, frames, enc_lengths, lengths,
                  block_ids, arena_ids, ctx=None):
    """A batched encoder-decoder admission, IN PLACE.

    tokens (N, Sb) right-padded to the prompt bucket; frames (N, Fb, d)
    right-padded to the frame bucket; enc_lengths, lengths (N,) true
    frame and prompt counts (batch fillers: 0 frames, 1 token);
    block_ids (N, nbp) the block destinations (pad tails and fillers at
    the null block), nbp * BS >= Sb; arena_ids (N,) the arena rows to
    write (fillers, and rows whose features are written already, at the
    null row). The masked encoder runs, each layer's
    cross K/V is written into the arena rows, and the decoder's
    self-KV packed into the pool. Returns (logits (N, V) f32 at each
    row's last real position, pools). ``ctx.shard``: the rank's heads,
    and its slices of the pool and the arena.
    """
    shard = ctx.shard if ctx is not None else None
    N, Sb = tokens.shape
    bs = pools["self"]["k"].shape[2]
    enc_out = encode(params, cfg, frames, enc_lengths=enc_lengths,
                     shard=shard)
    x, self_kv, cross = _decoder_prefill(
        params, cfg, tokens, enc_out,
        lambda p, xn, kv: attn_lib.attend_cross_masked(p, cfg, xn, kv,
                                                       enc_lengths, shard),
        shard)
    W = block_ids.shape[1] * bs
    dense = {n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, W - Sb))
             for n, t in _stack(self_kv).items()}     # (L, N, W, Hkv, D)
    paged_kv.pack_prefill_kv(pools["self"], dense, block_ids, bs)
    paged_kv.pack_cross_arena(pools["cross"], _stack(cross), arena_ids)
    x = layers.apply_norm(cfg.norm, params["final_norm"],
                          _select_rows(x, lengths.long() - 1))
    return _logits(params, cfg, x, shard)[:, 0], pools


def decode_step_paged(params, cfg, pools, block_table, lengths, tokens,
                      arena_ids, enc_lengths, ctx=None):
    """The continuous-batching decode step: tokens (B, 1) at per-row
    positions ``lengths`` (B,) (each row's sinusoidal position too),
    self-attention through K2 over the pool (the new row written IN
    PLACE), cross-attention over each row's arena row ``arena_ids``
    (B,) masked to ``enc_lengths`` (B,) (an empty slot on the null row,
    0 frames, reads zeros). Nothing is read back to the host. Returns
    (logits (B, V) f32, pools). ``ctx.shard``: K2 over the rank's
    head-sharded pool (or its kv-head range of a whole one), the cross
    attention over its arena slice, the logits all-gathered where the
    vocabulary splits."""
    shard = ctx.shard if ctx is not None else None
    x = _embed(params, cfg, tokens, lengths.long()[:, None], shard)
    rows = arena_ids.long()
    for i in range(cfg.n_layers):
        p = layer_slice(params["dec"], i)
        xn = layers.apply_norm(cfg.norm, p["ln1"], x)
        out, _ = attn_lib.decode_attend_paged(
            p["attn"], cfg, xn, layer_slice(pools["self"], i), block_table,
            lengths, shard=shard)
        x = x + out
        xn = layers.apply_norm(cfg.norm, p["lnx"], x)
        kv = {n: torch.index_select(pools["cross"][n][i], 0, rows)
              for n in ("k", "v")}                  # (B, Hkv, enc_len, D)
        x = _mlp_part(p, cfg, x + attn_lib.attend_cross_masked(
            p["xattn"], cfg, xn, kv, enc_lengths, shard), shard)
    x = layers.apply_norm(cfg.norm, params["final_norm"], x)
    return _logits(params, cfg, x, shard)[:, 0], pools
