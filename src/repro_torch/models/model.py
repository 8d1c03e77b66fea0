"""Unified model API: config -> init / prefill / paged decode and verify /
dense decode.

Counterpart of ``repro/models/model.py`` (``ServingCaps``, ``Model``):
``Model`` dispatches on ``cfg.enc_dec`` between the decoder-only stack
(``transformer.py``: full and windowed attention, RG-LRU, mLSTM and
sLSTM layers, dense or MoE FFNs, the VLM's visual prefix and M-RoPE)
and the encoder-decoder (``encdec.py``). ``Model`` also owns the device the
model runs on: ``"cuda"`` by default, which raises on a machine without
a GPU instead of carrying on on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

from . import encdec, transformer
from .transformer import RunCtx


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument; raises
    when a CUDA device is asked for and none is present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain-torch path")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


@dataclasses.dataclass(frozen=True)
class ServingCaps:
    """Declared serving capabilities of one model configuration.

    Attributes
    ----------
    ragged_prefill : bool
        Right-padded (bucketed) prefill is exact: causal attention hides
        pad keys, and positions are relative or absent.
    prefix_cache : bool
        Block-granular KV prefix sharing is exact: every layer's decode
        state lives in the shared pool, with K/V a pure function of the
        prefix token ids and absolute positions.
    paged_decode : bool
        The model has a block-paged continuous-batching decode path.
    cross_attn : bool
        Requests carry encoder features (encoder-decoder configs).
    moe : bool
        FFN layers route through experts.
    quantized_kv : bool
        The paged pool may store int8/fp8 K/V payloads.
    """

    ragged_prefill: bool
    prefix_cache: bool
    paged_decode: bool
    cross_attn: bool
    moe: bool
    quantized_kv: bool


class Model:
    """Thin functional wrapper selecting the decoder-only or the
    encoder-decoder path, on one device."""

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    # -- parameters -----------------------------------------------------

    def init(self, seed: int = 0):
        """Random params from a ``torch.Generator`` seeded with ``seed``
        on this model's device (see ``transformer.init_lm`` and
        ``encdec.init_encdec``)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if self.cfg.enc_dec:
            return encdec.init_encdec(gen, self.cfg)
        return transformer.init_lm(gen, self.cfg)

    # -- training -------------------------------------------------------

    def forward(self, params, batch, ctx: RunCtx):
        """Full-sequence logits (B, S, V) f32 and the aux scalar of
        ``batch["tokens"]`` (a VLM also ``visual_embeds`` and
        ``mrope_positions``; an enc-dec config ``frames`` (B, F, d)): the
        training form, no cache."""
        if self.cfg.enc_dec:
            return encdec.forward(params, self.cfg, batch["tokens"],
                                  batch["frames"], ctx)
        return transformer.forward(params, self.cfg, batch["tokens"], ctx,
                                   batch.get("visual_embeds"),
                                   batch.get("mrope_positions"))

    def loss_fn(self, params, batch, ctx: RunCtx):
        """(loss, {"ce", "aux", "loss"}) of ``batch`` (``tokens``,
        ``targets``; an enc-dec config also ``frames``); differentiable
        with ``torch.autograd``. An MoE config's loss adds
        ``moe_aux_coef`` x its Switch aux loss."""
        if self.cfg.enc_dec:
            return encdec.loss_fn(params, self.cfg, batch, ctx)
        return transformer.loss_fn(params, self.cfg, batch, ctx)

    # -- serving --------------------------------------------------------

    def prefill(self, params, batch, ctx: RunCtx, max_len=None, length=None,
                rows=None):
        """Dense prefill of ``batch["tokens"]`` (B, S); an enc-dec config
        also takes ``batch["frames"]`` (B, F, d) (exact length only), a
        VLM ``batch["visual_embeds"]`` and ``batch["mrope_positions"]``.
        ``rows`` selects one position per row whose logits to return."""
        if self.cfg.enc_dec:
            if length is not None:
                raise NotImplementedError(
                    "padded prefill is decoder-only: the engine's "
                    "encoder-decoder admission is prefill_paged_encdec")
            return encdec.prefill(params, self.cfg, batch["tokens"],
                                  batch["frames"], ctx, max_len=max_len,
                                  rows=rows)
        return transformer.prefill(
            params, self.cfg, batch["tokens"], ctx, max_len=max_len,
            length=length, rows=rows,
            visual_embeds=batch.get("visual_embeds"),
            mrope_positions=batch.get("mrope_positions"))

    def serving_caps(self) -> ServingCaps:
        """The declared ``ServingCaps`` for this configuration (the same
        predicates as the JAX package)."""
        cfg = self.cfg
        paged = (cfg.rope_style != "mrope"
                 and not cfg.visual_prefix
                 and (cfg.pos_embed == "none" or cfg.enc_dec))
        return ServingCaps(
            ragged_prefill=(cfg.enc_dec
                            or transformer.prefill_supports_ragged(cfg)),
            prefix_cache=(not cfg.enc_dec
                          and set(cfg.block_pattern) == {"attn"}
                          and not cfg.sliding_window
                          and cfg.rope_style in ("rope", "none")
                          and cfg.pos_embed == "none"
                          and not cfg.visual_prefix),
            paged_decode=paged,
            cross_attn=cfg.enc_dec,
            moe=cfg.is_moe,
            quantized_kv=paged and not cfg.enc_dec,
        )

    def init_cache(self, batch: int, max_len: int, shard=None):
        """Per-slot decode caches (the draft model's, dense decode's):
        linear or ring K/V, recurrent state; an enc-dec config's self-KV
        and cross K/V. ``shard`` (a ``launch.sharding.ShardCtx``): this
        rank's slice of a decoder-only stack's caches (JAX's cache
        specs)."""
        if self.cfg.enc_dec:
            return encdec.init_cache(self.cfg, batch, max_len, self.device)
        return transformer.init_cache(self.cfg, batch, max_len, self.device,
                                      shard)

    def decode_step(self, params, cache, tokens, pos, ctx: RunCtx,
                    mrope_positions=None):
        """Dense decode: tokens (B, 1) at per-slot positions ``pos``; a
        VLM also takes their ``mrope_positions`` (3, B, 1)."""
        if self.cfg.enc_dec:
            return encdec.decode_step(params, self.cfg, cache, tokens, pos,
                                      ctx)
        return transformer.decode_step(params, self.cfg, cache, tokens, pos,
                                       ctx, mrope_positions=mrope_positions)

    def init_paged_cache(self, layout, spec=None, shard=None, device=None):
        """Block pools on this model's device (or ``device``: "meta" gives
        the tree's shapes without memory); ``spec`` (a
        ``paged_kv.PoolSpec``) selects an int8/fp8 block format. An
        enc-dec config's tree is its self-KV pool and the cross arena,
        always in the model dtype. ``shard``: this rank's slice of every
        pool and of the arena (``paged_cache_specs``)."""
        device = self.device if device is None else torch.device(device)
        if self.cfg.enc_dec:
            if spec is not None and spec.quantized:
                raise ValueError("quantized KV is decoder-only "
                                 "(ServingCaps.quantized_kv)")
            return encdec.init_paged_cache(self.cfg, layout, device, shard)
        return transformer.init_paged_cache(self.cfg, layout, device, spec,
                                            shard)

    def paged_cache_specs(self, layout, shard, spec=None):
        """Specs of the ``init_paged_cache`` tree over ``shard``'s mesh
        (``transformer.paged_cache_specs``; an enc-dec config's
        ``encdec.paged_cache_specs``, its cross arena included)."""
        if self.cfg.enc_dec:
            return encdec.paged_cache_specs(self.cfg, layout, shard)
        return transformer.paged_cache_specs(self.cfg, layout, shard, spec)

    def paged_pool_mask(self, layout, spec=None):
        """Same-structure tree of kind strings over ``init_paged_cache``:
        ``"pool"`` on block-pool leaves (scales included), ``"slot"`` on
        per-slot state, ``"cross"`` on cross-arena leaves, classified by
        layer kind (``transformer.paged_pool_mask``). Drives the KV
        migration gather and scatter of ``launch/engine/transport.py``."""
        if self.cfg.enc_dec:
            return encdec.paged_pool_mask(self.cfg, layout)
        return transformer.paged_pool_mask(self.cfg, layout, spec)

    def pack_prefill_into_paged(self, layout, pools, dense_caches,
                                row_of_slot, valid, block_ids, spec=None):
        """Batched install (in place): block_ids (N, nbp) per prefill
        row for the pools, ``row_of_slot`` / ``valid`` (num_slots,) for
        per-slot state (rings, RG-LRU carries); ``spec`` quantizes the
        pool writes (scales land alongside)."""
        return transformer.pack_prefill_into_paged(
            self.cfg, layout, pools, dense_caches, row_of_slot, valid,
            block_ids, spec)

    def prefill_paged_encdec(self, params, pools, tokens, frames,
                             enc_lengths, lengths, block_ids, arena_ids,
                             ctx: RunCtx):
        """Encoder-decoder admission (in place): masked encoder, cross
        K/V into the arena rows, the ragged decoder prefill packed into
        the pool. See ``encdec.prefill_paged``."""
        return encdec.prefill_paged(params, self.cfg, pools, tokens, frames,
                                    enc_lengths, lengths, block_ids,
                                    arena_ids, ctx)

    def decode_step_paged(self, params, pools, block_table, lengths, tokens,
                          ctx: RunCtx, arena_ids=None, enc_lengths=None):
        """One paged decode step; an enc-dec config also takes each
        slot's arena row and frame count."""
        if self.cfg.enc_dec:
            return encdec.decode_step_paged(params, self.cfg, pools,
                                            block_table, lengths, tokens,
                                            arena_ids, enc_lengths, ctx)
        return transformer.decode_step_paged(params, self.cfg, pools,
                                             block_table, lengths, tokens,
                                             ctx)

    def decode_verify(self, params, pools, block_table, lengths, tokens,
                      commit_fn, ctx: RunCtx):
        """Speculative verify: score a (B, K1) token window in one pass;
        ``commit_fn(logits) -> (out_tokens, commit)`` is the accept rule.
        See transformer.decode_verify_paged."""
        return transformer.decode_verify_paged(
            params, self.cfg, pools, block_table, lengths, tokens,
            commit_fn, ctx)
