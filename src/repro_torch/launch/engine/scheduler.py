"""PagedBackend: continuous batching over the block-paged KV cache.

Counterpart of ``repro/launch/engine/scheduler.py::PagedBackend``
(speculation subclasses it in ``speculative.py``):

* **Optimistic admission** — a request is admitted when the pool covers
  its *current* footprint (plus an optional free-block watermark), not
  its worst case.
* **LIFO preemption** — when a sequence needs a growth block and the
  pool is dry, the most recently admitted active sequence is evicted to
  a host-side *recompute record* (prompt + emitted tokens + RNG-stream
  position) and re-prefills over its history on re-admission (front of
  queue). The oldest admission is never evicted, so the engine cannot
  livelock, and outputs survive preemption bit-exactly.
* **Bucketed, batched prefill** — each admission drains the maximal FCFS
  *prefix* of the queue that shares the head's power-of-two prompt
  bucket and prefills it as ONE right-padded batch call (batch width a
  power of two, capped at the slot count), scattering each row's cache
  into its blocks; pad tails go to the reserved null block.
* **Copy-on-write prefix cache** (``EngineConfig.prefix_cache``, on by
  default) — admission matches each request's longest block-aligned
  cached prefix in a host-side trie (``paged_kv.PrefixIndex``) and
  shares those blocks by refcount. A full hit costs no device call (the
  first decode replays the prompt's last token), a partial hit prefills
  only the suffix through the verify pass (kernel K3), a miss takes the
  batched full prefill. A write into a shared block copies it first;
  unreferenced indexed blocks park in the allocator's LRU, reclaimed
  only when the free list runs dry.
* **Quantized pool** (``EngineConfig.kv_dtype`` int8 / fp8) — a
  ``paged_kv.PoolSpec`` rides in the ``RunCtx``: rows are quantized
  where they enter the pool (prefill pack, decode and verify frontiers)
  and dequantized inside the attention kernels (K4); COW copies the
  scale leaves with the payload.
* **The fused decode step** (``step_graph.DecodeStep``) — token-feed
  select, decode and on-device sampling as one call; on the card one
  replay of a captured CUDA graph, its host inputs packed into one
  copy. The sequential path dispatches it and fetches the tokens at
  once.
* **Encoder-decoder admission** (``ServingCaps.cross_attn``) — requests
  carry encoder features; the admission key adds the frame bucket
  (powers of two from 8, capped at ``encoder_len``), one call runs the
  masked encoder, writes each fresh row's cross K/V into its arena row
  (``paged_kv.CrossArena``: identity-shared features ride one row's
  refcount, and a row already written is not rewritten) and packs the
  decoder prefill; the decode step reads each
  slot's arena row. Rows are freed with the slot at retirement and
  preemption (a resumed request re-encodes).
* **Host/device overlap** (``EngineConfig.overlap``) — ``step()``
  dispatches the NEXT decode, feeding the in-flight sampled tokens
  device to device, before it fetches the previous step's tokens, so
  host scheduling hides under device work. Admission tickets discard
  the draws of rows retired in between; outputs are bit-identical with
  it on or off.
* **Tensor parallelism** (``RunCtx.shard``, set by the Engine from
  ``EngineConfig.mesh``, with its per-block plan) — every rank runs this
  scheduler on the same requests (SPMD): params are this rank's slices
  (``sharding.shard_params``), the pools its kv-head shard of every
  block (or the whole pool where the kv heads do not divide T), the
  per-slot state (rings, recurrent carries, conv tails) its slice by
  JAX's cache specs, so block tables, lengths, the allocator and the
  prefix index are the same host state on every rank and a COW copy
  runs on each rank's shard. Logits are all-gathered, so every rank samples the
  same token. No scheduling decision reads a clock. The captured decode
  step stays on under NCCL (its collectives capture); under gloo (the
  CPU, ranks sharing a card) the step runs eagerly and
  ``eager_decode_steps`` counts it: a choice made from the backend and
  reported in ``stats()["tp"]``, never taken on a failure. With
  ``overlap=True`` every rank makes the same follow-up / bail decision
  and allocates the same blocks (every input to them is the same host
  state on every rank), so the same collectives run in the same order:
  the dispatched decode's, then the admission prefill's. Under NCCL the
  dispatched step is a replay of the captured graph; under gloo it runs
  eagerly and its collectives block on the host, so overlap changes only
  the order of host work there (``stats()["overlap"]`` stays True and
  the dispatch-then-harvest path is the one that runs).
* **Migration** (``disagg.py`` / ``transport.py``) — ``export_slot``,
  ``detach_slot`` and ``import_slot`` move a live request between
  replicas' backends at any stream position; a ``prefill_only`` backend
  admits and prefills and never decodes.

The pools live on the engine's device and are updated in place (the
captured step replays over their storage: every writer keeps each leaf
where it is); the block table, lengths and sampler parameters are host
(numpy) state, copied to the device once per call.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ...models import paged_kv
from ...models.model import Model
from ...models.transformer import RunCtx
from .api import (EngineConfig, RequestHandle, RequestOutput, prefill_bucket,
                  register_sample)
from .sampling import SlotSampler
from .step_graph import DecodeStep, Tokens


@dataclasses.dataclass
class _Slot:
    req: Optional[RequestHandle] = None
    blocks: list[int] = dataclasses.field(default_factory=list)
    last_token: int = 0
    ticket: int = -1             # admission order; LIFO preemption key
    shared: int = 0              # leading blocks held by shared reference


@dataclasses.dataclass
class _Pending:
    """One dispatched decode whose sampled tokens are not fetched yet.
    ``rows`` records (slot, ticket) pairs so a harvest can discard draws
    whose slot retired or was re-admitted in between (tickets are
    monotonic: equality proves the same request); ``t_dispatch`` feeds
    the device-busy clock."""
    rows: list
    toks: Tokens
    t_dispatch: float


class PagedBackend:
    """Host-side scheduler state + device steps over the paged pools."""

    # False for a subclass that never decodes through ``_dispatch_decode``
    # (the speculative backend's verify step): it captures no graph
    fused_decode = True

    # Role specialization (disagg.py): a prefill-only backend runs
    # admission and prefill and returns before the decode phase; its
    # slots never grow, preempt or COW, the front-end exports them
    prefill_only = False

    def __init__(self, model: Model, params, cfg: EngineConfig,
                 ctx: RunCtx):
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = model.device
        self.layout = paged_kv.PagedLayout(
            num_slots=cfg.num_slots, num_blocks=cfg.num_blocks,
            block_size=cfg.block_size, max_len=cfg.max_len)
        # tensor parallelism: this rank keeps its slices of the params
        self.shard = ctx.shard
        if self.shard is not None:
            from ..sharding import leaf_exceptions, shard_params
            self.tp_leaves = leaf_exceptions(params, self.shard)
            self.params = params = shard_params(params, self.shard)
        # quantized paged KV: the PoolSpec rides in the RunCtx to the
        # write frontiers and the kernels; None keeps the model dtype
        self.kv_spec = None
        if cfg.kv_dtype != "bf16":
            self.kv_spec = paged_kv.make_pool_spec(
                model.cfg, self.layout, kv_dtype=cfg.kv_dtype,
                head_sharded=bool(ctx.decode_head_shard))
            ctx = dataclasses.replace(ctx, kv_spec=self.kv_spec)
        self.ctx = ctx
        caps = model.serving_caps()
        # cross-KV arena (encoder-decoder): one row per resident request
        self.arena = paged_kv.CrossArena(cfg.num_slots) \
            if caps.cross_attn else None
        self.arena_ids = np.zeros((cfg.num_slots,), np.int32)
        self.enc_lengths = np.zeros((cfg.num_slots,), np.int32)
        # COW prefix caching: only when EVERY layer's decode state lives
        # in the shared pool blocks
        self.prefix = paged_kv.PrefixIndex(cfg.block_size) \
            if cfg.prefix_cache and caps.prefix_cache else None
        self.alloc = paged_kv.BlockAllocator(
            self.layout, watermark=cfg.watermark_blocks,
            on_evict=self._on_evict if self.prefix is not None else None)
        self.pools = model.init_paged_cache(self.layout, spec=self.kv_spec,
                                            shard=self.shard)
        self.table = np.full(
            (cfg.num_slots, self.layout.max_blocks_per_seq),
            paged_kv.NULL_BLOCK, np.int32)
        self.lengths = np.zeros((cfg.num_slots,), np.int32)
        self.slots = [_Slot() for _ in range(cfg.num_slots)]
        self.sampler = SlotSampler(cfg.num_slots)
        self.waiting: collections.deque[RequestHandle] = collections.deque()
        self.finished: list[RequestHandle] = []
        self.ragged_prefill = cfg.bucketed_prefill and caps.ragged_prefill
        self.made_progress = False
        self._ticket = 0
        self._prefill_shapes: set = set()
        self._suffix_shapes: set = set()
        # overlap: the one in-flight decode, and outputs harvested
        # outside step() (flush_overlap) owed to the next step
        self._pending: Optional[_Pending] = None
        self._flushed: list[RequestOutput] = []
        self._no_prev = np.zeros((cfg.num_slots,), bool)
        self._t_fetch_done = 0.0
        self.reset_telemetry()
        # captured on the card now, while no slot is live (step_graph),
        # unless the ranks' collectives run over gloo, which no graph takes
        capture = self.shard is None or self.shard.backend == "nccl"
        self.decode = DecodeStep(model, params, self.pools, self.ctx,
                                 cfg.num_slots,
                                 self.layout.max_blocks_per_seq,
                                 cross=self.arena is not None,
                                 capture=capture) \
            if self.fused_decode else None

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -- public backend API ---------------------------------------------

    def enqueue(self, req: RequestHandle):
        """Append to the FCFS queue (the Engine validated it first)."""
        self.waiting.append(req)

    @property
    def num_active(self) -> int:
        """Occupied decode slots."""
        return sum(s.req is not None for s in self.slots)

    @property
    def has_work(self) -> bool:
        """True while any request is waiting or active (or a flush
        harvested outputs the next step still owes the stream)."""
        return bool(self.waiting) or self.num_active > 0 \
            or bool(self._flushed)

    def step(self) -> list[RequestOutput]:
        """Admissions, growth (with preemption), one decode, sampling.

        With ``cfg.overlap`` the call routes through ``_step_overlap``:
        the decode for THIS step is dispatched before the previous
        step's sampled tokens are fetched. Token values are identical
        either way (the RNG-stream contract)."""
        outs: list[RequestOutput] = []
        self.made_progress = False
        if self._flushed:
            outs.extend(self._flushed)
            self._flushed = []
            self.made_progress = True
        if self.prefill_only:          # it never dispatches a decode
            self._admit(outs)
            return outs
        if self.cfg.overlap:
            return self._step_overlap(outs)
        self._admit(outs)
        if self._dispatch_sequential():
            pend, self._pending = self._pending, None
            outs.extend(self._harvest(pend))   # replay, then fetch at once
        return outs

    def _dispatch_sequential(self) -> bool:
        """The sequential shape: growth (with LIFO preemption), COW of
        shared tail blocks, then one decode dispatch over the host
        tokens with the dead feed, left in ``self._pending``. Returns
        False when no slot is left to decode."""
        self._grow_blocks()
        active = [i for i, s in enumerate(self.slots) if s.req is not None]
        if not active:
            return False
        self._ensure_cow(active)       # may LIFO-preempt under pressure
        active = [i for i in active if self.slots[i].req is not None]
        if not active:
            return False
        tokens = np.zeros((self.cfg.num_slots, 1), np.int32)
        for i in active:
            tokens[i, 0] = self.slots[i].last_token
        self._dispatch_decode(active, tokens, self._no_prev, None,
                              self.sampler.steps)
        return True

    # -- host/device overlap (cfg.overlap) -------------------------------

    def _step_overlap(self, outs: list[RequestOutput]):
        """One overlapped step: (1) with a decode in flight, try to
        dispatch THIS step's decode first, feeding the in-flight tokens
        device to device (``_try_followup``); (2) fetch the in-flight
        tokens and register them; (3) admit: the admission prefill is
        enqueued after whichever decode was dispatched last, on the same
        stream, so its pool writes come after that decode's; (4) when no
        follow-up went out, take the sequential shape (growth with
        preemption, COW, dispatch) and leave the new decode pending.

        Outputs equal the sequential path's: every fed token and stream
        position matches, and a follow-up's writes for a row retired at
        harvest land only where nothing live reads (the row's own
        frontier, or blocks whose reuse is enqueued after this decode).
        Under a mesh every rank takes the same branch at each point (see
        the module docstring), so the ranks' collectives pair up."""
        pend, self._pending = self._pending, None
        followed = False
        if pend is not None:
            followed = self._try_followup(pend)
            outs.extend(self._harvest(pend))
        self._admit(outs)
        if not followed:
            self._dispatch_sequential()
        return outs

    def _try_followup(self, pend: _Pending) -> bool:
        """Dispatch the next decode BEFORE harvesting ``pend`` when that
        is safe without the in-flight tokens on the host:

        * rows whose in-flight token retires them for sure (max_tokens
          reached) are left out: their slot frees at harvest;
        * growth blocks and COW copies for every dispatched row must be
          allocatable WITHOUT preemption (preempting a row whose last
          token is still on the device would need that token for its
          recompute record); any shortfall bails to the sequential
          path, which may preempt after the harvest. Allocations made
          before a bail are kept: the sequential growth and COW passes
          skip rows already extended or privatized.

        An in-flight token that turns out to be a stop token retires its
        row at harvest anyway; the follow-up's draw for that row is
        discarded by the ticket check one step later, and its cache
        write landed one past the row's final frontier, never read.
        Returns True when the follow-up was dispatched."""
        bs = self.cfg.block_size
        inflight = set()
        for i, ticket in pend.rows:
            s = self.slots[i]
            if s.req is not None and s.ticket == ticket:
                inflight.add(i)
        dispatch = []
        for i, s in enumerate(self.slots):
            if s.req is None:
                continue
            if i in inflight and \
                    len(s.req.token_ids) + 1 >= s.req.sampling.max_tokens:
                continue              # harvest retires this row for sure
            dispatch.append(i)
        if not dispatch:
            return False
        for i in dispatch:
            slot = self.slots[i]
            L = int(self.lengths[i])
            if L % bs == 0 and L // bs >= len(slot.blocks):
                if not self.alloc.can_alloc(1):
                    return False      # pool dry: sequential path preempts
                (nb,) = self.alloc.alloc(1)
                slot.blocks.append(nb)
                self.table[i, len(slot.blocks) - 1] = nb
            if self.prefix is not None:
                idx = L // bs
                if idx < slot.shared:
                    assert idx == slot.shared - 1, \
                        "write frontier deeper than the shared tail block"
                    if not self.alloc.can_alloc(1):
                        return False
                    self._cow_block(i, idx)
        host = np.zeros((self.cfg.num_slots, 1), np.int32)
        use_prev = np.zeros((self.cfg.num_slots,), bool)
        for i in dispatch:
            if i in inflight:
                use_prev[i] = True    # its token is still on the device
            else:
                host[i, 0] = self.slots[i].last_token
        steps = self.sampler.steps.copy()
        steps[use_prev] += 1          # one draw ahead of the host mirror
        self._dispatch_decode(dispatch, host, use_prev, pend.toks, steps)
        return True

    def _dispatch_decode(self, active, host_tokens, use_prev, prev_toks,
                         steps):
        """Enqueue the fused feed-select + decode + sample WITHOUT
        fetching its tokens; the step parks in ``self._pending``.
        Lengths advance at dispatch (the fed token's cache write is in
        flight), so the harvest only registers the sampled values. The
        host arrays go to the device inside the dispatch, so bumping
        ``lengths`` and ``table`` afterwards is safe."""
        steps, samp = self.sampler.fused_args(steps)
        cross = None if self.arena is None else (self.arena_ids,
                                                  self.enc_lengths)
        t0 = time.monotonic()
        n0 = self._collectives()
        toks = self.decode.dispatch(self.pools, self.table, self.lengths,
                                    host_tokens, use_prev, prev_toks,
                                    steps, samp, cross)
        self.step_collectives += self._collectives() - n0
        self.steps += 1
        if self.decode.graphed:
            self.graph_replays += 1
        else:
            self.eager_decode_steps += 1
        self.slot_steps += len(active)
        self.block_token_steps += self.alloc.used_count * self.cfg.block_size
        self.made_progress = True
        rows = []
        for i in active:
            self.lengths[i] += 1          # the fed token got cached
            self.live_token_steps += int(self.lengths[i])
            rows.append((i, self.slots[i].ticket))
        self._pending = _Pending(rows, toks, t0)

    def _harvest(self, pend: _Pending) -> list[RequestOutput]:
        """Fetch an in-flight decode's tokens and register the draws.
        Rows whose slot retired or was re-admitted since the dispatch
        (ticket mismatch) are discarded: their cache writes landed where
        nothing live reads."""
        toks = pend.toks.fetch()            # the one blocking fetch
        self._mark_device(pend.t_dispatch)
        outs = []
        for i, ticket in pend.rows:
            slot = self.slots[i]
            if slot.req is None or slot.ticket != ticket:
                continue
            outs.append(self._accept(i, int(toks[i])))
        if outs:
            self.made_progress = True
        return outs

    def flush_overlap(self):
        """Harvest any in-flight decode NOW (no new dispatch) and buffer
        its outputs for the next ``step()``. A caller that reads host
        slot state calls this first (``lengths`` already counts the
        in-flight fed token, but ``slot.last_token`` is current only
        after the harvest); a flush may retire slots."""
        if self._pending is None:
            return
        pend, self._pending = self._pending, None
        self._flushed.extend(self._harvest(pend))

    def _mark_device(self, t_dispatch: float):
        """Account one dispatch-to-fetch interval into the device-busy
        clock, unioned with the previous fetch so overlapped dispatches
        never count device time twice."""
        t1 = time.monotonic()
        self.device_s += t1 - max(t_dispatch, self._t_fetch_done)
        self._t_fetch_done = t1

    def live_handles(self) -> list[RequestHandle]:
        """Resident + queued request handles (latency aggregation)."""
        return [s.req for s in self.slots if s.req is not None] \
            + list(self.waiting)

    # -- internals ------------------------------------------------------

    def _accept(self, i: int, tok: int) -> RequestOutput:
        """Register one sampled token for slot i; emit/stop/retire."""
        slot = self.slots[i]
        out = register_sample(slot.req, tok, self.cfg.eos_id,
                              lambda: self._retire(i))
        if not out.finished:
            self.sampler.steps[i] = slot.req._n_sampled
            slot.last_token = tok
        return out

    def _grow_blocks(self):
        """Allocate growth blocks oldest-admission-first; when the pool
        is dry, preempt LIFO until the allocation fits (a sequence may
        preempt itself if it is the newest — it then waits in queue)."""
        order = sorted(
            (i for i, s in enumerate(self.slots) if s.req is not None),
            key=lambda i: self.slots[i].ticket)
        for i in order:
            slot = self.slots[i]
            if slot.req is None:          # preempted earlier in this pass
                continue
            L = int(self.lengths[i])
            if L % self.cfg.block_size != 0 or \
                    L // self.cfg.block_size < len(slot.blocks):
                continue
            while not self.alloc.can_alloc(1):
                cands = [(j, s.ticket) for j, s in enumerate(self.slots)
                         if s.req is not None]
                victim = self.alloc.select_victim(cands)
                self._preempt(victim)
                if victim == i:
                    break
            if slot.req is None:
                continue
            (nb,) = self.alloc.alloc(1)
            slot.blocks.append(nb)
            self.table[i, len(slot.blocks) - 1] = nb

    def _on_evict(self, b: int):
        """Allocator reclaimed an unreferenced cached block: unlink it
        from the prefix index so it can never be matched again."""
        self.prefix.evict_block(b)
        self.prefix_evictions += 1

    def _ensure_cow(self, active):
        """Copy-on-write pass before a decode/verify device call: a slot
        whose next write position lands inside its SHARED prefix gets
        that block copied into a private one first, so the write cannot
        corrupt other slots sharing it (or the indexed copy future
        admissions match). Only the LAST shared block is ever a write
        target: writes happen at the length frontier, which a full-prefix
        hit places one token inside the shared tail (lengths = S - 1)."""
        if self.prefix is None:
            return
        bs = self.cfg.block_size
        for i in active:
            slot = self.slots[i]
            idx = int(self.lengths[i]) // bs
            if idx >= slot.shared:
                continue
            assert idx == slot.shared - 1, \
                "write frontier deeper than the shared tail block"
            assert self.alloc.must_cow(slot.blocks[idx])
            while not self.alloc.can_alloc(1):   # LIFO, like _grow_blocks
                cands = [(j, s.ticket) for j, s in enumerate(self.slots)
                         if s.req is not None]
                victim = self.alloc.select_victim(cands)
                self._preempt(victim)
                if victim == i:
                    break
            if slot.req is None:           # preempted itself: waits in
                continue                   # queue, re-admits later
            self._cow_block(i, idx)

    def _cow_block(self, i: int, idx: int):
        """Copy shared block ``slot.blocks[idx]`` into a freshly owned
        one (an indexed copy over every layer leaf of the in-place pools,
        the scale leaves of a quantized pool included) and swap the table
        entry; the old block keeps its other
        references and its place in the prefix index."""
        slot = self.slots[i]
        old = slot.blocks[idx]
        (new,) = self.alloc.alloc(1)
        for group in self.pools.values():        # {gk: {pk: {"k", "v"}}}
            for pool in group.values():
                for leaf in pool.values():       # (count, NB, BS, Hkv[, D])
                    leaf[:, new] = leaf[:, old]
        slot.blocks[idx] = new
        self.table[i, idx] = new
        self.alloc.free([old])             # drop only THIS slot's ref
        slot.shared = idx                  # blocks before idx still shared
        self.cow_copies += 1

    def _imminent_growth(self) -> int:
        """Growth blocks active sequences will claim THIS step, counted
        into admission so a new request cannot take the last free blocks
        only to be preempted by an older sequence's growth."""
        bs = self.cfg.block_size
        return sum(1 for i, s in enumerate(self.slots)
                   if s.req is not None
                   and int(self.lengths[i]) % bs == 0
                   and int(self.lengths[i]) // bs >= len(s.blocks))

    @staticmethod
    def _cached_tokens(req: RequestHandle) -> list[int]:
        """Tokens a (re-)admitted request must have in cache before its
        next decode: the prompt, plus all-but-the-last emitted token on
        a preemption resume (the last one is fed to decode)."""
        if req._n_sampled > 0:
            return list(req.prompt) + req.token_ids[:-1]
        return list(req.prompt)

    def _bucket_key(self, S: int):
        """The prefill-shape identity of a cached length: the padded
        token width (bucketed) or the exact length."""
        bs = self.cfg.block_size
        if self.ragged_prefill:
            cap = paged_kv.blocks_for(self.cfg.max_len, bs) * bs
            return paged_kv.blocks_for(prefill_bucket(S, bs, cap), bs) * bs
        return ("exact", S)

    def _suffix_bucket(self, n: int) -> int:
        """Power-of-two bucket for a non-shared admission suffix: the
        prompt-bucket policy (floor = block size, capped at the table
        width), so suffix-prefill shapes stay O(log max_len)."""
        bs = self.cfg.block_size
        cap = paged_kv.blocks_for(self.cfg.max_len, bs) * bs
        return prefill_bucket(n, bs, cap)

    def _enc_bucket(self, F: int) -> int:
        """The frame bucket of F encoder frames: a power of two from 8,
        capped at ``encoder_len`` (a full 1500-frame clip takes 1500)."""
        return prefill_bucket(F, 8, self.model.cfg.encoder_len)

    def _admit_key(self, S: int, matched: int, req: RequestHandle):
        """The admission-shape identity: full-hit installs (no device
        call), suffix prefills by suffix bucket, full prefills by the
        prompt bucket, times the frame bucket for encoder-decoder
        requests. Requests batch together iff their keys match."""
        if matched == S:
            key = ("hit",)
        elif matched > 0:
            key = ("sfx", self._suffix_bucket(S - matched))
        else:
            key = self._bucket_key(S)
        if self.arena is not None:
            key = (key, "enc",
                   self._enc_bucket(req.encoder_features.shape[0]))
        return key

    def _drain_bucket_run(self):
        """Pop the maximal FCFS PREFIX of the queue that fits the free
        slots and the pool (cumulative footprint + this step's imminent
        growth, watermark headroom while anything else runs), shares the
        head's admission key (prefill bucket / suffix bucket / full hit),
        and stays within ``max_prefill_batch``. A request that does not
        fit ends the run — no skipping ahead.

        Each accepted request's longest block-aligned cached prefix is
        matched here and its blocks are SHARED at once (refcount pinned),
        so a later entry's fresh allocation cannot reclaim them out of
        the LRU mid-run; a request that then fails the pool check is
        un-pinned before the run closes. Returns
        ``(req, matched_blocks, cached_tokens, S)`` entries."""
        free = sum(1 for s in self.slots if s.req is None)
        if not free:
            return []
        bs = self.cfg.block_size
        cap = free if self.cfg.max_prefill_batch <= 0 else \
            min(free, self.cfg.max_prefill_batch)
        run = []
        need = self._imminent_growth()
        key0 = None
        arena_need = 0
        seen_feats: set[int] = set()
        for req in self.waiting:
            if len(run) >= cap:
                break
            cached = self._cached_tokens(req)
            S = len(cached)
            m = self.prefix.match(cached) if self.prefix is not None \
                else []
            key = self._admit_key(S, len(m) * bs, req)
            if run and key != key0:
                break
            if self.arena is not None:
                # a fresh feature array claims an arena row; identity-
                # shared features (resident or earlier in this run) ride
                # an existing row's refcount
                fk = id(req.encoder_features)
                fresh = (fk not in seen_feats and self.arena.lookup(fk)
                         == paged_kv.NULL_ARENA)
                if fresh and not self.arena.can_admit(arena_need + 1):
                    break
                if fresh:
                    arena_need += 1
                    seen_feats.add(fk)
            for b in m:                   # pin against mid-run reclaim
                self.alloc.share(b)
            # + 1: the admitted slot decodes THIS step, caching the fed
            # token at position S; matched blocks are already resident
            # (for a fresh full hit the + 1 covers the COW block instead)
            want = paged_kv.blocks_for(S + 1, bs) - len(m)
            strict = self.num_active > 0 or bool(run)
            if not self.alloc.can_admit(need + want, strict=strict):
                if m:
                    self.alloc.free(m)    # un-pin: hits return to LRU
                break
            need += want
            run.append((req, m, cached, S))
            key0 = key
        for _ in run:
            self.waiting.popleft()
        return run

    def _admit(self, outs: list[RequestOutput]):
        while self.waiting:
            run = self._drain_bucket_run()
            if not run:
                return                    # FCFS: no skipping ahead
            self._place_batch(run, outs)

    def _place_batch(self, run, outs: list[RequestOutput]):
        """Admit one drained run (all rows share one admission key):
        install matched prefix blocks, allocate the rest and compute ONLY
        the non-shared tokens: a full-prefix hit costs no device call, a
        partial hit prefills just the suffix through the verify pass, a
        miss takes the batched full prefill. Then sample each row's first
        token (a resumed request samples nothing new: its last emitted
        token feeds the next decode; a fresh full hit samples it from
        this step's decode, at the same stream position from the same
        logits row)."""
        bs = self.cfg.block_size
        free_slots = [i for i, s in enumerate(self.slots) if s.req is None]
        rows = []                          # (slot, req, cached, S, ids)
        fresh = set()                      # slots whose arena row is new
        for req, m, cached, S in run:
            # matched blocks were share()'d at drain time; only the
            # non-shared tail is allocated
            block_ids = list(m) + self.alloc.alloc(
                paged_kv.blocks_for(S, bs) - len(m))
            i = free_slots.pop(0)
            slot = self.slots[i]
            slot.req = req
            slot.blocks = block_ids
            slot.shared = len(m)
            slot.ticket = self._ticket
            self._ticket += 1
            self.table[i, :] = paged_kv.NULL_BLOCK
            self.table[i, :len(block_ids)] = block_ids
            if self.arena is not None and self._install_arena(i, req):
                fresh.add(i)
            rows.append((i, req, cached, S, block_ids))
            if self.prefix is not None:
                self.prefix_lookups += 1
                if m:
                    self.prefix_hits += 1
                    self.prefix_hit_tokens += len(m) * bs
        _, m0, _, S0 = run[0]
        if m0 and len(m0) * bs == S0:
            row_logits = self._install_hits(rows)
        elif m0:
            row_logits = self._suffix_batch(rows)
        elif self.arena is not None:
            row_logits = self._encdec_batch(rows, fresh)
        else:
            row_logits = self._full_batch(rows)
        self.made_progress = True
        # index each row's full PROMPT-chunk blocks before sampling: a
        # max_tokens=1 row retires inside _accept, and its freed chain
        # must already be registered to land in the LRU
        if self.prefix is not None:
            for i, req, cached, S, block_ids in rows:
                for b in self.prefix.insert(cached, block_ids):
                    self.alloc.register(b)
        for r, (i, req, cached, S, block_ids) in enumerate(rows):
            self.sampler.install(i, req.sampling, req._n_sampled)
            if req._n_sampled > 0:         # resume: nothing new to sample
                self.slots[i].last_token = req.token_ids[-1]
            elif row_logits is not None:   # miss/suffix: sample token 0
                outs.append(self._accept(
                    i, self.sampler.sample_one(i, row_logits[r:r + 1])))
        self._post_admit(rows)

    def _install_hits(self, rows):
        """Full-prefix hit: every block is already resident, no device
        call. A RESUME row's cache is complete (lengths = S, feed the
        last emitted token); a FRESH row still owes the sample after its
        prompt, so its length rewinds one token (lengths = S - 1) and
        this step's decode replays ``cached[-1]``; that rewrite lands in
        the shared tail block, which ``_ensure_cow`` privatizes first."""
        for i, req, cached, S, block_ids in rows:
            if req._n_sampled > 0:
                self.lengths[i] = S
            else:
                self.lengths[i] = S - 1
                self.slots[i].last_token = cached[-1]
        return None

    def _suffix_batch(self, rows):
        """Partial hit: prefill ONLY each row's non-shared suffix, in one
        verify-pass call (fed token j caches at ``lengths + j``, which is
        suffix prefill when lengths = matched tokens), through kernel K3
        with K1 = W, the suffix bucket. The other slots ride along
        masked: local table rows at the null block and local lengths 0,
        so their writes land in the reserved block and their logits rows
        are ignored. Returns row-ordered next-token logits
        (len(rows), V)."""
        bs = self.cfg.block_size
        i0, _, _, S0, _ = rows[0]
        W = self._suffix_bucket(S0 - self.slots[i0].shared * bs)
        self._suffix_shapes.add(W)
        N = self.cfg.num_slots
        toks = np.zeros((N, W), np.int32)
        slens = np.zeros((N,), np.int32)
        stable = np.full((N, self.layout.max_blocks_per_seq),
                         paged_kv.NULL_BLOCK, np.int32)
        last = np.zeros((N,), np.int32)
        for i, req, cached, S, block_ids in rows:
            mt = self.slots[i].shared * bs
            sfx = S - mt
            toks[i, :sfx] = cached[mt:]
            slens[i] = mt
            stable[i, :len(block_ids)] = block_ids
            last[i] = sfx - 1
            self.lengths[i] = S
            self.prefill_tokens += sfx
        last_t = self._dev(last).long()
        ridx = torch.arange(N, device=self.device)

        def commit_fn(logits):           # (N, W, V) -> each row's last
            return logits[ridx, last_t], torch.full((N,), W)

        row_logits, _, self.pools = self.model.decode_verify(
            self.params, self.pools, self._dev(stable), self._dev(slens),
            self._dev(toks), commit_fn, self.ctx)
        self.prefill_calls += 1
        self.prefill_reqs += len(rows)
        return row_logits[[i for i, *_ in rows]]

    def _prefill_width(self, S: int, n: int):
        """(token width, cache width, batch width) of a prefill call:
        prompts pad to the power-of-two bucket (or keep the exact
        length), batch widths to the next power of two capped at
        num_slots; the cache width is a block multiple."""
        bs = self.cfg.block_size
        if self.ragged_prefill:
            tok_w = cache_w = self._bucket_key(S)
        else:
            tok_w, cache_w = S, paged_kv.blocks_for(S, bs) * bs
        Nb = min(1 << max(n - 1, 0).bit_length(), self.cfg.num_slots)
        return tok_w, cache_w, Nb

    def _full_batch(self, rows):
        """One right-padded batch prefill; each row's cache is scattered
        into its blocks (pad tails and filler rows at the null block) and
        its per-slot state (rings, RG-LRU carries) installed in its slot
        (``row_of_slot`` / ``valid``: filler rows install nothing).
        Returns row-ordered next-token logits (len(rows), V)."""
        tok_w, cache_w, Nb = self._prefill_width(rows[0][3], len(rows))
        self._prefill_shapes.add((tok_w, Nb))
        nbc = cache_w // self.cfg.block_size
        toks = np.zeros((Nb, tok_w), np.int32)
        lens = np.ones((Nb,), np.int32)    # batch fillers: harmless len 1
        ids = np.full((Nb, nbc), paged_kv.NULL_BLOCK, np.int32)
        row_of_slot = np.zeros((self.cfg.num_slots,), np.int32)
        valid = np.zeros((self.cfg.num_slots,), bool)
        for r, (i, req, cached, S, block_ids) in enumerate(rows):
            toks[r, :S] = cached
            lens[r] = S
            ids[r, :len(block_ids)] = block_ids
            row_of_slot[i] = r
            valid[i] = True
            self.lengths[i] = S
            self.prefill_tokens += S
        length = self._dev(lens)
        logits, dense = self.model.prefill(
            self.params, {"tokens": self._dev(toks)}, self.ctx,
            max_len=cache_w, length=length, rows=length - 1)
        self.model.pack_prefill_into_paged(
            self.layout, self.pools, dense, self._dev(row_of_slot),
            self._dev(valid), self._dev(ids), spec=self.kv_spec)
        self.prefill_calls += 1
        self.prefill_reqs += len(rows)
        return logits[:len(rows)]

    def _install_arena(self, i: int, req: RequestHandle) -> bool:
        """Bind slot ``i`` to a cross-arena row: share the resident row
        when the SAME feature array (by identity) is encoded already,
        else claim a fresh one; ``_clear_slot`` frees it. Returns True
        for a fresh row, which the admission call writes. A shared row
        is not rewritten: this admission encodes at its own batch bucket,
        whose GEMMs may round differently from the ones that wrote the
        row, and live requests read it."""
        feats = req.encoder_features
        a = self.arena.lookup(id(feats))
        fresh = a == paged_kv.NULL_ARENA
        if fresh:
            a = self.arena.alloc(key=id(feats))
        else:
            self.arena.share(a)
            self.arena_hits += 1
        self.arena_ids[i] = a
        self.enc_lengths[i] = feats.shape[0]
        return fresh

    def _encdec_batch(self, rows, fresh):
        """The encoder-decoder admission: one right-padded call at
        (prompt bucket, frame bucket, batch bucket) runs the masked
        encoder, writes the cross K/V of each row in ``fresh`` (slots)
        into its new arena row and packs the decoder prefill into its
        blocks (fillers, and rows on a row already written, point their
        arena write at the null row; fillers also take one token, no
        frames and the null block). The cache width is the
        prompt bucket's blocks. The frames go to the device as one
        (Nb, Fb, d) f32 batch staged in pinned memory, by one
        non-blocking copy. Returns row-ordered next-token logits
        (len(rows), V)."""
        bs = self.cfg.block_size
        _, req0, _, S0, _ = rows[0]
        tok_w = self._bucket_key(S0) if self.ragged_prefill else S0
        Fb = self._enc_bucket(req0.encoder_features.shape[0])
        Nb = min(1 << max(len(rows) - 1, 0).bit_length(),
                 self.cfg.num_slots)
        self._prefill_shapes.add(("encdec", tok_w, Fb, Nb))
        nbc = paged_kv.blocks_for(tok_w, bs)
        toks = np.zeros((Nb, tok_w), np.int32)
        lens = np.ones((Nb,), np.int32)
        frames = torch.zeros((Nb, Fb, self.model.cfg.d_model),
                             dtype=torch.float32,
                             pin_memory=self.device.type == "cuda")
        enc_lens = np.zeros((Nb,), np.int32)
        ids = np.full((Nb, nbc), paged_kv.NULL_BLOCK, np.int32)
        aids = np.zeros((Nb,), np.int32)
        for r, (i, req, cached, S, block_ids) in enumerate(rows):
            toks[r, :S] = cached
            lens[r] = S
            F = req.encoder_features.shape[0]
            frames[r, :F] = torch.as_tensor(np.asarray(
                req.encoder_features, np.float32))
            enc_lens[r] = F
            ids[r, :len(block_ids)] = block_ids
            aids[r] = self.arena_ids[i] if i in fresh \
                else paged_kv.NULL_ARENA
            self.lengths[i] = S
            self.prefill_tokens += S
        logits, _ = self.model.prefill_paged_encdec(
            self.params, self.pools, self._dev(toks),
            frames.to(self.device, non_blocking=True), self._dev(enc_lens),
            self._dev(lens), self._dev(ids), self._dev(aids), self.ctx)
        self.prefill_calls += 1
        self.prefill_reqs += len(rows)
        return logits[:len(rows)]

    def _preempt(self, i: int):
        """Evict slot i to a host-side recompute record (LIFO victim).
        Not progress: only admissions and decodes flip
        ``made_progress``."""
        slot = self.slots[i]
        req = slot.req
        req.num_preemptions += 1
        self.preemptions += 1
        self.alloc.free(slot.blocks)
        self._clear_slot(i)
        self.waiting.appendleft(req)      # preempted work goes first

    def _retire(self, i: int):
        """Backend cleanup after register_sample flagged the handle."""
        self.finished.append(self.slots[i].req)
        self.alloc.free(self.slots[i].blocks)
        self._clear_slot(i)

    def _clear_slot(self, i: int):
        slot = self.slots[i]              # in place: callers hold it
        slot.req = None
        slot.blocks = []
        slot.last_token = 0
        slot.ticket = -1
        slot.shared = 0
        self.table[i, :] = paged_kv.NULL_BLOCK
        self.lengths[i] = 0
        if self.arena is not None and self.arena_ids[i]:
            # retirement and preemption both land here: the row's
            # refcount drops with the slot (a resumed request re-encodes)
            self.arena.free(int(self.arena_ids[i]))
            self.arena_ids[i] = paged_kv.NULL_ARENA
            self.enc_lengths[i] = 0
        self.sampler.clear(i)
        self._post_clear(i)

    # -- migration (prefill/decode disaggregation) ----------------------

    def export_slot(self, i: int):
        """Host-side migration snapshot of occupied slot ``i``: the
        handle, its physical block chain, the cached length and the next
        token to feed. An in-flight overlapped decode is harvested first:
        ``lengths`` already counts its fed token, but ``last_token`` is
        current only once the sampled value lands. The harvest may retire
        slots, so callers check occupancy after any flush. The device
        content is gathered by ``transport.extract_slot`` before
        ``detach_slot`` frees the chain (the pools are written in place,
        so the gather copies)."""
        self.flush_overlap()
        slot = self.slots[i]
        assert slot.req is not None, "exporting an empty slot"
        return slot.req, list(slot.blocks), int(self.lengths[i]), \
            slot.last_token

    def detach_slot(self, i: int):
        """Drop slot ``i`` WITHOUT retiring or re-queueing it: its
        request now lives in a MigrationPacket, which holds gathered
        content, not block ids into this pool. The chain is freed here
        (shared references just decrement), so a packet dropped
        mid-migration leaks nothing on either side."""
        self.flush_overlap()           # no-op after export_slot's flush
        self.alloc.free(self.slots[i].blocks)
        self._clear_slot(i)

    def import_slot(self, req: RequestHandle, block_ids: list[int],
                    length: int, last_token: int) -> int:
        """Install a migrated request into a free slot over freshly
        alloc()'d ``block_ids`` (the transport scatters the packet into
        them; this installs the host-side view) and return the slot.
        Position-agnostic: ``length`` may be anywhere from the full-hit
        rewind (S - 1, nothing sampled yet) to deep mid-decode. The
        sampler resumes at the request's stream position, full prompt
        and output chunks are registered in the prefix index so later
        admissions here can share them, an encoder-decoder slot is bound
        to an arena row, and ``_post_admit`` lets the speculative backend
        install its drafter state."""
        free = [i for i, s in enumerate(self.slots) if s.req is None]
        assert free, "import into a full backend (caller gates on this)"
        i = free[0]
        slot = self.slots[i]
        slot.req = req
        slot.blocks = list(block_ids)
        slot.shared = 0                  # fresh private copies, COW-free
        slot.last_token = last_token
        slot.ticket = self._ticket
        self._ticket += 1
        self.table[i, :] = paged_kv.NULL_BLOCK
        self.table[i, :len(block_ids)] = block_ids
        if self.arena is not None:
            self._install_arena(i, req)
        self.lengths[i] = length
        self.sampler.install(i, req.sampling, req._n_sampled)
        cached = (list(req.prompt) + req.token_ids)[:length]
        if self.prefix is not None:
            for b in self.prefix.insert(cached, slot.blocks):
                self.alloc.register(b)
        self._post_admit([(i, req, cached, length, list(block_ids))])
        self.made_progress = True
        return i

    def _post_admit(self, rows):
        """Subclass hook: ``(slot, req, cached, S, block_ids)`` rows just
        admitted (the speculative backend installs drafter state here)."""

    def _post_clear(self, i: int):
        """Subclass hook: slot ``i`` was just retired or preempted."""

    # -- reporting ------------------------------------------------------

    def _collectives(self) -> int:
        """This engine's collectives so far (0 without a mesh)."""
        return 0 if self.shard is None else self.shard.stats.collectives

    def reset_telemetry(self):
        """Zero the counters behind ``stats()`` (e.g. after a warmup);
        does not touch scheduling state."""
        self.finished.clear()
        if self.shard is not None:
            self.shard.stats.reset()
        self.step_collectives = 0
        self.steps = self.slot_steps = 0
        self.graph_replays = self.eager_decode_steps = 0
        self.block_token_steps = self.live_token_steps = 0
        self.device_s = 0.0
        self.preemptions = 0
        self.prefill_calls = self.prefill_reqs = self.prefill_tokens = 0
        self.prefix_lookups = self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.cow_copies = self.prefix_evictions = 0
        self.arena_hits = 0          # admissions sharing a resident row

    def stats(self) -> dict:
        """Cache/occupancy/scheduling telemetry for the run so far.
        ``device_s`` is the union of the host-clock intervals from each
        decode's dispatch to its sampled tokens reaching the host;
        ``graph_replays`` / ``eager_decode_steps`` count the decode
        steps run by replay of the captured step (the card) and eagerly
        (the CPU); ``pool_bytes`` counts every leaf of the block pools,
        a quantized pool's scales included (and the cross arena's
        leaves); ``prefill_shapes`` counts the distinct admission shapes
        (JAX's ``prefill_compiles``), ``cross_arena`` the arena's rows
        and shared admissions. Under a mesh ``pool_bytes`` is this
        rank's (its slice) and a ``tp`` section reports the mesh and the
        plan (``sharding.tp_report``), whether the decode pool is head-sharded
        and whether the decode step is a captured graph."""
        cap = self.block_token_steps or 1
        st = {
            "steps": self.steps,
            "mean_active_slots": self.slot_steps / max(self.steps, 1),
            "cache_utilization": self.live_token_steps / cap,
            "overlap": bool(self.cfg.overlap),
            "device_s": self.device_s,
            "graph_replays": self.graph_replays,
            "eager_decode_steps": self.eager_decode_steps,
            "kv_dtype": self.cfg.kv_dtype,
            "pool_bytes": paged_kv.pool_bytes(self.pools),
            "blocks_free": self.alloc.free_count,
            "blocks_used": self.alloc.used_count,
            "preemptions": self.preemptions,
            "prefill_shapes": len(self._prefill_shapes),
            "prefill_calls": self.prefill_calls,
            "prefill_reqs": self.prefill_reqs,
            "prefill_tokens": self.prefill_tokens,
            "bucketed_prefill": self.ragged_prefill,
            "prefix_cache": {
                "enabled": self.prefix is not None,
                "lookups": self.prefix_lookups,
                "hits": self.prefix_hits,
                "hit_rate": self.prefix_hits / max(self.prefix_lookups, 1),
                "hit_tokens": self.prefix_hit_tokens,
                "cow_copies": self.cow_copies,
                "evictions": self.prefix_evictions,
                "lru_blocks": self.alloc.lru_count,
                "suffix_shapes": len(self._suffix_shapes),
            },
            "cross_arena": {
                "enabled": self.arena is not None,
                "rows_used": self.arena.used_count if self.arena else 0,
                "rows_free": self.arena.free_count if self.arena else 0,
                "shared_hits": self.arena_hits,
            },
        }
        if self.shard is not None:
            from ..sharding import tp_report
            st["tp"] = dict(
                tp_report(self.shard, self.device, self.step_collectives,
                          self.steps),
                **self.tp_leaves,
                head_sharded=bool(self.ctx.decode_head_shard),
                captured_step=bool(self.decode is not None
                                   and self.decode.graphed))
        return st
