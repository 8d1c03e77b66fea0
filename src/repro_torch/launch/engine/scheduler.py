"""PagedBackend: continuous batching over the block-paged KV cache.

Counterpart of ``repro/launch/engine/scheduler.py::PagedBackend``
without overlap, speculation, prefix cache, mesh or cross arena:

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

The pools live on the engine's device and are updated in place; the
block table, lengths and sampler parameters are host (numpy) state,
copied to the device once per call.
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


@dataclasses.dataclass
class _Slot:
    req: Optional[RequestHandle] = None
    blocks: list[int] = dataclasses.field(default_factory=list)
    last_token: int = 0
    ticket: int = -1             # admission order; LIFO preemption key


class PagedBackend:
    """Host-side scheduler state + device steps over the paged pools."""

    def __init__(self, model: Model, params, cfg: EngineConfig,
                 ctx: RunCtx):
        self.model = model
        self.params = params
        self.cfg = cfg
        self.ctx = ctx
        self.device = model.device
        self.layout = paged_kv.PagedLayout(
            num_slots=cfg.num_slots, num_blocks=cfg.num_blocks,
            block_size=cfg.block_size, max_len=cfg.max_len)
        self.alloc = paged_kv.BlockAllocator(self.layout,
                                             watermark=cfg.watermark_blocks)
        self.pools = model.init_paged_cache(self.layout)
        self.table = np.full(
            (cfg.num_slots, self.layout.max_blocks_per_seq),
            paged_kv.NULL_BLOCK, np.int32)
        self.lengths = np.zeros((cfg.num_slots,), np.int32)
        self.slots = [_Slot() for _ in range(cfg.num_slots)]
        self.sampler = SlotSampler(cfg.num_slots)
        self.waiting: collections.deque[RequestHandle] = collections.deque()
        self.finished: list[RequestHandle] = []
        self.ragged_prefill = (cfg.bucketed_prefill
                               and model.serving_caps().ragged_prefill)
        self.made_progress = False
        self._ticket = 0
        self._prefill_shapes: set = set()
        self.reset_telemetry()

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -- public backend API ---------------------------------------------

    def check_request(self, prompt_len: int, sampling):
        """Reject requests whose WORST-CASE footprint exceeds the pool
        (they could never run to completion even alone)."""
        worst = paged_kv.blocks_for(
            prompt_len + sampling.max_tokens, self.cfg.block_size)
        if worst > self.layout.usable_blocks:
            raise ValueError(
                f"request worst case ({worst} blocks) exceeds pool "
                f"capacity ({self.layout.usable_blocks} usable blocks) — "
                "it could never run to completion even alone")

    def enqueue(self, req: RequestHandle):
        """Append to the FCFS queue (the Engine validated it first)."""
        self.waiting.append(req)

    @property
    def num_active(self) -> int:
        """Occupied decode slots."""
        return sum(s.req is not None for s in self.slots)

    @property
    def has_work(self) -> bool:
        """True while any request is waiting or active."""
        return bool(self.waiting) or self.num_active > 0

    def step(self) -> list[RequestOutput]:
        """Admissions, growth (with preemption), one decode, sampling."""
        outs: list[RequestOutput] = []
        self.made_progress = False
        self._admit(outs)
        self._grow_blocks()
        active = [i for i, s in enumerate(self.slots) if s.req is not None]
        if not active:
            return outs
        tokens = np.zeros((self.cfg.num_slots, 1), np.int32)
        for i in active:
            tokens[i, 0] = self.slots[i].last_token
        t0 = time.monotonic()
        logits, self.pools = self.model.decode_step_paged(
            self.params, self.pools, self._dev(self.table),
            self._dev(self.lengths), self._dev(tokens), self.ctx)
        toks = self.sampler.sample(logits)       # waits for the device
        self.device_s += time.monotonic() - t0
        self.steps += 1
        self.slot_steps += len(active)
        self.block_token_steps += self.alloc.used_count * self.cfg.block_size
        self.made_progress = True
        for i in active:
            self.lengths[i] += 1          # the fed token got cached
            self.live_token_steps += int(self.lengths[i])
            outs.append(self._accept(i, int(toks[i])))
        return outs

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
        token width (bucketed) or the exact length. Requests batch
        together iff their keys match."""
        bs = self.cfg.block_size
        if self.ragged_prefill:
            cap = paged_kv.blocks_for(self.cfg.max_len, bs) * bs
            return paged_kv.blocks_for(prefill_bucket(S, bs, cap), bs) * bs
        return ("exact", S)

    def _drain_bucket_run(self):
        """Pop the maximal FCFS PREFIX of the queue that fits the free
        slots and the pool (cumulative footprint + this step's imminent
        growth, watermark headroom while anything else runs), shares the
        head's bucket, and stays within ``max_prefill_batch``. A request
        that does not fit ends the run — no skipping ahead. Returns
        ``(req, cached_tokens, S)`` entries."""
        free = sum(1 for s in self.slots if s.req is None)
        if not free:
            return []
        bs = self.cfg.block_size
        cap = free if self.cfg.max_prefill_batch <= 0 else \
            min(free, self.cfg.max_prefill_batch)
        run = []
        need = self._imminent_growth()
        key0 = None
        for req in self.waiting:
            if len(run) >= cap:
                break
            cached = self._cached_tokens(req)
            S = len(cached)
            key = self._bucket_key(S)
            if run and key != key0:
                break
            # + 1: the admitted slot decodes THIS step, caching the fed
            # token at position S
            want = paged_kv.blocks_for(S + 1, bs)
            strict = self.num_active > 0 or bool(run)
            if not self.alloc.can_admit(need + want, strict=strict):
                break
            need += want
            run.append((req, cached, S))
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
        """Admit one drained run: allocate each row's blocks, prefill the
        batch in one call, sample each row's first token (a resumed
        request samples nothing new: its last emitted token feeds the
        next decode)."""
        bs = self.cfg.block_size
        free_slots = [i for i, s in enumerate(self.slots) if s.req is None]
        rows = []                          # (slot, req, cached, S, ids)
        for req, cached, S in run:
            block_ids = self.alloc.alloc(paged_kv.blocks_for(S, bs))
            i = free_slots.pop(0)
            slot = self.slots[i]
            slot.req = req
            slot.blocks = block_ids
            slot.ticket = self._ticket
            self._ticket += 1
            self.table[i, :] = paged_kv.NULL_BLOCK
            self.table[i, :len(block_ids)] = block_ids
            rows.append((i, req, cached, S, block_ids))
        row_logits = self._full_batch(rows)
        self.made_progress = True
        for r, (i, req, cached, S, block_ids) in enumerate(rows):
            self.sampler.install(i, req.sampling, req._n_sampled)
            if req._n_sampled > 0:         # resume: nothing new to sample
                self.slots[i].last_token = req.token_ids[-1]
            else:
                outs.append(self._accept(
                    i, self.sampler.sample_one(i, row_logits[r:r + 1])))

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
        into its blocks (pad tails and filler rows at the null block).
        Returns row-ordered next-token logits (len(rows), V)."""
        tok_w, cache_w, Nb = self._prefill_width(rows[0][3], len(rows))
        self._prefill_shapes.add((tok_w, Nb))
        nbc = cache_w // self.cfg.block_size
        toks = np.zeros((Nb, tok_w), np.int32)
        lens = np.ones((Nb,), np.int32)    # batch fillers: harmless len 1
        ids = np.full((Nb, nbc), paged_kv.NULL_BLOCK, np.int32)
        for r, (i, req, cached, S, block_ids) in enumerate(rows):
            toks[r, :S] = cached
            lens[r] = S
            ids[r, :len(block_ids)] = block_ids
            self.lengths[i] = S
            self.prefill_tokens += S
        length = self._dev(lens)
        logits, dense = self.model.prefill(
            self.params, {"tokens": self._dev(toks)}, self.ctx,
            max_len=cache_w, length=length, rows=length - 1)
        self.model.pack_prefill_into_paged(self.layout, self.pools, dense,
                                           self._dev(ids))
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
        self.table[i, :] = paged_kv.NULL_BLOCK
        self.lengths[i] = 0
        self.sampler.clear(i)

    # -- reporting ------------------------------------------------------

    def reset_telemetry(self):
        """Zero the counters behind ``stats()`` (e.g. after a warmup);
        does not touch scheduling state."""
        self.finished.clear()
        self.steps = self.slot_steps = 0
        self.block_token_steps = self.live_token_steps = 0
        self.device_s = 0.0
        self.preemptions = 0
        self.prefill_calls = self.prefill_reqs = self.prefill_tokens = 0

    def stats(self) -> dict:
        """Cache/occupancy/scheduling telemetry for the run so far.
        ``device_s`` is host time from each decode's launch to its
        sampled tokens reaching the host."""
        cap = self.block_token_steps or 1
        return {
            "steps": self.steps,
            "mean_active_slots": self.slot_steps / max(self.steps, 1),
            "cache_utilization": self.live_token_steps / cap,
            "device_s": self.device_s,
            "blocks_free": self.alloc.free_count,
            "blocks_used": self.alloc.used_count,
            "preemptions": self.preemptions,
            "prefill_shapes": len(self._prefill_shapes),
            "prefill_calls": self.prefill_calls,
            "prefill_reqs": self.prefill_reqs,
            "prefill_tokens": self.prefill_tokens,
            "bucketed_prefill": self.ragged_prefill,
        }
