"""StaticBackend: the lockstep batcher behind the Engine API.

Counterpart of ``repro/launch/engine/static.py``. A batch of waiting
requests is admitted at once and prefilled as one RIGHT-padded batch
(real tokens at positions 0..len-1, so causal attention never sees a pad
key and rope positions match the unbatched reference), then decoded in
lockstep with PER-ROW positions through ``Model.decode_step`` until
every member finishes; only then is the next batch admitted. Finished
rows ride along with their outputs discarded. Dense (num_slots,
max_len) cache: no paging, no preemption. It is the baseline the paged
backend is priced against.

Per-row true lengths thread through ``Model.prefill`` so ring and
recurrent caches capture state at each row's real boundary; prompts pad
to the power-of-two bucket of the longest (``prefill_bucket``, shared
with the paged backend). Models whose prefill state cannot be taken at
a padded length batch FCFS runs of equal prompt length instead. Eager
on both devices: the prefill runs K1 (and K5 for RG-LRU layers) on the
card, the dense decode is plain torch, as JAX computes it in jnp.

Under a mesh (``RunCtx.shard``) each rank keeps its param slices and its
slice of the caches (``sharding.batch_specs``' cache rules, applied by
``Model.prefill``: K/V by kv heads, recurrent state by channels or
heads, whole where they do not divide); the decode is eager, its
collectives counted in ``stats()["tp"]``.
"""

from __future__ import annotations

import collections
from typing import Optional

import numpy as np
import torch

from ...models import paged_kv
from .api import (EngineConfig, RequestHandle, RequestOutput, prefill_bucket,
                  register_sample)
from .sampling import SlotSampler


class StaticBackend:
    """Lockstep batcher over a dense (B, max_len) cache (the baseline).

    One batch in, right-padded batched prefill, per-row-position decode
    until every member finishes, then the next batch. See the module
    docstring for the padding and bucketing contract."""

    def __init__(self, model, params, cfg: EngineConfig, ctx):
        self.model = model
        self.shard = ctx.shard
        if self.shard is not None:
            from ..sharding import leaf_exceptions, shard_params
            self.tp_leaves = leaf_exceptions(params, self.shard)
            params = shard_params(params, self.shard)
        self.params = params
        self.cfg = cfg
        self.ctx = ctx
        self.device = model.device
        self.ragged = model.serving_caps().ragged_prefill
        B = cfg.num_slots
        self.waiting: collections.deque[RequestHandle] = collections.deque()
        self.finished: list[RequestHandle] = []
        self.batch: list[Optional[RequestHandle]] = [None] * B
        self.live = np.zeros((B,), bool)
        self.lengths = np.ones((B,), np.int32)
        self.last = np.zeros((B,), np.int32)
        self.cache = None
        self.sampler = SlotSampler(B)
        self.made_progress = False
        self._prefill_shapes: set = set()
        self.reset_telemetry()

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -- public backend API ---------------------------------------------

    def enqueue(self, req: RequestHandle):
        """Append to the FCFS queue (validated by the caller)."""
        self.waiting.append(req)

    @property
    def num_active(self) -> int:
        """Live rows in the current lockstep batch."""
        return int(self.live.sum())

    @property
    def has_work(self) -> bool:
        """True while any request is waiting or live."""
        return bool(self.waiting) or bool(self.live.any())

    def live_handles(self) -> list[RequestHandle]:
        """Resident + queued request handles (latency aggregation)."""
        return [h for h in self.batch if h is not None
                and not h.finished] + list(self.waiting)

    def step(self) -> list[RequestOutput]:
        """Admit a fresh batch when idle, else one lockstep decode."""
        outs: list[RequestOutput] = []
        self.made_progress = False
        if not self.live.any():
            if self.waiting:
                self._admit_batch(outs)
            return outs
        rows = np.flatnonzero(self.live)
        n0 = self._collectives()
        logits, self.cache = self.model.decode_step(
            self.params, self.cache, self._dev(self.last[:, None]),
            self._dev(self.lengths), self.ctx)
        self.step_collectives += self._collectives() - n0
        toks = self.sampler.sample(logits)
        self.steps += 1
        self.slot_steps += len(rows)
        self.made_progress = True
        for i in rows:
            self.lengths[i] += 1          # the fed token got cached
            self.live_token_steps += int(self.lengths[i])
            outs.append(self._accept(int(i), int(toks[i])))
        if not self.live.any():
            self._clear_batch()
        return outs

    # -- internals ------------------------------------------------------

    def _admit_batch(self, outs: list[RequestOutput]):
        """Lockstep admission is batched prefill admission: the whole
        batch prefills as one right-padded call at the bucket of its
        longest member. Admission is not split by bucket: a lockstep
        lane left idle by a split stays idle for the whole generation.
        ``max_prefill_batch`` (> 0) bounds the admitted width."""
        B = self.cfg.num_slots
        cap = B if self.cfg.max_prefill_batch <= 0 else \
            min(B, self.cfg.max_prefill_batch)
        reqs = []
        while self.waiting and len(reqs) < cap:
            # models without length-exact padded prefill batch FCFS runs
            # of EQUAL prompt length
            if not self.ragged and reqs and \
                    len(self.waiting[0].prompt) != len(reqs[0].prompt):
                break
            reqs.append(self.waiting.popleft())
        plens = [len(r.prompt) for r in reqs]
        Lb = self._bucket(max(plens))
        self._prefill_shapes.add(Lb)
        toks = np.zeros((B, Lb), np.int32)
        lens = np.ones((B,), np.int32)    # filler rows: harmless length 1
        for i, r in enumerate(reqs):
            toks[i, :plens[i]] = r.prompt
            lens[i] = plens[i]
        length = self._dev(lens)
        # each row's next-token logits at its true last position
        row_logits, self.cache = self.model.prefill(
            self.params, {"tokens": self._dev(toks)}, self.ctx,
            max_len=self.cfg.max_len,
            length=length if self.ragged else None, rows=length - 1)
        self.batches += 1
        self.cache_bytes = paged_kv.pool_bytes(self.cache)
        self.lengths[:] = lens
        self.last[:] = 0
        for i, r in enumerate(reqs):
            self.batch[i] = r
            self.live[i] = True
            self.sampler.install(i, r.sampling, 0)
        first = self.sampler.sample(row_logits)
        for i in range(len(reqs)):
            outs.append(self._accept(i, int(first[i])))
        self.made_progress = True
        if not self.live.any():           # the whole batch stopped at once
            self._clear_batch()

    def _bucket(self, maxp: int) -> int:
        if not self.ragged:
            return maxp                   # uniform lengths: exact
        return prefill_bucket(maxp, self.cfg.block_size, self.cfg.max_len)

    def _accept(self, i: int, tok: int) -> RequestOutput:
        out = register_sample(self.batch[i], tok, self.cfg.eos_id,
                              lambda: self._finish(i))
        if not out.finished:
            self.sampler.steps[i] = self.batch[i]._n_sampled
            self.last[i] = tok
        return out

    def _finish(self, i: int):
        """Backend cleanup after register_sample flagged the handle."""
        self.finished.append(self.batch[i])
        self.live[i] = False              # rides along until batch ends

    def _clear_batch(self):
        B = self.cfg.num_slots
        self.batch = [None] * B
        self.live[:] = False
        self.lengths[:] = 1
        self.last[:] = 0
        self.cache = None
        for i in range(B):
            self.sampler.clear(i)

    # -- reporting ------------------------------------------------------

    def _collectives(self) -> int:
        return 0 if self.shard is None else self.shard.stats.collectives

    def reset_telemetry(self):
        """Zero the counters behind ``stats()`` (e.g. after a warm-up);
        does not touch scheduling state."""
        self.finished.clear()
        if self.shard is not None:
            self.shard.stats.reset()
        self.step_collectives = self.cache_bytes = 0
        self.steps = self.batches = 0
        self.slot_steps = self.live_token_steps = 0

    def stats(self) -> dict:
        """Occupancy / utilization telemetry (dense-cache denominator:
        every lane pays max_len whether live or not);
        ``prefill_compiles`` counts the prefill shapes seen."""
        cap = self.steps * self.cfg.num_slots * self.cfg.max_len or 1
        st = {
            "steps": self.steps,
            "batches": self.batches,
            "mean_active_slots": self.slot_steps / max(self.steps, 1),
            "cache_utilization": self.live_token_steps / cap,
            "prefill_compiles": len(self._prefill_shapes),
        }
        if self.shard is not None:
            from ..sharding import tp_report
            st["tp"] = dict(tp_report(self.shard, self.device,
                                      self.step_collectives, self.steps),
                            **self.tp_leaves,
                            cache_bytes=self.cache_bytes)
        return st
