"""Speculative decoding on the paged Engine: draft, verify, commit.

Counterpart of ``repro/launch/engine/speculative.py``. A cheap drafter
proposes up to K tokens per scheduled request, and the target model
scores all K+1 positions in ONE pass through the paged KV pool (kernel
K3 fetches every pool block once for the whole window instead of once
per token). Acceptance couples the drafts to the request's own sampling
stream: the engine's sampler is a deterministic function of (seed,
stream position), so rejection sampling collapses to exact-match
acceptance and outputs equal the non-speculative engine's, greedy and
seeded alike (``sampling.verify_accept``).

Rollback is free for the block pool: a rejected tail is erased by
rewinding the slot's length pointer and returning surplus tail blocks to
the allocator, with no block copies. Per-slot state (windowed rings,
RG-LRU carries) is committed by picking the candidate state at the
accept boundary (``transformer.select_verify_state``).

Two drafters:

* ``NgramDrafter`` — zero parameters, prompt lookup: the longest recent
  n-gram suffix of the request's history is matched against its own
  earlier tokens and the continuation is proposed.
* ``DraftModelDrafter`` — a small draft ``Model`` sharing the target's
  vocabulary, decoded greedily slot-parallel over dense per-slot caches
  (plain torch) after a prefill through kernel K1; its cache rolls back
  by the same position-pointer rewind. Under a mesh the draft model
  runs whole on every rank (replicated), the target's verify and suffix
  prefill on each rank's heads (K3 through its ``*_headshard`` wrapper).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ...models import paged_kv
from ...models.model import Model
from ...models.transformer import RunCtx
from .api import EngineConfig, RequestOutput, prefill_bucket
from .sampling import verify_accept, verify_accept_greedy
from .scheduler import PagedBackend


class NgramDrafter:
    """Zero-parameter prompt-lookup drafter (self-drafting).

    Proposes continuations by matching the longest suffix of a request's
    own history (up to ``max_ngram`` tokens) against earlier occurrences
    in that history and replaying the tokens that followed the most
    recent match. No device state, nothing to roll back: ``begin``,
    ``rewind`` and ``drop`` do nothing.

    Parameters
    ----------
    k : int
        Maximum drafts proposed per request per step.
    max_ngram : int
        Longest suffix length to key on; falls back to shorter suffixes
        (down to 1 token) before giving up.
    """

    def __init__(self, k: int, max_ngram: int = 3):
        self.k = k
        self.max_ngram = max_ngram

    def begin(self, slot: int, context):
        """No-op: the drafter reads each request's history directly."""

    def rewind(self, slot: int, new_len: int, tail_token: int):
        """No-op: no device state to roll back."""

    def drop(self, slot: int):
        """No-op: nothing installed per slot."""

    def propose(self, active, last_tokens, histories):
        """Per-slot proposals: ``{slot: [draft, ...]}`` (possibly [])."""
        return {i: self.lookup(histories[i]) for i in active}

    def lookup(self, history) -> list[int]:
        """Longest-suffix prompt lookup over one token history.

        Longest suffix first; within a suffix length, the MOST RECENT
        match with a full K-token continuation wins (on periodic text the
        latest match sits so close to the end that its continuation is
        clipped, while an earlier period offers the same tokens at full
        width). Falls back to the longest partial continuation when no
        match has K tokens after it.
        """
        H = len(history)
        best: list[int] = []
        for n in range(min(self.max_ngram, H - 1), 0, -1):
            suffix = history[H - n:]
            for e in range(H - 1, n - 1, -1):
                if history[e - n:e] == suffix:
                    cont = list(history[e:e + self.k])
                    if len(cont) == self.k:
                        return cont
                    if len(cont) > len(best):
                        best = cont
        return best


class DraftModelDrafter:
    """Draft-model drafter: greedy slot-parallel decode of a small LM.

    The draft shares the target's vocabulary and decodes over dense
    per-slot caches (one row per engine slot); its proposals never
    affect output correctness, only the acceptance rate, so it always
    decodes greedily. Rollback after a rejected tail is a position
    rewind, which is why the draft must keep ALL state
    position-addressed: full-attention linear caches only.

    Parameters
    ----------
    model, params
        The draft ``Model`` (decoder-only, pattern all-"attn", no
        sliding window, same vocab as the target) and its params, on the
        engine's device.
    cfg : EngineConfig
        The engine config (slot count, max_len, spec_tokens).
    ctx : RunCtx
        Per-call model context shared with the engine.
    """

    def __init__(self, model: Model, params, cfg: EngineConfig,
                 ctx: RunCtx):
        if model is None or params is None:
            raise ValueError("drafter='draft_model' needs "
                             "EngineConfig.draft_model/draft_params")
        mc = model.cfg
        if (set(mc.block_pattern) != {"attn"} or mc.sliding_window
                or mc.enc_dec or mc.pos_embed != "none"):
            raise ValueError(
                "the draft model must be attention-only (linear caches "
                "roll back by position rewind; rings/SSM carries do not)")
        self.model = model
        self.params = params
        self.ctx = ctx
        self.k = cfg.spec_tokens
        self.num_slots = cfg.num_slots
        self.max_len = cfg.max_len
        self.device = model.device
        self.cache = model.init_cache(cfg.num_slots, cfg.max_len)
        self.pos = np.zeros((cfg.num_slots,), np.int32)
        # slot -> token the draft cache is missing at its frontier: on a
        # FULL unshrunk accept the target's cache is one token ahead of
        # the draft's (the last draft was emitted but never fed back), so
        # the next propose() feeds it first, leaving no unwritten hole
        self._pending: dict[int, int] = {}
        self.ragged = model.serving_caps().ragged_prefill

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def begin(self, slot: int, context):
        """(Re-)prefill the draft cache row for ``slot`` over the tokens
        the target has cached (admission and preemption resume)."""
        S = len(context)
        Sb = prefill_bucket(S, 8, self.max_len) if self.ragged else S
        toks = np.zeros((1, Sb), np.int32)
        toks[0, :S] = context
        length = self._dev(np.asarray([S], np.int32))
        _, dense = self.model.prefill(
            self.params, {"tokens": self._dev(toks)}, self.ctx,
            max_len=self.max_len, length=length, rows=length - 1)
        valid = np.zeros((self.num_slots,), bool)
        valid[slot] = True
        paged_kv.pack_prefill_state(
            self.cache, dense,
            self._dev(np.zeros((self.num_slots,), np.int32)),
            self._dev(valid))
        self.pos[slot] = S
        self._pending.pop(slot, None)

    def rewind(self, slot: int, new_len: int, tail_token: int):
        """Resynchronise with the target's cache after a verify.

        ``new_len`` is the target cache's new length, ``tail_token`` the
        token at its last position. A rejected tail: entries past
        ``new_len`` are masked by position and overwritten as decode
        re-advances. A FULL accept: the target is one token AHEAD of the
        draft (``tail_token`` was emitted from the window, never fed to
        the draft), so it is stashed and fed first at the next propose.
        """
        if new_len > self.pos[slot]:
            self._pending[slot] = tail_token
        else:
            self.pos[slot] = new_len
            self._pending.pop(slot, None)

    def drop(self, slot: int):
        """Forget the slot: its cache row is garbage until ``begin``."""
        self.pos[slot] = 0
        self._pending.pop(slot, None)

    def propose(self, active, last_tokens, histories):
        """K greedy draft tokens for every active slot in K slot-parallel
        decode calls of the draft model. Slots with a pending catch-up
        token spend their first call feeding it, so they return K-1
        drafts that step."""
        toks = np.zeros((self.num_slots, 1), np.int32)
        queued = {}                       # catch-up slots: fed at step 1
        for i in active:
            if i in self._pending:
                toks[i, 0] = self._pending.pop(i)
                queued[i] = last_tokens[i]
            else:
                toks[i, 0] = last_tokens[i]
        pos = self.pos.copy()
        outs = np.zeros((self.num_slots, self.k), np.int32)
        for t in range(self.k):
            logits, self.cache = self.model.decode_step(
                self.params, self.cache, self._dev(toks), self._dev(pos),
                self.ctx)
            nxt = logits.argmax(-1).int().cpu().numpy()
            outs[:, t] = nxt
            toks = nxt[:, None].astype(np.int32)
            if t == 0:
                for i, tok in queued.items():
                    toks[i, 0] = tok
            pos += 1
        for i in active:
            self.pos[i] += self.k
        # a catch-up slot's step-0 output followed the re-fed token, not
        # the actual next token (the bonus): it is not a usable draft
        return {i: [int(x) for x in outs[i, (1 if i in queued else 0):]]
                for i in active}


_DRAFTERS = ("ngram", "draft_model")


class SpecDecodeBackend(PagedBackend):
    """Speculative-decoding backend: PagedBackend + draft/verify/commit.

    Admission, growth, preemption and retirement are the paged
    scheduler's; only the decode step differs. Each step:

    1. the drafter proposes up to K tokens per active slot;
    2. growth covers each slot's verify window (positions L..L+k_i),
       preferring to SHRINK a slot's window over preempting others; the
       plain-decode footprint keeps the base LIFO guarantee;
    3. ONE verify pass embeds the (B, K+1) window, runs it through kernel
       K3 over the paged pool and applies the exact-match accept rule
       against each request's own sampling stream;
    4. the host registers the emitted tokens through the standard
       acceptance state machine (stop tokens, max_tokens, streaming
       increments), rewinds each slot's length pointer over the rejected
       tail and returns surplus blocks to the pool.

    Attributes
    ----------
    drafter : NgramDrafter | DraftModelDrafter
        Proposal source, selected by ``EngineConfig.drafter``.
    spec_steps, spec_proposed, spec_accepted, spec_emitted : int
        Window telemetry surfaced by ``stats()['spec']``; per-request
        counters live on ``RequestHandle.num_draft_proposed/accepted``.

    Notes
    -----
    Output tokens equal ``PagedBackend``'s for any SamplingParams: the
    verify logits at row j are the baseline decode logits after feeding
    tokens 0..j, and the accept rule IS the baseline sampler evaluated
    ahead on the same stream positions.
    """

    # the verify step stays eager: no captured decode step (``self.decode``
    # is None)
    fused_decode = False

    def __init__(self, model: Model, params, cfg: EngineConfig,
                 ctx: RunCtx):
        super().__init__(model, params, cfg, ctx)
        self.k = cfg.spec_tokens
        self.k1 = self.k + 1
        if cfg.max_len <= self.k1:
            raise ValueError(f"spec_tokens={self.k} needs max_len > "
                             f"{self.k1}")
        if cfg.drafter == "ngram":
            self.drafter = NgramDrafter(self.k, cfg.ngram_max)
        elif cfg.drafter == "draft_model":
            if cfg.draft_model is not None \
                    and cfg.draft_model.cfg.vocab_size != model.cfg.vocab_size:
                raise ValueError("draft and target models must share a "
                                 "vocabulary")
            # the draft model runs whole on every rank (its params are
            # not sliced): the same proposals everywhere
            self.drafter = DraftModelDrafter(
                cfg.draft_model, cfg.draft_params, cfg,
                dataclasses.replace(ctx, shard=None,
                                    decode_head_shard=False))
        else:
            raise ValueError(f"unknown drafter {cfg.drafter!r} "
                             f"(have {_DRAFTERS})")
        self.spec_steps = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_emitted = 0

    # -- drafter synchronisation hooks ----------------------------------

    def _post_admit(self, rows):
        for (i, req, cached, S, block_ids) in rows:
            self.drafter.begin(i, list(cached))

    def _post_clear(self, i: int):
        self.drafter.drop(i)

    # -- scheduling ------------------------------------------------------

    def _imminent_growth(self) -> int:
        """Admission headroom: a verify window can claim up to
        blocks_for(L + K + 1) per active slot this step (the base
        backend's single growth block is the K = 0 case)."""
        bs = self.cfg.block_size
        return sum(
            max(paged_kv.blocks_for(int(self.lengths[i]) + self.k1, bs)
                - len(s.blocks), 0)
            for i, s in enumerate(self.slots) if s.req is not None)

    def _grow_for_verify(self, drafts: dict):
        """Cover each slot's verify window, oldest admission first.

        The plain-decode footprint (blocks_for(L + 1)) keeps the base
        backend's LIFO-preemption guarantee; beyond it, a slot SHRINKS
        its own draft window to what the free pool covers rather than
        evicting other sequences."""
        bs = self.cfg.block_size
        order = sorted(
            (i for i, s in enumerate(self.slots) if s.req is not None),
            key=lambda i: self.slots[i].ticket)
        for i in order:
            slot = self.slots[i]
            if slot.req is None:          # preempted earlier in this pass
                continue
            L = int(self.lengths[i])
            need_min = paged_kv.blocks_for(L + 1, bs) - len(slot.blocks)
            while need_min > 0 and not self.alloc.can_alloc(need_min):
                cands = [(j, self.slots[j].ticket)
                         for j, s in enumerate(self.slots)
                         if s.req is not None]
                victim = self.alloc.select_victim(cands)
                self._preempt(victim)
                if victim == i:
                    break
            if slot.req is None:
                drafts.pop(i, None)
                continue
            while drafts.get(i):
                want = paged_kv.blocks_for(
                    L + len(drafts[i]) + 1, bs) - len(slot.blocks)
                if want <= 0 or self.alloc.can_alloc(want):
                    break
                drafts[i].pop()           # shrink, don't evict
            want = paged_kv.blocks_for(
                L + len(drafts.get(i, ())) + 1, bs) - len(slot.blocks)
            if want > 0:
                new = self.alloc.alloc(want)
                start = len(slot.blocks)
                slot.blocks.extend(new)
                self.table[i, start:start + len(new)] = new

    def _trim_blocks(self, i: int):
        """Return the rejected tail's surplus blocks to the pool and null
        their table entries: the length pointer was already rewound, so
        the blocks hold only invisible garbage."""
        slot = self.slots[i]
        extra = paged_kv.rollback_tail(slot.blocks, int(self.lengths[i]),
                                       self.cfg.block_size)
        if extra:
            self.alloc.free(extra)
            self.table[i, len(slot.blocks):] = paged_kv.NULL_BLOCK
        # the committed length never retreats below the shared-prefix
        # frontier, so a shared block can never be freed here
        assert len(slot.blocks) >= slot.shared, \
            "verify rollback rewound into the shared prefix"

    # -- the speculative step -------------------------------------------

    def step(self) -> list[RequestOutput]:
        """Admissions, drafting, window growth, ONE verify pass, commit."""
        outs: list[RequestOutput] = []
        self.made_progress = False
        self._admit(outs)
        active = [i for i, s in enumerate(self.slots) if s.req is not None]
        if not active:
            return outs
        last = {i: self.slots[i].last_token for i in active}
        hist = {i: list(self.slots[i].req.prompt)
                + list(self.slots[i].req.token_ids) for i in active}
        drafts = {}
        for i, d in self.drafter.propose(active, last, hist).items():
            # clamp the window to the position cap: fed token j caches at
            # position L + j, which must stay < max_len
            cap = max(0, min(self.k,
                             self.cfg.max_len - 1 - int(self.lengths[i])))
            drafts[i] = list(d)[:cap]
        self._grow_for_verify(drafts)
        active = [i for i in active if self.slots[i].req is not None]
        if not active:
            return outs
        # the window starts writing at lengths[i]; a fresh full-prefix
        # hit puts that frontier inside its shared tail block
        self._ensure_cow(active)
        active = [i for i in active if self.slots[i].req is not None]
        if not active:
            return outs
        B = self.cfg.num_slots
        tokens = np.zeros((B, self.k1), np.int32)
        num_drafts = np.zeros((B,), np.int32)
        start_len = {}
        for i in active:
            row = [self.slots[i].last_token] + drafts.get(i, [])
            row += [row[-1]] * (self.k1 - len(row))  # pad: never accepted
            tokens[i] = row
            num_drafts[i] = len(drafts.get(i, ()))
            start_len[i] = int(self.lengths[i])
        tok_t, nd_t = self._dev(tokens), self._dev(num_drafts)
        sm = self.sampler
        if (sm.temps <= 0.0).all():       # all greedy: no draws needed
            def commit_fn(logits):
                return verify_accept_greedy(logits, tok_t, nd_t)
        else:
            samp = sm.device_args(self.device)

            def commit_fn(logits):
                return verify_accept(logits, tok_t, nd_t, *samp)
        t0 = time.monotonic()
        n0 = self._collectives()
        out_toks, commit, self.pools = self.model.decode_verify(
            self.params, self.pools, self._dev(self.table),
            self._dev(self.lengths), tok_t, commit_fn, self.ctx)
        out_toks = out_toks.cpu().numpy()     # waits for the device
        commit = commit.cpu().numpy()
        self.device_s += time.monotonic() - t0
        self.step_collectives += self._collectives() - n0
        self.steps += 1
        self.spec_steps += 1
        self.slot_steps += len(active)
        self.block_token_steps += self.alloc.used_count * self.cfg.block_size
        self.made_progress = True
        for i in active:
            n_emit = int(commit[i])
            req = self.slots[i].req
            nd = int(num_drafts[i])
            self.spec_proposed += nd
            req.num_draft_proposed += nd
            self.spec_accepted += n_emit - 1
            req.num_draft_accepted += n_emit - 1
            # fed tokens 0..commit-1 are validly cached; the pointer
            # rewind IS the rollback of the pool
            self.lengths[i] = start_len[i] + n_emit
            self.live_token_steps += int(self.lengths[i])
            for j in range(n_emit):
                out = self._accept(i, int(out_toks[i, j]))
                outs.append(out)
                self.spec_emitted += 1
                if out.finished:
                    break
            if self.slots[i].req is not None:
                self._trim_blocks(i)
                self.drafter.rewind(i, int(self.lengths[i]),
                                    int(tokens[i, n_emit - 1]))
        return outs

    # -- reporting ------------------------------------------------------

    def reset_telemetry(self):
        """Zero base + speculative counters (warm-up boundary), including
        the per-request draft counters of handles still active or queued,
        which would otherwise leak warm-up proposals into the accept
        rate."""
        super().reset_telemetry()
        self.spec_steps = self.spec_proposed = 0
        self.spec_accepted = self.spec_emitted = 0
        live = [s.req for s in self.slots if s.req is not None]
        for r in live + list(self.waiting):
            r.num_draft_proposed = r.num_draft_accepted = 0

    def stats(self) -> dict:
        """Base paged stats + a ``spec`` section (window telemetry and
        the per-request accepted/proposed counters)."""
        st = super().stats()
        reqs = [s.req for s in self.slots if s.req is not None]
        reqs += list(self.waiting) + list(self.finished)
        st["spec"] = {
            "spec_tokens": self.k,
            "steps": self.spec_steps,
            "proposed": self.spec_proposed,
            "accepted": self.spec_accepted,
            "emitted": self.spec_emitted,
            "accept_rate": self.spec_accepted / max(self.spec_proposed, 1),
            "emitted_per_step": self.spec_emitted / max(self.spec_steps, 1),
            "per_request": {
                r.uid: {"proposed": r.num_draft_proposed,
                        "accepted": r.num_draft_accepted,
                        "preemptions": r.num_preemptions} for r in reqs},
        }
        return st
