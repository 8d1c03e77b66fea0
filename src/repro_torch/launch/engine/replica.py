"""ReplicaSet: data-parallel engine replicas behind ONE admission queue.

Counterpart of ``repro/launch/engine/replica.py`` on one device. EPAC
scales throughput by replicating compute tiles behind one coherent hub;
this is the serving analogue: R full ``Engine`` replicas, each with its
OWN KV block pool and its own captured decode graphs, sharing one
parameter tree on the device and fed from one shared admission queue.
Requests are dispatched strictly FCFS (always the queue head, never
skip-ahead) through a pluggable placement policy:

* ``least_loaded`` (default): the replica with the fewest committed
  cache blocks (used + queued footprint), ties to the lowest index;
* ``round_robin``: rotate over accepting replicas;
* a callable ``(rset, candidates) -> int``.

No request waits unboundedly: the head is dispatched as soon as any
replica has a lane to spare, and within a replica it inherits the
engine's no-livelock guarantee. Preemption stays local to a replica: an
evicted request re-enters its own replica's queue, never the shared one.

The set meters each replica's busy time (host wall inside its step
calls, ``time.monotonic``) and tokens; the finer device-occupancy clock
is the paged backend's own ``device_s``, the union of its dispatch-to-
fetch windows. The multi-device form (each replica on a submesh of a
``data`` axis) is not ported: ``mesh=`` and ``EngineConfig.mesh`` raise.
``step_workers > 1`` opts into thread-parallel stepping; the step loop
holds the GIL for its host bookkeeping, so it pays off only where a
step's device work dominates. It stays off by default.

Token streams equal a single engine's serving the same requests: outputs
are a pure function of (params, prompt, SamplingParams) by the engine's
RNG-stream contract, whichever replica, slot or co-batch serves them.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

from ...models import paged_kv
from ...models.model import Model
from . import api
from .api import (Engine, EngineConfig, RequestHandle, RequestOutput,
                  SamplingParams)

_MULTI_DEVICE = ("replicas on a device mesh are not ported yet (ROADMAP "
                 "queue 1, item 7 'multi-device', sub-item 'replicas on "
                 "submeshes'); pass dp= for replicas on one device")


def least_loaded(rset: "ReplicaSet", candidates: list[int]) -> int:
    """Fewest committed blocks (paged) / occupied lanes (static); ties
    break to the LOWEST replica index so placement is deterministic."""
    return min(candidates, key=lambda r: (rset.load(r), r))


def round_robin(rset: "ReplicaSet", candidates: list[int]) -> int:
    """Rotate over accepting replicas."""
    pick = min(candidates,
               key=lambda r: (r - rset._rr) % len(rset.replicas))
    rset._rr = pick + 1
    return pick


_POLICIES = {"least_loaded": least_loaded, "round_robin": round_robin}


class ReplicaSet:
    """Engine-shaped front-end over R data-parallel engine replicas on
    one device.

    Parameters
    ----------
    model, params
        The target model and its parameter tree, shared by the replicas.
    cfg : EngineConfig, optional
        The PER-REPLICA configuration (slots, pool, spec_tokens, ...).
    dp : int, optional
        Replica count (default 1).
    mesh
        Not ported: anything but None raises NotImplementedError, as
        does ``cfg.mesh``.
    policy : str or callable
        FCFS dispatch placement: ``"least_loaded"`` (default),
        ``"round_robin"``, or a callable ``(rset, candidates) -> int``.
    overrides : sequence of dict or None, optional
        Per-replica ``EngineConfig`` field replacements, one entry per
        replica (None keeps ``cfg``). May not carry ``mesh`` or
        ``eos_id`` (stop semantics must match for outputs to stay
        request-pure). With overrides, requests validate against every
        replica, since any of them may serve a request.
    ctx : RunCtx, optional
        Per-call model context forwarded to every replica.
    step_workers : int, optional
        Thread-pool width for stepping busy replicas concurrently; off
        by default (see the module docstring).
    device : str or torch.device
        The model's device, ``"cuda"`` by default.

    Attributes
    ----------
    replicas : list of Engine
        The R engines (own KV pool and captured decode graphs each).
    queue : deque of RequestHandle
        The ONE shared admission queue; dispatch only pops its head.
    finished : list of RequestHandle
        Handles retired so far, across replicas, in completion order.
    """

    def __init__(self, model: Model, params, cfg: EngineConfig = None,
                 *, dp: Optional[int] = None, mesh=None,
                 policy="least_loaded", ctx=None, step_workers=None,
                 overrides: Optional[Sequence[Optional[dict]]] = None,
                 device="cuda"):
        cfg = cfg or EngineConfig()
        if mesh is not None or cfg.mesh is not None:
            raise NotImplementedError(_MULTI_DEVICE)
        self.dp = 1 if dp is None else dp
        if self.dp < 1:
            raise ValueError("dp must be >= 1")
        if overrides is not None and len(overrides) != self.dp:
            raise ValueError(f"{len(overrides)} overrides for "
                             f"{self.dp} replicas")
        cfgs = [cfg] * self.dp
        if overrides is not None:
            bad = {"mesh", "eos_id"} & set().union(
                *(ov.keys() for ov in overrides if ov))
            if bad:
                raise ValueError(f"per-replica overrides cannot change "
                                 f"{sorted(bad)}")
            cfgs = [dataclasses.replace(cfg, **(ov or {}))
                    for ov in overrides]
        self.replicas = [Engine(model, params, c, ctx=ctx, device=device)
                         for c in cfgs]
        self.cfg = cfg                   # baseline per-replica config
        self._validators = self.replicas if overrides is not None \
            else self.replicas[:1]
        self.policy = _POLICIES.get(policy, policy)
        if not callable(self.policy):
            raise ValueError(f"unknown dispatch policy {policy!r}")
        self.queue: collections.deque[RequestHandle] = collections.deque()
        self.finished: list[RequestHandle] = []
        self.made_progress = False
        self._uid = 0
        self._rr = 0                     # round-robin cursor
        # in-flight handles only, pruned at retirement
        self._by_uid: dict[int, RequestHandle] = {}
        self._enq: dict[int, tuple[int, float]] = {}  # uid -> (step, t)
        workers = 1 if step_workers is None else \
            min(step_workers, os.cpu_count() or 1)
        self._pool = ThreadPoolExecutor(workers) if workers > 1 else None
        self._zero_telemetry()

    def _zero_telemetry(self):
        self.steps = 0
        self.dispatched = [0] * self.dp
        self.busy_s = [0.0] * self.dp     # wall inside each replica's step
        self.tokens_out = [0] * self.dp   # tokens emitted per replica
        self.wait_steps: list[int] = []   # shared-queue wait per request
        self.wait_wall: list[float] = []

    @property
    def total_slots(self) -> int:
        """Decode slots across the whole set."""
        return sum(e.cfg.num_slots for e in self.replicas)

    # -- request lifecycle ----------------------------------------------

    def add_request(self, prompt,
                    sampling: Optional[SamplingParams] = None,
                    encoder_features=None) -> RequestHandle:
        """Validate and append to the shared FCFS queue; returns the live
        handle. ``prompt`` is a token-id sequence or an ``api.Request``."""
        if isinstance(prompt, api.Request):
            if sampling is not None or encoder_features is not None:
                raise ValueError("pass sampling/encoder_features inside "
                                 "the Request, not alongside it")
            sampling = prompt.sampling
            encoder_features = prompt.encoder_features
            prompt = prompt.prompt
        sampling = sampling or SamplingParams()
        prompt = [int(t) for t in prompt]
        for eng in self._validators:
            eng.check_request(prompt, sampling, encoder_features)
        handle = RequestHandle(self._uid, prompt, sampling,
                               encoder_features=encoder_features)
        self._uid += 1
        self._by_uid[handle.uid] = handle
        self._enq[handle.uid] = (self.steps, time.monotonic())
        self.queue.append(handle)
        return handle

    def step(self) -> list[RequestOutput]:
        """Dispatch from the shared queue, then step every busy replica
        and merge their streams in replica order."""
        self.steps += 1
        moved = self._dispatch()
        busy = [(r, eng) for r, eng in enumerate(self.replicas)
                if eng.has_work]
        outs = self._timed_steps(busy)
        self.made_progress = moved > 0 or any(
            eng.made_progress for _, eng in busy)
        self._finish(outs)
        return outs

    def _timed_steps(self, busy) -> list[RequestOutput]:
        """Step the given ``(index, engine)`` pairs (through the thread
        pool when one is configured), metering busy clocks and tokens."""
        def timed_step(pair):
            r, eng = pair
            t0 = time.monotonic()
            part = eng.step()
            self.busy_s[r] += time.monotonic() - t0
            self.tokens_out[r] += sum(len(o.new_tokens) for o in part)
            return part

        if self._pool is not None and len(busy) > 1:
            outs_per = list(self._pool.map(timed_step, busy))
        else:
            outs_per = [timed_step(p) for p in busy]
        return [o for part in outs_per for o in part]

    def _finish(self, outs: list[RequestOutput]):
        """Move retired handles from the in-flight map to ``finished``."""
        for out in outs:
            if out.finished:
                self.finished.append(self._by_uid.pop(out.request_id))

    @property
    def has_work(self) -> bool:
        """True while anything is queued or active on any replica."""
        return bool(self.queue) or any(e.has_work for e in self.replicas)

    def stats(self) -> dict:
        """Set-level telemetry: per-replica stats, dispatch counts, busy
        and device clocks, queue waits, TTFT / TPOT over every handle,
        and the aggregate occupancy and leak views."""
        per = [e.stats() for e in self.replicas]
        paged = [e.backend for e in self.replicas
                 if hasattr(e.backend, "alloc")]
        live = sum(b.live_token_steps for b in paged)
        cap = sum(b.block_token_steps for b in paged)
        lat = api.latency_stats(list(self.finished)
                                + list(self._by_uid.values()))
        return {
            "dp": self.dp,
            "steps": self.steps,
            "per_replica": per,
            "dispatched": list(self.dispatched),
            "busy_s": list(self.busy_s),
            "device_s": [p.get("device_s", 0.0) for p in per],
            "tokens_out": list(self.tokens_out),
            "queue_depth": len(self.queue),
            "queue_wait_steps_mean": (sum(self.wait_steps)
                                      / max(len(self.wait_steps), 1)),
            "queue_wait_steps_max": max(self.wait_steps, default=0),
            "queue_wait_s_mean": (sum(self.wait_wall)
                                  / max(len(self.wait_wall), 1)),
            "ttft": lat["ttft"],
            "latency": lat,
            "mean_active_slots": sum(p["mean_active_slots"] for p in per),
            "cache_utilization": live / max(cap, 1),
            "blocks_used": sum(p.get("blocks_used", 0) for p in per),
            "preemptions": sum(p.get("preemptions", 0) for p in per),
            "prefill_calls": sum(p.get("prefill_calls", 0) for p in per),
            "prefill_reqs": sum(p.get("prefill_reqs", 0) for p in per),
        }

    def reset_telemetry(self):
        """Zero every replica's counters and the set-level telemetry (a
        warm-up boundary); scheduling state is untouched."""
        for eng in self.replicas:
            eng.backend.reset_telemetry()
        self.finished.clear()
        self._zero_telemetry()

    # -- dispatch -------------------------------------------------------

    def load(self, r: int) -> int:
        """Committed-capacity estimate: cache blocks held + the block
        footprint queued at the replica (paged), or occupied + queued
        lanes (static)."""
        be = self.replicas[r].backend
        if hasattr(be, "alloc"):
            # emitted tokens count too: a preempted request waiting to
            # resume re-prefills its whole history
            queued = sum(paged_kv.blocks_for(
                len(h.prompt) + len(h.token_ids) + 1,
                self.replicas[r].cfg.block_size) for h in be.waiting)
            return be.alloc.used_count + queued
        return be.num_active + len(be.waiting)

    def can_accept(self, r: int) -> bool:
        """A replica accepts while it has decode lanes not yet spoken
        for; beyond that, requests wait in the shared queue where the
        policy can still steer them."""
        be = self.replicas[r].backend
        return self.replicas[r].cfg.num_slots \
            - be.num_active - len(be.waiting) > 0

    def _dispatch_candidates(self) -> list[int]:
        """Replica indices dispatch may target (the disaggregated engine
        restricts fresh admissions to its prefill replicas)."""
        return list(range(self.dp))

    def _dispatch(self) -> int:
        moved = 0
        while self.queue:
            cands = [r for r in self._dispatch_candidates()
                     if self.can_accept(r)]
            if not cands:
                break                     # head waits; never skip ahead
            handle = self.queue.popleft()
            r = self.policy(self, cands)
            self.replicas[r].backend.enqueue(handle)
            self.dispatched[r] += 1
            step0, t0 = self._enq.pop(handle.uid)
            self.wait_steps.append(self.steps - 1 - step0)
            self.wait_wall.append(time.monotonic() - t0)
            moved += 1
        return moved

    # -- drive to completion --------------------------------------------

    def drain(self, max_steps: int = 100_000) -> list[RequestOutput]:
        """Step until idle; returns the concatenated output stream."""
        return api.drive(
            self, max_steps,
            "replica set stalled: waiting requests cannot be admitted "
            "on any replica")

    def generate(self, prompts: Sequence[Sequence[int]], sampling=None,
                 max_steps: int = 100_000,
                 encoder_features=None) -> list[list[int]]:
        """Submit ``prompts`` and drive to completion; returns token ids
        per prompt in submission order."""
        return api.run_generate(self, prompts, sampling, max_steps,
                                encoder_features=encoder_features)
