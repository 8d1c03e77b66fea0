"""ReplicaSet: data-parallel engine replicas behind ONE admission queue.

Counterpart of ``repro/launch/engine/replica.py``. EPAC scales
throughput by replicating compute tiles behind one coherent hub; this is
the serving analogue: R full ``Engine`` replicas, each with its OWN KV
block pool and its own captured decode graphs, fed from one shared
admission queue. On one device they share one parameter tree; on a
``(data=R, model=T)`` mesh (``mesh=``) each replica is one engine over
the T ranks of its ``(1, T)`` submesh.
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
fetch windows. ``step_workers > 1`` opts into thread-parallel stepping;
the step loop holds the GIL for its host bookkeeping, so it pays off
only where a step's device work dominates. It stays off by default.

**On a mesh** (``mesh=``, every process one rank, SPMD): each process
builds and steps only its own replica's ``Engine``, on its submesh
(``launch.mesh.submeshes``). Every process holds the same shared queue
(the program serving it submits the same requests on every rank) and
makes the same dispatch decisions, so it has to see every replica's
state: after each step an all-gather over the mesh's world group (the
router's exchange, gloo: host data only) brings every replica's
allocator blocks in use and free, active slots, waiting requests and
their block footprint, has-work flag, cross-arena rows (free, and the
requests holding one), that step's ``RequestOutput``s, when each was
sampled and the step's busy time; dispatch then runs the policy on those
mirrored numbers everywhere (the mirror of a replica that takes a
request grows by its footprint at once), and every process applies the
other replicas' outputs to its handles, stamped as their home replica
took them, and emits the same merged stream, in replica order. A replica's
T ranks must agree on all of it; a rank whose state differs from its
replica's first rank raises. A callable policy must be deterministic, as
``least_loaded`` and ``round_robin`` are. ``step_workers`` has nothing
to do there (one engine a process), and ``stats()`` is a collective
every rank calls. Per-replica ``overrides`` hold there too: requests
validate against every replica's config (``api.check_request``, which
needs no engine), so every process raises on the same requests.

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

import torch

from ...models import paged_kv
from ...models.model import Model
from ..mesh import SHARDED_TRAINING, not_ported, submeshes
from . import api
from .api import (Engine, EngineConfig, RequestHandle, RequestOutput,
                  SamplingParams)


@dataclasses.dataclass
class _Mirror:
    """One replica's scheduling state as dispatch and migration read it:
    the allocator's blocks in use (-1: a static backend) and free (cached
    prefix blocks count, as ``BlockAllocator.free_count`` does), active
    slots, waiting requests and their block footprint, whether it has
    work, and its cross arena's free rows (-1: no arena) and the uids of
    the live requests holding one. On one device read from the engine
    (``_state``); under a mesh refreshed by each exchange, grown at each
    dispatch to it and at each packet landing on it."""
    used: int = 0
    active: int = 0
    waiting: int = 0
    queued_blocks: int = 0
    has_work: bool = False
    free: int = 0
    arena_free: int = -1
    arena_uids: frozenset = frozenset()


def _footprint(h: RequestHandle, block_size: int) -> int:
    """The cache blocks a waiting request will claim. Emitted tokens
    count too: a preempted request waiting to resume re-prefills its
    whole history."""
    return paged_kv.blocks_for(len(h.prompt) + len(h.token_ids) + 1,
                               block_size)


def _state(eng: Engine) -> _Mirror:
    """A local engine's ``_Mirror``, as dispatch reads it and the
    exchange sends it."""
    be = eng.backend
    if not hasattr(be, "alloc"):                   # static
        return _Mirror(-1, be.num_active, len(be.waiting), 0, eng.has_work)
    queued = sum(_footprint(h, eng.cfg.block_size) for h in be.waiting)
    m = _Mirror(be.alloc.used_count, be.num_active, len(be.waiting), queued,
                eng.has_work, be.alloc.free_count)
    if be.arena is not None:
        m.arena_free = be.arena.free_count
        m.arena_uids = frozenset(s.req.uid for i, s in enumerate(be.slots)
                                 if s.req is not None and be.arena_ids[i])
    return m


def least_loaded(rset: "ReplicaSet", candidates: list[int]) -> int:
    """Fewest committed blocks (paged) / occupied lanes (static); ties
    break to the LOWEST replica index so placement is deterministic."""
    return min(candidates, key=lambda r: (rset.load(r), r))


def round_robin(rset: "ReplicaSet", candidates: list[int]) -> int:
    """Rotate over accepting replicas."""
    pick = min(candidates, key=lambda r: (r - rset._rr) % rset.dp)
    rset._rr = pick + 1
    return pick


_POLICIES = {"least_loaded": least_loaded, "round_robin": round_robin}


class ReplicaSet:
    """Engine-shaped front-end over R data-parallel engine replicas on
    one device, or one a submesh of a ``(data, model)`` mesh.

    Parameters
    ----------
    model, params
        The target model and its parameter tree, shared by the replicas.
    cfg : EngineConfig, optional
        The PER-REPLICA configuration (slots, pool, spec_tokens, ...).
    dp : int, optional
        Replica count (default 1; with ``mesh``, its data axis).
    mesh : launch.mesh.Mesh, optional
        This process's rank of a ``(data, model)`` mesh: the replicas
        are its ``submeshes`` (see the module docstring). ``cfg.mesh``
        raises ValueError, with or without it (JAX's message).
    policy : str or callable
        FCFS dispatch placement: ``"least_loaded"`` (default),
        ``"round_robin"``, or a callable ``(rset, candidates) -> int``.
    overrides : sequence of dict or None, optional
        Per-replica ``EngineConfig`` field replacements, one entry per
        replica (None keeps ``cfg``). May not carry ``mesh`` or
        ``eos_id`` (stop semantics must match for outputs to stay
        request-pure). With overrides, requests validate against every
        replica's config, since any of them may serve a request (under a
        mesh too: the check needs no engine).
    ctx : RunCtx, optional
        Per-call model context forwarded to every replica.
    step_workers : int, optional
        Thread-pool width for stepping busy replicas concurrently; off
        by default (see the module docstring).
    device : str or torch.device
        The model's device, ``"cuda"`` by default (with ``mesh``, the
        rank's device).

    Attributes
    ----------
    replicas : list of Engine
        The R engines (own KV pool and captured decode graphs each);
        with ``mesh`` this process's replica's engine at its index and
        None elsewhere (``mirrors`` holds every replica's state).
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
        if cfg.mesh is not None:
            raise ValueError("pass the mesh to ReplicaSet(mesh=...), "
                             "not through EngineConfig")
        if mesh is not None:
            rows = int(mesh.shape["data"])
            meshes = submeshes(mesh, rows if dp is None else dp)
            if len(meshes) != rows:
                raise not_ported(
                    f"a data axis above 1 inside one engine "
                    f"(ReplicaSet(mesh=) with dp={dp} on a data axis of "
                    f"{rows}; dp None gives a replica a row)",
                    SHARDED_TRAINING)
            if mesh.group is None:
                raise ValueError("ReplicaSet(mesh=) takes this rank's "
                                 "mesh (launch.mesh.launch / init_mesh), "
                                 "not one that only describes a shape")
            dp = rows
        self.mesh = mesh
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
        self._cfgs = cfgs
        self.model = model
        self.mirrors = None
        if mesh is None:
            self.home = None
            self.replicas = [Engine(model, params, c, ctx=ctx, device=device)
                             for c in cfgs]
        else:                            # this process's replica alone
            self.home = mesh.coord("data")
            sub = meshes[self.home]
            self.replicas = [None] * self.dp
            self.replicas[self.home] = Engine(
                model, params, dataclasses.replace(cfgs[self.home],
                                                   mesh=sub),
                ctx=ctx, device=sub.device)
            idle = _state(self.replicas[self.home])  # as every replica
            self.mirrors = [dataclasses.replace(
                idle, free=c.num_blocks - 1 if idle.used >= 0 else 0,
                arena_free=c.num_slots if idle.arena_free >= 0 else -1)
                for c in cfgs]
        self.cfg = cfg                   # baseline per-replica config
        self._validators = cfgs if overrides is not None else cfgs[:1]
        # under a mesh: outputs of a replica's next step that a steal's
        # flush already applied here (disagg.py), by replica
        self._preapplied: dict[int, int] = {}
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
        self._pool = ThreadPoolExecutor(workers) \
            if workers > 1 and mesh is None else None
        self._zero_telemetry()

    def _zero_telemetry(self):
        self.steps = 0
        self.dispatched = [0] * self.dp
        self.busy_s = [0.0] * self.dp     # wall inside each replica's step
        self.tokens_out = [0] * self.dp   # tokens emitted per replica
        self.wait_steps: list[int] = []   # shared-queue wait per request
        self.wait_wall: list[float] = []
        self.exchanges = 0                # the router's, under a mesh
        self.exchange_s = 0.0

    @property
    def total_slots(self) -> int:
        """Decode slots across the whole set."""
        return sum(c.num_slots for c in self._cfgs)

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
        for c in self._validators:
            api.check_request(self.model, c, prompt, sampling,
                              encoder_features)
        handle = RequestHandle(self._uid, prompt, sampling,
                               encoder_features=encoder_features)
        self._uid += 1
        self._by_uid[handle.uid] = handle
        self._enq[handle.uid] = (self.steps, time.monotonic())
        self.queue.append(handle)
        return handle

    def step(self) -> list[RequestOutput]:
        """Dispatch from the shared queue, then step every busy replica
        and merge their streams in replica order (under a mesh: this
        process's replica, then the router's exchange)."""
        self.steps += 1
        moved = self._dispatch()
        outs, progress, _ = self._step_replicas(self._busy(range(self.dp)))
        self.made_progress = moved > 0 or progress
        self._finish(outs)
        return outs

    def _busy(self, ids) -> list[int]:
        """The replicas among ``ids`` with work, by their (mirrored)
        state."""
        return [r for r in ids if self._mirror(r).has_work]

    def _step_replicas(self, busy: list[int], after=None):
        """Step the ``busy`` replicas and merge their outputs in replica
        order; ``after(r)``, where given, runs right after replica r's
        step, on the process holding it, and returns host data the
        caller gets back for every replica. Under a mesh this process
        steps its own replica (if busy), then the router's exchange
        brings the others' outputs, state and ``after`` data (none when
        no replica is busy). Returns (outputs, whether any replica made
        progress, {replica: after's data})."""
        if self.mesh is None:
            outs = self._timed_steps([(r, self.replicas[r]) for r in busy])
            extra = {r: after(r) for r in busy} if after else {}
            return outs, any(self.replicas[r].made_progress
                             for r in busy), extra
        if not busy:
            return [], False, {}
        eng = self.replicas[self.home]
        part, progress, dt, extra = [], False, 0.0, None
        if self.home in busy:
            t0 = time.monotonic()
            part = eng.step()
            dt = time.monotonic() - t0
            progress = eng.made_progress
            if after is not None:
                extra = after(self.home)
        got = self._gather((_state(eng), part, progress, extra),
                           (self._sample_offsets(part), dt))
        outs, extras = [], {}
        for r in range(self.dp):
            (state, rpart, rprog, rextra), (offsets, rdt) = got[r]
            self.mirrors[r] = state
            if r in busy:
                self.busy_s[r] += rdt
                self.tokens_out[r] += sum(len(o.new_tokens) for o in rpart)
                extras[r] = rextra
            # a steal's flush applied the first outputs here already
            done = self._preapplied.pop(r, 0) if r in busy else 0
            if r != self.home:
                for o, off in list(zip(rpart, offsets))[done:]:
                    self._apply(o, off)
            progress = progress or rprog
            outs.extend(rpart)
        return outs, progress, extras

    def _gather(self, agreed, host) -> list:
        """The router's exchange, counted and timed: ``(agreed, host)``
        all-gathered over the mesh's world group; returns each replica's
        pair as its first rank sent it. ``agreed`` is what a replica's T
        ranks must send alike (a rank that disagrees raises); ``host``
        may differ (clocks)."""
        t0 = time.monotonic()
        got = [None] * self.mesh.size
        torch.distributed.all_gather_object(
            got, (self.home, self.mesh.coord("model"), agreed, host),
            group=self.mesh.group)
        self.exchanges += 1
        self.exchange_s += time.monotonic() - t0
        out = []
        for r in range(self.dp):
            entries = [g for g in got if g[0] == r]
            first = min(entries, key=lambda g: g[1])
            for g in entries:
                if g[2] != first[2]:
                    raise RuntimeError(
                        f"replica {r}: rank {g[1]} on the model axis "
                        f"disagrees with rank {first[1]} ({g[2]} vs "
                        f"{first[2]})")
            out.append(first[2:])
        return out

    def _sample_offsets(self, part: list[RequestOutput]) -> list[float]:
        """When each output of this process's replica was sampled, as an
        offset from its request's submission here: the home replica's
        clock, which the other processes add to their own submissions
        (one output a sample, its stamp the last of a step's)."""
        left = collections.Counter(o.request_id for o in part)
        out = []
        for o in part:
            h = self._by_uid[o.request_id]
            out.append(h.t_tokens[-left[o.request_id]] - h.t_submit)
            left[o.request_id] -= 1
        return out

    def _apply(self, out: RequestOutput, offset: float):
        """Register another replica's output on this process's handle of
        the request, as ``api.register_sample`` does on its own: one
        sample an output (a stripped stop token carries no token),
        stamped ``offset`` after the request's submission, as its home
        replica took it."""
        h = self._by_uid[out.request_id]
        api.stamp_sample(h, h.t_submit + offset)
        h.token_ids.extend(out.new_tokens)
        if out.finished:
            h.finished = True
            h.finish_reason = out.finish_reason

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
        return bool(self.queue) or any(self._mirror(r).has_work
                                       for r in range(self.dp))

    def stats(self) -> dict:
        """Set-level telemetry: per-replica stats, dispatch counts, busy
        and device clocks, queue waits, TTFT / TPOT over every handle,
        and the aggregate occupancy and leak views. Under a mesh a
        collective (every rank calls it): each replica's engine stats as
        its first rank reports them, the latencies of world rank 0's
        handles (each sample stamped as its home replica took it, less
        the request's submission), so every rank returns the same dict,
        with the router's ``exchanges`` and their host ``exchange_ms``."""
        lat = api.latency_stats(list(self.finished)
                                + list(self._by_uid.values()))
        wait_s = sum(self.wait_wall) / max(len(self.wait_wall), 1)
        exchange_s = self.exchange_s
        if self.mesh is None:
            per = [e.stats() for e in self.replicas]
            occ = [(e.backend.live_token_steps, e.backend.block_token_steps)
                   for e in self.replicas if hasattr(e.backend, "alloc")]
        else:
            eng = self.replicas[self.home]
            be = eng.backend
            mine = (eng.stats(), (be.live_token_steps, be.block_token_steps)
                    if hasattr(be, "alloc") else None)
            got = [None] * self.mesh.size
            torch.distributed.all_gather_object(
                got, (self.home, self.mesh.coord("model"), mine, lat,
                      wait_s, exchange_s), group=self.mesh.group)
            first = {}
            for g in got:
                if g[0] not in first or g[1] < first[g[0]][1]:
                    first[g[0]] = g
            per = [first[r][2][0] for r in range(self.dp)]
            occ = [first[r][2][1] for r in range(self.dp)
                   if first[r][2][1] is not None]
            lat, wait_s, exchange_s = got[0][3:6]
        live = sum(o[0] for o in occ)
        cap = sum(o[1] for o in occ)
        out = {
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
            "queue_wait_s_mean": wait_s,
            "ttft": lat["ttft"],
            "latency": lat,
            "mean_active_slots": sum(p["mean_active_slots"] for p in per),
            "cache_utilization": live / max(cap, 1),
            "blocks_used": sum(p.get("blocks_used", 0) for p in per),
            "preemptions": sum(p.get("preemptions", 0) for p in per),
            "prefill_calls": sum(p.get("prefill_calls", 0) for p in per),
            "prefill_reqs": sum(p.get("prefill_reqs", 0) for p in per),
        }
        if self.mesh is not None:
            out["router"] = {"exchanges": self.exchanges,
                             "exchange_ms": exchange_s * 1e3}
        return out

    def reset_telemetry(self):
        """Zero every replica's counters and the set-level telemetry (a
        warm-up boundary); scheduling state is untouched."""
        for eng in self.replicas:
            if eng is not None:
                eng.backend.reset_telemetry()
        self.finished.clear()
        self._zero_telemetry()

    # -- dispatch -------------------------------------------------------

    def _mirror(self, r: int) -> _Mirror:
        """Replica ``r``'s scheduling state: under a mesh its mirror,
        else read from its engine."""
        if self.mirrors is not None:
            return self.mirrors[r]
        return _state(self.replicas[r])

    def load(self, r: int) -> int:
        """Committed-capacity estimate: cache blocks held + the block
        footprint queued at the replica (paged), or occupied + queued
        lanes (static)."""
        m = self._mirror(r)
        return m.used + m.queued_blocks if m.used >= 0 \
            else m.active + m.waiting

    def can_accept(self, r: int) -> bool:
        """A replica accepts while it has decode lanes not yet spoken
        for; beyond that, requests wait in the shared queue where the
        policy can still steer them."""
        m = self._mirror(r)
        return self._cfgs[r].num_slots - m.active - m.waiting > 0

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
            if self.mirrors is not None:
                m = self.mirrors[r]
                m.waiting += 1
                m.queued_blocks += _footprint(handle,
                                              self._cfgs[r].block_size)
                m.has_work = True
            if self.replicas[r] is not None:
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
