"""DisaggregatedEngine: prefill/decode role-specialized replicas.

Counterpart of ``repro/launch/engine/disagg.py`` on one device. EPAC
splits its workload by kind over heterogeneous tiles behind one coherent
fabric; serving has the same split inside every request: prefill is
compute-bound batch work, decode latency-bound incremental work, and a
symmetric replica set makes every replica do both, so a long prompt's
prefill stalls the decode steps of everything co-resident. This module
dedicates replicas to one role each and hands finished prefill caches
across as block migrations (``transport.py``).

Role lifecycle of one request::

    shared queue --dispatch--> prefill replica: admit + prefill + token 0
                 --export--> MigrationPacket (gathered blocks, RNG position)
                 --import--> decode replica: scatter, decode to retirement

Straggler handling runs the same path backwards: when no packet is in
flight, an idle decode replica *steals*: the busiest decode replica is
flushed, then re-exports its newest-ticket slot mid-decode (migration is
position-agnostic), and keeps its oldest admission, so the engine's
no-livelock guarantee survives stealing.

Invariants: outputs equal a single ``Engine``'s and a symmetric
``ReplicaSet``'s (the sampler stream position travels in the packet);
dispatch pops only the shared-queue head and imports land only the head
packet; no block leaks in any pool (export frees the source chain
eagerly, import allocates under the scheduler's admission accounting).

On one device a migration is a gather and a scatter in device memory.
**On a** ``(data=R, model=T)`` **mesh** (``mesh=``; every process one
rank, as under ``ReplicaSet(mesh=)``) each process builds and steps only
its own replica's engine, on its ``(1, T)`` submesh, and the step keeps
the single-device order. Every decision is taken on every process from
mirrored state (``replica._Mirror``), so all ranks agree:

* the prefill replicas' step ends in the router's exchange, which
  carries their outputs, their post-export state and the headers of
  the packets they exported (``transport.header``); every process then
  appends the same packets in (replica, slot) order, while each payload
  stays on the source replica's T ranks, a shard each;
* imports read the decode replicas' mirrors (free blocks against the
  watermark, lanes, arena rows, residency by request uid); a landing
  grows the destination's mirror as its allocation does, and moves the
  payload rank t to rank t over the mesh's payload group
  (``transport.send_payload`` / ``recv_payload``), where the destination
  scatters it in place;
* a steal runs one more exchange: the donor the single-device rule picks
  (alone) flushes its in-flight overlapped token, picks its newest-ticket
  slot and, when the thief's mirror can take it, exports it; every
  process applies the flushed outputs at once (the donor's next step
  re-emits them without a second application), refreshes the donor's
  mirror and lands the packet;
* the decode replicas' step ends in another exchange.

``stats()`` is a collective there, the same dict on every rank; its
``disagg`` section counts ``bytes_moved`` as the logical packets (every
head once, JAX's count) and ``rank_bytes_moved`` as what one rank sent.

``fabric=None`` (the default) prices nothing: ``fabric_s`` stays 0.0 and
``stats()["disagg"]["fabric_priced"]`` is False. A
``core.noc.FabricSpec`` the caller passes prices each packet with
``noc.p2p_time`` over the replica-index distance on ``"data"``, as JAX
does.
"""

from __future__ import annotations

import collections
from typing import Optional

from ...core import noc
from ...models import paged_kv
from ...models.model import Model
from . import transport
from .api import EngineConfig
from .replica import ReplicaSet, _state

ROLES = ("prefill", "decode")


class DisaggregatedEngine(ReplicaSet):
    """Engine-shaped front-end over role-specialized engine replicas.

    Same surface as ``ReplicaSet``, but each replica has one role:
    prefill replicas run admission and prefill only (their backends are
    ``prefill_only`` and never decode, grow, preempt or COW) and export
    every occupied slot as a ``MigrationPacket``; decode replicas import
    packets ahead of fresh work and run them to retirement.

    Parameters
    ----------
    model, params
        The target model and its parameter tree, shared by the replicas.
    cfg : EngineConfig, optional
        The baseline PER-REPLICA configuration; must select the paged
        backend.
    roles : tuple of str or "auto"
        One role per replica, e.g. ``("prefill", "decode", "decode")``,
        at least one of each; ``"auto"`` splits ``dp`` replicas by
        ``prefill_fraction``.
    prefill_fraction : float, optional
        ``roles="auto"``: ``round(dp * prefill_fraction)`` prefill
        replicas, clamped to [1, dp - 1]. Default 0.5.
    role_overrides : dict, optional
        ``EngineConfig`` field replacements per role name, e.g.
        ``{"decode": {"spec_tokens": 4}}``. Prefill replicas are always
        forced to ``spec_tokens=0`` (they never decode). The migration
        geometry (``block_size``, ``max_len``) and ``backend`` may not
        differ per role.
    max_inflight : int, optional
        Packet backpressure: fresh dispatch to prefill replicas pauses
        while this many packets are exported but unclaimed (default 2x
        the decode side's slots).
    fabric : core.noc.FabricSpec, optional
        Prices each packet with ``noc.p2p_time``; None prices nothing.
    dp, mesh, policy, ctx, step_workers, device
        As for ``ReplicaSet`` (``dp`` None reads the mesh's data axis;
        ``cfg.mesh`` raises ValueError); the policy picks among one
        role's candidates (prefill for dispatch, decode for imports).

    Attributes
    ----------
    roles : tuple of str
        The resolved per-replica roles.
    prefill_ids, decode_ids : list of int
        Replica indices per role.
    packets : deque of MigrationPacket
        Exported-but-unclaimed packets, oldest first.
    """

    def __init__(self, model: Model, params, cfg: EngineConfig = None,
                 *, roles="auto", prefill_fraction: float = 0.5,
                 role_overrides: Optional[dict] = None,
                 max_inflight: Optional[int] = None, fabric=None,
                 dp: Optional[int] = None, mesh=None,
                 policy="least_loaded", ctx=None, step_workers=None,
                 device="cuda"):
        cfg = cfg or EngineConfig()
        if cfg.backend != "paged":
            raise ValueError("disaggregation requires the paged backend "
                             "(block migration has no static analogue)")
        n = int(mesh.shape["data"]) if mesh is not None and dp is None \
            else (dp or 1)
        self.roles = self._resolve_roles(roles, n, prefill_fraction)
        role_overrides = role_overrides or {}
        if not set(role_overrides) <= set(ROLES):
            raise ValueError(f"unknown role in overrides "
                             f"{sorted(role_overrides)} (have {ROLES})")
        frozen = {"block_size", "max_len", "backend"}
        for role, ov in role_overrides.items():
            if frozen & set(ov):
                raise ValueError(
                    f"{sorted(frozen & set(ov))} cannot differ per role "
                    "(shared migration geometry)")
        overrides = []
        for role in self.roles:
            ov = dict(role_overrides.get(role, {}))
            if role == "prefill":
                ov["spec_tokens"] = 0     # never decodes; drafts are waste
            overrides.append(ov)
        super().__init__(model, params, cfg, dp=len(self.roles),
                         mesh=mesh, policy=policy, ctx=ctx,
                         step_workers=step_workers, overrides=overrides,
                         device=device)
        self.prefill_ids = [r for r, ro in enumerate(self.roles)
                            if ro == "prefill"]
        self.decode_ids = [r for r, ro in enumerate(self.roles)
                           if ro == "decode"]
        for r in self.prefill_ids:
            if self.replicas[r] is not None:
                self.replicas[r].backend.prefill_only = True
        self.packets: collections.deque = collections.deque()
        self._here: dict = {}        # uid -> packet exported on this process
        dec_slots = sum(self._cfgs[r].num_slots for r in self.decode_ids)
        self.max_inflight = 2 * dec_slots if max_inflight is None \
            else max_inflight
        self.fabric = fabric
        self._zero_migration()

    def _zero_migration(self):
        self.exported = 0
        self.imported = 0
        self.stolen = 0
        self.bytes_moved = 0
        self.rank_bytes_moved = 0
        self.fabric_s = 0.0

    @staticmethod
    def _resolve_roles(roles, dp: int, prefill_fraction: float):
        if roles == "auto":
            if dp < 2:
                raise ValueError("disaggregation needs dp >= 2 "
                                 "(one replica per role minimum)")
            n_pre = max(1, min(dp - 1, round(dp * prefill_fraction)))
            roles = ("prefill",) * n_pre + ("decode",) * (dp - n_pre)
        roles = tuple(roles)
        if not set(roles) <= set(ROLES):
            raise ValueError(f"unknown role in {roles} (have {ROLES})")
        if "prefill" not in roles or "decode" not in roles:
            raise ValueError(f"need at least one replica per role, "
                             f"got {roles}")
        return roles

    # -- step loop -------------------------------------------------------

    def step(self):
        """One engine step: dispatch fresh work to prefill replicas
        (backpressure permitting), step them, export every occupied
        prefill slot, land packets FCFS on decode replicas, steal for
        idle ones, then step the decode side."""
        self.steps += 1
        moved = self._dispatch()
        outs, pre_progress, heads = self._step_replicas(
            self._busy(self.prefill_ids), self._export_ready)
        exported = self._queue_packets(heads)
        imported = self._import_packets()
        stolen = self._steal()
        part, dec_progress, _ = self._step_replicas(
            self._busy(self.decode_ids))
        outs += part
        self.made_progress = bool(moved or exported or imported or stolen
                                  or pre_progress or dec_progress)
        self._finish(outs)
        return outs

    @property
    def has_work(self) -> bool:
        """True while anything is queued, in flight, or active."""
        return bool(self.packets) or super().has_work

    def _dispatch_candidates(self) -> list[int]:
        """Fresh admissions go to prefill replicas only, paused under
        packet backpressure."""
        if len(self.packets) >= self.max_inflight:
            return []
        return list(self.prefill_ids)

    # -- migration -------------------------------------------------------

    def _export_ready(self, r: int) -> list:
        """Export every occupied slot of prefill replica ``r`` (admitted
        this step, its token 0 sampled unless it was a full-prefix hit),
        freeing its source blocks at once; the packets wait here and
        their headers go back to the step (``_queue_packets``)."""
        be = self.replicas[r].backend
        heads = []
        for i, slot in enumerate(be.slots):
            if slot.req is not None:
                heads.append(self._keep(transport.extract_slot(be, i,
                                                               src=r)))
        return heads

    def _keep(self, pkt) -> tuple:
        """Hold a packet exported on this process until it lands; return
        its header."""
        self._here[pkt.req.uid] = pkt
        return transport.header(pkt)

    def _packet(self, head: tuple):
        """The packet of ``head``: this process's export, or one around
        this process's handle whose payload is on the source's ranks."""
        pkt = self._here.pop(head[0], None)
        return pkt if pkt is not None else \
            transport.from_header(head, self._by_uid[head[0]])

    def _queue_packets(self, heads: dict) -> int:
        """Append the exported packets in (replica, slot) order."""
        n = 0
        for r in self.prefill_ids:
            for head in heads.get(r) or ():
                self.packets.append(self._packet(head))
                n += 1
        self.exported += n
        return n

    def _resident(self, r: int, req) -> bool:
        """Whether ``req``'s encoder features hold an arena row on
        replica ``r`` (a live request there shares the same array)."""
        return any(self._by_uid[u].encoder_features is req.encoder_features
                   for u in self._mirror(r).arena_uids)

    def _can_import(self, r: int, pkt) -> bool:
        m = self._mirror(r)
        return transport.can_import(
            m, self._cfgs[r], pkt,
            m.arena_free >= 0 and self._resident(r, pkt.req))

    def _import_packets(self) -> int:
        """Land packets on decode replicas, oldest first, head-blocking:
        a head no decode replica can take yet parks the deque (never
        overtaken; an idle decode replica can always take it)."""
        n = 0
        while self.packets:
            pkt = self.packets[0]
            cands = [r for r in self.decode_ids if self._can_import(r, pkt)]
            if not cands:
                break
            self.packets.popleft()
            self._land(pkt, self.policy(self, cands))
            n += 1
        return n

    def _land(self, pkt, r: int):
        """Insert a packet into replica ``r`` and account it: logical and
        per-rank bytes and, with a fabric, ``noc.p2p_time`` over the
        replica distance. Under a mesh the source's ranks send their
        shards to ``r``'s ranks and every process grows ``r``'s mirror
        as the allocation does (checked on ``r``'s ranks)."""
        if self.mesh is None:
            transport.insert_packet(self.replicas[r].backend, pkt)
        else:
            # refused on every process before any rank sends a byte
            fmt = pkt.kv_format.kv_dtype if pkt.kv_format else "bf16"
            if fmt != self._cfgs[r].kv_dtype:
                raise ValueError(
                    f"KV-format mismatch on migration (a {fmt} packet "
                    f"for replica {r}'s {self._cfgs[r].kv_dtype} pool): "
                    "source and destination replicas must share one "
                    "EngineConfig.kv_dtype")
            tp = int(self.mesh.shape["model"])
            t = self.mesh.coord("model")
            if self.home == pkt.src:
                transport.send_payload(pkt, r * tp + t, self.mesh)
            elif self.home == r:
                be = self.replicas[r].backend
                transport.recv_payload(be, pkt, pkt.src * tp + t,
                                       self.mesh)
                transport.insert_packet(be, pkt)
                pkt.state = None
            self._grow(r, pkt)
        self.imported += 1
        self.bytes_moved += pkt.payload_bytes
        self.rank_bytes_moved += pkt.rank_bytes
        if self.fabric is not None:
            self.fabric_s += noc.p2p_time(pkt.payload_bytes,
                                          abs(pkt.src - r), "data",
                                          self.fabric)

    def _grow(self, r: int, pkt):
        """Replica ``r``'s mirror after landing ``pkt``: a lane, the
        chain's blocks, an arena row unless the features are resident."""
        m = self.mirrors[r]
        resident = m.arena_free >= 0 and self._resident(r, pkt.req)
        m.active += 1
        m.used += pkt.n_blocks
        m.free -= pkt.n_blocks
        m.has_work = True
        if m.arena_free >= 0:
            m.arena_free -= 0 if resident else 1
            m.arena_uids = m.arena_uids | {pkt.req.uid}
        if self.home == r:
            got = _state(self.replicas[r])
            if got != m:
                raise RuntimeError(f"replica {r}'s mirror {m} differs from "
                                   f"its state {got} after a landing")

    def _steal(self) -> int:
        """With no packet in flight, an idle decode replica takes the
        newest-ticket slot of the busiest one (which keeps its oldest
        admission), through the ordinary migration path."""
        if self.packets:
            return 0
        n = 0
        for thief in self.decode_ids:
            if self._mirror(thief).has_work:
                continue
            donors = [r for r in self.decode_ids
                      if r != thief and self._mirror(r).active >= 2
                      and not self._mirror(r).waiting]
            if not donors:
                continue
            donor = max(donors, key=lambda r: self._mirror(r).active)
            head = self._donate(donor, thief)
            if head is None:
                continue
            self._land(self._packet(head), thief)
            self.stolen += 1
            n += 1
        return n

    def _donate(self, donor: int, thief: int):
        """The donor's side of a steal, known on every process: flush its
        in-flight token BEFORE choosing a slot (the harvest can retire a
        request), pick its newest-ticket live slot and export it when
        the idle thief can land it. Returns the packet's header, or None.
        Under a mesh the donor's ranks do this and the router's exchange
        brings the others their flushed outputs, applied here at once,
        and the donor's new state."""
        if self.mesh is None:
            self.replicas[donor].backend.flush_overlap()
            return self._pick(donor, thief)
        mine, host = None, None
        if self.home == donor:
            eng = self.replicas[donor]
            n0 = len(eng.backend._flushed)
            eng.backend.flush_overlap()
            flushed = eng.backend._flushed[n0:]
            head = self._pick(donor, thief)
            mine = (flushed, _state(eng), head)
            host = self._sample_offsets(flushed)
        (flushed, state, head), offsets = self._gather(mine, host)[donor]
        self.mirrors[donor] = state
        if self.home != donor:
            for o, off in zip(flushed, offsets):
                self._apply(o, off)
        self._preapplied[donor] = self._preapplied.get(donor, 0) \
            + len(flushed)
        return head

    def _pick(self, donor: int, thief: int):
        """On the donor's process: export its newest-ticket slot when it
        keeps another and the thief's free blocks take the chain plus a
        growth block (the thief is idle: no watermark)."""
        dbe = self.replicas[donor].backend
        live = [j for j, s in enumerate(dbe.slots) if s.req is not None]
        if len(live) < 2:
            return None                   # the flush retired it below the bar
        i = max(live, key=lambda j: dbe.slots[j].ticket)
        need = paged_kv.blocks_for(int(dbe.lengths[i]) + 1,
                                   self._cfgs[thief].block_size)
        if need > self._mirror(thief).free:
            return None
        return self._keep(transport.extract_slot(dbe, i, src=donor))

    # -- reporting -------------------------------------------------------

    def stats(self) -> dict:
        """ReplicaSet telemetry plus a ``"disagg"`` section: roles,
        packets exported / imported / stolen / in flight, bytes moved
        (logical, and one rank's), and ``fabric_s`` (0.0 unless a fabric
        prices the packets). Under a mesh a collective, like
        ``ReplicaSet.stats``."""
        st = super().stats()
        st["disagg"] = {
            "roles": list(self.roles),
            "packets_inflight": len(self.packets),
            "exported": self.exported,
            "imported": self.imported,
            "stolen": self.stolen,
            "bytes_moved": self.bytes_moved,
            "rank_bytes_moved": self.rank_bytes_moved,
            "fabric_priced": self.fabric is not None,
            "fabric_s": self.fabric_s,
            "bytes_per_packet": self.bytes_moved / max(self.imported, 1),
        }
        return st

    def reset_telemetry(self):
        """Zero replica and set counters and the migration telemetry;
        in-flight packets are untouched."""
        super().reset_telemetry()
        self._zero_migration()
