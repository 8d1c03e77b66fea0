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

The replicas share one device, so a migration is a gather and a scatter
in device memory. Replicas on submeshes of a mesh (``mesh=``, or
``cfg.mesh``) raise NotImplementedError: moving a packet between
submeshes is ROADMAP's "migration across submeshes". ``fabric=None`` (the default) prices nothing:
``fabric_s`` stays 0.0 and ``stats()["disagg"]["fabric_priced"]`` is
False. A ``core.noc.FabricSpec`` the caller passes prices each packet
with ``noc.p2p_time`` over the replica-index distance, as JAX does.
"""

from __future__ import annotations

import collections
from typing import Optional

from ...core import noc
from ...models import paged_kv
from ...models.model import Model
from ..mesh import MIGRATION, not_ported
from . import transport
from .api import EngineConfig
from .replica import ReplicaSet

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
    dp, policy, ctx, step_workers, device
        As for ``ReplicaSet``; the policy picks among one role's
        candidates (prefill for dispatch, decode for imports).
    mesh
        Not ported (see the module docstring): anything but None, or a
        ``cfg.mesh``, raises NotImplementedError.

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
        if mesh is not None or cfg.mesh is not None:
            raise not_ported("DisaggregatedEngine on a mesh (KV packets "
                             "between submeshes)", MIGRATION)
        if cfg.backend != "paged":
            raise ValueError("disaggregation requires the paged backend "
                             "(block migration has no static analogue)")
        self.roles = self._resolve_roles(roles, dp or 1, prefill_fraction)
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
            self.replicas[r].backend.prefill_only = True
        self.packets: collections.deque = collections.deque()
        dec_slots = sum(self.replicas[r].cfg.num_slots
                        for r in self.decode_ids)
        self.max_inflight = 2 * dec_slots if max_inflight is None \
            else max_inflight
        self.fabric = fabric
        self._zero_migration()

    def _zero_migration(self):
        self.exported = 0
        self.imported = 0
        self.stolen = 0
        self.bytes_moved = 0
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
        busy_pre = [(r, self.replicas[r]) for r in self.prefill_ids
                    if self.replicas[r].has_work]
        outs = self._timed_steps(busy_pre)
        exported = self._export_ready()
        imported = self._import_packets()
        stolen = self._steal()
        busy_dec = [(r, self.replicas[r]) for r in self.decode_ids
                    if self.replicas[r].has_work]
        outs += self._timed_steps(busy_dec)
        self.made_progress = bool(
            moved or exported or imported or stolen
            or any(eng.made_progress for _, eng in busy_pre + busy_dec))
        self._finish(outs)
        return outs

    @property
    def has_work(self) -> bool:
        """True while anything is queued, in flight, or active."""
        return bool(self.queue) or bool(self.packets) \
            or any(e.has_work for e in self.replicas)

    def _dispatch_candidates(self) -> list[int]:
        """Fresh admissions go to prefill replicas only, paused under
        packet backpressure."""
        if len(self.packets) >= self.max_inflight:
            return []
        return list(self.prefill_ids)

    # -- migration -------------------------------------------------------

    def _export_ready(self) -> int:
        """Export every occupied prefill slot (admitted this step, its
        token 0 sampled unless it was a full-prefix hit), freeing its
        source blocks at once."""
        n = 0
        for r in self.prefill_ids:
            be = self.replicas[r].backend
            for i, slot in enumerate(be.slots):
                if slot.req is not None:
                    self.packets.append(
                        transport.extract_slot(be, i, src=r))
                    n += 1
        self.exported += n
        return n

    def _import_packets(self) -> int:
        """Land packets on decode replicas, oldest first, head-blocking:
        a head no decode replica can take yet parks the deque (never
        overtaken; an idle decode replica can always take it)."""
        n = 0
        while self.packets:
            pkt = self.packets[0]
            cands = [r for r in self.decode_ids if transport.can_import(
                self.replicas[r].backend, pkt)]
            if not cands:
                break
            self.packets.popleft()
            self._land(pkt, self.policy(self, cands))
            n += 1
        return n

    def _land(self, pkt, r: int):
        """Insert a packet into replica ``r`` and account it: bytes moved
        and, with a fabric, ``noc.p2p_time`` over the replica distance."""
        transport.insert_packet(self.replicas[r].backend, pkt)
        self.imported += 1
        self.bytes_moved += pkt.payload_bytes
        if self.fabric is not None:
            self.fabric_s += noc.p2p_time(pkt.payload_bytes,
                                          abs(pkt.src - r), "data",
                                          self.fabric)

    def _steal(self) -> int:
        """With no packet in flight, an idle decode replica takes the
        newest-ticket slot of the busiest one (which keeps its oldest
        admission), through the ordinary migration path."""
        if self.packets:
            return 0
        n = 0
        for thief in self.decode_ids:
            tbe = self.replicas[thief].backend
            if tbe.has_work:
                continue
            donors = [r for r in self.decode_ids
                      if r != thief
                      and self.replicas[r].backend.num_active >= 2
                      and not self.replicas[r].backend.waiting]
            if not donors:
                continue
            donor = max(donors,
                        key=lambda r: self.replicas[r].backend.num_active)
            dbe = self.replicas[donor].backend
            # flush the donor's in-flight token BEFORE choosing a slot:
            # the harvest can retire a request
            dbe.flush_overlap()
            live = [j for j, s in enumerate(dbe.slots) if s.req is not None]
            if len(live) < 2:
                continue                  # the flush retired it below the bar
            i = max(live, key=lambda j: dbe.slots[j].ticket)
            # uproot the slot only when the idle thief can land it
            need = paged_kv.blocks_for(int(dbe.lengths[i]) + 1,
                                       tbe.cfg.block_size)
            if not tbe.alloc.can_admit(need, strict=False):
                continue
            self._land(transport.extract_slot(dbe, i, src=donor), thief)
            self.stolen += 1
            n += 1
        return n

    # -- reporting -------------------------------------------------------

    def stats(self) -> dict:
        """ReplicaSet telemetry plus a ``"disagg"`` section: roles,
        packets exported / imported / stolen / in flight, bytes moved,
        and ``fabric_s`` (0.0 unless a fabric prices the packets)."""
        st = super().stats()
        st["disagg"] = {
            "roles": list(self.roles),
            "packets_inflight": len(self.packets),
            "exported": self.exported,
            "imported": self.imported,
            "stolen": self.stolen,
            "bytes_moved": self.bytes_moved,
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
