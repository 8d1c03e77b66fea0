"""KV-cache migration between replica pools (the prefill/decode handoff).

Counterpart of ``repro/launch/engine/transport.py``. One request's paged
state moves in three steps: **gather** the slot's block chain and
per-slot state out of the source replica's pools
(``paged_kv.extract_blocks``), **install** the host-side view in the
destination (``PagedBackend.import_slot``: refcounts, block table,
sampler stream position, prefix-index registration, arena row), and
**scatter** the content into freshly allocated destination blocks
(``paged_kv.insert_blocks``).

Where the JAX design leans on functional arrays, the port's pools are
written in place, which changes two things:

* **The gather copies.** ``extract_slot`` gathers into storage of its
  own (``index_select`` / ``clone``) before ``detach_slot`` frees the
  chain, so a later admission on the source replica that rewrites those
  physical blocks cannot reach into the packet. Freeing eagerly keeps
  migration leak-free: a packet dropped mid-flight holds no block in any
  pool.
* **The scatter writes in place.** ``insert_packet`` copies into the
  destination's existing pool tensors and never rebinds
  ``backend.pools``: the destination's decode step is a captured CUDA
  graph over those storages, and a replay whose pools moved raises.

Both run on the current stream, as everything in the engine does: the
gather is ordered after the replay that wrote the slot's last row, and
before any later prefill that reuses the freed blocks. There is no
retrace cost in torch, so only the real chain moves (JAX pads it to a
fixed width with the null block); ``payload_bytes`` counts what JAX's
does: the real blocks of every pool leaf plus whole slot and cross rows.

Migration is position-agnostic: the packet carries the cached length,
the next token to feed and the handle (whose ``_n_sampled`` is the RNG
stream position), so the first-token handoff, the full-hit rewind and a
mid-decode re-export for work stealing take the same path, and outputs
stay bit-identical by the engine's RNG-stream contract.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ...models import paged_kv
from .api import RequestHandle


@dataclasses.dataclass
class MigrationPacket:
    """One request's cache in flight between replica pools.

    Attributes
    ----------
    req : RequestHandle
        The live handle: prompt, emitted tokens, SamplingParams and the
        RNG stream position (``_n_sampled``) travel with it.
    length : int
        Cached tokens at export.
    last_token : int
        The next token the destination's decode feeds.
    n_blocks : int
        Blocks in the chain.
    state : dict
        The gathered tree: block-pool leaves ``(L, n_blocks, ...)`` and
        per-slot / cross leaves ``(L, 1, ...)``, the pools' structure, on
        the source's device, in storage of its own.
    payload_bytes : int
        Bytes of ``state``.
    src : int
        Exporting replica index.
    kv_format : PoolSpec or None
        The source pool's ``paged_kv.PoolSpec`` (None: the model dtype).
        Scale leaves travel in ``state`` like any pool leaf, so the
        stored payload moves bit for bit; ``insert_packet`` refuses a
        format mismatch.
    """

    req: RequestHandle
    length: int
    last_token: int
    n_blocks: int
    state: Any
    payload_bytes: int
    src: int
    kv_format: Any = None


def _pool_mask(backend):
    """The backend's kind-string tree ("pool" | "slot" | "cross"),
    built once."""
    mask = getattr(backend, "_migration_mask", None)
    if mask is None:
        mask = backend.model.paged_pool_mask(backend.layout,
                                             spec=backend.kv_spec)
        backend._migration_mask = mask
    return mask


def _ids(backend, blocks) -> torch.Tensor:
    """A block chain as an index tensor on the backend's device: on the
    card copied from pinned memory without blocking the host, so the
    host does not wait for the stream to drain at every migration."""
    ids = torch.tensor(blocks, dtype=torch.long)
    if backend.device.type == "cuda":
        ids = ids.pin_memory()
    return ids.to(backend.device, non_blocking=True)


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def extract_slot(backend, i: int, *, src: int = 0) -> MigrationPacket:
    """Export occupied slot ``i`` as a MigrationPacket and release it:
    gather the chain and the slot's state into fresh storage, then
    ``detach_slot`` frees the chain, so the packet holds no source
    block."""
    req, blocks, length, last_token = backend.export_slot(i)
    state = paged_kv.extract_blocks(
        backend.pools, _pool_mask(backend), _ids(backend, blocks), i,
        int(backend.arena_ids[i]))
    backend.detach_slot(i)
    return MigrationPacket(req, length, last_token, len(blocks), state,
                           _nbytes(state), src, kv_format=backend.kv_spec)


def can_import(backend, packet: MigrationPacket) -> bool:
    """True when ``backend`` can land the packet now: a decode lane not
    spoken for, admission headroom for the chain plus this step's growth
    block (the watermark is waived for an idle backend, which is why an
    idle decode replica can always take the head packet), and a
    cross-arena row when the request's features are not resident."""
    if backend.num_active + len(backend.waiting) >= backend.cfg.num_slots:
        return False
    if backend.arena is not None:
        resident = backend.arena.lookup(id(packet.req.encoder_features))
        if resident == paged_kv.NULL_ARENA \
                and not backend.arena.can_admit(1):
            return False
    need = paged_kv.blocks_for(packet.length + 1, backend.cfg.block_size)
    return backend.alloc.can_admit(need, strict=backend.num_active > 0)


def insert_packet(backend, packet: MigrationPacket) -> int:
    """Land a packet: allocate destination blocks, install the host-side
    slot view (``import_slot``) and scatter the state into the pools in
    place. Returns the slot index. Callers gate on ``can_import``; the
    allocation may still reclaim prefix-LRU blocks (the allocator
    unlinks them from the index, as at admission).

    When the request's features already have a resident arena row, the
    slot shares it and the packet's cross row goes to the null row
    instead: a live request reads the resident row, and the port never
    rewrites a shared row (``PagedBackend._install_arena``)."""
    if packet.kv_format != backend.kv_spec:
        raise ValueError(
            "KV-format mismatch on migration "
            f"(MigrationPacket.kv_format={packet.kv_format!r} vs "
            f"destination pool spec {backend.kv_spec!r})"
            ": source and destination replicas must share one "
            "EngineConfig.kv_dtype")
    shared = backend.arena is not None and backend.arena.lookup(
        id(packet.req.encoder_features)) != paged_kv.NULL_ARENA
    ids = backend.alloc.alloc(packet.n_blocks)
    i = backend.import_slot(packet.req, ids, packet.length,
                            packet.last_token)
    arena = paged_kv.NULL_ARENA if shared else int(backend.arena_ids[i])
    paged_kv.insert_blocks(backend.pools, _pool_mask(backend), packet.state,
                           _ids(backend, ids), i, arena)
    return i
