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

**Between submeshes** (``DisaggregatedEngine(mesh=)``) a packet has two
parts. Its header (``header``: the request's uid, length, last token,
block count, bytes, source replica, pool format) travels in the router's
exchange, so every process holds the same packets in the same order
(``from_header`` rebuilds one around the process's own handle). Its
payload stays where the gather left it, each of the source replica's T
ranks holding its own shard, until the packet lands: then rank t of the
source sends its shard to rank t of the destination (``send_payload`` /
``recv_payload``, one flat buffer over the mesh's payload group). Both
replicas run the same ``plan_tp``, so shard t holds the same heads,
channels and arena columns on both sides, and the destination scatters
it in place as on one device. ``payload_bytes`` counts the logical
packet, as JAX's global arrays do (every head once, a leaf a rank holds
whole, as under the replicated-KV fallback, counted once); ``rank_bytes``
is what one rank sends.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ...models import paged_kv
from .api import RequestHandle

_ALIGN = 16        # a leaf's bytes in a flat payload start 16-byte aligned


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
        Under a mesh: the rank's shard, on the source replica's ranks
        only, None elsewhere and once landed.
    payload_bytes : int
        The logical packet's bytes: every pool leaf's real blocks and
        every slot and cross row, each head once (JAX's count).
    src : int
        Exporting replica index.
    kv_format : PoolSpec or None
        The source pool's ``paged_kv.PoolSpec`` (None: the model dtype).
        Scale leaves travel in ``state`` like any pool leaf, so the
        stored payload moves bit for bit; ``insert_packet`` refuses a
        format mismatch.
    rank_bytes : int
        Bytes of one rank's ``state`` (``payload_bytes`` on one device).
    """

    req: RequestHandle
    length: int
    last_token: int
    n_blocks: int
    state: Any
    payload_bytes: int
    src: int
    kv_format: Any = None
    rank_bytes: int = 0


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


def _leaves(tree, kinds):
    """(leaf, kind) pairs of a pool-structured tree, in its dict order
    (``kinds`` None: the leaves' kinds are not needed)."""
    if isinstance(tree, dict):
        return [p for k in tree for p in _leaves(
            tree[k], None if kinds is None else kinds[k])]
    return [(tree, kinds)]


def _row_shapes(backend, pools, n_blocks: int):
    """(shape, dtype) of each leaf of a packet over ``pools``' leaves:
    ``n_blocks`` rows of a pool leaf, one row of a slot or cross leaf."""
    return [((t.shape[0], n_blocks if kind == "pool" else 1)
             + tuple(t.shape[2:]), t.dtype)
            for t, kind in _leaves(pools, _pool_mask(backend))]


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _shape_bytes(shapes) -> int:
    """Bytes of leaves of the given (shape, dtype)."""
    return sum(torch.Size(s).numel() * d.itemsize for s, d in shapes)


def logical_bytes(backend, n_blocks: int) -> int:
    """Bytes of the logical packet of ``n_blocks`` blocks: the leaves
    at their whole shapes (a pool built on the meta device), as JAX's
    global arrays count them, whatever this rank holds of them."""
    pools = getattr(backend, "_migration_whole", None)
    if pools is None:
        pools = backend.model.init_paged_cache(backend.layout,
                                               spec=backend.kv_spec,
                                               device="meta")
        backend._migration_whole = pools
    return _shape_bytes(_row_shapes(backend, pools, n_blocks))


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
    n = len(blocks)
    return MigrationPacket(
        req, length, last_token, n, state, logical_bytes(backend, n), src,
        kv_format=backend.kv_spec,
        rank_bytes=_nbytes(state))


def header(packet: MigrationPacket) -> tuple:
    """A packet without its handle and payload, as the router's exchange
    carries it: (uid, length, last_token, n_blocks, payload_bytes,
    rank_bytes, src, kv_format)."""
    return (packet.req.uid, packet.length, packet.last_token,
            packet.n_blocks, packet.payload_bytes, packet.rank_bytes,
            packet.src, packet.kv_format)


def from_header(head: tuple, req: RequestHandle) -> MigrationPacket:
    """The packet of ``header`` around this process's handle of its
    request; its payload is on the source replica's ranks."""
    _, length, last_token, n_blocks, nbytes, rank_bytes, src, fmt = head
    return MigrationPacket(req, length, last_token, n_blocks, None, nbytes,
                           src, kv_format=fmt, rank_bytes=rank_bytes)


def can_import(state, cfg, packet: MigrationPacket, resident: bool) -> bool:
    """True when a replica whose scheduling state is ``state`` (a
    ``replica._Mirror``) under ``cfg`` can land the packet now: a decode
    lane not spoken for, admission headroom for the chain plus this
    step's growth block (the watermark is waived for an idle replica,
    which is why an idle decode replica can always take the head
    packet), and a cross-arena row when the request's features are not
    ``resident`` there."""
    if state.active + state.waiting >= cfg.num_slots:
        return False
    if state.arena_free >= 0 and not resident and state.arena_free < 1:
        return False
    need = paged_kv.blocks_for(packet.length + 1, cfg.block_size)
    headroom = cfg.watermark_blocks if state.active > 0 else 0
    return need + headroom <= state.free


def _slots(shapes):
    """Each leaf's byte offset in a flat payload (16-byte aligned, so a
    leaf's view of the buffer needs no copy) and the payload's size."""
    offs, n = [], 0
    for s, d in shapes:
        offs.append(n)
        n += -(-_shape_bytes([(s, d)]) // _ALIGN) * _ALIGN
    return offs, n


def send_payload(packet: MigrationPacket, dst: int, mesh):
    """Send this rank's shard of a packet to world rank ``dst`` (rank t
    of the destination replica) over the mesh's payload group, as one
    flat buffer of 16-byte aligned leaves, and drop it here. Under gloo
    a CUDA payload goes through pinned host memory (gloo sends CPU
    tensors only); under NCCL it goes card to card."""
    leaves = [t for t, _ in _leaves(packet.state, None)]
    offs, n = _slots([(t.shape, t.dtype) for t in leaves])
    flat = torch.empty(n, dtype=torch.uint8, device=leaves[0].device)
    for t, o in zip(leaves, offs):
        b = t.reshape(-1).view(torch.uint8)
        flat[o:o + b.numel()].copy_(b)
    if mesh.payload_backend == "gloo" and flat.is_cuda:
        host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        host.copy_(flat)
        flat = host
    torch.distributed.send(flat, dst, group=mesh.payload_group)
    packet.state = None


def recv_payload(backend, packet: MigrationPacket, src: int, mesh):
    """Receive the shard world rank ``src`` (rank t of the source
    replica) sends of ``packet`` into ``packet.state``, shaped after
    this rank's pools (its ``plan_tp`` is the source's)."""
    shapes = _row_shapes(backend, backend.pools, packet.n_blocks)
    if _shape_bytes(shapes) != packet.rank_bytes:
        raise ValueError(
            f"a {packet.rank_bytes}-byte shard for a rank whose pools take "
            f"{_shape_bytes(shapes)} bytes of {packet.n_blocks} blocks: "
            "source and destination replicas must share one plan")
    offs, n = _slots(shapes)
    on_card = backend.device.type == "cuda"
    staged = mesh.payload_backend == "gloo" and on_card
    flat = torch.empty(n, dtype=torch.uint8, pin_memory=staged,
                       device="cpu" if staged else backend.device)
    torch.distributed.recv(flat, src, group=mesh.payload_group)
    if staged:
        flat = flat.to(backend.device)
    views = iter([flat[o:o + _shape_bytes([(s, d)])].view(d).view(s)
                  for (s, d), o in zip(shapes, offs)])

    def build(pools):
        if isinstance(pools, dict):
            return {k: build(v) for k, v in pools.items()}
        return next(views)

    packet.state = build(backend.pools)


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
