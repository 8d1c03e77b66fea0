"""Paged KV cache: a shared pool of token blocks + per-sequence block tables.

Counterpart of ``repro/models/paged_kv.py`` (bf16/f32 pools, the
int8/fp8 pools of ``PoolSpec`` with their per-(token, head) scales, the
refcounting allocator, the prefix index, and the encoder-decoder's
cross-KV arena with its refcounting ``CrossArena``). Physical
storage is a pool of fixed-size blocks shared by all decode slots, and a
per-sequence block table maps logical token positions to physical
blocks, so cache memory scales with ``sum(len_i)``.

Layout per full-attention layer stack (count = layers in the group):

    k_pool, v_pool: (count, num_blocks, block_size, n_kv_heads, head_dim)
    k_scale, v_scale: (count, num_blocks, block_size, n_kv_heads) f32,
                      only in a quantized pool (int8 / fp8 payloads)

Physical block 0 is the reserved *null block*: retired or empty slots
and pad tails point at it, so their discarded writes land somewhere
harmless; it is only ever read masked. The allocator never hands it out.

Unlike the JAX package, the device-side functions here update the pool
tensors IN PLACE (and return the pool for symmetry); the
``BlockAllocator`` is host-side bookkeeping owned by the scheduler.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

NULL_BLOCK = 0
NULL_ARENA = 0

KV_DTYPES = ("bf16", "int8", "fp8")

# fp8 e4m3 saturates at +-448; values past it cast to NaN, not inf, so
# the quantizer must clip BEFORE the dtype cast.
_FP8_MAX = 448.0


def blocks_for(n_tokens: int, block_size: int) -> int:
    return -(-n_tokens // block_size)


def rollback_tail(blocks: list, n_tokens: int, block_size: int) -> list:
    """Split off the blocks a sequence no longer needs after a rewind.

    The speculative verify step appends up to K+1 tokens to a slot's
    blocks and then rewinds the length pointer over the rejected tail:
    the paged cache's rollback is just that pointer move (rejected K/V
    stay in place, invisible past the length, overwritten when the
    sequence genuinely reaches those positions). What remains is
    returning surplus whole blocks: mutates ``blocks`` down to
    ``blocks_for(n_tokens)`` entries and returns the cut tail for
    ``BlockAllocator.free``. No block contents are copied.
    """
    keep = blocks_for(n_tokens, block_size)
    tail = blocks[keep:]
    del blocks[keep:]
    return tail


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Static geometry of the paged cache."""

    num_slots: int           # decode batch width B
    num_blocks: int          # pool size incl. reserved null block 0
    block_size: int          # tokens per block
    max_len: int             # per-sequence position cap

    def __post_init__(self):
        if self.num_blocks < 2:
            raise ValueError("need >= 1 allocatable block + the null block")

    @property
    def max_blocks_per_seq(self) -> int:
        return blocks_for(self.max_len, self.block_size)

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1        # block 0 is the null block


class BlockAllocator:
    """Refcounting allocator over physical blocks 1..num_blocks-1.

    Every block is in exactly ONE of four states, and the partition is
    checked after every transition (``check_invariant``):

    * **owned** — refcount >= 1: referenced by live slot tables. A block
      shared by N slots carries refcount N; ``free`` decrements and only
      the last reference releases the block.
    * **cached** LRU — refcount 0 but registered in a prefix index
      (``register``): kept resident so a future admission can re-hit it
      (``share`` revives it), reclaimed oldest-first ONLY when the free
      list runs dry (``on_evict`` tells the index to unlink it).
    * **free** — a plain FIFO: ``free`` appends to the tail, ``alloc``
      pops from the head, so a preempted victim's blocks are the LAST
      ones recycled.
    * the reserved null block 0 — never allocated, never freed.

    ``can_admit`` applies a free-block *watermark* so new sequences
    leave growth headroom, and ``select_victim`` encodes the preemption
    order (LIFO — the most recently admitted sequence is evicted first,
    so the oldest admission always runs to completion and the engine
    cannot livelock).
    """

    def __init__(self, layout: PagedLayout, watermark: int = 0,
                 on_evict=None):
        self.layout = layout
        self.watermark = watermark
        self.on_evict = on_evict           # called with each reclaimed
        self._free = collections.deque(range(1, layout.num_blocks))
        self._refs: dict[int, int] = {}    # block -> live reference count
        self._cached: set[int] = set()     # registered in a prefix index
        # refcount-0 cached blocks, insertion-ordered: oldest first
        self._lru: collections.OrderedDict[int, None] = \
            collections.OrderedDict()

    @property
    def free_count(self) -> int:
        """Blocks allocatable right now (free list + reclaimable LRU)."""
        return len(self._free) + len(self._lru)

    @property
    def used_count(self) -> int:
        """Blocks with at least one live reference."""
        return len(self._refs)

    @property
    def lru_count(self) -> int:
        """Unreferenced cached blocks awaiting re-hit or reclaim."""
        return len(self._lru)

    def refcount(self, b: int) -> int:
        return self._refs.get(b, 0)

    def can_alloc(self, n: int) -> bool:
        return n <= self.free_count

    def can_admit(self, n: int, *, strict: bool = True) -> bool:
        """Admission check for a NEW sequence needing ``n`` blocks now.

        ``strict`` keeps ``watermark`` blocks free as growth headroom for
        already-running sequences; callers pass ``strict=False`` when
        nothing else is running (the watermark must never starve a sole
        request — progress beats headroom)."""
        if not strict:
            return n <= self.free_count
        return n + self.watermark <= self.free_count

    @staticmethod
    def select_victim(candidates: list[tuple[int, int]]) -> int:
        """Pick the preemption victim from ``(slot, admission_ticket)``
        pairs: LIFO — highest ticket (latest admission) loses."""
        if not candidates:
            raise ValueError("no preemption candidates")
        return max(candidates, key=lambda c: c[1])[0]

    def alloc(self, n: int) -> list[int]:
        """Claim ``n`` exclusively-owned blocks (refcount 1 each),
        reclaiming the oldest unreferenced cached blocks only after the
        plain free list is exhausted."""
        if n > self.free_count:
            raise MemoryError(f"paged pool exhausted: want {n}, "
                              f"free {self.free_count}")
        out = []
        for _ in range(n):
            if self._free:
                b = self._free.popleft()
            else:                          # reclaim the oldest cached
                b, _ = self._lru.popitem(last=False)
                self._cached.discard(b)
                if self.on_evict is not None:
                    self.on_evict(b)
            self._refs[b] = 1
            out.append(b)
        self.check_invariant()
        return out

    def free(self, blocks: list[int]):
        """Drop one reference per block. The LAST reference releases the
        block: to the cached LRU when a prefix index registered it, else
        to the tail of the FIFO free list."""
        for b in blocks:
            if b == NULL_BLOCK:
                raise ValueError("freeing the reserved null block")
            r = self._refs.get(b, 0)
            if r <= 0:
                raise ValueError(f"double-free of block {b}")
            if r > 1:
                self._refs[b] = r - 1
            else:
                del self._refs[b]
                if b in self._cached:
                    self._lru[b] = None    # most recent at the tail
                else:
                    self._free.append(b)
        self.check_invariant()

    def share(self, b: int):
        """Take one more reference on a resident block: bump a live
        block's refcount, or revive an unreferenced cached block out of
        the LRU. Raises on free/unknown blocks."""
        if b in self._refs:
            self._refs[b] += 1
        elif b in self._lru:
            del self._lru[b]
            self._refs[b] = 1
        else:
            raise ValueError(f"sharing unreferenced block {b}")
        self.check_invariant()

    def register(self, b: int):
        """Mark a LIVE block as indexed by a prefix cache: when its last
        reference drops it parks in the LRU instead of the free list."""
        if b not in self._refs:
            raise ValueError(f"registering non-live block {b}")
        self._cached.add(b)

    def must_cow(self, b: int) -> bool:
        """True when an in-place write to ``b`` would be observable
        outside the writer: another slot holds a reference, or a prefix
        index could hand the block to a future admission."""
        return self._refs.get(b, 0) > 1 or b in self._cached

    def check_invariant(self):
        """owned ⊎ cached-LRU ⊎ free must partition blocks 1..N-1 (and
        the cached set may only mark resident blocks)."""
        owned, lru, free = set(self._refs), set(self._lru), set(self._free)
        if (owned & lru) or (owned & free) or (lru & free):
            raise AssertionError(
                f"allocator states overlap: owned∩lru={owned & lru} "
                f"owned∩free={owned & free} lru∩free={lru & free}")
        universe = set(range(1, self.layout.num_blocks))
        if (owned | lru | free) != universe:
            raise AssertionError(
                f"allocator lost blocks: missing "
                f"{universe - (owned | lru | free)}, "
                f"foreign {(owned | lru | free) - universe}")
        if not self._cached <= (owned | lru):
            raise AssertionError(
                f"cached marks non-resident blocks: "
                f"{self._cached - (owned | lru)}")
        if any(r < 1 for r in self._refs.values()):
            raise AssertionError("non-positive refcount")


class _PrefixNode:
    __slots__ = ("chunk", "block", "parent", "children")

    def __init__(self, chunk, block, parent):
        self.chunk = chunk
        self.block = block
        self.parent = parent              # None for root-level nodes
        self.children: dict = {}


class PrefixIndex:
    """Host-side trie mapping block-size token chunks to pool blocks.

    Each node keys one FULL block of token ids on the path from the
    sequence start and names the physical block whose K/V holds exactly
    those positions: K/V of an attention layer depend only on the token
    ids and absolute positions of the prefix, so two requests sharing a
    prompt prefix can share the physical blocks.

    The index holds NO references of its own: the ``BlockAllocator``
    keeps indexed blocks resident (cached LRU) and calls ``evict_block``
    when it reclaims one. Insertion is first-wins: a chunk already
    indexed keeps its original block, and later copies of the same
    content stay private to their slot. Evicting a node orphans its
    descendants: matching walks from the root, so they can no longer be
    matched, and they age out of the allocator's LRU like any cold block.
    """

    def __init__(self, block_size: int):
        self.block_size = block_size
        self.children: dict = {}          # root: chunk tuple -> node
        self._by_block: dict[int, _PrefixNode] = {}

    def __len__(self) -> int:
        return len(self._by_block)

    def match(self, tokens) -> list[int]:
        """Physical blocks of the longest indexed chain of FULL
        block-size chunks prefixing ``tokens`` (possibly empty)."""
        bs = self.block_size
        out: list[int] = []
        kids = self.children
        for c in range(len(tokens) // bs):
            node = kids.get(tuple(tokens[c * bs:(c + 1) * bs]))
            if node is None:
                break
            out.append(node.block)
            kids = node.children
        return out

    def insert(self, tokens, blocks) -> list[int]:
        """Index ``blocks[c]`` under the c-th full chunk of ``tokens``
        (first-wins). Returns the block ids newly indexed: the caller
        must ``register`` exactly those with the allocator."""
        bs = self.block_size
        new: list[int] = []
        kids = self.children
        parent = None
        for c in range(min(len(tokens) // bs, len(blocks))):
            chunk = tuple(tokens[c * bs:(c + 1) * bs])
            node = kids.get(chunk)
            if node is None:
                node = _PrefixNode(chunk, blocks[c], parent)
                kids[chunk] = node
                self._by_block[blocks[c]] = node
                new.append(blocks[c])
            parent = node
            kids = node.children
        return new

    def evict_block(self, b: int):
        """Unlink the node indexing block ``b`` (allocator reclaim
        callback). Descendants become unmatchable orphans and are
        unlinked the same way when their blocks are reclaimed."""
        node = self._by_block.pop(b, None)
        if node is None:
            return
        kids = self.children if node.parent is None \
            else node.parent.children
        if kids.get(node.chunk) is node:
            del kids[node.chunk]


class CrossArena:
    """Refcounting allocator over cross-KV arena rows 1..num_arenas.

    An encoder-decoder request's cross-attention K/V is a pure function
    of its encoder features: written once at admission, read every
    decode step. It lives in one row of the arena (``init_cross_arena``);
    row 0 is the null row that empty slots and batch fillers point at.
    Two live requests built from the SAME feature array (``key`` is the
    caller's identity key, ``id(features)``) share one row by refcount.
    Rows partition into owned (refcount >= 1, keyed) and free (FIFO);
    an unreferenced row is freed at once (it is recomputable), so there
    is no LRU tier. ``check_invariant`` runs after every transition.
    """

    def __init__(self, num_arenas: int):
        self.num_arenas = num_arenas
        self._free = collections.deque(range(1, num_arenas + 1))
        self._refs: dict[int, int] = {}       # row -> live references
        self._key_of: dict[int, object] = {}  # row -> identity key
        self._by_key: dict[object, int] = {}  # identity key -> row

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        """Rows with at least one live reference."""
        return len(self._refs)

    def refcount(self, a: int) -> int:
        return self._refs.get(a, 0)

    def can_admit(self, n: int) -> bool:
        """True when ``n`` fresh (unshared) rows are allocatable."""
        return n <= len(self._free)

    def lookup(self, key) -> int:
        """The row holding ``key``'s cross-KV, or ``NULL_ARENA``."""
        return self._by_key.get(key, NULL_ARENA)

    def alloc(self, key=None) -> int:
        """Claim one row (refcount 1), keyed for ``lookup`` when ``key``
        is given. Raises MemoryError when none is free."""
        if not self._free:
            raise MemoryError("cross-KV arena exhausted")
        a = self._free.popleft()
        self._refs[a] = 1
        if key is not None:
            self._key_of[a] = key
            self._by_key[key] = a
        self.check_invariant()
        return a

    def share(self, a: int) -> int:
        """One more reference on a live row; raises on a free row."""
        if a not in self._refs:
            raise ValueError(f"sharing unreferenced arena row {a}")
        self._refs[a] += 1
        return a

    def free(self, a: int):
        """Drop one reference; the last returns the row to the free list
        and unlinks its key. Raises on the null row and on a free row."""
        if a == NULL_ARENA:
            raise ValueError("freeing the reserved null arena row")
        r = self._refs.get(a, 0)
        if r <= 0:
            raise ValueError(f"double-free of arena row {a}")
        if r > 1:
            self._refs[a] = r - 1
        else:
            del self._refs[a]
            key = self._key_of.pop(a, None)
            if key is not None:
                self._by_key.pop(key, None)
            self._free.append(a)
        self.check_invariant()

    def check_invariant(self):
        """Owned and free partition rows 1..A; the key maps mirror each
        other and name owned rows only."""
        owned, free = set(self._refs), set(self._free)
        if owned & free:
            raise AssertionError(f"arena states overlap: {owned & free}")
        universe = set(range(1, self.num_arenas + 1))
        if (owned | free) != universe:
            raise AssertionError(
                f"arena lost rows: missing {universe - (owned | free)}, "
                f"foreign {(owned | free) - universe}")
        if not set(self._key_of) <= owned:
            raise AssertionError("keys on non-owned arena rows")
        if {self._by_key[k]: k for k in self._by_key} != self._key_of:
            raise AssertionError("arena key maps disagree")


def head_shard_ok(cfg, tp_size: int) -> bool:
    """True when the head-sharded pool layout is exact for this model:
    each rank of the model axis owns a whole kv-head shard of every
    block (and the matching query-head groups), so its paged attention
    needs no collective. GQA group alignment follows from both
    divisibilities: rank i's query heads [i*Hq/t, (i+1)*Hq/t) map onto
    exactly its kv heads [i*Hkv/t, (i+1)*Hkv/t)."""
    return (tp_size > 1 and cfg.n_heads % tp_size == 0
            and cfg.n_kv_heads % tp_size == 0)


# ---------------------------------------------------------------------------
# Pool format: PoolSpec + KV quantization
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PoolSpec:
    """Static description of one paged pool's physical block format.

    The one source of truth for how K/V blocks are stored: the payload
    dtype (``bf16`` keeps the model compute dtype; ``int8`` / ``fp8``
    store a low-precision payload plus one f32 scale per (token row, kv
    head) as extra ``k_scale`` / ``v_scale`` pool leaves), the block
    geometry, and the physical head dim (``padded_head_dim`` pads
    blocks wider than the model's head dim; 0 means unpadded). Frozen
    and hashable, like JAX's. ``kv_dtype="bf16"`` with no padding yields
    exactly the pool tree of an engine without a spec. ``head_sharded``
    marks a pool split by kv heads over the model axis of a mesh: its
    ``n_kv_heads`` stays the model's, each rank's pool holds
    ``n_kv_heads / T`` of them (``transformer.init_paged_cache``), its
    scale leaves split with the payload.
    """

    kv_dtype: str = "bf16"                # "bf16" | "int8" | "fp8"
    block_size: int = 16
    n_kv_heads: int = 1
    head_dim: int = 64
    padded_head_dim: int = 0              # 0 = no padding
    head_sharded: bool = False

    def __post_init__(self):
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, "
                             f"got {self.kv_dtype!r}")
        if self.padded_head_dim and self.padded_head_dim < self.head_dim:
            raise ValueError("padded_head_dim < head_dim")

    @property
    def quantized(self) -> bool:
        return self.kv_dtype != "bf16"

    @property
    def store_dtype(self):
        """Payload dtype blocks are stored in (None = the cache dtype)."""
        if self.kv_dtype == "int8":
            return torch.int8
        if self.kv_dtype == "fp8":
            return torch.float8_e4m3fn
        return None

    @property
    def qmax(self) -> float:
        """Largest representable payload magnitude (scale denominator)."""
        return 127.0 if self.kv_dtype == "int8" else _FP8_MAX

    @property
    def pool_head_dim(self) -> int:
        """Physical last-axis width of pool blocks (padded or not)."""
        return self.padded_head_dim or self.head_dim


def make_pool_spec(cfg, layout: PagedLayout, *, kv_dtype: str = "bf16",
                   head_sharded: bool = False) -> PoolSpec:
    """Build the (unpadded) ``PoolSpec`` for a model config + paged
    layout."""
    return PoolSpec(kv_dtype=kv_dtype, block_size=layout.block_size,
                    n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                    head_sharded=head_sharded)


def quantize_kv(x, spec: PoolSpec):
    """Quantize K or V rows to the spec's payload dtype + scales.

    x: (..., Hkv, D) rows. Returns ``(payload, scale)``: payload shaped
    like x in ``spec.store_dtype``, scale (..., Hkv) f32 — one absmax
    scale per (token row, kv head), so a one-token decode append is
    self-contained and never requantizes its block. A zero row keeps
    scale 0 behind a divide guard (payload 0, dequant exact). int8
    rounds half to even; fp8 clips to +-448 before the cast. Every
    division is a true f32 division (never a multiply by a rounded
    reciprocal), so payload and scales equal JAX's bit for bit."""
    xf = x.float()
    # a device-side fill, not torch.tensor: no blocking host copy
    qmax = torch.full((), spec.qmax, dtype=torch.float32, device=x.device)
    scale = xf.abs().amax(-1) / qmax
    q = xf / torch.where(scale > 0, scale, 1.0)[..., None]
    q = q.clamp(-spec.qmax, spec.qmax)
    if spec.kv_dtype == "int8":
        q = torch.round(q)
    return q.to(spec.store_dtype), scale


def dequantize_kv(payload, scale):
    """Inverse of ``quantize_kv``: f32 rows from payload + scales."""
    return payload.float() * scale[..., None]


def _pad_head_dim(x, hd_pool: int):
    """Zero-pad the last axis of K/V rows to the pool's physical width."""
    pad = hd_pool - x.shape[-1]
    return torch.nn.functional.pad(x, (0, pad)) if pad > 0 else x


def _raw(t):
    """A one-byte float pool as uint8 for indexed writes (the same bytes;
    integer index_put runs on every backend)."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


# ---------------------------------------------------------------------------
# Device side (in place)
# ---------------------------------------------------------------------------


def write_kv_rows(pool, phys, off, k, v, spec: PoolSpec = None):
    """Scatter new K/V rows at the decode/verify append frontier, IN
    PLACE.

    pool: {"k", "v"} of (NB, BS, Hkv, Dp), plus ``k_scale`` / ``v_scale``
    (NB, BS, Hkv) when quantized; phys/off: integer index tensors
    selecting (block, slot-in-block) per row, (B,) for a decode step or
    (B, K1) for a verify window; k/v: (..., Hkv, D) new rows matching the
    index shape. With a spec the rows are zero-padded to the pool's head
    dim, and with a quantized spec they are quantized per (row, head),
    the scales landing at the same (phys, off). Rows aimed at the same
    place (the null block, from retired slots and pad rows) land in
    unspecified order, which is harmless because the null block is only
    read masked."""
    phys, off = phys.long(), off.long()
    if spec is not None:
        k = _pad_head_dim(k, spec.pool_head_dim)
        v = _pad_head_dim(v, spec.pool_head_dim)
    if spec is None or not spec.quantized:
        pool["k"][phys, off] = k.to(pool["k"].dtype)
        pool["v"][phys, off] = v.to(pool["v"].dtype)
        return pool
    for name, x in (("k", k), ("v", v)):
        payload, scale = quantize_kv(x, spec)
        _raw(pool[name])[phys, off] = _raw(payload)
        pool[name + "_scale"][phys, off] = scale
    return pool


def init_layer_pool(cfg, layout: PagedLayout, dtype, device, lead=(),
                    spec: PoolSpec = None):
    """Zeroed block pool {"k", "v"} of ``lead + (NB, BS, Hkv, Dp)`` for a
    full-attention layer, Dp the spec's pool head dim. A quantized spec
    stores its payload dtype and adds f32 ``k_scale`` / ``v_scale``
    leaves of ``lead + (NB, BS, Hkv)``; ``None`` (or a bf16 spec without
    padding) yields the pool of an engine without a spec. Windowed and
    recurrent layers keep per-slot state instead
    (``transformer.init_paged_cache``): their state is bounded, so
    paging buys nothing."""
    hd = spec.pool_head_dim if spec is not None else cfg.head_dim
    shape = tuple(lead) + (layout.num_blocks, layout.block_size,
                           cfg.n_kv_heads, hd)
    if spec is None or not spec.quantized:
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    return {"k": torch.zeros(shape, dtype=spec.store_dtype, device=device),
            "v": torch.zeros(shape, dtype=spec.store_dtype, device=device),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device)}


def init_cross_arena(cfg, layout: PagedLayout, dtype, device):
    """The cross-attention K/V arena: ``{"k", "v"}`` of (n_layers,
    num_slots + 1, Hkv, encoder_len, D), zeroed, row 0 the null row.
    Allocated once with the pools and written in place, so the captured
    decode step reads the same storage forever."""
    shape = (cfg.n_layers, layout.num_slots + 1, cfg.n_kv_heads,
             cfg.encoder_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def pack_cross_arena(arena, cross_kv, arena_ids):
    """Write freshly encoded cross-KV rows into the arena, IN PLACE.

    arena: {"k", "v"} of (L, A+1, Hkv, encoder_len, D); cross_kv: {"k",
    "v"} of (L, N, Hkv, Fb, D) with the frame bucket Fb <= encoder_len,
    zero-padded here to encoder_len (reads are masked to each row's true
    length); arena_ids: (N,) int destination rows. Batch fillers, and
    rows whose features' row is written already, point at the null row,
    where their writes collide harmlessly (its reads are masked to 0
    frames); every other destination appears once.
    """
    ids = arena_ids.long()
    for name in ("k", "v"):
        a, c = arena[name], cross_kv[name]
        c = torch.nn.functional.pad(c, (0, 0, 0, a.shape[3] - c.shape[3]))
        a[:, ids] = c.to(a.dtype)
    return arena


def pool_bytes(pools) -> int:
    """Bytes of every leaf of a (nested) pool tree, scales included."""
    if isinstance(pools, dict):
        return sum(pool_bytes(v) for v in pools.values())
    return pools.numel() * pools.element_size()


def pack_prefill_kv(pool, dense_kv, block_ids, block_size,
                    spec: PoolSpec = None):
    """Scatter a batch of prefilled dense caches into pool blocks, IN
    PLACE.

    pool: {"k", "v"} of (..., NB, BS, Hkv, Dp) (plus the scale leaves
    when quantized); dense_kv: {"k", "v"} of (..., N, S, Hkv, D) with
    S == block_ids.shape[1] * BS (zero past each row's true length);
    block_ids: (N, nbp) physical destinations, one row per prefilled
    sequence. Leading (stacked layer) dims broadcast. With a quantized
    ``spec`` the dense rows are quantized per (token, head) and the
    scales land in ``k_scale`` / ``v_scale`` through the same flat block
    indices. Rows' real blocks are disjoint; pad-tail and batch-filler
    entries all point at the null block, where their writes collide
    harmlessly.
    """
    if block_ids.dim() == 1:              # single-sequence convenience
        block_ids = block_ids[None]
    n, nbp = block_ids.shape
    flat = block_ids.reshape(-1).long()
    quant = spec is not None and spec.quantized
    for name in ("k", "v"):
        p, d = pool[name], dense_kv[name]
        if spec is not None:
            d = _pad_head_dim(d, spec.pool_head_dim)
        lead = p.shape[:-4]
        hkv, hd = p.shape[-2:]
        if quant:
            d, s = quantize_kv(d, spec)
            sp = pool[name + "_scale"]
            sp[..., flat, :, :] = s.reshape(lead + (n * nbp, block_size,
                                                    hkv))
        d = d.reshape(lead + (n * nbp, block_size, hkv, hd))
        _raw(p)[..., flat, :, :, :] = _raw(d.to(p.dtype))
    return pool


def _select_slots(state, dense, row_of_slot, valid, batch_axis):
    """Install per-slot decode state IN PLACE: slot s takes ``dense``
    row ``row_of_slot[s]`` where ``valid[s]``, else keeps its state (a
    batch filler row never overwrites a live slot). A gather of the
    valid slots' rows and an indexed copy into distinct slots, never a
    scatter with duplicate indices, so the result is exact for any
    (row_of_slot, valid)."""
    slots = torch.nonzero(valid.bool()).flatten()
    rows = row_of_slot.long()[slots]
    src = torch.index_select(dense, batch_axis, rows)
    state.index_copy_(batch_axis, slots, src.to(state.dtype))
    return state


def pack_prefill_ring(ring, dense_ring, row_of_slot, valid):
    """Install a batch of prefilled ring caches into per-slot storage, IN
    PLACE.

    ring: (..., B, size_e, Hkv, D); dense_ring: (..., N, size_p, Hkv, D)
    with size_p <= size_e. A prompt shorter than the ring leaves the
    prefill ring's tail zero (masked by the decode validity predicate
    until decode overwrites it); a prompt that wrapped has size_p ==
    size_e, and ring order (slot = pos % size) already matches the
    decode discipline, so a direct copy is exact.
    """
    pad = ring.shape[-3] - dense_ring.shape[-3]
    if pad:
        dense_ring = torch.nn.functional.pad(dense_ring, (0, 0, 0, 0, 0, pad))
    return _select_slots(ring, dense_ring, row_of_slot, valid,
                         batch_axis=ring.dim() - 4)


def pack_prefill_state(state, dense_state, row_of_slot, valid):
    """Install a batch of prefilled decode state into per-slot storage,
    IN PLACE: the draft model's linear caches, RG-LRU carries and conv
    tails. Both trees are stacked like ``init_cache``: a leading
    layer-count axis, then the slot/batch axis, so the batch axis is
    axis 1 on every leaf (rglru h (L, B, dr), conv (L, B, 3, dr))."""
    if isinstance(state, dict):
        for k in state:
            pack_prefill_state(state[k], dense_state[k], row_of_slot, valid)
        return state
    return _select_slots(state, dense_state, row_of_slot, valid,
                         batch_axis=1)


def extract_blocks(pools, kinds, block_ids, slot: int,
                   arena: int = NULL_ARENA):
    """Gather ONE slot's migratable cache out of a paged tree into fresh
    storage.

    ``kinds`` is a same-structure tree of kind strings
    (``Model.paged_pool_mask``, classified by layer kind): ``"pool"``
    leaves ``(L, NB, BS, Hkv, D)`` (and their scale leaves) gather the
    ``block_ids`` rows along the block axis (axis 1, after the stacked
    layer-count axis); ``"slot"`` leaves (rings, recurrent carries, conv
    tails; slot axis also at axis 1) take the slot's own row; ``"cross"``
    leaves (the cross-KV arena) take row ``arena``, the slot's arena row.
    Single rows keep size 1 along axis 1, so every leaf keeps its rank.
    ``block_ids`` is a 1-D integer tensor of the real chain only.

    Unlike JAX's functional gather, the pools here are written in place:
    every gathered leaf is a copy (``index_select`` / ``clone``), so the
    source chain may be freed and its blocks rewritten by a later
    admission without reaching into the result. The copies are enqueued
    on the current stream, after whatever wrote the slot last."""
    if isinstance(pools, dict):
        return {k: extract_blocks(v, kinds[k], block_ids, slot, arena)
                for k, v in pools.items()}
    if kinds == "pool":
        return torch.index_select(_raw(pools), 1, block_ids.long()
                                  ).view(pools.dtype)
    row = arena if kinds == "cross" else slot
    return pools[:, row:row + 1].clone()


def insert_blocks(pools, kinds, packet, block_ids, slot: int,
                  arena: int = NULL_ARENA):
    """Scatter an ``extract_blocks`` result into a destination tree, IN
    PLACE: pool leaves write the packet's block rows into ``block_ids``
    (freshly allocated, as many as the packet holds), ``"slot"`` leaves
    overwrite the destination slot's row and ``"cross"`` leaves row
    ``arena``. No leaf is rebound, so a captured decode step keeps
    reading the same storage."""
    if isinstance(pools, dict):
        for k, v in pools.items():
            insert_blocks(v, kinds[k], packet[k], block_ids, slot, arena)
        return pools
    if kinds == "pool":
        _raw(pools).index_copy_(1, block_ids.long(), _raw(packet))
    else:
        row = arena if kinds == "cross" else slot
        pools[:, row:row + 1].copy_(packet)
    return pools
