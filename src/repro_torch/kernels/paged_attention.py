"""K2, K3 and K4 wrappers: attention over the block-paged pool.

Counterparts of ``repro/kernels/paged_attention.py``:
``paged_decode_attention`` (K2, one query row per sequence, kernel
``csrc/paged_attention.cu``) and ``paged_verify_attention`` (K3, K1
query rows per sequence for the speculative verify and the suffix
prefill, kernel ``csrc/paged_verify_attention.cu``). K4 is the quantized
path of both (JAX ``_dequant``): an int8 or fp8 (e4m3fn) payload with
f32 ``k_scale`` / ``v_scale`` of (NB, BS, Hkv), dequantized inside the
same two kernels as the rows are loaded, so no full-precision copy of
the pool exists. A CPU tensor runs the plain version in
``kernels/ref.py``; a CUDA tensor launches the hand-written kernel on
the current stream, or raises. There is no fallback from one to the
other. Launches are counted per function: ``.launches`` for float pools
(K2, K3), ``.k4_launches`` for quantized ones (K4), one per call and one
per replay of the captured decode step (``kernels/counters.py``). A pool
wider than q's head dim (a padded pool, ``PoolSpec.padded_head_dim``) is
read at q's width by the plain version; for the kernels, which take one
width, the wrapper zero-pads q to the pool's and slices the output back.

K2 cuts each sequence's table into ``split_plan``'s splits, one CTA
each (flash-decoding); with more than one split, the combine kernel
merges their partial softmax states, launched by the same C call and
counted in ``paged_decode_combine.launches`` (that wrapper runs the
combine alone). The plan reads shapes only, never ``lengths``: nothing
syncs with the card, and a captured CUDA graph replays for any lengths
and table.

``kv_heads=(first, count)`` reads a range of the pool's kv heads, the
rest untouched: a tensor-parallel rank whose query heads read one kv
head of a pool every rank holds whole (the replicated-KV layout). The
plain version reads a head view of the pool; the kernels take the
range's first head and the pool's kv heads as their row stride (the C
entries' ``kv_lo`` / ``Hkp``). No byte of the pool is copied.

K3 has three bodies, and ``verify_body`` picks one from shapes, dtypes
and q's alignment alone, never from ``lengths``: "split" for a window
of fewer than ``SPLIT_PAIRS`` (row, group) pairs a kv head (the verify
step: K2's plan and combine pass, f32 on the CUDA cores), "wgmma" for a
bf16 q over a bf16, int8 or fp8 pool that a tensor map takes (the
suffix prefill on Hopper's tensor cores), "simt" for the rest (f32
suffix prefill, block sizes the tensor map cannot tile).
``paged_verify_attention.launches_by_body`` counts each body's calls,
float and quantized pools alike; a split call with more than one split
also counts one combine launch in ``paged_decode_combine.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build, ref
from .flash_attention import DTYPES

HEAD_DIMS = (16, 32, 64, 128, 256)  # pool head dims the kernels are built for
GROUPS = (1, 2, 4, 8)               # Hq // Hkv the CUDA kernel is built for
MAX_GROUP_DIMS = 1024               # K2: group * head dim (shared memory)
PAYLOADS = {torch.int8: 2, torch.float8_e4m3fn: 3}   # csrc/common.cuh DType

SPLIT_TOKENS = (64, 128)   # K2: keys a split takes, least and most
CTAS_PER_SM = 8            # K2: the plan's aim, 2 waves of 4 CTAs an SM

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
             + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_COMBINE_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]
_PV_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 11
                + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p])

VERIFY_BODIES = ("simt", "wgmma", "split")   # the C entry's body codes
SPLIT_PAIRS = 32        # K3 "split": fewer than 32 (row, group) pairs
WGMMA_TILE_KEYS = 64    # K3 "wgmma": keys a K/V tile
WGMMA_MAX_TABLE = 1024  # K3 "wgmma": table entries a CTA stages


def supports(head_dim: int, group: int, mode: str = "decode") -> bool:
    """True when the CUDA kernel of ``mode`` ("decode": K2, "verify":
    K3; K4 likewise) is built for this pool head dim and query-per-kv
    group. K2 also keeps group * head dim within its merge buffer."""
    ok = head_dim in HEAD_DIMS and group in GROUPS
    return ok and (mode != "decode" or group * head_dim <= MAX_GROUP_DIMS)


def _pad_q(q, k_pool, scale):
    """(q zero-padded to the pool's head dim, the logical width, the
    softmax scale from the logical width)."""
    D, Dp = q.shape[-1], k_pool.shape[-1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    if Dp > D:
        q = torch.nn.functional.pad(q, (0, Dp - D))
    return q, D, scale


def kv_range(k_pool, kv_heads) -> tuple:
    """(first, count) of the pool's kv heads a call reads: ``kv_heads``
    checked against the pool, or all of them."""
    hkp = k_pool.shape[2]
    lo, n = kv_heads if kv_heads is not None else (0, hkp)
    if lo < 0 or n < 1 or lo + n > hkp:
        raise ValueError(f"kv heads [{lo}, {lo + n}) outside a pool of "
                         f"{hkp}")
    return int(lo), int(n)


def _head_view(t, lo, n):
    """The kv heads [lo, lo + n) of a pool or scale leaf, a view."""
    return t if t is None or (lo == 0 and n == t.shape[2]) \
        else t[:, :, lo:lo + n]


def _plain(fn, q, k_pool, v_pool, block_table, lengths, kv_heads, **kw):
    """The plain version over the kv-head view ``kv_heads`` selects."""
    lo, n = kv_range(k_pool, kv_heads)
    kw["k_scale"] = _head_view(kw["k_scale"], lo, n)
    kw["v_scale"] = _head_view(kw["v_scale"], lo, n)
    return fn(q, _head_view(k_pool, lo, n), _head_view(v_pool, lo, n),
              block_table, lengths, **kw)


def _check_pool_args(name, q, k_pool, v_pool, block_table, lengths,
                     k_scale, v_scale, hkv) -> int:
    """Raise ValueError unless the tensors are what the CUDA kernels take:
    one CUDA device; q f32 or bf16 and the pools of q's dtype, or int8 /
    fp8 payloads with f32 scales of (NB, BS, Hkp); int32 table and
    lengths; matching shapes, a supported head dim and group of q's heads
    over the ``hkv`` kv heads read; contiguous, pools 16-byte aligned.
    Returns the payload's type code."""
    B, Hq, D = q.shape[0], q.shape[-2], q.shape[-1]
    Hkv = hkv
    tensors = [q, k_pool, v_pool, block_table, lengths]
    quant = k_scale is not None or v_scale is not None
    if quant:
        if k_scale is None or v_scale is None:
            raise ValueError(f"{name}: a quantized pool needs both k_scale "
                             "and v_scale")
        tensors += [k_scale, v_scale]
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: tensors on "
                         f"{[str(t.device) for t in tensors]}; expected one "
                         "CUDA device")
    pdt = k_pool.dtype
    if q.dtype not in DTYPES or v_pool.dtype != pdt \
            or (pdt not in PAYLOADS if quant else pdt != q.dtype) \
            or (quant and (k_scale.dtype != torch.float32
                           or v_scale.dtype != torch.float32)):
        raise ValueError(
            f"{name}: dtypes q {q.dtype}, pools {k_pool.dtype} / "
            f"{v_pool.dtype}, scales "
            f"{[t.dtype for t in (k_scale, v_scale) if t is not None]}; "
            "expected q float32 or bfloat16 with pools of q's dtype, or "
            "int8 / float8_e4m3fn pools with float32 k_scale and v_scale")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(f"{name}: block_table and lengths must be int32")
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape \
            or k_pool.shape[3] != D or block_table.dim() != 2 \
            or block_table.shape[0] != B or lengths.shape != (B,) \
            or Hq % Hkv != 0 \
            or (quant and (k_scale.shape != k_pool.shape[:3]
                           or v_scale.shape != k_pool.shape[:3])):
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}, table {tuple(block_table.shape)}, "
            f"lengths {tuple(lengths.shape)}"
            + (f", scales {tuple(k_scale.shape)} / {tuple(v_scale.shape)}"
               if quant else ""))
    mode = "decode" if q.dim() == 3 else "verify"
    if not supports(D, Hq // Hkv, mode):
        raise ValueError(f"{name}: head dim {D} / group {Hq // Hkv} not in "
                         f"{HEAD_DIMS} / {GROUPS} (K2: group * head dim <= "
                         f"{MAX_GROUP_DIMS})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError(f"{name}: pools must be 16-byte aligned")
    return PAYLOADS[pdt] if quant else DTYPES[q.dtype]


def _ptr(t):
    return t.data_ptr() if t is not None else None


@functools.lru_cache(maxsize=None)
def split_plan(B: int, Hkv: int, nbmax: int, BS: int,
               n_sm: int) -> tuple[int, int]:
    """K2's split of the key axis: (blocks per split, number of splits).

    A split takes between ``SPLIT_TOKENS`` keys (64-128, so 4-8 blocks
    at BS 16; one block where a block is larger): the largest split that
    still gives ``B * Hkv * nsplit >= CTAS_PER_SM * n_sm`` CTAs at full
    table width, else the smallest. Split s covers logical blocks
    [s * bps, min((s + 1) * bps, nbmax)), so the splits cover the table
    once. Shapes only: a length never changes the plan."""
    least = max(1, -(-SPLIT_TOKENS[0] // BS))
    most = max(least, SPLIT_TOKENS[1] // BS)
    bps = least
    for c in range(most, least - 1, -1):
        if B * Hkv * -(-nbmax // c) >= CTAS_PER_SM * n_sm:
            bps = c
            break
    return bps, max(1, -(-nbmax // bps))


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def paged_decode_attention(q, k_pool, v_pool, block_table, lengths, *,
                           window=None, scale=None, k_scale=None,
                           v_scale=None, kv_heads=None):
    """q: (B, Hq, D); pools: (NB, BS, Hkv, D); block_table: (B, NBMAX)
    int32; lengths: (B,) int32 valid tokens including the current one;
    ``k_scale`` / ``v_scale`` (NB, BS, Hkv) f32 for an int8/fp8 pool
    (K4); ``kv_heads`` (first, count) the pool's kv heads q's heads read
    (default all) -> (B, Hq, D) in q's dtype.

    The kernel reads only the table entries of blocks the length (and
    window) can see, so entries past a sequence's last block may hold
    anything; every entry it does read must be a block id < NB.
    """
    if q.device.type == "cpu":
        return _plain(ref.paged_decode_attention, q, k_pool, v_pool,
                      block_table, lengths, kv_heads, window=window,
                      scale=scale, k_scale=k_scale, v_scale=v_scale)
    if q.dim() != 3:
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)} is "
                         "not (B, Hq, D)")
    kv_lo, Hkv = kv_range(k_pool, kv_heads)
    q, D0, scale = _pad_q(q, k_pool, scale)
    pdtype = _check_pool_args("paged_decode_attention", q, k_pool, v_pool,
                              block_table, lengths, k_scale, v_scale, Hkv)
    B, Hq, D = q.shape
    BS, Hkp = k_pool.shape[1:3]
    nbmax = block_table.shape[1]
    if B * Hq * D == 0:
        return torch.empty((B, Hq, D0), dtype=q.dtype, device=q.device)
    bps, nsplit = split_plan(B, Hkv, nbmax, BS, sm_count(q.device))
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    # every split writes its state here: acc (B, Hq, nsplit, D), m, l
    scratch = torch.empty(B * Hq * nsplit * (D + 2), dtype=torch.float32,
                          device=q.device) if nsplit > 1 else None
    fn = _build.function("repro_paged_decode_attention", _ARGTYPES)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             _ptr(k_scale), _ptr(v_scale), block_table.data_ptr(),
             lengths.data_ptr(), out.data_ptr(), _ptr(scratch),
             DTYPES[q.dtype], pdtype, B, Hq, Hkv, D, BS, nbmax,
             int(window or 0), scale, bps, nsplit, kv_lo, Hkp,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_decode_attention")
    if nsplit > 1:           # the same call launched the combine kernel
        paged_decode_combine.launches += 1
    if k_scale is None:
        paged_decode_attention.launches += 1
    else:
        paged_decode_attention.k4_launches += 1
    return out[..., :D0]


paged_decode_attention.launches = 0      # K2
paged_decode_attention.k4_launches = 0   # K4 (quantized pool)


def paged_decode_combine(m, l, acc, out_dtype):
    """Merge K2's per-split softmax states: m, l (B, Hq, nsplit) and the
    unnormalised acc (B, Hq, nsplit, D), f32 -> (B, Hq, D) in
    ``out_dtype`` (f32 or bf16). A split that saw no key holds m =
    kMaskValue, l = 0, acc = 0; a row whose splits all saw none gives 0.
    A CPU tensor runs ``ref.paged_decode_combine``, a CUDA tensor the
    combine kernel (``csrc/paged_attention.cu``). K2 launches the same
    kernel from its own C call, and counts it here too."""
    if m.device.type == "cpu":
        return ref.paged_decode_combine(m, l, acc, out_dtype)
    if m.device.type != "cuda" or any(t.device != m.device
                                      for t in (l, acc)):
        raise ValueError("paged_decode_combine: tensors on "
                         f"{[str(t.device) for t in (m, l, acc)]}; "
                         "expected one CUDA device")
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           for t in (m, l, acc)) or out_dtype not in DTYPES:
        raise ValueError("paged_decode_combine: m, l, acc must be "
                         "contiguous float32 and out_dtype float32 or "
                         f"bfloat16, got {[t.dtype for t in (m, l, acc)]} "
                         f"-> {out_dtype}")
    B, Hq, nsplit, D = acc.shape
    if m.shape != (B, Hq, nsplit) or l.shape != m.shape or nsplit < 1 \
            or D not in HEAD_DIMS:
        raise ValueError(f"paged_decode_combine: shapes m {tuple(m.shape)},"
                         f" l {tuple(l.shape)}, acc {tuple(acc.shape)}; "
                         f"head dim in {HEAD_DIMS}")
    out = torch.empty((B, Hq, D), dtype=out_dtype, device=m.device)
    fn = _build.function("repro_paged_decode_combine", _COMBINE_ARGTYPES)
    err = fn(m.data_ptr(), l.data_ptr(), acc.data_ptr(), out.data_ptr(),
             DTYPES[out_dtype], B * Hq, nsplit, D,
             torch.cuda.current_stream(m.device).cuda_stream)
    _build.check(err, "paged_decode_combine")
    paged_decode_combine.launches += 1
    return out


paged_decode_combine.launches = 0


def verify_body(q, k_pool, block_table) -> str:
    """The body K3 runs for a q (B, K1, Hq, D) over a pool (NB, BS, Hkv,
    D) (a head view of it for a ``kv_heads`` range) and a (B, NBMAX)
    table, from their shapes, dtypes and q's alignment alone (never a
    length, so a captured graph replays for any):

    * "split" when K1 * Hq / Hkv < ``SPLIT_PAIRS``: the verify step
      (spec_tokens + 1 rows), any dtype and payload. At 32 pairs and
      more the f32 products outweigh the bytes, and the smallest suffix
      bucket past the block size (32 rows at group 1) goes to the tensor
      cores;
    * "wgmma" for a bf16 q (16-byte aligned) over a bf16, int8 or fp8
      pool whose blocks a tensor map tiles: D a multiple of 16 up to 256,
      BS a multiple of 8 that divides ``WGMMA_TILE_KEYS`` or is a
      multiple of it, NBMAX <= ``WGMMA_MAX_TABLE``;
    * "simt" for everything else (an f32 suffix prefill, BS 6).
    """
    K1, Hq, D = q.shape[1:]
    BS, Hkv = k_pool.shape[1:3]
    if K1 * (Hq // max(Hkv, 1)) < SPLIT_PAIRS:
        return "split"
    tiles = BS % 8 == 0 and (WGMMA_TILE_KEYS % BS == 0
                             or BS % WGMMA_TILE_KEYS == 0)
    if q.dtype == torch.bfloat16 and q.data_ptr() % 16 == 0 \
            and k_pool.dtype in (torch.bfloat16, *PAYLOADS) \
            and D % 16 == 0 and 0 < D <= 256 and tiles \
            and block_table.shape[1] <= WGMMA_MAX_TABLE:
        return "wgmma"
    return "simt"


def paged_verify_attention(q, k_pool, v_pool, block_table, lengths, *,
                           window=None, scale=None, k_scale=None,
                           v_scale=None, kv_heads=None):
    """q: (B, K1, Hq, D); pools: (NB, BS, Hkv, D); block_table: (B, NBMAX)
    int32; lengths: (B,) int32 tokens cached BEFORE the window;
    ``k_scale`` / ``v_scale`` (NB, BS, Hkv) f32 for an int8/fp8 pool
    (K4); ``kv_heads`` (first, count) the pool's kv heads q's heads read
    (default all) -> (B, K1, Hq, D) in q's dtype. Row j attends
    positions < lengths[b] + 1 + j.

    The kernel reads only the table entries of positions some row of a
    query tile can see (clamped at NBMAX * BS), so entries past them may
    hold anything; every entry it does read must be a block id < NB.
    """
    if q.device.type == "cpu":
        return _plain(ref.paged_verify_attention, q, k_pool, v_pool,
                      block_table, lengths, kv_heads, window=window,
                      scale=scale, k_scale=k_scale, v_scale=v_scale)
    if q.dim() != 4:
        raise ValueError(f"paged_verify_attention: q {tuple(q.shape)} is "
                         "not (B, K1, Hq, D)")
    kv_lo, Hkv = kv_range(k_pool, kv_heads)
    q, D0, scale = _pad_q(q, k_pool, scale)
    pdtype = _check_pool_args("paged_verify_attention", q, k_pool, v_pool,
                              block_table, lengths, k_scale, v_scale, Hkv)
    B, K1, Hq, D = q.shape
    NB, BS, Hkp = k_pool.shape[:3]
    nbmax = block_table.shape[1]
    out = torch.empty((B, K1, Hq, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out[..., :D0]
    which = verify_body(q, _head_view(k_pool, kv_lo, Hkv), block_table)
    bps, nsplit, scratch = 0, 1, None
    if which == "split":
        bps, nsplit = split_plan(B, Hkv, nbmax, BS, sm_count(q.device))
        # every split writes its state here: acc (B, K1, Hq, nsplit, D),
        # then m and l (B, K1, Hq, nsplit), as K2's combine reads them
        if nsplit > 1:
            scratch = torch.empty(B * K1 * Hq * nsplit * (D + 2),
                                  dtype=torch.float32, device=q.device)
    fn = _build.function("repro_paged_verify_attention", _PV_ARGTYPES)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             _ptr(k_scale), _ptr(v_scale), block_table.data_ptr(),
             lengths.data_ptr(), out.data_ptr(), _ptr(scratch),
             DTYPES[q.dtype], pdtype, B, K1, Hq, Hkv, D, BS, NB, nbmax,
             int(window or 0), scale, VERIFY_BODIES.index(which), bps,
             nsplit, kv_lo, Hkp,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, f"paged_verify_attention ({which} body)")
    if nsplit > 1:           # the same call launched the combine kernel
        paged_decode_combine.launches += 1
    if k_scale is None:
        paged_verify_attention.launches += 1
    else:
        paged_verify_attention.k4_launches += 1
    paged_verify_attention.launches_by_body[which] += 1
    return out[..., :D0]


paged_verify_attention.launches = 0      # K3
paged_verify_attention.k4_launches = 0   # K4 (quantized pool)
paged_verify_attention.launches_by_body = dict.fromkeys(VERIFY_BODIES, 0)


def _check_head_shard(name, q_heads, k_pool, shard, kv_heads):
    """The rank's q heads must be whole query groups of the kv heads they
    read: its pool's kv-head shard (``paged_kv.head_shard_ok`` of the
    model makes them so), or the ``kv_heads`` range of a replicated
    pool. Returns that range."""
    lo, hkv = kv_range(k_pool, kv_heads)
    if shard.tp_size < 2 or q_heads % hkv:
        raise ValueError(
            f"{name}: {q_heads} query heads over {hkv} kv heads on a "
            f"{shard.tp_size}-rank model axis are not a head shard")
    return lo, hkv


def paged_decode_attention_headshard(q, k_pool, v_pool, block_table,
                                     lengths, *, shard, window=None,
                                     scale=None, k_scale=None, v_scale=None,
                                     kv_heads=None):
    """K2 (K4 over a quantized pool) on one rank of a head-sharded pool.

    The counterpart of JAX's ``shard_map`` wrapper of the same name: the
    pool is split by kv heads over the model axis (every rank owns its
    kv-head shard of every physical block; tables and lengths are the
    same host integers on every rank), so kv-head groups attend
    independently and the output needs no collective. In the port each
    rank is a process that holds only its shard: q (B, Hq / T, D) are
    this rank's query heads, the pools (NB, BS, Hkv / T, D) and scales
    (NB, BS, Hkv / T) its kv heads, and the call is the single-device
    ``paged_decode_attention`` on them (no new kernel; its launches count
    there). Returns this rank's (B, Hq / T, D).

    Where the kv heads do not divide T, the pool is whole on every rank
    (the replicated-KV layout) and ``kv_heads`` (first, count) names the
    kv heads this rank's query heads read: the kernel walks that range of
    the pool in place (``kv_range``), never a copy of it."""
    kv = _check_head_shard("paged_decode_attention_headshard", q.shape[-2],
                           k_pool, shard, kv_heads)
    return paged_decode_attention(q, k_pool, v_pool, block_table, lengths,
                                  window=window, scale=scale,
                                  k_scale=k_scale, v_scale=v_scale,
                                  kv_heads=kv)


def paged_verify_attention_headshard(q, k_pool, v_pool, block_table,
                                     lengths, *, shard, window=None,
                                     scale=None, k_scale=None, v_scale=None,
                                     kv_heads=None):
    """K3 (K4 over a quantized pool) on one rank of a head-sharded pool:
    the ``paged_decode_attention_headshard`` layout with a K1-row query
    block a sequence, q (B, K1, Hq / T, D). ``verify_body`` picks the body
    from this rank's shapes (the split plan runs over Hkv / T heads, or
    the ``kv_heads`` range of a replicated pool). Returns this rank's
    (B, K1, Hq / T, D)."""
    kv = _check_head_shard("paged_verify_attention_headshard", q.shape[-2],
                           k_pool, shard, kv_heads)
    return paged_verify_attention(q, k_pool, v_pool, block_table, lengths,
                                  window=window, scale=scale,
                                  k_scale=k_scale, v_scale=v_scale,
                                  kv_heads=kv)
