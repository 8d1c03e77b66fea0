"""Plain-torch versions of the hand-written kernels (the correctness
contract).

Each function mirrors its counterpart in ``repro/kernels/ref.py`` line
for line: the same masks, f32 softmax, the same fully-masked-row -> 0
rule, the same dequantization of an int8/fp8 pool (payload in f32 times
its per-(token, head) scale). The wrappers in ``kernels/*.py`` run these
for CPU tensors, and ``chip_smoke.py`` holds every CUDA kernel against
them on the card.
"""

from __future__ import annotations

import math

import torch


def flash_attention(q, k, v, *, causal=True, window=None, scale=None,
                    q_offset=0):
    """Reference attention.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D). GQA maps query head h to
    kv head h // (Hq // Hkv). ``window`` (if set) restricts attention to
    the last ``window`` positions (SWA). ``q_offset`` positions queries at
    absolute position q_offset + i. Returns (B, Hq, Sq, D) in q.dtype.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    kx = k.repeat_interleave(group, dim=1).float()
    vx = v.repeat_interleave(group, dim=1).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx) * scale
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    # Fully-masked rows (tiny windows) -> zeros, not NaN.
    probs = torch.where(mask.any(-1)[:, None], probs, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vx).to(q.dtype)


def _gather_dequant(pool, scale_pool, bt, B, S, Hkv, D):
    """Gather pool blocks into (B, S, Hkv, D) f32 sequences, applying the
    per-(token, head) dequant scales when the pool is quantized (JAX
    ref.py ``_gather_dequant``). A one-byte float pool is gathered as
    its bytes, then read back as fp8. A pool wider than D (a padded
    pool) is read at width D: its zero tail adds nothing, and dropping
    it makes the output bit-equal to the unpadded pool's."""
    if pool.dtype == torch.float8_e4m3fn:
        x = pool.view(torch.uint8)[bt].view(pool.dtype)
    else:
        x = pool[bt]
    x = x.reshape(B, S, Hkv, pool.shape[-1])[..., :D].float()
    if scale_pool is not None:
        x = x * scale_pool[bt].reshape(B, S, Hkv)[..., None]
    return x


def paged_decode_attention(q, k_pool, v_pool, block_table, lengths, *,
                           window=None, scale=None, k_scale=None,
                           v_scale=None):
    """Reference single-token decode attention over a block-paged cache.

    q: (B, Hq, D) — the query for the token at position ``lengths[b] - 1``.
    k_pool, v_pool: (NB, BS, Hkv, D) — shared pool of BS-token blocks.
    block_table: (B, NBMAX) int32 — per-sequence logical->physical block
    map (entries past a sequence's last block may hold any in-range id).
    lengths: (B,) int32 — valid tokens per sequence, including the
    current token, whose K/V must already be in the pool. ``window``
    restricts attention to the last ``window`` positions.
    ``k_scale`` / ``v_scale``: (NB, BS, Hkv) f32 dequant scales when the
    pool stores int8/fp8 payloads (None: a float pool).
    Returns (B, Hq, D) in q.dtype.
    """
    B, Hq, D = q.shape
    BS, Hkv = k_pool.shape[1], k_pool.shape[2]
    group = Hq // Hkv
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    S = block_table.shape[1] * BS
    bt = block_table.long()
    k = _gather_dequant(k_pool, k_scale, bt, B, S, Hkv, D)
    v = _gather_dequant(v_pool, v_scale, bt, B, S, Hkv, D)
    kx = k.transpose(1, 2).repeat_interleave(group, dim=1)   # (B, Hq, S, D)
    vx = v.transpose(1, 2).repeat_interleave(group, dim=1)
    logits = torch.einsum("bhd,bhsd->bhs", q.float(), kx) * scale
    kpos = torch.arange(S, device=q.device)[None, :]
    lens = lengths.long()[:, None]
    valid = kpos < lens
    if window is not None:
        valid = valid & (kpos >= lens - window)
    logits = logits.masked_fill(~valid[:, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(valid.any(-1)[:, None, None], probs, 0.0)
    return torch.einsum("bhs,bhsd->bhd", probs, vx).to(q.dtype)


def paged_verify_attention(q, k_pool, v_pool, block_table, lengths, *,
                           window=None, scale=None, k_scale=None,
                           v_scale=None):
    """Reference multi-query decode attention over a block-paged cache.

    The speculative-decode verify step (and suffix prefill): each
    sequence contributes K1 query rows for the positions
    ``lengths[b] + j`` (j = 0..K1-1), whose K/V must already be in the
    pool. Row j attends positions < ``lengths[b] + 1 + j`` (and, with a
    window, >= that limit minus ``window``), so row j equals
    ``paged_decode_attention`` at length ``lengths[b] + 1 + j``.

    q: (B, K1, Hq, D); pools: (NB, BS, Hkv, D); block_table: (B, NBMAX)
    int32; lengths: (B,) int32 tokens cached BEFORE the window. Positions
    past the table (``NBMAX * BS``) do not exist. A row that sees no key
    gives 0. ``k_scale`` / ``v_scale`` as in ``paged_decode_attention``.
    Returns (B, K1, Hq, D) in q.dtype.
    """
    B, K1, Hq, D = q.shape
    BS, Hkv = k_pool.shape[1], k_pool.shape[2]
    group = Hq // Hkv
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    S = block_table.shape[1] * BS
    bt = block_table.long()
    k = _gather_dequant(k_pool, k_scale, bt, B, S, Hkv, D)
    v = _gather_dequant(v_pool, v_scale, bt, B, S, Hkv, D)
    kx = k.transpose(1, 2).repeat_interleave(group, dim=1)   # (B, Hq, S, D)
    vx = v.transpose(1, 2).repeat_interleave(group, dim=1)
    logits = torch.einsum("bjhd,bhsd->bjhs", q.float(), kx) * scale
    kpos = torch.arange(S, device=q.device)[None, None, :]
    limit = lengths.long()[:, None, None] \
        + 1 + torch.arange(K1, device=q.device)[None, :, None]
    valid = kpos < limit                                     # (B, K1, S)
    if window is not None:
        valid = valid & (kpos >= limit - window)
    logits = logits.masked_fill(~valid[:, :, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(valid.any(-1)[:, :, None, None], probs, 0.0)
    return torch.einsum("bjhs,bhsd->bjhd", probs, vx).to(q.dtype)


def linear_scan(a, x, h0=None):
    """Reference diagonal linear recurrence h_t = a_t * h_{t-1} + x_t
    along axis 1. a, x: (B, T, D); h0: (B, D) or None (zeros).

    A sequential loop over T with the carry in f32 and each h_t stored
    in x's dtype: the order of the Pallas kernel body
    (``rglru_scan.py::_scan_kernel``), not the associative scan of JAX's
    ``ref.linear_scan`` (the two agree to f32 rounding, ~1e-7
    relative). The product and the sum round separately, as K5 rounds
    them, so on f32 inputs the kernel equals this bit for bit.
    """
    B, T, D = x.shape
    h = (torch.zeros((B, D), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    af, xf = a.float(), x.float()
    out = torch.empty((B, T, D), dtype=x.dtype, device=x.device)
    for t in range(T):
        h = af[:, t] * h + xf[:, t]
        out[:, t] = h
    return out
