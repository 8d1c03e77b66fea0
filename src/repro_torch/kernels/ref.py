"""Plain-torch versions of the hand-written kernels (the correctness
contract).

Each function mirrors its counterpart in ``repro/kernels/ref.py`` line
for line: the same masks, f32 softmax, the same fully-masked-row -> 0
rule, the same dequantization of an int8/fp8 pool (payload in f32 times
its per-(token, head) scale), the stencils' term order. The per-lane
versions of K8 (``vrp_dot_lanes``, ``vrp_sum_lanes``) follow the Pallas
bodies instead, whose lanes are the kernel's output. The wrappers in ``kernels/*.py`` run these
for CPU tensors, and ``chip_smoke.py`` holds every CUDA kernel against
them on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _attention_logits(q, k, causal, window, scale, q_offset):
    """Scaled f32 scores (B, Hq, Sq, Skv) with masked keys at -inf, the
    (Sq, Skv) mask and k in f32 repeated over each GQA group."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    kx = k.repeat_interleave(Hq // Hkv, dim=1).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx) * scale
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return logits.masked_fill(~mask, float("-inf")), mask, kx


def flash_attention(q, k, v, *, causal=True, window=None, scale=None,
                    q_offset=0, return_lse=False):
    """Reference attention.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D). GQA maps query head h to
    kv head h // (Hq // Hkv). ``window`` (if set) restricts attention to
    the last ``window`` positions (SWA). ``q_offset`` positions queries at
    absolute position q_offset + i. Returns (B, Hq, Sq, D) in q.dtype;
    with ``return_lse`` also each row's f32 log-sum-exp of its scaled
    scores (B, Hq, Sq), -inf for a row that sees no key (K1's lse output,
    what the backward pass recomputes the probabilities from).
    """
    group = q.shape[1] // k.shape[1]
    logits, mask, _ = _attention_logits(q, k, causal, window, scale,
                                        q_offset)
    vx = v.repeat_interleave(group, dim=1).float()
    probs = torch.softmax(logits, dim=-1)
    # Fully-masked rows (tiny windows) -> zeros, not NaN.
    probs = torch.where(mask.any(-1)[:, None], probs, 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vx).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=None,
                        scale=None):
    """Gradients (dq, dk, dv) of ``flash_attention`` for the output
    gradient ``do``, FlashAttention-2's formulas in f32: P = exp(S *
    scale - lse) recomputed from the forward's ``lse`` (0 where a key is
    masked or the row sees none), delta = rowsum(do * o), dV = P^T dO,
    dS = P * (dO V^T - delta), dQ = dS K * scale, dK = dS^T Q * scale,
    dK and dV summed over each GQA group. A row that sees no key gets
    zero gradients (autograd of the forward above would give NaN there).
    Returned in the inputs' dtypes and shapes: (B, Hq, Sq, D) and
    (B, Hkv, Skv, D), contiguous."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    logits, mask, kx = _attention_logits(q, k, causal, window, scale, 0)
    lse = lse.float()[..., None]
    probs = torch.where(mask & torch.isfinite(lse),
                        torch.exp(logits - lse), 0.0)
    dof = do.float()
    vx = v.repeat_interleave(group, dim=1).float()
    delta = (dof * o.float()).sum(-1, keepdim=True)
    dv = torch.einsum("bhqk,bhqd->bhkd", probs, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vx)
    ds = probs * (dp - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kx) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dk = dk.reshape(B, Hkv, group, Skv, D).sum(2)
    dv = dv.reshape(B, Hkv, group, Skv, D).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)   # csrc kMaskValue


def paged_decode_combine(m, l, acc, out_dtype):
    """Merge the split-K partial softmax states of a decode step.

    m, l: (B, Hq, nsplit) f32, each split's running max of its scaled
    scores and sum of exp(score - m); acc: (B, Hq, nsplit, D) f32, its
    unnormalised sum of exp(score - m) * v. A split that saw no key
    holds m = ``MASK_VALUE`` (finite), l = 0, acc = 0. Returns
    sum_s w_s acc_s / sum_s w_s l_s with w_s = exp(m_s - max_s m_s), in
    ``out_dtype``; a row whose splits all saw no key gives 0.
    """
    w = torch.exp(m - m.amax(-1, keepdim=True))
    den = (w * l).sum(-1)
    out = (w[..., None] * acc).sum(-2)
    return (out / torch.where(den == 0, 1.0, den)[..., None]).to(out_dtype)


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


def paged_verify_split_partials(q, k_pool, v_pool, block_table, lengths,
                                bps, nsplit, *, window=None, scale=None,
                                k_scale=None, v_scale=None):
    """The partial softmax states of K3's split body: the keys of each
    sequence cut into ``nsplit`` splits of ``bps`` logical blocks
    (``kernels/paged_attention.split_plan``), and each query row's state
    over the keys of one split that it can see, as in
    ``paged_verify_attention``.

    Returns m, l (B, K1, Hq, nsplit) and the unnormalised acc (B, K1,
    Hq, nsplit, D), all f32: a split's max of the scaled scores, its sum
    of exp(score - m) and of exp(score - m) * v. A split that a row
    sees no key of holds m = ``MASK_VALUE``, l = 0, acc = 0.
    ``paged_decode_combine`` of the three, over the rows (B, K1 * Hq),
    gives ``paged_verify_attention``.
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
    m = torch.full((B, K1, Hq, nsplit), MASK_VALUE, device=q.device)
    l = torch.zeros((B, K1, Hq, nsplit), device=q.device)
    acc = torch.zeros((B, K1, Hq, nsplit, D), device=q.device)
    for s in range(nsplit):
        mask = (valid & (kpos // (bps * BS) == s))[:, :, None, :]
        part = logits.masked_fill(~mask, float("-inf"))
        seen = mask.any(-1)                                  # (B, K1, 1)
        ms = torch.where(seen, part.amax(-1), MASK_VALUE)    # (B, K1, Hq)
        p = torch.exp(part - ms[..., None])                  # 0 where masked
        m[..., s], l[..., s] = ms, p.sum(-1)
        acc[..., s, :] = torch.einsum("bjhs,bhsd->bjhd", p, vx)
    return m, l, acc


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


def scan_grads(a, h, h0, dh):
    """(da, dx, dh0) of ``linear_scan`` from the backward recurrence's
    dh (B, T, D): dx = dh, da_t = dh_t h_{t-1} with h_{-1} = h0 (or 0)
    in f32, cast to a's dtype, dh0 = a_0 dh_0 in f32."""
    B, _, D = dh.shape
    first = (torch.zeros((B, 1, D), dtype=h.dtype, device=h.device)
             if h0 is None else h0[:, None].to(h.dtype))
    h_prev = torch.cat([first, h[:, :-1]], dim=1)
    da = (dh.float() * h_prev.float()).to(a.dtype)
    return da, dh, a[:, 0].float() * dh[:, 0].float()


def linear_scan_bwd(a, h, g, h0=None):
    """Gradients of ``linear_scan`` for the output gradient ``g`` (B, T,
    D), given its output ``h``: the recurrence run backwards,
    dh_t = g_t + a_{t+1} * dh_{t+1} (a sequential loop, the carry in f32
    and each dh_t stored in h's dtype, the product and the sum rounded
    apart as in ``linear_scan``), then ``scan_grads``. Returns (da, dx,
    dh0) in a's, h's and f32 dtypes."""
    B, T, D = g.shape
    af, gf = a.float(), g.float()
    dh = torch.zeros((B, D), dtype=torch.float32, device=g.device)
    dhs = torch.empty((B, T, D), dtype=h.dtype, device=g.device)
    for t in range(T - 1, -1, -1):
        a_next = af[:, t + 1] if t + 1 < T else torch.zeros_like(dh)
        dh = a_next * dh + gf[:, t]
        dhs[:, t] = dh
    return scan_grads(a, h, h0, dhs)


# ---------------------------------------------------------------------------
# STX matmul (K6)
# ---------------------------------------------------------------------------


def matmul(x, w, out_dtype=None):
    """(..., K) @ (K, N), f32 accumulation, cast to ``out_dtype``
    (default x's)."""
    out = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    return out.to(out_dtype or x.dtype)


# ---------------------------------------------------------------------------
# STX stencils (K7): the SPU workload, structured grid, fixed pattern
# ---------------------------------------------------------------------------


def _stencil(x, weights, dims):
    """Weighted 3^dims stencil over x's last ``dims`` axes, zero
    boundary: terms accumulated from 0 in JAX's order (the first axis
    offset outermost), each product and sum rounded on its own. bf16 x
    accumulates in f32 (the weights' dtype), cast back once."""
    acc_dtype = torch.promote_types(x.dtype, weights.dtype)
    xp = F.pad(x.to(acc_dtype), (1, 1) * dims)
    grid = x.shape[-dims:]
    out = torch.zeros(x.shape, dtype=acc_dtype, device=x.device)
    for offs in np.ndindex(*(3,) * dims):
        sl = xp[(...,) + tuple(slice(o, o + n) for o, n in zip(offs, grid))]
        out = out + weights[offs] * sl
    return out.to(x.dtype)


def stencil2d(x, weights):
    """3x3 weighted stencil on (..., M, N); zero boundary (halo = 0)."""
    return _stencil(x, weights, 2)


def stencil3d(x, weights):
    """3x3x3 weighted stencil on (..., D, M, N); zero boundary."""
    return _stencil(x, weights, 3)


def seven_point_weights(dtype=torch.float32, device=None):
    """Classic 7-point Laplacian weights as a 3x3x3 mask."""
    w = np.zeros((3, 3, 3), dtype=np.float64)
    w[1, 1, 1] = -6.0
    for d in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0), (1, 1, 2)):
        w[d] = 1.0
    return torch.tensor(w, dtype=dtype, device=device)


def five_point_weights(dtype=torch.float32, device=None):
    w = np.zeros((3, 3), dtype=np.float64)
    w[1, 1] = -4.0
    w[0, 1] = w[2, 1] = w[1, 0] = w[1, 2] = 1.0
    return torch.tensor(w, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# VRP compensated reductions (K8; double-word = 2-term expansion)
# ---------------------------------------------------------------------------

LANES = 1024                     # the (8, 128) lane tile
_F32_SPLITTER = float(2**12 + 1)


def double_word(dtype):
    """The K=2 expansion environment in ``dtype`` (float32 / float64)."""
    from ..core.precision import PrecisionEnv

    return PrecisionEnv(compute_terms=2,
                        base_dtype=str(dtype).removeprefix("torch."))


def vrp_dot(x, y):
    """Double-word dot oracle via core.vrp at K=2 in the input dtype ->
    (2,) expansion [hi, lo]."""
    from ..core import vrp

    return vrp.dot(x, y, double_word(x.dtype))


def vrp_sum(x):
    from ..core import vrp

    return vrp.sum_floats(x.reshape(-1), double_word(x.dtype))


def _lane_blocks(x):
    """Flat x zero-padded to whole lane tiles -> (n / 1024, 8, 128)."""
    nb = -(-x.shape[0] // LANES)
    return F.pad(x, (0, nb * LANES - x.shape[0])).reshape(nb, 8, 128)


def _lanes(blocks, step):
    """Walk the (8, 128) lanes' Neumaier pairs over the blocks in order
    (the Pallas grid's sequential axis) -> (8, 128, 2)."""
    from ..core.vrp import two_sum

    s = torch.zeros((8, 128), dtype=torch.float32, device=blocks[0].device)
    c = torch.zeros_like(s)
    for args in zip(*blocks):
        val, e = step(*args)
        s, err = two_sum(s, val)
        c = c + err
        if e is not None:
            c = c + e   # product error is already second-order
    return torch.stack([s, c], dim=-1)


def vrp_dot_lanes(x, y):
    """Per-lane compensated dot of flat f32 x, y -> (8, 128, 2): lane l
    holds elements l, l + 1024, ... (``vrp_dot.py::_dot_kernel``):
    two_prod(x, y) -> (p, e), two_sum(s, p) -> (s, err), c += err,
    c += e. The tail past len(x) reads as zeros."""
    from ..core.vrp import two_prod

    return _lanes((_lane_blocks(x), _lane_blocks(y)),
                  lambda a, b: two_prod(a, b, splitter=_F32_SPLITTER))


def vrp_sum_lanes(x):
    """Per-lane compensated sum of flat f32 x -> (8, 128, 2)
    (``vrp_dot.py::_sum_kernel``)."""
    return _lanes((_lane_blocks(x),), lambda a: (a, None))


def vrp_finalize(lanes):
    """Compensated tree over per-lane (8, 128, 2) partials -> (2,)
    (JAX ops.py ``_finalize_expansion``: ``core.vrp.tree_sum`` of the
    1024 pairs at K = 2, in torch ops on the lanes' device)."""
    from ..core import vrp

    return vrp.tree_sum(lanes.reshape(-1, 2), double_word(lanes.dtype))


def vrp_finalize_pairs(lanes):
    """The finalize kernel's order as a scalar loop over float32 values
    (``csrc/vrp_dot.cu::finalize_kernel``): 10 levels, each merging the
    pairs (2k, 2k + 1) of the level before (lane r * 128 + c first) by
    ``vrp.add`` at K = 2, the four terms through two bubble passes of
    (t_i, t_{i+1}) = two_sum(t_i, t_{i+1}) for i = 2, 1, 0 -> (2,)."""
    f32 = np.float32

    def two_sum(a, b):
        s = f32(a + b)
        a1 = f32(s - b)
        b1 = f32(s - a1)
        return s, f32(f32(a - a1) + f32(b - b1))

    pairs = [tuple(p) for p in lanes.reshape(-1, 2).cpu().numpy()]
    while len(pairs) > 1:
        level = []
        for k in range(0, len(pairs), 2):
            t = [*pairs[k], *pairs[k + 1]]
            for _ in range(2):
                for i in (2, 1, 0):
                    t[i], t[i + 1] = two_sum(t[i], t[i + 1])
            level.append((t[0], t[1]))
        pairs = level
    return torch.tensor(np.array(pairs[0], dtype=f32))
