"""Vectorized sampling step for the serving engine.

Counterpart of ``repro/launch/engine/sampling.py``: one call samples
every decode slot at once from per-slot parameter arrays (temperature /
top-k / top-p / seed / RNG-stream step). Greedy decoding and the top-k
and top-p masks follow the JAX package exactly.

Determinism contract: token t of a request is drawn from
``fold_in(PRNGKey(seed), t)`` with the Gumbel-max ``categorical``, as in
the JAX package, so sampled outputs do not depend on admission order,
slot index, co-batched requests, preemption history or device. The
random stream is JAX's own (threefry2x32 with
``jax_threefry_partitionable=True``, jax 0.9.0), written here in torch
integer ops: the key, ``fold_in`` and the random bits equal JAX's bit
for bit, and so do the uniforms; the Gumbel values ``-log(-log(u))``
may differ from XLA's by an ulp of ``log``.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(np.finfo(np.float32).tiny)


def fold_seed(seed: int) -> int:
    """Fold an arbitrary Python int seed into the non-negative int32
    range the param arrays carry. Pure masking — a given seed always
    selects the same stream."""
    return int(seed) & 0x7FFFFFFF


# ---------------------------------------------------------------------------
# threefry2x32 on int64 tensors holding uint32 words
# ---------------------------------------------------------------------------
#
# torch has no uint32 arithmetic that runs everywhere, so every word is
# an int64 in [0, 2**32): sums are masked back to 32 bits and rotations
# are built from a masked left shift and a right shift of a
# non-negative value.


def _rotl(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash (20 rounds) of JAX's ``prng.py``: key words
    ``(k1, k2)``, counter words ``(x1, x2)``, all broadcasting int64
    tensors (or ints) of uint32 values. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def prng_key(seeds, device=None):
    """``jax.random.PRNGKey(seed)`` as an int64 tensor ``(..., 2)``. With
    64-bit types off (JAX's default) a seed is an int32, so the key is
    ``(0, seed mod 2**32)`` for any integer seed or seed tensor."""
    seeds = torch.as_tensor(seeds, device=device).long() & _M32
    return torch.stack([torch.zeros_like(seeds), seeds], -1)


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: the key hashed with the counter
    ``(0, data)``. key: (..., 2); data: an int or a tensor broadcasting
    against ``key[..., 0]``."""
    data = torch.as_tensor(data, device=key.device).long() & _M32
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], 0, data)
    return torch.stack(torch.broadcast_tensors(b1, b2), -1)


def random_bits(key, shape):
    """``jax.random.bits(key, shape, uint32)`` on the partitionable path:
    the 64-bit iota over ``shape`` split into (hi, lo) counter words,
    hashed, and the two output words XORed. key: (..., 2) -> int64
    tensor ``key.shape[:-1] + shape`` of uint32 values."""
    shape = tuple(shape)
    n = torch.arange(int(np.prod(shape, dtype=np.int64)),
                     dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.shape[:-1] + (1,) * len(shape)
    b1, b2 = threefry2x32(key[..., 0].reshape(lead),
                          key[..., 1].reshape(lead), n >> 32, n & _M32)
    return b1 ^ b2


def uniform(key, shape):
    """``jax.random.uniform(key, shape, float32, minval=tiny, maxval=1)``
    (the uniforms under ``gumbel``): 23 random mantissa bits under the
    exponent of 1.0, minus 1, with 0 lifted to the smallest normal."""
    bits = random_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp_min(f - 1.0, _F32_TINY)


def gumbel(key, shape):
    """``jax.random.gumbel(key, shape, float32)`` (mode "low")."""
    return -torch.log(-torch.log(uniform(key, shape)))


def categorical(key, logits):
    """``jax.random.categorical(key, logits)`` over the last axis: the
    Gumbel-max draw, one key per row. key: (..., 2); logits: (..., V)
    f32 -> (...) int64."""
    return (gumbel(key, logits.shape[-1:]) + logits).argmax(-1)


def sample_tokens(logits, seeds, steps, temps, top_ks, top_ps):
    """logits (B, V) f32 + per-slot param tensors (B,) -> (B,) int32."""
    V = logits.shape[1]
    greedy = logits.argmax(-1)
    scaled = logits.float() / temps.float().clamp_min(1e-6)[:, None]
    desc = scaled.sort(-1, descending=True).values
    # top-k: logits below the k-th highest are cut (k <= 0 disables;
    # ties at the threshold survive — the standard caveat)
    k_eff = torch.where(top_ks <= 0, V, top_ks.clamp(1, V)).long()
    thresh_k = desc.gather(1, (k_eff - 1)[:, None])
    # top-p (nucleus): keep tokens whose PRECEDING cumulative mass is < p;
    # the argmax token is always kept
    probs = torch.softmax(desc, -1)
    kept = (probs.cumsum(-1) - probs) < top_ps.float().clamp(1e-6, 1.0)[:, None]
    thresh_p = desc.gather(1, (kept.sum(-1) - 1).clamp_min(0)[:, None])
    allowed = (scaled >= thresh_k) & (scaled >= thresh_p)
    masked = scaled.masked_fill(~allowed, float("-inf"))
    sampled = categorical(fold_in(prng_key(seeds), steps), masked)
    return torch.where(temps <= 0.0, greedy, sampled).int()


def fused_sample(logits, steps, samp):
    """Sampling tail of the fused decode step: the greedy argmax when
    ``samp`` is None (first-occurrence tie-break, as the host fast path
    in ``SlotSampler.sample``), else the full per-slot sampler, ``samp``
    being the (seeds, temps, top_ks, top_ps) tensors and ``steps`` the
    per-slot RNG-stream positions. Returns the (B,) int32 tokens on the
    logits' device; nothing is read back to the host."""
    if samp is None:
        return logits.argmax(-1).int()
    seeds, temps, top_ks, top_ps = samp
    return sample_tokens(logits, seeds, steps, temps, top_ks, top_ps)


def verify_accept(logits, tokens, num_drafts, seeds, steps, temps,
                  top_ks, top_ps):
    """Accept/resample rule for a speculative verify window.

    Every request's sampler is a deterministic function of its own
    stream (token t is drawn at stream position t from the target
    logits of that position), so rejection sampling collapses to
    exact-match coupling: compute the token the baseline sampler WOULD
    emit at each of the K1 window positions (greedy argmax, or the seeded
    draw at stream position ``steps + j``), accept the longest draft
    prefix matching those draws, and emit the first mismatching target
    as the correction (the row-K target is the bonus token when every
    draft matches). Outputs therefore equal non-speculative decoding.

    logits: (B, K1, V) f32, row j scoring the position after fed token
    j; tokens: (B, K1) int the fed window (row 0 the last accepted
    token, rows 1..K the drafts, padded past ``num_drafts``);
    num_drafts: (B,) usable drafts per slot; seeds, steps, temps,
    top_ks, top_ps: (B,) per-slot sampling parameters, ``steps`` the
    stream position at the window start. Returns (out_tokens (B, K1)
    int32, -1 past each row's emitted prefix; commit (B,) int32 in
    [1, K1], the fed tokens whose cache state is valid).
    """
    B, K1, V = logits.shape
    j = torch.arange(K1, device=logits.device)

    def rep(a):
        return a.repeat_interleave(K1)

    tgt = sample_tokens(logits.reshape(B * K1, V), rep(seeds),
                        (steps.long()[:, None] + j[None, :]).reshape(-1),
                        rep(temps), rep(top_ks), rep(top_ps))
    return _accept_targets(tgt.reshape(B, K1), tokens, num_drafts)


def verify_accept_greedy(logits, tokens, num_drafts):
    """All-greedy fast path of ``verify_accept`` (the serving default):
    the targets are plain argmax rows, no sort, masks or draws."""
    return _accept_targets(logits.argmax(-1).int(), tokens, num_drafts)


def _accept_targets(tgt, tokens, num_drafts):
    """Shared tail of the accept rule: the longest draft prefix matching
    the per-position targets, plus the correction/bonus target."""
    K1 = tgt.shape[1]
    jidx = torch.arange(K1, device=tgt.device)
    ok = (tokens[:, 1:] == tgt[:, :-1]) \
        & (jidx[None, :-1] < num_drafts[:, None])
    acc = ok.int().cumprod(1).sum(1)          # leading all-True prefix
    out = torch.where(jidx[None, :] <= acc[:, None], tgt.int(), -1)
    return out.int(), (acc + 1).int()


class SlotSampler:
    """Host-side mirror of the per-slot sampling parameter arrays.

    The backend installs a request's SamplingParams at admission and
    resets the slot at retirement; ``sample`` runs the step on the
    logits' device. ``steps[i]`` is the owning request's RNG-stream
    position and must be advanced by the backend after every draw.
    """

    def __init__(self, num_slots: int):
        self.temps = np.zeros((num_slots,), np.float32)
        self.top_ks = np.zeros((num_slots,), np.int32)
        self.top_ps = np.ones((num_slots,), np.float32)
        self.seeds = np.zeros((num_slots,), np.int32)
        self.steps = np.zeros((num_slots,), np.int32)

    def install(self, slot: int, sampling, n_sampled: int):
        """Install a request's SamplingParams at admission; ``n_sampled``
        is its RNG-stream position (nonzero on preemption resume)."""
        self.temps[slot] = sampling.temperature
        self.top_ks[slot] = sampling.top_k
        self.top_ps[slot] = sampling.top_p
        self.seeds[slot] = fold_seed(sampling.seed)
        self.steps[slot] = n_sampled

    def clear(self, slot: int):
        """Reset a retired/preempted slot to the default (greedy) row."""
        self.temps[slot] = 0.0
        self.top_ks[slot] = 0
        self.top_ps[slot] = 1.0
        self.seeds[slot] = 0
        self.steps[slot] = 0

    def _sample(self, logits, sl):
        if (self.temps[sl] <= 0.0).all():
            # all-greedy fast path (the default): only argmax leaves the
            # device, no sort/softmax/cumsum
            return logits.argmax(-1).int().cpu().numpy()
        args = self.device_args(logits.device, sl)
        return sample_tokens(logits, *args).cpu().numpy()

    def sample(self, logits):
        """logits: (B, V) tensor -> (B,) numpy int32 tokens."""
        return self._sample(logits, slice(None))

    def device_args(self, device, sl=slice(None)):
        """The (seeds, steps, temps, top_ks, top_ps) rows ``sl`` of the
        per-slot arrays as tensors on ``device``."""
        return [torch.from_numpy(a[sl]).to(device) for a in
                (self.seeds, self.steps, self.temps, self.top_ks,
                 self.top_ps)]

    def fused_args(self, steps):
        """The (steps, samp) pair of the fused decode step: ``samp`` is
        None on the all-greedy fast path (the step's argmax variant),
        else the host (seeds, temps, top_ks, top_ps) arrays. ``steps``
        overrides ``self.steps``: under overlap a slot whose token is
        still on the device sits one stream position ahead of the host
        mirror."""
        if (self.temps <= 0.0).all():
            return steps, None
        return steps, (self.seeds, self.temps, self.top_ks, self.top_ps)

    def sample_one(self, slot: int, row_logits) -> int:
        """Sample for ONE slot (prefill admission) from the parameters
        just installed — same streams as the batch path. row_logits:
        (1, V)."""
        return int(self._sample(row_logits, slice(slot, slot + 1))[0])
