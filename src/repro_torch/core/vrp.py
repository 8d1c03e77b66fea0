"""VRP tile — variable-precision arithmetic via floating-point expansions.

Counterpart of ``repro/core/vrp.py``, function for function. A value is
an unevaluated sum ``x = t_0 + t_1 + ... + t_{K-1}`` of K machine floats
of decreasing magnitude, held as a tensor with a trailing axis of length
K (term 0 = highest magnitude). Every building block is an error-free
transformation (``two_sum``, ``two_prod``): precision is lost only when
an expansion is truncated back to K terms, and K plays the role of the
VRP chunk count (cost ~O(K^2)).

Each torch op here stands for one JAX op and rounds once, in the same
order, so on the same inputs the results equal the JAX package's bit for
bit, on the CPU and on the card. Products and sums are never fused:
no ``alpha=`` argument, no ``addcmul``. Everything runs on the device of
its inputs.
"""

from __future__ import annotations

import torch

from .precision import PrecisionEnv, get_env

# ---------------------------------------------------------------------------
# Error-free transformations
# ---------------------------------------------------------------------------


def two_sum(a, b):
    """Knuth's branch-free TwoSum: s + e == a + b exactly."""
    s = a + b
    a1 = s - b
    b1 = s - a1
    da = a - a1
    db = b - b1
    return s, da + db


def fast_two_sum(a, b):
    """Dekker's FastTwoSum; exact when |a| >= |b|."""
    s = a + b
    return s, b - (s - a)


def _split(a, splitter):
    """Veltkamp split: a == hi + lo with hi, lo half-width."""
    c = splitter * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b, *, splitter=float(2**27 + 1)):
    """Dekker's TwoProd: p + e == a * b exactly (no FMA required)."""
    p = a * b
    ah, al = _split(a, splitter)
    bh, bl = _split(b, splitter)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# ---------------------------------------------------------------------------
# Expansion construction / destruction
# ---------------------------------------------------------------------------


def from_float(x, env: PrecisionEnv):
    """Promote a plain array to a K-term expansion (value in term 0)."""
    env = get_env(env)
    x = torch.as_tensor(x, dtype=env.dtype)
    tail = torch.zeros(x.shape + (env.K - 1,), dtype=env.dtype,
                       device=x.device)
    return torch.cat([x[..., None], tail], dim=-1)


def to_float(e):
    """Collapse an expansion to its base dtype (sum low terms first)."""
    acc = e[..., -1]
    for i in range(e.shape[-1] - 2, -1, -1):
        acc = acc + e[..., i]
    return acc


def zeros(shape, env: PrecisionEnv, device=None):
    env = get_env(env)
    return torch.zeros(tuple(shape) + (env.K,), dtype=env.dtype,
                       device=device)


# ---------------------------------------------------------------------------
# Renormalization (the VRP "normalization at full width" stage)
# ---------------------------------------------------------------------------


def _vecsum_pass(terms):
    """One VecSum distillation pass over the trailing axis.

    Sequentially applies (t[i], t[i+1]) <- two_sum(t[i], t[i+1]) for
    i = M-2 .. 0, pushing dominant mass to index 0 and errors downward
    (JAX's reverse ``lax.scan``, as a loop over the terms).
    """
    M = terms.shape[-1]
    carry = terms[..., M - 1]
    errs = [None] * (M - 1)
    for i in range(M - 2, -1, -1):
        carry, errs[i] = two_sum(terms[..., i], carry)
    # errs[i] is the error emitted when t[i] absorbed the running sum; it
    # belongs at slot i+1. Slot 0 is the final running sum.
    return torch.stack([carry] + errs, dim=-1)


def renormalize(terms, K: int, passes: int | None = None):
    """Compress an (..., M)-term sum into a (..., K)-term expansion.

    Uses repeated VecSum distillation passes (Ogita–Rump–Oishi). Every
    two_sum is exact, so the *exact* value of the sum is invariant; only
    the final truncation to K terms rounds. ``passes`` trades accuracy
    against latency.
    """
    M = terms.shape[-1]
    if M <= K:
        pad = torch.zeros(terms.shape[:-1] + (K - M,), dtype=terms.dtype,
                          device=terms.device)
        terms = torch.cat([terms, pad], dim=-1)
        M = K
    if passes is None:
        passes = 2 if K <= 2 else 3
    if M <= 6:
        # Small merges: unrolled bubble passes.
        cols = [terms[..., i] for i in range(M)]
        for _ in range(passes):
            for i in range(M - 2, -1, -1):
                cols[i], cols[i + 1] = two_sum(cols[i], cols[i + 1])
        return torch.stack(cols[:K], dim=-1)
    for _ in range(passes):
        terms = _vecsum_pass(terms)
    return terms[..., :K]


# ---------------------------------------------------------------------------
# Arithmetic
# ---------------------------------------------------------------------------


def add(x, y, env: PrecisionEnv):
    env = get_env(env)
    merged = torch.cat(torch.broadcast_tensors(x, y), dim=-1)
    return renormalize(merged, env.K)


def sub(x, y, env: PrecisionEnv):
    return add(x, -y, env)


def add_float(x, s, env: PrecisionEnv):
    """Expansion + plain float (Shewchuk grow-expansion, vectorized)."""
    env = get_env(env)
    s = torch.broadcast_to(
        torch.as_tensor(s, dtype=env.dtype, device=x.device), x.shape[:-1])
    merged = torch.cat([x, s[..., None]], dim=-1)
    return renormalize(merged, env.K)


def scale(x, s, env: PrecisionEnv):
    """Expansion times plain float — exact partial products, then renorm."""
    env = get_env(env)
    s = torch.as_tensor(s, dtype=env.dtype, device=x.device)
    p, e = two_prod(x, s[..., None], splitter=env.splitter)
    return renormalize(torch.cat([p, e], dim=-1), env.K)


def mul(x, y, env: PrecisionEnv):
    """Expansion times expansion.

    Keeps partial products t_i * u_j with i + j <= K (magnitude-ordered
    truncation — the chunk-iteration schedule of the VPFPU multiplier).
    """
    env = get_env(env)
    K = env.K
    x, y = torch.broadcast_tensors(x, y)
    Kx, Ky = x.shape[-1], y.shape[-1]
    # All partial products at once (TwoProd over the K x K outer grid),
    # magnitude-truncated at order K: keep p where i+j <= K and e where
    # i+j < K. Zeroed-out entries are exact no-ops in renorm.
    p, e = two_prod(x[..., :, None], y[..., None, :], splitter=env.splitter)
    order = (torch.arange(Kx, device=x.device)[:, None]
             + torch.arange(Ky, device=x.device)[None, :])
    p = torch.where(order <= K, p, 0.0)
    e = torch.where(order < K, e, 0.0)
    parts = torch.cat([p.reshape(p.shape[:-2] + (Kx * Ky,)),
                       e.reshape(e.shape[:-2] + (Kx * Ky,))], dim=-1)
    return renormalize(parts, env.K)


def _const(val, like, env):
    return from_float(torch.full(like.shape[:-1], val, dtype=env.dtype,
                                 device=like.device), env)


def reciprocal(y, env: PrecisionEnv):
    """Newton–Raphson reciprocal: r <- r * (2 - y*r); quadratic/iteration."""
    env = get_env(env)
    iters = env.newton_iters or max(1, (env.K - 1).bit_length() + 1)
    r = from_float(1.0 / to_float(y), env)
    two = _const(2.0, y, env)
    for _ in range(iters):
        r = mul(r, sub(two, mul(y, r, env), env), env)
    return r


def div(x, y, env: PrecisionEnv):
    return mul(x, reciprocal(y, env), env)


def sqrt(x, env: PrecisionEnv):
    """sqrt via Newton on r ~ 1/sqrt(x): r <- r*(3 - x*r^2)/2, then x*r."""
    env = get_env(env)
    iters = env.newton_iters or max(1, (env.K - 1).bit_length() + 1)
    r = from_float(1.0 / torch.sqrt(to_float(x)), env)
    three = _const(3.0, x, env)
    half = torch.tensor(0.5, dtype=env.dtype, device=x.device)
    for _ in range(iters):
        xr2 = mul(x, mul(r, r, env), env)
        r = scale(mul(r, sub(three, xr2, env), env), half, env)
    return mul(x, r, env)


# ---------------------------------------------------------------------------
# Reductions (tree-structured, vectorized — the long-vector discipline)
# ---------------------------------------------------------------------------


def tree_sum(x, env: PrecisionEnv, axis: int = 0):
    """Sum an array of expansions along ``axis`` by pairwise vp-adds.

    log2(n) vectorized levels; each level is an exact merge + renormalize,
    so worst-case error is ~log2(n) truncations instead of n.
    """
    env = get_env(env)
    x = torch.movedim(x, axis, 0)
    n = x.shape[0]
    while n > 1:
        half = n // 2
        lo, hi = x[: 2 * half: 2], x[1: 2 * half: 2]
        merged = add(lo, hi, env)
        if n % 2:
            merged = torch.cat([merged, x[2 * half:]], dim=0)
        x = merged
        n = x.shape[0]
    return x[0]


def sum_floats(x, env: PrecisionEnv, axis: int = 0):
    """Extended-precision sum of a *plain* float array (cascaded)."""
    env = get_env(env)
    x = torch.movedim(torch.as_tensor(x, dtype=env.dtype), axis, 0)
    return tree_sum(from_float(x, env), env)


def dot(x, y, env: PrecisionEnv):
    """Extended-precision dot of two plain vectors (Ogita–Rump–Oishi DotK).

    Elementwise TwoProd (exact), then a compensated tree sum of the 2n
    partials: the VBLAS ``dot`` of the paper.
    """
    env = get_env(env)
    x = torch.as_tensor(x, dtype=env.dtype)
    y = torch.as_tensor(y, dtype=env.dtype)
    p, e = two_prod(x, y, splitter=env.splitter)
    partials = torch.stack([p, e], dim=-1)  # (n, 2) exact products
    partials = renormalize(partials, env.K)
    return tree_sum(partials, env)


def dot_vp(x, y, env: PrecisionEnv):
    """Dot of two expansion vectors (n, K) x (n, K)."""
    env = get_env(env)
    return tree_sum(mul(x, y, env), env)


def matvec(A, x, env: PrecisionEnv):
    """Plain matrix (m, n) times expansion vector (n, K) -> (m, K).

    Exact per-element products against every expansion term, then a
    compensated tree reduction along n.
    """
    env = get_env(env)
    A = torch.as_tensor(A, dtype=env.dtype)
    p, e = two_prod(A[..., None], x[None, ...], splitter=env.splitter)
    merged = renormalize(torch.cat([p, e], dim=-1), env.K)  # (m, n, K)
    return tree_sum(merged, env, axis=1)
