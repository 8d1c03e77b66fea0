"""Mixture-of-Experts on one device: dropless for every serving path,
capacity-routed with the Switch aux loss for training.

Counterpart of ``repro/models/moe.py``'s single-device path
(``apply_moe``; JAX's prefill-with-cache, decode and verify run it with
``dropless=True``, its training forward with ``dropless=False``):

  1. route: softmax over an f32 router, the top-k experts a token and
     their weights renormalized to sum to 1;
  2. sort the (token, expert) assignments by expert id (stable) and
     number each one within its expert;
  3. gather the tokens into per-expert buffers of capacity C: C = T when
     dropless (no assignment ever drops: a token's k ids are distinct,
     so an expert holds at most T of them), else ceil(T k / E x 1.25)
     (``capacity``), and an assignment numbered C or later within its
     expert is dropped: it is written to one overflow row past the
     buffers, which nothing reads, and adds nothing to its token;
  4. the gated FFN of every expert as three batched matmuls;
  5. combine: each token sums its k weighted expert outputs.

Dropless, each token's output depends on its own hidden state only, not
on right padding, co-batched rows or batch width. Two choices keep the
port deterministic on the card where JAX leaves the order to XLA:

- ties in the top-k go to the lower expert index (JAX's ``lax.top_k``),
  by a stable descending sort rather than ``torch.topk``, which
  promises no tie order;
- the combine adds a token's k contributions one after another in
  ascending expert order, starting from zero, as XLA's scatter-add on
  the CPU walks the expert-sorted updates, instead of ``index_add_``,
  whose atomics on CUDA add in no fixed order. A dropped assignment
  adds an exact zero in its place.

Routing is a pure function of the layer's input, so a layer recomputed
in the backward pass (``RunCtx(remat="full")``) drops exactly the
assignments its first pass dropped.

Per-expert counts come from an integer ``scatter_add_`` of fixed size E
(``torch.bincount`` on CUDA reads its maximum back to the host, which a
captured decode step cannot do).

Expert parallelism (``apply_moe_sharded``, JAX's ``apply_moe_sharded`` in
mode ``"gather"`` with a data axis of 1): a rank holds E / T experts
(``w1`` / ``w3`` / ``w2`` split over the model axis by JAX's specs) and
the replicated router, routes every token as one device does, runs the
dropless FFN of its experts for every assignment routed to them (the
others go to an overflow row nothing reads) and adds its partial sums,
which an all-reduce makes whole. Every serving path runs it (prefill,
decode and verify alike: the port has no GSPMD to partition a prefill,
and dropless routing makes the result the same). Each token's partial
sum adds its contributions in expert order, as one device does, and an
expert of another rank adds an exact zero; with top-2 routing the
all-reduce of two ranks' partials is that one device's sum bit for bit.
Training stays single-device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import layers

_ACT = {"silu": F.silu, "gelu": lambda v: F.gelu(v, approximate="tanh")}


def init_moe(gen, cfg, dtype, lead=()):
    """Stacked ``lead + (...)`` expert params drawn from ``gen``: JAX's
    tree; the router f32 in any model dtype, w1 / w3 (E, d, ff) with
    stddev 1/sqrt(d), w2 (E, ff, d) with 1/sqrt(ff)."""
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff

    def experts(shape, fan_in):
        return layers.truncated_normal_init(
            gen, shape, dtype, stddev=1.0 / math.sqrt(fan_in), lead=lead)

    return {
        "router": layers.truncated_normal_init(gen, (d, E), torch.float32,
                                               lead=lead),
        "w1": experts((E, d, ff), d),
        "w3": experts((E, d, ff), d),
        "w2": experts((E, ff, d), ff),
    }


def route(x2d, router_w, top_k: int, stats: bool = False):
    """x2d: (T, d) -> (expert ids (T, k) int64, weights (T, k) f32
    summing to 1), the ids by descending probability, ties to the lower
    index. ``stats`` also returns JAX's Switch statistics: ``load`` (E,),
    the share of tokens whose first expert is e (no gradient), and
    ``imp`` (E,), the mean router probability of e."""
    probs = torch.softmax(x2d.float() @ router_w.float(), dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :top_k], topi[:, :top_k]
    topw = topw / topw.sum(-1, keepdim=True)
    if not stats:
        return topi, topw
    E = router_w.shape[-1]
    load = F.one_hot(topi[:, 0], E).float().mean(0)
    return topi, topw, load, probs.mean(0)


def aux_loss(load, imp):
    """The Switch load-balancing loss E * sum(load * imp)."""
    return load.shape[-1] * torch.sum(load * imp)


def capacity(cfg, T: int, dropless: bool) -> int:
    """Assignments each expert takes from T tokens: T when ``dropless``
    (nothing drops), else ceil(T k / E x capacity factor), at least 1
    (JAX's ``_capacity``, in its order of operations)."""
    if dropless:
        return T
    return max(1, int(math.ceil(T * cfg.moe_top_k / cfg.n_experts
                                * cfg.moe_capacity_factor)))


def dispatch_indices(topi, n_experts: int):
    """The expert-sorted assignment bookkeeping (JAX's
    ``_dispatch_indices``): (sorted expert id, sorted token id, the
    sort's order over the flat (T * k) assignments, position within the
    expert), each (T * k,)."""
    T, k = topi.shape
    flat_e = topi.reshape(-1)
    se, order = torch.sort(flat_e, stable=True)
    st = order // k                               # flat index t * k + j
    counts = torch.zeros(n_experts, dtype=flat_e.dtype,
                         device=flat_e.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=topi.device) - starts[se]
    return se, st, order, pos


def expert_ffn(xg, w1, w3, w2, activation="silu"):
    """xg: (E, C, d) through each expert's gated FFN."""
    h = _ACT[activation](torch.bmm(xg, w1)) * torch.bmm(xg, w3)
    return torch.bmm(h, w2)


def plan(x2d, router_w, cfg, dropless: bool):
    """The routing of x2d (T, d) and what capacity makes of it, as a
    dict: ``topi`` / ``topw`` (T, k), ``capacity`` C, and over the
    expert-sorted assignments (T * k,) ``st`` (their tokens), ``order``
    (``dispatch_indices``') and ``slot``, the buffer row expert * C +
    position within the expert. Unless ``dropless``: also ``load`` /
    ``imp`` (E,), ``kept`` (position < C), and a dropped assignment's
    ``slot`` is E * C, the overflow row."""
    E = cfg.n_experts
    C = capacity(cfg, x2d.shape[0], dropless)
    out = dict(zip(("topi", "topw", "load", "imp"),
                   route(x2d, router_w, cfg.moe_top_k,
                         stats=not dropless)))
    se, st, order, pos = dispatch_indices(out["topi"], E)
    out.update(capacity=C, st=st, order=order, se=se, slot=se * C + pos)
    if not dropless:
        out["kept"] = pos < C
        out["slot"] = torch.where(out["kept"], out["slot"], E * C)
    return out


def _moe(params, cfg, x, dropless, experts=None):
    """(out (B, S, d), the plan) of the MoE over x (B, S, d). ``experts``
    (first, count): the dropless FFN of those experts alone (the
    weights hold them), the rest of the assignments routed to an
    overflow row and adding zero: this rank's partial output (JAX's
    ``_moe_math(..., e_lo, e_local)``)."""
    B, S, d = x.shape
    x2d = x.reshape(-1, d)
    T, E, k = B * S, cfg.n_experts, cfg.moe_top_k
    r = plan(x2d, params["router"], cfg, dropless)
    C, slot, order = r["capacity"], r["slot"], r["order"]
    keep = r.get("kept")                 # None: every assignment counts
    if experts is not None:
        e_lo, E = experts
        keep = (r["se"] >= e_lo) & (r["se"] < e_lo + E)
        slot = torch.where(keep, slot - e_lo * C, E * C)
    rows = E * C if keep is None else E * C + 1
    xg = x2d.new_zeros((rows, d))
    xg[slot] = x2d[r["st"]]
    yg = expert_ffn(xg[:E * C].view(E, C, d), params["w1"], params["w3"],
                    params["w2"], cfg.activation).reshape(E * C, d)
    sw = r["topw"].reshape(-1)[order]
    if keep is None:
        contrib = yg[slot] * sw[:, None].to(yg.dtype)
    else:
        # an assignment not kept (dropped by capacity, or another rank's
        # expert) reads a real row (clamped) and adds zero: neither that
        # row nor its router weight gets a gradient from it
        contrib = torch.where(
            keep[:, None],
            yg[slot.clamp(max=E * C - 1)] * sw[:, None].to(yg.dtype), 0.0)
    # each token's k contributions in expert-sorted order: the sorted
    # positions of its assignments, ascending
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k, device=x.device)
    mine = inv.view(T, k).sort(dim=-1).values
    out = torch.zeros((T, d), dtype=yg.dtype, device=x.device)
    for j in range(k):
        out = out + contrib[mine[:, j]]
    return out.to(x.dtype).reshape(B, S, d), r


def apply_moe_train(params, cfg, x):
    """The training form, JAX's ``apply_moe(params, cfg, x,
    dropless=False)``: x (B, S, d) -> (out (B, S, d), aux scalar f32).
    Each expert takes ``capacity(cfg, B * S, False)`` assignments and
    the rest drop; ``aux`` is ``aux_loss(load, imp)``."""
    out, r = _moe(params, cfg, x, dropless=False)
    return out, aux_loss(r["load"], r["imp"])


def apply_moe(params, cfg, x):
    """Dropless MoE over x: (B, S, d) -> (B, S, d), every serving path's
    (JAX's ``dropless=True``; no statistics, no aux loss)."""
    return _moe(params, cfg, x, dropless=True)[0]


def apply_moe_sharded(params, cfg, x, shard):
    """The expert-parallel dropless MoE on one rank (JAX's
    ``apply_moe_sharded`` in mode ``"gather"`` with a data axis of 1):
    x (B, S, d), the same on every rank; ``params`` this rank's E / T
    experts and the whole router; its experts are ``shard.plan.experts``.
    Returns the whole (B, S, d) on every rank (one all-reduce)."""
    return layers.tp_reduce(
        _moe(params, cfg, x, dropless=True, experts=shard.plan.experts)[0],
        shard)
