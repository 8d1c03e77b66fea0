"""Mixture-of-Experts on one device, dropless, for every serving path.

Counterpart of ``repro/models/moe.py``'s single-device path
(``apply_moe`` with ``dropless=True``, which JAX's prefill-with-cache,
decode and verify all use):

  1. route: softmax over an f32 router, the top-k experts a token and
     their weights renormalized to sum to 1;
  2. sort the (token, expert) assignments by expert id (stable) and
     number each one within its expert;
  3. gather the tokens into per-expert buffers of capacity C = T (no
     assignment ever drops: a token's k ids are distinct, so an expert
     holds at most T of them);
  4. the gated FFN of every expert as three batched matmuls;
  5. combine: each token sums its k weighted expert outputs.

Each token's output thus depends on its own hidden state only, not on
right padding, co-batched rows or batch width. Two choices keep the
port deterministic on the card where JAX leaves the order to XLA:

- ties in the top-k go to the lower expert index (JAX's ``lax.top_k``),
  by a stable descending sort rather than ``torch.topk``, which
  promises no tie order;
- the combine adds a token's k contributions one after another in
  ascending expert order, starting from zero, as XLA's scatter-add on
  the CPU walks the expert-sorted updates, instead of ``index_add_``,
  whose atomics on CUDA add in no fixed order.

Per-expert counts come from an integer ``scatter_add_`` of fixed size E
(``torch.bincount`` on CUDA reads its maximum back to the host, which a
captured decode step cannot do). The Switch load-balancing statistics
and the capacity-factor drop path are training's (ROADMAP queue 1,
'Training of xLSTM, MoE and enc-dec'); the expert-parallel
``apply_moe_sharded`` is queue 1's 'multi-device'.
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


def route(x2d, router_w, top_k: int):
    """x2d: (T, d) -> (expert ids (T, k) int64, weights (T, k) f32
    summing to 1), the ids by descending probability, ties to the lower
    index."""
    probs = torch.softmax(x2d.float() @ router_w.float(), dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :top_k], topi[:, :top_k]
    return topi, topw / topw.sum(-1, keepdim=True)


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


def apply_moe(params, cfg, x):
    """Dropless MoE over x: (B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    x2d = x.reshape(-1, d)
    T, E, k = B * S, cfg.n_experts, cfg.moe_top_k
    C = T                                         # dropless capacity
    topi, topw = route(x2d, params["router"], k)
    se, st, order, pos = dispatch_indices(topi, E)
    slot = se * C + pos
    xg = x2d.new_zeros((E * C, d))
    xg[slot] = x2d[st]
    yg = expert_ffn(xg.view(E, C, d), params["w1"], params["w3"],
                    params["w2"], cfg.activation).reshape(E * C, d)
    sw = topw.reshape(-1)[order]
    contrib = yg[slot] * sw[:, None].to(yg.dtype)
    # each token's k contributions in expert-sorted order: the sorted
    # positions of its assignments, ascending
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k, device=x.device)
    mine = inv.view(T, k).sort(dim=-1).values
    out = torch.zeros((T, d), dtype=yg.dtype, device=x.device)
    for j in range(k):
        out = out + contrib[mine[:, j]]
    return out.to(x.dtype).reshape(B, S, d)
