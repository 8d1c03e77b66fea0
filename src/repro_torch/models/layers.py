"""Shared model layers: initializers, norms, MLPs, rotary embeddings.

Counterpart of ``repro/models/layers.py`` for the dense decoder-only
path: norms rmsnorm (``(1 + scale)`` convention), layernorm and
nonparametric (OLMo: LayerNorm without affine), the per-head group norm
of the xLSTM cells, gated and plain MLPs, half-split RoPE with f32
angles, Qwen2-VL's three-stream M-RoPE, whisper's sinusoidal position
table, the causal depthwise temporal conv in front of the RG-LRU
and the mLSTM, and the collectives of tensor parallelism (``tp_reduce``
after a row-parallel product, ``tp_gather_last`` of a rank's channels,
``vocab_parallel_lookup`` and ``tp_gather_vocab`` over a vocab-sharded
table and head, whole where the plan keeps the vocabulary whole). Params
are plain dicts of tensors.
Initializers take a ``lead`` shape so a scan group's stacked
``(count, ...)`` leaves are drawn in one call.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def truncated_normal_init(gen, shape, dtype, stddev=None, lead=()):
    """``stddev * truncated_normal(-2, 2)`` drawn from the
    ``torch.Generator`` ``gen`` on its device, shaped ``lead + shape``.

    The default stddev is ``1 / sqrt(shape[0])`` (fan-in), JAX's rule;
    the draw is in f32 and cast to ``dtype``, as JAX casts.
    """
    stddev = stddev if stddev is not None else 1.0 / math.sqrt(shape[0])
    t = torch.empty(tuple(lead) + tuple(shape), dtype=torch.float32,
                    device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(stddev).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(kind: str, dim: int, dtype, device, lead=()):
    shape = tuple(lead) + (dim,)
    if kind == "rmsnorm":                 # (1 + scale) convention
        return {"scale": torch.zeros(shape, dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones(shape, dtype=dtype, device=device),
                "bias": torch.zeros(shape, dtype=dtype, device=device)}
    if kind == "nonparametric":
        return {}
    raise ValueError(kind)


def apply_norm(kind: str, params, x, eps: float = 1e-6):
    dt = x.dtype
    xf = x.float()
    if kind == "rmsnorm":
        xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return (xf * (1.0 + params["scale"].float())).to(dt)
    if kind in ("layernorm", "nonparametric"):
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        xf = (xf - mu) * torch.rsqrt(var + eps)
        if kind == "layernorm":
            xf = xf * params["scale"].float() + params["bias"].float()
        return xf.to(dt)
    raise ValueError(kind)


def group_norm(x, scale, groups: int, eps: float = 1e-6):
    """Per-head group norm (the xLSTM cell output's): each of ``groups``
    slices of the last axis is normalized in f32, then scaled (no
    bias)."""
    dt = x.dtype
    lead, d = x.shape[:-1], x.shape[-1]
    xf = x.float().reshape(*lead, groups, d // groups)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    xf = ((xf - mu) * torch.rsqrt(var + eps)).reshape(*lead, d)
    return (xf * scale.float()).to(dt)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

_ACT = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def init_mlp(gen, d_model: int, d_ff: int, dtype, gated: bool = True,
             lead=()):
    p = {"w_up": truncated_normal_init(gen, (d_model, d_ff), dtype,
                                       lead=lead),
         "w_down": truncated_normal_init(gen, (d_ff, d_model), dtype,
                                         lead=lead)}
    if gated:
        p["w_gate"] = truncated_normal_init(gen, (d_model, d_ff), dtype,
                                            lead=lead)
    return p


def apply_mlp(params, x, activation: str = "silu", shard=None):
    """Gated (or plain) MLP. Under ``shard`` the weights are this rank's
    slices (w_up / w_gate column-parallel, w_down row-parallel) and the
    partial output is all-reduced over the model axis; pass ``shard``
    None for an MLP the plan keeps whole."""
    act = _ACT[activation]
    up = x @ params["w_up"]
    if "w_gate" in params:
        up = act(x @ params["w_gate"]) * up
    else:
        up = act(up)
    return tp_reduce(up @ params["w_down"], shard)


# ---------------------------------------------------------------------------
# Tensor-parallel collectives (``shard``: a launch.sharding.ShardCtx)
# ---------------------------------------------------------------------------


def _timed(shard, collective):
    """Run ``collective()``, counted in the engine's ``TPStats`` and,
    while its ``timing`` is a list, between two recorded CUDA events."""
    timing = shard.stats.timing
    if timing is None:
        return collective()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = collective()
    end.record()
    timing.append((start, end))
    return out


def tp_reduce(x, shard):
    """Sum a row-parallel product's partial outputs over the model axis
    (``all_reduce``, in x's dtype); identity without a mesh."""
    if shard is None or shard.tp_size == 1:
        return x
    x = x.contiguous()
    shard.stats.record(x.numel() * x.element_size())
    _timed(shard, lambda: torch.distributed.all_reduce(x, group=shard.group))
    return x


def split_over(shard, flag: str) -> bool:
    """True when the plan of ``shard`` splits the block named by ``flag``
    (a ``TPPlan`` field) over more than one rank."""
    return shard is not None and shard.tp_size > 1 \
        and bool(getattr(shard.plan, flag))


def rank_slice(n: int, shard) -> slice:
    """This rank's equal share of ``n`` (heads, channels), rank order."""
    k = n // shard.tp_size
    return slice(shard.tp_rank * k, (shard.tp_rank + 1) * k)


def rank_parts(t, parts: int, shard):
    """This rank's share of each of the ``parts`` equal parts of the last
    dim of ``t`` (a concatenation of per-head parts: mLSTM [c | z] and
    [i | f], sLSTM [z | i | f | o]), in part order: a head-aligned
    slice."""
    T, r = shard.tp_size, shard.tp_rank
    w = t.shape[-1] // parts
    return t.unflatten(-1, (parts, w)).narrow(
        -1, r * (w // T), w // T).flatten(-2)


def tp_gather_last(x, shard):
    """Concatenate each rank's slice of the last axis (rank order), so
    every rank holds the whole row: an all-gather, counted and timed like
    ``tp_reduce``; identity without a mesh. NCCL gathers into one tensor
    (a captured step can replay it); gloo takes the list form."""
    if shard is None or shard.tp_size == 1:
        return x
    x = x.contiguous()
    T = shard.tp_size
    shard.stats.record(x.numel() * x.element_size())
    if shard.backend == "nccl":
        out = x.new_empty((T,) + tuple(x.shape))
        _timed(shard, lambda: torch.distributed.all_gather_into_tensor(
            out, x, group=shard.group))
        return out.movedim(0, -2).reshape(*x.shape[:-1], T * x.shape[-1])
    parts = [torch.empty_like(x) for _ in range(T)]
    _timed(shard, lambda: torch.distributed.all_gather(parts, x,
                                                       group=shard.group))
    return torch.cat(parts, dim=-1)


def tp_gather_vocab(x, shard):
    """Each rank's vocab slice of the head's output made whole on every
    rank (``tp_gather_last``); identity where the plan keeps the
    vocabulary whole (it does not divide T: JAX's ``_fit``)."""
    return tp_gather_last(x, shard) if split_over(shard, "vocab") else x


def vocab_parallel_lookup(table, tokens, shard):
    """Rows of a vocab-sharded embedding table (Megatron-style): each
    rank gathers the ids in its vocab range [rank * V/T, (rank + 1) *
    V/T), zeros the rest, and an all-reduce assembles the embeddings (a
    sum with one nonzero term: exact). Without a mesh, or where the plan
    keeps the table whole, a plain gather."""
    if not split_over(shard, "vocab"):
        return table[tokens.long()]
    v_loc = table.shape[0]
    loc = tokens.long() - shard.tp_rank * v_loc
    valid = (loc >= 0) & (loc < v_loc)
    g = table[loc.clamp(0, v_loc - 1)].masked_fill(~valid[..., None], 0)
    return tp_reduce(g, shard)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def _rope_angles(positions, head_dim: int, theta: float):
    """positions (..., S) -> cos/sin (..., S, head_dim/2), f32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def _rotate(x, cos, sin):
    """Half-split rotation of x (B, S, H, D) by (B, S, 1, D/2) cos / sin
    in f32, cast back to x's dtype."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float = 10000.0):
    """Half-split RoPE. x: (B, S, H, D); positions: (B, S) or (S,)."""
    B, S, H, D = x.shape
    if positions.dim() == 1:
        positions = positions[None].expand(B, S)
    cos, sin = _rope_angles(positions, D, theta)       # (B, S, D/2)
    return _rotate(x, cos[:, :, None, :], sin[:, :, None, :])


def apply_mrope(x, positions3, sections, theta: float = 10000.0):
    """Qwen2-VL's multimodal RoPE. x: (B, S, H, D); positions3: (3, B, S)
    [t, h, w] ids. ``sections`` splits the D/2 frequency slots among the
    three streams (stream i's slots take ``theta ** (-j / (D/2))`` at
    its own positions); text tokens carry equal t / h / w ids, which
    reduces to ``apply_rope``."""
    D = x.shape[-1]
    half = D // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {half}")
    cos_parts, sin_parts = [], []
    start = 0
    for stream, sec in enumerate(sections):
        exps = torch.arange(start, start + sec, dtype=torch.float32,
                            device=x.device) / half
        ang = positions3[stream][..., None].float() * (1.0 / (theta ** exps))
        cos_parts.append(torch.cos(ang))
        sin_parts.append(torch.sin(ang))
        start += sec
    cos = torch.cat(cos_parts, -1)[:, :, None, :]
    sin = torch.cat(sin_parts, -1)[:, :, None, :]
    return _rotate(x, cos, sin)


def sinusoidal_embed(positions, d: int, dtype=torch.float32):
    """Whisper's sinusoidal embeddings at integer ``positions`` (...,) ->
    (..., d): the inverse frequencies ``exp(-log(10000) * i / max(d/2 -
    1, 1))``, the table selected by one ``where`` (sin on the first half
    of the lanes, cos on the second) in f32, then cast to ``dtype``.
    The f32 arguments are JAX's bit for bit; torch's exp / sin / cos
    may round the last bit otherwise than XLA's."""
    half = d // 2
    dim = torch.arange(half, dtype=torch.float32, device=positions.device)
    inv = torch.exp(-math.log(10000.0) * dim / max(half - 1, 1))
    idx = torch.arange(d, device=positions.device)
    ang = positions[..., None].float() * inv[idx % half]
    return torch.where(idx < half, torch.sin(ang),
                       torch.cos(ang)).to(dtype)


# ---------------------------------------------------------------------------
# Causal depthwise temporal conv (Griffin front conv)
# ---------------------------------------------------------------------------


def init_conv1d(gen, dim: int, width: int, dtype, lead=()):
    return {"w": truncated_normal_init(gen, (width, dim), dtype, stddev=0.1,
                                       lead=lead),
            "b": torch.zeros(tuple(lead) + (dim,), dtype=dtype,
                             device=gen.device)}


def conv_state_at(x, width, length):
    """Causal-conv carry state at a per-row offset.

    x: (B, S, D) conv INPUTS whose first ``length[b]`` positions are real
    (right-padded prefill); length: (B,) int. Returns the (B, width-1,
    D) tail ``apply_conv1d`` would carry had row b stopped at
    ``length[b]``: the last width-1 real inputs, zero-prefixed for rows
    shorter than the kernel.
    """
    B = x.shape[0]
    xc = torch.cat([x.new_zeros((B, width - 1) + x.shape[2:]), x], dim=1)
    idx = length.long()[:, None] \
        + torch.arange(width - 1, device=x.device)[None, :]
    return xc[torch.arange(B, device=x.device)[:, None], idx]


def apply_conv1d(params, x, state=None):
    """Causal depthwise conv. x: (B, S, D); state: (B, width-1, D) or
    None (zeros). Returns (y, new_state) where new_state holds the last
    width-1 inputs. The taps sum in x's dtype in JAX's order."""
    w = params["w"]
    width = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], width - 1) + x.shape[2:])
    xc = torch.cat([state, x], dim=1)
    S = x.shape[1]
    y = sum(xc[:, i:i + S] * w[i] for i in range(width))
    y = y + params["b"]
    return y.to(x.dtype), xc[:, -(width - 1):]
