"""Recurrent blocks: xLSTM's mLSTM / sLSTM and RecurrentGemma's RG-LRU.

Counterpart of ``repro/models/ssm.py``. mLSTM runs its prefill in the
chunkwise-parallel stabilized form (``mlstm_chunkwise``) and its decode
as the O(1)-state step (``mlstm_step``); the two are algebraically
equal, and every constant that decides whether a padded tail moves the
carried state is JAX's (chunk padding ig = -1e30 and fg = 30, m starting
at -1e30, gate freezing at +-1e30). sLSTM has a true recurrent matrix
and runs one cell a token. Both are plain torch, as JAX computes them in
plain jnp (no Pallas kernel).

The RG-LRU is a gated diagonal linear recurrence whose prefill scan runs
through kernel K5 (``kernels/ops.rglru_scan``; in training,
``apply_rglru_block``, K5 under autograd, its backward K5 run on the
reversed sequence) and whose decode is one O(1)-state step in plain
torch, as JAX computes it outside any Pallas
kernel. The decay parameter ``lam`` and the carried states (RG-LRU
``h``; mLSTM ``C``, ``n``, ``m``; sLSTM ``h``, ``c``, ``n``, ``m``)
stay f32 in a bf16 model; the conv tails are in the model dtype. Every
decode step writes its state into the cache leaves IN PLACE (JAX
returns new ones), so a captured decode step keeps its addresses.

Tensor parallelism (``shard``, a ``launch.sharding.ShardCtx`` whose plan
splits the block; the serving forms only, training stays single-device).
Replicated leaves (conv, ``lam``, ``b_a`` / ``b_i``, ``b_if``,
``b_zifo``, ``r_zifo``, ``gn_scale``) stay whole and a rank indexes its
channels or heads at use:

* RG-LRU: ``w_gate`` / ``w_x`` columns give the rank its dr / T
  channels of the gate and the conv input; the depthwise conv, the
  gates' biases and ``lam`` act on those channels; ``y`` is
  all-gathered for ``w_a`` / ``w_i`` (column slices: the rank's
  channels of r and i), K5 scans the rank's (B, S, dr / T) channels,
  and ``w_out`` (row-parallel) is all-reduced: 2 collectives;
* mLSTM: the head-aligned ``w_up`` gives the rank its heads' channels
  of c and z, the conv runs on them, ``[c, cc]`` is all-gathered for
  ``wq`` / ``wk`` / ``wv`` / the head-aligned ``w_if`` (the rank's
  heads), the cell, group norm and z gate run on its heads, and
  ``w_down`` is all-reduced: 2 collectives;
* sLSTM: the head-aligned ``w_zifo`` gives the rank its heads' columns
  of z, i, f and o, the cell runs on its heads' state with their
  blocks of ``r_zifo``, the hidden is all-gathered before the group
  norm and the gated FFN (the tensor-parallel MLP): 2 collectives.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from . import layers

# ---------------------------------------------------------------------------
# mLSTM (matrix-memory LSTM)
# ---------------------------------------------------------------------------


def init_mlstm_block(gen, cfg, dtype, lead=()):
    """Stacked ``lead + (...)`` mLSTM params drawn from ``gen``: JAX's
    tree; the forget-gate bias ``linspace(3, 6)`` (long memory at
    init) and the input-gate bias zero."""
    d, H = cfg.d_model, cfg.n_heads
    lead = tuple(lead)

    def dense(shape):
        return layers.truncated_normal_init(gen, shape, dtype, lead=lead)

    b_if = torch.cat([torch.zeros(H, dtype=dtype),
                      torch.linspace(3.0, 6.0, H).to(dtype)])
    return {
        "w_up": dense((d, 2 * d)),
        "conv": layers.init_conv1d(gen, d, 4, dtype, lead=lead),
        "wq": dense((d, d)),
        "wk": dense((d, d)),
        "wv": dense((d, d)),
        "w_if": dense((d, 2 * H)),
        "b_if": b_if.to(gen.device).expand(lead + (2 * H,)).clone(),
        "gn_scale": torch.ones(lead + (d,), dtype=dtype, device=gen.device),
        "w_down": dense((d, d)),
    }


def _mlstm_init_state(B, H, hd, device):
    """(C, n, m) before any token: zeros, m at -1e30, all f32."""
    return (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=device),
            torch.zeros((B, H, hd), dtype=torch.float32, device=device),
            torch.full((B, H), -1e30, dtype=torch.float32, device=device))


def mlstm_chunkwise(q, k, v, ig, fg, chunk: int = 256, state=None):
    """Chunkwise-parallel stabilized mLSTM (JAX's chunk loop, chunk by
    chunk in Python).

    q, k, v: (B, H, S, hd); ig / fg: (B, H, S) raw gate pre-activations.
    A tail that does not fill the last chunk is padded so that it leaves
    the carried state alone (input gate -1e30, forget gate 30). Returns
    (h (B, H, S, hd) in q's dtype, final state (C, n, m) in f32).
    """
    B, H, S, hd = q.shape
    S0 = S
    pad = (-S) % chunk
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        ig = F.pad(ig, (0, pad), value=-1e30)
        fg = F.pad(fg, (0, pad), value=30.0)
        S += pad
    L = chunk
    scale = 1.0 / math.sqrt(hd)
    qf = q.float() * scale
    kf, vf = k.float(), v.float()
    lf = F.logsigmoid(fg.float())                       # log forget
    li = ig.float()                                     # log input
    C, n, m = state if state is not None else \
        _mlstm_init_state(B, H, hd, q.device)
    tri = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    hs = []
    for c0 in range(0, S, L):
        qj, kj, vj = (t[:, :, c0:c0 + L] for t in (qf, kf, vf))
        lfj, lij = lf[..., c0:c0 + L], li[..., c0:c0 + L]
        a = torch.cumsum(lfj, dim=-1)                   # inclusive decay
        A = a[..., -1:]
        # intra-chunk log weights D_ij = a_i - a_j + li_j (j <= i)
        D = a[..., :, None] - a[..., None, :] + lij[..., None, :]
        D = torch.where(tri, D, -math.inf)
        m_intra = D.amax(-1)
        m_inter = m[..., None] + a
        m_i = torch.maximum(m_inter, m_intra).clamp(min=-1e30)
        Sij = (qj @ kj.transpose(-1, -2)) * torch.exp(D - m_i[..., None])
        inter_w = torch.exp(m_inter - m_i)
        num = inter_w[..., None] * (qj @ C) + Sij @ vj
        den = inter_w * (qj @ n[..., None])[..., 0] + Sij.sum(-1)
        hs.append(num / torch.maximum(den.abs(),
                                      torch.exp(-m_i))[..., None])
        # carry update
        m_k = A - a + lij                               # per-key weight
        m_new = torch.maximum(m[..., None] + A,
                              m_k.amax(-1, keepdim=True))[..., 0]
        carry_w = torch.exp(m[..., None] + A - m_new[..., None])[..., 0]
        kw = torch.exp(m_k - m_new[..., None])[..., None] * kj
        C = carry_w[..., None, None] * C + kw.transpose(-1, -2) @ vj
        n = carry_w[..., None] * n + kw.sum(-2)
        m = m_new
    h = torch.cat(hs, dim=2)[:, :, :S0]
    return h.to(q.dtype), (C, n, m)


def mlstm_step(q, k, v, ig, fg, state):
    """One-token recurrent mLSTM: q, k, v (B, H, hd), gates (B, H),
    state (C, n, m). Returns (h in q's dtype, new (C, n, m))."""
    C, n, m = state
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q.float() * scale
    kf, vf = k.float(), v.float()
    lf = F.logsigmoid(fg.float())
    li = ig.float()
    m_new = torch.maximum(lf + m, li)
    fw = torch.exp(lf + m - m_new)
    iw = torch.exp(li - m_new)
    C = fw[..., None, None] * C \
        + iw[..., None, None] * (kf[..., :, None] * vf[..., None, :])
    n = fw[..., None] * n + iw[..., None] * kf
    num = (qf[..., None, :] @ C)[..., 0, :]
    den = (qf * n).sum(-1)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h.to(q.dtype), (C, n, m_new)


def _xlstm_heads(cfg, shard):
    """(this rank's heads as a slice of the H heads, its channels as a
    slice of d) where the plan splits the xLSTM heads, else (None,
    None)."""
    if not layers.split_over(shard, "xlstm"):
        return None, None
    hs = layers.rank_slice(cfg.n_heads, shard)
    hd = cfg.d_model // cfg.n_heads
    return hs, slice(hs.start * hd, hs.stop * hd)


def _conv_on(conv, ch):
    """The depthwise conv's taps and bias on the channels ``ch`` (all
    for None)."""
    return conv if ch is None else {"w": conv["w"][..., ch],
                                    "b": conv["b"][..., ch]}


def mlstm_qkv_gates(params, cfg, xn, conv_state=None, length=None,
                    shard=None):
    """Up-projection, causal conv, q / k / v heads and the raw gates.

    xn: (B, S, d) pre-normed. Returns (q, k, v (B, H, S, hd), ig, fg
    (B, H, S), z (B, S, d), conv tail). With ``length`` (right-padded
    prefill) the conv tail holds the last width-1 REAL conv inputs.
    Under a ``shard`` whose plan splits the heads: the rank's H / T heads
    and d / T channels of z and the conv tail (one all-gather of
    ``[c, cc]``)."""
    B, S, d = xn.shape
    hs, ch = _xlstm_heads(cfg, shard)
    H = cfg.n_heads if hs is None else hs.stop - hs.start
    hd = d // cfg.n_heads
    c, z = (xn @ params["w_up"]).chunk(2, dim=-1)
    conv = _conv_on(params["conv"], ch)
    cc, conv_state = layers.apply_conv1d(conv, c, conv_state)
    if length is not None:
        conv_state = layers.conv_state_at(c, conv["w"].shape[0], length)
    cc = F.silu(cc)
    b_if = params["b_if"]
    if hs is not None:              # the whole c and cc, one collective
        both = layers.tp_gather_last(torch.cat([c, cc], dim=-1), shard)
        both = both.unflatten(-1, (shard.tp_size, 2, c.shape[-1]))
        c, cc = both[..., 0, :].flatten(-2), both[..., 1, :].flatten(-2)
        b_if = layers.rank_parts(b_if, 2, shard)

    def heads(t):
        return t.reshape(B, S, H, hd).transpose(1, 2)

    q, k, v = heads(cc @ params["wq"]), heads(cc @ params["wk"]), \
        heads(c @ params["wv"])
    ig, fg = (c @ params["w_if"] + b_if).chunk(2, dim=-1)
    return q, k, v, ig.transpose(1, 2), fg.transpose(1, 2), z, conv_state


def freeze_gates_past(ig, fg, length):
    """Gate pre-activations masked past each row's true length so the
    chunkwise scan carries its state FROZEN at ``length``: input gate
    -1e30 (zero key weight), forget gate 1e30 (log-sigmoid -0.0: no
    decay). ig / fg: (B, H, S); length: (B,)."""
    pad = torch.arange(ig.shape[-1], device=ig.device)[None, None, :] \
        >= length.long()[:, None, None]
    return torch.where(pad, -1e30, ig), torch.where(pad, 1e30, fg)


def mlstm_output(params, cfg, h, z, shard=None):
    """Group norm over the heads, the silu(z) gate, the down-projection.
    h: (B, H, S, hd); z: (B, S, d). Under a ``shard`` whose plan splits
    the heads, the rank's heads and channels, and the row-parallel
    ``w_down``'s partial sums all-reduced."""
    B, H, S, hd = h.shape
    _, ch = _xlstm_heads(cfg, shard)
    gn = params["gn_scale"] if ch is None else params["gn_scale"][..., ch]
    h = h.transpose(1, 2).reshape(B, S, H * hd)
    h = layers.group_norm(h, gn, H)
    return layers.tp_reduce((h * F.silu(z)) @ params["w_down"],
                            shard if ch is not None else None)


def apply_mlstm_block(params, cfg, xn):
    """Full-sequence mLSTM mixing of pre-normed xn (B, S, d), no cache:
    the training form (JAX's ``apply_mlstm_block`` at ``chunk =
    cfg.mlstm_chunk``), differentiable by autograd. Returns the block's
    delta."""
    q, k, v, ig, fg, z, _ = mlstm_qkv_gates(params, cfg, xn)
    h, _ = mlstm_chunkwise(q, k, v, ig, fg,
                           chunk=min(cfg.mlstm_chunk, xn.shape[1]))
    return mlstm_output(params, cfg, h, z)


def init_mlstm_cache(cfg, batch, dtype, device, lead=()):
    """Zeroed per-slot state: ``C`` (B, H, hd, hd), ``n`` (B, H, hd),
    ``m`` (B, H) at -1e30, all f32, and the conv tail (B, 3, d) in
    ``dtype``."""
    H, d = cfg.n_heads, cfg.d_model
    hd = d // H
    lead = tuple(lead) + (batch,)
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros(lead + (H, hd, hd), **f32),
            "n": torch.zeros(lead + (H, hd), **f32),
            "m": torch.full(lead + (H,), -1e30, **f32),
            "conv": torch.zeros(lead + (3, d), dtype=dtype, device=device)}


def apply_mlstm_decode(params, cfg, xn, cache, shard=None):
    """One-token mLSTM step; ``cache`` ({"C", "n", "m", "conv"}, the
    rank's heads under ``shard``) is updated IN PLACE and returned with
    the output."""
    q, k, v, ig, fg, z, conv_state = mlstm_qkv_gates(
        params, cfg, xn, cache["conv"], shard=shard)
    h, state = mlstm_step(q[:, :, 0], k[:, :, 0], v[:, :, 0], ig[:, :, 0],
                          fg[:, :, 0], (cache["C"], cache["n"], cache["m"]))
    out = mlstm_output(params, cfg, h[:, :, None], z, shard)
    for name, t in zip(("C", "n", "m"), state):
        cache[name].copy_(t)
    cache["conv"].copy_(conv_state)
    return out, cache


# ---------------------------------------------------------------------------
# sLSTM (scalar-memory LSTM with a recurrent matrix; sequential)
# ---------------------------------------------------------------------------


def slstm_ffn_width(d: int) -> int:
    """The gated GeGLU FFN inside the sLSTM block: xLSTM's 4/3 factor,
    rounded to a multiple of 64."""
    return int(round(d * 4 / 3 / 64)) * 64 or 64


def init_slstm_block(gen, cfg, dtype, lead=()):
    """Stacked ``lead + (...)`` sLSTM params drawn from ``gen``: JAX's
    tree; the recurrent ``r_zifo`` (4, H, hd, hd) with stddev
    1/sqrt(hd), forget-gate bias 4."""
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    lead = tuple(lead)
    b = torch.cat([torch.zeros(2 * d), torch.full((d,), 4.0),
                   torch.zeros(d)]).to(dtype)
    return {
        "w_zifo": layers.truncated_normal_init(gen, (d, 4 * d), dtype,
                                               lead=lead),
        "r_zifo": layers.truncated_normal_init(
            gen, (4, H, hd, hd), dtype, stddev=1.0 / math.sqrt(hd),
            lead=lead),
        "b_zifo": b.to(gen.device).expand(lead + (4 * d,)).clone(),
        "gn_scale": torch.ones(lead + (d,), dtype=dtype, device=gen.device),
        "ff": layers.init_mlp(gen, d, slstm_ffn_width(d), dtype, gated=True,
                              lead=lead),
    }


def slstm_cell(cfg, x_part, state, r, b):
    """One sLSTM step. x_part: (B, 4d) input projection; state (h, c, n,
    m) each (B, H, hd) f32; ``r`` / ``b`` the recurrent matrix and bias
    in f32. Returns (hidden, new state). The heads are the state's: a
    tensor-parallel rank passes its heads' columns, blocks and state."""
    h, c, n, m = state
    B, H, hd = h.shape
    d = H * hd
    rec = torch.einsum("bhd,ghde->bghe", h, r).reshape(B, 4 * d)
    zt, it, ft, ot = (x_part.float() + rec + b).chunk(4, dim=-1)
    zt = torch.tanh(zt).reshape(B, H, hd)
    ot = torch.sigmoid(ot).reshape(B, H, hd)
    li = it.reshape(B, H, hd)
    lf = F.logsigmoid(ft).reshape(B, H, hd)
    m_new = torch.maximum(lf + m, li)
    fw = torch.exp(lf + m - m_new)
    iw = torch.exp(li - m_new)
    c = fw * c + iw * zt
    n = fw * n + iw
    hidden = ot * c / torch.maximum(n, torch.exp(-m_new))
    return hidden, (hidden, c, n, m_new)


def slstm_output(params, cfg, hidden, dtype, shard=None):
    """Group norm of the (B, S, d) cell outputs, then the gated GeGLU.
    Under a ``shard`` whose plan splits the heads, ``hidden`` holds the
    rank's heads (B, S, d / T), all-gathered first; the FFN is the
    tensor-parallel MLP where the plan splits its width."""
    if _xlstm_heads(cfg, shard)[0] is not None:
        hidden = layers.tp_gather_last(hidden, shard)
    h = layers.group_norm(hidden.to(dtype), params["gn_scale"], cfg.n_heads)
    ff = shard if layers.split_over(shard, "slstm_ff") else None
    return layers.apply_mlp(params["ff"], h, "gelu", ff)


def _slstm_rank(params, cfg, shard):
    """(``r_zifo`` and ``b_zifo`` in f32 on the rank's heads, its heads
    as a slice, None where the plan keeps them whole)."""
    hs, _ = _xlstm_heads(cfg, shard)
    r, b = params["r_zifo"], params["b_zifo"]
    if hs is not None:
        r, b = r[:, hs], layers.rank_parts(b, 4, shard)
    return r.float(), b.float(), hs


def slstm_sequence(params, cfg, xn, length=None, shard=None):
    """The sLSTM over pre-normed xn (B, S, d), one cell a token: one
    input projection ``xn @ w_zifo``, the cells, then ``slstm_output``.
    Returns (out (B, S, d), the final state {"h", "c", "n", "m"}). With
    ``length`` ((B,) int, right-padded prefill) a pad step keeps the
    carry it was given, so the state is frozen bit for bit at each true
    length. Under a ``shard`` whose plan splits the heads, the cells run
    on the rank's heads (one launch a cell a rank) and the state is
    theirs."""
    B, S, _ = xn.shape
    x_parts = xn @ params["w_zifo"]
    r, b, hs = _slstm_rank(params, cfg, shard)
    init = init_slstm_cache(cfg, B, xn.dtype, xn.device)
    state = tuple(init[n] if hs is None else init[n][:, hs]
                  for n in ("h", "c", "n", "m"))
    keep = None if length is None else \
        torch.arange(S, device=xn.device)[None, :] < length.long()[:, None]
    hs = []
    for t in range(S):
        hidden, new = slstm_cell(cfg, x_parts[:, t], state, r, b)
        if keep is None:
            state = new
        else:
            kt = keep[:, t, None, None]
            state = tuple(torch.where(kt, a, o) for a, o in zip(new, state))
        hs.append(hidden)
    out = slstm_output(params, cfg, torch.stack(hs, dim=1).flatten(2),
                       xn.dtype, shard)
    return out, dict(zip(("h", "c", "n", "m"), state))


def apply_slstm_block(params, cfg, xn):
    """Full-sequence sLSTM mixing, no cache: the training form (JAX's
    ``apply_slstm_block``), the cell stepped token by token under
    autograd. Returns the block's delta."""
    return slstm_sequence(params, cfg, xn)[0]


def init_slstm_cache(cfg, batch, dtype, device, lead=()):
    """Zeroed per-slot state ``h``, ``c``, ``n`` and ``m`` (at -1e30),
    each (B, H, hd) f32."""
    H, d = cfg.n_heads, cfg.d_model
    lead = tuple(lead) + (batch, H, d // H)
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros(lead, **f32), "c": torch.zeros(lead, **f32),
            "n": torch.zeros(lead, **f32),
            "m": torch.full(lead, -1e30, **f32)}


def apply_slstm_decode(params, cfg, xn, cache, shard=None):
    """One-token sLSTM step; ``cache`` ({"h", "c", "n", "m"}, the rank's
    heads under ``shard``) is updated IN PLACE and returned with the
    output."""
    B = xn.shape[0]
    r, b, _ = _slstm_rank(params, cfg, shard)
    hidden, state = slstm_cell(
        cfg, (xn @ params["w_zifo"])[:, 0],
        (cache["h"], cache["c"], cache["n"], cache["m"]), r, b)
    out = slstm_output(params, cfg, hidden.reshape(B, 1, -1), xn.dtype,
                       shard)
    for name, t in zip(("h", "c", "n", "m"), state):
        cache[name].copy_(t)
    return out, cache


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma / Griffin recurrent block)
# ---------------------------------------------------------------------------

_RGLRU_C = 8.0


def init_rglru_block(gen, cfg, dtype, lead=()):
    """Stacked ``lead + (...)`` RG-LRU params drawn from ``gen``: JAX's
    tree and distributions (``lam`` f32 so that a = exp(-c *
    softplus(lam)) spans ~(0.9, 0.999))."""
    d = cfg.d_model
    dr = cfg.rnn_width or d
    lead = tuple(lead)
    u = torch.empty(lead + (dr,), dtype=torch.float32, device=gen.device)
    u.uniform_(0.9, 0.999, generator=gen)
    lam = torch.log(torch.expm1(-torch.log(u) / _RGLRU_C))

    def dense(shape):
        return layers.truncated_normal_init(gen, shape, dtype, lead=lead)

    def zeros(n):
        return torch.zeros(lead + (n,), dtype=dtype, device=gen.device)

    return {
        "w_x": dense((d, dr)),
        "w_gate": dense((d, dr)),
        "conv": layers.init_conv1d(gen, dr, 4, dtype, lead=lead),
        "lam": lam,
        "w_a": dense((dr, dr)),
        "b_a": zeros(dr),
        "w_i": dense((dr, dr)),
        "b_i": zeros(dr),
        "w_out": dense((dr, d)),
    }


def rglru_channels(params, shard):
    """This rank's RG-LRU channels as a slice of the recurrence width
    where the plan splits it (``rnn_width`` divides T), else None."""
    if not layers.split_over(shard, "rglru"):
        return None
    return layers.rank_slice(params["lam"].shape[-1], shard)


def _rglru_coeffs(params, y, ch=None, shard=None):
    """Gated decay a_t and driven input b_t from conv output y, in f32.
    On a rank's channels ``ch``: y holds them, and is all-gathered for
    the column slices of ``w_a`` / ``w_i``."""
    yf = y.float()
    yw = yf if ch is None else layers.tp_gather_last(y, shard).float()

    def on(t):
        return t if ch is None else t[..., ch]

    r = torch.sigmoid(yw @ params["w_a"].float() + on(params["b_a"]).float())
    i = torch.sigmoid(yw @ params["w_i"].float() + on(params["b_i"]).float())
    lam = on(params["lam"])
    log_a = -_RGLRU_C * torch.logaddexp(lam, torch.zeros_like(lam)) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(-torch.expm1(2.0 * log_a))
    return a, beta * (i * yf)


def _gate_and_input(params, xn):
    gate = F.gelu(xn @ params["w_gate"], approximate="tanh")
    return gate, xn @ params["w_x"]


def rglru_mix(params, xn, shard=None, conv_state=None):
    """The RG-LRU's gate, conv and coefficients of pre-normed xn (B, S,
    d), on the rank's channels where the plan splits them: (gate, conv
    input xb, conv output's new tail, a, b, the channel slice or None)."""
    ch = rglru_channels(params, shard)
    gate, xb = _gate_and_input(params, xn)
    y, tail = layers.apply_conv1d(_conv_on(params["conv"], ch), xb,
                                  conv_state)
    a, b = _rglru_coeffs(params, y, ch, shard)
    return gate, xb, tail, a, b, ch


def rglru_out(params, gate, h, ch, shard):
    """(gate * h) @ ``w_out``, all-reduced where the rank holds its
    channels' rows of it."""
    return layers.tp_reduce((gate * h) @ params["w_out"],
                            shard if ch is not None else None)


def apply_rglru_block(params, cfg, xn):
    """Full-sequence Griffin recurrent mixing through K5. Returns the
    block's delta (the prefill's cache-emitting form is
    ``transformer._rglru_with_cache``)."""
    gate, _, _, a, b, _ = rglru_mix(params, xn)
    h = kops.rglru_scan(a, b).to(xn.dtype)
    return (gate * h) @ params["w_out"]


def init_rglru_cache(cfg, batch, dtype, device, lead=()):
    """Zeroed per-slot state: ``h`` (f32) and the conv tail (dtype)."""
    dr = cfg.rnn_width or cfg.d_model
    lead = tuple(lead)
    return {"h": torch.zeros(lead + (batch, dr), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(lead + (batch, 3, dr), dtype=dtype,
                                device=device)}


def apply_rglru_decode(params, cfg, xn, cache, shard=None):
    """One-token RG-LRU step; ``cache`` ({"h", "conv"}, the rank's
    channels under ``shard``) is updated IN PLACE (JAX returns a new one)
    and returned with the output."""
    gate, _, conv_state, a, b, ch = rglru_mix(params, xn, shard,
                                              cache["conv"])
    h = a[:, 0] * cache["h"] + b[:, 0]
    out = rglru_out(params, gate, h[:, None].to(xn.dtype), ch, shard)
    cache["h"].copy_(h)
    cache["conv"].copy_(conv_state)
    return out, cache
