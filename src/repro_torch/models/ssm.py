"""Recurrent blocks: RecurrentGemma's RG-LRU.

Counterpart of ``repro/models/ssm.py`` for the RG-LRU (the Griffin
recurrent block): a gated diagonal linear recurrence whose prefill scan
runs through kernel K5 (``kernels/ops.rglru_scan``) and whose decode is
one O(1)-state step in plain torch, as JAX computes it outside any
Pallas kernel. The decay parameter ``lam`` and the carried state ``h``
stay f32 in a bf16 model; the conv tail is in the model dtype.

xLSTM's mLSTM and sLSTM blocks are not ported yet (ROADMAP queue 1:
'mLSTM / sLSTM (xlstm)'): ``transformer.check_supported`` refuses their
configs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from . import layers

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


def _rglru_coeffs(params, y):
    """Gated decay a_t and driven input b_t from conv output y, in f32."""
    yf = y.float()
    r = torch.sigmoid(yf @ params["w_a"].float() + params["b_a"].float())
    i = torch.sigmoid(yf @ params["w_i"].float() + params["b_i"].float())
    lam = params["lam"]
    log_a = -_RGLRU_C * torch.logaddexp(lam, torch.zeros_like(lam)) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(-torch.expm1(2.0 * log_a))
    return a, beta * (i * yf)


def _gate_and_input(params, xn):
    gate = F.gelu(xn @ params["w_gate"], approximate="tanh")
    return gate, xn @ params["w_x"]


def apply_rglru_block(params, cfg, xn):
    """Full-sequence Griffin recurrent mixing through K5. Returns the
    block's delta (the prefill's cache-emitting form is
    ``transformer._rglru_with_cache``)."""
    gate, xb = _gate_and_input(params, xn)
    y, _ = layers.apply_conv1d(params["conv"], xb)
    a, b = _rglru_coeffs(params, y)
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


def apply_rglru_decode(params, cfg, xn, cache):
    """One-token RG-LRU step; ``cache`` ({"h", "conv"}) is updated IN
    PLACE (JAX returns a new one) and returned with the output."""
    gate, xb = _gate_and_input(params, xn)
    y, conv_state = layers.apply_conv1d(params["conv"], xb, cache["conv"])
    a, b = _rglru_coeffs(params, y)
    h = a[:, 0] * cache["h"] + b[:, 0]
    out = (gate * h[:, None].to(xn.dtype)) @ params["w_out"]
    cache["h"].copy_(h)
    cache["conv"].copy_(conv_state)
    return out, cache
