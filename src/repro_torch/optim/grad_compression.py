"""int8 gradient compression with error feedback.

Counterpart of ``repro/optim/grad_compression.py``: symmetric per-tensor
int8 quantization of a gradient plus the residual carried locally, so
the compression error does not bias the descent direction. The three
local functions are here; the all-reduce over a data-parallel axis
(``compressed_psum``) needs more than one device and waits for the
Multi-device slice.
"""

from __future__ import annotations

import torch


def quantize_int8(x):
    """Symmetric per-tensor int8 quantization -> (q, scale)."""
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def compress_residual(g, residual):
    """Error feedback: quantize (g + residual), carry the new residual."""
    target = g.to(torch.float32) + residual
    q, scale = quantize_int8(target)
    deq = dequantize_int8(q, scale)
    return q, scale, target - deq


def compressed_psum(g, residual, axis_name):
    """The int8 all-reduce over ``axis_name`` needs a process group of
    several devices: not ported yet."""
    raise NotImplementedError(
        "compressed_psum is an all-reduce across devices: it waits for "
        "queue-1 item Multi-device, sub-item 'sharded training'")
