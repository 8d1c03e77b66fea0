"""K7 wrappers: the STX/SPU weighted stencils (K7a 3x3 on (..., M, N),
K7b 3x3x3 on (..., D, M, N)), zero boundary.

Counterparts of ``repro/kernels/stx_stencil.py::stencil2d_pallas`` and
``::stencil3d_pallas``. A CPU tensor runs the plain version
(``kernels/ref.stencil2d`` / ``stencil3d``); a CUDA tensor launches the
hand-written kernel in ``csrc/stx_stencil.cu`` on the current stream, or
raises. There is no fallback from one to the other. The kernel reads
neighbours outside the grid as zero, so nothing is padded; leading dims
are a batch. The kernel equals the plain version bit for bit.

K7b has two bodies, and ``body3d`` picks one from dtype, shape and
alignment alone before the launch: "ring" (planes brought by TMA into a
ring of shared-memory slots, each read once by threads that own 4 x 4
outputs) for float32 with N a multiple of 4 on a 16-byte aligned base,
"simt" (the first port's kernel) for the rest; the C side sets the
ring's tile, chunk and slots. ``stencil3d.launches_by_body`` counts
each body's launches; K7a has one body.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build, ref
from .flash_attention import DTYPES

BODIES = ("simt", "ring")        # index = the C entry's body code

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def body3d(x) -> str:
    """The body K7b runs for x (..., D, M, N), from dtype, shape and
    alignment alone: "ring" for float32 with N a multiple of 4 (rows of
    16-byte multiples) on a 16-byte aligned base (what a tensor map
    takes), else "simt"."""
    if x.dtype == torch.float32 and x.dim() >= 3 and x.shape[-1] % 4 == 0 \
            and x.data_ptr() % 16 == 0:
        return "ring"
    return "simt"


def _launch(x, weights, dims, name, which="simt"):
    if x.dim() < dims or tuple(weights.shape) != (3,) * dims:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, weights "
                         f"{tuple(weights.shape)}; expected at least {dims} "
                         f"dims and {(3,) * dims} weights")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x on {x.device}; expected a CUDA device")
    if x.dtype not in DTYPES or weights.dtype != torch.float32:
        raise ValueError(f"{name}: dtypes x {x.dtype}, weights "
                         f"{weights.dtype}; expected float32 or bfloat16 x "
                         "and float32 weights")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    w = weights.to(x.device).contiguous()
    grid = x.shape[-dims:]
    B = math.prod(x.shape[:-dims])
    D, M, N = ((1,) + tuple(grid)) if dims == 2 else tuple(grid)
    fn = _build.function("repro_stencil", _ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), DTYPES[x.dtype],
             int(dims == 3), B, D, M, N, BODIES.index(which),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, f"{name} ({which} body)")
    return out


def stencil2d(x, weights):
    """3x3 weighted stencil on (..., M, N), zero boundary; weights (3, 3)
    float32. Output in x's dtype, accumulated in f32 (bf16 x) or x's
    dtype."""
    if x.device.type == "cpu":
        return ref.stencil2d(x, weights)
    out = _launch(x, weights, 2, "stencil2d")
    stencil2d.launches += 1
    return out


def launch3d(x, weights, which=None):
    """One K7b launch on a CUDA x, counting nothing (``stencil3d``
    counts); ``which`` forces a body (chip_smoke.py times both; a ring
    the input cannot take raises). Returns (out, body)."""
    which = which or body3d(x)
    return _launch(x, weights, 3, "stencil3d", which), which


def stencil3d(x, weights):
    """3x3x3 weighted stencil on (..., D, M, N), zero boundary; weights
    (3, 3, 3) float32."""
    if x.device.type == "cpu":
        return ref.stencil3d(x, weights)
    out, which = launch3d(x, weights)
    if out.numel():
        stencil3d.launches += 1
        stencil3d.launches_by_body[which] += 1
    return out


stencil2d.launches = 0
stencil3d.launches = 0
stencil3d.launches_by_body = dict.fromkeys(BODIES, 0)
