"""K6 wrapper: the STX tile's matmul with an f32 accumulator.

Counterpart of ``repro/kernels/stx_matmul.py::stx_matmul_pallas``.
A CPU tensor runs the plain version (``kernels/ref.matmul``); a CUDA
tensor launches the hand-written kernel in ``csrc/stx_matmul.cu`` on the
current stream, or raises. There is no fallback from one to the other.
The kernel masks ragged M, N and K itself, so nothing is padded.

The kernel has two bodies, and ``body`` picks one from the inputs alone
before the launch: "wgmma" (Hopper's tensor cores on TMA-fed bf16 tiles)
for bf16 operands that TMA can describe, "simt" (the CUDA cores in f32)
for everything else, f32 operands among it. A launch that fails raises;
it is never rerun on the other body. ``stx_matmul.launches`` counts every
launch and ``stx_matmul.launches_by_body`` each body's.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, ref
from .flash_attention import BODIES, DTYPES

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def body(x, w) -> str:
    """The body the kernel runs for x (M, K) @ w (K, N), from their dtype,
    shape and alignment alone: "wgmma" when both are bf16, K and N are
    multiples of 8 (rows of 16-byte multiples, what a tensor map takes)
    and both bases are 16-byte aligned; else "simt"."""
    K, N = w.shape
    if x.dtype == w.dtype == torch.bfloat16 and K % 8 == 0 \
            and N % 8 == 0 and x.data_ptr() % 16 == 0 \
            and w.data_ptr() % 16 == 0:
        return "wgmma"
    return "simt"


def stx_matmul(x, w, out_dtype=None):
    """x (M, K) @ w (K, N) -> (M, N) in ``out_dtype`` (default x's), the
    products summed in f32. On the card: x and w one dtype, float32 or
    bfloat16, contiguous; ``out_dtype`` float32 or bfloat16."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"stx_matmul: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}; expected (M, K) and (K, N)")
    if x.device.type == "cpu" and w.device.type == "cpu":
        return ref.matmul(x, w, out_dtype=out_dtype)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"stx_matmul: tensors on {x.device} and "
                         f"{w.device}; expected one CUDA device")
    out_dtype = out_dtype or x.dtype
    if x.dtype not in DTYPES or w.dtype != x.dtype \
            or out_dtype not in DTYPES:
        raise ValueError(f"stx_matmul: dtypes x {x.dtype}, w {w.dtype}, "
                         f"out {out_dtype}; expected float32 or bfloat16 "
                         "operands of one dtype and a float32 or bfloat16 "
                         "output")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("stx_matmul: x and w must be contiguous")
    (M, K), N = x.shape, w.shape[1]
    if K == 0:
        return torch.zeros((M, N), dtype=out_dtype, device=x.device)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    which = body(x, w)
    fn = _build.function("repro_stx_matmul", _ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), DTYPES[x.dtype],
             DTYPES[out_dtype], M, N, K, BODIES.index(which),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, f"stx_matmul ({which} body)")
    stx_matmul.launches += 1
    stx_matmul.launches_by_body[which] += 1
    return out


stx_matmul.launches = 0
stx_matmul.launches_by_body = dict.fromkeys(BODIES, 0)
