"""K1 wrapper: blocked (flash) attention for prefill.

Counterpart of ``repro/kernels/flash_attention.py::flash_attention_pallas``.
A CPU tensor runs the plain version (``kernels/ref.flash_attention``); a
CUDA tensor launches the hand-written kernel in
``csrc/flash_attention.cu`` on the current stream, or raises. There is
no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build, ref

MAX_HEAD_DIM = 256                  # widest template tile of the kernel
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # csrc/common.cuh DType

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 2
             + [ctypes.c_float, ctypes.c_void_p])


def supports(head_dim: int) -> bool:
    """True when the CUDA kernel takes this head dim: any width up to
    256, run in the narrowest template tile of 16, 32, 64, 128 or 256
    lanes that holds it (lanes past the head dim load zero and store
    nothing, so 120 runs in the 128 tile without a padded copy)."""
    return 0 < head_dim <= MAX_HEAD_DIM


def flash_attention(q, k, v, *, causal=True, window=None, scale=None):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D).

    GQA maps query head h to kv head h // (Hq // Hkv); ``window`` keeps
    keys with kpos > qpos - window. The CUDA kernel takes any strides
    whose last (head-dim) stride is 1, so a (B, S, H, D) projection can
    be passed through ``.transpose(1, 2)`` without a copy. The output is
    a new contiguous tensor in q's dtype.
    """
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"flash_attention: tensors on {q.device}, "
                         f"{k.device}, {v.device}; expected one CUDA device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; expected all float32 or all bfloat16")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D \
            or Hq % Hkv != 0:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not supports(D):
        raise ValueError(f"flash_attention: head dim {D} is not in "
                         f"1..{MAX_HEAD_DIM}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention: head dim must be contiguous")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = _build.function("repro_flash_attention", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             DTYPES[q.dtype], B, Hq, Hkv, Sq, Skv, D,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             int(causal), int(window or 0), scale,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
