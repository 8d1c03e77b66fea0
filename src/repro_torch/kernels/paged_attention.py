"""K2 wrapper: single-token decode attention over the block-paged pool.

Counterpart of ``repro/kernels/paged_attention.py::
paged_decode_attention_pallas``. A CPU tensor runs the plain version
(``kernels/ref.paged_decode_attention``); a CUDA tensor launches the
hand-written kernel in ``csrc/paged_attention.cu`` on the current
stream, or raises. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build, ref
from .flash_attention import DTYPES, HEAD_DIMS

GROUPS = (1, 2, 4, 8)               # Hq // Hkv the CUDA kernel is built for

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_void_p])


def paged_decode_attention(q, k_pool, v_pool, block_table, lengths, *,
                           window=None, scale=None):
    """q: (B, Hq, D); pools: (NB, BS, Hkv, D); block_table: (B, NBMAX)
    int32; lengths: (B,) int32 valid tokens including the current one
    -> (B, Hq, D) in q's dtype.

    The kernel reads only the table entries of blocks the length (and
    window) can see, so entries past a sequence's last block may hold
    anything; every entry it does read must be a block id < NB.
    """
    if q.device.type == "cpu":
        return ref.paged_decode_attention(q, k_pool, v_pool, block_table,
                                          lengths, window=window,
                                          scale=scale)
    B, Hq, D = q.shape
    NB, BS, Hkv = k_pool.shape[:3]
    tensors = (q, k_pool, v_pool, block_table, lengths)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("paged_decode_attention: tensors on "
                         f"{[str(t.device) for t in tensors]}; expected one "
                         "CUDA device")
    if q.dtype not in DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise ValueError(f"paged_decode_attention: dtypes {q.dtype}, "
                         f"{k_pool.dtype}, {v_pool.dtype}; expected all "
                         "float32 or all bfloat16")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged_decode_attention: block_table and lengths "
                         "must be int32")
    if k_pool.shape != v_pool.shape or k_pool.shape[3] != D \
            or block_table.dim() != 2 or block_table.shape[0] != B \
            or lengths.shape != (B,) or Hq % Hkv != 0:
        raise ValueError(
            f"paged_decode_attention: shapes q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}, table {tuple(block_table.shape)}, "
            f"lengths {tuple(lengths.shape)}")
    if D not in HEAD_DIMS or Hq // Hkv not in GROUPS:
        raise ValueError(f"paged_decode_attention: head dim {D} / group "
                         f"{Hq // Hkv} not in {HEAD_DIMS} / {GROUPS}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_attention: inputs must be contiguous")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = _build.function("repro_paged_decode_attention", _ARGTYPES)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             DTYPES[q.dtype], B, Hq, Hkv, D, BS, block_table.shape[1],
             int(window or 0), scale,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
