"""K2 and K3 wrappers: attention over the block-paged pool.

Counterparts of ``repro/kernels/paged_attention.py``:
``paged_decode_attention`` (K2, one query row per sequence, kernel
``csrc/paged_attention.cu``) and ``paged_verify_attention`` (K3, K1
query rows per sequence for the speculative verify and the suffix
prefill, kernel ``csrc/paged_verify_attention.cu``). A CPU tensor runs
the plain version in ``kernels/ref.py``; a CUDA tensor launches the
hand-written kernel on the current stream, or raises. There is no
fallback from one to the other.
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
_PV_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                + [ctypes.c_float, ctypes.c_void_p])


def _check_pool_args(name, q, k_pool, v_pool, block_table, lengths):
    """Raise ValueError unless the tensors are what the CUDA kernels take:
    one CUDA device, all f32 or all bf16, int32 table and lengths,
    matching shapes, a supported head dim and group, contiguous."""
    B, Hq, D = q.shape[0], q.shape[-2], q.shape[-1]
    Hkv = k_pool.shape[2]
    tensors = (q, k_pool, v_pool, block_table, lengths)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: tensors on "
                         f"{[str(t.device) for t in tensors]}; expected one "
                         "CUDA device")
    if q.dtype not in DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype}, {k_pool.dtype}, "
                         f"{v_pool.dtype}; expected all float32 or all "
                         "bfloat16")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(f"{name}: block_table and lengths must be int32")
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape \
            or k_pool.shape[3] != D or block_table.dim() != 2 \
            or block_table.shape[0] != B or lengths.shape != (B,) \
            or Hq % Hkv != 0:
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}, table {tuple(block_table.shape)}, "
            f"lengths {tuple(lengths.shape)}")
    if D not in HEAD_DIMS or Hq // Hkv not in GROUPS:
        raise ValueError(f"{name}: head dim {D} / group {Hq // Hkv} not in "
                         f"{HEAD_DIMS} / {GROUPS}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")


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
    if q.dim() != 3:
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)} is "
                         "not (B, Hq, D)")
    _check_pool_args("paged_decode_attention", q, k_pool, v_pool,
                     block_table, lengths)
    B, Hq, D = q.shape
    BS, Hkv = k_pool.shape[1:3]
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


def paged_verify_attention(q, k_pool, v_pool, block_table, lengths, *,
                           window=None, scale=None):
    """q: (B, K1, Hq, D); pools: (NB, BS, Hkv, D); block_table: (B, NBMAX)
    int32; lengths: (B,) int32 tokens cached BEFORE the window -> (B, K1,
    Hq, D) in q's dtype. Row j attends positions < lengths[b] + 1 + j.

    The kernel reads only the table entries of positions some row of a
    query tile can see (clamped at NBMAX * BS), so entries past them may
    hold anything; every entry it does read must be a block id < NB.
    """
    if q.device.type == "cpu":
        return ref.paged_verify_attention(q, k_pool, v_pool, block_table,
                                          lengths, window=window,
                                          scale=scale)
    if q.dim() != 4:
        raise ValueError(f"paged_verify_attention: q {tuple(q.shape)} is "
                         "not (B, K1, Hq, D)")
    _check_pool_args("paged_verify_attention", q, k_pool, v_pool,
                     block_table, lengths)
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_verify_attention: pools must be 16-byte "
                         "aligned")
    B, K1, Hq, D = q.shape
    BS, Hkv = k_pool.shape[1:3]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty((B, K1, Hq, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = _build.function("repro_paged_verify_attention", _PV_ARGTYPES)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             DTYPES[q.dtype], B, K1, Hq, Hkv, D, BS, block_table.shape[1],
             int(window or 0), scale,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_verify_attention")
    paged_verify_attention.launches += 1
    return out


paged_verify_attention.launches = 0
