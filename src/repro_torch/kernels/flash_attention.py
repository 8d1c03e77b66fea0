"""K1 wrapper: blocked (flash) attention for prefill.

Counterpart of ``repro/kernels/flash_attention.py::flash_attention_pallas``.
A CPU tensor runs the plain version (``kernels/ref.flash_attention``); a
CUDA tensor launches the hand-written kernel in
``csrc/flash_attention.cu`` on the current stream, or raises. There is
no fallback from one to the other.

The kernel has two bodies, and ``body`` picks one from the inputs alone
before the launch: "wgmma" (Hopper's tensor cores on TMA-fed bf16 tiles)
for bf16 inputs that TMA can describe, "simt" (the CUDA cores in f32)
for everything else, f32 among it. A launch that fails raises; it is
never rerun on the other body. ``flash_attention.launches`` counts every
launch and ``flash_attention.launches_by_body`` each body's.

Under autograd (inputs that require grad, grad mode on) the call goes
through ``_Attention``, a ``torch.autograd.Function``: its forward is
the same kernel asked to write each row's f32 log-sum-exp as well, its
backward ``flash_attention_bwd``, the hand-written kernels of
``csrc/flash_attention_bwd.cu`` (FlashAttention-2's backward from q, k,
v, the output, its gradient and the lse), counted in
``flash_attention_bwd.launches`` and ``.launches_by_body``. The
backward has the same two bodies under the same rule (``bwd_body``):
"wgmma" for bf16 inputs a tensor map takes, "simt" for the rest. A
kernel's output carries no
``grad_fn``, so without the Function a loss on the card would reach
nothing in front of attention. On the CPU the Function runs the plain
versions, ``ref.flash_attention(..., return_lse=True)`` and
``ref.flash_attention_bwd``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build, ref

MAX_HEAD_DIM = 256                  # widest template tile of the kernel
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # csrc/common.cuh DType
BODIES = ("simt", "wgmma")          # the C entry's body codes 0 and 1

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 2
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                 + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 2
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def supports(head_dim: int) -> bool:
    """True when the CUDA kernel takes this head dim: any width up to
    256, run in the narrowest template tile of 16, 32, 64, 128 or 256
    lanes that holds it (lanes past the head dim load zero and store
    nothing, so 120 runs in the 128 tile without a padded copy)."""
    return 0 < head_dim <= MAX_HEAD_DIM


def _strides(t):
    """t's (batch, head, seq) strides in elements, with the stride of a
    dim of size 1 (never stepped along) replaced by 8, so that it cannot
    keep a tensor map from describing t."""
    return tuple(st if n > 1 else 8 for n, st in zip(t.shape[:3], t.stride()))


def body(q, k, v) -> str:
    """The body the kernel runs for these inputs, from their dtype, head
    dim, strides and alignment alone: "wgmma" when all three are bf16,
    the head dim is a multiple of 8 up to 256, each has a contiguous head
    dim, every other stride a positive multiple of 8 elements (16 bytes,
    what a tensor map takes) and a 16-byte aligned base; else "simt"."""
    D = q.shape[-1]
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)) \
            or D % 8 or not 0 < D <= MAX_HEAD_DIM:
        return "simt"
    for t in (q, k, v):
        if t.stride(-1) != 1 or t.data_ptr() % 16 \
                or any(st <= 0 or st % 8 for st in _strides(t)):
            return "simt"
    return "wgmma"


def bwd_body(q, k, v) -> str:
    """The body K1's backward runs for these inputs: ``body``'s rule on
    q, k and v alone. The other tensors of the call always qualify: the
    wrapper makes o and do contiguous on 16-byte aligned bases and
    allocates dq, dk and dv, all (..., D) with D a multiple of 8 where
    the rule picks "wgmma"."""
    return body(q, k, v)


def _check(q, k, v, name="flash_attention"):
    """Raise ValueError for inputs the CUDA kernels do not take."""
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"{name}: tensors on {q.device}, "
                         f"{k.device}, {v.device}; expected one CUDA device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; expected all float32 or all bfloat16")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D \
            or Hq % Hkv != 0:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not supports(D):
        raise ValueError(f"{name}: head dim {D} is not in "
                         f"1..{MAX_HEAD_DIM}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError(f"{name}: head dim must be contiguous")


def _scale(scale, D):
    return float(scale) if scale is not None else 1.0 / math.sqrt(D)


def _forward(q, k, v, causal, window, scale, with_lse):
    """One forward on either device -> (out, lse or None); on CUDA one
    counted kernel launch, which writes the lse when ``with_lse``."""
    if q.device.type == "cpu":
        if with_lse:
            return ref.flash_attention(q, k, v, causal=causal, window=window,
                                       scale=scale, return_lse=True)
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale), None
    _check(q, k, v)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32,
                      device=q.device) if with_lse else None
    if out.numel() == 0:
        return out, lse
    which = body(q, k, v)
    fn = _build.function("repro_flash_attention", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr() if with_lse else None,
             DTYPES[q.dtype], B, Hq, Hkv, Sq, Skv, D,
             *_strides(q), *_strides(k), *_strides(v),
             int(causal), int(window or 0), _scale(scale, D),
             BODIES.index(which),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, f"flash_attention ({which} body)")
    flash_attention.launches += 1
    flash_attention.launches_by_body[which] += 1
    return out, lse


def flash_attention(q, k, v, *, causal=True, window=None, scale=None):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D).

    GQA maps query head h to kv head h // (Hq // Hkv); ``window`` keeps
    keys with kpos > qpos - window. The CUDA kernel takes any strides
    whose last (head-dim) stride is 1, so a (B, S, H, D) projection can
    be passed through ``.transpose(1, 2)`` without a copy. The output is
    a new contiguous tensor in q's dtype. When autograd needs its
    gradient, the call runs through ``_Attention`` (see the module
    docstring).
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Attention.apply(q, k, v, causal, window, scale)
    return _forward(q, k, v, causal, window, scale, False)[0]


def _dense(t):
    """t contiguous on a 16-byte aligned base (a copy only when a view
    starts off one)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def launch_bwd(q, k, v, o, lse, do, *, causal=True, window=None,
               scale=None, which=None):
    """One launch of K1's backward on CUDA tensors (the pre-pass, then
    dK / dV, then dQ), counting nothing (``flash_attention_bwd``
    counts). ``which`` forces a body (chip_smoke.py times both; a wgmma
    request the inputs cannot take raises). Returns (dq, dk, dv, body)."""
    _check(q, k, v, "flash_attention_bwd")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if o.shape != q.shape or do.shape != q.shape \
            or lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32 \
            or o.dtype != q.dtype or do.dtype != q.dtype \
            or any(t.device != q.device for t in (o, do, lse)):
        raise ValueError(
            f"flash_attention_bwd: o {tuple(o.shape)} {o.dtype}, do "
            f"{tuple(do.shape)} {do.dtype}, lse {tuple(lse.shape)} "
            f"{lse.dtype}; expected q's shape and dtype, lse (B, Hq, Sq) "
            "float32, on q's device")
    which = which or bwd_body(q, k, v)
    o, do, lse = _dense(o), _dense(do), lse.contiguous()
    dq = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Hkv, Skv, D), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_(), which
    # f32 scratch: the rows' lse (log2) and deltas, each (b, h) padded to
    # a multiple of 64 rows
    sq_pad = -(-Sq // 64) * 64
    delta = torch.empty(2 * B * Hq * sq_pad, dtype=torch.float32,
                        device=q.device)
    fn = _build.function("repro_flash_attention_bwd", _BWD_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), DTYPES[q.dtype],
             B, Hq, Hkv, Sq, Skv, D,
             *_strides(q), *_strides(k), *_strides(v),
             int(causal), int(window or 0), _scale(scale, D),
             BODIES.index(which),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, f"flash_attention_bwd ({which} body)")
    return dq, dk, dv, which


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=None,
                        scale=None):
    """Gradients (dq, dk, dv) of ``flash_attention`` at output ``o`` with
    row log-sum-exps ``lse`` (B, Hq, Sq) f32, for the output gradient
    ``do``. A CPU tensor runs ``ref.flash_attention_bwd``; a CUDA tensor
    launches the kernels of ``csrc/flash_attention_bwd.cu`` on the
    current stream on the body ``bwd_body`` picks (``launch_bwd``: one
    counted launch), or raises. Returns contiguous (B, Hq, Sq, D) and
    (B, Hkv, Skv, D) tensors in the inputs' dtype."""
    if q.device.type == "cpu":
        return ref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                       window=window, scale=scale)
    dq, dk, dv, which = launch_bwd(q, k, v, o, lse, do, causal=causal,
                                   window=window, scale=scale)
    if dq.numel() and dk.numel():
        flash_attention_bwd.launches += 1
        flash_attention_bwd.launches_by_body[which] += 1
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """K1 under autograd: the forward keeps (q, k, v, out, lse), the
    backward runs ``flash_attention_bwd`` on them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, lse = _forward(q, k, v, causal, window, scale, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(causal=causal, window=window, scale=scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, **ctx.args)
        return dq, dk, dv, None, None, None


flash_attention.launches = 0
flash_attention.launches_by_body = dict.fromkeys(BODIES, 0)
flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_body = dict.fromkeys(BODIES, 0)
