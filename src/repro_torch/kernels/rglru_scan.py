"""K5 wrapper: the RG-LRU's diagonal linear recurrence (prefill scan).

Counterpart of ``repro/kernels/rglru_scan.py::rglru_scan_pallas``.
A CPU tensor runs the plain version (``kernels/ref.linear_scan``); a
CUDA tensor launches the hand-written kernel in ``csrc/rglru_scan.cu``
on the current stream, or raises. There is no fallback from one to the
other. The kernel masks ragged T and D itself, so nothing is padded.

The kernel has two bodies, and ``body`` picks one from dtype, shape and
alignment alone before the launch: "ring" (TMA tiles of a and x in a
ring of stages, one warp walking the chain from shared memory) where a
tensor map takes the inputs (D * elem a multiple of 16 bytes, 16-byte
aligned bases), "simt" (one thread a channel) for the rest. The C
side sets the ring's geometry (32 channels a CTA, 64 time rows a stage,
the stages from the shape). ``launches`` counts every launch,
``launches_by_body`` each body's and ``launches_by_shape`` each
(B, T, D)'s, as {"BxTxD": {body: n}}. Both bodies equal the plain
version bit for bit in f32.

Under autograd (a, x or h0 requiring grad, grad mode on) the call goes
through ``_Scan``, a ``torch.autograd.Function``, whose backward needs
no kernel of its own: the gradient of h_t = a_t h_{t-1} + x_t is the
same diagonal recurrence run backwards, dh_t = g_t + a_{t+1} dh_{t+1},
so ``scan_bwd`` launches K5 itself on the time-reversed output gradient
with the decays shifted one step (a_{t+1}, 0 past the end), then takes
dx = dh, da_t = dh_t h_{t-1} and dh0 = a_0 dh_0 in plain torch. Its
plain version is ``ref.linear_scan_bwd``, a backward loop with the same
rounding, which the reversed K5 equals bit for bit in f32.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, ref
from .flash_attention import DTYPES

BODIES = ("simt", "ring")        # index = the C entry's body code

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def body(a, x) -> str:
    """The body the kernel runs for a, x (B, T, D), from dtype, shape and
    alignment alone: "ring" for float32 or bfloat16 rows of a multiple
    of 16 bytes (D * elem) on 16-byte aligned bases (what a tensor map
    takes), else "simt"."""
    elem = x.element_size()
    if x.dtype in DTYPES and (x.shape[-1] * elem) % 16 == 0 \
            and all(t.data_ptr() % 16 == 0 for t in (a, x)):
        return "ring"
    return "simt"


def _check(a, x, h0):
    tensors = [a, x] + ([h0] if h0 is not None else [])
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"rglru_scan: tensors on "
                         f"{[str(t.device) for t in tensors]}; expected one "
                         "CUDA device")
    if x.dtype not in DTYPES or a.dtype != x.dtype:
        raise ValueError(f"rglru_scan: dtypes a {a.dtype}, x {x.dtype}; "
                         "expected both float32 or both bfloat16")
    if x.dim() != 3 or a.shape != x.shape \
            or (h0 is not None and h0.shape != (x.shape[0], x.shape[2])):
        raise ValueError(f"rglru_scan: shapes a {tuple(a.shape)}, x "
                         f"{tuple(x.shape)}, h0 "
                         f"{None if h0 is None else tuple(h0.shape)}")
    if not (a.is_contiguous() and x.is_contiguous()):
        raise ValueError("rglru_scan: a and x must be contiguous")


def launch(a, x, h0=None, *, which=None):
    """One launch on CUDA tensors, counting nothing (``rglru_scan``
    counts). ``which`` forces a body (chip_smoke.py times both; a ring
    the inputs cannot take raises). Returns (h, body)."""
    _check(a, x, h0)
    which = which or body(a, x)
    B, T, D = x.shape
    out = torch.empty((B, T, D), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out, which
    if h0 is not None:
        h0 = h0.float().contiguous()
    fn = _build.function("repro_rglru_scan", _ARGTYPES)
    err = fn(a.data_ptr(), x.data_ptr(),
             h0.data_ptr() if h0 is not None else None, out.data_ptr(),
             DTYPES[x.dtype], B, T, D, BODIES.index(which),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, f"rglru_scan ({which} body)")
    return out, which


def _scan(a, x, h0=None):
    """One forward on either device: the plain version on the CPU, a
    counted K5 launch on CUDA."""
    if x.device.type == "cpu":
        return ref.linear_scan(a, x, h0)
    out, which = launch(a, x, h0)
    if out.numel():
        rglru_scan.launches += 1
        rglru_scan.launches_by_body[which] += 1
        by_body = rglru_scan.launches_by_shape.setdefault(
            "x".join(map(str, x.shape)), {})
        by_body[which] = by_body.get(which, 0) + 1
    return out


def rglru_scan(a, x, h0=None):
    """a, x: (B, T, D) float32 or bfloat16 (one dtype); h0: (B, D) or
    None -> h (B, T, D) in x's dtype, h_t = a_t * h_{t-1} + x_t with the
    carry in f32. Differentiable (``_Scan``) when autograd asks."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, x, h0)):
        return _Scan.apply(a, x, h0)
    return _scan(a, x, h0)


def scan_bwd(a, h, g, h0=None):
    """Gradients (da, dx, dh0) of ``rglru_scan`` at output ``h`` for the
    output gradient ``g``: the reversed recurrence through ``_scan`` (K5
    on the card, counted as a K5 launch), then ``ref.scan_grads``."""
    B, T, D = g.shape
    a_next = torch.cat([a[:, 1:], a.new_zeros((B, 1, D))], dim=1)
    dh = _scan(a_next.flip(1).contiguous(),
               g.flip(1).contiguous()).flip(1)
    return ref.scan_grads(a, h, h0, dh)


class _Scan(torch.autograd.Function):
    """K5 under autograd: the forward keeps (a, h, h0), the backward is
    ``scan_bwd``."""

    @staticmethod
    def forward(ctx, a, x, h0):
        h = _scan(a, x, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h, h0 = ctx.saved_tensors
        da, dx, dh0 = scan_bwd(a, h, g, h0)
        return da, dx, None if h0 is None else dh0.to(h0.dtype)


rglru_scan.launches = 0
rglru_scan.launches_by_body = dict.fromkeys(BODIES, 0)
rglru_scan.launches_by_shape = {}
