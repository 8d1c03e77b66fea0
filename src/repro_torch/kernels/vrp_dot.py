"""K8 wrappers: the VRP tile's compensated dot (K8a) and sum (K8b), per
lane.

Counterparts of ``repro/kernels/vrp_dot.py::vrp_dot_pallas`` and
``::vrp_sum_pallas``. Element i of a flat f32 input belongs to lane
i mod 1024 of an (8, 128) tile; each lane walks its elements in block
order with a Neumaier (s, c) pair, and the result is the (8, 128, 2)
lane pairs (``ops.vrp_dot`` / ``ops.vrp_sum`` finalize them). A CPU
tensor runs the plain version (``kernels/ref.vrp_dot_lanes`` /
``vrp_sum_lanes``); a CUDA tensor launches the hand-written kernel in
``csrc/vrp_dot.cu`` on the current stream, or raises. There is no
fallback from one to the other. A length that is not a multiple of 1024
reads as zero-padded, without a padded copy. The lanes equal the plain
version's, and JAX's, bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, ref

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_void_p]


def _check(name, tensors):
    if any(t.dim() != 1 for t in tensors) \
            or any(t.shape != tensors[0].shape for t in tensors):
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in tensors]}"
                         "; expected flat vectors of one length")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"{name}: dtypes {[t.dtype for t in tensors]}; "
                         "expected float32")
    devices = {t.device for t in tensors}
    if len(devices) != 1 or next(iter(devices)).type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {sorted(map(str, devices))}; "
                         "expected one CPU or CUDA device")
    return tensors[0].device.type == "cuda"


def _launch(x, y, dot, name):
    if not all(t.is_contiguous() for t in (x, y)):
        raise ValueError(f"{name}: inputs must be contiguous")
    out = torch.empty((8, 128, 2), dtype=torch.float32, device=x.device)
    fn = _build.function("repro_vrp_lanes", _ARGTYPES)
    err = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(),
             int(dot), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, name)
    return out


def vrp_dot_lanes(x, y):
    """Per-lane compensated dot of flat float32 x, y -> (8, 128, 2)."""
    if not _check("vrp_dot_lanes", (x, y)):
        return ref.vrp_dot_lanes(x, y)
    out = _launch(x, y, True, "vrp_dot_lanes")
    vrp_dot_lanes.launches += 1
    return out


def vrp_sum_lanes(x):
    """Per-lane compensated sum of flat float32 x -> (8, 128, 2)."""
    if not _check("vrp_sum_lanes", (x,)):
        return ref.vrp_sum_lanes(x)
    out = _launch(x, x, False, "vrp_sum_lanes")
    vrp_sum_lanes.launches += 1
    return out


vrp_dot_lanes.launches = 0
vrp_sum_lanes.launches = 0
