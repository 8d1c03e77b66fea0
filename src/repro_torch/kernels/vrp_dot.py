"""K8 wrappers: the VRP tile's compensated dot (K8a) and sum (K8b), per
lane, and the compensated tree that finalizes the lanes.

Counterparts of ``repro/kernels/vrp_dot.py::vrp_dot_pallas`` and
``::vrp_sum_pallas``. Element i of a flat f32 input belongs to lane
i mod 1024 of an (8, 128) tile; each lane walks its elements in block
order with a Neumaier (s, c) pair, and the result is the (8, 128, 2)
lane pairs. ``vrp_dot`` / ``vrp_sum`` also finalize them into the (2,)
expansion [hi, lo] (``ops.vrp_dot`` / ``ops.vrp_sum``). A CPU tensor
runs the plain versions (``kernels/ref.vrp_dot_lanes`` /
``vrp_sum_lanes``, ``ref.vrp_finalize``); a CUDA tensor launches the
hand-written kernels in ``csrc/vrp_dot.cu`` on the current stream, or
raises. There is no fallback from one to the other. A length that is not
a multiple of 1024 reads as zero-padded, without a padded copy. The
lanes and the finalized expansion equal the plain versions', and JAX's,
bit for bit.

The lane kernel has two bodies, and ``body`` picks one from n and the
bases' alignment alone before the launch: "ring" (a TMA ring whose tile
walks are split over warps: one carries s, one c, helpers form the
products and the errors) for n >= 1024 and 16-byte aligned inputs,
"simt" (one thread a lane) for the rest, such as a contiguous ``x[1:]``.
``launches`` counts every lane launch and ``launches_by_body`` each
body's; ``vrp_finalize.launches`` counts the finalize kernel's. On the
card ``vrp_dot`` / ``vrp_sum`` are one C call that launches the lane
kernel and then the finalize, with no host sync, so a CUDA graph can
capture them.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, ref

LANES = ref.LANES
BODIES = ("simt", "ring")        # index = the C entry's body code
RING_LANES = 8                   # lanes a CTA of the ring body (8, 16, 32)

_LANES_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] \
    + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_FINAL_ARGTYPES = [ctypes.c_void_p] * 3


def body(x, y=None) -> str:
    """The body the lane kernel runs for flat x (and y), from n and the
    bases' alignment alone: "ring" when n >= 1024 and every base is
    16-byte aligned (what a tensor map takes), else "simt"."""
    ts = (x,) if y is None else (x, y)
    if x.numel() >= LANES and all(t.data_ptr() % 16 == 0 for t in ts):
        return "ring"
    return "simt"


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


def launch(x, y, dot, name, *, final=False, lanes_per_cta=RING_LANES):
    """One C call: the lane kernel on x (and y when ``dot``) and, with
    ``final``, the finalize after it. Counts nothing (the public
    wrappers do). ``lanes_per_cta`` (8, 16 or 32) is the ring body's CTA
    width: RING_LANES on every path; ``chip_smoke.py`` times the others.
    Returns (lanes, expansion or None, body)."""
    if not all(t.is_contiguous() for t in (x, y)):
        raise ValueError(f"{name}: inputs must be contiguous")
    which = body(x, y if dot else None)
    lanes = torch.empty((8, 128, 2), dtype=torch.float32, device=x.device)
    out = torch.empty(2, dtype=torch.float32, device=x.device) \
        if final else None
    fn = _build.function("repro_vrp_lanes", _LANES_ARGTYPES)
    err = fn(x.data_ptr(), y.data_ptr(), lanes.data_ptr(),
             out.data_ptr() if final else None, x.numel(), int(dot),
             BODIES.index(which), lanes_per_cta,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, f"{name} ({which} body)")
    return lanes, out, which


def _count(fn, which, final):
    fn.launches += 1
    fn.launches_by_body[which] += 1
    if final:
        vrp_finalize.launches += 1


def vrp_dot_lanes(x, y):
    """Per-lane compensated dot of flat float32 x, y -> (8, 128, 2)."""
    if not _check("vrp_dot_lanes", (x, y)):
        return ref.vrp_dot_lanes(x, y)
    lanes, _, which = launch(x, y, True, "vrp_dot_lanes")
    _count(vrp_dot_lanes, which, False)
    return lanes


def vrp_sum_lanes(x):
    """Per-lane compensated sum of flat float32 x -> (8, 128, 2)."""
    if not _check("vrp_sum_lanes", (x,)):
        return ref.vrp_sum_lanes(x)
    lanes, _, which = launch(x, x, False, "vrp_sum_lanes")
    _count(vrp_sum_lanes, which, False)
    return lanes


def vrp_finalize(lanes):
    """Compensated tree over (8, 128, 2) lane pairs -> (2,) [hi, lo]."""
    if lanes.shape != (8, 128, 2) or lanes.dtype != torch.float32:
        raise ValueError(f"vrp_finalize: lanes {tuple(lanes.shape)} "
                         f"{lanes.dtype}; expected (8, 128, 2) float32")
    if lanes.device.type == "cpu":
        return ref.vrp_finalize(lanes)
    if lanes.device.type != "cuda" or not lanes.is_contiguous():
        raise ValueError(f"vrp_finalize: lanes on {lanes.device}; expected "
                         "a contiguous CPU or CUDA tensor")
    out = torch.empty(2, dtype=torch.float32, device=lanes.device)
    fn = _build.function("repro_vrp_finalize", _FINAL_ARGTYPES)
    stream = torch.cuda.current_stream(lanes.device).cuda_stream
    _build.check(fn(lanes.data_ptr(), out.data_ptr(), stream), "vrp_finalize")
    vrp_finalize.launches += 1
    return out


def vrp_dot(x, y):
    """Double-word dot of flat float32 x, y -> (2,) expansion [hi, lo]:
    the lanes of K8a, then the finalize (one C call on the card)."""
    if not _check("vrp_dot", (x, y)):
        return ref.vrp_finalize(ref.vrp_dot_lanes(x, y))
    _, out, which = launch(x, y, True, "vrp_dot", final=True)
    _count(vrp_dot_lanes, which, True)
    return out


def vrp_sum(x):
    """Double-word sum of a flat float32 x -> (2,) expansion [hi, lo]:
    the lanes of K8b, then the finalize (one C call on the card)."""
    if not _check("vrp_sum", (x,)):
        return ref.vrp_finalize(ref.vrp_sum_lanes(x))
    _, out, which = launch(x, x, False, "vrp_sum", final=True)
    _count(vrp_sum_lanes, which, True)
    return out


for _fn in (vrp_dot_lanes, vrp_sum_lanes):
    _fn.launches = 0
    _fn.launches_by_body = dict.fromkeys(BODIES, 0)
vrp_finalize.launches = 0
