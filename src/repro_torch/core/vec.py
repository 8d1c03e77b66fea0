"""VEC tile — vector-length-agnostic (VLA) execution discipline.

Counterpart of ``repro/core/vec.py``. The VEC tile's defining software
property (RVV 0.7.1): code sets a desired vector length, hardware grants
up to its maximum, and loops of *arbitrary* size run with no scalar tail
handling. The VPU retires a 256-element double-precision vop in 32
cycles through 8 parallel FAUST lanes.

  * ``strip_mine``    — apply a lane-width kernel over an arbitrary-length
    array with masked tails (vsetvl semantics), as a loop over strips
    (JAX's ``lax.scan``).
  * ``VecTimingModel`` — the paper's cycle model (8 lanes x 8 elem/cycle,
    ~3-cycle decode overhead).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F


def _strips(x, max_vl):
    """x (n, ...) zero-padded to whole strips -> (n_strips, max_vl, ...)."""
    n = x.shape[0]
    n_strips = -(-n // max_vl)
    pad = n_strips * max_vl - n
    xp = F.pad(x, [0, 0] * (x.dim() - 1) + [0, pad])
    return xp.reshape((n_strips, max_vl) + tuple(x.shape[1:]))


def strip_mine(fn: Callable, x: torch.Tensor, max_vl: int, *,
               out_dtype=None):
    """Apply ``fn`` (vector -> vector, same length) VLA-style.

    Processes ``x`` (n, ...) in strips of ``max_vl`` with a masked final
    strip — no scalar tail (vsetvl analogue: the grant is
    min(max_vl, remaining)).
    """
    n = x.shape[0]
    outs = []
    for i, strip in enumerate(_strips(x, max_vl)):
        vl = min(max_vl, n - i * max_vl)       # granted vector length
        mask = torch.arange(max_vl, device=x.device) < vl
        out = fn(strip)
        outs.append(torch.where(
            mask.reshape((max_vl,) + (1,) * (out.dim() - 1)), out, 0))
    ys = torch.cat(outs, dim=0)
    return ys[:n].to(out_dtype or ys.dtype)


def strip_reduce(fn: Callable, x: torch.Tensor, max_vl: int, init):
    """VLA-style reduction: fold strips through ``fn(acc, strip, mask)``."""
    n = x.shape[0]
    acc = init
    for i, strip in enumerate(_strips(x, max_vl)):
        mask = torch.arange(max_vl, device=x.device) < (n - i * max_vl)
        acc = fn(acc, strip, mask)
    return acc


@dataclasses.dataclass(frozen=True)
class VecTimingModel:
    """Cycle model of the EPAC VPU (§3.1).

    A vector arithmetic instruction on VL elements takes
    ``ceil(VL / (lanes * elems_per_lane)) + decode_overhead`` cycles; a full
    256-element vop = 32 + ~3 cycles.
    """

    lanes: int = 8
    elems_per_lane_cycle: int = 1
    max_vl_elems: int = 256          # 2048 B / 8 B per f64
    decode_overhead_cycles: int = 3
    freq_ghz: float = 1.0

    def vop_cycles(self, vl: int) -> int:
        per_cycle = self.lanes * self.elems_per_lane_cycle
        return -(-vl // per_cycle) + self.decode_overhead_cycles

    def utilization(self, vl: int) -> float:
        """Fraction of lane-cycles doing useful work at vector length vl."""
        per_cycle = self.lanes * self.elems_per_lane_cycle
        return vl / (self.vop_cycles(vl) * per_cycle)

    def gflops(self, vl: int, flops_per_elem: int = 2) -> float:
        return (vl * flops_per_elem * self.freq_ghz) / self.vop_cycles(vl)
