"""Tile registry & dispatch — the EPAC heterogeneity made software.

Counterpart of ``repro/core/tiles.py``. A *tile* is an execution
strategy for an operator class, selectable per-op and per-model:

  VEC — general path: plain PyTorch (the vendor library; JAX's XLA
        einsum, the analogue of the LLVM-EPI auto-vectorizer).
  STX — explicit-data-movement path: the hand-written kernels (K6, K7).
  VRP — extended-precision path: expansion arithmetic for numerically
        sensitive reductions and solvers.

A TilePolicy maps operator classes -> tile. JAX's policy also carries
``interpret`` and the ``stx_block_*`` geometry; the port has neither:
the device of the tensors decides (a CUDA tensor launches the kernel, a
CPU tensor runs its plain version), as the port's ``RunCtx`` does, and
each kernel fixes its own tile.
"""

from __future__ import annotations

import dataclasses

import torch

VALID_TILES = ("vec", "stx", "vrp")
OP_CLASSES = ("matmul", "attention", "stencil", "scan", "reduction")


@dataclasses.dataclass(frozen=True)
class TilePolicy:
    """Operator-class -> tile assignment (hashable)."""

    matmul: str = "vec"
    attention: str = "vec"
    stencil: str = "stx"
    scan: str = "vec"
    reduction: str = "vec"
    # VRP environment preset for 'vrp' reductions.
    vrp_env: str = "vp128"

    def __post_init__(self):
        for cls in OP_CLASSES:
            tile = getattr(self, cls)
            if tile not in VALID_TILES:
                raise ValueError(f"{cls}: unknown tile {tile!r}")

    def tile_for(self, op_class: str) -> str:
        return getattr(self, op_class)


# Paper-faithful default: general work on VEC, stencils on STX.
DEFAULT_POLICY = TilePolicy()
# All-STX policy: every hot op through the hand-written kernels.
STX_POLICY = TilePolicy(matmul="stx", attention="stx", scan="stx")


def dispatch_matmul(x, w, policy: TilePolicy):
    """Matmul (..., K) @ (K, N) through the policy's tile."""
    if policy.tile_for("matmul") == "stx":
        from ..kernels import ops as kops

        return kops.stx_matmul(x, w)
    return torch.matmul(x, w)


def dispatch_reduction(x, policy: TilePolicy, axis=None):
    """Sum-reduction; 'vrp' uses compensated (expansion) accumulation
    through ``vrp.sum_floats`` (plain torch on any device: no kernel)."""
    if policy.tile_for("reduction") == "vrp":
        from . import vrp
        from .precision import get_env

        env = get_env(policy.vrp_env)
        flat = x.reshape(-1) if axis is None else torch.movedim(x, axis, 0)
        return vrp.to_float(vrp.sum_floats(flat.to(env.dtype), env)).to(x.dtype)
    return torch.sum(x) if axis is None else torch.sum(x, dim=axis)
