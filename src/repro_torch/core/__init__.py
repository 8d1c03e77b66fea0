"""core — the paper's contribution: tiles (VEC/STX/VRP) + uncore model.

Counterpart of ``repro/core``: precision environments, VRP expansion
arithmetic, VBLAS, Krylov solvers, the VEC strip-mining discipline, the
STX cluster, the tile policy and ``noc``, the uncore's transfer-time
model (its ``FabricSpec`` has no default figures: the caller names the
fabric). ``compat`` (JAX version shims) has nothing to port.
"""

from .precision import F64, VP128, VP256, VP512, PrecisionEnv, get_env
from .tiles import DEFAULT_POLICY, STX_POLICY, TilePolicy

__all__ = [
    "F64", "VP128", "VP256", "VP512", "PrecisionEnv", "get_env",
    "TilePolicy", "DEFAULT_POLICY", "STX_POLICY",
]
