"""STX tile executor — the paper's cluster model and its dispatch.

Counterpart of ``repro/core/stx.py``. The silicon STX tile is
parameterized: 4 clusters x (4-16 compute cores + 1 DMA core) x 64-256
kB TCDM scratchpad. ``StxCluster`` keeps that parameterization and the
JAX package's geometry arithmetic (``matmul_blocks``, ``stencil_blocks``,
``working_set_kb``: the blocks a TCDM-sized VMEM budget would allow),
so both packages report the same numbers.

Its ``matmul``, ``stencil2d`` and ``stencil3d`` reach the port's kernels
(K6, K7a, K7b on a CUDA tensor, their plain versions on a CPU one)
through ``kernels/ops.py``, without the TPU's block arguments: each CUDA
kernel fixes its own tile and masks its ragged edge, as the port's K1
dropped ``block_q`` / ``block_k``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class StxCluster:
    """Paper-faithful defaults: 4 clusters x 8 cores @ 1 GHz, 256 kB."""

    n_clusters: int = 4
    cores_per_cluster: int = 8
    tcdm_kb: int = 256          # per-cluster scratchpad (VMEM analogue)
    freq_ghz: float = 1.0
    flops_per_core_cycle: int = 2   # DP FMA

    @property
    def peak_gflops(self) -> float:
        """The paper's 64 DP GFLOPS/tile claim at the defaults."""
        return (self.n_clusters * self.cores_per_cluster
                * self.flops_per_core_cycle * self.freq_ghz)

    # -- geometry ---------------------------------------------------------

    def matmul_blocks(self, dtype=torch.float32) -> tuple:
        """Largest MXU-aligned square blocks with x/w/acc in budget."""
        itemsize = dtype.itemsize
        b = 128
        while 3 * (2 * b) ** 2 * itemsize <= self.tcdm_kb * 1024 * 4:
            b *= 2
        return b, b, b

    def stencil_blocks(self, dtype=torch.float32) -> tuple:
        itemsize = dtype.itemsize
        bm = bn = 128
        while 2 * (2 * bm + 2) * (bn + 2) * itemsize <= self.tcdm_kb * 1024 * 4:
            bm *= 2
        return bm, bn

    def working_set_kb(self, block_m: int, block_n: int, block_k: int,
                       dtype=torch.float32) -> float:
        itemsize = dtype.itemsize
        return (block_m * block_k + block_k * block_n
                + block_m * block_n) * itemsize / 1024

    # -- dispatch ---------------------------------------------------------

    def matmul(self, x, w, out_dtype=None):
        return kops.stx_matmul(x, w, out_dtype=out_dtype)

    def stencil2d(self, x, weights):
        return kops.stencil2d(x, weights)

    def stencil3d(self, x, weights):
        return kops.stencil3d(x, weights)


DEFAULT_CLUSTER = StxCluster()
