"""The ring bodies of K5 (the RG-LRU scan) and K7b (the 3x3x3 stencil),
on the CPU, without JAX:

  1. ``rglru_scan.body`` and ``stx_stencil.body3d`` pick "ring" or
     "simt" from dtype, shape and alignment alone, on CPU and meta
     tensors;
  2. on CPU tensors the wrappers run the plain versions and count no
     launch.

The kernels themselves, and the rings' geometry (set on the C side),
are held on the card (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as k5
from repro_torch.kernels import stx_stencil as k7


def _buf(n, dtype, device):
    return torch.zeros(n, dtype=dtype, device=device)


# -- 1. the body from dtype, shape and alignment ---------------------------


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("shape,dtype,offset,want", [
    ((2, 2560, 2560), torch.float32, 0, "ring"),
    ((8, 512, 2560), torch.float32, 0, "ring"),
    ((3, 100, 40), torch.float32, 0, "ring"),        # 160-byte rows
    ((2, 300, 512), torch.bfloat16, 0, "ring"),
    ((1, 1, 8), torch.bfloat16, 0, "ring"),          # one 16-byte row
    ((2, 37, 2561), torch.float32, 0, "simt"),       # 10244-byte rows
    ((1, 1, 5), torch.float32, 0, "simt"),
    ((1, 1, 4), torch.bfloat16, 0, "simt"),          # 8-byte rows
    ((2, 300, 2560), torch.float32, 1, "simt"),      # 4 bytes off 16
    ((2, 300, 2560), torch.float32, 4, "ring"),      # 16 bytes: aligned
    ((2, 300, 2560), torch.bfloat16, 4, "simt"),     # 8 bytes off 16
])
def test_k5_body_from_dtype_shape_alignment(device, shape, dtype, offset,
                                            want):
    n = int(np.prod(shape))
    x = _buf(n + offset, dtype, device)[offset:].view(shape)
    a = _buf(n, dtype, device).view(shape)
    assert k5.body(a, x) == want
    assert k5.body(x, a) == want


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("shape,dtype,offset,want", [
    ((512, 512, 512), torch.float32, 0, "ring"),
    ((2, 33, 8, 64), torch.float32, 0, "ring"),
    ((70, 9, 64), torch.float32, 0, "ring"),
    ((3, 1, 1, 4), torch.float32, 0, "ring"),
    ((9, 20, 33), torch.float32, 0, "simt"),         # N % 4 != 0
    ((70, 9, 65), torch.float32, 0, "simt"),
    ((1, 1, 1), torch.float32, 0, "simt"),
    ((70, 9, 64), torch.float32, 1, "simt"),         # 4 bytes off 16
    ((70, 9, 64), torch.float32, 4, "ring"),
    ((70, 9, 64), torch.bfloat16, 0, "simt"),        # f32 only
    ((64, 64), torch.float32, 0, "simt"),            # not a volume
])
def test_k7b_body_from_dtype_shape_alignment(device, shape, dtype, offset,
                                             want):
    n = int(np.prod(shape))
    x = _buf(n + offset, dtype, device)[offset:].view(shape)
    assert k7.body3d(x) == want


# -- 2. the CPU runs the plain versions and launches nothing ----------------


def test_cpu_tensors_run_plain_and_count_nothing():
    gen = torch.Generator().manual_seed(0)
    a = 0.8 + 0.2 * torch.rand((2, 40, 64), generator=gen)
    x = torch.randn((2, 40, 64), generator=gen)
    vol = torch.randn((9, 7, 12), generator=gen)
    w7 = ref.seven_point_weights()
    n0 = (k5.rglru_scan.launches, dict(k5.rglru_scan.launches_by_body),
          dict(k5.rglru_scan.launches_by_shape),
          k7.stencil3d.launches, dict(k7.stencil3d.launches_by_body))
    assert torch.equal(ops.rglru_scan(a, x), ref.linear_scan(a, x))
    assert torch.equal(k5.rglru_scan(a, x), ref.linear_scan(a, x))
    assert torch.equal(ops.stencil3d(vol, w7), ref.stencil3d(vol, w7))
    assert torch.equal(k7.stencil3d(vol, w7), ref.stencil3d(vol, w7))
    assert (k5.rglru_scan.launches, dict(k5.rglru_scan.launches_by_body),
            dict(k5.rglru_scan.launches_by_shape), k7.stencil3d.launches,
            dict(k7.stencil3d.launches_by_body)) == n0
    assert set(k5.rglru_scan.launches_by_body) == {"ring", "simt"}
    assert set(k7.stencil3d.launches_by_body) == {"ring", "simt"}
