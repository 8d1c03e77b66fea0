"""K8's finalize and the body chooser of its lane kernel, on the CPU.

  1. ``ref.vrp_finalize_pairs`` (the finalize kernel's order as a scalar
     loop over float32 values) equals the torch tree
     ``ops._finalize_expansion`` and JAX's
     ``repro.kernels.ops._finalize_expansion`` bit for bit, on random
     lanes, on real lanes of the plain dot / sum, and on adversarial
     lanes: pairs that cancel exactly, magnitudes from 1e-30 to 1e30, all
     zeros. Subnormal lanes are held to the torch tree only: XLA:CPU
     flushes subnormals to zero, so JAX's tree reads them as zeros.
  2. ``ops.vrp_dot`` / ``ops.vrp_sum`` on CPU tensors (the plain lanes,
     then the tree) equal JAX's ops in ``mode="interpret"``, and launch
     nothing.
  3. ``vrp_dot.body`` picks "ring" or "simt" from n and the bases'
     alignment alone, on CPU and meta tensors.

The kernels themselves are held on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref
from repro_torch.kernels import vrp_dot as k8


def _bits(t):
    return np.asarray(t, dtype=np.float32).view(np.int32)


def _lanes(case):
    rng = np.random.default_rng(len(case))
    shape = (8, 128, 2)
    if case == "random":
        v = rng.normal(size=shape) * 10.0 ** rng.integers(-5, 5, size=shape)
    elif case in ("real_dot", "real_sum"):
        x = torch.from_numpy((rng.normal(size=5000) * 1e4).astype(np.float32))
        y = torch.from_numpy(rng.normal(size=5000).astype(np.float32))
        return (ref.vrp_dot_lanes(x, y) if case == "real_dot"
                else ref.vrp_sum_lanes(x)).numpy()
    elif case == "cancel":
        v = rng.normal(size=shape) * 1e20
        q = v.reshape(-1, 4)
        q[:, 2:] = -q[:, :2]           # pair 2k + 1 = -(pair 2k)
        q[::3, 3] *= 0.5
    elif case == "magnitudes":
        v = rng.choice([-1.0, 1.0], size=shape) \
            * 10.0 ** rng.uniform(-30, 30, size=shape)
    elif case == "subnormals":
        v = rng.normal(size=shape) * 1e-40
    else:
        v = np.zeros(shape)
    return v.astype(np.float32)


@pytest.mark.parametrize("case", ["random", "real_dot", "real_sum", "cancel",
                                  "magnitudes", "zeros", "subnormals"])
def test_finalize_order_equals_tree_and_jax(case):
    lanes = _lanes(case)
    got = ref.vrp_finalize_pairs(torch.from_numpy(lanes))
    tree = ops._finalize_expansion(torch.from_numpy(lanes))
    assert got.shape == (2,) and got.dtype == torch.float32
    assert (_bits(got) == _bits(tree)).all()
    assert (_bits(k8.vrp_finalize(torch.from_numpy(lanes)))
            == _bits(tree)).all()                  # CPU: the plain tree
    if case != "subnormals":
        assert (_bits(got) == _bits(jops._finalize_expansion(
            jnp.asarray(lanes)))).all()


@pytest.mark.parametrize("n", [1, 1023, 1024, 4097])
def test_ops_on_cpu_equal_jax_interpret_and_launch_nothing(n):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=n) * 1e4).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    n0 = (k8.vrp_dot_lanes.launches, k8.vrp_sum_lanes.launches,
          k8.vrp_finalize.launches, dict(k8.vrp_dot_lanes.launches_by_body))
    dot = ops.vrp_dot(torch.from_numpy(x), torch.from_numpy(y))
    tot = ops.vrp_sum(torch.from_numpy(x))
    assert (_bits(dot) == _bits(jops.vrp_dot(
        jnp.asarray(x), jnp.asarray(y), mode="interpret"))).all()
    assert (_bits(tot) == _bits(jops.vrp_sum(jnp.asarray(x),
                                             mode="interpret"))).all()
    assert (k8.vrp_dot_lanes.launches, k8.vrp_sum_lanes.launches,
            k8.vrp_finalize.launches,
            dict(k8.vrp_dot_lanes.launches_by_body)) == n0


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_body_from_length_and_alignment(device):
    buf = torch.empty(8192 + 8, device=device)
    assert k8.body(buf[:8192]) == "ring"
    assert k8.body(buf[:1024]) == "ring"
    assert k8.body(buf[:1023]) == "simt"          # no whole row of lanes
    assert k8.body(buf[1:1 + 8192]) == "simt"     # 4 bytes off 16
    assert k8.body(buf[4:4 + 8192]) == "ring"     # 16 bytes: aligned again
    assert k8.body(buf[:8192], buf[4:4 + 8192]) == "ring"
    assert k8.body(buf[:8192], buf[2:2 + 8192]) == "simt"   # y decides too


def test_finalize_rejects_other_shapes():
    with pytest.raises(ValueError, match="8, 128, 2"):
        k8.vrp_finalize(torch.zeros(1024, 2))
    with pytest.raises(ValueError, match="8, 128, 2"):
        k8.vrp_finalize(torch.zeros((8, 128, 2), dtype=torch.float64))
