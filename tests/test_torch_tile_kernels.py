"""The port's EPAC tile layer, kernel half: ``core.vec``, the
``core.stx`` cluster model and ``core.tiles`` policies and dispatch, and
the plain versions of kernels K6 (STX matmul), K7 (stencils) and K8
(compensated dot / sum) against the JAX package on the CPU.

  1. ``strip_mine`` / ``strip_reduce`` and ``VecTimingModel``,
     ``StxCluster``'s geometry and dispatch, ``TilePolicy`` validation
     and ``dispatch_matmul`` / ``dispatch_reduction`` (the vrp path
     bit-equal) against JAX's;
  2. K6's plain version within ``tests/test_kernels.py``'s tolerances of
     JAX's Pallas kernel in interpret mode; K7 and the K8 lanes
     ``torch.equal`` to it, and the finalized ``ops.vrp_dot`` /
     ``ops.vrp_sum`` equal to JAX's interpret-mode ops. JAX's
     interpret-mode stencil lets XLA:CPU fuse a product that rounds into
     the sum (the seven-point weight -6, random weights); there K7's
     plain version is held equal to JAX's oracle ``ref.stencil*`` and
     within test_kernels' tolerance of the kernel.

On the CPU every wrapper runs its plain version and counts no launch;
the kernels themselves are held on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stx as jstx
from repro.core import tiles as jtiles
from repro.core import vec as jvec
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.vrp_dot import vrp_dot_pallas, vrp_sum_pallas
from repro_torch import core
from repro_torch.core import stx, tiles, vec
from repro_torch.kernels import ops, ref
from repro_torch.kernels import stx_matmul as k6_mod
from repro_torch.kernels import stx_stencil as k7_mod
from repro_torch.kernels import vrp_dot as k8_mod

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(got, want):
    """torch.equal against a JAX / numpy result (values: -0 == 0)."""
    want = _t(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (
        got.dtype, want.dtype, got.shape, want.shape)
    assert torch.equal(got, want), (got - want).abs().max().item()


# ---------------------------------------------------------------------------
# 1. vec, stx, tiles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,max_vl", [(1, 8), (37, 8), (64, 16), (100, 256)])
def test_strip_mine_and_reduce_equal_jax(n, max_vl):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 3)).astype(np.float32)

    def fn(v):
        return v * 2.0 + 1.0

    _same(vec.strip_mine(fn, _t(x), max_vl),
          jvec.strip_mine(fn, jnp.asarray(x), max_vl))
    _same(vec.strip_mine(fn, _t(x), max_vl, out_dtype=torch.float64),
          jvec.strip_mine(fn, jnp.asarray(x), max_vl, out_dtype=jnp.float64))

    def red(acc, strip, mask):
        return acc + (strip * mask[:, None]).sum(0)

    # small integers: every sum is exact, whatever the order
    xi = rng.integers(-50, 50, size=(n, 3)).astype(np.float32)
    got = vec.strip_reduce(red, _t(xi), max_vl, torch.zeros(3))
    _same(got, jvec.strip_reduce(red, jnp.asarray(xi), max_vl,
                                 jnp.zeros(3, jnp.float32)))
    _same(got, xi.sum(0))


def test_vec_timing_model_equals_jax():
    mine, theirs = vec.VecTimingModel(), jvec.VecTimingModel()
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    for vl in (1, 7, 8, 64, 255, 256):
        assert mine.vop_cycles(vl) == theirs.vop_cycles(vl)
        assert mine.utilization(vl) == theirs.utilization(vl)
        assert mine.gflops(vl) == theirs.gflops(vl)
    assert mine.vop_cycles(256) == 35


@pytest.mark.parametrize("tcdm_kb", [64, 128, 256])
def test_stx_cluster_geometry_equals_jax(tcdm_kb):
    mine = stx.StxCluster(tcdm_kb=tcdm_kb)
    theirs = jstx.StxCluster(tcdm_kb=tcdm_kb)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.peak_gflops == theirs.peak_gflops
    for td, jd in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        assert mine.matmul_blocks(td) == theirs.matmul_blocks(jd)
        assert mine.stencil_blocks(td) == theirs.stencil_blocks(jd)
        bm, bn, bk = mine.matmul_blocks(td)
        assert mine.working_set_kb(bm, bn, bk, td) == theirs.working_set_kb(
            bm, bn, bk, jd)
    assert stx.DEFAULT_CLUSTER.peak_gflops == 64.0


def test_stx_cluster_dispatch_matches_jax_oracles():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(48, 32)).astype(np.float32)
    w = rng.normal(size=(32, 40)).astype(np.float32)
    np.testing.assert_allclose(stx.DEFAULT_CLUSTER.matmul(_t(x), _t(w)).numpy(),
                               np.asarray(jref.matmul(jnp.asarray(x),
                                                      jnp.asarray(w))),
                               rtol=1e-5, atol=1e-4)
    g = rng.normal(size=(64, 64)).astype(np.float32)
    w5 = ref.five_point_weights()
    _same(stx.DEFAULT_CLUSTER.stencil2d(_t(g), w5),
          jref.stencil2d(jnp.asarray(g), jref.five_point_weights()))
    v = rng.normal(size=(6, 10, 12)).astype(np.float32)
    _same(stx.DEFAULT_CLUSTER.stencil3d(_t(v), ref.seven_point_weights()),
          jref.stencil3d(jnp.asarray(v), jref.seven_point_weights()))


def test_tile_policies_mirror_jax():
    assert tiles.OP_CLASSES == jtiles.OP_CLASSES
    assert tiles.VALID_TILES == jtiles.VALID_TILES
    for mine, theirs in ((tiles.DEFAULT_POLICY, jtiles.DEFAULT_POLICY),
                         (tiles.STX_POLICY, jtiles.STX_POLICY),
                         (core.TilePolicy(), jtiles.TilePolicy())):
        for cls in tiles.OP_CLASSES + ("vrp_env",):
            assert getattr(mine, cls) == getattr(theirs, cls)
        for cls in tiles.OP_CLASSES:
            assert mine.tile_for(cls) == theirs.tile_for(cls)


@pytest.mark.parametrize("field", tiles.OP_CLASSES)
def test_tile_policy_validation(field):
    with pytest.raises(ValueError):
        jtiles.TilePolicy(**{field: "gpu"})
    with pytest.raises(ValueError, match=field):
        tiles.TilePolicy(**{field: "gpu"})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_matmul_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 24, 32)).astype(np.float32)
    w = rng.normal(size=(32, 64)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    X, W = _t(x).to(tdt), _t(w).to(tdt)
    want = np.asarray(jtiles.dispatch_matmul(
        jnp.asarray(x, jdt), jnp.asarray(w, jdt), jtiles.DEFAULT_POLICY),
        np.float32)
    tol = dict(rtol=1e-5, atol=1e-4) if dtype == "float32" else \
        dict(rtol=2e-2, atol=2e-1)
    n0 = k6_mod.stx_matmul.launches
    for policy in (tiles.DEFAULT_POLICY, tiles.STX_POLICY):
        got = tiles.dispatch_matmul(X, W, policy)
        assert got.dtype == tdt and got.shape == (2, 24, 64)
        np.testing.assert_allclose(got.float().numpy(), want, **tol)
    assert k6_mod.stx_matmul.launches == n0     # CPU: the plain version


def test_dispatch_reduction_equals_jax():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(16, 12)) * 1e4).astype(np.float32)
    vrp_policy = tiles.TilePolicy(reduction="vrp", vrp_env="vp128")
    jvrp_policy = jtiles.TilePolicy(reduction="vrp", vrp_env="vp128")
    _same(tiles.dispatch_reduction(_t(x), vrp_policy),
          jtiles.dispatch_reduction(jnp.asarray(x), jvrp_policy))
    _same(tiles.dispatch_reduction(_t(x), vrp_policy, axis=1),
          jtiles.dispatch_reduction(jnp.asarray(x), jvrp_policy, axis=1))
    np.testing.assert_allclose(
        tiles.dispatch_reduction(_t(x), tiles.DEFAULT_POLICY).numpy(),
        np.asarray(jtiles.dispatch_reduction(jnp.asarray(x),
                                             jtiles.DEFAULT_POLICY)),
        rtol=1e-5)
    exact = float(np.sum(x.astype(np.float64)))
    vec_sum = float(tiles.dispatch_reduction(_t(x), tiles.DEFAULT_POLICY))
    vrp_sum = float(tiles.dispatch_reduction(_t(x), vrp_policy))
    assert abs(vrp_sum - exact) <= abs(vec_sum - exact) + 1e-3


# ---------------------------------------------------------------------------
# 2. the plain versions of K6, K7, K8 against JAX's kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [(32, 16, 32), (70, 50, 130),
                                   (128, 128, 128), (1, 7, 300)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k6_plain_matches_pallas_interpret(m, k, n, dtype):
    rng = np.random.default_rng(m * 7 + n)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = jnp.asarray(rng.normal(size=(m, k)), jdt)
    w = jnp.asarray(rng.normal(size=(k, n)), jdt)
    interp = jops.stx_matmul(x, w, block_m=32, block_n=64, block_k=16,
                             mode="interpret")
    X = _t(np.asarray(x.astype(jnp.float32))).to(tdt)
    W = _t(np.asarray(w.astype(jnp.float32))).to(tdt)
    got = ops.stx_matmul(X, W)
    assert got.dtype == tdt and got.shape == (m, n)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for ref_out in (interp, jref.matmul(x, w)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref_out, np.float32),
                                   rtol=tol, atol=tol * 10)
    f32 = ops.stx_matmul(X, W, out_dtype=torch.float32)
    np.testing.assert_allclose(
        f32.numpy(), np.asarray(jref.matmul(x, w, out_dtype=jnp.float32)),
        rtol=1e-5, atol=1e-4)


def test_k6_plain_batched_lead_matches_pallas_interpret():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 40)).astype(np.float32)
    w = rng.normal(size=(40, 24)).astype(np.float32)
    want = jops.stx_matmul(jnp.asarray(x), jnp.asarray(w), block_m=16,
                           block_n=16, block_k=16, mode="interpret")
    got = ops.stx_matmul(_t(x), _t(w))
    assert got.shape == (3, 5, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def _weights2(kind, rng):
    if kind == "five_point":
        return np.asarray(jref.five_point_weights())
    if kind == "ones":
        return np.ones((3, 3), np.float32)
    return rng.normal(size=(3, 3)).astype(np.float32)


@pytest.mark.parametrize("shape", [(64, 64), (65, 70), (128, 33)])
@pytest.mark.parametrize("kind", ["five_point", "ones", "random"])
def test_k7a_plain_equals_pallas_interpret_and_oracle(shape, kind):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    w = _weights2(kind, rng)
    got = ops.stencil2d(_t(x), _t(w))
    _same(got, jref.stencil2d(jnp.asarray(x), jnp.asarray(w)))
    interp = jops.stencil2d(jnp.asarray(x), jnp.asarray(w), block_m=32,
                            block_n=32, mode="interpret")
    if kind == "random":        # XLA:CPU fuses the rounded product
        np.testing.assert_allclose(got.numpy(), np.asarray(interp),
                                   rtol=1e-5, atol=1e-5)
    else:
        _same(got, interp)


@pytest.mark.parametrize("shape", [(8, 16, 32), (9, 20, 33), (3, 5, 7)])
@pytest.mark.parametrize("kind", ["seven_point", "random"])
def test_k7b_plain_equals_oracle_and_matches_interpret(shape, kind):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    w = (np.asarray(jref.seven_point_weights()) if kind == "seven_point"
         else rng.normal(size=(3, 3, 3)).astype(np.float32))
    got = ops.stencil3d(_t(x), _t(w))
    _same(got, jref.stencil3d(jnp.asarray(x), jnp.asarray(w)))
    interp = jops.stencil3d(jnp.asarray(x), jnp.asarray(w), block_d=4,
                            block_m=8, block_n=16, mode="interpret")
    np.testing.assert_allclose(got.numpy(), np.asarray(interp), rtol=1e-5,
                               atol=1e-5)


def test_k7_plain_batches_leading_dims_and_keeps_bf16():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 10, 12)).astype(np.float32)
    w5, w7 = ref.five_point_weights(), ref.seven_point_weights()
    got = ops.stencil2d(_t(x), w5)
    for i in range(2):
        for j in range(3):
            assert torch.equal(got[i, j], ops.stencil2d(_t(x[i, j]), w5))
    got3 = ops.stencil3d(_t(x), w7)
    assert torch.equal(got3[1], ops.stencil3d(_t(x[1]), w7))
    xb = _t(x[0, 0]).to(torch.bfloat16)
    out = ops.stencil2d(xb, w5)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, ops.stencil2d(xb.float(), w5).to(torch.bfloat16))


def test_stencil_weights_equal_jax():
    _same(ref.five_point_weights(), jref.five_point_weights())
    _same(ref.seven_point_weights(), jref.seven_point_weights())
    _same(ref.five_point_weights(torch.float64),
          jref.five_point_weights(jnp.float64))


@pytest.mark.parametrize("n", [1024, 3 * 1024, 3000, 5000, 1])
def test_k8_lanes_equal_pallas_interpret(n):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=n) * 1e4).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    pad = -(-n // 1024) * 1024 - n
    xp, yp = jnp.asarray(np.pad(x, (0, pad))), jnp.asarray(np.pad(y, (0, pad)))
    n0 = (k8_mod.vrp_dot_lanes.launches, k8_mod.vrp_sum_lanes.launches)
    _same(k8_mod.vrp_dot_lanes(_t(x), _t(y)),
          vrp_dot_pallas(xp, yp, interpret=True))
    _same(k8_mod.vrp_sum_lanes(_t(x)), vrp_sum_pallas(xp, interpret=True))
    assert (k8_mod.vrp_dot_lanes.launches,
            k8_mod.vrp_sum_lanes.launches) == n0     # CPU: the plain version


@pytest.mark.parametrize("n,scale", [(3000, 1e4), (2048, 1e6)])
def test_k8_finalized_equals_jax_interpret_ops(n, scale):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=n) * scale).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    _same(ops.vrp_dot(_t(x), _t(y)),
          jops.vrp_dot(jnp.asarray(x), jnp.asarray(y), mode="interpret"))
    _same(ops.vrp_sum(_t(x)), jops.vrp_sum(jnp.asarray(x), mode="interpret"))
    _same(ref.vrp_dot(_t(x), _t(y)),
          jref.vrp_dot(jnp.asarray(x), jnp.asarray(y)))
    _same(ref.vrp_sum(_t(x)), jref.vrp_sum(jnp.asarray(x)))


def test_k8_dot_beats_naive():
    """tests/test_kernels.py's accuracy check, through the port."""
    rng = np.random.default_rng(0)
    n = 3000
    x = (rng.normal(size=n) * 1e4).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    exact = float(np.dot(x.astype(np.float64), y.astype(np.float64)))
    naive_err = abs(float(torch.dot(_t(x), _t(y))) - exact)
    d = ops.vrp_dot(_t(x), _t(y))
    assert abs(float(d[0]) + float(d[1]) - exact) < max(naive_err / 100, 1e-8)


@pytest.mark.parametrize("fn,args,match", [
    (k8_mod.vrp_dot_lanes, lambda: (torch.ones(8, dtype=torch.float64),
                                    torch.ones(8, dtype=torch.float64)),
     "float32"),
    (k8_mod.vrp_sum_lanes, lambda: (torch.ones(8, dtype=torch.bfloat16),),
     "float32"),
    (k8_mod.vrp_dot_lanes, lambda: (torch.ones(8), torch.ones(9)), "length"),
    (k8_mod.vrp_sum_lanes, lambda: (torch.ones(2, 4),), "flat"),
    (k6_mod.stx_matmul, lambda: (torch.ones(3, 4), torch.ones(5, 2)), "(K, N)"),
    (k6_mod.stx_matmul, lambda: (torch.ones(4), torch.ones(4, 2)), "(M, K)"),
])
def test_kernel_wrappers_reject_bad_inputs(fn, args, match):
    with pytest.raises(ValueError, match=match.replace("(", r"\(")
                       .replace(")", r"\)")):
        fn(*args())


def test_k7_wrappers_run_plain_version_on_cpu():
    x = torch.randn(5, 6, generator=torch.Generator().manual_seed(0))
    n0 = (k7_mod.stencil2d.launches, k7_mod.stencil3d.launches)
    assert torch.equal(k7_mod.stencil2d(x, ref.five_point_weights()),
                       ref.stencil2d(x, ref.five_point_weights()))
    assert torch.equal(k7_mod.stencil3d(x[None], ref.seven_point_weights()),
                       ref.stencil3d(x[None], ref.seven_point_weights()))
    assert (k7_mod.stencil2d.launches, k7_mod.stencil3d.launches) == n0
