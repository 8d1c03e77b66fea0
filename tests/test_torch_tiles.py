"""The port's EPAC tile layer, arithmetic half: ``repro_torch.core``'s
precision, VRP expansions, VBLAS and Krylov solvers against the JAX
package on the CPU (the kernels, policies and cluster model are in
``test_torch_tile_kernels.py``).

  1. ``core.precision`` and ``core.vrp``: presets field for field, and
     every expansion op (EFTs, renormalize, add / mul / div / sqrt,
     tree_sum, dot, matvec) equal to JAX's bit for bit at f64 and f32
     (``torch.equal``);
  2. ``core.vblas`` bit for bit, and the Krylov solvers (cg, pcg,
     bicgstab) on the same numpy matrices, run by JAX op by op
     (``jax.disable_jit()``): equal iteration counts, equal residuals
     and x equal bit for bit (and so within 1e-12 relative). JAX's
     jitted solvers differ: inside a fused loop XLA:CPU contracts a
     product and a sum into one fused multiply-add (in Dekker's
     two_prod of a negated operand, for one), so two_prod stops being
     error-free there and the iterates drift apart; against jitted CG
     the port is held as ``tests/test_solvers.py`` holds JAX (converged,
     x near the true solution) in at most two iterations more, and each
     of test_solvers' claims is held on the port.

Inputs are made by numpy from a seed and fed to both packages;
``tests/conftest.py`` enables x64, so JAX gets explicit dtypes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import precision as jprec
from repro.core import solvers as jsolvers
from repro.core import vblas as jvblas
from repro.core import vrp as jvrp
from repro_torch import core
from repro_torch.core import precision, solvers, vblas, vrp

torch.set_num_threads(1)

ENVS = ("f64", "vp128", "vp256", "vp512")
F32_ENV = dict(compute_terms=2, base_dtype="float32")


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(got, want):
    """torch.equal against a JAX / numpy result (values: -0 == 0)."""
    want = _t(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (
        got.dtype, want.dtype, got.shape, want.shape)
    assert torch.equal(got, want), (got - want).abs().max().item()


def _envs(name):
    if name == "f32":
        return precision.PrecisionEnv(**F32_ENV), jprec.PrecisionEnv(**F32_ENV)
    return precision.PRESETS[name], jprec.PRESETS[name]


def _wide(rng, shape, dtype=np.float64):
    """Normal values over ~20 decades, signs mixed, none subnormal."""
    return (rng.normal(size=shape) * 10.0 ** rng.integers(-10, 10, shape)
            ).astype(dtype)


def _expansion(rng, shape, K, dtype=np.float64):
    """A random K-term expansion (terms of decreasing magnitude)."""
    step = 1e-16 if dtype == np.float64 else 1e-7
    return (rng.normal(size=shape + (K,)) * step ** np.arange(K)
            * 10.0 ** rng.integers(-3, 3, shape + (1,))).astype(dtype)


# ---------------------------------------------------------------------------
# 1. precision and vrp
# ---------------------------------------------------------------------------


def test_precision_presets_mirror_jax_field_for_field():
    assert set(precision.PRESETS) == set(jprec.PRESETS)
    for name, env in precision.PRESETS.items():
        jenv = jprec.PRESETS[name]
        assert dataclasses.asdict(env) == dataclasses.asdict(jenv)
        assert (env.K, env.significand_bits, env.splitter, env.eps) == (
            jenv.K, jenv.significand_bits, jenv.splitter, jenv.eps)
        assert env.dtype == torch.float64
        assert dataclasses.asdict(env.storage()) == dataclasses.asdict(
            jenv.storage())
    f32 = precision.PrecisionEnv(**F32_ENV)
    assert f32.dtype == torch.float32
    assert f32.significand_bits == jprec.PrecisionEnv(**F32_ENV).significand_bits
    assert precision.get_env("vp128") is precision.VP128
    assert precision.get_env(f32) is f32
    assert core.VP512.significand_bits >= 512
    assert core.VP128.significand_bits == 106


@pytest.mark.parametrize("kw", [dict(compute_terms=0),
                                dict(compute_terms=2, store_terms=3),
                                dict(base_dtype="float16")])
def test_precision_env_rejects_what_jax_rejects(kw):
    with pytest.raises(ValueError):
        jprec.PrecisionEnv(**kw)
    with pytest.raises(ValueError):
        precision.PrecisionEnv(**kw)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_error_free_transforms_equal_jax(dtype):
    rng = np.random.default_rng(0)
    a, b = _wide(rng, 4096, dtype), _wide(rng, 4096, dtype)
    big, small = np.where(abs(a) >= abs(b), a, b), np.where(abs(a) >= abs(b), b, a)
    splitter = float(2**27 + 1) if dtype == np.float64 else float(2**12 + 1)
    for got, want in (
            (vrp.two_sum(_t(a), _t(b)), jvrp.two_sum(jnp.asarray(a), jnp.asarray(b))),
            (vrp.fast_two_sum(_t(big), _t(small)),
             jvrp.fast_two_sum(jnp.asarray(big), jnp.asarray(small))),
            (vrp._split(_t(a), splitter), jvrp._split(jnp.asarray(a), splitter)),
            (vrp.two_prod(_t(a), _t(b), splitter=splitter),
             jvrp.two_prod(jnp.asarray(a), jnp.asarray(b), splitter=splitter))):
        for g, w in zip(got, want):
            _same(g, w)


@pytest.mark.parametrize("M,K,passes", [(2, 1, None), (3, 2, None),
                                        (4, 2, None), (6, 5, 1), (8, 2, None),
                                        (20, 10, None), (50, 5, None),
                                        (12, 3, 4), (2, 5, None)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_renormalize_equals_jax(M, K, passes, dtype):
    rng = np.random.default_rng(M * 100 + K)
    terms = _wide(rng, (33, M), dtype)
    _same(vrp.renormalize(_t(terms), K, passes),
          jvrp.renormalize(jnp.asarray(terms), K, passes))


# JAX runs these op by op (each new shape compiles once), so the wide
# environments take only the ops that contain the others: div runs
# reciprocal, mul, sub and add; sqrt runs scale.
OPS = {"f64": "all", "f32": "all", "vp128": "all",
       "vp256": ("mul", "div", "sqrt"), "vp512": ("mul", "div")}


@pytest.mark.parametrize("name", ENVS + ("f32",))
def test_expansion_arithmetic_equals_jax(name):
    env, jenv = _envs(name)
    dt = np.float32 if name == "f32" else np.float64
    rng = np.random.default_rng(1)
    x = _expansion(rng, (7,), env.K, dt)
    y = _expansion(rng, (7,), env.K, dt)
    s = _wide(rng, 7, dt)
    X, Y, JX, JY = _t(x), _t(y), jnp.asarray(x), jnp.asarray(y)
    if OPS[name] != "all":
        for fn in OPS[name]:
            args = (X.abs(),) if fn == "sqrt" else (X, Y)
            jargs = (jnp.abs(JX),) if fn == "sqrt" else (JX, JY)
            _same(getattr(vrp, fn)(*args, env),
                  getattr(jvrp, fn)(*jargs, jenv))
        return
    for fn in ("add", "sub", "mul", "div"):
        _same(getattr(vrp, fn)(X, Y, env), getattr(jvrp, fn)(JX, JY, jenv))
    _same(vrp.add_float(X, _t(s), env), jvrp.add_float(JX, jnp.asarray(s), jenv))
    _same(vrp.scale(X, _t(s), env), jvrp.scale(JX, jnp.asarray(s), jenv))
    _same(vrp.reciprocal(Y, env), jvrp.reciprocal(JY, jenv))
    _same(vrp.sqrt(X.abs(), env), jvrp.sqrt(jnp.abs(JX), jenv))
    _same(vrp.to_float(X), jvrp.to_float(JX))
    _same(vrp.from_float(_t(s), env), jvrp.from_float(jnp.asarray(s), jenv))
    _same(vrp.zeros((3, 2), env), jvrp.zeros((3, 2), jenv))


@pytest.mark.parametrize("name", ("f64", "vp128", "f32"))
def test_reductions_equal_jax(name):
    env, jenv = _envs(name)
    dt = np.float32 if name == "f32" else np.float64
    rng = np.random.default_rng(2)
    a, b = _wide(rng, 13, dt), _wide(rng, 13, dt)
    A = rng.normal(size=(7, 13)).astype(dt)
    v = _expansion(rng, (13,), env.K, dt)
    w = _expansion(rng, (13,), env.K, dt)
    _same(vrp.dot_vp(_t(v), _t(w), env),
          jvrp.dot_vp(jnp.asarray(v), jnp.asarray(w), jenv))
    _same(vrp.matvec(_t(A), _t(v), env),
          jvrp.matvec(jnp.asarray(A), jnp.asarray(v), jenv))
    _same(vrp.dot(_t(a), _t(b), env), jvrp.dot(jnp.asarray(a), jnp.asarray(b), jenv))
    _same(vrp.sum_floats(_t(A), env, axis=1),
          jvrp.sum_floats(jnp.asarray(A), jenv, axis=1))
    ev = _expansion(rng, (5, 13), env.K, dt)
    _same(vrp.tree_sum(_t(ev), env, axis=1),
          jvrp.tree_sum(jnp.asarray(ev), jenv, axis=1))


@pytest.mark.parametrize("env_name,bits", [("vp128", 100), ("vp256", 200),
                                           ("vp512", 400)])
def test_dot_accuracy_scales_with_precision(env_name, bits):
    """tests/test_vrp.py's cancellation-heavy dot, through the port."""
    from fractions import Fraction

    env = precision.PRESETS[env_name]
    rng = np.random.default_rng(0)
    n = 2048
    x = rng.normal(size=n) * 1e10
    y = rng.normal(size=n)
    x[::2] = -x[1::2] * (1 + 1e-16)
    exact = sum(Fraction(float(a)) * Fraction(float(b)) for a, b in zip(x, y))
    got = sum(Fraction(float(t)) for t in vrp.dot(_t(x), _t(y), env))
    assert abs(got - exact) / (abs(exact) or 1) < Fraction(2) ** -bits


# ---------------------------------------------------------------------------
# 2. vblas and the solvers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ("f64", "vp128"))
def test_vblas_equals_jax(name):
    env, jenv = _envs(name)
    rng = np.random.default_rng(3)
    x, y = _expansion(rng, (13,), env.K), _expansion(rng, (13,), env.K)
    alpha = _expansion(rng, (), env.K)
    A = rng.normal(size=(7, 13))
    X, Y, JX, JY = _t(x), _t(y), jnp.asarray(x), jnp.asarray(y)
    _same(vblas.vcopy(X), jvblas.vcopy(JX))
    _same(vblas.vneg(X), jvblas.vneg(JX))
    _same(vblas.vaxpy(_t(alpha), X, Y, env),
          jvblas.vaxpy(jnp.asarray(alpha), JX, JY, jenv))
    _same(vblas.vscal(_t(alpha), X, env),
          jvblas.vscal(jnp.asarray(alpha), JX, jenv))
    _same(vblas.vdot(X, Y, env), jvblas.vdot(JX, JY, jenv))
    _same(vblas.vnrm2(X, env), jvblas.vnrm2(JX, jenv))
    _same(vblas.vgemv(_t(A), X, env), jvblas.vgemv(jnp.asarray(A), JX, jenv))
    p = rng.normal(size=13)
    _same(vblas.from_plain(_t(p), env), jvblas.from_plain(jnp.asarray(p), jenv))
    _same(vblas.to_plain(X), jvblas.to_plain(JX))


def _problem(kind):
    """(A, b) of tests/test_solvers.py's problems, as numpy."""
    if kind == "hilbert12":
        A = np.asarray(jsolvers.hilbert(12))
        return A, A @ np.ones(12)
    if kind == "nonsym":
        rng = np.random.default_rng(4)
        A = np.eye(24) * 4 + rng.normal(size=(24, 24)) * 0.3
        return A, A @ rng.normal(size=24)
    n, cond, seed = {"cond1e3": (32, 1e3, 0), "cond1e6": (24, 1e6, 3),
                     "cond1e8": (20, 1e8, 2)}[kind]
    A = np.asarray(jsolvers.hilbert_like(n, cond=cond, seed=seed))
    return A, A @ np.ones(n)


# JAX op by op is slow (~1 s an iteration at vp128), so the expansion
# runs are a few iterations deep; f64 CG runs to convergence.
@pytest.mark.parametrize("solver,kind,name,tol,maxiter", [
    ("cg", "hilbert12", "f64", 1e-13, 400),      # converges (18 its.)
    ("cg", "cond1e8", "vp128", 0.0, 2),          # ill-conditioned
    ("pcg", "cond1e6", "vp128", 1e-11, 2),
    ("bicgstab", "nonsym", "vp128", 1e-11, 2),
])
def test_solvers_equal_jax_op_by_op(solver, kind, name, tol, maxiter):
    env, jenv = _envs(name)
    A, b = _problem(kind)
    got = getattr(solvers, solver)(_t(A), _t(b), env, tol=tol,
                                   maxiter=maxiter)
    with jax.disable_jit():
        want = getattr(jsolvers, solver)(jnp.asarray(A), jnp.asarray(b),
                                         jenv, tol=tol, maxiter=maxiter)
    assert got.iterations == int(want.iterations)
    assert got.converged == bool(want.converged)
    assert got.residual == float(want.residual)
    _same(got.x, want.x)
    wx = np.asarray(want.x)
    assert np.max(np.abs(got.x.numpy() - wx)) <= 1e-12 * np.max(np.abs(wx))


def _like_jitted(got, want, x_star, rtol, atol=0.0):
    """Held as tests/test_solvers.py holds JAX: converged near x_star,
    in at most two iterations more than JAX's jitted solver (whose
    fused two_prod is not error-free: it may need more, as on
    Hilbert(12) at vp128, 14 iterations against the port's 10)."""
    assert got.converged and bool(want.converged)
    assert got.iterations <= int(want.iterations) + 2
    np.testing.assert_allclose(got.x.numpy(), x_star, rtol=rtol, atol=atol)
    np.testing.assert_allclose(np.asarray(want.x), x_star, rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("name", ["f64", "vp128"])
def test_cg_well_conditioned_as_jax(name):
    env, jenv = _envs(name)
    A, b = _problem("cond1e3")
    got = solvers.cg(_t(A), _t(b), env, tol=1e-10, maxiter=200)
    want = jsolvers.cg(jnp.asarray(A), jnp.asarray(b), jenv, tol=1e-10,
                       maxiter=200)
    _like_jitted(got, want, np.ones(32), rtol=1e-6)


def test_cg_extended_precision_converges_faster_as_in_jax():
    A, b = _problem("hilbert12")
    np.testing.assert_array_equal(solvers.hilbert(12).numpy(), A)
    r64 = solvers.cg(_t(A), _t(b), precision.F64, tol=1e-13, maxiter=400)
    r128 = solvers.cg(_t(A), _t(b), precision.VP128, tol=1e-13, maxiter=400)
    assert r128.converged and r128.iterations <= r64.iterations
    j128 = jsolvers.cg(jnp.asarray(A), jnp.asarray(b), jprec.VP128,
                       tol=1e-13, maxiter=400)
    _like_jitted(r128, j128, np.ones(12), rtol=1e-4)


def test_cg_extended_rhs_as_jax():
    """tests/test_solvers.py's extended-precision right-hand side: bE
    bit-equal to JAX's, then CG at vp128 against f64."""
    n = 24
    A = np.asarray(jsolvers.hilbert_like(n, cond=1e6, seed=1))
    jenv, env = jprec.VP256, precision.VP256
    bE_j = jvrp.tree_sum(jvrp.mul(jvrp.from_float(jnp.asarray(A), jenv),
                                  jvrp.from_float(jnp.ones(n), jenv)[None],
                                  jenv), jenv, axis=1)
    bE = vrp.tree_sum(vrp.mul(vrp.from_float(_t(A), env),
                              vrp.from_float(torch.ones(n, dtype=torch.float64),
                                             env)[None], env), env, axis=1)
    _same(bE, bE_j)
    r64 = solvers.cg(_t(A), vrp.to_float(bE), precision.F64, tol=1e-24,
                     maxiter=600)
    rvp = solvers.cg(_t(A), bE[:, :2], precision.VP128, tol=1e-24,
                     maxiter=600)
    assert rvp.converged and rvp.iterations <= r64.iterations
    err64 = float((r64.x - 1.0).abs().max())
    errvp = float((rvp.x - 1.0).abs().max())
    assert errvp <= err64 * 1.2


def test_pcg_jacobi():
    """tests/test_solvers.py's PCG claim, through the port."""
    A, b = _problem("cond1e6")
    got = solvers.pcg(_t(A), _t(b), precision.VP128, tol=1e-11, maxiter=300)
    assert got.converged
    np.testing.assert_allclose(got.x.numpy(), np.ones(24), rtol=1e-6)


def test_bicgstab():
    """tests/test_solvers.py's BiCGStab claim, through the port."""
    rng = np.random.default_rng(4)
    A = np.eye(24) * 4 + rng.normal(size=(24, 24)) * 0.3
    x_star = rng.normal(size=24)
    got = solvers.bicgstab(_t(A), _t(A @ x_star), precision.VP128,
                           tol=1e-11, maxiter=200)
    assert got.converged
    np.testing.assert_allclose(got.x.numpy(), x_star, rtol=1e-7, atol=1e-8)


def test_cg_runtime_precision():
    """tests/test_solvers.py: one call site, K chosen at run time."""
    A = solvers.hilbert_like(16, cond=1e4, seed=1)
    b = A @ torch.ones(16, dtype=torch.float64)
    iters = {}
    for env in (precision.F64, precision.VP128, precision.VP256):
        res = solvers.cg(A, b, env, tol=1e-10, maxiter=300)
        iters[env.K] = res.iterations
        assert res.converged
    assert iters[2] <= iters[1] + 5


def test_hilbert_like_is_spd_with_its_condition_number():
    A = solvers.hilbert_like(32, cond=1e6, seed=5)
    assert A.dtype == torch.float64
    torch.testing.assert_close(A, A.T, rtol=0, atol=1e-15)
    eig = torch.linalg.eigvalsh(A)
    assert eig.min() > 0
    assert abs(float(eig.max() / eig.min()) / 1e6 - 1) < 1e-3
    assert torch.equal(A, solvers.hilbert_like(32, cond=1e6, seed=5))
    assert not torch.equal(A, solvers.hilbert_like(32, cond=1e6, seed=6))
