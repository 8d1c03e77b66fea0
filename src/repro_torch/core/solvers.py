"""Krylov solvers at runtime-selectable precision — the VRP use case.

Counterpart of ``repro/core/solvers.py``. The paper's target workload:
"iterative linear solvers, such as Krylov methods (e.g., CG, BiCG, PCG),
where increasing precision can reduce rounding errors, improve
convergence, or enable convergence for ill-conditioned systems". These
solvers run *entirely* in expansion arithmetic (vectors, scalars and
reductions), with the precision chosen at call time via PrecisionEnv.

JAX's ``lax.while_loop`` becomes a Python loop that reads the residual
once per iteration (the loop's only host sync). Everything runs on the
device of ``A`` and ``b``; in float64 on the card, which has native f64.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import vblas, vrp
from .precision import PrecisionEnv, get_env


class SolveResult(NamedTuple):
    x: torch.Tensor         # solution as plain base-dtype array
    iterations: int
    residual: float         # final relative residual (plain float)
    converged: bool


def _to_expansion(b, env):
    """Accept either a plain (n,) vector or an (n, K) expansion."""
    b = torch.as_tensor(b)
    if b.dim() == 2:
        K = get_env(env).K
        if b.shape[-1] < K:
            pad = torch.zeros((b.shape[0], K - b.shape[-1]), dtype=b.dtype,
                              device=b.device)
            b = torch.cat([b, pad], dim=-1)
        return b[:, :K]
    return vrp.from_float(torch.as_tensor(b, dtype=get_env(env).dtype), env)


def _loop(state, body, tol, maxiter):
    """``lax.while_loop`` over (k < maxiter and res > tol): ``body`` maps
    the state to (state, res tensor); res is read once an iteration."""
    k, res = 0, math.inf
    while k < maxiter and res > tol:
        state, res_t = body(state)
        res = float(res_t)
        k += 1
    return state, k, res


def cg(A, b, env: PrecisionEnv, tol: float = 1e-10, maxiter: int = 1000):
    """Conjugate Gradient in expansion arithmetic. A: (n, n) SPD (plain)."""
    env = get_env(env)
    bE = _to_expansion(b, env)
    bnorm = vrp.to_float(vblas.vnrm2(bE, env))
    x = vrp.zeros(bE.shape[:-1], env, device=bE.device)
    r = bE
    p = r
    rz = vblas.vdot(r, r, env)

    def body(state):
        x, r, p, rz = state
        Ap = vrp.matvec(A, p, env)
        pAp = vblas.vdot(p, Ap, env)
        alpha = vrp.div(rz, pAp, env)
        x = vblas.vaxpy(alpha, p, x, env)
        r = vblas.vaxpy(-alpha, Ap, r, env)
        rz_new = vblas.vdot(r, r, env)
        beta = vrp.div(rz_new, rz, env)
        p = vblas.vaxpy(beta, p, r, env)
        res = torch.sqrt(torch.abs(vrp.to_float(rz_new))) / bnorm
        return (x, r, p, rz_new), res

    (x, *_), k, res = _loop((x, r, p, rz), body, tol, maxiter)
    return SolveResult(vrp.to_float(x), k, res, res <= tol)


def pcg(A, b, env: PrecisionEnv, tol: float = 1e-10, maxiter: int = 1000):
    """Jacobi-preconditioned CG in expansion arithmetic."""
    env = get_env(env)
    Minv_diag = 1.0 / torch.diagonal(torch.as_tensor(A, dtype=env.dtype))
    bE = _to_expansion(b, env)
    bnorm = vrp.to_float(vblas.vnrm2(bE, env))
    x = vrp.zeros(bE.shape[:-1], env, device=bE.device)
    r = bE

    def precond(v):  # Jacobi: exact elementwise scale
        return vrp.scale(v, Minv_diag, env)

    z = precond(r)
    p = z
    rz = vblas.vdot(r, z, env)

    def body(state):
        x, r, z, p, rz = state
        Ap = vrp.matvec(A, p, env)
        alpha = vrp.div(rz, vblas.vdot(p, Ap, env), env)
        x = vblas.vaxpy(alpha, p, x, env)
        r = vblas.vaxpy(-alpha, Ap, r, env)
        z = precond(r)
        rz_new = vblas.vdot(r, z, env)
        beta = vrp.div(rz_new, rz, env)
        p = vblas.vaxpy(beta, p, z, env)
        res = torch.abs(vrp.to_float(vblas.vnrm2(r, env))) / bnorm
        return (x, r, z, p, rz_new), res

    (x, *_), k, res = _loop((x, r, z, p, rz), body, tol, maxiter)
    return SolveResult(vrp.to_float(x), k, res, res <= tol)


def bicgstab(A, b, env: PrecisionEnv, tol: float = 1e-10,
             maxiter: int = 1000):
    """BiCGStab in expansion arithmetic (paper ref [20]'s stabilized use)."""
    env = get_env(env)
    bE = _to_expansion(b, env)
    bnorm = vrp.to_float(vblas.vnrm2(bE, env))
    x = vrp.zeros(bE.shape[:-1], env, device=bE.device)
    r = bE
    rhat = r
    one = vrp.from_float(torch.tensor(1.0, dtype=env.dtype,
                                      device=bE.device), env)
    v = vrp.zeros(bE.shape[:-1], env, device=bE.device)
    p = vrp.zeros(bE.shape[:-1], env, device=bE.device)

    def body(state):
        x, r, rho, alpha, omega, v, p = state
        rho_new = vblas.vdot(rhat, r, env)
        beta = vrp.mul(vrp.div(rho_new, rho, env),
                       vrp.div(alpha, omega, env), env)
        p = vblas.vaxpy(beta, vblas.vaxpy(-omega, v, p, env), r, env)
        v = vrp.matvec(A, p, env)
        alpha = vrp.div(rho_new, vblas.vdot(rhat, v, env), env)
        s = vblas.vaxpy(-alpha, v, r, env)
        t = vrp.matvec(A, s, env)
        omega = vrp.div(vblas.vdot(t, s, env), vblas.vdot(t, t, env), env)
        x = vblas.vaxpy(alpha, p, vblas.vaxpy(omega, s, x, env), env)
        r = vblas.vaxpy(-omega, t, s, env)
        res = torch.abs(vrp.to_float(vblas.vnrm2(r, env))) / bnorm
        return (x, r, rho_new, alpha, omega, v, p), res

    (x, *_), k, res = _loop((x, r, one, one, one, v, p), body, tol, maxiter)
    return SolveResult(vrp.to_float(x), k, res, res <= tol)


# ---------------------------------------------------------------------------
# Test problems (ill-conditioned SPD systems, the paper's target class)
# ---------------------------------------------------------------------------


def hilbert_like(n: int, cond: float = 1e12, dtype=torch.float64,
                 seed: int = 0):
    """Random SPD matrix with prescribed condition number.

    Drawn on the CPU from a ``torch.Generator`` seeded with ``seed``: the
    matrix is not JAX's draw. Callers move it to their device.
    """
    gen = torch.Generator().manual_seed(seed)
    Q, _ = torch.linalg.qr(torch.randn((n, n), generator=gen, dtype=dtype))
    eigs = torch.logspace(0.0, -math.log10(cond), n,
                          dtype=torch.float64).to(dtype)
    return (Q * eigs) @ Q.T


def hilbert(n: int, dtype=torch.float64):
    """The Hilbert matrix — the classic ill-conditioned SPD example."""
    i = torch.arange(n, dtype=dtype)
    return 1.0 / (1.0 + i[:, None] + i[None, :])
