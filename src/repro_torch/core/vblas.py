"""VBLAS — extended-precision BLAS-1/2 on expansion vectors.

Counterpart of ``repro/core/vblas.py``. The paper: "The VRP runs a
RISC-V binary using specialized libraries (e.g., VBLAS) to operate on
extended-precision data types." Vectors are expansions of shape (n, K);
scalars are expansions of shape (K,). All routines take a PrecisionEnv
and run on the device of their inputs.
"""

from __future__ import annotations

from . import vrp
from .precision import PrecisionEnv, get_env


def vcopy(x):
    return x


def vneg(x):
    return -x


def vaxpy(alpha, x, y, env: PrecisionEnv):
    """y + alpha * x with alpha an expansion scalar, x/y expansion vectors."""
    env = get_env(env)
    return vrp.add(vrp.mul(x, alpha[None, :], env), y, env)


def vscal(alpha, x, env: PrecisionEnv):
    env = get_env(env)
    return vrp.mul(x, alpha[None, :], env)


def vdot(x, y, env: PrecisionEnv):
    """Expansion-vector dot product -> expansion scalar."""
    return vrp.dot_vp(x, y, env)


def vnrm2(x, env: PrecisionEnv):
    env = get_env(env)
    return vrp.sqrt(vrp.dot_vp(x, x, env), env)


def vgemv(A, x, env: PrecisionEnv):
    """Plain (m, n) matrix times expansion vector."""
    return vrp.matvec(A, x, env)


def from_plain(x, env: PrecisionEnv):
    return vrp.from_float(x, env)


def to_plain(x):
    return vrp.to_float(x)
