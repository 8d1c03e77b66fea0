"""Shared harness of the training parity tests (``test_torch_train_*.py``):
the JAX package's params carried into the port, numpy batches in both
packages, JAX's ``jax.value_and_grad`` of ``Model.loss_fn`` (its oracles,
``kernel_mode="ref"``), and the comparison of a loss and its gradients
at the tolerances those tests state."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import transformer as jtr
from repro.models.model import Model as JModel
from repro_torch import tree as tr
from repro_torch.launch import train
from repro_torch.models import transformer, weights
from repro_torch.models.model import Model

LOSS_RTOL = 1e-5              # f32 loss, relative
GRAD_TOL = 1e-4               # each leaf: max|dg| <= GRAD_TOL * max(1, max|g|)


def models(jcfg, tcfg):
    """(JAX params from ``PRNGKey(0)``, the same values as port params on
    the CPU)."""
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    tparams = weights.from_jax_numpy(jax.tree.map(np.asarray, jparams),
                                     tcfg, "cpu")
    return jparams, tparams


def batch(cfg, B, S, seed=0):
    """(JAX batch, port batch) from numpy: tokens and targets, and for an
    encoder-decoder ``frames`` (B, encoder_len, d) f32."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
           "targets": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.enc_dec:
        out["frames"] = rng.standard_normal(
            (B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else None)
          for k, v in out.items()}
    return jb, {k: torch.from_numpy(v) for k, v in out.items()}


def jax_value_and_grad(jcfg, jparams, jb, **ctx):
    """JAX's jitted ``value_and_grad`` of ``Model.loss_fn``: ((loss,
    metrics), grads)."""
    jctx = jtr.RunCtx(kernel_mode="ref", **ctx)
    model = JModel(jcfg)
    return jax.jit(jax.value_and_grad(
        lambda p, b: model.loss_fn(p, b, jctx), has_aux=True))(jparams, jb)


def port_value_and_grad(tcfg, tparams, tb, **ctx):
    """The port's ``train.value_and_grad`` on the CPU: (loss, metrics,
    grads in JAX's leaf order)."""
    return train.value_and_grad(Model(tcfg, device="cpu"),
                                transformer.RunCtx(**ctx), tparams, tb)


def assert_matches_jax(tparams, got, want):
    """``got`` = the port's (loss, metrics, grads), ``want`` = JAX's
    ((loss, metrics), grads): the loss within LOSS_RTOL, the metrics'
    keys equal, every grad leaf finite and within GRAD_TOL * max(1,
    max|g_jax|) (f32 both sides; sums inside matmuls, softmax and the
    scans' backward add in other orders)."""
    loss, metrics, grads = got
    (jloss, jmet), jg = want
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    assert set(metrics) == set(jmet)
    jl = jax.tree.leaves(jg)
    assert len(jl) == len(grads)
    for (path, _), a, g in zip(tr.flatten(tparams), jl, grads):
        a = np.asarray(a)
        assert g.shape == a.shape and torch.isfinite(g).all(), path
        err = np.abs(g.numpy() - a).max()
        assert err <= GRAD_TOL * max(1.0, np.abs(a).max()), (path, err)
