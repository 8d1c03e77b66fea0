"""The MoE decoders' training path against the JAX package on the CPU:
qwen3_moe_30b_a3b and kimi_k2_1t_a32b smoke, whose layers route with the
capacity factor (JAX's ``apply_moe(dropless=False)``) and add the Switch
aux loss to the loss.

At B 2 x S 32 the smoke MoE (8 experts, top-2) has T = 64 tokens, 128
assignments, capacity ceil(64 x 2 / 8 x 1.25) = 20 against an expected
16 a expert: some assignments drop, and the tests assert that they do.
Weights are JAX's init carried over by ``weights.from_jax_numpy``;
JAX runs its oracles (``kernel_mode="ref"``). Tolerances are stated
where they are used (``_train_parity``: loss 1e-5 relative, each grad
leaf 1e-4 x max(1, max|g|)).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _train_parity as h
from repro.configs import get_config as jax_config
from repro.launch import train as jtrain
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.models.model import Model as JModel
from repro.optim import OptConfig as JOptConfig
from repro.optim.schedule import constant as jconstant
from repro_torch import tree as tr
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import train
from repro_torch.models import moe, transformer, weights
from repro_torch.models.model import Model
from repro_torch.optim import OptConfig
from repro_torch.optim.schedule import constant

torch.set_num_threads(1)

B, S = 2, 32
QWEN = "qwen3_moe_30b_a3b"


def _cfgs(arch):
    return jax_config(arch).smoke(), get_config(arch).smoke()


@pytest.mark.parametrize("arch,remat", [(QWEN, "none"), (QWEN, "full"),
                                        ("kimi_k2_1t_a32b", "none")])
def test_moe_loss_grads_and_aux_match_jax(arch, remat):
    """``train.value_and_grad`` of the port's ``loss_fn`` vs
    ``jax.value_and_grad`` of JAX's (loss = ce + moe_aux_coef x aux):
    loss and every grad leaf at ``_train_parity``'s tolerances, and
    ``metrics["aux"]`` (the layers' Switch losses summed) within 1e-6
    relative (f32 means over 64 tokens added in another order)."""
    jcfg, tcfg = _cfgs(arch)
    jparams, tparams = h.models(jcfg, tcfg)
    jb, tb = h.batch(jcfg, B, S)
    want = h.jax_value_and_grad(jcfg, jparams, jb, remat=remat)
    got = h.port_value_and_grad(tcfg, tparams, tb, remat=remat)
    h.assert_matches_jax(tparams, got, want)
    aux = got[1]["aux"].item()
    assert aux > 0
    np.testing.assert_allclose(aux, float(want[0][1]["aux"]), rtol=1e-6)


def _record_port_plans(monkeypatch):
    """Every ``moe.plan`` call's (input (T, d), plan), in call order."""
    seen = []
    real = moe.plan

    def plan(x2d, *args, **kw):
        r = real(x2d, *args, **kw)
        seen.append((x2d.detach().clone(), r))
        return r

    monkeypatch.setattr(moe, "plan", plan)
    return seen


def test_drop_mask_equals_jax_and_is_not_empty(monkeypatch):
    """The assignments each MoE layer of the model's forward drops: the
    port's (``moe.plan``'s ``kept``, expert-sorted order) equal JAX's
    routing of the same layer input (position within the expert >=
    ``_capacity``, from JAX's ``route`` and ``_dispatch_indices``),
    layer by layer, and the layers drop something, so that a path that
    silently ran dropless could not pass. The loss and grads tests above
    hold the layer inputs themselves to JAX's."""
    jcfg, tcfg = _cfgs(QWEN)
    jparams, tparams = h.models(jcfg, tcfg)
    _, tb = h.batch(jcfg, B, S)
    seen = _record_port_plans(monkeypatch)
    Model(tcfg, device="cpu").loss_fn(tparams, tb, transformer.RunCtx())
    assert len(seen) == tcfg.n_layers
    C = jmoe._capacity(jcfg, B * S, False)
    k, E = jcfg.moe_top_k, jcfg.n_experts

    @jax.jit
    def jax_dropped(x2d, router):
        topi = jmoe.route(x2d, router, k)[0]
        return jmoe._dispatch_indices(topi, k, E, C)[3] >= C

    routers = jparams["groups"]["g0"]["p0"]["moe"]["router"]
    dropped = 0
    for i, (x2d, r) in enumerate(seen):
        want = np.asarray(jax_dropped(jnp.asarray(x2d.numpy()), routers[i]))
        np.testing.assert_array_equal((~r["kept"]).numpy(), want)
        dropped += int(want.sum())
    assert dropped > 0
    assert C == moe.capacity(tcfg, B * S, False) == seen[0][1]["capacity"] \
        == 20


def test_remat_recomputes_the_same_routing(monkeypatch):
    """Under ``remat="full"`` each MoE layer routes twice (the forward and
    its recomputation in the backward pass) and drops the same
    assignments both times, those of ``remat="none"``; the loss and
    every gradient equal ``remat="none"``'s bit for bit (the CPU's ops
    are deterministic, and the recomputed layer is the same function of
    the same input)."""
    jcfg, tcfg = _cfgs(QWEN)
    _, tparams = h.models(jcfg, tcfg)
    _, tb = h.batch(jcfg, B, S)
    seen = _record_port_plans(monkeypatch)
    plain = h.port_value_and_grad(tcfg, tparams, tb, remat="none")
    remat = h.port_value_and_grad(tcfg, tparams, tb, remat="full")
    n = tcfg.n_layers
    kept = [r["kept"] for _, r in seen]
    # the backward pass recomputes the layers last to first
    first, again = kept[n:2 * n], kept[2 * n:][::-1]
    assert len(kept) == 3 * n
    for a, b, c in zip(kept[:n], first, again):
        assert torch.equal(a, b) and torch.equal(b, c)
    assert torch.equal(plain[0], remat[0])
    assert all(torch.equal(a, b) for a, b in zip(plain[2], remat[2]))


def test_moe_layer_and_its_vjp_match_jax(rng):
    """One MoE layer at 48 tokens (capacity 15 against an expected 12 a
    expert), in isolation: ``apply_moe_train``'s output and aux vs JAX's
    ``apply_moe(dropless=False)`` (1e-5), and the gradients of a random
    cotangent through both with respect to x, the router and the
    experts (1e-5 x max(1, max|g|)): a dropped assignment's router
    weight and expert row get none."""
    jcfg, tcfg = _cfgs(QWEN)
    jparams, tparams = h.models(jcfg, tcfg)
    jp = jparams["groups"]["g0"]["p0"]["moe"]
    jp = jax.tree.map(lambda t: t[0], jp)
    tp = {k: v.detach().clone() for k, v in transformer.layer_slice(
        tparams["groups"]["g0"]["p0"]["moe"], 0).items()}
    x = rng.normal(size=(3, 16, jcfg.d_model)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)

    jfwd = jax.jit(lambda p, x: jmoe.apply_moe(p, jcfg, x, dropless=False))

    def jfn(p, x):
        out, aux = jfwd(p, x)
        return jnp.sum(out * cot) + aux

    jout, jaux = jfwd(jp, jnp.asarray(x))
    jg = jax.jit(jax.grad(jfn, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = {k: v.requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = moe.apply_moe_train(leaves, tcfg, tx)
    r = moe.plan(tx.detach().reshape(-1, tcfg.d_model), tp["router"], tcfg,
                 dropless=False)
    assert r["capacity"] == 15 and not r["kept"].all()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    grads = torch.autograd.grad(
        (out * torch.from_numpy(cot)).sum() + aux,
        [leaves[k] for k in sorted(leaves)] + [tx])
    want = [jg[0][k] for k in sorted(leaves)] + [jg[1]]
    for g, w in zip(grads, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * max(1.0,
                                                         np.abs(w).max())


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_moe_train_steps_match_jax(grad_accum):
    """Three ``make_train_step`` steps of qwen3_moe smoke from JAX's exact
    state vs JAX's jitted step, by loss and grad norm within 1e-4
    relative (Adam turns last-bit gradient differences into updates of
    up to lr). With ``grad_accum`` 2 each micro-batch of 32 tokens routes
    with its own capacity (10), as JAX's scan over micro-batches does."""
    opt_kw = dict(grad_accum=grad_accum)
    jcfg, tcfg = _cfgs(QWEN)
    jm, tm = JModel(jcfg), Model(tcfg, device="cpu")
    jstate = jtrain.init_state(jm, JOptConfig(**opt_kw))
    tstate = weights.state_from_jax_numpy(
        jax.tree.map(np.asarray, jstate), tcfg, "cpu")
    jstep = jax.jit(jtrain.make_train_step(
        jm, JOptConfig(**opt_kw), jtr.RunCtx(kernel_mode="ref"),
        functools.partial(jconstant, peak_lr=1e-2)))
    tstep = train.make_train_step(tm, OptConfig(**opt_kw),
                                  transformer.RunCtx(),
                                  functools.partial(constant, peak_lr=1e-2))
    for i in range(3):
        jb, tb = h.batch(jcfg, B, S, seed=i)
        jstate, jmet = jstep(jstate, jb)
        tstate, tmet = tstep(tstate, tb)
        assert set(tmet) == set(jmet)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(tmet[k].item(), float(jmet[k]),
                                       rtol=1e-4)
    assert tstate["opt"]["step"].item() == int(jstate["opt"]["step"]) == 3


def test_moe_train_loop_restart_equals_uninterrupted(tmp_path):
    """The port's ``train_loop`` on qwen3_moe smoke: fail at step 5,
    restart from the step-4 checkpoint, run to 8; the losses of steps
    4..7 and the final state equal the uninterrupted run's bit for bit
    (routing and drops are a pure function of the restored state)."""
    cfg = get_config(QWEN).smoke()
    model = Model(cfg, device="cpu")
    opt_cfg, ctx = OptConfig(weight_decay=0.0), transformer.RunCtx()
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                          global_batch=B, seed=0)

    def loop(name):
        return train.TrainLoopConfig(steps=8, ckpt_every=4,
                                     ckpt_dir=str(tmp_path / name),
                                     log_every=1000)

    ref_state, ref_hist = train.train_loop(model, opt_cfg, ctx, data_cfg,
                                           loop("ref"))
    with pytest.raises(RuntimeError, match="injected failure"):
        train.train_loop(model, opt_cfg, ctx, data_cfg, loop("run"),
                         fail_at=5)
    state, hist = train.train_loop(model, opt_cfg, ctx, data_cfg,
                                   loop("run"))
    assert [m["step"] for m in hist] == [4, 5, 6, 7]
    assert [m["loss"] for m in hist] == [m["loss"] for m in ref_hist[4:]]
    assert all(m["aux"] > 0 for m in hist)
    for a, b in zip(tr.leaves(state), tr.leaves(ref_state)):
        assert torch.equal(a, b)
