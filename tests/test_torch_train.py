"""The port's training path against the JAX package on the CPU: the
loss and its gradients, K1's and K5's backward (plain versions and the
``autograd.Function``s around the kernels), train steps and the
fault-tolerant loop, on smoke configs.

Weights are the JAX package's own init, carried over with
``repro_torch.models.weights``; batches come from numpy (or from the
data pipeline, equal in both packages). JAX runs its oracles
(``RunCtx(kernel_mode="ref")``, as its trainer does) and differentiates
them with ``jax.value_and_grad`` / ``jax.vjp``; the port runs the
plain versions of its kernels under its own backward formulas. Every
tolerance is stated where it is used.
"""

import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.kernels import ref as jref
from repro.launch import train as jtrain
from repro.models import transformer as jtr
from repro.models.model import Model as JModel
from repro.optim import OptConfig as JOptConfig
from repro.optim.schedule import constant as jconstant
from repro_torch import tree as tr
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as k5
from repro_torch.launch import train
from repro_torch.models import transformer, weights
from repro_torch.models.model import Model
from repro_torch.optim import OptConfig
from repro_torch.optim.schedule import constant

torch.set_num_threads(1)

TRAIN_ARCHS = ("olmo_1b", "gemma_7b", "h2o_danube_3_4b",
               "recurrentgemma_2b", "qwen2_vl_2b")
B, S = 2, 32                  # S past the smoke windows (16): they bite


def _models(arch):
    jcfg, tcfg = jax_config(arch).smoke(), get_config(arch).smoke()
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    tparams = weights.from_jax_numpy(jax.tree.map(np.asarray, jparams),
                                     tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _batch(cfg, seed=0):
    """(JAX batch, port batch) from numpy: tokens, targets and, for the
    VLM, a visual prefix and M-RoPE ids (an (h, w) grid over the
    prefix, text positions after it)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S))
    tgt = rng.integers(0, cfg.vocab_size, (B, S))
    out = {"tokens": tok, "targets": tgt}
    if cfg.visual_prefix:
        out["visual_embeds"] = rng.standard_normal(
            (B, cfg.visual_prefix, cfg.d_model)).astype(np.float32)
        mp = np.broadcast_to(np.arange(S)[None, None], (3, B, S)).copy()
        mp[1, :, :4], mp[2, :, :4] = [0, 0, 1, 1], [0, 1, 0, 1]
        out["mrope_positions"] = mp
    jb = {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else None)
          for k, v in out.items()}
    return jb, {k: torch.from_numpy(v) for k, v in out.items()}


# every config; both CE forms (whole, chunks of 8) and both remat modes,
# each at least three times
LOSS_CASES = [("olmo_1b", 0, "none"), ("olmo_1b", 8, "full"),
              ("gemma_7b", 8, "none"), ("h2o_danube_3_4b", 0, "full"),
              ("recurrentgemma_2b", 0, "none"),
              ("recurrentgemma_2b", 8, "full"), ("qwen2_vl_2b", 8, "full")]


@pytest.mark.parametrize("arch,ce_chunk,remat", LOSS_CASES)
def test_loss_and_grads_match_jax(arch, ce_chunk, remat):
    """loss_fn and every grad leaf vs ``jax.value_and_grad(loss_fn)``.
    Tolerance: loss 1e-5 relative; each leaf max|dg| <= 1e-4 * max(1,
    max|g_jax|) (f32 both sides; the sums inside matmuls, softmax and
    the scan's backward add in other orders)."""
    jcfg, tcfg, jparams, tparams = _models(arch)
    jb, tb = _batch(jcfg)
    jctx = jtr.RunCtx(kernel_mode="ref", ce_chunk=ce_chunk, remat=remat)
    (jloss, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jtr.loss_fn(p, jcfg, b, jctx), has_aux=True))(
            jparams, jb)
    ctx = transformer.RunCtx(ce_chunk=ce_chunk, remat=remat)
    loss, metrics, grads = train.value_and_grad(Model(tcfg, device="cpu"),
                                                ctx, tparams, tb)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert set(metrics) == set(jmet) and metrics["aux"].item() == 0.0
    jl = jax.tree.leaves(jg)
    assert len(jl) == len(grads)
    for (path, _), a, g in zip(tr.flatten(tparams), jl, grads):
        a = np.asarray(a)
        assert g.shape == a.shape and torch.isfinite(g).all(), path
        err = np.abs(g.numpy() - a).max()
        assert err <= 1e-4 * max(1.0, np.abs(a).max()), (path, err)


def test_forward_logits_match_jax():
    """``Model.forward`` logits (B, S, V) f32 vs JAX's ``forward`` within
    1e-4 (f32, summation order)."""
    jcfg, tcfg, jparams, tparams = _models("recurrentgemma_2b")
    jb, tb = _batch(jcfg)
    jlog, _ = jtr.forward(jparams, jcfg, jb["tokens"],
                          jtr.RunCtx(kernel_mode="ref"))
    log, aux = Model(tcfg, device="cpu").forward(tparams, tb,
                                                 transformer.RunCtx())
    assert log.dtype == torch.float32 and aux.item() == 0.0
    np.testing.assert_allclose(log.detach().numpy(), np.asarray(jlog),
                               rtol=1e-4, atol=1e-4)


SINGLE_DEVICE_ARCHS = ("olmo_1b", "yi_6b", "gemma_7b", "recurrentgemma_2b",
                       "h2o_danube_3_4b", "xlstm_1_3b", "qwen3_moe_30b_a3b",
                       "kimi_k2_1t_a32b", "whisper_base", "qwen2_vl_2b")


@pytest.mark.parametrize("arch", SINGLE_DEVICE_ARCHS)
def test_every_single_device_config_trains(arch):
    """Every config the port serves on one device has a training form:
    one ``train.value_and_grad`` of its smoke config on the CPU (the
    port's own init, B 2 x S 8; frames for the encoder-decoder, a visual
    prefix and M-RoPE ids for the VLM) gives a finite loss, a finite
    gradient for every leaf and a nonzero one for the embedding, and an
    aux loss that is positive exactly for the MoE configs."""
    cfg = get_config(arch).smoke()
    model = Model(cfg, device="cpu")
    params = model.init(seed=0)
    gen = torch.Generator().manual_seed(0)
    Bn, Sn = 2, 8
    batch = {k: torch.randint(0, cfg.vocab_size, (Bn, Sn), generator=gen)
             for k in ("tokens", "targets")}
    if cfg.enc_dec:
        batch["frames"] = torch.randn((Bn, cfg.encoder_len, cfg.d_model),
                                      generator=gen)
    if cfg.visual_prefix:
        batch["visual_embeds"] = torch.randn(
            (Bn, cfg.visual_prefix, cfg.d_model), generator=gen)
        batch["mrope_positions"] = torch.arange(Sn).expand(3, Bn, Sn)
    loss, metrics, grads = train.value_and_grad(model, transformer.RunCtx(),
                                                params, batch)
    assert torch.isfinite(loss) and loss.item() > 0
    assert all(torch.isfinite(g).all() for g in grads)
    embed = [g for (path, _), g in zip(tr.flatten(params), grads)
             if path == ("embed",)]
    assert embed[0].abs().max() > 0
    assert (metrics["aux"].item() > 0) == cfg.is_moe


def _vjp(fn, args, cot):
    """(fn(*args), the vjp of fn at args for the cotangent cot)."""
    out, vjp = jax.vjp(fn, *args)
    return out, vjp(cot)


ATTN_CASES = [  # B, hq, hkv, S, D, causal, window
    (2, 4, 4, 37, 16, True, None),
    (1, 8, 2, 40, 24, True, None),        # GQA 4
    (2, 4, 1, 48, 120, True, 16),         # MQA, danube's D, a window
    (1, 2, 1, 33, 256, True, 12),         # recurrentgemma's D 256
    (2, 4, 2, 20, 32, False, None),       # bidirectional
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_flash_attention_bwd_matches_jax_vjp(case):
    """``ref.flash_attention_bwd`` vs ``jax.vjp`` of JAX's
    ``ref.flash_attention`` (f32, 1e-5 absolute on O(1) gradients), the
    lse vs numpy's log-sum-exp, and the CPU route of K1's
    ``autograd.Function`` equal to the plain backward bit for bit."""
    Bn, hq, hkv, Sn, D, causal, window = case
    rng = np.random.default_rng(Sn)
    q, do = (rng.standard_normal((Bn, hq, Sn, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((Bn, hkv, Sn, D)).astype(np.float32)
            for _ in range(2))
    out, want = jax.jit(lambda q, k, v, do: _vjp(functools.partial(
        jref.flash_attention, causal=causal, window=window), (q, k, v),
        do))(*map(jnp.asarray, (q, k, v, do)))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = ref.flash_attention(tq, tk, tv, causal=causal, window=window,
                                 return_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(out), atol=1e-5)
    got = ref.flash_attention_bwd(tq, tk, tv, o, lse, tdo, causal=causal,
                                  window=window)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    kk = np.repeat(k, hq // hkv, axis=1)
    s = np.einsum("bhqd,bhkd->bhqk", q, kk).astype(np.float64) / np.sqrt(D)
    qpos, kpos = np.arange(Sn)[:, None], np.arange(Sn)[None]
    mask = (kpos <= qpos if causal else np.ones((Sn, Sn), bool)) \
        & (kpos > qpos - (window or Sn + 1))
    s = np.where(mask, s, -np.inf)
    np.testing.assert_allclose(lse.numpy(), np.log(np.exp(s).sum(-1)),
                               rtol=1e-5, atol=1e-5)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    via_fn = torch.autograd.grad(
        fa.flash_attention(*leaves, causal=causal, window=window), leaves,
        tdo)
    assert all(torch.equal(a, b) for a, b in zip(via_fn, got))


def test_flash_attention_bwd_empty_rows_are_zero():
    """Rows that see no key (a causal mask with window 0 empties every
    row): lse -inf, output 0 and zero gradients, where autograd of the
    plain forward would give NaN."""
    rng = np.random.default_rng(7)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (1, 2, 6, 8)).astype(np.float32)) for _ in range(4))
    o, lse = ref.flash_attention(q, k, v, window=0, return_lse=True)
    assert torch.isinf(lse).all() and not o.any()
    dq, dk, dv = ref.flash_attention_bwd(q, k, v, o, lse, do, window=0)
    assert not dq.any() and not dk.any() and not dv.any()


@pytest.mark.parametrize("with_h0", [False, True])
def test_linear_scan_bwd_matches_jax_vjp(with_h0):
    """``ref.linear_scan_bwd`` vs ``jax.vjp`` of JAX's associative-scan
    ``ref.linear_scan`` (f32, 1e-5 relative + 1e-6 absolute), and the
    CPU route of K5's ``autograd.Function`` (the plain scan run on the
    reversed, shifted sequence) equal to the backward loop bit for
    bit."""
    rng = np.random.default_rng(8)
    a = rng.uniform(0.5, 1.0, (2, 19, 12)).astype(np.float32)
    x, g = (rng.standard_normal((2, 19, 12)).astype(np.float32)
            for _ in range(2))
    h0 = rng.standard_normal((2, 12)).astype(np.float32) if with_h0 else None
    args = [a, x] + ([h0] if with_h0 else [])
    _, want = jax.jit(lambda args, g: _vjp(jref.linear_scan, args, g))(
        list(map(jnp.asarray, args)), jnp.asarray(g))
    ta, tx, tg = map(torch.from_numpy, (a, x, g))
    th0 = torch.from_numpy(h0) if with_h0 else None
    h = ref.linear_scan(ta, tx, th0)
    got = ref.linear_scan_bwd(ta, h, tg, th0)
    for gt, w in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    leaves = [t.clone().requires_grad_() for t in (ta, tx)] \
        + ([th0.clone().requires_grad_()] if with_h0 else [])
    h_fn = k5.rglru_scan(leaves[0], leaves[1],
                         leaves[2] if with_h0 else None)
    assert torch.equal(h_fn, h)
    via_fn = torch.autograd.grad(h_fn, leaves, tg)
    assert all(torch.equal(a_, b_) for a_, b_ in zip(via_fn, got))


def _jax_state(jm, opt_kw):
    return jtrain.init_state(jm, JOptConfig(**opt_kw))


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_steps_match_jax(grad_accum):
    """Three ``make_train_step`` steps of olmo_1b smoke from JAX's exact
    state (carried over by ``weights.state_from_jax_numpy``) vs JAX's
    jitted step, by loss: 1e-4 relative (Adam turns last-bit gradient
    differences into updates of up to lr, so parameters are not held
    bit for bit; the loss is)."""
    opt_kw = dict(grad_accum=grad_accum)
    jcfg, tcfg = jax_config("olmo_1b").smoke(), get_config("olmo_1b").smoke()
    jm, tm = JModel(jcfg), Model(tcfg, device="cpu")
    jstate = _jax_state(jm, opt_kw)
    tstate = weights.state_from_jax_numpy(
        jax.tree.map(np.asarray, jstate), tcfg, "cpu")
    jstep = jax.jit(jtrain.make_train_step(
        jm, JOptConfig(**opt_kw), jtr.RunCtx(kernel_mode="ref"),
        functools.partial(jconstant, peak_lr=1e-2)))
    tstep = train.make_train_step(tm, OptConfig(**opt_kw),
                                  transformer.RunCtx(),
                                  functools.partial(constant, peak_lr=1e-2))
    for i in range(3):
        jb, tb = _batch(jcfg, seed=i)
        del jb["targets"], tb["targets"]
        jb["targets"] = jnp.roll(jb["tokens"], -1, axis=1)
        tb["targets"] = torch.roll(tb["tokens"], -1, dims=1)
        jstate, jmet = jstep(jstate, jb)
        tstate, tmet = tstep(tstate, tb)
        assert set(tmet) == set(jmet)
        np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(tmet["grad_norm"].item(),
                                   float(jmet["grad_norm"]), rtol=1e-4)
    assert tstate["opt"]["step"].item() == int(jstate["opt"]["step"]) == 3


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_marks_its_parts(grad_accum):
    """``make_train_step(mark=...)`` calls the mark at the step's start,
    after each forward and backward (once a microbatch) and after the
    optimizer, and changes nothing: the state and metrics equal those of
    the step without it, bit for bit."""
    cfg = get_config("olmo_1b").smoke()
    model = Model(cfg, device="cpu")
    opt_cfg = OptConfig(grad_accum=grad_accum)
    lr = functools.partial(constant, peak_lr=1e-2)
    state = train.init_state(model, opt_cfg, seed=0)
    _, batch = _batch(cfg)
    seen = []
    marked = train.make_train_step(model, opt_cfg, transformer.RunCtx(), lr,
                                   mark=seen.append)
    plain = train.make_train_step(model, opt_cfg, transformer.RunCtx(), lr)
    got, got_met = marked(state, batch)
    want, want_met = plain(state, batch)
    assert seen == ["start"] + ["loss", "grads"] * grad_accum + ["update"]
    assert all(torch.equal(a, b) for a, b in zip(tr.leaves(got),
                                                 tr.leaves(want)))
    assert all(torch.equal(got_met[k], want_met[k]) for k in want_met
               if k != "lr") and got_met["lr"] == want_met["lr"]


def _loop_setup(tmp_path, name, steps):
    cfg = get_config("olmo_1b").smoke()
    model = Model(cfg, device="cpu")
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                          global_batch=4, seed=0)
    loop_cfg = train.TrainLoopConfig(steps=steps, ckpt_every=10,
                                     ckpt_dir=str(tmp_path / name),
                                     log_every=1000,
                                     metrics_path=str(tmp_path / f"{name}.jl"))
    return model, OptConfig(weight_decay=0.0), data_cfg, loop_cfg


def test_train_loop_restart_equals_uninterrupted(tmp_path):
    """Fail at step 15, restart from the step-10 checkpoint, run to 20:
    the final state and the losses of steps 10..19 equal the
    uninterrupted run's bit for bit (an eager CPU step is
    deterministic, the checkpoint exact); the metrics file holds a line a
    step."""
    ctx = transformer.RunCtx()
    model, opt_cfg, data_cfg, ref_loop = _loop_setup(tmp_path, "ref", 20)
    ref_state, ref_hist = train.train_loop(model, opt_cfg, ctx, data_cfg,
                                           ref_loop)
    _, _, _, loop_cfg = _loop_setup(tmp_path, "run", 20)
    with pytest.raises(RuntimeError, match="injected failure"):
        train.train_loop(model, opt_cfg, ctx, data_cfg, loop_cfg, fail_at=15)
    state, hist = train.train_loop(model, opt_cfg, ctx, data_cfg, loop_cfg)
    assert hist[0]["step"] == 10 and len(hist) == 10
    assert [h["loss"] for h in hist] == [h["loss"] for h in ref_hist[10:]]
    for a, b in zip(tr.leaves(state), tr.leaves(ref_state)):
        assert torch.equal(a, b)
    assert ref_hist[-1]["loss"] < ref_hist[0]["loss"]
    assert len(open(loop_cfg.metrics_path).readlines()) == 15 + 10
    with pytest.raises(NotImplementedError, match="Multi-device"):
        train.train_loop(model, opt_cfg, ctx, data_cfg, loop_cfg,
                         mesh=object())


def test_port_resumes_a_jax_checkpoint(tmp_path):
    """JAX's ``train_loop`` runs 6 steps of olmo_1b smoke (weight decay
    off, constant lr), checkpointing at step 4; the port's
    ``train_loop`` restores that checkpoint and runs steps 4..5. Losses
    within 1e-4 relative of JAX's steps 4..5 (JAX's step is jitted; the
    port starts from JAX's step-4 state bit for bit)."""
    jcfg = jax_config("olmo_1b").smoke()
    jm = JModel(jcfg)
    lr = functools.partial(jconstant, peak_lr=1e-3)
    jdata = JDataConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                        global_batch=4, seed=0)
    jdir = tmp_path / "jax"
    jloop = jtrain.TrainLoopConfig(steps=6, ckpt_every=4,
                                   ckpt_dir=str(jdir), log_every=1000)
    _, jhist = jtrain.train_loop(jm, JOptConfig(weight_decay=0.0),
                                 jtr.RunCtx(kernel_mode="ref"), jdata,
                                 jloop, lr_fn=lr)
    shutil.copytree(jdir / "step_4", tmp_path / "port" / "step_4")
    jhist = jhist[4:]
    model, opt_cfg, data_cfg, loop_cfg = _loop_setup(tmp_path, "port", 6)
    state, hist = train.train_loop(
        model, opt_cfg, transformer.RunCtx(), data_cfg, loop_cfg,
        lr_fn=functools.partial(constant, peak_lr=1e-3))
    assert [h["step"] for h in hist] == [h["step"] for h in jhist] == [4, 5]
    for a, b in zip(hist, jhist):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
    assert state["opt"]["step"].item() == 6
