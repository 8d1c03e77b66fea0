"""The encoder-decoder's (whisper_base smoke) training path against the
JAX package on the CPU: ``Model.loss_fn`` on batches that carry
``frames`` (the exact-length encoder through K1 bidirectional, the
decoder's self-attention through K1 causal, its cross-attention through
K1 non-causal over the frames, all under autograd) vs
``jax.value_and_grad`` of JAX's ``encdec.loss_fn``, and
``make_train_step`` vs JAX's jitted step. JAX's enc-dec loss takes
neither ``remat`` nor ``ce_chunk``, and the port's ignores them too.
Tolerances: ``_train_parity`` (loss 1e-5 relative, each grad leaf 1e-4
x max(1, max|g|), f32).
"""

import functools

import jax
import numpy as np
import pytest
import torch

import _train_parity as h
from repro.configs import get_config as jax_config
from repro.launch import train as jtrain
from repro.models import transformer as jtr
from repro.models.model import Model as JModel
from repro.optim import OptConfig as JOptConfig
from repro.optim.schedule import constant as jconstant
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import train
from repro_torch.models import transformer, weights
from repro_torch.models.model import Model
from repro_torch.optim import OptConfig
from repro_torch.optim.schedule import constant

torch.set_num_threads(1)

ARCH = "whisper_base"
B, S = 2, 12                  # 12 decoder tokens over 16 frames


def _cfgs():
    return jax_config(ARCH).smoke(), get_config(ARCH).smoke()


@pytest.mark.parametrize("remat,ce_chunk", [("none", 0), ("full", 4)])
def test_whisper_loss_and_grads_match_jax(remat, ce_chunk):
    """Loss and every grad leaf (encoder, decoder, cross-attention, the
    tied embedding) vs JAX's, with aux 0; the second case sets remat
    and a CE chunk on both sides, which both enc-dec losses ignore."""
    jcfg, tcfg = _cfgs()
    jparams, tparams = h.models(jcfg, tcfg)
    jb, tb = h.batch(jcfg, B, S)
    ctx = dict(remat=remat, ce_chunk=ce_chunk)
    want = h.jax_value_and_grad(jcfg, jparams, jb, **ctx)
    got = h.port_value_and_grad(tcfg, tparams, tb, **ctx)
    h.assert_matches_jax(tparams, got, want)
    assert got[1]["aux"].item() == 0.0 == float(want[0][1]["aux"])


def test_whisper_train_steps_match_jax():
    """Three ``make_train_step`` steps of whisper smoke from JAX's exact
    state vs JAX's jitted step, by loss and grad norm within 1e-4
    relative; with ``grad_accum`` 2 both split every batch key, the
    (B, F, d) frames too, into micro-batches of one row."""
    opt_kw = dict(grad_accum=2)
    jcfg, tcfg = _cfgs()
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
    assert tstate["opt"]["step"].item() == 3


def test_train_loop_refuses_an_encdec_config(tmp_path):
    """The data pipeline makes token batches without frames (JAX's makes
    none either), so ``train_loop`` refuses an encoder-decoder config
    before it starts, naming ``make_train_step``."""
    cfg = get_config(ARCH).smoke()
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                          global_batch=B)
    loop = train.TrainLoopConfig(steps=1, ckpt_dir=str(tmp_path))
    with pytest.raises(ValueError, match="make_train_step"):
        train.train_loop(Model(cfg, device="cpu"), OptConfig(),
                         transformer.RunCtx(), data_cfg, loop)
