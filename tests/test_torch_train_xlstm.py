"""xLSTM's training path against the JAX package on the CPU: the mLSTM
block's chunkwise form and the sLSTM block's cell-by-cell form under
autograd (JAX's ``apply_mlstm_block`` / ``apply_slstm_block`` under
``jax.value_and_grad``), and ``launch.train.main`` on xlstm_1_3b smoke.

The parity cases cut xlstm smoke's 16 layers to one period on both sides
(``n_layers=8``: 7 mLSTM + 1 sLSTM): the second period runs the same
code on other weights, and JAX's trace and gradient of 16 layers cost
the tier-1 run several seconds more. S = 28 is not a multiple of the
smoke chunk (8): the last chunk's padded tail (input gate -1e30, forget
gate 30) is in every case, and must send no gradient anywhere real.
Tolerances: ``_train_parity`` (loss 1e-5 relative, each grad leaf 1e-4
x max(1, max|g|), f32).
"""

import dataclasses

import pytest
import torch

import _train_parity as h
from repro.configs import get_config as jax_config
from repro_torch.configs import get_config
from repro_torch.launch import train

torch.set_num_threads(1)

ARCH = "xlstm_1_3b"
B, S = 2, 28


@pytest.mark.parametrize("remat", ["none", "full"])
def test_xlstm_loss_and_grads_match_jax(remat):
    """Loss and every grad leaf of one xLSTM period (7 mLSTM, 1 sLSTM) vs
    ``jax.value_and_grad`` of JAX's ``loss_fn``, in both remat modes;
    aux is 0 on both sides (no MoE)."""
    jcfg = dataclasses.replace(jax_config(ARCH).smoke(), n_layers=8)
    tcfg = dataclasses.replace(get_config(ARCH).smoke(), n_layers=8)
    jparams, tparams = h.models(jcfg, tcfg)
    jb, tb = h.batch(jcfg, B, S)
    want = h.jax_value_and_grad(jcfg, jparams, jb, remat=remat)
    got = h.port_value_and_grad(tcfg, tparams, tb, remat=remat)
    h.assert_matches_jax(tparams, got, want)
    assert got[1]["aux"].item() == 0.0 == float(want[0][1]["aux"])


def test_main_trains_xlstm_smoke_on_cpu(tmp_path, capsys):
    """``main(["--arch", "xlstm_1_3b", "--smoke", "--device", "cpu",
    ...])`` runs two steps of the full smoke config (16 layers) through
    ``train_loop``, checkpoints at the end and prints a finite final
    loss."""
    train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps",
                "2", "--batch", "2", "--seq", "16", "--ckpt-dir",
                str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert "step     0 loss" in out
    final = float(out.split("final loss")[1])
    assert final == final and 0 < final < 1e3
    assert (tmp_path / "ckpt" / "step_2").is_dir()
