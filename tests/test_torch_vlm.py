"""The port's VLM (qwen2-vl) dense path against the JAX package on the
CPU: qwen2_vl_2b smoke (2 layers, d_model 64, GQA 4/2 heads of 16,
M-RoPE sections (4, 2, 2), q/k/v biases, a 4-position visual prefix).

JAX initialises the q/k/v biases to zero, so a parity test on its init
would pass with the bias path broken: the biases here are drawn nonzero
into the JAX tree and carried over with the weight bridge. M-RoPE ids
are an image grid (t = 0, h = i // 2, w = i % 2) over the visual prefix
and equal text positions after it, as Qwen2-VL lays them out. The
Engine still refuses the config (no paged decode path in either
package). The other branch of the decoder-only embedding, sinusoidal
positions at an offset (no shipped config uses it), is held to JAX on
olmo smoke with its RoPE swapped for them. Tolerance 1e-4 in f32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import layers as jlayers
from repro.models.model import Model as JModel
from repro.models.transformer import RunCtx as JRunCtx
from repro_torch.configs import get_config
from repro_torch.launch.engine import Engine, EngineConfig
from repro_torch.models import layers, weights
from repro_torch.models.model import Model
from repro_torch.models.transformer import RunCtx

torch.set_num_threads(1)

ARCH = "qwen2_vl_2b"
JCTX = JRunCtx(kernel_mode="ref")
CTX = RunCtx()
TOL = dict(rtol=1e-4, atol=1e-4)
B, S, GRID = 2, 12, 2                   # the visual prefix: a 2 x 2 grid


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **{**TOL, **kw})


def _with_biases(tree, rng):
    """The tree with every q/k/v bias leaf redrawn nonzero."""
    if isinstance(tree, dict):
        return {k: (rng.normal(size=v.shape).astype(v.dtype) * 0.5
                    if k in ("bq", "bk", "bv") else _with_biases(v, rng))
                for k, v in tree.items()}
    return tree


def mrope_ids(batch, seq, grid, prefix):
    """(3, batch, seq) ids: the visual prefix on a grid x grid patch grid
    (t 0, h row, w column), then text at grid + j on all three streams."""
    pos = np.zeros((3, batch, seq), np.int32)
    for i in range(seq):
        pos[:, :, i] = np.asarray((0, i // grid, i % grid) if i < prefix
                                  else (grid + i - prefix,) * 3)[:, None]
    return pos


@pytest.fixture(scope="module")
def vl():
    jcfg, tcfg = jax_config(ARCH).smoke(), get_config(ARCH).smoke()
    jm = JModel(jcfg)
    tree = _with_biases(jax.tree.map(np.asarray,
                                     jm.init(jax.random.PRNGKey(0))),
                        np.random.default_rng(1))
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = weights.from_jax_numpy(tree, tcfg, "cpu")
    assert float(np.abs(tree["groups"]["g0"]["p0"]["attn"]["bk"]).max()) > 0
    return jcfg, tcfg, jm, jparams, Model(tcfg, device="cpu"), tparams


@pytest.mark.parametrize("ids", ["text", "grid"])
def test_apply_mrope_matches_jax(rng, ids):
    """M-RoPE over (2, 12, 4, 16) at text ids (t = h = w: equal to plain
    RoPE) and at the image grid's ids."""
    x = rng.normal(size=(B, S, 4, 16)).astype(np.float32)
    if ids == "text":
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S))
    else:
        pos = mrope_ids(B, S, GRID, 4)
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), (4, 2, 2),
                               1e6)
    got = layers.apply_mrope(_t(x), _t(pos), (4, 2, 2), 1e6)
    _close(got.numpy(), np.asarray(want))
    if ids == "text":
        _close(got.numpy(), layers.apply_rope(_t(x), _t(pos[0]), 1e6)
               .numpy(), rtol=0, atol=0)
    with pytest.raises(ValueError, match="sum"):
        layers.apply_mrope(_t(x), _t(pos), (4, 2, 1), 1e6)


def test_prefill_and_decode_match_jax(rng, vl):
    """Prefill with ``visual_embeds`` over the first 4 positions and
    grid M-RoPE ids, then 4 greedy decode steps at continuing ids:
    logits and the linear caches against JAX's, nonzero biases
    included."""
    jcfg, tcfg, jm, jparams, tm, tparams = vl
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    vis = rng.normal(size=(B, 4, 64)).astype(np.float32)
    pos = mrope_ids(B, S, GRID, 4)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks),
                                  "visual_embeds": jnp.asarray(vis),
                                  "mrope_positions": jnp.asarray(pos)},
                        JCTX, max_len=20)
    tl, tc = tm.prefill(tparams, {"tokens": _t(toks), "visual_embeds": _t(vis),
                                  "mrope_positions": _t(pos)}, CTX,
                        max_len=20)
    _close(tl.numpy(), np.asarray(jl))
    for n in ("k", "v"):
        _close(tc["g0"]["p0"][n].numpy(), np.asarray(jc["g0"]["p0"][n]))
    tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    for step in range(4):
        p3 = np.full((3, B, 1), pos[0, 0, -1] + 1 + step, np.int32)
        jd, jc = jm.decode_step(jparams, jc, jnp.asarray(tok),
                                jnp.int32(S + step), JCTX,
                                mrope_positions=jnp.asarray(p3))
        td, tc = tm.decode_step(tparams, tc, _t(tok),
                                torch.full((B,), S + step), CTX,
                                mrope_positions=_t(p3))
        _close(td.numpy(), np.asarray(jd), err_msg=f"decode step {step}")
        tok = np.argmax(np.asarray(jd), -1).astype(np.int32)[:, None]


def test_padded_prefill_raises_and_engine_refuses_the_vlm(vl):
    """A right-padded prefill raises as JAX's does (the VLM has no
    ragged form), and the Engine refuses the config by name: no paged
    decode path (``ServingCaps.paged_decode``), as in JAX."""
    _, tcfg, _, _, tm, tparams = vl
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="padded prefill"):
        tm.prefill(tparams, {"tokens": toks}, CTX,
                   length=torch.tensor([5]))
    assert not tm.serving_caps().paged_decode
    with pytest.raises(NotImplementedError, match="qwen2-vl-2b-smoke"):
        Engine(tm, tparams, EngineConfig(max_len=32), device="cpu")


def test_decoder_only_sinusoidal_positions_match_jax(rng):
    """olmo_1b smoke with ``pos_embed="sinusoidal"`` in place of RoPE:
    the embedding adds the table at each position (prefill) and at
    ``pos`` (decode), as JAX's ``_embed`` does with ``pos_offset``."""
    kw = dict(rope_style="none", pos_embed="sinusoidal")
    jcfg = dataclasses.replace(jax_config("olmo_1b").smoke(), **kw)
    tcfg = dataclasses.replace(get_config("olmo_1b").smoke(), **kw)
    jm = JModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = Model(tcfg, device="cpu")
    tparams = weights.from_jax_numpy(jax.tree.map(np.asarray, jparams),
                                     tcfg, "cpu")
    toks = rng.integers(0, 256, (B, 7)).astype(np.int32)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, JCTX,
                        max_len=10)
    tl, tc = tm.prefill(tparams, {"tokens": _t(toks)}, CTX, max_len=10)
    _close(tl.numpy(), np.asarray(jl))
    tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    for step in range(2):
        jd, jc = jm.decode_step(jparams, jc, jnp.asarray(tok),
                                jnp.int32(7 + step), JCTX)
        td, tc = tm.decode_step(tparams, tc, _t(tok),
                                torch.full((B,), 7 + step), CTX)
        _close(td.numpy(), np.asarray(jd), err_msg=f"decode step {step}")
        tok = np.argmax(np.asarray(jd), -1).astype(np.int32)[:, None]
