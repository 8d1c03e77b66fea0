"""The port's model (repro_torch.models) against the JAX package on the
CPU: the weight bridge, the param layout of ``init_lm``, prefill and
paged-decode logits, and the block-pool contents, on smoke configs.

Weights are the JAX package's own init, carried over with
``repro_torch.models.weights``; inputs are made by numpy from a seed.
Tolerance 1e-4 in f32: both sides compute the same math in f32, and the
differences left are summation order inside matmuls and softmax.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import paged_kv as jpk
from repro.models import transformer as jtr
from repro.models.model import Model as JModel
from repro_torch.configs import get_config
from repro_torch.models import paged_kv, transformer, weights
from repro_torch.models.model import Model

torch.set_num_threads(1)

ARCHS = ("olmo_1b", "yi_6b", "gemma_7b")
JCTX = jtr.RunCtx(kernel_mode="ref")
CTX = transformer.RunCtx()
TOL = dict(rtol=1e-4, atol=1e-4)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _models(arch, dtype=None):
    jcfg, tcfg = jax_config(arch).smoke(), get_config(arch).smoke()
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        tcfg = dataclasses.replace(tcfg, dtype=dtype)
    jm = JModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = weights.from_jax_numpy(jax.tree.map(np.asarray, jparams),
                                     tcfg, "cpu")
    return jcfg, tcfg, jm, jparams, Model(tcfg, device="cpu"), tparams


@pytest.mark.parametrize("arch,dtype", [(a, None) for a in ARCHS]
                         + [("olmo_1b", "bfloat16")])
def test_weight_bridge_round_trip_exact(arch, dtype):
    """JAX tree -> torch -> numpy is bit-exact leaf for leaf, stacked
    (count, ...) group leaves included; bf16 leaves come back as their
    exact float32 values."""
    jcfg, tcfg, _, jparams, _, tparams = _models(arch, dtype)
    src = _leaves(jax.tree.map(np.asarray, jparams))
    back = _leaves(weights.to_numpy(tparams))
    assert src.keys() == back.keys()
    for path, a in src.items():
        b = back[path]
        assert b.shape == a.shape, path
        np.testing.assert_array_equal(b, np.asarray(a, np.float32)
                                      if dtype else a, err_msg=path)
    g0 = tparams["groups"]["g0"]["p0"]["attn"]["wq"]
    assert g0.shape[0] == tcfg.n_layers            # stacked layout kept
    with pytest.raises(ValueError):
        weights.from_jax_numpy({"groups": {}}, tcfg, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_layout_matches_jax(arch):
    """The port's own init draws JAX's tree: same paths, shapes and
    dtypes, truncated-normal weights within [-2, 2] * stddev."""
    jcfg, tcfg = jax_config(arch).smoke(), get_config(arch).smoke()
    jshapes = _leaves(jax.eval_shape(
        lambda: JModel(jcfg).init(jax.random.PRNGKey(0))))
    tparams = _leaves(Model(tcfg, device="cpu").init(seed=0))
    assert jshapes.keys() == tparams.keys()
    for path, s in jshapes.items():
        t = tparams[path]
        assert tuple(t.shape) == s.shape, path
        assert str(t.dtype).split(".")[-1] == str(s.dtype), path
    wq = tparams["/groups/g0/p0/attn/wq"]
    bound = 2.0 / np.sqrt(tcfg.d_model)
    assert float(wq.abs().max()) <= bound + 1e-6
    assert 0.5 * bound / 2 < float(wq.std()) < bound
    assert 0.5 < float(tparams["/embed"].std()) < 1.0


def _ragged_batch(rng, cfg, lens, width):
    toks = np.zeros((len(lens), width), np.int32)
    for r, L in enumerate(lens):
        toks[r, :L] = rng.integers(0, cfg.vocab_size, L)
    return toks, np.asarray(lens, np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_jax(rng, arch):
    """Right-padded prefill (``length``): logits at every position and
    the dense cache agree with JAX; ``rows`` picks the same logits."""
    jcfg, tcfg, jm, jparams, tm, tparams = _models(arch)
    toks, lens = _ragged_batch(rng, jcfg, [3, 7, 12], 16)
    jl, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, JCTX,
                            max_len=16, length=jnp.asarray(lens))
    tl, tcache = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                            CTX, max_len=16, length=torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            tcache["g0"]["p0"][name].numpy(),
            np.asarray(jcache["g0"]["p0"][name]), **TOL)
    rows, _ = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)}, CTX,
                         max_len=16, rows=torch.from_numpy(lens - 1))
    np.testing.assert_allclose(
        rows.numpy(), np.asarray(jl)[np.arange(3), lens - 1], **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_and_pool_match_jax(rng, arch):
    """Prefill packed into the block pool, then three paged decode
    steps: the pool contents after ``pack_prefill_into_paged`` and after
    each ``write_kv_rows``, and every step's logits, agree with JAX.
    Block 0 (the null block) is excluded: pad-tail writes collide there
    in unspecified order on both sides."""
    jcfg, tcfg, jm, jparams, tm, tparams = _models(arch)
    bs, width = 4, 16
    toks, lens = _ragged_batch(rng, jcfg, [3, 7, 12], width)
    B = len(lens)
    layout = jpk.PagedLayout(num_slots=B, num_blocks=3 * 8 + 1,
                             block_size=bs, max_len=32)
    tlayout = paged_kv.PagedLayout(num_slots=B, num_blocks=3 * 8 + 1,
                                   block_size=bs, max_len=32)
    table = np.zeros((B, layout.max_blocks_per_seq), np.int32)
    perm = rng.permutation(layout.num_blocks - 1) + 1    # scrambled ids
    table[:] = perm[:table.size].reshape(table.shape)
    nbp = width // bs
    ids = np.where(np.arange(nbp)[None, :] < -(-lens[:, None] // bs),
                   table[:, :nbp], 0).astype(np.int32)

    _, jdense = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, JCTX,
                           max_len=width, length=jnp.asarray(lens))
    jpools = jm.pack_prefill_into_paged(
        layout, jm.init_paged_cache(layout), jdense,
        jnp.arange(B, dtype=jnp.int32), jnp.ones((B,), bool),
        jnp.asarray(ids))
    _, tdense = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                           CTX, max_len=width, length=torch.from_numpy(lens))
    tpools = tm.pack_prefill_into_paged(
        tlayout, tm.init_paged_cache(tlayout), tdense,
        torch.arange(B, dtype=torch.int32), torch.ones(B, dtype=torch.bool),
        torch.from_numpy(ids))

    def check_pools():
        for name in ("k", "v"):
            np.testing.assert_allclose(
                tpools["g0"]["p0"][name][:, 1:].numpy(),
                np.asarray(jpools["g0"]["p0"][name])[:, 1:], **TOL)

    check_pools()
    length = lens.copy()
    tok = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
    for step in range(3):
        jlog, jpools = jm.decode_step_paged(
            jparams, jpools, jnp.asarray(table), jnp.asarray(length),
            jnp.asarray(tok), JCTX)
        tlog, tpools = tm.decode_step_paged(
            tparams, tpools, torch.from_numpy(table),
            torch.from_numpy(length), torch.from_numpy(tok), CTX)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL,
                                   err_msg=f"decode step {step}")
        check_pools()
        tok = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)
        length = length + 1


@pytest.mark.parametrize("arch", ["whisper_base", "qwen2_vl_2b"])
def test_encdec_and_vlm_init_and_prefill(arch):
    """The encoder-decoder and the VLM, refused until their slice, init
    from the port's own generator and prefill (whisper: 8 tokens over 12
    frames; qwen2-vl: 8 tokens behind its visual prefix, text M-RoPE
    ids) to finite logits of the vocabulary's width."""
    cfg = get_config(arch).smoke()
    model = Model(cfg, device="cpu")
    params = model.init(seed=0)
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), dtype=torch.int32,
                         generator=gen)
    batch = {"tokens": toks}
    if cfg.enc_dec:
        batch["frames"] = torch.randn((2, 12, cfg.d_model), generator=gen)
    else:
        batch["visual_embeds"] = torch.randn(
            (2, cfg.visual_prefix, cfg.d_model), generator=gen)
        batch["mrope_positions"] = torch.arange(8).expand(3, 2, 8)
    logits, cache = model.prefill(params, batch, CTX, max_len=12)
    assert logits.shape == (2, 8, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    assert set(cache) == ({"self", "cross"} if cfg.enc_dec
                          else set(params["groups"]))


@pytest.mark.parametrize("arch", ["xlstm_1_3b", "qwen3_moe_30b_a3b",
                                  "kimi_k2_1t_a32b"])
def test_xlstm_and_moe_init_and_prefill(arch):
    """The xLSTM and MoE families, refused until their slice, init from
    the port's own generator and prefill right-padded rows to finite
    logits of the vocabulary's width."""
    cfg = get_config(arch).smoke()
    model = Model(cfg, device="cpu")
    params = model.init(seed=0)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), dtype=torch.int32)
    logits, cache = model.prefill(params, {"tokens": toks}, CTX,
                                  length=torch.tensor([5, 8]))
    assert logits.shape == (2, 8, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    assert set(cache) == set(params["groups"])
