"""The port's single-device, dropless MoE against the JAX package on the
CPU: qwen3_moe_30b_a3b smoke (8 experts, top-2, ``qk_norm``) and
kimi_k2_1t_a32b smoke (8 experts, top-2).

The chain, weakest to strongest:
  1. the layer: ``route`` (ids and renormalized weights, ties to the
     lower expert), ``dispatch_indices`` and ``apply_moe`` against JAX's
     ``apply_moe(dropless=True)``; pad and batch invariance (JAX's
     tests/test_workload_serve.py:435); the combine's fixed order;
  2. the model: right-padded prefill logits and four paged decode
     steps; the weight bridge keeps the router f32; the bf16 init tree;
  3. the Engine, token for token against the JAX Engine, with equal
     scheduler and prefix-cache counters: greedy with preemption,
     seeded, speculative (ngram, K 3; a draft model on qwen3), int8 and
     fp8 pools, ``overlap=True`` and the static backend, on prompts that
     share a block-aligned prefix (partial hits and a full hit).

Inputs are made by numpy from a seed and fed to both packages; weights
are JAX's init carried over with the weight bridge. Tolerance 1e-4 for
f32 values; ids, counters and tokens exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.engine import Engine as JEngine
from repro.launch.engine import EngineConfig as JEngineConfig
from repro.launch.engine import SamplingParams as JSamplingParams
from repro.models import moe as jmoe
from repro.models import paged_kv as jpk
from repro.models import transformer as jtr
from repro.models.model import Model as JModel
from repro_torch.configs import get_config
from repro_torch.launch.engine import Engine, EngineConfig, SamplingParams
from repro_torch.models import moe, paged_kv, transformer, weights
from repro_torch.models.model import Model

torch.set_num_threads(1)

ARCHS = ("qwen3_moe_30b_a3b", "kimi_k2_1t_a32b")
JCTX = jtr.RunCtx(kernel_mode="ref")
CTX = transformer.RunCtx()
TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **{**TOL, **kw})


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}/{k}") if isinstance(v, dict)
                   else {f"{prefix}/{k}": v})
    return out


_MODELS = {}


def _models(arch):
    """(jcfg, tcfg, JAX model, JAX params, port model, port params),
    built once a module."""
    if arch not in _MODELS:
        jcfg, tcfg = jax_config(arch).smoke(), get_config(arch).smoke()
        jm = JModel(jcfg)
        jparams = jm.init(jax.random.PRNGKey(0))
        tparams = weights.from_jax_numpy(jax.tree.map(np.asarray, jparams),
                                         tcfg, "cpu")
        _MODELS[arch] = (jcfg, tcfg, jm, jparams, Model(tcfg, device="cpu"),
                         tparams)
    return _MODELS[arch]


def _layer_moe(arch):
    """Layer 0's expert params of ``arch`` smoke, as JAX and as torch."""
    jcfg, tcfg, _, jparams, _, _ = _models(arch)
    jp = jax.tree.map(lambda t: t[0], jparams["groups"]["g0"]["p0"]["moe"])
    return jcfg, tcfg, jp, weights.map_tree(_t, jax.tree.map(np.asarray, jp))


# -- 1. the layer ------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_route_dispatch_and_moe_match_jax(rng, arch):
    """21 tokens: the top-k ids and the sorted bookkeeping equal JAX's
    exactly, the weights and the dropless output within 1e-4."""
    jcfg, tcfg, jp, tp = _layer_moe(arch)
    x = rng.normal(size=(3, 7, jcfg.d_model)).astype(np.float32)
    x2d = x.reshape(-1, jcfg.d_model)
    ti, tw = moe.route(_t(x2d), tp["router"], tcfg.moe_top_k)
    ji, jw, _, _ = jmoe.route(jnp.asarray(x2d), jp["router"],
                              jcfg.moe_top_k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tw.numpy(), jw, rtol=1e-6, atol=1e-6)
    got = moe.dispatch_indices(ti, tcfg.n_experts)
    want = jmoe._dispatch_indices(ji, jcfg.moe_top_k, jcfg.n_experts,
                                  x2d.shape[0])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    out = moe.apply_moe(tp, tcfg, _t(x))
    jout, _ = jmoe.apply_moe(jp, jcfg, jnp.asarray(x), dropless=True)
    assert out.shape == x.shape
    _close(out.numpy(), jout)


def test_route_breaks_ties_toward_the_lower_expert():
    """Equal router columns give equal probabilities: the lower expert
    id is taken first, as ``jax.lax.top_k`` takes it."""
    cfg = get_config("qwen3_moe_30b_a3b").smoke()
    w = torch.zeros((cfg.d_model, cfg.n_experts))
    w[:, 5] = w[:, 2] = w[:, 6] = 0.3
    x = torch.ones((4, cfg.d_model))
    ids, wts = moe.route(x, w, 3)
    assert ids.tolist() == [[2, 5, 6]] * 4
    jids, _, _, _ = jmoe.route(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                               3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


def test_dropless_is_pad_and_batch_invariant(rng):
    """JAX's tests/test_workload_serve.py:435 on the port: a token's
    output does not depend on right padding or on the rows beside it."""
    cfg = get_config("qwen3_moe_30b_a3b").smoke()
    gen = torch.Generator().manual_seed(0)
    params = moe.init_moe(gen, cfg, torch.float32)
    x = _t(rng.normal(size=(1, 6, cfg.d_model)).astype(np.float32))
    alone = moe.apply_moe(params, cfg, x)
    pad = _t(rng.normal(size=(1, 10, cfg.d_model)).astype(np.float32))
    padded = moe.apply_moe(params, cfg, torch.cat([x, pad], dim=1))
    _close(alone[0].numpy(), padded[0, :6].numpy(), rtol=1e-5, atol=1e-6)
    others = _t(rng.normal(size=(3, 6, cfg.d_model)).astype(np.float32))
    batched = moe.apply_moe(params, cfg, torch.cat([others, x]))
    _close(alone[0].numpy(), batched[3].numpy(), rtol=1e-5, atol=1e-6)


def test_combine_sums_each_token_in_expert_order(rng):
    """The combine is each token's k weighted expert outputs added one
    by one in ascending expert order from zero, bit for bit: no order
    left to the backend."""
    cfg = get_config("kimi_k2_1t_a32b").smoke()
    gen = torch.Generator().manual_seed(1)
    p = moe.init_moe(gen, cfg, torch.float32)
    x = _t(rng.normal(size=(9, cfg.d_model)).astype(np.float32))
    got = moe.apply_moe(p, cfg, x[None])[0]
    ids, wts = moe.route(x, p["router"], cfg.moe_top_k)
    act = torch.nn.functional.silu
    want = torch.zeros_like(x)
    for t in range(x.shape[0]):
        for j in ids[t].argsort().tolist():
            e = int(ids[t, j])
            xe = x[t:t + 1]
            ye = (act(xe @ p["w1"][e]) * (xe @ p["w3"][e])) @ p["w2"][e]
            want[t] = want[t] + ye[0] * wts[t, j]
    _close(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


# -- 2. the model ------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_paged_decode_match_jax(rng, arch):
    """Right-padded prefill of rows 3, 9 and 14 tokens long packed into
    the pool, then four paged decode steps: logits at every real
    position and step, and the pool's K/V, within 1e-4 of JAX."""
    jcfg, tcfg, jm, jparams, tm, tparams = _models(arch)
    toks = np.zeros((3, 16), np.int32)
    lens = np.asarray([3, 9, 14], np.int32)
    for r, n in enumerate(lens):
        toks[r, :n] = rng.integers(0, jcfg.vocab_size, n)
    jl, jdense = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, JCTX,
                            max_len=16, length=jnp.asarray(lens))
    tl, tdense = tm.prefill(tparams, {"tokens": _t(toks)}, CTX, max_len=16,
                            length=_t(lens))
    for r, n in enumerate(lens):
        _close(tl[r, :n].numpy(), np.asarray(jl)[r, :n])
    geo = dict(num_slots=3, num_blocks=25, block_size=4, max_len=32)
    jlay, tlay = jpk.PagedLayout(**geo), paged_kv.PagedLayout(**geo)
    table = (np.arange(24, dtype=np.int32) + 1).reshape(3, 8)
    slots, valid = np.arange(3, dtype=np.int32), np.ones(3, bool)
    jpools = jm.pack_prefill_into_paged(
        jlay, jm.init_paged_cache(jlay), jdense, jnp.asarray(slots),
        jnp.asarray(valid), jnp.asarray(table[:, :4]))
    tpools = tm.pack_prefill_into_paged(
        tlay, tm.init_paged_cache(tlay), tdense, _t(slots), _t(valid),
        _t(table[:, :4]))
    length = lens.copy()
    tok = rng.integers(0, jcfg.vocab_size, (3, 1)).astype(np.int32)
    for step in range(4):
        jlog, jpools = jm.decode_step_paged(
            jparams, jpools, jnp.asarray(table), jnp.asarray(length),
            jnp.asarray(tok), JCTX)
        tlog, tpools = tm.decode_step_paged(
            tparams, tpools, _t(table), _t(length), _t(tok), CTX)
        _close(tlog.numpy(), jlog, err_msg=f"decode step {step}")
        tok = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)
        length = length + 1
    want = _leaves(jax.tree.map(np.asarray, jpools))
    for path, t in _leaves(tpools).items():
        _close(t[:, 1:].numpy(), want[path][:, 1:], err_msg=path)


def test_bridge_keeps_the_router_f32_and_init_tree_matches_jax():
    """A bf16 cast through the bridge leaves the router f32 (JAX keeps
    it f32 in any dtype) and casts the experts; the port's bf16 init
    (smoke, and one full-width qwen3 block's router and MoE norms) has
    JAX's ``eval_shape`` tree, shapes and dtypes, ``moe`` where the
    dense config would have ``mlp``."""
    jcfg, tcfg, _, jparams, _, _ = _models("qwen3_moe_30b_a3b")
    bf = weights.from_jax_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu", dtype=torch.bfloat16)
    m = bf["groups"]["g0"]["p0"]["moe"]
    assert m["router"].dtype == torch.float32
    assert m["w1"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        m["router"].numpy(),
        np.asarray(jparams["groups"]["g0"]["p0"]["moe"]["router"]))
    for arch in ARCHS:
        jc, tc = jax_config(arch).smoke(), get_config(arch).smoke()
        mine = _leaves(Model(dataclasses.replace(tc, dtype="bfloat16"),
                             device="cpu").init(seed=0))
        jshapes = _leaves(jax.eval_shape(lambda jc=jc: JModel(
            dataclasses.replace(jc, dtype="bfloat16")).init(
                jax.random.PRNGKey(0))))
        assert mine.keys() == jshapes.keys(), arch
        assert not any("/mlp/" in p for p in mine)
        for path, s in jshapes.items():
            assert tuple(mine[path].shape) == s.shape, path
            assert str(mine[path].dtype).split(".")[-1] == str(s.dtype), path


# -- 3. the Engine -----------------------------------------------------------


GEO = dict(num_slots=3, block_size=4, num_blocks=14, max_len=64)
PAGED_STATS = ("steps", "preemptions", "prefill_calls", "prefill_reqs",
               "prefill_tokens", "blocks_used", "bucketed_prefill")
STATIC_STATS = ("steps", "batches", "mean_active_slots", "cache_utilization",
                "prefill_compiles")
PREFIX_STATS = ("lookups", "hits", "hit_tokens", "cow_copies", "evictions",
                "lru_blocks")
MODES = {
    "greedy": ({}, None),
    "seeded": ({}, dict(temperature=0.9, top_k=30, top_p=0.95)),
    "spec3": ({"spec_tokens": 3}, None),
    "int8": ({"kv_dtype": "int8"}, None),
    "fp8": ({"kv_dtype": "fp8"}, None),
    "overlap": ({"overlap": True}, None),
    "static": ({"backend": "static"}, None),
}


def _prompts(rng):
    """Five prompts behind a shared 8-token (two-block) prefix, and a
    repeat of the first: partial prefix hits and one full hit."""
    common = list(map(int, rng.integers(0, 256, 8)))
    prompts = [common + list(map(int, rng.integers(0, 256, n)))
               for n in (1, 6, 12, 3, 9)]
    return prompts + [list(prompts[1])]


def _both(arch, prompts, sps, draft=False, **kw):
    """The same requests through the JAX Engine and the port's, same
    geometry and weights (``draft``: the olmo_1b smoke draft model, JAX's
    init from key 1, on both). Returns (jax tokens, port tokens, jax
    stats, port stats)."""
    _, _, jm, jparams, tm, tparams = _models(arch)
    jsps = [JSamplingParams(**dataclasses.asdict(sp)) for sp in sps]
    jkw = dict(kw)
    if draft:
        dcfg = get_config("olmo_1b").smoke()
        jdm = JModel(jax_config("olmo_1b").smoke())
        jdparams = jdm.init(jax.random.PRNGKey(1))
        jkw.update(draft_model=jdm, draft_params=jdparams)
        kw.update(draft_model=Model(dcfg, device="cpu"),
                  draft_params=weights.from_jax_numpy(
                      jax.tree.map(np.asarray, jdparams), dcfg, "cpu"))
    jeng = JEngine(jm, jparams, JEngineConfig(**{"backend": "paged", **GEO,
                                                 **jkw}))
    want = jeng.generate(prompts, jsps)
    eng = Engine(tm, tparams, EngineConfig(**GEO, **kw), device="cpu")
    got = eng.generate(prompts, sps)
    return want, got, jeng.stats(), eng.stats()


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine(rng, arch, mode):
    """The six prompts, 12-16 new tokens each, on three slots and 13
    usable blocks (the paged pool preempts under greedy): the port's
    Engine and the JAX Engine in the same mode give equal tokens, equal
    scheduler counters and (paged) equal prefix-cache counters with at
    least one hit, and no block leaks. With ``overlap=True`` the tokens
    also equal the port's own overlap-off engine."""
    kw, samp = MODES[mode]
    prompts = _prompts(rng)
    sps = [SamplingParams(max_tokens=16 if mode == "greedy" else 12,
                          **({**samp, "seed": s} if samp else {}))
           for s in range(len(prompts))]
    want, got, jst, st = _both(arch, prompts, sps, **kw)
    if mode == "overlap":
        # JAX's overlap=True tokens on these MoE configs vary from run to
        # run (ROADMAP queue 3); its schedule does not. The tokens are
        # held to JAX's overlap-off engine, which JAX's own contract
        # makes equal, the counters to its overlap engine.
        want, off, _, _ = _both(arch, prompts, sps)
        assert off == want
    assert got == want
    for k in (STATIC_STATS if mode == "static" else PAGED_STATS):
        assert st[k] == jst[k], k
    if mode == "static":
        return
    assert st["blocks_used"] == 0
    for k in PREFIX_STATS:
        assert st["prefix_cache"][k] == jst["prefix_cache"][k], k
    assert st["prefix_cache"]["hits"] >= 1
    if mode == "greedy":
        assert st["preemptions"] >= 1
    if mode == "spec3":
        assert st["spec"]["accepted"] == jst["spec"]["accepted"]


def test_draft_model_engine_matches_jax_engine(rng):
    """qwen3 smoke as the target of the draft-model drafter (an
    attention-only olmo_1b smoke draft with its own weights): tokens and
    the accepted count equal the JAX speculative engine's, and the
    tokens equal the port's plain engine's."""
    prompts = _prompts(rng)
    sps = [SamplingParams(max_tokens=10)] * len(prompts)
    want, got, jst, st = _both("qwen3_moe_30b_a3b", prompts, sps,
                               draft=True, spec_tokens=3,
                               drafter="draft_model")
    assert got == want
    assert st["spec"]["accepted"] == jst["spec"]["accepted"]
    assert st["blocks_used"] == 0
    _, _, _, _, tm, tparams = _models("qwen3_moe_30b_a3b")
    plain = Engine(tm, tparams, EngineConfig(**GEO), device="cpu")
    assert plain.generate(prompts, sps) == got
