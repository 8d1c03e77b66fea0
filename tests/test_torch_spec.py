"""Speculative decoding in the port (repro_torch) against the JAX package
on the CPU, mirroring tests/test_spec_decode.py.

The chain, weakest to strongest:
  1. the plain version of kernel K3 (``kernels/ref.paged_verify_attention``,
     reached through ``ops.paged_attention(mode="verify")`` on CPU
     tensors) equals JAX's oracle and its Pallas kernel in interpret
     mode, and row j equals the decode kernel at ``lengths + 1 + j``;
  2. the accept rule and the ngram drafter give JAX's results;
  3. ``decode_verify_paged`` gives JAX's logits, tokens, commit and pools
     on olmo, yi and gemma smoke;
  4. greedy Engine tokens with every drafter equal the JAX
     SpecDecodeBackend and the port's non-speculative engine; seeded
     tokens equal the port's non-speculative engine (seeded tokens
     against the JAX engine: tests/test_torch_threefry.py);
  5. the scheduler invariants of tests/test_spec_decode.py hold.

Inputs are made by numpy from a seed and fed to both packages; weights
are JAX's init carried over with the weight bridge. Tolerances are the
JAX package's own: 1e-4 in f32, 3e-2 in bf16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch.engine import Engine as JEngine
from repro.launch.engine import EngineConfig as JEngineConfig
from repro.launch.engine import NgramDrafter as JNgramDrafter
from repro.launch.engine import SamplingParams as JSamplingParams
from repro.launch.engine import sampling as jsampling
from repro.models import paged_kv as jpk
from repro.models import transformer as jtr
from repro.models.model import Model as JModel
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.engine import (Engine, EngineConfig, NgramDrafter,
                                       SamplingParams, SpecDecodeBackend)
from repro_torch.launch.engine import sampling
from repro_torch.models import transformer, weights
from repro_torch.models.model import Model

torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JCTX = jtr.RunCtx(kernel_mode="ref")
CTX = transformer.RunCtx()
GREEDY = SamplingParams(max_tokens=12)
SEEDED = SamplingParams(max_tokens=12, temperature=0.9, top_k=30,
                        top_p=0.95, seed=7)


def _pair(arch):
    jm = JModel(jax_config(arch).smoke())
    jparams = jm.init(jax.random.PRNGKey(0))
    tcfg = get_config(arch).smoke()
    tparams = weights.from_jax_numpy(jax.tree.map(np.asarray, jparams),
                                     tcfg, "cpu")
    return jm, jparams, Model(tcfg, device="cpu"), tparams


@pytest.fixture(scope="module")
def olmo():
    return _pair("olmo_1b")


def _geo(**kw):
    base = dict(num_slots=4, num_blocks=32, block_size=4, max_len=64)
    base.update(kw)
    return base


def _engine(model, params, **kw):
    return Engine(model, params, EngineConfig(**_geo(**kw)), device="cpu")


def _prompts(rng, vocab, n=5, repetitive=False):
    if repetitive:
        return [list(map(int, (list(rng.integers(0, vocab, 3)) * 6)[:10 + i]))
                for i in range(n)]
    return [list(map(int, rng.integers(0, vocab, int(ln))))
            for ln in rng.integers(5, 14, n)]


class GarbageDrafter(NgramDrafter):
    """Adversarial drafter: random proposals, ~0% acceptance, so every
    verify step exercises the rejected-tail rewind."""

    def propose(self, active, last_tokens, histories):
        rng = np.random.default_rng(sum(map(len, histories.values())))
        return {i: [int(x) for x in rng.integers(0, 256, self.k)]
                for i in active}


# -- 1. the plain version of K3 ------------------------------------------


def _verify_case(rng, B, K1, hq, hkv, hd, bs, nbmax, lengths):
    nb = B * nbmax + 1
    q = rng.normal(size=(B, K1, hq, hd))
    kp = rng.normal(size=(nb, bs, hkv, hd))
    vp = rng.normal(size=(nb, bs, hkv, hd))
    bt = (rng.permutation(nb - 1) + 1)[:B * nbmax].reshape(B, nbmax)
    return q, kp, vp, bt.astype(np.int32), np.asarray(lengths, np.int32)


def _t(a, dtype="float32"):
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return torch.from_numpy(a.astype(np.float32)).to(TDT[dtype])
    return torch.from_numpy(a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("window", [None, 5])
def test_verify_plain_matches_jax(rng, dtype, hq, hkv, window):
    """Window-start lengths zero, mid-block, block boundary and deep, and
    a pad row whose limits run past the table width (20 positions)."""
    B, K1, hd, bs, nbmax = 5, 4, 16, 4, 5
    q, kp, vp, bt, ln = _verify_case(rng, B, K1, hq, hkv, hd, bs, nbmax,
                                     [0, 3, 8, 14, nbmax * bs - 2])
    got = ops.paged_attention(_t(q, dtype), {"k": _t(kp, dtype),
                                             "v": _t(vp, dtype)},
                              _t(bt), _t(ln), mode="verify", window=window)
    assert got.dtype == TDT[dtype] and got.shape == (B, K1, hq, hd)
    jd = getattr(jnp, dtype)
    jargs = (jnp.asarray(q, jd), jnp.asarray(kp, jd), jnp.asarray(vp, jd),
             jnp.asarray(bt), jnp.asarray(ln))
    tol = TOL[dtype]
    want = jref.paged_verify_attention(*jargs, window=window)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    if dtype == "float32":        # the Pallas kernel body, interpreted
        want_k = jops.paged_verify_attention(*jargs, window=window,
                                             mode="interpret")
        np.testing.assert_allclose(got.numpy(), np.asarray(want_k),
                                   rtol=tol, atol=tol)


def test_verify_row_j_is_decode_at_length_plus_one_plus_j(rng):
    """K3 counts the tokens BEFORE the window, K2 the tokens including
    the current one: row j of verify == decode at lengths + 1 + j."""
    B, K1, hq, hkv, hd, bs, nbmax = 3, 3, 4, 2, 8, 4, 4
    q, kp, vp, bt, ln = _verify_case(rng, B, K1, hq, hkv, hd, bs, nbmax,
                                     [2, 7, 0])
    pool = {"k": _t(kp), "v": _t(vp)}
    multi = ops.paged_attention(_t(q), pool, _t(bt), _t(ln), mode="verify")
    for j in range(K1):
        single = ops.paged_attention(_t(q[:, j]), pool, _t(bt),
                                     _t(ln + 1 + j), mode="decode")
        np.testing.assert_allclose(multi[:, j].numpy(), single.numpy(),
                                   atol=1e-6)


# -- 2. accept rule and ngram drafter ------------------------------------


def _accept_case(rng, B=5, K1=4, V=11):
    logits = rng.normal(size=(B, K1, V)).astype(np.float32)
    tgt = logits.argmax(-1)
    tokens = rng.integers(0, V, (B, K1)).astype(np.int32)
    for b in range(B):                  # matching prefixes of every length
        n = b % K1
        tokens[b, 1:1 + n] = tgt[b, :n]
    num_drafts = np.asarray([3, 3, 1, 0, 2][:B], np.int32)
    return logits, tokens, num_drafts


def test_verify_accept_greedy_matches_jax(rng):
    logits, tokens, nd = _accept_case(rng)
    want = jsampling.verify_accept_greedy(
        jnp.asarray(logits), jnp.asarray(tokens), jnp.asarray(nd))
    got = sampling.verify_accept_greedy(_t(logits), _t(tokens), _t(nd))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    commit = got[1].tolist()
    assert commit[2] == 2 and commit[3] == 1      # capped by num_drafts


def test_accept_targets_matches_jax(rng):
    """The shared tail of the accept rule on targets that are no argmax
    (a seeded draw), drafts matching them for every prefix length."""
    _, tokens, nd = _accept_case(rng)
    tgt = rng.integers(0, 11, tokens.shape).astype(np.int32)
    tokens[:, 1:] = np.where(rng.random((5, 3)) < 0.7, tgt[:, :-1],
                             tokens[:, 1:])
    want = jsampling._accept_targets(jnp.asarray(tgt), jnp.asarray(tokens),
                                     jnp.asarray(nd))
    got = sampling._accept_targets(_t(tgt), _t(tokens), _t(nd))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_verify_accept_seeded_is_the_port_sampler_at_steps_plus_j(rng):
    """Seeded acceptance couples to the SAME stream the port's sampler
    draws from: target row j == sample_tokens at step + j."""
    V, K1 = 13, 3
    logits = _t(rng.normal(size=(2, K1, V)))
    seeds = torch.tensor([5, 9], dtype=torch.int32)
    temps = torch.tensor([0.8, 1.2])
    steps0 = torch.tensor([2, 0], dtype=torch.int32)
    z = torch.zeros(2, dtype=torch.int32)
    ones = torch.ones(2)
    want = torch.stack([sampling.sample_tokens(logits[:, j], seeds,
                                               steps0 + j, temps, z, ones)
                        for j in range(K1)], dim=1)
    tokens = torch.zeros((2, K1), dtype=torch.int32)
    tokens[:, 1:] = want[:, :K1 - 1]
    out, commit = sampling.verify_accept(
        logits, tokens, torch.tensor([2, 2], dtype=torch.int32), seeds,
        steps0, temps, z, ones)
    assert commit.tolist() == [K1, K1]
    assert torch.equal(out, want.int())


@pytest.mark.parametrize("kind", ["random", "periodic"])
def test_ngram_lookup_matches_jax(rng, kind):
    mine, ref_ = NgramDrafter(k=3, max_ngram=3), JNgramDrafter(k=3,
                                                               max_ngram=3)
    hists = [[1, 2, 3, 9, 1, 2, 3, 7, 8, 1, 2, 3], [5, 5, 5, 5],
             [1, 2, 3, 4], [4], [7, 1, 9, 2, 9]]
    for n in range(30):
        if kind == "random":
            hists.append(list(map(int, rng.integers(0, 4, 2 + n))))
        else:
            period = list(map(int, rng.integers(0, 50, 1 + n % 5)))
            hists.append((period * 12)[:3 + n])
    for h in hists:
        assert mine.lookup(h) == ref_.lookup(h), h
    assert mine.lookup([1, 2, 3, 9, 1, 2, 3, 7, 8, 1, 2, 3]) == [7, 8, 1]


# -- 3. the model's verify pass ------------------------------------------


@pytest.mark.parametrize("arch", ["olmo_1b", "yi_6b", "gemma_7b"])
def test_decode_verify_paged_matches_jax(rng, arch):
    """One verify pass over random pools: logits, emitted tokens, commit
    and the pools written in place agree with JAX (block 0 excluded:
    the pad rows of the slot near max_len collide there)."""
    jm, jparams, tm, tparams = _pair(arch)
    B, K1, bs = 4, 4, 4
    layout = jpk.PagedLayout(num_slots=B, num_blocks=B * 6 + 1,
                             block_size=bs, max_len=24)
    jpools = jax.tree.map(
        lambda z: jnp.asarray(rng.normal(size=z.shape), z.dtype),
        jm.init_paged_cache(layout))
    tpools = jax.tree.map(lambda a: _t(np.asarray(a)), jpools)
    table = (rng.permutation(B * 6) + 1).reshape(B, 6).astype(np.int32)
    lengths = np.asarray([0, 5, 9, 22], np.int32)     # last: past the table
    tokens = rng.integers(0, jm.cfg.vocab_size, (B, K1)).astype(np.int32)
    nd = np.asarray([3, 2, 3, 1], np.int32)
    seen = {}

    def jcommit(lg):
        seen["jax"] = lg
        return jsampling.verify_accept_greedy(lg, jnp.asarray(tokens),
                                              jnp.asarray(nd))

    def tcommit(lg):
        seen["port"] = lg
        return sampling.verify_accept_greedy(lg, _t(tokens), _t(nd))

    jout, jc, jpools = jm.decode_verify(
        jparams, jpools, jnp.asarray(table), jnp.asarray(lengths),
        jnp.asarray(tokens), jcommit, JCTX)
    tout, tc, tpools = tm.decode_verify(
        tparams, tpools, _t(table), _t(lengths), _t(tokens), tcommit, CTX)
    np.testing.assert_allclose(seen["port"].numpy(), np.asarray(seen["jax"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for name in ("k", "v"):
        np.testing.assert_allclose(
            tpools["g0"]["p0"][name][:, 1:].numpy(),
            np.asarray(jpools["g0"]["p0"][name])[:, 1:], rtol=1e-4,
            atol=1e-4)


# -- 4. engine equivalence -----------------------------------------------


@pytest.fixture(scope="module")
def jax_spec_greedy(olmo):
    """The JAX SpecDecodeBackend's greedy tokens on repetitive + random
    prompts (made from the rng seed 0, as the ``rng`` fixture)."""
    jm, jparams, _, _ = olmo
    rng = np.random.default_rng(0)
    prompts = _prompts(rng, jm.cfg.vocab_size, repetitive=True) \
        + _prompts(rng, jm.cfg.vocab_size, n=2)
    out = JEngine(jm, jparams, JEngineConfig(
        backend="paged", spec_tokens=3, **_geo())).generate(
            prompts, JSamplingParams(max_tokens=12))
    return prompts, out


@pytest.mark.parametrize("drafter", ["ngram", "draft_model", "garbage"])
def test_spec_engine_greedy_matches_jax_and_nonspec(olmo, jax_spec_greedy,
                                                    drafter):
    _, _, tm, tparams = olmo
    prompts, want = jax_spec_greedy
    base = _engine(tm, tparams).generate(prompts, GREEDY)
    kw = {"spec_tokens": 3}
    if drafter == "draft_model":
        kw.update(drafter="draft_model", draft_model=tm,
                  draft_params=tm.init(seed=7))
    spec = _engine(tm, tparams, **kw)
    if drafter == "garbage":
        spec.backend.drafter = GarbageDrafter(3)
    got = spec.generate(prompts, GREEDY)
    assert got == want == base
    st = spec.stats()
    assert isinstance(spec.backend, SpecDecodeBackend)
    assert st["blocks_used"] == 0 and st["spec"]["proposed"] > 0
    if drafter == "garbage":
        assert st["spec"]["accepted"] == 0


@pytest.mark.parametrize("arch", ["olmo_1b", "yi_6b", "gemma_7b"])
def test_spec_prefix_cached_engine_matches_jax(rng, arch):
    """Speculative decoding with the prefix cache (both on, the JAX
    engine's default config plus spec_tokens) on prompts sharing a
    block-aligned prefix: greedy tokens equal the JAX engine's in the
    same configuration, with equal prefix-cache counters."""
    jm, jparams, tm, tparams = _pair(arch)
    common = list(map(int, rng.integers(0, tm.cfg.vocab_size, 8)))
    prompts = [common + list(map(int, rng.integers(0, tm.cfg.vocab_size,
                                                   3))) * 2
               for _ in range(4)] + _prompts(rng, tm.cfg.vocab_size, n=2)
    geo = _geo(num_slots=2, spec_tokens=3)
    jeng = JEngine(jm, jparams, JEngineConfig(backend="paged", **geo))
    want = jeng.generate(prompts, JSamplingParams(max_tokens=8))
    spec = _engine(tm, tparams, num_slots=2, spec_tokens=3)
    assert spec.generate(prompts, SamplingParams(max_tokens=8)) == want
    st, jst = spec.stats(), jeng.stats()
    assert st["prefix_cache"]["hits"] > 0
    for key in ("hits", "hit_tokens", "cow_copies"):
        assert st["prefix_cache"][key] == jst["prefix_cache"][key], key
    assert st["blocks_used"] == 0


@pytest.mark.parametrize("drafter", ["ngram", "draft_model", "garbage"])
def test_spec_engine_seeded_matches_nonspec(rng, olmo, drafter):
    _, _, tm, tparams = olmo
    prompts = _prompts(rng, tm.cfg.vocab_size, repetitive=True) \
        + _prompts(rng, tm.cfg.vocab_size, n=2)
    want = _engine(tm, tparams).generate(prompts, SEEDED)
    kw = {"spec_tokens": 3}
    if drafter == "draft_model":
        kw.update(drafter="draft_model", draft_model=tm,
                  draft_params=tparams)           # self-draft: accepts
    spec = _engine(tm, tparams, **kw)
    if drafter == "garbage":
        spec.backend.drafter = GarbageDrafter(3)
    assert spec.generate(prompts, SEEDED) == want
    assert spec.stats()["blocks_used"] == 0


# -- 5. scheduler invariants under speculation ---------------------------


def test_spec_stop_tokens_mid_window(rng, olmo):
    """A stop/eos token emitted mid-window retires the request there;
    accepted-but-unemitted tokens are discarded with the slot. The stop
    ids are tokens the greedy model emits mid-output."""
    _, _, tm, tparams = olmo
    prompts = _prompts(rng, tm.cfg.vocab_size, n=4, repetitive=True)
    free = _engine(tm, tparams).generate(prompts, GREEDY)
    stops = (free[0][3], free[2][5])
    sp = SamplingParams(max_tokens=12, stop_token_ids=stops)
    want = _engine(tm, tparams, eos_id=free[1][4]).generate(prompts, sp)
    spec = _engine(tm, tparams, eos_id=free[1][4], spec_tokens=3)
    assert spec.generate(prompts, sp) == want
    assert any(len(w) < 12 for w in want)
    assert spec.stats()["blocks_used"] == 0


def test_spec_no_leak_under_preemption(rng, olmo):
    """A tiny pool: growth for verify windows forces LIFO preemption and
    rejected-tail trims; every block comes home."""
    _, _, tm, tparams = olmo
    geo = dict(num_slots=4, num_blocks=9, block_size=4, max_len=32)
    prompts = [list(map(int, rng.integers(0, tm.cfg.vocab_size, 6)))
               for _ in range(6)]
    sp = SamplingParams(max_tokens=20)
    want = _engine(tm, tparams, **geo).generate(prompts, sp)
    spec = _engine(tm, tparams, spec_tokens=3, watermark_blocks=1, **geo)
    assert spec.generate(prompts, sp) == want
    st = spec.stats()
    assert st["blocks_used"] == 0 and st["preemptions"] > 0
    assert st["spec"]["per_request"]


def test_spec_window_shrinks_before_evicting(rng, olmo):
    """When the pool covers plain decode but not a full verify window,
    the slot shrinks its own drafts instead of preempting others."""
    _, _, tm, tparams = olmo
    geo = dict(num_slots=2, num_blocks=11, block_size=4, max_len=24)
    prompts = [(list(map(int, rng.integers(0, tm.cfg.vocab_size, 2)))
                * 5)[:7] for _ in range(2)]
    sp = SamplingParams(max_tokens=12)
    spec = _engine(tm, tparams, spec_tokens=3, **geo)
    assert spec.generate(prompts, sp) == \
        _engine(tm, tparams, **geo).generate(prompts, sp)
    st = spec.stats()
    assert st["preemptions"] == 0, "speculation must not evict"
    assert st["blocks_used"] == 0


@pytest.mark.parametrize("drafter", ["garbage", "ngram", "draft_model"])
def test_spec_window_clamped_at_position_cap(olmo, drafter):
    """A slot within K tokens of max_len clamps its draft window (no
    block-table overflow), and pad rows past the cap write to the null
    block, never into the slot's own last real block."""
    _, _, tm, tparams = olmo
    geo = dict(num_slots=2, num_blocks=24, block_size=4, max_len=32)
    prompts = [[1, 2] * 6, [3, 4] * 6]
    sp = SamplingParams(max_tokens=20)        # 12 + 20 == max_len exactly
    want = _engine(tm, tparams, **geo).generate(prompts, sp)
    kw = dict(geo, spec_tokens=4)
    if drafter == "draft_model":
        kw.update(drafter="draft_model", draft_model=tm,
                  draft_params=tm.init(seed=3))
    spec = _engine(tm, tparams, **kw)
    if drafter == "garbage":
        spec.backend.drafter = GarbageDrafter(4)
    assert spec.generate(prompts, sp) == want
    assert spec.stats()["blocks_used"] == 0


def test_draft_model_cache_has_no_holes(olmo):
    """Full-accept windows leave the draft cache one token behind the
    target; the catch-up feed fills that position, so every position
    below the draft's frontier holds real K/V."""
    _, _, tm, tparams = olmo
    spec = _engine(tm, tparams, spec_tokens=3, drafter="draft_model",
                   draft_model=tm, draft_params=tparams)  # self-draft
    spec.add_request([5, 9, 5, 9, 5], SamplingParams(max_tokens=40))
    for _ in range(7):
        if spec.has_work:
            spec.step()
    dr = spec.backend.drafter
    pos = int(dr.pos[0])
    assert pos > 10, "window never advanced: test premise broken"
    leaf = dr.cache["g0"]["p0"]["k"]                 # (L, B, S, Hkv, D)
    norms = leaf[0, 0].float().reshape(leaf.shape[2], -1).norm(dim=1)
    holes = [p for p in range(pos) if float(norms[p]) == 0.0]
    assert not holes, f"unwritten draft-cache positions: {holes}"


def test_spec_stats_counters(rng, olmo):
    _, _, tm, tparams = olmo
    spec = _engine(tm, tparams, spec_tokens=3)
    prompts = _prompts(rng, tm.cfg.vocab_size, n=3, repetitive=True)
    spec.generate(prompts, SamplingParams(max_tokens=16))
    st = spec.stats()["spec"]
    assert st["spec_tokens"] == 3 and st["steps"] > 0
    assert st["emitted"] >= st["steps"]
    assert 0.0 <= st["accept_rate"] <= 1.0
    per = st["per_request"]
    assert len(per) == 3
    assert sum(r["proposed"] for r in per.values()) == st["proposed"]
    assert sum(r["accepted"] for r in per.values()) == st["accepted"]
    h = spec.finished[0]
    assert h.num_draft_proposed == per[h.uid]["proposed"]


def test_spec_reset_telemetry_clears_live_handles(olmo):
    """Warm-up -> reset -> measure: per-request draft counters of STILL
    ACTIVE handles reset with the aggregates."""
    _, _, tm, tparams = olmo
    eng = _engine(tm, tparams, spec_tokens=3, num_slots=2,
                  prefix_cache=False)
    eng.add_request([7, 3, 9, 5] * 3, SamplingParams(max_tokens=24))
    be = eng.backend
    for _ in range(6):
        be.step()
    live = [s.req for s in be.slots if s.req is not None]
    assert live and any(r.num_draft_proposed > 0 for r in live)
    be.reset_telemetry()
    st = be.stats()["spec"]
    assert st["proposed"] == st["accepted"] == 0
    assert all(v["proposed"] == 0 and v["accepted"] == 0
               for v in st["per_request"].values())
    eng.drain()
    assert be.alloc.used_count == 0


def test_spec_config_validation(olmo):
    _, _, tm, tparams = olmo
    with pytest.raises(ValueError, match="paged"):
        Engine(tm, tparams, EngineConfig(backend="static", spec_tokens=2),
               device="cpu")
    with pytest.raises(ValueError, match="incompatible"):
        Engine(tm, tparams, EngineConfig(overlap=True, spec_tokens=2),
               device="cpu")
    with pytest.raises(ValueError, match="draft_model"):
        _engine(tm, tparams, spec_tokens=2, drafter="draft_model")
    with pytest.raises(ValueError, match="unknown drafter"):
        _engine(tm, tparams, spec_tokens=2, drafter="nope")
    with pytest.raises(ValueError, match="max_len"):
        _engine(tm, tparams, spec_tokens=8, max_len=9)
    # recurrent draft models cannot roll back by pointer rewind
    rg_cfg = dataclasses.replace(get_config("recurrentgemma_2b").smoke(),
                                 vocab_size=tm.cfg.vocab_size)
    with pytest.raises(ValueError, match="attention-only"):
        _engine(tm, tparams, spec_tokens=2, drafter="draft_model",
                draft_model=Model(rg_cfg, device="cpu"), draft_params={})
