"""The port's copy-on-write prefix cache (repro_torch) against the JAX
package on the CPU, mirroring tests/test_prefix_cache.py.

  1. ``PrefixIndex`` insert / match / evict give JAX's results on the
     same op sequences;
  2. greedy outputs with the cache on == cache off == the JAX engine
     (cache on) on olmo, yi and gemma smoke, with every
     ``stats()["prefix_cache"]`` counter equal to JAX's on the same run;
  3. a full hit costs no prefill and copies the shared tail block once
     (COW); partial hits prefill only the suffix (through the verify
     pass); preemption, speculative decoding and eviction pressure keep
     outputs and counters equal to JAX's, with zero leaked blocks.

Weights are JAX's init carried over with the weight bridge; prompts are
made by numpy from a seed.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.engine import Engine as JEngine
from repro.launch.engine import EngineConfig as JEngineConfig
from repro.launch.engine import SamplingParams as JSamplingParams
from repro.models import paged_kv as jpk
from repro.models.model import Model as JModel
from repro_torch.configs import get_config
from repro_torch.launch.engine import Engine, EngineConfig, SamplingParams
from repro_torch.models import paged_kv, weights
from repro_torch.models.model import Model

torch.set_num_threads(1)

COUNTERS = ("lookups", "hits", "hit_tokens", "cow_copies", "evictions",
            "lru_blocks")


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
    base = dict(num_slots=2, block_size=4, num_blocks=33, max_len=48)
    base.update(kw)
    return base


def _eng(model, params, *, prefix_cache, **kw):
    return Engine(model, params,
                  EngineConfig(prefix_cache=prefix_cache, **_geo(**kw)),
                  device="cpu")


def _jax_run(jm, jparams, prompts, n_new, **kw):
    eng = JEngine(jm, jparams, JEngineConfig(backend="paged",
                                             prefix_cache=True,
                                             **_geo(**kw)))
    out = eng.generate(prompts, JSamplingParams(max_tokens=n_new))
    return out, eng.stats()


def _shared_work(rng, vocab, n=6, shared=12, unique=3):
    """Prompts sharing a long common prefix (block-aligned at bs=4)."""
    common = list(map(int, rng.integers(0, vocab, shared)))
    return [common + list(map(int, rng.integers(0, vocab, unique)))
            for _ in range(n)]


def _assert_clean(be):
    assert be.alloc.used_count == 0
    assert be.alloc.free_count == be.layout.usable_blocks
    be.alloc.check_invariant()


def _same_counters(st, jst):
    for key in ("prefill_tokens", "prefill_calls", "preemptions",
                "blocks_used"):
        assert st[key] == jst[key], key
    for key in COUNTERS:
        assert st["prefix_cache"][key] == jst["prefix_cache"][key], key


# -- 1. the prefix index -------------------------------------------------


def _index_ops(ix):
    toks = list(range(11))                # two full chunks + partial tail
    return [ix.insert(toks, [5, 6, 7]), ix.match(toks), ix.match(toks[:4]),
            ix.match(toks[:3]), ix.match([9] + toks[1:]),
            ix.insert(toks, [8, 9]), ix.match(toks), ix.evict_block(5),
            ix.match(toks), ix.insert(toks[:8], [3, 4]), ix.match(toks),
            len(ix)]


def test_prefix_index_matches_jax():
    got = _index_ops(paged_kv.PrefixIndex(4))
    assert got == _index_ops(jpk.PrefixIndex(4))
    assert got[:2] == [[5, 6], [5, 6]] and got[8] == []


def test_prefix_index_random_ops_match_jax(rng):
    """A random interleaving of inserts (shared and forked prefixes),
    matches and evictions: every result equal to JAX's."""
    mine, ref_ = paged_kv.PrefixIndex(4), jpk.PrefixIndex(4)
    base = list(map(int, rng.integers(0, 5, 24)))
    next_block = 1
    for step in range(200):
        op = rng.integers(0, 3)
        cut = int(rng.integers(0, 24))
        toks = base[:cut] + list(map(int, rng.integers(0, 5, 8)))
        if op == 0:
            blocks = list(range(next_block, next_block + 8))
            next_block += 8
            assert mine.insert(toks, blocks) == ref_.insert(toks, blocks)
        elif op == 1:
            assert mine.match(toks) == ref_.match(toks)
        else:
            b = int(rng.integers(1, next_block))
            mine.evict_block(b)
            ref_.evict_block(b)
        assert len(mine) == len(ref_), step


# -- 2. cache on == cache off == JAX -------------------------------------


@pytest.mark.parametrize("arch", ["olmo_1b", "yi_6b", "gemma_7b"])
def test_prefix_cache_on_equals_off_equals_jax(rng, arch):
    jm, jparams, tm, tparams = _pair(arch)
    prompts = _shared_work(rng, tm.cfg.vocab_size)
    want, jst = _jax_run(jm, jparams, prompts, 5)
    off = _eng(tm, tparams, prefix_cache=False)
    assert off.generate(prompts, SamplingParams(max_tokens=5)) == want
    on = _eng(tm, tparams, prefix_cache=True)
    assert on.generate(prompts, SamplingParams(max_tokens=5)) == want
    st = on.stats()
    assert st["prefix_cache"]["enabled"] and st["prefix_cache"]["hits"] > 0
    assert not off.stats()["prefix_cache"]["enabled"]
    _same_counters(st, jst)
    _assert_clean(on.backend)


def test_prefix_cache_default_on():
    assert EngineConfig().prefix_cache is True


def test_prefix_cache_seeded_on_equals_off(rng, olmo):
    """Seeded sampling: the full-hit path samples a request's first token
    from the admission step's decode instead of the prefill logits, at
    the same stream position from the same logits row."""
    _, _, tm, tparams = olmo
    prompts = _shared_work(rng, tm.cfg.vocab_size)
    sps = [SamplingParams(max_tokens=5, temperature=0.8, top_k=20,
                          seed=100 + i) for i in range(len(prompts))]
    off = _eng(tm, tparams, prefix_cache=False).generate(prompts, sps)
    on = _eng(tm, tparams, prefix_cache=True)
    assert on.generate(prompts, sps) == off
    assert on.stats()["prefix_cache"]["hits"] > 0
    _assert_clean(on.backend)


# -- 3. hits, COW, suffix prefill, pressure ------------------------------


def test_prefix_cache_full_hit_cow(rng, olmo):
    """An identical prompt re-submitted is a FULL hit: no prefill call,
    and the first decode copies the shared tail block once."""
    _, _, tm, tparams = olmo
    prompt = list(map(int, rng.integers(0, tm.cfg.vocab_size, 12)))
    sp = SamplingParams(max_tokens=4)
    eng = _eng(tm, tparams, prefix_cache=True, num_slots=1)
    want = _eng(tm, tparams, prefix_cache=False,
                num_slots=1).generate([prompt], sp)[0]
    assert eng.generate([prompt], sp) == [want]
    calls0 = eng.stats()["prefill_calls"]
    assert eng.generate([prompt], sp) == [want]
    st = eng.stats()
    pc = st["prefix_cache"]
    assert st["prefill_calls"] == calls0
    assert pc["hit_tokens"] >= 12 and pc["cow_copies"] >= 1
    _assert_clean(eng.backend)


def test_partial_hits_prefill_only_the_suffix(rng, olmo):
    """A block-aligned shared prefix leaves only the unique suffix to
    prefill, through the verify pass (K3 on the card); tokens and
    counters equal JAX's on the same run."""
    jm, jparams, tm, tparams = olmo
    prompts = _shared_work(rng, tm.cfg.vocab_size, n=6, shared=16, unique=3)
    want, jst = _jax_run(jm, jparams, prompts, 3)
    off = _eng(tm, tparams, prefix_cache=False)
    assert off.generate(prompts, SamplingParams(max_tokens=3)) == want
    on = _eng(tm, tparams, prefix_cache=True)
    assert on.generate(prompts, SamplingParams(max_tokens=3)) == want
    st = on.stats()
    # the first TWO prompts co-admit before anything is indexed
    assert st["prefix_cache"]["hits"] >= 4
    assert st["prefix_cache"]["suffix_shapes"] >= 1
    assert st["prefill_tokens"] <= off.stats()["prefill_tokens"] - 4 * 16
    _same_counters(st, jst)
    _assert_clean(on.backend)


def test_prefix_cache_under_preemption(rng, olmo):
    """A pool tight enough to preempt mid-run: preempted victims re-hit
    their own just-freed blocks; tokens and counters equal JAX's."""
    jm, jparams, tm, tparams = olmo
    prompts = _shared_work(rng, tm.cfg.vocab_size, n=5, shared=8, unique=3)
    geo = dict(num_slots=3, num_blocks=11, max_len=32)
    want, jst = _jax_run(jm, jparams, prompts, 8, **geo)
    on = _eng(tm, tparams, prefix_cache=True, **geo)
    assert on.generate(prompts, SamplingParams(max_tokens=8)) == want
    st = on.stats()
    assert st["preemptions"] > 0
    _same_counters(st, jst)
    _assert_clean(on.backend)


@pytest.mark.parametrize("temp", [0.0, 0.9])
def test_prefix_cache_with_spec_decode(rng, olmo, temp):
    """Speculative decoding over shared prefixes: verify windows start
    inside a shared tail block (COW before the pass) and rejection at a
    shared-block boundary rolls back without touching shared blocks.
    Tokens equal the non-speculative cache-off engine (and, greedy, the
    JAX engine with its counters)."""
    jm, jparams, tm, tparams = olmo
    base = [7, 3, 9, 5] * 3
    prompts = [base + [11 + i] for i in range(4)]
    sps = [SamplingParams(max_tokens=6, temperature=temp, seed=i)
           for i in range(4)]
    off = _eng(tm, tparams, prefix_cache=False).generate(prompts, sps)
    on = _eng(tm, tparams, prefix_cache=True, spec_tokens=3)
    assert on.generate(prompts, sps) == off
    st = on.stats()
    assert st["prefix_cache"]["hits"] > 0
    if temp == 0.0:
        want, jst = _jax_run(jm, jparams, prompts, 6, spec_tokens=3)
        assert off == want
        _same_counters(st, jst)
    _assert_clean(on.backend)


def test_prefix_cache_survives_eviction_pressure(rng, olmo):
    """More distinct prompts than the pool can cache: LRU reclaim fires,
    matches stay exact, tokens and counters equal JAX's."""
    jm, jparams, tm, tparams = olmo
    prompts = [list(map(int, rng.integers(0, tm.cfg.vocab_size, 12)))
               for _ in range(8)]
    geo = dict(num_blocks=13, max_len=24)
    want, jst = _jax_run(jm, jparams, prompts, 4, **geo)
    on = _eng(tm, tparams, prefix_cache=True, **geo)
    assert on.generate(prompts, SamplingParams(max_tokens=4)) == want
    st = on.stats()
    assert st["prefix_cache"]["evictions"] > 0
    _same_counters(st, jst)
    _assert_clean(on.backend)


def test_preempt_only_step_reports_no_progress(rng, olmo):
    """``_preempt`` does not set made_progress: a step that only evicts
    and re-queues emits nothing."""
    _, _, tm, tparams = olmo
    eng = _eng(tm, tparams, prefix_cache=True)
    eng.add_request(list(map(int, rng.integers(0, tm.cfg.vocab_size, 6))),
                    SamplingParams(max_tokens=4))
    be = eng.backend
    be.step()
    assert be.num_active == 1
    be.made_progress = False
    be._preempt(next(i for i, s in enumerate(be.slots) if s.req is not None))
    assert not be.made_progress
    eng.drain()
    _assert_clean(be)
