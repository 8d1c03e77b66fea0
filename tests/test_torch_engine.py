"""The port's serving engine (repro_torch.launch.engine) on the CPU:
greedy outputs token-identical to the JAX Engine on the same weights,
and the scheduler invariants of tests/test_paged_serve.py mirrored
(block leaks, slot reuse, admission-order independence, preemption,
EOS, oversized requests, the allocator, batched prefill).

Weights are the JAX package's init carried over with the weight bridge;
prompts are made by numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.engine import Engine as JEngine
from repro.launch.engine import EngineConfig as JEngineConfig
from repro.launch.engine import SamplingParams as JSamplingParams
from repro.models.model import Model as JModel
from repro.models.transformer import RunCtx as JRunCtx
from repro_torch.configs import get_config
from repro_torch.launch.engine import Engine, EngineConfig, SamplingParams
from repro_torch.launch.engine.sampling import sample_tokens
from repro_torch.models import paged_kv, weights
from repro_torch.models.model import Model

torch.set_num_threads(1)

JCTX = JRunCtx(kernel_mode="ref")


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


def _engine(model, params, **kw):
    base = dict(num_slots=2, block_size=4, num_blocks=17, max_len=32)
    base.update(kw)
    return Engine(model, params, EngineConfig(**base), device="cpu")


def _jax_greedy(jm, jparams, prompt, n_new, max_len=64):
    """The JAX package's unbatched reference: exact prefill + dense
    decode loop (tests/test_paged_serve.py::_oracle_greedy)."""
    logits, cache = jm.prefill(
        jparams, {"tokens": jnp.asarray([prompt], jnp.int32)}, JCTX,
        max_len=max_len)
    out = [int(jnp.argmax(logits[0, len(prompt) - 1]))]
    while len(out) < n_new:
        lg, cache = jm.decode_step(
            jparams, cache, jnp.asarray([[out[-1]]], jnp.int32),
            jnp.int32(len(prompt) + len(out) - 1), JCTX)
        out.append(int(jnp.argmax(lg[0])))
    return out


def _prompts(rng, vocab, lens):
    return [list(map(int, rng.integers(0, vocab, L))) for L in lens]


@pytest.mark.parametrize("arch", ["olmo_1b", "yi_6b", "gemma_7b"])
def test_engine_matches_jax_engine_greedy(rng, arch):
    """Ragged prompts (3, 7, 12) through both engines, same geometry and
    weights: token-identical greedy outputs, zero block leaks."""
    jm, jparams, tm, tparams = _pair(arch)
    prompts = _prompts(rng, tm.cfg.vocab_size, (3, 7, 12))
    geo = dict(num_slots=2, block_size=4, num_blocks=17, max_len=32)
    want = JEngine(jm, jparams, JEngineConfig(backend="paged", **geo)) \
        .generate(prompts, JSamplingParams(max_tokens=6))
    eng = _engine(tm, tparams, **geo)
    got = eng.generate(prompts, SamplingParams(max_tokens=6))
    assert got == want
    st = eng.stats()
    assert st["blocks_used"] == 0 and st["bucketed_prefill"]
    assert eng.backend.alloc.free_count == eng.backend.layout.usable_blocks


def test_engine_no_block_leak_and_slot_reuse(rng, olmo):
    _, _, tm, tparams = olmo
    work = [(_prompts(rng, 256, [int(rng.integers(2, 12))])[0],
             int(rng.integers(1, 10))) for _ in range(9)]
    eng = _engine(tm, tparams, num_slots=3, num_blocks=33)
    handles = [eng.add_request(p, SamplingParams(max_tokens=n))
               for p, n in work]
    eng.drain()
    be = eng.backend
    assert len(be.finished) == 9                 # slots were reused
    assert be.alloc.used_count == 0
    assert be.alloc.free_count == be.layout.usable_blocks
    assert np.all(be.table == paged_kv.NULL_BLOCK)
    assert np.all(be.lengths == 0)
    for h, (p, n) in zip(handles, work):
        assert h.finished and len(h.token_ids) == n


def test_engine_outputs_independent_of_admission_order(rng, olmo):
    """Seeded sampling (temperature 0.8, top-k/top-p) is a pure function
    of (params, prompt, seed): shuffling submission order and changing
    the slot count changes no request's tokens."""
    _, _, tm, tparams = olmo
    work = [(_prompts(rng, 256, [int(rng.integers(2, 10))])[0],
             SamplingParams(max_tokens=int(rng.integers(2, 8)),
                            temperature=0.8, top_k=20, top_p=0.9, seed=i))
            for i in range(6)]

    def run(order, slots):
        eng = _engine(tm, tparams, num_slots=slots, num_blocks=33)
        hs = [eng.add_request(work[i][0], work[i][1]) for i in order]
        eng.drain()
        return {order[j]: h.token_ids for j, h in enumerate(hs)}

    a = run(list(range(6)), 2)
    b = run([3, 0, 5, 1, 4, 2], 4)
    assert a == b
    greedy = run(list(range(6)), 2)              # same again: deterministic
    assert greedy == a


def test_optimistic_admission_with_preemption(rng, olmo):
    """Three requests whose worst cases cannot be co-resident: all three
    are admitted, the pool runs dry, LIFO preemption recomputes, and the
    outputs equal the uncontended run and the JAX reference, with zero
    leaks."""
    jm, jparams, tm, tparams = olmo
    prompts = _prompts(rng, 256, (8, 8, 8))
    n_new, bs, num_blocks = 16, 4, 14             # 13 usable blocks
    assert 3 * paged_kv.blocks_for(8 + n_new, bs) > num_blocks - 1
    ref = _engine(tm, tparams, num_slots=3, num_blocks=65, max_len=64)
    want = ref.generate(prompts, SamplingParams(max_tokens=n_new))
    assert ref.stats()["preemptions"] == 0
    eng = _engine(tm, tparams, num_slots=3, num_blocks=num_blocks,
                  max_len=64)
    handles = [eng.add_request(p, SamplingParams(max_tokens=n_new))
               for p in prompts]
    max_active = 0
    while eng.has_work:
        eng.step()
        max_active = max(max_active, eng.backend.num_active)
    st = eng.stats()
    assert max_active == 3
    assert st["preemptions"] >= 1
    assert [h.token_ids for h in handles] == want
    assert want[0] == _jax_greedy(jm, jparams, prompts[0], n_new)
    assert st["blocks_used"] == 0
    assert np.all(eng.backend.table == paged_kv.NULL_BLOCK)


def test_batched_prefill_admission_one_call(rng, olmo):
    """A same-bucket burst into an idle engine prefills as ONE batched
    call, and each row matches the JAX unbatched reference."""
    jm, jparams, tm, tparams = olmo
    prompts = _prompts(rng, 256, (5, 8, 6, 7))   # all bucket 8 (block 4)
    want = [_jax_greedy(jm, jparams, p, 4) for p in prompts]
    eng = _engine(tm, tparams, num_slots=4, num_blocks=33)
    got = eng.generate(prompts, SamplingParams(max_tokens=4))
    st = eng.stats()
    assert got == want
    assert st["prefill_calls"] == 1 and st["prefill_reqs"] == 4
    assert st["blocks_used"] == 0


def test_engine_eos_retirement(rng, olmo):
    """EOS is stripped, never emitted, and retirement frees the slot."""
    jm, jparams, tm, tparams = olmo
    prompt = _prompts(rng, 256, (7,))[0]
    eos = _jax_greedy(jm, jparams, prompt, 1)[0]
    eng = _engine(tm, tparams, num_slots=1, eos_id=eos)
    r1 = eng.add_request(list(prompt), SamplingParams(max_tokens=20))
    r2 = eng.add_request(_prompts(rng, 256, (5,))[0],
                         SamplingParams(max_tokens=3))
    eng.drain()
    assert r1.finished and r1.token_ids == [] and r1.finish_reason == "stop"
    assert r2.finished and len(r2.token_ids) <= 3 and eos not in r2.token_ids
    assert eng.backend.alloc.used_count == 0


def test_engine_rejects_bad_requests(rng, olmo):
    """Worst case past the pool, past max_len, or an empty prompt is a
    ValueError at add_request, not a mid-flight failure."""
    _, _, tm, tparams = olmo
    eng = _engine(tm, tparams, num_slots=1, num_blocks=5, max_len=256)
    with pytest.raises(ValueError, match="pool"):
        eng.add_request(_prompts(rng, 256, (10,))[0],
                        SamplingParams(max_tokens=20))
    with pytest.raises(ValueError, match="max_len"):
        eng.add_request([1] * 250, SamplingParams(max_tokens=10))
    with pytest.raises(ValueError, match="empty"):
        eng.add_request([], SamplingParams(max_tokens=1))


def test_allocator_double_free_detected():
    layout = paged_kv.PagedLayout(num_slots=1, num_blocks=4, block_size=4,
                                  max_len=8)
    alloc = paged_kv.BlockAllocator(layout)
    ids = alloc.alloc(2)
    alloc.free(ids)
    with pytest.raises(ValueError):
        alloc.free([ids[0]])
    with pytest.raises(ValueError):
        alloc.free([paged_kv.NULL_BLOCK])
    with pytest.raises(MemoryError):
        alloc.alloc(4)


def test_allocator_watermark_and_victim_selection():
    layout = paged_kv.PagedLayout(num_slots=2, num_blocks=8, block_size=4,
                                  max_len=16)
    alloc = paged_kv.BlockAllocator(layout, watermark=2)   # 7 usable
    assert alloc.can_admit(5, strict=True)
    assert not alloc.can_admit(6, strict=True)
    assert alloc.can_admit(7, strict=False)
    assert paged_kv.BlockAllocator.select_victim(
        [(0, 5), (2, 9), (1, 7)]) == 2
    with pytest.raises(ValueError):
        paged_kv.BlockAllocator.select_victim([])


def test_allocator_refcounts_and_lru():
    """The refcount / cached-LRU states: a shared block is released by
    its last reference, a registered block parks in the LRU and is
    reclaimed (with the eviction callback) only after the free list."""
    layout = paged_kv.PagedLayout(num_slots=1, num_blocks=4, block_size=4,
                                  max_len=8)
    evicted = []
    alloc = paged_kv.BlockAllocator(layout, on_evict=evicted.append)
    a, b = alloc.alloc(2)
    alloc.share(a)
    assert alloc.refcount(a) == 2 and alloc.must_cow(a)
    alloc.register(b)
    alloc.free([a, b])
    assert alloc.refcount(a) == 1 and alloc.lru_count == 1
    alloc.share(b)                                 # revive from the LRU
    alloc.free([b])
    assert alloc.alloc(1) == [3] and not evicted   # free list first
    assert alloc.alloc(1) == [b] and evicted == [b]
    with pytest.raises(ValueError):
        alloc.share(99)


def test_sample_tokens_masks_and_greedy():
    """Greedy rows are argmax; top_k=1 or a tiny top_p leave only the
    argmax; top-k draws stay inside the k highest logits; a draw is a
    pure function of (seed, step)."""
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn((4, 50), generator=gen) * 3
    top = logits.argmax(-1).int()
    z = torch.zeros(4, dtype=torch.int32)

    def draw(temps, top_ks, top_ps, seeds=z, steps=z):
        return sample_tokens(logits, seeds, steps, torch.tensor(temps),
                             torch.tensor(top_ks, dtype=torch.int32),
                             torch.tensor(top_ps))

    assert torch.equal(draw([0.0] * 4, [0] * 4, [1.0] * 4), top)
    assert torch.equal(draw([1.0] * 4, [1] * 4, [1.0] * 4), top)
    assert torch.equal(draw([1.0] * 4, [0] * 4, [1e-6] * 4), top)
    top3 = logits.topk(3, -1).indices
    for s in range(20):
        seeds = torch.full((4,), s, dtype=torch.int32)
        got = draw([2.0] * 4, [3] * 4, [1.0] * 4, seeds=seeds)
        assert all(int(got[b]) in top3[b].tolist() for b in range(4))
        again = draw([2.0] * 4, [3] * 4, [1.0] * 4, seeds=seeds)
        assert torch.equal(got, again)
