"""The port's fused decode step and ``EngineConfig(overlap=True)`` against
the JAX package on the CPU.

  1. ``fused_sample`` equals JAX's bit for bit, greedy (``samp`` None,
     first-occurrence ties) and seeded;
  2. overlap on equals overlap off token for token with zero leaks, and
     equals the JAX ``Engine(overlap=True)``, on olmo_1b and
     recurrentgemma_2b smoke: JAX's trace of
     ``tests/test_open_loop.py::test_overlap_identity_across_archs``
     (prompts of 5, 9, 3, 12, 7, 6 tokens arriving two a step,
     alternating greedy and seeded, 2 slots and 16 usable blocks; then
     7, so that it preempts);
  3. a shared-prefix trace with the prefix cache on, so a fresh full hit
     takes its COW copy inside a follow-up dispatch; int8 and fp8 pools;
     ``flush_overlap`` between steps, against JAX's; the speculative
     backend builds no decode step;
  4. telemetry: ``device_s`` within the wall time, ``stats()["overlap"]``;
     the config check raises JAX's ValueError;
  5. ``decode_step_paged`` and a whole engine run keep every pool leaf the
     same tensor at the same ``data_ptr()``: the precondition of the
     captured step on the card.

Weights are JAX's init carried over with the weight bridge; prompts come
from numpy with a seed. Tokens are compared exactly.
"""

import collections
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.engine import Engine as JEngine
from repro.launch.engine import EngineConfig as JEngineConfig
from repro.launch.engine import SamplingParams as JSamplingParams
from repro.launch.engine import sampling as jsampling
from repro.models.model import Model as JModel
from repro_torch.configs import get_config
from repro_torch.launch.engine import Engine, EngineConfig, SamplingParams
from repro_torch.launch.engine import sampling
from repro_torch.models import paged_kv, transformer, weights
from repro_torch.models.model import Model

torch.set_num_threads(1)

GEO = dict(num_slots=2, block_size=4, num_blocks=17, max_len=32)


@pytest.fixture(scope="module")
def pairs():
    """(JAX model, JAX params, port model, port params) per arch, built
    once for the module."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jm = JModel(jax_config(arch).smoke())
            jparams = jm.init(jax.random.PRNGKey(0))
            tcfg = get_config(arch).smoke()
            tparams = weights.from_jax_numpy(
                jax.tree.map(np.asarray, jparams), tcfg, "cpu")
            cache[arch] = (jm, jparams, Model(tcfg, device="cpu"), tparams)
        return cache[arch]

    return get


# -- 1. the sampling tail --------------------------------------------------


def test_fused_sample_greedy_matches_jax(rng):
    """``samp`` None: argmax with ties broken at the first occurrence, as
    JAX's and as the host fast path."""
    logits = np.round(rng.normal(size=(6, 64)), 0).astype(np.float32)
    steps = np.zeros(6, np.int32)
    want = np.asarray(jsampling.fused_sample(jnp.asarray(logits),
                                             jnp.asarray(steps), None))
    got = sampling.fused_sample(torch.from_numpy(logits),
                                torch.from_numpy(steps), None)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    host = sampling.SlotSampler(6).sample(torch.from_numpy(logits))
    assert np.array_equal(host, want)


def test_fused_sample_seeded_matches_jax(rng):
    """Per-slot seeds, stream steps, temperatures, top-k and top-p, with
    a greedy row among them."""
    B, V = 6, 256
    logits = (rng.normal(size=(B, V)) * 2).astype(np.float32)
    steps = rng.integers(0, 500, B).astype(np.int32)
    samp = (rng.integers(0, 2**31 - 1, B).astype(np.int32),
            np.array([0.0, 0.7, 1.0, 1.3, 0.9, 2.0], np.float32),
            np.array([0, 9, 0, 50, 3, 0], np.int32),
            np.array([1.0, 0.95, 0.9, 0.5, 1.0, 0.95], np.float32))
    want = np.asarray(jsampling.fused_sample(
        jnp.asarray(logits), jnp.asarray(steps),
        tuple(map(jnp.asarray, samp))))
    got = sampling.fused_sample(torch.from_numpy(logits),
                                torch.from_numpy(steps),
                                tuple(map(torch.from_numpy, samp)))
    assert np.array_equal(got.numpy(), want)


def test_fused_args_pick_the_variant():
    s = sampling.SlotSampler(3)
    steps = np.array([4, 5, 6], np.int32)
    assert s.fused_args(steps) == (steps, None)
    s.install(1, SamplingParams(temperature=0.7, top_k=9, seed=3), 2)
    got_steps, samp = s.fused_args(steps)
    assert got_steps is steps
    assert [a.tolist() for a in samp] == [
        [0, 3, 0], [0.0, np.float32(0.7), 0.0], [0, 9, 0], [1.0, 1.0, 1.0]]


# -- 2. overlap identity ---------------------------------------------------


def _drive_steps(eng, work, max_steps=20_000):
    """Step-clocked arrivals (JAX's ``_drive_steps``): request i is
    submitted when the step counter reaches its arrival step."""
    pending = collections.deque(work)
    handles = []
    step = 0
    while pending or eng.has_work:
        while pending and pending[0][0] <= step:
            _, prompt, sp = pending.popleft()
            handles.append(eng.add_request(prompt, sp))
        if eng.has_work:
            eng.step()
        step += 1
        assert step < max_steps, "trace stalled"
    return handles


def _assert_clean(eng, handles, work):
    be = eng.backend
    assert eng.stats()["blocks_used"] == 0
    assert be.alloc.free_count == be.layout.usable_blocks
    assert np.all(be.lengths == 0)
    for h, (_, _, sp) in zip(handles, work):
        assert h.finished and len(h.token_ids) <= sp.max_tokens


def _run(model, params, work, spy=None, **kw):
    eng = Engine(model, params, EngineConfig(**{**GEO, **kw}), device="cpu")
    if spy is not None:
        spy(eng.backend)
    handles = _drive_steps(eng, work)
    _assert_clean(eng, handles, work)
    return [h.token_ids for h in handles], eng.stats()


def _jax_run(jm, jparams, work, **kw):
    jwork = [(t, p, JSamplingParams(**dataclasses.asdict(sp)))
             for t, p, sp in work]
    eng = JEngine(jm, jparams, JEngineConfig(backend="paged",
                                             **{**GEO, **kw}))
    handles = _drive_steps(eng, jwork)
    return [h.token_ids for h in handles], eng.stats()


def _arch_trace(rng, vocab):
    """JAX's overlap-identity trace (test_open_loop.py:312-326)."""
    work = []
    for i, plen in enumerate((5, 9, 3, 12, 7, 6)):
        prompt = list(map(int, rng.integers(0, vocab, plen)))
        sp = SamplingParams(max_tokens=6 + i % 4) if i % 2 == 0 else \
            SamplingParams(max_tokens=6 + i % 4, temperature=0.7,
                           top_k=9, top_p=0.95, seed=100 + i)
        work.append((i // 2, prompt, sp))
    return work


@pytest.mark.parametrize("num_blocks", [17, 8])
@pytest.mark.parametrize("arch", ["olmo_1b", "recurrentgemma_2b"])
def test_overlap_matches_off_and_jax_overlap(rng, pairs, arch, num_blocks):
    """Overlap on == off token for token, both leak-free, with the same
    scheduler counters; and both equal the JAX ``Engine(overlap=True)``
    on the same trace. JAX's 16 usable blocks hold this trace whole; 7
    make it preempt."""
    jm, jparams, tm, tparams = pairs(arch)
    work = _arch_trace(rng, tm.cfg.vocab_size)
    off, st_off = _run(tm, tparams, work, overlap=False,
                       num_blocks=num_blocks)
    on, st_on = _run(tm, tparams, work, overlap=True, num_blocks=num_blocks)
    want, jst = _jax_run(jm, jparams, work, overlap=True,
                         num_blocks=num_blocks)
    assert on == off == want
    assert st_on["overlap"] is True and st_off["overlap"] is False
    for k in ("preemptions", "prefill_calls", "prefill_tokens"):
        assert st_on[k] == st_off[k] == jst[k], k
    assert st_on["steps"] == jst["steps"]
    assert (st_on["preemptions"] > 0) == (num_blocks == 8)
    assert st_on["eager_decode_steps"] == st_on["steps"]
    assert st_on["graph_replays"] == 0


def test_overlap_cow_in_followup_matches_jax(rng, pairs):
    """Prompts sharing a block-aligned 12-token prefix, a full-hit twin
    arriving while the others decode, the prefix cache on: the twin's
    first write lands in its shared tail block, and its COW copy is made
    inside a follow-up dispatch. Tokens and prefix-cache counters equal
    overlap off and the JAX overlap engine's."""
    jm, jparams, tm, tparams = pairs("olmo_1b")
    vocab = tm.cfg.vocab_size
    common = list(map(int, rng.integers(0, vocab, 12)))
    prompts = [common + list(map(int, rng.integers(0, vocab, 4)))
               for _ in range(3)]
    work = [(0, prompts[0], SamplingParams(max_tokens=8)),
            (0, prompts[1], SamplingParams(max_tokens=9, temperature=0.8,
                                           top_k=20, seed=7)),
            (3, list(prompts[0]), SamplingParams(max_tokens=7)),
            (4, prompts[2], SamplingParams(max_tokens=6))]
    geo = dict(num_slots=3, num_blocks=40, max_len=48)
    where = []

    def spy(be):                 # records which path made each COW copy
        followup, cow = be._try_followup, be._cow_block
        inside = []

        def try_followup(pend):
            inside.append(True)
            try:
                return followup(pend)
            finally:
                inside.pop()

        def cow_block(i, idx):
            where.append(bool(inside))
            return cow(i, idx)

        be._try_followup, be._cow_block = try_followup, cow_block

    off, st_off = _run(tm, tparams, work, overlap=False, **geo)
    on, st_on = _run(tm, tparams, work, spy=spy, overlap=True, **geo)
    want, jst = _jax_run(jm, jparams, work, overlap=True, **geo)
    assert on == off == want
    assert st_on["prefix_cache"]["cow_copies"] >= 1 and any(where)
    for k in ("hits", "cow_copies", "hit_tokens", "lookups"):
        assert st_on["prefix_cache"][k] == st_off["prefix_cache"][k] \
            == jst["prefix_cache"][k], k


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_overlap_quantized_pool_matches_off(rng, pairs, kv_dtype):
    """int8 / fp8 pools: overlap on == off on the preempting trace."""
    _, _, tm, tparams = pairs("olmo_1b")
    work = _arch_trace(rng, tm.cfg.vocab_size)
    geo = dict(kv_dtype=kv_dtype, num_blocks=8)
    off, _ = _run(tm, tparams, work, overlap=False, **geo)
    on, st = _run(tm, tparams, work, overlap=True, **geo)
    assert on == off
    assert st["kv_dtype"] == kv_dtype and st["preemptions"] > 0


def _drive_flushing(eng, work, every=3):
    """``_drive_steps`` with ``backend.flush_overlap()`` before every
    ``every``-th step; returns the handles and each step's output count."""
    pending = collections.deque(work)
    handles, per_step = [], []
    step = 0
    while pending or eng.has_work:
        while pending and pending[0][0] <= step:
            _, prompt, sp = pending.popleft()
            handles.append(eng.add_request(prompt, sp))
        if step % every == every - 1:
            eng.backend.flush_overlap()
        if eng.has_work:
            per_step.append(len(eng.step()))
        step += 1
        assert step < 20_000, "trace stalled"
    return handles, per_step


def test_flush_overlap_matches_off_and_jax(rng, pairs):
    """``flush_overlap`` harvests the in-flight decode between steps and
    buffers its outputs for the next ``step()`` (``has_work`` stays True
    while it holds any): tokens equal overlap off, and the outputs each
    step streams equal the JAX engine's under the same flushes, on the
    preempting trace."""
    jm, jparams, tm, tparams = pairs("olmo_1b")
    work = _arch_trace(rng, tm.cfg.vocab_size)
    off, _ = _run(tm, tparams, work, overlap=False, num_blocks=8)
    eng = Engine(tm, tparams, EngineConfig(**{**GEO, "num_blocks": 8,
                                              "overlap": True}),
                 device="cpu")
    handles, per_step = _drive_flushing(eng, work)
    _assert_clean(eng, handles, work)
    jwork = [(t, p, JSamplingParams(**dataclasses.asdict(sp)))
             for t, p, sp in work]
    jeng = JEngine(jm, jparams, JEngineConfig(backend="paged", overlap=True,
                                              **{**GEO, "num_blocks": 8}))
    jhandles, jper_step = _drive_flushing(jeng, jwork)
    assert [h.token_ids for h in handles] == off \
        == [h.token_ids for h in jhandles]
    assert per_step == jper_step
    assert sum(per_step) == sum(map(len, off))


def test_spec_backend_captures_no_decode_step(pairs):
    """The speculative backend decodes by its own eager verify step, so
    it builds no ``DecodeStep``; the paged backend builds one."""
    _, _, tm, tparams = pairs("olmo_1b")
    spec = Engine(tm, tparams, EngineConfig(**GEO, spec_tokens=2),
                  device="cpu")
    paged = Engine(tm, tparams, EngineConfig(**GEO), device="cpu")
    assert spec.backend.decode is None
    assert paged.backend.decode is not None


# -- 4. telemetry and config ---------------------------------------------


def test_device_clock_is_a_union_under_overlap(rng, pairs):
    """``device_s`` is the union of dispatch-to-fetch intervals: with
    overlap on it stays within the run's wall time."""
    _, _, tm, tparams = pairs("olmo_1b")
    eng = Engine(tm, tparams, EngineConfig(**{**GEO, "num_blocks": 33,
                                              "overlap": True}),
                 device="cpu")
    prompts = [list(map(int, rng.integers(0, tm.cfg.vocab_size, n)))
               for n in (5, 8, 6)]
    eng.generate(prompts, SamplingParams(max_tokens=8))
    eng.backend.reset_telemetry()
    t0 = time.monotonic()
    eng.generate(prompts, SamplingParams(max_tokens=8))
    wall = time.monotonic() - t0
    st = eng.stats()
    assert st["overlap"] is True
    assert 0.0 < st["device_s"] <= wall
    assert st["latency"]["tpot"]["count"] == len(prompts)


@pytest.mark.parametrize("kw", [dict(backend="static", overlap=True),
                                dict(overlap=True, spec_tokens=2)])
def test_overlap_config_errors_match_jax(pairs, kw):
    """Overlap is paged-only and refuses speculation, with JAX's
    ValueError and JAX's message."""
    jm, jparams, tm, tparams = pairs("olmo_1b")
    with pytest.raises(ValueError) as want:
        JEngine(jm, jparams, JEngineConfig(**GEO, **kw))
    with pytest.raises(ValueError) as got:
        Engine(tm, tparams, EngineConfig(**GEO, **kw), device="cpu")
    assert str(got.value) == str(want.value)


# -- 5. the pools stay where they are ------------------------------------


def _ptrs(tree):
    return [(id(t), t.data_ptr()) for t in _leaves(tree)]


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("arch,kv_dtype", [
    ("olmo_1b", "bf16"), ("recurrentgemma_2b", "bf16"),
    ("h2o_danube_3_4b", "bf16"), ("olmo_1b", "int8"),
    ("xlstm_1_3b", "bf16"), ("qwen3_moe_30b_a3b", "fp8")])
def test_pools_keep_their_storage(rng, arch, kv_dtype):
    """``decode_step_paged`` writes every leaf in place, and so does a
    whole engine run (prefill packs, COW copies, preemption): each leaf
    stays the same tensor at the same ``data_ptr()``, which the captured
    step on the card requires."""
    cfg = get_config(arch).smoke()
    model = Model(cfg, device="cpu")
    params = model.init(seed=0)
    layout = paged_kv.PagedLayout(num_slots=2, num_blocks=9, block_size=4,
                                  max_len=32)
    spec = None if kv_dtype == "bf16" else paged_kv.make_pool_spec(
        cfg, layout, kv_dtype=kv_dtype)
    pools = model.init_paged_cache(layout, spec=spec)
    before = _ptrs(pools)
    table = torch.tensor([[1, 2] + [0] * 6, [3, 0] + [0] * 6],
                         dtype=torch.int32)
    _, out = model.decode_step_paged(
        params, pools, table, torch.tensor([5, 2], dtype=torch.int32),
        torch.tensor([[7], [9]], dtype=torch.int32),
        transformer.RunCtx(kv_spec=spec))
    assert out is pools and _ptrs(out) == before

    eng = Engine(model, params, EngineConfig(**{**GEO, "kv_dtype": kv_dtype,
                                                "overlap": True}),
                 device="cpu")
    before = _ptrs(eng.backend.pools)
    work = _arch_trace(rng, cfg.vocab_size)
    work.append((5, list(work[0][1]), SamplingParams(max_tokens=4)))
    _drive_steps(eng, work)
    assert _ptrs(eng.backend.pools) == before
