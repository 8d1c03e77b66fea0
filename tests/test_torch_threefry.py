"""The port's seeded sampler against jax 0.9.0 on the CPU.

``repro_torch.launch.engine.sampling`` draws token t of a request from
``fold_in(PRNGKey(seed), t)`` with JAX's own threefry2x32 stream, written
in torch integer ops. Each step is held against the installed jax:

  1. the key, ``fold_in`` and the random bits (partitionable path): bit
     for bit, up to a vocabulary of 50304 and batched keys;
  2. the uniforms on [tiny, 1): bit for bit;
  3. the Gumbel values ``-log(-log(u))``: XLA's f32 ``log`` and torch's
     differ by at most one ulp, so each log is held to 1 ulp and the
     Gumbel value to 2 ulp at ``max(|g|, 1)`` (near g = 0 the value is
     the log of a number near 1, where one ulp of the inner log is an
     absolute 2**-24);
  4. draws: ``categorical``, ``sample_tokens`` over temperatures, top-k
     and top-p, and the seeded ``verify_accept`` give JAX's tokens;
  5. seeded olmo-smoke engines, plain and speculative, give the JAX
     engine's tokens.

Inputs are made by numpy from a seed. Note that the repo's conftest turns
on 64-bit types in JAX, so every JAX draw here names float32.
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
from repro.launch.engine import sampling as jsampling
from repro.models.model import Model as JModel
from repro_torch.configs import get_config
from repro_torch.launch.engine import Engine, EngineConfig, SamplingParams
from repro_torch.launch.engine import sampling
from repro_torch.models import weights
from repro_torch.models.model import Model

torch.set_num_threads(1)

SEEDS = [0, 1, 7, 12345, 2**31 - 1]
STEPS = [0, 1, 9, 4096]
VOCAB = 50304
TINY = float(np.finfo(np.float32).tiny)


def _jkey(seed, step):
    return jax.random.fold_in(jax.random.PRNGKey(seed), step)


def _tkey(seed, step):
    return sampling.fold_in(sampling.prng_key(seed), step)


def _words(jkey):
    return np.asarray(jax.random.key_data(jkey)).astype(np.int64)


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


# -- 1. key, fold_in, bits ------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    assert np.array_equal(sampling.prng_key(seed).numpy(),
                          _words(jax.random.PRNGKey(seed)))
    seeds = np.array([seed, -3, 5], np.int32)     # an int32 seed array
    want = np.stack([_words(jax.random.PRNGKey(jnp.int32(s)))
                     for s in seeds])
    assert np.array_equal(
        sampling.prng_key(torch.from_numpy(seeds)).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("step", STEPS)
def test_fold_in_matches_jax(seed, step):
    assert np.array_equal(_tkey(seed, step).numpy(),
                          _words(_jkey(seed, step)))


def test_fold_in_batched_matches_jax():
    """One key per row, each folded with its own step (the sampler's
    call): equal to folding each row alone."""
    seeds = torch.tensor(SEEDS)
    steps = torch.tensor([3, 0, 17, 2, 4096])
    got = sampling.fold_in(sampling.prng_key(seeds), steps).numpy()
    want = np.stack([_words(_jkey(int(s), int(t)))
                     for s, t in zip(seeds, steps)])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("shape", [(1,), (7,), (VOCAB,), (3, VOCAB),
                                   (2, 3, 5)])
def test_random_bits_match_jax(shape):
    for seed, step in [(0, 0), (7, 9), (2**31 - 1, 4096)]:
        want = np.asarray(jax.random.bits(_jkey(seed, step), shape,
                                          jnp.uint32)).astype(np.int64)
        got = sampling.random_bits(_tkey(seed, step), shape).numpy()
        assert got.shape == shape and np.array_equal(got, want)


def test_random_bits_batched_keys():
    """A (B, 2) key array draws (B, V) bits, row b from key b."""
    keys = torch.stack([_tkey(s, t) for s, t in zip(SEEDS, STEPS + [5])])
    got = sampling.random_bits(keys, (VOCAB,)).numpy()
    for b, (s, t) in enumerate(zip(SEEDS, STEPS + [5])):
        want = np.asarray(jax.random.bits(_jkey(s, t), (VOCAB,),
                                          jnp.uint32)).astype(np.int64)
        assert np.array_equal(got[b], want)


# -- 2. uniforms, 3. Gumbel values ----------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_matches_jax_exactly(seed):
    for step in STEPS:
        want = np.asarray(jax.random.uniform(
            _jkey(seed, step), (VOCAB,), jnp.float32, minval=TINY,
            maxval=1.0))
        got = sampling.uniform(_tkey(seed, step), (VOCAB,))
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_two_ulp(seed):
    for step in STEPS:
        key = _tkey(seed, step)
        u = sampling.uniform(key, (VOCAB,))
        # each log, on the same f32 inputs, within one ulp of XLA's
        inner_t = -torch.log(u)
        inner_j = np.asarray(jax.jit(lambda x: -jnp.log(x))(u.numpy()))
        assert _ulps(inner_t.numpy(), inner_j).max() <= 1
        outer_j = np.asarray(jax.jit(lambda x: -jnp.log(x))(
            inner_t.numpy()))
        assert _ulps(-torch.log(inner_t).numpy(), outer_j).max() <= 1
        want = np.asarray(jax.random.gumbel(_jkey(seed, step), (VOCAB,),
                                            jnp.float32))
        got = sampling.gumbel(key, (VOCAB,)).numpy()
        ulp = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
        assert (np.abs(got - want) <= 2 * ulp).all()


# -- 4. draws --------------------------------------------------------------


def test_categorical_matches_jax(rng):
    """Gumbel-max draws over 60 keys, on logits with -inf entries (the
    masks of top-k/top-p) and on a full vocabulary."""
    for i in range(60):
        V = VOCAB if i % 10 == 0 else 256
        logits = (rng.normal(size=(V,)) * rng.choice([0.5, 2.0, 8.0])) \
            .astype(np.float32)
        logits[rng.random(V) < 0.3] = -np.inf
        seed, step = int(rng.integers(0, 2**31 - 1)), int(rng.integers(0,
                                                                       500))
        want = int(jax.random.categorical(_jkey(seed, step),
                                          jnp.asarray(logits)))
        got = int(sampling.categorical(_tkey(seed, step),
                                       torch.from_numpy(logits)))
        assert got == want, (i, seed, step)


@pytest.mark.parametrize("temp,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 0, 1.0), (1.3, 20, 1.0), (0.9, 0, 0.9),
    (0.8, 40, 0.95), (2.0, 5, 0.5), (0.0, 0, 1.0),
])
@pytest.mark.parametrize("V", [256, VOCAB])
def test_sample_tokens_matches_jax(rng, temp, top_k, top_p, V):
    B = 8
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    seeds = rng.integers(0, 2**31 - 1, B).astype(np.int32)
    steps = rng.integers(0, 1000, B).astype(np.int32)
    temps = np.full((B,), temp, np.float32)
    top_ks = np.full((B,), top_k, np.int32)
    top_ps = np.full((B,), top_p, np.float32)
    args = (logits, seeds, steps, temps, top_ks, top_ps)
    want = np.asarray(jsampling.sample_tokens(*map(jnp.asarray, args)))
    got = sampling.sample_tokens(*map(torch.from_numpy, args))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_sample_tokens_mixed_rows_match_jax(rng):
    """One batch mixing greedy and seeded rows of different parameters."""
    B, V = 6, 512
    logits = (rng.normal(size=(B, V)) * 2).astype(np.float32)
    args = (logits, np.arange(B, dtype=np.int32) * 977,
            np.array([0, 3, 9, 2, 7, 1], np.int32),
            np.array([0.0, 0.7, 1.0, 1.3, 0.9, 2.0], np.float32),
            np.array([0, 10, 0, 50, 3, 0], np.int32),
            np.array([1.0, 1.0, 0.9, 0.5, 1.0, 0.95], np.float32))
    want = np.asarray(jsampling.sample_tokens(*map(jnp.asarray, args)))
    got = sampling.sample_tokens(*map(torch.from_numpy, args)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("temp,top_k,top_p", [(0.9, 30, 0.95),
                                              (1.0, 0, 1.0), (0.0, 0, 1.0)])
def test_verify_accept_seeded_matches_jax(rng, temp, top_k, top_p):
    """The seeded accept rule draws the target at stream position steps
    + j for window row j: the port's targets, accepted prefixes and
    commits equal JAX's, with drafts built from those targets so every
    prefix length is exercised."""
    B, K1, V = 5, 4, 64
    logits = (rng.normal(size=(B, K1, V)) * 2).astype(np.float32)
    seeds = rng.integers(0, 2**31 - 1, B).astype(np.int32)
    steps = rng.integers(0, 100, B).astype(np.int32)
    temps = np.full((B,), temp, np.float32)
    top_ks = np.full((B,), top_k, np.int32)
    top_ps = np.full((B,), top_p, np.float32)
    params = (seeds, steps, temps, top_ks, top_ps)
    tgt = np.stack([np.asarray(jsampling.sample_tokens(
        jnp.asarray(logits[:, j]), jnp.asarray(seeds),
        jnp.asarray(steps + j), *map(jnp.asarray, params[2:])))
        for j in range(K1)], 1)
    tokens = rng.integers(0, V, (B, K1)).astype(np.int32)
    for b in range(B):               # row b matches its first b targets
        tokens[b, 1:1 + min(b, K1 - 1)] = tgt[b, :min(b, K1 - 1)]
    nd = np.array([3, 3, 2, 3, 1], np.int32)
    want = jsampling.verify_accept(*map(jnp.asarray, (logits, tokens, nd)),
                                   *map(jnp.asarray, params))
    got = sampling.verify_accept(*map(torch.from_numpy, (logits, tokens,
                                                         nd)),
                                 *map(torch.from_numpy, params))
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


# -- 5. engines ------------------------------------------------------------


@pytest.fixture(scope="module")
def olmo():
    jm = JModel(jax_config("olmo_1b").smoke())
    jparams = jm.init(jax.random.PRNGKey(0))
    tcfg = get_config("olmo_1b").smoke()
    tparams = weights.from_jax_numpy(jax.tree.map(np.asarray, jparams),
                                     tcfg, "cpu")
    return jm, jparams, Model(tcfg, device="cpu"), tparams


def _seeded_work(rng, vocab, n=5):
    prompts = [list(map(int, rng.integers(0, vocab, int(L))))
               for L in rng.integers(3, 14, n)]
    kw = [dict(max_tokens=int(rng.integers(4, 11)),
               temperature=float(rng.choice([0.6, 0.9, 1.2])),
               top_k=int(rng.choice([0, 20])),
               top_p=float(rng.choice([1.0, 0.9])), seed=int(s))
          for s in rng.integers(0, 2**31 - 1, n)]
    return prompts, kw


GEO = dict(num_slots=3, block_size=4, num_blocks=40, max_len=48)


def test_engine_seeded_matches_jax_engine(rng, olmo):
    """Seeded requests through the port's Engine and the JAX Engine on
    the same weights: equal tokens, request by request."""
    jm, jparams, tm, tparams = olmo
    prompts, kw = _seeded_work(rng, tm.cfg.vocab_size)
    want = JEngine(jm, jparams, JEngineConfig(backend="paged", **GEO)) \
        .generate(prompts, [JSamplingParams(**k) for k in kw])
    eng = Engine(tm, tparams, EngineConfig(**GEO), device="cpu")
    got = eng.generate(prompts, [SamplingParams(**k) for k in kw])
    assert got == want
    assert eng.stats()["blocks_used"] == 0


def test_spec_engine_seeded_matches_jax_engine(rng, olmo):
    """The seeded speculative engine (ngram, K 3, prefix cache on) gives
    the JAX speculative engine's tokens, and the plain JAX engine's."""
    jm, jparams, tm, tparams = olmo
    prompts, kw = _seeded_work(rng, tm.cfg.vocab_size)
    prompts = [p + p[:4] * 2 for p in prompts]     # ngram material
    sp = [JSamplingParams(**k) for k in kw]
    want = JEngine(jm, jparams, JEngineConfig(
        backend="paged", spec_tokens=3, drafter="ngram", **GEO)) \
        .generate(prompts, sp)
    plain = JEngine(jm, jparams, JEngineConfig(backend="paged", **GEO)) \
        .generate(prompts, sp)
    eng = Engine(tm, tparams, EngineConfig(spec_tokens=3, drafter="ngram",
                                           **GEO), device="cpu")
    got = eng.generate(prompts, [SamplingParams(**k) for k in kw])
    assert got == want == plain
    st = eng.stats()
    assert st["blocks_used"] == 0 and st["spec"]["steps"] > 0
