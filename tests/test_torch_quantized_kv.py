"""The port's quantized paged KV pool (int8 / fp8 e4m3, kernel K4's
path) against the JAX package on the CPU, mirroring
tests/test_quantized_kv.py wherever the port has the feature.

The chain, weakest to strongest:
  1. quantization: ``quantize_kv`` payload and scales are bit-identical
     to JAX's (zero rows, values far past +-448, f32 and bf16 inputs);
     the round trip is bounded; ``PoolSpec`` validates and hashes;
  2. the pool writes (``write_kv_rows``, ``pack_prefill_kv``) leave the
     same bytes as JAX's; the bf16 pool tree gains no scale leaves;
  3. the plain paged decode and verify over a quantized pool (what the
     wrappers run for CPU tensors, and what K4 is held against on the
     card) match JAX's oracle and its Pallas kernels in interpret mode
     within 1e-4 in f32; a padded head dim is exact;
  4. engines: int8 and fp8 greedy tokens equal the JAX
     ``Engine(kv_dtype=...)`` tokens on olmo, yi and gemma smoke;
     seeded ones too; speculation over a quantized pool equals the
     non-speculative engine and JAX; the prefix cache shares quantized
     blocks and its copy-on-write copies the scale leaves; zero leaks;
  5. the gates: unknown kv_dtype (API and CLI), the static backend, the
     encoder-decoder cap, and recurrent configs (not ported).

Inputs are made by numpy from a seed and fed to both packages; weights
are JAX's init carried over with the weight bridge.
"""

import os
import subprocess
import sys

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
from repro.launch.engine import SamplingParams as JSamplingParams
from repro.models import paged_kv as jpk
from repro.models.model import Model as JModel
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa_mod
from repro_torch.launch.engine import Engine, EngineConfig, SamplingParams
from repro_torch.models import paged_kv, weights
from repro_torch.models.model import Model

torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4                       # f32, summation order (JAX's own)
GEO = dict(num_slots=3, block_size=4, num_blocks=33, max_len=48)
STORE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def _spec(kv_dtype="int8", bs=4, hkv=2, hd=16, padded=0, mod=paged_kv):
    return mod.PoolSpec(kv_dtype=kv_dtype, block_size=bs, n_kv_heads=hkv,
                        head_dim=hd, padded_head_dim=padded)


def _to_torch(a):
    """A JAX payload (int8 / float8_e4m3fn / float) as a torch tensor of
    the same bytes."""
    a = np.asarray(a)
    if a.dtype.itemsize == 1 and a.dtype != np.int8:       # fp8
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _bytes(t):
    """Payload bytes of a torch or JAX array, for bit comparisons."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.uint8).numpy() \
            if t.element_size() == 1 else t.numpy()
    a = np.asarray(t)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


def _rows(rng, shape):
    """K/V rows at mixed magnitudes: zero rows, rows past +-448, tiny
    rows."""
    x = rng.normal(size=shape) * rng.choice([1e-3, 1.0, 30.0, 1e5],
                                            size=shape[:-1] + (1,))
    x = x.astype(np.float32)
    x.reshape(-1, shape[-1])[::7] = 0.0
    return x


# -- 1. quantization math ----------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_identical_to_jax(rng, kv_dtype, dtype):
    x = _rows(rng, (24, 4, 2, 16))
    jq, js = jpk.quantize_kv(jnp.asarray(x, dtype), _spec(kv_dtype,
                                                          mod=jpk))
    tq, ts = paged_kv.quantize_kv(
        torch.from_numpy(x).to(getattr(torch, dtype)), _spec(kv_dtype))
    assert tq.dtype == STORE[kv_dtype] and ts.dtype == torch.float32
    assert ts.shape == x.shape[:-1]
    np.testing.assert_array_equal(_bytes(tq), _bytes(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantize_roundtrip_bounded(rng):
    x = torch.from_numpy(rng.normal(size=(9, 4, 2, 16)).astype(np.float32))
    payload, scale = paged_kv.quantize_kv(x, _spec("int8"))
    back = paged_kv.dequantize_kv(payload, scale)
    err = (back - x).abs().max().item()
    # per-(row, head) amax / 127 bounds the grid step
    assert err <= x.abs().max().item() / 127.0 + 1e-6
    payload, scale = paged_kv.quantize_kv(x, _spec("fp8"))
    back = paged_kv.dequantize_kv(payload, scale)
    # e4m3 keeps 3 mantissa bits: rounding moves a scaled value by at
    # most 2**-4 of itself, or by half the subnormal step 2**-9 below
    # 2**-6; in x's units the scale is the row's amax / 448
    amax = x.abs().amax(-1, keepdim=True)
    bound = torch.maximum(x.abs() / 16, amax / 448 * 2.0**-10)
    assert ((back - x).abs() <= bound * (1 + 1e-6)).all()


def test_quantize_zero_rows_and_fp8_overflow(rng):
    z = torch.zeros((2, 4, 2, 16))
    payload, scale = paged_kv.quantize_kv(z, _spec("int8"))
    assert paged_kv.dequantize_kv(payload, scale).abs().max().item() == 0.0
    big = torch.from_numpy(rng.normal(size=(2, 4, 2, 16)) * 1e6).float()
    payload, scale = paged_kv.quantize_kv(big, _spec("fp8"))
    assert torch.isfinite(paged_kv.dequantize_kv(payload, scale)).all()


def test_pool_spec_validates_and_hashes():
    with pytest.raises(ValueError, match="kv_dtype"):
        paged_kv.PoolSpec(kv_dtype="int4")
    with pytest.raises(ValueError, match="padded_head_dim"):
        paged_kv.PoolSpec(kv_dtype="int8", head_dim=64, padded_head_dim=32)
    sharded = paged_kv.PoolSpec(kv_dtype="int8", head_sharded=True)
    assert sharded.head_sharded and sharded != paged_kv.PoolSpec(
        kv_dtype="int8")
    a = _spec("int8")
    assert hash(a) == hash(_spec("int8")) and a == _spec("int8")
    assert a.quantized and not _spec("bf16").quantized
    assert _spec("bf16", padded=128).pool_head_dim == 128
    assert (_spec("int8").store_dtype, _spec("fp8").store_dtype,
            _spec("bf16").store_dtype) == (torch.int8, torch.float8_e4m3fn,
                                           None)
    assert (_spec("int8").qmax, _spec("fp8").qmax) == (127.0, 448.0)


# -- 2. pool writes and the pool tree ------------------------------------


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_pool_writes_match_jax(rng, kv_dtype):
    """``pack_prefill_kv`` then ``write_kv_rows`` (a verify window) into
    a stacked quantized pool leave JAX's bytes and scales."""
    L, NB, BS, Hkv, D = 2, 9, 4, 2, 16
    tspec, jspec = _spec(kv_dtype), _spec(kv_dtype, mod=jpk)
    dense = {n: _rows(rng, (L, 2, 8, Hkv, D)) for n in ("k", "v")}
    ids = np.array([[3, 5], [7, 0]], np.int32)
    phys = np.array([[3, 3, 1], [2, 8, 8]], np.int32)
    off = np.array([[1, 2, 0], [3, 0, 1]], np.int32)
    new = {n: _rows(rng, (2, 3, Hkv, D)) for n in ("k", "v")}
    shape = (L, NB, BS, Hkv, D)
    jpool = {"k": jnp.zeros(shape, jspec.store_dtype),
             "v": jnp.zeros(shape, jspec.store_dtype),
             "k_scale": jnp.zeros(shape[:-1], jnp.float32),
             "v_scale": jnp.zeros(shape[:-1], jnp.float32)}
    jpool = jpk.pack_prefill_kv(
        jpool, {n: jnp.asarray(a) for n, a in dense.items()},
        jnp.asarray(ids), BS, spec=jspec)
    cfg = get_config("olmo_1b").smoke()
    layout = paged_kv.PagedLayout(num_slots=2, num_blocks=NB,
                                  block_size=BS, max_len=32)
    tpool = paged_kv.init_layer_pool(cfg, layout, torch.float32, "cpu",
                                     lead=(L,), spec=tspec)
    paged_kv.pack_prefill_kv(tpool, {n: torch.from_numpy(a)
                                     for n, a in dense.items()},
                             torch.from_numpy(ids), BS, spec=tspec)
    # one decode-frontier write into layer 0 (JAX returns a new pool)
    jl0 = jpk.write_kv_rows({n: v[0] for n, v in jpool.items()},
                            jnp.asarray(phys), jnp.asarray(off),
                            jnp.asarray(new["k"]), jnp.asarray(new["v"]),
                            jspec)
    paged_kv.write_kv_rows({n: v[0] for n, v in tpool.items()},
                           torch.from_numpy(phys), torch.from_numpy(off),
                           torch.from_numpy(new["k"]),
                           torch.from_numpy(new["v"]), tspec)
    for n in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(_bytes(tpool[n][0]), _bytes(jl0[n]))
        np.testing.assert_array_equal(_bytes(tpool[n][1]),
                                      _bytes(jpool[n][1]))


def test_bf16_pool_tree_unchanged():
    """A bf16 engine builds exactly the pool tree of an engine without a
    spec (no scale leaves, the model dtype); an int8 / fp8 engine adds
    f32 scale leaves beside payloads of its store dtype."""
    model = Model(get_config("olmo_1b").smoke(), device="cpu")
    params = model.init(seed=0)
    eng = Engine(model, params, EngineConfig(**GEO), device="cpu")
    pool = eng.backend.pools["g0"]["p0"]
    assert set(pool) == {"k", "v"} and eng.backend.kv_spec is None
    assert pool["k"].dtype == torch.float32
    for kv_dtype, store in STORE.items():
        q = Engine(model, params, EngineConfig(**GEO, kv_dtype=kv_dtype),
                   device="cpu")
        qpool = q.backend.pools["g0"]["p0"]
        assert set(qpool) == {"k", "v", "k_scale", "v_scale"}
        assert qpool["k"].dtype == store == qpool["v"].dtype
        assert qpool["k_scale"].dtype == torch.float32
        assert qpool["k_scale"].shape == qpool["k"].shape[:-1]
        assert q.backend.ctx.kv_spec == q.backend.kv_spec


def test_pool_bytes_count_scale_leaves():
    """``stats()["pool_bytes"]`` counts every leaf: an int8/fp8 pool
    holds (D + 4) bytes per (token, head) and K/V against 4 D for the
    f32 smoke pool."""
    cfg = get_config("olmo_1b").smoke()
    model = Model(cfg, device="cpu")
    params = model.init(seed=0)
    per = GEO["num_blocks"] * GEO["block_size"] * cfg.n_kv_heads \
        * cfg.n_layers * 2
    for kv_dtype, width in (("bf16", 4 * cfg.head_dim),
                            ("int8", cfg.head_dim + 4),
                            ("fp8", cfg.head_dim + 4)):
        eng = Engine(model, params, EngineConfig(**GEO, kv_dtype=kv_dtype),
                     device="cpu")
        st = eng.stats()
        assert st["pool_bytes"] == per * width and st["kv_dtype"] == kv_dtype


# -- 3. plain paged attention over a quantized pool ----------------------


def _quant_case(rng, B, hq, hkv, hd, bs, nbmax, lengths, kv_dtype, K1=None):
    nb = B * nbmax + 1
    qshape = (B, hq, hd) if K1 is None else (B, K1, hq, hd)
    q = rng.normal(size=qshape).astype(np.float32)
    kp = rng.normal(size=(nb, bs, hkv, hd)).astype(np.float32)
    vp = rng.normal(size=(nb, bs, hkv, hd)).astype(np.float32)
    bt = (rng.permutation(nb - 1) + 1)[:B * nbmax].reshape(B, nbmax) \
        .astype(np.int32)
    ln = np.asarray(lengths, np.int32)
    spec = _spec(kv_dtype, bs=bs, hkv=hkv, hd=hd, mod=jpk)
    kq, ks = jpk.quantize_kv(jnp.asarray(kp), spec)
    vq, vs = jpk.quantize_kv(jnp.asarray(vp), spec)
    jpool = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    tpool = {n: _to_torch(a) for n, a in jpool.items()}
    return q, jpool, tpool, bt, ln, spec


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("mode", ["decode", "verify"])
def test_quantized_paged_attention_matches_jax(rng, kv_dtype, window, mode):
    """The plain quantized decode / verify (the port's CPU path and K4's
    yardstick) against JAX's oracle and its Pallas kernel in interpret
    mode: ragged lengths, a block boundary, a single token, GQA 2."""
    K1 = None if mode == "decode" else 3
    lengths = [7, 8, 1, 16] if mode == "decode" else [2, 7, 0, 12]
    q, jpool, tpool, bt, ln, spec = _quant_case(rng, 4, 4, 2, 16, 4, 5,
                                                lengths, kv_dtype, K1)
    n0 = (pa_mod.paged_decode_attention.k4_launches,
          pa_mod.paged_verify_attention.k4_launches)
    got = ops.paged_attention(torch.from_numpy(q), tpool,
                              torch.from_numpy(bt), torch.from_numpy(ln),
                              mode=mode, window=window)
    assert n0 == (pa_mod.paged_decode_attention.k4_launches,
                  pa_mod.paged_verify_attention.k4_launches)
    oracle = jref.paged_decode_attention if mode == "decode" \
        else jref.paged_verify_attention
    want = oracle(jnp.asarray(q), jpool["k"], jpool["v"], jnp.asarray(bt),
                  jnp.asarray(ln), window=window, k_scale=jpool["k_scale"],
                  v_scale=jpool["v_scale"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    kern = jops.paged_attention(jnp.asarray(q), jpool, jnp.asarray(bt),
                                jnp.asarray(ln), mode=mode, window=window,
                                kernel_mode="interpret", kv_format=spec)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("mode", ["decode", "verify"])
def test_padded_head_dim_is_exact(rng, mode):
    """A pool padded to head dim 128 (zero tail, written through the
    spec) holds exactly the unpadded pool's payload and scales (the
    per-row absmax, hence every scale and payload value, is invariant
    under zero padding), and attention over it gives the unpadded
    output: q is zero-padded, the scale comes from the logical head dim,
    the tail is sliced off. The plain version reads the padded pool at
    the logical head dim (the zero tail adds nothing), so its output is
    bit-equal to the unpadded pool's, as JAX's oracle is. The same
    padded pool through JAX agrees within 1e-4."""
    K1 = None if mode == "decode" else 3
    q, _, upool, bt, ln, _ = _quant_case(rng, 4, 4, 2, 16, 4, 5,
                                         [7, 8, 1, 16], "int8", K1)
    spec_p = _spec("int8", padded=128)
    dense = {n: paged_kv.dequantize_kv(upool[n], upool[n + "_scale"])
             for n in ("k", "v")}
    ppool = {"k": torch.zeros(dense["k"].shape[:-1] + (128,),
                              dtype=torch.int8)}
    ppool["v"] = ppool["k"].clone()
    ppool["k_scale"] = torch.zeros(dense["k"].shape[:-1])
    ppool["v_scale"] = ppool["k_scale"].clone()
    nb, bs = dense["k"].shape[:2]
    ids = torch.arange(nb)[None]                     # every block, in place
    paged_kv.pack_prefill_kv({n: t[None] for n, t in ppool.items()},
                             {n: t.reshape(1, 1, nb * bs, 2, 16)
                              for n, t in dense.items()}, ids, bs,
                             spec=spec_p)
    for n in ("k", "v"):
        assert torch.equal(ppool[n][..., :16], upool[n])
        assert not ppool[n][..., 16:].any()
        assert torch.equal(ppool[n + "_scale"], upool[n + "_scale"])
    args = (torch.from_numpy(q), torch.from_numpy(bt), torch.from_numpy(ln))
    out_u = ops.paged_attention(args[0], upool, *args[1:], mode=mode)
    out_p = ops.paged_attention(args[0], ppool, *args[1:], mode=mode,
                                kv_format=spec_p)
    assert out_p.shape == out_u.shape == args[0].shape
    assert torch.equal(out_p, out_u)
    jpool = {n: jnp.asarray(t.numpy()) for n, t in ppool.items()}
    want = jops.paged_attention(jnp.asarray(q), jpool, jnp.asarray(bt),
                                jnp.asarray(ln), mode=mode, kernel_mode="ref",
                                kv_format=_spec("int8", padded=128, mod=jpk))
    np.testing.assert_allclose(out_p.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_kv_format_must_match_pool(rng):
    """The spec handed to the dispatcher is checked against the pool:
    another head dim, padding or quantization raises."""
    q, _, tpool, bt, ln, _ = _quant_case(rng, 2, 4, 2, 16, 4, 3, [5, 9],
                                         "int8")
    args = (torch.from_numpy(q), tpool, torch.from_numpy(bt),
            torch.from_numpy(ln))
    ops.paged_attention(*args, kv_format=_spec("int8"))
    for bad in (_spec("bf16"), _spec("int8", hd=32),
                _spec("int8", padded=128)):
        with pytest.raises(ValueError, match="kv_format"):
            ops.paged_attention(*args, kv_format=bad)


# -- 4. engines ------------------------------------------------------------


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


def _run(model, params, prompts, sp, **kw):
    eng = Engine(model, params, EngineConfig(**dict(GEO, **kw)),
                 device="cpu")
    out = eng.generate(prompts, sp)
    be = eng.backend
    assert be.alloc.free_count == be.layout.usable_blocks   # zero leaks
    assert eng.stats()["blocks_used"] == 0
    return out, eng


def _jrun(jm, jparams, prompts, sp, **kw):
    return JEngine(jm, jparams, JEngineConfig(
        **dict(GEO, backend="paged", **kw))).generate(prompts, sp)


@pytest.mark.parametrize("arch", ["olmo_1b", "yi_6b", "gemma_7b"])
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_engine_quantized_greedy_matches_jax_engine(rng, arch, kv_dtype):
    """Ragged prompts through both engines over an int8 / fp8 pool, same
    weights: token-identical greedy outputs, zero leaks."""
    jm, jparams, tm, tparams = _pair(arch)
    prompts = [list(map(int, rng.integers(0, tm.cfg.vocab_size, L)))
               for L in (3, 9, 14)]
    want = _jrun(jm, jparams, prompts, JSamplingParams(max_tokens=8),
                 kv_dtype=kv_dtype)
    got, eng = _run(tm, tparams, prompts, SamplingParams(max_tokens=8),
                    kv_dtype=kv_dtype)
    assert got == want
    assert eng.stats()["kv_dtype"] == kv_dtype


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_engine_quantized_seeded_matches_jax_engine(rng, olmo, kv_dtype):
    jm, jparams, tm, tparams = olmo
    prompts = [list(map(int, rng.integers(0, tm.cfg.vocab_size, L)))
               for L in (4, 11, 6)]
    kw = [dict(max_tokens=8, temperature=0.9, top_k=20, top_p=0.95,
               seed=int(s)) for s in (3, 99, 12345)]
    want = _jrun(jm, jparams, prompts, [JSamplingParams(**k) for k in kw],
                 kv_dtype=kv_dtype)
    got, _ = _run(tm, tparams, prompts, [SamplingParams(**k) for k in kw],
                  kv_dtype=kv_dtype)
    assert got == want


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_spec_quantized_matches_nonspec_and_jax(rng, olmo, kv_dtype):
    """Verify-path quantization: the speculative engine over a quantized
    pool emits the non-speculative quantized engine's tokens and JAX's,
    greedy and seeded."""
    jm, jparams, tm, tparams = olmo
    prompts = [(list(map(int, rng.integers(0, tm.cfg.vocab_size, 4)))
                * 4)[:9 + i] for i in range(3)]
    for kw in (dict(max_tokens=10),
               dict(max_tokens=10, temperature=0.8, top_k=30, seed=5)):
        want, _ = _run(tm, tparams, prompts, SamplingParams(**kw),
                       kv_dtype=kv_dtype)
        got, eng = _run(tm, tparams, prompts, SamplingParams(**kw),
                        kv_dtype=kv_dtype, spec_tokens=3)
        jwant = _jrun(jm, jparams, prompts, JSamplingParams(**kw),
                      kv_dtype=kv_dtype, spec_tokens=3)
        assert got == want == jwant
        assert eng.stats()["spec"]["accepted"] > 0


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_draft_model_spec_quantized_matches_nonspec(rng, olmo, kv_dtype):
    """The draft-model drafter over a quantized target pool: the draft's
    own dense caches stay in the model dtype (as in JAX), and the tokens
    equal the non-speculative quantized engine's."""
    _, _, tm, tparams = olmo
    prompts = [list(map(int, rng.integers(0, tm.cfg.vocab_size, n)))
               for n in (5, 9, 13)]
    sp = SamplingParams(max_tokens=9)
    want, _ = _run(tm, tparams, prompts, sp, kv_dtype=kv_dtype)
    got, eng = _run(tm, tparams, prompts, sp, kv_dtype=kv_dtype,
                    spec_tokens=3, drafter="draft_model", draft_model=tm,
                    draft_params=tm.init(seed=7))
    assert got == want
    assert eng.stats()["spec"]["accepted"] > 0


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_prefix_cache_shares_quantized_blocks(rng, olmo, kv_dtype):
    """The prefix cache over a quantized pool: cache on == cache off ==
    JAX, with real hits (partial hits prefill their suffix over shared
    quantized blocks) and a full hit whose copy-on-write copies the
    block."""
    jm, jparams, tm, tparams = olmo
    prefix = list(map(int, rng.integers(0, tm.cfg.vocab_size, 12)))
    prompts = [prefix + list(map(int, rng.integers(0, tm.cfg.vocab_size,
                                                   t))) for t in (4, 3, 5)]
    prompts.append(list(prompts[0]))     # 16 tokens again: a full hit
    sp = SamplingParams(max_tokens=8)
    off, _ = _run(tm, tparams, prompts, sp, kv_dtype=kv_dtype,
                  prefix_cache=False)
    on, eng = _run(tm, tparams, prompts, sp, kv_dtype=kv_dtype,
                   num_slots=1)
    jwant = _jrun(jm, jparams, prompts, JSamplingParams(max_tokens=8),
                  kv_dtype=kv_dtype)
    assert on == off == jwant
    st = eng.stats()["prefix_cache"]
    assert st["hits"] >= 3 and st["cow_copies"] >= 1


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_cow_copies_scale_leaves(olmo, kv_dtype):
    """``_cow_block`` copies every leaf of every layer's pool: payload
    bytes AND the k_scale / v_scale rows of the shared block."""
    _, _, tm, tparams = olmo
    eng = Engine(tm, tparams, EngineConfig(**GEO, kv_dtype=kv_dtype),
                 device="cpu")
    be = eng.backend
    gen = torch.Generator().manual_seed(0)
    for group in be.pools.values():
        for pool in group.values():
            for name, leaf in pool.items():
                x = torch.randn(leaf.shape, generator=gen) * 3
                leaf.copy_(x.to(leaf.dtype) if "scale" in name
                           else x.round().clamp(-100, 100).to(leaf.dtype))
    (old,) = be.alloc.alloc(1)
    be.alloc.register(old)                   # shared with the index
    be.alloc.share(old)
    be.slots[0].blocks = [old]
    be.slots[0].shared = 1
    be.table[0, 0] = old
    be._cow_block(0, 0)
    new = be.slots[0].blocks[0]
    assert new != old and be.table[0, 0] == new and be.cow_copies == 1
    for group in be.pools.values():
        for pool in group.values():
            assert set(pool) == {"k", "v", "k_scale", "v_scale"}
            for leaf in pool.values():
                assert torch.equal(leaf[:, new].view(torch.uint8)
                                   if leaf.element_size() == 1
                                   else leaf[:, new],
                                   leaf[:, old].view(torch.uint8)
                                   if leaf.element_size() == 1
                                   else leaf[:, old])


# -- 5. the gates ----------------------------------------------------------


def test_unknown_kv_dtype_rejected(olmo):
    _, _, tm, tparams = olmo
    with pytest.raises(ValueError, match="kv_dtype"):
        Engine(tm, tparams, EngineConfig(**GEO, kv_dtype="int4"),
               device="cpu")


def test_static_backend_rejects_quantized(olmo):
    _, _, tm, tparams = olmo
    with pytest.raises(ValueError, match="paged backend"):
        Engine(tm, tparams, EngineConfig(backend="static", kv_dtype="int8"),
               device="cpu")


def test_encdec_rejects_quantized_naming_cap():
    model = Model(get_config("whisper_base").smoke(), device="cpu")
    assert not model.serving_caps().quantized_kv
    with pytest.raises(ValueError, match="quantized_kv"):
        Engine(model, {}, EngineConfig(**GEO, kv_dtype="int8"),
               device="cpu")


@pytest.mark.parametrize("arch", ["xlstm_1_3b"])
def test_quantized_recurrent_serves_fp8_as_jax(rng, arch):
    """xLSTM over an fp8 pool: no layer keeps its K/V in the pool, so
    the mLSTM / sLSTM states stay f32 and the tokens equal the JAX
    engine's over fp8 and the port's bf16 engine's."""
    jm, jparams, tm, tparams = _pair(arch)
    assert tm.serving_caps().quantized_kv
    prompts = [list(map(int, rng.integers(0, tm.cfg.vocab_size, L)))
               for L in (3, 9, 14)]
    want = _jrun(jm, jparams, prompts, JSamplingParams(max_tokens=8),
                 kv_dtype="fp8")
    got, eng = _run(tm, tparams, prompts, SamplingParams(max_tokens=8),
                    kv_dtype="fp8")
    assert got == want
    assert eng.stats()["kv_dtype"] == "fp8"
    assert _run(tm, tparams, prompts, SamplingParams(max_tokens=8))[0] \
        == got


def test_serve_cli_rejects_unknown_kv_dtype():
    """The port's serve CLI takes --kv-dtype from a closed set: an
    unknown value dies in argparse before any device work."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--kv-dtype", "int4"],
        env=dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src")),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert "invalid choice: 'int4'" in proc.stderr
