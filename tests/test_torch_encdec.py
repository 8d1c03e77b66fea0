"""The port's encoder-decoder (whisper_base) against the JAX package on
the CPU: whisper_base smoke (2 encoder and 2 decoder layers, d_model 64,
4 heads of 16, 16 encoder frames).

The chain, weakest to strongest:
  1. the pieces: the sinusoidal table, the masked self- and
     cross-attention (a fully masked row gives zeros, no NaN), the
     encoder with and without frame masks, the ``CrossArena``;
  2. the model: dense prefill logits and four decode steps; the paged
     admission (masked encoder, arena write, decoder prefill packed into
     the pool) and a paged decode step, logits and pools; the weight
     bridge and the bf16 init tree;
  3. the Engine, token for token and counter for counter (``cross_arena``
     and the admission shapes, JAX's ``prefill_compiles``, included)
     against the JAX Engine: greedy with preemption, seeded, features
     shared by identity, the frame-bucket axis, ``overlap=True``; and
     its refusals, with JAX's error kinds and messages.

Inputs are made by numpy from a seed and fed to both packages; weights
are JAX's init carried over with the weight bridge. Tolerance 1e-4 for
f32 values (summation order inside matmuls); tokens exact.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.engine import Engine as JEngine
from repro.launch.engine import EngineConfig as JEngineConfig
from repro.launch.engine import SamplingParams as JSamplingParams
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models.model import Model as JModel
from repro.models.transformer import RunCtx as JRunCtx
from repro_torch.configs import get_config
from repro_torch.launch.engine import (Engine, EngineConfig, Request,
                                       SamplingParams)
from repro_torch.models import attention, encdec, layers, paged_kv, weights
from repro_torch.models.model import Model
from repro_torch.models.transformer import RunCtx, layer_slice

torch.set_num_threads(1)

ARCH = "whisper_base"
JCTX = JRunCtx(kernel_mode="ref")
CTX = RunCtx()
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


@pytest.fixture(scope="module")
def wh():
    jcfg, tcfg = jax_config(ARCH).smoke(), get_config(ARCH).smoke()
    jm = JModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = weights.from_jax_numpy(jax.tree.map(np.asarray, jparams),
                                     tcfg, "cpu")
    return jcfg, tcfg, jm, jparams, Model(tcfg, device="cpu"), tparams


def _layer0(jparams, stack, name):
    jp = jax.tree.map(lambda t: t[0], jparams[stack][name])
    return jp, weights.map_tree(_t, jax.tree.map(np.asarray, jp))


# -- 1. the pieces -----------------------------------------------------------


@pytest.mark.parametrize("d,n", [(64, 16), (512, 1500)])
def test_sinusoidal_embed_matches_jax(d, n):
    """The exponent arguments of the inverse frequencies are JAX's bit
    for bit, and so is the f32 table where exp, sin and cos round alike.
    torch's and XLA:CPU's exp / sin / cos round the last bit differently
    on some arguments, so the table is held to JAX within two f32 ulps
    of the largest angle (the angle's rounding bounds the gap)."""
    half = d // 2
    jarg = np.asarray(-math.log(10000.0) * jnp.arange(half, dtype=jnp.float32)
                      / max(half - 1, 1))
    targ = -math.log(10000.0) * torch.arange(half, dtype=torch.float32) \
        / max(half - 1, 1)
    np.testing.assert_array_equal(targ.numpy(), jarg)
    pos = np.arange(n)
    want = np.asarray(jlayers.sinusoidal_embed(jnp.asarray(pos), d,
                                               jnp.float32))
    got = layers.sinusoidal_embed(_t(pos), d).numpy()
    assert got.dtype == np.float32 and got.shape == (n, d)
    np.testing.assert_array_equal(got[0], want[0])       # sin 0, cos 0
    _close(got, want, rtol=0, atol=2 * n * 2.0 ** -23)
    bf = layers.sinusoidal_embed(_t(pos), d, torch.bfloat16)
    np.testing.assert_array_equal(bf.float().numpy(),
                                  torch.from_numpy(got).bfloat16().float()
                                  .numpy())


@pytest.mark.parametrize("which", ["self", "cross"])
def test_masked_attention_matches_jax(rng, wh, which):
    """``attend_masked`` (the serving encoder) and ``attend_cross_masked``
    (the decoder over the arena) against JAX on rows of 5, 8 and 0 real
    keys: the 0-key row (a batch filler, an empty slot on the null row)
    gives exact zeros, and nothing is NaN."""
    jcfg, tcfg, _, jparams, _, _ = wh
    lens = np.asarray([5, 8, 0], np.int32)
    x = rng.normal(size=(3, 8, 64)).astype(np.float32)
    if which == "self":
        jp, tp = _layer0(jparams, "enc", "attn")
        want = jattn.attend_masked(jp, jcfg, jnp.asarray(x), jnp.asarray(lens))
        got = attention.attend_masked(tp, tcfg, _t(x), _t(lens))
    else:
        jp, tp = _layer0(jparams, "dec", "xattn")
        kv = {n: rng.normal(size=(3, 2, 16, 16)).astype(np.float32)
              for n in ("k", "v")}
        xq = x[:, :3]
        want = jattn.attend_cross_masked(
            jp, jcfg, jnp.asarray(xq), jax.tree.map(jnp.asarray, kv),
            jnp.asarray(lens))
        got = attention.attend_cross_masked(
            tp, tcfg, _t(xq), weights.map_tree(_t, kv), _t(lens))
    assert torch.isfinite(got).all()
    np.testing.assert_array_equal(got[2].numpy(), 0.0)
    _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("masked", [False, True])
def test_encode_matches_jax(rng, wh, masked):
    """The encoder over (3, 16) frames: exact length (bidirectional
    through K1's plain version), and right-padded with frame counts 11,
    16 and 0 (a filler row)."""
    jcfg, tcfg, _, jparams, _, tparams = wh
    frames = rng.normal(size=(3, 16, 64)).astype(np.float32)
    lens = np.asarray([11, 16, 0], np.int32)
    want = jencdec.encode(jparams, jcfg, jnp.asarray(frames), JCTX,
                          enc_lengths=jnp.asarray(lens) if masked else None)
    got = encdec.encode(tparams, tcfg, _t(frames),
                        enc_lengths=_t(lens) if masked else None)
    assert torch.isfinite(got).all()
    _close(got.numpy(), np.asarray(want))


def test_cross_arena_alloc_share_free():
    a = paged_kv.CrossArena(3)
    assert a.free_count == 3 and a.used_count == 0
    r1, r2 = a.alloc(key="feat-a"), a.alloc(key="feat-b")
    assert r1 != r2 and paged_kv.NULL_ARENA not in (r1, r2)
    assert a.lookup("feat-a") == r1
    assert a.lookup("missing") == paged_kv.NULL_ARENA
    a.share(r1)
    assert a.refcount(r1) == 2 and a.used_count == 2
    a.free(r1)
    assert a.refcount(r1) == 1 and a.lookup("feat-a") == r1
    a.free(r1)
    assert a.lookup("feat-a") == paged_kv.NULL_ARENA and a.free_count == 2
    a.check_invariant()


def test_cross_arena_exhaustion_and_double_free():
    a = paged_kv.CrossArena(2)
    assert a.can_admit(2) and not a.can_admit(3)
    r1, r2 = a.alloc(), a.alloc()
    assert not a.can_admit(1)
    with pytest.raises(MemoryError):
        a.alloc()
    a.free(r1)
    with pytest.raises(ValueError, match="double-free"):
        a.free(r1)
    with pytest.raises(ValueError, match="null"):
        a.free(paged_kv.NULL_ARENA)
    with pytest.raises(ValueError, match="unreferenced"):
        a.share(r1)
    a.free(r2)
    a.check_invariant()
    assert a.free_count == 2


# -- 2. the model ------------------------------------------------------------


def test_dense_prefill_and_decode_match_jax(rng, wh):
    """Dense prefill of two 6-token prompts over 11 frames (all
    positions' logits, the cross K/V) and four greedy decode steps."""
    jcfg, tcfg, jm, jparams, tm, tparams = wh
    toks = rng.integers(0, 256, (2, 6)).astype(np.int32)
    frames = rng.normal(size=(2, 11, 64)).astype(np.float32)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks),
                                  "frames": jnp.asarray(frames)}, JCTX,
                        max_len=12)
    tl, tc = tm.prefill(tparams, {"tokens": _t(toks), "frames": _t(frames)},
                        CTX, max_len=12)
    _close(tl.numpy(), np.asarray(jl))
    for n in ("k", "v"):
        _close(tc["cross"][n].numpy(), np.asarray(jc["cross"][n]))
        _close(tc["self"][n].numpy(), np.asarray(jc["self"][n]))
    tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    for step in range(4):
        jd, jc = jm.decode_step(jparams, jc, jnp.asarray(tok),
                                jnp.int32(6 + step), JCTX)
        td, tc = tm.decode_step(tparams, tc, _t(tok),
                                torch.full((2,), 6 + step), CTX)
        _close(td.numpy(), np.asarray(jd), err_msg=f"decode step {step}")
        tok = np.argmax(np.asarray(jd), -1).astype(np.int32)[:, None]


def test_paged_admission_and_decode_match_jax(rng, wh):
    """``prefill_paged_encdec`` on a (3, 8)-token, (3, 16)-frame bucket
    with 5 / 8 real tokens, 11 / 16 real frames and a filler row, then
    ``decode_step_paged`` over the pool and the arena with an empty
    slot on the null row: logits, the self-KV pool and every arena row
    against JAX's (JAX's ``test_workload_serve`` checks the same
    positions against its dense oracle)."""
    jcfg, tcfg, jm, jparams, tm, tparams = wh
    layout = paged_kv.PagedLayout(num_slots=3, num_blocks=12, block_size=4,
                                  max_len=16)
    jpools = jm.init_paged_cache(layout)
    tpools = tm.init_paged_cache(layout)
    assert tuple(tpools["cross"]["k"].shape) == (2, 4, 2, 16, 16)
    toks = np.zeros((3, 8), np.int32)
    toks[0, :5] = rng.integers(0, 256, 5)
    toks[1] = rng.integers(0, 256, 8)
    frames = np.zeros((3, 16, 64), np.float32)
    frames[0, :11] = rng.normal(size=(11, 64))
    frames[1] = rng.normal(size=(16, 64))
    enc_lens = np.asarray([11, 16, 0], np.int32)
    lens = np.asarray([5, 8, 1], np.int32)
    ids = np.asarray([[1, 2], [3, 4], [0, 0]], np.int32)
    aids = np.asarray([2, 1, 0], np.int32)
    jrows, jpools = jm.prefill_paged_encdec(
        jparams, jpools, *(jnp.asarray(a) for a in (toks, frames, enc_lens,
                                                    lens, ids, aids)), JCTX)
    trows, _ = tm.prefill_paged_encdec(
        tparams, tpools, *(_t(a) for a in (toks, frames, enc_lens, lens,
                                           ids, aids)), CTX)
    _close(trows[:2].numpy(), np.asarray(jrows)[:2])

    def check_pools():
        want = _leaves(jax.tree.map(np.asarray, jpools))
        for path, t in _leaves(tpools).items():
            # block 0 and arena row 0 take the fillers' writes, in either
            # order: nothing reads them unmasked
            _close(t[:, 1:].numpy(), want[path][:, 1:], err_msg=path)

    check_pools()
    table = np.zeros((3, layout.max_blocks_per_seq), np.int32)
    table[0, :2], table[1, :3] = [1, 2], [3, 4, 5]
    tok = np.asarray([[7], [9], [0]], np.int32)
    args = (table, lens * np.asarray([1, 1, 0], np.int32), tok)
    jd, jpools = jm.decode_step_paged(
        jparams, jpools, *(jnp.asarray(a) for a in args), JCTX,
        arena_ids=jnp.asarray(aids), enc_lengths=jnp.asarray(enc_lens))
    td, _ = tm.decode_step_paged(tparams, tpools, *(_t(a) for a in args),
                                 CTX, arena_ids=_t(aids),
                                 enc_lengths=_t(enc_lens))
    assert torch.isfinite(td).all()
    _close(td.numpy(), np.asarray(jd))
    check_pools()


def test_bridge_and_bf16_init_tree_match_jax(wh):
    """The bridge carries JAX's enc-dec tree leaf for leaf (``enc`` and
    ``dec`` stacks, norms, tied embedding); a tree without the ``dec``
    stack is refused; the port's bf16 init has JAX's ``eval_shape`` tree,
    shapes and dtypes."""
    jcfg, tcfg, _, jparams, _, tparams = wh
    jl = _leaves(jax.tree.map(np.asarray, jparams))
    tl = _leaves(tparams)
    assert jl.keys() == tl.keys()
    for path, want in jl.items():
        np.testing.assert_array_equal(tl[path].numpy(), want, err_msg=path)
    bad = {k: v for k, v in jax.tree.map(np.asarray, jparams).items()
           if k != "dec"}
    with pytest.raises(ValueError, match="dec"):
        weights.from_jax_numpy(bad, tcfg, "cpu")
    bcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    mine = _leaves(Model(bcfg, device="cpu").init(seed=0))
    jshapes = _leaves(jax.eval_shape(lambda: JModel(dataclasses.replace(
        jcfg, dtype="bfloat16")).init(jax.random.PRNGKey(0))))
    assert mine.keys() == jshapes.keys()
    for path, s in jshapes.items():
        assert tuple(mine[path].shape) == s.shape, path
        assert str(mine[path].dtype).split(".")[-1] == str(s.dtype), path


# -- 3. the Engine -----------------------------------------------------------


def _workload(rng, n_req, lens, frames, same=()):
    prompts = [list(map(int, rng.integers(0, 256, L))) for L in lens]
    feats = [rng.normal(size=(F, 64)).astype(np.float32) for F in frames]
    for a, b in same:                    # request b submits a's array
        feats[b] = feats[a]
    return prompts[:n_req], feats[:n_req]


ENGINE_STATS = ("steps", "preemptions", "prefill_calls", "prefill_reqs",
                "prefill_tokens", "blocks_used", "cross_arena")
SEEDED = dict(temperature=8.0, top_k=32, top_p=0.95)
MODES = {
    # name: (geometry, prompt lens, frame counts, identity pairs,
    #        sampling, max_tokens, overlap)
    "greedy_preempt": (dict(num_slots=4, num_blocks=9), (3, 7, 5, 9),
                       (5, 16, 9, 12), (), None, 10, False),
    "seeded": (dict(num_slots=3, num_blocks=33), (3, 7, 5, 9),
               (5, 16, 9, 12), (), SEEDED, 6, False),
    "shared": (dict(num_slots=3, num_blocks=33), (3, 3, 4, 5),
               (12, 12, 12, 7), ((0, 1), (0, 2)), SEEDED, 5, False),
    "frame_buckets": (dict(num_slots=2, num_blocks=65), (2, 3, 5, 7),
                      (3, 7, 9, 13), (), None, 2, False),
    "overlap": (dict(num_slots=4, num_blocks=9), (3, 7, 5, 9, 4, 7),
                (5, 16, 9, 12, 7, 16), ((1, 5),), "mixed", 10, True),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_matches_jax_engine(rng, wh, mode):
    """The port's Engine and the JAX Engine on the same requests: equal
    tokens, equal scheduler and arena counters, equal admission shapes
    (the port's ``prefill_shapes``, JAX's ``prefill_compiles``), no
    block and no arena row left in use. ``greedy_preempt`` and
    ``overlap`` run on 8 usable blocks, so the pool preempts (a resumed
    request re-encodes); ``shared`` submits one array three times (one
    arena row, refcounted); ``frame_buckets`` spreads four frame counts
    over buckets 8 and 16; ``overlap`` mixes greedy and seeded rows with
    a shared pair on ``overlap=True``. JAX's overlap engine is not
    reproducible on whisper smoke (one of four runs of this trace moved
    a token; ROADMAP queue 3), so the port's overlap tokens are held to
    JAX's overlap-off engine, which JAX's contract makes equal, and its
    counters to JAX's overlap engine."""
    _, _, jm, jparams, tm, tparams = wh
    geo, lens, frames, same, samp, max_tokens, overlap = MODES[mode]
    prompts, feats = _workload(rng, len(lens), lens, frames, same)
    sps = []
    for s in range(len(prompts)):
        kw = samp if samp != "mixed" else (SEEDED if s % 2 == 0 else None)
        sps.append(SamplingParams(max_tokens=max_tokens,
                                  **({**kw, "seed": s} if kw else {})))
    geo = {"block_size": 4, "max_len": 32, **geo}
    jfeats = {id(f): jnp.asarray(f) for f in feats}   # keep the identity
    jsps = [JSamplingParams(**dataclasses.asdict(sp)) for sp in sps]

    def jax_run(overlap):
        jeng = JEngine(jm, jparams, JEngineConfig(**geo, overlap=overlap))
        out = jeng.generate(prompts, jsps,
                            encoder_features=[jfeats[id(f)] for f in feats])
        return out, jeng.stats()

    want, jst = jax_run(False)
    if overlap:
        _, jst = jax_run(True)
    eng = Engine(tm, tparams, EngineConfig(**geo, overlap=overlap),
                 device="cpu")
    got = eng.generate(prompts, sps, encoder_features=feats)
    assert got == want
    st = eng.stats()
    for k in ENGINE_STATS:
        assert st[k] == jst[k], k
    assert st["prefill_shapes"] == jst["prefill_compiles"]
    assert st["blocks_used"] == 0 and st["cross_arena"]["rows_used"] == 0
    assert st["eager_decode_steps"] == st["steps"]
    eng.backend.arena.check_invariant()
    if mode in ("greedy_preempt", "overlap"):
        assert st["preemptions"] >= 1
    if mode == "shared":
        assert st["cross_arena"]["shared_hits"] >= 2
    if mode == "frame_buckets":
        assert {k[2] for k in eng.backend._prefill_shapes} == {8, 16}


def test_engine_writes_a_shared_arena_row_once(wh, monkeypatch):
    """A request whose features' arena row is resident shares the row
    and its admission does not rewrite it (its write goes to the null
    row): that admission encodes at its own batch bucket, and the live
    request reads the row meanwhile."""
    _, _, _, _, tm, tparams = wh
    writes = []
    pack = paged_kv.pack_cross_arena

    def spy(arena, cross_kv, arena_ids):
        writes.append(arena_ids.tolist())
        return pack(arena, cross_kv, arena_ids)

    monkeypatch.setattr(paged_kv, "pack_cross_arena", spy)
    feats = np.random.default_rng(3).normal(size=(12, 64)).astype(
        np.float32)
    eng = Engine(tm, tparams, EngineConfig(num_slots=2, block_size=4,
                                           num_blocks=17, max_len=32),
                 device="cpu")
    first = eng.add_request([1, 2, 3], SamplingParams(max_tokens=6),
                            encoder_features=feats)
    eng.step()
    row = int(eng.backend.arena_ids[0])
    cross = {n: t[:, row].clone()
             for n, t in eng.backend.pools["cross"].items()}
    eng.add_request([4, 5, 6, 7, 8], SamplingParams(max_tokens=3),
                    encoder_features=feats)
    eng.step()
    assert writes == [[row], [paged_kv.NULL_ARENA]]
    assert list(eng.backend.arena_ids) == [row, row]
    for n, t in eng.backend.pools["cross"].items():
        assert torch.equal(t[:, row], cross[n]), n
    eng.drain()
    st = eng.stats()["cross_arena"]
    assert st["shared_hits"] == 1 and st["rows_used"] == 0
    assert first.finished


def _olmo_engine():
    model = Model(get_config("olmo_1b").smoke(), device="cpu")
    return Engine(model, model.init(seed=0), EngineConfig(max_len=32),
                  device="cpu")


REFUSALS = {
    # name: (error, match, call on the whisper engine / model)
    "features_on_decoder_only": (ValueError, r"dense/olmo-1b-smoke", None),
    "features_beside_request": (ValueError, "inside the Request", None),
    "no_features": (ValueError, r"audio/whisper-base-smoke",
                    lambda e, f: e.add_request([1, 2, 3])),
    "features_wrong_width": (ValueError, "d_model",
                             lambda e, f: e.add_request(
                                 [1, 2, 3], encoder_features=f[:, :63])),
    "features_too_long": (ValueError, "encoder_len",
                          lambda e, f: e.add_request(
                              [1, 2, 3], encoder_features=np.zeros(
                                  (17, 64), np.float32))),
    "static_backend": (ValueError, "paged backend", dict(backend="static")),
    "speculative": (ValueError, "decoder-only", dict(spec_tokens=2)),
    "quantized_pool": (ValueError, "quantized_kv", dict(kv_dtype="int8")),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_engine_refuses_what_jax_refuses(wh, case):
    """``check_request`` and the backend gates raise JAX's error kinds
    with JAX's messages (the config named as family/name)."""
    _, _, _, _, tm, tparams = wh
    err, match, call = REFUSALS[case]
    feats = np.zeros((4, 64), np.float32)
    with pytest.raises(err, match=match):
        if case == "features_on_decoder_only":
            _olmo_engine().add_request([1, 2, 3], encoder_features=feats)
        elif case == "features_beside_request":
            _olmo_engine().add_request(Request([1, 2, 3]),
                                       SamplingParams(max_tokens=2))
        elif isinstance(call, dict):
            Engine(tm, tparams, EngineConfig(max_len=32, **call),
                   device="cpu")
        else:
            call(Engine(tm, tparams, EngineConfig(max_len=32),
                        device="cpu"), feats)
