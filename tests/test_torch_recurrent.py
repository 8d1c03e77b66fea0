"""The port's recurrent and windowed slice against the JAX package on the
CPU: recurrentgemma_2b (RG-LRU + local attention) and h2o_danube_3_4b
(sliding-window attention).

The chain, weakest to strongest:
  1. the plain version of kernel K5 (``kernels/ref.linear_scan``,
     reached through ``ops.rglru_scan`` on CPU tensors) equals JAX's
     Pallas kernel in interpret mode and its associative-scan oracle;
  2. rings and recurrent state: ``ring_from_prefill``, the windowed
     ``decode_attend_batched`` over enough steps to wrap the ring, the
     causal conv and its carry, the RG-LRU prefill state at the true
     length and its decode step;
  3. the model: right-padded prefill logits, the install of per-slot
     state through ``row_of_slot`` / ``valid``, then paged decode steps;
  4. the Engine, token for token against the JAX Engine: greedy with
     preemption and wrapped rings, seeded (threefry), speculative (ngram,
     K 3) and over int8 / fp8 pools, with the scheduler's counters equal.

Inputs are made by numpy from a seed and fed to both packages; weights
are JAX's init carried over with the weight bridge. Tolerances: K5's
1e-5 (JAX's own, tests/test_kernels.py), 1e-4 for f32 model outputs
(summation order inside matmuls and softmax), exact for gathers.
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
from repro.launch.engine import SamplingParams as JSamplingParams
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import paged_kv as jpk
from repro.models import ssm as jssm
from repro.models import transformer as jtr
from repro.models.model import Model as JModel
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as k5_mod
from repro_torch.launch.engine import Engine, EngineConfig, SamplingParams
from repro_torch.models import attention, layers, paged_kv, ssm
from repro_torch.models import transformer, weights
from repro_torch.models.model import Model

torch.set_num_threads(1)

ARCHS = ("recurrentgemma_2b", "h2o_danube_3_4b")
JCTX = jtr.RunCtx(kernel_mode="ref")
CTX = transformer.RunCtx()
TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _models(arch):
    jcfg, tcfg = jax_config(arch).smoke(), get_config(arch).smoke()
    jm = JModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = weights.from_jax_numpy(jax.tree.map(np.asarray, jparams),
                                     tcfg, "cpu")
    return jcfg, tcfg, jm, jparams, Model(tcfg, device="cpu"), tparams


@pytest.fixture(scope="module")
def rg():
    return _models("recurrentgemma_2b")


def _layer0(jparams, pk, part):
    """Layer 0 of pattern position ``pk``'s ``part`` subtree, as JAX and
    as torch params."""
    jp = jax.tree.map(lambda t: t[0], jparams["groups"]["g0"][pk][part])
    return jp, weights.map_tree(_t, jax.tree.map(np.asarray, jp))


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **{**TOL, **kw})


# -- 1. K5's plain version ---------------------------------------------


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("B,T,D", [(3, 100, 40), (2, 64, 128), (1, 17, 5)])
def test_rglru_scan_plain_matches_jax(rng, B, T, D, with_h0):
    """tests/test_kernels.py's shapes: the port's sequential f32 scan
    against the Pallas kernel body in interpret mode and against JAX's
    associative-scan oracle, with and without a carried-in state."""
    a = (0.8 + 0.2 * rng.random((B, T, D))).astype(np.float32)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    h0 = rng.normal(size=(B, D)).astype(np.float32) if with_h0 else None
    n0 = k5_mod.rglru_scan.launches
    got = ops.rglru_scan(_t(a), _t(x), None if h0 is None else _t(h0))
    assert k5_mod.rglru_scan.launches == n0       # the CPU never launches
    assert got.dtype == torch.float32 and got.shape == (B, T, D)
    jh0 = None if h0 is None else jnp.asarray(h0)
    kern = jops.rglru_scan(jnp.asarray(a), jnp.asarray(x), jh0, block_b=2,
                           block_t=16, block_d=16, mode="interpret")
    oracle = jref.linear_scan(jnp.asarray(a), jnp.asarray(x), jh0)
    _close(got, kern, rtol=1e-5, atol=1e-5)
    _close(got, oracle, rtol=1e-5, atol=1e-5)


def test_rglru_scan_bf16_keeps_an_f32_carry(rng):
    """bf16 in, bf16 out, the carry in f32: each step's output is the f32
    scan rounded once, never a bf16 recurrence."""
    a = (0.8 + 0.2 * rng.random((2, 40, 24))).astype(np.float32)
    x = rng.normal(size=(2, 40, 24)).astype(np.float32)
    ab, xb = _t(a).bfloat16(), _t(x).bfloat16()
    got = ops.rglru_scan(ab, xb)
    want = ops.rglru_scan(ab.float(), xb.float()).bfloat16()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


# -- 2. rings and recurrent state ----------------------------------------


def test_ring_from_prefill_matches_jax(rng):
    """Right-padded rows shorter than, equal to and past the ring (the
    last wraps twice): the ring is JAX's exactly."""
    kv = rng.normal(size=(4, 40, 2, 16)).astype(np.float32)
    length = np.asarray([3, 16, 37, 1], np.int32)
    got = attention.ring_from_prefill(_t(kv), 16, _t(length))
    want = jattn.ring_from_prefill(jnp.asarray(kv), 16, jnp.asarray(length))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch,pk", [("h2o_danube_3_4b", "p0"),
                                     ("recurrentgemma_2b", "p2")])
def test_windowed_decode_matches_jax(rng, arch, pk):
    """44 decode steps over a 16-row ring from per-slot start positions
    0, 5 and 13: every output and the ring after every step agree with
    JAX's ``decode_attend_batched`` as the rings wrap."""
    jcfg, tcfg, _, jparams, _, _ = _models(arch)
    jp, tp = _layer0(jparams, pk, "attn")
    window = jtr._window_for(jcfg, "attn" if arch.startswith("h2o")
                             else "local")
    B, size = 3, 16
    jcache = jattn.init_kv_cache(jcfg, B, 64, jnp.float32, window=window)
    tcache = attention.init_kv_cache(tcfg, B, 64, torch.float32, "cpu",
                                     window=window)
    assert tcache["k"].shape == (B, size, tcfg.n_kv_heads, tcfg.head_dim)
    pos = np.asarray([0, 5, 13], np.int32)
    for step in range(44):
        x = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
        jout, jcache = jattn.decode_attend_batched(
            jp, jcfg, jnp.asarray(x), jcache, jnp.asarray(pos),
            window=window)
        tout, tcache = attention.decode_attend_batched(
            tp, tcfg, _t(x), tcache, _t(pos), window=window)
        _close(tout.numpy(), jout, err_msg=f"step {step}")
        for n in ("k", "v"):
            _close(tcache[n].numpy(), jcache[n])
        pos = pos + 1


def test_conv1d_and_its_state_match_jax(rng, rg):
    """The causal depthwise conv from zeros and from a carried tail, and
    the carry rebuilt at a right-padded length (rows shorter than the
    kernel are zero-prefixed), against JAX."""
    _, _, _, jparams, _, _ = rg
    jp, tp = _layer0(jparams, "p0", "rec")
    jconv, tconv = jp["conv"], tp["conv"]
    x = rng.normal(size=(3, 12, 64)).astype(np.float32)
    state = rng.normal(size=(3, 3, 64)).astype(np.float32)
    for st in (None, state):
        ty, ts = layers.apply_conv1d(tconv, _t(x),
                                     None if st is None else _t(st))
        jy, js = jlayers.apply_conv1d(jconv, jnp.asarray(x),
                                      None if st is None
                                      else jnp.asarray(st))
        _close(ty.numpy(), jy, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    length = np.asarray([1, 2, 12], np.int32)
    got = layers.conv_state_at(_t(x), 4, _t(length))
    want = jlayers.conv_state_at(jnp.asarray(x), 4, jnp.asarray(length))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rglru_prefill_state_and_decode_match_jax(rng, rg):
    """``_rglru_with_cache`` on right-padded rows (the carry gathered at
    the true length, the conv tail rebuilt from the real inputs), the
    block's delta, and then eight ``apply_rglru_decode`` steps continuing
    from that state, against JAX; ``h`` stays f32."""
    jcfg, tcfg, _, jparams, _, _ = rg
    jp, tp = _layer0(jparams, "p0", "rec")
    xn = rng.normal(size=(3, 20, jcfg.d_model)).astype(np.float32)
    length = np.asarray([1, 9, 20], np.int32)
    tout, tc = transformer._rglru_with_cache(tp, tcfg, _t(xn), _t(length))
    jout, jc = jtr._rglru_with_cache(jp, jcfg, jnp.asarray(xn), JCTX,
                                     jnp.asarray(length))
    _close(tout.numpy(), jout)
    for n in ("h", "conv"):
        _close(tc[n].numpy(), jc[n])
    assert tc["h"].dtype == torch.float32
    _close(ssm.apply_rglru_block(tp, tcfg, _t(xn)).numpy(),
           jssm.apply_rglru_block(jp, jcfg, jnp.asarray(xn),
                                  kernel_mode="ref"))
    for step in range(8):
        x = rng.normal(size=(3, 1, jcfg.d_model)).astype(np.float32)
        tout, tc = ssm.apply_rglru_decode(tp, tcfg, _t(x), tc)
        jout, jc = jssm.apply_rglru_decode(jp, jcfg, jnp.asarray(x), jc)
        _close(tout.numpy(), jout, err_msg=f"step {step}")
        for n in ("h", "conv"):
            _close(tc[n].numpy(), jc[n])


# -- 3. the model ------------------------------------------------------


def _slot_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_slot_leaves(v, f"{prefix}/{k}") if isinstance(v, dict)
                   else {f"{prefix}/{k}": v})
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_install_and_paged_decode_match_jax(rng, arch):
    """Right-padded prefill of rows 3, 9 and 21 tokens long (the last
    wraps the 16-row ring), installed into 4 slots through
    ``row_of_slot`` / ``valid`` (slot 2 invalid: its zero state must
    survive the filler row 0), then 8 paged decode steps: logits at
    every step and every per-slot leaf agree with JAX."""
    jcfg, tcfg, jm, jparams, tm, tparams = _models(arch)
    toks = np.zeros((3, 32), np.int32)
    lens = np.asarray([3, 9, 21], np.int32)
    for r, n in enumerate(lens):
        toks[r, :n] = rng.integers(0, jcfg.vocab_size, n)
    jl, jdense = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, JCTX,
                            max_len=32, length=jnp.asarray(lens))
    tl, tdense = tm.prefill(tparams, {"tokens": _t(toks)}, CTX, max_len=32,
                            length=_t(lens))
    for r, n in enumerate(lens):                # real positions only
        _close(tl[r, :n].numpy(), np.asarray(jl)[r, :n])
    row_of_slot = np.asarray([2, 0, 0, 1], np.int32)
    valid = np.asarray([True, True, False, True])
    geo = dict(num_slots=4, num_blocks=33, block_size=4, max_len=64)
    jlay, tlay = jpk.PagedLayout(**geo), paged_kv.PagedLayout(**geo)
    ids = np.zeros((3, 8), np.int32)
    jpools = jm.pack_prefill_into_paged(
        jlay, jm.init_paged_cache(jlay), jdense, jnp.asarray(row_of_slot),
        jnp.asarray(valid), jnp.asarray(ids))
    tpools = tm.pack_prefill_into_paged(
        tlay, tm.init_paged_cache(tlay), tdense, _t(row_of_slot),
        _t(valid), _t(ids))

    def check_state():
        jleaves = _slot_leaves(jax.tree.map(np.asarray, jpools))
        tleaves = _slot_leaves(tpools)
        assert jleaves.keys() == tleaves.keys()
        for path, want in jleaves.items():
            got = tleaves[path]
            assert str(got.dtype).split(".")[-1] == str(want.dtype), path
            _close(got.numpy(), want, err_msg=path)

    check_state()
    assert not any(t[:, 2].any() for t in _slot_leaves(tpools).values())
    table = np.zeros((4, 16), np.int32)
    length = lens[row_of_slot] * valid
    tok = rng.integers(0, jcfg.vocab_size, (4, 1)).astype(np.int32)
    for step in range(8):
        jlog, jpools = jm.decode_step_paged(
            jparams, jpools, jnp.asarray(table), jnp.asarray(length),
            jnp.asarray(tok), JCTX)
        tlog, tpools = tm.decode_step_paged(
            tparams, tpools, _t(table), _t(length), _t(tok), CTX)
        _close(tlog.numpy(), jlog, err_msg=f"decode step {step}")
        check_state()
        tok = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)
        length = length + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_verify_selects_state_as_jax(rng, arch):
    """A 4-token verify window over per-slot state, after a prefill:
    logits, the accept rule's commit and the committed rings / carries
    agree with JAX's ``decode_verify_paged``, and equal the state after
    ``commit`` plain decode steps."""
    jcfg, tcfg, jm, jparams, tm, tparams = _models(arch)
    toks = rng.integers(0, jcfg.vocab_size, (3, 16)).astype(np.int32)
    lens = np.asarray([5, 16, 11], np.int32)
    geo = dict(num_slots=3, num_blocks=25, block_size=4, max_len=32)
    jlay, tlay = jpk.PagedLayout(**geo), paged_kv.PagedLayout(**geo)
    slots, valid, ids = np.arange(3, dtype=np.int32), np.ones(3, bool), \
        np.zeros((3, 4), np.int32)
    _, jdense = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, JCTX,
                           max_len=16, length=jnp.asarray(lens))
    _, tdense = tm.prefill(tparams, {"tokens": _t(toks)}, CTX, max_len=16,
                           length=_t(lens))
    jpools = jm.pack_prefill_into_paged(
        jlay, jm.init_paged_cache(jlay), jdense, jnp.asarray(slots),
        jnp.asarray(valid), jnp.asarray(ids))
    tpools = tm.pack_prefill_into_paged(
        tlay, tm.init_paged_cache(tlay), tdense, _t(slots), _t(valid),
        _t(ids))
    window = rng.integers(0, jcfg.vocab_size, (3, 4)).astype(np.int32)
    commit = np.asarray([1, 4, 2], np.int32)
    table = np.zeros((3, 8), np.int32)

    def jcommit(logits):
        return jnp.argmax(logits, -1).astype(jnp.int32), jnp.asarray(commit)

    def tcommit(logits):
        return logits.argmax(-1).int(), _t(commit)

    jout, _, jpools2 = jm.decode_verify(
        jparams, jpools, jnp.asarray(table), jnp.asarray(lens),
        jnp.asarray(window), jcommit, JCTX)
    tout, _, tpools2 = tm.decode_verify(
        tparams, tpools, _t(table), _t(lens), _t(window), tcommit, CTX)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    jl, tl = (_slot_leaves(jax.tree.map(np.asarray, jpools2)),
              _slot_leaves(tpools2))
    for path, want in jl.items():
        _close(tl[path].numpy(), want, err_msg=path)
    # the committed state is the state after commit[b] plain decode steps
    ref = tm.pack_prefill_into_paged(
        tlay, tm.init_paged_cache(tlay), tdense, _t(slots), _t(valid),
        _t(ids))
    def clone(tree):
        return weights.map_tree(torch.clone, tree)

    steps = [clone(ref)]
    for j in range(4):
        _, ref = tm.decode_step_paged(tparams, ref, _t(table),
                                      _t(lens + j), _t(window[:, j:j + 1]),
                                      CTX)
        steps.append(clone(ref))
    for b, c in enumerate(commit):
        want = _slot_leaves(steps[c])
        for path, t in _slot_leaves(tpools2).items():
            _close(t[:, b].numpy(), want[path][:, b].numpy(),
                   err_msg=f"slot {b} {path}")


def test_bridge_and_init_keep_lam_f32(rg):
    """``lam`` and the RG-LRU carry stay f32 in a bf16 model: the bridge's
    cast leaves ``lam`` alone, the torch init draws it f32, and the
    paged state keeps ``h`` f32 beside a bf16 conv tail; the init's tree
    is JAX's leaf for leaf."""
    jcfg, tcfg, _, jparams, _, _ = rg
    bf = weights.from_jax_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu", dtype=torch.bfloat16)
    rec = bf["groups"]["g0"]["p0"]["rec"]
    assert rec["lam"].dtype == torch.float32
    assert rec["w_a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        rec["lam"].numpy(),
        np.asarray(jparams["groups"]["g0"]["p0"]["rec"]["lam"]))
    bcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    tm = Model(bcfg, device="cpu")
    mine = _slot_leaves(tm.init(seed=0))
    jshapes = _slot_leaves(jax.eval_shape(lambda: JModel(
        dataclasses.replace(jcfg, dtype="bfloat16")).init(
            jax.random.PRNGKey(0))))
    assert mine.keys() == jshapes.keys()
    for path, s in jshapes.items():
        assert tuple(mine[path].shape) == s.shape, path
        assert str(mine[path].dtype).split(".")[-1] == str(s.dtype), path
    lay = paged_kv.PagedLayout(num_slots=2, num_blocks=5, block_size=4,
                               max_len=16)
    state = tm.init_paged_cache(lay)["g0"]["p0"]
    assert state["h"].dtype == torch.float32
    assert state["conv"].dtype == torch.bfloat16


# -- 4. the Engine -------------------------------------------------------


GEO = dict(num_slots=3, block_size=4, num_blocks=14, max_len=64)
STAT_KEYS = ("steps", "preemptions", "prefill_calls", "prefill_reqs",
             "prefill_tokens", "blocks_used", "bucketed_prefill")


def _prompts(rng, vocab, lens=(9, 14, 20, 6, 17)):
    return [list(map(int, rng.integers(0, vocab, n))) for n in lens]


def _both(arch, prompts, sps, **kw):
    """The same requests through the JAX Engine and the port's, same
    geometry and weights. Returns (jax tokens, port tokens, jax stats,
    port stats)."""
    _, _, jm, jparams, tm, tparams = _models(arch)
    jsp = [JSamplingParams(**dataclasses.asdict(sp)) for sp in sps]
    jeng = JEngine(jm, jparams, JEngineConfig(backend="paged", **GEO, **kw))
    want = jeng.generate(prompts, jsp)
    eng = Engine(tm, tparams, EngineConfig(**GEO, **kw), device="cpu")
    got = eng.generate(prompts, sps)
    return want, got, jeng.stats(), eng.stats()


def _check_stats(jst, tst):
    for k in STAT_KEYS:
        assert tst[k] == jst[k], k
    assert tst["bucketed_prefill"] is True
    assert tst["prefix_cache"]["enabled"] is False \
        is jst["prefix_cache"]["enabled"]
    assert tst["blocks_used"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_matches_jax_engine(rng, arch):
    """Five prompts of 6-20 tokens, 16 new each, three slots and 13
    usable blocks: the pool preempts, every ring wraps (window 16), and
    the tokens and scheduler counters equal the JAX Engine's."""
    prompts = _prompts(rng, 256)
    sps = [SamplingParams(max_tokens=16)] * len(prompts)
    want, got, jst, tst = _both(arch, prompts, sps)
    assert got == want
    _check_stats(jst, tst)
    assert tst["preemptions"] >= 1


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_seeded_matches_jax_engine(rng, arch):
    """Seeded sampling (threefry, temperature 0.9, top-k 30, top-p 0.95):
    the JAX Engine's tokens."""
    prompts = _prompts(rng, 256)
    sps = [SamplingParams(max_tokens=12, temperature=0.9, top_k=30,
                          top_p=0.95, seed=s) for s in range(len(prompts))]
    want, got, jst, tst = _both(arch, prompts, sps)
    assert got == want
    _check_stats(jst, tst)


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_engine_matches_jax_engine(rng, arch):
    """``spec_tokens=3`` with the ngram drafter on repetitive prompts
    (tests/test_spec_decode.py:181): the verify window scans the decode
    cell over rings and carries, and the tokens equal the JAX
    speculative engine's and the port's plain engine's."""
    prompts = [(list(rng.integers(0, 256, 3)) * 6)[:10 + i]
               for i in range(4)] + _prompts(rng, 256, (7, 12))
    sps = [SamplingParams(max_tokens=12)] * len(prompts)
    want, got, jst, tst = _both(arch, prompts, sps, spec_tokens=3)
    assert got == want
    assert tst["blocks_used"] == 0
    assert tst["spec"]["accepted"] == jst["spec"]["accepted"] > 0
    _, _, _, _, tm, tparams = _models(arch)
    plain = Engine(tm, tparams, EngineConfig(**GEO), device="cpu")
    assert plain.generate(prompts, sps) == got


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_engine_matches_jax_engine(rng, rg, kv_dtype):
    """``kv_dtype`` int8 / fp8 on recurrentgemma
    (tests/test_quantized_kv.py:245): no layer has a pool, the rings and
    carries stay full precision, and the tokens equal the JAX engine's
    and the bf16 engine's."""
    prompts = _prompts(rng, 256)
    sps = [SamplingParams(max_tokens=12)] * len(prompts)
    want, got, jst, tst = _both("recurrentgemma_2b", prompts, sps,
                                kv_dtype=kv_dtype)
    assert got == want
    _check_stats(jst, tst)
    assert tst["kv_dtype"] == kv_dtype
    _, _, _, _, tm, tparams = rg
    eng = Engine(tm, tparams, EngineConfig(**GEO), device="cpu")
    assert eng.generate(prompts, sps) == got


def test_draft_model_refuses_a_recurrent_draft(rg):
    """A recurrent draft model cannot roll back by pointer rewind: the
    draft-model drafter refuses it, as JAX's does
    (tests/test_spec_decode.py:400)."""
    _, _, _, jparams, tm, tparams = rg
    tcfg = get_config("olmo_1b").smoke()
    target = Model(tcfg, device="cpu")
    draft = Model(dataclasses.replace(tm.cfg, vocab_size=tcfg.vocab_size),
                  device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        Engine(target, target.init(seed=0), EngineConfig(
            **GEO, spec_tokens=2, drafter="draft_model", draft_model=draft,
            draft_params=tparams), device="cpu")


def test_xlstm_target_with_a_draft_model_matches_jax(rng):
    """xlstm_1_3b, refused until its slice, as the target of the
    draft-model drafter (an attention-only olmo_1b draft, which JAX
    allows for a recurrent target): the verify window scans the mLSTM /
    sLSTM cells and the tokens equal the JAX speculative engine's and
    the port's plain engine's."""
    _, _, jm, jparams, tm, tparams = _models("xlstm_1_3b")
    _, _, jdm, jdparams, dm, dparams = _models("olmo_1b")
    prompts = [(list(rng.integers(0, 256, 3)) * 6)[:10 + i]
               for i in range(3)]
    sps = [SamplingParams(max_tokens=10)] * len(prompts)
    jsp = [JSamplingParams(**dataclasses.asdict(sp)) for sp in sps]
    kw = dict(spec_tokens=3, drafter="draft_model")
    want = JEngine(jm, jparams, JEngineConfig(
        backend="paged", **GEO, **kw, draft_model=jdm,
        draft_params=jdparams)).generate(prompts, jsp)
    eng = Engine(tm, tparams, EngineConfig(**GEO, **kw, draft_model=dm,
                                           draft_params=dparams),
                 device="cpu")
    got = eng.generate(prompts, sps)
    assert got == want
    assert eng.stats()["blocks_used"] == 0
    plain = Engine(tm, tparams, EngineConfig(**GEO), device="cpu")
    assert plain.generate(prompts, sps) == got
