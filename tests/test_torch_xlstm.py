"""The port's xLSTM (mLSTM / sLSTM) against the JAX package on the CPU:
xlstm_1_3b smoke (16 layers of seven mLSTM and one sLSTM, d_model 64,
4 heads of 16).

The chain, weakest to strongest:
  1. the pieces: the per-head group norm, log-sigmoid at the gate
     constants, the chunkwise mLSTM (with and without a start state, S a
     multiple of the chunk and not) and its step, the sLSTM cell, and the
     state a right-padded prefill carries against the exact-length
     state;
  2. the model: right-padded prefill logits and caches, their install
     into slots through ``row_of_slot`` / ``valid``, paged decode steps,
     the verify window and ``select_verify_state``; the weight bridge
     and the bf16 init tree;
  3. the Engine, token for token and counter for counter against the
     JAX Engine: greedy with preemption, seeded, speculative (ngram,
     K 3), an int8 pool, ``overlap=True`` and the static backend (fp8:
     tests/test_torch_quantized_kv.py).

Inputs are made by numpy from a seed and fed to both packages; weights
are JAX's init carried over with the weight bridge. Tolerance 1e-4 for
f32 values (summation order inside matmuls); tokens exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jax_config
from repro.launch.engine import Engine as JEngine
from repro.launch.engine import EngineConfig as JEngineConfig
from repro.launch.engine import SamplingParams as JSamplingParams
from repro.models import layers as jlayers
from repro.models import paged_kv as jpk
from repro.models import ssm as jssm
from repro.models import transformer as jtr
from repro.models.model import Model as JModel
from repro_torch.configs import get_config
from repro_torch.launch.engine import Engine, EngineConfig, SamplingParams
from repro_torch.models import layers, paged_kv, ssm, transformer, weights
from repro_torch.models.model import Model

torch.set_num_threads(1)

ARCH = "xlstm_1_3b"
JCTX = jtr.RunCtx(kernel_mode="ref")
CTX = transformer.RunCtx()
TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **{**TOL, **kw})


@pytest.fixture(scope="module")
def xl():
    jcfg, tcfg = jax_config(ARCH).smoke(), get_config(ARCH).smoke()
    jm = JModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = weights.from_jax_numpy(jax.tree.map(np.asarray, jparams),
                                     tcfg, "cpu")
    return jcfg, tcfg, jm, jparams, Model(tcfg, device="cpu"), tparams


def _mix(jparams, pk):
    """Layer 0 of pattern position ``pk``'s mixer, as JAX and as torch
    params (p0..p6 mLSTM, p7 sLSTM)."""
    jp = jax.tree.map(lambda t: t[0], jparams["groups"]["g0"][pk]["mix"])
    return jp, weights.map_tree(_t, jax.tree.map(np.asarray, jp))


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}/{k}") if isinstance(v, dict)
                   else {f"{prefix}/{k}": v})
    return out


def _gates(rng, B, H, S, hd):
    q, k, v = (rng.normal(size=(B, H, S, hd)).astype(np.float32)
               for _ in range(3))
    ig = rng.normal(size=(B, H, S)).astype(np.float32)
    fg = (rng.normal(size=(B, H, S)) + 2).astype(np.float32)
    return q, k, v, ig, fg


# -- 1. the pieces -----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_matches_jax(rng, dtype):
    """Per-head norm in f32, scale only, eps 1e-6, cast back."""
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3 + 1
    scale = rng.normal(size=(64,)).astype(np.float32)
    got = layers.group_norm(_t(x).to(getattr(torch, dtype)), _t(scale), 4)
    want = jlayers.group_norm(jnp.asarray(x, dtype), jnp.asarray(scale), 4)
    assert str(got.dtype).split(".")[-1] == dtype
    tol = {"float32": 1e-6, "bfloat16": 1e-2}[dtype]
    _close(got.float().numpy(), np.asarray(want, np.float32), rtol=tol,
           atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_log_sigmoid_at_the_gate_constants_matches_jax(dtype):
    """The values that decide whether a pad step moves the state: chunk
    padding's forget gate 30, gate freezing's +-1e30. Equal in value;
    at 1e30 torch gives +0.0 where JAX gives -0.0, which no sum in the
    scan can tell apart."""
    x = np.asarray([30.0, 1e30, -1e30, -30.0, 0.0], np.float32)
    got = F.logsigmoid(_t(x).to(getattr(torch, dtype))).float().numpy()
    want = np.asarray(jax.nn.log_sigmoid(jnp.asarray(x, dtype)),
                      np.float32)
    np.testing.assert_array_equal(got, want)


def test_three_operand_key_value_product_matches_jax(rng):
    """The chunk's carry update ``einsum("bhj,bhjd,bhje->bhde")``: the
    port weights the keys first, then contracts over j."""
    kw = rng.random((2, 3, 8)).astype(np.float32)
    k, v = (rng.normal(size=(2, 3, 8, 16)).astype(np.float32)
            for _ in range(2))
    got = (_t(kw)[..., None] * _t(k)).transpose(-1, -2) @ _t(v)
    want = jnp.einsum("bhj,bhjd,bhje->bhde", *map(jnp.asarray, (kw, k, v)))
    _close(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("start", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("S", [32, 37], ids=["whole", "ragged"])
def test_mlstm_chunkwise_matches_jax(rng, S, start):
    """Chunk 8 over S a multiple of it and not (the tail padded with
    ig -1e30, fg 30), from zeros and from a carried (C, n, m): outputs
    and the final state."""
    B, H, hd = 2, 3, 16
    arrs = _gates(rng, B, H, S, hd)
    state = None
    if start:
        state = (rng.normal(size=(B, H, hd, hd)).astype(np.float32),
                 rng.normal(size=(B, H, hd)).astype(np.float32),
                 rng.normal(size=(B, H)).astype(np.float32))
    th, tst = ssm.mlstm_chunkwise(*map(_t, arrs), chunk=8,
                                  state=None if state is None
                                  else tuple(map(_t, state)))
    jh, jst = jssm.mlstm_chunkwise(*map(jnp.asarray, arrs), chunk=8,
                                   state=None if state is None
                                   else tuple(map(jnp.asarray, state)))
    assert th.shape == (B, H, S, hd)
    _close(th.numpy(), jh)
    for got, want in zip(tst, jst):
        assert got.dtype == torch.float32
        _close(got.numpy(), want)


def test_mlstm_chunkwise_equals_its_own_stepwise(rng):
    """JAX's tests/test_consistency.py:19 on the port: the chunkwise
    form over 33 steps (not a multiple of the chunk) equals 33 single
    steps."""
    B, H, S, hd = 2, 2, 33, 8
    q, k, v, ig, fg = map(_t, _gates(rng, B, H, S, hd))
    h_chunk, (C, n, m) = ssm.mlstm_chunkwise(q, k, v, ig, fg, chunk=8)
    state = ssm._mlstm_init_state(B, H, hd, "cpu")
    hs = []
    for t in range(S):
        h_t, state = ssm.mlstm_step(q[:, :, t], k[:, :, t], v[:, :, t],
                                    ig[:, :, t], fg[:, :, t], state)
        hs.append(h_t)
    _close(h_chunk.numpy(), torch.stack(hs, dim=2).numpy(), atol=1e-5)
    _close(C.numpy(), state[0].numpy(), atol=1e-5)


def test_mlstm_step_and_slstm_cell_match_jax(rng, xl):
    """Six single steps of ``mlstm_step`` and of the sLSTM cell (with
    the smoke model's recurrent matrix and bias) from the initial
    states: outputs and every state leaf."""
    jcfg, tcfg, _, jparams, _, _ = xl
    B, H, hd = 3, 4, 16
    tst = ssm._mlstm_init_state(B, H, hd, "cpu")
    jst = tuple(jnp.asarray(t.numpy()) for t in tst)
    jp, tp = _mix(jparams, "p7")
    sinit = ssm.init_slstm_cache(tcfg, B, torch.float32, "cpu")
    sst = tuple(sinit[n] for n in ("h", "c", "n", "m"))
    jsst = tuple(jnp.asarray(t.numpy()) for t in sst)
    r, b = tp["r_zifo"].float(), tp["b_zifo"].float()
    for step in range(6):
        q, k, v = (rng.normal(size=(B, H, hd)).astype(np.float32)
                   for _ in range(3))
        ig = rng.normal(size=(B, H)).astype(np.float32)
        fg = (rng.normal(size=(B, H)) + 2).astype(np.float32)
        th, tst = ssm.mlstm_step(*map(_t, (q, k, v, ig, fg)), tst)
        jh, jst = jssm.mlstm_step(*map(jnp.asarray, (q, k, v, ig, fg)), jst)
        _close(th.numpy(), jh, err_msg=f"mlstm step {step}")
        for got, want in zip(tst, jst):
            _close(got.numpy(), want, err_msg=f"mlstm step {step}")
        xp = rng.normal(size=(B, 4 * jcfg.d_model)).astype(np.float32)
        th, sst = ssm.slstm_cell(tcfg, _t(xp), sst, r, b)
        jh, jsst = jssm._slstm_cell(jp, jcfg, jnp.asarray(xp), jsst)
        _close(th.numpy(), jh, err_msg=f"slstm step {step}")
        for got, want in zip(sst, jsst):
            _close(got.numpy(), want, err_msg=f"slstm step {step}")


@pytest.mark.parametrize("pk,kind", [("p0", "mlstm"), ("p7", "slstm")])
def test_padded_prefill_state_matches_exact_and_jax(rng, xl, pk, kind):
    """Rows of 1, 9 and 20 real tokens right-padded to 20: the block's
    output at real positions and the carried state equal JAX's padded
    prefill, and each row's exact-length prefill alone (the mLSTM by
    gate freezing, the sLSTM by carry selection; the conv tail rebuilt
    from the real inputs)."""
    jcfg, tcfg, _, jparams, _, _ = xl
    jp, tp = _mix(jparams, pk)
    tf = {"mlstm": transformer._mlstm_with_cache,
          "slstm": transformer._slstm_with_cache}[kind]
    jf = {"mlstm": jtr._mlstm_with_cache, "slstm": jtr._slstm_with_cache}[kind]
    xn = rng.normal(size=(3, 20, jcfg.d_model)).astype(np.float32)
    length = np.asarray([1, 9, 20], np.int32)
    tout, tc = tf(tp, tcfg, _t(xn), _t(length))
    jout, jc = jf(jp, jcfg, jnp.asarray(xn), length=jnp.asarray(length))
    assert tc.keys() == jc.keys()
    for name in tc:
        _close(tc[name].numpy(), jc[name], err_msg=name)
    for r, n in enumerate(length):
        _close(tout[r, :n].numpy(), np.asarray(jout)[r, :n])
        eout, ec = tf(tp, tcfg, _t(xn[r:r + 1, :n]))
        _close(tout[r, :n].numpy(), eout[0].numpy(), atol=1e-5)
        for name in tc:
            _close(tc[name][r].numpy(), ec[name][0].numpy(), atol=1e-5,
                   err_msg=f"row {r} {name}")


# -- 2. the model ------------------------------------------------------------


def test_prefill_install_and_paged_decode_match_jax(rng, xl):
    """Right-padded prefill of rows 3, 9 and 21 tokens long (chunk 8:
    the chunk tail and the pad tail both stay out of the state),
    installed into 4 slots through ``row_of_slot`` / ``valid`` (slot 2
    invalid: its initial state must survive the filler row 0), then 4
    paged decode steps: logits at real positions and every per-slot
    leaf agree with JAX after the install and after each step."""
    jcfg, tcfg, jm, jparams, tm, tparams = xl
    toks = np.zeros((3, 32), np.int32)
    lens = np.asarray([3, 9, 21], np.int32)
    for r, n in enumerate(lens):
        toks[r, :n] = rng.integers(0, jcfg.vocab_size, n)
    jl, jdense = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, JCTX,
                            max_len=32, length=jnp.asarray(lens))
    tl, tdense = tm.prefill(tparams, {"tokens": _t(toks)}, CTX, max_len=32,
                            length=_t(lens))
    for r, n in enumerate(lens):
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

    def check_state(when):
        jleaves = _leaves(jax.tree.map(np.asarray, jpools))
        tleaves = _leaves(tpools)
        assert jleaves.keys() == tleaves.keys()
        for path, want in jleaves.items():
            got = tleaves[path]
            assert str(got.dtype).split(".")[-1] == str(want.dtype), path
            _close(got.numpy(), want, err_msg=f"{when} {path}")

    check_state("install")
    fresh = _leaves(tm.init_paged_cache(tlay))
    for path, t in _leaves(tpools).items():
        assert torch.equal(t[:, 2], fresh[path][:, 2]), path
    table = np.zeros((4, 16), np.int32)
    length = lens[row_of_slot] * valid
    tok = rng.integers(0, jcfg.vocab_size, (4, 1)).astype(np.int32)
    for step in range(4):
        jlog, jpools = jm.decode_step_paged(
            jparams, jpools, jnp.asarray(table), jnp.asarray(length),
            jnp.asarray(tok), JCTX)
        tlog, out = tm.decode_step_paged(
            tparams, tpools, _t(table), _t(length), _t(tok), CTX)
        assert out is tpools
        _close(tlog.numpy(), jlog, err_msg=f"decode step {step}")
        check_state(f"step {step}")
        tok = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)
        length = length + 1


def test_decode_verify_selects_state_as_jax(rng, xl):
    """A 4-token verify window over the mLSTM / sLSTM states after a
    prefill: tokens, the committed states against JAX's
    ``decode_verify_paged`` (``select_verify_state``), and the state
    after ``commit`` plain decode steps; the window scans a copy, so the
    committed state is all that moves."""
    jcfg, tcfg, jm, jparams, tm, tparams = xl
    toks = rng.integers(0, jcfg.vocab_size, (3, 16)).astype(np.int32)
    lens = np.asarray([5, 16, 11], np.int32)
    geo = dict(num_slots=3, num_blocks=25, block_size=4, max_len=32)
    jlay, tlay = jpk.PagedLayout(**geo), paged_kv.PagedLayout(**geo)
    slots, valid = np.arange(3, dtype=np.int32), np.ones(3, bool)
    ids = np.zeros((3, 4), np.int32)
    _, jdense = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, JCTX,
                           max_len=16, length=jnp.asarray(lens))
    _, tdense = tm.prefill(tparams, {"tokens": _t(toks)}, CTX, max_len=16,
                           length=_t(lens))
    jpools = jm.pack_prefill_into_paged(
        jlay, jm.init_paged_cache(jlay), jdense, jnp.asarray(slots),
        jnp.asarray(valid), jnp.asarray(ids))

    def install():
        return tm.pack_prefill_into_paged(
            tlay, tm.init_paged_cache(tlay), tdense, _t(slots), _t(valid),
            _t(ids))

    tpools = install()
    window = rng.integers(0, jcfg.vocab_size, (3, 4)).astype(np.int32)
    commit = np.asarray([1, 4, 2], np.int32)
    table = np.zeros((3, 8), np.int32)
    jout, _, jpools2 = jm.decode_verify(
        jparams, jpools, jnp.asarray(table), jnp.asarray(lens),
        jnp.asarray(window),
        lambda lg: (jnp.argmax(lg, -1).astype(jnp.int32),
                    jnp.asarray(commit)), JCTX)
    tout, _, tpools2 = tm.decode_verify(
        tparams, tpools, _t(table), _t(lens), _t(window),
        lambda lg: (lg.argmax(-1).int(), _t(commit)), CTX)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    want = _leaves(jax.tree.map(np.asarray, jpools2))
    for path, t in _leaves(tpools2).items():
        _close(t.numpy(), want[path], err_msg=path)
    ref = install()
    steps = [weights.map_tree(torch.clone, ref)]
    for j in range(4):
        _, ref = tm.decode_step_paged(tparams, ref, _t(table), _t(lens + j),
                                      _t(window[:, j:j + 1]), CTX)
        steps.append(weights.map_tree(torch.clone, ref))
    for b, c in enumerate(commit):
        after = _leaves(steps[c])
        for path, t in _leaves(tpools2).items():
            _close(t[:, b].numpy(), after[path][:, b].numpy(), atol=1e-5,
                   err_msg=f"slot {b} {path}")


def test_bridge_and_bf16_init_tree_match_jax(xl):
    """The bridge carries the mLSTM / sLSTM trees leaf for leaf; the
    port's bf16 init (smoke, and one layer of each kind at full width:
    the sLSTM FFN 2752 wide) has JAX's ``eval_shape`` tree, shapes and
    dtypes; its states stay f32 beside a bf16 conv tail."""
    jcfg, tcfg, _, jparams, _, tparams = xl
    jl = _leaves(jax.tree.map(np.asarray, jparams))
    tl = _leaves(tparams)
    assert jl.keys() == tl.keys()
    for path, want in jl.items():
        np.testing.assert_array_equal(tl[path].numpy(), want, err_msg=path)
    bcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    mine = _leaves(Model(bcfg, device="cpu").init(seed=0))
    jshapes = _leaves(jax.eval_shape(lambda: JModel(dataclasses.replace(
        jcfg, dtype="bfloat16")).init(jax.random.PRNGKey(0))))
    full_t, full_j = get_config(ARCH), jax_config(ARCH)
    assert ssm.slstm_ffn_width(full_t.d_model) == 2752
    gen = torch.Generator().manual_seed(0)
    for kind in ("mlstm", "slstm"):
        block = transformer.init_block(gen, full_t, kind, torch.bfloat16, 1)
        mine.update(_leaves(block, f"/full/{kind}"))
        jshapes.update(_leaves(jax.eval_shape(
            lambda kind=kind: jax.tree.map(lambda t: t[None],
                                           jtr.init_block(
                                               jax.random.PRNGKey(0), full_j,
                                               kind, jnp.bfloat16))),
            f"/full/{kind}"))
    assert mine.keys() == jshapes.keys()
    for path, s in jshapes.items():
        assert tuple(mine[path].shape) == s.shape, path
        assert str(mine[path].dtype).split(".")[-1] == str(s.dtype), path
    lay = paged_kv.PagedLayout(num_slots=2, num_blocks=5, block_size=4,
                               max_len=16)
    pools = Model(bcfg, device="cpu").init_paged_cache(lay)["g0"]
    for name in ("C", "n", "m"):
        assert pools["p0"][name].dtype == torch.float32
    assert pools["p0"]["conv"].dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in pools["p7"].values())


# -- 3. the Engine -----------------------------------------------------------


GEO = dict(num_slots=3, block_size=4, num_blocks=14, max_len=64)
PAGED_STATS = ("steps", "preemptions", "prefill_calls", "prefill_reqs",
               "prefill_tokens", "blocks_used", "bucketed_prefill")
STATIC_STATS = ("steps", "batches", "mean_active_slots", "cache_utilization",
                "prefill_compiles")
MODES = {
    "greedy": ({}, None),
    "seeded": ({}, dict(temperature=0.9, top_k=30, top_p=0.95)),
    "spec3": ({"spec_tokens": 3}, None),
    "int8": ({"kv_dtype": "int8"}, None),
    "overlap": ({"overlap": True}, None),
    "static": ({"backend": "static"}, None),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_matches_jax_engine(rng, xl, mode):
    """Five prompts of 6-20 tokens, 12-16 new each, on three slots and 13
    usable blocks (the paged pool preempts): the port's Engine and the
    JAX Engine in the same mode give equal tokens and equal scheduler
    counters, and no block leaks."""
    _, _, jm, jparams, tm, tparams = xl
    kw, samp = MODES[mode]
    prompts = [list(map(int, rng.integers(0, 256, n)))
               for n in (9, 14, 20, 6, 17)]
    sps = [SamplingParams(max_tokens=16 if mode == "greedy" else 12,
                          **({**samp, "seed": s} if samp else {}))
           for s in range(len(prompts))]
    jsps = [JSamplingParams(**dataclasses.asdict(sp)) for sp in sps]
    jeng = JEngine(jm, jparams, JEngineConfig(**{"backend": "paged", **GEO,
                                                 **kw}))
    want = jeng.generate(prompts, jsps)
    eng = Engine(tm, tparams, EngineConfig(**GEO, **kw), device="cpu")
    got = eng.generate(prompts, sps)
    assert got == want
    jst, st = jeng.stats(), eng.stats()
    for k in (STATIC_STATS if mode == "static" else PAGED_STATS):
        assert st[k] == jst[k], k
    if mode == "static":
        return
    assert st["blocks_used"] == 0
    assert st["prefix_cache"]["enabled"] is False \
        is jst["prefix_cache"]["enabled"]
    if mode == "greedy":
        assert st["preemptions"] >= 1
    if mode == "spec3":
        assert st["spec"]["accepted"] == jst["spec"]["accepted"]
