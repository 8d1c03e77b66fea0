"""whisper_base under tensor parallelism, and ``overlap=True`` under a
mesh, against the JAX package on the CPU.

As in ``test_torch_tp.py``, the oracle is what the reference's contract
makes it, "tokens are mesh-independent": JAX's single-device ``Engine``
(its own sharded path fails under this jax). The layout is held to
JAX's specs on an ``AbstractMesh``, which needs no devices.

  1. the plan of whisper_base: at full width (8 q / 8 kv heads) its
     attention splits by heads at T = 2, 4 and 8, and its vocabulary
     (51865) stays whole; at smoke size (4 / 2) by heads at T = 2 and by
     query heads over a replicated KV at T = 4; 3 collectives a decoder
     layer a step, plus the vocabulary's where it divides T;
  2. its paged tree's specs (the self pool, the cross arena split by kv
     heads where they divide T) equal JAX's ``encdec.paged_cache_specs``
     at T = 2 and 4, f32 and bf16;
  3. ``shard_params`` round-trips the whole enc-dec tree, and a leaf the
     plan keeps whole (``wk`` / ``wv`` of every attention, the cross
     projections too, under ``kv_replicated``) is whole on every rank;
  4. one T = 2 and one T = 4 gloo group, spawned once for the module
     while JAX's single-device engines run: whisper's engine (a
     preempting pool; a feature array shared three times) gives JAX's
     tokens and counters (``cross_arena`` and the admission shapes
     included) on every rank, each rank holds exactly its spec slice of
     the pool and arena, and a step runs the plan's collectives; the
     masked encoder and a decoder layer's cross-attention on each rank
     equal JAX's (1e-5: f32 summation order inside the column-sliced
     products and across the ranks' partial sums);
  5. ``overlap=True`` at T = 2 for olmo_1b, recurrentgemma_2b,
     h2o_danube_3_4b, xlstm_1_3b, qwen3_moe_30b_a3b and whisper_base:
     tokens equal JAX's overlap-off engine's (JAX's own overlap engine is
     not reproducible on the MoE and whisper, ROADMAP queue 3), counters
     equal JAX's overlap engine's, every rank's equal, and the
     dispatch-then-harvest path is the one that ran.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import _tp_encdec_cases as ec
from repro.configs import get_config as jax_config
from repro.launch.engine import Engine as JEngine
from repro.launch.engine import EngineConfig as JEngineConfig
from repro.launch.engine import SamplingParams as JSamplingParams
from repro.launch.sharding import ShardCtx as JShardCtx
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models import paged_kv as jpaged_kv
from repro.models.model import Model as JModel
from repro.models.transformer import RunCtx as JRunCtx
from repro_torch.configs import get_config
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import sharding
from repro_torch.models import encdec, paged_kv
from repro_torch.models.model import Model

torch.set_num_threads(1)

TP_TIMEOUT_S = 300.0
JCTX = JRunCtx(kernel_mode="ref")
TOL = dict(rtol=1e-5, atol=1e-5)


def _jshard(tp):
    return JShardCtx(mesh=AbstractMesh((1, tp), ("data", "model")),
                     dp_axes=("data",))


def _mesh(tp, rank=0):
    """A mesh that only describes a shape (no process group)."""
    return meshlib.Mesh({"data": 1, "model": tp}, rank)


def _flat_jax(specs):
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(k.key for k in path): tuple(spec) for path, spec in leaves}


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _flat(sub, path + (k,)).items()}
    return {path: tree}


# -- 1. the plan --------------------------------------------------------------


@pytest.mark.parametrize("smoke,tp,attn,collectives", [
    (False, 2, "heads", 3 * 6), (False, 4, "heads", 3 * 6),
    (False, 8, "heads", 3 * 6),
    (True, 2, "heads", 3 * 2 + 2), (True, 4, "kv_replicated", 3 * 2 + 2),
])
def test_plan_of_whisper(smoke, tp, attn, collectives):
    cfg = get_config(ec.WHISPER)
    cfg = cfg.smoke() if smoke else cfg
    plans = [sharding.plan_tp(cfg, sharding.layout_ctx(_mesh(tp, r)))
             for r in range(tp)]
    plan = plans[0]
    assert plan.attn == attn and plan.mlp
    assert plan.vocab == smoke                  # 51865 does not divide T
    assert plan.step_collectives() == collectives
    assert plan.report()["plan"]["collectives_by_kind"] == {"dec": 3}
    hq = cfg.n_heads // tp
    assert [p.q_heads for p in plans] == [(r * hq, hq) for r in range(tp)]
    if attn == "kv_replicated":                # 1 q head reads 1 of 2
        assert [p.kv_heads for p in plans] == [(0, 1), (0, 1), (1, 1),
                                               (1, 1)]


# -- 2. the paged tree's specs ------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tp", [2, 4])
def test_paged_cache_specs_equal_jax(tp, dtype):
    jcfg = dataclasses.replace(jax_config(ec.WHISPER).smoke(), dtype=dtype)
    tcfg = dataclasses.replace(get_config(ec.WHISPER).smoke(), dtype=dtype)
    geo = dict(num_slots=3, num_blocks=9, block_size=4, max_len=32)
    want = _flat_jax(jencdec.paged_cache_specs(
        jcfg, jpaged_kv.PagedLayout(**geo), _jshard(tp)))
    shard = sharding.layout_ctx(_mesh(tp))
    layout = paged_kv.PagedLayout(**geo)
    got = _flat(encdec.paged_cache_specs(tcfg, layout, shard))
    assert got == want
    assert _flat(Model(tcfg, device="cpu").paged_cache_specs(
        layout, shard)) == want
    split = tp == 2                             # 2 kv heads
    assert (got[("cross", "k")][2] == "model") == split
    rank = _flat(encdec.init_paged_cache(tcfg, layout, "cpu", shard))
    whole = _flat(encdec.init_paged_cache(tcfg, layout, "cpu"))
    for path, t in whole.items():
        n = sum(a == "model" for a in got[path])
        assert rank[path].shape[3 if path[0] == "self" else 2] * tp ** n \
            == t.shape[3 if path[0] == "self" else 2]
        assert rank[path].dtype == t.dtype


# -- 3. shard_params ----------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_params_round_trips(tp):
    cfg = get_config(ec.WHISPER).smoke()
    full = Model(cfg, device="cpu").init(seed=0)
    shards = [sharding.make_shard_ctx(_mesh(tp, r), cfg)
              for r in range(tp)]
    ranks = [_flat(sharding.shard_params(full, s)) for s in shards]
    specs = _flat(sharding.param_specs(full, shards[0]))
    kept = sharding.leaf_exceptions(full, shards[0])["kept_whole"]
    sliced = 0
    for path, leaf in _flat(full).items():
        parts = [r[path] for r in ranks]
        dims = [d for d, a in enumerate(specs[path]) if a == "model"]
        whole = sharding.leaf_layout(path, shards[0]) == "whole"
        if whole or not dims:
            assert ("/".join(path) in kept) == bool(dims)
            assert all(torch.equal(p, leaf) for p in parts)
            continue
        sliced += 1
        assert torch.equal(torch.cat(parts, dim=dims[0]), leaf)
    assert sliced > 0
    want = [f"{s}/{n}" for s in ("enc/attn", "dec/attn", "dec/xattn")
            for n in ("wk", "wv")] if tp == 4 else []
    assert sorted(kept) == sorted(want)


# -- 4. whisper's engine over T = 2 and T = 4 gloo groups ---------------------


@pytest.fixture(scope="module")
def jax_weights():
    out = {}
    for arch in ec.ARCHS:
        jm = JModel(jax_config(arch).smoke())
        out[arch] = (jm, jm.init(jax.random.PRNGKey(0)))
    return out


@pytest.fixture(scope="module")
def tp_run(jax_weights):
    """Spawn the T = 2 and T = 4 groups once, each in a thread, so the
    JAX engines of the tests below run while the ranks run theirs.
    Returns a getter of the ranks' results by T (a list by rank), which
    re-raises a group's failure."""
    weights_np = {k: jax.tree.map(np.asarray, p)
                  for k, (_, p) in jax_weights.items()}
    box, threads = {}, {}

    def group(tp):
        try:
            box[tp] = meshlib.launch(ec.run_rank, tp, "cpu",
                                     args=(ec.CASES, weights_np),
                                     timeout_s=TP_TIMEOUT_S)
        except BaseException as e:          # re-raised by every reader
            box[tp] = e

    for tp in (2, 4):
        threads[tp] = threading.Thread(target=group, args=(tp,),
                                       daemon=True)
        threads[tp].start()

    def get(tp):
        threads[tp].join(TP_TIMEOUT_S + 60)
        assert tp in box, "the tp ranks did not finish"
        if isinstance(box[tp], BaseException):
            raise box[tp]
        return box[tp]

    return get


_JAX_RUNS = {}


def _jax_run(jax_weights, arch, mode, overlap=None):
    """JAX's single-device engine on a case (once a case): the case's
    own options, or ``overlap`` forced on or off."""
    key = (arch, mode, overlap)
    if key not in _JAX_RUNS:
        jm, jparams = jax_weights[arch]
        kw, prompts, samp, feats = ec.case(arch, mode, jm.cfg.vocab_size,
                                           jm.cfg.d_model)
        if overlap is not None:
            kw = dict(kw, overlap=overlap)
        eng = JEngine(jm, jparams, JEngineConfig(**kw))
        jfeats = None
        if feats is not None:                # keep the identity
            by_id = {id(f): jnp.asarray(f) for f in feats}
            jfeats = [by_id[id(f)] for f in feats]
        toks = eng.generate(prompts, [JSamplingParams(**s) for s in samp],
                            encoder_features=jfeats)
        _JAX_RUNS[key] = (toks, ec.engine_view(eng.stats()), kw)
    return _JAX_RUNS[key]


def _rank_bytes(kw, tp):
    """Bytes of a rank's slice of whisper's pool and arena by JAX's
    specs: each leaf's bytes over the axis size of each sharded dim."""
    jm = JModel(jax_config(ec.WHISPER).smoke())
    layout = jpaged_kv.PagedLayout(**{k: kw[k] for k in (
        "num_slots", "num_blocks", "block_size", "max_len")})
    tree = jax.eval_shape(lambda: jm.init_paged_cache(layout))
    specs = _flat_jax(jencdec.paged_cache_specs(jm.cfg, layout,
                                                _jshard(tp)))
    total = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        path = tuple(k.key for k in path)
        nbytes = int(np.prod(leaf.shape)) * leaf.dtype.itemsize
        total += nbytes // tp ** sum(a == "model" for a in specs[path])
    return total


WHISPER_CASES = [c for c in ec.CASES if c[2] != "overlap"]


@pytest.mark.parametrize("tp,arch,mode", WHISPER_CASES,
                         ids=[f"T{t}-{m}" for t, _, m in WHISPER_CASES])
def test_whisper_engine_equals_jax_single_device(jax_weights, tp_run, tp,
                                                 arch, mode):
    want_toks, want_stats, kw = _jax_run(jax_weights, arch, mode)
    got = [r[(tp, arch, mode)] for r in tp_run(tp)]
    toks, st, nbytes, info, _, _ = got[0]
    assert toks == want_toks
    assert st == want_stats
    assert all(g[0] == toks and g[1] == st for g in got[1:])  # every rank
    assert all(g[2] == _rank_bytes(kw, tp) for g in got)
    assert [g[3]["rank"] for g in got] == list(range(tp))
    cfg = get_config(arch).smoke()
    plan = sharding.plan_tp(cfg, sharding.layout_ctx(_mesh(tp)))
    assert info["plan"]["attn"] == plan.attn
    assert info["kv_replicated"] == (tp == 4)
    assert info["head_sharded"] == (tp == 2)
    assert info["collectives_per_step"] == plan.step_collectives() \
        == 3 * cfg.n_layers + 2
    if mode == "greedy_preempt":
        assert st["preemptions"] > 0
    else:
        assert st["cross_arena"]["shared_hits"] >= 2


def test_whisper_blocks_equal_jax(jax_weights, tp_run):
    """The masked encoder and layer 0's cross-attention on every rank of
    both groups against JAX's single-device functions on the same
    inputs; a rank projects its 1 kv head at T = 2, both at T = 4."""
    jm, jparams = jax_weights[ec.WHISPER]
    cfg = jm.cfg
    frames, lens, x = ec.block_inputs(cfg.d_model)
    enc = jencdec.encode(jparams, cfg, jnp.asarray(frames), JCTX,
                         enc_lengths=jnp.asarray(lens))
    jp = jax.tree.map(lambda t: t[0], jparams["dec"])
    xn = jlayers.apply_norm(cfg.norm, jp["lnx"], jnp.asarray(x))
    kv = jattn.encode_cross_kv(jp["xattn"], cfg, enc)
    cross = jattn.attend_cross_masked(jp["xattn"], cfg, xn, kv,
                                      jnp.asarray(lens))
    for tp in (2, 4):
        for r in tp_run(tp):
            b = r["blocks"]
            np.testing.assert_allclose(b["encode"], np.asarray(enc), **TOL)
            np.testing.assert_allclose(b["cross"], np.asarray(cross), **TOL)
            assert b["kv_heads"] == (1 if tp == 2 else 2)


# -- 5. overlap=True under a mesh ---------------------------------------------


@pytest.mark.parametrize("arch", ec.OVERLAP_ARCHS)
def test_overlap_under_a_mesh_equals_jax(jax_weights, tp_run, arch):
    want_toks, _, _ = _jax_run(jax_weights, arch, "overlap", overlap=False)
    _, want_stats, _ = _jax_run(jax_weights, arch, "overlap")
    got = [r[(2, arch, "overlap")] for r in tp_run(2)]
    toks, st, _, info, overlap, eager = got[0]
    assert toks == want_toks
    assert st == want_stats
    assert all(g[0] == toks and g[1] == st for g in got[1:])  # every rank
    assert all(g[4] for g in got) and eager == st["steps"]
    assert info["backend"] == "gloo" and not info["captured_step"]
    cfg = get_config(arch).smoke()
    plan = sharding.plan_tp(cfg, sharding.layout_ctx(_mesh(2)))
    assert info["collectives_per_step"] == plan.step_collectives()
    assert st["preemptions"] > 0
