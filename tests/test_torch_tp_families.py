"""Tensor-parallel serving of the recurrent, windowed, xLSTM and MoE
decoders, and of the replicated-KV fallback, against the JAX package on
the CPU.

As in ``test_torch_tp.py``, the oracle is what the reference's contract
makes it, "tokens are mesh-independent": JAX's single-device
``Engine`` (its own sharded path fails under this jax). The layout is
held to JAX's specs on an ``AbstractMesh``, which needs no devices.

  1. the plan (``sharding.plan_tp``): what each config runs per block at
     T = 2 and 4, and the refusals that still stand;
  2. the pool and per-slot cache specs of every new family equal JAX's
     ``paged_cache_specs`` / ``batch_specs`` at T = 2 and 4 (an int8
     pool's scale leaves included);
  3. ``shard_params`` round-trips: the ranks' slices, the head-aligned
     leaves' parts put back in order, give the full leaf; a leaf the
     plan keeps whole is whole on every rank; ``init_lm(keep=)``, which
     slices as it draws (``init_rank_params``), equals ``shard_params``
     of the whole tree drawn the same way;
  4. one T = 2 and one T = 4 gloo group, spawned once for the module
     while JAX's single-device engines run: every case of
     ``_tp_family_cases`` (recurrentgemma_2b, h2o_danube_3_4b,
     xlstm_1_3b, qwen3_moe_30b_a3b and kimi_k2_1t_a32b smoke at T = 2:
     greedy with preemption, seeded, speculative ngram, int8 for the MoE
     pools, static for recurrentgemma and qwen3, and qwen3 at its full
     top-8 routing (16 experts, where smoke routes top-2); yi_6b and
     recurrentgemma_2b at T = 4, the replicated-KV fallback, and a
     2-head recurrentgemma whose attention runs whole) gives JAX's
     tokens and scheduling counters on both ranks, each rank holds
     exactly its spec slice of the pool and state, and a step runs the
     plan's collectives;
  5. the blocks alone: the RG-LRU, mLSTM and sLSTM blocks (prefill with
     their state, then a decode step) and ``moe.apply_moe_sharded`` on
     each rank of the T = 2 group against JAX's single-device block on
     the same inputs, the MoE at top-2 and top-8 (tolerance 1e-5: f32
     summation order inside the column-sliced products and across the
     ranks' partial sums);
  6. K2 and K3 over a replicated pool whose rank's q heads start past kv
     head 0, in their plain versions, against JAX's decode / verify
     attention on all the heads; K5's body at a rank's channels.
"""

import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import _tp_family_cases as fc
from repro.configs import get_config as jax_config
from repro.kernels import ref as jref
from repro.launch.engine import Engine as JEngine
from repro.launch.engine import EngineConfig as JEngineConfig
from repro.launch.engine import SamplingParams as JSamplingParams
from repro.launch.sharding import ShardCtx as JShardCtx
from repro.launch.sharding import batch_specs as jbatch_specs
from repro.models import moe as jmoe
from repro.models import paged_kv as jpaged_kv
from repro.models import transformer as jtr
from repro.models.model import Model as JModel
from repro_torch.configs import all_configs, get_config
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import rglru_scan
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import sharding
from repro_torch.models import paged_kv, transformer
from repro_torch.models.model import Model

torch.set_num_threads(1)

TP_TIMEOUT_S = 300.0
FAMILIES = tuple(fc.FAMILY_MODES)
JCTX = jtr.RunCtx(kernel_mode="ref")


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


def _plan(arch, tp, smoke=False):
    cfg = get_config(arch)
    cfg = cfg.smoke() if smoke else cfg
    return sharding.plan_tp(cfg, sharding.layout_ctx(_mesh(tp)))


# -- 1. the plan --------------------------------------------------------------


@pytest.mark.parametrize("arch,tp,attn,experts,collectives", [
    ("recurrentgemma_2b", 2, "kv_replicated", 0, 2 + 18 * 3 + 8 * 2),
    ("recurrentgemma_2b", 4, "whole", 0, 2 + 18 * 3 + 8 * 1),
    ("h2o_danube_3_4b", 4, "heads", 0, 2 + 24 * 2),
    ("xlstm_1_3b", 4, "none", 0, 2 + 42 * 2 + 6 * 2),
    ("qwen3_moe_30b_a3b", 4, "heads", 32, 2 + 48 * 2),
    ("kimi_k2_1t_a32b", 2, "heads", 192, 2 + 61 * 2),
    ("yi_6b", 4, "heads", 0, 2 + 32 * 2),
])
def test_plan_of_each_family(arch, tp, attn, experts, collectives):
    """The plan chosen from which dimensions divide T, at full width:
    recurrentgemma's one kv head is read whole by each rank's 5 query
    heads at T = 2 and its 10 heads run whole at T = 4; a rank holds
    E / T experts; a decode step runs the counted collectives."""
    plan = _plan(arch, tp)
    assert plan.attn == attn
    assert plan.experts[1] == experts or (experts == 0 and not plan.moe)
    assert plan.step_collectives() == collectives
    if attn == "kv_replicated":
        assert plan.kv_heads == (0, 1) and plan.q_heads[1] == 5


def test_plan_ranges_and_refusals():
    """A rank's q heads and the kv heads they read (yi smoke at T = 4:
    rank 3's one q head reads kv head 1 of 2), its experts; the
    encoder-decoder is planned by heads (whisper_base's 8 / 8 at T = 2
    and 4: 3 collectives a decoder layer, its 51865-token vocabulary
    whole), and so is every other config the port serves."""
    cfg = get_config("yi_6b").smoke()
    plans = [sharding.plan_tp(cfg, sharding.layout_ctx(_mesh(4, r)))
             for r in range(4)]
    assert [p.q_heads for p in plans] == [(0, 1), (1, 1), (2, 1), (3, 1)]
    assert [p.kv_heads for p in plans] == [(0, 1), (0, 1), (1, 1), (1, 1)]
    qwen = get_config("qwen3_moe_30b_a3b")
    assert [sharding.plan_tp(qwen, sharding.layout_ctx(
        _mesh(4, r))).experts for r in range(4)] == \
        [(0, 32), (32, 32), (64, 32), (96, 32)]
    for arch in sorted(all_configs()):
        for tp in (2, 4):
            shard = sharding.layout_ctx(_mesh(tp))
            cfg = get_config(arch)
            if cfg.enc_dec:
                plan = sharding.plan_tp(cfg, shard)
                assert plan.attn == "heads" and not plan.vocab
                assert plan.step_collectives() == 3 * cfg.n_layers
            elif not cfg.visual_prefix:
                sharding.plan_tp(cfg, shard)


def test_whole_vocabulary_needs_no_collective():
    """A vocabulary that does not divide T stays whole (JAX's ``_fit``):
    the embedding is a plain gather and the head's logits are whole on
    every rank, with no collective (none is counted)."""
    import dataclasses

    from repro_torch.models import layers

    cfg = dataclasses.replace(get_config("olmo_1b").smoke(), vocab_size=250)
    shard = sharding.make_shard_ctx(_mesh(4, 1), cfg)
    assert not shard.plan.vocab
    assert shard.plan.step_collectives() == 2 * cfg.n_layers
    full = Model(cfg, device="cpu").init(seed=0)
    table = sharding.shard_params(full, shard)["embed"]
    assert torch.equal(table, full["embed"])
    tokens = torch.tensor([[0, 249, 7]], dtype=torch.int32)
    assert torch.equal(layers.vocab_parallel_lookup(table, tokens, shard),
                       full["embed"][tokens.long()])
    x = torch.randn(1, 3, 250)
    assert layers.tp_gather_vocab(x, shard) is x
    assert shard.stats.collectives == 0


# -- 2. pool and per-slot cache specs -----------------------------------------


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", FAMILIES)
def test_pool_and_cache_specs_equal_jax(arch, tp, kv_dtype):
    jcfg, tcfg = jax_config(arch).smoke(), get_config(arch).smoke()
    geo = dict(num_slots=3, num_blocks=9, block_size=4, max_len=32)
    jlayout, layout = jpaged_kv.PagedLayout(**geo), paged_kv.PagedLayout(**geo)
    jspec = tspec = None
    if kv_dtype != "bf16":
        jspec = jpaged_kv.make_pool_spec(jcfg, jlayout, kv_dtype=kv_dtype)
        tspec = paged_kv.make_pool_spec(tcfg, layout, kv_dtype=kv_dtype)
    jm, shard = JModel(jcfg), sharding.layout_ctx(_mesh(tp))
    want = _flat_jax(jm.paged_cache_specs(jlayout, _jshard(tp), spec=jspec))
    got = _flat(transformer.paged_cache_specs(tcfg, layout, shard, tspec))
    assert got == want
    jcache = jax.eval_shape(lambda: jm.init_cache(3, 32))
    meta = transformer.init_cache(tcfg, 3, 32, torch.device("meta"))
    assert _flat(sharding.batch_specs(meta, shard)) == \
        _flat_jax(jbatch_specs(jcache, _jshard(tp)))


# -- 3. shard_params ----------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", FAMILIES + ("yi_6b",))
def test_shard_params_round_trips(arch, tp):
    cfg = get_config(arch).smoke()
    full = Model(cfg, device="cpu").init(seed=0)
    shards = [sharding.make_shard_ctx(_mesh(tp, r), cfg)
              for r in range(tp)]
    ranks = [_flat(sharding.shard_params(full, s)) for s in shards]
    specs = _flat(sharding.param_specs(full, shards[0]))
    leaves = sharding.leaf_exceptions(full, shards[0])
    seen = {"whole": 0, "head_aligned": 0, "sliced": 0}
    for path, leaf in _flat(full).items():
        parts = [r[path] for r in ranks]
        how = sharding.leaf_layout(path, shards[0])
        dims = [d for d, a in enumerate(specs[path]) if a == "model"]
        if how == "head_aligned":
            seen["head_aligned"] += 1
            assert "/".join(path) in leaves["head_aligned"]
            n = sharding.HEAD_ALIGNED_PARTS[path[-1]]
            back = torch.cat([p.unflatten(-1, (n, -1)) for p in parts],
                             dim=-1).flatten(-2)
            assert torch.equal(back, leaf)
        elif how == "whole" or not dims:
            seen["whole"] += bool(dims)
            assert ("/".join(path) in leaves["kept_whole"]) == bool(dims)
            assert all(torch.equal(p, leaf) for p in parts)
        else:
            seen["sliced"] += 1
            assert parts[0].shape[dims[0]] * tp == leaf.shape[dims[0]]
            assert torch.equal(torch.cat(parts, dim=dims[0]), leaf)
    assert seen["sliced"] > 0
    assert (seen["head_aligned"] > 0) == (arch == "xlstm_1_3b")
    plan = shards[0].plan
    assert (seen["whole"] > 0) == (plan.attn in ("kv_replicated", "whole"))


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", FAMILIES + ("yi_6b",))
def test_init_rank_params_equals_sliced_init(arch, tp):
    """A rank's slices kept as ``init_lm`` draws (each drawn block and
    top-level leaf cut by ``shard_params`` on its own partial tree) equal
    ``shard_params`` of the whole tree drawn the same way, leaf by leaf
    on every rank: ``init_rank_params`` (a layer at a time) against its
    own whole tree, and the stacked draw against ``model.init``. The
    same values, and the same specs on a partial tree as on the whole
    one."""
    cfg = get_config(arch).smoke()
    model = Model(cfg, device="cpu")
    whole = {"per_layer": sharding.init_rank_params(model, 3),
             "stacked": model.init(seed=3)}
    for r in range(tp):
        shard = sharding.make_shard_ctx(_mesh(tp, r), cfg)

        def keep(tree, shard=shard):
            return dict(sharding.shard_params(tree, shard))

        kept = {"per_layer": sharding.init_rank_params(model, 3, shard),
                "stacked": transformer.init_lm(
                    torch.Generator().manual_seed(3), cfg, keep=keep)}
        assert isinstance(kept["per_layer"], sharding.RankSlices)
        for how, full in whole.items():
            want = _flat(sharding.shard_params(full, shard))
            got = _flat(kept[how])
            assert got.keys() == want.keys()
            for path, leaf in want.items():
                assert got[path].dtype == leaf.dtype, (how, path)
                assert torch.equal(got[path], leaf), (how, path)


# -- 4. the engine over T = 2 and T = 4 gloo groups ---------------------------


def _jax_model(arch, mode=""):
    return JModel(fc.smoke_config(jax_config, arch, mode))


@pytest.fixture(scope="module")
def jax_weights():
    out = {}
    for _, arch, mode in fc.CASES:
        key = fc.weights_key(arch, mode)
        if key not in out:
            jm = _jax_model(arch, mode)
            out[key] = (jm, jm.init(jax.random.PRNGKey(0)))
    return out


@pytest.fixture(scope="module")
def tp_run(jax_weights):
    """Spawn the T = 2 and T = 4 groups once, each in a thread, so the
    JAX engines of the tests below run while the ranks run theirs; the
    T = 2 group also runs the blocks alone. Returns a getter of the
    ranks' results by T (each a list by rank), which re-raises a
    group's failure."""
    weights_np = {k: jax.tree.map(np.asarray, p)
                  for k, (_, p) in jax_weights.items()}
    box, threads = {}, {}

    def group(tp):
        try:
            box[tp] = meshlib.launch(_rank, tp, "cpu",
                                     args=(fc.CASES, weights_np),
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


def _rank(mesh, cases, weights_np):
    out = fc.run_family_cases(mesh, cases, weights_np)
    if mesh.shape["model"] == 2:
        out["blocks"] = fc.run_blocks(mesh, weights_np)
    return out


_JAX_RUNS = {}


def _jax_run(jax_weights, arch, mode):
    """JAX's single-device engine on a case (the same at T = 2 and 4:
    run once)."""
    if (arch, mode) not in _JAX_RUNS:
        _JAX_RUNS[(arch, mode)] = _jax_engine(jax_weights, arch, mode)
    return _JAX_RUNS[(arch, mode)]


def _jax_engine(jax_weights, arch, mode):
    jm, jparams = jax_weights[fc.weights_key(arch, mode)]
    kw, prompts, samp = fc.case(arch, mode, jm.cfg.vocab_size)
    eng = JEngine(jm, jparams, JEngineConfig(**kw))
    toks = eng.generate(prompts, [JSamplingParams(**s) for s in samp])
    return toks, fc.stats_view(eng.stats()), kw


def _rank_bytes(arch, mode, kw, tp):
    """The bytes of a rank's slice of the pool (or the static cache) by
    JAX's specs: each leaf's bytes over the axis size of each of its
    sharded dims."""
    jm = _jax_model(arch, mode)
    if kw.get("backend") == "static":
        tree = jax.eval_shape(lambda: jm.init_cache(kw["num_slots"],
                                                    kw["max_len"]))
        specs = jbatch_specs(tree, _jshard(tp))
    else:
        geo = {k: kw[k] for k in ("num_slots", "num_blocks", "block_size",
                                  "max_len")}
        layout = jpaged_kv.PagedLayout(**geo)
        spec = None if kw.get("kv_dtype", "bf16") == "bf16" else \
            jpaged_kv.make_pool_spec(jm.cfg, layout, kv_dtype=kw["kv_dtype"])
        tree = jax.eval_shape(lambda: jm.init_paged_cache(layout, spec))
        specs = jm.paged_cache_specs(layout, _jshard(tp), spec=spec)
    specs, total, full = _flat_jax(specs), 0, 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        path = tuple(k.key for k in path)
        nbytes = int(np.prod(leaf.shape)) * leaf.dtype.itemsize
        full += nbytes
        total += nbytes // tp ** sum(a == "model" for a in specs[path])
    return total, full


@pytest.mark.parametrize("tp,arch,mode", fc.CASES,
                         ids=[f"T{t}-{a}-{m}" for t, a, m in fc.CASES])
def test_tp_family_engine_equals_jax_single_device(jax_weights, tp_run, tp,
                                                    arch, mode):
    want_toks, want_stats, kw = _jax_run(jax_weights, arch, mode)
    got = [r[(tp, arch, mode)] for r in tp_run(tp)]
    toks, st, nbytes, info = got[0]
    assert toks == want_toks
    assert st == want_stats
    assert all(g[0] == toks for g in got[1:])             # every rank
    assert all(g[1] == st for g in got[1:])
    rank_bytes, full_bytes = _rank_bytes(arch, mode, kw, tp)
    assert all(g[2] == rank_bytes for g in got)
    if (tp, arch) != (4, "yi_6b"):        # yi's pool is whole at T = 4
        assert rank_bytes < full_bytes
    assert [g[3]["rank"] for g in got] == list(range(tp))
    assert info["tp"] == tp and info["backend"] == "gloo"
    cfg = fc.smoke_config(get_config, arch, mode)
    plan = sharding.plan_tp(cfg, sharding.layout_ctx(_mesh(tp)))
    rows = kw.get("spec_tokens", 0) + 1
    assert info["collectives_per_step"] == plan.step_collectives(rows)
    assert info["plan_collectives_per_step"] == plan.step_collectives()
    assert info["experts_local"] == plan.experts[1]
    if cfg.is_moe:
        assert info["experts_local"] * tp == cfg.n_experts
    assert info["kv_replicated"] == (plan.attn == "kv_replicated")
    if mode in ("greedy_preempt", "int8"):
        assert st["preemptions"] > 0
    if mode == "whole_attn":
        assert info["plan"]["attn"] == "whole"
        assert any(p.endswith("attn/wq") for p in info["kept_whole"])


# -- 5. the blocks alone ------------------------------------------------------


@pytest.mark.parametrize("arch,kind,mode", fc.BLOCKS,
                         ids=["-".join(filter(None, b)) for b in fc.BLOCKS])
def test_sharded_block_equals_jax_block(jax_weights, tp_run, arch, kind,
                                        mode):
    jm, jparams = jax_weights[fc.weights_key(arch, mode)]
    cfg = jm.cfg
    x, length, x1 = fc.block_inputs(cfg.d_model)
    jp = jax.tree.map(lambda a: a[0],
                      jparams["groups"]["g0"][fc.pattern_key(cfg, kind)])
    got = [r["blocks"][(arch, kind, mode)] for r in tp_run(2)]
    tol = dict(rtol=1e-5, atol=1e-5)
    if kind == "moe":
        want, _ = jmoe.apply_moe(jp["moe"], cfg, x, dropless=True)
        for g in got:
            np.testing.assert_allclose(g["y"], np.asarray(want), **tol)
        return
    pos = np.arange(x.shape[1], dtype=np.int32)
    y, _, cache = jtr.apply_block(jp, cfg, kind, x, pos, JCTX,
                                  with_cache=True, cache_len=x.shape[1],
                                  prefill_length=length)
    y1, cache1 = jtr.apply_block_decode(jp, cfg, kind, x1, cache, length,
                                        JCTX)
    for g in got:
        np.testing.assert_allclose(g["y"], np.asarray(y), **tol)
        np.testing.assert_allclose(g["y1"], np.asarray(y1), **tol)
    for name, dim in fc.STATE_DIM[kind].items():
        for stage, want in (("prefill", cache), ("decode", cache1)):
            parts = [g[f"{stage}_{name}"] for g in got]
            assert parts[0].shape[dim] * 2 == np.asarray(want[name]).shape[dim]
            np.testing.assert_allclose(np.concatenate(parts, axis=dim),
                                       np.asarray(want[name]), **tol)


# -- 6. K2 / K3 over a kv-head range, K5's body at rank shapes ----------------


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("mode", ["decode", "verify"])
def test_paged_attention_kv_range_equals_jax(mode, kv_dtype):
    """yi smoke at T = 4 (4 q heads over 2 kv heads, a rank one q head):
    rank 3's q head reads kv head 1, past kv head 0, of the pool every
    rank holds whole. The headshard wrapper's plain version on that q
    head and range equals JAX's attention over all the heads, at that
    head."""
    rng = np.random.default_rng(3)
    B, K1, Hq, Hkv, D, NB, BS = 3, 4, 4, 2, 16, 12, 4
    table = rng.permutation(np.arange(1, NB))[:B * 3].reshape(B, 3)
    table = table.astype(np.int32)
    lengths = np.array([5, 9, 2], np.int32)
    q = rng.standard_normal((B, K1, Hq, D)).astype(np.float32)
    k = rng.standard_normal((NB, BS, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((NB, BS, Hkv, D)).astype(np.float32)
    scales = {}
    if kv_dtype:
        spec = jpaged_kv.PoolSpec(kv_dtype=kv_dtype, block_size=BS,
                                  n_kv_heads=Hkv, head_dim=D)
        (k, ks), (v, vs) = (jpaged_kv.quantize_kv(t, spec) for t in (k, v))
        k, v = np.asarray(k), np.asarray(v)
        scales = dict(k_scale=np.asarray(ks), v_scale=np.asarray(vs))
    if mode == "decode":
        qd = q[:, 0]
        want = jref.paged_decode_attention(qd, k, v, table, lengths,
                                           **scales)
        fn = pa.paged_decode_attention_headshard
    else:
        qd = q
        want = jref.paged_verify_attention(qd, k, v, table, lengths,
                                           **scales)
        fn = pa.paged_verify_attention_headshard
    shard = sharding.make_shard_ctx(_mesh(4, 3),
                                    get_config("yi_6b").smoke())
    assert shard.plan.kv_heads == (1, 1)
    got = fn(torch.from_numpy(qd[..., 3:4, :].copy()), torch.from_numpy(k),
             torch.from_numpy(v), torch.from_numpy(table),
             torch.from_numpy(lengths), shard=shard,
             kv_heads=shard.plan.kv_heads,
             **{n: torch.from_numpy(a) for n, a in scales.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[..., 3:4, :],
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="outside a pool"):
        fn(torch.from_numpy(qd[..., 3:4, :].copy()), torch.from_numpy(k),
           torch.from_numpy(v), torch.from_numpy(table),
           torch.from_numpy(lengths), shard=shard, kv_heads=(2, 1),
           **{n: torch.from_numpy(a) for n, a in scales.items()})


@pytest.mark.parametrize("shape", [(8, 512, 1280), (2, 2560, 1280)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_body_at_rank_channels(shape, dtype):
    """K5 takes a rank's contiguous (B, S, 2560 / 2) a and b on its ring
    body, as the whole width does; a strided channel view of the whole
    would not be 16-byte aligned past its first rank."""
    meta = torch.device("meta")
    a = torch.empty(shape, dtype=dtype, device=meta)
    assert rglru_scan.body(a, a) == "ring"
    whole = torch.empty(shape[:2] + (2 * shape[2],), dtype=dtype, device=meta)
    assert rglru_scan.body(whole, whole) == "ring"
