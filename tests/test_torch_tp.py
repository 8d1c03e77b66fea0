"""Tensor-parallel serving of the port against the JAX package on the
CPU.

JAX's own sharded path is no oracle here (its multi-device tests fail
under this jax), so the port is held to what the reference's contract
makes the oracle, "tokens are mesh-independent": JAX's single-device
``Engine``.

  1. the layout rules: ``sharding.param_specs`` equals JAX's
     ``param_specs`` on an ``AbstractMesh((1, T), ("data", "model"))``
     leaf for leaf, for every config's smoke tree at T = 2 and 4 (the
     leaves ``_fit`` leaves whole included), and so do the paged pool's
     and the static cache's specs for the three dense configs;
  2. ``shard_params`` round-trips: the ranks' slices, concatenated along
     each spec's dim, give the full leaf back;
  3. one T = 2 gloo group, spawned once for the module, runs every case
     of ``_tp_cases`` (olmo_1b, yi_6b and gemma_7b smoke in f32: greedy
     with preemption, seeded, speculative with the ngram and the draft
     model drafter, int8 and fp8 pools, prefix hits with a COW copy, the
     static backend); each case's tokens and scheduling counters equal
     JAX's single-device ``Engine``'s on the same JAX weights, both
     ranks' tokens are equal, the pool (or the static cache) a rank
     holds is half the single-device one, and a decode step runs 2 L + 2
     collectives;
  4. K2 / K3's body choosers at per-rank shapes pick what they pick at
     the model's;
  5. what a mesh serves since the refusals went (``overlap=True`` for
     every family, whisper at T = 2 and 4) builds and reports its plan,
     and the refusals that stand name their ROADMAP sub-item; ``--tp``
     asking for a GPU that is not there raises before any rank starts,
     and a rank that raises makes the launcher raise within its timeout.

The JAX engines run in this process while the ranks run theirs.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import _tp_cases as cases
from repro.configs import get_config as jax_config
from repro.launch.engine import Engine as JEngine
from repro.launch.engine import EngineConfig as JEngineConfig
from repro.launch.engine import SamplingParams as JSamplingParams
from repro.launch.sharding import ShardCtx as JShardCtx
from repro.launch.sharding import batch_specs as jbatch_specs
from repro.launch.sharding import param_specs as jparam_specs
from repro.models import paged_kv as jpaged_kv
from repro.models.model import Model as JModel
from repro_torch.configs import all_configs, get_config
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import serve, sharding, train
from repro_torch.launch.engine import (DisaggregatedEngine, Engine,
                                       EngineConfig, ReplicaSet)
from repro_torch.models import paged_kv, transformer
from repro_torch.models.model import Model

torch.set_num_threads(1)

T = 2
TP_TIMEOUT_S = 300.0
ALL = [(a, m) for a in cases.ARCHS for m in cases.MODES]


def _jshard(tp):
    return JShardCtx(mesh=AbstractMesh((1, tp), ("data", "model")),
                     dp_axes=("data",))


def _mesh(tp, rank=0, data=1):
    """A mesh that only describes a shape (no process group)."""
    return meshlib.Mesh({"data": data, "model": tp}, rank)


def _flat_jax(specs):
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(k.key for k in path): tuple(spec) for path, spec in leaves}


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _flat(sub, path + (k,)).items()}
    return {path: tree}


# -- 1. layout rules ---------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", sorted(all_configs()))
def test_param_specs_equal_jax(arch, tp):
    jm = JModel(jax_config(arch).smoke())
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    want = _flat_jax(jparam_specs(shapes, _jshard(tp)))
    params = Model(get_config(arch).smoke(), device="cpu").init(seed=0)
    got = _flat(sharding.param_specs(
        params, sharding.layout_ctx(_mesh(tp))))
    assert got and got == want


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", cases.ARCHS)
def test_pool_and_cache_specs_equal_jax(arch, tp, kv_dtype):
    """The head-sharded pool (a quantized pool's scale leaves on the same
    axis) and the static backend's cache rules, against JAX's."""
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


# -- 2. shard_params ---------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", cases.ARCHS)
def test_shard_params_round_trips(arch, tp):
    full = Model(get_config(arch).smoke(), device="cpu").init(seed=0)
    ranks = [sharding.shard_params(full, sharding.layout_ctx(
        _mesh(tp, r))) for r in range(tp)]
    specs = _flat(sharding.param_specs(full, sharding.layout_ctx(
        _mesh(tp))))
    sliced = 0
    for path, leaf in _flat(full).items():
        parts = [_flat(r)[path] for r in ranks]
        dims = [d for d, a in enumerate(specs[path]) if a == "model"]
        if not dims:
            assert all(torch.equal(p, leaf) for p in parts)
            continue
        sliced += 1
        assert parts[0].shape[dims[0]] * tp == leaf.shape[dims[0]]
        assert torch.equal(torch.cat(parts, dim=dims[0]), leaf)
    assert sliced > 0


# -- 3. the engine over a T = 2 gloo group -----------------------------------


@pytest.fixture(scope="module")
def jax_weights():
    out = {}
    for arch in cases.ARCHS:
        jm = JModel(jax_config(arch).smoke())
        out[arch] = (jm, jm.init(jax.random.PRNGKey(0)))
    return out


@pytest.fixture(scope="module")
def tp_run(jax_weights):
    """Spawn the T = 2 group once, in a thread, so the JAX engines of the
    tests below run while the ranks run theirs. Returns a getter that
    waits for the ranks' results (by rank) or re-raises their failure."""
    weights_np = {a: jax.tree.map(np.asarray, p)
                  for a, (_, p) in jax_weights.items()}
    box = {}

    def run():
        try:
            box["res"] = meshlib.launch(cases.run_cases, T, "cpu",
                                        args=(ALL, weights_np),
                                        timeout_s=TP_TIMEOUT_S)
        except BaseException as e:          # re-raised by every reader
            box["err"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()

    def get():
        th.join(TP_TIMEOUT_S + 60)
        assert not th.is_alive(), "the tp ranks did not finish"
        if "err" in box:
            raise box["err"]
        return box["res"]

    return get


def _jax_run(jax_weights, arch, mode):
    jm, jparams = jax_weights[arch]
    kw, prompts, samp = cases.case(arch, mode, jm.cfg.vocab_size)
    if kw.pop("draft", False):
        kw.update(draft_model=jm, draft_params=jparams)
    eng = JEngine(jm, jparams, JEngineConfig(**kw))
    toks = eng.generate(prompts, [JSamplingParams(**s) for s in samp])
    return toks, cases.stats_view(eng.stats()), kw


def _full_bytes(arch, kw):
    """The single-device pool (or static cache) bytes of a case."""
    cfg = get_config(arch).smoke()
    if kw.get("backend") == "static":
        tree = transformer.init_cache(cfg, kw["num_slots"], kw["max_len"],
                                      torch.device("meta"))
    else:
        geo = {k: kw[k] for k in ("num_slots", "num_blocks", "block_size",
                                  "max_len")}
        layout = paged_kv.PagedLayout(**geo)
        spec = None if kw.get("kv_dtype", "bf16") == "bf16" else \
            paged_kv.make_pool_spec(cfg, layout, kv_dtype=kw["kv_dtype"])
        tree = transformer.init_paged_cache(cfg, layout, torch.device("meta"),
                                            spec)
    return paged_kv.pool_bytes(tree)


@pytest.mark.parametrize("arch,mode", ALL, ids=[f"{a}-{m}" for a, m in ALL])
def test_tp_engine_equals_jax_single_device(jax_weights, tp_run, arch, mode):
    want_toks, want_stats, kw = _jax_run(jax_weights, arch, mode)
    ranks = tp_run()
    got = [r[(arch, mode)] for r in ranks]
    toks, st, nbytes, tp = got[0]
    assert toks == want_toks
    assert st == want_stats
    assert all(g[0] == toks for g in got[1:])            # every rank
    assert all(g[1] == st for g in got[1:])
    assert nbytes * T == _full_bytes(arch, kw)
    assert [g[3]["rank"] for g in got] == list(range(T))
    assert tp["tp"] == T and tp["backend"] == "gloo"
    L = get_config(arch).smoke().n_layers
    assert tp["collectives_per_step"] == 2 * L + 2
    if mode in ("greedy_preempt", "int8"):
        assert st["preemptions"] > 0
    if mode == "prefix":
        assert st["prefix_cache"]["hits"] > 0
        assert st["prefix_cache"]["cow_copies"] > 0
    if mode != "static":
        assert tp["head_sharded"] and not tp["captured_step"]


# -- 4. K2 / K3 at per-rank shapes -------------------------------------------


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("arch", cases.ARCHS)
def test_kernel_bodies_at_rank_shapes(arch, tp):
    """``verify_body`` picks at a rank's Hq / T, Hkv / T heads what it
    picks at the model's (the group is the same: yi's is 8), for the
    verify window (spec 4: 5 rows) and a 64-row suffix; ``split_plan``
    covers the table once at the rank's kv heads."""
    cfg = get_config(arch)
    assert tp == 1 or paged_kv.head_shard_ok(cfg, tp)
    hq, hkv, D = cfg.n_heads // tp, cfg.n_kv_heads // tp, cfg.head_dim
    meta = torch.device("meta")
    pool = torch.empty((64, 16, hkv, D), dtype=torch.bfloat16, device=meta)
    full = torch.empty((64, 16, cfg.n_kv_heads, D), dtype=torch.bfloat16,
                       device=meta)
    table = torch.empty((8, 40), dtype=torch.int32, device=meta)
    for rows in (5, 64):
        q = torch.empty((8, rows, hq, D), dtype=torch.bfloat16, device=meta)
        qf = torch.empty((8, rows, cfg.n_heads, D), dtype=torch.bfloat16,
                         device=meta)
        assert pa.verify_body(q, pool, table) == \
            pa.verify_body(qf, full, table)
    bps, nsplit = pa.split_plan(8, hkv, 40, 16, 132)
    assert (nsplit - 1) * bps < 40 <= nsplit * bps


# -- 5. refusals and failures ------------------------------------------------


@pytest.fixture(scope="module")
def olmo():
    model = Model(get_config("olmo_1b").smoke(), device="cpu")
    return model, model.init(seed=0)


@pytest.mark.parametrize("arch,tp,data,extra,match", [
    # a data axis above 1 inside one engine (FSDP): still refused
    ("olmo_1b", 2, 2, {}, "sharded training"),
    # served since the refusals went: the engine builds, reports its plan
    ("olmo_1b", 2, 1, {"overlap": True}, None),
    ("recurrentgemma_2b", 2, 1, {"overlap": True}, None),
    ("h2o_danube_3_4b", 2, 1, {"overlap": True}, None),
    ("xlstm_1_3b", 2, 1, {"overlap": True}, None),
    ("qwen3_moe_30b_a3b", 2, 1, {"overlap": True}, None),
    ("whisper_base", 2, 1, {}, None),
    ("whisper_base", 4, 1, {"overlap": True}, None),
    # still refused: the VLM's frontend, xLSTM heads that do not divide T
    ("qwen2_vl_2b", 2, 1, {}, "the other families under TP"),
    ("xlstm_1_3b", 8, 1, {}, "the other families under TP"),
])
def test_engine_refusals_name_their_sub_item(arch, tp, data, extra, match):
    cfg = get_config(arch).smoke()
    model = Model(cfg, device="cpu")
    params = model.init(seed=0)
    ecfg = EngineConfig(mesh=_mesh(tp, data=data), **extra)
    if match is not None:
        with pytest.raises(NotImplementedError, match=match) as exc:
            Engine(model, params, ecfg, device="cpu")
        assert "multi-device" in str(exc.value)
        return
    st = Engine(model, params, ecfg, device="cpu").stats()
    plan = sharding.plan_tp(cfg, sharding.layout_ctx(_mesh(tp)))
    assert st["overlap"] == extra.get("overlap", False)
    assert st["tp"]["plan"] == plan.report()["plan"]
    assert st["tp"]["plan_collectives_per_step"] == plan.step_collectives()


def test_other_refusals_name_their_sub_item(olmo, tmp_path):
    model, params = olmo
    mesh = _mesh(2, data=2)
    # migration across submeshes is ported: the disaggregated engine gets
    # past its old refusal to ReplicaSet's check of the mesh, and
    # --roles with --tp reaches the launcher (no GPU here; it serves on
    # the CPU in test_torch_tp_replica.py)
    with pytest.raises(ValueError, match="only describes a shape"):
        DisaggregatedEngine(model, params, EngineConfig(), dp=2, mesh=mesh,
                            device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            serve.main(["--smoke", "--tp", "2", "--dp", "2",
                        "--roles", "prefill,decode"])
    with pytest.raises(ValueError, match="not through EngineConfig"):
        ReplicaSet(model, params, EngineConfig(mesh=mesh), dp=2,
                   device="cpu")
    assert [dict(m.shape) for m in meshlib.submeshes(mesh, 2)] == \
        [{"data": 1, "model": 2}] * 2
    assert dict(meshlib.replica_cli_mesh(2, 2).shape) == \
        {"data": 2, "model": 2}
    with pytest.raises(NotImplementedError, match="sharded training"):
        sharding.layout_ctx(_mesh(2), layout="fsdp")
    with pytest.raises(NotImplementedError, match="sharded training"):
        train.main(["--smoke", "--device", "cpu", "--tp", "2"])


def test_tp_asking_for_a_missing_gpu_raises_before_spawning():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--smoke", "--tp", "2"])
    with pytest.raises(RuntimeError, match="cuda"):
        meshlib.launch(cases.raise_on_rank1, 2, "cuda")
    assert time.monotonic() - t0 < 5.0        # no rank was started


def test_a_rank_that_raises_makes_the_launcher_raise():
    """Rank 1 raises while rank 0 waits in an all-reduce: the launcher
    re-raises rank 1's error with its traceback and terminates rank 0
    well inside the timeout."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="injected failure on rank 1"):
        meshlib.launch(cases.raise_on_rank1, 2, "cpu", timeout_s=60)
    assert time.monotonic() - t0 < 60


def test_backend_is_chosen_from_the_devices():
    assert meshlib.choose_backend("cpu", 2) == "gloo"
    want = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    assert meshlib.choose_backend("cuda", 2) == want
