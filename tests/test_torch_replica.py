"""The port's replica layer against the JAX package on the CPU:
``ReplicaSet``, ``DisaggregatedEngine`` and KV migration on one device.

  1. ``core.noc`` equals JAX's transfer-time functions on a grid, given
     JAX's own fabric figures (the port's ``FabricSpec`` has no default);
     ``paged_pool_mask`` equals JAX's for every config's smoke;
  2. ``paged_kv.extract_blocks`` / ``insert_blocks`` equal JAX's bit for
     bit on the same pools (olmo, olmo int8, recurrentgemma, whisper),
     the gather lands in storage of its own, the scatter writes in place,
     and ``payload_bytes`` equals JAX's count;
  3. ``ReplicaSet(dp=2)`` paged, static and with a per-replica
     ``spec_tokens`` override: tokens equal JAX's single ``Engine``,
     ``dispatched`` equals JAX's ``ReplicaSet``;
  4. ``DisaggregatedEngine``: olmo with a forced steal (also with
     ``overlap=True`` and an int8 pool) and recurrentgemma, tokens equal
     JAX's ``Engine``, migration counters, ``bytes_moved`` and, given
     JAX's fabric figures, ``fabric_s`` equal JAX's
     ``DisaggregatedEngine``; whisper against JAX with overlap off; xlstm
     against the port's own ``Engine`` (held to JAX in
     test_torch_xlstm.py);
  5. a mid-migration cancel, decode-side preemption and the full-hit
     rewind leak nothing; the refusals: a ``kv_format`` mismatch, role
     validation, a mesh through ``EngineConfig`` or one with no group.

Weights are JAX's init carried over with the weight bridge; prompts come
from numpy with a seed. Tokens and counters are compared exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import noc as jnoc
from repro.launch.engine import DisaggregatedEngine as JDisagg
from repro.launch.engine import Engine as JEngine
from repro.launch.engine import EngineConfig as JEngineConfig
from repro.launch.engine import ReplicaSet as JReplicaSet
from repro.launch.engine import SamplingParams as JSamplingParams
from repro.launch.engine import transport as jtransport
from repro.models import paged_kv as jpaged_kv
from repro.models.model import Model as JModel
from repro_torch import tree
from repro_torch.configs import all_configs, get_config
from repro_torch.core import noc
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import serve
from repro_torch.launch.engine import (DisaggregatedEngine, Engine,
                                       EngineConfig, ReplicaSet,
                                       SamplingParams, transport)
from repro_torch.models import paged_kv, weights
from repro_torch.models.model import Model

torch.set_num_threads(1)

GEO = dict(num_slots=3, block_size=4, num_blocks=33, max_len=48)
BIG = dict(GEO, max_len=64, num_blocks=65)
V5E = noc.FabricSpec(**dataclasses.asdict(jnoc.V5E_FABRIC))


def _first(rset, cands):
    """Pile every placement onto the first candidate (forces a steal)."""
    return cands[0]


@pytest.fixture(scope="module")
def pairs():
    """(JAX model, JAX params, port model, port params) per arch."""
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


def _work(vocab, seed=0, max_tokens=6, n=6):
    """Ragged prompts in one prefill bucket (each JAX replica compiles
    every admission shape it meets: one bucket keeps that to a few), with
    greedy and seeded rows. Returns (prompts, port sampling params, JAX
    sampling params)."""
    rng = np.random.default_rng(seed)
    prompts = [list(map(int, rng.integers(0, vocab, L)))
               for L in (5, 7, 8, 6, 8, 7)[:n]]
    kw = [dict(), dict(temperature=0.9, top_k=12, seed=3),
          dict(temperature=1.0, top_p=0.85, seed=5), dict(),
          dict(temperature=0.7, seed=11), dict()][:n]
    return (prompts, [SamplingParams(max_tokens=max_tokens, **k) for k in kw],
            [JSamplingParams(max_tokens=max_tokens, **k) for k in kw])


def _feats(d_model, n, seed=0):
    """Encoder features for whisper: one array a request, requests 1 and
    2 on the same array (one arena row)."""
    rng = np.random.default_rng(seed)
    feats = [rng.standard_normal((f, d_model), dtype=np.float32)
             for f in (5, 16, 9, 12, 7, 16)[:n]]
    feats[2] = feats[1]
    return feats


def _assert_no_leaks(engine):
    for eng in engine.replicas:
        be = eng.backend
        assert be.alloc.free_count == be.layout.usable_blocks, \
            (be.alloc.free_count, be.layout.usable_blocks)
        be.alloc.check_invariant()
        if be.arena is not None:
            assert be.arena.used_count == 0


# -- 1. noc and the pool mask -------------------------------------------


@pytest.mark.parametrize("fn", ["all_reduce_time", "all_gather_time",
                                "reduce_scatter_time", "all_to_all_time"])
@pytest.mark.parametrize("axis", ["data", "model", "pod"])
def test_collective_times_match_jax(fn, axis):
    for nbytes in (0.0, 1.0, 4096.0, 3.5e9):
        for n in (1, 2, 3, 8, 64):
            assert getattr(noc, fn)(nbytes, n, axis, V5E) == \
                getattr(jnoc, fn)(nbytes, n, axis, jnoc.V5E_FABRIC)


def test_p2p_interleave_and_table_match_jax():
    for axis in ("data", "pod"):
        for nbytes in (0.0, 1.0, 1.5e6, 2e9):
            for hops in (-1, 0, 1, 2, 7):
                assert noc.p2p_time(nbytes, hops, axis, V5E) == \
                    jnoc.p2p_time(nbytes, hops, axis, jnoc.V5E_FABRIC)
    for mode in ("line", "block"):
        for addr in (0, 63, 64, 4095, 4096, 123457):
            for n in (1, 4, 7):
                assert noc.interleave(addr, n, mode=mode) == \
                    jnoc.interleave(addr, n, mode=mode)
    with pytest.raises(ValueError):
        noc.interleave(0, 4, mode="other")
    assert noc.EPAC_NOC == jnoc.EPAC_NOC
    # no fabric figure is a default: the caller names the fabric
    assert all(f.default is dataclasses.MISSING
               for f in dataclasses.fields(noc.FabricSpec))
    with pytest.raises(TypeError):
        noc.p2p_time(1.0, 1, "data")


@pytest.mark.parametrize("arch,kv_dtype", [
    (a, q) for a, c in sorted(all_configs().items())
    for q in (("bf16",) if c.enc_dec else ("bf16", "int8"))])
def test_paged_pool_mask_matches_jax(arch, kv_dtype):
    """Kind strings by layer kind, for every config's smoke; a quantized
    pool's scale leaves are "pool" leaves (an encoder-decoder pool is
    never quantized)."""
    tcfg, jcfg = get_config(arch).smoke(), jax_config(arch).smoke()
    layout = paged_kv.PagedLayout(num_slots=2, num_blocks=5, block_size=4,
                                  max_len=16)
    jlayout = jpaged_kv.PagedLayout(num_slots=2, num_blocks=5, block_size=4,
                                    max_len=16)
    spec = jspec = None
    if kv_dtype != "bf16":
        spec = paged_kv.make_pool_spec(tcfg, layout, kv_dtype=kv_dtype)
        jspec = jpaged_kv.make_pool_spec(jcfg, jlayout, kv_dtype=kv_dtype)
    mine = Model(tcfg, device="cpu").paged_pool_mask(layout, spec)
    assert mine == JModel(jcfg).paged_pool_mask(jlayout, spec=jspec)
    if spec is not None and "pool" in str(mine):
        assert "k_scale" in str(mine)


# -- 2. gather and scatter ------------------------------------------------


def _fill(tree, rng):
    """Random numpy leaves in a pool tree's shapes and dtypes."""
    if isinstance(tree, dict):
        return {k: _fill(v, rng) for k, v in tree.items()}
    dt = np.dtype(tree.dtype)
    if dt == np.int8:
        return rng.integers(-127, 128, tree.shape).astype(np.int8)
    return rng.standard_normal(tree.shape).astype(dt)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _equal_trees(mine, ref):
    assert mine.keys() == ref.keys()
    for k in ref:
        if isinstance(ref[k], dict):
            _equal_trees(mine[k], ref[k])
        else:
            assert mine[k].numpy().dtype == ref[k].dtype, k
            assert np.array_equal(mine[k].numpy(), ref[k]), k


@pytest.mark.parametrize("arch,kv_dtype", [
    ("olmo_1b", "bf16"), ("olmo_1b", "int8"),
    ("recurrentgemma_2b", "bf16"), ("whisper_base", "bf16")])
def test_extract_insert_blocks_match_jax(pairs, arch, kv_dtype):
    jm, _, tm, _ = pairs(arch)
    layout = paged_kv.PagedLayout(num_slots=3, num_blocks=9, block_size=4,
                                  max_len=16)
    jlayout = jpaged_kv.PagedLayout(num_slots=3, num_blocks=9, block_size=4,
                                    max_len=16)
    spec = jspec = None
    if kv_dtype != "bf16":
        spec = paged_kv.make_pool_spec(tm.cfg, layout, kv_dtype=kv_dtype)
        jspec = jpaged_kv.make_pool_spec(jm.cfg, jlayout, kv_dtype=kv_dtype)
    rng = np.random.default_rng(7)
    src_np = _fill(jm.init_paged_cache(jlayout, jspec), rng)
    dst_np = _fill(src_np, rng)
    src, dst = _torch_tree(src_np), _torch_tree(dst_np)
    _equal_trees(tm.init_paged_cache(layout, spec), _np_tree(
        jax.tree.map(np.zeros_like, src_np)))        # the same layout
    mask = tm.paged_pool_mask(layout, spec)
    jmask = jm.paged_pool_mask(jlayout, spec=jspec)
    chain, dchain = [5, 2, 7], [1, 8, 3]
    want = jpaged_kv.extract_blocks(
        jax.tree.map(jnp.asarray, src_np), jmask, jnp.asarray(chain), 1,
        arena=2)
    got = paged_kv.extract_blocks(src, mask, torch.tensor(chain), 1, 2)
    _equal_trees(got, _np_tree(want))
    assert transport._nbytes(got) == jtransport._payload_bytes(
        want, jmask, len(chain))
    # the gather owns its storage: rewriting the source reaches nothing
    for leaf in tree.leaves(src):
        leaf.zero_()
    _equal_trees(got, _np_tree(want))
    ptrs = [t.data_ptr() for t in tree.leaves(dst)]
    want_dst = jpaged_kv.insert_blocks(
        jax.tree.map(jnp.asarray, dst_np), jmask, want, jnp.asarray(dchain),
        0, arena=1)
    out = paged_kv.insert_blocks(dst, mask, got, torch.tensor(dchain), 0, 1)
    assert out is dst and [t.data_ptr() for t in tree.leaves(dst)] == ptrs
    _equal_trees(dst, _np_tree(want_dst))


# -- 3. ReplicaSet ---------------------------------------------------------


@pytest.fixture(scope="module")
def jax_runs(pairs):
    """JAX reference runs by name, computed once: (tokens, stats)."""
    cache = {}

    def get(name, build, arch, geo, work, **gen):
        if name not in cache:
            jm, jparams, _, _ = pairs(arch)
            eng = build(jm, jparams, JEngineConfig(**geo))
            toks = eng.generate(work, **gen)
            cache[name] = (toks, eng.stats(), eng)
        return cache[name]

    return get


def _jengine(jm, jparams, cfg):
    return JEngine(jm, jparams, cfg)


@pytest.mark.parametrize("case", ["paged", "static", "spec_mix"])
def test_replicaset_matches_jax(pairs, jax_runs, case):
    """dp=2 over one shared queue: tokens equal JAX's single Engine
    (greedy and seeded rows), placements equal JAX's ReplicaSet."""
    jm, _, tm, tparams = pairs("olmo_1b")
    prompts, sp, jsp = _work(tm.cfg.vocab_size)
    geo = dict(GEO, backend="static" if case == "static" else "paged")
    overrides = [{"spec_tokens": 4}, {"spec_tokens": 0}] \
        if case == "spec_mix" else None
    want, _, _ = jax_runs(f"engine_olmo_1b_{geo['backend']}", _jengine,
                          "olmo_1b", geo, prompts, sampling=jsp)
    _, jst, _ = jax_runs(f"rset_{case}", lambda m, p, c: JReplicaSet(
        m, p, c, dp=2, overrides=overrides), "olmo_1b", geo, prompts,
        sampling=jsp)
    rset = ReplicaSet(tm, tparams, EngineConfig(**geo), dp=2,
                      overrides=overrides, device="cpu")
    assert rset.generate(prompts, sp) == want
    st = rset.stats()
    assert st["dispatched"] == jst["dispatched"]
    assert all(d > 0 for d in st["dispatched"])
    assert st["blocks_used"] == 0 and st["ttft"]["count"] == len(prompts)
    if case == "spec_mix":
        assert rset.replicas[0].stats()["spec"]["proposed"] > 0


def _last(rset, cands):
    return cands[-1]


@pytest.mark.parametrize("policy,want", [
    ("round_robin", [3, 3]), (_last, [3, 3]), ("least_loaded", None)])
def test_replicaset_policies_and_workers(pairs, policy, want):
    """Placement by policy (a callable's first pick is the last
    replica), on one thread or two (``step_workers``): the tokens are a
    single engine's whichever replica serves."""
    _, _, tm, tparams = pairs("olmo_1b")
    prompts, sp, _ = _work(tm.cfg.vocab_size)
    ref = Engine(tm, tparams, EngineConfig(**GEO),
                 device="cpu").generate(prompts, sp)
    rset = ReplicaSet(tm, tparams, EngineConfig(**GEO), dp=2, policy=policy,
                      step_workers=2 if want is None else None,
                      device="cpu")
    assert rset.generate(prompts, sp) == ref
    if want is not None:
        assert rset.stats()["dispatched"] == want
    if policy is _last:
        assert 0 in {h.uid for h in rset.replicas[1].finished}
    with pytest.raises(ValueError, match="policy"):
        ReplicaSet(tm, tparams, EngineConfig(**GEO), dp=2, policy="nope",
                   device="cpu")


def test_replicaset_fcfs_under_saturation(pairs):
    """One slot a replica, twelve requests: dispatch pops the queue head
    only (request i never leaves the queue after j > i), every request
    finishes, and the pools drain."""
    _, _, tm, tparams = pairs("olmo_1b")
    rng = np.random.default_rng(1)
    rset = ReplicaSet(tm, tparams, EngineConfig(
        num_slots=1, block_size=4, num_blocks=9, max_len=32), dp=2,
        device="cpu")
    order = []
    dispatch = rset._dispatch

    def spy():
        before = {h.uid for h in rset.queue}
        moved = dispatch()
        order.extend(sorted(before - {h.uid for h in rset.queue}))
        return moved

    rset._dispatch = spy
    handles = [rset.add_request(
        list(map(int, rng.integers(0, tm.cfg.vocab_size, 4 + i % 3))),
        SamplingParams(max_tokens=4)) for i in range(12)]
    rset.drain()
    assert all(h.finished for h in handles)
    assert order == sorted(order) and len(order) == 12
    st = rset.stats()
    assert st["blocks_used"] == 0 and st["queue_wait_steps_max"] <= 12 * 8


@pytest.mark.parametrize("front", ["rset", "disagg"])
def test_ttft_telemetry_and_reset(pairs, front):
    _, _, tm, tparams = pairs("olmo_1b")
    prompts, sp, _ = _work(tm.cfg.vocab_size)
    eng = ReplicaSet(tm, tparams, EngineConfig(**GEO), dp=2, device="cpu") \
        if front == "rset" else DisaggregatedEngine(
            tm, tparams, EngineConfig(**GEO), dp=2, roles="auto",
            device="cpu")
    eng.generate(prompts, sp)
    st = eng.stats()
    assert st["ttft"]["count"] == len(prompts)
    assert 0.0 <= st["ttft"]["p50_s"] <= st["ttft"]["p95_s"]
    assert sum(st["tokens_out"]) == sum(len(h.token_ids)
                                        for h in eng.finished)
    assert all(b >= 0.0 for b in st["busy_s"] + st["device_s"])
    eng.reset_telemetry()
    st = eng.stats()
    assert st["ttft"]["count"] == 0 and st["steps"] == 0
    assert sum(st["dispatched"]) == 0
    if front == "disagg":
        assert st["disagg"]["exported"] == st["disagg"]["bytes_moved"] == 0


def test_backpressure_bounds_inflight_packets(pairs):
    """``max_inflight=1`` pauses fresh dispatch while a packet waits; the
    trace still completes with a single engine's tokens."""
    _, _, tm, tparams = pairs("olmo_1b")
    prompts, sp, _ = _work(tm.cfg.vocab_size)
    want = Engine(tm, tparams, EngineConfig(**GEO),
                  device="cpu").generate(prompts, sp)
    dis = DisaggregatedEngine(tm, tparams, EngineConfig(**GEO), dp=2,
                              roles=("prefill", "decode"), max_inflight=1,
                              device="cpu")
    assert dis.generate(prompts, sp) == want
    assert dis._dispatch_candidates() == dis.prefill_ids
    dis.packets.append(object())            # a backlog of one
    assert dis._dispatch_candidates() == []
    dis.packets.clear()
    _assert_no_leaks(dis)


@pytest.mark.parametrize("args", [["--dp", "2"],
                                  ["--dp", "2", "--roles", "prefill,decode"],
                                  ["--dp", "3", "--roles", "auto"]])
def test_serve_cli_replicas(capsys, args):
    serve.main(["--smoke", "--device", "cpu", "--requests", "4",
                "--n-new", "6"] + args)
    out = capsys.readouterr().out
    assert f"dp={args[1]}" in out and "'blocks_used': 0" in out
    assert ("'disagg'" in out) == ("--roles" in args)


# -- 4. DisaggregatedEngine ------------------------------------------------


DISAGG = {
    # case: (arch, dp roles, policy, engine overrides, JAX counters)
    "olmo_steal": ("olmo_1b", ("prefill", "decode", "decode"), _first, {},
                   True),
    "olmo_steal_overlap": ("olmo_1b", ("prefill", "decode", "decode"),
                           _first, {"overlap": True}, False),
    "olmo_int8": ("olmo_1b", ("prefill", "decode"), "least_loaded",
                  {"kv_dtype": "int8"}, False),
    "recurrentgemma": ("recurrentgemma_2b", ("prefill", "decode"),
                       "least_loaded", {}, True),
}


@pytest.mark.parametrize("case", sorted(DISAGG))
def test_disagg_matches_jax(pairs, jax_runs, case):
    """Migration is invisible in the tokens (JAX's Engine, with overlap
    off); the counters, ``bytes_moved`` and ``fabric_s`` under JAX's
    fabric figures equal JAX's DisaggregatedEngine on the same work. The
    first-candidate policy piles every import onto one decode replica,
    so the idle one steals."""
    arch, roles, policy, kw, counters = DISAGG[case]
    jm, _, tm, tparams = pairs(arch)
    prompts, sp, jsp = _work(tm.cfg.vocab_size)
    geo = dict(GEO, kv_dtype=kw.get("kv_dtype", "bf16"))
    want, _, _ = jax_runs(f"engine_{arch}_{geo['kv_dtype']}", _jengine,
                          arch, geo, prompts, sampling=jsp)
    dis = DisaggregatedEngine(tm, tparams, EngineConfig(**GEO, **kw),
                              dp=len(roles), roles=roles, policy=policy,
                              fabric=V5E, device="cpu")
    assert dis.generate(prompts, sp) == want
    _assert_no_leaks(dis)
    got = dis.stats()["disagg"]
    assert got["fabric_priced"] and got["packets_inflight"] == 0
    assert got["exported"] == len(prompts)
    assert got["imported"] == got["exported"] + got["stolen"]
    assert (got["stolen"] >= 1) == (policy is _first)
    if counters:
        _, jst, _ = jax_runs(f"disagg_{case}", lambda m, p, c: JDisagg(
            m, p, c, dp=len(roles), roles=roles, policy=policy), arch,
            geo, prompts, sampling=jsp)
        for key in ("exported", "imported", "stolen", "bytes_moved",
                    "fabric_s"):
            assert got[key] == jst["disagg"][key], key
    for r in dis.prefill_ids:
        st = dis.replicas[r].stats()
        assert st["steps"] == 0 and dis.replicas[r].backend.prefill_only


def test_disagg_speculative_decode_role(pairs, jax_runs):
    """Decode replicas keep speculation (a role override) while prefill
    replicas are forced to ``spec_tokens`` 0; an import installs the
    drafter's state (``_post_admit``). Tokens equal JAX's Engine."""
    _, _, tm, tparams = pairs("olmo_1b")
    prompts, sp, jsp = _work(tm.cfg.vocab_size)
    geo = dict(GEO, kv_dtype="bf16")
    want, _, _ = jax_runs("engine_olmo_1b_bf16", _jengine, "olmo_1b", geo,
                          prompts, sampling=jsp)
    dis = DisaggregatedEngine(tm, tparams, EngineConfig(**GEO), dp=2,
                              roles=("prefill", "decode"), device="cpu",
                              role_overrides={"decode": {"spec_tokens": 3}})
    assert [e.cfg.spec_tokens for e in dis.replicas] == [0, 3]
    assert dis.generate(prompts, sp) == want
    assert dis.replicas[1].stats()["spec"]["proposed"] > 0
    _assert_no_leaks(dis)


def test_disagg_unpriced_without_a_fabric(pairs):
    _, _, tm, tparams = pairs("olmo_1b")
    prompts, sp, _ = _work(tm.cfg.vocab_size, n=3)
    dis = DisaggregatedEngine(tm, tparams, EngineConfig(**GEO), dp=2,
                              roles="auto", device="cpu")
    assert dis.roles == ("prefill", "decode") and dis.fabric is None
    dis.generate(prompts, sp)
    got = dis.stats()["disagg"]
    assert got["bytes_moved"] > 0 and got["imported"] == 3
    assert got["fabric_s"] == 0.0 and not got["fabric_priced"]


def test_disagg_whisper_matches_jax_overlap_off(pairs):
    """Cross rows migrate with the slot; requests 1 and 2 share one
    feature array (one arena row on each side). Held to JAX's overlap-off
    Engine: JAX's whisper overlap tokens vary run to run."""
    jm, jparams, tm, tparams = pairs("whisper_base")
    prompts, sp, jsp = _work(tm.cfg.vocab_size)
    feats = _feats(tm.cfg.d_model, len(prompts))
    geo = dict(GEO, num_slots=4, max_len=32)
    want = JEngine(jm, jparams, JEngineConfig(**geo)).generate(
        prompts, jsp, encoder_features=feats)
    for kw in ({}, {"overlap": True}):
        dis = DisaggregatedEngine(tm, tparams, EngineConfig(**geo, **kw),
                                  roles=("prefill", "decode", "decode"),
                                  dp=3, device="cpu")
        assert dis.generate(prompts, sp, encoder_features=feats) == want
        _assert_no_leaks(dis)
        assert dis.stats()["disagg"]["imported"] >= len(prompts)


def test_disagg_xlstm_matches_port_engine():
    """mLSTM / sLSTM per-slot state migrates as "slot" rows; held to the
    port's own Engine (its own init), which test_torch_xlstm.py holds to
    JAX's."""
    tm = Model(get_config("xlstm_1_3b").smoke(), device="cpu")
    tparams = tm.init(seed=0)
    prompts, sp, _ = _work(tm.cfg.vocab_size, n=4, max_tokens=4)
    want = Engine(tm, tparams, EngineConfig(**GEO),
                  device="cpu").generate(prompts, sp)
    dis = DisaggregatedEngine(tm, tparams, EngineConfig(**GEO),
                              roles=("prefill", "decode"), dp=2,
                              device="cpu")
    assert dis.generate(prompts, sp) == want
    _assert_no_leaks(dis)


# -- 5. leaks and refusals --------------------------------------------------


def test_mid_migration_cancel_leaks_nothing(pairs):
    """Packets dropped between export and import leave both pools free:
    the export returned the source blocks, and no destination block was
    ever allocated."""
    _, _, tm, tparams = pairs("olmo_1b")
    prompts, sp, _ = _work(tm.cfg.vocab_size, n=3)
    dis = DisaggregatedEngine(tm, tparams, EngineConfig(**GEO), dp=2,
                              roles=("prefill", "decode"), device="cpu")
    for p, s in zip(prompts, sp):
        dis.add_request(p, s)
    dis._import_packets = lambda: 0     # park every packet in flight
    while dis.queue or any(dis.replicas[r].has_work
                           for r in dis.prefill_ids):
        dis.step()
    assert len(dis.packets) == len(prompts)
    for pkt in dis.packets:
        assert pkt.n_blocks > 0 and pkt.payload_bytes > 0
        dis._by_uid.pop(pkt.req.uid, None)
    dis.packets.clear()
    assert not dis.has_work
    _assert_no_leaks(dis)


def test_decode_side_preemption_no_leaks(pairs):
    """A decode pool too small for its imports preempts LIFO and
    re-prefills locally; tokens equal an uncontended engine's."""
    _, _, tm, tparams = pairs("olmo_1b")
    prompts, sp, _ = _work(tm.cfg.vocab_size, n=4, max_tokens=12)
    want = Engine(tm, tparams, EngineConfig(**BIG),
                  device="cpu").generate(prompts, sp)
    dis = DisaggregatedEngine(tm, tparams, EngineConfig(**BIG), dp=2,
                              roles=("prefill", "decode"),
                              role_overrides={"decode": {"num_blocks": 12}},
                              device="cpu")
    assert dis.generate(prompts, sp) == want
    assert dis.replicas[1].stats()["preemptions"] >= 1
    _assert_no_leaks(dis)


def test_full_hit_rewind_migrates(pairs):
    """A full prefix hit on the prefill replica has nothing sampled yet
    (length S - 1, stream position 0): the decode replica samples token 0
    at position 0, equal to the unmigrated prefix-cache engine."""
    _, _, tm, tparams = pairs("olmo_1b")
    rng = np.random.default_rng(3)
    prompt = list(map(int, rng.integers(0, tm.cfg.vocab_size, 8)))
    sp = [SamplingParams(max_tokens=5, temperature=0.8, seed=7)] * 2
    want = Engine(tm, tparams, EngineConfig(**GEO),
                  device="cpu").generate([prompt, prompt], sp)
    dis = DisaggregatedEngine(tm, tparams, EngineConfig(**GEO), dp=2,
                              roles=("prefill", "decode"), device="cpu")
    h0 = dis.add_request(prompt, sp[0])
    while not h0.finished:
        dis.step()
    h1 = dis.add_request(prompt, sp[1])
    dis.drain()
    assert [h0.token_ids, h1.token_ids] == want
    assert dis.replicas[0].stats()["prefix_cache"]["hits"] >= 1
    _assert_no_leaks(dis)


def test_kv_format_mismatch_raises(pairs):
    _, _, tm, tparams = pairs("olmo_1b")
    src = Engine(tm, tparams, EngineConfig(**GEO, kv_dtype="int8"),
                 device="cpu")
    dst = Engine(tm, tparams, EngineConfig(**GEO), device="cpu")
    src.add_request([1, 2, 3, 4, 5], SamplingParams(max_tokens=4))
    src.step()
    pkt = transport.extract_slot(src.backend, 0)
    assert pkt.kv_format == src.backend.kv_spec
    with pytest.raises(ValueError, match="KV-format mismatch"):
        transport.insert_packet(dst.backend, pkt)
    assert dst.backend.alloc.used_count == 0


def test_refusals(pairs):
    """Roles and overrides validate as JAX's do; a mesh passed through
    ``EngineConfig`` raises JAX's ValueError, the disaggregated engine
    takes a mesh as ``ReplicaSet`` does (a mesh that only describes a
    shape raises its ValueError) and ``serve --roles`` with ``--tp``
    reaches the launcher (here: no GPU)."""
    _, _, tm, tparams = pairs("olmo_1b")
    base = EngineConfig(**dict(GEO, spec_tokens=2))
    dis = DisaggregatedEngine(tm, tparams, base, dp=2,
                              roles=("prefill", "decode"), device="cpu")
    assert dis.replicas[0].cfg.spec_tokens == 0
    assert dis.replicas[1].cfg.spec_tokens == 2
    for kw, match in (
            (dict(role_overrides={"decode": {"block_size": 8}}), "per role"),
            (dict(roles=("prefill", "verify")), "unknown role"),
            (dict(roles=("decode", "decode")), "one replica per role"),
            (dict(dp=1, roles="auto"), "dp >= 2")):
        with pytest.raises(ValueError, match=match):
            DisaggregatedEngine(tm, tparams, EngineConfig(**GEO),
                                **{"dp": 2, "roles": ("prefill", "decode"),
                                   **kw}, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        DisaggregatedEngine(tm, tparams, EngineConfig(backend="static"),
                            dp=2, device="cpu")
    with pytest.raises(ValueError, match="cannot change"):
        ReplicaSet(tm, tparams, EngineConfig(**GEO), dp=2,
                   overrides=[None, {"eos_id": 5}], device="cpu")
    shape = meshlib.Mesh({"data": 2, "model": 2})     # no group
    for kw, match in ((dict(mesh=shape), "only describes a shape"),
                      (dict(cfg=EngineConfig(**GEO, mesh=shape)),
                       "not through EngineConfig")):
        with pytest.raises(ValueError, match=match):
            DisaggregatedEngine(tm, tparams,
                                **{"cfg": EngineConfig(**GEO), **kw},
                                dp=2, roles=("prefill", "decode"),
                                device="cpu")
    with pytest.raises(ValueError, match="not through EngineConfig"):
        ReplicaSet(tm, tparams, EngineConfig(**GEO, mesh=object()), dp=2,
                   device="cpu")
    with pytest.raises(RuntimeError, match="is_available"):
        serve.main(["--smoke", "--tp", "2", "--dp", "2", "--roles", "auto"])
