"""``DisaggregatedEngine`` and ``ReplicaSet(overrides=)`` on ``(data,
model)`` submeshes against the JAX package on the CPU.

JAX's own multi-device tests fail under this jax, so the oracles are
JAX's single-device engines on the same requests: its ``Engine`` for the
tokens (a packet moving between submeshes is invisible in them), its
``DisaggregatedEngine(dp=3)`` for the migration counters (every decision
is the same policy over the same loads) and its ``ReplicaSet(dp=3,
overrides=)`` for a replica set whose replicas differ.

One (3, 2) mesh of 6 gloo ranks, spawned once for the module while
JAX's engines run, serves roles ("prefill", "decode", "decode"):

  1. olmo_1b on a tight pool with every import on the first decode
     replica (it preempts, the other steals), olmo_1b seeded over an
     int8 pool with a speculative decode role, recurrentgemma_2b with
     ``overlap=True`` on the decode role (channel-sharded RG-LRU state
     and replicated KV: one rank's bytes times T exceed the logical
     packet) and whisper_base (the cross arena, two requests sharing one
     feature array): tokens equal JAX's ``Engine`` (overlap off), the
     counters, ``bytes_moved`` and ``fabric_s`` (JAX's fabric figures)
     equal JAX's ``DisaggregatedEngine``, every rank returns the same
     ``stats()``, no pool leaks on any rank, the prefill replica never
     steps; olmo_1b stealing under ``overlap=True`` (the second steal
     mid-decode: the donor's flushed tokens applied on every process)
     likewise, its counters held to the
     port's single-device ``DisaggregatedEngine``, which
     ``test_torch_replica.py`` holds to JAX's tokens;
  2. ``ReplicaSet(mesh=, overrides=)`` equals JAX's ``ReplicaSet(dp=3,
     overrides=)`` in tokens and in its refusal of a request the
     max_len 8 replica cannot hold.
"""

import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

import _tp_disagg_cases as dc
from repro.configs import get_config as jax_config
from repro.core import noc as jnoc
from repro.launch.engine import DisaggregatedEngine as JDisagg
from repro.launch.engine import Engine as JEngine
from repro.launch.engine import EngineConfig as JEngineConfig
from repro.launch.engine import ReplicaSet as JReplicaSet
from repro.launch.engine import SamplingParams as JSamplingParams
from repro.models.model import Model as JModel
from repro_torch.configs import get_config
from repro_torch.core import noc
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.engine import (DisaggregatedEngine, EngineConfig,
                                       SamplingParams)
from repro_torch.models import weights
from repro_torch.models.model import Model

torch.set_num_threads(1)

TP_TIMEOUT_S = 300.0


@pytest.fixture(scope="module")
def jax_weights():
    out = {}
    for arch in dc.ARCHS:
        jm = JModel(jax_config(arch).smoke())
        out[arch] = (jm, jm.init(jax.random.PRNGKey(0)))
    return out


@pytest.fixture(scope="module")
def mesh_run(jax_weights):
    """Spawn the (3, 2) mesh once, in a thread, so JAX's engines run
    while the ranks run theirs. Returns a getter of the ranks' results
    (by rank), which re-raises their failure."""
    weights_np = {a: jax.tree.map(np.asarray, p)
                  for a, (_, p) in jax_weights.items()}
    fabric = dataclasses.asdict(jnoc.V5E_FABRIC)
    box = {}

    def run():
        try:
            box["res"] = meshlib.launch(dc.run_rank, dc.TP, "cpu", dp=dc.DP,
                                        args=(weights_np, fabric),
                                        timeout_s=TP_TIMEOUT_S)
        except BaseException as e:          # re-raised by every reader
            box["err"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()

    def get():
        th.join(TP_TIMEOUT_S + 60)
        assert not th.is_alive(), "the ranks did not finish"
        if "err" in box:
            raise box["err"]
        return box["res"]

    return get


# -- 1. DisaggregatedEngine(mesh=) -------------------------------------------


@pytest.mark.parametrize("name", sorted(dc.CASES))
def test_disagg_on_submeshes_equals_jax(jax_weights, mesh_run, name):
    arch, kw, pol, role_ov = dc.CASES[name]
    jm, jparams = jax_weights[arch]
    prompts, samp, feats = dc.case(name, jm.cfg.vocab_size, jm.cfg.d_model)
    jsp = [JSamplingParams(**s) for s in samp]
    want = JEngine(jm, jparams, JEngineConfig(**kw)).generate(
        prompts, jsp, encoder_features=feats)
    if name in dc.PORT_COUNTERS:
        cfg = get_config(arch).smoke()
        ref = DisaggregatedEngine(
            Model(cfg, device="cpu"), weights.from_jax_numpy(
                jax.tree.map(np.asarray, jparams), cfg, "cpu"),
            EngineConfig(**kw), dp=dc.DP, roles=dc.ROLES,
            policy=dc.policy(pol), role_overrides=role_ov,
            fabric=noc.FabricSpec(**dataclasses.asdict(jnoc.V5E_FABRIC)),
            device="cpu")
        ref.generate(prompts, [SamplingParams(**s) for s in samp],
                     encoder_features=feats)
        want_view = dc.view(ref.stats())
    else:
        jdis = JDisagg(jm, jparams, JEngineConfig(**kw), dp=dc.DP,
                       roles=dc.ROLES, policy=dc.policy(pol),
                       role_overrides=role_ov)
        jdis.generate(prompts, jsp, encoder_features=feats)
        want_view = dc.view(jdis.stats())
    got = [r[name] for r in mesh_run()]
    toks, st, _ = got[0]
    assert toks == want
    assert dc.view(st) == want_view
    assert all(g[0] == toks and g[1] == st for g in got[1:])  # every rank
    assert all(g[2] == [True, 0] for g in got), [g[2] for g in got]
    d = st["disagg"]
    assert d["exported"] == len(prompts) and d["packets_inflight"] == 0
    assert d["imported"] == d["exported"] + d["stolen"]
    assert d["fabric_priced"] and st["blocks_used"] == 0
    assert st["per_replica"][0]["steps"] == 0             # prefill only
    assert all(p["tp"]["tp"] == dc.TP and p["tp"]["backend"] == "gloo"
               for p in st["per_replica"])
    assert st["router"]["exchanges"] > 0
    if name == "olmo_steal":
        assert d["stolen"] >= 1 and st["preemptions"] > 0
    if name == "olmo_steal_overlap":
        assert d["stolen"] >= 2
        assert all(p["overlap"] for p in st["per_replica"][1:])
    if name == "olmo_int8_spec":
        assert st["per_replica"][1]["spec"]["proposed"] > 0
    # head-sharded pools: a rank sends half the logical packet; under the
    # replicated KV of recurrentgemma every rank holds all kv heads
    half = d["rank_bytes_moved"] * dc.TP == d["bytes_moved"]
    assert half == (arch != "recurrentgemma_2b"), d


# -- 2. ReplicaSet(mesh=, overrides=) ----------------------------------------


def test_replica_set_overrides_on_submeshes_equals_jax(jax_weights,
                                                       mesh_run):
    jm, jparams = jax_weights["olmo_1b"]
    prompts, samp, long, lsamp = dc.overrides_case(jm.cfg.vocab_size)
    jrs = JReplicaSet(jm, jparams, JEngineConfig(**dc.OVERRIDES_GEO),
                      dp=dc.DP, overrides=dc.OVERRIDES)
    with pytest.raises(ValueError) as exc:
        jrs.add_request(long, JSamplingParams(**lsamp))
    want = jrs.generate(prompts, [JSamplingParams(**s) for s in samp])
    jst = jrs.stats()
    got = [r["overrides"] for r in mesh_run()]
    toks, st, refusal = got[0]
    assert toks == want
    assert refusal == str(exc.value) and "max_len 8" in refusal
    assert st["dispatched"] == jst["dispatched"]
    assert [p["steps"] for p in st["per_replica"]] == \
        [p["steps"] for p in jst["per_replica"]]
    assert all(g == got[0] for g in got[1:])               # every rank
    assert st["blocks_used"] == 0
