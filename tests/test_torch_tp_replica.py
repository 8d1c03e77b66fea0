"""``ReplicaSet`` on ``(data, model)`` submeshes against the JAX package
on the CPU.

JAX's own multi-device tests fail under this jax, so the oracle is JAX's
single-device ``ReplicaSet(dp=2)`` on the same requests: its replicas'
tokens are the single engine's, and its dispatch decisions are the
policy's over the same loads.

  1. one (2, 2) mesh of 4 gloo ranks, spawned once for the module while
     JAX's replica sets run: ``ReplicaSet(mesh=)`` under least_loaded
     (a tight pool: preemption) and round_robin (seeded rows) gives
     JAX's tokens, ``dispatched`` and counters, every rank returns the
     same ``stats()``, the router's exchanges included, and holds the
     same sample stamps (less submission) as the request's home replica;
  2. ``submeshes`` gives JAX's shapes and raises JAX's ValueErrors (JAX's
     over a mesh of one CPU device repeated), and ``replica_cli_mesh``
     JAX's shapes (over a device count stubbed in, as its CLI reads it);
  3. ``serve --smoke --device cpu --dp 2 --tp 2`` serves, and with
     ``--roles auto`` serves ``DisaggregatedEngine(mesh=)``;
  4. what became legal takes a mesh as ``ReplicaSet`` does: the
     disaggregated engine and per-replica overrides get past their old
     refusals to the shape-only mesh's ValueError, and a mesh passed
     through ``EngineConfig`` raises JAX's ValueError; what stays refused
     names its sub-item: ``ReplicaSet(mesh=, dp=)`` with fewer replicas
     than the data axis (a data axis above 1 inside one engine) names
     "sharded training". (``test_torch_tp_disagg.py`` serves both on a
     (3, 2) mesh.)
"""

import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import Mesh as JMesh

import _tp_replica_cases as rc
from repro.configs import get_config as jax_config
from repro.launch import mesh as jmesh
from repro.launch.engine import EngineConfig as JEngineConfig
from repro.launch.engine import ReplicaSet as JReplicaSet
from repro.launch.engine import SamplingParams as JSamplingParams
from repro.models.model import Model as JModel
from repro_torch.configs import get_config
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import serve
from repro_torch.launch.engine import (DisaggregatedEngine, EngineConfig,
                                       ReplicaSet)
from repro_torch.models.model import Model

torch.set_num_threads(1)

TP_TIMEOUT_S = 300.0


@pytest.fixture(scope="module")
def jax_weights():
    jm = JModel(jax_config(rc.ARCH).smoke())
    return jm, jm.init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def mesh_run(jax_weights):
    """Spawn the (2, 2) mesh once, in a thread, so JAX's replica sets run
    while the ranks run theirs. Returns a getter of the ranks' results
    (by rank), which re-raises their failure."""
    weights_np = jax.tree.map(np.asarray, jax_weights[1])
    box = {}

    def run():
        try:
            box["res"] = meshlib.launch(rc.run_rank, 2, "cpu", dp=2,
                                        args=(weights_np,),
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


# -- 1. ReplicaSet(mesh=) ----------------------------------------------------


@pytest.mark.parametrize("policy,mode", rc.CASES)
def test_replica_set_on_submeshes_equals_jax(jax_weights, mesh_run, policy,
                                             mode):
    jm, jparams = jax_weights
    kw, prompts, samp = rc.case(mode, jm.cfg.vocab_size)
    jrs = JReplicaSet(jm, jparams, JEngineConfig(**kw), dp=2, policy=policy)
    want = jrs.generate(prompts, [JSamplingParams(**s) for s in samp])
    want_st = rc.set_view(jrs.stats())
    got = [r[(policy, mode)] for r in mesh_run()]
    toks, st, stamps = got[0]
    assert toks == want
    assert rc.set_view(st) == want_st
    assert all(g[0] == toks and g[1] == st for g in got[1:])  # every rank
    # a request's sample stamps (less submission) are, on the ranks outside
    # its home replica, those its home replica's first rank took: world
    # ranks 0 and 2, each the first of its replica, hold the same ones, and
    # so does the other replica's second rank (3 for replica 0, 1 for 1)
    same = [[np.allclose(a, b, rtol=0, atol=1e-6) for a, b in
             zip(stamps, g[2])] for g in got]
    assert all(same[2]) and all(s1 or s3 for s1, s3 in zip(same[1],
                                                           same[3]))
    assert st["dp"] == 2 and all(st["dispatched"])
    assert st["router"]["exchanges"] > 0
    assert [p["tp"]["rank"] for p in st["per_replica"]] == [0, 0]
    assert all(p["tp"]["tp"] == 2 and p["tp"]["backend"] == "gloo"
               for p in st["per_replica"])
    if mode == "greedy_preempt":
        assert st["preemptions"] > 0


# -- 2. submeshes and replica_cli_mesh ---------------------------------------


def _jax_err(fn):
    try:
        return fn(), None
    except ValueError as e:
        return None, str(e)


@pytest.mark.parametrize("shape,dp", [((2, 2), 2), ((2, 2), 1),
                                      ((4, 1), 2), ((2, 2), 3),
                                      ((2, 2), 0)])
def test_submeshes_equal_jax(shape, dp):
    d = jax.devices()[0]
    jm = JMesh(np.array([d] * (shape[0] * shape[1]), dtype=object)
               .reshape(shape), ("data", "model"))
    want, jerr = _jax_err(lambda: jmesh.submeshes(jm, dp))
    for rank in range(shape[0] * shape[1]):
        m = meshlib.Mesh({"data": shape[0], "model": shape[1]}, rank)
        if jerr is not None:
            with pytest.raises(ValueError) as exc:
                meshlib.submeshes(m, dp)
            assert jerr.startswith(str(exc.value))
            continue
        got = meshlib.submeshes(m, dp)
        assert [dict(s.shape) for s in got] == [dict(s.shape) for s in want]
        per = shape[0] // dp
        home = m.coord("data") // per
        assert got[home].rank == rank - home * per * shape[1]
        assert got[home].coord("model") == m.coord("model")
    with pytest.raises(ValueError, match="no 'pod' axis"):
        meshlib.submeshes(meshlib.Mesh({"data": 2, "model": 2}), 2, "pod")


@pytest.mark.parametrize("dp,tp", [(2, 2), (1, 2), (3, 2), (1, 4),
                                   (1, 1), (2, 1)])
def test_replica_cli_mesh_equals_jax(monkeypatch, dp, tp):
    """JAX's shape on a host with a device for each rank; with tp 1 the
    replicas share one device in one process, JAX's None on one device."""
    n = dp * tp if tp > 1 else 1
    monkeypatch.setattr(jmesh.jax, "devices", lambda: [None] * n)
    monkeypatch.setattr(jmesh.jax, "make_mesh",
                        lambda s, a: AbstractMesh(tuple(s), tuple(a)))
    want = jmesh.replica_cli_mesh(dp, tp)
    got = meshlib.replica_cli_mesh(dp, tp)
    assert (got is None) == (want is None)
    if got is not None:
        assert dict(got.shape) == dict(want.shape)
    for bad in ((0, tp), (dp, 0)):
        with pytest.raises(ValueError, match="must be >= 1"):
            meshlib.replica_cli_mesh(*bad)


# -- 3. the CLI --------------------------------------------------------------


def test_serve_cli_dp_tp_serves(capfd):
    serve.main(["--smoke", "--device", "cpu", "--dp", "2", "--tp", "2",
                "--requests", "4", "--n-new", "6"])
    out = capfd.readouterr().out
    assert "tp=2 dp=2" in out and "'router'" in out
    assert out.count("tok/s") == 1                   # rank 0 prints


def test_serve_cli_dp_tp_roles_serves(capfd):
    serve.main(["--smoke", "--device", "cpu", "--dp", "2", "--tp", "2",
                "--roles", "auto", "--requests", "4", "--n-new", "6"])
    out = capfd.readouterr().out
    assert "tp=2 dp=2 roles=auto" in out and "'router'" in out
    assert "'disagg'" in out and "'roles': ['prefill', 'decode']" in out
    assert "'exported': 4" in out and "'blocks_used': 0" in out
    assert out.count("tok/s") == 1                   # rank 0 prints


# -- 4. what stays refused ---------------------------------------------------


def test_refusals_name_migration_across_submeshes():
    model = Model(get_config(rc.ARCH).smoke(), device="cpu")
    params = model.init(seed=0)
    mesh = meshlib.Mesh({"data": 2, "model": 2})
    # legal now: each gets past its old refusal to ReplicaSet's checks
    with pytest.raises(ValueError, match="only describes a shape"):
        DisaggregatedEngine(model, params, EngineConfig(), mesh=mesh,
                            roles=("prefill", "decode"), device="cpu")
    with pytest.raises(ValueError, match="only describes a shape"):
        ReplicaSet(model, params, mesh=mesh, device="cpu",
                   overrides=[None, {"num_slots": 2}])
    for cls, kw in ((ReplicaSet, {}),
                    (DisaggregatedEngine, dict(dp=2, roles="auto"))):
        with pytest.raises(ValueError, match="not through EngineConfig"):
            cls(model, params, EngineConfig(mesh=mesh), mesh=mesh,
                device="cpu", **kw)
    # still refused
    with pytest.raises(NotImplementedError,
                       match="data axis above 1 inside one engine.*"
                             "sharded training"):
        ReplicaSet(model, params, mesh=mesh, dp=1, device="cpu")
    with pytest.raises(NotImplementedError,
                       match="data axis above 1 inside one engine.*"
                             "sharded training"):
        DisaggregatedEngine(model, params,
                            mesh=meshlib.Mesh({"data": 4, "model": 2}),
                            roles=("prefill", "decode"), device="cpu")
    with pytest.raises(ValueError, match="only describes a shape"):
        ReplicaSet(model, params, mesh=mesh, device="cpu")
