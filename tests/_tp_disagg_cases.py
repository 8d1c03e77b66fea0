"""The cases of ``test_torch_tp_disagg.py``: ``DisaggregatedEngine`` and
``ReplicaSet(overrides=)`` over a ``(data=3, model=2)`` mesh of 6 ranks.
Shared by the test process (which runs JAX's single-device engines) and
the spawned ranks (which run the port's over the mesh). Imports torch
and the port only: a rank process never imports JAX.

Roles ``("prefill", "decode", "decode")``; six prompts in one prefill
bucket (8 tokens at block size 4), so each JAX replica compiles few
admission shapes.
"""

import numpy as np

from _tp_cases import ROOMY, SEEDED, TIGHT

ROLES = ("prefill", "decode", "decode")
DP, TP = 3, 2
ARCHS = ("olmo_1b", "recurrentgemma_2b", "whisper_base")
# case: (arch, engine kwargs, policy, role overrides)
CASES = {
    # every import on the first decode replica: a tight pool there
    # preempts, and the other one steals
    "olmo_steal": ("olmo_1b", dict(TIGHT), "first", {}),
    "olmo_int8_spec": ("olmo_1b", dict(ROOMY, kv_dtype="int8"),
                       "least_loaded", {"decode": {"spec_tokens": 3}}),
    "recurrentgemma_overlap": ("recurrentgemma_2b", dict(ROOMY),
                               "least_loaded", {"decode": {"overlap": True}}),
    "whisper": ("whisper_base", dict(ROOMY, num_slots=4, max_len=32),
                "least_loaded", {}),
    # steals under overlap: two long requests and four short ones, so
    # the second steal comes mid-decode and the donor's flush harvests
    # its in-flight tokens first (counters held to the port's
    # single-device engine: JAX's overlap engine flushes elsewhere)
    "olmo_steal_overlap": ("olmo_1b", dict(ROOMY), "first",
                           {"decode": {"overlap": True}}),
}
# the cases whose counters are held to the port's single-device
# DisaggregatedEngine (tokens to JAX's Engine all the same)
PORT_COUNTERS = ("olmo_steal_overlap",)
# ReplicaSet(mesh=, overrides=): a replica of fewer slots, one of a
# shorter max_len (its requests must fit 8 positions)
OVERRIDES = [None, {"num_slots": 2}, {"max_len": 8}]
OVERRIDES_GEO = dict(ROOMY)


def first(rset, cands):
    """Pile every placement onto the first candidate (forces a steal)."""
    return cands[0]


def policy(name):
    return first if name == "first" else name


def case(name: str, vocab: int, d_model: int):
    """(prompts, sampling kwargs a request, encoder features or None)."""
    arch = CASES[name][0]
    rng = np.random.default_rng(500 + sorted(CASES).index(name))
    prompts = [list(map(int, rng.integers(0, vocab, n)))
               for n in (5, 7, 8, 6, 8, 7)]
    if name == "olmo_int8_spec":
        samp = [dict(s, max_tokens=8) for s in SEEDED]
    elif name == "olmo_steal_overlap":
        samp = [dict(max_tokens=n) for n in (14, 14, 4, 4, 4, 4)]
    else:
        samp = [dict(max_tokens=10 if name == "olmo_steal" else 8)] * 6
    feats = None
    if arch == "whisper_base":        # requests 1 and 2 share one array
        feats = [rng.standard_normal((f, d_model)).astype(np.float32)
                 for f in (5, 16, 9, 12, 7, 16)]
        feats[2] = feats[1]
    return prompts, samp, feats


def overrides_case(vocab: int):
    """(prompts that fit every replica, their sampling kwargs, a prompt
    that overflows the max_len 8 replica, its sampling kwargs)."""
    rng = np.random.default_rng(600)
    prompts = [list(map(int, rng.integers(0, vocab, n)))
               for n in (4, 5, 3, 5, 4, 5, 3, 4)]
    samp = [dict(max_tokens=3)] * len(prompts)
    return prompts, samp, prompts[1] + [1], dict(max_tokens=3)


def view(st: dict) -> dict:
    """What a disaggregated engine's stats share with JAX's
    single-device one on the same work (either package's stats)."""
    d = st["disagg"]
    return {"dispatched": st["dispatched"], "steps": st["steps"],
            "preemptions": st["preemptions"],
            "replica_steps": [p["steps"] for p in st["per_replica"]],
            **{k: d[k] for k in ("exported", "imported", "stolen",
                                 "bytes_moved", "fabric_s")}}


def leaks(engine) -> list:
    """This process's replica: (free blocks == usable, arena rows used),
    with the allocator's invariant checked."""
    be = engine.replicas[engine.home].backend
    be.alloc.check_invariant()
    return [be.alloc.free_count == be.layout.usable_blocks,
            0 if be.arena is None else be.arena.used_count]


def run_rank(mesh, weights_np, fabric):
    """One rank of the (3, 2) mesh: each case from the JAX weights
    (numpy, by arch), priced by ``fabric`` (a dict of ``FabricSpec``
    fields). Returns {case: (tokens, stats(), leaks)} and, under
    "overrides", (tokens, stats(), the refusal's message)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import noc
    from repro_torch.launch.engine import (DisaggregatedEngine,
                                           EngineConfig, ReplicaSet,
                                           SamplingParams)
    from repro_torch.models import weights
    from repro_torch.models.model import Model

    torch.set_num_threads(1)
    spec = noc.FabricSpec(**fabric)
    out, pairs = {}, {}
    for arch in ARCHS:
        cfg = get_config(arch).smoke()
        pairs[arch] = (cfg, Model(cfg, device=mesh.device),
                       weights.from_jax_numpy(weights_np[arch], cfg,
                                              mesh.device))
    for name, (arch, kw, pol, role_ov) in CASES.items():
        cfg, model, params = pairs[arch]
        prompts, samp, feats = case(name, cfg.vocab_size, cfg.d_model)
        dis = DisaggregatedEngine(model, params, EngineConfig(**kw),
                                  mesh=mesh, roles=ROLES,
                                  policy=policy(pol), role_overrides=role_ov,
                                  fabric=spec)
        toks = dis.generate(prompts, [SamplingParams(**s) for s in samp],
                            encoder_features=feats)
        out[name] = (toks, dis.stats(), leaks(dis))
    cfg, model, params = pairs["olmo_1b"]
    prompts, samp, long, lsamp = overrides_case(cfg.vocab_size)
    rset = ReplicaSet(model, params, EngineConfig(**OVERRIDES_GEO),
                      mesh=mesh, overrides=OVERRIDES)
    try:
        rset.add_request(long, SamplingParams(**lsamp))
        refusal = None
    except ValueError as e:
        refusal = str(e)
    toks = rset.generate(prompts, [SamplingParams(**s) for s in samp])
    out["overrides"] = (toks, rset.stats(), refusal)
    return out
