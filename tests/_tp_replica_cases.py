"""The cases of ``test_torch_tp_replica.py``: ``ReplicaSet`` over a
``(data=2, model=2)`` mesh of 4 ranks. Shared by the test process (which
runs JAX's single-device ``ReplicaSet(dp=2)``) and the spawned ranks
(which run the port's ``ReplicaSet(mesh=)``). Imports torch and the port
only: a rank process never imports JAX.

Eight prompts in one prefill bucket (8 tokens at block size 4) over two
replicas of 3 slots: the shared queue holds requests back while both
replicas are full.
"""

import numpy as np

from _tp_cases import ROOMY, SEEDED, TIGHT

ARCH = "olmo_1b"
# (policy, mode): a tight pool per replica preempts (greedy), a roomy one
# serves seeded rows
CASES = (("least_loaded", "greedy_preempt"), ("round_robin", "seeded"))


def case(mode: str, vocab: int):
    """(per-replica engine kwargs, prompts, sampling kwargs a request)."""
    rng = np.random.default_rng(400 + [m for _, m in CASES].index(mode))
    lens = (5, 7, 8, 6, 8, 7, 6, 5)
    prompts = [list(map(int, rng.integers(0, vocab, n))) for n in lens]
    if mode == "greedy_preempt":
        return dict(TIGHT), prompts, [dict(max_tokens=10)] * len(prompts)
    samp = [dict(s, max_tokens=8) for s in SEEDED + SEEDED[:2]]
    return dict(ROOMY), prompts, samp


def set_view(st: dict) -> dict:
    """The counters a replica set shares with JAX's (either package's
    ``ReplicaSet.stats()``)."""
    return {"dispatched": st["dispatched"], "steps": st["steps"],
            "preemptions": st["preemptions"],
            "prefill_calls": st["prefill_calls"],
            "blocks_used": st["blocks_used"],
            "replica_steps": [p["steps"] for p in st["per_replica"]]}


def run_rank(mesh, weights_np):
    """One rank of the (2, 2) mesh: each case through ``ReplicaSet(mesh=)``
    from the JAX weights (numpy). Returns {case: (tokens, stats(), each
    request's sample stamps less its submission, by request)}."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.engine import (EngineConfig, ReplicaSet,
                                           SamplingParams)
    from repro_torch.models import weights
    from repro_torch.models.model import Model

    torch.set_num_threads(1)
    cfg = get_config(ARCH).smoke()
    model = Model(cfg, device=mesh.device)
    params = weights.from_jax_numpy(weights_np, cfg, mesh.device)
    out = {}
    for policy, mode in CASES:
        kw, prompts, samp = case(mode, cfg.vocab_size)
        rset = ReplicaSet(model, params, EngineConfig(**kw), mesh=mesh,
                          policy=policy)
        toks = rset.generate(prompts, [SamplingParams(**s) for s in samp])
        stamps = [[t - h.t_submit for t in h.t_tokens]
                  for h in sorted(rset.finished, key=lambda h: h.uid)]
        out[(policy, mode)] = (toks, rset.stats(), stamps)
    return out
