"""The tensor-parallel serving cases of ``test_torch_tp.py``, shared by
the test process (which runs JAX's single-device ``Engine`` on them) and
the spawned ranks (which run the port's ``Engine`` over their mesh).
Imports torch and the port only: a rank process never imports JAX.

Each case is (arch, mode): an engine geometry and options, ragged
prompts from numpy with a seed (all in the 8-token prefill bucket at
block size 4, so each JAX engine compiles few admission shapes) and
per-request sampling keyword arguments.
"""

import numpy as np

ARCHS = ("olmo_1b", "yi_6b", "gemma_7b")
MODES = ("greedy_preempt", "seeded", "spec3", "spec3_draft", "int8", "fp8",
         "prefix", "static")
# 8 usable blocks against 3 slots of up to 4 blocks: LIFO preemption
TIGHT = dict(num_slots=3, block_size=4, num_blocks=9, max_len=48)
ROOMY = dict(num_slots=3, block_size=4, num_blocks=33, max_len=48)
SEEDED = [dict(), dict(temperature=0.9, top_k=12, seed=3),
          dict(temperature=1.0, top_p=0.85, seed=5), dict(),
          dict(temperature=0.7, seed=11), dict()]


def case(arch: str, mode: str, vocab: int):
    """(engine kwargs, prompts, sampling kwargs a request) of a case.
    ``draft`` in the engine kwargs asks for the target's own smoke
    weights as the draft model."""
    rng = np.random.default_rng(ARCHS.index(arch) * 10 + MODES.index(mode))
    lens = (5, 7, 8, 6, 8, 7)
    prompts = [list(map(int, rng.integers(0, vocab, n))) for n in lens]
    greedy = [dict()] * len(prompts)
    new = dict(max_tokens=8)
    if mode == "greedy_preempt":
        return dict(TIGHT), prompts, [dict(g, **new) for g in greedy]
    if mode == "seeded":
        return dict(ROOMY), prompts, [dict(s, **new) for s in SEEDED]
    if mode in ("spec3", "spec3_draft"):
        # repeated phrases: material the ngram drafter can match
        phrase = list(map(int, rng.integers(0, vocab, 3)))
        prompts = [p[:2] + phrase * 2 for p in prompts]
        kw = dict(ROOMY, spec_tokens=3)
        if mode == "spec3_draft":
            kw.update(drafter="draft_model", draft=True)
        return kw, prompts, [dict(s, **new) for s in SEEDED]
    if mode in ("int8", "fp8"):          # int8 also preempts
        geo = TIGHT if mode == "int8" else ROOMY
        return dict(geo, kv_dtype=mode), prompts, \
            [dict(s, **new) for s in SEEDED]
    if mode == "prefix":
        # a shared block-aligned 4-token prefix (partial hits), and an
        # 8-token prompt repeated whole (a full hit: its rewind copies
        # the shared tail block on write)
        head = list(map(int, rng.integers(0, vocab, 4)))
        prompts = [head + p[:n - 4] for p, n in zip(prompts, lens)]
        prompts[3] = list(prompts[2])
        return dict(ROOMY), prompts, [dict(g, **new) for g in greedy]
    if mode == "static":
        return dict(backend="static", num_slots=3, max_len=48), prompts, \
            [dict(s, **new) for s in SEEDED]
    raise ValueError(mode)


def stats_view(st: dict) -> dict:
    """The scheduling counters a TP engine must share with the
    single-device one (either package's stats)."""
    out = {k: st[k] for k in ("steps", "preemptions", "batches",
                              "prefill_calls", "prefill_tokens")
           if k in st}
    if "prefix_cache" in st:
        out["prefix_cache"] = {k: st["prefix_cache"][k] for k in (
            "lookups", "hits", "hit_tokens", "cow_copies")}
    if "spec" in st:
        out["spec"] = {k: st["spec"][k] for k in (
            "steps", "proposed", "accepted", "emitted")}
    return out


def run_cases(mesh, cases, weights_np):
    """One rank: each (arch, mode) of ``cases`` through the port's Engine
    over ``mesh``, from the JAX weights ``weights_np[arch]`` (numpy).
    Returns {(arch, mode): (tokens, stats_view, pool or cache bytes,
    stats()["tp"])}."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.engine import Engine, EngineConfig, SamplingParams
    from repro_torch.models import weights
    from repro_torch.models.model import Model

    torch.set_num_threads(1)
    out = {}
    for arch, mode in cases:
        cfg = get_config(arch).smoke()
        model = Model(cfg, device=mesh.device)
        params = weights.from_jax_numpy(weights_np[arch], cfg, mesh.device)
        kw, prompts, samp = case(arch, mode, cfg.vocab_size)
        if kw.pop("draft", False):
            kw.update(draft_model=model, draft_params=params)
        eng = Engine(model, params, EngineConfig(**kw, mesh=mesh),
                     device=mesh.device)
        toks = eng.generate(prompts, [SamplingParams(**s) for s in samp])
        st = eng.stats()
        nbytes = st["tp"]["cache_bytes"] if "cache_bytes" in st["tp"] \
            else st["pool_bytes"]
        assert st.get("blocks_used", 0) == 0
        out[(arch, mode)] = (toks, stats_view(st), nbytes, st["tp"])
    return out


def raise_on_rank1(mesh):
    """Rank 1 raises while rank 0 waits for it in a collective."""
    import torch

    if mesh.rank == 1:
        raise ValueError("injected failure on rank 1")
    torch.distributed.all_reduce(torch.ones(4), group=mesh.group)
    return "unreachable"
