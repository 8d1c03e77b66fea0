"""The tensor-parallel serving cases of ``test_torch_tp_families.py``:
the recurrent, windowed, xLSTM and MoE decoders over a mesh, and the
replicated-KV fallback. Shared by the test process (which runs JAX's
single-device ``Engine`` on them) and the spawned ranks (which run the
port's ``Engine`` over their mesh). Imports torch and the port only: a
rank process never imports JAX. ``_tp_cases.ARCHS`` keeps the dense
decoders at T = 2; these cases are (tp, arch, mode).
"""

import numpy as np

from _tp_cases import ROOMY, SEEDED, TIGHT, stats_view

# T = 2: every decoder-only family beyond the dense ones (xLSTM's JAX
# engines compile slowest: the fewest modes); T = 4: the replicated-KV
# fallback (yi's 2 smoke kv heads over 4 ranks; recurrentgemma's one kv
# head at any T)
FAMILY_MODES = {
    "recurrentgemma_2b": ("greedy_preempt", "seeded", "spec3", "static"),
    "h2o_danube_3_4b": ("greedy_preempt", "seeded", "spec3"),
    "xlstm_1_3b": ("greedy_preempt", "seeded", "spec3"),
    "qwen3_moe_30b_a3b": ("greedy_preempt", "seeded", "spec3", "int8",
                          "static", "top8"),
    "kimi_k2_1t_a32b": ("greedy_preempt", "seeded", "spec3", "int8"),
}
T4_MODES = {
    "yi_6b": ("greedy_preempt", "spec3", "int8"),
    "recurrentgemma_2b": ("greedy_preempt", "seeded", "whole_attn"),
}
CASES = [(2, a, m) for a, ms in FAMILY_MODES.items() for m in ms] \
    + [(4, a, m) for a, ms in T4_MODES.items() for m in ms]
ARCHS = tuple(dict.fromkeys(a for _, a, _ in CASES))
MODES = ("greedy_preempt", "seeded", "spec3", "int8", "static",
         "whole_attn", "top8")
# modes that also change the smoke config: 2 query heads do not divide 4
# ranks, so the plan runs the attention layers whole on every rank;
# qwen3's full top-8 routing (over 16 experts, 8 a rank at T = 2), where
# smoke routes top-2: a token's output is then up to 8 contributions, and
# the all-reduce adds two ranks' partial sums of them
OVERRIDES = {"whole_attn": dict(n_heads=2),
             "top8": dict(n_experts=16, moe_top_k=8)}


def weights_key(arch: str, mode: str) -> str:
    """The key of a case's weights: the arch, or the arch and the mode
    whose config it overrides."""
    return f"{arch}/{mode}" if mode in OVERRIDES else arch


def smoke_config(get_config, arch: str, mode: str = ""):
    """The smoke config of a case from either package's ``get_config``,
    with the mode's overrides."""
    import dataclasses

    return dataclasses.replace(get_config(arch).smoke(),
                               **OVERRIDES.get(mode, {}))


def case(arch: str, mode: str, vocab: int):
    """(engine kwargs, prompts, sampling kwargs a request) of a case:
    ragged prompts from numpy with a seed, in the 8-token prefill bucket
    at block size 4."""
    rng = np.random.default_rng(100 + ARCHS.index(arch) * 10
                                + MODES.index(mode))
    lens = (5, 7, 8, 6, 8, 7)
    prompts = [list(map(int, rng.integers(0, vocab, n))) for n in lens]
    new = dict(max_tokens=8)
    if mode in ("greedy_preempt", "whole_attn", "top8"):
        return dict(TIGHT), prompts, [dict(new)] * len(prompts)
    samp = [dict(s, **new) for s in SEEDED]
    if mode == "seeded":
        return dict(ROOMY), prompts, samp
    if mode == "spec3":
        phrase = list(map(int, rng.integers(0, vocab, 3)))
        return dict(ROOMY, spec_tokens=3), \
            [p[:2] + phrase * 2 for p in prompts], samp
    if mode == "int8":                    # a tight pool: it also preempts
        return dict(TIGHT, kv_dtype="int8"), prompts, samp
    if mode == "static":
        return dict(backend="static", num_slots=3, max_len=48), prompts, \
            samp
    raise ValueError(mode)


def run_family_cases(mesh, cases, weights_np):
    """One rank: each (tp, arch, mode) of ``cases`` whose tp is the
    mesh's, through the port's Engine over ``mesh``, from the JAX
    weights ``weights_np[arch]`` (numpy). Returns {(tp, arch, mode):
    (tokens, stats_view, pool or cache bytes, stats()["tp"])}."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.engine import Engine, EngineConfig, SamplingParams
    from repro_torch.models import weights
    from repro_torch.models.model import Model

    torch.set_num_threads(1)
    tp = mesh.shape["model"]
    out = {}
    for t, arch, mode in cases:
        if t != tp:
            continue
        cfg = smoke_config(get_config, arch, mode)
        model = Model(cfg, device=mesh.device)
        params = weights.from_jax_numpy(weights_np[weights_key(arch, mode)],
                                        cfg, mesh.device)
        kw, prompts, samp = case(arch, mode, cfg.vocab_size)
        eng = Engine(model, params, EngineConfig(**kw, mesh=mesh),
                     device=mesh.device)
        toks = eng.generate(prompts, [SamplingParams(**s) for s in samp])
        st = eng.stats()
        nbytes = st["tp"]["cache_bytes"] if "cache_bytes" in st["tp"] \
            else st["pool_bytes"]
        assert st.get("blocks_used", 0) == 0
        out[(t, arch, mode)] = (toks, stats_view(st), nbytes, st["tp"])
    return out


# The blocks held alone against JAX's single-device block: (arch, kind of
# the pattern position, whose first layer is taken, the mode whose
# config it takes)
BLOCKS = (("recurrentgemma_2b", "rglru", ""), ("xlstm_1_3b", "mlstm", ""),
          ("xlstm_1_3b", "slstm", ""), ("qwen3_moe_30b_a3b", "moe", ""),
          ("qwen3_moe_30b_a3b", "moe", "top8"))
# the dim each rank's slice of a block's decode state lies along
STATE_DIM = {"rglru": {"h": -1, "conv": -1},
             "mlstm": {"C": 1, "n": 1, "m": 1, "conv": -1},
             "slstm": {"h": 1, "c": 1, "n": 1, "m": 1}}


def block_inputs(d_model: int):
    """x (2, 8, d) and its true lengths (right-padded second row), and a
    one-token decode input (2, 1, d), f32 from numpy with a seed."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 8, d_model)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, d_model)).astype(np.float32)
    return x, np.array([8, 5], np.int32), x1


def pattern_key(cfg, kind: str) -> str:
    """The ``p{i}`` key of the first pattern position of ``kind`` (an
    MoE's attention position for "moe")."""
    want = "attn" if kind == "moe" else kind
    return f"p{cfg.block_pattern.index(want)}"


def run_blocks(mesh, weights_np):
    """One rank of a T = 2 group: each of ``BLOCKS`` on the same inputs,
    layer 0's params cut to this rank's slices. The recurrent blocks run
    the prefill block (``transformer.apply_block`` on a right-padded
    batch, emitting the rank's state) and one decode step on it; the MoE
    runs ``moe.apply_moe_sharded``. Returns {(arch, kind): numpy
    outputs and state leaves}, keyed as ``BLOCKS``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import sharding
    from repro_torch.models import moe, transformer, weights

    torch.set_num_threads(1)
    out = {}
    for arch, kind, mode in BLOCKS:
        cfg = smoke_config(get_config, arch, mode)
        params = weights.from_jax_numpy(weights_np[weights_key(arch, mode)],
                                        cfg, "cpu")
        shard = sharding.make_shard_ctx(mesh, cfg)
        lp = transformer.layer_slice(
            params["groups"]["g0"][pattern_key(cfg, kind)], 0)
        lp = sharding.shard_params(lp, shard)
        x, length, x1 = (torch.from_numpy(a) for a in
                         block_inputs(cfg.d_model))
        if kind == "moe":
            y = moe.apply_moe_sharded(lp["moe"], cfg, x, shard)
            out[(arch, kind, mode)] = {"y": y.numpy()}
            continue
        pos = torch.arange(x.shape[1], dtype=torch.int32)
        y, cache = transformer.apply_block(lp, cfg, kind, x, pos,
                                           x.shape[1], length, shard=shard)
        res = {"y": y.numpy(), **{f"prefill_{n}": t.numpy().copy()
                                  for n, t in cache.items()}}
        y1 = transformer.apply_block_decode(lp, cfg, kind, x1, cache,
                                            length, shard=shard)
        res.update(y1=y1.numpy(), **{f"decode_{n}": t.numpy().copy()
                                     for n, t in cache.items()})
        out[(arch, kind, mode)] = res
    return out
