"""The cases of ``test_torch_tp_encdec.py``: whisper_base under tensor
parallelism, and ``overlap=True`` under a mesh for every family the port
serves over one. Shared by the test process (which runs JAX's
single-device ``Engine`` on them) and the spawned ranks (which run the
port's ``Engine`` over their mesh). Imports torch and the port only: a
rank process never imports JAX.

Prompts sit in one prefill bucket (8 tokens at block size 4) and
whisper's frames in one frame bucket (16), so each JAX engine compiles
few admission shapes.
"""

import numpy as np

from _tp_cases import SEEDED, TIGHT, stats_view

WHISPER = "whisper_base"
# whisper's engine cases at T = 2 ("heads") and T = 4 ("kv_replicated"):
# a pool that preempts (a resumed request re-encodes), and one feature
# array submitted three times (one arena row, shared by refcount)
WHISPER_MODES = ("greedy_preempt", "shared")
# overlap=True at T = 2, every family the port serves under TP
OVERLAP_ARCHS = ("olmo_1b", "recurrentgemma_2b", "h2o_danube_3_4b",
                 "xlstm_1_3b", "qwen3_moe_30b_a3b", WHISPER)
CASES = [(tp, WHISPER, m) for tp in (2, 4) for m in WHISPER_MODES] \
    + [(2, a, "overlap") for a in OVERLAP_ARCHS]
ARCHS = tuple(dict.fromkeys(a for _, a, _ in CASES))
WHISPER_GEO = {"greedy_preempt": dict(num_slots=4, num_blocks=9),
               "shared": dict(num_slots=3, num_blocks=33),
               "overlap": dict(num_slots=4, num_blocks=9)}


def case(arch: str, mode: str, vocab: int, d_model: int):
    """(engine kwargs, prompts, sampling kwargs a request, encoder
    features or None) of a case. Whisper's features are numpy arrays;
    ``shared`` repeats one array object (the identity the arena keys
    on); overlap cases mix greedy and seeded rows."""
    rng = np.random.default_rng(300 + ARCHS.index(arch) * 10
                                + (("overlap",) + WHISPER_MODES).index(mode))
    lens = (5, 7, 8, 6, 8, 7)
    prompts = [list(map(int, rng.integers(0, vocab, n))) for n in lens]
    mixed = [dict(s, max_tokens=8) for s in SEEDED]
    if arch != WHISPER:
        return dict(TIGHT, overlap=True), prompts, mixed, None
    feats = [rng.normal(size=(F, d_model)).astype(np.float32)
             for F in (9, 16, 12, 14, 10, 16)]
    geo = dict(WHISPER_GEO[mode], block_size=4, max_len=32)
    if mode == "shared":
        feats[1] = feats[2] = feats[0]
        return geo, prompts[:4], mixed[:4], feats[:4]
    if mode == "greedy_preempt":
        return geo, prompts[:4], [dict(max_tokens=10)] * 4, feats[:4]
    feats[5] = feats[1]
    return dict(geo, overlap=True), prompts, \
        [dict(s, max_tokens=10) for s in SEEDED], feats


def engine_view(st: dict) -> dict:
    """The counters a TP engine shares with JAX's single-device one:
    ``_tp_cases.stats_view``, and an encoder-decoder's admissions and
    arena (the port's ``prefill_shapes`` is JAX's
    ``prefill_compiles``)."""
    out = stats_view(st)
    if st.get("cross_arena", {}).get("enabled"):
        out["prefill_reqs"] = st["prefill_reqs"]
        out["cross_arena"] = dict(st["cross_arena"])
        out["prefill_shapes"] = st.get("prefill_shapes",
                                       st.get("prefill_compiles"))
    return out


def block_inputs(d_model: int):
    """Frames (3, 16, d) with frame counts 11, 16 and 0 (a filler row),
    and decoder rows (3, 4, d), f32 from numpy with a seed."""
    rng = np.random.default_rng(17)
    frames = rng.normal(size=(3, 16, d_model)).astype(np.float32)
    x = rng.normal(size=(3, 4, d_model)).astype(np.float32)
    return frames, np.asarray([11, 16, 0], np.int32), x


def run_blocks(mesh, weights_np):
    """whisper's masked encoder, and its first decoder layer's
    cross-attention over the encoder output's K/V (``encode_cross_kv``
    on the rank's weights), on this rank's slices. Returns numpy
    outputs (whole rows: each is all-reduced)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import sharding
    from repro_torch.models import attention, encdec, layers, weights
    from repro_torch.models.transformer import layer_slice

    cfg = get_config(WHISPER).smoke()
    full = weights.from_jax_numpy(weights_np[WHISPER], cfg, "cpu")
    shard = sharding.make_shard_ctx(mesh, cfg)
    params = sharding.shard_params(full, shard)
    frames, lens, x = (torch.from_numpy(a) for a in
                       block_inputs(cfg.d_model))
    enc = encdec.encode(params, cfg, frames, enc_lengths=lens, shard=shard)
    p = layer_slice(params["dec"], 0)
    xn = layers.apply_norm(cfg.norm, p["lnx"], x)
    kv = attention.encode_cross_kv(p["xattn"], cfg, enc)
    cross = attention.attend_cross_masked(p["xattn"], cfg, xn, kv, lens,
                                          shard)
    return {"encode": enc.numpy(), "cross": cross.numpy(),
            "kv_heads": int(kv["k"].shape[1])}


def run_rank(mesh, cases, weights_np):
    """One rank: each (tp, arch, mode) of ``cases`` whose tp is the
    mesh's, through the port's Engine over ``mesh`` from the JAX weights
    (numpy), then the blocks. Returns {(tp, arch, mode): (tokens,
    engine_view, pool bytes, stats()["tp"], overlap flag, decode steps
    run eagerly)} and "blocks"."""
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
        cfg = get_config(arch).smoke()
        model = Model(cfg, device=mesh.device)
        params = weights.from_jax_numpy(weights_np[arch], cfg, mesh.device)
        kw, prompts, samp, feats = case(arch, mode, cfg.vocab_size,
                                        cfg.d_model)
        eng = Engine(model, params, EngineConfig(**kw, mesh=mesh),
                     device=mesh.device)
        toks = eng.generate(prompts, [SamplingParams(**s) for s in samp],
                            encoder_features=feats)
        st = eng.stats()
        assert st["blocks_used"] == 0
        assert st["cross_arena"]["rows_used"] == 0
        out[(t, arch, mode)] = (toks, engine_view(st), st["pool_bytes"],
                                st["tp"], st["overlap"],
                                st["eager_decode_steps"])
    out["blocks"] = run_blocks(mesh, weights_np)
    return out
