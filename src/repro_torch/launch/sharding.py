"""Layout rules of tensor-parallel serving: which dim of which leaf each
rank holds a slice of.

Counterpart of ``repro/launch/sharding.py`` for its 2-D layout with a
data axis of 1 (Megatron-style tensor parallelism):

  * column-parallel weights (wq / wk / wv, w_up / w_gate, ...): the
    output dim over the model axis;
  * row-parallel weights (wo, w_down, w_out): the input dim over it, an
    all-reduce after the product (``layers.tp_reduce``);
  * embeddings: the vocabulary over it (``layers.vocab_parallel_lookup``
    masks the ids and all-reduces); the head (``lm_head``, or the tied
    ``embed.T``) gives each rank a vocab slice of the logits, which an
    all-gather makes whole on every rank (JAX's replicated logits);
  * norms and gains: replicated.

The specs are JAX's, leaf for leaf (``param_specs`` returns tuples of
axis names, ``()`` for a replicated leaf, where JAX returns a
``PartitionSpec``); a dim that does not divide its axes is left whole
(``_fit``). Where JAX commits a full tree to its shardings
(``place_params``), every rank here builds the same full tree (from the
seed, or from the JAX bridge) and keeps its slice (``shard_params``);
the pools and caches are allocated at their local shapes directly
(``local_zeros`` over a tree built on the meta device), never whole.

Which blocks split over the ranks is a per-block plan (``TPPlan``,
``plan_tp``), chosen once from which dimensions divide T: attention by
heads (its pool or ring split by kv heads), by query heads over a
replicated KV (kv heads that do not divide T; each rank reads the range
of kv heads its query heads map to) or whole; the RG-LRU by channels,
the mLSTM / sLSTM by heads, the MLP by ``d_ff``, the MoE by experts
(expert parallelism), the embedding and head by vocabulary, each whole
where its dimension does not divide. ``shard_params`` follows JAX's
specs except for two kinds of leaves, which the plan names: leaves kept
whole where JAX's spec splits them (an MQA layer's ``wk`` / ``wv``, every
projection of a whole attention layer: GSPMD gathers those on use, so a
rank holds more bytes than JAX's spec says) and head-aligned leaves,
concatenations of per-head parts (mLSTM ``w_up`` = [c | z] and ``w_if`` =
[i | f], sLSTM ``w_zifo`` = [z | i | f | o]) of which a rank takes its
heads' columns of each part, where JAX's contiguous column split would
hand one rank all of ``c`` and the other all of ``z``.

The encoder-decoder (whisper) plans one attention mode for its
encoder's self-attention, its decoder's self-attention and the
cross-attention, and ``encdec.paged_cache_specs`` splits its cross-KV
arena by kv heads where they divide T, as JAX's does.

The ``fsdp`` layout, ``opt_state_specs`` and a seq-sharded decode cache
wait for the sub-items that need them (``layout_ctx`` raises), and so
does a data axis above 1 inside one engine: replicas on ``(data, model)``
submeshes are one engine a submesh (``ReplicaSet(mesh=)``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..models import layers
from .mesh import SHARDED_TRAINING, TP_FAMILIES, not_ported


class TPStats:
    """What one engine's collectives cost this rank: calls and bytes
    (each collective's input on this rank), and, while ``timing`` holds
    a list, a (start, end) CUDA event pair around each collective."""

    def __init__(self):
        self.timing = None
        self.reset()

    def reset(self):
        self.collectives = 0
        self.bytes = 0

    def record(self, nbytes: int):
        self.collectives += 1
        self.bytes += nbytes

    def snapshot(self) -> tuple:
        return self.collectives, self.bytes

    def add(self, delta: tuple):
        """Advance by a captured step's collectives (one graph replay)."""
        self.collectives += delta[0]
        self.bytes += delta[1]


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """The static handle threaded into model code (``RunCtx.shard``):
    the mesh, its axis names, the layout and the engine's ``TPStats``."""

    mesh: Any                                  # launch.mesh.Mesh
    dp_axes: tuple                             # ("data",)
    tp_axis: str = "model"
    layout: str = "2d"
    stats: TPStats = dataclasses.field(default_factory=TPStats,
                                       compare=False, repr=False)
    # the TPPlan a model runs by (``make_shard_ctx``); None only for a
    # ``layout_ctx``, which serves the layout rules alone
    plan: Any = dataclasses.field(default=None, compare=False)

    @property
    def batch_axes(self) -> tuple:
        """Axes the batch dim is sharded over."""
        return self.dp_axes

    @property
    def tp_size(self) -> int:
        return int(self.mesh.shape[self.tp_axis])

    @property
    def tp_rank(self) -> int:
        return self.mesh.coord(self.tp_axis)

    @property
    def group(self):
        return self.mesh.group

    @property
    def backend(self) -> str:
        return self.mesh.backend


def tp_report(shard: ShardCtx, device, step_collectives: int,
              steps: int) -> dict:
    """The common part of a backend's ``stats()["tp"]``: the mesh, this
    rank, the collectives' backend, the collectives (all, and those of
    the decode / verify steps, per step) with their bytes on this rank,
    and the plan (``TPPlan.report``)."""
    out = {"tp": shard.tp_size, "rank": shard.tp_rank,
           "backend": shard.backend, "device": str(device),
           "collectives": shard.stats.collectives,
           "collective_bytes": shard.stats.bytes,
           "step_collectives": step_collectives,
           "collectives_per_step": step_collectives / max(steps, 1)}
    if shard.plan is not None:
        out.update(shard.plan.report())
    return out


def layout_ctx(mesh, layout: str = "2d", tp_axis: str = "model") -> ShardCtx:
    """A ``ShardCtx`` of ``mesh`` with no plan: enough for the layout
    rules (``param_specs``, ``paged_cache_specs``, ``batch_specs``) of
    any config, not to run a model. ``mesh`` is one engine's: a ``(1,
    T)`` mesh, or a submesh of replicas whose data axis is 1
    (``mesh.submeshes``). Raises for what is not ported: the ``fsdp``
    layout and a data axis above 1 inside one engine (FSDP, or JAX's
    slots sharded over ``data``), both sharded training's."""
    if tp_axis not in mesh.axis_names:
        raise ValueError(f"mesh has no {tp_axis!r} axis: {mesh.axis_names}")
    if layout != "2d":
        raise not_ported(f"the {layout!r} layout", SHARDED_TRAINING)
    dp = tuple(a for a in mesh.axis_names if a != tp_axis)
    if any(int(mesh.shape[a]) > 1 for a in dp):
        raise not_ported(
            f"a data axis above 1 inside one engine (mesh {mesh.shape}: "
            "FSDP, or slots sharded over 'data'; for replicas on (1, T) "
            "submeshes pass the mesh to ReplicaSet(mesh=))",
            SHARDED_TRAINING)
    return ShardCtx(mesh=mesh, dp_axes=dp, tp_axis=tp_axis, layout=layout)


def make_shard_ctx(mesh, cfg, tp_axis: str = "model") -> ShardCtx:
    """The ``ShardCtx`` a model runs under on ``mesh``: ``layout_ctx``'s
    with the plan of ``cfg`` over it (``plan_tp``, which raises for a
    config the mesh does not serve)."""
    shard = layout_ctx(mesh, tp_axis=tp_axis)
    return dataclasses.replace(shard, plan=plan_tp(cfg, shard))


def _axis_size(mesh, axis) -> int:
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= int(mesh.shape[a])
        return n
    return int(mesh.shape[axis])


def _norm(axis):
    """An axis tuple of one name is that name (as ``PartitionSpec``
    prints it)."""
    if isinstance(axis, tuple) and len(axis) == 1:
        return axis[0]
    return axis


def _fit(spec_dims, shape, mesh) -> tuple:
    """Drop sharding on dims that don't divide their mesh axes."""
    out = []
    for dim, axis in zip(shape, spec_dims):
        if axis is None or dim % _axis_size(mesh, axis) != 0:
            out.append(None)
        else:
            out.append(_norm(axis))
    return tuple(out)


# Rules keyed by the leaf name (last path key); dims are right-aligned so
# stacked (L, ...) variants share the rule. JAX's table, whole.
def _param_rule(name: str, ndim: int, shard: ShardCtx):
    dp, tp = shard.dp_axes, shard.tp_axis
    col = (dp, tp)            # (..., d_in -> dp, d_out -> tp)
    row = (tp, dp)            # (..., d_in -> tp, d_out -> dp)
    table = {
        "embed": (tp, dp),
        "lm_head": (dp, tp),
        "wq": col, "wk": col, "wv": col, "w_up": col, "w_gate": col,
        "w_x": col, "w_a": col, "w_i": col, "w_zifo": col, "w_if": col,
        "wo": row, "w_down": row, "w_out": row,
        "router": (dp, None),
        "w1": (tp, dp, None), "w3": (tp, dp, None),   # experts (E, d, ff)
        "w2": (tp, None, dp),                          # experts (E, ff, d)
    }
    dims = table.get(name)
    if dims is None:
        return None  # replicate (norms, biases, conv, lam, r_zifo, ...)
    return (None,) * (ndim - len(dims)) + tuple(dims)


def _tree_map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def param_specs(params, shard: ShardCtx):
    """Same-structure tree of specs for a param tree (divisibility-
    checked): a tuple of axis names (or None) a dim, ``()`` for a
    replicated leaf. Leaves need only ``.shape`` and ``.ndim``."""
    def spec_of(path, leaf):
        dims = _param_rule(path[-1], leaf.ndim, shard)
        if dims is None:
            return ()
        return _fit(dims, tuple(leaf.shape), shard.mesh)

    return _tree_map_with_path(spec_of, params)


def _batch_rule(path, shape, shard: ShardCtx):
    """Spec for one batch-like leaf (the per-slot caches of the static
    backend and of windowed / recurrent layers): batch over the data
    axes, the head / state-width dim over the model axis."""
    dp, tp = shard.batch_axes, shard.tp_axis
    kv_rule = (None, dp, None, tp, None)      # (L, B, S, Hkv -> tp, hd)
    cache_rules = {
        "k": kv_rule,
        "v": kv_rule,
        "C": (None, dp, tp, None, None),      # (L, B, H, hd, hd)
        "n": (None, dp, tp, None),            # (L, B, H, hd)
        "m": (None, dp, tp),                  # (L, B, H)
        "h": (None, dp, tp),                  # rglru (L, B, dr) / slstm 4D
        "c": (None, dp, tp, None),            # slstm (L, B, H, hd)
        "conv": (None, dp, None, tp),         # (L, B, w-1, d)
    }
    last = path[-1] if path else ""
    nd = len(shape)
    if last in ("tokens", "targets"):
        return _fit((dp, None), shape, shard.mesh)
    if last in ("frames", "visual_embeds"):
        return _fit((dp, None, None), shape, shard.mesh)
    if last == "mrope_positions":
        return _fit((None, dp, None), shape, shard.mesh)
    if last == "pos" or nd == 0:
        return ()
    if last in cache_rules:
        dims = cache_rules[last]
        if last in ("h", "m") and nd == 4:   # slstm h/m: (L, B, H, hd)
            dims = (None, dp, tp, None)
        if last in ("k", "v") and "cross" in path[:-1]:
            dims = (None, dp, tp, None, None)  # (L, B, Hkv, Senc, hd)
        elif last in ("k", "v") and nd == 4:  # unstacked (B, S, Hkv, hd)
            dims = (dp, None, tp, None)
        dims = dims[:nd] if len(dims) >= nd else dims + (None,) * (
            nd - len(dims))
        return _fit(dims, shape, shard.mesh)
    if nd >= 2:
        return _fit((None, dp) + (None,) * (nd - 2), shape, shard.mesh)
    return ()


def batch_specs(tree, shard: ShardCtx):
    """Specs of batch-like leaves (cache trees) by ``_batch_rule``."""
    return _tree_map_with_path(
        lambda path, leaf: _batch_rule(path, tuple(leaf.shape), shard), tree)


def paged_pool_spec(shape, shard: ShardCtx) -> tuple:
    """Head-sharded layout of one full-attention block-pool leaf (L, NB,
    BS, Hkv, D), or of its scale leaf (L, NB, BS, Hkv): every rank owns
    its kv-head shard of every physical block, so block tables and
    lengths stay replicated host integers and no pool byte crosses
    ranks. ``_fit`` drops the head sharding when Hkv does not divide the
    model axis: the replicated pool every rank writes whole, whose kv
    heads a rank's query heads read by range (``TPPlan.kv_heads``)."""
    return _fit((None, None, None, shard.tp_axis, None), tuple(shape),
                shard.mesh)


def local_shape(shape, spec, shard: ShardCtx) -> tuple:
    """This rank's shape of a leaf of full ``shape`` under ``spec``."""
    out = list(shape)
    for d, axis in enumerate(spec):
        if axis is not None:
            out[d] //= _axis_size(shard.mesh, axis)
    return tuple(out)


def _axes(axis) -> tuple:
    return axis if isinstance(axis, tuple) else (axis,)


def shard_tensor(t, spec, shard: ShardCtx):
    """This rank's slice of the full tensor ``t`` under ``spec``, in
    storage of its own (the full tree can be dropped after)."""
    mesh = shard.mesh
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        idx, n = 0, 1
        for a in _axes(axis):            # row-major over the named axes
            idx = idx * int(mesh.shape[a]) + mesh.coord(a)
            n *= int(mesh.shape[a])
        size = t.shape[d] // n
        t = t.narrow(d, idx * size, size)
    return t.contiguous().clone()


class RankSlices(dict):
    """A param tree already cut to one rank's slices (``shard_params``'
    output, or ``init_rank_params``'): a backend takes it as it is."""


# Head-aligned leaves: a concatenation of per-head parts along the last
# dim (mLSTM w_up = [c | z], w_if = [i | f]; sLSTM w_zifo = [z|i|f|o]).
HEAD_ALIGNED_PARTS = {"w_up": 2, "w_if": 2, "w_zifo": 4}
ATTN_PROJ = ("wq", "wk", "wv", "wo")


def leaf_layout(path, shard: ShardCtx) -> str:
    """How this rank holds the leaf at ``path``: ``"spec"`` (JAX's spec),
    ``"whole"`` (kept whole for the plan) or ``"head_aligned"``."""
    plan = shard.plan
    if plan is None or len(path) < 2:
        return "spec"
    parent, name = path[-2], path[-1]
    if parent in ("attn", "xattn") and name in ATTN_PROJ and (
            plan.attn == "whole"
            or (plan.attn == "kv_replicated" and name in ("wk", "wv"))):
        return "whole"
    if parent == "mix" and name in HEAD_ALIGNED_PARTS and plan.xlstm:
        return "head_aligned"
    return "spec"


def shard_params(full, shard: ShardCtx):
    """Each rank's slices of a full param tree (the counterpart of JAX's
    ``place_params``): every rank holds the same full tree and keeps its
    slice of each leaf, by ``param_specs``, except where ``shard.plan``
    keeps a leaf whole or takes its heads' columns of each part
    (``leaf_layout``). A ``RankSlices`` tree is returned as it is."""
    if isinstance(full, RankSlices):
        return full
    specs = param_specs(full, shard)

    def one(path, t):
        how = leaf_layout(path, shard)
        if how == "whole":
            return t.contiguous().clone()
        if how == "head_aligned":
            return layers.rank_parts(
                t, HEAD_ALIGNED_PARTS[path[-1]], shard).contiguous().clone()
        return shard_tensor(t, _at(specs, path), shard)

    return RankSlices(_tree_map_with_path(one, full))


def leaf_exceptions(params, shard: ShardCtx) -> dict:
    """The paths (``/``-joined) of the leaves of a full tree (or its
    meta shapes) that ``shard_params`` keeps whole although JAX's spec
    splits them, and of the head-aligned ones."""
    specs = param_specs(params, shard)
    out = {"kept_whole": [], "head_aligned": []}

    def one(path, t):
        how = leaf_layout(path, shard)
        if how == "whole" and shard.tp_axis in _at(specs, path):
            out["kept_whole"].append("/".join(path))
        elif how == "head_aligned":
            out["head_aligned"].append("/".join(path))

    _tree_map_with_path(one, params)
    return out


def init_rank_params(model, seed: int, shard: ShardCtx = None):
    """``model``'s params from ``seed`` drawn on its device a layer at a
    time (``transformer.init_lm(per_layer=True)``: one layer's f32 draw
    at a time, for a model whose stacked blocks do not fit the card; not
    ``model.init``'s values), keeping this rank's slices of each layer
    and top-level leaf as it goes (``shard_params`` of each part), so
    the whole tree never exists at once. ``shard`` None: the whole tree,
    the single-device run to hold the ranks to. Returns a ``RankSlices``
    tree under ``shard``. An encoder-decoder (whisper_base: 74M
    parameters) is drawn whole by ``model.init``'s draw, then sliced."""
    from ..models import encdec, transformer

    gen = torch.Generator(device=model.device).manual_seed(seed)
    if model.cfg.enc_dec:
        tree = encdec.init_encdec(gen, model.cfg)
        return tree if shard is None else shard_params(tree, shard)
    if shard is None:
        return transformer.init_lm(gen, model.cfg, per_layer=True)
    return RankSlices(transformer.init_lm(
        gen, model.cfg, per_layer=True,
        keep=lambda tree: dict(shard_params(tree, shard))))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def local_zeros(meta_tree, specs, shard: ShardCtx, device):
    """Zeroed tensors of this rank's shapes on ``device`` for a tree
    built on the meta device (a pool or cache tree) and its specs."""
    return _tree_map_with_path(
        lambda path, t: torch.zeros(local_shape(t.shape, _at(specs, path),
                                                shard),
                                    dtype=t.dtype, device=device),
        meta_tree)


@dataclasses.dataclass(frozen=True)
class TPPlan:
    """What each block of one config computes on one rank of a T-rank
    model axis (``plan_tp``), and the collectives that costs.

    ``attn`` is ``"heads"`` (Hq and Hkv divide T: the rank's query and kv
    heads, its pool or ring split by kv heads), ``"kv_replicated"`` (Hq
    divides T, Hkv does not: the rank's query heads against the kv heads
    they read, ``kv_heads``, of a pool or ring every rank writes whole),
    ``"whole"`` (the whole layer on every rank, no collective) or
    ``"none"`` (no attention layer). ``q_heads``, ``kv_heads`` and
    ``experts`` are (first, count) ranges; ``mlp``, ``rglru``, ``xlstm``,
    ``slstm_ff``, ``moe`` and ``vocab`` say whether the block splits
    (``d_ff``, ``rnn_width``, the xLSTM heads, the sLSTM's FFN width, the
    experts, the vocabulary divide T). ``layers`` holds (kind, pool
    layer) for every layer in order."""

    tp: int
    rank: int
    attn: str
    q_heads: tuple
    kv_heads: tuple
    mlp: bool
    rglru: bool
    xlstm: bool
    slstm_ff: bool
    moe: bool
    experts: tuple
    vocab: bool
    layers: tuple

    def block_collectives(self, kind: str) -> int:
        """Collectives of one layer of ``kind`` for one token row window
        (its mixer and the FFN after it)."""
        attn = {"heads": 1, "kv_replicated": 1}.get(self.attn, 0)
        mixer = {"attn": attn, "local": attn, "dec": 2 * attn,
                 "rglru": 2 * self.rglru, "mlstm": 2 * self.xlstm,
                 "slstm": self.xlstm + self.slstm_ff}[kind]
        ffn = 0                         # an xLSTM block has no FFN after it
        if kind in ("attn", "local", "dec"):
            ffn = int(self.moe if self.experts[1] else self.mlp)
        elif kind == "rglru":
            ffn = int(self.mlp)
        return mixer + ffn

    def step_collectives(self, rows: int = 1) -> int:
        """Collectives of one decode step (``rows`` 1) or one verify step
        over a ``rows``-token window: the embedding and the head once,
        a pool layer once, a ring or recurrent layer once a row (the
        verify scans the decode cell)."""
        n = 2 * self.vocab
        for kind, pool in self.layers:
            n += self.block_collectives(kind) * (1 if pool else rows)
        return n

    def report(self) -> dict:
        """The plan as ``stats()["tp"]`` reports it."""
        kinds = dict.fromkeys(k for k, _ in self.layers)
        return {"plan": {"attn": self.attn, "mlp": self.mlp,
                         "rglru": self.rglru, "xlstm": self.xlstm,
                         "moe": self.moe, "vocab": self.vocab,
                         "collectives_by_kind": {
                             k: self.block_collectives(k) for k in kinds}},
                "q_heads": list(self.q_heads),
                "kv_heads": list(self.kv_heads),
                "kv_replicated": self.attn == "kv_replicated",
                "experts_local": self.experts[1],
                "experts_range": list(self.experts),
                "plan_collectives_per_step": self.step_collectives()}


def _attn_mode(cfg, tp: int) -> str:
    """Head-parallel where Hq and Hkv divide T; query heads over a
    replicated KV where Hq divides T and each rank's query heads read one
    kv head; else the whole layer on every rank."""
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    if hq % tp:
        return "whole"
    if hkv % tp == 0:
        return "heads"
    return "kv_replicated" if (hq // hkv) % (hq // tp) == 0 else "whole"


def plan_tp(cfg, shard: ShardCtx) -> TPPlan:
    """The per-block plan of ``cfg`` on this rank (``TPPlan``), chosen
    from which dimensions divide T. An encoder-decoder takes one
    attention mode for its encoder, its decoder and the cross-attention
    (its sinusoidal table needs no collective). Raises
    NotImplementedError naming the sub-item for what no plan serves: a
    VLM or a decoder-only absolute-position frontend, an xLSTM whose
    heads do not divide T."""
    from ..models import transformer
    from ..models.ssm import slstm_ffn_width

    tp, rank = shard.tp_size, shard.tp_rank
    name = f"{cfg.family}/{cfg.name}"
    if cfg.visual_prefix or cfg.rope_style == "mrope" or cfg.attn_bias \
            or (cfg.pos_embed != "none" and not cfg.enc_dec):
        raise not_ported(f"{name}'s frontend under a mesh", TP_FAMILIES)
    kinds = set(cfg.block_pattern)
    xlstm = bool(kinds & {"mlstm", "slstm"})
    if xlstm and cfg.n_heads % tp:
        raise not_ported(f"xLSTM heads that do not divide --tp {tp} "
                         f"({name}: {cfg.n_heads} heads)", TP_FAMILIES)
    attn = _attn_mode(cfg, tp) if kinds & {"attn", "local"} else "none"
    g = cfg.n_heads // cfg.n_kv_heads
    if attn in ("heads", "kv_replicated"):
        hq = cfg.n_heads // tp
        q = (rank * hq, hq)
        kv = (q[0] // g, max(hq // g, 1))
    else:
        q, kv = (0, cfg.n_heads), (0, cfg.n_kv_heads)
    E = cfg.n_experts
    moe = bool(E) and E % tp == 0
    experts = (rank * E // tp, E // tp) if moe else (0, E)
    if cfg.enc_dec:
        walk = (("dec", True),) * cfg.n_layers
    else:
        walk = tuple((kind, transformer._is_pool_kind(cfg, kind))
                     for kind in cfg.layer_kinds)
    return TPPlan(
        tp=tp, rank=rank, attn=attn, q_heads=q, kv_heads=kv,
        mlp=cfg.d_ff > 0 and cfg.d_ff % tp == 0,
        rglru="rglru" in kinds and (cfg.rnn_width or cfg.d_model) % tp == 0,
        xlstm=xlstm,
        slstm_ff="slstm" in kinds
        and slstm_ffn_width(cfg.d_model) % tp == 0,
        moe=moe, experts=experts, vocab=cfg.vocab_size % tp == 0,
        layers=walk)
