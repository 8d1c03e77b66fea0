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

The ``fsdp`` layout, ``opt_state_specs`` and a seq-sharded decode cache
wait for the sub-items that need them (``make_shard_ctx`` raises).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .mesh import SHARDED_TRAINING, SUBMESHES, TP_FAMILIES, not_ported


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
    rank, the collectives' backend, and the collectives (all, and those
    of the decode / verify steps, per step) with their bytes on this
    rank."""
    return {"tp": shard.tp_size, "rank": shard.tp_rank,
            "backend": shard.backend, "device": str(device),
            "collectives": shard.stats.collectives,
            "collective_bytes": shard.stats.bytes,
            "step_collectives": step_collectives,
            "collectives_per_step": step_collectives / max(steps, 1)}


def make_shard_ctx(mesh, layout: str = "2d",
                   tp_axis: str = "model") -> ShardCtx:
    """The ``ShardCtx`` of ``mesh``; raises for what is not ported: the
    ``fsdp`` layout (sharded training) and a data axis above 1 (FSDP
    under one engine, or replicas on submeshes)."""
    if tp_axis not in mesh.axis_names:
        raise ValueError(f"mesh has no {tp_axis!r} axis: {mesh.axis_names}")
    if layout != "2d":
        raise not_ported(f"the {layout!r} layout", SHARDED_TRAINING)
    dp = tuple(a for a in mesh.axis_names if a != tp_axis)
    if any(int(mesh.shape[a]) > 1 for a in dp):
        raise not_ported(
            f"a data axis above 1 inside one engine (mesh {mesh.shape}: "
            "FSDP, or replicas on submeshes with --dp)", SUBMESHES)
    return ShardCtx(mesh=mesh, dp_axes=dp, tp_axis=tp_axis, layout=layout)


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
    model axis (the replicated-pool fallback, refused by the engine)."""
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


def shard_params(full, shard: ShardCtx):
    """Each rank's slices of a full param tree (the counterpart of JAX's
    ``place_params``): every rank holds the same full tree and keeps its
    slice of each leaf, by ``param_specs``."""
    specs = param_specs(full, shard)
    return _tree_map_with_path(
        lambda path, t: shard_tensor(t, _at(specs, path), shard), full)


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


def check_tp_supported(cfg, shard: ShardCtx):
    """Raise NotImplementedError for a config this slice does not serve
    over a mesh: only decoder-only stacks whose every layer is full
    attention with no window (olmo_1b, yi_6b, gemma_7b), with heads and
    vocabulary that divide the model axis, shard their pool by heads;
    everything else names its sub-item."""
    from ..models.paged_kv import head_shard_ok

    tp = shard.tp_size
    name = f"{cfg.family}/{cfg.name}"
    if cfg.enc_dec:
        raise not_ported(f"an encoder-decoder ({name}) under a mesh "
                         "(encdec.paged_cache_specs)", TP_FAMILIES)
    if cfg.is_moe:
        raise not_ported(f"the MoE's expert parallelism ({name}: "
                         "apply_moe_sharded)", TP_FAMILIES)
    if set(cfg.block_pattern) != {"attn"} or cfg.sliding_window:
        raise not_ported(
            f"recurrent, windowed or xLSTM layers over TP ({name}: "
            f"{sorted(set(cfg.block_pattern))}, window "
            f"{cfg.sliding_window})", TP_FAMILIES)
    if cfg.visual_prefix or cfg.rope_style == "mrope" \
            or cfg.pos_embed != "none" or cfg.attn_bias:
        raise not_ported(f"{name}'s frontend under a mesh", TP_FAMILIES)
    if tp > 1 and not head_shard_ok(cfg, tp):
        raise not_ported(
            f"the replicated-pool fallback ({name}: {cfg.n_heads} / "
            f"{cfg.n_kv_heads} heads do not divide --tp {tp})",
            TP_FAMILIES)
    if cfg.vocab_size % tp or cfg.d_ff % tp:
        raise not_ported(
            f"a vocabulary or MLP width that does not divide --tp {tp} "
            f"({name}: vocab {cfg.vocab_size}, d_ff {cfg.d_ff})",
            TP_FAMILIES)
