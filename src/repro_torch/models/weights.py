"""The weight bridge: JAX param trees <-> the port's params.

``from_jax_numpy`` takes the JAX package's param tree as nested dicts of
numpy arrays (``jax.tree.map(np.asarray, params)``, or the ``.npy`` per
leaf a checkpoint holds) and returns the same tree of torch tensors under
the same paths, the stacked ``(count, ...)`` group leaves included, so
the port runs on exactly the reference's weights: the decoder-only
``groups`` layout, or the encoder-decoder's ``enc`` / ``dec`` stacks.
``to_numpy`` is the inverse. Both are exact: values are copied, never recomputed.
``state_from_jax_numpy`` carries a whole train state (params and
optimizer state) the same way, so a port run can start from JAX's exact
state.

Some leaves stay f32 whatever the model dtype: the RG-LRU's decay
parameter ``lam`` (JAX ``ssm.py:321``) and the MoE ``router`` (JAX
``moe.py:37``), so a cast to bf16 leaves them alone (``F32_LEAVES``).

numpy has no bfloat16 of its own: JAX's bf16 leaves arrive as a numpy
dtype named ``bfloat16`` (2-byte payloads, reinterpreted bit for bit
here), and ``to_numpy`` returns bf16 leaves as float32 arrays, which hold
every bf16 value exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tree import map_tree
from .encdec import DEC_KEYS, ENC_KEYS
from .transformer import layer_walk


F32_LEAVES = ("lam", "router")   # leaf names kept f32 in any dtype


def _from_numpy(a) -> torch.Tensor:
    a = np.array(a, copy=True)            # owned, writable, contiguous
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _check_stacked(name, sub, keys, count):
    if set(sub) != set(keys):
        raise ValueError(f"{name}: keys {sorted(sub)} != {sorted(keys)}")

    def lead(t):
        if t.shape[0] != count:
            raise ValueError(f"{name}: leaf of shape {tuple(t.shape)} is "
                             f"not stacked over {count} layers")
    map_tree(lead, sub)


def check_layout(tree, cfg):
    """Raise ValueError unless the tree has ``cfg``'s stacked layout: for
    an encoder-decoder, ``enc`` / ``dec`` with ``encdec.ENC_KEYS`` /
    ``DEC_KEYS``, every leaf led by the stack's layer count; else
    ``tree["groups"]`` with one ``g{g}/p{pi}`` subtree per pattern
    position, every leaf led by the group's layer count."""
    if cfg.enc_dec:
        _check_stacked("enc", tree.get("enc", {}), ENC_KEYS,
                       cfg.n_encoder_layers)
        _check_stacked("dec", tree.get("dec", {}), DEC_KEYS, cfg.n_layers)
        return
    groups = tree.get("groups", {})
    want = {gk: (len(pattern), count) for gk, pattern, count in
            layer_walk(cfg)}
    if set(groups) != set(want):
        raise ValueError(f"groups {sorted(groups)} != {sorted(want)}")
    for gk, (n_pos, count) in want.items():
        _check_stacked(gk, groups[gk], [f"p{pi}" for pi in range(n_pos)],
                       count)


def to_device(tree, device, dtype=None):
    """Copy every leaf to ``device`` (and floating leaves to ``dtype``,
    except those named in ``F32_LEAVES``)."""
    if isinstance(tree, dict):
        return {k: v.to(device) if k in F32_LEAVES
                else to_device(v, device, dtype) for k, v in tree.items()}
    t = tree.to(device)
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def from_jax_numpy(tree, cfg, device, dtype=None):
    """JAX param tree of numpy arrays -> the port's params on ``device``.

    ``dtype`` (optional) casts floating leaves, e.g. to run f32 reference
    weights in bf16 on the card. Raises ValueError when the tree does not
    have ``cfg``'s stacked layout (``check_layout``).
    """
    params = map_tree(_from_numpy, tree)
    check_layout(params, cfg)
    return to_device(params, device, dtype)


def state_from_jax_numpy(state, cfg, device):
    """A JAX train state ``{"params", "opt": {"step", "m", "v" | "fac",
    "comp"}}`` of numpy arrays -> the same tree of tensors on ``device``,
    leaf for leaf and dtype for dtype (bf16 leaves bit for bit); raises
    ValueError when the params do not have ``cfg``'s layout. The inverse
    is ``to_numpy``."""
    out = map_tree(_from_numpy, state)
    check_layout(out["params"], cfg)
    return map_tree(lambda t: t.to(device), out)


def to_numpy(params):
    """The port's params -> nested dicts of numpy arrays (bf16 leaves as
    float32)."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return map_tree(leaf, params)
