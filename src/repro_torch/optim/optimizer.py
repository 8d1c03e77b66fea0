"""Optimizers: AdamW and Adafactor-lite, with Kahan-compensated
parameter accumulation.

Counterpart of ``repro/optim/optimizer.py``, field for field and
expression for expression: the same f32 arithmetic in the same order,
over the port's nested-dict trees walked in JAX's flatten order
(``repro_torch.tree``), so the global norm adds its per-leaf sums as
JAX does. ``kahan=True`` keeps a compensation buffer in the params'
dtype that recovers the low bits a bf16 ``p += delta`` drops.

Every function is pure: it returns new trees and leaves its inputs
alone, as JAX's does. ``global_norm(tile="vrp")`` adds the per-leaf
sums by the compensated sum (``kernels/ops.vrp_sum``: kernel K8b on the
card, its plain version on the CPU); no gradient flows through it.

On identical gradients the elementwise updates equal JAX's bit for bit
on the CPU. Reductions (each leaf's sum of squares, Adafactor's row and
column means) add in torch's order, not XLA's, and may differ in the
last bit.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import tree as tr


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"              # adamw | adafactor
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"     # m/v dtype (bfloat16 halves memory)
    kahan: bool = False              # compensated parameter accumulation
    grad_accum: int = 1              # microbatch accumulation steps
    accum_dtype: str = "float32"     # microbatch grad accumulator dtype
    # 'vrp' computes the global grad norm with compensated reduction.
    norm_tile: str = "vec"


def _sqrt(x):
    """Correctly rounded f32 square root, as XLA's and CUDA's. torch's
    vectorized CPU ``sqrt`` is not (661 of 1e5 random f32 values off by
    an ulp on an AVX-512 host), so on the CPU it goes through f64, whose
    rounding to f32 is exact for a square root."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def init_opt_state(params, cfg: OptConfig):
    sd = getattr(torch, cfg.state_dtype)

    def zeros(p, shape=None):
        return torch.zeros(p.shape if shape is None else shape, dtype=sd,
                           device=p.device)

    first = tr.leaves(params)
    device = first[0].device if first else None
    state = {"step": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.kind == "adamw":
        state["m"] = tr.map_tree(zeros, params)
        state["v"] = tr.map_tree(zeros, params)
    elif cfg.kind == "adafactor":
        def fact(p):
            if p.dim() >= 2:
                return {"row": zeros(p, p.shape[:-1]),
                        "col": zeros(p, p.shape[:-2] + p.shape[-1:])}
            return {"v": zeros(p)}
        state["fac"] = tr.map_tree(fact, params)
    else:
        raise ValueError(cfg.kind)
    if cfg.kahan:
        state["comp"] = tr.map_tree(torch.zeros_like, params)
    return state


def global_norm(tree, tile: str = "vec"):
    """Global L2 norm; 'vrp' adds the per-leaf sums by the compensated
    (double-word) sum."""
    sums = [torch.sum(torch.square(x.float())) for x in tr.leaves(tree)]
    if tile == "vrp":
        from ..kernels import ops as kops
        total = kops.vrp_sum(torch.stack(sums))
        return torch.sqrt(total[0] + total[1])
    return torch.sqrt(sum(sums))


def clip_by_global_norm(grads, max_norm: float, tile: str = "vec"):
    norm = global_norm(grads, tile)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tr.map_tree(lambda g: (g.float() * scale).to(g.dtype),
                       grads), norm


def _kahan_add(p, delta, comp):
    """p + delta with compensation carried in ``comp`` (same dtype as p)."""
    pf = p.float()
    y = delta - comp.float()
    t = (pf + y).to(p.dtype)
    new_comp = ((t.float() - pf) - y).to(p.dtype)
    return t, new_comp


def apply_updates(params, grads, state, cfg: OptConfig, lr):
    """One optimizer step. Returns (new_params, new_state, metrics)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, cfg.norm_tile)
    step = state["step"] + 1
    new_state = {"step": step}
    sd = getattr(torch, cfg.state_dtype)
    flat_p = tr.leaves(params)
    flat_g = tr.leaves(grads)
    t = step.to(torch.float32)

    if cfg.kind == "adamw":
        bc1 = 1.0 - cfg.b1 ** t
        bc2 = 1.0 - cfg.b2 ** t

        def upd(p, g, m, v):
            gf = g.float()
            mf = cfg.b1 * m.float() + (1 - cfg.b1) * gf
            vf = cfg.b2 * v.float() + (1 - cfg.b2) * gf * gf
            delta = (mf / bc1) / (_sqrt(vf / bc2) + cfg.eps)
            delta = delta + cfg.weight_decay * p.float()
            return -lr * delta, mf.to(sd), vf.to(sd)

        out = [upd(*a) for a in zip(flat_p, flat_g, tr.leaves(state["m"]),
                                     tr.leaves(state["v"]))]
        new_state["m"] = tr.unflatten(params, [o[1] for o in out])
        new_state["v"] = tr.unflatten(params, [o[2] for o in out])
    else:  # adafactor (factored second moment; memory ~ O(n+m) per matrix)
        beta2 = 1.0 - t ** -0.8

        def upd_fac(p, g, f):
            gf = g.float()
            g2 = gf * gf + 1e-30
            if p.dim() >= 2:
                row = beta2 * f["row"].float() + (1 - beta2) * g2.mean(-1)
                col = beta2 * f["col"].float() + (1 - beta2) * g2.mean(-2)
                rm = row.mean(-1, keepdim=True)
                vhat = (row / (rm + 1e-30))[..., None] * col[..., None, :]
                newf = {"row": row.to(sd), "col": col.to(sd)}
            else:
                vhat = beta2 * f["v"].float() + (1 - beta2) * g2
                newf = {"v": vhat.to(sd)}
            delta = gf / (_sqrt(vhat) + 1e-30)
            # update clipping (Adafactor's d=1.0 RMS rule)
            rms = _sqrt(torch.mean(delta * delta) + 1e-30)
            delta = delta / torch.clamp(rms, min=1.0)
            delta = delta + cfg.weight_decay * p.float()
            return -lr * delta, newf

        # JAX flattens the factor tree only down to the params' leaves
        fac = _leaves_up_to(params, state["fac"])
        out = [upd_fac(p, g, f) for p, g, f in zip(flat_p, flat_g, fac)]
        new_state["fac"] = tr.unflatten(params, [o[1] for o in out])

    deltas = [o[0] for o in out]
    if cfg.kahan:
        pairs = [_kahan_add(p, d, c) for p, d, c in
                 zip(flat_p, deltas, tr.leaves(state["comp"]))]
        new_params = tr.unflatten(params, [pr[0] for pr in pairs])
        new_state["comp"] = tr.unflatten(params, [pr[1] for pr in pairs])
    else:
        new_params = tr.unflatten(
            params, [(p.float() + d).to(p.dtype)
                     for p, d in zip(flat_p, deltas)])
    return new_params, new_state, {"grad_norm": gnorm}


def _leaves_up_to(params, tree):
    """``tree``'s subtrees at the leaf paths of ``params`` (JAX's
    ``flatten_up_to``), in JAX's order."""
    out = []
    for path, _ in tr.flatten(params):
        sub = tree
        for k in path:
            sub = sub[k]
        out.append(sub)
    return out
