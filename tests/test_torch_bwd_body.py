"""K1's backward bodies on the CPU, without JAX:

  1. ``flash_attention.bwd_body`` picks "wgmma" or "simt" from dtype,
     head dim, strides and alignment alone (CPU tensors: it reads no
     data);
  2. on CPU tensors the backward runs the plain version and counts no
     launch;
  3. the wgmma body's error budget: the tensor cores take P and dS as
     bf16 operands (q, k, v and dO are bf16 already) and sum in f32. The
     same roundings, emulated here in torch, stay within the card tests'
     per-element limit TOL + BWD_RTOL |plain| of ``ref.flash_attention_bwd``
     at the training heads (D 128 causal, D 120 GQA 4 with a window),
     with a quarter of the limit to spare.

The kernels themselves are held against the plain version on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

TOL, BWD_RTOL = 3e-2, 2.0 ** -7     # bf16: the card tests' K1_bwd limit


def _qkv(shape_q, shape_kv, dtype, seq_major=True, seed=0):
    """q, k, v as the training path passes them: (B, S, H, D) projections
    seen through ``.transpose(1, 2)`` (or (B, H, S, D) when not
    ``seq_major``), from numpy's generator."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in (shape_q, shape_kv, shape_kv):
        B, H, S, D = shape
        lay = (B, S, H, D) if seq_major else shape
        t = torch.from_numpy(rng.standard_normal(lay).astype(np.float32))
        t = t.to(dtype)
        out.append(t.transpose(1, 2) if seq_major else t)
    return out


# -- 1. the body from dtype, head dim, strides and alignment -----------------


@pytest.mark.parametrize("hq,hkv,D", [(16, 16, 128), (32, 8, 120),
                                      (10, 1, 256), (4, 4, 64), (4, 1, 16)])
def test_bwd_body_takes_bf16_training_layouts(hq, hkv, D):
    q, k, v = _qkv((2, hq, 96, D), (2, hkv, 96, D), torch.bfloat16)
    assert q.stride(-1) == 1 and not q.is_contiguous()
    assert fa.bwd_body(q, k, v) == "wgmma"
    q, k, v = (t.contiguous() for t in (q, k, v))
    assert fa.bwd_body(q, k, v) == "wgmma"


def test_bwd_body_leaves_f32_on_simt():
    q, k, v = _qkv((2, 4, 64, 128), (2, 4, 64, 128), torch.float32)
    assert fa.bwd_body(q, k, v) == "simt"


def test_bwd_body_leaves_a_head_dim_off_eight_on_simt():
    q, k, v = _qkv((1, 4, 64, 100), (1, 2, 64, 100), torch.bfloat16)
    assert fa.bwd_body(q, k, v) == "simt"


def test_bwd_body_leaves_a_strided_head_dim_on_simt():
    q, k, v = _qkv((1, 4, 64, 64), (1, 4, 64, 64), torch.bfloat16)
    rng = np.random.default_rng(1)
    qt = torch.from_numpy(rng.standard_normal((1, 4, 64, 64)).astype(
        np.float32)).to(torch.bfloat16).transpose(-1, -2)   # stride(-1) 64
    assert qt.stride(-1) != 1
    assert fa.bwd_body(qt, k, v) == "simt"
    assert fa.bwd_body(q, k, v) == "wgmma"


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_bwd_body_leaves_an_unaligned_base_on_simt(which):
    q, k, v = _qkv((1, 4, 64, 64), (1, 4, 64, 64), torch.bfloat16)
    named = dict(q=q, k=k, v=v)
    t = named[which].contiguous()
    buf = torch.zeros(t.numel() + 1, dtype=torch.bfloat16)
    named[which] = buf[1:].view(t.shape).copy_(t)
    assert named[which].data_ptr() % 16
    assert fa.bwd_body(**named) == "simt"


def test_bwd_on_cpu_runs_the_plain_version_and_counts_nothing():
    q, k, v = _qkv((1, 4, 40, 32), (1, 2, 40, 32), torch.bfloat16)
    do = torch.ones((1, 4, 40, 32), dtype=torch.bfloat16)
    o, lse = ref.flash_attention(q, k, v, return_lse=True)
    n0 = fa.flash_attention_bwd.launches
    by0 = dict(fa.flash_attention_bwd.launches_by_body)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    want = ref.flash_attention_bwd(q, k, v, o, lse, do)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert fa.flash_attention_bwd.launches == n0
    assert fa.flash_attention_bwd.launches_by_body == by0


# -- 3. the wgmma body's roundings against the card's limit -----------------


def _bf16_operand_bwd(q, k, v, o, lse, do, causal, window):
    """``ref.flash_attention_bwd`` with the wgmma body's roundings: S and
    dP in f32 from the bf16 inputs, P and dS rounded to bf16 before the
    three gradient products, f32 sums, the gradients rounded to bf16."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qf, dof = q.float(), do.float()
    kf = k.repeat_interleave(group, dim=1).float()
    vf = v.repeat_interleave(group, dim=1).float()
    s = qf @ kf.transpose(-1, -2) * scale
    qpos = torch.arange(Sq)[:, None]
    kpos = torch.arange(Skv)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    lse = lse[..., None]
    p = torch.where(mask & torch.isfinite(lse), torch.exp(s - lse), 0.0)
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - delta)
    pb, dsb = p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
    dv = pb.transpose(-1, -2) @ dof
    dq = dsb @ kf * scale
    dk = dsb.transpose(-1, -2) @ qf * scale
    dk = dk.reshape(B, Hkv, group, Skv, D).sum(2)
    dv = dv.reshape(B, Hkv, group, Skv, D).sum(2)
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


@pytest.mark.parametrize("hq,hkv,S,D,window", [(4, 4, 1024, 128, None),
                                               (8, 2, 1024, 120, 512)])
def test_bf16_operands_stay_within_the_card_limit(hq, hkv, S, D, window):
    """The worst element's error over its limit stays <= 0.75 for each of
    dq, dk and dv (the SIMT body's own roundings take up to ~0.5 of it on
    the card: both round an f32 sum to bf16)."""
    q, k, v = _qkv((1, hq, S, D), (1, hkv, S, D), torch.bfloat16, seed=S + D)
    rng = np.random.default_rng(D)
    do = torch.from_numpy(rng.standard_normal((1, hq, S, D)).astype(
        np.float32)).to(torch.bfloat16)
    o, lse = ref.flash_attention(q, k, v, window=window, return_lse=True)
    want = ref.flash_attention_bwd(q, k, v, o, lse, do, window=window)
    got = _bf16_operand_bwd(q, k, v, o, lse, do, True, window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        diff = (g.float() - w.float()).abs()
        ratio = (diff / (TOL + BWD_RTOL * w.float().abs())).max().item()
        assert math.isfinite(ratio) and ratio <= 0.75, (name, ratio)
