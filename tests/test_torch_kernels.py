"""The port's kernel plain versions (repro_torch.kernels.ref, reached
through the wrappers on CPU tensors) against the JAX package's Pallas
kernels in interpret mode and its jnp oracles.

Sweeps mirror tests/test_kernels.py (flash attention: GQA groups 1/2/8,
causal / non-causal / window 16) and tests/test_paged_serve.py (paged
decode: ragged lengths mid-block, on a block boundary, a single token
and a full table; window 5). Tolerances are the JAX package's own: 1e-4
in f32, 3e-2 in bf16. The CUDA kernels themselves are held against these
plain versions on the card (tests/test_torch_cuda_kernels.py and
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import configs
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ops, paged_attention as pa_mod
from repro_torch.models import transformer
from repro_torch.models.model import Model

torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a, dtype):
    """The same numpy array as a JAX and a torch tensor of ``dtype``."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(TDT[dtype])
    return jnp.asarray(a, getattr(jnp, dtype)), t


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 16)])
def test_flash_attention_matches_jax(rng, dtype, hq, hkv, causal, window):
    B, S, D = 2, 80, 32
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.normal(size=(B, h, S, D)), dtype) for h in (hq, hkv, hkv))
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == TDT[dtype] and got.shape == (B, hq, S, D)
    tol = TOL[dtype]
    want_ref = jref.flash_attention(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want_ref), rtol=tol, atol=tol)
    if dtype == "float32":      # Pallas interpret mode: the kernel body
        want_k = jops.flash_attention(jq, jk, jv, causal=causal,
                                      window=window, block_q=32, block_k=32,
                                      mode="interpret")
        np.testing.assert_allclose(_f32(got), _f32(want_k), rtol=tol,
                                   atol=tol)


def test_flash_attention_bf16_d64(rng):
    """The bf16 case of tests/test_kernels.py (D = 64), kernel body in
    interpret mode."""
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.normal(size=(1, 2, 64, 64)), "bfloat16") for _ in range(3))
    got = ops.flash_attention(tq, tk, tv)
    want = jops.flash_attention(jq, jk, jv, block_q=32, block_k=32,
                                mode="interpret")
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=3e-2, atol=3e-2)


def _pool_case(rng, B, hq, hkv, hd, bs, nbmax, lengths, dtype):
    nb = B * nbmax + 1
    q = _pair(rng.normal(size=(B, hq, hd)), dtype)
    kp = _pair(rng.normal(size=(nb, bs, hkv, hd)), dtype)
    vp = _pair(rng.normal(size=(nb, bs, hkv, hd)), dtype)
    perm = rng.permutation(nb - 1) + 1          # scrambled physical ids
    bt = perm[:B * nbmax].reshape(B, nbmax).astype(np.int32)
    ln = np.asarray(lengths, np.int32)
    return q, kp, vp, (jnp.asarray(bt), torch.from_numpy(bt)), \
        (jnp.asarray(ln), torch.from_numpy(ln))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("window", [None, 5])
def test_paged_decode_matches_jax(rng, dtype, hq, hkv, window):
    # ragged: mid-block, exact block boundary, single token, full table
    q, kp, vp, bt, ln = _pool_case(rng, 4, hq, hkv, 16, 4, 4, [7, 8, 1, 16],
                                   dtype)
    got = ops.paged_attention(q[1], {"k": kp[1], "v": vp[1]}, bt[1], ln[1],
                              mode="decode", window=window)
    assert got.dtype == TDT[dtype] and got.shape == (4, hq, 16)
    want = jops.paged_attention(q[0], {"k": kp[0], "v": vp[0]}, bt[0], ln[0],
                                mode="decode", window=window,
                                kernel_mode="interpret")
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_paged_decode_scale_from_logical_head_dim(rng):
    """``ops.paged_attention`` takes the softmax scale from q's head dim
    (JAX ops.py:166), as the oracle does by default."""
    q, kp, vp, bt, ln = _pool_case(rng, 2, 4, 2, 32, 8, 2, [5, 11],
                                   "float32")
    got = ops.paged_attention(q[1], {"k": kp[1], "v": vp[1]}, bt[1], ln[1])
    want = jref.paged_decode_attention(q[0], kp[0], vp[0], bt[0], ln[0],
                                       scale=1 / np.sqrt(32))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4, atol=1e-4)


def test_unported_paged_modes_raise(rng):
    """An unknown mode is a ValueError (JAX ops.py:160), and so is a pool
    that carries only one of the two scale leaves of a quantized pool
    (kernel K4 reads both)."""
    q, kp, vp, bt, ln = _pool_case(rng, 2, 4, 2, 16, 4, 2, [3, 5],
                                   "float32")
    with pytest.raises(ValueError, match="mode"):
        ops.paged_attention(q[1], {"k": kp[1], "v": vp[1]}, bt[1], ln[1],
                            mode="prefill")
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        ops.paged_attention(q[1], {"k": kp[1], "v": vp[1],
                                   "k_scale": kp[1][..., 0]}, bt[1], ln[1])


def test_cpu_tensors_never_launch_a_kernel(rng):
    """A CPU tensor takes the plain version: neither launch counter moves
    (the counters count CUDA kernel launches only)."""
    def counts():
        return (fa_mod.flash_attention.launches,
                pa_mod.paged_decode_attention.launches,
                pa_mod.paged_verify_attention.launches)

    before = counts()
    t = torch.from_numpy(rng.normal(size=(1, 2, 8, 16)).astype(np.float32))
    ops.flash_attention(t, t, t)
    q, kp, vp, bt, ln = _pool_case(rng, 2, 4, 2, 16, 4, 2, [3, 5],
                                   "float32")
    ops.paged_attention(q[1], {"k": kp[1], "v": vp[1]}, bt[1], ln[1])
    ops.paged_attention(q[1][:, None], {"k": kp[1], "v": vp[1]}, bt[1],
                        ln[1], mode="verify")
    assert counts() == before


def test_wrappers_reject_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device is
    refused, never silently computed elsewhere."""
    t = torch.zeros((1, 2, 4, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fa_mod.flash_attention(t, t, t)
    q = torch.zeros((1, 2, 16), device="meta")
    pool = torch.zeros((2, 4, 2, 16), device="meta")
    idx = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pa_mod.paged_decode_attention(q, pool, pool, idx, idx[0])
    with pytest.raises(ValueError, match="CUDA"):
        pa_mod.paged_verify_attention(q[:, None], pool, pool, idx, idx[0])


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_every_accepted_config_has_kernels_built_for_it(arch):
    """Every full-size config the port accepts (``check_supported`` and a
    paged decode path in ``serving_caps``) has a head dim K1 is built for
    (gemma's 256, danube's 120 among them) and, where a layer keeps its
    K/V in the block pool, the head dim and group K2 and K3 are built
    for. A config the port refuses has nothing to check."""
    cfg = configs.get_config(arch)
    try:
        transformer.check_supported(cfg)
    except NotImplementedError:
        return
    if not Model(cfg, device="cpu").serving_caps().paged_decode:
        return
    assert fa_mod.supports(cfg.head_dim), (arch, cfg.head_dim)
    if any(transformer._is_pool_kind(cfg, k) for k in cfg.block_pattern):
        group = cfg.n_heads // cfg.n_kv_heads
        for mode in ("decode", "verify"):
            assert pa_mod.supports(cfg.head_dim, group, mode), (arch, mode)


def test_flash_attention_head_dims_past_a_power_of_two(rng):
    """The plain version at head dims 120 and 256 (danube, recurrentgemma
    / gemma) with GQA and MQA windows, against JAX's oracle; the K1
    wrapper takes any head dim up to 256 and no wider."""
    for hq, hkv, D, window in ((8, 2, 120, 16), (10, 1, 256, 24)):
        (jq, tq), (jk, tk), (jv, tv) = (
            _pair(rng.normal(size=(1, h, 40, D)), "float32")
            for h in (hq, hkv, hkv))
        got = ops.flash_attention(tq, tk, tv, causal=True, window=window)
        want = jref.flash_attention(jq, jk, jv, causal=True, window=window)
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4,
                                   atol=1e-4)
    assert fa_mod.supports(120) and fa_mod.supports(256)
    assert not fa_mod.supports(0) and not fa_mod.supports(264)
