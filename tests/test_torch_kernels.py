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
    """Every full-size config the port accepts (``check_supported``)
    with attention layers has a head dim K1 is built for (gemma's 256,
    danube's 120, whisper's 64, qwen2-vl's 128 at group 6 among them)
    and, where it has a paged decode path and a layer keeps its K/V in
    the block pool, the head dim and group K2 and K3 are built for
    (qwen3's and kimi's group 8, whisper's decoder). A config without
    attention (xLSTM) has nothing to check."""
    cfg = configs.get_config(arch)
    transformer.check_supported(cfg)
    if not {"attn", "local"} & set(cfg.block_pattern):
        return
    assert fa_mod.supports(cfg.head_dim), (arch, cfg.head_dim)
    if not Model(cfg, device="cpu").serving_caps().paged_decode:
        return
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


# ---------------------------------------------------------------------------
# K1 / K6 body choice: a function of the inputs alone (dtype, head dim,
# strides, alignment), so CPU tensors show it without a launch
# ---------------------------------------------------------------------------

SERVED_ARCHS = ("olmo_1b", "yi_6b", "gemma_7b", "recurrentgemma_2b",
                "h2o_danube_3_4b")


@pytest.mark.parametrize("arch", SERVED_ARCHS)
def test_flash_attention_body_of_every_served_config(arch, monkeypatch):
    """K1's inputs as the model's prefill passes them (the (B, S, H, D)
    projections, rotated where the config rotates, as transposed views)
    at the config's own head counts and head dim: bf16 takes the
    tensor-core body, f32 the SIMT body. A narrow d_model keeps it
    small; it changes no stride K1 sees."""
    from repro_torch.models import attention

    cfg = configs.get_config(arch)
    hq, hkv, hd, d, S = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 16, 8
    seen = []

    def spy(q, k, v, **kw):
        seen.append((fa_mod.body(q, k, v), q.dtype, q.shape[-1],
                     q.is_contiguous()))
        return fa_mod.flash_attention(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        params = {name: torch.randn(shape, generator=gen).to(dtype)
                  for name, shape in (("wq", (d, hq * hd)),
                                      ("wk", (d, hkv * hd)),
                                      ("wv", (d, hkv * hd)),
                                      ("wo", (hq * hd, d)))}
        x = torch.randn((2, S, d), generator=gen).to(dtype)
        out, _ = attention.attend(params, cfg, x, torch.arange(S))
        assert out.shape == (2, S, d)
    assert seen == [("wgmma", torch.bfloat16, hd, False),
                    ("simt", torch.float32, hd, False)]


def test_flash_attention_body_rejects_what_tma_cannot_describe():
    bf = torch.bfloat16
    q = torch.zeros((1, 4, 32, 64), dtype=bf)
    assert fa_mod.body(q, q, q) == "wgmma"
    f = q.float()
    assert fa_mod.body(f, f, f) == "simt"                  # f32
    for D in (100, 12, 264):                               # D % 8, > 256
        odd = torch.zeros((1, 4, 32, D), dtype=bf)
        assert fa_mod.body(odd, odd, odd) == "simt", D
    mis = torch.zeros(1 + q.numel(), dtype=bf)[1:].view(q.shape)
    assert mis.data_ptr() % 16
    assert fa_mod.body(mis, q, q) == fa_mod.body(q, q, mis) == "simt"
    # a head stride of 36 elements (72 bytes) is no tensor-map stride
    x = torch.zeros((1, 32, 4, 36), dtype=bf)[..., :32].transpose(1, 2)
    assert fa_mod.body(x, x, x) == "simt"
    # size-1 dims are never stepped along: their strides do not matter
    one = torch.zeros((1, 9, 1, 64), dtype=bf).transpose(1, 2)
    assert one.stride()[:3] == (576, 64, 64) and one.shape[:2] == (1, 1)
    assert fa_mod.body(one, one, one) == "wgmma"
    assert fa_mod._strides(one) == (8, 8, 64)


def test_stx_matmul_body_from_shape_dtype_and_alignment():
    from repro_torch.kernels import stx_matmul as k6_mod

    bf = torch.bfloat16

    def mats(M, K, N, dtype=bf):
        return torch.empty((M, K), dtype=dtype), torch.empty((K, N),
                                                             dtype=dtype)

    assert k6_mod.body(*mats(4096, 2048, 8192)) == "wgmma"   # tile_path
    assert k6_mod.body(*mats(1000, 64, 296)) == "wgmma"      # ragged M, N
    assert k6_mod.body(*mats(77, 136, 200)) == "wgmma"       # ragged K
    assert k6_mod.body(*mats(4096, 2048, 8192, torch.float32)) == "simt"
    for M, K, N in ((1000, 700, 300), (1, 7, 300), (129, 1, 127),
                    (70, 50, 130), (64, 64, 300)):
        assert k6_mod.body(*mats(M, K, N)) == "simt", (M, K, N)
    mis = torch.empty(1 + 64 * 64, dtype=bf)[1:].view(64, 64)
    assert k6_mod.body(mis, torch.empty((64, 64), dtype=bf)) == "simt"
    assert k6_mod.body(torch.empty((64, 64), dtype=bf), mis) == "simt"


def test_cpu_tensors_count_no_body():
    """The per-body counters move only with a CUDA launch."""
    from repro_torch.kernels import stx_matmul as k6_mod

    before = (dict(fa_mod.flash_attention.launches_by_body),
              dict(k6_mod.stx_matmul.launches_by_body))
    t = torch.zeros((1, 2, 8, 16), dtype=torch.bfloat16)
    ops.flash_attention(t, t, t)
    ops.stx_matmul(torch.zeros((8, 16), dtype=torch.bfloat16),
                   torch.zeros((16, 8), dtype=torch.bfloat16))
    assert (fa_mod.flash_attention.launches_by_body,
            k6_mod.stx_matmul.launches_by_body) == before
    assert set(before[0]) == set(before[1]) == {"simt", "wgmma"}
