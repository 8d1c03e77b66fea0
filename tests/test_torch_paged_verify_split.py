"""K3's split body and its body chooser, on the CPU.

K3 (``csrc/paged_verify_attention.cu``) has three bodies, picked by
``paged_attention.verify_body`` from shapes, dtypes and q's alignment:
"split" for the verify step (fewer than ``SPLIT_PAIRS`` (row, group)
pairs a kv head: K2's ``split_plan`` cuts the keys into splits, one CTA
each, and K2's combine pass merges their partial softmax states),
"wgmma" for a bf16 suffix prefill a tensor map can tile, "simt" for the
rest. Here the split body's plain version (``ref.
paged_verify_split_partials`` cut by the plan, merged by ``ref.
paged_decode_combine``) is held against JAX's Pallas verify kernel in
interpret mode at the JAX package's tolerances, 1e-4 in f32 and 3e-2 in
bf16, over float, int8 and fp8 pools; and the chooser is checked to read
shapes and dtypes only. The kernels themselves are held against the
plain versions on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_verify_attention_pallas
from repro.models import paged_kv as jpk
from repro_torch.kernels import paged_attention as pa_mod
from repro_torch.kernels import ref

torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# B 4 sequences, 5 rows (the verify step of spec_tokens 4), D 16, a table
# of 16 blocks of 16 tokens that the plan cuts into 4 splits of 4 blocks.
# Lengths 0 (row j sees j + 1 keys, all in split 0), 5 (mid-block), 150
# (mid-table: with the window the first split lies below every floor)
# and 253 (the last rows' limits run past the 256-key table).
B, K1, D, BS, NBMAX = 4, 5, 16, 16, 16
LENGTHS = [0, 5, 150, BS * NBMAX - 3]


def _to_torch(a, dtype=None):
    """A JAX array as a torch tensor of the same bytes (fp8 through its
    bytes: numpy has no float8), or of ``dtype``."""
    a = np.asarray(a)
    if a.dtype.itemsize == 1 and a.dtype != np.int8:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    t = torch.from_numpy(np.asarray(a, np.float32).copy())
    return t.to(dtype) if dtype is not None else t


def _case(rng, hq, hkv, dtype, kv_dtype):
    """q, pools (float of ``dtype``, or quantized to ``kv_dtype`` by
    JAX's quantize_kv), table and lengths, as JAX and torch pairs."""
    nb = B * NBMAX + 1
    q = rng.normal(size=(B, K1, hq, D)).astype(np.float32)
    kp, vp = (rng.normal(size=(nb, BS, hkv, D)).astype(np.float32)
              for _ in range(2))
    bt = (rng.permutation(nb - 1) + 1)[:B * NBMAX].reshape(B, NBMAX) \
        .astype(np.int32)
    ln = np.asarray(LENGTHS, np.int32)
    jdt = getattr(jnp, dtype)
    jq = jnp.asarray(q, jdt)
    tq = _to_torch(jq, TDT[dtype])
    if kv_dtype is None:
        jpool = {"k": jnp.asarray(kp, jdt), "v": jnp.asarray(vp, jdt)}
        tpool = {n: _to_torch(a, TDT[dtype]) for n, a in jpool.items()}
    else:
        spec = jpk.PoolSpec(kv_dtype=kv_dtype, block_size=BS,
                            n_kv_heads=hkv, head_dim=D)
        (kq, ks), (vq, vs) = (jpk.quantize_kv(jnp.asarray(x), spec)
                              for x in (kp, vp))
        jpool = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        tpool = {n: _to_torch(a) for n, a in jpool.items()}
    return (jq, tq), jpool, tpool, (jnp.asarray(bt), torch.from_numpy(bt)), \
        (jnp.asarray(ln), torch.from_numpy(ln))


def _split_then_combine(tq, tpool, bt, ln, window):
    """The split body's plain version: per-split partials cut by the
    plan, merged over the (B, K1 * Hq) rows by the combine pass."""
    hq, hkv = tq.shape[2], tpool["k"].shape[2]
    bps, nsplit = pa_mod.split_plan(B, hkv, NBMAX, BS, 132)
    assert (bps, nsplit) == (4, 4)
    m, l, acc = ref.paged_verify_split_partials(
        tq, tpool["k"], tpool["v"], bt, ln, bps, nsplit, window=window,
        k_scale=tpool.get("k_scale"), v_scale=tpool.get("v_scale"))
    assert m.shape == l.shape == (B, K1, hq, nsplit)
    assert acc.shape == (B, K1, hq, nsplit, D)
    rows = K1 * hq
    out = ref.paged_decode_combine(m.reshape(B, rows, nsplit),
                                   l.reshape(B, rows, nsplit),
                                   acc.reshape(B, rows, nsplit, D), tq.dtype)
    return out.reshape(B, K1, hq, D), l


@pytest.mark.parametrize("dtype,kv_dtype", [("float32", None),
                                            ("bfloat16", None),
                                            ("float32", "int8"),
                                            ("bfloat16", "fp8")])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("window", [None, 70])
def test_split_partials_and_combine_match_jax(rng, dtype, kv_dtype, hq, hkv,
                                              window):
    """Groups 1 and 4 (5 and 20 pairs a kv head: the split body),
    with and without a window, over f32 / bf16 pools and int8 / fp8
    payloads; the combined partials equal JAX's verify kernel (Pallas,
    interpret mode) and the wrapper's plain version."""
    (jq, tq), jpool, tpool, (jbt, tbt), (jln, tln) = _case(
        rng, hq, hkv, dtype, kv_dtype)
    got, l = _split_then_combine(tq, tpool, tbt, tln, window)
    assert got.dtype == TDT[dtype] and got.shape == (B, K1, hq, D)
    # length 0 sees only split 0; 5 likewise; with the window, 150's
    # first split lies wholly below every row's floor
    assert (l[0, :, :, 1:] == 0).all() and (l[1, :, :, 1:] == 0).all()
    assert (l[:2, :, :, 0] > 0).all()
    if window is not None:
        assert (l[2, :, :, 0] == 0).all() and (l[2, :, :, 1] > 0).all()
    want = paged_verify_attention_pallas(
        jq, jpool["k"], jpool["v"], jbt, jln, window=window,
        k_scale=jpool.get("k_scale"), v_scale=jpool.get("v_scale"),
        interpret=True)
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    before = (pa_mod.paged_verify_attention.launches,
              pa_mod.paged_verify_attention.k4_launches,
              dict(pa_mod.paged_verify_attention.launches_by_body))
    plain = pa_mod.paged_verify_attention(
        tq, tpool["k"], tpool["v"], tbt, tln, window=window,
        k_scale=tpool.get("k_scale"), v_scale=tpool.get("v_scale"))
    assert before == (pa_mod.paged_verify_attention.launches,    # CPU: no
                      pa_mod.paged_verify_attention.k4_launches,  # kernel
                      pa_mod.paged_verify_attention.launches_by_body)
    np.testing.assert_allclose(np.asarray(plain.float()),
                               np.asarray(got.float()), rtol=tol, atol=tol)


def test_split_partials_of_a_window_of_one():
    """A window of 1 over length 0: row j sees only key j, so its one
    live split (split j of one-block splits: blocks of 1 token) holds
    l = 1 and acc = that key's value, and every other split is exactly
    empty (m = MASK_VALUE, l = 0, acc = 0)."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn((1, 3, 2, 16), generator=g)
    kp, vp = (torch.randn((5, 1, 2, 16), generator=g) for _ in range(2))
    bt = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    ln = torch.zeros((1,), dtype=torch.int32)
    m, l, acc = ref.paged_verify_split_partials(q, kp, vp, bt, ln, 1, 4,
                                                window=1)
    for j in range(3):
        torch.testing.assert_close(l[0, j, :, j], torch.ones(2))
        torch.testing.assert_close(acc[0, j, :, j], vp[1 + j, 0])
        live = torch.arange(4) == j
        assert (m[0, j][:, ~live] == ref.MASK_VALUE).all()
        assert (l[0, j][:, ~live] == 0).all()
        assert (acc[0, j][:, ~live] == 0).all()
    out = ref.paged_decode_combine(m.reshape(1, 6, 4), l.reshape(1, 6, 4),
                                   acc.reshape(1, 6, 4, 16), torch.float32)
    torch.testing.assert_close(out.reshape(3, 2, 16), vp[1:4, 0])


def _shapes(K1, hq, hkv, D, bs, nbmax, dtype=torch.bfloat16, pool=None,
            device="cpu"):
    q = torch.empty((2, K1, hq, D), dtype=dtype, device=device)
    kp = torch.empty((9, bs, hkv, D), dtype=pool or dtype, device=device)
    bt = torch.empty((2, nbmax), dtype=torch.int32, device=device)
    return q, kp, bt


@pytest.mark.parametrize("K1,hq,hkv,D,bs,nbmax,dtype,pool,want", [
    # the verify step, every q type and payload: split
    (5, 16, 16, 128, 16, 40, torch.bfloat16, None, "split"),
    (5, 16, 4, 128, 16, 40, torch.bfloat16, None, "split"),
    (5, 16, 16, 128, 16, 40, torch.float32, None, "split"),
    (5, 16, 16, 128, 16, 40, torch.bfloat16, torch.float8_e4m3fn, "split"),
    (5, 16, 16, 128, 16, 40, torch.float32, torch.int8, "split"),
    (4, 4, 2, 16, 6, 8, torch.bfloat16, None, "split"),      # BS 6
    (31, 8, 8, 64, 16, 8, torch.bfloat16, None, "split"),    # 31 pairs
    (16, 4, 4, 128, 16, 40, torch.float32, None, "split"),   # bucket 16
    # 32 pairs and more: the suffix prefill
    (32, 8, 8, 64, 16, 8, torch.bfloat16, None, "wgmma"),
    (8, 16, 4, 128, 16, 40, torch.bfloat16, None, "wgmma"),  # 8 x 4
    (5, 16, 2, 128, 16, 40, torch.bfloat16, None, "wgmma"),  # verify, G 8
    (256, 16, 16, 128, 16, 40, torch.bfloat16, None, "wgmma"),
    (256, 16, 16, 128, 16, 40, torch.bfloat16, torch.float8_e4m3fn,
     "wgmma"),
    (256, 16, 16, 128, 16, 40, torch.bfloat16, torch.int8, "wgmma"),
    (64, 10, 1, 256, 16, 160, torch.bfloat16, None, "wgmma"),
    (64, 4, 4, 16, 8, 20, torch.bfloat16, None, "wgmma"),    # D 16, BS 8
    (64, 4, 4, 32, 64, 4, torch.bfloat16, None, "wgmma"),    # BS 64
    (64, 4, 4, 32, 128, 4, torch.bfloat16, None, "wgmma"),   # BS 128
    # what the tensor cores or a tensor map cannot take: simt
    (256, 16, 16, 128, 16, 40, torch.float32, None, "simt"),
    (256, 16, 16, 128, 16, 40, torch.float32, torch.int8, "simt"),
    (64, 4, 4, 32, 4, 40, torch.bfloat16, None, "simt"),     # BS 4
    (64, 8, 2, 64, 6, 40, torch.bfloat16, None, "simt"),     # BS 6
    (64, 8, 2, 64, 24, 40, torch.bfloat16, None, "simt"),    # BS 24
    (64, 8, 2, 120, 16, 40, torch.bfloat16, None, "simt"),   # D 120
    (64, 8, 2, 64, 16, 1025, torch.bfloat16, None, "simt"),  # table
])
def test_verify_body_by_shape_and_dtype(K1, hq, hkv, D, bs, nbmax, dtype,
                                        pool, want):
    q, kp, bt = _shapes(K1, hq, hkv, D, bs, nbmax, dtype, pool)
    assert pa_mod.verify_body(q, kp, bt) == want
    # meta tensors hold no data: the choice reads no value (no length,
    # no table entry), so a captured graph replays for any of them
    assert pa_mod.verify_body(*_shapes(K1, hq, hkv, D, bs, nbmax, dtype,
                                       pool, device="meta")) == want


def test_verify_body_reads_no_lengths_and_needs_aligned_q():
    """The chooser takes no lengths at all, and a bf16 q whose base is
    not 16-byte aligned (no 16-byte load takes it) runs "simt"."""
    assert list(inspect.signature(pa_mod.verify_body).parameters) == [
        "q", "k_pool", "block_table"]
    q, kp, bt = _shapes(64, 8, 2, 64, 16, 40)
    flat = torch.empty(q.numel() + 8, dtype=torch.bfloat16)
    odd = flat[1:1 + q.numel()].view(q.shape)
    assert odd.data_ptr() % 16 and pa_mod.verify_body(odd, kp, bt) == "simt"
    assert pa_mod.verify_body(flat[8:].view(q.shape), kp, bt) == "wgmma"
    assert pa_mod.VERIFY_BODIES == ("simt", "wgmma", "split")
    assert set(pa_mod.paged_verify_attention.launches_by_body) == set(
        pa_mod.VERIFY_BODIES)


def test_main_path_verify_takes_ten_splits():
    """spec_serve's verify step (8 slots, 16 kv heads, a 40-block table of
    16 tokens) runs split over K2's plan: 10 splits of 4 blocks, 1280
    CTAs where the first design had 128."""
    q, kp, bt = _shapes(5, 16, 16, 128, 16, 40)
    assert pa_mod.verify_body(q, kp, bt) == "split"
    assert pa_mod.split_plan(8, 16, 40, 16, 132) == (4, 10)
