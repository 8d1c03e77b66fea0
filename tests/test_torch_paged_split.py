"""K2's split-K plan and the combine pass's plain version, on the CPU.

K2 (``csrc/paged_attention.cu``) cuts each sequence's block table into
``split_plan``'s splits, one CTA each, and ``paged_decode_combine``
merges the splits' partial softmax states (m, l, unnormalised acc).
Here the plan is checked to cover every table column exactly once from
shapes alone, and the combine's plain version (``ref.
paged_decode_combine``), fed partials cut by the plan, is held against
JAX's decode attention (``ops.paged_attention``, the Pallas kernel in
interpret mode) at the JAX package's tolerances: 1e-4 in f32, 3e-2 in
bf16. The kernels themselves are held against the plain versions on
the card (tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

import inspect
import math

import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import paged_attention as pa_mod
from repro_torch.kernels import ref
from test_torch_kernels import TDT, TOL, _pool_case

torch.set_num_threads(1)

# (B, Hkv, nbmax, BS, n_sm): chip_smoke.py's decode cases (serve's
# shape, GQA 4; 8 and 1 sequences at a 128-block table), the card
# tests' split cases (block sizes 4, 6 and 16), their older tables
# (6 wide) and edge shapes (an empty table, a block past 128 keys).
PLAN_CASES = [
    (8, 16, 40, 16, 132), (8, 4, 40, 16, 132), (8, 16, 128, 16, 132),
    (1, 16, 128, 16, 132), (4, 16, 40, 16, 132), (1, 4, 128, 16, 132),
    (4, 2, 64, 16, 132), (3, 2, 60, 6, 132), (3, 1, 96, 4, 132),
    (3, 2, 48, 16, 132), (4, 4, 40, 16, 132), (3, 2, 40, 16, 132),
    (5, 2, 6, 4, 132), (6, 2, 6, 6, 132), (1, 1, 1, 16, 132),
    (2, 2, 0, 16, 132), (2, 1, 9, 256, 132), (1, 1, 300, 1, 132),
]


def _covers_once(bps, nsplit, nbmax):
    cols = [c for s in range(nsplit)
            for c in range(s * bps, min((s + 1) * bps, nbmax))]
    return cols == list(range(nbmax))


@pytest.mark.parametrize("B,Hkv,nbmax,BS,n_sm", PLAN_CASES)
def test_split_plan_covers_every_column_once(B, Hkv, nbmax, BS, n_sm):
    bps, nsplit = pa_mod.split_plan(B, Hkv, nbmax, BS, n_sm)
    assert type(bps) is int and type(nsplit) is int
    assert nsplit >= 1 and 1 <= bps
    assert _covers_once(bps, nsplit, nbmax)
    assert (nsplit - 1) * bps < max(nbmax, 1)          # no split past it
    least = max(1, -(-pa_mod.SPLIT_TOKENS[0] // BS))
    most = max(least, pa_mod.SPLIT_TOKENS[1] // BS)
    assert least <= bps <= most <= 128                 # csrc kMaxSplitBlocks


def test_split_plan_sweep_and_the_main_path():
    """Every (B, Hkv, nbmax, BS) of a sweep is covered once; the main
    path's decode (8 slots, 16 kv heads, a 40-wide table of 16-token
    blocks) takes 10 splits of 4 blocks (1280 CTAs); the 2048-token
    cases take 128-token splits when 8 sequences fill the card and
    64-token ones for a single sequence."""
    for B in (1, 2, 8, 33):
        for Hkv in (1, 4, 16):
            for nbmax in (0, 1, 7, 40, 129):
                for BS in (1, 4, 6, 16, 200):
                    bps, nsplit = pa_mod.split_plan(B, Hkv, nbmax, BS, 132)
                    assert nsplit >= 1 and _covers_once(bps, nsplit, nbmax)
    assert pa_mod.split_plan(8, 16, 40, 16, 132) == (4, 10)
    assert pa_mod.split_plan(8, 16, 128, 16, 132) == (8, 16)
    assert pa_mod.split_plan(1, 16, 128, 16, 132) == (4, 32)


def test_split_plan_takes_shapes_only():
    """The plan is a function of ints: no tensor (so no length) reaches
    it, and a CUDA graph captured around K2 replays for any lengths."""
    params = inspect.signature(pa_mod.split_plan).parameters
    assert list(params) == ["B", "Hkv", "nbmax", "BS", "n_sm"]
    assert all(p.annotation in (int, "int") for p in params.values())


def _split_partials(q, kp, vp, bt, ln, window, bps, nsplit):
    """Each split's (m, l, acc) in torch f32, straight from the
    definition: the split's visible keys, its own max (``MASK_VALUE``
    where it sees none), exp-sums and unnormalised value sums."""
    B, Hq, D = q.shape
    BS, Hkv = kp.shape[1:3]
    S = bt.shape[1] * BS
    k, v = (p[bt.long()].reshape(B, S, Hkv, D).float()
            .repeat_interleave(Hq // Hkv, dim=2) for p in (kp, vp))
    s = torch.einsum("bhd,bshd->bhs", q.float(), k) / math.sqrt(D)
    kpos = torch.arange(S)
    lens = ln.long()[:, None]
    valid = kpos[None] < lens
    if window is not None:
        valid = valid & (kpos[None] >= lens - window)
    m = torch.full((B, Hq, nsplit), ref.MASK_VALUE)
    l = torch.zeros((B, Hq, nsplit))
    acc = torch.zeros((B, Hq, nsplit, D))
    for sp in range(nsplit):
        mask = (valid & (kpos // (bps * BS) == sp)[None])[:, None]
        if not mask.any():
            continue
        sm = s.masked_fill(~mask, float("-inf"))
        ms = torch.where(mask.any(-1), sm.amax(-1), ref.MASK_VALUE)
        p = torch.exp(sm - ms[..., None])              # 0 where masked
        m[..., sp], l[..., sp] = ms, p.sum(-1)
        acc[..., sp, :] = torch.einsum("bhs,bshd->bhd", p, v)
    return m, l, acc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (8, 1)])
@pytest.mark.parametrize("window", [None, 70])
def test_combine_of_split_partials_matches_jax(rng, dtype, hq, hkv, window):
    """Lengths 0 (no key: a zero row), 5 (every split past the first
    sees nothing), 150 (mid-table; with the window its first split lies
    wholly below the floor and the second starts inside it) and 263
    (past the 256-key table's end) over a table the plan cuts into 4
    splits of 4 blocks."""
    B, D, bs, nbmax = 4, 16, 16, 16
    lengths = [0, 5, 150, bs * nbmax + 7]
    q, kp, vp, bt, ln = _pool_case(rng, B, hq, hkv, D, bs, nbmax, lengths,
                                   dtype)
    bps, nsplit = pa_mod.split_plan(B, hkv, nbmax, bs, 132)
    assert (bps, nsplit) == (4, 4)
    m, l, acc = _split_partials(q[1], kp[1], vp[1], bt[1], ln[1], window,
                                bps, nsplit)
    assert (l[1, :, 1:] == 0).all() and (l[0] == 0).all()
    if window is not None:
        assert (l[2, :, 0] == 0).all() and (l[2, :, 1] > 0).all()
    n0 = pa_mod.paged_decode_combine.launches
    got = pa_mod.paged_decode_combine(m, l, acc, TDT[dtype])
    assert pa_mod.paged_decode_combine.launches == n0     # CPU: no kernel
    assert got.dtype == TDT[dtype] and got.shape == (B, hq, D)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    want = jops.paged_attention(q[0], {"k": kp[0], "v": vp[0]}, bt[0], ln[0],
                                mode="decode", window=window,
                                kernel_mode="interpret")
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    # and the whole wrapper (the plain version on a CPU tensor)
    np.testing.assert_allclose(
        np.asarray(pa_mod.paged_decode_attention(
            q[1], kp[1], vp[1], bt[1], ln[1], window=window).float()),
        np.asarray(got.float()), rtol=tol, atol=tol)


def test_combine_edge_states():
    """All splits empty -> exactly 0; one live split -> its acc / l; the
    order of the splits does not matter beyond rounding."""
    g = torch.Generator().manual_seed(0)
    D = 32
    m = torch.full((2, 3, 5), ref.MASK_VALUE)
    l = torch.zeros((2, 3, 5))
    acc = torch.zeros((2, 3, 5, D))
    m[1, :, 2] = torch.randn((3,), generator=g)
    l[1, :, 2] = torch.rand((3,), generator=g) + 0.5
    acc[1, :, 2] = torch.randn((3, D), generator=g)
    out = ref.paged_decode_combine(m, l, acc, torch.float32)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    torch.testing.assert_close(out[1], acc[1, :, 2] / l[1, :, 2, None])
    m[1, :, 4] = m[1, :, 2] - 1.0
    l[1, :, 4] = torch.rand((3,), generator=g) + 0.5
    acc[1, :, 4] = torch.randn((3, D), generator=g)
    perm = torch.tensor([4, 3, 2, 1, 0])
    torch.testing.assert_close(
        ref.paged_decode_combine(m, l, acc, torch.float32),
        ref.paged_decode_combine(m[..., perm], l[..., perm],
                                 acc[..., perm, :], torch.float32))
    assert torch.isfinite(ref.paged_decode_combine(m, l, acc,
                                                   torch.bfloat16).float()
                          ).all()


def test_combine_wrapper_rejects_other_devices():
    m = torch.zeros((1, 2, 3), device="meta")
    acc = torch.zeros((1, 2, 3, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pa_mod.paged_decode_combine(m, m, acc, torch.float32)
