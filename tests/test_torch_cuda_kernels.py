"""The port's hand-written CUDA kernels (K1, K2, K3, K4, the
quantized-pool path of K2 and K3, K5, the RG-LRU scan, and the tile
layer's K6 matmul, K7 stencils and K8 compensated dot / sum) against
their plain-torch versions, on the card.

Marked ``cuda``: on a machine without a GPU every test skips (the
``cuda_device`` fixture decides at run time). This file imports no JAX,
so it also runs on a GPU machine that has none:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_cuda_kernels.py

Tolerances are the JAX package's kernel tolerances: 1e-4 in f32 (the
kernels sum in another order than the plain version) and 3e-2 in bf16
(the output is rounded to bf16). K6 is held relatively, as
``tests/test_kernels.py`` holds the Pallas matmul (rtol 1e-5 / atol
1e-4 in f32, 3e-2 / 3e-1 in bf16: a long f32 sum in another order), K7
in f32 and the K8 lanes exactly (``torch.equal``: they round every
operation as their plain versions do, in the same order). K1, K3, K5,
K6, K7b and K8 have several bodies; their tests name the body each case
must run (``launches_by_body``), and K5 and K7b hold both bodies to the
plain version bit for bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa_mod
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as k5_mod
from repro_torch.kernels import stx_matmul as k6_mod
from repro_torch.kernels import stx_stencil as k7_mod
from repro_torch.kernels import vrp_dot as k8_mod
from repro_torch.models import paged_kv

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen).to(device=device, dtype=dtype)


def _close(got, want, dtype):
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], f"max abs err {err} > {TOL[dtype]}"


def _ran_body(counter, before):
    """The one body a single launch went through, from the per-body
    counters before and after it."""
    moved = [b for b, n in counter.launches_by_body.items()
             if n != before[b]]
    assert len(moved) == 1 and counter.launches_by_body[moved[0]] \
        == before[moved[0]] + 1, (before, counter.launches_by_body)
    return moved[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,hq,hkv,Sq,Skv,D,causal,window", [
    (2, 4, 4, 80, 80, 32, True, None),
    (2, 4, 2, 80, 80, 32, False, None),
    (2, 8, 1, 80, 80, 32, True, 16),
    (1, 2, 2, 64, 64, 64, True, None),
    (2, 4, 2, 33, 33, 16, True, None),
    (1, 4, 1, 7, 130, 16, False, 5),
    (2, 16, 16, 512, 512, 128, True, None),
    (1, 16, 4, 200, 200, 128, True, None),
    (2, 4, 4, 200, 200, 16, True, None),     # D 16 in the 64-wide tile
    (2, 4, 2, 130, 130, 48, True, 40),       # D 48, a window that bites
    (2, 8, 2, 300, 300, 64, True, None),     # GQA 4, ragged Sq
    (1, 8, 2, 333, 333, 120, True, 100),     # danube's D 120 in 128
    (2, 16, 4, 256, 256, 128, True, None),   # GQA 4 at D 128
    (1, 10, 1, 700, 700, 256, True, 128),    # MQA 10, D 256, window
    (2, 4, 4, 200, 200, 256, True, None),    # D 256, causal
    (1, 4, 1, 77, 300, 64, False, None),     # Sq < Skv, not causal
    (2, 4, 4, 100, 37, 128, False, None),    # Sq > Skv, ragged both
    (1, 2, 2, 300, 100, 64, False, 50),      # rows >= 149 see no key
    (1, 4, 2, 64, 200, 128, False, 20),      # a window, not causal
])
def test_flash_attention_kernel_matches_plain(cuda_device, dtype, B, hq, hkv,
                                              Sq, Skv, D, causal, window):
    """Both bodies (bf16 the tensor cores, f32 the CUDA cores) against the
    plain version: head dims 16 to 256, GQA 4 and MQA 10, windows that
    bite, kv tiles skipped whole and rows with no visible key (output
    0), ragged Sq and Skv."""
    gen = torch.Generator().manual_seed(B * 1000 + Sq + D)
    q = _randn(gen, (B, hq, Sq, D), dtype, cuda_device)
    k = _randn(gen, (B, hkv, Skv, D), dtype, cuda_device)
    v = _randn(gen, (B, hkv, Skv, D), dtype, cuda_device)
    n0 = fa_mod.flash_attention.launches
    before = dict(fa_mod.flash_attention.launches_by_body)
    got = fa_mod.flash_attention(q, k, v, causal=causal, window=window)
    assert fa_mod.flash_attention.launches == n0 + 1
    assert _ran_body(fa_mod.flash_attention, before) == (
        "wgmma" if dtype == torch.bfloat16 else "simt")
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, ref.flash_attention(q, k, v, causal=causal, window=window),
           dtype)
    if window is not None and not causal and Sq > Skv + window:
        assert torch.equal(got[:, :, Skv + window:],
                           torch.zeros_like(got[:, :, Skv + window:]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,hq,hkv,Sq,D,window", [
    (2, 16, 16, 300, 256, None),          # gemma_7b: causal, D 256
    (1, 10, 1, 2304, 256, 2048),          # recurrentgemma: MQA, window bites
    (2, 32, 8, 512, 120, 4096),           # h2o-danube: GQA 4, D 120
    (1, 8, 2, 200, 120, 64),              # D 120 with a biting window
    (2, 4, 2, 70, 48, None),              # a head dim in a wider tile
])
def test_flash_attention_kernel_wide_and_odd_head_dims(
        cuda_device, dtype, B, hq, hkv, Sq, D, window):
    """K1 at head dims 256 and 120 / 48 (a logical width inside a wider
    tile: loads past it zero, stores skipped), MQA group 10, windows that
    bite; bf16 on the tensor-core body (64-row query tiles at D 256),
    f32 on the SIMT body (32-row tiles at D 256)."""
    gen = torch.Generator().manual_seed(B * 1000 + Sq + D)
    q = _randn(gen, (B, hq, Sq, D), dtype, cuda_device)
    k = _randn(gen, (B, hkv, Sq, D), dtype, cuda_device)
    v = _randn(gen, (B, hkv, Sq, D), dtype, cuda_device)
    n0 = fa_mod.flash_attention.launches
    before = dict(fa_mod.flash_attention.launches_by_body)
    got = fa_mod.flash_attention(q, k, v, causal=True, window=window)
    assert fa_mod.flash_attention.launches == n0 + 1
    assert _ran_body(fa_mod.flash_attention, before) == (
        "wgmma" if dtype == torch.bfloat16 else "simt")
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, ref.flash_attention(q, k, v, causal=True, window=window),
           dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,hq,hkv,Sq,Skv,D,causal", [
    (2, 8, 8, 1500, 1500, 64, False),     # whisper's exact-length encoder
    (2, 8, 8, 37, 1500, 64, False),       # whisper's dense cross-attention
    (2, 12, 2, 512, 512, 128, True),      # qwen2-vl: GQA 12/2, group 6
])
def test_flash_attention_kernel_at_encdec_and_vlm_shapes(
        cuda_device, dtype, B, hq, hkv, Sq, Skv, D, causal):
    """K1 at the shapes the encoder-decoder and the VLM give it: the
    non-causal encoder over 1500 frames, the non-causal cross-attention
    of a prompt over them, and qwen2-vl's causal prefill at GQA 12/2
    (group 6), against the plain version; bf16 on the tensor-core body,
    f32 on the SIMT body."""
    gen = torch.Generator().manual_seed(Sq + Skv + D)
    q = _randn(gen, (B, hq, Sq, D), dtype, cuda_device)
    k = _randn(gen, (B, hkv, Skv, D), dtype, cuda_device)
    v = _randn(gen, (B, hkv, Skv, D), dtype, cuda_device)
    before = dict(fa_mod.flash_attention.launches_by_body)
    got = fa_mod.flash_attention(q, k, v, causal=causal)
    assert _ran_body(fa_mod.flash_attention, before) == (
        "wgmma" if dtype == torch.bfloat16 else "simt")
    _close(got, ref.flash_attention(q, k, v, causal=causal), dtype)


@pytest.mark.parametrize("D", [64, 120, 256])
def test_flash_attention_kernel_strided_inputs(cuda_device, D):
    """(B, S, H, D) projections pass as transposed views, no copy: the
    model's layout (head stride D, row stride H * D), GQA 2, read by the
    tensor-core body's 4-D tensor maps."""
    gen = torch.Generator().manual_seed(D)
    x = _randn(gen, (2, 150, 4 + 2 + 2, D), torch.bfloat16, cuda_device)
    q = x[:, :, :4].transpose(1, 2)
    k, v = x[:, :, 4:6].transpose(1, 2), x[:, :, 6:].transpose(1, 2)
    assert not q.is_contiguous()
    before = dict(fa_mod.flash_attention.launches_by_body)
    got = fa_mod.flash_attention(q, k, v)
    assert _ran_body(fa_mod.flash_attention, before) == "wgmma"
    _close(got, ref.flash_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous()), torch.bfloat16)


def test_flash_attention_bodies_by_input(cuda_device):
    """f32, a head dim that is no multiple of 8 and a misaligned base run
    the SIMT body (and match the plain version); aligned bf16 the
    tensor-core one."""
    gen = torch.Generator().manual_seed(3)
    counter = fa_mod.flash_attention
    cases = []
    a = _randn(gen, (1, 4, 90, 64), torch.bfloat16, cuda_device)
    cases.append(((a, a, a), "wgmma"))
    f = a.float()
    cases.append(((f, f, f), "simt"))
    odd = _randn(gen, (1, 4, 90, 100), torch.bfloat16, cuda_device)
    cases.append(((odd, odd, odd), "simt"))
    buf = _randn(gen, (1 + a.numel(),), torch.bfloat16, cuda_device)
    mis = buf[1:].view(a.shape)
    cases.append(((mis, a, a), "simt"))
    for (q, k, v), want in cases:
        before = dict(counter.launches_by_body)
        got = counter(q, k, v)
        assert _ran_body(counter, before) == want
        _close(got, ref.flash_attention(q, k, v), q.dtype)


def _pool_case(gen, B, hq, hkv, D, bs, nbmax, lengths, dtype, device):
    nb = B * nbmax + 1
    q = _randn(gen, (B, hq, D), dtype, device)
    kp = _randn(gen, (nb, bs, hkv, D), dtype, device)
    vp = _randn(gen, (nb, bs, hkv, D), dtype, device)
    perm = torch.randperm(nb - 1, generator=gen) + 1
    bt = perm[:B * nbmax].reshape(B, nbmax).to(torch.int32).to(device)
    ln = torch.tensor(lengths, dtype=torch.int32, device=device)
    return q, kp, vp, bt, ln


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,D,bs,window", [
    (4, 4, 16, 4, None), (4, 2, 16, 4, 5), (8, 1, 16, 4, None),
    (4, 2, 32, 8, None), (8, 2, 64, 16, 7), (16, 16, 128, 16, None),
    (16, 4, 128, 16, 40), (4, 2, 16, 6, None),
])
def test_paged_decode_kernel_matches_plain(cuda_device, dtype, hq, hkv, D,
                                           bs, window):
    gen = torch.Generator().manual_seed(hq * 100 + D + bs)
    nbmax = 6
    lengths = [7, 8, 1, bs * nbmax, 2 * bs + 3]
    q, kp, vp, bt, ln = _pool_case(gen, len(lengths), hq, hkv, D, bs,
                                   nbmax, lengths, dtype, cuda_device)
    n0 = pa_mod.paged_decode_attention.launches
    got = pa_mod.paged_decode_attention(q, kp, vp, bt, ln, window=window)
    assert pa_mod.paged_decode_attention.launches == n0 + 1
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, ref.paged_decode_attention(q, kp, vp, bt, ln, window=window),
           dtype)


def test_paged_decode_kernel_reads_only_visible_blocks(cuda_device):
    """Table entries past a sequence's last visible block are never
    dereferenced: poison them with out-of-range ids and the result still
    matches the plain version on a clean table."""
    gen = torch.Generator().manual_seed(3)
    q, kp, vp, bt, ln = _pool_case(gen, 3, 4, 2, 32, 4, 5, [5, 1, 9],
                                   torch.float32, cuda_device)
    want = ref.paged_decode_attention(q, kp, vp, bt, ln)
    poisoned = bt.clone()
    for b, L in enumerate([5, 1, 9]):
        poisoned[b, -(-L // 4):] = 1 << 30
    _close(pa_mod.paged_decode_attention(q, kp, vp, poisoned, ln), want,
           torch.float32)


def _plan(B, hkv, nbmax, bs, device):
    return pa_mod.split_plan(B, hkv, nbmax, bs, pa_mod.sm_count(device))


SPLIT_CASES = [  # hq, hkv, D, bs, nbmax, lengths, window
    (16, 16, 128, 16, 40, [513, 300, 258, 17], None),   # serve's decode
    (16, 4, 128, 16, 128, [2048], None),                # B 1, GQA 4
    (8, 2, 64, 16, 64, [1000, 700, 5, 0], 200),         # floors mid-split
    (4, 2, 32, 6, 60, [359, 100, 369], None),           # BS 6, past the end
    (8, 1, 16, 4, 96, [387, 200, 33], 50),              # MQA 8, window
    (8, 2, 256, 16, 48, [700, 768, 769], 300),          # D 256, past the end
]


def _split_call(gen, dtype, kv_dtype, hq, hkv, D, bs, nbmax, lengths,
                window, device):
    """K2 (or K4 with ``kv_dtype``) at a table the plan cuts into 4 or
    more splits: one call checked against the plain version, the call
    counters and the combine's."""
    B = len(lengths)
    bps, nsplit = _plan(B, hkv, nbmax, bs, device)
    assert nsplit >= 4, (bps, nsplit)
    q, kp, vp, bt, ln = _pool_case(gen, B, hq, hkv, D, bs, nbmax, lengths,
                                   dtype, device)
    kw = {}
    if kv_dtype is not None:
        kp, vp, kw["k_scale"], kw["v_scale"] = _quant_pool(
            kp.float(), vp.float(), kv_dtype)
    fn = pa_mod.paged_decode_attention
    before = (fn.launches, fn.k4_launches,
              pa_mod.paged_decode_combine.launches)
    got = fn(q, kp, vp, bt, ln, window=window, **kw)
    assert (fn.launches, fn.k4_launches,
            pa_mod.paged_decode_combine.launches) == (
        before[0] + (kv_dtype is None), before[1] + (kv_dtype is not None),
        before[2] + 1)
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, ref.paged_decode_attention(q, kp, vp, bt, ln, window=window,
                                           **kw), dtype)
    if 0 in lengths:
        row = lengths.index(0)
        assert torch.equal(got[row], torch.zeros_like(got[row]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,D,bs,nbmax,lengths,window", SPLIT_CASES)
def test_paged_decode_split_kernel_matches_plain(cuda_device, dtype, hq, hkv,
                                                 D, bs, nbmax, lengths,
                                                 window):
    """K2 split over 4 to 32 CTAs a (sequence, kv head): one sequence
    alone, window floors inside a split and splits wholly below them,
    splits past the length, block size 6, lengths past the table's end,
    a sequence with no key (a zero row)."""
    gen = torch.Generator().manual_seed(nbmax * 100 + D + bs)
    _split_call(gen, dtype, None, hq, hkv, D, bs, nbmax, lengths, window,
                cuda_device)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,D,bs,nbmax,lengths,window", SPLIT_CASES)
def test_paged_decode_split_k4_matches_plain(cuda_device, kv_dtype, dtype,
                                             hq, hkv, D, bs, nbmax, lengths,
                                             window):
    """The same split cases over an int8 / fp8 pool (K4)."""
    gen = torch.Generator().manual_seed(nbmax * 100 + D + bs + 1)
    _split_call(gen, dtype, kv_dtype, hq, hkv, D, bs, nbmax, lengths, window,
                cuda_device)


def test_paged_decode_split_reads_only_visible_blocks(cuda_device):
    """At a table wide enough to split (10 splits of 4 blocks), entries
    past each sequence's last visible block are never dereferenced: a
    split reads only its visible entries, so poisoned ids change
    nothing."""
    gen = torch.Generator().manual_seed(4)
    lengths = [70, 1, 300]
    assert _plan(3, 2, 40, 16, cuda_device)[1] == 10
    q, kp, vp, bt, ln = _pool_case(gen, 3, 4, 2, 32, 16, 40, lengths,
                                   torch.float32, cuda_device)
    want = ref.paged_decode_attention(q, kp, vp, bt, ln)
    poisoned = bt.clone()
    for b, L in enumerate(lengths):
        poisoned[b, -(-L // 16):] = 1 << 30
    _close(pa_mod.paged_decode_attention(q, kp, vp, poisoned, ln), want,
           torch.float32)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nsplit,D", [(1, 16), (5, 128), (10, 128),
                                      (33, 256), (7, 64)])
def test_paged_decode_combine_kernel_matches_plain(cuda_device, out_dtype,
                                                   nsplit, D):
    """The combine kernel against ``ref.paged_decode_combine`` on random
    partial states: splits that saw no key (m = kMaskValue, l = 0, acc =
    0) among live ones, and rows whose splits all saw none (exactly 0)."""
    gen = torch.Generator().manual_seed(nsplit * 1000 + D)
    B, Hq = 3, 8
    m = torch.randn((B, Hq, nsplit), generator=gen) * 3
    l = torch.rand((B, Hq, nsplit), generator=gen) * 5 + 0.1
    acc = torch.randn((B, Hq, nsplit, D), generator=gen) * 4
    empty = torch.rand((B, Hq, nsplit), generator=gen) < 0.4
    empty[1, 2] = True                                 # a row with no key
    m[empty] = ref.MASK_VALUE
    l[empty] = 0.0
    acc[empty] = 0.0
    m, l, acc = (t.to(cuda_device) for t in (m, l, acc))
    n0 = pa_mod.paged_decode_combine.launches
    got = pa_mod.paged_decode_combine(m, l, acc, out_dtype)
    assert pa_mod.paged_decode_combine.launches == n0 + 1
    assert got.dtype == out_dtype and got.shape == (B, Hq, D)
    _close(got, ref.paged_decode_combine(m, l, acc, out_dtype), out_dtype)
    assert torch.equal(got[1, 2], torch.zeros_like(got[1, 2]))


def test_paged_decode_replays_in_a_cuda_graph(cuda_device):
    """One K2 call (split kernel + combine) captured in a CUDA graph and
    replayed after q, the lengths and the table change in place equals
    the plain version on the new inputs: the plan reads no device value
    and the scratch comes from the graph's pool."""
    gen = torch.Generator().manual_seed(8)
    q, kp, vp, bt, ln = _pool_case(gen, 4, 16, 4, 128, 16, 40,
                                   [300, 17, 513, 64], torch.bfloat16,
                                   cuda_device)
    assert _plan(4, 4, 40, 16, cuda_device)[1] > 1
    fn = pa_mod.paged_decode_attention
    fn(q, kp, vp, bt, ln)                          # build and warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    n0, c0 = fn.launches, pa_mod.paged_decode_combine.launches
    with torch.cuda.graph(graph):
        out = fn(q, kp, vp, bt, ln)
    assert (fn.launches, pa_mod.paged_decode_combine.launches) == (
        n0 + 1, c0 + 1)
    for lengths in ([640, 1, 200, 0], [5, 639, 77, 400]):
        q.copy_(_randn(gen, tuple(q.shape), q.dtype, cuda_device))
        ln.copy_(torch.tensor(lengths, dtype=torch.int32))
        bt.copy_(bt.flip(0).roll(1, dims=1))
        graph.replay()
        _close(out, ref.paged_decode_attention(q, kp, vp, bt, ln),
               torch.bfloat16)
    assert fn.launches == n0 + 1                  # replays count nothing


def _verify_case(gen, B, K1, hq, hkv, D, bs, nbmax, lengths, dtype, device):
    nb = B * nbmax + 1
    q = _randn(gen, (B, K1, hq, D), dtype, device)
    kp = _randn(gen, (nb, bs, hkv, D), dtype, device)
    vp = _randn(gen, (nb, bs, hkv, D), dtype, device)
    perm = torch.randperm(nb - 1, generator=gen) + 1
    bt = perm[:B * nbmax].reshape(B, nbmax).to(torch.int32).to(device)
    ln = torch.tensor(lengths, dtype=torch.int32, device=device)
    return q, kp, vp, bt, ln


def _verify_call(fn_args, kw, dtype, want_body, quant=False):
    """One K3 / K4 call: the call counters, the combine's (a split call
    with more than one split launches it) and the body it ran."""
    fn = pa_mod.paged_verify_attention
    q, kp, vp, bt, ln = fn_args
    before = dict(fn.launches_by_body)
    counts = (fn.launches, fn.k4_launches,
              pa_mod.paged_decode_combine.launches)
    got = fn(q, kp, vp, bt, ln, **kw)
    assert _ran_body(fn, before) == want_body
    nsplit = _plan(q.shape[0], kp.shape[2], bt.shape[1], kp.shape[1],
                   q.device)[1] if want_body == "split" else 1
    assert (fn.launches, fn.k4_launches,
            pa_mod.paged_decode_combine.launches) == (
        counts[0] + (not quant), counts[1] + quant,
        counts[2] + (nsplit > 1))
    assert got.dtype == dtype and got.shape == q.shape
    return got


# (K1, hq, hkv, D, bs, window, body): the body an f32 and a bf16 q run,
# from verify_body's rule: fewer than 32 (row, group) pairs "split", a
# bf16 q over blocks a tensor map tiles "wgmma", else "simt"
VERIFY_CASES = [
    (5, 4, 4, 16, 4, None, ("split", "split")),
    (5, 4, 2, 16, 4, 5, ("split", "split")),
    (5, 8, 1, 16, 4, None, ("simt", "simt")),       # 40 pairs, BS 4
    (5, 4, 2, 32, 8, None, ("split", "split")),
    (5, 8, 2, 64, 16, 7, ("split", "split")),
    (5, 16, 16, 128, 16, None, ("split", "split")),
    (5, 16, 4, 128, 16, 40, ("split", "split")),
    (7, 16, 4, 128, 16, None, ("split", "split")),  # 28 pairs: 8 a warp
    (4, 4, 2, 16, 6, None, ("split", "split")),     # BS 6
    (5, 16, 2, 128, 16, None, ("simt", "wgmma")),   # verify at group 8
    (64, 4, 4, 32, 4, None, ("simt", "simt")),      # BS 4
    (64, 8, 2, 64, 16, 20, ("simt", "wgmma")),
    (64, 8, 2, 32, 8, None, ("simt", "wgmma")),     # D 32 in a 64 tile
    (64, 4, 4, 128, 64, 100, ("simt", "wgmma")),    # BS 64
    (40, 4, 2, 64, 128, None, ("simt", "wgmma")),   # BS 128: half a block
    (256, 16, 16, 128, 16, None, ("simt", "wgmma")),
    (256, 4, 1, 16, 16, None, ("simt", "wgmma")),
    (128, 16, 4, 256, 16, 50, ("simt", "wgmma")),   # D 256, GQA 4
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K1,hq,hkv,D,bs,window,bodies", VERIFY_CASES)
def test_paged_verify_kernel_matches_plain(cuda_device, dtype, K1, hq, hkv,
                                           D, bs, window, bodies):
    """K3 over both regimes: verify windows (K1 4 to 7) and suffix
    prefill (K1 40 to 256), every head dim and group, windows, block
    sizes 4 to 128 and one that is no power of two; lengths at zero,
    mid-block, a block boundary and deep, and a row whose limits run
    past the table. Each case names the body it runs."""
    gen = torch.Generator().manual_seed(K1 * 1000 + hq * 100 + D + bs)
    nbmax = -(-(K1 + 3 * bs + 2) // bs) + 2
    lengths = [0, 3, 2 * bs, nbmax * bs - 2, bs + 1]
    args = _verify_case(gen, len(lengths), K1, hq, hkv, D, bs, nbmax,
                        lengths, dtype, cuda_device)
    got = _verify_call(args, {"window": window}, dtype,
                       bodies[dtype == torch.bfloat16])
    _close(got, ref.paged_verify_attention(*args, window=window), dtype)


# (hq, hkv, D, bs, nbmax, lengths, window): split verify at tables the
# plan cuts into 4 or more splits
VERIFY_SPLIT_CASES = [
    (16, 16, 128, 16, 40, [513, 300, 258, 17, 0, 600, 44, 250], None),
    (16, 4, 128, 16, 128, [2040], None),                # B 1, GQA 4
    (8, 2, 64, 16, 64, [1000, 700, 5, 0], 200),         # floors mid-split
    (4, 2, 32, 6, 60, [357, 100, 369], None),           # BS 6, past the end
    (8, 1, 16, 4, 96, [387, 200, 33], 50),              # MQA 8 (40 pairs)
    (8, 2, 256, 16, 48, [700, 766, 769], 300),          # D 256, past the end
]


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,D,bs,nbmax,lengths,window",
                         VERIFY_SPLIT_CASES)
def test_paged_verify_split_kernel_matches_plain(cuda_device, kv_dtype,
                                                 dtype, hq, hkv, D, bs,
                                                 nbmax, lengths, window):
    """K3's split body (and K4 inside it) over 4 to 32 splits a (sequence,
    kv head), the combine launched by the same call: window floors inside
    a split and splits wholly below them, splits past the limits, lengths
    past the table's end, a sequence of length 0. MQA 8's 40 pairs are
    past the split body: it runs "simt" there (f32 q, and BS 4 for bf16)."""
    K1 = 5
    B = len(lengths)
    pairs = K1 * hq // hkv
    assert _plan(B, hkv, nbmax, bs, cuda_device)[1] >= 4
    gen = torch.Generator().manual_seed(nbmax * 100 + D + bs + 7)
    q, kp, vp, bt, ln = _verify_case(gen, B, K1, hq, hkv, D, bs, nbmax,
                                     lengths, dtype, cuda_device)
    kw = {"window": window}
    if kv_dtype is not None:
        kp, vp, kw["k_scale"], kw["v_scale"] = _quant_pool(
            kp.float(), vp.float(), kv_dtype)
    want_body = "split" if pairs < pa_mod.SPLIT_PAIRS else "simt"
    got = _verify_call((q, kp, vp, bt, ln), kw, dtype, want_body,
                       quant=kv_dtype is not None)
    _close(got, ref.paged_verify_attention(q, kp, vp, bt, ln, **kw), dtype)


def test_paged_verify_kernel_row_j_is_decode_at_length(cuda_device):
    """Row j of K3 equals K2 at lengths + 1 + j (K3 counts the tokens
    before the window, K2 the tokens including the current one)."""
    gen = torch.Generator().manual_seed(11)
    q, kp, vp, bt, ln = _verify_case(gen, 3, 5, 8, 2, 64, 16, 6,
                                     [0, 17, 40], torch.float32, cuda_device)
    got = pa_mod.paged_verify_attention(q, kp, vp, bt, ln)
    for j in range(5):
        _close(got[:, j], pa_mod.paged_decode_attention(
            q[:, j].contiguous(), kp, vp, bt, ln + 1 + j), torch.float32)


@pytest.mark.parametrize("dtype,K1,bs,body", [
    (torch.float32, 5, 4, "split"), (torch.float32, 40, 8, "simt"),
    (torch.bfloat16, 40, 8, "wgmma")])
def test_paged_verify_kernel_reads_only_visible_blocks(cuda_device, dtype,
                                                       K1, bs, body):
    """Table entries past every row's limit (the NULL tail of a suffix
    chain, unallocated growth) are never dereferenced, by any of the
    three bodies: poisoned with out-of-range ids, the result still
    matches the clean table. A slot with length 0 and an all-null table
    reads only block 0."""
    gen = torch.Generator().manual_seed(5)
    lengths = [5, 0, 9]
    nbmax = -(-(max(lengths) + K1) // bs) + 3
    q, kp, vp, bt, ln = _verify_case(gen, 3, K1, 4, 2, 32, bs, nbmax,
                                     lengths, dtype, cuda_device)
    bt[1] = 0
    want = ref.paged_verify_attention(q, kp, vp, bt, ln)
    poisoned = bt.clone()
    for b, L in enumerate(lengths):
        poisoned[b, -(-(L + K1) // bs):] = 1 << 30
    before = dict(pa_mod.paged_verify_attention.launches_by_body)
    got = pa_mod.paged_verify_attention(q, kp, vp, poisoned, ln)
    assert _ran_body(pa_mod.paged_verify_attention, before) == body
    _close(got, want, dtype)


def test_paged_verify_replays_in_a_cuda_graph(cuda_device):
    """A K3 call of each body captured in a CUDA graph and replayed after
    q, the lengths and the table change in place equals the plain version
    on the new inputs: the body and the split plan read no device value,
    and the split body's scratch (and its combine) come from the graph's
    pool. bf16 verify runs "split" with more than one split, bf16 suffix
    "wgmma" (bf16 and fp8 pools), f32 suffix "simt"."""
    fn = pa_mod.paged_verify_attention
    for dtype, K1, kv_dtype, body in (
            (torch.bfloat16, 5, None, "split"),
            (torch.bfloat16, 64, None, "wgmma"),
            (torch.bfloat16, 64, "fp8", "wgmma"),
            (torch.float32, 40, None, "simt")):
        gen = torch.Generator().manual_seed(9 + K1)
        nbmax = 40
        q, kp, vp, bt, ln = _verify_case(gen, 4, K1, 16, 4, 128, 16, nbmax,
                                         [300, 17, 513, 64], dtype,
                                         cuda_device)
        kw = {}
        if kv_dtype is not None:
            kp, vp, kw["k_scale"], kw["v_scale"] = _quant_pool(
                kp.float(), vp.float(), kv_dtype)
        if body == "split":
            assert _plan(4, 4, nbmax, 16, cuda_device)[1] > 1
        fn(q, kp, vp, bt, ln, **kw)                # build and warm up
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        before = dict(fn.launches_by_body)
        with torch.cuda.graph(graph):
            out = fn(q, kp, vp, bt, ln, **kw)
        assert _ran_body(fn, before) == body
        for lengths in ([640 - K1, 1, 200, 0], [5, 639 - K1, 77, 400]):
            q.copy_(_randn(gen, tuple(q.shape), q.dtype, cuda_device))
            ln.copy_(torch.tensor(lengths, dtype=torch.int32))
            bt.copy_(bt.flip(0).roll(1, dims=1))
            graph.replay()
            _close(out, ref.paged_verify_attention(q, kp, vp, bt, ln, **kw),
                   dtype)
        after = dict(fn.launches_by_body)
        assert after[body] == before[body] + 1    # replays count nothing


def test_kernels_reject_unsupported_shapes(cuda_device):
    t = torch.zeros((1, 2, 8, 264), device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        fa_mod.flash_attention(t, t, t)
    q = torch.zeros((1, 6, 16), device=cuda_device)
    pool = torch.zeros((2, 4, 2, 16), device=cuda_device)
    bt = torch.zeros((1, 1), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="group"):
        pa_mod.paged_decode_attention(q, pool, pool, bt, bt[0])
    with pytest.raises(ValueError, match="group \\* head dim"):
        wide = torch.zeros((2, 4, 1, 256), device=cuda_device)
        pa_mod.paged_decode_attention(
            torch.zeros((1, 8, 256), device=cuda_device), wide, wide, bt,
            bt[0])
    with pytest.raises(ValueError, match="int32"):
        pa_mod.paged_decode_attention(q[:, :4], pool, pool, bt.long(),
                                      bt[0])
    qv = torch.zeros((1, 5, 6, 16), device=cuda_device)
    with pytest.raises(ValueError, match="group"):
        pa_mod.paged_verify_attention(qv, pool, pool, bt, bt[0])
    with pytest.raises(ValueError, match="head dim"):
        pa_mod.paged_verify_attention(
            torch.zeros((1, 5, 4, 48), device=cuda_device),
            torch.zeros((2, 4, 2, 48), device=cuda_device),
            torch.zeros((2, 4, 2, 48), device=cuda_device), bt, bt[0])
    with pytest.raises(ValueError, match="int32"):
        pa_mod.paged_verify_attention(qv[:, :, :4], pool, pool, bt.long(),
                                      bt[0])
    with pytest.raises(ValueError, match=r"\(B, K1, Hq, D\)"):
        pa_mod.paged_verify_attention(q, pool, pool, bt, bt[0])



# ---------------------------------------------------------------------------
# K4: int8 / fp8 payloads with per-(token, head) scales, dequantized inside
# K2 and K3
# ---------------------------------------------------------------------------


def _quant_pool(kp, vp, kv_dtype):
    """An int8/fp8 pool (payload + f32 scales) from float pools."""
    spec = paged_kv.PoolSpec(kv_dtype=kv_dtype, n_kv_heads=kp.shape[2],
                             head_dim=kp.shape[3])
    kq, ks = paged_kv.quantize_kv(kp, spec)
    vq, vs = paged_kv.quantize_kv(vp, spec)
    return kq, vq, ks, vs


K4_CASES = [  # hq, hkv, D, bs, window
    (4, 4, 16, 4, None), (4, 2, 32, 8, 5), (8, 2, 64, 16, None),
    (16, 16, 128, 16, None), (16, 4, 128, 16, 40), (8, 1, 128, 16, None),
    (16, 16, 256, 16, None), (8, 2, 256, 16, 9), (4, 2, 64, 6, None),
]


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,D,bs,window", K4_CASES)
def test_paged_decode_k4_matches_plain(cuda_device, kv_dtype, dtype, hq,
                                       hkv, D, bs, window):
    """K2 over an int8/fp8 pool (K4): every head dim 16..256, GQA groups
    1..8, windows, a block size that is no power of two, and a length
    past the table's end."""
    gen = torch.Generator().manual_seed(hq * 100 + D + bs + 1)
    nbmax = 6
    lengths = [7, 8, 1, bs * nbmax, 2 * bs + 3, bs * nbmax + 5]
    q, kp, vp, bt, ln = _pool_case(gen, len(lengths), hq, hkv, D, bs,
                                   nbmax, lengths, dtype, cuda_device)
    kq, vq, ks, vs = _quant_pool(kp.float(), vp.float(), kv_dtype)
    n0 = pa_mod.paged_decode_attention.k4_launches
    n2 = pa_mod.paged_decode_attention.launches
    got = pa_mod.paged_decode_attention(q, kq, vq, bt, ln, window=window,
                                        k_scale=ks, v_scale=vs)
    assert pa_mod.paged_decode_attention.k4_launches == n0 + 1
    assert pa_mod.paged_decode_attention.launches == n2
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, ref.paged_decode_attention(q, kq, vq, bt, ln, window=window,
                                           k_scale=ks, v_scale=vs), dtype)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K1,hq,hkv,D,bs,window,bodies", [
    (5, 4, 4, 16, 4, None, ("split", "split")),
    (5, 4, 2, 32, 8, 5, ("split", "split")),
    (5, 16, 16, 128, 16, None, ("split", "split")),
    (5, 16, 4, 128, 16, 40, ("split", "split")),
    (5, 16, 16, 256, 16, None, ("split", "split")),
    (5, 8, 1, 64, 16, None, ("simt", "wgmma")),     # 40 pairs
    (64, 8, 2, 64, 16, 20, ("simt", "wgmma")),
    (64, 4, 4, 16, 8, None, ("simt", "wgmma")),     # D 16, BS 8
    (256, 16, 16, 128, 16, None, ("simt", "wgmma")),
    (64, 16, 16, 256, 16, None, ("simt", "wgmma")),
    (64, 8, 2, 64, 6, None, ("simt", "simt")),      # BS 6
])
def test_paged_verify_k4_matches_plain(cuda_device, kv_dtype, dtype, K1, hq,
                                       hkv, D, bs, window, bodies):
    """K3 over an int8/fp8 pool (K4), both regimes (verify windows and
    suffix prefill), lengths at zero, mid-block, deep and past the
    table; each case names the body it runs (K4 inside split, wgmma's
    staged dequant, or simt)."""
    gen = torch.Generator().manual_seed(K1 * 1000 + hq * 100 + D + bs + 1)
    nbmax = -(-(K1 + 3 * bs + 2) // bs) + 2
    lengths = [0, 3, 2 * bs, nbmax * bs - 2, bs + 1]
    q, kp, vp, bt, ln = _verify_case(gen, len(lengths), K1, hq, hkv, D, bs,
                                     nbmax, lengths, dtype, cuda_device)
    kq, vq, ks, vs = _quant_pool(kp.float(), vp.float(), kv_dtype)
    kw = {"window": window, "k_scale": ks, "v_scale": vs}
    got = _verify_call((q, kq, vq, bt, ln), kw, dtype,
                       bodies[dtype == torch.bfloat16], quant=True)
    _close(got, ref.paged_verify_attention(q, kq, vq, bt, ln, **kw), dtype)


# (mode, K1, hq, first kv head, kv heads read, pool kv heads, D, body in
# f32, in bf16): a tensor-parallel rank's q heads over a range of the
# kv heads of a pool every rank holds whole (the replicated-KV layout);
# the range starts past kv head 0
KV_RANGE_CASES = [
    ("decode", 1, 1, 1, 1, 2, 128, None, None),     # yi at T = 4, rank 3
    ("decode", 1, 2, 3, 1, 4, 64, None, None),
    ("decode", 1, 4, 2, 2, 4, 16, None, None),
    ("verify", 5, 1, 1, 1, 2, 128, "split", "split"),
    ("verify", 5, 4, 2, 2, 4, 64, "split", "split"),
    ("verify", 64, 2, 3, 1, 4, 128, "simt", "wgmma"),
    ("verify", 64, 8, 1, 1, 2, 64, "simt", "wgmma"),
]


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,K1,hq,lo,n,hkp,D,f32_body,bf16_body",
                         KV_RANGE_CASES)
def test_paged_kernels_over_a_kv_head_range_match_plain(
        cuda_device, kv_dtype, dtype, mode, K1, hq, lo, n, hkp, D,
        f32_body, bf16_body):
    """K2 and K3 (K4 over an int8 / fp8 pool) with ``kv_heads=(lo, n)``:
    the kernels walk kv heads [lo, lo + n) of the whole pool in place
    (the C entries' kv offset and the pool's kv heads as the row stride)
    and equal the plain version on that head view, and the plain
    version on all the heads at the q heads that read them."""
    gen = torch.Generator().manual_seed(hq * 100 + lo * 10 + D + K1)
    bs, nbmax = 16, 5
    lengths = [3, 17, 80, 40]
    q, kp, vp, bt, ln = _verify_case(gen, len(lengths), K1, hq, hkp, D, bs,
                                     nbmax, lengths, dtype, cuda_device)
    kw = {}
    if kv_dtype is not None:
        kp, vp, ks, vs = _quant_pool(kp.float(), vp.float(), kv_dtype)
        kw = {"k_scale": ks, "v_scale": vs}
    ptrs = (kp.data_ptr(), vp.data_ptr())
    view = {"k_scale": kw["k_scale"][:, :, lo:lo + n],
            "v_scale": kw["v_scale"][:, :, lo:lo + n]} if kw else {}
    kv, vv = kp[:, :, lo:lo + n], vp[:, :, lo:lo + n]
    if mode == "decode":
        q = q[:, 0].contiguous()
        fn, plain = pa_mod.paged_decode_attention, ref.paged_decode_attention
        n0 = fn.k4_launches if kw else fn.launches
        got = fn(q, kp, vp, bt, ln + 1, kv_heads=(lo, n), **kw)
        assert (fn.k4_launches if kw else fn.launches) == n0 + 1
        want = plain(q, kv, vv, bt, ln + 1, **view)
    else:
        body = bf16_body if dtype == torch.bfloat16 else f32_body
        fn, plain = pa_mod.paged_verify_attention, ref.paged_verify_attention
        before = dict(fn.launches_by_body)
        got = fn(q, kp, vp, bt, ln, kv_heads=(lo, n), **kw)
        assert _ran_body(fn, before) == body
        want = plain(q, kv, vv, bt, ln, **view)
    assert (kp.data_ptr(), vp.data_ptr()) == ptrs
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, want, dtype)
    # the same q heads as rank rows of the whole model's heads: each of
    # the n kv heads read takes hq / n consecutive q heads
    g = hq // n
    qall = torch.zeros(q.shape[:-2] + (hkp * g,) + q.shape[-1:],
                       dtype=dtype, device=cuda_device)
    qall[..., lo * g:(lo + n) * g, :] = q
    whole = plain(qall, kp, vp, bt, ln + (mode == "decode"), **kw)
    _close(got, whole[..., lo * g:(lo + n) * g, :], dtype)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("mode", ["decode", "verify"])
def test_k4_padded_head_dim_is_exact(cuda_device, kv_dtype, mode):
    """A 64-wide head in a 128-wide pool (zero tail) through the
    dispatcher: q is zero-padded, the softmax scale comes from the
    logical 64, and the result equals the unpadded pool's."""
    gen = torch.Generator().manual_seed(21)
    lengths = [9, 40, 1]
    q, kp, vp, bt, ln = _verify_case(gen, 3, 5, 8, 2, 64, 16, 4, lengths,
                                     torch.float32, cuda_device)
    if mode == "decode":
        q = q[:, 0].contiguous()
    kq, vq, ks, vs = _quant_pool(kp, vp, kv_dtype)
    pad = torch.nn.functional.pad
    wide = {"k": pad(kq.view(torch.uint8), (0, 64)).view(kq.dtype),
            "v": pad(vq.view(torch.uint8), (0, 64)).view(vq.dtype),
            "k_scale": ks, "v_scale": vs}
    got = ops.paged_attention(q, wide, bt, ln, mode=mode)
    want = ops.paged_attention(q, {"k": kq, "v": vq, "k_scale": ks,
                                   "v_scale": vs}, bt, ln, mode=mode)
    assert got.shape == q.shape
    _close(got, want, torch.float32)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("dtype,K1,bs,nbmax,body", [
    (torch.float32, 5, 4, 12, "split"),
    (torch.float32, 40, 4, 24, "simt"),
    (torch.bfloat16, 40, 8, 12, "wgmma")])
def test_k4_reads_only_visible_rows(cuda_device, kv_dtype, dtype, K1, bs,
                                    nbmax, body):
    """Table entries past every row's limit are never dereferenced, and
    the payload and scales of rows no query can see (past the limits,
    below the window floors) are never read: poisoned with out-of-range
    ids and NaN, K2 and every K3 body still match the plain version on
    clean data. Block size 4 (smaller than a tile or a 16-byte chunk of
    rows) where the body takes it; the wgmma body's tensor map needs 8."""
    gen = torch.Generator().manual_seed(13)
    lengths, window = [21, 0, 37], 9
    q, kp, vp, bt, ln = _verify_case(gen, 3, K1, 4, 2, 32, bs, nbmax,
                                     lengths, dtype, cuda_device)
    bt[1] = 0
    kq, vq, ks, vs = _quant_pool(kp.float(), vp.float(), kv_dtype)
    want_v = ref.paged_verify_attention(q, kq, vq, bt, ln, window=window,
                                        k_scale=ks, v_scale=vs)
    want_d = ref.paged_decode_attention(q[:, 0].contiguous(), kq, vq, bt,
                                        ln + 1, window=window, k_scale=ks,
                                        v_scale=vs)
    table = bt.clone()
    ks2, vs2 = ks.clone(), vs.clone()
    for b, L in enumerate(lengths):
        if b == 1:
            continue
        for pos in list(range(0, max(L + 1 - window, 0))) \
                + list(range(L + K1, nbmax * bs)):
            blk = int(bt[b, pos // bs])
            ks2[blk, pos % bs] = float("nan")
            vs2[blk, pos % bs] = float("nan")
        table[b, -(-(L + K1) // bs):] = 1 << 30
    before = dict(pa_mod.paged_verify_attention.launches_by_body)
    got = pa_mod.paged_verify_attention(q, kq, vq, table, ln, window=window,
                                        k_scale=ks2, v_scale=vs2)
    assert _ran_body(pa_mod.paged_verify_attention, before) == body
    _close(got, want_v, dtype)
    _close(pa_mod.paged_decode_attention(q[:, 0].contiguous(), kq, vq, table,
                                         ln + 1, window=window, k_scale=ks2,
                                         v_scale=vs2), want_d, dtype)


def test_k4_rejects_what_it_cannot_take(cuda_device):
    """No fallback: a payload or scale the kernel cannot take raises."""
    q = torch.zeros((1, 4, 16), device=cuda_device)
    bt = torch.zeros((1, 1), dtype=torch.int32, device=cuda_device)
    pool = torch.zeros((2, 4, 2, 16), device=cuda_device)
    ks = torch.zeros((2, 4, 2), device=cuda_device)
    i8 = pool.to(torch.int8)
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        pa_mod.paged_decode_attention(q, i8, i8, bt, bt[0], k_scale=ks)
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        pa_mod.paged_decode_attention(q, i8, i8, bt, bt[0])
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        pa_mod.paged_decode_attention(q, pool.to(torch.uint8),
                                      pool.to(torch.uint8), bt, bt[0],
                                      k_scale=ks, v_scale=ks)
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        pa_mod.paged_verify_attention(q[:, None], i8, i8, bt, bt[0],
                                      k_scale=ks.double(), v_scale=ks)
    with pytest.raises(ValueError, match="scales"):
        pa_mod.paged_verify_attention(q[:, None], i8, i8, bt, bt[0],
                                      k_scale=ks[:, :2], v_scale=ks)


# ---------------------------------------------------------------------------
# K5: the RG-LRU's diagonal linear recurrence
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,D", [(8, 512, 2560), (3, 100, 40),
                                   (2, 37, 2561), (1, 1, 5)])
def test_rglru_scan_kernel_matches_plain(cuda_device, dtype, B, T, D,
                                         with_h0):
    """Serving's (8, 512, 2560) and ragged T and D (a partial last chunk,
    a partial last CTA): in f32 the kernel rounds the product and the
    sum one at a time like the plain version, so they are equal bit for
    bit; in bf16 within the bf16 tolerance."""
    gen = torch.Generator().manual_seed(B * 7 + T + D)
    a = (0.8 + 0.2 * torch.rand((B, T, D), generator=gen)).to(
        device=cuda_device, dtype=dtype)
    x = _randn(gen, (B, T, D), dtype, cuda_device)
    h0 = _randn(gen, (B, D), torch.float32, cuda_device) if with_h0 \
        else None
    n0 = k5_mod.rglru_scan.launches
    got = k5_mod.rglru_scan(a, x, h0)
    assert k5_mod.rglru_scan.launches == n0 + 1
    assert got.dtype == dtype and got.shape == x.shape
    want = ref.linear_scan(a, x, h0)
    _close(got, want, dtype)
    if dtype == torch.float32:
        assert torch.equal(got, want)


def test_rglru_scan_kernel_rejects_what_it_cannot_take(cuda_device):
    a = torch.zeros((2, 8, 16), device=cuda_device)
    with pytest.raises(ValueError, match="dtypes"):
        k5_mod.rglru_scan(a.bfloat16(), a)
    with pytest.raises(ValueError, match="shapes"):
        k5_mod.rglru_scan(a, a, torch.zeros((2, 8), device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        k5_mod.rglru_scan(a.transpose(1, 2), a.transpose(1, 2))
    with pytest.raises(ValueError, match="CUDA"):
        k5_mod.rglru_scan(a.cpu(), a)


def _k5_inputs(gen, B, T, D, dtype, device, offset=0):
    """a (decays in (0.8, 1)) and x of (B, T, D), ``offset`` elements into
    their buffers: 0 keeps the bases 16-byte aligned, 1 puts them where no
    tensor map can start."""
    n = B * T * D
    a = (0.8 + 0.2 * torch.rand(n + offset, generator=gen)).to(
        device=device, dtype=dtype)[offset:].view(B, T, D)
    x = _randn(gen, (n + offset,), dtype, device)[offset:].view(B, T, D)
    return a, x


K5_BODY_CASES = [  # B, T, D, dtype, offset, body
    (2, 2560, 2560, torch.float32, 0, "ring"),     # the long admission
    (8, 512, 2560, torch.float32, 0, "ring"),      # serving's admission
    (2, 300, 2560, torch.float32, 0, "ring"),      # ragged T: a partial tile
    (1, 2560, 2560, torch.float32, 0, "ring"),     # one prompt: 4 stages
    (1, 9000, 64, torch.float32, 0, "ring"),       # 8 stages, the cap
    (3, 37, 64, torch.float32, 0, "ring"),         # T under one tile
    (3, 100, 40, torch.float32, 0, "ring"),        # a partial last CTA
    (1, 1, 16, torch.float32, 0, "ring"),
    (2, 300, 512, torch.bfloat16, 0, "ring"),
    (2, 37, 2561, torch.float32, 0, "simt"),       # rows of 10244 bytes
    (1, 1, 5, torch.float32, 0, "simt"),
    (2, 300, 2560, torch.float32, 1, "simt"),      # a base 4 bytes off
    (2, 37, 2561, torch.bfloat16, 0, "simt"),
]


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("B,T,D,dtype,offset,want", K5_BODY_CASES)
def test_rglru_scan_bodies_equal_plain(cuda_device, B, T, D, dtype, offset,
                                       want, with_h0):
    """Each case runs the body its dtype, shape and alignment pick, and
    equals the plain version bit for bit (f32, and bf16: the carry is f32
    in both and each h_t is rounded to bf16 once)."""
    gen = torch.Generator().manual_seed(B * 7 + T + D + offset)
    a, x = _k5_inputs(gen, B, T, D, dtype, cuda_device, offset)
    h0 = _randn(gen, (B, D), torch.float32, cuda_device) if with_h0 \
        else None
    assert k5_mod.body(a, x) == want
    before = dict(k5_mod.rglru_scan.launches_by_body)
    got = k5_mod.rglru_scan(a, x, h0)
    assert _ran_body(k5_mod.rglru_scan, before) == want
    want_h = ref.linear_scan(a, x, h0)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, want_h), (got.float() - want_h.float()).abs().max()


def test_rglru_scan_ring_refuses_what_no_map_takes(cuda_device):
    """A ring launch the inputs cannot take raises; it never reruns on
    the simt body."""
    gen = torch.Generator().manual_seed(9)
    a, x = _k5_inputs(gen, 2, 64, 2561, torch.float32, cuda_device)
    with pytest.raises(RuntimeError, match="ring body"):
        k5_mod.launch(a, x, which="ring")
    a, x = _k5_inputs(gen, 2, 64, 256, torch.float32, cuda_device, offset=1)
    with pytest.raises(RuntimeError, match="ring body"):
        k5_mod.launch(a, x, which="ring")


def test_rglru_scan_replays_in_a_cuda_graph(cuda_device):
    """Both bodies captured in a CUDA graph and replayed after a, x and h0
    change in place equal the plain version on the new values: the body
    and the plan come from shapes, nothing syncs."""
    gen = torch.Generator().manual_seed(14)
    cases = [_k5_inputs(gen, 2, 300, D, torch.float32, cuda_device)
             for D in (2560, 2561)]
    h0s = [_randn(gen, (2, D), torch.float32, cuda_device)
           for D in (2560, 2561)]
    for (a, x), h0 in zip(cases, h0s):
        k5_mod.rglru_scan(a, x, h0)                # build and warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = dict(k5_mod.rglru_scan.launches_by_body)
    with torch.cuda.graph(graph):
        outs = [k5_mod.rglru_scan(a, x, h0)
                for (a, x), h0 in zip(cases, h0s)]
    assert {b: n - before[b] for b, n in
            k5_mod.rglru_scan.launches_by_body.items()} \
        == {"ring": 1, "simt": 1}
    for seed in (1, 2):
        g = torch.Generator().manual_seed(seed)
        for (a, x), h0 in zip(cases, h0s):
            a.copy_(0.8 + 0.2 * torch.rand(a.shape, generator=g))
            x.copy_(torch.randn(x.shape, generator=g))
            h0.copy_(torch.randn(h0.shape, generator=g))
        graph.replay()
        torch.cuda.synchronize()
        for out, (a, x), h0 in zip(outs, cases, h0s):
            assert torch.equal(out, ref.linear_scan(a, x, h0))


# ---------------------------------------------------------------------------
# K6: the STX matmul (f32 accumulator)
# ---------------------------------------------------------------------------

K6_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4),
          torch.bfloat16: dict(rtol=3e-2, atol=3e-1)}


def _k6_tol(dtype, out_dtype):
    """K6's tolerance: bf16's where the operands or the output are bf16
    (a bf16 output rounds the f32 sum, so two summation orders may land
    one bf16 ulp apart), f32's only where both are f32."""
    return K6_TOL[torch.bfloat16 if torch.bfloat16 in (dtype, out_dtype)
                  else torch.float32]


@pytest.mark.parametrize("out_dtype", [None, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(256, 512, 384), (1000, 700, 300),
                                   (1, 7, 300), (129, 1, 127),
                                   (70, 50, 130)])
def test_stx_matmul_kernel_matches_plain(cuda_device, dtype, out_dtype, M,
                                         K, N):
    """Block multiples and ragged M, N and K (masked in the kernel)."""
    gen = torch.Generator().manual_seed(M + K + N)
    x = _randn(gen, (M, K), dtype, cuda_device)
    w = _randn(gen, (K, N), dtype, cuda_device)
    n0 = k6_mod.stx_matmul.launches
    before = dict(k6_mod.stx_matmul.launches_by_body)
    got = k6_mod.stx_matmul(x, w, out_dtype=out_dtype)
    assert k6_mod.stx_matmul.launches == n0 + 1
    tc = dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0
    assert _ran_body(k6_mod.stx_matmul, before) == ("wgmma" if tc
                                                    else "simt")
    assert got.dtype == (out_dtype or dtype) and got.shape == (M, N)
    want = ref.matmul(x, w, out_dtype=out_dtype)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(),
                               **_k6_tol(dtype, out_dtype))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(256, 512, 384), (128, 64, 128),
                                   (1000, 64, 296), (77, 136, 200),
                                   (1, 8, 8), (300, 2048, 1032)])
def test_stx_matmul_wgmma_body_matches_plain(cuda_device, out_dtype, M, K,
                                             N):
    """K6's tensor-core body: block multiples, ragged M and N (masked
    stores), ragged K (TMA's zero fill), one row."""
    gen = torch.Generator().manual_seed(M + K + N)
    x = _randn(gen, (M, K), torch.bfloat16, cuda_device)
    w = _randn(gen, (K, N), torch.bfloat16, cuda_device)
    before = dict(k6_mod.stx_matmul.launches_by_body)
    got = k6_mod.stx_matmul(x, w, out_dtype=out_dtype)
    assert _ran_body(k6_mod.stx_matmul, before) == "wgmma"
    assert got.dtype == out_dtype and got.shape == (M, N)
    want = ref.matmul(x, w, out_dtype=out_dtype)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(),
                               **K6_TOL[torch.bfloat16])


def test_stx_matmul_through_ops_and_policy(cuda_device):
    from repro_torch.core import tiles

    gen = torch.Generator().manual_seed(0)
    x = _randn(gen, (2, 33, 64), torch.bfloat16, cuda_device)
    w = _randn(gen, (64, 48), torch.bfloat16, cuda_device)
    n0 = k6_mod.stx_matmul.launches
    before = dict(k6_mod.stx_matmul.launches_by_body)
    got = tiles.dispatch_matmul(x, w, tiles.STX_POLICY)
    assert k6_mod.stx_matmul.launches == n0 + 1 and got.shape == (2, 33, 48)
    assert _ran_body(k6_mod.stx_matmul, before) == "wgmma"
    vec = tiles.dispatch_matmul(x, w, tiles.DEFAULT_POLICY)
    assert k6_mod.stx_matmul.launches == n0 + 1
    torch.testing.assert_close(got.float(), vec.float(),
                               **K6_TOL[torch.bfloat16])


def test_stx_matmul_kernel_rejects_what_it_cannot_take(cuda_device):
    x = torch.zeros((4, 8), device=cuda_device)
    with pytest.raises(ValueError, match="dtypes"):
        k6_mod.stx_matmul(x, x.T.contiguous().bfloat16())
    with pytest.raises(ValueError, match="dtypes"):
        k6_mod.stx_matmul(x.double(), x.T.contiguous().double())
    with pytest.raises(ValueError, match="dtypes"):
        k6_mod.stx_matmul(x, x.T.contiguous(), out_dtype=torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        k6_mod.stx_matmul(x, x.T)
    with pytest.raises(ValueError, match="CUDA"):
        k6_mod.stx_matmul(x, x.T.contiguous().cpu())
    with pytest.raises(ValueError, match="shapes"):
        k6_mod.stx_matmul(x, x)
    assert torch.equal(k6_mod.stx_matmul(x[:, :0], x[:0]),
                       torch.zeros((4, 8), device=cuda_device))


# ---------------------------------------------------------------------------
# K7: the STX stencils (2-D and 3-D)
# ---------------------------------------------------------------------------


def _weights(kind, dims, gen):
    if kind == "laplace":
        return (ref.five_point_weights() if dims == 2
                else ref.seven_point_weights())
    if kind == "ones":
        return torch.ones((3,) * dims)
    if kind == "zeros":
        return torch.zeros((3,) * dims)
    return torch.randn((3,) * dims, generator=gen)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["laplace", "ones", "random", "zeros"])
@pytest.mark.parametrize("shape", [(64, 64), (65, 70), (128, 33), (1, 1),
                                   (17, 1000), (3, 16, 64)])
def test_stencil2d_kernel_equals_plain(cuda_device, dtype, kind, shape):
    """Tile multiples, ragged edges, a single cell and a leading batch
    dim; f32 bit-equal, bf16 (f32 accumulator, one rounding) too."""
    gen = torch.Generator().manual_seed(sum(shape))
    x = _randn(gen, shape, dtype, cuda_device)
    w = _weights(kind, 2, gen).to(cuda_device)
    n0 = k7_mod.stencil2d.launches
    got = k7_mod.stencil2d(x, w)
    assert k7_mod.stencil2d.launches == n0 + 1
    assert got.dtype == dtype and got.shape == x.shape
    want = ref.stencil2d(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["laplace", "random", "zeros"])
@pytest.mark.parametrize("shape", [(8, 16, 32), (9, 20, 33), (70, 9, 65),
                                   (1, 1, 1), (2, 33, 8, 64)])
def test_stencil3d_kernel_equals_plain(cuda_device, dtype, kind, shape):
    """Plane chunks of 32 with a ragged last chunk (70), ragged M and N,
    a single cell and a leading batch dim."""
    gen = torch.Generator().manual_seed(sum(shape))
    x = _randn(gen, shape, dtype, cuda_device)
    w = _weights(kind, 3, gen).to(cuda_device)
    n0 = k7_mod.stencil3d.launches
    got = k7_mod.stencil3d(x, w)
    assert k7_mod.stencil3d.launches == n0 + 1
    assert got.dtype == dtype and got.shape == x.shape
    want = ref.stencil3d(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()


K7B_BODY_CASES = [  # shape, dtype, offset, body
    ((512, 512, 512), torch.float32, 0, "ring"),   # tile_path's step
    ((2, 33, 8, 64), torch.float32, 0, "ring"),    # a box past D reads 0
    ((130, 40, 36), torch.float32, 0, "ring"),     # ragged M, partial chunk
    ((70, 9, 64), torch.float32, 0, "ring"),       # 64 + 6 planes
    ((3, 1, 1, 4), torch.float32, 0, "ring"),
    ((2, 20, 30, 100), torch.float32, 0, "ring"),  # N ragged in the tile
    ((9, 20, 33), torch.float32, 0, "simt"),       # N not a multiple of 4
    ((70, 9, 64), torch.float32, 1, "simt"),       # a base 4 bytes off
    ((70, 9, 64), torch.bfloat16, 0, "simt"),
]


@pytest.mark.parametrize("kind", ["laplace", "random"])
@pytest.mark.parametrize("shape,dtype,offset,want", K7B_BODY_CASES)
def test_stencil3d_bodies_equal_plain(cuda_device, shape, dtype, offset,
                                      want, kind):
    """Each case runs the body its dtype, shape and alignment pick, and
    equals the plain version bit for bit: seven-point and random weights,
    every term computed in (dd, di, dj) order."""
    gen = torch.Generator().manual_seed(sum(shape) + offset)
    n = torch.Size(shape).numel()
    x = _randn(gen, (n + offset,), dtype, cuda_device)[offset:].view(shape)
    w = _weights(kind, 3, gen).to(cuda_device)
    assert k7_mod.body3d(x) == want
    before = dict(k7_mod.stencil3d.launches_by_body)
    got = k7_mod.stencil3d(x, w)
    assert _ran_body(k7_mod.stencil3d, before) == want
    want_y = ref.stencil3d(x, w)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, want_y), (got.float() - want_y.float()).abs().max()


def test_stencil3d_ring_refuses_what_no_map_takes(cuda_device):
    """A ring launch the input cannot take raises; it never reruns on the
    simt body."""
    w = ref.seven_point_weights().to(cuda_device)
    for x in (torch.zeros((4, 8, 33), device=cuda_device),
              torch.zeros(4 * 8 * 32 + 1, device=cuda_device)[1:].view(
                  4, 8, 32),
              torch.zeros((4, 8, 32), device=cuda_device,
                          dtype=torch.bfloat16)):
        with pytest.raises(RuntimeError, match="ring body"):
            k7_mod.launch3d(x, w, "ring")


def test_stencil3d_replays_in_a_cuda_graph(cuda_device):
    """Both bodies captured in a CUDA graph and replayed after x and the
    weights change in place equal the plain version on the new values."""
    gen = torch.Generator().manual_seed(15)
    xs = [_randn(gen, shape, torch.float32, cuda_device)
          for shape in ((70, 40, 64), (70, 40, 65))]
    w = torch.randn((3, 3, 3), generator=gen).to(cuda_device)
    for x in xs:
        k7_mod.stencil3d(x, w)                      # build and warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = dict(k7_mod.stencil3d.launches_by_body)
    with torch.cuda.graph(graph):
        outs = [k7_mod.stencil3d(x, w) for x in xs]
    assert {b: n - before[b] for b, n in
            k7_mod.stencil3d.launches_by_body.items()} \
        == {"ring": 1, "simt": 1}
    for seed in (1, 2):
        g = torch.Generator().manual_seed(seed)
        for x in xs:
            x.copy_(torch.randn(x.shape, generator=g))
        w.copy_(torch.randn(w.shape, generator=g))
        graph.replay()
        torch.cuda.synchronize()
        for out, x in zip(outs, xs):
            assert torch.equal(out, ref.stencil3d(x, w))


def test_stencil_kernel_takes_cpu_weights(cuda_device):
    x = torch.randn((40, 50), device=cuda_device)
    w = ref.five_point_weights()
    assert torch.equal(k7_mod.stencil2d(x, w), ref.stencil2d(x, w))


def test_stencil_kernels_reject_what_they_cannot_take(cuda_device):
    x = torch.zeros((8, 8), device=cuda_device)
    w = ref.five_point_weights().to(cuda_device)
    with pytest.raises(ValueError, match="dtypes"):
        k7_mod.stencil2d(x.double(), w)
    with pytest.raises(ValueError, match="dtypes"):
        k7_mod.stencil2d(x, w.double())
    with pytest.raises(ValueError, match="shapes"):
        k7_mod.stencil2d(x, ref.seven_point_weights())
    with pytest.raises(ValueError, match="shapes"):
        k7_mod.stencil3d(x, ref.seven_point_weights())
    with pytest.raises(ValueError, match="contiguous"):
        k7_mod.stencil2d(torch.zeros((8, 9), device=cuda_device).T, w)


# ---------------------------------------------------------------------------
# K8: the VRP compensated dot and sum (per-lane Neumaier pairs)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1024, 3000, 1, 40 * 1024 + 17, 2**20 + 3])
def test_vrp_lanes_kernels_equal_plain(cuda_device, n):
    """Whole lane tiles and the n % 1024 != 0 tail (read as zeros): the
    lanes, and the finalized expansion, equal the plain version's."""
    gen = torch.Generator().manual_seed(n)
    x = (torch.randn(n, generator=gen) * 1e4).to(cuda_device)
    y = torch.randn(n, generator=gen).to(cuda_device)
    n0 = (k8_mod.vrp_dot_lanes.launches, k8_mod.vrp_sum_lanes.launches)
    dot, tot = k8_mod.vrp_dot_lanes(x, y), k8_mod.vrp_sum_lanes(x)
    assert (k8_mod.vrp_dot_lanes.launches,
            k8_mod.vrp_sum_lanes.launches) == (n0[0] + 1, n0[1] + 1)
    assert dot.shape == (8, 128, 2) and dot.dtype == torch.float32
    want_dot, want_tot = ref.vrp_dot_lanes(x, y), ref.vrp_sum_lanes(x)
    torch.cuda.synchronize()
    assert torch.equal(dot, want_dot)
    assert torch.equal(tot, want_tot)
    assert torch.equal(ops.vrp_dot(x, y), ops.vrp_dot(x.cpu(), y.cpu()).to(
        cuda_device))
    assert torch.equal(ops.vrp_sum(x), ops.vrp_sum(x.cpu()).to(cuda_device))


def test_vrp_dot_kernel_of_a_vector_with_itself(cuda_device):
    x = torch.randn(5000, generator=torch.Generator().manual_seed(1)) \
        .to(cuda_device)
    assert torch.equal(k8_mod.vrp_dot_lanes(x, x), ref.vrp_dot_lanes(x, x))


def test_vrp_dot_kernel_beats_naive(cuda_device):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2**20 + 3, generator=gen, dtype=torch.float64) * 1e4
    y = torch.randn(2**20 + 3, generator=gen, dtype=torch.float64)
    xs, ys = x.float().to(cuda_device), y.float().to(cuda_device)
    exact = float(torch.dot(xs.double().cpu(), ys.double().cpu()))
    naive_err = abs(float(torch.dot(xs, ys)) - exact)
    d = ops.vrp_dot(xs, ys)
    assert abs(float(d[0]) + float(d[1]) - exact) < max(naive_err / 100, 1e-8)


def test_vrp_kernels_reject_what_they_cannot_take(cuda_device):
    x = torch.zeros(2048, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        k8_mod.vrp_dot_lanes(x.double(), x.double())
    with pytest.raises(ValueError, match="float32"):
        k8_mod.vrp_sum_lanes(x.bfloat16())
    with pytest.raises(ValueError, match="one length"):
        k8_mod.vrp_dot_lanes(x, x[:100])
    with pytest.raises(ValueError, match="device"):
        k8_mod.vrp_dot_lanes(x, x.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        k8_mod.vrp_sum_lanes(x[::2])



K8_N = [1, 1023, 1024, 3000, 40 * 1024 + 17, 2**20 + 3, 2**24 + 3]


def _k8_inputs(gen, n, offset, device):
    """x (scaled by 1e4) and y of n values, ``offset`` floats into their
    buffers: 0 keeps the bases 16-byte aligned, 1 puts them where no
    tensor map can start (a contiguous ``x[1:]``)."""
    x = (torch.randn(n + offset, generator=gen) * 1e4).to(device)[offset:]
    y = torch.randn(n + offset, generator=gen).to(device)[offset:]
    return x, y


def _k8_expect_body(n, offset):
    return "ring" if n >= 1024 and offset % 4 == 0 else "simt"


def _k8_check(x, y):
    """Both K8 kernels and their one-call finalized forms on x, y: the
    body each ran, lanes equal to the plain versions, the finalized (2,)
    equal to the plain lanes finalized by the torch tree. Returns the
    bodies (dot, sum)."""
    bodies = []
    for dot, lanes_fn, plain, final_fn in (
            (True, k8_mod.vrp_dot_lanes, ref.vrp_dot_lanes, ops.vrp_dot),
            (False, k8_mod.vrp_sum_lanes, ref.vrp_sum_lanes, ops.vrp_sum)):
        args = (x, y) if dot else (x,)
        before = dict(lanes_fn.launches_by_body)
        got = lanes_fn(*args)
        which = _ran_body(lanes_fn, before)
        assert which == k8_mod.body(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        f0 = k8_mod.vrp_finalize.launches
        before = dict(lanes_fn.launches_by_body)
        final = final_fn(*args)
        assert _ran_body(lanes_fn, before) == which
        assert k8_mod.vrp_finalize.launches == f0 + 1
        tree = ops._finalize_expansion(want)
        torch.cuda.synchronize()
        assert final.shape == (2,) and torch.equal(final, tree)
        bodies.append(which)
    return tuple(bodies)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", K8_N)
def test_vrp_bodies_equal_plain(cuda_device, n, offset):
    """Each body at each length, ragged tails included: the aligned
    inputs run "ring" from n = 1024 on ("simt" below), the inputs one
    float off their buffers' bases "simt"; lanes and the one-call
    finalized expansion equal the plain versions bit for bit."""
    gen = torch.Generator().manual_seed(n + offset)
    x, y = _k8_inputs(gen, n, offset, cuda_device)
    want = _k8_expect_body(n, offset)
    assert _k8_check(x, y) == (want, want)


@pytest.mark.parametrize("dot", [True, False])
def test_vrp_ring_at_the_plate_size(cuda_device, dot):
    """The tile path's 8192^2 plate through the ring body: lanes and the
    finalized expansion equal the plain versions'."""
    n = 8192 * 8192
    x = torch.rand(n, generator=torch.Generator().manual_seed(5)) \
        .to(cuda_device)
    fn, plain = ((k8_mod.vrp_dot_lanes, ref.vrp_dot_lanes) if dot
                 else (k8_mod.vrp_sum_lanes, ref.vrp_sum_lanes))
    args = (x, x) if dot else (x,)
    before = dict(fn.launches_by_body)
    got = fn(*args)
    assert _ran_body(fn, before) == "ring"
    want = plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    final = (ops.vrp_dot if dot else ops.vrp_sum)(*args)
    assert torch.equal(final, ops._finalize_expansion(want))


def _adversarial(gen, n):
    """Values that stress the error-free transforms: exact cancellation
    (each lane's step j + 1 the negative of its step j), magnitudes from
    1e-30 to 1e30, subnormals, a mix of 1e30 and 1e-38, and zeros."""
    base = torch.randn(n, generator=gen)
    cancel = base * 1e20
    m = n // 2048 * 2048
    rows = cancel[:m].view(-1, 2, 1024)
    rows[:, 1] = -rows[:, 0]
    return {
        "cancel": cancel,
        "magnitudes": base.sign() * 10.0 ** (
            torch.rand(n, generator=gen) * 60 - 30),
        "subnormals": base * 1e-40,
        "mixed": torch.where(torch.arange(n) % 3 == 0, base * 1e30,
                             base * 1e-38),
        "zeros": torch.zeros(n),
    }


@pytest.mark.parametrize("n", [3000, 40 * 1024 + 17])
def test_vrp_adversarial_data(cuda_device, n):
    """The adversarial values through both kernels (y standard normal, so
    no product overflows): lanes and finalized expansions bit-equal."""
    gen = torch.Generator().manual_seed(11)
    y = torch.randn(n, generator=gen).to(cuda_device)
    for name, x in _adversarial(gen, n).items():
        assert _k8_check(x.float().to(cuda_device), y) == ("ring", "ring"), \
            name


def test_vrp_misaligned_base_runs_simt(cuda_device):
    """A contiguous x[1:] (or y[1:] beside an aligned x) is 4 bytes off
    its buffer's 16-byte alignment: no tensor map takes it, so the
    wrapper picks "simt" before the launch; x[4:] is aligned again."""
    gen = torch.Generator().manual_seed(3)
    buf = torch.randn(2**16 + 8, generator=gen).to(cuda_device)
    x, y = buf[4: 4 + 2**16], buf[1: 1 + 2**16]
    assert k8_mod.body(buf[1:]) == "simt"
    assert k8_mod.body(x) == "ring" and k8_mod.body(x, y) == "simt"
    before = dict(k8_mod.vrp_dot_lanes.launches_by_body)
    got = k8_mod.vrp_dot_lanes(x, y)
    assert _ran_body(k8_mod.vrp_dot_lanes, before) == "simt"
    assert torch.equal(got, ref.vrp_dot_lanes(x, y))
    assert _k8_check(buf[1: 1 + 5000], buf[2: 2 + 5000]) == ("simt",
                                                             "simt")
    with pytest.raises(RuntimeError, match="ring body"):
        k8_mod.launch(x, x, False, "vrp_sum_lanes", lanes_per_cta=3)


@pytest.mark.parametrize("L", [8, 16, 32])
def test_vrp_ring_lanes_per_cta(cuda_device, L):
    """The ring at each CTA width chip_smoke.py times: the same lanes."""
    gen = torch.Generator().manual_seed(L)
    x, y = _k8_inputs(gen, 300 * 1024 + 5, 0, cuda_device)
    for dot in (True, False):
        got, _, which = k8_mod.launch(x, y if dot else x, dot, "ring",
                                      lanes_per_cta=L)
        want = ref.vrp_dot_lanes(x, y) if dot else ref.vrp_sum_lanes(x)
        torch.cuda.synchronize()
        assert which == "ring" and torch.equal(got, want)


def test_vrp_finalize_kernel_equals_tree(cuda_device):
    """The finalize kernel alone on given lanes: random pairs, pairs that
    cancel between neighbours, 1e-30..1e30, subnormals, zeros, and real
    lanes of the dot kernel; equal to ``ops._finalize_expansion`` (the
    torch tree) and to the scalar loop of its order."""
    gen = torch.Generator().manual_seed(12)
    r = torch.randn((8, 128, 2), generator=gen)
    cancel = r.clone()
    cancel.view(-1, 4)[:, 2:] = -cancel.view(-1, 4)[:, :2]
    cancel.view(-1, 4)[::3, 3] *= 0.5
    cases = {
        "random": r * 10.0 ** torch.randint(-5, 5, r.shape, generator=gen),
        "cancel": cancel * 1e20,
        "magnitudes": r.sign() * 10.0 ** (torch.rand(r.shape, generator=gen)
                                          * 60 - 30),
        "subnormals": r * 1e-40,
        "zeros": torch.zeros_like(r),
    }
    x = (torch.randn(5000, generator=gen) * 1e4).to(cuda_device)
    cases["dot_lanes"] = k8_mod.vrp_dot_lanes(x, x).cpu()
    for name, lanes in cases.items():
        lanes = lanes.float().contiguous()
        n0 = k8_mod.vrp_finalize.launches
        got = k8_mod.vrp_finalize(lanes.to(cuda_device))
        assert k8_mod.vrp_finalize.launches == n0 + 1
        want = ops._finalize_expansion(lanes.to(cuda_device))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu().view(torch.int32),
                           want.cpu().view(torch.int32)), name
        assert torch.equal(got.cpu(), ref.vrp_finalize_pairs(lanes)), name


def test_vrp_replays_in_a_cuda_graph(cuda_device):
    """``ops.vrp_dot`` / ``ops.vrp_sum`` (lane kernel + finalize, one C
    call) captured in a CUDA graph and replayed after x and y change in
    place equal the plain versions on the new values: the body comes from
    n and alignment, the scratch from the graph's pool, nothing syncs."""
    gen = torch.Generator().manual_seed(13)
    x, y = _k8_inputs(gen, 50 * 1024 + 7, 0, cuda_device)
    ops.vrp_dot(x, y)
    ops.vrp_sum(x)                                  # build and warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    n0 = (k8_mod.vrp_dot_lanes.launches, k8_mod.vrp_sum_lanes.launches,
          k8_mod.vrp_finalize.launches)
    with torch.cuda.graph(graph):
        dot, tot = ops.vrp_dot(x, y), ops.vrp_sum(x)
    assert (k8_mod.vrp_dot_lanes.launches, k8_mod.vrp_sum_lanes.launches,
            k8_mod.vrp_finalize.launches) == (n0[0] + 1, n0[1] + 1,
                                              n0[2] + 2)
    for seed in (1, 2):
        g = torch.Generator().manual_seed(seed)
        x.copy_(torch.randn(x.shape, generator=g) * 10.0**seed)
        y.copy_(torch.randn(y.shape, generator=g))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(dot, ops._finalize_expansion(
            ref.vrp_dot_lanes(x, y)))
        assert torch.equal(tot, ops._finalize_expansion(
            ref.vrp_sum_lanes(x)))
    assert k8_mod.vrp_finalize.launches == n0[2] + 2   # replays count nothing


# -- the captured decode step (launch/engine/step_graph.py) --------------


def _smoke_model(arch, device):
    from repro_torch.configs import get_config
    from repro_torch.models import weights
    from repro_torch.models.model import Model

    cfg = get_config(arch).smoke()
    cpu = Model(cfg, device="cpu")
    params = cpu.init(seed=0)
    return cpu, params, Model(cfg, device=device), weights.to_device(
        params, device)


def _step_inputs(gen, N, MB, nb, vocab):
    table = torch.randperm(nb - 1, generator=gen)[:N * MB] \
        .reshape(N, MB).add(1).to(torch.int32)
    lengths = torch.randint(0, MB * 4 - 1, (N,), generator=gen,
                            dtype=torch.int32)
    tokens = torch.randint(0, vocab, (N, 1), generator=gen,
                           dtype=torch.int32)
    steps = torch.randint(0, 50, (N,), generator=gen, dtype=torch.int32)
    samp = (torch.arange(N, dtype=torch.int32) * 977,
            torch.tensor([0.0, 0.7, 1.0, 1.3][:N], dtype=torch.float32),
            torch.tensor([0, 9, 0, 3][:N], dtype=torch.int32),
            torch.tensor([1.0, 0.95, 0.9, 1.0][:N], dtype=torch.float32))
    return [t.numpy() for t in (table, lengths, tokens, steps)], \
        tuple(t.numpy() for t in samp)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "seeded"])
def test_captured_step_equals_eager_step(cuda_device, sampled):
    """olmo_1b smoke in f32: two dispatches of the captured step (the
    second feeding two rows from the first's tokens on the device) give
    the eager ``fused_step``'s tokens and pools on a copy of the same
    pools, and the replays count one K2 launch a layer each (the capture
    and its warm-up count none)."""
    from repro_torch.launch.engine import step_graph
    from repro_torch.models import paged_kv, transformer

    _, _, model, params = _smoke_model("olmo_1b", cuda_device)
    N, MB, nb = 4, 8, 40
    layout = paged_kv.PagedLayout(num_slots=N, num_blocks=nb, block_size=4,
                                  max_len=MB * 4)
    ctx = transformer.RunCtx()
    pools = model.init_paged_cache(layout)
    gen = torch.Generator().manual_seed(21)
    n0 = (pa_mod.paged_decode_attention.launches,
          pa_mod.paged_decode_combine.launches)
    runner = step_graph.DecodeStep(model, params, pools, ctx, N, MB)
    assert runner.graphed
    assert (pa_mod.paged_decode_attention.launches,
            pa_mod.paged_decode_combine.launches) == n0
    for leaf in step_graph._leaves(pools):          # filled after capture
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    twin = {g: {p: {k: v.clone() for k, v in pool.items()}
                for p, pool in grp.items()} for g, grp in pools.items()}
    (table, lengths, tokens, steps), samp = _step_inputs(
        gen, N, MB, nb, model.cfg.vocab_size)
    samp = samp if sampled else None
    use = np.zeros(N, bool)

    def eager(pools_, use_, prev_):
        dev = lambda a: torch.from_numpy(np.asarray(a)).to(cuda_device)  # noqa: E731
        return step_graph.fused_step(
            model, ctx, params, pools_, dev(table), dev(lengths),
            dev(tokens), prev_, dev(use_), dev(steps),
            None if samp is None else tuple(map(dev, samp)))

    nsplit = _plan(N, model.cfg.n_kv_heads, MB, 4, cuda_device)[1]
    L = model.cfg.n_layers

    def replay(*args):               # one dispatch, one K2 a layer
        n = (pa_mod.paged_decode_attention.launches,
             pa_mod.paged_decode_combine.launches)
        toks = runner.dispatch(pools, table, *args)
        assert (pa_mod.paged_decode_attention.launches - n[0],
                pa_mod.paged_decode_combine.launches - n[1]) \
            == (L, L if nsplit > 1 else 0)
        return toks

    first = replay(lengths, tokens, use, None, steps, samp)
    want1 = eager(twin, use, torch.zeros(N, dtype=torch.int32,
                                         device=cuda_device))
    assert np.array_equal(first.fetch(), want1.cpu().numpy())
    use = np.array([True, False, True, False])
    lengths = lengths + 1
    steps = steps + use
    second = replay(lengths, tokens, use, first, steps, samp)
    want2 = eager(twin, use, want1)
    assert np.array_equal(second.fetch(), want2.cpu().numpy())
    for got, want in zip(step_graph._leaves(pools), step_graph._leaves(twin)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_captured_step_refuses_moved_pools(cuda_device):
    """A replay over pools that are not the captured tensors raises; no
    eager step runs in its place."""
    from repro_torch.launch.engine import step_graph
    from repro_torch.models import paged_kv, transformer

    _, _, model, params = _smoke_model("olmo_1b", cuda_device)
    layout = paged_kv.PagedLayout(num_slots=2, num_blocks=9, block_size=4,
                                  max_len=16)
    pools = model.init_paged_cache(layout)
    runner = step_graph.DecodeStep(model, params, pools,
                                   transformer.RunCtx(), 2, 4)
    moved = model.init_paged_cache(layout)
    z = np.zeros(2, np.int32)
    with pytest.raises(RuntimeError, match="moved"):
        runner.dispatch(moved, np.zeros((2, 4), np.int32), z,
                        z[:, None], np.zeros(2, bool), None, z, None)


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "xlstm_1_3b",
                                  "qwen3_moe_30b_a3b"])
@pytest.mark.parametrize("overlap", [False, True])
def test_captured_engine_equals_cpu_engine(cuda_device, overlap, arch):
    """recurrentgemma_2b, xlstm_1_3b and qwen3_moe_30b_a3b smoke in f32:
    the backend captures its step while no slot is live, then serves
    greedy and seeded requests with preemption by replay alone; the
    tokens equal a CPU engine's, so the capture's warm-up left no
    admitted slot's rings or carries changed, and the MoE's dispatch
    (sort, fixed-size counts, ordered combine) captures."""
    from repro_torch.launch.engine import Engine, EngineConfig, SamplingParams

    cpu, params, model, dparams = _smoke_model(arch, cuda_device)
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, 256, (n,), generator=gen).tolist()
               for n in (9, 14, 20, 6, 17)]
    sps = [SamplingParams(max_tokens=16) if i % 2 else
           SamplingParams(max_tokens=16, temperature=0.9, top_k=30, seed=i)
           for i in range(len(prompts))]
    geo = EngineConfig(num_slots=3, block_size=4, num_blocks=14, max_len=64,
                       overlap=overlap)
    want = Engine(cpu, params, geo, device="cpu").generate(prompts, sps)
    eng = Engine(model, dparams, geo, device="cuda")
    got = eng.generate(prompts, sps)
    st = eng.stats()
    assert got == want
    assert st["graph_replays"] == st["steps"] > 0
    assert st["eager_decode_steps"] == 0 and st["blocks_used"] == 0
    assert st["preemptions"] >= 1


def test_moe_on_the_card_is_deterministic_and_matches_cpu(cuda_device):
    """The dropless MoE at qwen3's full width (128 experts, top-8, width
    768; 64 tokens) in bf16 on the card: two calls are bit-equal (the
    combine adds each token's eight contributions in a fixed order, no
    atomics) and match the CPU's plain torch on the same bf16 inputs to
    bf16 rounding (relative error of the whole output below 1e-2: the
    two devices round the expert products in other orders)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config("qwen3_moe_30b_a3b")
    gen = torch.Generator().manual_seed(3)
    params = moe.init_moe(gen, cfg, torch.bfloat16)
    x = _randn(gen, (4, 16, cfg.d_model), torch.bfloat16, "cpu")
    dev = {k: v.to(cuda_device) for k, v in params.items()}
    first = moe.apply_moe(dev, cfg, x.to(cuda_device))
    again = moe.apply_moe(dev, cfg, x.to(cuda_device))
    assert torch.equal(first, again)
    want = moe.apply_moe(params, cfg, x).float()
    err = (first.cpu().float() - want).norm() / want.norm()
    assert err.item() < 1e-2, err.item()


def _whisper_work(gen, cfg):
    """Six whisper-smoke requests: prompts of 3-9 tokens, frame counts
    over buckets 8 and 16, requests 1 and 4 on one feature array;
    greedy and seeded rows alternating."""
    from repro_torch.launch.engine import SamplingParams

    prompts = [torch.randint(0, 256, (n,), generator=gen).tolist()
               for n in (3, 7, 5, 9, 4, 6)]
    feats = [torch.randn((f, cfg.d_model), generator=gen).numpy()
             for f in (5, 16, 9, 12, 7, 16)]
    feats[4] = feats[1]
    sps = [SamplingParams(max_tokens=10) if i % 2 else
           SamplingParams(max_tokens=10, temperature=8.0, top_k=32, seed=i)
           for i in range(len(prompts))]
    return prompts, feats, sps


@pytest.mark.parametrize("overlap", [False, True])
def test_captured_encdec_engine_equals_cpu_engine(cuda_device, overlap):
    """whisper_base smoke in f32: the backend captures its step (every
    slot on the null arena row, no frames) while no slot is live, then
    serves greedy and seeded requests with preemption (8 usable blocks)
    and a shared feature array by replay alone: tokens equal a CPU
    engine's, one K2 a decoder layer each step, no block and no arena row
    left in use."""
    from repro_torch.launch.engine import Engine, EngineConfig

    cpu, params, model, dparams = _smoke_model("whisper_base", cuda_device)
    prompts, feats, sps = _whisper_work(torch.Generator().manual_seed(7),
                                        cpu.cfg)
    geo = EngineConfig(num_slots=4, block_size=4, num_blocks=9, max_len=32,
                       overlap=overlap)
    want = Engine(cpu, params, geo, device="cpu").generate(
        prompts, sps, encoder_features=feats)
    eng = Engine(model, dparams, geo, device="cuda")
    n0 = pa_mod.paged_decode_attention.launches
    got = eng.generate(prompts, sps, encoder_features=feats)
    st = eng.stats()
    assert got == want
    assert st["graph_replays"] == st["steps"] > 0
    assert st["eager_decode_steps"] == 0 and st["blocks_used"] == 0
    assert st["preemptions"] >= 1
    assert st["cross_arena"]["rows_used"] == 0
    assert pa_mod.paged_decode_attention.launches - n0 \
        == cpu.cfg.n_layers * st["steps"]


def test_encdec_arena_keeps_its_storage_across_admissions(cuda_device):
    """The cross arena is written in place: every pool and arena leaf
    keeps its ``data_ptr()`` from the capture through admissions,
    preemptions and retirements (a moved leaf would make the replay
    raise), and the null row is all the step ever reads for an empty
    slot."""
    from repro_torch.launch.engine import Engine, EngineConfig
    from repro_torch.launch.engine import step_graph

    _, _, model, dparams = _smoke_model("whisper_base", cuda_device)
    prompts, feats, sps = _whisper_work(torch.Generator().manual_seed(8),
                                        model.cfg)
    eng = Engine(model, dparams, EngineConfig(
        num_slots=4, block_size=4, num_blocks=9, max_len=32), device="cuda")
    pools = eng.backend.pools
    ptrs = [t.data_ptr() for t in step_graph._leaves(pools)]
    for p, f, sp in zip(prompts, feats, sps):
        eng.add_request(p, sp, encoder_features=f)
    seen = set()
    while eng.has_work:
        eng.step()
        seen.update(int(a) for a in eng.backend.arena_ids if a)
        assert [t.data_ptr() for t in step_graph._leaves(
            eng.backend.pools)] == ptrs
    assert eng.backend.pools is pools and len(seen) >= 2
    assert eng.stats()["cross_arena"]["rows_used"] == 0


# ---------------------------------------------------------------------------
# Training: K1's lse and backward, K5 under autograd, gradients reaching
# the projections
# ---------------------------------------------------------------------------

BWD_CASES = [  # B, hq, hkv, Sq, Skv, D, causal, window
    (2, 4, 4, 80, 80, 32, True, None),
    (2, 8, 2, 300, 300, 64, True, None),     # GQA 4, ragged
    (1, 8, 2, 333, 333, 120, True, 100),     # danube's D 120, a window
    (1, 10, 1, 200, 200, 256, True, 64),     # MQA 10, D 256, a window
    (2, 4, 2, 130, 130, 48, False, None),    # bidirectional, D 48
    (1, 4, 1, 77, 300, 16, False, None),     # Sq < Skv
    (1, 2, 2, 300, 100, 64, False, 50),      # rows >= 149 see no key
]
# the training shapes (chip_smoke.py's parity_train rows), each in bf16
# and in f32
TRAIN_SHAPES = [(dt, c) for c in (
    (4, 16, 16, 2048, 2048, 128, True, None),    # olmo_1b
    (2, 10, 1, 2048, 2048, 256, True, 2048),     # recurrentgemma local
    (2, 32, 8, 2048, 2048, 120, True, 4096),     # h2o_danube
) for dt in (torch.bfloat16, torch.float32)]
# K1_bwd per element: |got - plain| <= TOL + BWD_RTOL |plain|, BWD_RTOL
# one bf16 ulp of the plain value (both round an f32 sum to bf16, and
# sums a few f32 ulps apart can round to neighbours), 0 in f32
BWD_RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}


def _attn_inputs(dtype, device, B, hq, hkv, Sq, Skv, D, seq_major=True):
    """q, k, v as the models pass them ((B, S, H, D) seen through
    ``.transpose(1, 2)``) and an output gradient."""
    gen = torch.Generator().manual_seed(Sq * 7 + D)
    shape = (lambda h, n: (B, n, h, D)) if seq_major else \
        (lambda h, n: (B, h, n, D))
    q, k, v = (_randn(gen, shape(h, n), dtype, device)
               for h, n in ((hq, Sq), (hkv, Skv), (hkv, Skv)))
    if seq_major:
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    return q, k, v, _randn(gen, (B, hq, Sq, D), dtype, device)


@pytest.mark.parametrize("dtype,case", [
    (dt, c) for c in BWD_CASES for dt in (torch.float32, torch.bfloat16)]
    + TRAIN_SHAPES, ids=str)
def test_flash_attention_lse_matches_plain(cuda_device, dtype, case):
    """K1 asked for its row log-sum-exps (both bodies: bf16 with D % 8 ==
    0 on wgmma, the rest on simt) gives the plain version's output and
    lse, -inf on rows that see no key; within TOL in f32 and 3e-3 in
    bf16 (the lse is f32 of a few units: bf16 only changes the
    products' order)."""
    B, hq, hkv, Sq, Skv, D, causal, window = case
    q, k, v, _ = _attn_inputs(dtype, cuda_device, B, hq, hkv, Sq, Skv, D)
    before = dict(fa_mod.flash_attention.launches_by_body)
    out, lse = fa_mod._forward(q, k, v, causal, window, None, True)
    assert _ran_body(fa_mod.flash_attention, before) == (
        "wgmma" if dtype == torch.bfloat16 and D % 8 == 0 else "simt")
    want, want_lse = ref.flash_attention(q, k, v, causal=causal,
                                         window=window, return_lse=True)
    _close(out, want, dtype)
    empty = torch.isinf(want_lse)
    assert torch.equal(torch.isinf(lse), empty)
    err = (lse[~empty] - want_lse[~empty]).abs().max().item()
    assert err <= (1e-4 if dtype == torch.float32 else 3e-3), err


@pytest.mark.parametrize("dtype,case", [
    (dt, c) for c in BWD_CASES for dt in (torch.float32, torch.bfloat16)]
    + TRAIN_SHAPES, ids=str)
def test_flash_attention_bwd_kernel_matches_plain(cuda_device, dtype, case):
    """K1's backward kernel vs ``ref.flash_attention_bwd`` on the same q,
    k, v, output, lse and output gradient (the training path's layout:
    transposed (B, S, H, D) projections), each element within TOL +
    BWD_RTOL * |plain|: dK and dV sum a group's heads and thousands of
    rows in another order, and the wgmma body (bf16 with D % 8 == 0)
    takes P and dS as bf16 operands. Empty rows give zero gradients."""
    B, hq, hkv, Sq, Skv, D, causal, window = case
    q, k, v, do = _attn_inputs(dtype, cuda_device, B, hq, hkv, Sq, Skv, D)
    out, lse = fa_mod._forward(q, k, v, causal, window, None, True)
    before = fa_mod.flash_attention_bwd.launches
    by_body = dict(fa_mod.flash_attention_bwd.launches_by_body)
    got = fa_mod.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                     window=window)
    assert fa_mod.flash_attention_bwd.launches == before + 1
    assert _ran_body(fa_mod.flash_attention_bwd, by_body) == (
        "wgmma" if dtype == torch.bfloat16 and D % 8 == 0 else "simt")
    want = ref.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                   window=window)
    torch.cuda.synchronize()
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        diff = (g.float() - w.float()).abs()
        limit = TOL[dtype] + BWD_RTOL[dtype] * w.float().abs()
        assert (diff <= limit).all(), (name, diff.max().item(),
                                       (diff / limit).max().item())


@pytest.mark.parametrize("which", ["wgmma", "simt"])
@pytest.mark.parametrize("case", [
    (2, 10, 1, 300, 300, 256, True, 64),     # MQA 10, D 256, a window
    (2, 8, 2, 333, 333, 120, True, None),    # GQA 4, D 120, ragged
    (1, 16, 16, 512, 512, 128, True, None),  # olmo's heads
], ids=str)
def test_flash_attention_bwd_is_deterministic(cuda_device, which, case):
    """Two backward calls on the same inputs give the same bits, on each
    body: dK / dV sum a GQA group inside one CTA in a fixed order and dQ
    has its own kernel, no atomics (a resumed training run repeats its
    losses)."""
    B, hq, hkv, Sq, Skv, D, causal, window = case
    q, k, v, do = _attn_inputs(torch.bfloat16, cuda_device, B, hq, hkv, Sq,
                               Skv, D)
    out, lse = fa_mod._forward(q, k, v, causal, window, None, True)
    runs = [fa_mod.launch_bwd(q, k, v, out, lse, do, causal=causal,
                              window=window, which=which) for _ in range(2)]
    torch.cuda.synchronize()
    assert runs[0][3] == runs[1][3] == which
    for a, b in zip(runs[0][:3], runs[1][:3]):
        assert torch.equal(a, b)


def test_flash_attention_bwd_wgmma_refuses_untaken_layouts(cuda_device):
    """The C entry asked for the wgmma body with inputs it does not take
    (f32, a base off 16 bytes, a head dim off 8) returns an error and the
    wrapper raises; nothing reruns on the simt body."""
    q, k, v, do = _attn_inputs(torch.bfloat16, cuda_device, 1, 4, 4, 90, 90,
                               64)
    out, lse = fa_mod._forward(q, k, v, True, None, None, True)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda_device)
    mis = buf[1:].view(q.shape).copy_(q)
    f32 = [t.float() for t in (q, k, v, out, do)]
    odd = _attn_inputs(torch.bfloat16, cuda_device, 1, 4, 4, 90, 90, 100)
    o_odd, lse_odd = fa_mod._forward(*odd[:3], True, None, None, True)
    n0 = dict(fa_mod.flash_attention_bwd.launches_by_body)
    for args in ((mis, k, v, out, lse, do), (*f32[:4], lse, f32[4]),
                 (*odd[:3], o_odd, lse_odd, odd[3])):
        assert fa_mod.bwd_body(*args[:3]) == "simt"
        with pytest.raises(RuntimeError, match="wgmma body"):
            fa_mod.launch_bwd(*args, which="wgmma")
    torch.cuda.synchronize()
    assert fa_mod.flash_attention_bwd.launches_by_body == n0
    got = fa_mod.launch_bwd(mis, k, v, out, lse, do, which="simt")
    want = ref.flash_attention_bwd(mis, k, v, out, lse, do)
    assert got[3] == "simt"
    for g, w in zip(got[:3], want):
        diff = (g.float() - w.float()).abs()
        assert (diff <= TOL[torch.bfloat16]
                + BWD_RTOL[torch.bfloat16] * w.float().abs()).all()


def test_flash_attention_autograd_on_cuda(cuda_device):
    """Under autograd a CUDA call goes through K1 and its backward
    kernel (one launch each), and the gradients equal the plain
    backward's on the same inputs within TOL."""
    q, k, v, do = _attn_inputs(torch.float32, cuda_device, 2, 4, 2, 90, 90,
                               64)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    f0, b0 = fa_mod.flash_attention.launches, \
        fa_mod.flash_attention_bwd.launches
    out = fa_mod.flash_attention(*leaves, window=30)
    grads = torch.autograd.grad(out, leaves, do)
    assert fa_mod.flash_attention.launches == f0 + 1
    assert fa_mod.flash_attention_bwd.launches == b0 + 1
    _, lse = ref.flash_attention(q, k, v, window=30, return_lse=True)
    want = ref.flash_attention_bwd(q, k, v, out.detach(), lse, do, window=30)
    for g, w in zip(grads, want):
        _close(g, w, torch.float32)


@pytest.mark.parametrize("B,T,D,with_h0", [(2, 300, 256, False),
                                           (3, 77, 40, True)])
def test_rglru_scan_backward_is_the_reversed_scan(cuda_device, B, T, D,
                                                  with_h0):
    """K5 under autograd: the backward launches K5 on the reversed,
    shifted sequence (one more launch) and equals the plain backward
    loop ``ref.linear_scan_bwd`` bit for bit in f32."""
    gen = torch.Generator().manual_seed(T)
    a = (0.8 + 0.2 * torch.rand((B, T, D), generator=gen)).to(cuda_device)
    x, g = (torch.randn((B, T, D), generator=gen).to(cuda_device)
            for _ in range(2))
    h0 = torch.randn((B, D), generator=gen).to(cuda_device) \
        if with_h0 else None
    leaves = [a.clone().requires_grad_(), x.clone().requires_grad_()] \
        + ([h0.clone().requires_grad_()] if with_h0 else [])
    n0 = k5_mod.rglru_scan.launches
    h = k5_mod.rglru_scan(leaves[0], leaves[1],
                          leaves[2] if with_h0 else None)
    grads = torch.autograd.grad(h, leaves, g)
    assert k5_mod.rglru_scan.launches == n0 + 2
    want = ref.linear_scan_bwd(a, h.detach(), g, h0)
    torch.cuda.synchronize()
    for got, w in zip(grads, want):
        assert torch.equal(got, w.to(got.dtype))


def test_cuda_loss_reaches_attention_and_rglru_params(cuda_device):
    """A loss on the card reaches q / k / v's projections through K1's
    backward and the RG-LRU's gates and decay through K5's: every grad
    leaf of recurrentgemma smoke (rglru, rglru, local) is finite and
    those of ``wq`` / ``wk`` / ``wv`` and ``w_a`` / ``w_i`` / ``lam`` are
    not all zero."""
    from repro_torch import tree as tr
    from repro_torch.configs import get_config
    from repro_torch.launch.train import value_and_grad
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import RunCtx

    cfg = get_config("recurrentgemma_2b").smoke()
    model = Model(cfg, device=cuda_device)
    params = model.init(seed=0)
    gen = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen)
    batch = {"tokens": tok.to(cuda_device),
             "targets": tok.roll(-1, 1).to(cuda_device)}
    b0, k0 = fa_mod.flash_attention_bwd.launches, k5_mod.rglru_scan.launches
    _, _, grads = value_and_grad(model, RunCtx(), params, batch)
    assert fa_mod.flash_attention_bwd.launches > b0
    assert k5_mod.rglru_scan.launches >= k0 + 2
    seen = set()
    for (path, _), g in zip(tr.flatten(params), grads):
        assert torch.isfinite(g).all(), path
        if path[-1] in ("wq", "wk", "wv", "w_a", "w_i", "lam"):
            assert g.abs().max().item() > 0, path
            seen.add(path[-1])
    assert seen == {"wq", "wk", "wv", "w_a", "w_i", "lam"}
