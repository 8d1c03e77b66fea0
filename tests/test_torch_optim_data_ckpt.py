"""The port's optimizer, LR schedule, gradient compression, data pipeline
and checkpoints against the JAX package on the CPU (no model).

Inputs are made by numpy from a seed and handed to both packages. The
optimizer is held on identical gradients (JAX's own, from
``jax.grad`` of a small loss): its elementwise updates (AdamW, Adafactor's
unfactored leaves, Kahan bf16, bf16 state) equal JAX's bit for bit while
the clip does not bite (the clip scale is then exactly 1). Reductions add
in torch's order, not XLA's, so each leaf's sum of squares, the global
norm, the clip scale when it bites and Adafactor's row / column means
may differ in the last bit: those are held within a few f32 ulps (stated
per test). JAX runs eagerly here, op by op, as the port does (a jitted
JAX step may fuse into FMAs).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import CheckpointManager as JCkpt
from repro.data import pipeline as jdata
from repro.optim import grad_compression as jgc
from repro.optim import optimizer as jopt
from repro.optim import schedule as jsched
from repro_torch import tree as tr
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.data import pipeline as data
from repro_torch.optim import grad_compression as gc
from repro_torch.optim import optimizer as opt
from repro_torch.optim import schedule as sched

torch.set_num_threads(1)

SHAPES = {"embed": (32, 16), "groups": {"g0": {"w": (2, 16, 24),
                                               "b": (2, 24)}},
          "final_norm": {}, "lm_head": (16, 32), "lam": (24,)}


def _tree(fn, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: _tree(fn, v) for k, v in shapes.items()}
    return fn(shapes)


def _np_params(seed=0):
    rng = np.random.default_rng(seed)
    return _tree(lambda s: rng.standard_normal(s).astype(np.float32))


def _jax_grads(params_np, scale):
    """JAX's gradient of a small nonlinear loss at ``params_np``."""
    rng = np.random.default_rng(1)
    targets = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape), jnp.float32), params_np)

    def loss(p):
        return sum(jnp.sum(jnp.sin(x) * t) for x, t in
                   zip(jax.tree.leaves(p), jax.tree.leaves(targets)))

    g = jax.grad(loss)(jax.tree.map(jnp.asarray, params_np))
    return jax.tree.map(lambda x: np.asarray(x * scale, np.float32), g)


def _to_torch(tree, dtype=None):
    return tr.map_tree(lambda a: torch.from_numpy(np.array(a)).to(dtype)
                       if dtype else torch.from_numpy(np.array(a)), tree)


def _bits(x):
    """A leaf's bytes: a JAX / numpy array or a torch tensor, bf16 too."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


@pytest.mark.parametrize("step", [0, 1, 5, 19, 20, 21, 37, 60, 99, 100, 150])
def test_warmup_cosine_within_an_ulp_of_jax(step):
    """Warm-up values equal JAX's; past it torch's and XLA's f32 ``cos``
    may round the last bit apart: within 1 ulp."""
    kw = dict(peak_lr=3e-4, warmup_steps=20, total_steps=100)
    want = np.asarray(jsched.warmup_cosine(jnp.asarray(step, jnp.int32),
                                           **kw))
    got = sched.warmup_cosine(torch.tensor(step, dtype=torch.int32),
                              **kw).numpy()
    assert got.dtype == want.dtype == np.float32
    assert abs(int(got.view(np.int32)) - int(want.view(np.int32))) <= 1
    if step < 20:
        assert got == want
    c = sched.constant(torch.tensor(step), peak_lr=3e-3)
    assert c.dtype == torch.float32 and c.item() == np.float32(3e-3)


CASES = {
    "adamw": dict(),
    "adamw_vrp": dict(norm_tile="vrp"),
    "adamw_bf16_state": dict(state_dtype="bfloat16"),
    "adamw_kahan_bf16": dict(kahan=True),
    "adafactor": dict(kind="adafactor"),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("clip", ["off", "on"])
def test_apply_updates_matches_jax(case, clip):
    """Three steps of ``apply_updates`` on JAX's own gradients, lr from
    ``warmup_cosine`` (bit-equal in warm-up). With the clip off (grad_clip
    above the norm: scale exactly 1) every elementwise leaf is bit-equal
    to JAX's: AdamW's params, m and v, Kahan's bf16 params and
    compensation, the bf16 state; Adafactor's 1-D leaves. What a
    reduction feeds differs by rounding only: grad_norm within 1e-6
    relative (a sum of ~1,900 squares in another order); with the clip
    on, or through Adafactor's row / column means, params within 2e-6
    relative and 1e-6 absolute."""
    kw = CASES[case]
    cfg_kw = dict(kw, grad_clip=1e9 if clip == "off" else 1.0)
    jcfg, tcfg = jopt.OptConfig(**cfg_kw), opt.OptConfig(**cfg_kw)
    bf16 = kw.get("kahan", False)
    pnp = _np_params()
    jparams = jax.tree.map(lambda a: jnp.asarray(
        a, jnp.bfloat16 if bf16 else jnp.float32), pnp)
    tparams = _to_torch(pnp, torch.bfloat16 if bf16 else None)
    jstate, tstate = jopt.init_opt_state(jparams, jcfg), \
        opt.init_opt_state(tparams, tcfg)
    assert [np.asarray(x).shape for x in jax.tree.leaves(jstate)] == \
        [tuple(t.shape) for t in tr.leaves(tstate)]
    lr_kw = dict(peak_lr=3e-2, warmup_steps=20, total_steps=100)
    exact = clip == "off" and case != "adafactor"
    for _ in range(3):
        g = _jax_grads(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                    jparams), 10.0)
        jg = jax.tree.map(lambda a, p: jnp.asarray(a, p.dtype), g, jparams)
        tg = tr.map_tree(lambda a, p: torch.tensor(a).to(p.dtype), g,
                         tparams)
        jlr = jsched.warmup_cosine(jstate["step"], **lr_kw)
        tlr = sched.warmup_cosine(tstate["step"], **lr_kw)
        assert np.asarray(jlr) == tlr.numpy()
        jparams, jstate, jm = jopt.apply_updates(jparams, jg, jstate, jcfg,
                                                 jlr)
        tparams, tstate, tm = opt.apply_updates(tparams, tg, tstate, tcfg,
                                                tlr)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert clip == "on" or float(jm["grad_norm"]) < 1e9
        for path, t in tr.flatten({"params": tparams, "opt": tstate}):
            j = {"params": jparams, "opt": jstate}
            for k in path:
                j = j[k]
            assert t.dtype == getattr(torch, str(j.dtype)), path
            if exact or (case == "adafactor" and clip == "off"
                         and path[-1] == "v"):
                assert _bits(t) == _bits(j), path
            else:
                np.testing.assert_allclose(t.float().numpy(),
                                           np.asarray(j, np.float32),
                                           rtol=2e-6, atol=1e-6,
                                           err_msg=str(path))


def test_global_norm_and_clip_match_jax():
    """``global_norm`` (vec and vrp tiles) and ``clip_by_global_norm``
    within 1e-6 relative of JAX's (per-leaf sums add in another order)."""
    g = _jax_grads(_np_params(), 3.0)
    jg, tg = jax.tree.map(jnp.asarray, g), _to_torch(g)
    for tile in ("vec", "vrp"):
        np.testing.assert_allclose(opt.global_norm(tg, tile).item(),
                                   float(jopt.global_norm(jg, tile)),
                                   rtol=1e-6)
    tc, tn = opt.clip_by_global_norm(tg, 1.0)
    jc, jn = jopt.clip_by_global_norm(jg, 1.0)
    np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
    for a, b in zip(tr.leaves(tc), jax.tree.leaves(jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-9)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kahan_add_bit_equal(dtype):
    """``_kahan_add`` rounds to nearest even in both packages."""
    rng = np.random.default_rng(3)
    p, d, c = (rng.standard_normal(4096).astype(np.float32) * s
               for s in (1.0, 1e-3, 1e-4))
    jd = getattr(jnp, dtype)
    jt, jc = jopt._kahan_add(jnp.asarray(p, jd), jnp.asarray(d),
                             jnp.asarray(c, jd))
    td = getattr(torch, dtype)
    tt, tc = opt._kahan_add(torch.from_numpy(p).to(td), torch.from_numpy(d),
                            torch.from_numpy(c).to(td))
    assert _bits(tt) == _bits(jt) and _bits(tc) == _bits(jc)


def test_grad_compression_bit_equal():
    """quantize_int8 / dequantize_int8 / compress_residual equal JAX's
    bit for bit; ``compressed_psum`` names the Multi-device item."""
    rng = np.random.default_rng(4)
    g = rng.standard_normal((64, 33)).astype(np.float32)
    r = rng.standard_normal((64, 33)).astype(np.float32) * 1e-2
    jq, js = jgc.quantize_int8(jnp.asarray(g))
    tq, ts = gc.quantize_int8(torch.from_numpy(g))
    assert _bits(tq) == _bits(jq) and _bits(ts) == _bits(js)
    assert _bits(gc.dequantize_int8(tq, ts)) == \
        _bits(jgc.dequantize_int8(jq, js))
    jout = jgc.compress_residual(jnp.asarray(g), jnp.asarray(r))
    tout = gc.compress_residual(torch.from_numpy(g), torch.from_numpy(r))
    assert all(_bits(a) == _bits(b) for a, b in zip(tout, jout))
    with pytest.raises(NotImplementedError, match="Multi-device"):
        gc.compressed_psum(torch.from_numpy(g), torch.from_numpy(r), "pod")


@pytest.mark.parametrize("seed,step,shard,n_shards", [
    (0, 0, 0, 1), (0, 7, 0, 1), (3, 11, 1, 2), (5, 123456, 3, 4)])
def test_synthetic_batches_equal_jax(seed, step, shard, n_shards):
    cfg = dict(vocab_size=257, seq_len=33, global_batch=8, seed=seed)
    want = jdata.SyntheticLM(jdata.DataConfig(**cfg)).batch_at(
        step, shard, n_shards)
    got = data.SyntheticLM(data.DataConfig(**cfg)).batch_at(
        step, shard, n_shards)
    for k in ("tokens", "targets"):
        assert got[k].dtype == torch.int64 and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_file_tokens_equal_jax(tmp_path):
    path = str(tmp_path / "tokens.bin")
    np.random.default_rng(5).integers(0, 65535, 5000).astype(
        np.uint16).tofile(path)
    cfg = dict(vocab_size=1000, seq_len=31, global_batch=4, path=path)
    jsrc = jdata.make_source(jdata.DataConfig(**cfg))
    tsrc = data.make_source(data.DataConfig(**cfg))
    assert isinstance(tsrc, data.FileTokens)
    for step, shard, n in ((0, 0, 1), (3, 1, 2), (40, 0, 1)):
        want, got = jsrc.batch_at(step, shard, n), tsrc.batch_at(step, shard,
                                                                  n)
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))


def _ckpt_tree():
    rng = np.random.default_rng(6)
    return {"params": {"w": rng.standard_normal((3, 5)).astype(np.float32),
                       "h": rng.standard_normal((4,)).astype(np.float32),
                       "empty": {}},
            "opt": {"step": np.int32(7),
                    "m": {"w": rng.standard_normal((3, 5)).astype(
                        np.float32)}}}


def _jax_tree(t):
    out = jax.tree.map(jnp.asarray, t)
    out["params"]["h"] = out["params"]["h"].astype(jnp.bfloat16)
    return out


def _torch_tree(t):
    out = tr.map_tree(lambda a: torch.from_numpy(np.array(a)), t)
    out["params"]["h"] = out["params"]["h"].to(torch.bfloat16)
    return out


def test_checkpoints_cross_restore_byte_equal(tmp_path):
    """The same tree written by JAX and by the port: the same manifest
    keys and step, byte-identical ``.npy`` files (the bf16 leaf as
    ``'<V2'`` in both); each package restores the other's checkpoint to
    an equal tree (JAX returns a bf16 leaf as ``V2`` bytes, the port as
    bf16)."""
    t = _ckpt_tree()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JCkpt(jdir, async_write=False).save(3, _jax_tree(t), {"step": 3})
    CheckpointManager(tdir, async_write=False).save(3, _torch_tree(t),
                                                    {"step": 3})
    jm = json.load(open(os.path.join(jdir, "step_3", "manifest.json")))
    tm = json.load(open(os.path.join(tdir, "step_3", "manifest.json")))
    assert jm["keys"] == tm["keys"] == ["opt/m/w", "opt/step", "params/h",
                                        "params/w"]
    assert jm["step"] == tm["step"] == 3 and jm["metadata"] == tm["metadata"]
    for i in range(len(jm["keys"])):
        a = open(os.path.join(jdir, "step_3", f"{i}.npy"), "rb").read()
        b = open(os.path.join(tdir, "step_3", f"{i}.npy"), "rb").read()
        assert a == b, jm["keys"][i]
    assert b"'descr': '<V2'" in open(os.path.join(
        tdir, "step_3", "2.npy"), "rb").read()
    want = _torch_tree(t)
    got, meta = CheckpointManager(jdir).restore(template=want)
    assert meta == {"step": 3}
    for (p, a), (_, b) in zip(tr.flatten(got), tr.flatten(want)):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    jflat, _ = JCkpt(tdir).restore()
    assert jflat["params/h"].dtype == np.dtype("V2")
    assert jflat["params/h"].tobytes() == _bits(want["params"]["h"])
    jgot, _ = JCkpt(tdir).restore(template=_jax_tree(t))
    for a, b in zip(jax.tree.leaves(jgot), tr.leaves(want)):
        assert np.asarray(a).tobytes() == _bits(b)


def test_checkpoint_atomic_keep_k_async(tmp_path):
    """Keep-k leaves the latest ``keep`` steps; a stale ``tmp.*`` dir (a
    crash mid-write) is never a step; async saves are complete after
    ``wait``, and a failed write surfaces there."""
    d = str(tmp_path / "ck")
    mgr = CheckpointManager(d, keep=2)
    tree = _torch_tree(_ckpt_tree())
    os.makedirs(os.path.join(d, "tmp.9.123"))
    for s in range(1, 6):
        mgr.save(s, tree, {"step": s})
    mgr.wait()
    assert mgr.all_steps() == [4, 5] and mgr.latest_step() == 5
    assert not [n for n in os.listdir(d) if n.startswith("tmp.")
                and n != "tmp.9.123"]
    got, meta = mgr.restore(template=tree)
    assert meta == {"step": 5} and torch.equal(got["params"]["w"],
                                               tree["params"]["w"])
    with pytest.raises(NotImplementedError, match="Multi-device"):
        mgr.restore(template=tree, shardings=object())
    bad = str(tmp_path / "gone")
    mgr2 = CheckpointManager(bad)
    os.rmdir(bad)
    open(bad, "w").close()            # the directory is now a file
    mgr2.save(1, tree)
    with pytest.raises(OSError):
        mgr2.wait()
