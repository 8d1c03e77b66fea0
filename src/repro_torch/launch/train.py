"""The trainer: the train step and the fault-tolerant loop.

Counterpart of ``repro/launch/train.py`` on one device:
  * ``make_train_step``: loss and gradients by ``torch.autograd`` (K1's
    and K5's ``autograd.Function``s on the card), microbatch gradient
    accumulation in ``accum_dtype`` as JAX's ``micro`` scan computes it,
    global-norm clipping (optionally through K8b's compensated sum),
    Kahan-compensated bf16 params (``OptConfig.kahan``);
  * ``train_loop``: restores the latest checkpoint in ``ckpt_dir``
    (atomic, async, JAX's on-disk format, so a JAX checkpoint resumes
    here), deterministic data by ``batch_at(step)``, a step-time
    straggler monitor, ``fail_at`` to inject a failure, the metrics
    file appended a JSON line a step;
  * ``main``: JAX's flags plus ``--device`` (default ``cuda``, which
    raises without a GPU; the CPU runs only when asked for).

The step runs eagerly (JAX jits it). The params are a nested dict of
tensors, as the port's models take them; gradients are taken with
respect to detached copies of their leaves, so a state holds no graph.
Every config the port serves on one device trains: the decoder-only
ones through all three, the encoder-decoder (whisper) through
``make_train_step`` on batches that carry ``frames`` (B, F, d) beside
``tokens`` and ``targets``; the data pipeline makes no frames, as JAX's
makes none, so ``train_loop`` and ``main`` take decoder-only configs.
Sharded steps (``--tp``, ``mesh``) wait for the Multi-device slice.

Run on the card (full size):
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b
    (or another decoder-only config that fits one card: xlstm_1_3b
    does; the MoE decoders' full depth does not)
On the CPU:
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import tree as tr
from ..checkpoint.checkpoint import CheckpointManager
from ..configs import get_config
from ..data.pipeline import DataConfig, make_source
from ..models.model import Model
from ..models.transformer import RunCtx
from ..optim import OptConfig, apply_updates, init_opt_state
from ..optim.schedule import warmup_cosine

MULTI_DEVICE = ("sharded training (tp > 1, a mesh) waits for queue-1 item "
                "Multi-device, sub-item 'sharded training'")


def _no_mark(name):
    pass


def value_and_grad(model, ctx, params, batch, mark=_no_mark):
    """(loss, metrics, grads in JAX's leaf order) of ``model.loss_fn`` on
    one batch, all detached; the gradient of a leaf the loss does not
    reach is zeros, as in JAX. ``mark("loss")`` is called after the
    forward, ``mark("grads")`` after the backward."""
    leaves = [p.detach().requires_grad_() for p in tr.leaves(params)]
    loss, metrics = model.loss_fn(tr.unflatten(params, leaves), batch, ctx)
    mark("loss")
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    mark("grads")
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(model: Model, opt_cfg: OptConfig, ctx: RunCtx,
                    lr_fn: Callable, mark: Callable[[str], None] = _no_mark):
    """(state, batch) -> (state, metrics), pure: the old state is left
    as it was. ``mark`` is called with "start", "loss" (after the
    forward), "grads" (after the backward; with ``grad_accum`` both once
    a microbatch) and "update" (after the optimizer), for a caller that
    records CUDA events there."""

    def grads_of(params, batch):
        if opt_cfg.grad_accum <= 1:
            loss, metrics, grads = value_and_grad(model, ctx, params, batch,
                                                  mark)
            return loss, metrics, tr.unflatten(params, grads)
        A = opt_cfg.grad_accum
        adt = getattr(torch, opt_cfg.accum_dtype)
        flat = tr.leaves(params)
        acc = [torch.zeros(p.shape, dtype=adt, device=p.device) for p in flat]
        loss_acc = torch.zeros((), dtype=torch.float32,
                               device=flat[0].device)
        for i in range(A):
            mb = {k: v.reshape((A, v.shape[0] // A) + v.shape[1:])[i]
                  for k, v in batch.items()}
            loss, _, g = value_and_grad(model, ctx, params, mb, mark)
            acc = [(a.float() + gg.float() / A).to(adt)
                   for a, gg in zip(acc, g)]
            loss_acc = loss_acc + loss / A
        return loss_acc, {"loss": loss_acc}, tr.unflatten(params, acc)

    def train_step(state, batch):
        mark("start")
        loss, metrics, grads = grads_of(state["params"], batch)
        lr = lr_fn(state["opt"]["step"])
        new_params, new_opt, om = apply_updates(
            state["params"], grads, state["opt"], opt_cfg, lr)
        mark("update")
        metrics = {**metrics, **om, "lr": lr}
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def init_state(model: Model, opt_cfg: OptConfig, seed: int = 0):
    """Params from the port's own ``torch.Generator`` (``Model.init``)
    and a zero optimizer state. To start from JAX's init, restore a JAX
    checkpoint (``train_loop`` does when ``ckpt_dir`` holds one)."""
    params = model.init(seed)
    return {"params": params, "opt": init_opt_state(params, opt_cfg)}


class StragglerMonitor:
    """Step-time outlier detector (straggler mitigation hook): flags a
    step slower than ``threshold`` times the median of the window."""

    def __init__(self, window: int = 32, threshold: float = 3.0):
        self.times: list[float] = []
        self.window = window
        self.threshold = threshold
        self.flags = 0

    def observe(self, dt: float) -> bool:
        self.times.append(dt)
        hist = self.times[-self.window:]
        if len(hist) < 8:
            return False
        med = float(np.median(hist[:-1]))
        is_straggler = dt > self.threshold * med
        self.flags += int(is_straggler)
        return is_straggler


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    keep: int = 3
    log_every: int = 10
    metrics_path: Optional[str] = None


def train_loop(model: Model, opt_cfg: OptConfig, ctx: RunCtx,
               data_cfg: DataConfig, loop_cfg: TrainLoopConfig,
               mesh=None, lr_fn=None, state=None,
               fail_at: Optional[int] = None):
    """Fault-tolerant training loop. Returns (state, metrics history).

    ``fail_at`` raises mid-run (tests use it to check the restart).
    Restores from the latest checkpoint in ``ckpt_dir`` if one exists
    (the tree of ``state``, or of a fresh ``init_state``, is the
    template).
    """
    if mesh is not None:
        raise NotImplementedError(MULTI_DEVICE)
    if model.cfg.enc_dec:
        raise ValueError(
            f"{model.cfg.name}: the data pipeline makes token batches "
            "only; train an encoder-decoder through make_train_step on "
            "batches that carry frames")
    lr_fn = lr_fn or functools.partial(
        warmup_cosine, peak_lr=3e-4, warmup_steps=20,
        total_steps=loop_cfg.steps)
    step_fn = make_train_step(model, opt_cfg, ctx, lr_fn)
    source = make_source(data_cfg, device=model.device)
    ckpt = CheckpointManager(loop_cfg.ckpt_dir, keep=loop_cfg.keep)
    monitor = StragglerMonitor()

    start_step = 0
    latest = ckpt.latest_step()
    if latest is not None:
        template = state if state is not None else init_state(model, opt_cfg)
        state, meta = ckpt.restore(latest, template=template,
                                   device=model.device)
        del template
        start_step = int(meta.get("step", latest))
    elif state is None:
        state = init_state(model, opt_cfg)

    history = []
    for step in range(start_step, loop_cfg.steps):
        if fail_at is not None and step == fail_at:
            ckpt.wait()
            raise RuntimeError(f"injected failure at step {step}")
        batch = source.batch_at(step)
        t0 = time.time()
        state, metrics = step_fn(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.time() - t0
        straggler = monitor.observe(dt)
        metrics.update(step=step, dt=dt, straggler=straggler)
        history.append(metrics)
        if loop_cfg.metrics_path:
            with open(loop_cfg.metrics_path, "a") as f:
                f.write(json.dumps(metrics) + "\n")
        if step % loop_cfg.log_every == 0:
            print(f"step {step:5d} loss {metrics['loss']:.4f} "
                  f"gnorm {metrics.get('grad_norm', 0):.2f} {dt*1e3:.0f} ms",
                  flush=True)
        if (step + 1) % loop_cfg.ckpt_every == 0 or step + 1 == loop_cfg.steps:
            ckpt.save(step + 1, state, metadata={"step": step + 1})
    ckpt.wait()
    return state, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=TrainLoopConfig.ckpt_dir)
    ap.add_argument("--kahan", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    if args.tp != 1:
        raise NotImplementedError(MULTI_DEVICE)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = Model(cfg, device=args.device)
    opt_cfg = OptConfig(kahan=args.kahan, grad_accum=args.grad_accum)
    ctx = RunCtx()
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch)
    loop_cfg = TrainLoopConfig(steps=args.steps, ckpt_dir=args.ckpt_dir)
    _, hist = train_loop(model, opt_cfg, ctx, data_cfg, loop_cfg)
    print(f"final loss {hist[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
