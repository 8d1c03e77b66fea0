"""LR schedules (pure functions of the step), in f32.

Counterpart of ``repro/optim/schedule.py``: the same expressions in the
same order. torch's and XLA's f32 ``cos`` may round the last bit apart,
so ``warmup_cosine`` past its warm-up equals JAX's within an ulp.
"""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1):
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 *
                     (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, *, peak_lr: float, **_):
    step = torch.as_tensor(step)
    return torch.full(step.shape, peak_lr, dtype=torch.float32,
                      device=step.device)
