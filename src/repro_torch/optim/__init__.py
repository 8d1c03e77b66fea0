"""Optimizers, LR schedules and gradient compression (counterpart of
``repro/optim``)."""

from .optimizer import (OptConfig, apply_updates, clip_by_global_norm,
                        global_norm, init_opt_state)
from .schedule import constant, warmup_cosine

__all__ = ["OptConfig", "apply_updates", "clip_by_global_norm",
           "global_norm", "init_opt_state", "warmup_cosine", "constant"]
