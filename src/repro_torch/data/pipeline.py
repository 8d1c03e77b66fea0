"""Data pipeline: deterministic, sharded, resumable token streams.

Counterpart of ``repro/data/pipeline.py``. ``batch(step, shard)`` is a
pure function of (seed, step, shard), so a restarted run needs no data
state beyond the step counter. Batches are built with numpy exactly as
JAX builds them, so tokens and targets equal JAX's for every (seed,
step, shard); they come back as int64 tensors (torch's ``gather`` and
``cross_entropy`` index in int64, where JAX's are int32) on the device
the caller names.

  * SyntheticLM — per-sequence affine recurrences
    x_{t+1} = (a x_t + b) mod V, learnable, so a loss curve falls.
  * FileTokens  — a memory-mapped flat .bin of token ids.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    path: Optional[str] = None       # None -> synthetic


def _to_batch(seqs, device):
    seqs = torch.from_numpy(np.ascontiguousarray(seqs)).to(device)
    return {"tokens": seqs[:, :-1], "targets": seqs[:, 1:]}


class SyntheticLM:
    """Deterministic synthetic LM stream with learnable structure."""

    def __init__(self, cfg: DataConfig, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1):
        cfg = self.cfg
        local = cfg.global_batch // n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, shard]))
        a = rng.integers(1, 17, (local, 1))
        b = rng.integers(0, cfg.vocab_size, (local, 1))
        x0 = rng.integers(0, cfg.vocab_size, (local, 1))
        seqs = np.empty((local, cfg.seq_len + 1), np.int64)
        seqs[:, 0] = x0[:, 0]
        for i in range(1, cfg.seq_len + 1):
            seqs[:, i] = (a[:, 0] * seqs[:, i - 1] + b[:, 0]) % cfg.vocab_size
        return _to_batch(seqs, self.device)

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class FileTokens:
    """Flat uint16/uint32 .bin of token ids, memory-mapped."""

    def __init__(self, cfg: DataConfig, dtype=np.uint16, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.data = np.memmap(cfg.path, dtype=dtype, mode="r")
        self.n_tokens = len(self.data)

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1):
        cfg = self.cfg
        local = cfg.global_batch // n_shards
        span = cfg.seq_len + 1
        per_step = cfg.global_batch * span
        base = (step * per_step + shard * local * span) % max(
            self.n_tokens - per_step, 1)
        rows = [np.asarray(self.data[base + i * span: base + (i + 1) * span],
                           np.int64) % cfg.vocab_size
                for i in range(local)]
        return _to_batch(np.stack(rows), self.device)


def make_source(cfg: DataConfig, device="cpu"):
    return (FileTokens(cfg, device=device) if cfg.path
            else SyntheticLM(cfg, device))
