"""Atomic, async, keep-k checkpoints in the JAX package's on-disk format
(counterpart of ``repro/checkpoint``)."""
