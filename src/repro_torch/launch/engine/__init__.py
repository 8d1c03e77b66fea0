"""Serving engine of the port: one front-end over the paged backend.

    engine = Engine(model, params, EngineConfig(), device="cuda")
    handle = engine.add_request(prompt, SamplingParams(max_tokens=8))
    while engine.has_work:
        for out in engine.step():          # streaming outputs
            consume(out.request_id, out.new_tokens)

``PagedBackend`` runs continuous batching over the block-paged KV pool
with optimistic admission, LIFO preemption and power-of-two bucketed,
batched prefill; the JAX engine's other backends and options arrive with
later slices (see ``EngineConfig``).
"""

from .api import (Engine, EngineConfig, Request, RequestHandle,
                  RequestOutput, SamplingParams)
from .sampling import sample_tokens
from .scheduler import PagedBackend

__all__ = [
    "Engine", "EngineConfig", "PagedBackend", "Request", "RequestHandle",
    "RequestOutput", "SamplingParams", "sample_tokens",
]
