"""Serving engine of the port: one front-end over the paged backend.

    engine = Engine(model, params, EngineConfig(), device="cuda")
    handle = engine.add_request(prompt, SamplingParams(max_tokens=8))
    while engine.has_work:
        for out in engine.step():          # streaming outputs
            consume(out.request_id, out.new_tokens)

``PagedBackend`` runs continuous batching over the block-paged KV pool
with optimistic admission, LIFO preemption, power-of-two bucketed,
batched prefill and the copy-on-write prefix cache;
``SpecDecodeBackend`` adds speculative decoding (``spec_tokens > 0``,
ngram or draft-model drafter). The JAX engine's other backends and
options arrive with later slices (see ``EngineConfig``).
"""

from .api import (Engine, EngineConfig, Request, RequestHandle,
                  RequestOutput, SamplingParams)
from .sampling import sample_tokens
from .scheduler import PagedBackend
from .speculative import NgramDrafter, SpecDecodeBackend

__all__ = [
    "Engine", "EngineConfig", "NgramDrafter", "PagedBackend", "Request",
    "RequestHandle", "RequestOutput", "SamplingParams", "SpecDecodeBackend",
    "sample_tokens",
]
