"""Serving engine of the port: one front-end over the paged and static
backends.

    engine = Engine(model, params, EngineConfig(), device="cuda")
    handle = engine.add_request(prompt, SamplingParams(max_tokens=8))
    while engine.has_work:
        for out in engine.step():          # streaming outputs
            consume(out.request_id, out.new_tokens)

``PagedBackend`` runs continuous batching over the block-paged KV pool
with optimistic admission, LIFO preemption, power-of-two bucketed,
batched prefill and the copy-on-write prefix cache;
its decode step is one fused call (one CUDA graph replay on the card),
and ``overlap=True`` dispatches the next step before fetching this
one's tokens. ``SpecDecodeBackend`` adds speculative decoding
(``spec_tokens > 0``, ngram or draft-model drafter); ``StaticBackend``
is the lockstep baseline (``backend="static"``). ``ReplicaSet`` runs
R engine replicas on one device behind one FCFS queue, and
``DisaggregatedEngine`` splits them into prefill and decode roles that
hand each request's KV blocks across as a ``MigrationPacket``
(``transport.py``). ``EngineConfig(mesh=...)`` serves one engine over
the T ranks of a tensor-parallel mesh (``launch/mesh.py``,
``launch/sharding.py``): each rank a process with its slices of the
params and of the pool and per-slot state, by a per-block plan.
"""

from .api import (Engine, EngineConfig, Request, RequestHandle,
                  RequestOutput, SamplingParams)
from .disagg import DisaggregatedEngine
from .replica import ReplicaSet
from .sampling import sample_tokens
from .scheduler import PagedBackend
from .speculative import NgramDrafter, SpecDecodeBackend
from .static import StaticBackend
from .transport import MigrationPacket

__all__ = [
    "DisaggregatedEngine", "Engine", "EngineConfig", "MigrationPacket",
    "NgramDrafter", "PagedBackend", "ReplicaSet", "Request",
    "RequestHandle", "RequestOutput", "SamplingParams", "SpecDecodeBackend",
    "StaticBackend", "sample_tokens",
]
