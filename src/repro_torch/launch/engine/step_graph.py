"""The paged decode step as one device program: feed select, decode,
sample.

``fused_step`` is the JAX scheduler's ``overlap_fn``: each slot's fed
token is the host's or, where ``use_prev`` is set, the previous step's
sampled token still on the device; then ``Model.decode_step_paged`` (an
encoder-decoder's with each slot's arena row and frame count) and
``sampling.fused_sample``. It returns the (num_slots,) int32 tokens on
the device and writes the pools in place.

``DecodeStep`` runs it for one ``PagedBackend``. On the CPU it runs
eagerly, as the tests do. On CUDA it runs as a ``torch.cuda.CUDAGraph``
over static device buffers, one graph for the all-greedy variant and
one for the sampled one, chosen on the host before the replay. Both are
captured when the runner is built, which ``PagedBackend`` does before
any slot is live (table at the null block, lengths 0, the dead feed),
so the warm-up's writes land in the null block and in free slots' rings
and carries, which admission overwrites (an encoder-decoder's slots read
the null arena row with no frames: zeros). A failed capture raises; a
replay whose pools or params have moved raises. Nothing falls back to
the eager step on the card.

Per dispatch the host arrays (the fed tokens, ``use_prev``, lengths,
RNG-stream steps, the four sampler arrays, an encoder-decoder's arena
rows and frame counts, and the block table) are
packed into one pinned int32 buffer and copied to the device in one
non-blocking copy; the sampled tokens come back by one non-blocking copy
into pinned memory behind an event. Two such staging sets alternate, so
the host never rewrites a buffer a copy may still read. Everything runs
on the current stream, in the order the scheduler enqueues it: a COW
copy or an admission's prefill enqueued after a dispatch runs after it.

The captured graph reads its own output buffer as the feed of the rows
that ``use_prev`` marks: at a replay it holds the previous dispatch's
tokens. With no dispatch in flight ``use_prev`` is all False and the
feed is dead (the eager step passes zeros there, as JAX does).

Kernel launch counters (``kernels/counters.py``) count replays: the
capture's launches are recorded, taken back out, and added once per
replay. A tensor-parallel rank's collectives (``RunCtx.shard``'s
``TPStats``) are counted the same way. The backend decides whether to
capture (``capture=False``: the step runs eagerly on the card too, as a
gloo mesh needs, whose collectives no graph takes).
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from ...kernels import counters
from .sampling import fused_sample


def fused_step(model, ctx, params, pools, table, lengths, host_tokens,
               prev_toks, use_prev, steps, samp, cross=None):
    """Feed select + ``decode_step_paged`` + ``fused_sample``: tokens
    (B, 1) are ``prev_toks`` where ``use_prev`` else ``host_tokens``;
    ``samp`` is None (greedy) or the (seeds, temps, top_ks, top_ps)
    tensors; ``cross`` None or an encoder-decoder's (arena_ids,
    enc_lengths). Returns the (B,) int32 sampled tokens on the device."""
    tokens = torch.where(use_prev[:, None], prev_toks[:, None].int(),
                         host_tokens)
    kw = {} if cross is None else {"arena_ids": cross[0],
                                   "enc_lengths": cross[1]}
    logits, _ = model.decode_step_paged(params, pools, table, lengths,
                                        tokens, ctx, **kw)
    return fused_sample(logits, steps, samp)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


class Tokens:
    """One dispatched step's sampled tokens: ``device`` feeds the next
    step; ``fetch()`` waits for them and returns a numpy (B,) int32 (a
    replay's through its pinned copy and event, an eager step's by a
    blocking copy)."""

    def __init__(self, device_toks, host=None, event=None):
        self.device = device_toks
        self._host, self._event = host, event

    def fetch(self) -> np.ndarray:
        if self._event is None:       # eager: a blocking copy on the card
            return self.device.cpu().numpy().copy()
        self._event.synchronize()                # not the whole device
        return self._host.numpy().copy()


class DecodeStep:
    """``fused_step`` for one backend: eager on the CPU, two captured
    CUDA graphs on the card (see the module docstring).

    Attributes
    ----------
    graphed : bool
        True on the card: every dispatch is a graph replay.
    """

    # the packed int32 words a slot takes before its table row: fed
    # token, use_prev, length, step, seed, temp, top_k, top_p, and an
    # encoder-decoder's arena row and frame count
    _FIELDS = ("tok", "use", "len", "step", "seed", "temp", "top_k", "top_p")
    _CROSS = ("arena", "enc_len")

    def __init__(self, model, params, pools, ctx, num_slots: int,
                 max_blocks: int, cross: bool = False, capture: bool = True):
        self.model, self.params, self.ctx = model, params, ctx
        self.device = model.device
        self.N, self.MB = num_slots, max_blocks
        self.fields = self._FIELDS + (self._CROSS if cross else ())
        self._graphs = None
        self._tp = ctx.shard.stats if ctx.shard is not None else None
        self._mode = "global" if self._tp is None else "thread_local"
        if capture and self.device.type == "cuda":
            self._capture(pools)

    @property
    def graphed(self) -> bool:
        return self._graphs is not None

    # -- the card --------------------------------------------------------

    def _views(self, words):
        N = self.N
        v = {f: words[i * N:(i + 1) * N] for i, f in enumerate(self.fields)}
        v["temp"] = v["temp"].view(torch.float32)
        v["top_p"] = v["top_p"].view(torch.float32)
        v["table"] = words[len(self.fields) * N:].view(N, self.MB)
        return v

    def _body(self, pools, greedy: bool):
        v = self._in
        samp = None if greedy else (v["seed"], v["temp"], v["top_k"],
                                    v["top_p"])
        cross = (v["arena"], v["enc_len"]) if "arena" in v else None
        toks = fused_step(self.model, self.ctx, self.params, pools,
                          v["table"], v["len"], v["tok"][:, None],
                          self._out, v["use"] != 0, v["step"], samp, cross)
        self._out.copy_(toks)

    def _capture(self, pools):
        dev = self.device
        n_words = len(self.fields) * self.N + self.N * self.MB
        self._words = torch.zeros(n_words, dtype=torch.int32, device=dev)
        self._in = self._views(self._words)
        self._in["top_p"].fill_(1.0)
        self._out = torch.zeros(self.N, dtype=torch.int32, device=dev)
        self._stage = []
        for _ in range(2):
            words = torch.zeros(n_words, dtype=torch.int32, pin_memory=True)
            self._stage.append({
                "in": words,
                "np": {k: t.numpy() for k, t in self._views(words).items()},
                "out": torch.zeros(self.N, dtype=torch.int32,
                                   pin_memory=True),
                "done": None})
        self._turn = 0
        self._ptrs = [t.data_ptr() for t in _leaves(pools)
                      + _leaves(self.params)]
        before = counters.snapshot()
        tp_before = self._tp.snapshot() if self._tp else None
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):            # warm-up: builds kernels,
            for greedy in (True, False):         # cuBLAS handles, plans
                self._body(pools, greedy)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        # No garbage collection inside a capture: a collected engine's
        # graphs and pinned buffers would be released on the capturing
        # stream, which invalidates the capture.
        gc.collect()
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            graphs = {}
            mempool = None
            for greedy in (True, False):
                graph = torch.cuda.CUDAGraph()
                at = counters.snapshot()
                tp_at = self._tp.snapshot() if self._tp else None
                # a mesh's collectives: the process group's watchdog
                # thread queries CUDA events while this thread captures,
                # which only a thread-local capture allows
                with torch.cuda.graph(graph, pool=mempool,
                                      capture_error_mode=self._mode):
                    self._body(pools, greedy)
                mempool = graph.pool()
                tp_delta = None if self._tp is None else counters.delta(
                    tp_at, self._tp.snapshot())
                graphs[greedy] = (graph,
                                  counters.delta(at, counters.snapshot()),
                                  tp_delta)
        finally:
            if gc_was_on:
                gc.enable()
        self._graphs = graphs
        counters.restore(before)
        if self._tp is not None:
            self._tp.collectives, self._tp.bytes = tp_before

    def _replay(self, pools, table, lengths, host_tokens, use_prev, steps,
                samp, cross) -> Tokens:
        ptrs = [t.data_ptr() for t in _leaves(pools) + _leaves(self.params)]
        if ptrs != self._ptrs:
            raise RuntimeError(
                "captured decode step: a pool or param tensor moved since "
                "the capture; every writer must update the pools in place")
        st = self._stage[self._turn]
        self._turn ^= 1
        if st["done"] is not None:
            st["done"].synchronize()     # its last copies have finished
        h = st["np"]
        h["tok"][:] = host_tokens.reshape(-1)
        h["use"][:] = use_prev
        h["len"][:] = lengths
        h["step"][:] = steps
        h["table"][:] = table
        if samp is not None:
            h["seed"][:], h["temp"][:], h["top_k"][:], h["top_p"][:] = samp
        if cross is not None:
            h["arena"][:], h["enc_len"][:] = cross
        self._words.copy_(st["in"], non_blocking=True)
        graph, delta, tp_delta = self._graphs[samp is None]
        graph.replay()
        st["out"].copy_(self._out, non_blocking=True)
        st["done"] = torch.cuda.Event()
        st["done"].record()
        counters.add(delta)
        if tp_delta is not None:
            self._tp.add(tp_delta)
        return Tokens(self._out, st["out"], st["done"])

    # -- both devices ----------------------------------------------------

    def dispatch(self, pools, table, lengths, host_tokens, use_prev,
                 prev: Tokens | None, steps, samp, cross=None) -> Tokens:
        """Enqueue one step without waiting for it. ``table`` (N, MB),
        ``lengths``, ``host_tokens`` (N, 1), ``use_prev`` (bool) and
        ``steps`` are host numpy arrays, ``samp`` None or the host
        (seeds, temps, top_ks, top_ps), ``cross`` None or the host
        (arena_ids, enc_lengths) of an encoder-decoder; ``prev`` is the
        in-flight step whose tokens feed the ``use_prev`` rows (None:
        the dead feed)."""
        if self._graphs is not None:
            if prev is not None and prev.device is not self._out:
                raise RuntimeError("captured decode step: the feed is not "
                                   "the previous dispatch's tokens")
            return self._replay(pools, table, lengths, host_tokens,
                                use_prev, steps, samp, cross)

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        prev_toks = prev.device if prev is not None else \
            torch.zeros(self.N, dtype=torch.int32, device=self.device)
        samp_t = None if samp is None else tuple(dev(a) for a in samp)
        cross_t = None if cross is None else tuple(dev(a) for a in cross)
        toks = fused_step(self.model, self.ctx, self.params, pools,
                          dev(table), dev(lengths), dev(host_tokens),
                          prev_toks, dev(use_prev), dev(steps), samp_t,
                          cross_t)
        return Tokens(toks)
