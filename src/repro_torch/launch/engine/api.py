"""Engine front-end: SamplingParams, request handles, streaming outputs.

Counterpart of ``repro/launch/engine/api.py``. The Engine owns request
admission and the step loop, on one device or, with
``EngineConfig.mesh``, on every rank of a tensor-parallel mesh (SPMD:
each rank runs the same scheduler on the same requests over its slices
of the params and its head shard of the pool, and samples the same
tokens from the all-gathered logits); the backend (``PagedBackend``,
``SpecDecodeBackend`` when ``spec_tokens > 0``, or the lockstep
``StaticBackend``) owns the device state and implements
``enqueue(handle)``, ``step()`` and ``stats()``. Every token
is *emitted the step it is sampled* (prefill included), so ``step()``
doubles as the streaming interface.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional, Sequence

from ...models.model import Model, resolve_device
from ...models.paged_kv import KV_DTYPES, blocks_for
from ...models.transformer import RunCtx, check_supported


def prefill_bucket(n: int, floor: int, cap: int) -> int:
    """The prompt-bucket policy: the smallest power of two >=
    max(n, floor), clamped to cap (the same O(log(max_len / floor))
    bucket set as the JAX engine)."""
    return min(max(1 << max(n - 1, 0).bit_length(), floor), cap)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding parameters.

    ``temperature <= 0`` selects greedy (argmax) decoding; otherwise
    logits are temperature-scaled, truncated to the ``top_k`` highest
    and to the top-p nucleus, then sampled from the request's own RNG
    stream.

    Parameters
    ----------
    max_tokens : int
        Retire the request after this many emitted tokens (>= 1).
    temperature : float
        Softmax temperature; ``<= 0`` selects greedy decoding.
    top_k : int
        Keep only the ``top_k`` highest logits (0 disables).
    top_p : float
        Nucleus sampling in (0, 1].
    seed : int
        Derives the request's own RNG stream: token t is a pure function
        of (seed, t) and the request's own logits, so sampled outputs do
        not depend on admission order, slot placement, co-batched
        traffic or preemption history.
    stop_token_ids : tuple of int
        Retire the request on match (the stop token is stripped, never
        emitted), on top of the engine-level ``eos_id``.

    Raises
    ------
    ValueError
        On ``max_tokens < 1``, ``top_p`` outside (0, 1], or negative
        ``top_k``.
    """

    max_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    stop_token_ids: tuple[int, ...] = ()

    def __post_init__(self):
        if self.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0 (0 disables)")

    @property
    def greedy(self) -> bool:
        """True when this request decodes greedily (temperature <= 0)."""
        return self.temperature <= 0.0


@dataclasses.dataclass(frozen=True)
class Request:
    """One unit of admission work, as submitted.

    Parameters
    ----------
    prompt : sequence of int
        Prompt token ids (>= 1 token).
    sampling : SamplingParams, optional
        Decoding parameters; defaults to ``SamplingParams()``.
    encoder_features : array or None
        Precomputed encoder-frontend embeddings of shape ``(frames,
        d_model)`` on the host (a numpy array or a CPU tensor; whisper's
        mel-conv frames, the frontend being a stub). Required for
        encoder-decoder configs, refused otherwise
        (``Engine.check_request``). Submitting the SAME array object with
        several requests shares one cross-KV arena row by refcount (e.g.
        best-of-n over one clip).
    """

    prompt: Sequence[int]
    sampling: Optional[SamplingParams] = None
    encoder_features: Any = None


@dataclasses.dataclass
class RequestHandle:
    """Live view of one request; ``token_ids`` grows as the engine steps.

    Attributes
    ----------
    uid : int
        Engine-assigned request id (matches ``RequestOutput.request_id``).
    prompt : list of int
        The prompt token ids as submitted.
    sampling : SamplingParams
        The request's decoding parameters.
    token_ids : list of int
        Tokens emitted so far, in order (stop tokens are stripped).
    finished : bool
        True once the request retired.
    finish_reason : str or None
        ``"length"`` (max_tokens) or ``"stop"`` (eos / stop token).
    num_preemptions : int
        Times this request was LIFO-preempted and later resumed.
    num_draft_proposed, num_draft_accepted : int
        Speculative-decoding counters: draft tokens proposed for /
        accepted into this request (0 unless ``spec_tokens > 0``), the
        per-request source of ``Engine.stats()["spec"]``.
    t_submit, t_first_token : float or None
        Monotonic-clock stamps at handle creation and at the first
        sampled token (TTFT, aggregated by ``latency_stats``).
    t_tokens : list of float
        Monotonic stamp per *sampled* token (TPOT, ``latency_stats``).
    encoder_features : array or None
        The submitted ``Request.encoder_features``, kept with the handle:
        a preempted request's arena row is recomputed from it on
        re-admission.
    """

    uid: int
    prompt: list[int]
    sampling: SamplingParams
    encoder_features: Any = None
    token_ids: list[int] = dataclasses.field(default_factory=list)
    finished: bool = False
    finish_reason: Optional[str] = None      # "length" | "stop"
    num_preemptions: int = 0
    num_draft_proposed: int = 0
    num_draft_accepted: int = 0
    t_submit: float = dataclasses.field(default_factory=time.monotonic)
    t_first_token: Optional[float] = None
    t_tokens: list[float] = dataclasses.field(default_factory=list)
    # internal: RNG stream position (== tokens sampled; differs from
    # len(token_ids) only after a stripped stop token)
    _n_sampled: int = 0


@dataclasses.dataclass(frozen=True)
class RequestOutput:
    """One streaming increment: tokens a request gained this step.

    Attributes
    ----------
    request_id : int
        The owning request's ``RequestHandle.uid``.
    new_tokens : tuple of int
        Tokens emitted by this increment: one, or none on a stripped
        stop token (a speculative step emits one increment per token).
    num_tokens : int
        Total tokens emitted for the request so far.
    finished : bool
        True when this increment retires the request.
    finish_reason : str or None
        ``"length"`` or ``"stop"`` when ``finished``, else None.
    """

    request_id: int
    new_tokens: tuple[int, ...]
    num_tokens: int
    finished: bool
    finish_reason: Optional[str] = None


def stamp_sample(req: RequestHandle, now: float):
    """Count one sample of ``req``, taken at host time ``now``
    (``time.monotonic``), in its TTFT / TPOT stamps."""
    req._n_sampled += 1
    req.t_tokens.append(now)
    if req._n_sampled == 1:
        req.t_first_token = now


def register_sample(req: RequestHandle, tok: int, eos_id: int,
                    on_finish) -> RequestOutput:
    """Token-acceptance state machine: advance the request's RNG stream,
    strip stop tokens, retire on stop or max_tokens, and emit the
    streaming increment. ``on_finish()`` runs backend cleanup after the
    handle's finished/finish_reason flags are set."""
    stamp_sample(req, time.monotonic())
    stop = (eos_id >= 0 and tok == eos_id) \
        or tok in req.sampling.stop_token_ids
    if not stop:
        req.token_ids.append(tok)
        if len(req.token_ids) < req.sampling.max_tokens:
            return RequestOutput(req.uid, (tok,), len(req.token_ids),
                                 False)
    reason = "stop" if stop else "length"
    req.finished = True
    req.finish_reason = reason
    on_finish()
    return RequestOutput(req.uid, () if stop else (tok,),
                         len(req.token_ids), True, reason)


def _pctl(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted sample."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1,
            max(0, int(round(q * (len(sorted_vals) - 1)))))
    return float(sorted_vals[i])


def latency_stats(handles) -> dict:
    """Aggregate per-request latency stamps into TTFT/TPOT percentiles.

    TTFT is ``t_first_token - t_submit`` per request; TPOT is the mean
    inter-token gap over requests with at least two sampled tokens.

    Parameters
    ----------
    handles : iterable of RequestHandle
        Finished and/or in-flight handles.

    Returns
    -------
    dict
        ``{"ttft": {count, mean_s, p50_s, p95_s, p99_s}, "tpot": {...}}``.
    """
    ttft = sorted(h.t_first_token - h.t_submit for h in handles
                  if h.t_first_token is not None)
    tpot = sorted((h.t_tokens[-1] - h.t_tokens[0]) / (len(h.t_tokens) - 1)
                  for h in handles if len(h.t_tokens) >= 2)

    def summarize(vals):
        return {"count": len(vals),
                "mean_s": float(sum(vals) / len(vals)) if vals else 0.0,
                "p50_s": _pctl(vals, 0.50),
                "p95_s": _pctl(vals, 0.95),
                "p99_s": _pctl(vals, 0.99)}

    return {"ttft": summarize(ttft), "tpot": summarize(tpot)}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine/backend configuration (immutable).

    The fields are the JAX engine's. What a mesh cannot serve yet raises
    NotImplementedError at ``Engine`` construction, naming the ROADMAP
    queue 1 item that brings it (``mesh``).

    Parameters
    ----------
    backend : {"paged", "static"}
        ``"paged"``: continuous batching over the block-paged KV pool
        (the speculative backend when ``spec_tokens > 0``);
        ``"static"``: the lockstep right-padded baseline over a dense
        (num_slots, max_len) cache (``static.StaticBackend``).
    num_slots : int
        Decode batch width (concurrent sequences on device).
    block_size, num_blocks : int
        Paged pool geometry: tokens per cache block and pool size
        (block 0 is the reserved null block).
    max_len : int
        Per-sequence position cap (prompt + output).
    eos_id : int
        Engine-level stop token; -1 retires on length only.
    watermark_blocks : int
        Admission headroom: keep this many blocks free for in-flight
        growth while admitting new sequences.
    bucketed_prefill : bool
        Right-pad prompts to power-of-two buckets (exact for every
        served config).
    max_prefill_batch : int
        Cap on requests prefilled in one batched admission call (the
        static backend's lockstep batch width); <= 0 lifts the cap to
        the slot count.
    prefix_cache : bool
        Copy-on-write prefix caching: admissions match the longest
        block-aligned cached prefix, share those blocks by refcount and
        prefill only the non-shared suffix (through kernel K3);
        unreferenced indexed blocks park in an LRU reclaimed before the
        allocator reports exhaustion. Active when the model's whole
        state lives in the pool (``ServingCaps.prefix_cache``); outputs
        are token-identical with it on or off.
    mesh : launch.mesh.Mesh or None
        Tensor-parallel serving: this process's rank of a ``(data=1,
        model=T)`` mesh (``launch.mesh.init_mesh`` / ``launch``). Every
        rank builds an Engine over the same full params (it keeps its
        slices, ``sharding.shard_params``) and serves the same requests;
        each block splits by the plan chosen from which of its dimensions
        divide T (``launch.sharding.plan_tp``: attention by heads, or by
        query heads over a replicated KV, or whole; the RG-LRU by
        channels, the xLSTM cells by heads, the MoE by experts), reported
        in ``stats()["tp"]``. Tokens are mesh-independent. Every
        family the port serves on one device but the VLM, the
        encoder-decoder included (one attention mode for its encoder,
        decoder and cross-attention, its arena split by kv heads), with
        ``overlap=True`` too; a data axis above 1 raises
        NotImplementedError naming its ROADMAP sub-item (replicas on
        submeshes are ``ReplicaSet(mesh=)``).
    tp_axis : str
        The tensor-parallel axis name of ``mesh``.
    spec_tokens : int
        Speculative decoding: draft tokens proposed per request per step
        (K); the verify pass scores K+1 positions at once through kernel
        K3. 0 disables.
    drafter : {"ngram", "draft_model"}
        Proposal source: zero-parameter prompt lookup, or a small draft
        model given by ``draft_model``/``draft_params``.
    ngram_max : int
        Longest history suffix the ngram drafter keys on.
    draft_model, draft_params
        The draft ``Model`` (attention-only, same vocabulary, on the
        engine's device) and its params for ``drafter="draft_model"``.
    kv_dtype : {"bf16", "int8", "fp8"}
        Paged pool storage precision. ``"bf16"`` stores the model dtype;
        ``"int8"`` / ``"fp8"`` (float8 e4m3fn) store quantized payloads
        plus per-(token, kv head) f32 scales, quantized where rows enter
        the pool and dequantized inside the decode and verify kernels
        (K4), so no full-precision copy of the pool is made. Requires
        ``ServingCaps.quantized_kv`` and the paged backend.
    overlap : bool
        Host/device overlap on the paged backend: ``step()`` dispatches
        the NEXT decode (feeding the in-flight sampled tokens device to
        device) before it fetches the previous step's tokens, so host
        scheduling and admission hide under device work. Outputs are
        bit-identical with it on or off. Requires the paged backend and
        ``spec_tokens == 0``.
    """

    backend: str = "paged"
    num_slots: int = 8
    block_size: int = 16
    num_blocks: int = 512
    max_len: int = 256
    eos_id: int = -1
    watermark_blocks: int = 0
    bucketed_prefill: bool = True
    max_prefill_batch: int = 0
    prefix_cache: bool = True
    mesh: Any = None
    tp_axis: str = "model"
    spec_tokens: int = 0
    drafter: str = "ngram"
    ngram_max: int = 3
    draft_model: Any = None
    draft_params: Any = None
    kv_dtype: str = "bf16"
    overlap: bool = False


def check_request(model: Model, cfg: EngineConfig, prompt: Sequence[int],
                  sampling: SamplingParams, encoder_features=None):
    """Raise ValueError when an engine of ``model`` under ``cfg`` could
    never serve the request (empty prompt, position cap, the paged
    pool's capacity, encoder features absent on an encoder-decoder
    config, present on any other, or not a (frames, d_model) array of
    1..encoder_len frames). Reads the config alone, so a replica set
    validates against replicas this process holds no engine of."""
    mc = model.cfg
    caps = model.serving_caps()
    if len(prompt) < 1:
        raise ValueError("empty prompt")
    if len(prompt) + sampling.max_tokens > cfg.max_len:
        raise ValueError(
            f"prompt ({len(prompt)}) + max_tokens "
            f"({sampling.max_tokens}) exceeds max_len "
            f"{cfg.max_len}")
    if encoder_features is not None and not caps.cross_attn:
        raise ValueError(
            f"encoder features on a non-encoder-decoder config: "
            f"{mc.family}/{mc.name} has no cross-attention "
            f"(enc_dec=False) — drop Request.encoder_features, or "
            f"serve an enc-dec config (e.g. whisper)")
    if caps.cross_attn:
        if encoder_features is None:
            raise ValueError(
                f"encoder-decoder config {mc.family}/{mc.name} "
                f"needs Request.encoder_features (a "
                f"(frames, {mc.d_model}) array — whisper mel-conv "
                f"frames, the frontend being a stub); bare prompts "
                f"are decoder-only")
        shape = getattr(encoder_features, "shape", None)
        if shape is None or len(shape) != 2 or shape[1] != mc.d_model:
            raise ValueError(
                f"encoder_features must be a (frames, d_model="
                f"{mc.d_model}) array, got shape {shape}")
        if not 1 <= shape[0] <= mc.encoder_len:
            raise ValueError(
                f"encoder_features frames ({shape[0]}) outside "
                f"[1, encoder_len={mc.encoder_len}] for "
                f"{mc.family}/{mc.name}")
    if cfg.backend == "paged":
        # the worst case must fit the pool: it could never run even alone
        worst = blocks_for(len(prompt) + sampling.max_tokens,
                           cfg.block_size)
        usable = cfg.num_blocks - 1          # block 0 is the null block
        if worst > usable:
            raise ValueError(
                f"request worst case ({worst} blocks) exceeds pool "
                f"capacity ({usable} usable blocks) — "
                "it could never run to completion even alone")


class Engine:
    """Serving front-end over the paged or static backend on one device,
    or on one rank of a tensor-parallel mesh (``EngineConfig.mesh``).

    Parameters
    ----------
    model : Model
        The target model. A config without a paged decode path (the
        VLM, qwen2-vl) raises NotImplementedError; an encoder-decoder
        config (whisper) needs the paged backend without speculation and
        with a model-dtype pool (ValueError otherwise).
    params
        Its parameter tree, on ``device``.
    cfg : EngineConfig, optional
        Geometry and options; defaults to ``EngineConfig()``.
    ctx : RunCtx, optional
        Per-call model context.
    device : str or torch.device
        Where the engine runs, ``"cuda"`` by default; raises when no GPU
        is present. Must be the model's device (and, under a mesh, the
        rank's ``mesh.device``).

    Attributes
    ----------
    backend : PagedBackend | SpecDecodeBackend | StaticBackend
        The execution backend selected by ``cfg``.
    finished : list of RequestHandle
        Handles retired so far, in completion order.

    Notes
    -----
    Outputs obey the RNG-stream contract: they do not depend on
    admission order, slot placement, co-batched traffic or preemption.
    They do not depend on the prefix cache or speculative decoding
    either. Greedy outputs are token-identical to the JAX engine on the
    same weights. Zero block leaks: every pool block returns to the
    allocator on retirement, preemption and speculative rejected-tail
    rewind (double-frees raise).

    Examples
    --------
    >>> engine = Engine(model, params, EngineConfig(), device="cuda")
    >>> handle = engine.add_request(prompt, SamplingParams(max_tokens=8))
    >>> while engine.has_work:
    ...     for out in engine.step():
    ...         print(out.request_id, out.new_tokens)
    """

    def __init__(self, model: Model, params, cfg: EngineConfig = None,
                 ctx: Optional[RunCtx] = None, device="cuda"):
        from .scheduler import PagedBackend
        from .speculative import SpecDecodeBackend
        from .static import StaticBackend

        self.device = resolve_device(device)
        if self.device != model.device:
            raise ValueError(f"engine device {self.device} != model "
                             f"device {model.device}")
        self.cfg = cfg or EngineConfig()
        if self.cfg.overlap:
            if self.cfg.backend != "paged":
                raise ValueError(
                    "overlap=True requires the paged backend — the "
                    "static baseline fetches lockstep; use "
                    "backend='paged'")
            if self.cfg.spec_tokens > 0:
                raise ValueError(
                    "overlap=True is incompatible with speculative "
                    "decoding: the verify step consumes the sampled "
                    "tokens on the host before the next dispatch; set "
                    "spec_tokens=0")
        if self.cfg.spec_tokens > 0 and self.cfg.backend != "paged":
            raise ValueError(
                "speculative decoding requires the paged backend")
        if self.cfg.kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"unknown kv_dtype {self.cfg.kv_dtype!r}; expected one "
                f"of {KV_DTYPES}")
        if self.cfg.kv_dtype != "bf16" and self.cfg.backend == "static":
            raise ValueError(
                f"quantized KV (kv_dtype={self.cfg.kv_dtype!r}) requires "
                "the paged backend — the static baseline keeps dense "
                "full-precision caches; use backend='paged'")
        if self.cfg.backend not in ("paged", "static"):
            raise ValueError(f"unknown backend {self.cfg.backend!r}")
        self.model = model
        self.caps = model.serving_caps()
        mc = model.cfg
        ctx = ctx or RunCtx()
        if self.cfg.mesh is not None:
            ctx = self._mesh_ctx(ctx)
        if not self.caps.paged_decode:
            raise NotImplementedError(
                f"no paged decode path for config {mc.family}/{mc.name}: "
                "mrope / visual-prefix frontends (qwen2-vl) and "
                "decoder-only absolute-position embeddings are not "
                "served (ServingCaps.paged_decode)")
        if self.caps.cross_attn and self.cfg.backend == "static":
            raise ValueError(
                "encoder-decoder serving needs the paged backend "
                "(the cross-KV arena lives in the paged pool); use "
                "backend='paged'")
        if self.caps.cross_attn and self.cfg.spec_tokens > 0:
            raise ValueError(
                "speculative decoding is decoder-only: the verify pass "
                "has no cross-attention path; set spec_tokens=0 for "
                f"{mc.family}/{mc.name}")
        if self.cfg.kv_dtype != "bf16" and not self.caps.quantized_kv:
            raise ValueError(
                f"config {mc.family}/{mc.name} does not support a "
                f"quantized paged KV pool (kv_dtype="
                f"{self.cfg.kv_dtype!r}): ServingCaps.quantized_kv is "
                "False — encoder-decoder cross-KV arenas and non-paged "
                "frontends stay bf16")
        check_supported(model.cfg)
        if self.cfg.backend == "static":
            backend = StaticBackend
        elif self.cfg.spec_tokens > 0:
            backend = SpecDecodeBackend
        else:
            backend = PagedBackend
        self.backend = backend(model, params, self.cfg, ctx)
        self._uid = 0

    def _mesh_ctx(self, ctx: RunCtx) -> RunCtx:
        """The ``RunCtx`` of this rank: the mesh's ``ShardCtx`` (a fresh
        ``TPStats`` an engine) with the model's plan over it, chosen here
        once (``sharding.plan_tp``, which raises for what no plan
        serves), and ``decode_head_shard`` where the plan splits the
        attention by heads."""
        from ..sharding import make_shard_ctx

        mesh, mc = self.cfg.mesh, self.model.cfg
        if self.device != mesh.device:
            raise ValueError(f"engine device {self.device} != the mesh "
                             f"rank's device {mesh.device}")
        shard = make_shard_ctx(mesh, mc, tp_axis=self.cfg.tp_axis)
        return dataclasses.replace(
            ctx, shard=shard, decode_head_shard=shard.plan.attn == "heads")

    # -- request lifecycle ----------------------------------------------

    def check_request(self, prompt: Sequence[int],
                      sampling: SamplingParams, encoder_features=None):
        """Raise ValueError when this engine could never serve the
        request (``check_request``)."""
        check_request(self.model, self.cfg, prompt, sampling,
                      encoder_features)

    def add_request(self, prompt,
                    sampling: Optional[SamplingParams] = None,
                    encoder_features=None) -> RequestHandle:
        """Validate and enqueue one request; returns its live handle.
        ``prompt`` is a token-id sequence or a ``Request``."""
        if isinstance(prompt, Request):
            if sampling is not None or encoder_features is not None:
                raise ValueError("pass sampling/encoder_features inside "
                                 "the Request, not alongside it")
            sampling = prompt.sampling
            encoder_features = prompt.encoder_features
            prompt = prompt.prompt
        sampling = sampling or SamplingParams()
        prompt = [int(t) for t in prompt]
        self.check_request(prompt, sampling, encoder_features)
        handle = RequestHandle(self._uid, prompt, sampling,
                               encoder_features=encoder_features)
        self._uid += 1
        self.backend.enqueue(handle)
        return handle

    def step(self) -> list[RequestOutput]:
        """Admissions + one device step; streams per-request increments."""
        return self.backend.step()

    @property
    def has_work(self) -> bool:
        """True while any request is waiting or active."""
        return self.backend.has_work

    @property
    def finished(self) -> list[RequestHandle]:
        """Handles retired so far, in completion order."""
        return self.backend.finished

    def stats(self) -> dict:
        """Backend telemetry plus a ``"latency"`` section (TTFT/TPOT
        percentiles over finished and in-flight requests)."""
        st = self.backend.stats()
        st["latency"] = latency_stats(list(self.backend.finished)
                                      + self.backend.live_handles())
        return st

    @property
    def made_progress(self) -> bool:
        """True when the last ``step()`` admitted or decoded."""
        return self.backend.made_progress

    # -- drive to completion --------------------------------------------

    def drain(self, max_steps: int = 100_000) -> list[RequestOutput]:
        """Step until idle; returns the concatenated output stream."""
        return drive(self, max_steps,
                     "engine stalled: waiting requests cannot be admitted")

    def generate(self, prompts: Sequence[Sequence[int]], sampling=None,
                 max_steps: int = 100_000,
                 encoder_features=None) -> list[list[int]]:
        """Submit ``prompts`` and drive to completion; returns token ids
        per prompt in submission order. ``sampling`` is one
        SamplingParams for all or a per-prompt sequence;
        ``encoder_features`` a per-prompt sequence of feature arrays for
        encoder-decoder configs (entries may repeat to share arena
        rows)."""
        return run_generate(self, prompts, sampling, max_steps,
                            encoder_features=encoder_features)


def drive(engine, max_steps: int, stall_msg: str) -> list[RequestOutput]:
    """Drive-to-completion loop: step until idle, guard the step budget,
    raise on a stall (a step that neither emitted nor progressed)."""
    stream: list[RequestOutput] = []
    steps = 0
    while engine.has_work:
        outs = engine.step()
        stream.extend(outs)
        steps += 1
        if steps > max_steps:
            raise RuntimeError("step budget exceeded")
        if not outs and not engine.made_progress:
            raise RuntimeError(stall_msg)
    return stream


def run_generate(engine, prompts, sampling, max_steps,
                 encoder_features=None) -> list[list[int]]:
    """The ``generate`` loop: broadcast/validate sampling params and
    encoder features, submit everything, drain, collect per-prompt
    tokens in order."""
    if sampling is None or isinstance(sampling, SamplingParams):
        sampling = [sampling or SamplingParams()] * len(prompts)
    if len(sampling) != len(prompts):
        raise ValueError(f"{len(sampling)} sampling params for "
                         f"{len(prompts)} prompts")
    if encoder_features is None:
        encoder_features = [None] * len(prompts)
    if len(encoder_features) != len(prompts):
        raise ValueError(f"{len(encoder_features)} encoder features for "
                         f"{len(prompts)} prompts")
    handles = [engine.add_request(p, s, encoder_features=f)
               for p, s, f in zip(prompts, sampling, encoder_features)]
    engine.drain(max_steps=max_steps)
    return [list(h.token_ids) for h in handles]
