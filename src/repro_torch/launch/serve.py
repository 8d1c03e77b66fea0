"""Serving CLI of the port: random-weight requests through ``Engine``,
a ``ReplicaSet`` or a ``DisaggregatedEngine``.

Run on the card:  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo_1b
On the CPU:       PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
Speculative:      add --spec-tokens 3 (ngram drafter)
Quantized pool:   add --kv-dtype int8 (or fp8)
Lockstep static:  add --backend static
Replicas:         add --dp 2 (one device, one shared FCFS queue)
Disaggregated:    add --dp 2 --roles prefill,decode (or --roles auto)
Tensor parallel:  add --tp 2 (T ranks: spawned here, or one a process
                  under torchrun --nproc-per-node T; rank 0 prints)
Replicas x TP:    add --dp 2 --tp 2 (R x T ranks, each replica on a
                  (1, T) submesh behind one shared queue; rank 0 prints)
Disagg x TP:      add --dp 2 --tp 2 --roles auto (KV packets move rank t
                  to rank t between the replicas' submeshes)

``--tp T`` serves one engine over T ranks (``launch/mesh.py``): on the
CPU and on ranks sharing one card over gloo, on T cards of their own over
NCCL. Every rank builds the same seeded params and keeps its slices; the
stats carry a ``tp`` section (mesh, rank, backend, whether the decode
step is a captured graph, collectives per step, bytes, and the per-block
plan: which blocks split and which leaves are kept whole). Every family
but the VLM serves over a mesh (dense, windowed, recurrent, xLSTM, MoE
by expert parallelism, and whisper_base, its requests carrying random
encoder frames here). ``--dp R --tp T`` serves ``ReplicaSet(mesh=)``
over a ``(data=R, model=T)`` mesh, and with ``--roles``
``DisaggregatedEngine(mesh=)``; their stats add the router's exchanges
(and the ``disagg`` section: packets, logical and per-rank bytes).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.engine import (DisaggregatedEngine, Engine,
                                       EngineConfig, ReplicaSet,
                                       SamplingParams)
from repro_torch.launch.mesh import launch, replica_cli_mesh
from repro_torch.models.model import Model, resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--backend", choices=("static", "paged"),
                    default="paged")
    ap.add_argument("--n-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--spec-tokens", type=int, default=0,
                    help="speculative decoding: ngram-drafted tokens per "
                         "step (outputs identical to spec-tokens 0)")
    ap.add_argument("--kv-dtype", choices=("bf16", "int8", "fp8"),
                    default="bf16",
                    help="paged KV pool storage precision: int8/fp8 "
                         "store quantized blocks + per-(token, head) "
                         "scales with dequant fused into the kernels")
    ap.add_argument("--dp", type=int, default=1,
                    help="engine replicas on the device behind one shared "
                         "admission queue (ReplicaSet), each with its own "
                         "KV pool")
    ap.add_argument("--roles", default=None,
                    help="prefill/decode disaggregation over the dp "
                         "replicas: comma-separated roles (e.g. "
                         "'prefill,decode') or 'auto'; needs dp >= 2 and "
                         "the paged backend (KV blocks migrate between "
                         "pools, outputs unchanged)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor parallelism: one engine over T ranks, "
                         "each with 1/T of every block whose dimension "
                         "divides T (heads, channels, experts, MLP, "
                         "vocabulary) and its slice of the pool and state; "
                         "every family but the VLM, whisper included, "
                         "with EngineConfig(overlap=True) too; with --dp "
                         "R, R such engines behind one queue")
    args = ap.parse_args(argv)
    shape = replica_cli_mesh(args.dp, args.tp)
    if shape is None:
        _serve(None, args)
        return
    resolve_device(args.device)          # no GPU: raise before spawning
    launch(_serve, args.tp, args.device, dp=args.dp, args=(args,))


def _serve(mesh, args):
    """Build the model, the engine and the requests, and serve; under a
    mesh this is one rank, and rank 0 prints."""
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    device = args.device if mesh is None else mesh.device
    model = Model(cfg, device=device)
    params = model.init(seed=0)
    rng = np.random.default_rng(0)
    replicas = mesh is not None and mesh.shape["data"] > 1
    ecfg = EngineConfig(backend=args.backend, num_slots=args.slots,
                        max_len=128, spec_tokens=args.spec_tokens,
                        kv_dtype=args.kv_dtype,
                        mesh=None if replicas else mesh)
    roles = args.roles if args.roles in (None, "auto") \
        else tuple(args.roles.split(","))
    if replicas and roles is not None:
        engine = DisaggregatedEngine(model, params, ecfg, mesh=mesh,
                                     roles=roles)
    elif replicas:
        engine = ReplicaSet(model, params, ecfg, mesh=mesh)
    elif roles is not None:
        engine = DisaggregatedEngine(model, params, ecfg, dp=args.dp,
                                     roles=roles, device=args.device)
    elif args.dp > 1:
        engine = ReplicaSet(model, params, ecfg, dp=args.dp,
                            device=args.device)
    else:
        engine = Engine(model, params, ecfg, device=device)
        del params                   # under a mesh the engine keeps slices
    prompts = [list(rng.integers(0, cfg.vocab_size,
                                 int(rng.integers(4, 16))))
               for _ in range(args.requests)]
    sp = [SamplingParams(max_tokens=int(rng.integers(4, args.n_new + 1)),
                         temperature=args.temperature, seed=i)
          for i in range(args.requests)]
    feats = None
    if cfg.enc_dec:                  # the frontend is a stub: random frames
        feats = [rng.standard_normal((int(rng.integers(1, cfg.encoder_len
                                                       + 1)), cfg.d_model))
                 .astype(np.float32) for _ in prompts]
    t0 = time.time()
    outs = engine.generate(prompts, sp, encoder_features=feats)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    total = sum(len(o) for o in outs)
    stats = engine.stats()           # a collective under a (data, model) mesh
    if mesh is not None and mesh.rank != 0:
        return
    print(f"[{args.backend} {model.device} tp={args.tp} dp={args.dp} "
          f"roles={args.roles} "
          f"spec={args.spec_tokens} kv={args.kv_dtype}] {total} tokens "
          f"over {len(outs)} reqs in {dt:.2f}s ({total / dt:.1f} tok/s)  "
          f"stats={stats}")
    for i, o in enumerate(outs[:2]):
        print(f"req{i}: {o[:12]}...")


if __name__ == "__main__":
    main()
