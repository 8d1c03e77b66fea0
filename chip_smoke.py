#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU and
check it end to end.

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --profile  # adds torch.profiler breakdowns of
                                     # serve (overlap off and on),
                                     # spec_serve, recurrent_serve,
                                     # xlstm_serve, moe_serve,
                                     # encdec_serve, vlm_dense
                                     # and tile_path (each window lists
                                     # the port's own kernels and their
                                     # share of device time)
    python3 chip_smoke.py --tp-cards # 4 cards: the build and the
                                     # tensor-parallel phases alone, over
                                     # NCCL (parity_tp at 2 ranks;
                                     # tp_serve for olmo_1b at 2 and 4
                                     # ranks and yi_6b at 4, each against
                                     # its own single-device run; the
                                     # packet ladder between two cards
                                     # and tp_disagg_serve priced by it)

Every paged engine decodes through the captured step
(``launch/engine/step_graph.py``): feed select, the decode and sampling
as one CUDA graph replay a step. The serve phases print
``graph_replays`` (must equal their decode ``steps``) and
``eager_decode_steps`` (must be 0), and hold the launch counters, which
count replays, to one K2 (or K4) and one combine launch per layer per
decode step.

K1 (flash attention) and K6 (the STX matmul) have two bodies each,
chosen by their wrappers from the inputs before the launch and counted
in ``launches_by_body``: "wgmma" (Hopper's tensor cores, wgmma on
TMA-fed bf16 tiles) for bf16 inputs a tensor map can describe, "simt"
(the CUDA cores in f32) for f32 and everything else. Every K1 and K6
row of the kernels phase names the body its checked call ran; the bf16
cases with aligned shapes must run "wgmma", the f32 cases and the one
misaligned bf16 K6 case "simt".

K2 (paged decode, and K4 inside it) splits each sequence's keys over
CTAs (``paged_attention.split_plan``, shapes only) and merges the splits
in a combine kernel launched by the same call: its kernels-phase rows
carry ``splits``, and beside ``ms`` (the eager call, as every row) the
CUDA-event time of a graph replay of the call, ``graph_ms`` (both
kernels back to back, the host's enqueue out of the timing); with
``--profile`` also ``kernel_ms``, the profiler's durations of the two
kernels. The combine kernel has its own row (``K2_combine``) and its
launches must be counted on the serve and quant_serve paths.

K3 (paged verify, and K4 inside it) has three bodies, chosen by
``paged_attention.verify_body`` from shapes and dtypes and counted in
``paged_verify_attention.launches_by_body``: "split" for fewer than 32
(row, group) pairs a kv head (the verify step, on K2's split plan and
combine pass), "wgmma" for a bf16 suffix prefill over a bf16, int8 or
fp8 pool (tensor cores on paged TMA tiles), "simt" for the rest. Every
K3 / K4-verify row of the kernels phase names its ``body`` and carries
``splits``, ``graph_ms`` and (``--profile``) ``kernel_ms``: the bf16
verify rows must run "split" with more than one split, the bf16 and fp8
suffix rows "wgmma", the f32 verify "split" and the f32 suffix "simt".
The bf16 and fp8 suffix rows run at spec_serve's buckets (K1 32, 64 and
128 over its 256-token prefix; the summary line takes the 64-row bucket)
and at a 256-row suffix off its path; ``verify_k1`` / ``_k2`` / ``_k8``
hold the split body at 1, 2 and 8 rows on the verify step's bytes.
spec_serve and quant_serve's fp8 speculative run report
``launches_by_body``: every verify launch (spec steps x layers) must be
"split" and every suffix-prefill launch "wgmma". ``--profile`` also
profiles a spec_serve window (one admission of partial prefix hits and
8 verify steps), so that ``port_kernels`` shows K3's device share.

Phases, one JSON line each (any failed check exits non-zero):

1. build    — nvcc builds every kernel under src/repro_torch/csrc/;
              the SASS of K5's, K7's and K8's kernels must hold no FFMA
              (``ffma``, by kernel: their bits depend on every operation
              rounding on its own).
2. kernels  — K1 (prefill flash attention), K2 (paged decode attention),
              K3 (paged verify attention: the verify window and the
              suffix prefill) and K4 (K2 and K3 over an int8 / fp8 pool
              with per-(token, head) scales, fused dequant; a GQA case
              and a D-64-in-128 padded case) against their plain-torch
              versions at the main path's shapes (bf16, D 128, 16 heads),
              plus a GQA (group 4) and an f32 case, and K2 / K4 decode
              at olmo_1b's 2048-token context (8 sequences, one alone,
              fp8; off every phase's path): max abs error within
              3e-2 (bf16) / 1e-4 (f32), CUDA-event times for kernel,
              plain version and (K1) ``F.scaled_dot_product_attention``,
              and the H100 bound.
3. parity   — olmo_1b smoke in f32, same weights, served on cuda and on
              cpu: greedy tokens identical (a tight pool forces LIFO
              preemption on both) and prefill / first-decode logits
              within 1e-3; then speculative decoding (ngram and
              draft-model drafters) with the prefix cache on prompts that
              share a block-aligned prefix (partial hits, a full hit and
              a COW copy): tokens identical on cuda and cpu and equal to
              the non-speculative, cache-off engine; seeded tokens
              (threefry) identical on cuda and cpu, plain and speculative.
4. parity_quant — the same smoke model over int8 and fp8 pools, cuda
              against cpu: greedy, seeded and speculative runs with the
              prefix cache give equal tokens and equal prefix-cache
              counters, leak nothing, and launch K4 in decode and verify.
5. serve    — olmo_1b at full width in bf16 (random weights from a
              seeded torch.Generator) serves 16 requests of 32-512 prompt
              tokens and 32-64 new tokens through ``Engine`` (prefix
              cache on, the default); the K1 and K2 launch counters are
              reset before and must be > 0 after, K1's tensor-core
              launches among them, K2 and its combine 16 x decode steps,
              and the pool must end with zero blocks in use. Then the
              same requests on an ``overlap=True`` engine (dispatch the
              next step before fetching this one's tokens): the same
              checks, and tokens equal to the first turn's. Each turn
              prints ``tok_s`` and ``decode_device_s``.
   static_serve — the same model and requests on ``backend="static"``
              (lockstep batches of 8 over a dense (8, 640) cache): tok/s,
              steps, batches (2), cache utilization, K1 launches (one a
              layer a batch); every request emits max_tokens in range.
6. spec_serve — the same model with ``spec_tokens=4`` (ngram drafter)
              and the prefix cache serves 16 requests that share a
              256-token prefix; the K3 launch counter is reset before and
              must be > 0 after, every request hits the cache, the pool
              ends empty. It also reports the share of requests whose
              tokens equal a non-speculative, cache-off engine's (bf16
              argmax may flip on near-ties, so that share is no check).
7. quant_serve — the serve phase's model, requests and geometry over an
              fp8 pool (overlap off, then on: equal tokens) and an int8
              pool that gets the bf16 pool's usable
              bytes (so 1.94x its blocks): capacity ratio, tok/s, TTFT /
              TPOT p50, K4 launches (16 x decode steps, as the combine's;
              K2 none), zero leaked
              blocks, and the greedy token match rate against the serve
              phase's bf16 outputs (reported, not gated); then fp8 with
              speculation on spec_serve's traffic, where every verify
              runs through K4.
   parity_replica — the replica layer on smoke configs in f32, cuda
              against cpu: ``ReplicaSet(dp=2)`` paged, static and with a
              speculative replica; ``DisaggregatedEngine`` on olmo_1b
              with a forced steal (overlap off and on), a full-prefix-hit
              rewind, int8 and fp8 pools, speculative decode replicas,
              and on recurrentgemma_2b and whisper_base. Tokens equal on
              both devices and equal a single Engine's, no replica leaks,
              K1 / K2 / K3 / K4 / K5 launched where the case runs them;
              an int8 and an fp8 packet land bit for bit.
   replica_serve — serve's model, requests and geometry (8 slots a
              replica) on ``ReplicaSet(dp=2)`` and on prefill / decode /
              decode: tokens equal serve's; tok/s, TTFT / TPOT p50; per
              replica busy / device seconds, dispatches, K1 / K2 /
              combine launches, and on every decode replica graph
              replays = steps with no eager step and K2 = combine = 16 x
              steps; exported / imported / stolen, bytes moved, the
              migrations' in-loop ms a packet (CUDA events around
              ``extract_slot`` and ``insert_packet``) and one packet's
              device ms alone (eager and replayed, beside its bound) and
              payload GB/s. The summary line's ``K1_replica``,
              ``K2_replica`` and ``K2_combine_replica`` rows take their
              launches from this phase.
   parity_tp — tensor parallelism over 2 ranks spawned on the one card
              (gloo, so each rank's decode step runs eagerly): olmo_1b,
              yi_6b and gemma_7b smoke in f32, greedy on a pool that
              preempts, seeded, speculative (ngram, K 3), int8 (which
              preempts) and fp8 pools, prefix hits with a COW copy; both
              ranks' tokens and counters equal the single-device cpu
              engine's, no leak, each rank's pool half the cpu one, 2 L
              + 2 collectives a step, K1 / K2 / K3 / K4 launched on every
              rank.
   tp_serve — olmo_1b at full width in bf16 over 2 ranks on the card,
              serve's geometry: serve's 16 requests (greedy; tokens
              against serve's: the share of equal requests and the first
              differing token, reported), 8 of spec_serve's requests with
              spec_tokens 4 (every verify launch on the body
              ``verify_body`` picks, every suffix prefill "wgmma") and
              serve's first 8 over an fp8 pool (K4); per turn tok/s and
              each rank's launches by body, none "simt"; each rank's pool
              exactly half of serve's, no leaked block, 34 collectives a
              step; the first prefill and decode logits within 3e-2 of
              the single-device model's (relative to the largest logit);
              the collectives' share of an eager step's CUDA-event time.
              The summary line's ``*_tp`` rows (K1, K2, its combine, K3's
              verify and suffix bodies, K4) are timed at a rank's shapes
              (8 of olmo_1b's 16 heads, (8, 8/8, ., 128)) and take their
              launches, summed over the ranks, from this phase.
   tp_disagg_serve — olmo_1b at full width in bf16 as
              ``DisaggregatedEngine`` on a (data=2, model=2) mesh of 4
              ranks on the card, roles prefill / decode, serve's 16
              requests: tokens equal serve's; packets, logical and
              per-rank bytes, each packet's gather / send / receive /
              scatter ms (CUDA events and the host clock), the router's
              exchanges and their ms, tok/s, TTFT / TPOT p50, the
              prefill replica's steps (0), no leak on any rank. The
              summary line has the ``*_tp`` K1 / K2 / combine rows again
              with this phase's launches (and parity_tp_disagg's as
              ``parity_launches``).
   parity_tp_disagg — ``DisaggregatedEngine`` on a (data=3, model=2)
              mesh of 6 ranks on the card, prefill / decode / decode,
              smoke configs in f32: olmo_1b stealing on a tight pool,
              olmo_1b over an int8 pool with a speculative decode role,
              recurrentgemma_2b and olmo_1b (stealing mid-decode) with
              overlap on the decode role, whisper_base: tokens and
              counters equal the cpu ``DisaggregatedEngine(dp=3)``'s,
              every rank's stats equal, no leak.
8. parity_recurrent — recurrentgemma_2b (RG-LRU + local attention) and
              h2o_danube_3_4b (sliding-window attention) smoke in f32, cuda
              against cpu on a pool tight enough to preempt, with rings
              (window 16) that wrap: greedy, seeded, speculative (ngram,
              K 3) and (recurrentgemma) int8 tokens equal, no leak, K5 and
              K1 launched on cuda.
   parity_overlap_static — olmo_1b and recurrentgemma_2b smoke in f32,
              cuda against cpu: ``overlap=True`` with seeded and greedy
              rows on a pool that preempts (the sampled graph), and
              ``backend="static"`` over two batches; tokens equal, and
              the overlap tokens equal a cpu run with overlap off.
9. recurrent_serve — recurrentgemma_2b at full width in bf16 (26
              layers, seeded random weights, depth not cut; 8 slots,
              max_len 2560 so the 2048-row rings wrap) serves two
              2,200-token prompts (one (2, 2560) prefill: K1's window
              bites, the rings wrap in prefill) and then the serve
              phase's 16 requests; the K5 and K1 counters are reset before
              and must be > 0 after (K1's tensor-core launches among
              them), the pool must end empty. K5's launches are tallied
              by shape and body (``k5_launches_by_shape``,
              ``k5_launches_by_body``): the long admission must launch
              one K5 a RG-LRU layer (18), all on the ring body. Then
              the same requests with ``overlap=True``: equal tokens, the
              same K1 and K5 launches.
   parity_xlstm_moe — xlstm_1_3b, qwen3_moe_30b_a3b and kimi_k2_1t_a32b
              smoke in f32, cuda against cpu, on prompts behind a shared
              two-block prefix (prefix hits for the MoE configs), 3 slots
              and 13 usable blocks: greedy (the pool preempts), seeded,
              speculative (ngram, K 3), fp8, ``overlap=True`` and
              ``backend="static"``; tokens equal, no leak, every cuda
              paged decode step a graph replay. Prints its seconds.
10. xlstm_serve — xlstm_1_3b at full width in bf16, depth cut to
              XLSTM_LAYERS of 48 (14 mLSTM, 2 sLSTM); d_model 2048, 4 heads x 512; seeded
              random weights; 8 slots, max_len 640) serves the serve
              phase's 16 requests with overlap off, then on (equal
              tokens), then on ``backend="static"``: tok/s, TTFT / TPOT
              p50, decode device ms a step, the seconds of the (8, 512)
              first admission alone, the decode state bytes a slot;
              ``graph_replays`` = steps and ``eager_decode_steps`` = 0.
              No port kernel is on this path (mLSTM and sLSTM are plain
              torch, as JAX's are plain jnp).
11. moe_serve — qwen3_moe_30b_a3b at full width in bf16 (d_model 2048,
              32 / 4 heads x 128 with qk_norm, 128 experts top-8 of width
              768, vocab 151936), depth cut to MOE_LAYERS = 12 of 48 (the
              cut is printed: 48 layers are ~61 GB of random init), the
              same requests with overlap off, then on (equal tokens): K1
              (its tensor-core body) at every prefill, K2 and its combine
              12 x decode steps by replay.
   parity_encdec_vlm — whisper_base and qwen2_vl_2b smoke in f32, cuda
              against cpu: whisper through the Engine (greedy on a pool
              that preempts, seeded, ``overlap=True``; two requests on one
              feature array): tokens equal, every cuda step a replay, no
              block or arena row left; the greedy cuda engine equals the
              dense prefill + decode_step oracle on cuda, beside the two
              admissions' largest logits gap; qwen2-vl's dense prefill
              (visual embeddings, M-RoPE, nonzero q/k/v biases) and 8
              greedy steps: tokens equal. Prints its seconds.
   encdec_serve — whisper_base at full width and depth in bf16 (6 + 6
              layers, d_model 512, 8 heads x 64; 8 slots, block 16,
              max_len 448, 225 blocks) serves a transcription service's
              16 requests (12 full 30 s windows of 1500 frames, 4 last
              windows of 300-1499; 10 start-of-transcript prompts, 6 with
              64-192 tokens of previous text; two pairs best-of-2 on one
              array each) with overlap off, then on (equal tokens):
              tok/s, TTFT / TPOT p50, decode device ms a step, the (8,
              1500-frame) admission's seconds, the arena's bytes and
              ``cross_arena`` (shared_hits >= 2, rows_used 0), K1 = 6 x
              prefill calls, K2 = combine = 6 x steps by replay; then
              the dense path (the exact-length encoder through K1,
              non-causal: 6 launches; its greedy tokens beside the
              engine's, reported).
   vlm_dense — qwen2-vl-2b at full width and depth in bf16: an (8, 512)
              dense prefill whose first 64 positions take visual
              embeddings on an 8 x 8 patch grid's M-RoPE ids, then 32
              greedy decode steps; twice, equal tokens; K1 = 28 launches
              on its tensor-core body; prefill ms, decode ms a step and
              tok/s.

12. tile_path — the EPAC tile layer (``repro_torch.core``) through its
              entry points, every tile kernel's counter reset first:
              (a) 200 steps of 2-D heat diffusion on an (8192, 8192) f32
              plate through ``DEFAULT_CLUSTER.stencil2d`` (K7a must count
              200; the peak decays inside (0, 1), the total and the
              energy, summed through K8b and K8a, do not rise and equal
              the plain lanes' finalized sums bit for bit; every K8
              call runs the "ring" body and the finalize kernel), one
              7-point ``stencil3d`` step on 512^3 (K7b, ring body), and the
              example's own sizes (96^2 for 8 steps, one 64^3 step) equal
              on cuda and cpu; (b) ``dispatch_matmul`` of (8, 512, 2048)
              @ (2048, 8192) bf16 under STX_POLICY (one K6 launch, on
              the tensor-core body) and
              DEFAULT_POLICY (``torch.matmul``, none) within the bf16
              tolerance, and a vrp ``dispatch_reduction`` equal on cuda
              and cpu; (c) the adaptive CG ladder f64 -> vp128 -> vp256
              -> vp512 on hilbert(12) and hilbert_like(64, cond 1e8) (cut
              to LADDER_ITERS a rung), and the extended-precision
              right-hand side, each on cuda and cpu with the same matrix
              (equal iterations, x within 1e-12), then vp128 CG on
              hilbert_like(1024, cond 1e8) for CG_TIMED_ITERS iterations
              (ms per iteration). Each part's line carries its
              ``seconds`` and ``t_s``.
13. parity_train — the training path at smoke sizes in f32: olmo_1b,
              h2o_danube_3_4b, recurrentgemma_2b, xlstm_1_3b,
              qwen3_moe_30b_a3b, kimi_k2_1t_a32b and whisper_base
              ``loss_fn`` loss and every grad leaf, cuda against cpu on
              the same params and batch (loss 1e-5 relative, grads 1e-4
              x max(1, max|g|)), K1, its backward (every config but
              xlstm, which has no attention) and (recurrentgemma) K5
              launched on cuda, the MoE's dropped assignments equal on
              both and more than 0; three ``make_train_step`` steps of
              olmo_1b smoke for AdamW, ``grad_accum=2`` and
              ``norm_tile="vrp"`` (K8b), and of qwen3_moe and whisper
              smoke for ``grad_accum=2``, cuda against cpu by loss (1e-4
              relative). Then, at the
              training shapes, K1's forward with its row lse against
              ``ref.flash_attention(..., return_lse=True)`` (output
              within TOL, lse within 1e-4 f32 / 3e-3 bf16; bf16 on the
              wgmma body) and K1's backward kernel
              (``csrc/flash_attention_bwd.cu``) against
              ``ref.flash_attention_bwd``, element by element within
              TOL + BWD_RTOL |plain| (BWD_RTOL 2^-7 in bf16, one ulp; 0
              in f32), each a kernels row (``K1_bwd``: ms, plain ms, the
              bound, SDPA's backward as the library time; the forward's
              ``fwd_ms``, ``fwd_plain_ms``, ``fwd_bound_ms`` and SDPA's
              forward beside them): olmo_1b (4, 16/16, 2048, 128)
              causal, recurrentgemma's local (2, 10/1, 2048, 256)
              window 2048 and h2o_danube (2, 32/8, 2048, 120) window
              4096, each in bf16 and in f32; and in bf16 at
              train_families' shapes: qwen3_moe (4, 32/4, 2048, 128)
              causal, whisper's encoder (8, 8/8, 1500, 64) and
              cross-attention (448 rows over 1500 keys) non-causal and
              decoder (8, 8/8, 448, 64) causal.
14. train   — ``launch.train.train_loop`` on olmo_1b at full width and
              depth in bf16: AdamW on ``SyntheticLM`` at batch 4 x 2048,
              20 steps, a checkpoint every 10; the loss must fall, K1
              and its backward launch 16 a step; then a second
              ``train_loop`` restores step 10 and runs to 20 (losses
              within 1e-2 relative, the largest difference and bit
              equality printed); the step's ms (median of steps 2..19),
              tokens/s, one step split into forward / backward /
              optimizer, K1's backward's share of a profiled step's
              device time, peak memory and the card. The summary line's
              ``K1_bwd`` row takes its launches from this phase.
15. train_families — ``make_train_step`` at full width in bf16 (AdamW,
              f32 moments) on xlstm_1_3b (16 of 48 layers, 4 x 1024, remat
              "full"), whisper_base (6 + 6, 8 x 448 decoder tokens over
              (8, 1500, 512) frames) and qwen3_moe_30b_a3b (depth cut to
              3 of 48, 4 x 2048, ce_chunk 512), each on one seeded batch:
              a falling loss, step ms, tokens/s, the forward / backward /
              optimizer split, peak memory, K1 / K1_bwd launches by body
              (all wgmma; none on xlstm). The summary line's
              ``K1_bwd_moe`` and ``K1_bwd_whisper`` rows take their
              launches from this phase.

The kernels phase also holds K5 (the RG-LRU scan) at recurrent_serve's
(8, 512, 2560) and (2, 2560, 2560) f32 shapes, bit-equal to its plain
version. K5 and K7b have two bodies each, chosen by their wrappers from
dtype, shape and alignment and counted in ``launches_by_body``: "ring"
(TMA tiles in a ring of shared-memory stages fed by a producer thread)
where a tensor map takes the input, "simt" (the first port's kernel)
for the rest. Their rows name the body (both K5 shapes and K7b at 512^3
must run "ring") and carry ``graph_ms`` and ``simt_ms`` (the simt body
forced on the same input, bit-equal too), and the summary line has a
``K5_long`` row for the long admission beside ``K5``. K1 at head
dims 256
(recurrentgemma MQA 10/1 window 2048 at Sq 512 and 2560; gemma_7b
16/16 causal), 120 (h2o_danube GQA 32/8 window 4096) and 64 (a ragged
(2, 8/2, 300) case) and at qwen3_moe's GQA 32/4 (D 128, (8, 512)
causal: moe_serve's prefill; summary row ``K1_moe``) beside K2 at that
head layout over serve's first decode lengths (``K2_moe``); K1 at
whisper's decoder prefill (8, 8/8, 256, 64), its encoder over full
windows (8, 8/8, 1500, 64) non-causal (``K1_whisper_enc``, SDPA without
a mask beside it) and qwen2-vl's prefill (8, 12/2, 512, 128)
(``K1_qwen2vl``), K2 at whisper's (8, 8/8, 64) over encdec_serve's first
decode lengths (``K2_whisper``); and the
tile kernels at tile_path's shapes: K6
(4096, 2048) @ (2048, 8192) bf16 to bf16 and to f32 (tensor cores),
1024^3 and ragged (1000, 700, 300) f32, and (1000, 700, 300) bf16 (rows
of 1400 bytes, which no tensor map takes: the SIMT body) (relative
tolerance 3e-2 / 3e-1 for bf16 operands, 1e-5 / 1e-4 for f32 ones,
against ``torch.matmul``); K7a on 8192^2 (five-point, ones) and 4097 x
4099, K7b on 512^3 (seven-point, 27 random weights), bit-equal to the
plain version, against cuDNN ``conv2d`` / ``conv3d``; K8a / K8b at n =
8192^2 (the plate's size) and 2^24 + 3 through ``ops.vrp_dot`` /
``ops.vrp_sum``: lanes bit-equal, hi + lo within max(naive error / 100,
1e-8) of the exact sum. K8's lane kernel has two bodies, chosen by
``vrp_dot.body`` from n and alignment and counted in
``launches_by_body``: "ring" (a TMA ring, the walk split over warps)
for n >= 1024 on 16-byte aligned bases, "simt" for the rest; the rows
at 8192^2 and 2^24 + 3 must run "ring", a K8a case one float off its
buffer's base "simt". ``ops.vrp_*`` on the card is one call that
launches the lane kernel and the finalize kernel (the 1024 lanes'
compensated tree): each K8 row checks that the finalized (2,) equals
the plain lanes finalized by the torch tree and that the finalize
kernel alone equals the tree, and carries ``body``, ``call_ms`` /
``graph_ms`` (the whole call eager / replayed), ``finalize_ms`` beside
the torch tree's ``tree_finalize_ms``, ``call_host_ms`` (host wall time
a call, synced) and ``enqueue_ms`` (not synced), ``--profile``
``kernel_ms``. The summary line has a ``vrp_finalize`` row.

Then a ``{"kernels": [...]}`` summary line, the card's name and power
limit from nvidia-smi, and as the last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16
              "float32": 67e12}    # f32 outside the tensor cores
TOL = {"bfloat16": 3e-2, "float32": 1e-4}
LSE_TOL = {"bfloat16": 3e-3,       # K1's row lse: f32 of a few units; bf16
           "float32": 1e-4}        # inputs only reorder the products
BWD_RTOL = {"bfloat16": 2.0 ** -7,  # K1_bwd, per element |g - w| <= TOL +
            "float32": 0.0}         # BWD_RTOL |w|: one bf16 ulp of w (both
#                                     sides round an f32 sum to bf16)
K5_TOL = 1e-5                      # JAX's rglru_scan tolerance (f32)
LONG, LONG_NEW = 2200, 64          # recurrent_serve: prompts past the window
K6_TOL = {"bfloat16": (3e-2, 3e-1),  # (rtol, atol) by operand dtype, as
          "float32": (1e-5, 1e-4)}   # tests/test_kernels.py holds K6
K8_N = 2**24 + 3                   # K8 cases: a ragged tail of 3
DIFF_N, DIFF_STEPS, ALPHA = 8192, 200, 0.20   # tile_path diffusion
LADDER = ("f64", "vp128", "vp256", "vp512")   # adaptive CG precisions
LADDER_ITERS = 50                  # problem 1's cut (the example's 400):
#                                    no rung converges by 100 either, and
#                                    every rung is compared cuda vs cpu
CG_TIMED_ITERS = 20                # tile_path's vp128 n = 1024 timing: only
#                                    ms_per_iter reads it
PARITY_TOL = 1e-3                  # f32 logits, cuda vs cpu summation order
N_REQ, HALF = 16, 8                # serve: first HALF prompts in bucket 512
SHARED, PHRASE = 256, 8            # spec_serve: shared prefix, repeated phrase
SUFFIX_BUCKETS = (32, 64, 128)     # spec_serve: its suffixes' K3 widths
ENC_FRAMES = 1500                  # encdec_serve: a full 30 s window
SOT = [50258, 50259, 50359, 50363]  # whisper's start-of-transcript tokens
VLM_GRID, VLM_STEPS = 8, 32        # vlm_dense: 8 x 8 patches, decode steps
VLM_PROBE = 8                      # vlm_dense: decode steps under the profiler


T_START = time.monotonic()


def emit(obj):
    """Print ``obj`` as a JSON line; a phase's line gains ``t_s``, the
    seconds since the script started (where the run's time goes)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.monotonic() - T_START}
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def cuda_ms(torch, fn, reps=20):
    """Mean CUDA-event time of ``fn`` over ``reps`` launches, each after a
    256 MiB write that evicts the 50 MB L2 (the main path finds its
    inputs cold: every layer reads other weights and another pool).
    A 0.1 s warm-up first brings the card out of its idle clocks (a
    single warm-up call read K1 up to 1.4x slower)."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    t_warm = time.monotonic() + 0.1
    while time.monotonic() < t_warm:
        fn()
        torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def graph_ms(torch, fn, reps=20):
    """``cuda_ms`` of one replay of ``fn`` captured in a CUDA graph: the
    device time of the launches ``fn`` makes, back to back, with the
    host's enqueue out of the timing (a replay costs the host a few us,
    hidden behind the L2 flush; an eager call of a Python wrapper can
    cost more than its kernels)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(torch, graph.replay, reps)


def kernel_ms(torch, fn, names, reps=10):
    """Mean device time one call of ``fn`` spends in the kernels whose
    names match ``names`` (torch.profiler's kernel durations), each call
    after ``cuda_ms``'s L2 flush: set beside a CUDA-event time it shows
    whether the event time is the kernels' own or the host's enqueue."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and names.search(e.key))
    return us / 1e3 / reps


def bound(flops, nbytes, dtype):
    """Least time (ms) for the work on an H100 SXM at full power, and
    which of the two limits sets it."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops > t_mem
                                     else "bytes")


def zero_bodies(counter):
    """Set a kernel's per-body launch counts to 0."""
    counter.launches_by_body = dict.fromkeys(counter.launches_by_body, 0)


def ran_body(counter, before):
    """The one body of a kernel with several (K1, K3, K6) that a single
    call launched, from its per-body counts before and after the call."""
    moved = {b: n - before[b] for b, n in counter.launches_by_body.items()
             if n != before[b]}
    check(len(moved) == 1 and set(moved.values()) == {1},
          f"{counter.__name__}: one call launched bodies {moved}")
    return next(iter(moved))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def workload(np):
    """The serve phase's requests: the first HALF prompts fall in the 512
    bucket (so the first admission is one (8, 16, 512, 128) prefill), the
    rest in 32..256; 32-64 new tokens each. Plus a 40-token warm-up
    prompt that shares no block with them."""
    rng = np.random.default_rng(SEED)
    lens = list(rng.integers(257, 513, HALF)) \
        + list(rng.integers(32, 257, N_REQ - HALF))
    news = list(rng.integers(32, 65, N_REQ))
    prompts = [list(map(int, rng.integers(0, 50304, n))) for n in lens]
    warm = list(map(int, rng.integers(0, 50304, 40)))
    return prompts, [int(n) for n in news], warm


def spec_workload(np):
    """spec_serve's requests: a SHARED-token prefix drawn from the seed,
    then a distinct 16..128-token suffix whose last 32 tokens repeat an
    8-token phrase (material for the ngram drafter); 32-64 new tokens.
    The warm-up request is the prefix plus a short suffix of its own."""
    rng = np.random.default_rng(SEED + 1)
    prefix = list(map(int, rng.integers(0, 50304, SHARED)))
    prompts, news = [], []
    for _ in range(N_REQ):
        n = int(rng.integers(16, 129))
        phrase = list(map(int, rng.integers(0, 50304, PHRASE)))
        head = list(map(int, rng.integers(0, 50304, max(n - 32, 0))))
        prompts.append(prefix + head + (phrase * 4)[-min(n, 32):])
        news.append(int(rng.integers(32, 65)))
    warm = prefix + list(map(int, rng.integers(0, 50304, 8)))
    return prompts, news, warm


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.monotonic()
    lib = _build.build()
    secs = time.monotonic() - t0
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "Used" in line or "spill" in line:
            print(line.strip(), file=sys.stderr)
    ffma = ffma_counts(lib)
    emit({"phase": "build", "seconds": round(secs, 3), "library": lib.name,
          "sources": [s.name for s in _build.sources()], "ffma": ffma})
    check(ffma and not any(ffma.values())
          and all(any(re.search(k, n) for n in ffma)
                  for k in ("scan_tma", "stencil3d_tma", "ring_kernel")),
          f"build: K5's, K7's and K8's kernels hold fused multiply-adds, "
          f"or one is missing {ffma}")


def ffma_counts(lib):
    """FFMA instructions in the SASS (cuobjdump) of the kernels whose
    order is their contract (K5, K7, K8: BIT_EXACT_KERNELS), by kernel:
    every operation there must round on its own, so each count must
    be 0."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = (m.group(1) if BIT_EXACT_KERNELS.search(m.group(1))
                    else None)
            if name:
                counts[name] = 0
        elif name and "FFMA" in line:
            counts[name] += 1
    return counts


def k1_case(torch, name, B, hq, hkv, S, D, dtype, library, window=None,
            causal=True, Skv=None, seq_major=False):
    """K1 at (B, hq/hkv, S, D), causal (or not: whisper's encoder),
    optional window; non-causal queries may read ``Skv`` keys (whisper's
    cross-attention). ``seq_major`` makes q, k and v as the models pass
    them: (B, S, H, D) projections seen through ``.transpose(1, 2)``.
    The library time is one ``scaled_dot_product_attention`` call on
    the same tensors (``enable_gqa`` for hkv < hq), causal or not, or
    with a boolean mask where the window bites."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa, ref

    Skv = Skv or S
    assert Skv == S or not causal
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = ((torch.randn((B, n, h, D), generator=gen, device="cuda")
                .transpose(1, 2) if seq_major else
                torch.randn((B, h, n, D), generator=gen, device="cuda"))
               .to(dt) for h, n in ((hq, S), (hkv, Skv), (hkv, Skv)))
    before = dict(fa.flash_attention.launches_by_body)
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    body = ran_body(fa.flash_attention, before)
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    w = min(window or S, S)
    # visible (q, k) pairs: query i sees min(i + 1, window) keys (all Skv
    # without the causal mask)
    pairs = B * hq * (w * (w + 1) // 2 + (S - w) * w if causal else S * Skv)
    nbytes = q.element_size() * (2 * B * hq * S * D + 2 * B * hkv * Skv * D)
    bound_ms, bound_by = bound(4 * D * pairs, nbytes, dtype)
    bites = window is not None and window < S
    lib = None
    if library:
        pos = torch.arange(S, device="cuda")
        mask = (pos[None, :] <= pos[:, None]) \
            & (pos[None, :] > pos[:, None] - (window or S))
        kw = {"enable_gqa": hkv < hq}
        kw.update({"attn_mask": mask} if bites else {"is_causal": causal})
        lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, **kw))
    row = {"phase": "kernels", "kernel": "K1", "case": name,
           "shape": [B, hq, hkv, S, D], "keys": Skv, "seq_major": seq_major,
           "dtype": dtype, "window": window,
           "causal": causal, "body": body, "max_abs_err": err,
           "tol": TOL[dtype],
           "ms": cuda_ms(torch, lambda: fa.flash_attention(
               q, k, v, causal=causal, window=window)),
           "plain_ms": cuda_ms(torch, lambda: ref.flash_attention(
               q, k, v, causal=causal, window=window)),
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib,
           "library": None if lib is None else (
               "sdpa, boolean causal+window mask" if bites
               else "sdpa, is_causal" if causal else "sdpa, no mask")}
    emit(row)
    check(math.isfinite(err) and err <= TOL[dtype],
          f"K1 {name}: max abs err {err} > {TOL[dtype]}")
    # every bf16 case here is aligned: the tensor cores; f32 the CUDA cores
    want_body = "wgmma" if dtype == "bfloat16" else "simt"
    check(body == want_body, f"K1 {name}: ran the {body} body, "
          f"expected {want_body}")
    return row


def k5_case(torch, name, B, T, D):
    """K5 at (B, T, D) in f32, the RG-LRU's serving dtype (its
    coefficients are f32 in a bf16 model): decays in (0.8, 1) like the
    RG-LRU's, inputs standard normal. The body the wrapper chose
    (``rglru_scan.body``: "ring" at both of recurrent_serve's shapes)
    must equal the plain version bit for bit, and so must the simt body
    forced on the same inputs: ``simt_ms`` (the kernel before the ring)
    times it beside ``ms`` (the eager call) and ``graph_ms`` (its
    replay). No PyTorch
    call computes a diagonal linear recurrence, so there is no library
    time."""
    from repro_torch.kernels import rglru_scan as k5, ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    a = 0.8 + 0.2 * torch.rand((B, T, D), generator=gen, device="cuda")
    x = torch.randn((B, T, D), generator=gen, device="cuda")
    before = dict(k5.rglru_scan.launches_by_body)
    got = k5.rglru_scan(a, x)
    body = ran_body(k5.rglru_scan, before)
    want = ref.linear_scan(a, x)
    simt = lambda: k5.launch(a, x, which="simt")[0]  # noqa: E731
    simt_equal = bool(torch.equal(simt(), want))
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    equal = bool(torch.equal(got, want))
    bound_ms, bound_by = bound(2 * B * T * D, 3 * 4 * B * T * D, "float32")
    call = lambda: k5.rglru_scan(a, x)               # noqa: E731
    row = {"phase": "kernels", "kernel": "K5", "case": name,
           "shape": [B, T, D], "dtype": "float32", "body": body,
           "max_abs_err": err, "bit_equal": equal,
           "simt_bit_equal": simt_equal, "tol": K5_TOL,
           "ms": cuda_ms(torch, call), "graph_ms": graph_ms(torch, call),
           "simt_ms": cuda_ms(torch, simt),
           "plain_ms": cuda_ms(torch, lambda: ref.linear_scan(a, x), reps=3),
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    emit(row)
    check(math.isfinite(err) and err <= K5_TOL and equal and simt_equal,
          f"K5 {name}: not bit-equal to the plain version (max abs err "
          f"{err}; simt body {simt_equal})")
    check(body == "ring", f"K5 {name}: ran the {body} body, expected ring")
    return row


def pool_case(torch, np, gen, B, hkv, D, dtype, kv_dtype, bs, nb, nbmax):
    """A random (nb, bs, hkv, D) K/V pool drawn from ``gen`` in ``dtype``,
    or quantized to ``kv_dtype`` (int8 / fp8: payload plus f32 scales,
    the K4 path), and a scrambled block table. Returns (kp, vp, scales
    kwargs, table, bytes of one token row of K and V together)."""
    from repro_torch.models import paged_kv

    kp, vp = (torch.randn((nb, bs, hkv, D), generator=gen, device="cuda")
              .to(getattr(torch, dtype)) for _ in range(2))
    kw = {}
    if kv_dtype is not None:
        spec = paged_kv.PoolSpec(kv_dtype=kv_dtype, block_size=bs,
                                 n_kv_heads=hkv, head_dim=D)
        (kp, kw["k_scale"]), (vp, kw["v_scale"]) = (
            paged_kv.quantize_kv(x.float(), spec) for x in (kp, vp))
    row_bytes = 2 * hkv * (D * kp.element_size() + 4 * bool(kw))
    ids = np.random.default_rng(SEED).permutation(nb - 1)[:B * nbmax] + 1
    bt = torch.from_numpy(ids.reshape(B, nbmax).astype(np.int32)).cuda()
    return kp, vp, kw, bt, row_bytes


def kv_view(kp, vp, kw, kv_heads):
    """The plain version's inputs for a ``kv_heads`` (first, count) range
    of a pool: head views of the payloads and the scales."""
    if kv_heads is None:
        return kp, vp, kw
    lo, n = kv_heads
    return (kp[:, :, lo:lo + n], vp[:, :, lo:lo + n],
            {k: t[:, :, lo:lo + n] for k, t in kw.items()})


def k2_case(torch, np, name, lengths, hq, hkv, D, dtype, kv_dtype=None,
            bs=16, nb=1024, nbmax=40, profile=False, kv_heads=None):
    """K2 (float pool) or K4 (``kv_dtype`` int8 / fp8) decode case, with
    the split plan it ran with (``splits``, ``blocks_per_split``), its
    graph-replay time (``graph_ms``) and, with ``profile``, the
    profiler's durations of its split and combine kernels
    (``kernel_ms``). ``kv_heads`` (first, count): the q heads read that
    range of an ``hkv``-head pool in place (the replicated-KV layout);
    the plain version reads a head view, the bound counts the range's
    bytes."""
    from repro_torch.kernels import paged_attention as pa, ref

    dt = getattr(torch, dtype)
    B = len(lengths)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn((B, hq, D), generator=gen, device="cuda").to(dt)
    kp, vp, kw, bt, row_bytes = pool_case(torch, np, gen, B, hkv, D, dtype,
                                          kv_dtype, bs, nb, nbmax)
    rng_kw = {} if kv_heads is None else {"kv_heads": kv_heads}
    pk, pv, pkw = kv_view(kp, vp, kw, kv_heads)
    if kv_heads is not None:
        row_bytes = row_bytes * kv_heads[1] // hkv
        hkv = kv_heads[1]
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    got = pa.paged_decode_attention(q, kp, vp, bt, ln, **kw, **rng_kw)
    want = ref.paged_decode_attention(q, pk, pv, bt, ln, **pkw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    toks = int(sum(lengths))
    blocks = int(sum(-(-n // bs) for n in lengths))
    nbytes = q.element_size() * 2 * B * hq * D + toks * row_bytes \
        + 4 * (blocks + B)                        # table entries, lengths
    bound_ms, bound_by = bound(4 * toks * hq * D, nbytes, dtype)
    bps, nsplit = pa.split_plan(B, hkv, nbmax, bs, pa.sm_count(q.device))

    def call():
        return pa.paged_decode_attention(q, kp, vp, bt, ln, **kw, **rng_kw)

    row = {"phase": "kernels", "kernel": "K4" if kw else "K2", "case": name,
           "shape": [B, hq, hkv, D, bs, nbmax], "lengths": list(lengths),
           "kv_heads": kv_heads,
           "dtype": dtype, "kv_dtype": kv_dtype, "splits": nsplit,
           "blocks_per_split": bps, "max_abs_err": err, "tol": TOL[dtype],
           "ms": cuda_ms(torch, call), "graph_ms": graph_ms(torch, call),
           "plain_ms": cuda_ms(torch, lambda: ref.paged_decode_attention(
               q, pk, pv, bt, ln, **pkw)),
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    if profile:
        row["kernel_ms"] = kernel_ms(torch, call, SPLIT_KERNELS)
    emit(row)
    check(math.isfinite(err) and err <= TOL[dtype],
          f"{row['kernel']} {name}: max abs err {err} > {TOL[dtype]}")
    return row


def combine_case(torch, name, B, hq, nsplit, D, dtype):
    """K2's combine kernel on random partial states of the main path's
    decode shape, about half its splits empty (m = kMaskValue, l = 0,
    acc = 0: serve's lengths reach half of its 40-block table)."""
    from repro_torch.kernels import paged_attention as pa, ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    m = torch.randn((B, hq, nsplit), generator=gen, device="cuda") * 3
    l = torch.rand((B, hq, nsplit), generator=gen, device="cuda") * 30 + 1
    acc = torch.randn((B, hq, nsplit, D), generator=gen, device="cuda") * 8
    empty = torch.rand((B, hq, nsplit), generator=gen, device="cuda") < 0.5
    m[empty], l[empty], acc[empty] = ref.MASK_VALUE, 0.0, 0.0
    dt = getattr(torch, dtype)
    got = pa.paged_decode_combine(m, l, acc, dt)
    want = ref.paged_decode_combine(m, l, acc, dt)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    rows = B * hq
    nbytes = 4 * rows * nsplit * (2 + D) + got.element_size() * rows * D
    bound_ms, bound_by = bound(2 * rows * nsplit * (D + 1), nbytes,
                               "float32")

    def call():
        return pa.paged_decode_combine(m, l, acc, dt)

    row = {"phase": "kernels", "kernel": "K2_combine", "case": name,
           "shape": [B, hq, nsplit, D], "dtype": dtype, "max_abs_err": err,
           "tol": TOL[dtype], "ms": cuda_ms(torch, call),
           "graph_ms": graph_ms(torch, call),
           "plain_ms": cuda_ms(torch, lambda: ref.paged_decode_combine(
               m, l, acc, dt)),
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    emit(row)
    check(math.isfinite(err) and err <= TOL[dtype],
          f"K2 combine {name}: max abs err {err} > {TOL[dtype]}")
    return row


def k3_case(torch, np, name, lengths, K1, hq, hkv, D, dtype, want_body,
            kv_dtype=None, bs=16, nb=1024, nbmax=40, profile=False,
            kv_heads=None):
    """K3 (float pool) or K4 (``kv_dtype`` int8 / fp8) verify or suffix
    case, with the body its checked call ran (``body``, which must be
    ``want_body``), its split plan (``splits``; 1 outside the split
    body), its graph-replay time (``graph_ms``) and, with ``profile``,
    the profiler's durations of its kernels (``kernel_ms``);
    ``kv_heads`` as in ``k2_case``."""
    from repro_torch.kernels import paged_attention as pa, ref

    dt = getattr(torch, dtype)
    B = len(lengths)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn((B, K1, hq, D), generator=gen, device="cuda").to(dt)
    kp, vp, kw, bt, row_bytes = pool_case(torch, np, gen, B, hkv, D, dtype,
                                          kv_dtype, bs, nb, nbmax)
    rng_kw = {} if kv_heads is None else {"kv_heads": kv_heads}
    pk, pv, pkw = kv_view(kp, vp, kw, kv_heads)
    if kv_heads is not None:
        row_bytes = row_bytes * kv_heads[1] // hkv
        hkv = kv_heads[1]
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    fn = pa.paged_verify_attention
    before = dict(fn.launches_by_body)
    got = fn(q, kp, vp, bt, ln, **kw, **rng_kw)
    body = ran_body(fn, before)
    want = ref.paged_verify_attention(q, pk, pv, bt, ln, **pkw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    # visible keys: row j of sequence b sees min(len + 1 + j, table) keys;
    # the sequence's K/V rows are read once for all its rows
    s_max = nbmax * bs
    pairs = sum(min(n + 1 + j, s_max) for n in lengths for j in range(K1))
    rows = sum(min(n + K1, s_max) for n in lengths)
    blocks = sum(-(-min(n + K1, s_max) // bs) for n in lengths)
    nbytes = q.element_size() * 2 * B * K1 * hq * D + rows * row_bytes \
        + 4 * (blocks + B)                        # table entries, lengths
    bound_ms, bound_by = bound(4 * D * hq * pairs, nbytes, dtype)
    nsplit = pa.split_plan(B, hkv, nbmax, bs, pa.sm_count(q.device))[1] \
        if body == "split" else 1

    def call():
        return fn(q, kp, vp, bt, ln, **kw, **rng_kw)

    row = {"phase": "kernels", "kernel": "K4" if kw else "K3", "case": name,
           "shape": [B, K1, hq, hkv, D, bs, nbmax], "lengths": list(lengths),
           "kv_heads": kv_heads,
           "dtype": dtype, "kv_dtype": kv_dtype, "body": body,
           "splits": nsplit, "max_abs_err": err, "tol": TOL[dtype],
           "ms": cuda_ms(torch, call), "graph_ms": graph_ms(torch, call),
           "plain_ms": cuda_ms(torch, lambda: ref.paged_verify_attention(
               q, pk, pv, bt, ln, **pkw)),
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    if profile:
        row["kernel_ms"] = kernel_ms(torch, call, VERIFY_KERNELS)
    emit(row)
    check(math.isfinite(err) and err <= TOL[dtype],
          f"{row['kernel']} {name}: max abs err {err} > {TOL[dtype]}")
    check(body == want_body,
          f"{row['kernel']} {name}: ran the {body} body, not {want_body}")
    check(body != "split" or dtype != "bfloat16" or nsplit > 1,
          f"{row['kernel']} {name}: the split body ran one split")
    return row


def k4_padded_case(torch, np, name, lengths, hq, hkv, D, Dp, kv_dtype,
                   bs=16, nb=1024, nbmax=40):
    """K4 decode of a D-wide head in a Dp-wide pool (zero tail) through
    the dispatcher, which zero-pads q and slices the output; the plain
    version runs on the same padded inputs with the logical scale."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.models import paged_kv

    B = len(lengths)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn((B, hq, D), generator=gen, device="cuda") \
        .to(torch.bfloat16)
    gen.manual_seed(SEED + 1)
    spec = paged_kv.PoolSpec(kv_dtype=kv_dtype, block_size=bs,
                             n_kv_heads=hkv, head_dim=D, padded_head_dim=Dp)
    pool = {}
    for n in ("k", "v"):
        x = torch.randn((nb, bs, hkv, D), generator=gen, device="cuda")
        pool[n], pool[n + "_scale"] = paged_kv.quantize_kv(
            paged_kv._pad_head_dim(x, Dp), spec)
    ids = np.random.default_rng(SEED).permutation(nb - 1)[:B * nbmax] + 1
    bt = torch.from_numpy(ids.reshape(B, nbmax).astype(np.int32)).cuda()
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    scales = {"k_scale": pool["k_scale"], "v_scale": pool["v_scale"]}

    def plain():
        return ref.paged_decode_attention(
            F.pad(q, (0, Dp - D)), pool["k"], pool["v"], bt, ln,
            scale=1 / math.sqrt(D), **scales)[..., :D]

    got = ops.paged_attention(q, pool, bt, ln, kv_format=spec)
    want = plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    toks = int(sum(lengths))
    blocks = int(sum(-(-n // bs) for n in lengths))
    nbytes = 2 * 2 * B * hq * Dp + toks * 2 * hkv * (Dp + 4) \
        + 4 * (blocks + B)
    bound_ms, bound_by = bound(4 * toks * hq * Dp, nbytes, "bfloat16")
    row = {"phase": "kernels", "kernel": "K4", "case": name,
           "shape": [B, hq, hkv, D, Dp, bs, nbmax], "lengths": list(lengths),
           "dtype": "bfloat16", "kv_dtype": kv_dtype, "max_abs_err": err,
           "tol": TOL["bfloat16"],
           "ms": cuda_ms(torch, lambda: ops.paged_attention(
               q, pool, bt, ln, kv_format=spec)),
           "plain_ms": cuda_ms(torch, plain),
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    emit(row)
    check(math.isfinite(err) and err <= TOL["bfloat16"],
          f"K4 {name}: max abs err {err} > {TOL['bfloat16']}")
    return row


def phase_kernels(torch, np, prompts, profile):
    first = [len(p) + 1 for p in prompts[:HALF]]   # first decode lengths
    k1 = k1_case(torch, "main", HALF, 16, 16, 512, 128, "bfloat16", True)
    k1_case(torch, "gqa4", 2, 16, 4, 256, 128, "bfloat16", True)
    k1_case(torch, "f32", 2, 16, 16, 128, 128, "float32", False)
    k2 = k2_case(torch, np, "main", first, 16, 16, 128, "bfloat16",
                 profile=profile)
    k2_case(torch, np, "gqa4", first, 16, 4, 128, "bfloat16", profile=profile)
    k2_case(torch, np, "f32", first, 16, 16, 128, "float32", profile=profile)
    # olmo_1b's 2048-token context, off every phase's path: 8 sequences
    # near the end of a 128-block table, one alone (the first design's
    # worst grid: 16 CTAs), and the same over an fp8 pool
    long = [int(n) for n in np.random.default_rng(SEED).integers(
        1900, 2049, HALF)]
    wide = dict(nb=2048, nbmax=128, profile=profile)
    k2_case(torch, np, "long_8x2048", long, 16, 16, 128, "bfloat16", **wide)
    k2_case(torch, np, "single_2048", [2048], 16, 16, 128, "bfloat16", **wide)
    k2_case(torch, np, "long_fp8", long, 16, 16, 128, "bfloat16", "fp8",
            **wide)
    k2c = combine_case(torch, "main", HALF, 16, k2["splits"], 128,
                       "bfloat16")
    # K3 counts the tokens before the window: a verify window at the
    # first decode starts at len(prompt)
    cached = [n - 1 for n in first]
    sfx = [SHARED] * HALF                  # spec_serve's shared prefix
    kw3 = dict(profile=profile)
    k3 = k3_case(torch, np, "verify", cached, 5, 16, 16, 128, "bfloat16",
                 "split", **kw3)
    # the split body's fixed cost against its rows: 1, 2 and 8 rows a
    # sequence on the verify step's bytes (K2 main is 1 row), and the
    # combine over the verify step's 5 rows a sequence
    for rows in (1, 2, 8):
        k3_case(torch, np, f"verify_k{rows}", cached, rows, 16, 16, 128,
                "bfloat16", "split", **kw3)
    combine_case(torch, "verify_rows", HALF * 5, 16, k3["splits"], 128,
                 "bfloat16")
    # spec_serve's suffix prefills: its 16..128-token suffixes take the
    # buckets 32, 64 (the summary's row: half its requests) and 128 over
    # the shared prefix; "suffix" is a 256-token suffix, off its path
    k3s = {w: k3_case(torch, np, f"suffix_w{w}", sfx, w, 16, 16, 128,
                      "bfloat16", "wgmma", **kw3) for w in SUFFIX_BUCKETS}
    k3_case(torch, np, "suffix", sfx, SHARED, 16, 16, 128, "bfloat16",
            "wgmma", **kw3)
    k3_case(torch, np, "gqa4", cached, 5, 16, 4, 128, "bfloat16", "split",
            **kw3)
    k3_case(torch, np, "f32", cached, 5, 16, 16, 128, "float32", "split",
            **kw3)
    k3_case(torch, np, "suffix_f32", sfx, SHARED, 16, 16, 128, "float32",
            "simt", **kw3)
    # K4: the quantized pool through K2 and K3 at the same shapes
    k4d = k2_case(torch, np, "decode_fp8", first, 16, 16, 128, "bfloat16",
                  "fp8", profile=profile)
    k2_case(torch, np, "decode_int8", first, 16, 16, 128, "bfloat16", "int8",
            profile=profile)
    k2_case(torch, np, "decode_int8_gqa4", first, 16, 4, 128, "bfloat16",
            "int8", profile=profile)
    k4v = k3_case(torch, np, "verify_fp8", cached, 5, 16, 16, 128,
                  "bfloat16", "split", "fp8", **kw3)
    k3_case(torch, np, "verify_int8", cached, 5, 16, 16, 128, "bfloat16",
            "split", "int8", **kw3)
    k4s = {w: k3_case(torch, np, f"suffix_fp8_w{w}", sfx, w, 16, 16, 128,
                      "bfloat16", "wgmma", "fp8", **kw3)
           for w in SUFFIX_BUCKETS}
    k3_case(torch, np, "suffix_fp8", sfx, SHARED, 16, 16, 128, "bfloat16",
            "wgmma", "fp8", **kw3)
    k3_case(torch, np, "suffix_int8", sfx, SHARED, 16, 16, 128, "bfloat16",
            "wgmma", "int8", **kw3)
    k4_padded_case(torch, np, "decode_int8_d64_in_128", first, 16, 16, 64,
                   128, "int8")
    # recurrent_serve's shapes: K5 over the RG-LRU width 2560 at the
    # (8, 512) admission and the (2, 2560) long-prompt admission; K1 at
    # head dim 256 (recurrentgemma MQA, gemma_7b) and 120 (h2o_danube)
    k5 = k5_case(torch, "admit_8x512", 8, 512, 2560)
    k5_long = k5_case(torch, "long_2x2560", 2, 2560, 2560)
    k1_case(torch, "rg_d256_mqa10", 8, 10, 1, 512, 256, "bfloat16", True,
            window=2048)
    k1_case(torch, "rg_d256_long_window", 2, 10, 1, 2560, 256, "bfloat16",
            True, window=2048)
    k1_case(torch, "gemma_d256", 8, 16, 16, 512, 256, "bfloat16", True)
    k1_case(torch, "danube_d120_gqa4", 8, 32, 8, 512, 120, "bfloat16", True,
            window=4096)
    k1_case(torch, "d64_ragged_gqa4", 2, 8, 2, 300, 64, "bfloat16", True)
    # moe_serve's shapes (qwen3_moe_30b_a3b): GQA 32 / 4 at head dim 128,
    # the first admission's prefill and the decode over serve's lengths
    k1_moe = k1_case(torch, "qwen3_gqa8", HALF, 32, 4, 512, 128, "bfloat16",
                     True)
    k2_moe = k2_case(torch, np, "qwen3_gqa8", first, 32, 4, 128, "bfloat16",
                     profile=profile)
    # encdec_serve's and vlm_dense's shapes: whisper's decoder prefill at
    # its longest prompt bucket, its exact-length encoder over full
    # windows (the dense path: non-causal), the dense path's
    # cross-attention of the start-of-transcript prefill and of one
    # decode token over full windows (non-causal, q / k / v laid out as
    # the model passes them), K2 at whisper's head layout
    # over encdec_serve's first decode lengths; qwen2-vl's (8, 512)
    # prefill at GQA 12/2
    k1_case(torch, "whisper_dec", HALF, 8, 8, 256, 64, "bfloat16", True)
    k1_wenc = k1_case(torch, "whisper_enc", HALF, 8, 8, ENC_FRAMES, 64,
                      "bfloat16", True, causal=False)
    k1_wx = {n: k1_case(torch, f"whisper_xattn_{n}", HALF, 8, 8, Sq, 64,
                        "bfloat16", True, causal=False, Skv=ENC_FRAMES,
                        seq_major=True)
             for n, Sq in (("prefill", len(SOT)), ("decode", 1))}
    from repro_torch.configs import get_config

    wfirst = [len(p) + 1 for p in encdec_workload(
        np, get_config("whisper_base").d_model)[0][:HALF]]
    k2_wh = k2_case(torch, np, "whisper", wfirst, 8, 8, 64, "bfloat16",
                    profile=profile)
    k1_vl = k1_case(torch, "qwen2vl_gqa6", HALF, 12, 2, 512, 128,
                    "bfloat16", True)
    return (k1, k2, k2c, k3, k3s[64], k4d, k4v, k4s[64], k5, k5_long, k1_moe,
            k2_moe, k1_wenc, k1_wx["decode"], k2_wh, k1_vl)


def phase_parity(torch, np):
    from repro_torch.configs import get_config
    from repro_torch.launch.engine import Engine, EngineConfig, SamplingParams
    from repro_torch.models import transformer, weights
    from repro_torch.models.model import Model
    from repro_torch.models.paged_kv import PagedLayout

    cfg = get_config("olmo_1b").smoke()
    models = {d: Model(cfg, device=d) for d in ("cpu", "cuda")}
    params = {"cpu": models["cpu"].init(seed=SEED)}
    params["cuda"] = weights.to_device(params["cpu"], "cuda")
    rng = np.random.default_rng(SEED)
    ctx = transformer.RunCtx()

    # logits: right-padded prefill, packed into a pool, one paged decode
    lens = np.array([3, 7, 12], np.int32)
    toks = np.zeros((3, 16), np.int32)
    for r, n in enumerate(lens):
        toks[r, :n] = rng.integers(0, cfg.vocab_size, n)
    table = (np.arange(3 * 8, dtype=np.int32) + 1).reshape(3, 8)
    ids = np.where(np.arange(4)[None] < -(-lens[:, None] // 4),
                   table[:, :4], 0).astype(np.int32)
    feed = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    layout = PagedLayout(num_slots=3, num_blocks=25, block_size=4,
                         max_len=32)
    out = {}
    for d, m in models.items():
        def t(a, d=d):
            return torch.from_numpy(a).to(d)
        pl, dense = m.prefill(params[d], {"tokens": t(toks)}, ctx,
                              max_len=16, length=t(lens))
        pools = m.pack_prefill_into_paged(
            layout, m.init_paged_cache(layout), dense,
            t(np.arange(3, dtype=np.int32)), t(np.ones(3, bool)), t(ids))
        dl, _ = m.decode_step_paged(params[d], pools, t(table), t(lens),
                                    t(feed), ctx)
        out[d] = (pl.cpu(), dl.cpu())
    pre_diff = (out["cpu"][0] - out["cuda"][0]).abs().max().item()
    dec_diff = (out["cpu"][1] - out["cuda"][1]).abs().max().item()

    # engine: ragged prompts, then a pool tight enough to preempt
    ragged = [list(map(int, rng.integers(0, cfg.vocab_size, n)))
              for n in (3, 7, 12)]
    tight = [list(map(int, rng.integers(0, cfg.vocab_size, 8)))
             for _ in range(3)]
    got, pre = {}, {}
    for d, m in models.items():
        e1 = Engine(m, params[d], EngineConfig(num_slots=2, block_size=4,
                                               num_blocks=17, max_len=32),
                    device=d)
        e2 = Engine(m, params[d], EngineConfig(num_slots=3, block_size=4,
                                               num_blocks=14, max_len=64),
                    device=d)
        got[d] = (e1.generate(ragged, SamplingParams(max_tokens=6)),
                  e2.generate(tight, SamplingParams(max_tokens=16)))
        pre[d] = e2.stats()["preemptions"]
        check(e1.stats()["blocks_used"] == 0 == e2.stats()["blocks_used"],
              f"parity: {d} engine leaked blocks")
    emit({"phase": "parity", "config": cfg.name, "dtype": "float32",
          "prefill_max_abs_diff": pre_diff, "decode_max_abs_diff": dec_diff,
          "tol": PARITY_TOL, "tokens_equal": got["cpu"] == got["cuda"],
          "preemptions": pre})
    check(pre_diff <= PARITY_TOL and dec_diff <= PARITY_TOL,
          f"parity: logits differ by {pre_diff} / {dec_diff}")
    check(got["cpu"] == got["cuda"], "parity: cuda tokens != cpu tokens")
    check(pre["cuda"] >= 1, "parity: the tight pool never preempted")
    phase_parity_spec(torch, np, models, params, rng)


def phase_parity_spec(torch, np, models, params, rng):
    """Speculative decoding + prefix cache, cuda against cpu: prompts
    share a 12-token (3-block) prefix and end in a repeated phrase; the
    last repeats the first, so the run has partial hits (suffix prefill
    through K3), a full hit and its COW copy."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.engine import Engine, EngineConfig, SamplingParams
    from repro_torch.models import weights

    vocab = models["cpu"].cfg.vocab_size
    common = list(map(int, rng.integers(0, vocab, 12)))
    prompts = [common + list(map(int, rng.integers(0, vocab, 2))) * 2
               for _ in range(4)]
    prompts.append(list(prompts[0]))
    geo = dict(num_slots=2, block_size=4, num_blocks=40, max_len=48)
    draft = {"cpu": models["cpu"].init(seed=SEED + 7)}
    draft["cuda"] = weights.to_device(draft["cpu"], "cuda")
    sp = SamplingParams(max_tokens=10)
    runs, stats = {}, {}
    for d, m in models.items():
        for drafter in ("ngram", "draft_model"):
            kw = dict(geo, spec_tokens=3, drafter=drafter)
            if drafter == "draft_model":
                kw.update(draft_model=m, draft_params=draft[d])
            eng = Engine(m, params[d], EngineConfig(**kw), device=d)
            n0 = pa.paged_verify_attention.launches
            runs[(d, drafter)] = eng.generate(prompts, sp)
            st = eng.stats()
            stats[(d, drafter)] = {
                "blocks_used": st["blocks_used"],
                **{k: st["prefix_cache"][k] for k in (
                    "hits", "cow_copies", "suffix_shapes")},
                "accepted": st["spec"]["accepted"],
                "k3_launches": pa.paged_verify_attention.launches - n0}
    base = Engine(models["cuda"], params["cuda"],
                  EngineConfig(prefix_cache=False, **geo), device="cuda")
    want = base.generate(prompts, sp)
    equal = all(out == want for out in runs.values())
    # seeded sampling (threefry, JAX's stream): cuda == cpu, plain and
    # speculative
    seeded = [SamplingParams(max_tokens=10, temperature=0.9, top_k=30,
                             top_p=0.95, seed=s) for s in range(len(prompts))]
    sruns = {(d, k): Engine(m, params[d], EngineConfig(spec_tokens=k, **geo),
                            device=d).generate(prompts, seeded)
             for d, m in models.items() for k in (0, 3)}
    seeded_equal = len({str(v) for v in sruns.values()}) == 1
    emit({"phase": "parity_spec", "dtype": "float32", "tokens_equal": equal,
          "seeded_tokens_equal": seeded_equal,
          "stats": {f"{d}/{dr}": v for (d, dr), v in stats.items()}})
    check(equal, "parity_spec: spec / prefix-cache tokens differ from the "
          "non-speculative cache-off engine or between cuda and cpu")
    check(seeded_equal, "parity_spec: seeded tokens differ between cuda "
          "and cpu, or between speculative and plain")
    for key, st in stats.items():
        check(st["blocks_used"] == 0, f"parity_spec: {key} leaked blocks")
        check(st["hits"] >= 3 and st["cow_copies"] >= 1
              and st["suffix_shapes"] >= 1,
              f"parity_spec: {key} missed a partial hit, full hit or COW")
        check(key[0] == "cpu" or st["k3_launches"] > 0,
              f"parity_spec: {key} never launched K3")


def phase_parity_quant(torch, np):
    """The quantized pool (K4), cuda against cpu on olmo_1b smoke in f32,
    for int8 and fp8: greedy, seeded and ngram-speculative runs with the
    prefix cache on, over prompts sharing a block-aligned prefix (partial
    hits, a full hit and its COW copy). Tokens and prefix-cache counters
    must be equal on both devices, every pool must end empty, and every
    cuda run must have launched K4 in verify (suffix prefills, verify
    windows) and, unless speculative, in decode."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.engine import Engine, EngineConfig, SamplingParams
    from repro_torch.models import weights
    from repro_torch.models.model import Model

    cfg = get_config("olmo_1b").smoke()
    models = {d: Model(cfg, device=d) for d in ("cpu", "cuda")}
    params = {"cpu": models["cpu"].init(seed=SEED)}
    params["cuda"] = weights.to_device(params["cpu"], "cuda")
    rng = np.random.default_rng(SEED + 2)
    common = list(map(int, rng.integers(0, cfg.vocab_size, 12)))
    prompts = [common + list(map(int, rng.integers(0, cfg.vocab_size, 2)))
               * 2 for _ in range(4)]
    prompts.append(list(prompts[0]))              # 16 tokens: a full hit
    geo = dict(num_slots=2, block_size=4, num_blocks=40, max_len=48)
    runs = {"greedy": ({}, [SamplingParams(max_tokens=10)] * 5),
            "seeded": ({}, [SamplingParams(max_tokens=10, temperature=0.9,
                                           top_k=30, seed=s)
                            for s in range(5)]),
            "spec": ({"spec_tokens": 3}, [SamplingParams(max_tokens=10)] * 5)}
    out, stats = {}, {}
    for kv_dtype in ("int8", "fp8"):
        for name, (kw, sp) in runs.items():
            for d, m in models.items():
                k4 = (pa.paged_decode_attention.k4_launches,
                      pa.paged_verify_attention.k4_launches)
                eng = Engine(m, params[d], EngineConfig(
                    kv_dtype=kv_dtype, **kw, **geo), device=d)
                key = (kv_dtype, name, d)
                out[key] = eng.generate(prompts, sp)
                st = eng.stats()
                stats[key] = {
                    "blocks_used": st["blocks_used"],
                    "prefix_cache": {k: st["prefix_cache"][k] for k in (
                        "lookups", "hits", "hit_tokens", "cow_copies",
                        "evictions", "suffix_shapes")},
                    "k4_decode": pa.paged_decode_attention.k4_launches - k4[0],
                    "k4_verify": pa.paged_verify_attention.k4_launches
                    - k4[1]}
    equal = all(out[(q, n, "cpu")] == out[(q, n, "cuda")]
                for q in ("int8", "fp8") for n in runs)
    same_stats = all(stats[(q, n, "cpu")]["prefix_cache"]
                     == stats[(q, n, "cuda")]["prefix_cache"]
                     for q in ("int8", "fp8") for n in runs)
    emit({"phase": "parity_quant", "config": cfg.name, "dtype": "float32",
          "tokens_equal": equal, "prefix_stats_equal": same_stats,
          "stats": {"/".join(k): v for k, v in stats.items()}})
    check(equal, "parity_quant: cuda tokens != cpu tokens")
    check(same_stats, "parity_quant: prefix-cache counters differ")
    for key, st in stats.items():
        check(st["blocks_used"] == 0, f"parity_quant: {key} leaked blocks")
        pc = st["prefix_cache"]
        check(pc["hits"] >= 3 and pc["cow_copies"] >= 1,
              f"parity_quant: {key} missed a prefix hit or the COW copy")
        # every run prefills suffixes through verify; the speculative
        # run has no plain decode step
        check(key[2] == "cpu" or (st["k4_verify"] > 0 and (
            key[1] == "spec" or st["k4_decode"] > 0)),
            f"parity_quant: {key} never launched K4 {st}")


def decode_launches(st, runs, cfg, k2="K2"):
    """The captured step's launch rule: every decode step ran by graph
    replay (``graph_replays`` = steps, ``eager_decode_steps`` = 0) and
    each replay launched one K2 (or K4, ``k2``) and one combine a
    layer."""
    want = cfg.n_layers * st["steps"]
    check(st["graph_replays"] == st["steps"] > 0
          and st["eager_decode_steps"] == 0,
          f"decode ran {st['graph_replays']} replays and "
          f"{st['eager_decode_steps']} eager steps in {st['steps']} steps")
    check(runs[k2] == runs["K2_combine"] == want,
          f"{k2} / combine launches {runs[k2]} / {runs['K2_combine']}, "
          f"expected {cfg.n_layers} x {st['steps']} steps = {want}")


def serve_turn(torch, engine, prompts, news, warm):
    """One timed turn of ``engine`` over the requests, after a warm-up
    request and with the K1 / K2 / combine / K3 / K4 counters set to 0
    just before: (outputs, seconds, launches (K3's by body under
    ``K3_bodies``), K1 launches by body, stats)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rglru_scan as k5
    from repro_torch.launch.engine import SamplingParams

    engine.generate([warm], SamplingParams(max_tokens=2))
    engine.backend.reset_telemetry()              # warm-up excluded
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    zero_bodies(fa.flash_attention)
    k5.rglru_scan.launches = 0
    zero_bodies(k5.rglru_scan)
    k5.rglru_scan.launches_by_shape = {}
    pa.paged_decode_attention.launches = 0
    pa.paged_decode_attention.k4_launches = 0
    pa.paged_decode_combine.launches = 0
    pa.paged_verify_attention.launches = 0
    pa.paged_verify_attention.k4_launches = 0
    zero_bodies(pa.paged_verify_attention)
    t0 = time.monotonic()
    outs = engine.generate(prompts, [SamplingParams(max_tokens=n)
                                     for n in news])
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    launches = {"K1": fa.flash_attention.launches,
                "K2": pa.paged_decode_attention.launches,
                "K2_combine": pa.paged_decode_combine.launches,
                "K3": pa.paged_verify_attention.launches,
                "K4_decode": pa.paged_decode_attention.k4_launches,
                "K4_verify": pa.paged_verify_attention.k4_launches,
                "K3_bodies": dict(pa.paged_verify_attention.launches_by_body),
                "K5": k5.rglru_scan.launches,
                "K5_bodies": dict(k5.rglru_scan.launches_by_body),
                "K5_shapes": {s: dict(b) for s, b in
                              k5.rglru_scan.launches_by_shape.items()}}
    return (outs, secs, launches, dict(fa.flash_attention.launches_by_body),
            engine.stats())


def phase_serve(torch, np, prompts, news, warm, profile):
    """olmo_1b at full width through ``Engine``: the 16 requests with
    overlap off (the captured step replayed, its tokens fetched at once),
    then again on a second engine with ``overlap=True``; the tokens must
    be equal."""
    from repro_torch.configs import get_config
    from repro_torch.launch.engine import Engine, EngineConfig
    from repro_torch.models import transformer
    from repro_torch.models.model import Model

    cfg = get_config("olmo_1b")
    model = Model(cfg, device="cuda")
    params = model.init(seed=SEED)
    engines = {}
    turns = {}
    for overlap in (False, True):
        engines[overlap] = Engine(model, params, EngineConfig(
            num_slots=8, block_size=16, num_blocks=1024, max_len=640,
            overlap=overlap), device="cuda")
        torch.cuda.reset_peak_memory_stats()
        outs, secs, runs, k1_bodies, st = serve_turn(
            torch, engines[overlap], prompts, news, warm)
        launches = {k: runs[k] for k in ("K1", "K2", "K2_combine")}
        turns[overlap] = outs
        ntok = sum(len(o) for o in outs)
        emit({"phase": "serve", "config": cfg.name, "dtype": cfg.dtype,
              "overlap": overlap, "requests": len(outs), "tokens": ntok,
              "seconds": secs, "tok_s": ntok / secs, "launches": launches,
              "k1_launches_by_body": k1_bodies,
              "steps": st["steps"], "graph_replays": st["graph_replays"],
              "eager_decode_steps": st["eager_decode_steps"],
              "decode_device_s": st["device_s"],
              "prefill_calls": st["prefill_calls"],
              "prefill_tokens": st["prefill_tokens"],
              "preemptions": st["preemptions"],
              "blocks_used": st["blocks_used"],
              "ttft_p50_s": st["latency"]["ttft"]["p50_s"],
              "tpot_p50_s": st["latency"]["tpot"]["p50_s"],
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "first_tokens": outs[0][:8],
              **({"tokens_equal_overlap_off": outs == turns[False]}
                 if overlap else {})})
        check(all(len(o) == n for o, n in zip(outs, news)),
              "serve: a request did not emit max_tokens tokens")
        check(all(0 <= t < cfg.vocab_size for o in outs for t in o),
              "serve: token id out of range")
        check(all(n > 0 for n in launches.values()),
              f"serve: a kernel was never launched on the main path "
              f"{launches}")
        decode_launches(st, runs, cfg)
        check(k1_bodies["wgmma"] > 0,
              f"serve: no prefill ran K1's tensor-core body {k1_bodies}")
        check(st["blocks_used"] == 0,
              f"serve: {st['blocks_used']} blocks leaked")
        if overlap:
            check(outs == turns[False],
                  "serve: overlap=True tokens differ from overlap off")
        else:
            base = launches
    logits = model.prefill(params, {"tokens": torch.tensor(
        [prompts[0][:16]], device="cuda")}, transformer.RunCtx())[0]
    check(tuple(logits.shape) == (1, 16, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "serve: bad prefill logits")
    if profile:
        for overlap, engine in engines.items():
            phase_profile(torch, engine, prompts, news,
                          f"{cfg.name} serve overlap={overlap}")
    return base, turns[False], model, params


def phase_static_serve(torch, np, prompts, news, model, params):
    """olmo_1b at full width on the lockstep ``backend="static"``: serve's
    16 requests in batches of 8 over a dense (8, 640) cache, prefilled at
    the bucket of each batch's longest prompt through K1, decoded in
    plain torch."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.engine import Engine, EngineConfig, SamplingParams

    cfg = model.cfg
    engine = Engine(model, params, EngineConfig(
        backend="static", num_slots=8, block_size=16, max_len=640),
        device="cuda")
    engine.generate([prompts[0][:40]], SamplingParams(max_tokens=2))
    engine.backend.reset_telemetry()
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    t0 = time.monotonic()
    outs = engine.generate(prompts, [SamplingParams(max_tokens=n)
                                     for n in news])
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    st = engine.stats()
    ntok = sum(len(o) for o in outs)
    k1 = fa.flash_attention.launches
    emit({"phase": "static_serve", "config": cfg.name, "dtype": cfg.dtype,
          "requests": len(outs), "tokens": ntok, "seconds": secs,
          "tok_s": ntok / secs, "steps": st["steps"],
          "batches": st["batches"],
          "mean_active_slots": st["mean_active_slots"],
          "cache_utilization": st["cache_utilization"],
          "prefill_compiles": st["prefill_compiles"],
          "launches": {"K1": k1},
          "ttft_p50_s": st["latency"]["ttft"]["p50_s"],
          "tpot_p50_s": st["latency"]["tpot"]["p50_s"],
          "first_tokens": outs[0][:8]})
    check(all(len(o) == n for o, n in zip(outs, news)),
          "static_serve: a request did not emit max_tokens tokens")
    check(all(0 <= t < cfg.vocab_size for o in outs for t in o),
          "static_serve: token id out of range")
    check(st["batches"] == 2 and k1 == 2 * cfg.n_layers,
          f"static_serve: {st['batches']} batches, {k1} K1 launches")


def verify_bodies(pa, cfg, st, k3, k1):
    """K3's launches on a speculative path split by regime: the verify
    step (spec steps x layers) and the suffix prefill (the rest), with
    the per-body counts; fails unless every verify launch ran "split"
    and every suffix launch "wgmma". ``k3`` counts the path's K3 or K4
    calls, ``k1`` its full prefills (K1, none when every admission hits
    the prefix cache)."""
    by_body = dict(pa.paged_verify_attention.launches_by_body)
    verify = st["spec"]["steps"] * cfg.n_layers
    suffix = k3 - verify
    check(by_body == {"simt": 0, "split": verify, "wgmma": suffix}
          and suffix > 0 and suffix % cfg.n_layers == 0,
          f"K3 bodies {by_body}: expected {verify} verify launches on "
          f"split and {suffix} suffix launches on wgmma (K1 {k1})")
    return {"verify_launches": verify, "suffix_launches": suffix,
            "launches_by_body": by_body}


def phase_spec_serve(torch, np, profile):
    """Full-width olmo_1b, bf16, speculative decoding (ngram, K = 4) with
    the prefix cache, on shared-prefix traffic; then the same prompts
    through a non-speculative, cache-off engine for the token match.
    With ``profile``, a window of one admission of partial prefix hits
    (fresh suffixes after the shared prefix: K3's suffix prefill) and 8
    verify steps."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.engine import Engine, EngineConfig, SamplingParams
    from repro_torch.models.model import Model

    prompts, news, warm = spec_workload(np)
    cfg = get_config("olmo_1b")
    model = Model(cfg, device="cuda")
    params = model.init(seed=SEED)
    geo = dict(num_slots=8, block_size=16, num_blocks=1024, max_len=640)
    engine = Engine(model, params, EngineConfig(spec_tokens=4,
                                                drafter="ngram", **geo),
                    device="cuda")
    # indexes the prefix's 16 blocks (parked in the LRU after retirement)
    engine.generate([warm], SamplingParams(max_tokens=2))
    engine.backend.reset_telemetry()
    torch.cuda.synchronize()

    fa.flash_attention.launches = 0
    pa.paged_decode_attention.launches = 0
    pa.paged_verify_attention.launches = 0
    zero_bodies(pa.paged_verify_attention)
    t0 = time.monotonic()
    outs = engine.generate(prompts, [SamplingParams(max_tokens=n)
                                     for n in news])
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    launches = {"K1": fa.flash_attention.launches,
                "K2": pa.paged_decode_attention.launches,
                "K3": pa.paged_verify_attention.launches}
    st = engine.stats()
    bodies = verify_bodies(pa, cfg, st, launches["K3"], launches["K1"])
    if profile:
        rng = np.random.default_rng(SEED + 2)
        fresh = [p[:SHARED] + list(map(int, rng.integers(
            0, 50304, len(p) - SHARED))) for p in prompts]
        phase_profile(torch, engine, fresh, news, f"{cfg.name} spec_serve")
    del engine
    base = Engine(model, params, EngineConfig(prefix_cache=False, **geo),
                  device="cuda")
    want = base.generate(prompts, [SamplingParams(max_tokens=n)
                                   for n in news])
    same = [o == w for o, w in zip(outs, want)]
    diverge = [{"request": r, "position": next(
                   (j for j, (a, b) in enumerate(zip(o, w)) if a != b),
                   min(len(o), len(w))), "spec": o[:12], "base": w[:12]}
               for r, (o, w) in enumerate(zip(outs, want)) if o != w]
    ntok = sum(len(o) for o in outs)
    pc, spec = st["prefix_cache"], st["spec"]
    emit({"phase": "spec_serve", "config": cfg.name, "dtype": cfg.dtype,
          "spec_tokens": 4, "drafter": "ngram", "requests": len(outs),
          "tokens": ntok, "seconds": secs, "tok_s": ntok / secs,
          "launches": launches, **bodies, "steps": st["steps"],
          "decode_device_s": st["device_s"],
          "emitted_per_step": spec["emitted_per_step"],
          "accept_rate": spec["accept_rate"],
          "prefill_calls": st["prefill_calls"],
          "prefill_tokens": st["prefill_tokens"],
          "prefix_hits": pc["hits"], "prefix_hit_tokens": pc["hit_tokens"],
          "cow_copies": pc["cow_copies"], "blocks_used": st["blocks_used"],
          "preemptions": st["preemptions"],
          "ttft_p50_s": st["latency"]["ttft"]["p50_s"],
          "tpot_p50_s": st["latency"]["tpot"]["p50_s"],
          "match_nonspec_share": sum(same) / len(same),
          "first_divergence": diverge[:1]})
    check(all(len(o) == n for o, n in zip(outs, news)),
          "spec_serve: a request did not emit max_tokens tokens")
    check(all(0 <= t < cfg.vocab_size for o in outs for t in o),
          "spec_serve: token id out of range")
    check(launches["K3"] > 0,
          f"spec_serve: K3 was never launched on the path {launches}")
    check(pc["hits"] >= N_REQ, f"spec_serve: {pc['hits']} prefix hits")
    check(st["blocks_used"] == 0,
          f"spec_serve: {st['blocks_used']} blocks leaked")
    return {**launches, "K3_verify": bodies["verify_launches"],
            "K3_suffix": bodies["suffix_launches"]}


def pool_block_bytes(torch, cfg, kv_dtype):
    """Bytes one pool block takes across all layers, read off the leaves
    of a pool built on the meta device (no memory) in that format."""
    from repro_torch.models import paged_kv, transformer

    layout = paged_kv.PagedLayout(num_slots=1, num_blocks=2, block_size=16,
                                  max_len=16)
    spec = None if kv_dtype == "bf16" else paged_kv.make_pool_spec(
        cfg, layout, kv_dtype=kv_dtype)
    pools = transformer.init_paged_cache(cfg, layout, torch.device("meta"),
                                         spec)
    return paged_kv.pool_bytes(pools) // layout.num_blocks


def phase_quant_serve(torch, np, prompts, news, warm, base_outs, model,
                      params, usable_bf16=1023):
    """Full-width olmo_1b (bf16 compute) over an fp8 pool (overlap off,
    then on: equal tokens) and an int8 pool:
    the serve phase's 16 requests and geometry, with the serve pool's
    usable BYTES (1023 bf16 blocks) spent on quantized blocks. Reports
    the capacity ratio, tok/s, TTFT/TPOT p50, the greedy token match rate
    against the serve phase's bf16 outputs (reported, not gated), the K4
    launches and the leaked blocks (must be 0). Then an fp8 speculative
    run (ngram, K 4, prefix cache) on spec_serve's shared-prefix traffic,
    so K4 also runs inside the verify kernel on the full-width path."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.engine import Engine, EngineConfig, SamplingParams

    cfg = model.cfg
    bf16_block = pool_block_bytes(torch, cfg, "bf16")
    budget = usable_bf16 * bf16_block
    launches = {"K4_decode": 0, "K4_verify": 0}
    turns = {}
    for kv_dtype, overlap in (("fp8", False), ("fp8", True),
                              ("int8", False)):
        q_block = pool_block_bytes(torch, cfg, kv_dtype)
        usable = budget // q_block
        engine = Engine(model, params, EngineConfig(
            num_slots=8, block_size=16, num_blocks=usable + 1, max_len=640,
            kv_dtype=kv_dtype, overlap=overlap), device="cuda")
        outs, secs, runs, _, st = serve_turn(torch, engine, prompts, news,
                                             warm)
        turns[(kv_dtype, overlap)] = outs
        if not overlap:
            launches["K4_decode"] += runs["K4_decode"]
        ntok = sum(len(o) for o in outs)
        match = sum(a == b for o, w in zip(outs, base_outs)
                    for a, b in zip(o, w)) / max(
            sum(len(w) for w in base_outs), 1)
        emit({"phase": "quant_serve", "config": cfg.name, "dtype": cfg.dtype,
              "kv_dtype": kv_dtype, "overlap": overlap,
              "block_bytes_bf16": bf16_block,
              "block_bytes": q_block, "pool_budget_bytes": budget,
              "usable_blocks_bf16": usable_bf16, "usable_blocks": usable,
              "num_blocks": usable + 1,
              "capacity_ratio": usable / usable_bf16,
              "pool_bytes": st["pool_bytes"], "requests": len(outs),
              "tokens": ntok, "seconds": secs, "tok_s": ntok / secs,
              "launches": runs, "steps": st["steps"],
              "graph_replays": st["graph_replays"],
              "eager_decode_steps": st["eager_decode_steps"],
              "decode_device_s": st["device_s"],
              "ttft_p50_s": st["latency"]["ttft"]["p50_s"],
              "tpot_p50_s": st["latency"]["tpot"]["p50_s"],
              "match_rate_vs_bf16": match,
              "blocks_used": st["blocks_used"],
              "preemptions": st["preemptions"],
              "first_tokens": outs[0][:8],
              **({"tokens_equal_overlap_off":
                  outs == turns[(kv_dtype, False)]} if overlap else {})})
        check(st["pool_bytes"] <= budget + bf16_block,
              f"quant_serve {kv_dtype}: pool of {st['pool_bytes']} bytes "
              f"exceeds the bf16 pool's {budget + bf16_block}")
        check(all(len(o) == n for o, n in zip(outs, news)),
              f"quant_serve {kv_dtype}: a request did not finish")
        check(all(0 <= t < cfg.vocab_size for o in outs for t in o),
              f"quant_serve {kv_dtype}: token id out of range")
        check(runs["K2"] == 0,
              f"quant_serve {kv_dtype}: decode launched K2 {runs}")
        decode_launches(st, runs, cfg, k2="K4_decode")
        check(st["blocks_used"] == 0,
              f"quant_serve {kv_dtype}: {st['blocks_used']} blocks leaked")
        if overlap:
            check(outs == turns[(kv_dtype, False)],
                  f"quant_serve {kv_dtype}: overlap=True tokens differ "
                  "from overlap off")
        del engine

    sprompts, snews, swarm = spec_workload(np)
    engine = Engine(model, params, EngineConfig(
        num_slots=8, block_size=16, num_blocks=1024, max_len=640,
        kv_dtype="fp8", spec_tokens=4, drafter="ngram"), device="cuda")
    engine.generate([swarm], SamplingParams(max_tokens=2))
    engine.backend.reset_telemetry()
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    pa.paged_verify_attention.launches = 0
    pa.paged_verify_attention.k4_launches = 0
    zero_bodies(pa.paged_verify_attention)
    t0 = time.monotonic()
    outs = engine.generate(sprompts, [SamplingParams(max_tokens=n)
                                      for n in snews])
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    k3, k4v = (pa.paged_verify_attention.launches,
               pa.paged_verify_attention.k4_launches)
    st = engine.stats()
    bodies = verify_bodies(pa, cfg, st, k4v, fa.flash_attention.launches)
    launches["K4_verify"] = bodies["verify_launches"]
    launches["K4_verify_suffix"] = bodies["suffix_launches"]
    ntok = sum(len(o) for o in outs)
    emit({"phase": "quant_serve", "config": cfg.name, "dtype": cfg.dtype,
          "kv_dtype": "fp8", "spec_tokens": 4, "drafter": "ngram",
          "requests": len(outs), "tokens": ntok, "seconds": secs,
          "tok_s": ntok / secs,
          "launches": {"K3": k3, "K4_verify": k4v}, **bodies,
          "steps": st["steps"], "accept_rate": st["spec"]["accept_rate"],
          "prefix_hits": st["prefix_cache"]["hits"],
          "blocks_used": st["blocks_used"]})
    check(k4v > 0 and k3 == 0,
          f"quant_serve spec: verify did not go through K4 ({k3}, {k4v})")
    check(st["prefix_cache"]["hits"] >= N_REQ,
          f"quant_serve spec: {st['prefix_cache']['hits']} prefix hits")
    check(st["blocks_used"] == 0,
          f"quant_serve spec: {st['blocks_used']} blocks leaked")
    return launches


# ---------------------------------------------------------------------------
# replicas on one card: ReplicaSet, DisaggregatedEngine, KV migration
# ---------------------------------------------------------------------------


def first_candidate(rset, cands):
    """Dispatch policy that piles every placement onto the first
    candidate: one decode replica takes every import, the other steals."""
    return cands[0]


def no_leaks(engine, where):
    """Every replica's pool (and arena) back to all-free (a static
    replica has no pool: its batch must be empty)."""
    for r, eng in enumerate(engine.replicas):
        be = eng.backend
        if not hasattr(be, "alloc"):
            check(not be.has_work, f"{where}: replica {r} still busy")
            continue
        check(be.alloc.free_count == be.layout.usable_blocks,
              f"{where}: replica {r} leaked "
              f"{be.layout.usable_blocks - be.alloc.free_count} blocks")
        be.alloc.check_invariant()
        check(be.arena is None or be.arena.used_count == 0,
              f"{where}: replica {r} leaked an arena row")


def bytes_equal(torch, a, b):
    """Two trees of tensors hold the same bytes, leaf by leaf."""
    from repro_torch import tree

    return all(x.dtype == y.dtype and x.shape == y.shape and torch.equal(
        x.contiguous().view(torch.uint8), y.contiguous().view(torch.uint8))
        for x, y in zip(tree.leaves(a), tree.leaves(b)))


def migration_roundtrip(torch, np, model, params, kv_dtype, prompt):
    """On the card: admit one request into an engine over a ``kv_dtype``
    pool, export it, land it in a second engine and gather it back out:
    the payload and scale bytes must equal the packet's, and the request
    must finish on the second engine with nothing leaked."""
    from repro_torch.launch.engine import Engine, EngineConfig, SamplingParams
    from repro_torch.launch.engine import transport
    from repro_torch.models import paged_kv

    geo = dict(num_slots=3, block_size=4, num_blocks=33, max_len=48,
               kv_dtype=kv_dtype)
    src, dst = (Engine(model, params, EngineConfig(**geo),
                       device=model.device) for _ in range(2))
    src.add_request(prompt, SamplingParams(max_tokens=6))
    src.step()                              # admit + one decode
    i = next(j for j, s in enumerate(src.backend.slots) if s.req is not None)
    pkt = transport.extract_slot(src.backend, i)
    j = transport.insert_packet(dst.backend, pkt)
    back = paged_kv.extract_blocks(
        dst.backend.pools, transport._pool_mask(dst.backend),
        torch.tensor(dst.backend.slots[j].blocks, device=model.device), j)
    equal = bytes_equal(torch, back, pkt.state)
    dst.drain()
    for eng in (src, dst):
        check(eng.stats()["blocks_used"] == 0,
              f"parity_replica: {kv_dtype} round trip leaked blocks")
    return equal


def phase_parity_replica(torch, np):
    """The replica layer on smoke configs in f32, cuda against cpu, the
    same weights: ``ReplicaSet(dp=2)`` paged and static on olmo_1b;
    ``DisaggregatedEngine`` on olmo_1b with a forced steal (also with
    ``overlap=True``), with a full-prefix-hit rewind, over int8 and fp8
    pools, on recurrentgemma_2b (slot leaves, K5) and whisper_base (cross
    rows); a speculative replica (``spec_tokens`` 3 on one of the
    ReplicaSet's, on the decode role of the disaggregated one) over
    prompts behind a shared two-block prefix. Tokens equal on both
    devices and equal a single Engine's on cuda; no replica leaks; K1
    and the decode kernels (K2, K4 over the quantized pools, K5 on
    recurrentgemma, K3 on the speculative cases) launched on cuda; an
    int8 and an fp8 packet land bit for bit."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rglru_scan as k5
    from repro_torch.launch.engine import (DisaggregatedEngine, Engine,
                                           EngineConfig, ReplicaSet,
                                           SamplingParams)

    t0 = time.monotonic()
    rng = np.random.default_rng(SEED + 9)
    geo = dict(num_slots=3, block_size=4, num_blocks=33, max_len=48)
    pd, pdd = ("prefill", "decode"), ("prefill", "decode", "decode")
    cases = {   # name: (arch, engine options, set kind, set options)
        "rset_paged": ("olmo_1b", {}, "rset", {}),
        "rset_static": ("olmo_1b", {"backend": "static"}, "rset", {}),
        "disagg_steal": ("olmo_1b", {}, "disagg",
                         {"roles": pdd, "policy": first_candidate}),
        "disagg_steal_overlap": ("olmo_1b", {"overlap": True}, "disagg",
                                 {"roles": pdd, "policy": first_candidate}),
        "rset_spec": ("olmo_1b", {}, "rset",
                      {"overrides": [{"spec_tokens": 3}, {}]}),
        "disagg_spec": ("olmo_1b", {}, "disagg", {
            "roles": pdd, "role_overrides": {"decode": {"spec_tokens": 3}}}),
        "disagg_rewind": ("olmo_1b", {}, "disagg", {"roles": pd}),
        "disagg_int8": ("olmo_1b", {"kv_dtype": "int8"}, "disagg",
                        {"roles": pd}),
        "disagg_fp8": ("olmo_1b", {"kv_dtype": "fp8"}, "disagg",
                       {"roles": pd}),
        "disagg_recurrentgemma": ("recurrentgemma_2b", {}, "disagg",
                                  {"roles": pdd,
                                   "policy": first_candidate}),
        "disagg_whisper": ("whisper_base", {}, "disagg", {"roles": pdd}),
    }
    pairs = {a: smoke_pair(torch, a) for a in
             dict.fromkeys(c[0] for c in cases.values())}
    out, stats, single = {}, {}, {}
    for name, (arch, kw, kind, skw) in cases.items():
        cfg, models, params = pairs[arch]
        prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n)))
                   for n in (5, 9, 14, 7, 12, 6)]
        sps = [SamplingParams(max_tokens=8) if i % 2 else
               SamplingParams(max_tokens=8, temperature=0.9, top_k=30,
                              seed=i) for i in range(len(prompts))]
        feats = None
        if cfg.enc_dec:
            feats = [rng.standard_normal((f, cfg.d_model), dtype=np.float32)
                     for f in (5, 16, 9, 12, 7, 16)]
            feats[2] = feats[1]              # one arena row, shared
        if name == "disagg_rewind":
            prompts, sps = [prompts[1]] * 2, [sps[0]] * 2
        if "spec" in name:        # a shared two-block prefix: partial hits
            prompts = [prompts[0][:4] * 2 + p for p in prompts]
        ecfg = EngineConfig(**geo, **kw)
        single[name] = Engine(models["cuda"], params["cuda"], ecfg,
                              device="cuda").generate(
                                  prompts, sps, encoder_features=feats)
        for d, m in models.items():
            n0 = (fa.flash_attention.launches,
                  pa.paged_decode_attention.launches,
                  pa.paged_decode_attention.k4_launches,
                  k5.rglru_scan.launches)
            n3 = pa.paged_verify_attention.launches
            if kind == "rset":
                eng = ReplicaSet(m, params[d], ecfg, dp=2, device=d, **skw)
            else:
                eng = DisaggregatedEngine(m, params[d], ecfg, dp=len(
                    skw["roles"]), device=d, **skw)
            if name == "disagg_rewind":     # the second is a full hit
                hs = [eng.add_request(prompts[0], sps[0])]
                while not hs[0].finished:
                    eng.step()
                hs.append(eng.add_request(prompts[1], sps[1]))
                eng.drain()
                out[(name, d)] = [h.token_ids for h in hs]
            else:
                out[(name, d)] = eng.generate(prompts, sps,
                                              encoder_features=feats)
            no_leaks(eng, f"parity_replica {name} {d}")
            st = eng.stats()
            row = {"dispatched": st["dispatched"],
                   "K1": fa.flash_attention.launches - n0[0],
                   "K2": pa.paged_decode_attention.launches - n0[1],
                   "K4": pa.paged_decode_attention.k4_launches - n0[2],
                   "K5": k5.rglru_scan.launches - n0[3],
                   "K3": pa.paged_verify_attention.launches - n3}
            if kind == "disagg":
                row.update({k: st["disagg"][k] for k in (
                    "exported", "imported", "stolen", "bytes_moved")})
                row["prefill_hits"] = eng.replicas[0].stats()[
                    "prefix_cache"]["hits"]
                row["graph_replays"] = [eng.replicas[r].stats()[
                    "graph_replays"] for r in eng.decode_ids]
            stats[(name, d)] = row
    roundtrip = {q: migration_roundtrip(
        torch, np, pairs["olmo_1b"][1]["cuda"], pairs["olmo_1b"][2]["cuda"],
        q, list(range(1, 12))) for q in ("int8", "fp8")}
    equal = {n: out[(n, "cpu")] == out[(n, "cuda")] for n in cases}
    equal_single = {n: out[(n, "cuda")] == single[n] for n in cases}
    emit({"phase": "parity_replica", "dtype": "float32",
          "seconds": time.monotonic() - t0, "tokens_equal": equal,
          "tokens_equal_single_engine": equal_single,
          "roundtrip_bytes_equal": roundtrip,
          "stats": {"/".join(k): v for k, v in stats.items()}})
    check(all(equal.values()), f"parity_replica: cuda tokens != cpu tokens "
          f"{equal}")
    check(all(equal_single.values()), f"parity_replica: the sets' tokens "
          f"!= a single Engine's {equal_single}")
    check(all(roundtrip.values()), f"parity_replica: a migrated packet "
          f"changed its bytes {roundtrip}")
    for (name, d), row in stats.items():
        arch, kw, kind, skw = cases[name]
        if kind == "disagg":
            check(row["exported"] > 0 and row["imported"]
                  == row["exported"] + row["stolen"],
                  f"parity_replica: {name} {d} migration counts {row}")
            check(skw.get("policy") is not first_candidate
                  or row["stolen"] >= 1,
                  f"parity_replica: {name} {d} never stole {row}")
        if d == "cpu":
            continue
        check(row["K1"] > 0, f"parity_replica: {name} launched no K1 {row}")
        # recurrentgemma's attention is windowed (rings, no block pool);
        # a speculative decode replica verifies through K3, not K2
        decode = "K4" if "kv_dtype" in kw else "K2"
        check(kw.get("backend") == "static" or arch == "recurrentgemma_2b"
              or name == "disagg_spec" or row[decode] > 0,
              f"parity_replica: {name} never launched {decode} {row}")
        check(arch != "recurrentgemma_2b" or row["K5"] > 0,
              f"parity_replica: {name} launched no K5 {row}")
        check("spec" not in name or row["K3"] > 0,
              f"parity_replica: {name} launched no K3 {row}")
        check(name != "disagg_rewind" or row["prefill_hits"] >= 1,
              f"parity_replica: the rewind case missed its full hit {row}")
        check(kind != "disagg" or "spec" in name
              or all(n > 0 for n in row["graph_replays"]),
              f"parity_replica: {name} decoded off the graph {row}")


class MigrationTimer:
    """CUDA events around every ``transport.extract_slot`` and
    ``insert_packet`` call while active (the disaggregated engine calls
    both through the module): per packet, the device time of its gather
    and of its scatter, and its payload bytes."""

    def __init__(self, torch, transport):
        self.torch, self.transport = torch, transport
        self.rows = []

    def _timed(self, fn, *args, **kw):
        ev = self.torch.cuda.Event
        start, end = ev(enable_timing=True), ev(enable_timing=True)
        start.record()
        res = fn(*args, **kw)
        end.record()
        return res, (start, end)

    def __enter__(self):
        tr = self.transport
        self.orig = extract, insert = tr.extract_slot, tr.insert_packet

        def timed_extract(backend, i, *, src=0):
            pkt, ev = self._timed(extract, backend, i, src=src)
            pkt.timing = {"bytes": pkt.payload_bytes,
                          "blocks": pkt.n_blocks, "extract": ev}
            self.rows.append(pkt.timing)
            return pkt

        def timed_insert(backend, pkt):
            j, pkt.timing["insert"] = self._timed(insert, backend, pkt)
            return j

        tr.extract_slot, tr.insert_packet = timed_extract, timed_insert
        return self

    def __exit__(self, *exc):
        self.transport.extract_slot, self.transport.insert_packet = self.orig

    def summary(self):
        """Per-packet ms (gather + scatter, with whatever host work the
        device waited on between the events), their sum, the mean chain
        and the payload rate, over the packets that landed."""
        self.torch.cuda.synchronize()
        done = [r for r in self.rows if "insert" in r]
        ms = [r["extract"][0].elapsed_time(r["extract"][1])
              + r["insert"][0].elapsed_time(r["insert"][1]) for r in done]
        nbytes = sum(r["bytes"] for r in done)
        total = sum(ms)
        return {"packets": len(done), "bytes": nbytes,
                "blocks_mean": (sum(r["blocks"] for r in done)
                                / max(len(done), 1)),
                "ms_mean": total / max(len(ms), 1),
                "ms_p50": sorted(ms)[len(ms) // 2] if ms else 0.0,
                "ms_max": max(ms, default=0.0), "ms_total": total,
                "gb_s": nbytes / (total * 1e6) if total else 0.0}


def migration_device_ms(torch, engine, n_blocks):
    """The device time of one packet's migration alone: the gather of an
    ``n_blocks`` chain and one slot's state out of the first replica's
    pools and its scatter into the second's, on blocks free after the
    run. CUDA events around the eager pair (``ms``) and around a replay
    of it captured in a graph (``graph_ms``: the host's enqueue out of
    the timing), L2 flushed; ``bound_ms`` moves each payload byte read
    and written twice (gather, then scatter) at 3.35 TB/s."""
    from repro_torch.launch.engine import transport
    from repro_torch.models import paged_kv

    src, dst = (engine.replicas[r].backend for r in (0, 1))
    mask = transport._pool_mask(src)
    ids = torch.arange(1, n_blocks + 1, device=src.device)
    box = {}

    def move():
        box["state"] = paged_kv.extract_blocks(src.pools, mask, ids, 0)
        paged_kv.insert_blocks(dst.pools, mask, box["state"], ids, 0)

    move()
    nbytes = transport._nbytes(box["state"])
    return {"blocks": n_blocks, "payload_bytes": nbytes,
            "ms": cuda_ms(torch, move), "graph_ms": graph_ms(torch, move),
            "bound_ms": bound(0, 4 * nbytes, "bfloat16")[0]}


def count_replica_launches(engine):
    """Wrap each replica's ``step`` so that K1, K2 and combine launches
    are tallied per replica from here on (the set steps its replicas one
    after another, and every launch of a step is its replica's)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    def now():
        return (fa.flash_attention.launches,
                pa.paged_decode_attention.launches,
                pa.paged_decode_combine.launches)

    per = [{"K1": 0, "K2": 0, "K2_combine": 0} for _ in engine.replicas]
    for r, eng in enumerate(engine.replicas):
        def step(eng_step=eng.step, row=per[r]):
            before = now()
            outs = eng_step()
            for k, a, b in zip(row, now(), before):
                row[k] += a - b
            return outs
        eng.step = step
    return per


def phase_replica_serve(torch, np, prompts, news, warm, base_outs, model,
                        params):
    """serve's olmo_1b, requests and geometry (8 slots a replica, block
    16, 1024 blocks, max_len 640) on ``ReplicaSet(dp=2)`` and on
    ``DisaggregatedEngine(roles=("prefill", "decode", "decode"))``: each
    engine's tokens must equal serve's (``base_outs``). Per replica:
    busy and device seconds, dispatches, K1 / K2 / combine launches, and
    on every decode replica ``graph_replays`` = its steps > 0 with no
    eager step (an import must not break the captured graph) and K2 =
    combine = layers x steps; the migrations' device time per packet and
    payload rate from CUDA events around the gather and the scatter."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.engine import (DisaggregatedEngine,
                                           EngineConfig, ReplicaSet,
                                           SamplingParams, transport)

    cfg = model.cfg
    ecfg = EngineConfig(num_slots=8, block_size=16, num_blocks=1024,
                        max_len=640)
    builds = {
        "replicaset": lambda: ReplicaSet(model, params, ecfg, dp=2,
                                         device="cuda"),
        "disagg": lambda: DisaggregatedEngine(
            model, params, ecfg, dp=3, device="cuda",
            roles=("prefill", "decode", "decode"))}
    total = {"K1": 0, "K2": 0, "K2_combine": 0}
    for name, build in builds.items():
        engine = build()
        engine.generate([warm], SamplingParams(max_tokens=2))
        engine.reset_telemetry()              # warm-up excluded
        torch.cuda.synchronize()
        fa.flash_attention.launches = 0
        zero_bodies(fa.flash_attention)
        pa.paged_decode_attention.launches = 0
        pa.paged_decode_combine.launches = 0
        per = count_replica_launches(engine)
        with MigrationTimer(torch, transport) as timer:
            t0 = time.monotonic()
            outs = engine.generate(prompts, [SamplingParams(max_tokens=n)
                                             for n in news])
            torch.cuda.synchronize()
            secs = time.monotonic() - t0
        mig = timer.summary()
        st = engine.stats()
        decode_ids = getattr(engine, "decode_ids", range(engine.dp))
        reps = []
        for r, eng in enumerate(engine.replicas):
            rs = st["per_replica"][r]
            reps.append({"role": (engine.roles[r] if name == "disagg"
                                  else "both"),
                         "dispatched": st["dispatched"][r],
                         "busy_s": st["busy_s"][r],
                         "device_s": st["device_s"][r],
                         "tokens_out": st["tokens_out"][r],
                         "steps": rs["steps"],
                         "graph_replays": rs["graph_replays"],
                         "eager_decode_steps": rs["eager_decode_steps"],
                         "prefill_calls": rs["prefill_calls"],
                         "preemptions": rs["preemptions"],
                         "launches": per[r]})
        ntok = sum(len(o) for o in outs)
        equal = outs == base_outs
        line = {"phase": "replica_serve", "config": cfg.name,
                "dtype": cfg.dtype, "engine": name, "dp": engine.dp,
                "requests": len(outs), "tokens": ntok, "seconds": secs,
                "tok_s": ntok / secs,
                "ttft_p50_s": st["latency"]["ttft"]["p50_s"],
                "tpot_p50_s": st["latency"]["tpot"]["p50_s"],
                "tokens_equal_serve": equal,
                "requests_equal_serve": sum(
                    a == b for a, b in zip(outs, base_outs)),
                "k1_launches_by_body": dict(
                    fa.flash_attention.launches_by_body),
                "replicas": reps, "blocks_used": st["blocks_used"],
                "first_tokens": outs[0][:8]}
        if name == "disagg":
            line["disagg"] = st["disagg"]
            dev = migration_device_ms(torch, engine,
                                      round(mig["blocks_mean"]))
            dev["payload_gb_s"] = dev["payload_bytes"] / (
                dev["graph_ms"] * 1e6)
            line["migration"] = {"in_loop": mig, "device": dev}
        emit(line)
        for k in total:
            total[k] += sum(rep["launches"][k] for rep in reps)
        check(all(len(o) == n for o, n in zip(outs, news)),
              f"replica_serve {name}: a request did not emit max_tokens")
        no_leaks(engine, f"replica_serve {name}")
        for r in decode_ids:
            rep = reps[r]
            check(rep["graph_replays"] == rep["steps"] > 0
                  and rep["eager_decode_steps"] == 0,
                  f"replica_serve {name}: replica {r} decoded "
                  f"{rep['graph_replays']} steps by replay, "
                  f"{rep['eager_decode_steps']} eagerly of {rep['steps']}")
            want = cfg.n_layers * rep["steps"]
            check(rep["launches"]["K2"] == rep["launches"]["K2_combine"]
                  == want, f"replica_serve {name}: replica {r} K2 / "
                  f"combine {rep['launches']}, expected {want}")
        check(fa.flash_attention.launches_by_body["wgmma"] > 0,
              f"replica_serve {name}: no prefill ran K1's tensor-core body")
        if name == "disagg":
            dg = st["disagg"]
            pre = reps[engine.prefill_ids[0]]
            check(pre["launches"]["K1"] > 0 and pre["launches"]["K2"] == 0
                  and pre["steps"] == 0,
                  f"replica_serve disagg: the prefill replica {pre}")
            check(dg["exported"] == len(prompts) and dg["imported"]
                  == dg["exported"] + dg["stolen"] == mig["packets"]
                  and dg["packets_inflight"] == 0,
                  f"replica_serve disagg: migrations {dg} {mig}")
        else:
            check(all(rep["dispatched"] > 0 and rep["launches"]["K1"] > 0
                      for rep in reps),
                  f"replica_serve replicaset: a replica idled {reps}")
        check(equal, f"replica_serve {name}: tokens differ from serve's "
              f"on {len(outs) - line['requests_equal_serve']} requests")
        del engine
        torch.cuda.empty_cache()
    return {f"{k}_replica": n for k, n in total.items()}


def phase_parity_recurrent(torch, np):
    """recurrentgemma_2b and h2o_danube_3_4b smoke in f32, cuda against
    cpu, same weights: five prompts of 6-20 tokens, 16 new each, on 3
    slots and 13 usable blocks (the pool preempts; every 16-row ring
    wraps). Greedy, seeded (threefry), speculative (ngram, K 3) and,
    for recurrentgemma, an int8 pool: tokens equal, no leak, and every
    cuda run launches K1 (windowed prefill) and, for recurrentgemma, K5."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as k5
    from repro_torch.launch.engine import Engine, EngineConfig, SamplingParams
    from repro_torch.models import weights
    from repro_torch.models.model import Model

    rng = np.random.default_rng(SEED + 3)
    prompts = [list(map(int, rng.integers(0, 256, n)))
               for n in (9, 14, 20, 6, 17)]
    geo = dict(num_slots=3, block_size=4, num_blocks=14, max_len=64)
    greedy = [SamplingParams(max_tokens=16)] * len(prompts)
    seeded = [SamplingParams(max_tokens=16, temperature=0.9, top_k=30,
                             top_p=0.95, seed=s) for s in range(len(prompts))]
    runs = {"greedy": ({}, greedy), "seeded": ({}, seeded),
            "spec3": ({"spec_tokens": 3}, greedy)}
    out, stats = {}, {}
    for arch in ("recurrentgemma_2b", "h2o_danube_3_4b"):
        cfg = get_config(arch).smoke()
        models = {d: Model(cfg, device=d) for d in ("cpu", "cuda")}
        params = {"cpu": models["cpu"].init(seed=SEED)}
        params["cuda"] = weights.to_device(params["cpu"], "cuda")
        arch_runs = dict(runs)
        if arch == "recurrentgemma_2b":
            arch_runs["int8"] = ({"kv_dtype": "int8"}, greedy)
        for name, (kw, sp) in arch_runs.items():
            for d, m in models.items():
                n0 = (fa.flash_attention.launches, k5.rglru_scan.launches)
                eng = Engine(m, params[d], EngineConfig(**geo, **kw),
                             device=d)
                key = (arch, name, d)
                out[key] = eng.generate(prompts, sp)
                st = eng.stats()
                stats[key] = {
                    "blocks_used": st["blocks_used"],
                    "preemptions": st["preemptions"],
                    "K1": fa.flash_attention.launches - n0[0],
                    "K5": k5.rglru_scan.launches - n0[1]}
    pairs = {(a, n) for a, n, _ in out}
    equal = {f"{a}/{n}": out[(a, n, "cpu")] == out[(a, n, "cuda")]
             for a, n in sorted(pairs)}
    emit({"phase": "parity_recurrent", "dtype": "float32",
          "tokens_equal": equal,
          "stats": {"/".join(k): v for k, v in stats.items()}})
    check(all(equal.values()), f"parity_recurrent: cuda tokens != cpu "
          f"tokens {equal}")
    for key, st in stats.items():
        check(st["blocks_used"] == 0, f"parity_recurrent: {key} leaked")
        check(key[1] not in ("greedy", "int8") or st["preemptions"] >= 1,
              f"parity_recurrent: {key} never preempted")
        check(key[2] == "cpu" or (st["K1"] > 0 and (
            key[0] != "recurrentgemma_2b" or st["K5"] > 0)),
            f"parity_recurrent: {key} never launched K1 / K5 {st}")


def phase_parity_overlap_static(torch, np):
    """olmo_1b and recurrentgemma_2b smoke in f32, cuda against cpu, same
    weights: ``overlap=True`` on a pool small enough to preempt, with
    seeded rows beside greedy ones (the sampled graph), and the static
    backend over more requests than slots. Tokens equal on both devices,
    and the overlap runs equal a cpu run with overlap off; no leak, and
    every cuda decode step a graph replay."""
    from repro_torch.configs import get_config
    from repro_torch.launch.engine import Engine, EngineConfig, SamplingParams
    from repro_torch.models import weights
    from repro_torch.models.model import Model

    rng = np.random.default_rng(SEED + 5)
    prompts = [list(map(int, rng.integers(0, 256, n)))
               for n in (9, 14, 20, 6, 17, 11)]
    sps = [SamplingParams(max_tokens=16) if i % 2 else
           SamplingParams(max_tokens=16, temperature=0.9, top_k=30,
                          top_p=0.95, seed=i) for i in range(len(prompts))]
    runs = {"overlap": dict(num_slots=3, block_size=4, num_blocks=14,
                            max_len=64, overlap=True),
            "overlap_off": dict(num_slots=3, block_size=4, num_blocks=14,
                                max_len=64),
            "static": dict(backend="static", num_slots=4, block_size=4,
                           max_len=64)}
    out, stats = {}, {}
    for arch in ("olmo_1b", "recurrentgemma_2b"):
        cfg = get_config(arch).smoke()
        models = {d: Model(cfg, device=d) for d in ("cpu", "cuda")}
        params = {"cpu": models["cpu"].init(seed=SEED)}
        params["cuda"] = weights.to_device(params["cpu"], "cuda")
        for name, kw in runs.items():
            for d, m in models.items():
                if name == "overlap_off" and d == "cuda":
                    continue
                eng = Engine(m, params[d], EngineConfig(**kw), device=d)
                out[(arch, name, d)] = eng.generate(prompts, sps)
                st = eng.stats()
                stats[(arch, name, d)] = {
                    k: st[k] for k in ("steps", "preemptions", "blocks_used",
                                       "graph_replays", "batches")
                    if k in st}
    equal = {f"{a}/{n}": out[(a, n, "cuda")] == out[(a, n, "cpu")]
             for a in ("olmo_1b", "recurrentgemma_2b")
             for n in ("overlap", "static")}
    identity = {a: out[(a, "overlap", "cuda")] == out[(a, "overlap_off",
                                                       "cpu")]
                for a in ("olmo_1b", "recurrentgemma_2b")}
    emit({"phase": "parity_overlap_static", "dtype": "float32",
          "tokens_equal": equal, "overlap_equals_off": identity,
          "stats": {"/".join(k): v for k, v in stats.items()}})
    check(all(equal.values()), f"parity_overlap_static: cuda tokens != "
          f"cpu tokens {equal}")
    check(all(identity.values()), f"parity_overlap_static: overlap "
          f"tokens != overlap-off tokens {identity}")
    for key, st in stats.items():
        check(st.get("blocks_used", 0) == 0,
              f"parity_overlap_static: {key} leaked")
        if key[1] == "overlap":
            check(st["preemptions"] >= 1,
                  f"parity_overlap_static: {key} never preempted")
            check(key[2] == "cpu" or st["graph_replays"] == st["steps"] > 0,
                  f"parity_overlap_static: {key} decoded off the graph")
        if key[1] == "static":
            check(st["batches"] >= 2,
                  f"parity_overlap_static: {key} ran one batch")


def long_prompts(np):
    """recurrent_serve's two prompts past the 2048-token window."""
    rng = np.random.default_rng(SEED + 4)
    return [list(map(int, rng.integers(0, 256000, LONG))) for _ in range(2)]


def phase_recurrent_serve(torch, np, prompts, news, warm, profile):
    """Full-width recurrentgemma_2b in bf16 through ``Engine``: two
    LONG-token prompts first (one (2, 2560) prefill: K1's window bites,
    the rings wrap in prefill and stay wrapped through decode), then the
    serve phase's 16 requests (their first admission is one (8, 512)
    prefill through K5 and K1)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as k5
    from repro_torch.launch.engine import Engine, EngineConfig, SamplingParams
    from repro_torch.launch.engine.api import prefill_bucket
    from repro_torch.models import transformer
    from repro_torch.models.model import Model

    cfg = get_config("recurrentgemma_2b")
    model = Model(cfg, device="cuda")
    params = model.init(seed=SEED)
    engine = Engine(model, params, EngineConfig(
        num_slots=8, block_size=16, num_blocks=1024, max_len=2560),
        device="cuda")
    engine.generate([warm], SamplingParams(max_tokens=2))
    engine.backend.reset_telemetry()              # warm-up excluded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reqs = long_prompts(np) + prompts
    budgets = [LONG_NEW, LONG_NEW] + news

    fa.flash_attention.launches = 0
    zero_bodies(fa.flash_attention)
    k5.rglru_scan.launches = 0
    zero_bodies(k5.rglru_scan)
    k5.rglru_scan.launches_by_shape = {}
    t0 = time.monotonic()
    outs = engine.generate(reqs, [SamplingParams(max_tokens=n)
                                  for n in budgets])
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    by_shape = dict(k5.rglru_scan.launches_by_shape)
    # the long admission: both LONG prompts in one prefill of the bucket
    # that holds them, through every RG-LRU layer
    rg_layers = sum(cfg.block_pattern[i % len(cfg.block_pattern)] == "rglru"
                    for i in range(cfg.n_layers))
    long_key = "x".join(map(str, (2, prefill_bucket(LONG, 16, 2560),
                                  cfg.rnn_width)))
    long_bodies = by_shape.get(long_key, {})
    n_long = sum(long_bodies.values())
    launches = {"K1": fa.flash_attention.launches,
                "K5": k5.rglru_scan.launches - n_long, "K5_long": n_long}
    k1_bodies = dict(fa.flash_attention.launches_by_body)
    k5_bodies = dict(k5.rglru_scan.launches_by_body)
    st = engine.stats()
    ntok = sum(len(o) for o in outs)
    ring = engine.backend.pools["g0"]["p2"]["k"]  # (count, slots, 2048, ..)
    logits = model.prefill(params, {"tokens": torch.tensor(
        [reqs[0][:16]], device="cuda")}, transformer.RunCtx())[0]
    emit({"phase": "recurrent_serve", "config": cfg.name, "dtype": cfg.dtype,
          "overlap": False, "requests": len(outs), "tokens": ntok,
          "seconds": secs, "tok_s": ntok / secs, "launches": launches,
          "k1_launches_by_body": k1_bodies,
          "k5_launches_by_body": k5_bodies,
          "k5_launches_by_shape": by_shape,
          "steps": st["steps"], "graph_replays": st["graph_replays"],
          "eager_decode_steps": st["eager_decode_steps"],
          "decode_device_s": st["device_s"],
          "step_ms": 1e3 * st["device_s"] / max(st["steps"], 1),
          "prefill_calls": st["prefill_calls"],
          "prefill_tokens": st["prefill_tokens"],
          "preemptions": st["preemptions"], "blocks_used": st["blocks_used"],
          "ring_rows": ring.shape[2],
          "bucketed_prefill": st["bucketed_prefill"],
          "prefix_cache_enabled": st["prefix_cache"]["enabled"],
          "ttft_p50_s": st["latency"]["ttft"]["p50_s"],
          "tpot_p50_s": st["latency"]["tpot"]["p50_s"],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "first_tokens": outs[0][:8]})
    check(all(len(o) == n for o, n in zip(outs, budgets)),
          "recurrent_serve: a request did not emit max_tokens tokens")
    check(all(0 <= t < cfg.vocab_size for o in outs for t in o),
          "recurrent_serve: token id out of range")
    check(launches["K5"] > 0 and launches["K1"] > 0,
          f"recurrent_serve: a kernel was never launched {launches}")
    check(long_bodies == {"ring": rg_layers},
          f"recurrent_serve: the long admission ({long_key}) launched K5 "
          f"{long_bodies}, expected {rg_layers} on the ring body")
    check(k1_bodies["wgmma"] > 0,
          f"recurrent_serve: no prefill ran K1's tensor-core body "
          f"{k1_bodies}")
    check(ring.shape[2] == cfg.local_window < LONG,
          f"recurrent_serve: ring of {ring.shape[2]} rows does not wrap")
    check(st["blocks_used"] == 0,
          f"recurrent_serve: {st['blocks_used']} blocks leaked")
    check(tuple(logits.shape) == (1, 16, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          "recurrent_serve: bad prefill logits")
    check(st["graph_replays"] == st["steps"] > 0
          and st["eager_decode_steps"] == 0,
          f"recurrent_serve: {st['graph_replays']} replays, "
          f"{st['eager_decode_steps']} eager steps in {st['steps']} steps")

    # the same requests with overlap on: equal tokens, the same K5 work
    ov = Engine(model, params, EngineConfig(
        num_slots=8, block_size=16, num_blocks=1024, max_len=2560,
        overlap=True), device="cuda")
    ov.generate([warm], SamplingParams(max_tokens=2))
    ov.backend.reset_telemetry()
    torch.cuda.synchronize()
    k5.rglru_scan.launches = 0
    fa.flash_attention.launches = 0
    t0 = time.monotonic()
    ov_outs = ov.generate(reqs, [SamplingParams(max_tokens=n)
                                 for n in budgets])
    torch.cuda.synchronize()
    ov_secs = time.monotonic() - t0
    ov_st = ov.stats()
    ov_launches = {"K1": fa.flash_attention.launches,
                   "K5": k5.rglru_scan.launches}
    emit({"phase": "recurrent_serve", "config": cfg.name,
          "dtype": cfg.dtype, "overlap": True, "requests": len(ov_outs),
          "tokens": ntok, "seconds": ov_secs, "tok_s": ntok / ov_secs,
          "launches": ov_launches, "steps": ov_st["steps"],
          "graph_replays": ov_st["graph_replays"],
          "eager_decode_steps": ov_st["eager_decode_steps"],
          "decode_device_s": ov_st["device_s"],
          "step_ms": 1e3 * ov_st["device_s"] / max(ov_st["steps"], 1),
          "blocks_used": ov_st["blocks_used"],
          "ttft_p50_s": ov_st["latency"]["ttft"]["p50_s"],
          "tpot_p50_s": ov_st["latency"]["tpot"]["p50_s"],
          "tokens_equal_overlap_off": ov_outs == outs})
    check(ov_outs == outs,
          "recurrent_serve: overlap=True tokens differ from overlap off")
    check(ov_launches == {"K1": launches["K1"],
                          "K5": launches["K5"] + launches["K5_long"]},
          f"recurrent_serve: overlap launched {ov_launches}, off "
          f"{launches}")
    check(ov_st["graph_replays"] == ov_st["steps"] > 0
          and ov_st["eager_decode_steps"] == 0
          and ov_st["blocks_used"] == 0,
          f"recurrent_serve overlap: replays / eager / leaked {ov_st}")
    del ov
    if profile:
        phase_profile(torch, engine, prompts, news, cfg.name)
    return launches


# ---------------------------------------------------------------------------
# xLSTM and MoE: parity_xlstm_moe, xlstm_serve, moe_serve
# ---------------------------------------------------------------------------


def phase_parity_xlstm_moe(torch, np):
    """xlstm_1_3b, qwen3_moe_30b_a3b and kimi_k2_1t_a32b smoke in f32,
    cuda against cpu, same weights: five prompts behind a shared
    two-block prefix (and a repeat: prefix hits for the MoE configs), 16
    new tokens each on 3 slots and 13 usable blocks (the pool preempts).
    Greedy, seeded (threefry), speculative (ngram, K 3), fp8 pools,
    ``overlap=True`` and ``backend="static"``: tokens equal on both
    devices, no leak, and every cuda decode step of a paged non-spec
    engine a graph replay."""
    from repro_torch.configs import get_config
    from repro_torch.launch.engine import Engine, EngineConfig, SamplingParams
    from repro_torch.models import weights
    from repro_torch.models.model import Model

    rng = np.random.default_rng(SEED + 6)
    common = list(map(int, rng.integers(0, 256, 8)))
    prompts = [common + list(map(int, rng.integers(0, 256, n)))
               for n in (1, 6, 12, 3, 9)]
    prompts.append(list(prompts[1]))
    geo = dict(num_slots=3, block_size=4, num_blocks=14, max_len=64)
    greedy = [SamplingParams(max_tokens=16)] * len(prompts)
    seeded = [SamplingParams(max_tokens=16, temperature=0.9, top_k=30,
                             top_p=0.95, seed=s) for s in range(len(prompts))]
    runs = {"greedy": ({}, greedy), "seeded": ({}, seeded),
            "spec3": ({"spec_tokens": 3}, greedy),
            "fp8": ({"kv_dtype": "fp8"}, greedy),
            "overlap": ({"overlap": True}, seeded),
            "static": ({"backend": "static", "num_slots": 4}, greedy)}
    out, stats = {}, {}
    t0 = time.monotonic()
    for arch in ("xlstm_1_3b", "qwen3_moe_30b_a3b", "kimi_k2_1t_a32b"):
        cfg = get_config(arch).smoke()
        models = {d: Model(cfg, device=d) for d in ("cpu", "cuda")}
        params = {"cpu": models["cpu"].init(seed=SEED)}
        params["cuda"] = weights.to_device(params["cpu"], "cuda")
        for name, (kw, sp) in runs.items():
            for d, m in models.items():
                eng = Engine(m, params[d], EngineConfig(**{**geo, **kw}),
                             device=d)
                key = (arch, name, d)
                out[key] = eng.generate(prompts, sp)
                st = eng.stats()
                stats[key] = {k: st[k] for k in (
                    "steps", "preemptions", "blocks_used", "graph_replays",
                    "eager_decode_steps", "batches") if k in st}
                if "prefix_cache" in st:
                    stats[key]["prefix_hits"] = st["prefix_cache"]["hits"]
    equal = {f"{a}/{n}": out[(a, n, "cpu")] == out[(a, n, "cuda")]
             for a, n, _ in out}
    emit({"phase": "parity_xlstm_moe", "dtype": "float32",
          "seconds": time.monotonic() - t0, "tokens_equal": equal,
          "stats": {"/".join(k): v for k, v in stats.items()}})
    check(all(equal.values()), f"parity_xlstm_moe: cuda tokens != cpu "
          f"tokens {equal}")
    for (arch, name, d), st in stats.items():
        key = f"{arch}/{name}/{d}"
        check(st.get("blocks_used", 0) == 0,
              f"parity_xlstm_moe: {key} leaked")
        if name == "greedy":
            check(st["preemptions"] >= 1,
                  f"parity_xlstm_moe: {key} never preempted")
        if d == "cuda" and name not in ("spec3", "static"):
            check(st["graph_replays"] == st["steps"] > 0
                  and st["eager_decode_steps"] == 0,
                  f"parity_xlstm_moe: {key} decoded off the graph {st}")
        if arch != "xlstm_1_3b" and name not in ("static",):
            check(st["prefix_hits"] >= 1,
                  f"parity_xlstm_moe: {key} never hit the prefix cache")


def state_bytes_per_slot(pools, num_slots):
    """Bytes of decode state a slot holds, for a model whose whole paged
    tree is per-slot state (xLSTM: mLSTM C / n / m and conv tails, sLSTM
    carries; no layer keeps a block pool)."""
    return sum(t.numel() * t.element_size() for group in pools.values()
               for leaf in group.values() for t in leaf.values()) / num_slots


def serve_pair(torch, model, params, prompts, news, warm, geo, phase):
    """Serve the requests on a paged engine with overlap off, then on a
    second with ``overlap=True``: (engines, per-turn (outputs, seconds,
    launches, K1 bodies, stats)). Each turn sets the K1 / K2 / combine
    counters to 0 just before its requests."""
    from repro_torch.launch.engine import Engine, EngineConfig

    engines, turns = {}, {}
    for overlap in (False, True):
        engines[overlap] = Engine(model, params, EngineConfig(
            **geo, overlap=overlap), device="cuda")
        turns[overlap] = serve_turn(torch, engines[overlap], prompts, news,
                                    warm)
        st = turns[overlap][4]
        check(st["graph_replays"] == st["steps"] > 0
              and st["eager_decode_steps"] == 0,
              f"{phase}: overlap={overlap} ran {st['graph_replays']} "
              f"replays and {st['eager_decode_steps']} eager steps in "
              f"{st['steps']} steps")
        check(st["blocks_used"] == 0,
              f"{phase}: overlap={overlap} leaked {st['blocks_used']} "
              "blocks")
    check(turns[True][0] == turns[False][0],
          f"{phase}: overlap=True tokens differ from overlap off")
    return engines, turns


def turn_line(phase, cfg, overlap, turn, news):
    outs, secs, runs, k1_bodies, st = turn
    check(all(len(o) == n for o, n in zip(outs, news)),
          f"{phase}: a request did not emit max_tokens tokens")
    check(all(0 <= t < cfg.vocab_size for o in outs for t in o),
          f"{phase}: token id out of range")
    ntok = sum(len(o) for o in outs)
    return {"phase": phase, "config": cfg.name, "dtype": cfg.dtype,
            "overlap": overlap, "requests": len(outs), "tokens": ntok,
            "seconds": secs, "tok_s": ntok / secs,
            "steps": st["steps"], "graph_replays": st["graph_replays"],
            "eager_decode_steps": st["eager_decode_steps"],
            "decode_device_s": st["device_s"],
            "decode_device_ms_per_step": 1e3 * st["device_s"]
            / max(st["steps"], 1),
            "prefill_calls": st["prefill_calls"],
            "prefill_tokens": st["prefill_tokens"],
            "preemptions": st["preemptions"],
            "blocks_used": st["blocks_used"],
            "ttft_p50_s": st["latency"]["ttft"]["p50_s"],
            "tpot_p50_s": st["latency"]["tpot"]["p50_s"],
            "first_tokens": outs[0][:8]}


def admission_s(torch, model, params, prompts):
    """Seconds of the serve workload's first admission alone: one (8,
    512) right-padded prefill of its first HALF prompts, synced."""
    from repro_torch.models import transformer

    toks = torch.zeros((HALF, 512), dtype=torch.int32, device="cuda")
    lens = torch.tensor([len(p) for p in prompts[:HALF]], dtype=torch.int32,
                        device="cuda")
    for r, p in enumerate(prompts[:HALF]):
        toks[r, :len(p)] = torch.tensor(p, dtype=torch.int32)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    logits, _ = model.prefill(params, {"tokens": toks}, transformer.RunCtx(),
                              max_len=512, length=lens, rows=lens - 1)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    check(tuple(logits.shape) == (HALF, model.cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          "admission: bad prefill logits")
    return secs


# xlstm_serve and train_families: xlstm_1_3b's depth, cut from 48 to keep
# the script inside its time (two of its 7 mLSTM + 1 sLSTM groups; the
# sLSTM's cells run one by one, most of a training step)
XLSTM_LAYERS = 16


def phase_xlstm_serve(torch, np, prompts, news, warm, profile):
    """xlstm_1_3b at full width in bf16, depth cut to XLSTM_LAYERS of 48
    (14 mLSTM, 2 sLSTM; d_model 2048, 4 heads x 512; seeded random
    weights) serves the 16 requests with overlap off, then on (equal
    tokens), then on ``backend="static"``. No port kernel runs on this
    path (mLSTM and sLSTM are plain torch, as in JAX); every decode step
    is a replay of the captured step."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.engine import Engine, EngineConfig, SamplingParams
    from repro_torch.models.model import Model

    t0 = time.monotonic()
    cfg = dataclasses.replace(get_config("xlstm_1_3b"), n_layers=XLSTM_LAYERS)
    model = Model(cfg, device="cuda")
    params = model.init(seed=SEED)
    geo = dict(num_slots=8, block_size=16, num_blocks=1024, max_len=640)
    adm = admission_s(torch, model, params, prompts)
    torch.cuda.reset_peak_memory_stats()
    engines, turns = serve_pair(torch, model, params, prompts, news, warm,
                                geo, "xlstm_serve")
    per_slot = state_bytes_per_slot(engines[False].backend.pools,
                                    geo["num_slots"])
    for overlap, turn in turns.items():
        emit({**turn_line("xlstm_serve", cfg, overlap, turn, news),
              "launches": {k: turn[2][k] for k in ("K1", "K2")},
              "admission_8x512_s": adm, "state_bytes_per_slot": per_slot,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if profile:
        phase_profile(torch, engines[False], prompts, news,
                      f"{cfg.name} xlstm_serve")
    del engines
    static = Engine(model, params, EngineConfig(
        backend="static", num_slots=8, block_size=16, max_len=640),
        device="cuda")
    static.generate([warm], SamplingParams(max_tokens=2))
    static.backend.reset_telemetry()
    torch.cuda.synchronize()
    ts = time.monotonic()
    outs = static.generate(prompts, [SamplingParams(max_tokens=n)
                                     for n in news])
    torch.cuda.synchronize()
    secs = time.monotonic() - ts
    st = static.stats()
    ntok = sum(len(o) for o in outs)
    emit({"phase": "xlstm_serve", "config": cfg.name, "dtype": cfg.dtype,
          "backend": "static", "requests": len(outs), "tokens": ntok,
          "seconds": secs, "tok_s": ntok / secs, "steps": st["steps"],
          "batches": st["batches"],
          "ttft_p50_s": st["latency"]["ttft"]["p50_s"],
          "tpot_p50_s": st["latency"]["tpot"]["p50_s"],
          "phase_seconds": time.monotonic() - t0})
    check(all(len(o) == n for o, n in zip(outs, news))
          and all(0 <= t < cfg.vocab_size for o in outs for t in o)
          and st["batches"] == 2,
          f"xlstm_serve static: bad outputs or {st['batches']} batches")


MOE_LAYERS = 12                     # moe_serve: depth cut from 48


def phase_moe_serve(torch, np, prompts, news, warm, profile):
    """qwen3_moe_30b_a3b at full width in bf16 (d_model 2048, 32 / 4
    heads x 128 with qk_norm, 128 experts top-8 of width 768, vocab
    151936), depth cut to MOE_LAYERS of 48 (all 48 would be ~61 GB of
    random init), serves the 16 requests with overlap off, then on
    (equal tokens). K1 runs every prefill (GQA 32 / 4), K2 and its
    combine one launch a layer per decode step by replay; the dropless
    MoE reads every expert each step."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    t0 = time.monotonic()
    full = get_config("qwen3_moe_30b_a3b")
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    model = Model(cfg, device="cuda")
    params = model.init(seed=SEED)
    geo = dict(num_slots=8, block_size=16, num_blocks=1024, max_len=640)
    adm = admission_s(torch, model, params, prompts)
    torch.cuda.reset_peak_memory_stats()
    engines, turns = serve_pair(torch, model, params, prompts, news, warm,
                                geo, "moe_serve")
    launches = {}
    for overlap, turn in turns.items():
        runs, k1_bodies, st = turn[2], turn[3], turn[4]
        decode_launches(st, runs, cfg)
        check(runs["K1"] > 0 and k1_bodies["wgmma"] > 0,
              f"moe_serve: no prefill ran K1's tensor-core body "
              f"{k1_bodies}")
        launches[overlap] = {k: runs[k] for k in ("K1", "K2", "K2_combine")}
        emit({**turn_line("moe_serve", cfg, overlap, turn, news),
              "layers": f"{MOE_LAYERS} of {full.n_layers} (depth cut)",
              "launches": launches[overlap],
              "k1_launches_by_body": k1_bodies,
              "admission_8x512_s": adm,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              **({"phase_seconds": time.monotonic() - t0} if overlap
                 else {})})
    if profile:
        phase_profile(torch, engines[False], prompts, news,
                      f"{cfg.name} moe_serve ({MOE_LAYERS} layers)")
    return launches[False]


# ---------------------------------------------------------------------------
# the encoder-decoder (whisper_base) and the VLM (qwen2-vl)
# ---------------------------------------------------------------------------


def encdec_workload(np, d_model):
    """encdec_serve's 16 requests, a transcription service's traffic:
    12 carry a full 30 s window (ENC_FRAMES frames), 4 a file's last
    window (300-1499 frames); 10 prompts are the 4-token
    start-of-transcript sequence, 6 carry the previous window's text
    (64-192 tokens); 48-128 new tokens each. The first HALF are short
    prompts over full windows (one (8, 1500-frame) admission), among
    them two adjacent pairs that submit one array each (best-of-2,
    seeded, temperature 0.7); the rest are greedy. Frames are seeded
    N(0, 1) features (the frontend is a stub). Returns (prompts,
    features, max_tokens, sampling kwargs per request)."""
    rng = np.random.default_rng(SEED + 9)
    short = [True] * HALF + [True, False, False, True, False, False, False,
                             False]
    full = [True] * HALF + [False, True, False, True, True, False, True,
                            False]
    prompts = [SOT if s else SOT + list(map(int, rng.integers(
        0, 50257, int(rng.integers(64, 193)) - len(SOT)))) for s in short]
    feats = [rng.standard_normal(
        (ENC_FRAMES if f else int(rng.integers(300, ENC_FRAMES)), d_model),
        dtype=np.float32) for f in full]
    feats[3], feats[5] = feats[2], feats[4]
    news = [int(n) for n in rng.integers(48, 129, len(prompts))]
    samp = [dict(temperature=0.7, seed=i) if i in (2, 3, 4, 5) else {}
            for i in range(len(prompts))]
    return prompts, feats, news, samp


def smoke_pair(torch, arch):
    """``arch``'s smoke config in f32 on cpu and cuda, the same weights
    (the port's init from SEED; q/k/v biases redrawn nonzero where the
    config has them, so the bias path is exercised)."""
    from repro_torch.configs import get_config
    from repro_torch.models import weights
    from repro_torch.models.model import Model

    cfg = get_config(arch).smoke()
    models = {d: Model(cfg, device=d) for d in ("cpu", "cuda")}
    params = {"cpu": models["cpu"].init(seed=SEED)}
    gen = torch.Generator().manual_seed(SEED)

    def biased(tree):
        return {k: (torch.randn(v.shape, generator=gen) * 0.5
                    if k in ("bq", "bk", "bv") else
                    biased(v) if isinstance(v, dict) else v)
                for k, v in tree.items()}
    params["cpu"] = biased(params["cpu"])
    params["cuda"] = weights.to_device(params["cpu"], "cuda")
    return cfg, models, params


def vlm_batch(torch, cfg, B, S, device, gen):
    """Tokens (B, S), visual embeddings for the first ``visual_prefix``
    positions and their M-RoPE ids: the prefix on a square patch grid
    (t 0, h row, w column), text after it at grid + j on all three
    streams. Returns (batch, the next text id)."""
    P = cfg.visual_prefix
    grid = math.isqrt(P)
    i = torch.arange(S)
    text = grid + (i - P)
    pos = torch.stack([torch.where(i < P, 0, text),
                       torch.where(i < P, i // grid, text),
                       torch.where(i < P, i % grid, text)])
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen, dtype=torch.int32),
             "visual_embeds": torch.randn((B, P, cfg.d_model),
                                          generator=gen),
             "mrope_positions": pos[:, None].expand(3, B, S).contiguous()}
    return {k: v.to(device) for k, v in batch.items()}, grid + S - P


def dense_greedy(torch, model, params, batch, max_len, steps, rows=True,
                 mrope_next=None, after_prefill=None):
    """Dense prefill of ``batch`` then ``steps`` greedy decode steps at
    continuing positions (with ``mrope_next``, all three M-RoPE streams
    at the text id from there); ``after_prefill()`` runs between the
    two. Returns (prefill logits at the last position, (B, steps + 1)
    tokens on the device, the last step's logits)."""
    from repro_torch.models import transformer

    ctx = transformer.RunCtx()
    B, S = batch["tokens"].shape
    dev = batch["tokens"].device
    logits, cache = model.prefill(
        params, batch, ctx, max_len=max_len,
        rows=torch.full((B,), S - 1, device=dev) if rows else None)
    if not rows:
        logits = logits[:, -1]
    first = logits
    toks = [logits.argmax(-1).int()]
    if after_prefill is not None:
        after_prefill()
    for t in range(steps):
        kw = {} if mrope_next is None else {"mrope_positions": torch.full(
            (3, B, 1), mrope_next + t, dtype=torch.int32, device=dev)}
        logits, cache = model.decode_step(
            params, cache, toks[-1][:, None],
            torch.full((B,), S + t, device=dev), ctx, **kw)
        toks.append(logits.argmax(-1).int())
    return first, torch.stack(toks, 1), logits


def encdec_oracle(torch, model, params, prompts, feats, max_len, steps):
    """The dense greedy oracle, one request at a time: exact-length
    prefill (encoder and cross-attention through K1) and ``steps - 1``
    decode steps. Returns the token lists."""
    return [dense_greedy(torch, model, params, {
        "tokens": torch.tensor([prompt], dtype=torch.int32, device="cuda"),
        "frames": torch.from_numpy(f)[None].cuda()}, max_len,
        steps - 1)[1][0].tolist() for prompt, f in zip(prompts, feats)]


def admission_gap(torch, np, model, params, prompts, feats):
    """Largest logits gap at each request's last prompt position between
    the dense prefill (exact length: the encoder through K1) and the
    engine's admission (``prefill_paged_encdec``: the masked plain
    encoder), on one right-padded batch over scratch pools."""
    from repro_torch.models import paged_kv, transformer

    ctx = transformer.RunCtx()
    N = len(prompts)
    Sb = max(len(p) for p in prompts)
    Fb = max(f.shape[0] for f in feats)
    bs = 4
    nbp = -(-Sb // bs)
    layout = paged_kv.PagedLayout(num_slots=N, num_blocks=N * nbp + 1,
                                  block_size=bs, max_len=nbp * bs)
    toks = np.zeros((N, Sb), np.int32)
    frames = np.zeros((N, Fb, model.cfg.d_model), np.float32)
    for r, (p, f) in enumerate(zip(prompts, feats)):
        toks[r, :len(p)] = p
        frames[r, :len(f)] = f
    ids = (np.arange(N * nbp, dtype=np.int32) + 1).reshape(N, nbp)
    args = [torch.from_numpy(a).cuda() for a in (
        toks, frames, np.asarray([len(f) for f in feats], np.int32),
        np.asarray([len(p) for p in prompts], np.int32), ids,
        np.arange(1, N + 1, dtype=np.int32))]
    rows, _ = model.prefill_paged_encdec(
        params, model.init_paged_cache(layout), *args, ctx)
    gap = 0.0
    for r, (p, f) in enumerate(zip(prompts, feats)):
        dense, _ = model.prefill(params, {
            "tokens": torch.tensor([p], dtype=torch.int32, device="cuda"),
            "frames": torch.from_numpy(f)[None].cuda()}, ctx)
        gap = max(gap, (dense[0, -1] - rows[r]).abs().max().item())
    return gap


def phase_parity_encdec_vlm(torch, np):
    """whisper_base and qwen2_vl_2b smoke in f32, cuda against cpu, the
    same weights. whisper through the Engine on 8 usable blocks (the
    pool preempts), requests 1 and 2 on one feature array: greedy,
    seeded, and seeded with ``overlap=True``; tokens equal on both
    devices, every cuda step a replay, no block or arena row left in
    use. The greedy engine on cuda equals the dense prefill +
    decode_step oracle on cuda (JAX's own contract), beside the largest
    logits gap between the two admissions (the dense encoder runs K1,
    the engine's the masked plain one). qwen2-vl: a dense prefill with
    visual embeddings and M-RoPE ids, then 8 greedy decode steps;
    tokens equal on both devices."""
    from repro_torch.launch.engine import Engine, EngineConfig, SamplingParams

    t0 = time.monotonic()
    cfg, models, params = smoke_pair(torch, "whisper_base")
    rng = np.random.default_rng(SEED + 8)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n)))
               for n in (3, 7, 5, 9, 4, 6)]
    feats = [rng.standard_normal((f, cfg.d_model), dtype=np.float32)
             for f in (5, 16, 9, 12, 7, 16)]
    feats[2] = feats[1]           # one admission run: one arena row
    greedy = [SamplingParams(max_tokens=10)] * len(prompts)
    seeded = [SamplingParams(max_tokens=10, temperature=8.0, top_k=32,
                             seed=s) for s in range(len(prompts))]
    geo = dict(num_slots=4, block_size=4, num_blocks=9, max_len=32)
    runs = {"greedy": (False, greedy), "seeded": (False, seeded),
            "overlap": (True, seeded)}
    out, stats = {}, {}
    for name, (overlap, sps) in runs.items():
        for d, m in models.items():
            eng = Engine(m, params[d], EngineConfig(**geo, overlap=overlap),
                         device=d)
            out[(name, d)] = eng.generate(prompts, sps,
                                          encoder_features=feats)
            st = eng.stats()
            stats[f"{name}/{d}"] = {
                **{k: st[k] for k in ("steps", "preemptions", "blocks_used",
                                      "graph_replays",
                                      "eager_decode_steps")},
                "cross_arena": st["cross_arena"]}
    oracle = encdec_oracle(torch, models["cuda"], params["cuda"], prompts,
                           feats, geo["max_len"], 10)
    gap = admission_gap(torch, np, models["cuda"], params["cuda"], prompts,
                        feats)
    equal = {n: out[(n, "cpu")] == out[(n, "cuda")] for n in runs}

    vcfg, vmodels, vparams = smoke_pair(torch, "qwen2_vl_2b")
    vout, vfirst = {}, {}
    for d, m in vmodels.items():
        batch, nxt = vlm_batch(torch, vcfg, 2, 12, d,
                               torch.Generator().manual_seed(SEED))
        first, toks, _ = dense_greedy(torch, m, vparams[d], batch, 24, 8,
                                      rows=False, mrope_next=nxt)
        vout[d], vfirst[d] = toks.cpu().tolist(), first.cpu()
    vgap = (vfirst["cpu"] - vfirst["cuda"]).abs().max().item()
    emit({"phase": "parity_encdec_vlm", "dtype": "float32",
          "seconds": time.monotonic() - t0, "tokens_equal": equal,
          "engine_equals_dense_oracle": out[("greedy", "cuda")] == oracle,
          "engine_tokens": out[("greedy", "cuda")][:2],
          "oracle_tokens": oracle[:2],
          "admission_logits_max_gap": gap, "stats": stats,
          "vlm_tokens_equal": vout["cpu"] == vout["cuda"],
          "vlm_prefill_max_abs_diff": vgap, "tol": PARITY_TOL})
    check(all(equal.values()), f"parity_encdec_vlm: cuda tokens != cpu "
          f"tokens {equal}")
    check(out[("greedy", "cuda")] == oracle,
          f"parity_encdec_vlm: the engine's greedy tokens differ from the "
          f"dense oracle's (admission logits gap {gap})")
    for key, st in stats.items():
        check(st["blocks_used"] == 0 and st["cross_arena"]["rows_used"] == 0
              and st["cross_arena"]["shared_hits"] >= 1,
              f"parity_encdec_vlm: {key} leaked or shared no row {st}")
        check(st["preemptions"] >= 1 or not key.startswith("greedy"),
              f"parity_encdec_vlm: {key} never preempted")
        if key.endswith("cuda"):
            check(st["graph_replays"] == st["steps"] > 0
                  and st["eager_decode_steps"] == 0,
                  f"parity_encdec_vlm: {key} decoded off the graph {st}")
    check(vout["cpu"] == vout["cuda"] and vgap <= PARITY_TOL,
          f"parity_encdec_vlm: qwen2-vl cuda != cpu (prefill gap {vgap})")


def encdec_turn(torch, engine, reqs):
    """One timed turn of the whisper engine over encdec_serve's requests
    after a warm-up request, the K1 / K2 / combine counters set to 0
    just before: (outputs, seconds, launches, K1 launches by body,
    stats)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.engine import SamplingParams

    prompts, feats, news, samp = reqs
    engine.generate([SOT], SamplingParams(max_tokens=2),
                    encoder_features=[feats[0]])
    engine.backend.reset_telemetry()
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    zero_bodies(fa.flash_attention)
    pa.paged_decode_attention.launches = 0
    pa.paged_decode_combine.launches = 0
    t0 = time.monotonic()
    outs = engine.generate(prompts, [SamplingParams(max_tokens=n, **kw)
                                     for n, kw in zip(news, samp)],
                           encoder_features=feats)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    return (outs, secs, {"K1": fa.flash_attention.launches,
                         "K2": pa.paged_decode_attention.launches,
                         "K2_combine": pa.paged_decode_combine.launches},
            dict(fa.flash_attention.launches_by_body), engine.stats())


def encdec_admission_s(torch, np, model, params, feats):
    """Seconds of one (8, 1500-frame) admission alone, synced, after one
    warm-up call: ``prefill_paged_encdec`` of HALF start-of-transcript
    prompts over full windows into scratch pools (the masked encoder,
    the arena write, the decoder prefill)."""
    from repro_torch.models import paged_kv, transformer

    layout = paged_kv.PagedLayout(num_slots=HALF, num_blocks=HALF + 1,
                                  block_size=16, max_len=16)
    pools = model.init_paged_cache(layout)
    toks = np.zeros((HALF, 16), np.int32)
    toks[:, :len(SOT)] = SOT
    args = [torch.from_numpy(a).cuda() for a in (
        toks, np.stack(feats[:HALF]), np.full(HALF, ENC_FRAMES, np.int32),
        np.full(HALF, len(SOT), np.int32),
        np.arange(1, HALF + 1, dtype=np.int32)[:, None],
        np.arange(1, HALF + 1, dtype=np.int32))]
    secs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        rows, _ = model.prefill_paged_encdec(params, pools, *args,
                                             transformer.RunCtx())
        torch.cuda.synchronize()
        secs.append(time.monotonic() - t0)
    check(bool(torch.isfinite(rows).all()), "encdec admission: bad logits")
    return secs[1]


def phase_encdec_serve(torch, np, profile):
    """whisper_base at full width and depth in bf16 (6 + 6 layers, d_model
    512, 8 heads x 64, vocab 51865; seeded random weights) through the
    Engine: 8 slots, block 16, max_len 448 (the decoder's context), 225
    blocks (every slot's full context), the cross arena of 9 rows of 6 x
    8 x 1500 x 64. encdec_workload's 16 requests with overlap off, then
    on (equal tokens). K1 runs the decoder's prefill (one a layer a
    prefill call), K2 and its combine the decode step by replay (one a
    layer a step); the engine's encoder and cross-attention are plain
    torch, as in JAX. Then the dense path on the first HALF requests
    (one (8, 4)-token prefill over full windows and greedy steps): its
    encoder and cross-attention run K1 (``K1_whisper_enc``'s launches:
    one a layer of the exact-length encoder), its greedy tokens against
    the engine's (bf16: reported, not gated)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.engine import Engine, EngineConfig
    from repro_torch.models import encdec, paged_kv
    from repro_torch.models.model import Model

    t0 = time.monotonic()
    cfg = get_config("whisper_base")
    model = Model(cfg, device="cuda")
    params = model.init(seed=SEED)
    reqs = encdec_workload(np, cfg.d_model)
    prompts, feats, news, samp = reqs
    geo = dict(num_slots=HALF, block_size=16, num_blocks=225, max_len=448)
    adm = encdec_admission_s(torch, np, model, params, feats)
    torch.cuda.reset_peak_memory_stats()
    engines, turns = {}, {}
    for overlap in (False, True):
        engines[overlap] = Engine(model, params, EngineConfig(
            **geo, overlap=overlap), device="cuda")
        turns[overlap] = encdec_turn(torch, engines[overlap], reqs)
        outs, secs, runs, k1_bodies, st = turns[overlap]
        arena = st["cross_arena"]
        emit({**turn_line("encdec_serve", cfg, overlap,
                          (outs, secs, runs, k1_bodies, st), news),
              "launches": runs, "k1_launches_by_body": k1_bodies,
              "admission_8x1500_s": adm,
              "arena_bytes": paged_kv.pool_bytes(
                  engines[overlap].backend.pools["cross"]),
              "cross_arena": arena, "prefill_shapes": st["prefill_shapes"],
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              **({"tokens_equal_overlap_off": outs == turns[False][0]}
                 if overlap else {})})
        decode_launches(st, runs, cfg)
        check(runs["K1"] == cfg.n_layers * st["prefill_calls"] > 0
              and k1_bodies["wgmma"] == runs["K1"],
              f"encdec_serve: K1 launches {runs['K1']} {k1_bodies} for "
              f"{st['prefill_calls']} prefill calls x {cfg.n_layers} layers")
        check(arena["shared_hits"] >= 2 and arena["rows_used"] == 0
              and st["blocks_used"] == 0,
              f"encdec_serve: arena {arena}, {st['blocks_used']} blocks")
    check(turns[True][0] == turns[False][0],
          "encdec_serve: overlap=True tokens differ from overlap off")

    # the dense path: the exact-length encoder through K1, non-causal
    frames = torch.from_numpy(np.stack(feats[:HALF])).cuda()
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    te = time.monotonic()
    enc = encdec.encode(params, cfg, frames)
    torch.cuda.synchronize()
    enc_s = time.monotonic() - te
    enc_launches = fa.flash_attention.launches
    check(enc_launches == cfg.n_encoder_layers
          and bool(torch.isfinite(enc).all()),
          f"encdec_serve: the dense encoder ran {enc_launches} K1 launches")
    greedy = [r for r in range(HALF) if not samp[r]]
    steps = min(news[r] for r in greedy)
    fa.flash_attention.launches = 0
    batch = {"tokens": torch.tensor([SOT] * HALF, dtype=torch.int32,
                                    device="cuda"), "frames": frames}
    counts = []

    def prefilled():             # from here K1 runs the cross-attention
        counts.append(fa.flash_attention.launches)
        fa.flash_attention.launches = 0

    _, toks, _ = dense_greedy(torch, model, params, batch, geo["max_len"],
                              steps - 1, after_prefill=prefilled)
    dense = toks.tolist()
    pre_launches, xattn_launches = counts[0], fa.flash_attention.launches
    L = cfg.n_layers
    match = [sum(a == b for a, b in zip(dense[r], turns[False][0][r]))
             / steps for r in greedy]
    emit({"phase": "encdec_serve", "config": cfg.name, "path": "dense",
          "encode_8x1500_s": enc_s, "k1_encoder_launches": enc_launches,
          "k1_prefill_launches": pre_launches,
          "k1_decode_xattn_launches": xattn_launches, "steps": steps,
          "greedy_token_match_vs_engine": match,
          "phase_seconds": time.monotonic() - t0})
    check(pre_launches == cfg.n_encoder_layers + 2 * L
          and xattn_launches == L * (steps - 1),
          f"encdec_serve: the dense path ran {pre_launches} K1 launches at "
          f"its prefill, {xattn_launches} over {steps - 1} decode steps")
    if profile:
        phase_profile(torch, engines[False], prompts, news,
                      f"{cfg.name} encdec_serve", feats)
    return {"K1_whisper_enc": enc_launches,
            "K1_whisper_xattn": xattn_launches,
            "K2_whisper": turns[False][2]["K2"]}


def phase_vlm_dense(torch, np, profile):
    """qwen2-vl-2b at full width and depth in bf16 (28 layers, d_model
    1536, GQA 12/2 x 128, M-RoPE sections 16/24/24, q/k/v biases, vocab
    151936; seeded random weights): an (8, 512) dense prefill whose first
    64 positions take visual embeddings on an 8 x 8 patch grid's M-RoPE
    ids, text after them, then VLM_STEPS greedy decode steps at
    continuing ids. Twice: equal tokens. K1 runs once a layer (28) at
    the prefill, on its tensor-core body; the decode is plain torch over
    linear caches (JAX's dense decode). ``profile`` adds windows over a
    prefill alone and over a prefill and VLM_PROBE decode steps, and
    from their difference the device ops a step issues and their busy
    time, beside the unprofiled wall time a step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import Model

    t0 = time.monotonic()
    cfg = get_config("qwen2_vl_2b")
    model = Model(cfg, device="cuda")
    params = model.init(seed=SEED)
    batch, nxt = vlm_batch(torch, cfg, HALF, 512, "cuda",
                           torch.Generator().manual_seed(SEED))
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        fa.flash_attention.launches = 0
        zero_bodies(fa.flash_attention)
        stamps = [time.monotonic()]

        def prefilled():
            torch.cuda.synchronize()
            stamps.append(time.monotonic())
            stamps.append((fa.flash_attention.launches,
                           dict(fa.flash_attention.launches_by_body)))

        first, toks, last = dense_greedy(torch, model, params, batch,
                                         512 + VLM_STEPS, VLM_STEPS,
                                         mrope_next=nxt,
                                         after_prefill=prefilled)
        torch.cuda.synchronize()
        t_end = time.monotonic()
        (k1, bodies) = stamps[2]
        runs.append((toks.tolist(), stamps[1] - stamps[0], t_end - stamps[1],
                     k1, bodies, bool(torch.isfinite(first).all()
                                      and torch.isfinite(last).all())))
    toks, pre_s, dec_s, k1, bodies, finite = runs[-1]
    emit({"phase": "vlm_dense", "config": cfg.name, "dtype": cfg.dtype,
          "shape": [HALF, 512], "visual_prefix": cfg.visual_prefix,
          "prefill_ms": [r[1] * 1e3 for r in runs],
          "decode_ms_per_step": [r[2] * 1e3 / VLM_STEPS for r in runs],
          "decode_tok_s": [HALF * VLM_STEPS / r[2] for r in runs],
          "k1_launches": k1, "k1_launches_by_body": bodies,
          "finite": finite, "tokens_equal": runs[0][0] == runs[1][0],
          "first_tokens": toks[0][:8],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "phase_seconds": time.monotonic() - t0})
    check(k1 == cfg.n_layers and bodies["wgmma"] == k1,
          f"vlm_dense: K1 ran {k1} launches {bodies}, expected "
          f"{cfg.n_layers} on wgmma")
    check(finite and runs[0][5], "vlm_dense: logits not finite")
    check(runs[0][0] == runs[1][0], "vlm_dense: tokens differ across runs")
    if profile:
        # what a decode step issues: the device ops (kernels, copies,
        # fills) and busy time over a prefill and VLM_PROBE steps less
        # those over the prefill alone, beside the unprofiled wall time
        probe = [profile_window(torch, lambda n=n: dense_greedy(
            torch, model, params, batch, 512 + n, n, mrope_next=nxt))
            for n in (0, VLM_PROBE)]
        ops = (probe[1]["device_ops"] - probe[0]["device_ops"]) / VLM_PROBE
        emit({"phase": "profile", "config": f"{cfg.name} vlm_dense",
              **probe[1], "decode_steps": VLM_PROBE,
              "decode_device_ops_per_step": ops,
              "decode_device_busy_ms_per_step": (
                  probe[1]["device_busy_s"] - probe[0]["device_busy_s"])
              * 1e3 / VLM_PROBE,
              "decode_wall_ms_per_step": dec_s * 1e3 / VLM_STEPS,
              "decode_wall_us_per_op": dec_s * 1e6 / VLM_STEPS / ops
              if ops else None})
    return {"K1_qwen2vl": k1}


# ---------------------------------------------------------------------------
# the EPAC tile layer: K6, K7, K8 and the tile_path phase
# ---------------------------------------------------------------------------


def k6_case(torch, name, M, K, N, dtype, out_dtype, want_body):
    """K6 (M, K) @ (K, N) in ``dtype`` to ``out_dtype``, held relatively
    (K6_TOL by operand dtype). The library time is one ``torch.matmul``
    on the same tensors (TF32 off) where the output dtype is the
    operands', else one ``torch.mm(..., out_dtype=)`` where the installed
    torch has it (None where it does not)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import stx_matmul as k6

    dt, odt = getattr(torch, dtype), getattr(torch, out_dtype)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((M, K), generator=gen, device="cuda").to(dt)
    w = torch.randn((K, N), generator=gen, device="cuda").to(dt)
    before = dict(k6.stx_matmul.launches_by_body)
    got = k6.stx_matmul(x, w, out_dtype=odt)
    body = ran_body(k6.stx_matmul, before)
    want = ref.matmul(x, w, out_dtype=odt)
    torch.cuda.synchronize()
    rtol, atol = K6_TOL[dtype]
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    excess = (diff - (atol + rtol * want.float().abs())).max().item()
    nbytes = x.element_size() * (M * K + K * N) + got.element_size() * M * N
    bound_ms, bound_by = bound(2 * M * N * K, nbytes, dtype)
    lib_fn, lib_name = (lambda: torch.matmul(x, w)), "torch.matmul"
    if odt != dt:
        lib_fn, lib_name = (lambda: torch.mm(x, w, out_dtype=odt)), \
            "torch.mm(out_dtype)"
    try:
        lib_out = lib_fn()
    except (TypeError, RuntimeError) as e:
        lib_fn, lib_name = None, f"none ({type(e).__name__}: {e})"[:200]
    lib_err = (None if lib_fn is None
               else (lib_out.float() - want.float()).abs().max().item())
    row = {"phase": "kernels", "kernel": "K6", "case": name,
           "shape": [M, K, N], "dtype": dtype, "out_dtype": out_dtype,
           "body": body, "max_abs_err": err, "rtol": rtol, "atol": atol,
           "within_tol": excess <= 0,
           "ms": cuda_ms(torch, lambda: k6.stx_matmul(x, w, out_dtype=odt)),
           "plain_ms": cuda_ms(torch, lambda: ref.matmul(x, w, out_dtype=odt)),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": lib_fn and cuda_ms(torch, lib_fn),
           "library": lib_name, "library_max_abs_err": lib_err}
    emit(row)
    check(math.isfinite(err) and excess <= 0,
          f"K6 {name}: outside rtol {rtol} / atol {atol} (max abs err {err})")
    check(body == want_body, f"K6 {name}: ran the {body} body, expected "
          f"{want_body}")
    return row


def k7_case(torch, name, shape, kind):
    """K7a (2-D) or K7b (3-D) in f32 with ``kind`` weights ("laplace":
    five- or seven-point, "ones", "random": seeded), held bit for bit;
    the library time is one cuDNN ``F.conv2d`` / ``F.conv3d`` with
    padding 1 (the same cross-correlation; TF32 off). K7b rows name the
    body the wrapper chose (``stx_stencil.body3d``: "ring" at 512^3) and
    add ``graph_ms`` (the call replayed) and ``simt_ms`` (the simt body,
    the kernel before the ring, forced on the same input and held bit
    for bit too)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels import stx_stencil as k7

    dims = len(shape)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(shape, generator=gen, device="cuda")
    if kind == "laplace":
        w = (ref.five_point_weights(device="cuda") if dims == 2
             else ref.seven_point_weights(device="cuda"))
    elif kind == "ones":
        w = torch.ones((3,) * dims, device="cuda")
    else:
        w = torch.randn((3,) * dims, generator=gen, device="cuda")
    fn, plain, conv = ((k7.stencil2d, ref.stencil2d, F.conv2d) if dims == 2
                       else (k7.stencil3d, ref.stencil3d, F.conv3d))
    if dims == 3:
        before = dict(k7.stencil3d.launches_by_body)
    got, want = fn(x, w), plain(x, w)
    extra = {}
    if dims == 3:
        simt = lambda: k7.launch3d(x, w, "simt")[0]  # noqa: E731
        extra = {"body": ran_body(k7.stencil3d, before),
                 "simt_bit_equal": bool(torch.equal(simt(), want))}
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    equal = bool(torch.equal(got, want))
    bound_ms, bound_by = bound(2 * 3**dims * x.numel(), 2 * 4 * x.numel(),
                               "float32")
    row = {"phase": "kernels", "kernel": "K7a" if dims == 2 else "K7b",
           "case": name, "shape": list(shape), "weights": kind,
           "dtype": "float32", **extra, "max_abs_err": err,
           "bit_equal": equal, "ms": cuda_ms(torch, lambda: fn(x, w))}
    if dims == 3:
        row.update(graph_ms=graph_ms(torch, lambda: fn(x, w)),
                   simt_ms=cuda_ms(torch, simt))
    row.update({"plain_ms": cuda_ms(torch, lambda: plain(x, w), reps=5),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": cuda_ms(torch, lambda: conv(
                    x[None, None], w[None, None], padding=1)),
                "library": f"F.conv{dims}d, padding 1"})
    emit(row)
    check(equal and extra.get("simt_bit_equal", True),
          f"{row['kernel']} {name}: kernel != plain version (max abs err "
          f"{err}; simt body {extra.get('simt_bit_equal')})")
    check(dims == 2 or row["body"] == "ring",
          f"K7b {name}: ran the {row.get('body')} body, expected ring")
    return row


def exact_sum(t):
    """The f64 sum of a tensor's values, correctly rounded (fsum)."""
    return math.fsum(t.double().cpu().numpy().tolist())


def k8_case(torch, np, dot, n, offset=0, profile=False):
    """K8a (``dot``) or K8b through ``ops.vrp_dot`` / ``ops.vrp_sum`` on
    n values, x scaled by 1e4 (tests/test_kernels.py's data), the inputs
    ``offset`` floats into their buffers (1: a base no tensor map takes):
    the body the wrapper chose ("ring" for n >= 1024 on aligned bases,
    else "simt"); the lanes equal the plain version's bit for bit; the
    finalized (2,) of the one-call ``ops.vrp_*`` (lane kernel + finalize
    kernel) equals the plain lanes finalized by the torch tree
    (``ops._finalize_expansion``), and the finalize kernel alone equals
    the tree on the kernel's lanes; hi + lo lies within max(naive error
    / 100, 1e-8) of the exact sum. ``ms`` is the eager lane call,
    ``call_ms`` / ``graph_ms`` the whole ``ops.vrp_*`` call eager and
    replayed from a CUDA graph, ``finalize_ms`` the finalize kernel and
    ``tree_finalize_ms`` the torch tree (the finalize before the kernel),
    ``call_host_ms`` the host's wall time of a call with its sync and
    ``enqueue_ms`` without; ``kernel_ms`` (``profile``) the profiler's
    device time of both kernels in one call. The plain version
    (n / 1024 sequential vector steps) is timed once. No PyTorch call
    returns the compensated expansion: no library time."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import vrp_dot as k8

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = (torch.randn(n + offset, generator=gen, device="cuda") * 1e4)[offset:]
    y = torch.randn(n + offset, generator=gen, device="cuda")[offset:]
    if dot:
        counter, args = k8.vrp_dot_lanes, (x, y)
        plain_fn = lambda: ref.vrp_dot_lanes(x, y)   # noqa: E731
        final_fn = lambda: ops.vrp_dot(x, y)         # noqa: E731
        exact = exact_sum(x.double() * y.double())
        naive = float(torch.dot(x, y))
    else:
        counter, args = k8.vrp_sum_lanes, (x,)
        plain_fn = lambda: ref.vrp_sum_lanes(x)      # noqa: E731
        final_fn = lambda: ops.vrp_sum(x)            # noqa: E731
        exact = exact_sum(x)
        naive = float(torch.sum(x))
    lanes_fn = lambda: counter(*args)                # noqa: E731
    before = dict(counter.launches_by_body)
    got = lanes_fn()
    body = ran_body(counter, before)
    want_body = "simt" if offset % 4 or n < 1024 else "ring"
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    want = plain_fn()
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    err = (got - want).abs().max().item()
    equal = bool(torch.equal(got, want))
    f0 = k8.vrp_finalize.launches
    final = final_fn()
    finalize_launched = k8.vrp_finalize.launches - f0
    tree = ops._finalize_expansion(want)
    fin_alone = k8.vrp_finalize(got)
    final_equal = bool(torch.equal(final, tree))
    fin_alone_equal = bool(torch.equal(fin_alone, ops._finalize_expansion(got)))
    hi, lo = final.tolist()
    final_err = abs(hi + lo - exact)
    naive_err = abs(naive - exact)
    limit = max(naive_err / 100, 1e-8)
    flops = (25 if dot else 7) * n       # two_prod 17, two_sum 6, c 1-2
    bound_ms, bound_by = bound(flops, (8 if dot else 4) * n + 8192,
                               "float32")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(5):
        final_fn()
        torch.cuda.synchronize()
    call_host_ms = 1e3 * (time.monotonic() - t0) / 5
    t0 = time.monotonic()
    for _ in range(20):
        final_fn()
    enqueue_ms = 1e3 * (time.monotonic() - t0) / 20
    torch.cuda.synchronize()
    row = {"phase": "kernels", "kernel": "K8a" if dot else "K8b",
           "case": f"{'dot' if dot else 'sum'}_{n}"
                   + (f"_offset{offset}" if offset else ""),
           "n": n, "dtype": "float32", "body": body,
           "max_abs_err": err, "lanes_bit_equal": equal,
           "final": [hi, lo], "final_equal_plain": final_equal,
           "finalize_alone_equal_tree": fin_alone_equal,
           "finalize_launches": finalize_launched,
           "exact": exact, "final_err": final_err,
           "naive_err": naive_err, "limit": limit,
           "ms": cuda_ms(torch, lanes_fn), "plain_ms": plain_ms,
           "call_ms": cuda_ms(torch, final_fn),
           "graph_ms": graph_ms(torch, final_fn),
           "finalize_ms": cuda_ms(torch, lambda: k8.vrp_finalize(got)),
           "tree_finalize_ms": cuda_ms(
               torch, lambda: ops._finalize_expansion(got), reps=5),
           "call_host_ms": call_host_ms, "enqueue_ms": enqueue_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    if profile:
        row["kernel_ms"] = kernel_ms(torch, final_fn, K8_KERNELS)
    emit(row)
    check(body == want_body, f"{row['kernel']} {row['case']}: ran the "
                             f"{body} body, expected {want_body}")
    check(equal, f"{row['kernel']} n {n}: lanes != plain version (max abs "
                 f"err {err})")
    check(finalize_launched == 1 and final_equal and fin_alone_equal,
          f"{row['kernel']} n {n}: finalize launched {finalize_launched}, "
          f"equal to the tree {final_equal} / {fin_alone_equal}")
    check(final_err <= limit, f"{row['kernel']} n {n}: finalized error "
                              f"{final_err} > {limit}")
    return row


def phase_tile_kernels(torch, np, profile):
    """The tile layer's kernels at the tile_path's shapes: K6 at olmo_1b's
    MLP up-projection for 8 x 512 tokens (bf16, to bf16 and to f32),
    bench_stx's 1024^3 f32 and a ragged f32 case; K7a on 8192^2
    (five-point and ones) and a ragged 4097 x 4099; K7b on 512^3
    (seven-point and 27 random weights); K8a and K8b on the diffusion
    plate's 8192^2 values (the summary's rows) and on 2^24 + 3 (a ragged
    tail of 3)."""
    k6 = k6_case(torch, "olmo_mlp_bf16", 4096, 2048, 8192, "bfloat16",
                 "bfloat16", "wgmma")
    k6_case(torch, "olmo_mlp_bf16_to_f32", 4096, 2048, 8192, "bfloat16",
            "float32", "wgmma")
    k6_case(torch, "bench_stx_f32", 1024, 1024, 1024, "float32", "float32",
            "simt")
    k6_case(torch, "ragged_f32", 1000, 700, 300, "float32", "float32", "simt")
    # K = 700 rows are 1400 bytes, no tensor-map stride: the SIMT body
    k6_case(torch, "ragged_bf16_simt", 1000, 700, 300, "bfloat16", "bfloat16",
            "simt")
    k7a = k7_case(torch, "diffusion_8192", (DIFF_N, DIFF_N), "laplace")
    k7_case(torch, "ones_8192", (DIFF_N, DIFF_N), "ones")
    k7_case(torch, "ragged_4097x4099", (4097, 4099), "laplace")
    k7b = k7_case(torch, "seven_point_512", (512, 512, 512), "laplace")
    k7_case(torch, "random27_512", (512, 512, 512), "random")
    k8a = k8_case(torch, np, True, DIFF_N * DIFF_N, profile=profile)
    k8_case(torch, np, True, K8_N, profile=profile)
    k8_case(torch, np, True, K8_N, offset=1)
    k8b = k8_case(torch, np, False, DIFF_N * DIFF_N, profile=profile)
    k8_case(torch, np, False, K8_N, profile=profile)
    return k6, k7a, k7b, k8a, k8b


def hot_plate(torch, n, device):
    """The diffusion example's plate: 24-cell hot squares (1.0) on a
    cold plate, one every 96 cells from the corner, so the squares on
    the edges touch the cold (zero) boundary and heat leaks out."""
    i = torch.arange(n, device=device) % 96 < 24
    return (i[:, None] & i[None, :]).float()


def k8_totals(torch, u):
    """The plate's total and energy through K8b / K8a (``ops.vrp_sum`` /
    ``ops.vrp_dot``), and whether both expansions equal, bit for bit,
    the plain lanes (``ref.vrp_*_lanes`` on the same tensor) finalized
    alike: the plain route launches no K8."""
    from repro_torch.kernels import ops, ref

    flat = u.reshape(-1)
    got = (ops.vrp_sum(u), ops.vrp_dot(u, u))
    want = (ops._finalize_expansion(ref.vrp_sum_lanes(flat)),
            ops._finalize_expansion(ref.vrp_dot_lanes(flat, flat)))
    return ([sum(g.tolist()) for g in got],
            all(bool(torch.equal(g, w)) for g, w in zip(got, want)))


def diffuse(u, w, steps, cluster):
    for _ in range(steps):
        u = u + ALPHA * cluster.stencil2d(u, w)
    return u


def adaptive_cg(torch, solvers, A, b, tol, maxiter):
    """Escalate the precision until CG converges (examples/vrp_solver.py):
    a list of (env, iterations, residual, seconds, x) per rung run."""
    from repro_torch.core.precision import PRESETS

    rungs = []
    for name in LADDER:
        t0 = time.monotonic()
        res = solvers.cg(A, b, PRESETS[name], tol=tol, maxiter=maxiter)
        torch.cuda.synchronize()
        rungs.append((name, res.iterations, res.residual,
                      time.monotonic() - t0, res.x))
        if res.converged:
            break
    return rungs


def compare_solves(torch, name, got, want):
    """cuda rungs against cpu rungs: same rungs, equal iteration counts,
    x within 1e-12 relative; reports whether the bits are equal."""
    out = {"rungs": [], "x_bits_equal": True}
    check(len(got) == len(want), f"tile_path {name}: the ladders differ")
    for (env, it, res, secs, x), (env_c, it_c, res_c, secs_c, x_c) in zip(
            got, want):
        rel = ((x.cpu() - x_c).abs().max() / x_c.abs().max()).item()
        equal = bool(torch.equal(x.cpu(), x_c))
        out["rungs"].append({"env": env, "iterations": it,
                             "iterations_cpu": it_c, "residual": res,
                             "residual_cpu": res_c, "x_rel_diff": rel,
                             "x_bits_equal": equal, "cuda_s": secs,
                             "cpu_s": secs_c,
                             "cuda_ms_per_iter": 1e3 * secs / max(it, 1)})
        out["x_bits_equal"] &= equal
        check(env == env_c and it == it_c,
              f"tile_path {name} {env}: {it} iterations on cuda, {it_c} on "
              "cpu")
        check(rel <= 1e-12, f"tile_path {name} {env}: x differs by {rel}")
    return out


def phase_tile_path(torch, np, profile):
    """The EPAC tile layer end to end through its entry points (the
    port's counterparts of examples/stencil_diffusion.py and
    examples/vrp_solver.py, and the tile policies): every tile kernel's
    counter is reset first and read last. ``profile`` adds device time
    by kernel over 20 diffusion steps and 5 vp128 CG iterations on
    n = 1024."""
    from repro_torch.core import solvers, stx, tiles, vrp
    from repro_torch.core.precision import PRESETS
    from repro_torch.kernels import ref
    from repro_torch.kernels import stx_matmul as k6
    from repro_torch.kernels import stx_stencil as k7
    from repro_torch.kernels import vrp_dot as k8

    counters = {"K6": k6.stx_matmul, "K7a": k7.stencil2d,
                "K7b": k7.stencil3d, "K8a": k8.vrp_dot_lanes,
                "K8b": k8.vrp_sum_lanes}
    counters["K8_finalize"] = k8.vrp_finalize
    for fn in counters.values():
        fn.launches = 0
    for fn in (k6.stx_matmul, k7.stencil3d, k8.vrp_dot_lanes,
               k8.vrp_sum_lanes):
        zero_bodies(fn)
    cluster = stx.DEFAULT_CLUSTER
    out = {"phase": "tile_path"}
    t_part = time.monotonic()

    def part_done(key):
        """A part's seconds and ``t_s`` (seconds since the start) at its
        end."""
        nonlocal t_part
        now = time.monotonic()
        out[key].update(seconds=now - t_part, t_s=now - T_START)
        t_part = now

    # (a) diffusion at full size: K7a steps, the totals through K8
    w5 = ref.five_point_weights(device="cuda")
    u0 = hot_plate(torch, DIFF_N, "cuda")
    (total0, energy0), k8_equal0 = k8_totals(torch, u0)
    n7 = counters["K7a"].launches
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    u = diffuse(u0, w5, DIFF_STEPS, cluster)
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / DIFF_STEPS
    k7_steps = counters["K7a"].launches - n7
    (total, energy), k8_equal = k8_totals(torch, u)
    peak = u.max().item()
    finite = bool(torch.isfinite(u).all())
    vol = torch.randn((512, 512, 512), device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(SEED))
    before = dict(k7.stencil3d.launches_by_body)
    v7 = cluster.stencil3d(vol, ref.seven_point_weights(device="cuda"))
    body3 = ran_body(k7.stencil3d, before)
    finite3 = bool(torch.isfinite(v7).all())
    del vol, v7
    # at the example's own sizes, cuda against cpu
    small = {d: diffuse(hot_plate(torch, 96, d),
                        ref.five_point_weights(device=d), 8, cluster)
             for d in ("cuda", "cpu")}
    vol = torch.from_numpy(np.random.default_rng(SEED).normal(
        size=(64, 64, 64)).astype(np.float32))
    w7 = ref.seven_point_weights()
    small3 = (cluster.stencil3d(vol.cuda(), w7.cuda()).cpu(),
              cluster.stencil3d(vol, w7))
    out["diffusion"] = {
        "grid": [DIFF_N, DIFF_N], "steps": DIFF_STEPS, "alpha": ALPHA,
        "k7a_launches": k7_steps, "step_ms": step_ms,
        "mpts_s": DIFF_N * DIFF_N / (step_ms * 1e-3) / 1e6,
        "peak": peak, "finite": finite, "total0": total0, "total": total,
        "energy0": energy0, "energy": energy,
        "k8_totals_equal_plain": k8_equal0 and k8_equal,
        "stencil3d_512_finite": finite3, "stencil3d_512_body": body3,
        "small_96x96_8_steps_equal": bool(torch.equal(small["cuda"].cpu(),
                                                      small["cpu"])),
        "small_64cube_equal": bool(torch.equal(*small3))}
    d = out["diffusion"]
    check(k7_steps == DIFF_STEPS, f"tile_path: {k7_steps} K7a launches over "
                                  f"{DIFF_STEPS} steps")
    check(0.0 < peak < 1.0 and finite and finite3,
          f"tile_path: diffusion peak {peak}, finite {finite}/{finite3}")
    check(body3 == "ring", f"tile_path: the 512^3 stencil3d step ran K7b's "
                           f"{body3} body")
    check(total <= total0, f"tile_path: total rose {total0} -> {total}")
    check(energy <= energy0, f"tile_path: energy rose {energy0} -> {energy}")
    check(d["k8_totals_equal_plain"],
          "tile_path: K8 totals differ from the plain lanes' finalized sums")
    check(d["small_96x96_8_steps_equal"] and d["small_64cube_equal"],
          "tile_path: example-size stencils differ on cuda and cpu")
    part_done("diffusion")

    # (b) the tile policies' dispatch
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((8, 512, 2048), generator=gen, device="cuda") \
        .to(torch.bfloat16)
    w = torch.randn((2048, 8192), generator=gen, device="cuda") \
        .to(torch.bfloat16)
    n6 = counters["K6"].launches
    before = dict(k6.stx_matmul.launches_by_body)
    y_stx = tiles.dispatch_matmul(x, w, tiles.STX_POLICY)
    k6_stx = counters["K6"].launches - n6
    stx_body = ran_body(k6.stx_matmul, before)
    y_vec = tiles.dispatch_matmul(x, w, tiles.DEFAULT_POLICY)
    k6_vec = counters["K6"].launches - n6 - k6_stx
    rtol, atol = K6_TOL["bfloat16"]
    diff = (y_stx.float() - y_vec.float()).abs()
    excess = (diff - (atol + rtol * y_vec.float().abs())).max().item()
    vrp_policy = tiles.TilePolicy(reduction="vrp")
    r_cuda = tiles.dispatch_reduction(x, vrp_policy)
    r_cpu = tiles.dispatch_reduction(x.cpu(), vrp_policy)
    out["dispatch"] = {"matmul_shape": [8, 512, 2048, 8192],
                       "stx_k6_launches": k6_stx, "vec_k6_launches": k6_vec,
                       "stx_k6_body": stx_body,
                       "max_abs_diff": diff.max().item(),
                       "within_tol": excess <= 0,
                       "vrp_reduction": [r_cuda.item(), r_cpu.item()],
                       "vrp_reduction_equal": bool(torch.equal(
                           r_cuda.cpu(), r_cpu))}
    check(k6_stx == 1 and k6_vec == 0,
          f"tile_path: K6 launches stx {k6_stx}, vec {k6_vec}")
    check(stx_body == "wgmma",
          f"tile_path: the STX_POLICY matmul ran K6's {stx_body} body")
    check(excess <= 0, "tile_path: STX and VEC matmuls disagree")
    check(out["dispatch"]["vrp_reduction_equal"],
          "tile_path: vrp reduction differs on cuda and cpu")
    del x, w, y_stx, y_vec, diff
    part_done("dispatch")

    # (c) the VRP solvers: the adaptive ladder on cuda and cpu
    problems = {}
    for name, A, tol, maxiter in (
            ("hilbert12", solvers.hilbert(12), 1e-13, 400),
            ("hilbert_like64_cond1e8",
             solvers.hilbert_like(64, cond=1e8, seed=SEED), 1e-12,
             LADDER_ITERS)):
        t0 = time.monotonic()
        b = A @ torch.ones(A.shape[0], dtype=A.dtype)
        got = adaptive_cg(torch, solvers, A.cuda(), b.cuda(), tol, maxiter)
        want = adaptive_cg(torch, solvers, A, b, tol, maxiter)
        problems[name] = compare_solves(torch, name, got, want)
        problems[name].update(tol=tol, maxiter=maxiter,
                              solved_at=got[-1][0] if got[-1][2] <= tol
                              else None, seconds=time.monotonic() - t0)
    # problem 3: the right-hand side in extended precision
    t0 = time.monotonic()
    env = PRESETS["vp256"]
    A = solvers.hilbert_like(24, cond=1e6, seed=1)
    res3 = {}
    for dev in ("cuda", "cpu"):
        Ad = A.to(dev)
        xs = vrp.from_float(torch.ones(24, dtype=torch.float64, device=dev),
                            env)
        bE = vrp.tree_sum(vrp.mul(vrp.from_float(Ad, env), xs[None], env),
                          env, axis=1)
        res3[dev] = []
        for name, rhs in (("f64", vrp.to_float(bE)), ("vp128", bE[:, :2])):
            t0 = time.monotonic()
            r = solvers.cg(Ad, rhs, PRESETS[name], tol=1e-24, maxiter=600)
            torch.cuda.synchronize()
            res3[dev].append((name, r.iterations, r.residual,
                              time.monotonic() - t0, r.x))
    problems["extended_rhs"] = compare_solves(torch, "extended_rhs",
                                              res3["cuda"], res3["cpu"])
    problems["extended_rhs"]["x_err"] = {
        r[0]: float((r[4] - 1).abs().max()) for r in res3["cuda"]}
    problems["extended_rhs"]["seconds"] = time.monotonic() - t0
    # cg at vp128 on n = 1024: time per iteration on the card (a timing
    # only: CG_TIMED_ITERS iterations, no comparison rides on them)
    A = solvers.hilbert_like(1024, cond=1e8, seed=SEED).cuda()
    b = A @ torch.ones(1024, dtype=A.dtype, device="cuda")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    big = solvers.cg(A, b, PRESETS["vp128"], tol=1e-12,
                     maxiter=CG_TIMED_ITERS)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    problems["cg_vp128_n1024"] = {"iterations": big.iterations,
                                  "residual": big.residual, "seconds": secs,
                                  "ms_per_iter": 1e3 * secs / big.iterations}
    check(math.isfinite(big.residual) and big.iterations > 0,
          "tile_path: vp128 CG on n 1024 failed")
    out["solvers"] = problems
    part_done("solvers")
    out["launches"] = {k: fn.launches for k, fn in counters.items()}
    out["k6_launches_by_body"] = dict(k6.stx_matmul.launches_by_body)
    out["k7b_launches_by_body"] = dict(k7.stencil3d.launches_by_body)
    out["k8_launches_by_body"] = {
        "K8a": dict(k8.vrp_dot_lanes.launches_by_body),
        "K8b": dict(k8.vrp_sum_lanes.launches_by_body)}
    emit(out)
    if profile:
        emit({"phase": "profile", "config": "tile_path diffusion 20 steps",
              **profile_window(torch, lambda: diffuse(u0, w5, 20, cluster))})
        emit({"phase": "profile", "config": "tile_path cg vp128 n 1024, "
                                            "5 iterations",
              **profile_window(torch, lambda: solvers.cg(
                  A, b, PRESETS["vp128"], tol=0.0, maxiter=5))})
    for k in ("K6", "K7a", "K7b", "K8a", "K8b", "K8_finalize"):
        check(out["launches"][k] > 0,
              f"tile_path: {k} was never launched {out['launches']}")
    # the plate's totals: every K8 call on the ring body, each finalized
    # on the card in the same call
    by_body = out["k8_launches_by_body"]
    check(all(b["simt"] == 0 and b["ring"] > 0 for b in by_body.values())
          and out["launches"]["K8_finalize"]
          == out["launches"]["K8a"] + out["launches"]["K8b"],
          f"tile_path: K8 bodies {by_body}, finalize launches "
          f"{out['launches']['K8_finalize']}")
    return out["launches"]


# ---------------------------------------------------------------------------
# training: K1's backward, parity_train, train
# ---------------------------------------------------------------------------


def k1_bwd_case(torch, name, B, hq, hkv, S, D, dtype, window=None,
                causal=True, Skv=None):
    """K1's forward with its row lse and K1's backward kernel at (B,
    hq/hkv, S, D), causal or not, over ``Skv`` keys (default S; a
    cross-attention's S query rows over Skv encoder positions), q / k /
    v laid out as the training path passes them ((B, S, H, D)
    projections seen through ``.transpose(1, 2)``). The forward's output
    is held against ``ref.flash_attention(..., return_lse=True)`` within
    TOL and its lse within LSE_TOL, on the body the wrapper picks (bf16:
    wgmma, f32: simt), so that a wrong lse cannot cancel out of the
    backward's check below. The backward runs the body ``bwd_body`` picks (bf16: wgmma,
    f32: simt) and is held against ``ref.flash_attention_bwd`` on
    the same q, k, v, output, lse and output gradient, element by
    element: |got - plain| <= TOL + BWD_RTOL * |plain|; a second call
    must give the same bits (``deterministic``). On a bf16 row the simt
    body forced on the same inputs is held to the same limit and timed
    beside it (``simt_ms``). Bounds: the forward's 4 D flops a visible
    (query, key) pair and q, k, v, O, lse moved once;
    the backward's 2.5x the forward's products (five matmuls against
    two) and q, k, v, O, dO, lse, dQ, dK, dV moved once. The library
    times are SDPA's forward and its backward (forward + backward under
    autograd less the forward), on the same tensors."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa, ref

    Skv = Skv or S
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn((B, n, h, D), generator=gen, device="cuda")
               .to(dt).transpose(1, 2)
               for h, n in ((hq, S), (hkv, Skv), (hkv, Skv)))
    do = torch.randn((B, hq, S, D), generator=gen, device="cuda").to(dt)
    before = dict(fa.flash_attention.launches_by_body)
    out, lse = fa._forward(q, k, v, causal, window, None, True)
    fwd_body = ran_body(fa.flash_attention, before)
    want_out, want_lse = ref.flash_attention(q, k, v, causal=causal,
                                             window=window, return_lse=True)
    fwd_err = (out.float() - want_out.float()).abs().max().item()
    lse_err = (lse - want_lse).abs().max().item()
    del want_out, want_lse
    call = lambda: fa.flash_attention_bwd(  # noqa: E731
        q, k, v, out, lse, do, causal=causal, window=window)
    before = fa.flash_attention_bwd.launches
    by_body = dict(fa.flash_attention_bwd.launches_by_body)
    got = call()
    check(fa.flash_attention_bwd.launches == before + 1,
          f"K1_bwd {name}: not one counted launch")
    body = ran_body(fa.flash_attention_bwd, by_body)
    again = call()
    deterministic = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    del again
    want = ref.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                   window=window)
    torch.cuda.synchronize()

    def over_limit(grads):
        """Each gradient's max abs error and the largest ratio of an
        element's error to its own limit."""
        errs, excess = {}, {}
        for n, g, w in zip(("dq", "dk", "dv"), grads, want):
            diff = (g.float() - w.float()).abs()
            errs[n] = diff.max().item()
            excess[n] = (diff / (TOL[dtype] + BWD_RTOL[dtype]
                                 * w.float().abs())).max().item()
        return errs, excess

    errs, excess = over_limit(got)
    simt = lambda: fa.launch_bwd(  # noqa: E731
        q, k, v, out, lse, do, causal=causal, window=window, which="simt")
    simt_excess = over_limit(simt()[:3])[1] if body != "simt" else None
    del got, want
    if causal:
        w = min(window or S, S)
        pairs = B * hq * (w * (w + 1) // 2 + (S - w) * w)
    else:
        pairs = B * hq * S * Skv
    elem = q.element_size()
    fwd_bound_ms, fwd_bound_by = bound(
        4 * D * pairs, elem * (2 * B * hq * S * D + 2 * B * hkv * Skv * D)
        + 4 * B * hq * S, dtype)
    nbytes = elem * (4 * B * hq * S * D + 4 * B * hkv * Skv * D) \
        + 4 * B * hq * S
    bound_ms, bound_by = bound(2.5 * 4 * D * pairs, nbytes, dtype)
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    kw = {"enable_gqa": hkv < hq}
    if not causal:
        pass                                  # every key visible: no mask
    elif window is not None and window < S:
        pos = torch.arange(S, device="cuda")
        kw["attn_mask"] = (pos[None, :] <= pos[:, None]) \
            & (pos[None, :] > pos[:, None] - window)
    else:
        kw["is_causal"] = True
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qs, ks, vs, **kw)
    sdpa_fwd = cuda_ms(torch, sdpa)
    sdpa_fb = cuda_ms(torch, lambda: torch.autograd.grad(
        sdpa(), (qs, ks, vs), do))
    row = {"phase": "kernels", "kernel": "K1_bwd", "case": name,
           "shape": [B, hq, hkv, S, D], "keys": Skv, "dtype": dtype,
           "window": window, "causal": causal, "body": body,
           "max_abs_err": max(errs.values()),
           "err_by_grad": errs, "err_over_limit_by_grad": excess,
           "deterministic": deterministic,
           "tol": TOL[dtype], "rtol": BWD_RTOL[dtype],
           "ms": cuda_ms(torch, call),
           "plain_ms": cuda_ms(torch, lambda: ref.flash_attention_bwd(
               q, k, v, out, lse, do, causal=causal, window=window),
               reps=3),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": sdpa_fb - sdpa_fwd,
           "library": "sdpa backward (forward + backward under autograd "
                      "less the forward), " + (
                          "boolean causal+window mask" if "attn_mask" in kw
                          else "is_causal" if causal else "no mask"),
           "fwd_body": fwd_body, "fwd_max_abs_err": fwd_err,
           "fwd_lse_max_abs_err": lse_err, "lse_tol": LSE_TOL[dtype],
           "fwd_ms": cuda_ms(torch, lambda: fa._forward(
               q, k, v, causal, window, None, True)),
           "fwd_plain_ms": cuda_ms(torch, lambda: ref.flash_attention(
               q, k, v, causal=causal, window=window, return_lse=True),
               reps=3),
           "fwd_bound_ms": fwd_bound_ms, "fwd_bound_by": fwd_bound_by,
           "library_fwd_ms": sdpa_fwd}
    if simt_excess is not None:
        row.update(simt_ms=cuda_ms(torch, simt),
                   simt_err_over_limit_by_grad=simt_excess)
    emit(row)
    want_body = "wgmma" if dtype == "bfloat16" else "simt"
    check(fwd_body == want_body and math.isfinite(fwd_err)
          and fwd_err <= TOL[dtype] and math.isfinite(lse_err)
          and lse_err <= LSE_TOL[dtype],
          f"K1 (lse) {name}: {fwd_body} body (expected {want_body}), "
          f"output err {fwd_err} (tol {TOL[dtype]}), lse err {lse_err} "
          f"(tol {LSE_TOL[dtype]})")
    check(all(math.isfinite(e) and e <= 1.0 for e in excess.values()),
          f"K1_bwd {name}: errors {errs}, over their per-element limits "
          f"{TOL[dtype]} + {BWD_RTOL[dtype]} |plain| by {excess}")
    check(body == want_body and deterministic,
          f"K1_bwd {name}: {body} body (expected {want_body}), "
          f"deterministic {deterministic}")
    check(simt_excess is None or all(math.isfinite(e) and e <= 1.0
                                     for e in simt_excess.values()),
          f"K1_bwd {name}: the simt body over its limits by {simt_excess}")
    return row


def training_counters():
    """The launch counters of the training path's kernels: K1's forward,
    its backward, K5 (forward and reversed backward) and K8b."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as k5
    from repro_torch.kernels import vrp_dot as k8

    return {"K1": (fa.flash_attention, "launches"),
            "K1_bwd": (fa.flash_attention_bwd, "launches"),
            "K5": (k5.rglru_scan, "launches"),
            "K8b": (k8.vrp_sum_lanes, "launches")}


def zero_training_counters():
    for fn, attr in training_counters().values():
        setattr(fn, attr, 0)


def read_training_counters():
    return {k: getattr(fn, attr) for k, (fn, attr)
            in training_counters().items()}


PARITY_TRAIN_ARCHS = ("olmo_1b", "h2o_danube_3_4b", "recurrentgemma_2b",
                      "xlstm_1_3b", "qwen3_moe_30b_a3b", "kimi_k2_1t_a32b",
                      "whisper_base")


def smoke_train_batch(torch, cfg, src, step, device):
    """``src.batch_at(step)`` on ``device``; an encoder-decoder's batch
    also carries frames (B, encoder_len, d) drawn from a generator seeded
    with SEED + step."""
    batch = {k: v.to(device) for k, v in src.batch_at(step).items()}
    if cfg.enc_dec:
        gen = torch.Generator().manual_seed(SEED + step)
        B = batch["tokens"].shape[0]
        batch["frames"] = torch.randn((B, cfg.encoder_len, cfg.d_model),
                                      generator=gen).to(device)
    return batch


class DropCounter:
    """Counts the assignments the MoE drops while installed: wraps
    ``moe.plan`` (each call syncs to read its mask; parity runs only)."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.real, self.dropped, self.calls = moe, moe.plan, 0, 0

    def __enter__(self):
        def plan(*args, **kw):
            r = self.real(*args, **kw)
            if r.get("kept") is not None:
                self.dropped += int((~r["kept"]).sum())
                self.calls += 1
            return r

        self.moe.plan = plan
        return self

    def __exit__(self, *exc):
        self.moe.plan = self.real


def phase_parity_train(torch, np):
    """The training path at smoke sizes in f32 (TF32 off), cuda against
    cpu on the same params and batch: olmo_1b, h2o_danube_3_4b (SWA),
    recurrentgemma_2b (RG-LRU + local attention), xlstm_1_3b (mLSTM +
    sLSTM), qwen3_moe_30b_a3b and kimi_k2_1t_a32b (the MoE routed with the
    capacity factor, its aux loss) and whisper_base (the encoder-decoder,
    on frames from a seeded generator): loss within 1e-5 relative and
    every grad leaf within 1e-4 * max(1, max|g_cpu|) (the CPU tests'
    tolerance against JAX); the cuda run must launch K1 and its backward
    (none on xlstm, which has no attention) and (recurrentgemma) K5; the
    MoE runs print the assignments their layers dropped (more than 0).
    Then three steps of ``make_train_step`` for olmo_1b smoke with each
    of AdamW, AdamW with ``grad_accum=2`` and AdamW with
    ``norm_tile="vrp"`` (K8b on the norm), and for qwen3_moe and whisper
    smoke with ``grad_accum=2``, cuda against cpu by loss within 1e-4
    relative. Then K1's forward (with lse) and backward against their
    plain versions at the training shapes (``k1_bwd_case``): olmo's,
    recurrentgemma's and danube's in bf16 and in f32, and in bf16
    qwen3_moe's (4, 32/4, 2048, 128) causal and whisper's encoder (8,
    8/8, 1500, 64) non-causal, decoder (8, 8/8, 448, 64) causal and
    cross-attention (8, 8/8, 448 rows over 1500 keys, 64) non-causal:
    train_families' shapes."""
    import functools

    from repro_torch import tree as tr
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import RunCtx
    from repro_torch.optim import OptConfig
    from repro_torch.optim.schedule import constant

    t0 = time.monotonic()
    ctx = RunCtx()
    grads_rows = {}
    for arch in PARITY_TRAIN_ARCHS:
        cfg = get_config(arch).smoke()
        cpu = Model(cfg, device="cpu")
        gpu = Model(cfg, device="cuda")
        params = cpu.init(seed=SEED)
        src = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                     global_batch=4, seed=SEED))
        batch = smoke_train_batch(torch, cfg, src, 0, "cpu")
        with DropCounter() as cpu_drops:
            want_loss, _, want = train.value_and_grad(cpu, ctx, params,
                                                      batch)
        zero_training_counters()
        with DropCounter() as drops:
            loss, metrics, got = train.value_and_grad(
                gpu, ctx, tr.map_tree(lambda t: t.cuda(), params),
                {k: v.cuda() for k, v in batch.items()})
        torch.cuda.synchronize()
        counts = read_training_counters()
        rel = abs(loss.item() - want_loss.item()) / abs(want_loss.item())
        ratio = max((g.cpu() - w).abs().max().item()
                    / max(1.0, w.abs().max().item())
                    for g, w in zip(got, want))
        grads_rows[arch] = {"loss_cpu": want_loss.item(),
                            "loss_cuda": loss.item(), "loss_rel_err": rel,
                            "grad_err_over_scale": ratio,
                            "aux_cuda": metrics["aux"].item(),
                            "launches": counts}
        if cfg.is_moe:
            grads_rows[arch].update(moe_dropped_cuda=drops.dropped,
                                    moe_dropped_cpu=cpu_drops.dropped,
                                    moe_layers=drops.calls)
        check(rel <= 1e-5 and ratio <= 1e-4,
              f"parity_train {arch}: loss rel err {rel}, grad err / scale "
              f"{ratio}")
        attention = arch != "xlstm_1_3b"
        check((counts["K1"] > 0) == attention
              and (counts["K1_bwd"] > 0) == attention
              and (counts["K5"] > 0) == (arch == "recurrentgemma_2b"),
              f"parity_train {arch}: launches {counts}")
        check(not cfg.is_moe or drops.dropped == cpu_drops.dropped > 0,
              f"parity_train {arch}: dropped assignments cuda "
              f"{drops.dropped}, cpu {cpu_drops.dropped}")
    steps = {}
    lr = functools.partial(constant, peak_lr=1e-3)
    for name, arch, kw in (("adamw", "olmo_1b", {}),
                           ("grad_accum_2", "olmo_1b", {"grad_accum": 2}),
                           ("norm_vrp", "olmo_1b", {"norm_tile": "vrp"}),
                           ("moe_grad_accum_2", "qwen3_moe_30b_a3b",
                            {"grad_accum": 2}),
                           ("encdec_grad_accum_2", "whisper_base",
                            {"grad_accum": 2})):
        cfg = get_config(arch).smoke()
        src = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                     global_batch=4, seed=SEED))
        losses = {}
        for dev in ("cpu", "cuda"):
            model = Model(cfg, device=dev)
            state = train.init_state(Model(cfg, device="cpu"),
                                     OptConfig(**kw), seed=SEED)
            state = tr.map_tree(lambda t: t.to(dev), state)
            step = train.make_train_step(model, OptConfig(**kw), ctx, lr)
            zero_training_counters()
            losses[dev] = []
            for i in range(3):
                state, metrics = step(state, smoke_train_batch(
                    torch, cfg, src, i, dev))
                losses[dev].append(float(metrics["loss"]))
            counts = read_training_counters()
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(losses["cuda"], losses["cpu"]))
        steps[name] = {"arch": arch, "losses_cuda": losses["cuda"],
                       "losses_cpu": losses["cpu"], "max_rel_err": rel,
                       "launches": counts}
        check(rel <= 1e-4, f"parity_train steps {name}: loss rel err {rel}")
        check(counts["K1_bwd"] > 0 and (counts["K8b"] > 0)
              == (name == "norm_vrp"),
              f"parity_train steps {name}: launches {counts}")
    emit({"phase": "parity_train", "grads": grads_rows, "steps": steps,
          "seconds": time.monotonic() - t0})
    rows = {"olmo": k1_bwd_case(torch, "olmo_train", 4, 16, 16, 2048, 128,
                                "bfloat16")}
    k1_bwd_case(torch, "rg_local_d256", 2, 10, 1, 2048, 256, "bfloat16",
                window=2048)
    k1_bwd_case(torch, "danube_d120_gqa4", 2, 32, 8, 2048, 120, "bfloat16",
                window=4096)
    rows["moe"] = k1_bwd_case(torch, "qwen3_train_gqa8", FAM_MOE_B, 32, 4,
                              FAM_MOE_S, 128, "bfloat16")
    k1_bwd_case(torch, "whisper_enc", FAM_WH_B, 8, 8, ENC_FRAMES, 64,
                "bfloat16", causal=False)
    k1_bwd_case(torch, "whisper_dec", FAM_WH_B, 8, 8, FAM_WH_S, 64,
                "bfloat16")
    rows["whisper"] = k1_bwd_case(torch, "whisper_xattn", FAM_WH_B, 8, 8,
                                  FAM_WH_S, 64, "bfloat16", causal=False,
                                  Skv=ENC_FRAMES)
    k1_bwd_case(torch, "olmo_train_f32", 4, 16, 16, 2048, 128, "float32")
    k1_bwd_case(torch, "rg_local_d256_f32", 2, 10, 1, 2048, 256, "float32",
                window=2048)
    k1_bwd_case(torch, "danube_d120_gqa4_f32", 2, 32, 8, 2048, 120,
                "float32", window=4096)
    return rows


TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 2048, 20   # train: olmo_1b's batch
# K1's backward kernels by name: the pre-pass (deltas, lse), and dK / dV
# and dQ of each body (flash_attention_bwd.cu)
K1_BWD_KERNELS = re.compile(
    r"prep_kernel|dkdv_(kernel|wgmma)|dq_(kernel|wgmma)")


def phase_train(torch, np):
    """``train_loop`` on olmo_1b at full width and depth in bf16 (16
    layers, d_model 2048, 16 heads x 128, vocab 50304; seeded random
    weights): AdamW on ``SyntheticLM`` at batch 4 x 2048, 20 steps
    (``warmup_cosine`` to a peak lr of 1e-3 after 2 steps), a checkpoint
    every 10. The loss at step 19 must be below step 0's. Then
    the step-20 checkpoint is removed and a second ``train_loop`` on the
    same directory restores step 10 and runs to 20: its losses of steps
    10..19 within 1e-2 relative of the first run's (bf16 weights; torch's
    scatter-add in the embedding's backward may add in another order, so
    the updates need not be bit-equal; the largest difference and
    whether every loss was bit-equal are printed). Then one step more of
    ``make_train_step``, timed in parts (forward, backward, optimizer)
    by CUDA events its ``mark`` hook records, and one more profiled:
    K1's backward kernels' share of device time. Every K1_bwd launch of
    the run must take the wgmma body. Prints the
    step's ms (median of steps 2..19), tokens/s, peak
    ``max_memory_allocated`` and the card."""
    import functools
    import shutil
    import tempfile

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import RunCtx
    from repro_torch.optim import OptConfig
    from repro_torch.optim.schedule import warmup_cosine

    t0 = time.monotonic()
    cfg = get_config("olmo_1b")
    model = Model(cfg, device="cuda")
    opt_cfg, ctx = OptConfig(), RunCtx()
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                          global_batch=TRAIN_B, seed=SEED)
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    loop = train.TrainLoopConfig(steps=TRAIN_STEPS, ckpt_every=10,
                                 ckpt_dir=ckdir, log_every=10)
    lr = functools.partial(warmup_cosine, peak_lr=1e-3, warmup_steps=2,
                           total_steps=TRAIN_STEPS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_training_counters()
    zero_bodies(fa.flash_attention_bwd)
    state, hist = train.train_loop(model, opt_cfg, ctx, data_cfg, loop,
                                   lr_fn=lr)
    torch.cuda.synchronize()
    launches = read_training_counters()
    bwd_bodies = dict(fa.flash_attention_bwd.launches_by_body)
    peak = torch.cuda.max_memory_allocated()
    run_s = time.monotonic() - t0
    losses = [h["loss"] for h in hist]
    dts = sorted(h["dt"] for h in hist[2:])
    step_s = float(np.median(dts))
    check(losses[-1] < losses[0],
          f"train: loss did not fall ({losses[0]} -> {losses[-1]})")
    check(launches["K1"] == launches["K1_bwd"] == cfg.n_layers * TRAIN_STEPS
          and bwd_bodies["wgmma"] == launches["K1_bwd"],
          f"train: launches {launches}, K1_bwd by body {bwd_bodies}; "
          f"expected {cfg.n_layers} a step, all wgmma")
    del state
    torch.cuda.empty_cache()
    shutil.rmtree(os.path.join(ckdir, f"step_{TRAIN_STEPS}"))
    t1 = time.monotonic()
    state, hist2 = train.train_loop(model, opt_cfg, ctx, data_cfg, loop,
                                    lr_fn=lr)
    resume_s = time.monotonic() - t1
    resumed = [h["loss"] for h in hist2]
    diffs = [abs(a - b) / abs(b) for a, b in zip(resumed, losses[10:])]
    check([h["step"] for h in hist2] == list(range(10, TRAIN_STEPS))
          and max(diffs) <= 1e-2,
          f"train: the resumed run's losses {resumed} vs {losses[10:]}")
    shutil.rmtree(ckdir, ignore_errors=True)

    # one more step of make_train_step, in parts, then under the profiler
    batch = SyntheticLM(data_cfg, device="cuda").batch_at(TRAIN_STEPS)
    events = {n: torch.cuda.Event(enable_timing=True)
              for n in ("start", "loss", "grads", "update")}
    step = train.make_train_step(model, opt_cfg, ctx, lr,
                                 mark=lambda n: events[n].record())
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    parts = {"forward_ms": events["start"].elapsed_time(events["loss"]),
             "backward_ms": events["loss"].elapsed_time(events["grads"]),
             "optimizer_ms": events["grads"].elapsed_time(events["update"])}
    step = train.make_train_step(model, opt_cfg, ctx, lr)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in dev)
    bwd_us = sum(e.self_device_time_total for e in dev
                 if K1_BWD_KERNELS.search(e.key))
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    del state
    torch.cuda.empty_cache()
    emit({"phase": "train", "arch": "olmo_1b", "layers": cfg.n_layers,
          "dtype": cfg.dtype, "batch": [TRAIN_B, TRAIN_S],
          "steps": TRAIN_STEPS, "optimizer": "adamw",
          "lr": "warmup_cosine peak 1e-3, warmup 2",
          "losses": losses, "loss_0": losses[0], "loss_19": losses[-1],
          "step_ms_median_2_19": step_s * 1e3,
          "tokens_per_s": TRAIN_B * TRAIN_S / step_s,
          "split_ms": parts, "device_ms_profiled_step": total_us / 1e3,
          "k1_bwd_share_of_device_time": bwd_us / total_us,
          "top_device_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3
                                    for e in top},
          "peak_memory_bytes": peak, "launches": launches,
          "k1_bwd_launches_by_body": bwd_bodies,
          "resumed_from": 10, "resumed_losses": resumed,
          "resume_max_rel_diff": max(diffs),
          "resume_bit_equal": resumed == losses[10:],
          "resume_first_step_bit_equal": resumed[0] == losses[10],
          "resume_tol": 1e-2, "run_s": run_s, "resume_s": resume_s,
          "card": nvidia_smi()})
    return launches


# train_families: (arch, layers (None: full depth), batch, sequence,
# ce_chunk, remat, steps). xlstm_1_3b's sequence is cut from olmo's 2048
# to 1024, its depth to XLSTM_LAYERS, and it takes 3 steps: its sLSTM runs
# 1024 cells one by one, forward and backward. It recomputes each layer in
# the backward pass: without remat the 48 layers' saved activations (the
# chunkwise mLSTM's f32 states and products, the sLSTM's cells) ran the
# card out of its 80 GB in the forward pass. qwen3_moe's depth is cut to 3 of 48
# layers: a layer holds 0.62 B parameters and the embedding and head
# 0.62 B more, and the eager AdamW step holds the old and the new
# params and f32 moments at once beside the bf16 grads (22 bytes a
# parameter) and f32 temporaries of a (layers, 128, 2048, 768) expert
# leaf: 4 layers (3.1 B parameters) ran out of the 80 GB in the
# optimizer. whisper_base runs 448 decoder tokens (its longest) over
# 1500 frames (a full 30 s window).
FAM_MOE_B, FAM_MOE_S, FAM_MOE_LAYERS = 4, 2048, 3
FAM_WH_B, FAM_WH_S = 8, 448
TRAIN_FAMILIES = (("xlstm_1_3b", XLSTM_LAYERS, 4, 1024, 0, "full", 3),
                  ("whisper_base", None, FAM_WH_B, FAM_WH_S, 0, "none", 4),
                  ("qwen3_moe_30b_a3b", FAM_MOE_LAYERS, FAM_MOE_B,
                   FAM_MOE_S, 512, "none", 4))


def phase_train_families(torch, np):
    """``make_train_step`` at full width in bf16 (AdamW, f32 moments,
    constant lr 1e-3, seeded random weights) on each family that the
    train phase does not cover: xlstm_1_3b at XLSTM_LAYERS of 48 (14
    mLSTM, 2 sLSTM) on a ``SyntheticLM`` batch of 4 x 1024, each layer
    recomputed in the backward pass (``remat="full"``); whisper_base
    at full depth (6 + 6) on 8 x 448 decoder tokens over frames (8,
    1500, 512) drawn from a generator seeded with SEED; qwen3_moe_30b_a3b
    at full width, depth cut to FAM_MOE_LAYERS of 48, on 4 x 2048 with
    the cross-entropy in chunks of 512 (the MoE routed with the capacity
    factor). Every step of a config takes the same seeded batch, so its
    losses compare like with like (from one batch to the next the loss
    of a random model moves more than a few steps move it). For each:
    the losses (the last must be below the first),
    the step's ms (median of the steps after the first, host clock to a
    synced loss) and tokens/s (decoder tokens), one step's forward /
    backward / optimizer ms from ``make_train_step(mark=...)``'s CUDA
    events, the peak ``max_memory_allocated``, and K1 / K1_bwd launches
    by body, counted from 0 before the config's steps: whisper 18 of each
    a step (6 encoder, 6 self, 6 cross), qwen3_moe one a layer a step,
    all wgmma; xlstm none (no attention). Returns the launches by
    config."""
    import dataclasses
    import functools

    from repro_torch import tree as tr
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import RunCtx
    from repro_torch.optim import OptConfig
    from repro_torch.optim.schedule import constant

    out = {}
    for arch, layers, B, S, ce_chunk, remat, steps in TRAIN_FAMILIES:
        t0 = time.monotonic()
        cfg = get_config(arch)
        full = cfg.n_layers
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        model = Model(cfg, device="cuda")
        opt_cfg, ctx = OptConfig(), RunCtx(ce_chunk=ce_chunk, remat=remat)
        src = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                     global_batch=B, seed=SEED),
                          device="cuda")
        batch = src.batch_at(0)
        if cfg.enc_dec:
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            batch["frames"] = torch.randn((B, ENC_FRAMES, cfg.d_model),
                                          generator=gen, device="cuda")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = train.init_state(model, opt_cfg, seed=SEED)
        n_params = sum(t.numel() for t in tr.leaves(state["params"]))
        events = {n: torch.cuda.Event(enable_timing=True)
                  for n in ("start", "loss", "grads", "update")}
        step = train.make_train_step(
            model, opt_cfg, ctx, functools.partial(constant, peak_lr=1e-3),
            mark=lambda n: events[n].record())
        zero_training_counters()
        zero_bodies(fa.flash_attention)
        zero_bodies(fa.flash_attention_bwd)
        losses, dts = [], []
        for _ in range(steps):
            t1 = time.monotonic()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            dts.append(time.monotonic() - t1)
        torch.cuda.synchronize()
        launches = read_training_counters()
        bodies = {"K1": dict(fa.flash_attention.launches_by_body),
                  "K1_bwd": dict(fa.flash_attention_bwd.launches_by_body)}
        parts = {"forward_ms": events["start"].elapsed_time(events["loss"]),
                 "backward_ms": events["loss"].elapsed_time(events["grads"]),
                 "optimizer_ms": events["grads"].elapsed_time(
                     events["update"])}
        peak = torch.cuda.max_memory_allocated()
        del state, batch
        torch.cuda.empty_cache()
        step_s = float(np.median(dts[1:]))
        per_step = {"xlstm_1_3b": 0, "whisper_base": 3 * cfg.n_layers,
                    "qwen3_moe_30b_a3b": cfg.n_layers}[arch]
        row = {"phase": "train_families", "arch": arch,
               "layers": cfg.n_layers if not layers
               else f"{layers} of {full} (depth cut)",
               "dtype": cfg.dtype, "batch": [B, S], "steps": steps,
               "optimizer": "adamw", "lr": "constant 1e-3",
               "ce_chunk": ce_chunk, "remat": remat, "params": n_params,
               "losses": losses, "step_ms": [d * 1e3 for d in dts],
               "step_ms_median_after_first": step_s * 1e3,
               "tokens_per_s": B * S / step_s, "split_ms_last_step": parts,
               "peak_memory_bytes": peak, "launches": launches,
               "launches_by_body": bodies,
               "seconds": time.monotonic() - t0, "card": nvidia_smi()}
        if cfg.enc_dec:
            row["frames"] = [B, ENC_FRAMES, cfg.d_model]
        emit(row)
        check(all(math.isfinite(x) for x in losses)
              and losses[-1] < losses[0],
              f"train_families {arch}: losses {losses}")
        check(launches["K1"] == launches["K1_bwd"] == per_step * steps
              and bodies["K1"]["wgmma"] == bodies["K1_bwd"]["wgmma"]
              == per_step * steps,
              f"train_families {arch}: launches {launches}, by body "
              f"{bodies}; expected {per_step} a step, all wgmma")
        out[arch] = launches
    return out


# ---------------------------------------------------------------------------
# tensor parallelism: parity_tp, tp_serve (and --tp-cards)
# ---------------------------------------------------------------------------

TP = 2                              # ranks on the one card (gloo)
TP_ARCHS = ("olmo_1b", "yi_6b", "gemma_7b")
TP_MODES = ("greedy_preempt", "seeded", "spec3", "int8", "fp8", "prefix")
TP_TIMEOUT_S = 900                  # a rank group's whole run
TP_CARDS_TIMEOUT_S = 240            # --tp-cards: a rank group's run
SERVE_GEO = dict(num_slots=8, block_size=16, num_blocks=1024, max_len=640)
TP_TIMED_STEPS = 10                 # decode steps timed for the collectives


def tp_parity_case(arch, mode, vocab, seed=None):
    """(engine kwargs, prompts, sampling kwargs) of one parity_tp case
    (or of another phase's, drawn from ``seed``): smoke geometry, ragged
    prompts in one prefill bucket, seeded rows beside greedy ones; a
    tight pool preempts (greedy_preempt, int8), a shared block-aligned
    prefix and a repeated 8-token prompt give partial and full prefix
    hits with a COW copy; "static" is the lockstep backend; "overlap"
    the tight pool with ``overlap=True``."""
    import numpy as np

    if seed is None:
        seed = SEED + TP_ARCHS.index(arch) * 10 + TP_MODES.index(mode)
    rng = np.random.default_rng(seed)
    lens = (5, 7, 8, 6, 8, 7)
    prompts = [list(map(int, rng.integers(0, vocab, n))) for n in lens]
    tight = dict(num_slots=3, block_size=4, num_blocks=9, max_len=48)
    roomy = dict(num_slots=3, block_size=4, num_blocks=33, max_len=48)
    seeded = [dict(), dict(temperature=0.9, top_k=12, seed=3),
              dict(temperature=1.0, top_p=0.85, seed=5), dict(),
              dict(temperature=0.7, seed=11), dict()]
    greedy = [dict()] * len(prompts)
    samp = [dict(s, max_tokens=8) for s in
            (greedy if mode in ("greedy_preempt", "prefix") else seeded)]
    if mode == "greedy_preempt":
        return tight, prompts, samp
    if mode == "overlap":
        return dict(tight, overlap=True), prompts, samp
    if mode == "seeded":
        return roomy, prompts, samp
    if mode == "spec3":
        phrase = list(map(int, rng.integers(0, vocab, 3)))
        return dict(roomy, spec_tokens=3), [p[:2] + phrase * 2
                                            for p in prompts], samp
    if mode in ("int8", "fp8"):
        return dict(tight if mode == "int8" else roomy,
                    kv_dtype=mode), prompts, samp
    if mode == "static":
        return dict(backend="static", num_slots=3, max_len=48), prompts, \
            samp
    head = list(map(int, rng.integers(0, vocab, 4)))       # "prefix"
    prompts = [head + p[:n - 4] for p, n in zip(prompts, lens)]
    prompts[3] = list(prompts[2])
    return roomy, prompts, samp


def tp_stats_view(st):
    """The scheduling counters a TP engine must share with a
    single-device one (the paged and the static backend's)."""
    out = {k: st[k] for k in ("steps", "preemptions", "batches",
                              "prefill_calls", "prefill_tokens") if k in st}
    if "prefix_cache" in st:
        out["prefix_cache"] = {k: st["prefix_cache"][k] for k in (
            "lookups", "hits", "hit_tokens", "cow_copies")}
    if "spec" in st:
        out["spec"] = {k: st["spec"][k] for k in (
            "steps", "proposed", "accepted", "emitted")}
    return out


def rank_setup():
    """A spawned rank: the port on the path, TF32 off (the parent's
    settings do not travel to a spawned process)."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch


def kernel_counts():
    """Every K1 / K2 / K3 / K4 / K5 counter, K1's, K3's and K5's by
    body."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rglru_scan as k5

    return {"K1": dict(fa.flash_attention.launches_by_body),
            "K2": pa.paged_decode_attention.launches,
            "K2_combine": pa.paged_decode_combine.launches,
            "K3": dict(pa.paged_verify_attention.launches_by_body),
            "K4_decode": pa.paged_decode_attention.k4_launches,
            "K4_verify": pa.paged_verify_attention.k4_launches,
            "K5": dict(k5.rglru_scan.launches_by_body)}


def parity_tp_rank(mesh, cases):
    """One rank of parity_tp: every case through the Engine over the
    mesh, on the smoke params drawn on the CPU from the seed (the
    reference engine's)."""
    torch = rank_setup()
    from repro_torch.configs import get_config
    from repro_torch.launch.engine import Engine, EngineConfig, SamplingParams
    from repro_torch.models import weights
    from repro_torch.models.model import Model

    out = {}
    for arch, mode in cases:
        print(f"[tp rank {mesh.rank}] parity_tp {arch} {mode}",
              file=sys.stderr, flush=True)
        cfg = get_config(arch).smoke()
        model = Model(cfg, device=mesh.device)
        params = weights.to_device(Model(cfg, device="cpu").init(seed=SEED),
                                   mesh.device)
        kw, prompts, samp = tp_parity_case(arch, mode, cfg.vocab_size)
        eng = Engine(model, params, EngineConfig(**kw, mesh=mesh),
                     device=mesh.device)
        toks = eng.generate(prompts, [SamplingParams(**s) for s in samp])
        torch.cuda.synchronize()
        st = eng.stats()
        out[(arch, mode)] = (toks, tp_stats_view(st), st["blocks_used"],
                             st["pool_bytes"], st["tp"])
    out["launches"] = kernel_counts()
    return out


def run_in_thread(fn):
    """Start ``fn()`` in a thread; returns a getter that joins it and
    returns its result or raises its exception."""
    import threading

    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:          # re-raised by the getter
            box["err"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()

    def get():
        th.join()
        if "err" in box:
            raise box["err"]
        return box["out"]

    return get


def phase_parity_tp(torch, np, tp=TP, timeout_s=TP_TIMEOUT_S):
    """Smoke configs in f32 over ``tp`` ranks (gloo on the one card, NCCL
    on cards of their own): olmo_1b, yi_6b and gemma_7b in every
    TP_MODES case; both ranks' tokens and scheduling counters equal the
    single-device engine's on the CPU, no rank leaks, each rank's pool
    is 1 / tp of the single-device one, 2 L + 2 collectives a step."""
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch.engine import Engine, EngineConfig, SamplingParams
    from repro_torch.models.model import Model

    t0 = time.monotonic()
    cases = [(a, m) for a in TP_ARCHS for m in TP_MODES]
    ranks = run_in_thread(lambda: meshlib.launch(
        parity_tp_rank, tp, "cuda", args=(cases,), timeout_s=timeout_s))
    want = {}
    for arch, mode in cases:
        cfg = get_config(arch).smoke()
        model = Model(cfg, device="cpu")
        kw, prompts, samp = tp_parity_case(arch, mode, cfg.vocab_size)
        eng = Engine(model, model.init(seed=SEED), EngineConfig(**kw),
                     device="cpu")
        toks = eng.generate(prompts, [SamplingParams(**s) for s in samp])
        st = eng.stats()
        want[(arch, mode)] = (toks, tp_stats_view(st), st["pool_bytes"])
    got = ranks()
    for arch in TP_ARCHS:
        cfg = get_config(arch).smoke()
        row = {"phase": "parity_tp", "config": cfg.name, "dtype": cfg.dtype,
               "tp": tp, "backend": got[0][(arch, TP_MODES[0])][4]["backend"],
               "captured_step": got[0][(arch, TP_MODES[0])][4][
                   "captured_step"],
               "tokens_equal": {}, "stats_equal": {}, "preemptions": {},
               "prefix_hits": got[0][(arch, "prefix")][1]["prefix_cache"],
               "collectives_per_step": {}}
        for mode in TP_MODES:
            toks, st, pool = want[(arch, mode)]
            rs = [g[(arch, mode)] for g in got]
            row["tokens_equal"][mode] = all(r[0] == toks for r in rs)
            row["stats_equal"][mode] = all(r[1] == st for r in rs)
            row["preemptions"][mode] = st.get("preemptions")
            row["collectives_per_step"][mode] = rs[0][4][
                "collectives_per_step"]
            check(row["tokens_equal"][mode] and row["stats_equal"][mode],
                  f"parity_tp {arch} {mode}: a rank's tokens or stats "
                  f"differ from the cpu engine's ({[r[1] for r in rs]} vs "
                  f"{st})")
            check(all(r[2] == 0 for r in rs),
                  f"parity_tp {arch} {mode}: a rank leaked blocks")
            check(all(r[3] * tp == pool for r in rs),
                  f"parity_tp {arch} {mode}: rank pool bytes "
                  f"{[r[3] for r in rs]} are not 1/{tp} of {pool}")
            check(rs[0][4]["collectives_per_step"] == 2 * cfg.n_layers + 2,
                  f"parity_tp {arch} {mode}: "
                  f"{rs[0][4]['collectives_per_step']} collectives a step")
        check(row["preemptions"]["greedy_preempt"] > 0,
              f"parity_tp {arch}: the tight pool never preempted")
        check(row["prefix_hits"]["cow_copies"] > 0,
              f"parity_tp {arch}: no full prefix hit copied its tail")
        emit(row)
    runs = [g["launches"] for g in got]
    emit({"phase": "parity_tp", "launches_by_rank": runs,
          "seconds": time.monotonic() - t0})
    for r, n in enumerate(runs):
        check(sum(n["K1"].values()) > 0 and n["K2"] > 0
              and sum(n["K3"].values()) > 0 and n["K4_decode"] > 0
              and n["K4_verify"] > 0,
              f"parity_tp: rank {r} did not launch every kernel {n}")


def first_decode_logits(torch, model, params, ctx, prompts, bs=16):
    """Logits of a right-padded prefill of ``prompts`` (one row each at
    its last position) and of the first paged decode step after it, over
    a pool built for them (this rank's head shard under ``ctx.shard``);
    the decode step feeds each prompt's first token. Returns (prefill,
    decode) f32 logits on the host, and the pools, table, lengths and
    tokens for ``collective_share``."""
    from repro_torch.models import paged_kv

    B = len(prompts)
    S = max(len(p) for p in prompts)
    nbc = -(-S // bs)
    width = nbc * bs
    dev = model.device
    toks = torch.zeros((B, width), dtype=torch.int32)
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    for r, p in enumerate(prompts):
        toks[r, :len(p)] = torch.tensor(p, dtype=torch.int32)
    ids = (1 + torch.arange(B * nbc, dtype=torch.int32)).reshape(B, nbc)
    nbmax = nbc + 1
    table = torch.zeros((B, nbmax), dtype=torch.int32)
    table[:, :nbc] = ids
    table[:, nbc] = B * nbc + 1 + torch.arange(B, dtype=torch.int32)
    layout = paged_kv.PagedLayout(num_slots=B, num_blocks=B * nbmax + 1,
                                  block_size=bs, max_len=nbmax * bs)
    length = lens.to(dev)
    pl, dense = model.prefill(params, {"tokens": toks.to(dev)}, ctx,
                              max_len=width, length=length,
                              rows=length - 1)
    pools = model.pack_prefill_into_paged(
        layout, model.init_paged_cache(layout, shard=ctx.shard), dense,
        torch.arange(B, dtype=torch.int32, device=dev),
        torch.ones(B, dtype=torch.bool, device=dev), ids.to(dev))
    feed = toks[:, :1].to(dev)
    step = (pools, table.to(dev), length, feed)
    dl, _ = model.decode_step_paged(params, *step[:3], feed, ctx)
    torch.cuda.synchronize()
    return pl.float().cpu().numpy(), dl.float().cpu().numpy(), step


def collective_share(torch, model, params, ctx, step, n=TP_TIMED_STEPS):
    """CUDA-event time of ``n`` eager paged decode steps (one a call, the
    same inputs) and of the collectives inside them (``TPStats.timing``):
    (step ms, collective ms a step, collectives a step)."""
    pools, table, lengths, feed = step
    stats = ctx.shard.stats
    model.decode_step_paged(params, pools, table, lengths, feed, ctx)
    torch.cuda.synchronize()
    stats.timing, calls0 = [], stats.collectives
    marks = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        model.decode_step_paged(params, pools, table, lengths, feed, ctx)
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize()
    timing, stats.timing = stats.timing, None
    step_ms = sum(a.elapsed_time(b) for a, b in marks) / n
    coll_ms = sum(a.elapsed_time(b) for a, b in timing) / n
    return step_ms, coll_ms, (stats.collectives - calls0) / n


def tp_serve_rank(mesh, arch, turns, logit_prompts):
    """One rank of tp_serve: ``turns`` ((name, engine kwargs, prompts,
    news, warm) each) through an Engine over the mesh at serve's
    geometry, the model at full width from the seed; then the first
    decode step's logits and the collectives' share of an eager step.
    Returns what the parent checks."""
    torch = rank_setup()
    from repro_torch.configs import get_config
    from repro_torch.launch.engine import Engine, EngineConfig
    from repro_torch.models.model import Model

    cfg = get_config(arch)
    model = Model(cfg, device=mesh.device)
    params = model.init(seed=SEED)
    out = {"turns": {}, "device": torch.cuda.get_device_name(mesh.device)}
    keep = None
    for name, kw, prompts, news, warm in turns:
        print(f"[tp rank {mesh.rank}] tp_serve {arch} {name}",
              file=sys.stderr, flush=True)
        eng = Engine(model, params, EngineConfig(**SERVE_GEO, **kw,
                                                 mesh=mesh),
                     device=mesh.device)
        outs, secs, runs, k1_bodies, st = serve_turn(torch, eng, prompts,
                                                     news, warm)
        out["turns"][name] = {
            "outs": outs, "seconds": secs, "launches": runs,
            "k1_bodies": k1_bodies,
            "stats": {k: st[k] for k in (
                "steps", "graph_replays", "eager_decode_steps",
                "pool_bytes", "blocks_used", "preemptions", "tp",
                "device_s")},
            "spec_steps": st["spec"]["steps"] if "spec" in st else 0,
            "ttft_p50_s": st["latency"]["ttft"]["p50_s"],
            "tpot_p50_s": st["latency"]["tpot"]["p50_s"]}
        if keep is None:
            keep = eng.backend
        else:
            del eng
    del params                              # the engine keeps its slices
    pl, dl, step = first_decode_logits(torch, model, keep.params, keep.ctx,
                                       logit_prompts)
    out["logits"] = (pl, dl)
    out["timing"] = collective_share(torch, model, keep.params, keep.ctx,
                                     step)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(mesh.device) / 1e9
    return out


def agreement(outs, base):
    """Requests whose tokens equal the T = 1 run's, and the first token
    index (a decode step) at which any request differs (None if none)."""
    same = sum(o == b for o, b in zip(outs, base))
    first = [next((i for i, (x, y) in enumerate(zip(o, b)) if x != y),
                  None if len(o) == len(b) else min(len(o), len(b)))
             for o, b in zip(outs, base)]
    firsts = [f for f in first if f is not None]
    return same / len(base), (min(firsts) if firsts else None)


def tp_turns(np, prompts, news, warm, overlap=False):
    """tp_serve's turns: serve's 16 requests (greedy, bf16 pool), 8 of
    spec_serve's shared-prefix requests with spec_tokens 4 (suffix
    prefills on K3's wgmma body, verify steps on its split body) and
    serve's first 8 requests over an fp8 pool (K4); with ``overlap``
    serve's 16 again on ``overlap=True``."""
    sp, sn, sw = spec_workload(np)
    return [("greedy", {}, prompts, news, warm),
            ("spec", dict(spec_tokens=4, drafter="ngram"), sp[:HALF],
             sn[:HALF], sw),
            ("fp8", dict(kv_dtype="fp8"), prompts[:HALF], news[:HALF],
             warm)] \
        + ([("overlap", dict(overlap=True), prompts, news, warm)]
           if overlap else [])


def phase_tp_serve(torch, np, arch, tp, turns, base_outs, base_logits,
                   base_pool_bytes, logit_prompts, timeout_s=TP_TIMEOUT_S):
    """``arch`` at full width in bf16 over ``tp`` ranks at serve's
    geometry: per turn tok/s and each rank's launches by body; the
    greedy turn's tokens against the single-device run's (``base_outs``:
    agreement and the first differing step, reported: the reduction
    order moves bf16 roundings), the first prefill and decode logits
    within the bf16 tolerance of the single-device model's (relative to
    the largest logit), each rank's pool exactly 1 / tp of the
    single-device pool, no leaked block, 2 L + 2 collectives a step and
    their share of an eager step's CUDA-event time. Returns the launches
    summed over ranks by kernel row."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch import mesh as meshlib

    cfg = get_config(arch)
    t0 = time.monotonic()
    got = meshlib.launch(tp_serve_rank, tp, "cuda",
                         args=(arch, turns, logit_prompts),
                         timeout_s=timeout_s)
    wall = time.monotonic() - t0
    totals = {"K1": 0, "K2": 0, "K2_combine": 0, "K3": 0, "K3_suffix": 0,
              "K4_decode": 0}
    L = cfg.n_layers
    for name, *_ in turns:
        rs = [g["turns"][name] for g in got]
        r0 = rs[0]
        ntok = sum(len(o) for o in r0["outs"])
        sts = [r["stats"] for r in rs]
        row = {"phase": "tp_serve", "config": cfg.name, "dtype": cfg.dtype,
               "tp": tp, "turn": name, "backend": sts[0]["tp"]["backend"],
               "captured_step": sts[0]["tp"]["captured_step"],
               "requests": len(r0["outs"]), "tokens": ntok,
               "seconds": r0["seconds"], "tok_s": ntok / r0["seconds"],
               "ttft_p50_s": r0["ttft_p50_s"], "tpot_p50_s": r0["tpot_p50_s"],
               "steps": sts[0]["steps"],
               "graph_replays": [s["graph_replays"] for s in sts],
               "eager_decode_steps": [s["eager_decode_steps"] for s in sts],
               "collectives_per_step": sts[0]["tp"]["collectives_per_step"],
               "collective_bytes_per_rank": sts[0]["tp"]["collective_bytes"],
               "pool_bytes_per_rank": [s["pool_bytes"] for s in sts],
               "blocks_used": [s["blocks_used"] for s in sts],
               "launches_by_rank": [{k: v for k, v in r["launches"].items()}
                                    for r in rs],
               "k1_launches_by_body": [r["k1_bodies"] for r in rs],
               "ranks_tokens_equal": all(r["outs"] == r0["outs"]
                                         for r in rs)}
        check(row["ranks_tokens_equal"],
              f"tp_serve {arch} tp={tp} {name}: the ranks' tokens differ")
        check(all(n == 0 for n in row["blocks_used"]),
              f"tp_serve {arch} {name}: blocks leaked {row['blocks_used']}")
        check(row["collectives_per_step"] == 2 * L + 2,
              f"tp_serve {arch} {name}: {row['collectives_per_step']} "
              f"collectives a step, expected {2 * L + 2}")
        if name != "spec":                  # a verify step is never fused
            key = "graph_replays" if row["backend"] == "nccl" \
                else "eager_decode_steps"
            check(all(s[key] == s["steps"] > 0 for s in sts),
                  f"tp_serve {arch} {name}: {sts[0]['steps']} steps, "
                  f"{row['graph_replays']} replays, "
                  f"{row['eager_decode_steps']} eager")
        for r in rs:
            runs, bodies = r["launches"], r["k1_bodies"]
            check(bodies["simt"] == 0 and runs["K3_bodies"]["simt"] == 0,
                  f"tp_serve {arch} {name}: a bf16 kernel ran simt "
                  f"{bodies} {runs['K3_bodies']}")
            # the spec turn's admissions all hit the warm-up's prefix:
            # suffix prefills (K3), no full prefill
            check(name == "spec" or bodies["wgmma"] == runs["K1"] > 0,
                  f"tp_serve {arch} {name}: no K1 launch {bodies}")
        if name == "greedy":
            check(all(p == base_pool_bytes // tp and p * tp ==
                      base_pool_bytes for p in row["pool_bytes_per_rank"]),
                  f"tp_serve {arch}: rank pools {row['pool_bytes_per_rank']}"
                  f" are not 1/{tp} of serve's {base_pool_bytes}")
            rate, first = agreement(r0["outs"], base_outs)
            row.update(requests_equal_t1=rate, first_differing_step=first,
                       pool_bytes_t1=base_pool_bytes)
            for r in rs:
                check(r["launches"]["K2"] == r["launches"]["K2_combine"]
                      == L * r["stats"]["steps"] > 0,
                      f"tp_serve {arch}: K2 / combine "
                      f"{r['launches']['K2']} / "
                      f"{r['launches']['K2_combine']} in "
                      f"{r['stats']['steps']} steps")
        if name == "spec":
            # the verify window (5 rows) runs the body verify_body picks
            # at the rank's group (split below SPLIT_PAIRS pairs a kv
            # head: olmo's group 1; yi's group 8 takes the tensor cores),
            # every suffix prefill "wgmma"
            vbody = "split" if 5 * (cfg.n_heads // cfg.n_kv_heads) \
                < pa.SPLIT_PAIRS else "wgmma"
            for r in rs:
                by = r["launches"]["K3_bodies"]
                verify = r["spec_steps"] * L
                suffix = by["wgmma"] - (verify if vbody == "wgmma" else 0)
                check(by[vbody] >= verify and by["simt"] == 0
                      and by["split"] == (verify if vbody == "split" else 0)
                      and suffix > 0 and suffix % L == 0,
                      f"tp_serve {arch} spec: K3 bodies {by}, {verify} "
                      f"verify launches expected on {vbody}")
                r["k3_split"] = (verify, suffix)
            row["k3_launches_by_body"] = [r["launches"]["K3_bodies"]
                                          for r in rs]
            row["verify_body"] = vbody
        if name == "fp8":
            check(all(r["launches"]["K4_decode"] > 0
                      and r["launches"]["K2"] == 0 for r in rs),
                  f"tp_serve {arch} fp8: decode did not run K4")
        if name == "overlap":
            row["tokens_equal_overlap_off"] = \
                r0["outs"] == got[0]["turns"]["greedy"]["outs"]
            check(row["tokens_equal_overlap_off"],
                  f"tp_serve {arch} overlap: tokens differ from the "
                  "greedy turn's")
        for r in rs:
            totals["K1"] += r["launches"]["K1"]
            totals["K2"] += r["launches"]["K2"]
            totals["K2_combine"] += r["launches"]["K2_combine"]
            verify, suffix = r.get("k3_split", (0, 0))
            totals["K3"] += verify
            totals["K3_suffix"] += suffix
            totals["K4_decode"] += r["launches"]["K4_decode"]
        emit(row)
    pl0, dl0 = base_logits
    errs = []
    for g in got:
        pl, dl = g["logits"]
        errs.append([float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))
                     for a, b in ((pl, pl0), (dl, dl0))])
    step_ms, coll_ms, calls = got[0]["timing"]
    emit({"phase": "tp_serve", "config": cfg.name, "tp": tp,
          "summary": True, "seconds": wall, "device": got[0]["device"],
          "logits_rel_err_by_rank": errs, "tol": TOL["bfloat16"],
          "eager_step_ms": step_ms, "collective_ms_per_step": coll_ms,
          "collective_share": coll_ms / step_ms,
          "collectives_timed_per_step": calls,
          "timing_by_rank": [g["timing"] for g in got],
          "peak_mem_gb_by_rank": [g["peak_mem_gb"] for g in got]})
    check(all(e <= TOL["bfloat16"] for es in errs for e in es),
          f"tp_serve {arch}: logits differ from the single-device model's "
          f"by {errs} (relative to the largest)")
    check(calls == 2 * L + 2, f"tp_serve {arch}: {calls} collectives in a "
          "timed step")
    return totals


def tp_base(torch, model, params, logit_prompts, geo=SERVE_GEO):
    """The single-device references of tp_serve: the first prefill and
    decode logits (``first_decode_logits``) and the pool bytes of serve's
    geometry."""
    from repro_torch.models import paged_kv, transformer

    pl, dl, _ = first_decode_logits(torch, model, params,
                                    transformer.RunCtx(), logit_prompts)
    layout = paged_kv.PagedLayout(**geo)
    pool = paged_kv.pool_bytes(transformer.init_paged_cache(
        model.cfg, layout, torch.device("meta")))
    return (pl, dl), pool


def phase_tp_kernels(torch, np, prompts):
    """K1, K2 with its combine, K3 (verify: split; suffix: wgmma) and K4
    at a rank's shapes in tp_serve (olmo_1b over 2 ranks: 8 of the 16
    heads, 8 of the 16 kv heads), on the same inputs as the kernels
    phase's rows at the model's shapes."""
    hq = hkv = 16 // TP
    first = [len(p) + 1 for p in prompts[:HALF]]
    cached = [n - 1 for n in first]
    sfx = [SHARED] * HALF
    k1 = k1_case(torch, "tp2_rank", HALF, hq, hkv, 512, 128, "bfloat16",
                 True)
    k2 = k2_case(torch, np, "tp2_rank", first, hq, hkv, 128, "bfloat16")
    k2c = combine_case(torch, "tp2_rank", HALF, hq, k2["splits"], 128,
                       "bfloat16")
    k3 = k3_case(torch, np, "tp2_verify", cached, 5, hq, hkv, 128,
                 "bfloat16", "split")
    k3s = k3_case(torch, np, "tp2_suffix_w64", sfx, 64, hq, hkv, 128,
                  "bfloat16", "wgmma")
    k4 = k2_case(torch, np, "tp2_decode_fp8", first, hq, hkv, 128,
                 "bfloat16", "fp8")
    return {"K1_tp": k1, "K2_tp": k2, "K2_combine_tp": k2c, "K3_tp": k3,
            "K3_suffix_tp": k3s, "K4_decode_tp": k4}


TP_ROWS = (
    ("K1_tp", "K1", "flash_attention (tp_serve and tp_replica_serve: a "
     "rank's prefill, 8 of olmo_1b's 16 heads; timed at (8, 8/8, 512, "
     "128))",
     "src/repro_torch/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:109"),
    ("K2_tp", "K2", "paged_decode_attention (tp_serve and "
     "tp_replica_serve: a rank's decode over its kv-head shard, "
     "paged_decode_attention_headshard)",
     "src/repro_torch/csrc/paged_attention.cu",
     "src/repro/kernels/paged_attention.py:361"),
    ("K2_combine_tp", "K2_combine", "paged_decode_combine (tp_serve's "
     "and tp_replica_serve's ranks)", "src/repro_torch/csrc/paged_attention.cu",
     "src/repro/kernels/paged_attention.py:361"),
    ("K3_tp", "K3", "paged_verify_attention (tp_serve's spec turn: a "
     "rank's verify, split body, paged_verify_attention_headshard)",
     "src/repro_torch/csrc/paged_verify_split.cuh",
     "src/repro/kernels/paged_attention.py:313"),
    ("K3_suffix_tp", "K3_suffix", "paged_verify_attention (tp_serve's spec "
     "turn: a rank's suffix prefill, wgmma body; timed at the 64-row "
     "bucket)", "src/repro_torch/csrc/paged_verify_wgmma.cuh",
     "src/repro/kernels/paged_attention.py:313"),
    ("K4_decode_tp", "K4_decode", "K4 paged_decode_attention (tp_serve's "
     "fp8 turn: a rank's kv-head shard of an fp8 pool)",
     "src/repro_torch/csrc/paged_attention.cu",
     "src/repro/kernels/paged_attention.py:43"),
)


def tp_rows(rows, totals):
    """The kernels line's rows of the per-rank kernels, their launches
    summed over tp_serve's ranks (and tp_replica_serve's for K1 and
    K2)."""
    out = []
    for key, count, name, src, tpu in TP_ROWS:
        row = rows[key]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": tpu, "launches": totals[count],
                    **{k: row[k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms", "body", "splits",
                        "graph_ms") if k in row}})
    return out


TPD_ROWS = (
    ("K1_tp", "K1", "flash_attention (tp_disagg_serve: the prefill "
     "replica's ranks of DisaggregatedEngine(mesh=), 8 of olmo_1b's 16 "
     "heads; timed at (8, 8/8, 512, 128))",
     "src/repro_torch/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:109"),
    ("K2_tp", "K2", "paged_decode_attention (tp_disagg_serve: the decode "
     "replica's ranks over their kv-head shards, "
     "paged_decode_attention_headshard)",
     "src/repro_torch/csrc/paged_attention.cu",
     "src/repro/kernels/paged_attention.py:361"),
    ("K2_combine_tp", "K2_combine", "paged_decode_combine (tp_disagg_serve's "
     "decode ranks)", "src/repro_torch/csrc/paged_attention.cu",
     "src/repro/kernels/paged_attention.py:361"),
)


def tpd_rows(rows, totals, parity):
    """The kernels line's rows of the disaggregated engine on a mesh:
    launches from tp_disagg_serve's ranks (timed at the same rank shapes
    as tp_serve's rows), ``parity_launches`` from parity_tp_disagg's
    smoke ranks."""
    out = []
    for key, count, name, src, tpu in TPD_ROWS:
        row = rows[key]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": tpu, "launches": totals[count],
                    "parity_launches": parity.get(count, 0),
                    **{k: row[k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms", "body", "splits",
                        "graph_ms") if k in row}})
    return out


def tp_cards_main(torch, np):
    """``--tp-cards``: the build and the TP phases alone, on a machine
    with a card a rank (NCCL, the decode step captured): first the
    families, tp_families_serve for recurrentgemma_2b at T = 2 and
    qwen3_moe (MOE_LAYERS) at T = 4, each against its single-card run,
    and qwen3_moe at all 48 layers over 4 ranks (32 experts a rank; no
    card holds the whole tree, so no single-card run), whisper_base at
    T = 2 and 4 (overlap on too); then tp_serve for olmo_1b at T = 2 and
    4 (with an overlap=True turn) and yi_6b at T = 4, each against its
    own single-device run on the first card, tp_replica_serve (olmo_1b,
    ReplicaSet on a (2, 2) mesh: NCCL within a replica), the packet
    ladder between two cards (NCCL), tp_disagg_serve (olmo_1b,
    DisaggregatedEngine on a (2, 2) mesh: NCCL within a replica and for
    the packets, priced by the ladder's fit), then parity_tp at T = 2
    (the kernels rows at a rank's shapes are the one-card run's)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.engine import Engine, EngineConfig
    from repro_torch.models.model import Model

    check(torch.cuda.device_count() >= 4,
          f"--tp-cards needs 4 cards, found {torch.cuda.device_count()}")
    prompts, news, warm = workload(np)
    phase_build()
    for fams, tp, compare in (((("recurrentgemma_2b", None),), 2, True),
                              ((("qwen3_moe_30b_a3b", MOE_LAYERS),), 4,
                               True),
                              ((QWEN3_FULL,), 4, False)):
        phase_tp_families_serve(torch, np, prompts, warm, fams, tp,
                                timeout_s=TP_CARDS_TIMEOUT_S,
                                compare=compare)
        torch.cuda.empty_cache()
    phase_tp_encdec_serve(torch, np, tps=(2, 4),
                          timeout_s=TP_CARDS_TIMEOUT_S)
    torch.cuda.empty_cache()
    turns = tp_turns(np, prompts, news, warm, overlap=True)
    logit_prompts = [p[:64] for p in prompts[:HALF]]
    for arch, tps in (("olmo_1b", (2, 4)), ("yi_6b", (4,))):
        model = Model(get_config(arch), device="cuda")
        params = model.init(seed=SEED)
        base_logits, pool = tp_base(torch, model, params, logit_prompts)
        eng = Engine(model, params, EngineConfig(**SERVE_GEO),
                     device="cuda")
        base_outs, secs, *_ = serve_turn(torch, eng, prompts, news, warm)
        ntok = sum(len(o) for o in base_outs)
        emit({"phase": "tp_serve", "config": model.cfg.name, "tp": 1,
              "turn": "greedy", "tokens": ntok, "seconds": secs,
              "tok_s": ntok / secs})
        del eng, params, model
        torch.cuda.empty_cache()
        for tp in tps:
            phase_tp_serve(torch, np, arch, tp, turns, base_outs,
                           base_logits, pool, logit_prompts,
                           timeout_s=TP_CARDS_TIMEOUT_S)
        if arch == "olmo_1b":
            phase_tp_replica_serve(torch, np, prompts, news, warm, base_outs,
                                   timeout_s=TP_CARDS_TIMEOUT_S)
            fit = phase_packet_ladder(torch, np)
            phase_tp_disagg_serve(torch, np, prompts, news, warm, base_outs,
                                  fabric=fit, timeout_s=TP_CARDS_TIMEOUT_S)
    phase_parity_tp(torch, np, tp=2, timeout_s=TP_CARDS_TIMEOUT_S)


# ---------------------------------------------------------------------------
# tensor parallelism of the other decoder families: parity_tp_families,
# tp_families_serve (and --tp-cards)
# ---------------------------------------------------------------------------

# (T, arch, mode): the recurrent, windowed, xLSTM and MoE decoders at
# T = 2, the replicated-KV fallback at T = 4 (yi's 2 smoke kv heads over
# 4 ranks: K2 / K3 / K4 at a kv-head offset; recurrentgemma's one kv head)
TPF_CASES = (
    (2, "recurrentgemma_2b", "greedy_preempt"),
    (2, "recurrentgemma_2b", "spec3"),
    (2, "recurrentgemma_2b", "static"),
    (2, "h2o_danube_3_4b", "seeded"),
    (2, "xlstm_1_3b", "greedy_preempt"),
    (2, "qwen3_moe_30b_a3b", "greedy_preempt"),
    (2, "qwen3_moe_30b_a3b", "spec3"),
    (2, "qwen3_moe_30b_a3b", "int8"),
    (2, "kimi_k2_1t_a32b", "seeded"),
    (4, "yi_6b", "greedy_preempt"),
    (4, "yi_6b", "spec3"),
    (4, "yi_6b", "int8"),
    (4, "recurrentgemma_2b", "seeded"),
    # whisper by heads at T = 2, by query heads over a replicated KV and
    # arena at T = 4; overlap=True under a mesh for every family
    (2, "whisper_base", "greedy_preempt"),
    (4, "whisper_base", "greedy_preempt"),
    *((2, a, "overlap") for a in (
        "olmo_1b", "recurrentgemma_2b", "h2o_danube_3_4b", "xlstm_1_3b",
        "qwen3_moe_30b_a3b", "whisper_base")),
)
TPF_MODES = ("greedy_preempt", "seeded", "spec3", "int8", "static",
             "overlap")
TPF_ARCHS = tuple(dict.fromkeys(a for _, a, _ in TPF_CASES))
# tp_families_serve: (arch, layers: None for all[, dtype]) and its new
# tokens. The last is the MoE's f32 witness: qwen3_moe at full width and
# top-8 in f32, cut to 4 layers, held to its single-device run at the f32
# tolerance (in bf16 the MoE's logits are only reported)
TPF_SERVE = (("recurrentgemma_2b", None), ("qwen3_moe_30b_a3b", MOE_LAYERS),
             ("h2o_danube_3_4b", 8), ("xlstm_1_3b", 8),
             ("qwen3_moe_30b_a3b", 4, "float32"))
TPF_NEW = 32
# a bf16 MoE family's turns after its greedy one, on the same rank params:
# K3 (5 verify rows, the wgmma body at 8 q heads a kv head) and K4 (an
# int8 pool) at the rank's heads, the shapes their kernels rows time
TPF_MOE_TURNS = (("spec", dict(spec_tokens=4, drafter="ngram")),
                 ("int8", dict(kv_dtype="int8")))
RECURRENT_GEO = dict(num_slots=8, block_size=16, num_blocks=1024,
                     max_len=2560)
QWEN3_FULL = ("qwen3_moe_30b_a3b", 48)   # --tp-cards: all 48 layers, T = 4


def tpf_case(arch, mode, cfg):
    """(engine kwargs, prompts, sampling kwargs, encoder features or
    None) of a parity_tp_families case: ``tp_parity_case``'s, drawn from
    the case's own seed; an encoder-decoder's requests carry 9..16 seeded
    frames each, the fourth the third's array (one arena row)."""
    import numpy as np

    seed = SEED + 200 + TPF_ARCHS.index(arch) * 10 + TPF_MODES.index(mode)
    kw, prompts, samp = tp_parity_case(arch, mode, cfg.vocab_size,
                                       seed=seed)
    feats = None
    if cfg.enc_dec:
        rng = np.random.default_rng(seed + 1000)
        feats = [rng.standard_normal((int(rng.integers(
            9, cfg.encoder_len + 1)), cfg.d_model), dtype=np.float32)
            for _ in prompts]
        feats[3] = feats[2]
    return kw, prompts, samp, feats


def flat_leaves(tree, path=()):
    """(path, leaf) over a nested dict of tensors."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat_leaves(v, path + (k,))
    else:
        yield path, tree


def counts_delta(before, after):
    """``kernel_counts()`` after minus before, by key (and body)."""
    return {k: ({b: n - before[k][b] for b, n in v.items()}
                if isinstance(v, dict) else v - before[k])
            for k, v in after.items()}


def launched(n) -> int:
    """A counter's launches, all bodies summed."""
    return sum(n.values()) if isinstance(n, dict) else n


def parity_tpf_rank(mesh, cases):
    """One rank of parity_tp_families: the cases of this mesh's T through
    the Engine over the mesh, on the smoke params drawn on the CPU from
    the seed (the reference engine's), each case's launches apart."""
    torch = rank_setup()
    from repro_torch.configs import get_config
    from repro_torch.launch.engine import Engine, EngineConfig, SamplingParams
    from repro_torch.models import weights
    from repro_torch.models.model import Model

    out = {}
    for tp, arch, mode in cases:
        if tp != mesh.shape["model"]:
            continue
        print(f"[tp rank {mesh.rank}] parity_tp_families T={tp} {arch} "
              f"{mode}", file=sys.stderr, flush=True)
        cfg = get_config(arch).smoke()
        model = Model(cfg, device=mesh.device)
        params = weights.to_device(Model(cfg, device="cpu").init(seed=SEED),
                                   mesh.device)
        kw, prompts, samp, feats = tpf_case(arch, mode, cfg)
        before = kernel_counts()
        eng = Engine(model, params, EngineConfig(**kw, mesh=mesh),
                     device=mesh.device)
        toks = eng.generate(prompts, [SamplingParams(**s) for s in samp],
                            encoder_features=feats)
        torch.cuda.synchronize()
        st = eng.stats()
        out[(tp, arch, mode)] = (
            toks, tp_stats_view(st), st.get("blocks_used", 0),
            st["tp"].get("cache_bytes", st.get("pool_bytes")), st["tp"],
            counts_delta(before, kernel_counts()), st.get("overlap"))
    return out


def rank_state_bytes(cfg, kw, tp):
    """(bytes of a rank's slice of the pool or static cache by the
    config's specs over T ranks, the single-device bytes, the bytes of
    the leaves the plan splits)."""
    import torch

    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import sharding
    from repro_torch.models import encdec, paged_kv, transformer

    shard = sharding.layout_ctx(meshlib.Mesh({"data": 1, "model": tp}))
    meta = torch.device("meta")
    if cfg.enc_dec:                      # the self pool and the arena
        layout = paged_kv.PagedLayout(**{k: kw[k] for k in (
            "num_slots", "num_blocks", "block_size", "max_len")})
        tree = encdec.init_paged_cache(cfg, layout, meta)
        specs = encdec.paged_cache_specs(cfg, layout, shard)
    elif kw.get("backend") == "static":
        tree = transformer.init_cache(cfg, kw["num_slots"], kw["max_len"],
                                      meta)
        specs = sharding.batch_specs(tree, shard)
    else:
        layout = paged_kv.PagedLayout(**{k: kw[k] for k in (
            "num_slots", "num_blocks", "block_size", "max_len")})
        spec = None if kw.get("kv_dtype", "bf16") == "bf16" else \
            paged_kv.make_pool_spec(cfg, layout, kv_dtype=kw["kv_dtype"])
        tree = transformer.init_paged_cache(cfg, layout, meta, spec)
        specs = transformer.paged_cache_specs(cfg, layout, shard, spec)
    rank = full = split = 0
    flat_specs = dict(flat_leaves(specs))
    for path, t in flat_leaves(tree):
        local = sharding.local_shape(t.shape, flat_specs[path], shard)
        n = t.numel() * t.element_size()
        full += n
        rank += n // t.numel() * math.prod(local)
        split += n if tuple(local) != tuple(t.shape) else 0
    return rank, full, split


def phase_parity_tp_families(torch, np, timeout_s=TP_TIMEOUT_S):
    """Smoke configs in f32 over ranks on the one card (gloo):
    recurrentgemma_2b, h2o_danube_3_4b, xlstm_1_3b, qwen3_moe_30b_a3b and
    kimi_k2_1t_a32b at T = 2, yi_6b and recurrentgemma_2b at T = 4 (the
    replicated-KV fallback), whisper_base at T = 2 and 4, and overlap=True
    for every family at T = 2, in TPF_CASES' modes. Every rank's tokens and
    scheduling counters equal the single-device engine's on the CPU, no
    rank leaks, each rank holds exactly its spec slice of the pool and
    state, and a step runs the plan's collectives. Returns the launches
    summed over ranks for the kernels line's rows: yi's K2, K4 and K3
    over a kv-head range of the replicated pool, at the shape those rows
    time."""
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import sharding
    from repro_torch.launch.engine import Engine, EngineConfig, SamplingParams
    from repro_torch.models.model import Model

    t0 = time.monotonic()
    groups = {tp: run_in_thread(lambda tp=tp: meshlib.launch(
        parity_tpf_rank, tp, "cuda", args=(TPF_CASES,),
        timeout_s=timeout_s)) for tp in (2, 4)}
    want = {}
    for tp, arch, mode in TPF_CASES:
        cfg = get_config(arch).smoke()
        model = Model(cfg, device="cpu")
        kw, prompts, samp, feats = tpf_case(arch, mode, cfg)
        eng = Engine(model, model.init(seed=SEED), EngineConfig(**kw),
                     device="cpu")
        toks = eng.generate(prompts, [SamplingParams(**s) for s in samp],
                            encoder_features=feats)
        want[(tp, arch, mode)] = (toks, tp_stats_view(eng.stats()), kw)
    got = {tp: g() for tp, g in groups.items()}
    totals = {"K2_kvrange": 0, "K4_kvrange": 0, "K3_kvrange": 0}
    for (tp, arch) in dict.fromkeys((t, a) for t, a, _ in TPF_CASES):
        cfg = get_config(arch).smoke()
        plan = sharding.make_shard_ctx(
            meshlib.Mesh({"data": 1, "model": tp}), cfg).plan
        row = {"phase": "parity_tp_families", "config": cfg.name,
               "dtype": cfg.dtype, "tp": tp, "attn": plan.attn,
               "plan": plan.report()["plan"], "tokens_equal": {},
               "stats_equal": {}, "preemptions": {}, "rank_bytes": {},
               "collectives_per_step": {}, "launches_by_rank": {}}
        for t, a, mode in TPF_CASES:
            if (t, a) != (tp, arch):
                continue
            toks, st, kw = want[(tp, arch, mode)]
            rs = [g[(tp, arch, mode)] for g in got[tp]]
            rank_bytes, full, split = rank_state_bytes(cfg, kw, tp)
            rows = kw.get("spec_tokens", 0) + 1
            row["tokens_equal"][mode] = all(r[0] == toks for r in rs)
            row["stats_equal"][mode] = all(r[1] == st for r in rs)
            row["preemptions"][mode] = st.get("preemptions")
            row["rank_bytes"][mode] = [rank_bytes, full, split]
            row["collectives_per_step"][mode] = rs[0][4][
                "collectives_per_step"]
            row["launches_by_rank"][mode] = [r[5] for r in rs]
            check(row["tokens_equal"][mode] and row["stats_equal"][mode],
                  f"parity_tp_families T={tp} {arch} {mode}: a rank's "
                  f"tokens or stats differ from the cpu engine's "
                  f"({[r[1] for r in rs]} vs {st})")
            check(all(r[2] == 0 for r in rs),
                  f"parity_tp_families T={tp} {arch} {mode}: blocks leaked")
            check(all(r[3] == rank_bytes for r in rs),
                  f"parity_tp_families T={tp} {arch} {mode}: rank state "
                  f"bytes {[r[3] for r in rs]}, its spec slice is "
                  f"{rank_bytes} of {full}")
            check(rs[0][4]["collectives_per_step"]
                  == plan.step_collectives(rows),
                  f"parity_tp_families T={tp} {arch} {mode}: "
                  f"{rs[0][4]['collectives_per_step']} collectives a step, "
                  f"the plan's {plan.step_collectives(rows)}")
            if mode in ("greedy_preempt", "int8"):
                check(st["preemptions"] > 0, f"parity_tp_families {arch} "
                      f"{mode}: the tight pool never preempted")
            check(all(bool(r[6]) == (mode == "overlap") for r in rs),
                  f"parity_tp_families T={tp} {arch} {mode}: a rank's "
                  f"stats()['overlap'] is {[r[6] for r in rs]}")
            attn = bool({"attn", "local"} & set(cfg.block_pattern))
            for r in rs:
                n = r[5]
                check(launched(n["K1"]) > 0 or not attn,
                      f"parity_tp_families T={tp} {arch} {mode}: a rank "
                      f"launched no K1 {n}")
                check(launched(n["K5"]) > 0
                      or "rglru" not in cfg.block_pattern,
                      f"parity_tp_families T={tp} {arch} {mode}: a rank "
                      f"launched no K5 {n}")
                if arch == "yi_6b":
                    totals["K2_kvrange"] += n["K2"]
                    totals["K4_kvrange"] += n["K4_decode"]
                    totals["K3_kvrange"] += launched(n["K3"])
        emit(row)
    emit({"phase": "parity_tp_families", "summary": True,
          "launches": totals, "seconds": time.monotonic() - t0})
    check(all(v > 0 for v in totals.values()),
          f"parity_tp_families: a kernel row was never launched {totals}")
    return totals


def tpf_label(cfg):
    """A tp_families_serve family's key: the config's name, and its dtype
    where that is not bf16."""
    return cfg.name if cfg.dtype == "bfloat16" else f"{cfg.name} {cfg.dtype}"


def tpf_serve_spec(np, arch, layers, prompts, warm, dtype=None):
    """(config, engine geometry, requests, budgets, warm-up prompt, logit
    prompts, later turns) of one tp_families_serve family:
    recurrentgemma_2b at recurrent_serve's geometry with its two long
    prompts and serve's first 6; the others at serve's geometry with
    serve's first HALF; TPF_NEW new tokens each; token ids taken modulo
    the vocabulary; a bf16 MoE's later turns TPF_MOE_TURNS."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if arch == "recurrentgemma_2b":
        reqs, geo = long_prompts(np) + prompts[:HALF - 2], RECURRENT_GEO
    else:
        reqs, geo = prompts[:HALF], SERVE_GEO
    V = cfg.vocab_size
    reqs = [[t % V for t in p] for p in reqs]
    turns = TPF_MOE_TURNS if cfg.is_moe and cfg.dtype == "bfloat16" else ()
    return (cfg, geo, reqs, [TPF_NEW] * len(reqs), [t % V for t in warm],
            [p[:64] for p in reqs], turns)


class RoutingRecorder:
    """While entered, keep each MoE layer's routing (every token's expert
    set, sorted) in ``self.sets``, in call order: the diagnostic of
    tp_families_serve's MoE logits."""

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.orig, self.sets = moe, moe.plan, []

        def plan(x2d, router_w, cfg, dropless):
            out = self.orig(x2d, router_w, cfg, dropless)
            self.sets.append(out["topi"].sort(-1).values.cpu().numpy())
            return out

        moe.plan = plan
        return self

    def __exit__(self, *exc):
        self.moe.plan = self.orig


def routing_flips(a, b, layers):
    """Tokens whose expert set differs between two runs' recorded
    routings, by layer, over the first ``layers`` calls (a prefill)."""
    return [int((x != y).any(-1).sum()) for x, y in zip(a[:layers],
                                                       b[:layers])]


def tpf_base(torch, spec):
    """The single-device run of one tp_families_serve family on the card:
    its params drawn a layer at a time (``init_rank_params``, as the
    ranks draw theirs, keeping their slices), the requests through the
    Engine (the step captured), the first prefill and decode logits."""
    from repro_torch.launch import sharding
    from repro_torch.launch.engine import Engine, EngineConfig
    from repro_torch.models import transformer
    from repro_torch.models.model import Model

    cfg, geo, reqs, news, warm, logit_prompts, _ = spec
    model = Model(cfg, device="cuda")
    params = sharding.init_rank_params(model, SEED)
    eng = Engine(model, params, EngineConfig(**geo), device="cuda")
    outs, secs, runs, k1_bodies, st = serve_turn(torch, eng, reqs, news,
                                                 warm)
    with RoutingRecorder() as rec:
        pl, dl, _ = first_decode_logits(torch, model, params,
                                        transformer.RunCtx(), logit_prompts)
    ntok = sum(len(o) for o in outs)
    out = {"outs": outs, "tok_s": ntok / secs, "logits": (pl, dl),
           "pool_bytes": st["pool_bytes"], "steps": st["steps"],
           "routing": rec.sets}
    emit({"phase": "tp_families_serve", "config": cfg.name,
          "dtype": cfg.dtype, "tp": 1,
          "layers": cfg.n_layers, "tokens": ntok, "seconds": secs,
          "tok_s": ntok / secs, "graph_replays": st["graph_replays"],
          "pool_bytes": st["pool_bytes"]})
    del eng, params, model
    torch.cuda.empty_cache()
    return out


def tpf_serve_rank(mesh, specs):
    """One rank of tp_families_serve: each family of ``specs`` drawn on
    the rank's card a layer at a time, keeping the rank's slices
    (``init_rank_params``: no process ever holds a whole tree), served
    through the Engine over the mesh; then the first logits, the
    collectives' share of an eager decode step, and the family's later
    turns, each on an Engine of its own over the same slices. Returns
    what the parent checks, by ``tpf_label``."""
    torch = rank_setup()
    from repro_torch.launch import sharding
    from repro_torch.launch.engine import Engine, EngineConfig
    from repro_torch.models.model import Model

    out = {"device": torch.cuda.get_device_name(mesh.device)}
    for cfg, geo, reqs, news, warm, logit_prompts, turns in specs:
        print(f"[tp rank {mesh.rank}] tp_families_serve {tpf_label(cfg)} "
              f"({cfg.n_layers} layers)", file=sys.stderr, flush=True)
        torch.cuda.reset_peak_memory_stats(mesh.device)
        model = Model(cfg, device=mesh.device)
        shard = sharding.make_shard_ctx(mesh, cfg)
        params = sharding.init_rank_params(model, SEED, shard)
        param_gb = sum(t.numel() * t.element_size() for _, t in
                       flat_leaves(params)) / 1e9
        eng = Engine(model, params, EngineConfig(**geo, mesh=mesh),
                     device=mesh.device)
        del params                          # the engine holds the slices
        outs, secs, runs, k1_bodies, st = serve_turn(torch, eng, reqs,
                                                     news, warm)
        be = eng.backend
        with RoutingRecorder() as rec:
            pl, dl, step = first_decode_logits(torch, model, be.params,
                                               be.ctx, logit_prompts)
        timing = collective_share(torch, model, be.params, be.ctx, step)
        out[tpf_label(cfg)] = {
            "outs": outs, "seconds": secs, "launches": runs,
            "k1_bodies": k1_bodies, "logits": (pl, dl), "timing": timing,
            "routing": rec.sets,
            "param_gb": param_gb,
            "stats": {k: st[k] for k in (
                "steps", "graph_replays", "eager_decode_steps",
                "pool_bytes", "blocks_used", "preemptions", "tp",
                "device_s")},
            "ttft_p50_s": st["latency"]["ttft"]["p50_s"],
            "tpot_p50_s": st["latency"]["tpot"]["p50_s"],
            "peak_mem_gb": torch.cuda.max_memory_allocated(mesh.device)
            / 1e9, "turns": {}}
        params = be.params
        del eng, be, step
        torch.cuda.empty_cache()
        for name, kw in turns:
            eng = Engine(model, params, EngineConfig(**geo, **kw, mesh=mesh),
                         device=mesh.device)
            outs, secs, runs, k1_bodies, st = serve_turn(torch, eng, reqs,
                                                         news, warm)
            out[tpf_label(cfg)]["turns"][name] = {
                "outs": outs, "seconds": secs, "launches": runs,
                "k1_bodies": k1_bodies, "blocks_used": st["blocks_used"],
                "spec_steps": st["spec"]["steps"] if "spec" in st else 0}
            del eng
            torch.cuda.empty_cache()
        del params
    return out


def phase_tp_families_serve(torch, np, prompts, warm, families, tp,
                            timeout_s=TP_TIMEOUT_S, compare=True):
    """``families`` ((arch, layers[, dtype]) each) at full width, in bf16
    unless a dtype is given, over ``tp`` ranks (gloo on the one card, the
    step eager; NCCL and the step captured on cards of their own), 8
    requests of TPF_NEW tokens each: per family tok/s, each rank's K1 /
    K2 / K3 / K5 launches by body (no simt at bf16; K5 on "ring" at the
    rank's 1280 channels), state and pool bytes a rank (exactly its spec
    slice: 1 / T of the leaves the plan splits), no leaked block, the
    plan's collectives a step and their CUDA-event share of an eager
    step; a bf16 MoE's later turns (TPF_MOE_TURNS: K3 and K4 at the
    rank's heads). With ``compare``, each family's single-device run
    comes first on the card (``tpf_base``, freed before the ranks
    spawn): tokens against it (agreement and the first differing step,
    reported: all-reduced partial sums round apart) and the first
    prefill and decode logits, within the dtype's tolerance of the
    largest, except a bf16 MoE's, which are reported beside the tokens
    whose expert sets differ by layer; the f32 MoE witness is held to
    the f32 tolerance. Returns the launches of the bf16 families summed
    over ranks for the kernels line's rows."""
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import sharding

    t0 = time.monotonic()
    specs = [tpf_serve_spec(np, f[0], f[1], prompts, warm, *f[2:])
             for f in families]
    bases = {tpf_label(s[0]): tpf_base(torch, s) for s in specs} \
        if compare else {}
    torch.cuda.empty_cache()
    got = meshlib.launch(tpf_serve_rank, tp, "cuda", args=(specs,),
                         timeout_s=timeout_s)
    totals = {"K1": {}, "K2": 0, "K2_combine": 0, "K5": 0, "K5_long": 0,
              "K3_moe": 0, "K4_moe": 0}
    far = []                       # logits past the tolerance, by family
    for cfg, geo, reqs, news, warm_p, _, turns in specs:
        label = tpf_label(cfg)
        rs = [g[label] for g in got]
        bf16 = cfg.dtype == "bfloat16"
        r0, sts = rs[0], [r["stats"] for r in rs]
        info = sts[0]["tp"]
        plan = sharding.make_shard_ctx(
            meshlib.Mesh({"data": 1, "model": tp}), cfg).plan
        rank_bytes, full, split = rank_state_bytes(cfg, geo, tp)
        ntok = sum(len(o) for o in r0["outs"])
        steps_key = "graph_replays" if info["backend"] == "nccl" \
            else "eager_decode_steps"
        step_ms, coll_ms, calls = r0["timing"]
        row = {"phase": "tp_families_serve", "config": cfg.name,
               "dtype": cfg.dtype, "tp": tp, "layers": cfg.n_layers,
               "backend": info["backend"],
               "captured_step": info["captured_step"],
               "plan": info["plan"], "kept_whole": info["kept_whole"],
               "head_aligned": len(info["head_aligned"]),
               "kv_replicated": info["kv_replicated"],
               "experts_local": info["experts_local"],
               "requests": len(r0["outs"]), "tokens": ntok,
               "seconds": r0["seconds"], "tok_s": ntok / r0["seconds"],
               "ttft_p50_s": r0["ttft_p50_s"], "tpot_p50_s": r0["tpot_p50_s"],
               "steps": sts[0]["steps"],
               "decode_steps_by_rank": [s[steps_key] for s in sts],
               "collectives_per_step": info["collectives_per_step"],
               "plan_collectives_per_step": plan.step_collectives(),
               "collective_bytes_per_rank": info["collective_bytes"],
               "eager_step_ms": step_ms, "collective_ms_per_step": coll_ms,
               "collective_share": coll_ms / step_ms,
               "collectives_timed_per_step": calls,
               "pool_bytes_per_rank": [s["pool_bytes"] for s in sts],
               "pool_bytes_t1": full, "pool_bytes_split_leaves": split,
               "blocks_used": [s["blocks_used"] for s in sts],
               "k1_launches_by_body": [r["k1_bodies"] for r in rs],
               "k5_launches_by_shape": [r["launches"]["K5_shapes"]
                                        for r in rs],
               "k2_launches": [r["launches"]["K2"] for r in rs],
               "k3_launches_by_body": [r["launches"]["K3_bodies"]
                                       for r in rs],
               "param_gb_by_rank": [r["param_gb"] for r in rs],
               "peak_mem_gb_by_rank": [r["peak_mem_gb"] for r in rs],
               "device": got[0]["device"],
               "ranks_tokens_equal": all(r["outs"] == r0["outs"]
                                         for r in rs)}
        name = f"tp_families_serve {label} T={tp}"
        check(row["ranks_tokens_equal"], f"{name}: the ranks' tokens differ")
        check(all(len(o) == n for o, n in zip(r0["outs"], news))
              and all(0 <= t < cfg.vocab_size for o in r0["outs"]
                      for t in o), f"{name}: bad outputs")
        check(all(n == 0 for n in row["blocks_used"]),
              f"{name}: blocks leaked {row['blocks_used']}")
        check(all(p == rank_bytes for p in row["pool_bytes_per_rank"]),
              f"{name}: rank state {row['pool_bytes_per_rank']}, its spec "
              f"slice is {rank_bytes} of {full}")
        check(rank_bytes == full - split + split // tp,
              f"{name}: the split leaves are not 1/{tp} a rank")
        check(row["collectives_per_step"] == plan.step_collectives()
              == calls, f"{name}: {row['collectives_per_step']} / {calls} "
              f"collectives a step, the plan's {plan.step_collectives()}")
        check(all(n == row["steps"] > 0
                  for n in row["decode_steps_by_rank"]),
              f"{name}: {row['steps']} steps, {steps_key} "
              f"{row['decode_steps_by_rank']}")
        check(cfg.is_moe == (info["experts_local"] > 0)
              and info["experts_local"] * tp == cfg.n_experts,
              f"{name}: {info['experts_local']} experts a rank")
        attn = bool({"attn", "local"} & set(cfg.block_pattern))
        k1_body = "wgmma" if bf16 else "simt"
        for r in rs:
            runs, bodies = r["launches"], r["k1_bodies"]
            check(bodies[k1_body] == runs["K1"]
                  and (runs["K3_bodies"]["simt"] == 0 or not bf16)
                  and (runs["K1"] > 0 or not attn),
                  f"{name}: K1 not all on {k1_body} {bodies}")
            pool_layers = sum(k == "attn" and not cfg.sliding_window
                              for k in cfg.layer_kinds)
            check(runs["K2"] + runs["K4_decode"]
                  == pool_layers * r["stats"]["steps"],
                  f"{name}: K2 {runs['K2']} in {r['stats']['steps']} steps "
                  f"over {pool_layers} pool layers")
            if "rglru" in cfg.block_pattern:
                ring = all({k for k, v in b.items() if v} <= {"ring"}
                           for b in runs["K5_shapes"].values())
                check(runs["K5"] > 0 and ring and all(
                    s.endswith(f"x{cfg.rnn_width // tp}")
                    for s in runs["K5_shapes"]),
                      f"{name}: K5 off the ring or not at the rank's "
                      f"channels {runs['K5_shapes']}")
            if not bf16:                   # the f32 witness: no kernel row
                continue
            totals["K1"][cfg.name] = totals["K1"].get(cfg.name, 0) \
                + runs["K1"]
            totals["K2"] += runs["K2"]
            totals["K2_combine"] += runs["K2_combine"]
            long_key = f"2x2560x{cfg.rnn_width // tp}" \
                if cfg.rnn_width else ""
            n_long = sum(runs["K5_shapes"].get(long_key, {}).values())
            totals["K5_long"] += n_long
            totals["K5"] += runs["K5"] - n_long
        for turn, _ in turns:
            ts = [r["turns"][turn] for r in rs]
            tname = f"{name} {turn}"
            trow = {"phase": "tp_families_serve", "config": cfg.name,
                    "dtype": cfg.dtype, "tp": tp, "turn": turn,
                    "layers": cfg.n_layers, "seconds": ts[0]["seconds"],
                    "tok_s": sum(len(o) for o in ts[0]["outs"])
                    / ts[0]["seconds"],
                    "spec_steps": ts[0]["spec_steps"],
                    "blocks_used": [t["blocks_used"] for t in ts],
                    "k1_launches_by_body": [t["k1_bodies"] for t in ts],
                    "k3_launches_by_body": [t["launches"]["K3_bodies"]
                                            for t in ts],
                    "k4_launches": [[t["launches"]["K4_decode"],
                                     t["launches"]["K4_verify"]]
                                    for t in ts],
                    "ranks_tokens_equal": all(t["outs"] == ts[0]["outs"]
                                              for t in ts)}
            emit(trow)
            check(trow["ranks_tokens_equal"] and all(
                len(o) == n for o, n in zip(ts[0]["outs"], news)),
                  f"{tname}: the ranks' tokens differ, or bad outputs")
            check(all(n == 0 for n in trow["blocks_used"]),
                  f"{tname}: blocks leaked {trow['blocks_used']}")
            for t in ts:
                runs = t["launches"]
                check(t["k1_bodies"]["simt"] == 0
                      and runs["K3_bodies"]["simt"] == 0,
                      f"{tname}: a K1 / K3 launch on simt")
                if turn == "spec":
                    check(t["spec_steps"] > 0
                          and runs["K3_bodies"]["wgmma"] > 0,
                          f"{tname}: no verify on K3's wgmma body "
                          f"{runs['K3_bodies']}")
                    totals["K3_moe"] += runs["K3_bodies"]["wgmma"]
                else:
                    check(runs["K4_decode"] > 0,
                          f"{tname}: no K4 decode launch {runs}")
                    totals["K4_moe"] += runs["K4_decode"]
        if compare:
            base = bases[label]
            rate, first = agreement(r0["outs"], base["outs"])
            pl0, dl0 = base["logits"]
            errs = [[float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))
                     for a, b in ((pl, pl0), (dl, dl0))]
                    for pl, dl in (r["logits"] for r in rs)]
            row.update(requests_equal_t1=rate, first_differing_step=first,
                       tok_s_t1=base["tok_s"], logits_rel_err_by_rank=errs,
                       tol=TOL[cfg.dtype])
            if cfg.is_moe:
                row["prefill_routing_flips_by_layer"] = routing_flips(
                    base["routing"], r0["routing"], cfg.n_layers)
                row["prefill_routed_tokens"] = len(base["routing"][0])
            row["logits_within_tol"] = all(e <= TOL[cfg.dtype]
                                           for es in errs for e in es)
            check(base["pool_bytes"] == full,
                  f"{name}: T = 1 state {base['pool_bytes']} != {full}")
            if not (row["logits_within_tol"] or (cfg.is_moe and bf16)):
                far.append(f"{name}: logits differ from the single-device "
                           f"model's by {errs} (relative to the largest)")
        emit(row)
    emit({"phase": "tp_families_serve", "tp": tp, "summary": True,
          "launches": totals, "seconds": time.monotonic() - t0})
    check(not far, "; ".join(far))
    return totals


# ---------------------------------------------------------------------------
# whisper under TP (tp_families_serve's whisper rows), ReplicaSet on
# (data, model) submeshes: parity_tp_replica, tp_replica_serve
# ---------------------------------------------------------------------------

TPE_NEW = 32                        # whisper over ranks: new tokens each


def encdec_first_logits(torch, np, model, params, ctx, feats):
    """Logits of one admission of HALF start-of-transcript prompts over
    ``feats`` (full windows: the masked encoder, the arena write, the
    decoder prefill, through ``prefill_paged_encdec``) and of the first
    paged decode step after it (its greedy token fed), over a pool and
    arena built for them (this rank's slices under ``ctx.shard``).
    Returns (prefill, decode) f32 logits on the host."""
    from repro_torch.models import paged_kv

    n, bs = len(feats), 16
    layout = paged_kv.PagedLayout(num_slots=n, num_blocks=n + 1,
                                  block_size=bs, max_len=bs)
    pools = model.init_paged_cache(layout, shard=ctx.shard)
    toks = np.zeros((n, len(SOT)), np.int32)
    toks[:] = SOT
    ids = np.arange(1, n + 1, dtype=np.int32)
    enc = np.asarray([f.shape[0] for f in feats], np.int32)
    lens = np.full(n, len(SOT), np.int32)
    dev = model.device
    args = [torch.from_numpy(a).to(dev) for a in (
        toks, np.stack(feats), enc, lens, ids[:, None], ids)]
    pl, _ = model.prefill_paged_encdec(params, pools, *args, ctx)
    feed = pl.argmax(-1).to(torch.int32)[:, None]
    dl, _ = model.decode_step_paged(
        params, pools, args[4], args[3], feed, ctx, arena_ids=args[5],
        enc_lengths=args[2])
    torch.cuda.synchronize()
    return pl.float().cpu().numpy(), dl.float().cpu().numpy()


def tpe_spec(np, dtype):
    """(config, engine geometry, requests) of whisper over ranks:
    whisper_base at full width and depth (6 + 6 layers) in ``dtype``,
    encdec_serve's geometry (8 slots, max_len 448, 225 blocks) and its
    first HALF requests (start-of-transcript prompts over full 1500-frame
    windows, two seeded pairs sharing an array each), TPE_NEW tokens
    each."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("whisper_base"), dtype=dtype)
    prompts, feats, _, samp = encdec_workload(np, cfg.d_model)
    geo = dict(num_slots=HALF, block_size=16, num_blocks=225, max_len=448)
    return cfg, geo, (prompts[:HALF], feats[:HALF], [TPE_NEW] * HALF,
                      samp[:HALF])


def tpe_turns(torch, np, model, params, cfg, geo, reqs, mesh=None):
    """whisper's turns on one engine a turn over the same params:
    overlap off, then (bf16 over ranks) on: (outputs, seconds, launches,
    K1 by body, a stats subset) by turn name, and the first logits (on
    the overlap-off engine's params and context)."""
    from repro_torch.launch.engine import Engine, EngineConfig

    out = {}
    keep = None
    both = cfg.dtype == "bfloat16" and mesh is not None
    for overlap in ((False, True) if both else (False,)):
        eng = Engine(model, params, EngineConfig(**geo, overlap=overlap,
                                                 mesh=mesh),
                     device=model.device)
        outs, secs, runs, k1_bodies, st = encdec_turn(torch, eng, reqs)
        out["overlap" if overlap else "greedy"] = {
            "outs": outs, "seconds": secs, "launches": runs,
            "k1_bodies": k1_bodies,
            "stats": {k: st[k] for k in (
                "steps", "graph_replays", "eager_decode_steps", "overlap",
                "pool_bytes", "blocks_used", "preemptions", "prefill_calls",
                "cross_arena", "device_s") + (("tp",) if mesh else ())},
            "ttft_p50_s": st["latency"]["ttft"]["p50_s"],
            "tpot_p50_s": st["latency"]["tpot"]["p50_s"]}
        if keep is None:
            keep = eng.backend
        del eng
    logits = encdec_first_logits(torch, np, model, keep.params, keep.ctx,
                                 reqs[1])
    return out, logits


def tpe_rank(mesh, dtypes):
    """One rank of whisper over ranks: per dtype the params drawn on the
    rank's card from the seed, its slices kept (``init_rank_params``),
    the turns (``tpe_turns``) over the mesh. Requests are drawn here
    from the seed (no frames cross processes)."""
    torch = rank_setup()
    import numpy as np

    from repro_torch.launch import sharding
    from repro_torch.models.model import Model

    out = {}
    for dtype in dtypes:
        print(f"[tp rank {mesh.rank}] tp_families_serve whisper {dtype}",
              file=sys.stderr, flush=True)
        cfg, geo, reqs = tpe_spec(np, dtype)
        model = Model(cfg, device=mesh.device)
        params = sharding.init_rank_params(
            model, SEED, sharding.make_shard_ctx(mesh, cfg))
        out[dtype] = tpe_turns(torch, np, model, params, cfg, geo, reqs,
                               mesh)
        del params
        torch.cuda.empty_cache()
    return out


def phase_tp_encdec_serve(torch, np, tps=(TP,), timeout_s=TP_TIMEOUT_S):
    """whisper_base at full width in bf16 over each T of ``tps`` ranks
    (gloo on the
    one card, eager; NCCL on cards of their own, the step captured):
    tpe_spec's 8 requests with overlap off, then on (equal tokens), per
    rank K1 (the decoder prefill on the rank's 4 of 8 heads, wgmma) and
    K2 (the decode over its head-sharded pool), the plan's 18
    collectives a step (3 a decoder layer; the 51865-token vocabulary
    stays whole), pool and arena bytes a rank (its spec slice), no leak,
    shared arena rows; tokens and the first logits against the
    single-device run on the card, first (bf16: reported; all-reduced
    partial sums round apart). Then the f32 witness at full width: its
    tokens equal to T = 1 and its first logits within the f32
    tolerance of the largest. Returns the bf16 launches summed over ranks
    for the kernels line's whisper rows."""
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import sharding
    from repro_torch.models.model import Model

    t0 = time.monotonic()
    dtypes = ("bfloat16", "float32")
    bases = {}
    for dtype in dtypes:
        cfg, geo, reqs = tpe_spec(np, dtype)
        model = Model(cfg, device="cuda")
        params = sharding.init_rank_params(model, SEED)
        turns, logits = tpe_turns(torch, np, model, params, cfg, geo, reqs)
        bases[dtype] = (turns["greedy"], logits)
        r = turns["greedy"]
        ntok = sum(len(o) for o in r["outs"])
        emit({"phase": "tp_families_serve", "config": cfg.name,
              "dtype": dtype, "tp": 1, "layers": cfg.n_layers,
              "tokens": ntok, "seconds": r["seconds"],
              "tok_s": ntok / r["seconds"],
              "graph_replays": r["stats"]["graph_replays"],
              "pool_bytes": r["stats"]["pool_bytes"]})
        del model, params
        torch.cuda.empty_cache()
    totals = {"K1_whisper_tp": 0, "K2_whisper_tp": 0}
    far = []
    for tp in tps:
        got = meshlib.launch(tpe_rank, tp, "cuda", args=(dtypes,),
                             timeout_s=timeout_s)
        tpe_check(np, got, tp, dtypes, bases, totals, far)
    emit({"phase": "tp_families_serve", "config": "whisper-base",
          "tp": list(tps), "summary": True, "launches": totals,
          "seconds": time.monotonic() - t0})
    check(not far, "; ".join(far))
    return totals


def tpe_check(np, got, tp, dtypes, bases, totals, far):
    """phase_tp_encdec_serve's rows and checks of one group of ``tp``
    ranks; adds the bf16 launches to ``totals`` and the logits past the
    tolerance to ``far``."""
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import sharding

    for dtype in dtypes:
        cfg, geo, reqs = tpe_spec(np, dtype)
        plan = sharding.make_shard_ctx(
            meshlib.Mesh({"data": 1, "model": tp}), cfg).plan
        rank_bytes, full, split = rank_state_bytes(cfg, geo, tp)
        base, (pl0, dl0) = bases[dtype]
        name = f"tp_families_serve whisper-base {dtype} T={tp}"
        for turn in got[0][dtype][0]:
            rs = [g[dtype][0][turn] for g in got]
            r0, sts = rs[0], [r["stats"] for r in rs]
            info = sts[0]["tp"]
            ntok = sum(len(o) for o in r0["outs"])
            steps_key = "graph_replays" if info["backend"] == "nccl" \
                else "eager_decode_steps"
            rate, first = agreement(r0["outs"], base["outs"])
            row = {"phase": "tp_families_serve", "config": cfg.name,
                   "dtype": dtype, "tp": tp, "turn": turn,
                   "layers": f"{cfg.n_encoder_layers} + {cfg.n_layers}",
                   "frames": [HALF, ENC_FRAMES],
                   "backend": info["backend"],
                   "captured_step": info["captured_step"],
                   "overlap": sts[0]["overlap"], "plan": info["plan"],
                   "kv_replicated": info["kv_replicated"],
                   "requests": len(r0["outs"]), "tokens": ntok,
                   "seconds": r0["seconds"], "tok_s": ntok / r0["seconds"],
                   "tok_s_t1": sum(len(o) for o in base["outs"])
                   / base["seconds"],
                   "ttft_p50_s": r0["ttft_p50_s"],
                   "tpot_p50_s": r0["tpot_p50_s"],
                   "tpot_p50_s_t1": base["tpot_p50_s"],
                   "steps": sts[0]["steps"],
                   "decode_steps_by_rank": [s[steps_key] for s in sts],
                   "collectives_per_step": info["collectives_per_step"],
                   "plan_collectives_per_step": plan.step_collectives(),
                   "pool_bytes_per_rank": [s["pool_bytes"] for s in sts],
                   "pool_bytes_t1": full,
                   "cross_arena": sts[0]["cross_arena"],
                   "k1_launches_by_body": [r["k1_bodies"] for r in rs],
                   "k2_launches": [r["launches"]["K2"] for r in rs],
                   "requests_equal_t1": rate, "first_differing_step": first,
                   "ranks_tokens_equal": all(r["outs"] == r0["outs"]
                                             for r in rs)}
            if turn == "overlap":
                greedy = got[0][dtype][0]["greedy"]["outs"]
                row["tokens_equal_overlap_off"] = r0["outs"] == greedy
                check(row["tokens_equal_overlap_off"] and row["overlap"],
                      f"{name}: overlap=True tokens differ from overlap "
                      "off, or overlap is off")
            emit(row)
            body = "wgmma" if dtype == "bfloat16" else "simt"
            check(row["ranks_tokens_equal"]
                  and all(len(o) == TPE_NEW for o in r0["outs"]),
                  f"{name} {turn}: the ranks' tokens differ, or bad outputs")
            check(all(s["blocks_used"] == 0
                      and s["cross_arena"]["rows_used"] == 0 for s in sts)
                  and row["cross_arena"]["shared_hits"] >= 2,
                  f"{name} {turn}: blocks or arena rows leaked, or no "
                  f"shared row {row['cross_arena']}")
            check(all(p == rank_bytes for p in row["pool_bytes_per_rank"])
                  and rank_bytes == full - split + split // tp,
                  f"{name}: rank pool and arena {row['pool_bytes_per_rank']}"
                  f", its spec slice is {rank_bytes} of {full}")
            check(row["collectives_per_step"] == plan.step_collectives()
                  == 3 * cfg.n_layers, f"{name}: "
                  f"{row['collectives_per_step']} collectives a step")
            for r, s in zip(rs, sts):
                runs = r["launches"]
                check(s[steps_key] == s["steps"] > 0
                      and runs["K2"] == cfg.n_layers * s["steps"]
                      and runs["K1"] == r["k1_bodies"][body]
                      == cfg.n_layers * s["prefill_calls"] > 0,
                      f"{name} {turn}: K1 {r['k1_bodies']} / K2 "
                      f"{runs['K2']} in {s['steps']} steps, "
                      f"{s['prefill_calls']} prefills")
                if dtype == "bfloat16":
                    totals["K1_whisper_tp"] += runs["K1"]
                    totals["K2_whisper_tp"] += runs["K2"]
        errs = [[float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))
                 for a, b in ((pl, pl0), (dl, dl0))]
                for pl, dl in (g[dtype][1] for g in got)]
        emit({"phase": "tp_families_serve", "config": cfg.name,
              "dtype": dtype, "tp": tp, "summary": "first logits",
              "logits_rel_err_by_rank": errs, "tol": TOL[dtype]})
        if dtype == "float32":
            check(got[0][dtype][0]["greedy"]["outs"] == base["outs"],
                  f"{name}: the f32 witness's tokens differ from T = 1")
        if not all(e <= TOL[dtype] for es in errs for e in es):
            far.append(f"{name}: first logits {errs} of the largest")


TPR_CASES = (("least_loaded", "greedy_preempt"), ("round_robin", "seeded"))


def tpr_case(mode, vocab):
    """(per-replica engine kwargs, prompts, sampling kwargs) of a
    parity_tp_replica case: ``tp_parity_case``'s, plus two more requests
    so the shared queue holds some back."""
    kw, prompts, samp = tp_parity_case("olmo_1b", mode, vocab,
                                       seed=SEED + 300
                                       + TPF_MODES.index(mode))
    return kw, prompts + prompts[:2], samp + samp[:2]


def tpr_view(st):
    """The counters a replica set shares with another serving the same
    requests."""
    return {"dispatched": st["dispatched"], "steps": st["steps"],
            "preemptions": st["preemptions"],
            "prefill_calls": st["prefill_calls"],
            "blocks_used": st["blocks_used"],
            "replica_steps": [p["steps"] for p in st["per_replica"]]}


def parity_tpr_rank(mesh):
    """One rank of parity_tp_replica: each case through
    ``ReplicaSet(mesh=)`` on olmo_1b smoke (the CPU's params from the
    seed), this rank's kernel launches apart."""
    torch = rank_setup()
    from repro_torch.configs import get_config
    from repro_torch.launch.engine import (EngineConfig, ReplicaSet,
                                           SamplingParams)
    from repro_torch.models import weights
    from repro_torch.models.model import Model

    cfg = get_config("olmo_1b").smoke()
    model = Model(cfg, device=mesh.device)
    params = weights.to_device(Model(cfg, device="cpu").init(seed=SEED),
                               mesh.device)
    out = {}
    for policy, mode in TPR_CASES:
        kw, prompts, samp = tpr_case(mode, cfg.vocab_size)
        before = kernel_counts()
        rset = ReplicaSet(model, params, EngineConfig(**kw), mesh=mesh,
                          policy=policy)
        toks = rset.generate(prompts, [SamplingParams(**s) for s in samp])
        torch.cuda.synchronize()
        out[(policy, mode)] = (toks, rset.stats(),
                               counts_delta(before, kernel_counts()))
    return out


def phase_parity_tp_replica(torch, np, timeout_s=TP_TIMEOUT_S):
    """olmo_1b smoke in f32 on a (data=2, model=2) mesh of 4 ranks on the
    one card (gloo: the replicas' subgroups and the router's world
    group): ``ReplicaSet(mesh=)`` under least_loaded (a tight pool that
    preempts) and round_robin (seeded rows); its tokens, ``dispatched``
    and counters equal ``ReplicaSet(dp=2)``'s on the CPU, every rank
    returns the same ``stats()``, and every rank launched K1 and K2."""
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch.engine import (EngineConfig, ReplicaSet,
                                           SamplingParams)
    from repro_torch.models.model import Model

    t0 = time.monotonic()
    ranks = run_in_thread(lambda: meshlib.launch(
        parity_tpr_rank, 2, "cuda", dp=2, timeout_s=timeout_s))
    cfg = get_config("olmo_1b").smoke()
    model = Model(cfg, device="cpu")
    params = model.init(seed=SEED)
    want = {}
    for policy, mode in TPR_CASES:
        kw, prompts, samp = tpr_case(mode, cfg.vocab_size)
        rset = ReplicaSet(model, params, EngineConfig(**kw), dp=2,
                          policy=policy, device="cpu")
        toks = rset.generate(prompts, [SamplingParams(**s) for s in samp])
        want[(policy, mode)] = (toks, tpr_view(rset.stats()))
    got = ranks()
    for policy, mode in TPR_CASES:
        toks, view = want[(policy, mode)]
        rs = [g[(policy, mode)] for g in got]
        st = rs[0][1]
        row = {"phase": "parity_tp_replica", "config": cfg.name,
               "dtype": cfg.dtype, "mesh": {"data": 2, "model": 2},
               "policy": policy, "mode": mode,
               "tokens_equal": all(r[0] == toks for r in rs),
               "stats_equal_cpu": all(tpr_view(r[1]) == view for r in rs),
               "ranks_stats_equal": all(r[1] == st for r in rs),
               "dispatched": st["dispatched"],
               "preemptions": st["preemptions"], "router": st["router"],
               "backends": [p["tp"]["backend"] for p in st["per_replica"]],
               "launches_by_rank": [r[2] for r in rs]}
        emit(row)
        check(row["tokens_equal"] and row["stats_equal_cpu"]
              and row["ranks_stats_equal"],
              f"parity_tp_replica {policy} {mode}: tokens or counters "
              f"differ from the cpu ReplicaSet(dp=2)'s, or the ranks' "
              f"stats differ ({tpr_view(st)} vs {view})")
        check(mode != "greedy_preempt" or st["preemptions"] > 0,
              f"parity_tp_replica {policy} {mode}: no preemption")
        check(all(launched(r[2]["K1"]) > 0 and r[2]["K2"] > 0 for r in rs),
              f"parity_tp_replica {policy} {mode}: a rank launched no K1 "
              f"or K2 {[r[2] for r in rs]}")
    emit({"phase": "parity_tp_replica", "summary": True,
          "seconds": time.monotonic() - t0})


def tpr_serve_rank(mesh, prompts, news, warm):
    """One rank of tp_replica_serve: olmo_1b at full width from the seed
    (each rank keeps its slices), ``ReplicaSet(mesh=)`` at serve's
    geometry a replica, a warm-up request, then serve's requests with
    this rank's K1 / K2 / combine counters set to 0 just before."""
    torch = rank_setup()
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.engine import (EngineConfig, ReplicaSet,
                                           SamplingParams)
    from repro_torch.models.model import Model

    model = Model(get_config("olmo_1b"), device=mesh.device)
    params = model.init(seed=SEED)
    rset = ReplicaSet(model, params, EngineConfig(**SERVE_GEO), mesh=mesh)
    del params                             # the engine keeps its slices
    torch.cuda.empty_cache()
    rset.generate([warm], SamplingParams(max_tokens=2))
    rset.reset_telemetry()
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    zero_bodies(fa.flash_attention)
    pa.paged_decode_attention.launches = 0
    pa.paged_decode_combine.launches = 0
    t0 = time.monotonic()
    outs = rset.generate(prompts, [SamplingParams(max_tokens=n)
                                   for n in news])
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    return {"outs": outs, "seconds": secs, "stats": rset.stats(),
            "launches": {"K1": fa.flash_attention.launches,
                         "K2": pa.paged_decode_attention.launches,
                         "K2_combine": pa.paged_decode_combine.launches},
            "k1_bodies": dict(fa.flash_attention.launches_by_body),
            "replica": rset.home,
            "device": torch.cuda.get_device_name(mesh.device)}


def phase_tp_replica_serve(torch, np, prompts, news, warm, base_outs,
                           timeout_s=TP_TIMEOUT_S):
    """olmo_1b at full width in bf16 as ``ReplicaSet(mesh=)`` on a
    (data=2, model=2) mesh of 4 ranks (on the one card: every group
    gloo, the step eager; on 4 cards: the replicas' subgroups NCCL and
    their steps captured, the router's exchange gloo): serve's 16
    requests, tokens equal to serve's (``base_outs``); per replica
    ``dispatched``, steps, graph replays and eager steps, K1 / K2 /
    combine launches by rank; the router's exchanges and their host ms
    (each waits for the slowest replica's step too). Returns the
    launches summed over ranks."""
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as meshlib

    t0 = time.monotonic()
    got = meshlib.launch(tpr_serve_rank, 2, "cuda", dp=2,
                         args=(prompts, news, warm), timeout_s=timeout_s)
    r0 = got[0]
    st = r0["stats"]
    ntok = sum(len(o) for o in r0["outs"])
    per = st["per_replica"]
    rate, first = agreement(r0["outs"], base_outs)
    row = {"phase": "tp_replica_serve", "config": "olmo-1b",
           "dtype": "bfloat16", "mesh": {"data": 2, "model": 2},
           "backends": [p["tp"]["backend"] for p in per],
           "captured_step": [p["tp"]["captured_step"] for p in per],
           "requests": len(r0["outs"]), "tokens": ntok,
           "seconds": r0["seconds"], "tok_s": ntok / r0["seconds"],
           "ttft_p50_s": st["ttft"]["p50_s"],
           "tpot_p50_s": st["latency"]["tpot"]["p50_s"],
           "dispatched": st["dispatched"], "busy_s": st["busy_s"],
           "replica_steps": [p["steps"] for p in per],
           "graph_replays": [p["graph_replays"] for p in per],
           "eager_decode_steps": [p["eager_decode_steps"] for p in per],
           "router": st["router"],
           "exchange_ms_per_exchange": st["router"]["exchange_ms"]
           / max(st["router"]["exchanges"], 1),
           "launches_by_rank": [g["launches"] for g in got],
           "k1_launches_by_body": [g["k1_bodies"] for g in got],
           "requests_equal_serve": rate, "first_differing_step": first,
           "ranks_stats_equal": all(g["stats"] == st for g in got),
           "blocks_used": st["blocks_used"], "device": r0["device"],
           "phase_seconds": time.monotonic() - t0}
    emit(row)
    check(all(g["outs"] == r0["outs"] for g in got)
          and row["ranks_stats_equal"],
          "tp_replica_serve: the ranks' tokens or stats differ")
    check(rate == 1.0, f"tp_replica_serve: {rate} of the requests equal "
          f"serve's (first difference at step {first})")
    check(st["blocks_used"] == 0 and all(st["dispatched"])
          and st["router"]["exchanges"] > 0,
          f"tp_replica_serve: blocks {st['blocks_used']}, dispatched "
          f"{st['dispatched']}, router {st['router']}")
    L = get_config("olmo_1b").n_layers
    for g in got:
        p = per[g["replica"]]
        key = "graph_replays" if p["tp"]["captured_step"] \
            else "eager_decode_steps"
        check(p[key] == p["steps"] > 0
              and g["launches"]["K2"] == g["launches"]["K2_combine"]
              == L * p["steps"]
              and g["k1_bodies"]["wgmma"] == g["launches"]["K1"] > 0,
              f"tp_replica_serve: replica {g['replica']} ran {p['steps']} "
              f"steps, {p[key]} {key}, launches {g['launches']} "
              f"{g['k1_bodies']}")
    return {k: sum(g["launches"][k] for g in got)
            for k in ("K1", "K2", "K2_combine")}


# ---------------------------------------------------------------------------
# migration across submeshes: parity_tp_disagg, tp_disagg_serve, and the
# packet ladder between two cards (--tp-cards)
# ---------------------------------------------------------------------------

TPD_ROLES = ("prefill", "decode", "decode")
# name: (arch, tp_parity_case mode for the geometry, policy, role
# overrides, pool dtype)
TPD_CASES = {
    "olmo_steal": ("olmo_1b", "greedy_preempt", "first", {}, "bf16"),
    "olmo_int8_spec": ("olmo_1b", "seeded", "least_loaded",
                       {"decode": {"spec_tokens": 3}}, "int8"),
    "recurrentgemma_overlap": ("recurrentgemma_2b", "seeded",
                               "least_loaded",
                               {"decode": {"overlap": True}}, "bf16"),
    "whisper": ("whisper_base", "seeded", "least_loaded", {}, "bf16"),
    "olmo_steal_overlap": ("olmo_1b", "seeded", "first",
                           {"decode": {"overlap": True}}, "bf16"),
}
# olmo_steal_overlap's new tokens: two long requests, four short ones,
# so a steal comes mid-decode and the donor's flush harvests tokens
TPD_OVERLAP_NEW = (14, 14, 4, 4, 4, 4)
PACKET_LADDER = (4096, 65536, 1 << 20, 8 << 20, 32 << 20, 128 << 20)
LADDER_REPS = 20                    # round trips a rung


def tpd_case(name, cfg):
    """(engine kwargs, prompts, sampling kwargs, encoder features or
    None, policy, role overrides) of a parity_tp_disagg case: smoke
    geometry (whisper 4 slots, max_len 32), six prompts in one prefill
    bucket, greedy rows that run to 10 tokens where a tight pool makes
    the first decode replica preempt and the other steal, greedy rows of
    ``TPD_OVERLAP_NEW`` tokens for the steals under overlap, seeded rows
    elsewhere; whisper's requests 1 and 2 share one feature array."""
    import numpy as np

    arch, mode, pol, role_ov, kv = TPD_CASES[name]
    seed = SEED + 500 + list(TPD_CASES).index(name)
    kw, prompts, samp = tp_parity_case("olmo_1b", mode, cfg.vocab_size,
                                       seed=seed)
    kw = dict(kw, kv_dtype=kv)
    if name == "olmo_steal":
        samp = [dict(s, max_tokens=10) for s in samp]
    if name == "olmo_steal_overlap":
        samp = [dict(max_tokens=n) for n in TPD_OVERLAP_NEW]
    feats = None
    if arch == "whisper_base":
        kw.update(num_slots=4, max_len=32)
        samp = [dict(max_tokens=8)] * len(prompts)
        rng = np.random.default_rng(seed)
        feats = [rng.standard_normal((f, cfg.d_model)).astype(np.float32)
                 for f in (5, 16, 9, 12, 7, 16)]
        feats[2] = feats[1]
    return (kw, prompts, samp, feats,
            first_candidate if pol == "first" else pol, role_ov)


def tpd_view(st):
    """What a disaggregated engine's stats share with another serving
    the same requests by the same decisions."""
    d = st["disagg"]
    return {"dispatched": st["dispatched"], "steps": st["steps"],
            "preemptions": st["preemptions"],
            "replica_steps": [p["steps"] for p in st["per_replica"]],
            **{k: d[k] for k in ("exported", "imported", "stolen",
                                 "bytes_moved", "fabric_s")}}


def home_leaks(engine):
    """This process's replica of a set on a mesh: blocks and arena rows
    still held after the run (0 and 0 when nothing leaked)."""
    be = engine.replicas[engine.home].backend
    be.alloc.check_invariant()
    return (be.layout.usable_blocks - be.alloc.free_count,
            0 if be.arena is None else be.arena.used_count)


def parity_tpd_rank(mesh):
    """One rank of parity_tp_disagg: each case through
    ``DisaggregatedEngine(mesh=)`` on the smoke configs (the CPU's params
    from the seed), this rank's kernel launches apart."""
    torch = rank_setup()
    from repro_torch.configs import get_config
    from repro_torch.launch.engine import (DisaggregatedEngine,
                                           EngineConfig, SamplingParams)
    from repro_torch.models import weights
    from repro_torch.models.model import Model

    out = {}
    for name, (arch, *_) in TPD_CASES.items():
        cfg = get_config(arch).smoke()
        model = Model(cfg, device=mesh.device)
        params = weights.to_device(Model(cfg, device="cpu").init(seed=SEED),
                                   mesh.device)
        kw, prompts, samp, feats, pol, role_ov = tpd_case(name, cfg)
        before = kernel_counts()
        dis = DisaggregatedEngine(model, params, EngineConfig(**kw),
                                  mesh=mesh, roles=TPD_ROLES, policy=pol,
                                  role_overrides=role_ov)
        toks = dis.generate(prompts, [SamplingParams(**s) for s in samp],
                            encoder_features=feats)
        torch.cuda.synchronize()
        out[name] = (toks, dis.stats(), home_leaks(dis),
                     counts_delta(before, kernel_counts()), dis.home)
    return out


def phase_parity_tp_disagg(torch, np, timeout_s=TP_TIMEOUT_S):
    """``DisaggregatedEngine`` on a (data=3, model=2) mesh of 6 ranks on
    the one card (gloo: the replicas' subgroups, the router's exchange
    and the payload moves), roles prefill / decode / decode, smoke
    configs in f32: olmo_1b stealing on a tight pool (decode-side
    preemption), olmo_1b seeded over an int8 pool with a speculative
    decode role, recurrentgemma_2b (replicated KV, channel-sharded
    state) with overlap on the decode role, whisper_base (the cross
    arena), olmo_1b stealing under overlap. Tokens and counters equal
    the cpu ``DisaggregatedEngine(dp=3)``'s on the same weights, every
    rank returns the same ``stats()``, no rank leaks, the prefill
    replica never steps, prefill ranks launched K1 (recurrentgemma's K5
    too), decode ranks K2 / K3 / K4 (recurrentgemma's decode is plain
    torch). Returns the launches summed over the ranks."""
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch.engine import (DisaggregatedEngine,
                                           EngineConfig, SamplingParams)
    from repro_torch.models.model import Model

    t0 = time.monotonic()
    ranks = run_in_thread(lambda: meshlib.launch(
        parity_tpd_rank, 2, "cuda", dp=3, timeout_s=timeout_s))
    want = {}
    for name, (arch, *_) in TPD_CASES.items():
        cfg = get_config(arch).smoke()
        model = Model(cfg, device="cpu")
        kw, prompts, samp, feats, pol, role_ov = tpd_case(name, cfg)
        dis = DisaggregatedEngine(model, model.init(seed=SEED),
                                  EngineConfig(**kw), dp=3, roles=TPD_ROLES,
                                  policy=pol, role_overrides=role_ov,
                                  device="cpu")
        toks = dis.generate(prompts, [SamplingParams(**s) for s in samp],
                            encoder_features=feats)
        want[name] = (toks, tpd_view(dis.stats()))
    got = ranks()
    totals = {}
    for name, (arch, *_) in TPD_CASES.items():
        toks, view = want[name]
        rs = [g[name] for g in got]
        st = rs[0][1]
        d = st["disagg"]
        row = {"phase": "parity_tp_disagg", "case": name, "config": arch,
               "dtype": "float32", "mesh": {"data": 3, "model": 2},
               "roles": list(TPD_ROLES),
               "tokens_equal": all(r[0] == toks for r in rs),
               "stats_equal_cpu": all(tpd_view(r[1]) == view for r in rs),
               "ranks_stats_equal": all(r[1] == st for r in rs),
               "exported": d["exported"], "imported": d["imported"],
               "stolen": d["stolen"], "bytes_moved": d["bytes_moved"],
               "rank_bytes_moved": d["rank_bytes_moved"],
               "fabric_s": d["fabric_s"],
               "preemptions": st["preemptions"], "router": st["router"],
               "leaks_by_rank": [r[2] for r in rs],
               "launches_by_rank": [r[3] for r in rs]}
        emit(row)
        check(row["tokens_equal"] and row["stats_equal_cpu"]
              and row["ranks_stats_equal"],
              f"parity_tp_disagg {name}: tokens or counters differ from "
              f"the cpu DisaggregatedEngine(dp=3)'s, or the ranks' stats "
              f"differ ({tpd_view(st)} vs {view})")
        check(all(r[2] == (0, 0) for r in rs) and st["blocks_used"] == 0
              and st["per_replica"][0]["steps"] == 0,
              f"parity_tp_disagg {name}: leaks {row['leaks_by_rank']}, "
              f"prefill steps {st['per_replica'][0]['steps']}")
        check(name != "olmo_steal" or (d["stolen"] >= 1
                                       and st["preemptions"] > 0),
              f"parity_tp_disagg {name}: stolen {d['stolen']}, "
              f"preemptions {st['preemptions']}")
        check(name != "olmo_steal_overlap" or d["stolen"] >= 2,
              f"parity_tp_disagg {name}: stolen {d['stolen']}")
        for r in rs:
            n = r[3]
            # recurrentgemma's decode (rings, the RG-LRU step) is plain
            # torch: its decode ranks owe no kernel
            if r[4] == 0:
                ran = launched(n["K1"]) > 0 and (
                    arch != "recurrentgemma_2b" or launched(n["K5"]) > 0)
            else:
                ran = arch == "recurrentgemma_2b" or (
                    n["K2"] + n["K4_decode"] + launched(n["K3"]) > 0)
            check(ran, f"parity_tp_disagg {name}: replica {r[4]}'s rank "
                       f"launched no kernel of its role {n}")
            for k, v in n.items():
                totals[k] = totals.get(k, 0) + launched(v)
    emit({"phase": "parity_tp_disagg", "summary": True,
          "seconds": time.monotonic() - t0, "launches": totals})
    return totals


class PacketTimer:
    """On a rank: CUDA events and the host clock around every packet's
    gather (``transport.extract_slot``), send or receive
    (``send_payload`` / ``recv_payload``) and scatter (``insert_packet``)
    on this rank, while active."""

    PARTS = {"extract_slot": "gather", "send_payload": "send",
             "recv_payload": "recv", "insert_packet": "scatter"}

    def __init__(self, torch, transport):
        self.torch, self.transport = torch, transport
        self.rows = {p: [] for p in self.PARTS.values()}

    def __enter__(self):
        self.orig = {f: getattr(self.transport, f) for f in self.PARTS}
        for f, part in self.PARTS.items():
            setattr(self.transport, f, self._wrap(self.orig[f], part))
        return self

    def _wrap(self, fn, part):
        def timed(*args, **kw):
            ev = self.torch.cuda.Event
            start, end = ev(enable_timing=True), ev(enable_timing=True)
            t0 = time.monotonic()
            start.record()
            res = fn(*args, **kw)
            end.record()
            end.synchronize()
            self.rows[part].append((start.elapsed_time(end),
                                    1e3 * (time.monotonic() - t0)))
            return res
        return timed

    def __exit__(self, *exc):
        for f, fn in self.orig.items():
            setattr(self.transport, f, fn)

    def summary(self):
        """Per part: calls, mean and p50 device ms (CUDA events) and host
        ms (the host clock, the event synchronized)."""
        out = {}
        for part, rows in self.rows.items():
            if not rows:
                continue
            dev = sorted(r[0] for r in rows)
            host = sorted(r[1] for r in rows)
            out[part] = {"calls": len(rows),
                         "device_ms_mean": sum(dev) / len(dev),
                         "device_ms_p50": dev[len(dev) // 2],
                         "host_ms_mean": sum(host) / len(host),
                         "host_ms_p50": host[len(host) // 2],
                         "host_ms_max": host[-1]}
        return out


def tpd_serve_rank(mesh, prompts, news, warm, fabric):
    """One rank of tp_disagg_serve: olmo_1b at full width from the seed
    (each rank keeps its slices), ``DisaggregatedEngine(mesh=)`` with
    roles prefill / decode at serve's geometry a replica, a warm-up
    request, then serve's requests with this rank's K1 / K2 / combine
    counters set to 0 just before and its packets timed."""
    torch = rank_setup()
    from repro_torch.configs import get_config
    from repro_torch.core import noc
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.engine import (DisaggregatedEngine,
                                           EngineConfig, SamplingParams,
                                           transport)
    from repro_torch.models.model import Model

    model = Model(get_config("olmo_1b"), device=mesh.device)
    params = model.init(seed=SEED)
    dis = DisaggregatedEngine(
        model, params, EngineConfig(**SERVE_GEO), mesh=mesh,
        roles=("prefill", "decode"),
        fabric=None if fabric is None else noc.FabricSpec(**fabric))
    del params                             # the engine keeps its slices
    torch.cuda.empty_cache()
    dis.generate([warm], SamplingParams(max_tokens=2))
    dis.reset_telemetry()
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    zero_bodies(fa.flash_attention)
    pa.paged_decode_attention.launches = 0
    pa.paged_decode_combine.launches = 0
    with PacketTimer(torch, transport) as timer:
        t0 = time.monotonic()
        outs = dis.generate(prompts, [SamplingParams(max_tokens=n)
                                      for n in news])
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
    return {"outs": outs, "seconds": secs, "stats": dis.stats(),
            "launches": {"K1": fa.flash_attention.launches,
                         "K2": pa.paged_decode_attention.launches,
                         "K2_combine": pa.paged_decode_combine.launches},
            "k1_bodies": dict(fa.flash_attention.launches_by_body),
            "packets": timer.summary(), "leaks": home_leaks(dis),
            "replica": dis.home, "backend": mesh.payload_backend,
            "device": torch.cuda.get_device_name(mesh.device)}


def phase_tp_disagg_serve(torch, np, prompts, news, warm, base_outs,
                          fabric=None, timeout_s=TP_TIMEOUT_S):
    """olmo_1b at full width in bf16 as ``DisaggregatedEngine(mesh=)`` on
    a (data=2, model=2) mesh of 4 ranks, roles prefill / decode (on the
    one card: every group gloo, a packet staged through pinned host
    memory, the steps eager; on 4 cards: NCCL inside a replica and for
    the packets, the decode step captured): serve's 16 requests, tokens
    equal to serve's (``base_outs``); packets, logical and per-rank bytes,
    each packet's gather / send / receive / scatter ms by CUDA events and
    the host clock, the router's exchanges and their ms, tok/s, TTFT and
    TPOT p50, the prefill replica's steps (0), leaks by rank; with
    ``fabric`` (a dict of ``FabricSpec`` fields) ``fabric_s`` a packet
    beside the measured move. Returns the launches summed over ranks."""
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as meshlib

    t0 = time.monotonic()
    got = meshlib.launch(tpd_serve_rank, 2, "cuda", dp=2,
                         args=(prompts, news, warm, fabric),
                         timeout_s=timeout_s)
    r0 = got[0]
    st = r0["stats"]
    d = st["disagg"]
    per = st["per_replica"]
    ntok = sum(len(o) for o in r0["outs"])
    rate, first = agreement(r0["outs"], base_outs)
    send = [g["packets"]["send"] for g in got if "send" in g["packets"]]
    recv = [g["packets"]["recv"] for g in got if "recv" in g["packets"]]
    move_ms = max(s["host_ms_mean"] for s in send) if send else 0.0
    row = {"phase": "tp_disagg_serve", "config": "olmo-1b",
           "dtype": "bfloat16", "mesh": {"data": 2, "model": 2},
           "roles": d["roles"], "payload_backend": r0["backend"],
           "captured_step": [p["tp"]["captured_step"] for p in per],
           "requests": len(r0["outs"]), "tokens": ntok,
           "seconds": r0["seconds"], "tok_s": ntok / r0["seconds"],
           "ttft_p50_s": st["ttft"]["p50_s"],
           "tpot_p50_s": st["latency"]["tpot"]["p50_s"],
           "replica_steps": [p["steps"] for p in per],
           "packets": d["imported"], "stolen": d["stolen"],
           "bytes_moved": d["bytes_moved"],
           "rank_bytes_moved": d["rank_bytes_moved"],
           "bytes_per_packet": d["bytes_per_packet"],
           "rank_bytes_per_packet": d["rank_bytes_moved"]
           / max(d["imported"], 1),
           "packet_ms_by_rank": [g["packets"] for g in got],
           "move_ms_per_packet": move_ms,
           "move_gb_s_per_rank": (d["rank_bytes_moved"]
                                  / max(d["imported"], 1))
           / (move_ms * 1e6) if move_ms else 0.0,
           "fabric_priced": d["fabric_priced"],
           "fabric_ms_per_packet": 1e3 * d["fabric_s"]
           / max(d["imported"], 1),
           "router": st["router"],
           "exchange_ms_per_exchange": st["router"]["exchange_ms"]
           / max(st["router"]["exchanges"], 1),
           "launches_by_rank": [g["launches"] for g in got],
           "k1_launches_by_body": [g["k1_bodies"] for g in got],
           "leaks_by_rank": [g["leaks"] for g in got],
           "requests_equal_serve": rate, "first_differing_step": first,
           "ranks_stats_equal": all(g["stats"] == st for g in got),
           "blocks_used": st["blocks_used"], "device": r0["device"],
           "phase_seconds": time.monotonic() - t0}
    emit(row)
    check(all(g["outs"] == r0["outs"] for g in got)
          and row["ranks_stats_equal"],
          "tp_disagg_serve: the ranks' tokens or stats differ")
    check(rate == 1.0, f"tp_disagg_serve: {rate} of the requests equal "
          f"serve's (first difference at step {first})")
    check(st["blocks_used"] == 0 and all(g["leaks"] == (0, 0) for g in got)
          and per[0]["steps"] == 0 and d["exported"] == len(prompts)
          and d["imported"] == d["exported"] + d["stolen"]
          and len(send) == len(recv) == 2,
          f"tp_disagg_serve: leaks {row['leaks_by_rank']}, prefill steps "
          f"{per[0]['steps']}, disagg {d}, timed sides {len(send)} / "
          f"{len(recv)}")
    L = get_config("olmo_1b").n_layers
    for g in got:
        n = g["launches"]
        if g["replica"] == 0:
            ok = n["K1"] > 0 and g["k1_bodies"]["wgmma"] == n["K1"] \
                and n["K2"] == 0
        else:
            p = per[1]
            ok = n["K2"] == n["K2_combine"] == L * p["steps"] > 0
        check(ok, f"tp_disagg_serve: replica {g['replica']}'s rank "
                  f"launches {n} {g['k1_bodies']}")
    return {k: sum(g["launches"][k] for g in got)
            for k in ("K1", "K2", "K2_combine")}


def ladder_rank(mesh, sizes, reps):
    """One of two ranks, a card each (NCCL): for each packet size,
    ``reps`` round trips of a send from rank 0 and the reply from rank 1,
    timed on the host clock around the whole loop (the streams
    synchronized): a one-way transfer is half a round trip."""
    torch = rank_setup()
    out = []
    peer = 1 - mesh.rank
    for n in sizes:
        buf = torch.zeros(n, dtype=torch.uint8, device=mesh.device)

        def trip():
            if mesh.rank == 0:
                torch.distributed.send(buf, peer, group=mesh.group)
                torch.distributed.recv(buf, peer, group=mesh.group)
            else:
                torch.distributed.recv(buf, peer, group=mesh.group)
                torch.distributed.send(buf, peer, group=mesh.group)

        for _ in range(3):
            trip()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(reps):
            trip()
        torch.cuda.synchronize()
        out.append((n, (time.monotonic() - t0) / (2 * reps)))
    return out, mesh.backend


def phase_packet_ladder(torch, np, timeout_s=TP_CARDS_TIMEOUT_S):
    """Packets between two cards over NCCL (a rank a card), sizes 4 KiB
    to 128 MiB: one-way seconds and GB/s a size, and the least-squares
    fit t = latency + bytes / rate over the ladder: the figures of a
    ``core.noc.FabricSpec`` for the card. Returns the fit as
    ``FabricSpec`` fields (``pod_bw`` = ``ici_bw``: one node has no
    second tier)."""
    from repro_torch.launch import mesh as meshlib

    got, backend = meshlib.launch(ladder_rank, 2, "cuda",
                                  args=(PACKET_LADDER, LADDER_REPS),
                                  timeout_s=timeout_s)[0]
    xs = np.array([n for n, _ in got], dtype=np.float64)
    ts = np.array([t for _, t in got], dtype=np.float64)
    slope, lat = (float(v) for v in np.polyfit(xs, ts, 1))
    fit = {"ici_bw": 1.0 / slope, "pod_bw": 1.0 / slope,
           "latency_us": lat * 1e6}
    emit({"phase": "packet_ladder", "backend": backend, "cards": 2,
          "rungs": [{"bytes": int(n), "one_way_ms": t * 1e3,
                     "gb_s": n / t / 1e9} for n, t in got],
          "fit": fit, "device": torch.cuda.get_device_name(0)})
    check(backend == "nccl" and slope > 0 and all(t > 0 for t in ts),
          f"packet_ladder: {backend}, fit {fit} over {got}")
    return fit


def kvrange_geometry(mode):
    """(first decode lengths, cached lengths, block size, table width)
    of parity_tp_families' yi_6b smoke case ``mode`` at T = 4: its first
    3 prompts in the engine's 3 slots, its geometry."""
    from repro_torch.configs import get_config

    kw, prompts, _, _ = tpf_case("yi_6b", mode,
                                 get_config("yi_6b").smoke())
    lens = [len(p) for p in prompts[:kw["num_slots"]]]
    return ([n + 1 for n in lens], lens, kw["block_size"],
            kw["max_len"] // kw["block_size"])


def phase_tpf_kernels(torch, np, prompts):
    """The kernels at a rank's shapes in the families' TP paths: K1
    windowed on recurrentgemma's rank (5 of 10 query heads over the one
    kv head, D 256, window 2048) and danube's (16 / 4 of 32 / 8, D 120,
    window 4096), K1 at qwen3's rank (16 / 2 of 32 / 4), K5 on a rank's
    1280 of the 2560 RG-LRU channels at both admissions, K2 with its
    combine, K3 (verify, 5 rows) and K4 (int8 decode) at qwen3's rank
    heads; K2, K4 and K3 over a kv-head range where the main path runs
    them: yi_6b smoke at T = 4 in f32 (parity_tp_families), a rank's one
    query head over one of the replicated pool's 2 kv heads, timed at
    rank 3's, kv head 1, with the case's first 3 prompts."""
    from repro_torch.configs import get_config

    first = [len(p) + 1 for p in prompts[:HALF]]
    cached = [n - 1 for n in first]
    yi = get_config("yi_6b").smoke()
    hq, hkv, d = yi.n_heads // 4, yi.n_kv_heads, yi.head_dim
    dec, _, bs, nbmax = kvrange_geometry("greedy_preempt")
    dec8, _, bs8, nbmax8 = kvrange_geometry("int8")
    _, ver, bs3, nbmax3 = kvrange_geometry("spec3")
    kv = (1, 1)
    rows = {
        "K1_rg_tp": k1_case(torch, "rg_tp2_rank", HALF, 5, 1, 512, 256,
                            "bfloat16", True, window=2048),
        "K1_danube_tp": k1_case(torch, "danube_tp2_rank", HALF, 16, 4, 512,
                                120, "bfloat16", True, window=4096),
        "K1_qwen3_tp": k1_case(torch, "qwen3_tp2_rank", HALF, 16, 2, 512,
                               128, "bfloat16", True),
        "K5_tp": k5_case(torch, "tp2_rank", HALF, 512, 1280),
        "K5_long_tp": k5_case(torch, "tp2_rank_long", 2, 2560, 1280),
        "K2_qwen3_tp": k2_case(torch, np, "qwen3_tp2_rank", first, 16, 2,
                               128, "bfloat16"),
        "K3_qwen3_tp": k3_case(torch, np, "qwen3_tp2_verify", cached, 5, 16,
                               2, 128, "bfloat16", "wgmma"),
        "K4_qwen3_tp": k2_case(torch, np, "qwen3_tp2_decode_int8", first,
                               16, 2, 128, "bfloat16", "int8"),
        "K2_kvrange": k2_case(torch, np, "yi_smoke_tp4_rank3", dec, hq,
                              hkv, d, yi.dtype, bs=bs, nbmax=nbmax,
                              nb=len(dec) * nbmax + 1, kv_heads=kv),
        "K4_kvrange": k2_case(torch, np, "yi_smoke_tp4_rank3_int8", dec8,
                              hq, hkv, d, yi.dtype, "int8", bs=bs8,
                              nbmax=nbmax8, nb=len(dec8) * nbmax8 + 1,
                              kv_heads=kv),
        "K3_kvrange": k3_case(torch, np, "yi_smoke_tp4_rank3_verify", ver,
                              4, hq, hkv, d, yi.dtype, "split", bs=bs3,
                              nbmax=nbmax3, nb=len(ver) * nbmax3 + 1,
                              kv_heads=kv),
        # whisper over 2 ranks: the decoder prefill of the
        # start-of-transcript prompts (bucket 16) and the decode over
        # the first decode lengths, at 4 of the 8 heads
        "K1_whisper_tp": k1_case(torch, "whisper_dec_tp2_rank", HALF, 4, 4,
                                 16, 64, "bfloat16", True),
        "K2_whisper_tp": k2_case(torch, np, "whisper_tp2_rank",
                                 [len(SOT) + 1] * HALF, 4, 4, 64,
                                 "bfloat16"),
    }
    rows["K2_combine_qwen3_tp"] = combine_case(
        torch, "qwen3_tp2_rank", HALF, 16, rows["K2_qwen3_tp"]["splits"],
        128, "bfloat16")
    return rows


TPF_ROWS = (
    ("K1_rg_tp", ("K1", "recurrentgemma-2b"),
     "flash_attention (tp_families_serve: a rank's windowed prefill, 5 of "
     "recurrentgemma_2b's 10 heads over its one kv head, window 2048)",
     "src/repro_torch/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:109"),
    ("K1_danube_tp", ("K1", "h2o-danube-3-4b"),
     "flash_attention (tp_families_serve: a rank's sliding-window prefill, "
     "16 / 4 of h2o_danube's 32 / 8 heads x 120, window 4096)",
     "src/repro_torch/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:109"),
    ("K1_qwen3_tp", ("K1", "qwen3-moe-30b-a3b"),
     "flash_attention (tp_families_serve: a rank's prefill, 16 / 2 of "
     "qwen3_moe's 32 / 4 heads)",
     "src/repro_torch/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:109"),
    ("K5_tp", ("K5",), "rglru_scan (tp_families_serve: a rank's 1280 of "
     "the 2560 RG-LRU channels; timed at (8, 512, 1280))",
     "src/repro_torch/csrc/rglru_scan.cu",
     "src/repro/kernels/rglru_scan.py:52"),
    ("K5_long_tp", ("K5_long",), "rglru_scan (tp_families_serve: a rank's "
     "channels of the long admission, (2, 2560, 1280))",
     "src/repro_torch/csrc/rglru_scan.cu",
     "src/repro/kernels/rglru_scan.py:52"),
    ("K2_qwen3_tp", ("K2",), "paged_decode_attention (tp_families_serve: "
     "a rank's decode, qwen3_moe's 16 / 2 heads)",
     "src/repro_torch/csrc/paged_attention.cu",
     "src/repro/kernels/paged_attention.py:361"),
    ("K2_combine_qwen3_tp", ("K2_combine",), "paged_decode_combine "
     "(tp_families_serve's qwen3_moe ranks)",
     "src/repro_torch/csrc/paged_attention.cu",
     "src/repro/kernels/paged_attention.py:361"),
    ("K3_qwen3_tp", ("K3_moe",), "paged_verify_attention (tp_families_serve:"
     " qwen3_moe's spec turn, a rank's 16 / 2 heads, 5 rows: 40 pairs a kv "
     "head, the wgmma body)",
     "src/repro_torch/csrc/paged_verify_wgmma.cuh",
     "src/repro/kernels/paged_attention.py:313"),
    ("K4_qwen3_tp", ("K4_moe",), "K4 paged_decode_attention "
     "(tp_families_serve: qwen3_moe's int8 turn, a rank's 16 / 2 heads)",
     "src/repro_torch/csrc/paged_attention.cu",
     "src/repro/kernels/paged_attention.py:43"),
    ("K2_kvrange", ("K2_kvrange",), "paged_decode_attention over a kv-head "
     "range (parity_tp_families: yi_6b smoke at T = 4 in f32, the "
     "replicated pool, a rank's 1 q head over 1 of the 2 kv heads; timed "
     "at rank 3's, kv head 1)",
     "src/repro_torch/csrc/paged_attention.cu",
     "src/repro/kernels/paged_attention.py:361"),
    ("K4_kvrange", ("K4_kvrange",), "K4 paged_decode_attention over a "
     "kv-head range (parity_tp_families: yi_6b smoke's int8 pool at T = 4, "
     "a rank's 1 q head over 1 of the 2 kv heads; timed at rank 3's)",
     "src/repro_torch/csrc/paged_attention.cu",
     "src/repro/kernels/paged_attention.py:43"),
    ("K1_whisper_tp", ("K1_whisper_tp",), "flash_attention (tp_families_serve"
     ": whisper's decoder prefill on a rank's 4 of 8 heads, (8, 4/4, 16, "
     "64) causal)", "src/repro_torch/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:109"),
    ("K2_whisper_tp", ("K2_whisper_tp",), "paged_decode_attention "
     "(tp_families_serve: whisper's decode over a rank's head-sharded "
     "pool, (8, 4/4, 64))", "src/repro_torch/csrc/paged_attention.cu",
     "src/repro/kernels/paged_attention.py:158"),
    ("K3_kvrange", ("K3_kvrange",), "paged_verify_attention over a kv-head "
     "range (parity_tp_families: yi_6b smoke's verify at T = 4 in f32, 4 "
     "rows, a rank's 1 q head over 1 of the 2 kv heads, the split body; "
     "timed at rank 3's)",
     "src/repro_torch/csrc/paged_verify_split.cuh",
     "src/repro/kernels/paged_attention.py:313"),
)


def tpf_rows(rows, totals):
    """The kernels line's rows of the families' per-rank kernels, their
    launches summed over the ranks of parity_tp_families and
    tp_families_serve."""
    out = []
    for key, where, name, src, tpu in TPF_ROWS:
        n = totals[where[0]]
        n = n[where[1]] if len(where) > 1 else n
        row = rows[key]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": tpu, "launches": n,
                    **{k: row[k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms", "body", "splits",
                        "graph_ms", "simt_ms") if k in row}})
    return out


def nvidia_smi():
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return out[0]


def k8_finalize_row(k8a):
    """The finalize kernel's summary row, from K8a's plate case: its time
    and the torch tree's on the same lanes (equal bit for bit there).
    Bound: 8 KB of lanes read once; 1023 merges of 6 two_sums (6 flops
    each), in f32."""
    bound_ms, bound_by = bound(1023 * 6 * 6, 8192 + 8, "float32")
    return {"max_abs_err": 0.0 if k8a["finalize_alone_equal_tree"]
            else float("nan"), "ms": k8a["finalize_ms"],
            "plain_ms": k8a["tree_finalize_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


# The port's kernel functions (csrc/*.cu), as torch.profiler names them.
PORT_KERNEL = re.compile(
    r"\(anonymous namespace\)::(tc::|pvs::|pvw::)?(fa_kernel|fa_wgmma|"
    r"pa_split_kernel|pa_combine_kernel|pv_kernel|pv_split_kernel|pv_wgmma|"
    r"scan_kernel|scan_tma_kernel|mm_kernel|mm_wgmma|stencil2d_kernel|"
    r"stencil3d_kernel|stencil3d_tma_kernel|lanes_kernel|ring_kernel|"
    r"finalize_kernel)\b")
# K8's kernels (the lane kernel's two bodies and the finalize), in the
# profiler's names and in cuobjdump's mangled ones.
K8_KERNELS = re.compile(r"(lanes|ring|finalize)_kernel")
# Every kernel held bit for bit to its plain version by its order: K5's
# two bodies, K7's (2-D, 3-D simt and 3-D ring) and K8's.
BIT_EXACT_KERNELS = re.compile(
    r"(scan|scan_tma|stencil2d|stencil3d|stencil3d_tma|lanes|ring|finalize)"
    r"_kernel")


# K2's two kernels: the split kernel and the combine pass.
SPLIT_KERNELS = re.compile(
    r"\(anonymous namespace\)::pa_(split|combine)_kernel<")
# K3's kernels: its three bodies and the combine pass after the split one.
VERIFY_KERNELS = re.compile(
    r"\(anonymous namespace\)::(pvs::|pvw::)?(pv_kernel|pv_split_kernel|"
    r"pv_wgmma|pa_combine_kernel)<")


def profile_window(torch, fn):
    """Device time by kernel over one call of ``fn``, the share of the
    window the device was busy (kernel time only), and each of the
    port's own kernels with its share of the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    ours = [e for e in kernels if PORT_KERNEL.search(e.key)]
    return {"window_s": wall, "device_busy_s": busy,
            "busy_share": busy / wall,
            "device_ops": sum(e.count for e in kernels),
            "top": [{"name": e.key[:80], "calls": e.count,
                     "device_ms": e.self_device_time_total / 1e3}
                    for e in kernels[:12]],
            "port_kernels": [{"name": e.key[:80], "calls": e.count,
                              "device_ms": e.self_device_time_total / 1e3,
                              "busy_share": e.self_device_time_total / 1e6
                              / busy} for e in ours]}


def phase_profile(torch, engine, prompts, news, config, feats=None):
    """Device time by kernel over one admission + 8 decode steps
    (``feats``: an encoder-decoder's features, one per prompt)."""
    from repro_torch.launch.engine import SamplingParams

    for r, (p, n) in enumerate(zip(prompts[:HALF], news)):
        engine.add_request(p, SamplingParams(max_tokens=n),
                           encoder_features=None if feats is None
                           else feats[r])

    def window():
        for _ in range(9):
            engine.step()

    emit({"phase": "profile", "config": config,
          **profile_window(torch, window)})
    engine.drain()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="also print device time by kernel (torch.profiler)")
    ap.add_argument("--tp-cards", action="store_true",
                    help="only the build and the tensor-parallel phases, "
                         "over NCCL on a machine with 4 cards")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a GPU")
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        fail("src/repro_torch not found: run from a checkout of the repo")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if args.tp_cards:
        tp_cards_main(torch, np)
        print(nvidia_smi(), flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return
    prompts, news, warm = workload(np)
    phase_build()
    (k1, k2, k2c, k3, k3s, k4d, k4v, k4s, k5, k5_long, k1_moe,
     k2_moe, k1_wenc, k1_wx, k2_wh, k1_vl) = phase_kernels(
         torch, np, prompts, args.profile)
    k6, k7a, k7b, k8a, k8b = phase_tile_kernels(torch, np, args.profile)
    tp_kernels = phase_tp_kernels(torch, np, prompts)
    tpf_kernels = phase_tpf_kernels(torch, np, prompts)
    phase_parity(torch, np)
    phase_parity_quant(torch, np)
    phase_parity_recurrent(torch, np)
    phase_parity_overlap_static(torch, np)
    phase_parity_xlstm_moe(torch, np)
    phase_parity_encdec_vlm(torch, np)
    launches, base_outs, model, params = phase_serve(
        torch, np, prompts, news, warm, args.profile)
    phase_static_serve(torch, np, prompts, news, model, params)
    spec = phase_spec_serve(torch, np, args.profile)
    launches.update(K3=spec["K3_verify"], K3_suffix=spec["K3_suffix"])
    quant = phase_quant_serve(torch, np, prompts, news, warm, base_outs,
                              model, params)
    phase_parity_replica(torch, np)
    launches.update(phase_replica_serve(torch, np, prompts, news, warm,
                                        base_outs, model, params))
    phase_parity_tp(torch, np)
    logit_prompts = [p[:64] for p in prompts[:HALF]]
    base_logits, base_pool = tp_base(torch, model, params, logit_prompts)
    del model, params
    torch.cuda.empty_cache()
    tp_launches = phase_tp_serve(
        torch, np, "olmo_1b", TP, tp_turns(np, prompts, news, warm),
        base_outs, base_logits, base_pool, logit_prompts)
    torch.cuda.empty_cache()
    for k, n in phase_tp_replica_serve(torch, np, prompts, news, warm,
                                       base_outs).items():
        tp_launches[k] += n
    torch.cuda.empty_cache()
    tpd_launches = phase_tp_disagg_serve(torch, np, prompts, news, warm,
                                         base_outs)
    torch.cuda.empty_cache()
    tpf_launches = phase_parity_tp_families(torch, np)
    phase_parity_tp_replica(torch, np)
    tpd_parity = phase_parity_tp_disagg(torch, np)
    tpf_launches.update(phase_tp_families_serve(torch, np, prompts, warm,
                                                TPF_SERVE, TP))
    torch.cuda.empty_cache()
    tpf_launches.update(phase_tp_encdec_serve(torch, np))
    torch.cuda.empty_cache()
    rec = phase_recurrent_serve(torch, np, prompts, news, warm, args.profile)
    launches.update(K5=rec["K5"], K5_long=rec["K5_long"])
    torch.cuda.empty_cache()
    phase_xlstm_serve(torch, np, prompts, news, warm, args.profile)
    torch.cuda.empty_cache()
    moe = phase_moe_serve(torch, np, prompts, news, warm, args.profile)
    launches.update(K1_moe=moe["K1"], K2_moe=moe["K2"])
    torch.cuda.empty_cache()
    launches.update(phase_encdec_serve(torch, np, args.profile))
    torch.cuda.empty_cache()
    launches.update(phase_vlm_dense(torch, np, args.profile))
    torch.cuda.empty_cache()
    launches.update(phase_tile_path(torch, np, args.profile))
    torch.cuda.empty_cache()
    k1_bwd = phase_parity_train(torch, np)
    torch.cuda.empty_cache()
    launches["K1_bwd"] = phase_train(torch, np)["K1_bwd"]
    torch.cuda.empty_cache()
    fam = phase_train_families(torch, np)
    launches.update(K1_bwd_moe=fam["qwen3_moe_30b_a3b"]["K1_bwd"],
                    K1_bwd_whisper=fam["whisper_base"]["K1_bwd"])

    kernels = []
    for row, key, name, src, tpu in (
            (k1, "K1", "flash_attention",
             "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:109"),
            (k2, "K2", "paged_decode_attention",
             "src/repro_torch/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention.py:158"),
            (k2c, "K2_combine", "paged_decode_combine (K2's split merge)",
             "src/repro_torch/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention.py:158"),
            (k1, "K1_replica",
             "flash_attention (replica_serve: the prefill of ReplicaSet(dp=2) "
             "and of DisaggregatedEngine's prefill replica; timed at serve's "
             "shape)",
             "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:109"),
            (k2, "K2_replica",
             "paged_decode_attention (replica_serve: every decode replica's "
             "graph replays)",
             "src/repro_torch/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention.py:158"),
            (k2c, "K2_combine_replica",
             "paged_decode_combine (replica_serve's decode replicas)",
             "src/repro_torch/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention.py:158"),
            (k1_moe, "K1_moe",
             "flash_attention (qwen3_moe GQA 32/4, moe_serve's prefill)",
             "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:109"),
            (k2_moe, "K2_moe",
             "paged_decode_attention (qwen3_moe GQA 32/4, moe_serve's "
             "decode)",
             "src/repro_torch/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention.py:158"),
            (k1_wenc, "K1_whisper_enc",
             "flash_attention (whisper's encoder, non-causal over 1500 "
             "frames: the dense path's)",
             "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:109"),
            (k1_wx, "K1_whisper_xattn",
             "flash_attention (whisper's cross-attention, non-causal over "
             "1500 frames: the dense path's decode steps; timed at one "
             "query row)",
             "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:109"),
            (k2_wh, "K2_whisper",
             "paged_decode_attention (whisper 8/8 x 64, encdec_serve's "
             "decode)",
             "src/repro_torch/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention.py:158"),
            (k1_vl, "K1_qwen2vl",
             "flash_attention (qwen2-vl GQA 12/2, vlm_dense's prefill)",
             "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:109"),
            (k3, "K3", "paged_verify_attention (verify: split body)",
             "src/repro_torch/csrc/paged_verify_split.cuh",
             "src/repro/kernels/paged_attention.py:301"),
            (k3s, "K3_suffix",
             "paged_verify_attention (suffix prefill, 64-row bucket: "
             "wgmma body)",
             "src/repro_torch/csrc/paged_verify_wgmma.cuh",
             "src/repro/kernels/paged_attention.py:301"),
            (k4d, "K4_decode", "K4 paged_decode_attention (int8/fp8 pool)",
             "src/repro_torch/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention.py:43"),
            (k4v, "K4_verify",
             "K4 paged_verify_attention (fp8 pool, verify: split body)",
             "src/repro_torch/csrc/paged_verify_split.cuh",
             "src/repro/kernels/paged_attention.py:43"),
            (k4s, "K4_verify_suffix",
             "K4 paged_verify_attention (fp8 pool, suffix prefill, "
             "64-row bucket: wgmma body)",
             "src/repro_torch/csrc/paged_verify_wgmma.cuh",
             "src/repro/kernels/paged_attention.py:43"),
            (k5, "K5", "rglru_scan (admissions other than the long one; "
             "timed at (8, 512, 2560))",
             "src/repro_torch/csrc/rglru_scan.cu",
             "src/repro/kernels/rglru_scan.py:52"),
            (k5_long, "K5_long",
             "rglru_scan (recurrent_serve's long admission, (2, 2560, 2560))",
             "src/repro_torch/csrc/rglru_scan.cu",
             "src/repro/kernels/rglru_scan.py:52"),
            (k6, "K6", "stx_matmul",
             "src/repro_torch/csrc/stx_matmul.cu",
             "src/repro/kernels/stx_matmul.py:53"),
            (k7a, "K7a", "stencil2d",
             "src/repro_torch/csrc/stx_stencil.cu",
             "src/repro/kernels/stx_stencil.py:53"),
            (k7b, "K7b", "stencil3d",
             "src/repro_torch/csrc/stx_stencil.cu",
             "src/repro/kernels/stx_stencil.py:86"),
            (k8a, "K8a", "vrp_dot",
             "src/repro_torch/csrc/vrp_dot.cu",
             "src/repro/kernels/vrp_dot.py:69"),
            (k8b, "K8b", "vrp_sum",
             "src/repro_torch/csrc/vrp_dot.cu",
             "src/repro/kernels/vrp_dot.py:109"),
            (k8_finalize_row(k8a), "K8_finalize",
             "vrp_finalize (K8's compensated tree over the 1024 lanes)",
             "src/repro_torch/csrc/vrp_dot.cu",
             "src/repro/kernels/ops.py:278"),
            (k1_bwd["olmo"], "K1_bwd",
             "flash_attention_bwd (K1's backward: dQ, dK, dV at olmo_1b's "
             "training shape; the JAX package differentiates K1's oracle, "
             "no Pallas backward)",
             "src/repro_torch/csrc/flash_attention_bwd.cu",
             "src/repro/kernels/flash_attention.py:109"),
            (k1_bwd["moe"], "K1_bwd_moe",
             "flash_attention_bwd (qwen3_moe GQA 32/4 x 128 at "
             "train_families' (4, 2048), causal)",
             "src/repro_torch/csrc/flash_attention_bwd.cu",
             "src/repro/kernels/flash_attention.py:109"),
            (k1_bwd["whisper"], "K1_bwd_whisper",
             "flash_attention_bwd (whisper_base in train_families: launches "
             "of its encoder, decoder and cross-attention; timed at the "
             "cross-attention, 448 query rows over 1500 keys, non-causal)",
             "src/repro_torch/csrc/flash_attention_bwd.cu",
             "src/repro/kernels/flash_attention.py:109")):
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": tpu,
                        "launches": {**launches, **quant}[key],
                        **{k: row[k] for k in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms", "body", "splits",
                            "graph_ms", "simt_ms", "call_ms", "call_host_ms")
                           if k in row}})
    kernels += tp_rows(tp_kernels, tp_launches)
    kernels += tpd_rows(tp_kernels, tpd_launches, tpd_parity)
    kernels += tpf_rows(tpf_kernels, tpf_launches)
    emit({"kernels": kernels})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
