#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA device and ``nvcc``, imports nothing of JAX or of the
JAX package, and exits nonzero (printing no result) when there is no card
or when it is not run from a checkout of the repository. Phases, each
printing its lines; any failed check raises and the exit code is nonzero.
The sessions and the LM engines of phases 3-9, 7/7b/7c and the main paths
of 12a-c run eagerly (``cuda_graphs=False``), so that every launch goes
through its wrapper, where the ``Recorder`` and the launch counts see it;
phases 10, 11 and the graph engines of 12a-c run the default, one CUDA
graph per key:

1. device: torch version, card name and ``nvidia-smi`` power limit; TF32
   off (the port sets it on import);
2. build: compile ``src/repro_torch/csrc/*.cu`` with nvcc, timed;
2b. the ``wgmma`` helpers the bf16 attention backward is built on, alone
   (``wgmma_check``): a product from shared memory with both operands
   K-major and one with A from registers and B MN-major, on tiles loaded
   by the backward's TMA maps, against ``torch.matmul`` at D 64 and 128;

MinkUNet-42 (OS dataflow):

3. kernels vs plain versions on the card, at the shapes of the main path:
   every launch of one batch-of-2 forward is recorded and re-run through
   the kernel and its plain PyTorch version — superwindow maps and
   overflow counters equal, and each launch of the overflow repair kernel
   (on a copy of the map the search gave) equal to its plain version
   (each search and repair timed on the card with the
   host's enqueue hidden, as the search kernels take less time than their
   wrappers' host code, and through the wrapper, each with its GB/s over
   the bound's bytes: the words at their size, the output rows and
   anchors read once, the int32 map and counters written once; the
   level-0 and level-4 launches alone), segment sums bitwise, OS within
   ``1e-5 * max(1, max|ref|)`` in fp32 (and ``2e-2`` relative in bf16 at
   the stem, a 256->256 layer and an up-conv), and every fp32 OS launch
   against the same gather-GEMM in float64 (the kernel's max|error|
   within ``max(4 * the plain version's, 1e-6 * max|ref|)``, one line per
   launch) with its tile ops (2 * 128 rows * offsets a 128-row tile runs *
   Cin * Cout) and the ops of the packed 16-row fragments the kernel
   multiplies beside its useful ops by layer group; each timed with CUDA
   events beside its plain version, its bound and the library yardstick
   (for the segment sum ``torch.segment_reduce``, here, at CenterPoint's
   and at the training step's launches, with the device time of each of
   its three passes; for the OS kernel, here and at CenterPoint's
   launches, one ``torch.einsum`` over the gathered, pre-masked ``[M, Kd,
   Cin]`` tensor, the gather not timed);
4. main path: MinkUNet-42 at full width through ``compile_network`` ->
   ``SpiraSession`` on two outdoor LiDAR-sized scenes — scene 0 alone,
   then the batch of 2, each twice — checking finite logits, batched
   scene 0 bitwise equal to the single run, one compiled key per bucket,
   and 42 launches of each of its kernels per call; then one more
   batch-of-2 call under ``torch.profiler`` for the device's busy share
   and its time by kernel;
5. the same session on the plain path (engine "zdelta", backends "torch")
   on the same card: kernel maps equal, logits within
   ``1e-3 * max|logits|``;
5m. the published MinkUNet (``pc.minkunet()``, 49 bias-free layers) at
   full width on four outdoor scenes, the shapes of the benchmark cell
   ``minkunet42-outdoor-b4``: every superwindow launch of one batch-of-4
   forward (the K = 2 ones also apart), every OS launch and every fused
   epilogue launch against its plain version as in 3 (each epilogue
   bitwise its chain, with the device ms, chain ms and bound of each norm
   order); the main path as in 4 with the launches and the fused
   epilogues by order per call; the plan's maps by kind and each equal to
   the ``zdelta`` engine's; one profiled call.

CenterPoint-Large (hybrid dataflow, t = 3, K = 5), same scenes:

3. every kernel launch of one batch-of-2 forward against its plain
   version as above — WS within ``1e-5 * max(1, max|ref|)`` in fp32 and
   every fp32 WS launch against the same function in float64 (gated as
   the OS launches, one line per launch), the device time of the WS
   kernel's passes (pack, rank, sweep) and its largest launch's peak
   memory; WS also at ``s2_b0a``'s shapes with a capacity that drops
   pairs (the pack kernel's kept set equal to the kept map's), and
   ``2e-2`` relative in bf16 at ``stem``, ``s2_down`` and ``s3_b0a``;
   then the per-group window search kernel on
   every layer of the plan (phase 4d's launches): maps and counters equal;
   every repair launch of the forward (and of 4d's plan) against its plain
   version, each phase's repair line with the device time of an
   unflagged launch (as in 3, 4e and 11c);
4b. main path at full width: scene 0 alone, then the batch of 2, each
   twice — finite logits, batched scene 0 bitwise equal to the single
   run, two compiled keys, and per call 20 superwindow, 20 segment-sum,
   17 OS and 20 WS launches; one profiled batch-of-2 call;
4c. escalation: every layer at ``ws_capacity = 32768`` drops pairs, the
   session replans once (bucket 524,288) and its logits equal the
   lossless session's bitwise;
4d. the per-group window engine: its plan's maps equal the superwindow
   engine's for all 20 layers; repaired cells per layer;
4e. int64 packed words: MinkUNet-42 at full width on two outdoor scenes of
   extent (2048, 2048, 64) (312,341 and 310,451 voxels, a 12/12/7 + 1
   batch-bit layout: 32 bits, so int64 words; buckets 524,288 and
   1,048,576): every superwindow launch of one batch-of-2 forward equal to
   its plain version, the main path as in 4 (scene 0 alone, then the
   batch of 2, each twice: finite logits, batched scene 0 bitwise equal
   to the single run, 42 launches of each kernel per call), and one
   ``zdelta_cuda_window`` plan of the same coordinates, every launch equal
   to its plain version and every map to the superwindow engine's; ms
   per call, the searches' device ms against their bound, repaired cells
   per layer, and every repair launch of the window plan (int64 words,
   thousands of flagged cells) equal to its plain version;
5b. the plain path (engine "zdelta", backends "torch"): maps equal, logits
   within ``1e-3 * max|logits|``, no kernel launched.

The tuner and the paper's baselines (phase 8, after 4e; the scenes of
phases 4 and 4b, tuned on scene 0 alone):

8a. CenterPoint-Large through ``compile_network(tuner="cost_model")``
   and ``tuner="measure"``: per layer the tuned t, backend, window (and
   whether it was held to the search kernel's largest) and half-search,
   the seconds each tuning took; every tuned layer on the kernels
   (``backend == "cuda"``). The measure-tuned session driven as in 4b
   (launches per call from its tuned specs, batched scene 0 bitwise equal
   to the single run, repaired cells per layer, one profiled call), then
   the untuned, measure- and cost-model-tuned sessions' batch-2 calls in
   turns; its logits against the plain path with the same tuned specs,
   and bitwise equal to a session rebuilt from the mapping form of the
   same results;
8b. MinkUNet-42 under ``tuner="cost_model"``: the half-search decisions
   of the submanifold layers, driven as in 4, logits against the plain
   path with the same specs;
8c. the baselines at MinkUNet-42's batch-2 plan (bucket 262,144): the
   ``bsearch`` and ``hash`` engines' maps and the sequential plan's
   levels and maps (``sequential_plan_fns``) equal to the fused
   ``zdelta_cuda`` plan's, ``BucketedPlanner`` one key per bucket, and
   each engine's network-plan ms (wall clock, synchronised; the plain
   torch engines timed, not tuned).

MinkUNet-42 training (the same scenes with 20-class labels, batch 2,
bucket 262,144):

6. the training kernels at one step's shapes: every OS dF launch over the
   transposed maps and every dW launch (42 layers and the head) against
   their plain versions within ``1e-4 * max|ref|``, and both against the
   same contraction in float64 (the kernel's max|error| within
   ``max(4 * the plain version's, 1e-6 * max|ref|)``; the dF launches with
   their tile ops as in 3, the dW launches with the packed rows they
   multiply and timed beside one fp32 ``torch.matmul`` of the
   pre-gathered, masked ``[Kd, Cin, M]`` tensor with g), every
   segment-sum launch of the step bitwise; then
   ``ops.output_stationary_fused`` (the
   masked grouped GEMM kernel) on every layer's forward operands within
   ``1e-5 * max(1, max|ref|)`` of its plain version and of the OS kernel,
   and against float64 as the OS launches (one line per launch), timed
   beside one ``torch.einsum`` on the pre-masked gathered tensor, with
   its useful and dense TFLOP/s and GB/s over the bound's bytes; an inf
   at a masked position still makes its row NaN;
6b. the training main path: ``compile_network(...).compile_train()``,
   5 steps with every kernel's launches and the kernel-map searches
   checked per step (one inference plan's, none in the backward), the
   loss falling, one profiled step, then the session serving the trained
   weights;
6c. one step's gradients through the kernels against the plain path on
   the card, gated relative to the kernel path's own sensitivity to a
   1e-6 weight perturbation (full-depth gradients at random init are
   ill-conditioned), and bitwise equal at buckets 262,144 and 524,288;
6d. the WS dataflow's training at full width: 2 steps (WS forward and dF
   at Cout 32-256) and its gradients against the plain path as in 6c.

The self-healing trainer and its checkpoints (phase 9, after 6d; the same
scenes, labels and bucket; every attempt — a full batch or a bisection
sub-batch — launches each kernel as a 6b step does and runs one plan's
42 searches; checkpoints go to a temporary directory):

9a. ``compile_train(guard=...)`` and ``compile_train()`` from the same
   weights, 13 clean steps each in turns: params, moments and step bitwise
   equal after every step; ms per step of each (CUDA events) over the
   last 12 pairs, in alternating order, and the per-pair difference's
   median and quartiles;
9b. scene 0 alone at its bucket, a bisected commit's shape: its gradients
   against the plain path as in 6c; scene 1 poisoned with NaN, then +Inf, then -Inf
   (``train.faults.poison_scene_nonfinite``): each full batch refused
   (``step_ok`` 0), scene 0 committed alone by bisection and scene 1
   quarantined, the state bitwise equal to the plain trainer stepped on
   scene 0 alone, nothing non-finite in params or moments; then every
   label poisoned (``poison_labels``) after the detector has its history:
   skipped as a spike, the state unchanged; the counters and the ms of a
   bisected step;
9c. ``GuardConfig(ckpt_every=2)`` with an async manager (keep 3): the ms
   a save blocks the step, the writer's ms and the checkpoint's size; a
   fresh session resumed from step 6 (restore ms) and stepped twice,
   bitwise equal to the uninterrupted run's step 8; step ms with a write
   in flight against without one, in turns; the newest checkpoint
   byte-flipped: resume walks back to step 6 with one checksum failure;
   both scenes NaN: every ``rollback_after`` dead steps restore
   ``last_good`` bitwise, and after ``max_rollbacks`` the trainer raises
   ``TrainAbortError``.

The point-cloud serving engine (phase 10, after 9; ``PointCloudServeEngine``
over ``compile_network(..., batch=2)`` sessions with the weights of phases
4 and 4b; four requests: phase 4's two scenes and two more of
``scene_batch(seed=1, ...)``, features as phase 4 makes them):

10a. MinkUNet-42: a clean run (two batches of 2; every answer, logits and
   voxels, bitwise equal to the bare session's single-scene call; every
   session call launches 42 superwindow, 42 OS and 42 segment-sum
   kernels, counted without the ``Recorder``); a poisoned run through
   ``FaultySession(poison=feature_poison())`` with request 1 carrying a
   ``poison_features`` marker (request 1 quarantined by bisection, the
   others bitwise the clean run; the counters); 8 requests serial and
   with ``pack_ahead=True`` in turns (answers bitwise, ``packs_overlapped``);
   ms per request and per batch against the bare batch-2 call timed in
   the same run, the host's pack, move and answer ms and the ``serve/pack``
   and ``serve/dispatch`` histograms; one engine ``step()`` profiled;
10b. CenterPoint-Large, as 10a (20 superwindow, 20 segment-sum, 17 OS
   and 20 WS launches per call), then phase 4c's lossy session
   (``ws_capacity = 32768``) through the engine: one replan counted in
   ``overflow_replans``, answers bitwise the lossless session's; with a
   ``DegradationLadder`` pinned at rung 2 the same call carries
   ``max_replans=0`` and its ``HealthReport`` shows the dropped pairs;
10c. 2x overload with the MinkUNet-42 session: ``tests/test_overload.py``'s
   scenario (admission and ladder configs, ``scheduler="bucket"``) on a
   ``FakeClock`` whose service time is 10a's bare batch-2 median, 24
   requests at ``2 * num_scenes / d``: every request one terminal
   outcome, every ``ok`` answer bitwise the unloaded one, every dispatch
   the real kernels; ``LoadReport.summary()``.

Phase 10's sessions are graph sessions and its references the
single-scene calls of an eager session on the same weights, so the
bisection of 10a/10b captures the single-scene key (bucket 131,072) in
the middle of serving and 10b's lossy session captures one key per
escalation level; ``CallCheck`` holds every call to its launches: one
forward's per body run, ``WARMUP_RUNS + 1`` runs for each key a
call captures and none for a replay, and one replay per escalation level.

One CUDA graph per key (phase 11, after 10; phase 4's scenes, weights from
seed 0, each network as an eager session and a graph session on the same
weights):

11a. MinkUNet-42, 11b. CenterPoint-Large, 11c. CenterPoint-Large under
   phase 8a's measure tuning (its windows overflow at batch 2): for
   scene 0 alone and the batch of 2, the capture's launches (one forward
   per body run), seconds and the memory it reserved, and the replay
   bitwise the eager call (logits, words, count, health); the keys
   replayed out of capture order, bitwise, launching nothing through the
   wrappers; ``GRAPH_PAIRS`` batch-2 calls of each in turns (ms per call,
   medians and IQRs, pairs won); one profiled call of each (device idle
   share); 11c also holds every repair launch of an eager tuned call
   against its plain version (the flagged cells re-searched);
11d. (after 7c) yi-9b's decode step: an engine with the decode graph and
   an eager one over the same weights and four requests, ``DECODE_PAIRS``
   steps of each in turns after the capture: greedy tokens equal, ms per
   step and tokens/s, one profiled replayed step.

yi-9b LM serving (48 layers, d_model 4096, 32 heads, GQA kv 4, head dim
128, bf16; random weights from a seeded generator on the card):

7. the flash attention kernel against its plain version on the card: the
   JAX kernel sweep's shapes through ``ops.attention`` in fp32 and bf16
   (fp32 within ``1e-5 * max(1, max|ref|)``, bf16 within ``2e-2``
   relative), then every prefill launch of the 7b run (recorded while it
   ran); each shape timed with CUDA events beside its plain version, its
   bound and ``scaled_dot_product_attention`` (the library yardstick,
   never called by the port);
7b. the main path: ``ServeEngine(batch_slots=4, cache_len=4096)`` serving
   8 requests with prompts drawn as ``launch/serve.py`` draws them and 2
   long prompts of 1024 and 2000 tokens, 16 greedy tokens each — finite
   logits, 48 flash attention launches per prefill and none per decode
   step; ms per prefill by length, ms per decode step, tokens/s; one
   profiled decode step and one profiled 2000-token prefill;
7c. the same weights on the plain path (``backend="torch"``): no kernel
   launched; the 2000-token prompt's prefill logits and 16 decode steps
   teacher-forced on 7b's tokens no farther (relative L2) from the plain
   bf16 path than that path is from the same weights run in fp32 (both
   distances printed, and the kernel path's distance in fp32); greedy
   agreement printed, not gated (random-init logits have near-ties).

Every LM architecture the reference configures (phase 12, after 11d; the
yi-9b weights and every graph pool freed first, the memory still reserved
checked against what the phase needs; weights random from seed 0 on the
card in ``cfg.dtype``, bf16; ``LM_SLOTS`` slots, cache ``LM_CACHE``):

12a. qwen3-moe-30b-a3b at full width and depth (48 layers, d_model 2048,
   128 experts top-8 of d_ff 768, GQA kv 4, head dim 128; 30.5 B
   parameters): the main path as 7b on an eager engine, 8 prompts drawn as
   ``launch/serve.py`` draws them plus one of 2,000 tokens, 16 greedy
   tokens each (finite logits; 48 flash launches per prefill and none per
   decode step), every prefill launch against its plain version as in 7;
   then a graph engine and an eager engine over the same weights and the
   first four prompts, 16 decode steps in turns: greedy tokens, the
   step's logits after every step and every state leaf after the last
   bitwise equal; ms per step and tokens/s of each, one profiled replayed
   step; the plain path's (``backend="torch"``) relative L2 from the
   kernel path on the 2,000-token prefill, printed, not gated (an fp32
   copy does not fit);
12b. jamba-1.5-large at full width (d_model 8192, 64 heads, kv 8, 16
   experts top-2 of d_ff 24,576, d_state 16, expand 2), depth cut to
   positions 3 and 4 of its period of 8, ``(mamba, dense)`` then
   ``(attn, moe)``, repeat 1: 2 of 72 sub-layers, 11.9 B parameters; the
   checks of 12a on 4 drawn prompts plus one of 2,048 tokens (one flash
   launch per prefill); the graph engine bitwise the eager one over all
   16 steps (the recurrent state restored after the capture's warm-up);
   one 2,048-token prefill with the Mamba block's and the Mamba scan's
   spans on the card (CUDA events around each call), then profiled; then
   the same prefill with ``REPRO_MAMBA_PREMAT=1`` against the default in
   turns (``premat_ab``): ms and peak memory of each, the premat logits
   within ``PREMAT_GATE`` of max|logits| of the default's;
12c. xlstm-350m at full width and depth (24 layers, 7 mLSTM : 1 sLSTM),
   the checks of 12b on 4 drawn prompts plus one of 1,024 tokens; it has
   no attention, so it launches no kernel (its lines say so); the mLSTM
   and sLSTM blocks' spans of one 1,024-token prefill;
12d. musicgen-medium at full width and depth (48 layers, d_model 1536,
   24 heads of 64) on embedding inputs: a prefill of 1,024 seeded random
   frame embeddings, then 16 decode steps fed with embeddings; 48 flash
   launches in the prefill and none per step, each held against its
   plain version; the plain path's logits beside it (relative L2, not
   gated).

Phase 12's flash launches join the kernel table's flash row (its
launches and times are summed over 7b, 12 and 13b; its paths list each
arch's prompt lengths).

LM training (phase 13, after 12d; autograd on inside it, bf16 unless
said):

13a. the attention backward kernels (``flash_attention_bwd``: dQ, then
   dK/dV) at the main path's shape (B 4, S 2,048, 32 heads, KV 4, head
   dim 128), at D 64 and 256, in fp32, at a ragged S = 1,000 and at the
   edge shape Sq 130 < Skv 200 (``BWD_SHAPES``), causal:
   dq, dk, dv of each launch against the plain backward evaluated in
   float64 (bf16 within 2e-2 of max|ref|, the forward's gate; fp32 within
   ``BWD_FP32_GATE``), two launches bitwise equal, the forward's output
   bitwise the same with and without its lse buffer; each timed with CUDA
   events beside its bound (2.5x the forward's operations), the plain
   version and the backward of ``scaled_dot_product_attention``
   (``enable_gqa``, the library yardstick);
13b. the main path: yi-9b at full width with the depth cut to
   ``TRAIN_LM_LAYERS`` of 48 (3.29 B parameters: the bf16 weights and
   gradients and the fp32 AdamW moments of all 48 layers, 106 GB, do not
   fit one card), ``train.make_train_step`` with remat, seq 2,048 x batch
   4 of ``data.tokens`` batches, the reference's AdamW defaults, 8 steps
   with the launch counts set to 0 before and read after (per step 32
   flash forward launches, 16 of them remat's recomputation, and 16
   backward launches; nothing else): ms per step, tokens/s, the loss per
   step (finite), peak memory, one profiled step; one more step recorded
   and every launch of it held against its plain version (the forward's
   output and lse, the backward against float64); then on a 2-layer,
   512-token cut of the same width the step-0 gradients of the kernel
   path against the plain path (``backend="torch"``): no farther in
   relative L2 than the plain bf16 path is from the same weights in fp32;
   whether two runs of the same 3 steps are bitwise equal (logged with
   the first leaf that differs and its op, not gated);
13c. on that cut: ``grad_accum=2`` against 1 (gradient norms within 2e-2)
   and ``train(compress_grads=True)`` over 3 steps, the residual carried;
13d. ``launch.train.main`` with ``--arch yi-9b --smoke --steps 3`` then
   ``--steps 5 --resume`` against 5 straight steps (the smoke config's
   heads widened to 64 for the kernels), and one training step at the
   smoke config of every other token architecture: finite loss, every
   leaf changed, the flash launches counted.

The multi-card layer (phase 14, after 13d; ``dist.sharding`` on DTensor,
``launch/{mesh,dryrun,op_analysis,roofline}.py``):

14a. a one-rank NCCL process group and its ``(1, 1)`` ``("data",
   "model")`` mesh; ``sharding_ctx(fsdp=True)``; 13b's yi-9b cut (16
   layers, seq 2,048 x batch 4, remat, bf16) from seed 0 for
   ``SHARD_STEPS`` steps on DTensor parameters and moments, against the
   plain step from the same init: every loss and every parameter and
   moment bitwise equal (at world size 1 every redistribution moves
   nothing), the flash forward and backward launched on this path
   (through ``local_map`` on the rank's heads, counted); then
   ``SHARD_TIMED_PAIRS`` (plain, sharded) pairs in alternating turns on
   one state (the plain step on the DTensors' own local tensors): the
   medians;
14b. reshard-on-load on a 2-layer, 512-token cut of the same width: the
   sharded state saved and restored into plain tensors, the plain state
   saved and restored with ``shardings=`` into DTensors on the mesh; one
   step after each bitwise the uninterrupted run's;
14c. the dry run (``launch.dryrun``, in a background process on the CPU
   while 14b runs: every cell on ``meta`` under a fake process group) of
   yi-9b ``train_4k`` and ``decode_32k`` on ``1x1`` and ``16x16`` and of
   qwen3-moe-30b-a3b ``train_4k`` on ``16x16`` at full size, and of 14a's
   cell on ``1x1``: ``n_params`` equal to the config's count, the
   per-device terms and the bottleneck printed; the 14a cell's parameter
   and optimizer bytes equal to what the card held in 14a, its peak-live
   estimate printed beside 14a's ``max_memory_allocated`` (not gated);
14d. the whole-step roofline of 14a's plain step: 6·N·D and the op
   counter's FLOPs, each over (median step x 989 TFLOP/s).

The kernel table's flash rows add 14a's launches under the path ``yi-16
sharded``.

The examples on the card (phase 15, after 14d): each of
``examples/torch_{quickstart,pointcloud_inference,train_pointcloud,
robust_train,serve_lm,train_lm}.py`` in its full mode, ``main(["--device",
"cuda"])`` in this process with autograd on, its own asserts and ✓ lines
included, the launch counts set to 0 just before and read just after
(``Sampler``: the first and the latest launch of each kernel recorded):
every kernel the example's path runs launched, and those two launches of
each held against its plain version by the check of the phase that
introduced it (``check_search``, ``check_repair``, ``check_os`` with the
float64 gate, ``check_ws``, ``check_segsum``, ``check_dw``,
``check_flash`` with 13b's lse gate; the attention backward twice
bitwise and against float64 by the float64 gate of the fp32 OS, WS and
dW launches, ``check_bwd_samples``; a training example's OS sample at
phase 6's dF gate and its segment sums as gradients); one ``[15x ...]``
line each with its seconds, its launches
and its headline number. The kernel table's paths gain the keys
``ex-quickstart``, ``ex-pc-infer``, ``ex-train-pc``, ``ex-robust-train``,
``ex-serve-lm`` and ``ex-train-lm``.

After each phase a ``[seconds]`` line gives its seconds and the run's so
far. The second-to-last lines are the kernel table as JSON and the raw
``nvidia-smi --query-gpu=name,power.limit`` line; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_FP32_PER_S = 67e12         # H100 SXM fp32, CUDA cores
PEAK_BF16_PER_S = 989e12        # H100 SXM bf16 dense, tensor cores
LOSSY_CAPACITY = 32768          # below s2_b0a's largest WS column (63,255)
REPLACES = {
    "zdelta_superwindow_search": ("src/repro_torch/csrc/zdelta_superwindow.cu",
                                  "src/repro/kernels/zdelta_window.py:246"),
    "spconv_gather_gemm": ("src/repro_torch/csrc/spconv_gather_gemm.cu",
                           "src/repro/kernels/spconv_gather_gemm.py:97"),
    "segment_sum": ("src/repro_torch/csrc/segsum.cu",
                    "src/repro/kernels/segsum.py:252"),
    "ws_scatter_gemm": ("src/repro_torch/csrc/ws_scatter_gemm.cu",
                        "src/repro/kernels/ws_scatter_gemm.py:119"),
    "zdelta_window_search": ("src/repro_torch/csrc/zdelta_window.cu",
                             "src/repro/kernels/zdelta_window.py:130"),
    "masked_group_gemm": ("src/repro_torch/csrc/masked_group_gemm.cu",
                          "src/repro/kernels/masked_group_gemm.py:64"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:79"),
}
# port-only: no pl.pallas_call; the JAX package computes this contraction
# (_dw_per_offset) in XLA
PORT_ONLY = {
    "dw_gather_gemm": ("src/repro_torch/csrc/dw_gather_gemm.cu",
                       "src/repro/core/dataflow.py:282"),
    # the JAX package repairs overflowed window cells in XLA, behind lax.cond
    "zdelta_repair": ("src/repro_torch/csrc/zdelta_repair.cu",
                      "src/repro/core/network_plan.py:149"),
    # the JAX package differentiates its attention (grouped_attention) in XLA
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                            "src/repro/models/layers.py:26"),
    # the JAX package computes the bias, ReLU and per-scene BN in XLA
    "relu_bn": ("src/repro_torch/csrc/segsum.cu",
                "src/repro/models/pointcloud.py:234"),
}
# the fused epilogue's apply kernels, one per norm order (csrc/segsum.cu)
EPILOGUE_APPLY = ("relu_bn_apply", "bn_relu_apply", "bn_apply",
                  "bn_add_relu_apply")
PUB_EXTENT = (1024, 1024, 40)   # phase 5m: the cell minkunet42-outdoor-b4's
PUB_SCENES = 4                  # sweeps, four a call
TRAIN_STEPS = 5
SPIKE_WARM_STEPS = 10           # phase 9b's clean commits before the spike
GUARD_PAIRS = 12                # phase 9a's timed guarded/plain step pairs
LM_ARCH = "yi-9b"
LM_SLOTS, LM_CACHE, LM_MAX_NEW = 4, 4096, 16
LM_LONG = (1024, 2000)          # long prompts: multi-tile causal work
SERVE_EXTENT = (1024, 1024, 40)  # phase 10's two extra scenes (seed 1)
SERVE_OVERLOAD_REQUESTS = 24    # 10c's offered requests
GRAPH_PAIRS = 10                # phase 11's timed graph/eager call pairs
DECODE_PAIRS = 12               # 11d's timed graph/eager decode-step pairs
DEV = "cuda"
PROGRAM_SPANS = ("session/", "train/", "serve/", "ckpt/")  # obs.span paths


def log(*args) -> None:
    print(*args, flush=True)


class PhaseClock:
    """Seconds of each phase and of the run so far, one line per phase."""

    def __init__(self):
        self.start = self.last = time.perf_counter()

    def __call__(self, phase: str) -> None:
        now = time.perf_counter()
        log(f"[seconds] {phase}: {now - self.last:.1f} s (run "
            f"{now - self.start:.1f} s)")
        self.last = now


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` on the card: one warm-up, then ``reps``
    calls between two CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int) -> float:
    """Mean device ms per call of ``fn``: one warm-up, then ``reps`` calls
    enqueued behind a ~2 ms spin of the card, so the host's launch cost is
    hidden and the two CUDA events see the calls' device time alone."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(4_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def short_kernel_name(name: str) -> str:
    """A device kernel's name without its argument list."""
    name = name.replace("(anonymous namespace)::", "")
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.removeprefix("void ").strip()[:72]


def profile_call(fn) -> tuple[float, dict]:
    """Run ``fn`` once under ``torch.profiler``: its wall ms (host clock,
    synchronised) and the device ms of every kernel and copy, by name. The
    program's spans are ``record_function`` ranges under a profiler, which
    the CUDA trace mirrors as device-side user annotations spanning the
    kernels they enclose: those are left out, or busy time would count
    the kernels again."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not (
                getattr(e, "is_user_annotation", False)
                or e.name.startswith(PROGRAM_SPANS)):
            k = short_kernel_name(e.name)
            by_name[k] = by_name.get(k, 0.0) + e.device_time_total / 1e3
    return wall, by_name


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FP32_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


class Recorder:
    """Records the arguments of every kernel launch of one forward by
    wrapping the launching functions where the dispatchers look them up."""

    def __init__(self, names=None):
        from repro_torch.kernels import ops, segsum, zdelta_window
        from repro_torch.models import layers, pointcloud
        self.targets = [(zdelta_window, "zdelta_superwindow_cuda",
                         "zdelta_superwindow_search"),
                        (ops, "spconv_gather_gemm", "spconv_gather_gemm"),
                        (segsum, "segment_sum_cuda", "segment_sum"),
                        (ops, "ws_scatter_gemm", "ws_scatter_gemm"),
                        (zdelta_window, "zdelta_window_cuda",
                         "zdelta_window_search"),
                        (ops, "dw_gather_gemm", "dw_gather_gemm"),
                        (layers, "flash_attention", "flash_attention"),
                        (layers, "flash_attention_bwd",
                         "flash_attention_bwd"),
                        (zdelta_window, "zdelta_repair_cuda",
                         "zdelta_repair"),
                        (pointcloud, "relu_bn_cuda", "relu_bn")]
        if names is not None:
            self.targets = [t for t in self.targets if t[2] in names]
        self.calls = {name: [] for _, _, name in self.targets}

    def __enter__(self):
        self.saved = []
        for mod, attr, name in self.targets:
            orig = getattr(mod, attr)
            self.saved.append((mod, attr, orig))

            def wrapped(*a, _orig=orig, _name=name, **kw):
                self.calls[_name].append((a, kw))
                return _orig(*a, **kw)
            # the launchers count on the function their module binds
            wrapped.launches = getattr(orig, "launches", 0)
            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in self.saved:
            setattr(mod, attr, orig)
        return False


def search_bytes(a, m, ovf) -> int:
    """Bytes of a search launch's bound: the words (at their size), the
    output rows and the anchors read once, the per-group search's int32
    window starts read once, the int32 map and counters written once."""
    import torch
    arr, out2d, anchors = a[:3]
    nb = (arr.element_size() * (arr.numel() + out2d.numel() + anchors.numel())
          + 4 * (m.numel() + ovf.numel()))
    if torch.is_tensor(a[3]):               # zdelta_window_cuda's starts
        nb += 4 * a[3].numel()
    return nb


def check_search(calls, kind: str) -> dict:
    """Search launches (``kind`` "superwindow" or "window"): the kernel's
    map and counters equal (``torch.equal``) to its plain version's. Per
    forward: ``ms``, the launches' device time (``queued_ms``: the host's
    enqueue hidden; a search kernel takes less time on the card than its
    wrapper's host code takes to launch it), ``wrapper_ms``, the same
    launches timed back to back through the wrapper as the other kernels
    are (host-bound here), plain and bound ms, and the bound's bytes."""
    import torch
    from repro_torch.kernels import zdelta_window as zw
    kernel = getattr(zw, f"zdelta_{kind}_cuda")
    plain = getattr(zw, f"zdelta_{kind}_torch")
    t_k = t_q = t_p = b_tot = nbytes = 0.0
    for i, (a, kw) in enumerate(calls):
        mk, ok = kernel(*a, **kw)
        mp, op = plain(*a, **kw)
        if not (torch.equal(mk, mp) and torch.equal(ok, op)):
            raise RuntimeError(f"{kind} launch {i}: map or counters differ "
                               "from the plain version")
        t_k += cuda_ms(lambda: kernel(*a, **kw), 3)
        t_q += queued_ms(lambda: kernel(*a, **kw), 5)
        t_p += cuda_ms(lambda: plain(*a, **kw), 2)
        nb = search_bytes(a, mk, ok)
        nbytes += nb
        b_tot += bound_ms(nb, 0)[0]
    return dict(max_abs_err=0.0, ms=t_q, wrapper_ms=t_k, plain_ms=t_p,
                bound_ms=b_tot, bound_by="bytes", library_ms=None,
                gbytes=nbytes / 1e9)


def search_rates(r: dict) -> str:
    """GB/s over the bound's bytes at the device time and through the
    wrapper, and the share of the bound's rate (the aim: half or more)."""
    return (f"device {r['gbytes'] / r['ms'] * 1e3:.0f} GB/s over the "
            f"bound's {r['gbytes']:.3f} GB ({r['bound_ms'] / r['ms']:.1%} of "
            f"the bound's rate; half is {2 * r['bound_ms']:.3f} ms); through "
            f"the wrapper {r['wrapper_ms']:.3f} ms, "
            f"{r['gbytes'] / r['wrapper_ms'] * 1e3:.0f} GB/s")


def check_repair(search_calls, repair_calls, kind: str) -> dict:
    """Overflow-repair launches, each paired with the search launch before
    it (``kind`` "superwindow" or "window"): the search is re-run on its
    recorded arguments for the map as it was before the repair (the
    repair writes it in place) and must give the recorded counters; then
    the repair kernel, on a copy, must equal its plain version exactly, in
    every cell. Per forward: ``ms`` (device time, the host's enqueue
    hidden, as for the searches), ``wrapper_ms``, plain and bound ms; the
    bound's bytes are the counters read once and, per flagged cell, its
    128 output words read and its 128 x K map entries written once.
    ``flagged`` counts the flagged cells."""
    import torch
    from repro_torch.kernels import zdelta_window as zw
    search = getattr(zw, f"zdelta_{kind}_cuda")
    if len(search_calls) != len(repair_calls):
        raise RuntimeError(f"{len(repair_calls)} repair launches for "
                           f"{len(search_calls)} {kind} searches")
    t_k = t_q = t_p = b_tot = nbytes = 0.0
    flagged = 0
    unflagged = []                   # device ms of each unflagged launch
    for i, ((sa, skw), (a, kw)) in enumerate(zip(search_calls,
                                                 repair_calls)):
        arr, out2d, anchors, zstep, _, ovf = a
        m0, ovf0 = search(*sa, **skw)
        if not torch.equal(ovf0, ovf):
            raise RuntimeError(f"repair launch {i}: its counters are not "
                               f"the {kind} search's")
        mk = zw.zdelta_repair_cuda(arr, out2d, anchors, zstep, m0.clone(),
                                   ovf, **kw)
        mp = zw.zdelta_repair_torch(arr, out2d, anchors, zstep, m0, ovf,
                                    **kw)
        if not torch.equal(mk, mp):
            raise RuntimeError(f"repair launch {i}: the map differs from the "
                               "plain version's")
        t_k += cuda_ms(lambda: zw.zdelta_repair_cuda(
            arr, out2d, anchors, zstep, mk, ovf, **kw), 3)
        q = queued_ms(lambda: zw.zdelta_repair_cuda(
            arr, out2d, anchors, zstep, mk, ovf, **kw), 5)
        t_q += q
        t_p += cuda_ms(lambda: zw.zdelta_repair_torch(
            arr, out2d, anchors, zstep, m0, ovf, **kw), 2)
        cells = int((ovf > 0).sum())
        if cells == 0:
            unflagged.append(q)
        flagged += cells
        nb = 4 * ovf.numel() + cells * 128 * (arr.element_size()
                                              + 4 * kw["K"])
        nbytes += nb
        b_tot += bound_ms(nb, 0)[0]
    return dict(max_abs_err=0.0, ms=t_q, wrapper_ms=t_k, plain_ms=t_p,
                bound_ms=b_tot, bound_by="bytes", library_ms=None,
                gbytes=nbytes / 1e9, flagged=flagged,
                unflagged=(sum(unflagged) / len(unflagged), len(unflagged))
                if unflagged else None)


def unflagged_note(r: dict) -> str:
    """Pops check_repair's per-launch time of the unflagged launches and
    says it."""
    u = r.pop("unflagged")
    if u is None:
        return "; every launch had a flagged cell"
    return (f"; an unflagged launch {u[0] * 1e3:.2f} us of device time "
            f"(mean of {u[1]})")


def os_f64(F, m, W):
    """The OS gather-GEMM in float64 on the card: the yardstick of the fp32
    kernel's and plain version's rounding."""
    import torch
    acc = torch.zeros((m.shape[0], W.shape[-1]), dtype=torch.float64,
                      device=F.device)
    F64 = F.double()
    for k in range(m.shape[1]):
        col = m[:, k]
        g = F64[col.clamp(min=0).long()] * (col >= 0)[:, None]
        acc += g @ W[k].double()
    return acc


def os_tile_ops(m, cin: int, cout: int) -> tuple:
    """Operations of the OS kernel's tiles on this map, as (tile, packed):
    2 * 128 rows * (offsets some row of each 128-row tile uses) * Cin *
    Cout, and what the kernel multiplies, 2 * 16 * (16-row fragments of
    the rows that use each offset, packed) * Cin * Cout; summed over the
    tiles (one fp32 product counts once, not 3xTF32's three)."""
    import torch
    from repro_torch.kernels.spconv_gather_gemm import TILE_M
    M, Kd = m.shape
    pad = -M % TILE_M
    used = torch.cat([m >= 0, torch.zeros((pad, Kd), dtype=torch.bool,
                                          device=m.device)])
    per_tile = used.view(-1, TILE_M, Kd).sum(1)
    active = int((per_tile > 0).sum())
    packed = int(((per_tile + 15) // 16).sum()) * 16
    return (2.0 * TILE_M * active * cin * cout,
            2.0 * packed * cin * cout)


def check_os(calls, rel: float = 0.0, label: str = "3 os",
             names=None, library: bool = False) -> dict:
    """OS launches: fp32 within ``1e-5 * max(1, max|ref|)``, or within
    ``rel * max|ref|`` when ``rel`` is given (gradients, whose scale is far
    below 1). Every fp32 launch is also held against the same gather-GEMM
    in float64: the kernel's max|error| must stay within ``max(4 * the
    plain version's, 1e-6 * max|ref|)`` (one line per launch). Tile ops and
    useful ops are summed by layer group (``names``: the layer of each
    launch; else the launch's shape). With ``library``, each launch's
    function is also timed as one ``torch.einsum`` over the gathered,
    pre-masked ``[M, Kd, Cin]`` tensor (the library yardstick, as phase 6
    times the masked grouped GEMM's; the gather is not timed)."""
    import torch
    from repro_torch.kernels.spconv_gather_gemm import (
        spconv_gather_gemm, spconv_gather_gemm_torch)
    err = t_k = t_p = t_l = b_tot = ops_tot = bytes_tot = 0.0
    f64_worst = 0.0
    groups: dict = {}
    for i, (a, kw) in enumerate(calls):
        F, m, W = a
        got = spconv_gather_gemm(F, m, W)
        ref = spconv_gather_gemm_torch(F, m, W)
        d = float((got - ref).abs().max())
        tol = (rel * float(ref.abs().max()) if rel
               else 1e-5 * max(1.0, float(ref.abs().max())))
        if not d <= tol:
            raise RuntimeError(f"OS launch {i} ({F.shape[1]}->{W.shape[2]}): "
                               f"max|diff| {d} > {tol}")
        what = (names[i] if names else
                f"M={m.shape[0]} {F.shape[1]}->{W.shape[2]}")
        if F.dtype == torch.float32:
            ref64 = os_f64(F, m, W)
            e_k = float((got.double() - ref64).abs().max())
            e_p = float((ref.double() - ref64).abs().max())
            scale = float(ref64.abs().max())
            gate = max(4.0 * e_p, 1e-6 * scale)
            if not e_k <= gate:
                raise RuntimeError(f"OS launch {i} ({what}) against float64: "
                                   f"kernel max|err| {e_k} > max(4 * plain "
                                   f"{e_p}, 1e-6 * {scale})")
            f64_worst = max(f64_worst, e_k / gate)
            log(f"[{label} f64 {i} {what}] vs float64: kernel max|err| "
                f"{e_k:.3e}, plain {e_p:.3e}, max|ref| {scale:.3e}, gate "
                f"{gate:.3e}")
            del ref64
        err = max(err, d)
        t_k += cuda_ms(lambda: spconv_gather_gemm(F, m, W), 3)
        t_p += cuda_ms(lambda: spconv_gather_gemm_torch(F, m, W), 2)
        if library:
            pre = F[m.clamp(min=0).long()] * (m >= 0)[..., None].to(F.dtype)
            t_l += cuda_ms(lambda: torch.einsum("mkc,kcd->md", pre, W), 2)
            del pre
            torch.cuda.empty_cache()
        nnz = int((m >= 0).sum())
        ops = 2.0 * nnz * F.shape[1] * W.shape[2]
        nb = 4 * (F.numel() + m.numel() + W.numel() + got.numel())
        b_tot += bound_ms(nb, ops)[0]
        ops_tot += ops
        bytes_tot += nb
        grp = (what.rstrip("0123456789").split("_")[0] if names
               else what)
        g = groups.setdefault(grp, [0, 0.0, 0.0, 0.0])
        tile, packed = os_tile_ops(m, F.shape[1], W.shape[2])
        g[0] += 1
        g[1] += ops
        g[2] += tile
        g[3] += packed
    return dict(max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=b_tot,
                bound_by=bound_ms(bytes_tot, ops_tot)[1],
                library_ms=t_l if library else None,
                gflop=ops_tot / 1e9, f64_worst=f64_worst, groups=groups)


def log_os_groups(label: str, r: dict, card: str) -> None:
    """Useful against tile ops (and the packed fragments the kernel
    multiplies) by layer group: what separates the kernel's speed from the
    dataflow's waste (offsets a tile runs for few rows)."""
    tot = [sum(g[i] for g in r["groups"].values()) for i in (1, 2, 3)]
    for name, (n, useful, tile, packed) in r["groups"].items():
        log(f"[{label} tile ops {name}] {n} launches: useful "
            f"{useful / 1e9:.2f} GFLOP, tile {tile / 1e9:.2f} GFLOP "
            f"({tile / max(useful, 1.0):.2f}x), packed {packed / 1e9:.2f} "
            f"GFLOP ({packed / max(useful, 1.0):.2f}x)")
    u, t, p = (x / 1e9 for x in tot)
    log(f"[{label} tile ops] all: useful {u:.1f} GFLOP, tile {t:.1f} GFLOP "
        f"({t / max(u, 1e-9):.2f}x), packed {p:.1f} GFLOP "
        f"({p / max(u, 1e-9):.2f}x); kernel {u / r['ms']:.2f} TFLOP/s "
        f"useful, {p / r['ms']:.2f} TFLOP/s on the packed fragments; fp64 "
        f"gate worst {r['f64_worst']:.3f} of its limit | {card}")


def check_segsum(calls, *, gradients: bool = False) -> dict:
    """Segment-sum launches: bitwise equal to the plain version, within
    1e-3 relative of an fp64 sum; ``torch.segment_reduce`` on the same rows
    timed (and scored) beside them; the device time of each of the
    kernel's three passes over one launch of every call (``passes``).
    ``gradients``: the launches of a backward pass, whose sums cancel, so
    no fp64 comparison, and the plain version (a loop over chunks, slow for
    the bias gradients' one capacity-long segment) runs once per launch,
    untimed."""
    import torch
    from repro_torch.kernels import segsum as segsum_mod
    from repro_torch.kernels.segsum import segment_sum_torch
    lib_rel = f64_rel = 0.0
    t_k = t_p = t_l = b_tot = ops_tot = bytes_tot = 0.0
    for i, (a, kw) in enumerate(calls):
        x, sid, starts, counts = a
        got = segsum_mod.segment_sum_cuda(x, sid, starts, counts, **kw)
        ref = segment_sum_torch(x, sid, starts, counts, **kw)
        if not torch.equal(got, ref):
            raise RuntimeError(f"segment_sum launch {i}: not bitwise equal "
                               f"(max|diff| {float((got - ref).abs().max())})")
        t_k += cuda_ms(lambda: segsum_mod.segment_sum_cuda(x, sid, starts,
                                                           counts, **kw), 3)
        rows = int(counts.sum())
        nb = rows * x.shape[1] * x.element_size() + 4 * got.numel()
        ops = float(rows * x.shape[1])
        b_tot += bound_ms(nb, ops)[0]
        ops_tot += ops
        bytes_tot += nb
        # segments are contiguous from row 0 (the input contract)
        xs = x[:rows]
        lengths = counts.long()
        t_l += cuda_ms(lambda: torch.segment_reduce(xs, "sum",
                                                    lengths=lengths), 3)
        if gradients:
            continue
        t_p += cuda_ms(lambda: segment_sum_torch(x, sid, starts, counts,
                                                 **kw), 2)
        exact = torch.stack([x[int(s0):int(s0) + int(c)].double().sum(0)
                             for s0, c in zip(starts, counts)])
        floor = 1e-6 * float(exact.abs().max()) + 1e-30
        rel = float(((got.double() - exact).abs()
                     / exact.abs().clamp(min=floor)).max())
        if not rel <= 1e-3:
            raise RuntimeError(f"segment_sum launch {i}: {rel:.2e} relative "
                               "from the fp64 sum")
        f64_rel = max(f64_rel, rel)
        lib_out = torch.segment_reduce(xs, "sum", lengths=lengths)
        lib_rel = max(lib_rel, float(((lib_out.double() - exact).abs()
                                      / exact.abs().clamp(min=floor)).max()))

    def every_call():
        for a, kw in calls:
            segsum_mod.segment_sum_cuda(*a, **kw)
    every_call()
    _, by_name = profile_call(every_call)
    passes = {p: sum(v for k, v in by_name.items() if k.startswith(p))
              for p in ("chunk_offsets", "chunk_partials",
                        "combine_partials")}
    return dict(max_abs_err=0.0, ms=t_k, plain_ms=None if gradients else t_p,
                bound_ms=b_tot, bound_by=bound_ms(bytes_tot, ops_tot)[1],
                library_ms=t_l, f64_rel=f64_rel, lib_rel=lib_rel,
                passes=passes)


def log_segsum_passes(label: str, r: dict, card: str) -> None:
    """Device ms of the segment sum's passes over one launch of every
    recorded call (``torch.profiler``)."""
    p = r.pop("passes")
    log(f"[{label} passes] device ms over one launch of each call: chunk "
        f"offsets {p['chunk_offsets']:.3f}, chunk partials "
        f"{p['chunk_partials']:.3f}, combine {p['combine_partials']:.3f} "
        f"| {card}")


def relu_bn_chain(a, kw):
    """The chain of torch ops a fused epilogue launch replaces, on the
    launch's own arguments and the segment sum's kernel: by its ``order``
    the bias add, the row mask and ``_relu_bn`` (``relu_bn``), or
    ``_bn_relu``, ``_bn`` or ``_bn_add_relu`` with its residual operand on
    a bias-free layer's output."""
    from repro_torch.core.spconv import SpConvSpec, add_bias
    from repro_torch.kernels.segsum import SegmentSpec
    from repro_torch.models import pointcloud as pc
    x, count, seg = a
    sp = SegmentSpec(backend="cuda", q=kw["q"])
    order = kw.get("order", "relu_bn")
    if order == "bn_add_relu":
        return pc._bn_add_relu(x, kw["residual"], count, seg, segment=sp)
    if order != "relu_bn":
        return pc._CHAIN_NORMS[order](x, count, seg, segment=sp)
    spec = SpConvSpec("l", 1, x.shape[1], dense=not kw["mask"])
    return pc._relu_bn(add_bias(x, kw["bias"], spec, count), count, seg,
                       segment=sp)


def chain_segsum_calls(calls) -> list:
    """The segment-sum launches the chain would make for the recorded
    fused epilogue launches (``concat([z, z²])`` over the same segments),
    in ``segment_sum_cuda``'s arguments: what an inference forward
    launched before the fused epilogue."""
    import torch
    from repro_torch.core.spconv import SpConvSpec, add_bias
    out = []
    for a, kw in calls:
        x, count, seg = a
        spec = SpConvSpec("l", 1, x.shape[1], dense=not kw["mask"])
        z = torch.relu(add_bias(x, kw["bias"], spec, count))
        if seg is None:
            cap = x.shape[0]
            sid = torch.where(torch.arange(cap, device=x.device) < count, 0,
                              1).to(torch.int32)
            seg = (sid, torch.zeros(1, dtype=torch.int32, device=x.device),
                   count.to(torch.int32).reshape(1), 1)
        sid, starts, counts, S = seg
        out.append(((torch.cat([z, z * z], dim=1), sid, starts, counts),
                    dict(num_segments=S, q=kw["q"])))
    return out


def check_relu_bn(calls, label: str) -> dict:
    """Fused epilogue launches: bitwise equal to the chain they replace
    (``relu_bn_chain``), both timed on the device with the host's enqueue
    hidden (``queued_ms``: a launch's kernels take less device time than
    its wrapper's host code), the wrapper also as called (``wrapper_ms``);
    the bound counts each
    valid row read twice (the moments, then the apply), every row written
    once, a residual operand's every row read once, and the bias, counts
    and statistics once; the device time of the two kernels (``apply``:
    every order's apply kernel) and the statistics' torch ops over one
    launch of every call (``passes``)."""
    import torch
    from repro_torch.models import pointcloud as pc
    t_k = t_w = t_p = b_tot = bytes_tot = 0.0
    for i, (a, kw) in enumerate(calls):
        x, count, seg = a
        got = pc.relu_bn_cuda(*a, **kw)
        ref = relu_bn_chain(a, kw)
        if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
            raise RuntimeError(f"{label} launch {i}: not bitwise equal to "
                               "the chain")
        t_k += queued_ms(lambda: pc.relu_bn_cuda(*a, **kw), 5)
        t_w += cuda_ms(lambda: pc.relu_bn_cuda(*a, **kw), 5)
        t_p += queued_ms(lambda: relu_bn_chain(a, kw), 3)
        cap, C = x.shape
        rows = int(count)
        S = 1 if seg is None else seg[3]
        nb = (4 * C * (2 * rows + cap) + 4 * (0 if seg is None else cap)
              + 4 * C * (int(kw.get("bias") is not None) + 4 * S)
              + (0 if kw.get("residual") is None else 4 * cap * C))
        b_tot += bound_ms(nb, 0.0)[0]
        bytes_tot += nb

    def every_call():
        for a, kw in calls:
            pc.relu_bn_cuda(*a, **kw)
    every_call()
    _, by_name = profile_call(every_call)
    passes = {k: sum(v for n, v in by_name.items() if n.startswith(k))
              for k in ("chunk_offsets", "chunk_partials",
                        "combine_partials", *EPILOGUE_APPLY)}
    passes["stats"] = sum(by_name.values()) - sum(passes.values())
    passes["apply"] = sum(passes.pop(k) for k in EPILOGUE_APPLY)
    return dict(max_abs_err=0.0, ms=t_k, wrapper_ms=t_w, plain_ms=t_p,
                bound_ms=b_tot, bound_by="bytes", gbytes=bytes_tot / 1e9,
                passes=passes)


def log_relu_bn(label: str, r: dict, n: int, card: str) -> None:
    p = r.pop("passes")
    gbytes = r.pop("gbytes")
    log(f"[{label}] {n} launches bitwise equal to the chain of torch ops "
        f"they replace (relu_bn_chain); per "
        f"forward device {r['ms']:.3f} ms, through the wrapper "
        f"{r['wrapper_ms']:.3f} ms, chain {r['plain_ms']:.3f} ms, "
        f"bound {r['bound_ms']:.4f} ms ({gbytes:.3f} GB, "
        f"{gbytes / r['ms'] * 1e3:.0f} GB/s, {r['bound_ms'] / r['ms']:.1%} "
        f"of the bound's rate); one launch of each, device ms: "
        f"chunk offsets {p['chunk_offsets']:.3f}, moments partials "
        f"{p['chunk_partials']:.3f}, combine {p['combine_partials']:.3f}, "
        f"stats {p['stats']:.3f}, apply {p['apply']:.3f} | {card}")


def ws_bound(F, m, W, capacity) -> tuple:
    """(bound ms, bytes, operations) of one WS launch: F, m and W read
    once, the fp32 output written once; 2 * Cin * Cout per kept pair."""
    import torch
    cols = torch.clamp((m >= 0).sum(0), max=capacity)
    ops = 2.0 * float(cols.sum()) * F.shape[1] * W.shape[2]
    nb = (F.numel() * F.element_size() + 4 * m.numel()
          + W.numel() * W.element_size() + 4 * m.shape[0] * W.shape[2])
    return bound_ms(nb, ops)[0], nb, ops


def ws_map(m, cols):
    """The map columns a WS launch reads: ``m``, or ``m[:, cols]``."""
    return m if cols is None else m[:, cols.long()]


def check_ws(calls, names, label: str = "3 cp ws") -> dict:
    """WS launches: fp32 within ``1e-5 * max(1, max|ref|)`` of the plain
    version, and every fp32 launch against the same function in float64
    (the OS gather-GEMM over the kept map): the kernel's max|error| within
    ``max(4 * the plain version's, 1e-6 * max|ref|)``, one line per launch.
    Also the device time of each of the kernel's passes (pack, rank, sweep)
    over one launch of every call (``passes``), and the largest launch's
    peak memory beside the pair tables the first port allocated there
    (``peak``)."""
    import torch
    from repro_torch.core.dataflow import ws_kept_map
    from repro_torch.kernels.ws_scatter_gemm import (ws_scatter_gemm,
                                                     ws_scatter_gemm_torch)
    err = t_k = t_p = b_tot = ops_tot = bytes_tot = f64_worst = 0.0
    for i, (a, kw) in enumerate(calls):
        F, m, W = a
        cap, cols = kw["capacity"], kw.get("cols")
        got = ws_scatter_gemm(F, m, W, **kw)
        ref = ws_scatter_gemm_torch(F, m, W, capacity=cap, cols=cols)
        d = float((got - ref).abs().max())
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
        msub = ws_map(m, cols)
        if not d <= tol:
            raise RuntimeError(f"WS launch {i} ({F.shape[1]}->{W.shape[2]}, "
                               f"Ks={msub.shape[1]}): max|diff| {d} > {tol}")
        if F.dtype == torch.float32:
            ref64 = os_f64(F, ws_kept_map(msub, cap), W)
            e_k = float((got.double() - ref64).abs().max())
            e_p = float((ref.double() - ref64).abs().max())
            scale = float(ref64.abs().max())
            gate = max(4.0 * e_p, 1e-6 * scale)
            if not e_k <= gate:
                raise RuntimeError(f"WS launch {i} ({names[i]}) against "
                                   f"float64: kernel max|err| {e_k} > max(4 "
                                   f"* plain {e_p}, 1e-6 * {scale})")
            f64_worst = max(f64_worst, e_k / gate)
            log(f"[{label} f64 {i} {names[i]}] vs float64: kernel max|err| "
                f"{e_k:.3e}, plain {e_p:.3e}, max|ref| {scale:.3e}, gate "
                f"{gate:.3e}")
            del ref64
        err = max(err, d)
        t_k += cuda_ms(lambda: ws_scatter_gemm(F, m, W, **kw), 3)
        t_p += cuda_ms(lambda: ws_scatter_gemm_torch(F, m, W, capacity=cap,
                                                     cols=cols), 2)
        b, nb, ops = ws_bound(F, msub, W, cap)
        b_tot += b
        ops_tot += ops
        bytes_tot += nb

    def every_call():
        for a, kw in calls:
            ws_scatter_gemm(*a, **kw)
    every_call()
    _, by_name = profile_call(every_call)
    passes = {p: sum(v for k, v in by_name.items() if k.startswith(p))
              for p in ("ws_pack_kernel", "ws_rank_kernel",
                        "ws_sweep_kernel")}
    # peak memory of the largest launch, above what was allocated before it
    (F, m, W), kw = max(calls, key=lambda c: ws_map(
        c[0][1], c[1].get("cols")).numel() * c[0][2].shape[-1])
    msub = ws_map(m, kw.get("cols"))
    pairs = int(torch.clamp((msub >= 0).sum(0), max=kw["capacity"]).sum())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = ws_scatter_gemm(F, m, W, **kw)
    torch.cuda.synchronize()
    peak = dict(bytes=torch.cuda.max_memory_allocated() - base,
                out=out.numel() * 4, M=msub.shape[0], Ks=msub.shape[1],
                old=4 * msub.numel() + 4 * pairs * W.shape[-1])
    del out
    return dict(max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=b_tot,
                bound_by=bound_ms(bytes_tot, ops_tot)[1], library_ms=None,
                gflop=ops_tot / 1e9, f64_worst=f64_worst, passes=passes,
                peak=peak)


def dw_f64(F, m, g):
    """The per-offset weight gradient in float64 on the card, over each
    offset's valid rows: the yardstick of the fp32 kernel's and plain
    version's rounding."""
    import torch
    out = torch.empty((m.shape[1], F.shape[1], g.shape[1]),
                      dtype=torch.float64, device=F.device)
    for k in range(m.shape[1]):
        rows = torch.nonzero(m[:, k] >= 0)[:, 0]
        out[k] = (F[m[rows, k].long()].double().t()
                  @ g[rows].double())
    return out


def dw_library_ms(F, m, g) -> float:
    """The library yardstick of one dW launch: one fp32 ``torch.matmul``
    (TF32 off) of the pre-gathered, masked ``[Kd, Cin, M]`` tensor with g,
    timed; its result is dropped."""
    import torch
    M, Kd = m.shape
    G = torch.empty((Kd, F.shape[1], M), dtype=F.dtype, device=F.device)
    for k in range(Kd):
        col = m[:, k]
        G[k] = (F[col.clamp(min=0).long()]
                * (col >= 0)[:, None].to(F.dtype)).t()
    ms = cuda_ms(lambda: torch.matmul(G, g), 2)
    del G
    torch.cuda.empty_cache()
    return ms


def dw_packed_ops(m, cin: int, cout: int, dtype) -> float:
    """Operations the dW kernel multiplies: per (offset, panel) its packed
    valid rows rounded up to the mma depth (8 fp32, 16 bf16), times the
    Cin x Cout tiles the layer is cut into (one fp32 product counts once,
    not 3xTF32's three)."""
    import torch
    from repro_torch.kernels.dw_gather_gemm import _tile_for, panel_counts
    depth = 8 if dtype == torch.float32 else 16
    rows = int(((panel_counts(m) + depth - 1) // depth).sum()) * depth
    mi, ni = _tile_for(cin, cout, dtype)
    pad_i = -(-cin // (32 * mi)) * 32 * mi
    pad_j = -(-cout // (32 * ni)) * 32 * ni
    return 2.0 * rows * pad_i * pad_j


def check_dw(calls, label: str = "6 dW") -> dict:
    """dW launches: within ``1e-4 * max|ref|`` of the plain version
    (``chunked_rowdot`` with the same panel: the library matmul in its own
    blocking over up to 262,144 rows), and every fp32 launch against the
    same contraction in float64: the kernel's max|error| (3xTF32) within
    ``max(4 * the plain version's, 1e-6 * max|ref|)``, one line per launch.
    Each timed beside its plain version and the library yardstick; the
    device time of each of the kernel's three passes over one launch of
    every call (``passes``)."""
    import torch
    from repro_torch.kernels.dw_gather_gemm import (dw_gather_gemm,
                                                    dw_gather_gemm_torch)
    err = rel_err = t_k = t_p = t_l = b_tot = ops_tot = bytes_tot = 0.0
    packed_tot = f64_worst = 0.0
    for i, (a, kw) in enumerate(calls):
        F, m, g = a
        got = dw_gather_gemm(F, m, g)
        ref = dw_gather_gemm_torch(F, m, g)
        d = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        what = f"{F.shape[1]}x{g.shape[1]} Kd={m.shape[1]}"
        if not d <= 1e-4 * scale:
            raise RuntimeError(f"dW launch {i} ({what}): max|diff| {d} > "
                               f"1e-4 * {scale}")
        ms = cuda_ms(lambda: dw_gather_gemm(F, m, g), 5)
        t_k += ms
        if F.dtype == torch.float32:
            ref64 = dw_f64(F, m, g)
            e_k = float((got.double() - ref64).abs().max())
            e_p = float((ref.double() - ref64).abs().max())
            s64 = float(ref64.abs().max())
            gate = max(4.0 * e_p, 1e-6 * s64)
            if not e_k <= gate:
                raise RuntimeError(f"dW launch {i} ({what}) against float64: "
                                   f"kernel max|err| {e_k} > max(4 * plain "
                                   f"{e_p}, 1e-6 * {s64})")
            f64_worst = max(f64_worst, e_k / gate)
            log(f"[{label} f64 {i} {what}] vs float64: kernel max|err| "
                f"{e_k:.3e}, plain {e_p:.3e}, max|ref| {s64:.3e}, gate "
                f"{gate:.3e}; kernel {ms:.4f} ms")
            del ref64
        err, rel_err = max(err, d), max(rel_err, d / max(scale, 1e-30))
        t_p += cuda_ms(lambda: dw_gather_gemm_torch(F, m, g), 1)
        t_l += dw_library_ms(F, m, g)
        nnz = int((m >= 0).sum())
        ops = 2.0 * nnz * F.shape[1] * g.shape[1]
        nb = (F.numel() * F.element_size() + 4 * m.numel()
              + g.numel() * g.element_size() + 4 * got.numel())
        b_tot += bound_ms(nb, ops)[0]
        ops_tot += ops
        bytes_tot += nb
        packed_tot += dw_packed_ops(m, F.shape[1], g.shape[1], F.dtype)

    def every_call():
        for a, _ in calls:
            dw_gather_gemm(*a)
    every_call()
    _, by_name = profile_call(every_call)
    passes = {p: sum(v for k, v in by_name.items() if k.startswith(p))
              for p in ("dw_pack_kernel", "dw_mma_kernel",
                        "dw_combine_kernel")}
    return dict(max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=b_tot,
                bound_by=bound_ms(bytes_tot, ops_tot)[1], library_ms=t_l,
                rel_err=rel_err, gflop=ops_tot / 1e9,
                packed_gflop=packed_tot / 1e9, f64_worst=f64_worst,
                passes=passes)


def check_mgg(calls, names) -> dict:
    """The unfused OS entry point (``ops.output_stationary_fused``: a torch
    gather into ``[M, Kd, Cin]``, then the masked grouped GEMM kernel) on
    every layer's forward operands, one layer at a time. Its launches are
    this path's; the kernel is then held against its plain version and the
    implicit-GEMM kernel within ``1e-5 * max(1, max|ref|)``, every fp32
    launch against the same contraction in float64 (the kernel's
    max|error| within ``max(4 * the plain version's, 1e-6 * max|ref|)``,
    one line per launch), and timed beside them and one ``torch.einsum``
    over the pre-masked gathered tensor (the library yardstick; it leaves
    out the mask multiply)."""
    import torch
    from repro_torch.kernels import launch_counts, ops
    from repro_torch.kernels.masked_group_gemm import (
        masked_group_gemm, masked_group_gemm_torch)
    err = t_k = t_p = t_l = b_tot = ops_tot = bytes_tot = dense = 0.0
    f64_worst = 0.0
    launches = 0
    for i, (name, (a, kw)) in enumerate(zip(names, calls)):
        F, m, W = a
        before = launch_counts()["masked_group_gemm"]
        got = ops.output_stationary_fused(F, m, W)
        launches += launch_counts()["masked_group_gemm"] - before
        gathered = F[m.clamp(min=0).long()]
        ref = masked_group_gemm_torch(m, gathered, W)
        os_out = ops.spconv_os_fused(F, m, W)
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
        d = float((got - ref).abs().max())
        d_os = float((got - os_out).abs().max())
        if not (d <= tol and d_os <= tol):
            raise RuntimeError(f"masked_group_gemm {name}: max|diff| {d} "
                               f"(plain), {d_os} (OS kernel) > {tol}")
        if F.dtype == torch.float32:
            ref64 = os_f64(F, m, W)
            e_k = float((got.double() - ref64).abs().max())
            e_p = float((ref.double() - ref64).abs().max())
            scale = float(ref64.abs().max())
            gate = max(4.0 * e_p, 1e-6 * scale)
            if not e_k <= gate:
                raise RuntimeError(f"masked_group_gemm {name} against "
                                   f"float64: kernel max|err| {e_k} > max(4 "
                                   f"* plain {e_p}, 1e-6 * {scale})")
            f64_worst = max(f64_worst, e_k / gate)
            del ref64
        err = max(err, d)
        del ref, os_out
        ms = cuda_ms(lambda: masked_group_gemm(m, gathered, W), 2)
        t_k += ms
        t_p += cuda_ms(lambda: masked_group_gemm_torch(m, gathered, W), 1)
        pre = gathered * (m >= 0)[..., None].to(gathered.dtype)
        t_l += cuda_ms(lambda: torch.einsum("mkc,kcd->md", pre, W), 2)
        del pre, gathered
        torch.cuda.empty_cache()
        nnz = int((m >= 0).sum())
        ops_ = 2.0 * nnz * F.shape[1] * W.shape[2]
        nb = 4 * (m.numel() * F.shape[1] + W.numel() + m.numel()
                  + m.shape[0] * W.shape[2])
        b_tot += bound_ms(nb, ops_)[0]
        ops_tot += ops_
        bytes_tot += nb
        dense += 2.0 * m.numel() * F.shape[1] * W.shape[2]
        if F.dtype == torch.float32:
            log(f"[6 mgg f64 {i} {name}] vs float64: kernel max|err| "
                f"{e_k:.3e}, plain {e_p:.3e}, max|ref| {scale:.3e}, gate "
                f"{gate:.3e}; kernel {ms:.4f} ms, {nb / ms / 1e6:.0f} GB/s "
                f"over the bound's bytes")
    return dict(max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=b_tot,
                bound_by=bound_ms(bytes_tot, ops_tot)[1], library_ms=t_l,
                launches=launches, gflop=ops_tot / 1e9,
                dense_gflop=dense / 1e9, gbytes=bytes_tot / 1e9,
                f64_worst=f64_worst)


def rel_l2(a: dict, b: dict) -> float:
    """‖a − b‖₂ / ‖b‖₂ over all tensors of two gradient dictionaries."""
    num = sum(float(((a[k] - b[k]).double() ** 2).sum()) for k in b)
    den = sum(float((b[k].double() ** 2).sum()) for k in b)
    return (num / den) ** 0.5


def worst_tensor(a: dict, b: dict) -> tuple:
    """The tensor whose max|a − b| is largest against its own max|b|."""
    errs = {k: float((a[k] - b[k]).abs().max())
            / max(float(b[k].abs().max()), 1e-30) for k in b}
    k = max(errs, key=errs.get)
    return k, errs[k]


def step_grads(net, layout, engine, seg_backend, model, packed, feats,
               labels) -> dict:
    """One plan → forward → loss → backward, no update: the parameter
    gradients by name."""
    import torch
    from repro_torch.kernels.segsum import SegmentSpec
    from repro_torch.train.pointcloud import make_segmentation_loss_fn
    fn = make_segmentation_loss_fn(net, layout, engine=engine,
                                   segment=SegmentSpec(backend=seg_backend))
    named = dict(model.named_parameters())
    with torch.enable_grad():
        loss, _ = fn(model, packed, feats, labels)
        grads = torch.autograd.grad(loss, list(named.values()))
    return dict(zip(named, grads))


def perturbed(model, net, rel: float, seed: int):
    """A copy of ``model`` with every weight scaled by (1 + rel·N(0, 1))."""
    import torch
    from repro_torch.models import pointcloud as pc
    out = pc.init_pointcloud(net, device=next(model.parameters()).device)
    g = torch.Generator(device="cpu").manual_seed(seed)
    for p, q in zip(out.parameters(), model.parameters()):
        p.data.copy_(q * (1 + rel * torch.randn(q.shape, generator=g)
                          .to(q.device)))
    return out


def grads_vs_plain(label, net, net_plain, layout, model, packed, feats,
                   labels, card) -> dict:
    """Phase 6c/6d's gradient gate: one step's parameter gradients through
    the kernels against the plain path (engine "zdelta", every backend
    "torch") on the card. Deep BN nets at random init have ill-conditioned
    gradients, so the gate is calibrated: the kernel path must be no
    farther from the plain path (relative L2 over all parameters) than the
    kernel path is from itself when the weights move by 1e-6 relative
    (and 1e-3 at least). The worst tensor's max|diff| / max|grad| is
    printed beside it."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    gk = step_grads(net, layout, "zdelta_cuda", "auto", model, packed,
                    feats, labels)
    torch.cuda.empty_cache()
    reset_launch_counts()
    gp = step_grads(net_plain, layout, "zdelta", "torch", model, packed,
                    feats, labels)
    if any(launch_counts().values()):
        raise RuntimeError(f"{label}: plain path launched kernels: "
                           f"{launch_counts()}")
    torch.cuda.empty_cache()
    gs = step_grads(net, layout, "zdelta_cuda", "auto",
                    perturbed(model, net, 1e-6, 0), packed, feats, labels)
    torch.cuda.empty_cache()
    d_plain, d_self = rel_l2(gk, gp), rel_l2(gs, gk)
    k, worst = worst_tensor(gk, gp)
    ks, worst_s = worst_tensor(gs, gk)
    if not all(bool(torch.isfinite(g).all()) for g in gk.values()):
        raise RuntimeError(f"{label}: non-finite gradients")
    if not d_plain <= max(1e-3, d_self):
        raise RuntimeError(f"{label}: kernel vs plain gradients {d_plain:.3e}"
                           f" relative L2 > max(1e-3, self-sensitivity "
                           f"{d_self:.3e})")
    log(f"[{label}] gradients kernel vs plain path: relative L2 "
        f"{d_plain:.3e} <= max(1e-3, {d_self:.3e} = the kernel path vs "
        f"itself at weights moved 1e-6); worst tensor {k} max|diff|/max|g| "
        f"{worst:.2e} (self: {ks} {worst_s:.2e}) | {card}")
    return gk


def train_drive(trainer, st, lab, steps: int, expected: dict,
                label: str) -> tuple:
    """The training main path: ``steps`` trainer steps with the launch and
    search counters set to 0 just before and read just after. Checks
    finite metrics and, per step, every kernel's launches and the plan's
    searches. Returns per-step ms, metrics and the whole run's launches."""
    import torch
    from repro_torch.core.zdelta import reset_search_calls, search_call_count
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    reset_search_calls()
    times, metrics = [], []
    for i in range(steps):
        before = launch_counts()
        s0 = search_call_count()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.step(st, lab)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        after = launch_counts()
        grew = {k: after[k] - before[k] for k in after}
        if grew != expected:
            raise RuntimeError(f"{label} step {i}: launches {grew}, "
                               f"expected {expected}")
        searches = search_call_count() - s0
        if searches != expected["zdelta_superwindow_search"]:
            raise RuntimeError(f"{label} step {i}: {searches} kernel-map "
                               "searches, expected one plan's")
        if not all(np.isfinite(v) for v in m.values()):
            raise RuntimeError(f"{label} step {i}: non-finite metrics {m}")
        metrics.append(m)
    return times, metrics, launch_counts()


# -- phase 9: the self-healing trainer and its checkpoints --------------------

def event_ms(fn) -> tuple:
    """``fn()`` between two CUDA events: its ms on the card's timeline
    (the trainer's step ends in a host read, so the events bracket all of
    it) and its result."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


class AttemptCheck:
    """Wraps a guarded trainer's step function: every attempt (a full
    batch or a bisection sub-batch) must launch each kernel exactly as a
    plain training step does and run one inference plan's searches. The
    launch counters are host counts taken at enqueue, so this adds no
    sync. ``totals`` sums each kernel's launches over the attempts alone:
    the guarded path's run, whatever else launches in between."""

    def __init__(self, expected: dict, label: str):
        self.expected = expected
        self.label = label
        self.attempts = 0
        self.totals = {k: 0 for k in expected}

    def wrap(self, trainer) -> None:
        inner = trainer._step

        def step(*args):
            from repro_torch.core.zdelta import search_call_count
            from repro_torch.kernels import launch_counts
            before, s0 = launch_counts(), search_call_count()
            out = inner(*args)
            after = launch_counts()
            grew = {k: after[k] - before[k] for k in after}
            if grew != self.expected:
                raise RuntimeError(f"{self.label} attempt {self.attempts}: "
                                   f"launches {grew}, expected "
                                   f"{self.expected}")
            searches = search_call_count() - s0
            if searches != self.expected["zdelta_superwindow_search"]:
                raise RuntimeError(f"{self.label} attempt {self.attempts}: "
                                   f"{searches} kernel-map searches")
            self.attempts += 1
            for k, v in grew.items():
                self.totals[k] += v
            return out

        trainer._step = step


def train_state(session, trainer) -> dict:
    """A trainer's state by name: parameters, moments and the step."""
    out = {f"p:{k}": p for k, p in session.params.named_parameters()}
    out.update({f"mu:{k}": t for k, t in trainer.opt_state.mu.items()})
    out.update({f"nu:{k}": t for k, t in trainer.opt_state.nu.items()})
    out["step"] = trainer.opt_state.step
    return out


def snapshot_state(session, trainer) -> dict:
    return {k: v.clone() if hasattr(v, "clone") else v
            for k, v in train_state(session, trainer).items()}


def same_state(a: dict, b: dict, what: str) -> None:
    """Raise unless two states are bitwise equal (step included)."""
    import torch
    if a["step"] != b["step"]:
        raise RuntimeError(f"{what}: step {a['step']} != {b['step']}")
    diff = [k for k in a if k != "step" and not torch.equal(a[k], b[k])]
    if diff:
        raise RuntimeError(f"{what}: {len(diff)} tensors differ, first "
                           f"{diff[:3]}")


def all_finite(state: dict, what: str) -> None:
    import torch
    bad = [k for k, v in state.items() if k != "step"
           and not bool(torch.isfinite(v).all())]
    if bad:
        raise RuntimeError(f"{what}: non-finite values in {bad[:3]}")


def guard_phases(tnet, plain_tnet, lbatch, tst, tlab, expected: dict,
                 paths: dict, card: str) -> None:
    """Phases 9a-9c (module doc): the guarded trainer at full width on
    phase 6b's scenes and labels, checkpoints in a temporary directory."""
    import os
    import tempfile
    import torch
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.core.zdelta import reset_search_calls
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.serve import compile_network
    from repro_torch.train import (GuardConfig, GuardedPointCloudTrainer,
                                   TrainAbortError, checkpoint_trees,
                                   labeled_batch)
    from repro_torch.train import faults as tf
    layout = lbatch[0].layout
    n_l = len(tnet.specs)
    check = AttemptCheck(expected, "9 guarded")

    # -- 9a. guarded against plain, clean batches --------------------------
    reset_launch_counts()
    reset_search_calls()
    sg = compile_network(tnet, layout, batch=2, seed=0, cuda_graphs=False)
    n_params = sum(p.numel() for p in sg.params.parameters())
    log(f"[9 memory] {n_params:,} parameters: a staged guarded update "
        f"holds {3 * n_params * 4 / 2**20:.1f} MiB beside them (new "
        "parameters and both moments)")
    sp = compile_network(tnet, layout, batch=2, seed=0, cuda_graphs=False)
    guard = GuardConfig(spike_window=6, spike_factor=1.8, spike_min_history=4)
    tg = sg.compile_train(guard=guard)
    if not isinstance(tg, GuardedPointCloudTrainer):
        raise RuntimeError("9a: compile_train(guard=...) is not guarded")
    tp = sp.compile_train()
    check.wrap(tg)
    same_state(train_state(sg, tg), train_state(sp, tp), "9a start")
    # one warm step each (the first guarded step also grows the allocator
    # by the staged update's buffers), then GUARD_PAIRS timed pairs; the
    # order within a pair alternates
    ms_g, ms_p, losses = [], [], []
    trainers = {"guarded": tg, "plain": tp}
    for i in range(1 + GUARD_PAIRS):
        order = ("guarded", "plain") if i % 2 == 0 else ("plain", "guarded")
        out = {k: event_ms(lambda: trainers[k].step(tst, tlab))
               for k in order}
        (tg_ms, m), (tp_ms, mp) = out["guarded"], out["plain"]
        if not (tg.last_report.ok and m["step_ok"] == 1.0
                and m["loss"] == mp["loss"]):
            raise RuntimeError(f"9a step {i}: {tg.last_report.summary()}, "
                               f"loss {m['loss']} vs plain {mp['loss']}")
        same_state(train_state(sg, tg), train_state(sp, tp), f"9a step {i}")
        losses.append(m["loss"])
        if i:
            ms_g.append(tg_ms)
            ms_p.append(tp_ms)
    diff = np.array(ms_g) - np.array(ms_p)
    q25, q50, q75 = (float(v) for v in np.percentile(diff, [25, 50, 75]))
    verdict = ("resolved" if q25 > 0 or q75 < 0 else
               "unresolved: the quartiles straddle 0")
    log(f"[9a guarded] {tnet.name} full width, batch 2: {1 + GUARD_PAIRS} "
        f"clean steps, params, moments and step bitwise equal to the plain "
        f"trainer's after every step; losses "
        f"{', '.join(f'{v:.4f}' for v in losses)}; ms per step (CUDA events,"
        f" after one warm step each, {GUARD_PAIRS} pairs in alternating "
        f"order) guarded {', '.join(f'{v:.1f}' for v in ms_g)}, plain "
        f"{', '.join(f'{v:.1f}' for v in ms_p)}; medians guarded "
        f"{float(np.median(ms_g)):.1f} (range {min(ms_g):.1f}-"
        f"{max(ms_g):.1f}), plain {float(np.median(ms_p)):.1f} (range "
        f"{min(ms_p):.1f}-{max(ms_p):.1f}); guarded minus plain per pair: "
        f"median {q50:.1f} ms, quartiles {q25:.1f} / {q75:.1f} ({verdict})"
        f" | {card}")

    # -- 9b. poison: bisection, quarantine, the spike skip -----------------
    single = labeled_batch([lbatch[0]], sg.layout)
    # a bisected commit runs the training kernels on scene 0 alone at its
    # own bucket: hold that shape's gradients against the plain path first
    cap = sg._bucket(single[0].capacity)
    sst = single[0].pad_to(cap)
    slab = torch.cat([single[1], torch.full(
        (cap - single[1].shape[0],), -1, dtype=torch.int32,
        device=single[1].device)])
    grads_vs_plain(f"9b grads scene 0 at bucket {cap}", tnet, plain_tnet,
                   sg.layout, sg.params, sst.packed, sst.features, slab,
                   card)
    del sst, slab
    torch.cuda.empty_cache()
    bis_ms = []
    for value in (float("nan"), float("inf"), float("-inf")):
        x = tf.poison_scene_nonfinite(tst, 1, value=value)
        t, m = event_ms(lambda: tg.step(x, tlab))
        bis_ms.append(t)
        r = tg.last_report
        if not (m["step_ok"] == 0.0 and r.action == "bisected"
                and r.nonfinite and r.committed == [[0]]
                and r.quarantined == [1]):
            raise RuntimeError(f"9b {value}: step_ok {m['step_ok']}, "
                               f"{r.summary()}")
        tp.step(*single)
        same_state(train_state(sg, tg), train_state(sp, tp),
                   f"9b {value} (bisected commit vs the plain trainer on "
                   "scene 0 alone)")
        all_finite(train_state(sg, tg), f"9b {value}")
        log(f"[9b poison] scene 1 feature = {value}: full batch step_ok 0, "
            f"{r.summary()}; state bitwise equal to the plain trainer "
            f"stepped on scene 0 alone; no non-finite parameter or moment; "
            f"bisected step {t:.1f} ms | {card}")
    # the spike needs a trained baseline (at random init every label costs
    # about ln 20, a poisoned one too; the reference's spike test trains
    # 15 steps first): clean steps in lockstep first
    for i in range(SPIKE_WARM_STEPS):
        m = tg.step(tst, tlab)
        tp.step(tst, tlab)
        same_state(train_state(sg, tg), train_state(sp, tp),
                   f"9b clean step {i}")
        losses.append(m["loss"])
    ring = list(tg._spikes.ring)
    labeled = int(tst.count)
    bad_lab = tf.poison_labels(tlab, rows=range(labeled))
    before = snapshot_state(sg, tg)
    m = tg.step(tst, bad_lab)
    r = tg.last_report
    if not (r.spike and not r.nonfinite and m["step_ok"] == 1.0
            and r.committed == []):
        raise RuntimeError(f"9b label poison: {r.summary()} (median of "
                           f"{len(ring)} committed losses "
                           f"{float(np.median(ring)):.4f}, factor "
                           f"{guard.spike_factor})")
    same_state(train_state(sg, tg), before, "9b label poison")
    log(f"[9b spike] {SPIKE_WARM_STEPS} more clean steps in lockstep "
        f"(bitwise; full-batch losses so far "
        f"{', '.join(f'{v:.4f}' for v in losses)}), then all {labeled} "
        f"labeled rows set to 10**6 (clipped to class {tnet.n_classes - 1}):"
        f" loss "
        f"{m['loss']:.4f} against {guard.spike_factor} x the median "
        f"{float(np.median(ring)):.4f} of the last committed losses: "
        f"{r.summary()}; state unchanged bitwise")
    log(f"[9b counters] {tg.counters}; bisected step ms "
        f"{', '.join(f'{v:.1f}' for v in bis_ms)} (median "
        f"{float(np.median(bis_ms)):.1f}) against the guarded clean step's "
        f"{float(np.median(ms_g)):.1f} | {card}")
    del sg, sp, tg, tp, single, before
    torch.cuda.empty_cache()

    # -- 9c. checkpoints: cadence, kill and resume, corruption, rollback ---
    with tempfile.TemporaryDirectory() as d:
        sc = compile_network(tnet, layout, batch=2, seed=0, cuda_graphs=False)
        mgr = CheckpointManager(d, keep=3, async_save=True,
                                metrics=sc.metrics)
        tc = sc.compile_train(guard=GuardConfig(ckpt_every=2), ckpt=mgr)
        check.wrap(tc)
        blocked = []
        save = mgr.save

        def timed_save(*a, **k):
            t0 = time.perf_counter()
            save(*a, **k)
            blocked.append((time.perf_counter() - t0) * 1e3)

        mgr.save = timed_save
        for _ in range(6):
            tc.step(tst, tlab)
        mgr.wait()
        snap6 = snapshot_state(sc, tc)
        if mgr.complete_steps() != [2, 4, 6] or mgr.last_good_step() != 4:
            raise RuntimeError(f"9c cadence: checkpoints "
                               f"{mgr.complete_steps()}, last_good "
                               f"{mgr.last_good_step()}")
        h = sc.metrics.snapshot()["histograms"]
        nbytes = os.path.getsize(os.path.join(d, "ckpt_00000006.npz"))
        log(f"[9c save] ckpt_every 2, keep 3, async: saves at steps 2, 4, "
            f"6 (last_good 4); {nbytes / 2**20:.1f} MiB per checkpoint; "
            f"ms a save blocks the step {', '.join(f'{v:.1f}' for v in blocked)}"
            f" (the D2H snapshot {h['ckpt/snapshot']['sum'] / h['ckpt/snapshot']['count'] * 1e3:.1f}"
            f" ms mean); the writer (CRC32 + npz + manifest) "
            f"{h['ckpt/save']['sum'] / h['ckpt/save']['count'] * 1e3:.1f} "
            f"ms mean over {h['ckpt/save']['count']} writes | {card}")

        # kill at step 6 and resume in a fresh session
        sr = compile_network(tnet, layout, batch=2, seed=0, cuda_graphs=False)
        tr = sr.compile_train(guard=True, ckpt=d)
        t0 = time.perf_counter()
        restored = tr.resume()
        restore_ms = (time.perf_counter() - t0) * 1e3
        if restored != 6:
            raise RuntimeError(f"9c resume restored step {restored}")
        same_state(train_state(sr, tr), snap6, "9c resume")
        check.wrap(tr)
        for _ in range(2):
            tr.step(tst, tlab)
        for _ in range(2):
            tc.step(tst, tlab)       # the uninterrupted run: steps 7, 8
        mgr.wait()
        same_state(train_state(sr, tr), train_state(sc, tc),
                   "9c kill and resume")
        log(f"[9c resume] a fresh session resumed step 6 in {restore_ms:.1f}"
            f" ms (verify + copy into its tensors), then 2 steps: params, "
            f"moments and step bitwise equal to the uninterrupted run's "
            f"step 8 | {card}")

        # a step with a write in flight against one without, in turns
        scratch = CheckpointManager(os.path.join(d, "contention"), keep=1,
                                    async_save=True, metrics=sr.metrics)
        busy, idle, overlap = [], [], []
        for flight in (True, False, False, True, True, False):
            if flight:
                scratch.save(tr.opt_state.step,
                             *checkpoint_trees(sr.params, tr.opt_state))
            t, _ = event_ms(lambda: tr.step(tst, tlab))
            if flight:
                overlap.append(scratch._thread is not None
                               and scratch._thread.is_alive())
                busy.append(t)
            else:
                idle.append(t)
            scratch.wait()
        log(f"[9c contention] step ms with a checkpoint write in flight "
            f"{', '.join(f'{v:.1f}' for v in busy)} (median "
            f"{float(np.median(busy)):.1f}; the write outlasted the step "
            f"{sum(overlap)} of 3 times), without "
            f"{', '.join(f'{v:.1f}' for v in idle)} (median "
            f"{float(np.median(idle)):.1f}) | {card}")

        # corrupt the newest checkpoint: resume walks back to step 6
        snap8 = mgr.latest_step()
        tf.corrupt_checkpoint(d, snap8, mode="flip")
        t3 = sr.compile_train(guard=True, ckpt=d, resume=True)
        if not (t3.opt_state.step == 6
                and t3.counters["checksum_failures"] == 1):
            raise RuntimeError(f"9c corrupt: resumed step "
                               f"{t3.opt_state.step}, {t3.counters}")
        same_state(train_state(sr, t3), snap6, "9c corrupt newest")
        log(f"[9c corrupt] ckpt_{snap8:08d}.npz byte-flipped: resume walked "
            f"back to step 6 (bitwise), checksum_failures 1")
        del t3, tr, sr, scratch
        torch.cuda.empty_cache()

        # rollback_after bad batches restore last_good; then the abort
        if mgr.last_good_step() != 6:
            raise RuntimeError(f"9c: last_good {mgr.last_good_step()}")
        starts, _ = tst.scene_segments()
        both = tf.poison_nonfinite(tst, rows=tuple(int(s) for s in starts))
        rollbacks = 0
        try:
            for i in range(3 * tc.guard.rollback_after):
                tc.step(both, tlab)
                r = tc.last_report
                if r.action == "rolled_back":
                    rollbacks += 1
                    if r.rollback_to != 6:
                        raise RuntimeError(f"9c rollback to {r.rollback_to}")
                    same_state(train_state(sc, tc), snap6,
                               f"9c rollback {rollbacks}")
        except TrainAbortError as e:
            abort = e
        else:
            raise RuntimeError("9c: no TrainAbortError after max_rollbacks")
        if rollbacks != tc.guard.max_rollbacks:
            raise RuntimeError(f"9c: {rollbacks} rollbacks before the abort")
        same_state(train_state(sc, tc), snap6, "9c after the abort")
        log(f"[9c rollback] both scenes NaN: every {tc.guard.rollback_after}"
            f" dead steps restored last_good (step 6) bitwise, "
            f"{rollbacks} times; then TrainAbortError ({abort}); counters "
            f"{abort.counters} | {card}")
        del sc, tc, mgr
    torch.cuda.empty_cache()
    totals = check.totals
    for k in ("zdelta_superwindow_search", "spconv_gather_gemm",
              "segment_sum", "dw_gather_gemm"):
        if not totals[k]:
            raise RuntimeError(f"9: {k} never launched")
        paths[k]["minkunet42 guarded train step"] = dict(
            launches=expected[k], attempts=check.attempts,
            run_total=totals[k])
    if any(totals[k] for k in totals if not expected[k]):
        raise RuntimeError(f"9: kernels off the path launched: {totals}")
    log(f"[9 launches] {check.attempts} guarded attempts (full batches and "
        f"bisection sub-batches), each with one plan's {n_l} searches and "
        f"the plain step's launches {({k: v for k, v in expected.items() if v})}; "
        f"the guarded attempts' total "
        f"{({k: v for k, v in totals.items() if v})}")


def per_forward(r: dict) -> dict:
    """The per-forward times of a check's result."""
    return {k: r[k] for k in ("ms", "wrapper_ms", "plain_ms", "bound_ms",
                              "library_ms") if k in r}


def drive(session, inputs, expected: dict, label: str, kind: str,
          card: str) -> tuple:
    """The main path: scene 0 alone, then the batch of 2, each twice, with
    the launch counters set to 0 just before and read just after. Checks
    finite logits, launches per call, batched scene 0 bitwise equal to the
    single run and one compiled key per bucket. Returns the batch-of-2
    output and health, the ms per call by input, and the launch counts."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    answers, times = {}, {}
    for name, st in inputs:
        for _ in range(2):
            before = launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, health = session.run_with_health(st)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            after = launch_counts()
            grew = {k: after[k] - before[k] for k in after}
            if grew != expected:
                raise RuntimeError(f"{label} {name}: launches per call "
                                   f"{grew}, expected {expected}")
            n = int(out.count)
            logits = out.features
            if tuple(logits.shape) != (health.bucket, session.net.n_classes):
                raise RuntimeError(f"{label} {name}: logits "
                                   f"{tuple(logits.shape)}")
            if not bool(torch.isfinite(logits[:n]).all()):
                raise RuntimeError(f"{label} {name}: non-finite logits")
            times.setdefault(name, []).append(dt * 1e3)
            answers[name] = (out, health)
    counts = launch_counts()
    (n1_name, _), (nb_name, _) = inputs
    out1, h1 = answers[n1_name]
    outb, hb = answers[nb_name]
    n1 = int(out1.count)
    b0 = outb.unbatch()[0]
    if int(b0.count) != n1 or not torch.equal(b0.packed[:n1],
                                              out1.packed[:n1]):
        raise RuntimeError(f"{label}: batched scene-0 coordinates differ "
                           "from single")
    if not torch.equal(b0.features[:n1], out1.features[:n1]):
        d = float((b0.features[:n1] - out1.features[:n1]).abs().max())
        raise RuntimeError(f"{label}: batched scene-0 logits not bitwise "
                           f"equal to the single-scene run (max|diff| {d})")
    if session.compile_count != 2:
        raise RuntimeError(f"{label}: compile_count {session.compile_count} "
                           "!= 2 distinct buckets")
    per_call = {k: v for k, v in expected.items() if v}
    log(f"[{label}] {session.net.name} full width, 4 requests: logits "
        f"finite, batched scene 0 == single bitwise ({n1} rows), "
        f"compile_count {session.compile_count} (buckets {h1.bucket}, "
        f"{hb.bucket}), launches {counts} ({per_call} per call)")
    log(f"[{label}] steady-state ms per call: scene0 "
        f"{times[n1_name][1]:.1f} (first {times[n1_name][0]:.1f}), {nb_name} "
        f"{times[nb_name][1]:.1f} (first {times[nb_name][0]:.1f}) | {kind} | "
        f"{card} | peak mem {torch.cuda.max_memory_allocated() / 2**30:.1f} "
        "GiB")
    log(f"[{label} overflow cells per layer] "
        + " ".join(f"{k}={v}" for k, v in hb.window_overflow_cells.items()))
    return outb, hb, times, counts


def profile_line(label: str, fn, steady: float, card: str,
                 what: str = "batch2") -> dict:
    """One call under the profiler: the device's busy and idle share of
    the unprofiled ``steady`` ms, and the top device entries by name;
    returns the device ms by name."""
    wall, dev_ms = profile_call(fn)
    busy = sum(dev_ms.values())
    if busy > 0:
        top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:8]
        log(f"[{label} profile] {what} under torch.profiler: wall "
            f"{wall:.1f} ms, device busy {busy:.1f} ms = {busy / steady:.1%} "
            f"of the unprofiled {steady:.1f} ms call (idle share "
            f"{1 - busy / steady:.1%}) | {card}")
        log(f"[{label} profile] device ms by kernel: "
            + "; ".join(f"{k} {v:.2f}" for k, v in top))
    else:
        log(f"[{label} profile] device time not measured: the profiler saw "
            "no device events")
    return dev_ms


def plain_path(session, net_plain, st, out_kernel, label: str) -> float:
    """The same session on the plain path (engine "zdelta", every backend
    "torch") on the card: maps equal, no kernel launched, logits within
    ``1e-3 * max|logits|``; returns the relative max difference."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import compile_network
    plain = compile_network(net_plain, session.layout, batch=2,
                            params=session.params, engine="zdelta",
                            segment_backend="torch", cuda_graphs=False)
    plan_k = session.plan(st)
    plan_p = plain.plan(st)
    for s in net_plain.specs:
        if not torch.equal(plan_k.kmaps[s.name].m, plan_p.kmaps[s.name].m):
            raise RuntimeError(f"{label}: kernel map of {s.name} differs "
                               "between the kernel engine and the torch "
                               "search")
    del plan_k, plan_p
    torch.cuda.empty_cache()
    reset_launch_counts()
    outp = plain(st)
    if any(launch_counts().values()):
        raise RuntimeError(f"{label}: plain path launched kernels: "
                           f"{launch_counts()}")
    nb = int(out_kernel.count)
    ref = outp.features[:nb]
    d = float((out_kernel.features[:nb] - ref).abs().max())
    scale = float(ref.abs().max())
    if not d <= 1e-3 * scale:
        raise RuntimeError(f"{label}: kernel path vs plain path: max|diff| "
                           f"{d} > 1e-3 * {scale}")
    log(f"[{label}] {len(net_plain.specs)} kernel maps equal; logits "
        f"max|diff| {d:.3e} vs 1e-3 * max|logits| = {1e-3 * scale:.3e} "
        f"({d / scale:.2e} relative); no kernel launched")
    return d / scale

def published_minkunet_phase(paths: dict, kind: str, card: str) -> None:
    """Phase 5m: the published MinkUNet (``pc.minkunet()``: cr = 1, 49
    bias-free layers, K = 2 strided and transposed, 1x1 shortcuts, the
    standardisation-first epilogues) at full width on the shapes of the
    benchmark cell ``minkunet42-outdoor-b4``: four outdoor sweeps of
    extent (1024, 1024, 40), overlap 0.5, in one call (bucket 524,288).
    Every launch of one eager batch-of-4 forward against its plain
    version: each superwindow search (the K = 2 ones also apart) with its
    map and counters equal; each OS launch as in 3 (the 1x1, K = 2 and
    transposed layers among them); each fused epilogue launch bitwise its
    chain, by norm order, with each order's device, wrapper and chain ms
    and its bound (the residual operand's bytes included). Then the main
    path (``drive``: scene 0 alone, then the batch of 4, each twice) with
    the launches per call of ``expected_launches`` and the fused epilogues
    by order of ``expected_epilogues``, none on the chain; the plan's maps
    by kind and every layer's map equal to the ``zdelta`` engine's; one
    profiled call with each epilogue kernel's device ms."""
    import torch
    from repro_torch.core import network_plan
    from repro_torch.core.sparse_tensor import SparseTensor
    from repro_torch.data import scenes
    from repro_torch.kernels.segsum import NORM_ORDERS
    from repro_torch.models import pointcloud as pc
    from repro_torch.serve import bucket_capacity, compile_network
    t0 = time.perf_counter()
    batch = scenes.scene_batch(seed=0, batch=PUB_SCENES, kind="outdoor",
                               extent=PUB_EXTENT, overlap=0.5)
    rng = np.random.default_rng(1)
    clouds = [(sc.coords, rng.normal(size=(len(sc.coords), 4))
               .astype(np.float32)) for sc in batch]
    sizes = [len(c) for c, _ in clouds]
    net = pc.minkunet()
    session = compile_network(net, batch[0].layout, batch=PUB_SCENES,
                              seed=0, cuda_graphs=False)
    st1 = SparseTensor.from_point_clouds(clouds[:1], session.layout)
    stb = SparseTensor.from_point_clouds(clouds, session.layout)
    log(f"[5m inputs] {PUB_SCENES} outdoor scenes {sizes} voxels, layout "
        f"{session.layout}, buckets {bucket_capacity(sizes[0])}/"
        f"{bucket_capacity(sum(sizes))}; {net.name}: {len(net.specs)} "
        f"layers ({sum(s.K == 1 for s in net.specs)} 1x1, "
        f"{sum(s.K == 2 and not s.transposed for s in net.specs)} K = 2 "
        f"strided, {sum(s.transposed for s in net.specs)} transposed), "
        f"made in {time.perf_counter() - t0:.1f} s")

    with Recorder(("zdelta_superwindow_search", "spconv_gather_gemm",
                   "relu_bn")) as rec:
        session(stb)
    torch.cuda.synchronize()

    # superwindow searches: maps and counters equal, the K = 2 ones apart
    z = rec.calls["zdelta_superwindow_search"]
    z2 = [c for c in z if c[1]["K"] == 2]
    if len(z2) != 4:
        raise RuntimeError(f"5m: {len(z2)} K = 2 searches, expected the 4 "
                           "stride-2 layers'")
    r = check_search(z2, "superwindow")
    log(f"[5m superwindow K=2] {len(z2)} launches (the stride-2 maps; the "
        f"transposed layers reuse them) equal to the plain version; per "
        f"forward device {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, "
        f"bound {r['bound_ms']:.5f} ms; {search_rates(r)} | {card}")
    paths.setdefault("zdelta_superwindow_search", {})[
        "minkunet (published) K = 2 (5m)"] = dict(launches=len(z2),
                                                  **per_forward(r))
    r = check_search(z, "superwindow")
    log(f"[5m superwindow] {len(z)} launches equal; per forward device "
        f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
        f"{r['bound_ms']:.4f} ms; {search_rates(r)} | {card}")
    paths["zdelta_superwindow_search"]["minkunet (published) (5m)"] = dict(
        launches=len(z), **per_forward(r))

    # OS: every launch as in 3, the 1x1, K = 2 and transposed layers among
    # them
    o = rec.calls["spconv_gather_gemm"]
    r = check_os(o, label="5m os", names=[s.name for s in net.specs])
    gflop = r.pop("gflop")
    log_os_groups("5m os", r, card)
    r.pop("groups"), r.pop("f64_worst")
    log(f"[5m os] {len(o)} launches within 1e-5*max(1,|ref|) and the "
        f"float64 gate (max|diff| {r['max_abs_err']:.3e}); per forward "
        f"kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
        f"{r['bound_ms']:.3f} ms ({gflop:.1f} GFLOP useful, "
        f"{gflop / r['ms']:.2f} TFLOP/s) | {card}")
    paths.setdefault("spconv_gather_gemm", {})[
        "minkunet (published) (5m)"] = dict(launches=len(o),
                                            **per_forward(r))

    # the fused epilogue: every launch bitwise its chain, by order
    by_order: dict = {}
    for a, kw in rec.calls["relu_bn"]:
        by_order.setdefault(kw.get("order", "relu_bn"), []).append((a, kw))
    want = expected_epilogues(net)
    got = {k: len(v) for k, v in by_order.items()}
    if got != {k: v for k, v in want.items() if k in NORM_ORDERS and v}:
        raise RuntimeError(f"5m: fused epilogue launches by order {got}, "
                           f"expected {want}")
    for order, calls in by_order.items():
        res = sum(kw.get("residual") is not None for _, kw in calls)
        label = f"5m {order}"
        r = check_relu_bn(calls, label)
        log_relu_bn(label, r, len(calls), card)
        log(f"[{label}] C {sorted({a[0].shape[1] for a, _ in calls})}, "
            f"rows {sorted({a[0].shape[0] for a, _ in calls})}, "
            f"{res} with a residual operand")
        paths.setdefault("relu_bn", {})[
            f"minkunet (published) {order} (5m)"] = dict(
                launches=len(calls), **per_forward(r))
    del rec, z, z2, o, by_order
    torch.cuda.empty_cache()

    # the main path: launches per call, fused epilogues by order
    pc.reset_epilogue_calls()
    outb, hb, times, counts = drive(session, (("scene0", st1),
                                              ("batch4", stb)),
                                    expected_launches(net.specs),
                                    "5m main path", kind, card)
    calls = 2 * 2
    if dict(pc.EPILOGUE_CALLS) != {k: calls * v for k, v in want.items()}:
        raise RuntimeError(f"5m main path: epilogues {pc.EPILOGUE_CALLS} "
                           f"over {calls} calls, expected {want} a call")
    log(f"[5m main path] fused epilogues a call {want}: none on the chain")

    # maps by kind, and every layer's map equal to the zdelta engine's
    network_plan.reset_plan_map_counts()
    plan_k = session.plan(stb)
    kinds = network_plan.plan_map_counts()
    if kinds != {"searched": 38, "transposed": 4, "identity": 7}:
        raise RuntimeError(f"5m: the plan's maps by kind {kinds}")
    plain = compile_network(net, session.layout, batch=PUB_SCENES,
                            params=session.params, engine="zdelta",
                            cuda_graphs=False)
    plan_z = plain.plan(stb)
    for s in net.specs:
        if not torch.equal(plan_k.kmaps[s.name].m, plan_z.kmaps[s.name].m):
            raise RuntimeError(f"5m: the map of {s.name} (K = {s.K}, "
                               f"transposed {s.transposed}) differs between "
                               "zdelta_cuda and zdelta")
    ovf = {k: int(v) for k, v in plan_k.stats.items() if int(v)}
    log(f"[5m maps] by kind {kinds}; all {len(net.specs)} equal to the "
        f"zdelta engine's (K = 2 strided, transposed and 1x1 among them); "
        f"overflowed cells {ovf or 0}")
    del plan_k, plan_z, plain
    torch.cuda.empty_cache()

    dev_ms = profile_line("5m", lambda: session(stb), times["batch4"][1],
                          card, what="batch4")
    parts = {k: sum(v for n, v in dev_ms.items() if n.startswith(k))
             for k in ("chunk_offsets", "chunk_partials", "combine_partials",
                       *EPILOGUE_APPLY)}
    log(f"[5m epilogue profile] device ms a batch-4 call: "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; total {sum(parts.values()):.3f} | {card}")
    del session, outb, hb, st1, stb
    torch.cuda.empty_cache()


def int64_phase(paths: dict, kind: str, card: str) -> None:
    """Phase 4e: MinkUNet-42 at full width on int64 packed words (a
    +-51.2 m range at 5 cm voxels: a 12/12/7 + 1 batch-bit layout is 32
    bits). Every superwindow launch of one batch-of-2 forward equal to its
    plain version; the main path (scene 0 alone, then the batch of 2, each
    twice) with batched scene 0 bitwise equal to the single run; one
    ``zdelta_cuda_window`` plan of the same coordinates, every launch equal
    to its plain version and every map equal to the superwindow engine's."""
    import torch
    from repro_torch.core.sparse_tensor import SparseTensor
    from repro_torch.data import scenes
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import pointcloud as pc
    from repro_torch.serve import bucket_capacity, compile_network
    t0 = time.perf_counter()
    batch = scenes.scene_batch(seed=0, batch=2, kind="outdoor",
                               extent=(2048, 2048, 64), overlap=0.5)
    rng = np.random.default_rng(1)
    clouds = [(sc.coords, rng.normal(size=(len(sc.coords), 4))
               .astype(np.float32)) for sc in batch]
    sizes = [len(c) for c, _ in clouds]
    net = pc.minkunet42(in_channels=4, n_classes=20)
    session = compile_network(net, batch[0].layout, batch=2, seed=0,
                              cuda_graphs=False)
    st1 = SparseTensor.from_point_clouds(clouds[:1], session.layout)
    st2 = SparseTensor.from_point_clouds(clouds, session.layout)
    if not (session.layout.dtype == st1.packed.dtype == st2.packed.dtype
            == torch.int64):
        raise RuntimeError(f"4e: layout {session.layout} packs "
                           f"{st2.packed.dtype} words, expected int64")
    log(f"[4e int64 inputs] 2 outdoor scenes of extent (2048, 2048, 64) "
        f"{sizes} voxels, layout {session.layout} "
        f"({session.layout.bits_total} bits: {st2.packed.dtype} words), "
        f"buckets {bucket_capacity(sizes[0])}/{bucket_capacity(sum(sizes))}, "
        f"made in {time.perf_counter() - t0:.1f} s")

    with Recorder(names=("zdelta_superwindow_search",)) as rec:
        session(st2)
    torch.cuda.synchronize()
    z = rec.calls["zdelta_superwindow_search"]
    if len(z) != len(net.specs) or any(a[0].dtype != torch.int64
                                       for a, _ in z):
        raise RuntimeError(f"4e: {len(z)} superwindow launches, expected "
                           f"{len(net.specs)} on int64 words")
    r = check_search(z, "superwindow")
    log(f"[4e int64 superwindow] {len(z)} launches of one batch-of-2 "
        f"forward (M={z[0][0][1].numel()}, int64 words): maps+counters "
        f"equal to the plain version; per forward device {r['ms']:.3f} ms, "
        f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms; "
        f"{search_rates(r)} | {card}")
    paths["zdelta_superwindow_search"]["minkunet42 int64 (4e)"] = dict(
        launches=len(z), **per_forward(r))
    del rec, z
    torch.cuda.empty_cache()

    expected = {k: 0 for k in launch_counts()}
    expected.update({"zdelta_superwindow_search": 42,
                     "zdelta_repair": 42,
                     "spconv_gather_gemm": 42, "relu_bn": 42})
    outb, hb, times, counts = drive(session, (("scene0", st1),
                                              ("batch2", st2)),
                                    expected, "4e int64", kind, card)
    paths["zdelta_superwindow_search"]["minkunet42 int64 (4e)"][
        "main_path_launches"] = counts["zdelta_superwindow_search"]
    del outb
    torch.cuda.empty_cache()

    win = compile_network(net, session.layout, batch=2,
                          params=session.params, engine="zdelta_cuda_window",
                          cuda_graphs=False)
    reset_launch_counts()
    plan_w = win.plan(st2)
    torch.cuda.synchronize()
    wcount = launch_counts()["zdelta_window_search"]
    if wcount != len(net.specs):
        raise RuntimeError(f"4e: {wcount} window launches, expected "
                           f"{len(net.specs)}")
    plan_s = session.plan(st2)
    for s in net.specs:
        if not torch.equal(plan_w.kmaps[s.name].m, plan_s.kmaps[s.name].m):
            raise RuntimeError(f"4e: window-engine map of {s.name} differs "
                               "from the superwindow engine's")
    log(f"[4e int64 window engine] {len(net.specs)} kernel maps equal to "
        f"the superwindow engine's; window launches {wcount}; repaired "
        "cells per layer: " + " ".join(f"{k}={int(v)}"
                                       for k, v in plan_w.stats.items()))
    del plan_w, plan_s
    torch.cuda.empty_cache()
    with Recorder(names=("zdelta_window_search", "zdelta_repair")) as rec:
        win.plan(st2)
    v_calls = rec.calls["zdelta_window_search"]
    r = check_search(v_calls, "window")
    log(f"[4e int64 window] {len(v_calls)} launches: maps+counters equal "
        f"to the plain version; per plan device {r['ms']:.3f} ms, plain "
        f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms; "
        f"{search_rates(r)} | {card}")
    paths["zdelta_window_search"]["minkunet42 int64 plan (4e)"] = dict(
        launches=wcount, **per_forward(r))
    r = check_repair(v_calls, rec.calls["zdelta_repair"], "window")
    flagged, gbytes = r.pop("flagged"), r.pop("gbytes")
    note = unflagged_note(r)
    paths["zdelta_repair"]["minkunet42 int64 window plan (4e)"] = dict(
        launches=len(rec.calls["zdelta_repair"]), flagged=flagged,
        **per_forward(r))
    log(f"[4e int64 repair] {len(rec.calls['zdelta_repair'])} repair "
        f"launches of the window plan on int64 words equal to the plain "
        f"version, {flagged} flagged cells re-searched; per plan device "
        f"{r['ms']:.4f} ms, through the wrapper {r['wrapper_ms']:.4f} ms, "
        f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.5f} ms "
        f"({gbytes * 1e3:.2f} MB){note} | {card}")
    del rec, v_calls, session, win, st1, st2
    torch.cuda.empty_cache()


def expected_launches(specs) -> dict:
    """Kernel launches of one forward of ``specs`` on the superwindow
    engine without autograd: one fused epilogue per layer; one search (and
    its repair) per layer whose map is searched (``core.network_plan``: not
    a 1x1 layer's identity, not a transposed layer's map where a strided
    layer of the plan has searched its transpose); the OS kernel for a
    layer with dense offsets, the WS kernel for one with sparse offsets."""
    from repro_torch.core.kernel_map import l1_partition
    from repro_torch.kernels import launch_counts
    exp = {k: 0 for k in launch_counts()}
    exp["relu_bn"] = len(specs)
    kept = [s for s in specs
            if not s.transposed and not (s.K == 1 and s.submanifold)]
    strided = {(s.m_in, s.m_out, s.K) for s in kept}
    searched = len(kept)
    searched += len({(s.m_out, s.m_in, s.K) for s in specs
                     if s.transposed} - strided)
    exp["zdelta_superwindow_search"] = exp["zdelta_repair"] = searched
    for s in specs:
        if s.dataflow == "hybrid":
            dense, sparse = l1_partition(s.K, s.offset_stride, s.t)
            os_, ws_ = bool(dense.size), bool(sparse.size)
        else:
            os_, ws_ = s.dataflow == "os", s.dataflow == "ws"
        exp["spconv_gather_gemm"] += os_
        exp["ws_scatter_gemm"] += ws_
    return exp


def expected_epilogues(net) -> dict:
    """Fused epilogues of one forward of ``net`` without autograd on the
    card, as ``models.pointcloud.EPILOGUE_CALLS`` counts them: every layer
    fused, by the norm order its graph gives it, none on the chain."""
    from repro_torch.models.pointcloud import EPILOGUE_CALLS
    exp = {k: 0 for k in EPILOGUE_CALLS}
    for g in net.graph:
        exp[g.order] += 1
    exp["fused"] = len(net.graph)
    return exp


def log_tuning(label: str, session) -> None:
    """Per layer the tuned t, backend, window (and whether it was held to
    the search kernel's largest) and half-search; gates every layer on
    the kernels."""
    rep = session.tune_report
    rows = []
    for s in session.net.specs:
        held = rep.windows_limited.get(s.name)
        w = (f"W={s.window}" + (f" (planned {held[0]}, held)" if held
                                else "")) if s.window else "W=default"
        rows.append(f"{s.name}: t={s.t} {s.backend} {w} sym={s.symmetry}")
    log(f"[{label}] {rep.mode} tuning took {rep.seconds:.2f} s; "
        f"{len(rep.windows_limited)} of {len(session.net.specs)} windows "
        "held to the kernel's largest; " + "; ".join(rows))
    bad = [s.name for s in session.net.specs if s.backend != "cuda"]
    if bad:
        raise RuntimeError(f"{label}: tuned layers {bad} off the kernels")


def tuner_phases(batch, kind: str, card: str, cp_untuned_ms: float) -> dict:
    """Phase 8: the §5.4 tuner on the card and the paper's mapping
    baselines, on phase 4's scenes (module doc). Returns 8a's measure
    results by layer (phase 11c serves them)."""
    import torch
    from repro_torch.core.network_plan import (build_network_plan,
                                               sequential_plan_fns)
    from repro_torch.core.sparse_tensor import SparseTensor
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import pointcloud as pc
    from repro_torch.serve import BucketedPlanner, compile_network

    def clouds_of(channels):
        rng = np.random.default_rng(1)
        return [(sc.coords, rng.normal(size=(len(sc.coords), channels))
                 .astype(np.float32)) for sc in batch]

    def plain_net(net):
        return dataclasses.replace(net, specs=tuple(
            dataclasses.replace(s, backend="torch") for s in net.specs))

    def wall_ms(fn, reps: int = 3) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    layout = batch[0].layout
    # -- 8a. CenterPoint-Large tuned on the card ------------------------------
    t_phase = time.perf_counter()
    clouds = clouds_of(5)
    cp = pc.centerpoint_large()
    base = compile_network(cp, layout, batch=2, seed=0, cuda_graphs=False)
    st1 = SparseTensor.from_point_clouds(clouds[:1], base.layout)
    st2 = SparseTensor.from_point_clouds(clouds, base.layout)
    tuned = {}
    for mode in ("cost_model", "measure"):
        tuned[mode] = compile_network(cp, layout, batch=2,
                                      params=base.params, tuner=mode,
                                      tune_sample=st1, cuda_graphs=False)
        log_tuning(f"8a cp {mode}", tuned[mode])
    meas = tuned["measure"]
    log(f"[8a cp measure] segment engine {meas.segment.backend} "
        f"({meas.tune_report.segment.per_backend})")
    outb, hb, times, counts = drive(meas, (("scene0", st1), ("batch2", st2)),
                                    expected_launches(meas.net.specs),
                                    "8a cp tuned", kind, card)
    profile_line("8a", lambda: meas(st2), times["batch2"][1], card)
    # the untuned (t = 3), cost-model and measure-tuned sessions in turns
    turns = {}
    for name, sess in (("untuned", base), ("measure", meas),
                       ("cost_model", tuned["cost_model"]),
                       ("measure", meas), ("untuned", base)):
        turns.setdefault(name, []).append(wall_ms(lambda: sess(st2)))
    log(f"[8a cp tuned vs untuned] batch-2 ms per call: measure-tuned "
        f"{times['batch2'][1]:.1f} (drive), 4b untuned {cp_untuned_ms:.1f}; "
        "in turns (3 calls each): " + ", ".join(
            f"{k} " + "/".join(f"{v:.1f}" for v in vs)
            for k, vs in turns.items()) + f" | {kind} | {card}")
    plain_path(meas, plain_net(meas.net), st2, outb, "8a plain path")
    again = compile_network(cp, layout, batch=2, params=base.params,
                            tuner=meas.tune_report.results, cuda_graphs=False)
    if again.net.specs != meas.net.specs:
        raise RuntimeError("8a: the mapping form gave other specs")
    outm = again(st2)
    if not torch.equal(outm.features, outb.features):
        raise RuntimeError("8a: logits of the session rebuilt from the "
                           "mapping form not bitwise equal")
    log(f"[8a cp mapping] rebuilt from tune_report.results: same specs, "
        f"logits bitwise equal; phase 8a "
        f"{time.perf_counter() - t_phase:.1f} s")
    results = meas.tune_report.results
    del base, tuned, meas, again, outb, outm, st1, st2
    torch.cuda.empty_cache()

    # -- 8b. MinkUNet-42 under the cost model ---------------------------------
    t_phase = time.perf_counter()
    clouds = clouds_of(4)
    net = pc.minkunet42(in_channels=4, n_classes=20)
    st1 = SparseTensor.from_point_clouds(clouds[:1], layout.with_batch(2))
    st2 = SparseTensor.from_point_clouds(clouds, layout.with_batch(2))
    mk = compile_network(net, layout, batch=2, seed=0, tuner="cost_model",
                         tune_sample=st1, cuda_graphs=False)
    log_tuning("8b mk cost_model", mk)
    sub = [s for s in mk.net.specs if s.submanifold]
    log(f"[8b mk symmetry] half-search chosen on "
        f"{sum(bool(s.symmetry) for s in sub)} of {len(sub)} submanifold "
        "layers: " + " ".join(f"{s.name}={s.symmetry}" for s in sub))
    outb, hb, times, counts = drive(mk, (("scene0", st1), ("batch2", st2)),
                                    expected_launches(mk.net.specs),
                                    "8b mk tuned", kind, card)
    plain_path(mk, plain_net(mk.net), st2, outb, "8b plain path")
    log(f"[8b] phase {time.perf_counter() - t_phase:.1f} s")
    del outb

    # -- 8c. the baselines at MinkUNet-42's batch-2 plan ----------------------
    t_phase = time.perf_counter()
    specs = net.specs
    stp = st2.pad_to(mk._bucket(st2.capacity))
    ref = build_network_plan(stp.packed, specs=specs, layout=mk.layout)
    plan_ms = {}
    for engine in ("zdelta_cuda", "zdelta", "bsearch", "hash"):
        reset_launch_counts()
        plan = build_network_plan(stp.packed, specs=specs, layout=mk.layout,
                                  engine=engine)
        if engine in ("bsearch", "hash") and any(launch_counts().values()):
            raise RuntimeError(f"8c: engine {engine} launched kernels")
        for s in specs:
            if not torch.equal(plan.kmaps[s.name].m, ref.kmaps[s.name].m):
                raise RuntimeError(f"8c: {engine} map of {s.name} differs "
                                   "from zdelta_cuda's")
        del plan
        plan_ms[engine] = wall_ms(lambda: build_network_plan(
            stp.packed, specs=specs, layout=mk.layout, engine=engine))
    sort_fn, level_fns, map_fns = sequential_plan_fns(specs, mk.layout)

    def sequential():
        v0 = sort_fn(stp.packed)
        coords = {0: v0, **{m: fn(v0) for m, fn in level_fns.items()}}
        return coords, {s.name: map_fns[s.name](coords[s.m_in],
                                                coords[s.m_out])
                        for s in specs}

    coords, kmaps = sequential()
    for m, cs in coords.items():
        if not (torch.equal(cs.packed, ref.coords[m].packed)
                and int(cs.count) == int(ref.coords[m].count)):
            raise RuntimeError(f"8c: sequential level {m} differs")
    for s in specs:
        if not torch.equal(kmaps[s.name].m, ref.kmaps[s.name].m):
            raise RuntimeError(f"8c: sequential map of {s.name} differs")
    del coords, kmaps
    plan_ms["sequential"] = wall_ms(sequential)
    planner = BucketedPlanner(specs=specs, layout=mk.layout)
    for st in (st1, st2, st1):
        planner.plan(st.packed[: int(st.count)])
    buckets = {mk._bucket(int(st1.count)), mk._bucket(int(st2.count))}
    if planner.compile_count != len(buckets):
        raise RuntimeError(f"8c: BucketedPlanner compile_count "
                           f"{planner.compile_count} != {len(buckets)}")
    log(f"[8c baselines] {len(specs)} MinkUNet-42 maps at bucket "
        f"{stp.capacity}: bsearch and hash equal to zdelta_cuda's, the "
        f"sequential plan's levels and maps equal to the fused plan's; "
        f"BucketedPlanner {planner.compile_count} keys for buckets "
        f"{sorted(buckets)} (hits {planner.bucket_hits})")
    log(f"[8c plan ms] network plan, wall ms per build (3 builds, synced): "
        + ", ".join(f"{k} {v:.2f}" for k, v in plan_ms.items())
        + f" | {kind} | {card}; phase {time.perf_counter() - t_phase:.1f} s")
    del mk, ref, planner, st1, st2, stp
    torch.cuda.empty_cache()
    return results


def attention_bound(q, k, causal: bool) -> tuple:
    """(bound ms, operations, basis) of one attention call: q, k, v read
    once and the output written once, over the HBM rate; 4 * B * H * Sq *
    Skv * D operations, halved under causal masking, over the bf16
    tensor-core peak for bf16 inputs and the fp32 CUDA-core peak for
    fp32."""
    import torch
    B, Sq, H, D = q.shape
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    ops = 4.0 * B * H * Sq * k.shape[1] * D * (0.5 if causal else 1.0)
    peak = PEAK_BF16_PER_S if q.dtype == torch.bfloat16 else PEAK_FP32_PER_S
    tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, ops / peak * 1e3
    return (tb, ops, "bytes") if tb >= to else (to, ops, "operations")


def sdpa_call(q, k, v, causal: bool, scale: float):
    """``scaled_dot_product_attention`` on the same function ([B, heads, S,
    D] views, GQA by ``enable_gqa``, the causal diagonal at the end of the
    keys): the library yardstick, timed here and never called by the
    port."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    Sq, Skv = q.shape[1], k.shape[1]
    mask = None
    if causal and Sq != Skv:
        mask = torch.ones((Sq, Skv), dtype=torch.bool,
                          device=q.device).tril(Skv - Sq)
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
        scale=scale, enable_gqa=True)


def attention_close(got, ref, what: str) -> float:
    """fp32 within ``1e-5 * max(1, max|ref|)``, bf16 within ``2e-2``
    relative; returns max|diff|."""
    import torch
    d = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    tol = (1e-5 * max(1.0, scale) if got.dtype == torch.float32
           else 2e-2 * max(scale, 1e-30))
    if not (bool(torch.isfinite(got.float()).all()) and d <= tol):
        raise RuntimeError(f"flash attention {what}: max|diff| {d} > {tol}")
    return d


def time_attention(q, k, v, kw: dict) -> dict:
    """Kernel, plain version and SDPA ms of one call, and its bound."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_torch)
    b, ops, by = attention_bound(q, k, kw["causal"])
    return dict(ms=cuda_ms(lambda: flash_attention(q, k, v, **kw), 5),
                plain_ms=cuda_ms(lambda: flash_attention_torch(q, k, v, **kw),
                                 2),
                library_ms=cuda_ms(sdpa_call(q, k, v, kw["causal"],
                                             kw["scale"]), 5),
                bound_ms=b, bound_by=by, gflop=ops / 1e9)


def check_flash(calls) -> dict:
    """Every recorded launch against the plain version; each distinct
    shape (a prefill's 48 layers share one) timed once, its times counted
    for every launch of that shape. Returns the sums and, by query
    length, the per-prefill numbers."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_torch)
    err = 0.0
    by_len: dict = {}
    for i, (a, kw) in enumerate(calls):
        q, k, v = a
        got = flash_attention(q, k, v, **kw)
        ref = flash_attention_torch(q, k, v, **kw)
        err = max(err, attention_close(got, ref, f"launch {i} "
                                       f"{tuple(q.shape)}"))
        del got, ref
        S = q.shape[1]
        if S not in by_len:
            by_len[S] = dict(launches=0, **time_attention(q, k, v, kw))
        by_len[S]["launches"] += 1
    tot = {key: sum(r[key] * r["launches"] for r in by_len.values())
           for key in ("ms", "plain_ms", "library_ms", "bound_ms", "gflop")}
    by = "operations" if any(r["bound_by"] == "operations"
                             for r in by_len.values()) else "bytes"
    return dict(max_abs_err=err, bound_by=by, **tot, by_len=by_len)


def lm_serve(eng, reqs, label: str = "7b") -> tuple:
    """The LM main path: ``eng.run(reqs)`` with the launch counters set to 0
    just before and read just after, and ``transformer.prefill`` /
    ``decode_step`` wrapped to time each call (synchronised), count its
    flash attention launches and check its logits finite. Returns the
    wall seconds, the launch counts and the per-call records."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import transformer as tf
    calls = {"prefill": [], "decode": []}
    saved = tf.prefill, tf.decode_step

    def timed(kind, fn):
        def wrapped(*a, **kw):
            before = launch_counts()["flash_attention"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, st = fn(*a, **kw)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
            if not bool(torch.isfinite(logits).all()):
                raise RuntimeError(f"{label}: non-finite logits from {kind}")
            n = a[2]["tokens"].shape[1] if kind == "prefill" else 1
            calls[kind].append(
                (n, dt, launch_counts()["flash_attention"] - before))
            return logits, st
        return wrapped

    tf.prefill = timed("prefill", saved[0])
    tf.decode_step = timed("decode", saved[1])
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        eng.run(list(reqs))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        tf.prefill, tf.decode_step = saved
    return wall, counts, calls


def teacher_forced(params, cfg, prompt, forced, backend: str):
    """The prompt's last-position prefill logits, then the logits of one
    decode step per token of ``forced`` fed in order: ``[1 + n, vocab]``
    fp32."""
    import torch
    from repro_torch.models import transformer as tf
    tok = torch.as_tensor(prompt[None], device=DEV)
    logits, st = tf.prefill(params, cfg, {"tokens": tok},
                            len(prompt) + len(forced), backend=backend)
    rows = [logits[0, -1].float()]
    for i, t in enumerate(forced):
        logits, st = tf.decode_step(
            params, cfg, st, {"tokens": torch.tensor([[t]], device=DEV)},
            len(prompt) + i)
        rows.append(logits[0, -1].float())
    return torch.stack(rows)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def rel_max(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def lm_phases(results: dict, paths: dict, card: str) -> None:
    """yi-9b serving: phases 7 (the kernel against its plain version), 7b
    (the main path) and 7c (the plain path); fills ``results`` and
    ``paths`` for the kernel table."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import launch_counts, ops, reset_launch_counts
    from repro_torch.models import transformer as tf
    from repro_torch.serve import Request, ServeEngine

    # -- 7 (sweep). the JAX kernel sweep's shapes through ops.attention ------
    gen = torch.Generator(device=DEV).manual_seed(0)
    sweep = [((2, 256, 64), (2, 256, 64), True),
             ((2, 256, 64), (2, 256, 64), False),
             ((1, 512, 128), (1, 512, 128), True),
             ((4, 128, 256), (4, 128, 256), True),
             ((2, 128, 64), (2, 512, 64), True)]
    sweep_paths = {}
    for shp_q, shp_k, causal in sweep:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(s_, generator=gen, device=DEV).to(dt)
                       for s_ in (shp_q, shp_k, shp_k))
            got = ops.attention(q, k, v, causal=causal)
            ref = ops.attention(q, k, v, causal=causal, backend="torch")
            d = attention_close(got, ref, f"sweep {shp_q} {shp_k}")
            kw = dict(causal=causal, scale=shp_q[-1] ** -0.5)
            r = time_attention(q[:, :, None], k[:, :, None], v[:, :, None],
                               kw)
            name = (f"{shp_q[0]}x{shp_q[1]}x{shp_k[1]}x{shp_q[2]} "
                    f"{'causal' if causal else 'full'} {str(dt)[6:]}")
            sweep_paths[name] = {key: r[key] for key in
                                 ("ms", "plain_ms", "library_ms", "bound_ms")}
            log(f"[7 flash sweep {name}] max|diff| {d:.3e}; kernel "
                f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, SDPA "
                f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), {r['gflop'] / r['ms']:.2f} TFLOP/s")
    del q, k, v, got, ref

    # -- the LM main path's inputs -------------------------------------------
    t0 = time.perf_counter()
    cfg = configs.get_config(LM_ARCH)
    params = tf.init_params(cfg, 0, device=DEV)[0]
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (int(rng.integers(4, 48)),))
               .astype(np.int32) for _ in range(8)]
    prompts += [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
                for n in LM_LONG]
    reqs = [Request(prompt=p_, max_new=LM_MAX_NEW) for p_ in prompts]
    log(f"[inputs lm] {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads (kv {cfg.n_kv}, head dim "
        f"{cfg.head_dim}), d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}; "
        f"{n_params / 1e9:.2f} B random parameters from seed 0 on the card "
        f"in {time.perf_counter() - t0:.1f} s; prompts "
        f"{[len(p_) for p_ in prompts]} tokens, {LM_MAX_NEW} greedy tokens "
        f"each, {LM_SLOTS} slots, cache {LM_CACHE}")
    # eager: the per-decode-step checks wrap transformer.decode_step, which a
    # replay does not call (11d times the decode graph)
    eng = ServeEngine(cfg, params, batch_slots=LM_SLOTS, cache_len=LM_CACHE,
                      cuda_graphs=False)
    for p_ in (prompts[0], prompts[-1]):      # warm-up, outside the counts
        tf.prefill(params, cfg, {"tokens": torch.as_tensor(p_[None],
                                                           device=DEV)},
                   LM_CACHE)
    torch.cuda.synchronize()

    # -- 7b. main path -------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    with Recorder(names=("flash_attention",)) as rec:
        wall, counts, calls = lm_serve(eng, reqs)
    pre, dec = calls["prefill"], calls["decode"]
    others = {k_: v_ for k_, v_ in counts.items()
              if v_ and k_ != "flash_attention"}
    if others or counts["flash_attention"] != cfg.n_layers * len(reqs):
        raise RuntimeError(f"7b: launches {counts}, expected "
                           f"{cfg.n_layers * len(reqs)} flash_attention only")
    bad = [c for c in pre if c[2] != cfg.n_layers] + [c for c in dec if c[2]]
    if bad or len(pre) != len(reqs):
        raise RuntimeError(f"7b: per-call flash launches {bad} (want "
                           f"{cfg.n_layers} per prefill, 0 per decode step)")
    if not all(len(r.out) == LM_MAX_NEW and r.done
               and all(0 <= t < cfg.vocab for t in r.out) for r in reqs):
        raise RuntimeError("7b: a request did not finish with "
                           f"{LM_MAX_NEW} tokens in the vocabulary")
    n_tok = sum(len(r.out) for r in reqs)
    dec_ms = [c[1] for c in dec]
    pre_ms = {n: ms for n, ms, _ in pre}
    log(f"[7b main path] {cfg.name} full width, ServeEngine(batch_slots="
        f"{LM_SLOTS}, cache_len={LM_CACHE}): {len(reqs)} requests, {n_tok} "
        f"tokens in {wall * 1e3:.1f} ms = {n_tok / wall:.1f} tokens/s; "
        f"launches {counts} ({cfg.n_layers} flash_attention per prefill, 0 "
        f"per decode step over {len(dec)} steps); logits finite | {card} | "
        f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    log(f"[7b main path] ms per prefill by prompt length: "
        + ", ".join(f"{n}: {ms:.2f}" for n, ms in sorted(pre_ms.items())))
    log(f"[7b main path] ms per decode step ({LM_SLOTS} slots): median "
        f"{float(np.median(dec_ms)):.2f}, first {dec_ms[0]:.2f}, min "
        f"{min(dec_ms):.2f}, max {max(dec_ms):.2f}")
    toks = torch.tensor([[r.out[-1]] for r in reqs[:LM_SLOTS]],
                        device=DEV)
    profile_line("7b", lambda: tf.decode_step(
        params, cfg, eng.state, {"tokens": toks},
        torch.as_tensor(eng.pos.copy())), float(np.median(dec_ms)), card,
        what="one decode step (4 slots)")
    long_tok = torch.as_tensor(prompts[-1][None], device=DEV)
    profile_line("7b", lambda: tf.prefill(params, cfg, {"tokens": long_tok},
                                          LM_CACHE),
                 pre_ms[LM_LONG[-1]], card,
                 what=f"one {LM_LONG[-1]}-token prefill")
    again = {}                  # each length once more, after the run
    for p_ in prompts:
        tok = torch.as_tensor(p_[None], device=DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tf.prefill(params, cfg, {"tokens": tok}, LM_CACHE)
        torch.cuda.synchronize()
        again[len(p_)] = (time.perf_counter() - t0) * 1e3
    log(f"[7b main path] ms per prefill by prompt length, called again "
        f"after the run: "
        + ", ".join(f"{n}: {ms:.2f}" for n, ms in sorted(again.items())))

    # -- 7 (yi-9b). every prefill launch of the main path ---------------------
    f_calls = rec.calls["flash_attention"]
    del rec
    r = check_flash(f_calls)
    by_len = r.pop("by_len")
    gflop = r.pop("gflop")
    results["flash_attention"] = dict(r, launches=counts["flash_attention"])
    log(f"[7 flash {cfg.name}] {len(f_calls)} prefill launches within 2e-2 "
        f"relative of the plain version (max|diff| {r['max_abs_err']:.3e}); "
        f"over the run kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} "
        f"ms, SDPA {r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
        f"({r['bound_by']}; {gflop:.1f} GFLOP, {gflop / r['ms']:.2f} "
        f"TFLOP/s) | {card}")
    for n, rr in sorted(by_len.items()):
        log(f"[7 flash {cfg.name} S={n}] per prefill ({rr['launches']} "
            f"launches): kernel {rr['ms'] * rr['launches']:.3f} ms, plain "
            f"{rr['plain_ms'] * rr['launches']:.3f} ms, SDPA "
            f"{rr['library_ms'] * rr['launches']:.3f} ms, bound "
            f"{rr['bound_ms'] * rr['launches']:.4f} ms ({rr['bound_by']}), "
            f"{rr['gflop'] / rr['ms']:.2f} TFLOP/s")
    paths["flash_attention"] = {
        f"{cfg.name} prefill S={n}": {
            "launches": rr["launches"],
            **{k_: rr[k_] * rr["launches"]
               for k_ in ("ms", "plain_ms", "library_ms", "bound_ms")}}
        for n, rr in sorted(by_len.items())}
    paths["flash_attention"].update(
        {f"sweep {k_}": v_ for k_, v_ in sweep_paths.items()})
    del f_calls
    torch.cuda.empty_cache()

    # -- 7c. the plain path ----------------------------------------------------
    long_req = reqs[-1]
    forced = long_req.out[:LM_MAX_NEW]
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    lk = teacher_forced(params, cfg, prompts[-1], forced, "auto")
    lk32 = teacher_forced(params, cfg32, prompts[-1], forced, "auto")
    reset_launch_counts()
    lp = teacher_forced(params, cfg, prompts[-1], forced, "torch")
    lf = teacher_forced(params, cfg32, prompts[-1], forced, "torch")
    if any(launch_counts().values()):
        raise RuntimeError(f"7c: the plain path launched kernels: "
                           f"{launch_counts()}")
    l2 = lambda a, b: rel_l2({0: a}, {0: b})  # noqa: E731
    d_kp, d_pf = l2(lk, lp), l2(lp, lf)
    if not d_kp <= d_pf:
        raise RuntimeError(f"7c: kernel path vs plain bf16 path {d_kp:.3e} "
                           f"> plain bf16 vs fp32 {d_pf:.3e} (relative L2)")
    agree = lambda a, b: int((a.argmax(-1) == b.argmax(-1)).sum())  # noqa
    served = torch.tensor(long_req.out, device=DEV)
    log(f"[7c plain path] {LM_LONG[-1]}-token prompt, prefill + "
        f"{len(forced)} decode steps teacher-forced on 7b's tokens, "
        f"relative L2 over the {len(lk)} logit rows: kernel path vs plain "
        f"bf16 path {d_kp:.3e} <= plain bf16 vs the same weights in fp32 "
        f"{d_pf:.3e} (kernel vs fp32 {l2(lk, lf):.3e}); max|diff| / "
        f"max|logits| {rel_max(lk, lp):.3e} and {rel_max(lp, lf):.3e}; "
        f"prefill row alone (relative L2) {l2(lk[:1], lp[:1]):.3e} and "
        f"{l2(lp[:1], lf[:1]):.3e}; in fp32 (the kernel's fp32 build) "
        f"kernel path vs plain path {l2(lk32, lf):.3e}, prefill row "
        f"{l2(lk32[:1], lf[:1]):.3e}; no kernel launched on the plain "
        f"path; greedy agreement (not gated) kernel/plain "
        f"{agree(lk, lp)}/{len(lk)}, plain/fp32 {agree(lp, lf)}/{len(lk)}, "
        f"kernel/served {int((lk[:len(served)].argmax(-1) == served).sum())}"
        f"/{len(served)} | {card}")
    del eng, lk, lk32, lp, lf
    torch.cuda.empty_cache()

    # -- 11d. the decode step as one CUDA graph ---------------------------------
    decode_graph_phase(cfg, params, prompts, card)
    del params
    torch.cuda.empty_cache()


# -- phase 10: the point-cloud serving engine ---------------------------------

class CallCheck:
    """Shadows a session's ``run_with_health`` for the ``with`` block:
    every call that reaches the session must launch each kernel as
    ``expected`` says per run of the plan+forward body (host counts taken
    at enqueue, so this adds no sync). An eager session runs the body once
    per escalation level; a graph session runs it ``WARMUP_RUNS + 1``
    times for each key it captures and replays once per level, launching
    nothing through the wrappers. ``calls`` counts the calls,
    ``body_runs`` the body's runs, ``captures`` the keys captured."""

    def __init__(self, session, expected: dict, label: str):
        self.session = session
        self.expected = expected
        self.label = label
        self.calls = self.body_runs = self.captures = 0

    def __enter__(self):
        from repro_torch.serve.graphs import WARMUP_RUNS
        inner = self.session.run_with_health
        reg = self.session.metrics

        def call(st, **kw):
            from repro_torch.kernels import launch_counts
            before = launch_counts()
            caps = reg.counter("session_graph_captures").value
            reps = reg.counter("session_graph_replays").value
            out, health = inner(st, **kw)
            after = launch_counts()
            caps = reg.counter("session_graph_captures").value - caps
            reps = reg.counter("session_graph_replays").value - reps
            levels = health.replans + 1
            if self.session.cuda_graphs:
                runs = caps * (WARMUP_RUNS + 1)
                if reps != levels:
                    raise RuntimeError(f"{self.label} call {self.calls}: "
                                       f"{reps} replays for {levels} "
                                       "escalation levels")
            else:
                runs = levels
            grew = {k: after[k] - before[k] for k in after}
            want = {k: v * runs for k, v in self.expected.items()}
            if grew != want:
                raise RuntimeError(f"{self.label} call {self.calls}: "
                                   f"launches {grew}, expected {want}")
            self.calls += 1
            self.body_runs += runs
            self.captures += caps
            return out, health

        self.session.run_with_health = call
        return self

    def __exit__(self, *exc):
        del self.session.run_with_health     # the bound method again
        return False


def bare_answer(session, cloud) -> tuple:
    """The bare session's single-scene call on ``cloud``, split by
    ``unbatch()`` and ``coords()``: the reference for the engine's
    answers."""
    from repro_torch.core.sparse_tensor import SparseTensor
    out = session(SparseTensor.from_point_clouds([cloud], session.layout,
                                                 device=DEV))
    scene = out.unbatch()[0]
    n = int(scene.count)
    return scene.features[:n].cpu().numpy(), scene.coords()[0]


def check_answers(reqs, want, label: str, skip=()) -> None:
    """Every request not in ``skip`` ended ``ok`` with logits and voxels
    bitwise equal to ``want`` (cycled over the requests)."""
    for i, r in enumerate(reqs):
        if i in skip:
            continue
        logits, voxels = want[i % len(want)]
        if r.outcome != "ok":
            raise RuntimeError(f"{label}: request {i} ended {r.outcome} "
                               f"({r.error})")
        if not (np.array_equal(r.logits, logits)
                and np.array_equal(r.voxels, voxels)):
            raise RuntimeError(f"{label}: request {i}'s answer is not "
                               "bitwise the bare session's")


def serve_requests(engine, clouds) -> tuple:
    """``engine.run`` over fresh requests on ``clouds``, timed on the host
    clock with the card synchronised on both sides; returns the requests
    and the ms."""
    import torch
    from repro_torch.serve import PointCloudRequest
    reqs = [PointCloudRequest(c, f.copy()) for c, f in clouds]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run(reqs)
    torch.cuda.synchronize()
    return reqs, (time.perf_counter() - t0) * 1e3


def hist_line(reg, name: str) -> str:
    h = reg.histogram(name)
    return (f"{name} p50 {h.percentile(0.5) * 1e3:.2f} ms (bucket edge), "
            f"mean {h.sum / max(h.count, 1) * 1e3:.2f} ms over {h.count}")


def engine_phase(label: str, session, bare, clouds, expected: dict,
                 card: str, paths: dict, path: str) -> dict:
    """10a / 10b on one graph session (module doc): a clean run, a
    poisoned run and pack-ahead through the engine, each answer against
    the single-scene call of ``bare`` (an eager session on the same
    weights); the engine timed against the graph session's bare batch-2
    call; one profiled engine step. Returns the reference answers and the
    bare batch-2 call's median seconds."""
    import torch
    from repro_torch.core.sparse_tensor import SparseTensor
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serve import (FaultySession, PointCloudRequest,
                                   PointCloudServeEngine, feature_poison,
                                   poison_features)
    from repro_torch.serve.engine import host_answers
    name = session.net.name
    refs = [bare_answer(bare, c) for c in clouds]
    per_call = {k: v for k, v in expected.items() if v}

    # clean run: two batches of 2
    reset_launch_counts()
    with CallCheck(session, expected, f"{label} clean") as chk:
        eng = PointCloudServeEngine(session)
        reqs, _ = serve_requests(eng, clouds)
    counts = launch_counts()
    check_answers(reqs, refs, f"{label} clean")
    if not (eng.batches_run == chk.calls == 2 and chk.captures
            and all(counts[k] == chk.body_runs * v
                    for k, v in expected.items())):
        raise RuntimeError(f"{label} clean: {eng.batches_run} batches, "
                           f"{chk.calls} calls, {chk.captures} captures, "
                           f"launches {counts}")
    for k, v in per_call.items():
        paths.setdefault(k, {})[path] = dict(launches=counts[k])
    log(f"[{label} clean] {name}: {len(reqs)} requests "
        f"{[len(c) for c, _ in clouds]} voxels, 2 batches of 2 through the "
        f"graph session: all ok, each bitwise the eager session's "
        f"single-scene call (logits and voxels); {chk.captures} key(s) "
        f"captured ({chk.body_runs} body runs of {per_call}), the rest "
        f"replayed; run {counts}")

    # poisoned: request 1 carries a poison_features marker
    poisoned = [(c, f.copy()) for c, f in clouds]
    poisoned[1] = (poisoned[1][0], poison_features(poisoned[1][1]))
    reset_launch_counts()
    with CallCheck(session, expected, f"{label} poisoned") as chk:
        eng_p = PointCloudServeEngine(FaultySession(
            session, poison=feature_poison()))
        keys_before = session.compile_count
        reqs_p, _ = serve_requests(eng_p, poisoned)
    counts = launch_counts()
    outcomes = [r.outcome for r in reqs_p]
    if outcomes != ["ok", "quarantined", "ok", "ok"]:
        raise RuntimeError(f"{label} poisoned: outcomes {outcomes}")
    check_answers(reqs_p, refs, f"{label} poisoned", skip=(1,))
    if not (chk.captures and all(counts[k] == chk.body_runs * v
                                 for k, v in expected.items())):
        raise RuntimeError(f"{label} poisoned: launches {counts} over "
                           f"{chk.calls} session calls, {chk.captures} "
                           "captures")
    log(f"[{label} poisoned] request 1 quarantined by bisection "
        f"({reqs_p[1].error.split(' (')[0]}); requests 0, 2, 3 bitwise the "
        f"eager session's (request 0 alone at bucket "
        f"{reqs_p[0].health.bucket}, a key captured mid-serving: "
        f"compile_count {keys_before} -> {session.compile_count}); "
        f"{chk.calls} session calls reached the card; counters "
        f"{eng_p.counters}")

    # under the dispatch watchdog: the session runs on the watchdog's thread
    with CallCheck(session, expected, f"{label} watchdog") as chk:
        eng_w = PointCloudServeEngine(session, dispatch_timeout=60.0)
        reqs_w, ms_w = serve_requests(eng_w, clouds)
    check_answers(reqs_w, refs, f"{label} watchdog")
    if chk.calls != 2 or eng_w.dispatch_timeouts:
        raise RuntimeError(f"{label} watchdog: {chk.calls} calls, "
                           f"{eng_w.dispatch_timeouts} timeouts")
    log(f"[{label} watchdog] dispatch_timeout=60 s: the session called "
        f"from the watchdog's thread on the card (its graphs replayed "
        f"there), answers bitwise, {chk.calls} calls, {ms_w:.1f} ms")

    # serial and pack-ahead over 8 requests, in turns
    eight = clouds * 2
    runs = {"serial": [], "pack_ahead": []}
    regs = {}
    with CallCheck(session, expected, f"{label} timed"):
        for mode in ("serial", "pack_ahead", "pack_ahead", "serial"):
            reg = regs[mode] = MetricsRegistry()
            eng_t = PointCloudServeEngine(
                session, pack_ahead=mode == "pack_ahead", metrics=reg)
            reqs_t, ms = serve_requests(eng_t, eight)
            check_answers(reqs_t, refs, f"{label} {mode}")
            runs[mode].append((ms, eng_t.batches_run,
                               eng_t.packs_overlapped))
    # the bare batch-2 call on batches packed ahead, on the card
    sts = [SparseTensor.from_point_clouds(clouds[i:i + 2], session.layout,
                                          device=DEV) for i in (0, 2)]
    bare = []
    for _ in range(3):
        for st in sts:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, _ = session.run_with_health(st)
            torch.cuda.synchronize()
            bare.append((time.perf_counter() - t0) * 1e3)
    bare_ms = float(np.median(bare))
    # the host's own work around a call: pack on the host, move, answer
    pack, move, answer = [], [], []
    for _ in range(3):
        t0 = time.perf_counter()
        st_h = SparseTensor.from_point_clouds(clouds[:2], session.layout,
                                              device="cpu")
        t1 = time.perf_counter()
        st_d = st_h.to(DEV)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out, _ = session.run_with_health(st_d)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        host_answers(out, 2)
        t4 = time.perf_counter()
        pack.append((t1 - t0) * 1e3)
        move.append((t2 - t1) * 1e3)
        answer.append((t4 - t3) * 1e3)
    ser = [ms for ms, _, _ in runs["serial"]]
    pa = [ms for ms, _, _ in runs["pack_ahead"]]
    n_b = runs["serial"][0][1]
    overlapped = [p for _, _, p in runs["pack_ahead"]]
    log(f"[{label} times] {name}, 8 requests in {n_b} batches of 2, in "
        f"turns: serial {ser[0]:.1f} / {ser[1]:.1f} ms = "
        f"{ser[0] / 8:.1f} / {ser[1] / 8:.1f} ms per request, "
        f"{ser[0] / n_b:.1f} / {ser[1] / n_b:.1f} per batch; pack-ahead "
        f"{pa[0]:.1f} / {pa[1]:.1f} ms = {pa[0] / 8:.1f} / "
        f"{pa[1] / 8:.1f} per request, {pa[0] / n_b:.1f} / "
        f"{pa[1] / n_b:.1f} per batch (packs_overlapped {overlapped} of "
        f"{n_b - 1}); bare batch-2 call on a tensor already on the card "
        f"median {bare_ms:.1f} ms ({', '.join(f'{v:.1f}' for v in bare)}) "
        f"| {card}")
    log(f"[{label} host] per batch of 2: pack on the host "
        f"{float(np.median(pack)):.1f} ms, H2D move "
        f"{float(np.median(move)):.1f} ms, answer read and split "
        f"{float(np.median(answer)):.1f} ms (medians of 3); serial engine "
        f"{hist_line(regs['serial'], 'serve/pack')}, "
        f"{hist_line(regs['serial'], 'serve/dispatch')}; pack-ahead "
        f"{hist_line(regs['pack_ahead'], 'serve/pack')} | {card}")

    # one engine step under the profiler
    eng_s = PointCloudServeEngine(session)
    two = [PointCloudRequest(c, f.copy()) for c, f in clouds[:2]]
    for r in two:
        eng_s.submit(r)
    profile_line(label, lambda: eng_s.step(), ser[1] / n_b, card,
                 what="engine step (pack, call, answer)")
    check_answers(two, refs[:2], f"{label} profiled step")
    return dict(refs=refs, bare_s=bare_ms / 1e3,
                serial_batch_ms=ser[1] / n_b)


def lossy_phase(cps, lossy_net, clouds, refs, card: str) -> None:
    """10b's escalation through the engine: the lossy session replans once
    and answers bitwise as the lossless one; with the ladder pinned at
    rung 2 the same call carries ``max_replans=0`` and serves with drops
    flagged."""
    from repro_torch.serve import (DegradationLadder, FaultySession,
                                   LadderConfig, PointCloudServeEngine,
                                   compile_network)
    lossy = compile_network(lossy_net, cps.layout, batch=2,
                            params=cps.params, device=DEV)
    eng = PointCloudServeEngine(lossy)
    reqs, ms = serve_requests(eng, clouds[:2])
    h = reqs[0].health
    if not (h.replans == 1 and h.ok and eng.overflow_replans == 1):
        raise RuntimeError(f"10b lossy: health {h.summary()}, "
                           f"overflow_replans {eng.overflow_replans}")
    check_answers(reqs, refs[:2], "10b lossy")
    log(f"[10b escalation] ws_capacity {LOSSY_CAPACITY} on every layer, "
        f"requests 0 and 1 in one batch: {h.summary()}, engine "
        f"overflow_replans {eng.overflow_replans}, keys captured "
        f"{lossy.compile_count} (one per escalation level); answers bitwise "
        f"the lossless eager session's; {ms:.1f} ms | {card}")
    ladder = DegradationLadder(LadderConfig(max_rung=2,
                                            deescalate_after=float("inf")))
    ladder.rung = 2
    fs = FaultySession(lossy)
    eng2 = PointCloudServeEngine(fs, ladder=ladder)
    reqs2, ms2 = serve_requests(eng2, clouds[:2])
    h2 = reqs2[0].health
    if not (fs.last_call_kwargs == {"max_replans": 0}
            and all(r.outcome == "ok" and r.degradation == 2 for r in reqs2)
            and h2.replans == 0 and h2.total_ws_dropped > 0
            and eng2.degradation_rung == 2):
        raise RuntimeError(f"10b rung 2: kwargs {fs.last_call_kwargs}, "
                           f"health {h2.summary()}, outcomes "
                           f"{[r.outcome for r in reqs2]}")
    log(f"[10b rung 2] ladder pinned at rung 2: the call carried "
        f"{fs.last_call_kwargs}, served degraded with {h2.summary()}; "
        f"{ms2:.1f} ms | {card}")


def overload_phase(session, clouds, refs, delay: float, expected: dict,
                   card: str) -> None:
    """10c (module doc): test_overload's 2x scenario on a FakeClock with
    the MinkUNet-42 session's real calls; every dispatch runs the kernels
    and every ok answer is bitwise the unloaded one."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serve import (AdmissionConfig, FakeClock, FaultySession,
                                   LadderConfig, PointCloudServeEngine,
                                   arrival_times, make_traffic,
                                   run_open_loop)
    terminal = ("ok", "invalid", "quarantined", "shed", "deadline_expired",
                "rejected_open", "dispatch_timeout")
    n = SERVE_OVERLOAD_REQUESTS
    ck = FakeClock()
    reg = MetricsRegistry(clock=ck)
    eng = PointCloudServeEngine(
        FaultySession(session, delay=delay, sleep=ck.sleep), clock=ck,
        max_queue=8, metrics=reg, scheduler="bucket",
        admission=AdmissionConfig(target=0.05, interval=0.2),
        ladder=LadderConfig(target=0.05, escalate_after=0.2,
                            deescalate_after=0.5, voxel_budget=1 << 20))
    reqs = make_traffic(clouds, n)
    rate = 2 * session.num_scenes / delay
    reset_launch_counts()
    t0 = time.perf_counter()
    with CallCheck(session, expected, "10c") as chk:
        rep = run_open_loop(eng, list(zip(arrival_times(n, rate), reqs)),
                            ck, idle_tick=0.01)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    recorded = sum(reg.histogram(f"serve_latency_{o}").count
                   for o in terminal)
    if not (all(r.outcome in terminal for r in reqs) and recorded == n
            and sum(rep.outcomes.values()) == n):
        raise RuntimeError(f"10c: outcomes {rep.outcomes}, {recorded} "
                           f"finalizations for {n} requests")
    served = [i for i, r in enumerate(reqs) if r.outcome == "ok"]
    check_answers(reqs, refs, "10c",
                  skip=set(range(n)) - set(served))
    if not (served and chk.calls == eng.batches_run
            and all(counts[k] == chk.body_runs * v
                    for k, v in expected.items())):
        raise RuntimeError(f"10c: {len(served)} ok, {chk.calls} calls, "
                           f"{eng.batches_run} batches, launches {counts}")
    log(f"[10c overload] {session.net.name}, service time {delay:.4f} s "
        f"(10a's bare batch-2 median) on a FakeClock, {n} requests offered "
        f"at {rate:.1f}/s = 2x: {rep.summary()}; every request one "
        f"terminal outcome, {len(served)} ok answers bitwise the unloaded "
        f"ones, {chk.calls} dispatches each replayed the kernels' graphs "
        f"({chk.captures} key(s) captured here, launches {counts}); "
        f"{wall:.1f} s of wall clock | {card}")


def serve_phases(batch, card: str, paths: dict, mk_net, cp_net) -> None:
    """Phase 10 (module doc): the point-cloud serving engine on phase 4's
    two scenes and two more (seed 1), ``mk_net`` (10a, 10c) and
    ``cp_net`` (10b) with the weights of phases 4 and 4b (seed 0)."""
    import torch
    from repro_torch.data import scenes
    from repro_torch.serve import compile_network
    more = scenes.scene_batch(seed=1, batch=2, kind="outdoor",
                              extent=SERVE_EXTENT, overlap=0.5)
    coords = [sc.coords for sc in list(batch) + list(more)]
    log(f"[inputs serve] 4 requests: phase 4's scenes and 2 of seed 1, "
        f"{[len(c) for c in coords]} voxels")

    # 10a: MinkUNet-42
    rng = np.random.default_rng(1)
    clouds = [(c, rng.normal(size=(len(c), 4)).astype(np.float32))
              for c in coords]
    session = compile_network(mk_net, batch[0].layout, batch=2, seed=0,
                              device=DEV)
    bare = compile_network(mk_net, batch[0].layout, batch=2,
                           params=session.params, device=DEV,
                           cuda_graphs=False)
    expected = expected_launches(mk_net.specs)
    r = engine_phase("10a", session, bare, clouds, expected, card, paths,
                     "minkunet42 engine (10a)")

    # 10c: 2x overload on the same session
    overload_phase(session, clouds, r["refs"], r["bare_s"], expected, card)
    del session, bare
    torch.cuda.empty_cache()

    # 10b: CenterPoint-Large
    rng = np.random.default_rng(1)
    clouds = [(c, rng.normal(size=(len(c), 5)).astype(np.float32))
              for c in coords]
    cps = compile_network(cp_net, batch[0].layout, batch=2, seed=0,
                          device=DEV)
    bare = compile_network(cp_net, batch[0].layout, batch=2,
                           params=cps.params, device=DEV, cuda_graphs=False)
    expected = expected_launches(cp_net.specs)
    r = engine_phase("10b", cps, bare, clouds, expected, card, paths,
                     "centerpoint_large engine (10b)")
    lossy_net = dataclasses.replace(cp_net, specs=tuple(
        dataclasses.replace(s, ws_capacity=LOSSY_CAPACITY)
        for s in cp_net.specs))
    lossy_phase(cps, lossy_net, clouds, r["refs"], card)
    del cps, bare
    torch.cuda.empty_cache()


# -- phase 11: one CUDA graph per key -----------------------------------------

def same_call(a, b) -> bool:
    """Two session outputs bitwise equal: logits, words and count."""
    import torch
    return (torch.equal(a.features, b.features)
            and torch.equal(a.packed, b.packed)
            and torch.equal(a.count, b.count))


def graph_case(label: str, net, layout, clouds, card: str, paths: dict,
               tuner=None) -> None:
    """11a-c (module doc) on one network: an eager session
    (``cuda_graphs=False``) and a graph session on the same weights; each
    key's capture (its launches, seconds and memory), every replay bitwise
    the eager call, keys replayed out of capture order, ms per batch-2 call
    in turns, both calls profiled."""
    import torch
    from repro_torch.core.sparse_tensor import SparseTensor
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import compile_network
    from repro_torch.serve.graphs import WARMUP_RUNS
    e = compile_network(net, layout, batch=2, seed=0, tuner=tuner,
                        cuda_graphs=False)
    g = compile_network(e.net, layout, batch=2, params=e.params)
    st1 = SparseTensor.from_point_clouds(clouds[:1], e.layout)
    st2 = SparseTensor.from_point_clouds(clouds, e.layout)
    expected = expected_launches(e.net.specs)
    want = {k: v * (WARMUP_RUNS + 1) for k, v in expected.items()}
    reg = g.metrics
    for name, st in (("scene0", st1), ("batch2", st2)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_reserved()
        reset_launch_counts()
        captured = reg.histogram("session/call/capture").sum
        t0 = time.perf_counter()
        out, h = g.run_with_health(st)
        torch.cuda.synchronize()
        first = (time.perf_counter() - t0) * 1e3
        captured = reg.histogram("session/call/capture").sum - captured
        grown = torch.cuda.memory_reserved() - mem0
        counts = launch_counts()
        if counts != want:
            raise RuntimeError(f"{label} {name}: capture launches {counts}, "
                               f"expected {want}")
        ref, href = e.run_with_health(st)
        if not (same_call(out, ref) and h == href):
            raise RuntimeError(f"{label} {name}: the replay is not bitwise "
                               "the eager call")
        log(f"[{label} capture {name}] key (bucket {h.bucket}, escalation "
            f"{h.escalation}): warm-up + capture "
            f"{captured:.2f} s, "
            f"first call {first:.1f} ms; launches {WARMUP_RUNS + 1} x "
            f"{ {k: v for k, v in expected.items() if v} }; memory reserved "
            f"+{grown / 2**30:.2f} GiB (process "
            f"{reg.gauge('session_graph_memory_reserved').value / 2**30:.2f}"
            f" GiB); replay bitwise the eager call (logits, words, count), "
            f"overflowed cells {sum(h.window_overflow_cells.values())} | "
            f"{card}")
    for st in (st2, st1, st2):          # out of capture order
        ref = e(st)
        reset_launch_counts()
        out = g(st)
        if any(launch_counts().values()) or not same_call(out, ref):
            raise RuntimeError(f"{label}: an out-of-order replay launched "
                               "through the wrappers or differs")
    if g.compile_count != 2:
        raise RuntimeError(f"{label}: compile_count {g.compile_count} != 2")
    times = {"eager": [], "graph": []}
    for i in range(GRAPH_PAIRS):
        for mode in (("eager", "graph") if i % 2 == 0
                     else ("graph", "eager")):
            sess = e if mode == "eager" else g
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess(st2)
            torch.cuda.synchronize()
            times[mode].append((time.perf_counter() - t0) * 1e3)
    med = {m: float(np.median(v)) for m, v in times.items()}
    wins = sum(gm < em for em, gm in zip(times["eager"], times["graph"]))
    log(f"[{label} times] {net.name} batch 2, {GRAPH_PAIRS} pairs in turns "
        f"(order alternating): graph replay median {med['graph']:.2f} ms "
        f"(IQR {np.percentile(times['graph'], 25):.2f}-"
        f"{np.percentile(times['graph'], 75):.2f}), eager median "
        f"{med['eager']:.2f} ms (IQR {np.percentile(times['eager'], 25):.2f}"
        f"-{np.percentile(times['eager'], 75):.2f}); graph faster in {wins} "
        f"of {GRAPH_PAIRS} pairs; compile_count {g.compile_count} | {card}")
    profile_line(label, lambda: g(st2), med["graph"], card,
                 what="batch2 graph replay")
    profile_line(f"{label} eager", lambda: e(st2), med["eager"], card,
                 what="batch2 eager call")
    if tuner is not None:
        with Recorder(names=("zdelta_superwindow_search",
                             "zdelta_repair")) as rec:
            e(st2)
        torch.cuda.synchronize()
        r = check_repair(rec.calls["zdelta_superwindow_search"],
                         rec.calls["zdelta_repair"], "superwindow")
        flagged, gbytes = r.pop("flagged"), r.pop("gbytes")
        note = unflagged_note(r)
        if not flagged:
            raise RuntimeError(f"{label}: the tuned session flagged no cell")
        paths["zdelta_repair"][f"{net.name} tuned ({label})"] = dict(
            launches=len(rec.calls["zdelta_repair"]), flagged=flagged,
            **per_forward(r))
        log(f"[{label} repair] eager tuned batch-2 call: "
            f"{len(rec.calls['zdelta_repair'])} repair launches equal to "
            f"the plain version, {flagged} flagged cells re-searched; per "
            f"forward device {r['ms']:.4f} ms, through the wrapper "
            f"{r['wrapper_ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.5f} ms ({gbytes * 1e3:.2f} MB){note} | {card}")
    del e, g
    torch.cuda.empty_cache()


def graph_phases(batch, card: str, paths: dict, tuned) -> None:
    """Phase 11 (module doc): 11a MinkUNet-42, 11b CenterPoint-Large,
    11c CenterPoint-Large under phase 8a's measure tuning (``tuned``, its
    results by layer), on phase 4's scenes."""
    from repro_torch.models import pointcloud as pc
    layout = batch[0].layout

    def clouds_of(channels):
        rng = np.random.default_rng(1)
        return [(sc.coords, rng.normal(size=(len(sc.coords), channels))
                 .astype(np.float32)) for sc in batch]

    graph_case("11a", pc.minkunet42(in_channels=4, n_classes=20), layout,
               clouds_of(4), card, paths)
    graph_case("11b", pc.centerpoint_large(), layout, clouds_of(5), card,
               paths)
    graph_case("11c", pc.centerpoint_large(), layout, clouds_of(5), card,
               paths, tuner=tuned)


def decode_graph_phase(cfg, params, prompts, card: str) -> None:
    """11d (module doc): the LM decode step as one CUDA graph against the
    eager step, on two engines over the same weights and the same four
    requests, stepped in turns."""
    import torch
    from repro_torch.serve import Request, ServeEngine
    engines, reqs = {}, {}
    for mode in ("eager", "graph"):
        engines[mode] = ServeEngine(cfg, params, batch_slots=LM_SLOTS,
                                    cache_len=LM_CACHE,
                                    cuda_graphs=mode == "graph")
        reqs[mode] = [Request(prompt=p_, max_new=10 ** 6)
                      for p_ in prompts[:LM_SLOTS]]
        for r in reqs[mode]:
            engines[mode].submit(r)

    def step_ms(mode):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engines[mode].step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    first = {mode: step_ms(mode) for mode in ("graph", "eager")}
    times = {"eager": [], "graph": []}
    for i in range(DECODE_PAIRS):
        for mode in (("eager", "graph") if i % 2 == 0
                     else ("graph", "eager")):
            times[mode].append(step_ms(mode))
    outs = {mode: [r.out for r in rs] for mode, rs in reqs.items()}
    if outs["graph"] != outs["eager"]:
        raise RuntimeError("11d: the decode graph's greedy tokens differ "
                           "from the eager step's")
    med = {m: float(np.median(v)) for m, v in times.items()}
    wins = sum(gm < em for em, gm in zip(times["eager"], times["graph"]))
    log(f"[11d decode graph] {cfg.name}, {LM_SLOTS} slots, cache "
        f"{LM_CACHE}: first graph step (warm-up + capture + replay) "
        f"{first['graph']:.1f} ms; {DECODE_PAIRS} pairs in turns: graph "
        f"median {med['graph']:.2f} ms per step = "
        f"{LM_SLOTS / med['graph'] * 1e3:.1f} tokens/s, eager median "
        f"{med['eager']:.2f} ms = {LM_SLOTS / med['eager'] * 1e3:.1f} "
        f"tokens/s; graph faster in {wins} of {DECODE_PAIRS}; "
        f"{len(outs['graph'][0])} greedy tokens per request equal | {card}")
    profile_line("11d", lambda: engines["graph"].step(), med["graph"], card,
                 what=f"one decode step replayed ({LM_SLOTS} slots)")
    del engines, reqs
    torch.cuda.empty_cache()


# -- phase 12: every LM architecture the reference configures ----------------

ARCH_RUNS = {                     # arch: (drawn prompts, long prompt)
    "qwen3-moe-30b-a3b": (8, 2000),
    "jamba-1.5-large-398b": (4, 2048),
    "xlstm-350m": (4, 1024),
}
JAMBA_CUT = (3, 4)                # 12b: positions of jamba's period of 8
# 12b premat A/B: the bf16 cut's logits, premat against chunked. The CPU
# test (tests/test_torch_mamba_premat.py) finds the fp32 forward bitwise;
# here the full-sequence x_proj product can take another cuBLAS kernel than
# the per-chunk ones, rounding bf16 differently: the bf16 kernels' gate
PREMAT_GATE = 2e-2
MUSICGEN_FRAMES = 1024


class BlockTimer:
    """Wraps module functions for the ``with`` block: each call's span on
    the card between two CUDA events (host gaps inside it included), summed
    by label in :meth:`ms`."""

    def __init__(self, targets):
        self.targets = targets            # (module, attribute, label)

    def __enter__(self):
        import torch
        self.events = {label: [] for _, _, label in self.targets}
        self.saved = []
        for mod, attr, label in self.targets:
            orig = getattr(mod, attr)
            self.saved.append((mod, attr, orig))

            def wrapped(*a, _orig=orig, _label=label, **kw):
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                out = _orig(*a, **kw)
                ev[1].record()
                self.events[_label].append(ev)
                return out
            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in self.saved:
            setattr(mod, attr, orig)
        return False

    def ms(self) -> dict:
        import torch
        torch.cuda.synchronize()
        return {label: sum(a.elapsed_time(b) for a, b in ev)
                for label, ev in self.events.items()}


def n_attn_layers(cfg) -> int:
    return sum(sb.repeat for sb in cfg.superblocks
               for kind, _ in sb.blocks if kind == "attn")


def free_card(label: str, need_gib: float) -> None:
    """Collect, empty the allocator's cache and check that what stays
    reserved leaves ``need_gib`` free."""
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    res = torch.cuda.memory_reserved() / 2**30
    alloc = torch.cuda.memory_allocated() / 2**30
    total = torch.cuda.get_device_properties(0).total_memory / 2**30
    log(f"[{label} memory] before the phase: reserved {res:.2f} GiB, "
        f"allocated {alloc:.2f} GiB of {total:.1f} GiB; the phase needs "
        f"~{need_gib:.0f} GiB")
    if res + need_gib > total:
        raise RuntimeError(f"{label}: {res:.2f} GiB still reserved, "
                           f"{need_gib:.0f} GiB needed of {total:.1f}")


def add_flash(results: dict, paths: dict, label: str, cfg, f_calls,
              launches: int, card: str) -> None:
    """Every recorded prefill launch of ``label``'s main path against the
    plain version (``check_flash``), logged by prompt length; its sums added
    to the kernel table's flash row and its lengths to the row's paths."""
    r = check_flash(f_calls)
    by_len, gflop = r.pop("by_len"), r.pop("gflop")
    log(f"[{label} flash] {cfg.name}: {len(f_calls)} prefill launches "
        f"within 2e-2 relative of the plain version (max|diff| "
        f"{r['max_abs_err']:.3e}); over the run kernel {r['ms']:.3f} ms, "
        f"plain {r['plain_ms']:.3f} ms, SDPA {r['library_ms']:.3f} ms, "
        f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}; {gflop:.1f} "
        f"GFLOP, {gflop / r['ms']:.2f} TFLOP/s) | {card}")
    for n, rr in sorted(by_len.items()):
        log(f"[{label} flash S={n}] per prefill ({rr['launches']} "
            f"launches): kernel {rr['ms'] * rr['launches']:.3f} ms, plain "
            f"{rr['plain_ms'] * rr['launches']:.3f} ms, SDPA "
            f"{rr['library_ms'] * rr['launches']:.3f} ms, bound "
            f"{rr['bound_ms'] * rr['launches']:.4f} ms ({rr['bound_by']}), "
            f"{rr['gflop'] / rr['ms']:.2f} TFLOP/s")
        paths["flash_attention"][f"{cfg.name} prefill S={n}"] = {
            "launches": rr["launches"],
            **{k: rr[k] * rr["launches"]
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")}}
    row = results["flash_attention"]
    row["launches"] += launches
    row["max_abs_err"] = max(row["max_abs_err"], r["max_abs_err"])
    for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
        row[k] += r[k]
    if r["bound_by"] == "operations":
        row["bound_by"] = "operations"


def arch_main_path(label: str, cfg, params, prompts, card: str,
                   results: dict, paths: dict) -> dict:
    """12a-c's main path (module doc) on an eager engine; returns the ms
    per prefill by prompt length."""
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.serve import Request, ServeEngine
    n_attn = n_attn_layers(cfg)
    reqs = [Request(prompt=p_, max_new=LM_MAX_NEW) for p_ in prompts]
    eng = ServeEngine(cfg, params, batch_slots=LM_SLOTS, cache_len=LM_CACHE,
                      cuda_graphs=False)
    for p_ in (prompts[0], prompts[-1]):      # warm-up, outside the counts
        tf.prefill(params, cfg, {"tokens": torch.as_tensor(p_[None],
                                                           device=DEV)},
                   LM_CACHE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with Recorder(names=("flash_attention",)) as rec:
        wall, counts, calls = lm_serve(eng, reqs, label)
    pre, dec = calls["prefill"], calls["decode"]
    others = {k_: v_ for k_, v_ in counts.items()
              if v_ and k_ != "flash_attention"}
    if others or counts["flash_attention"] != n_attn * len(reqs):
        raise RuntimeError(f"{label}: launches {counts}, expected "
                           f"{n_attn * len(reqs)} flash_attention only")
    bad = [c for c in pre if c[2] != n_attn] + [c for c in dec if c[2]]
    if bad or len(pre) != len(reqs):
        raise RuntimeError(f"{label}: per-call flash launches {bad} (want "
                           f"{n_attn} per prefill, 0 per decode step)")
    if not all(len(r.out) == LM_MAX_NEW and r.done
               and all(0 <= t < cfg.vocab for t in r.out) for r in reqs):
        raise RuntimeError(f"{label}: a request did not finish with "
                           f"{LM_MAX_NEW} tokens in the vocabulary")
    n_tok = sum(len(r.out) for r in reqs)
    dec_ms = [c[1] for c in dec]
    pre_ms = {n: ms for n, ms, _ in pre}
    kernels = (f"{n_attn} flash_attention per prefill, 0 per decode step"
               if n_attn else "no attention layer: no kernel launched")
    log(f"[{label} main path] {cfg.name}, eager ServeEngine(batch_slots="
        f"{LM_SLOTS}, cache_len={LM_CACHE}): {len(reqs)} requests, {n_tok} "
        f"tokens in {wall * 1e3:.1f} ms = {n_tok / wall:.1f} tokens/s; "
        f"launches {counts} ({kernels}, over {len(dec)} decode steps); "
        f"logits finite | {card} | peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    log(f"[{label} main path] ms per prefill by prompt length: "
        + ", ".join(f"{n}: {ms:.2f}" for n, ms in sorted(pre_ms.items())))
    log(f"[{label} main path] ms per eager decode step ({LM_SLOTS} slots): "
        f"median {float(np.median(dec_ms)):.2f}, first {dec_ms[0]:.2f}, min "
        f"{min(dec_ms):.2f}, max {max(dec_ms):.2f}")
    f_calls = rec.calls["flash_attention"]
    del rec, eng, reqs
    if f_calls:
        add_flash(results, paths, label, cfg, f_calls,
                  counts["flash_attention"], card)
    del f_calls
    torch.cuda.empty_cache()
    return pre_ms


def arch_graph_phase(label: str, cfg, params, prompts, card: str) -> None:
    """An engine with the decode graph and an eager one over the same
    weights and the first ``LM_SLOTS`` prompts, ``LM_MAX_NEW`` decode steps
    in turns (alternating order): greedy tokens, the step's logits after
    every step and every state leaf after the last, bitwise equal. The
    graph's first step (warm-up, capture with the recurrent state restored,
    replay) is left out of the medians."""
    import torch
    from repro_torch.serve import Request, ServeEngine
    engines, reqs, logits = {}, {}, {}
    for mode in ("eager", "graph"):
        eng = ServeEngine(cfg, params, batch_slots=LM_SLOTS,
                          cache_len=LM_CACHE, cuda_graphs=mode == "graph")
        reqs[mode] = [Request(prompt=p_, max_new=10 ** 6)
                      for p_ in prompts[:LM_SLOTS]]
        for r in reqs[mode]:
            eng.submit(r)
        store = logits[mode] = []

        def tapped(inner=eng._decode, store=store):
            lg, greedy = inner()
            store.append(lg.clone())
            return lg, greedy
        eng._decode = tapped
        engines[mode] = eng

    def step_ms(mode):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engines[mode].step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    times = {"eager": [], "graph": []}
    for i in range(LM_MAX_NEW):
        for mode in (("graph", "eager") if i % 2 == 0
                     else ("eager", "graph")):
            times[mode].append(step_ms(mode))
    outs = {mode: [r.out for r in rs] for mode, rs in reqs.items()}
    if outs["graph"] != outs["eager"]:
        raise RuntimeError(f"{label}: the decode graph's greedy tokens "
                           "differ from the eager step's")
    diff = [i for i, (a, b) in enumerate(zip(logits["graph"],
                                             logits["eager"]))
            if not torch.equal(a, b)]
    leaves = [(a, b) for sb in engines["graph"].state
              for bk in engines["graph"].state[sb]
              for a, b in zip(engines["graph"].state[sb][bk].values(),
                              engines["eager"].state[sb][bk].values())]
    if diff or not all(torch.equal(a, b) for a, b in leaves):
        raise RuntimeError(f"{label}: graph logits differ from the eager "
                           f"step's at steps {diff}, or a state leaf does")
    med = {m: float(np.median(v[1:])) for m, v in times.items()}
    wins = sum(g < e for e, g in zip(times["eager"][1:], times["graph"][1:]))
    log(f"[{label} decode graph] {cfg.name}, {LM_SLOTS} slots, cache "
        f"{LM_CACHE}: first graph step (warm-up + capture + restore + "
        f"replay) {times['graph'][0]:.1f} ms; {LM_MAX_NEW - 1} steps in "
        f"turns: graph median {med['graph']:.2f} ms per step = "
        f"{LM_SLOTS / med['graph'] * 1e3:.1f} tokens/s, eager median "
        f"{med['eager']:.2f} ms = {LM_SLOTS / med['eager'] * 1e3:.1f} "
        f"tokens/s; graph faster in {wins} of {LM_MAX_NEW - 1}; greedy "
        f"tokens and logits of all {LM_MAX_NEW} steps bitwise equal, and "
        f"all {len(leaves)} state leaves after them | {card}")
    profile_line(label, lambda: engines["graph"].step(), med["graph"], card,
                 what=f"one decode step replayed ({LM_SLOTS} slots)")
    del engines, reqs, logits, leaves
    torch.cuda.empty_cache()


def premat_ab(cfg, params, prompt, card: str) -> None:
    """12b's A/B of ``REPRO_MAMBA_PREMAT=1`` (the whole sequence
    discretised up front: ``dA`` and ``dBx`` ``[1, S, d_inner, d_state]``
    fp32, 2 GiB each at S 2,048) against the chunked default: one prefill
    of each warmed, then timed in turns (default, premat, premat, default)
    with the peak memory above what was allocated before it; the premat
    logits within ``PREMAT_GATE`` of max|logits| of the default's. The
    variable is restored afterwards."""
    import os
    import torch
    from repro_torch.models import transformer as tf
    tok = torch.as_tensor(prompt[None], device=DEV)
    saved = os.environ.get("REPRO_MAMBA_PREMAT")
    ms, peak, logits = {}, {}, {}
    try:
        for mode in ("default", "premat", "premat", "default"):
            if mode == "premat":
                os.environ["REPRO_MAMBA_PREMAT"] = "1"
            else:
                os.environ.pop("REPRO_MAMBA_PREMAT", None)
            if mode not in logits:              # warm-up, then the timed one
                tf.prefill(params, cfg, {"tokens": tok}, LM_CACHE)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            lg, _ = tf.prefill(params, cfg, {"tokens": tok}, LM_CACHE)
            torch.cuda.synchronize()
            ms.setdefault(mode, []).append((time.perf_counter() - t0) * 1e3)
            peak.setdefault(mode, []).append(
                (torch.cuda.max_memory_allocated() - base) / 2**30)
            logits.setdefault(mode, lg.float())
            del lg
    finally:
        if saved is None:
            os.environ.pop("REPRO_MAMBA_PREMAT", None)
        else:
            os.environ["REPRO_MAMBA_PREMAT"] = saved
    a, b = logits["default"], logits["premat"]
    d = float((b - a).abs().max())
    scale = float(a.abs().max())
    if not (bool(torch.isfinite(b).all()) and d <= PREMAT_GATE * scale):
        raise RuntimeError(f"12b premat: logits max|diff| {d:.3e} > "
                           f"{PREMAT_GATE} x {scale:.3e}")
    log(f"[12b premat] REPRO_MAMBA_PREMAT=1 against the chunked default, "
        f"one {len(prompt)}-token prefill each, in turns: default "
        + " / ".join(f"{x:.1f}" for x in ms["default"]) + " ms, premat "
        + " / ".join(f"{x:.1f}" for x in ms["premat"]) + " ms; peak above "
        f"the allocated base default {max(peak['default']):.2f} GiB, premat "
        f"{max(peak['premat']):.2f} GiB; logits max|diff| {d:.3e} = "
        f"{d / scale:.2e} of max|logits| (gate {PREMAT_GATE}; "
        f"{'bitwise' if torch.equal(a, b) else 'not bitwise'}) | {card}")


def arch_phases(results: dict, paths: dict, card: str, tick) -> None:
    """Phase 12 (module doc): qwen3-moe, jamba cut to two sub-layers,
    xlstm and musicgen on the card, weights random from seed 0; ``tick``
    (a ``PhaseClock``) after each."""
    import torch
    from repro_torch import configs
    from repro_torch.configs import jamba_1_5_large_398b as jamba
    from repro_torch.models import mamba, xlstm
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import SuperBlock

    def drawn(cfg, n_drawn, n_long):
        rng = np.random.default_rng(0)
        ps = [rng.integers(0, cfg.vocab, (int(rng.integers(4, 48)),))
              .astype(np.int32) for _ in range(n_drawn)]
        return ps + [rng.integers(0, cfg.vocab, (n_long,)).astype(np.int32)]

    def build(label, cfg, note=""):
        t0 = time.perf_counter()
        params = tf.init_params(cfg, 0, device=DEV)[0]
        torch.cuda.synchronize()
        n = sum(t.numel() for t in _leaves(params))
        blocks = [f"{sb.repeat} x {[f'{k}+{f}' for k, f in sb.blocks]}"
                  for sb in cfg.superblocks]
        log(f"[{label} inputs] {cfg.name}{note}: {cfg.n_layers} sub-layers "
            f"{blocks}, d_model {cfg.d_model}, {cfg.n_heads} heads (kv "
            f"{cfg.n_kv}, head dim {cfg.head_dim}), experts {cfg.n_experts} "
            f"top-{cfg.top_k} (d_ff {cfg.d_ff_expert}), d_ff {cfg.d_ff}, "
            f"vocab {cfg.vocab}, {cfg.dtype}; {n / 1e9:.2f} B random "
            f"parameters from seed 0 on the card in "
            f"{time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
        return params

    def long_prefill(label, cfg, params, prompt, targets, kernel=None):
        tok = torch.as_tensor(prompt[None], device=DEV)
        tf.prefill(params, cfg, {"tokens": tok}, LM_CACHE)
        torch.cuda.synchronize()
        with BlockTimer(targets) as bt:
            t0 = time.perf_counter()
            tf.prefill(params, cfg, {"tokens": tok}, LM_CACHE)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        spans = bt.ms()
        log(f"[{label} prefill blocks] one {len(prompt)}-token prefill "
            f"{ms:.1f} ms; spans on the card (CUDA events around each "
            f"call, summed over layers): "
            + ", ".join(f"{k} {v:.1f} ms ({v / ms:.1%})"
                        for k, v in spans.items()) + f" | {card}")
        dev_ms = profile_line(label, lambda: tf.prefill(
            params, cfg, {"tokens": tok}, LM_CACHE), ms, card,
            what=f"one {len(prompt)}-token prefill")
        if kernel and dev_ms:
            own = sum(v for k, v in dev_ms.items() if kernel[1] in k)
            log(f"[{label} profile] {kernel[0]} ({kernel[1]} kernels) "
                f"{own:.2f} ms of the device's {sum(dev_ms.values()):.2f} "
                f"ms busy ({own / sum(dev_ms.values()):.1%})")

    # -- 12a. qwen3-moe-30b-a3b, full width and depth --------------------------
    cfg = configs.get_config("qwen3-moe-30b-a3b")
    free_card("12a", 68)
    params = build("12a", cfg)
    prompts = drawn(cfg, *ARCH_RUNS[cfg.name])
    pre_ms = arch_main_path("12a", cfg, params, prompts, card, results,
                            paths)
    arch_graph_phase("12a", cfg, params, prompts, card)
    tok = torch.as_tensor(prompts[-1][None], device=DEV)
    lk, _ = tf.prefill(params, cfg, {"tokens": tok}, LM_CACHE)
    lp, _ = tf.prefill(params, cfg, {"tokens": tok}, LM_CACHE,
                       backend="torch")
    log(f"[12a plain path] {len(prompts[-1])}-token prefill on the plain "
        f"path (backend=\"torch\", bf16; an fp32 copy does not fit): "
        f"relative L2 of the kernel path's logits from it "
        f"{rel_l2({0: lk.float()}, {0: lp.float()}):.3e}, max|diff| / "
        f"max|logits| {rel_max(lk.float(), lp.float()):.3e}, argmax "
        f"{'equal' if int(lk.argmax()) == int(lp.argmax()) else 'differs'} "
        f"(not gated: the per-launch checks carry the kernel); kernel path "
        f"prefill {pre_ms[len(prompts[-1])]:.1f} ms | {card}")
    del params, lk, lp, tok
    tick("12a qwen3-moe-30b-a3b")

    # -- 12b. jamba-1.5-large at full width, two sub-layers --------------------
    full = configs.get_config("jamba-1.5-large-398b")
    period = jamba._blocks()
    cfg = dataclasses.replace(full, name=f"{full.name} (2 sub-layers)",
                              superblocks=(SuperBlock(blocks=tuple(
                                  period[i] for i in JAMBA_CUT), repeat=1),))
    free_card("12b", 30)
    params = build("12b", cfg, note=f" cut to period positions {JAMBA_CUT} "
                   f"{[period[i] for i in JAMBA_CUT]}, repeat 1 (2 of "
                   f"{full.n_layers} sub-layers)")
    prompts = drawn(cfg, *ARCH_RUNS[full.name])
    arch_main_path("12b", cfg, params, prompts, card, results, paths)
    arch_graph_phase("12b", cfg, params, prompts, card)
    long_prefill("12b", cfg, params, prompts[-1],
                 [(mamba, "mamba_fwd", "Mamba block"),
                  (mamba, "_scan", "Mamba scan")],
                 kernel=("the Mamba scan's recurrence", "addcmul"))
    premat_ab(cfg, params, prompts[-1], card)
    del params
    tick("12b jamba-1.5-large, two sub-layers")

    # -- 12c. xlstm-350m, full width and depth ----------------------------------
    cfg = configs.get_config("xlstm-350m")
    free_card("12c", 4)
    params = build("12c", cfg)
    prompts = drawn(cfg, *ARCH_RUNS[cfg.name])
    arch_main_path("12c", cfg, params, prompts, card, results, paths)
    arch_graph_phase("12c", cfg, params, prompts, card)
    long_prefill("12c", cfg, params, prompts[-1],
                 [(xlstm, "mlstm_fwd", "mLSTM blocks"),
                  (xlstm, "slstm_fwd", "sLSTM blocks")])
    del params
    tick("12c xlstm-350m")

    # -- 12d. musicgen-medium on frame embeddings --------------------------------
    from repro_torch.kernels import launch_counts, reset_launch_counts
    cfg = configs.get_config("musicgen-medium")
    free_card("12d", 8)
    params = build("12d", cfg)
    gen = torch.Generator(device=DEV).manual_seed(1)
    frames = torch.randn((1, MUSICGEN_FRAMES, cfg.d_model), generator=gen,
                         device=DEV)
    steps = [torch.randn((1, 1, cfg.d_model), generator=gen, device=DEV)
             for _ in range(LM_MAX_NEW)]
    cache = MUSICGEN_FRAMES + LM_MAX_NEW

    def run(backend):
        """Prefill on the frames, then one decode step per step embedding:
        the logit rows [1 + steps, vocab] fp32, prefill ms, step ms."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, st = tf.prefill(params, cfg, {"embeds": frames}, cache,
                            backend=backend)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        rows, s_ms = [lg[0, -1].float()], []
        for i, e in enumerate(steps):
            t0 = time.perf_counter()
            lg, st = tf.decode_step(params, cfg, st, {"embeds": e},
                                    MUSICGEN_FRAMES + i)
            torch.cuda.synchronize()
            s_ms.append((time.perf_counter() - t0) * 1e3)
            rows.append(lg[0, -1].float())
        return torch.stack(rows), p_ms, s_ms

    tf.prefill(params, cfg, {"embeds": frames[:, :64]}, cache)   # warm-up
    reset_launch_counts()
    with Recorder(names=("flash_attention",)) as rec:
        rows, p_ms, s_ms = run("auto")
    counts = launch_counts()
    n_attn = n_attn_layers(cfg)
    others = {k_: v_ for k_, v_ in counts.items()
              if v_ and k_ != "flash_attention"}
    if others or counts["flash_attention"] != n_attn:
        raise RuntimeError(f"12d: launches {counts}, expected {n_attn} "
                           "flash_attention (the prefill's) only")
    if not (tuple(rows.shape) == (LM_MAX_NEW + 1, cfg.vocab)
            and bool(torch.isfinite(rows).all())):
        raise RuntimeError("12d: logits not finite or of the wrong shape")
    log(f"[12d main path] {cfg.name} on frame embeddings: prefill of "
        f"{MUSICGEN_FRAMES} frames {p_ms:.1f} ms, then {LM_MAX_NEW} decode "
        f"steps fed with embeddings, median {float(np.median(s_ms)):.2f} ms "
        f"per step (first {s_ms[0]:.2f}); launches {counts} ({n_attn} "
        f"flash_attention in the prefill, 0 per decode step); logits finite "
        f"| {card}")
    f_calls = rec.calls["flash_attention"]
    del rec
    add_flash(results, paths, "12d", cfg, f_calls, counts["flash_attention"],
              card)
    del f_calls
    reset_launch_counts()
    rows_p, pp_ms, _ = run("torch")
    if any(launch_counts().values()):
        raise RuntimeError(f"12d: the plain path launched kernels: "
                           f"{launch_counts()}")
    log(f"[12d plain path] the same frames and step embeddings on the "
        f"plain path (backend=\"torch\"): relative L2 over the "
        f"{len(rows)} logit rows {rel_l2({0: rows}, {0: rows_p}):.3e}, "
        f"prefill row {rel_l2({0: rows[:1]}, {0: rows_p[:1]}):.3e}; argmax "
        f"agreement {int((rows.argmax(-1) == rows_p.argmax(-1)).sum())}/"
        f"{len(rows)} (not gated); plain prefill {pp_ms:.1f} ms | {card}")
    del params, frames, steps, rows, rows_p
    torch.cuda.empty_cache()


# -- phase 13: LM training ------------------------------------------------------
TRAIN_LM_LAYERS = 16              # 13b: yi-9b's depth cut (of 48): one card
TRAIN_LM_SEQ, TRAIN_LM_BATCH, TRAIN_LM_STEPS = 2048, 4, 8
TRAIN_CUT_LAYERS, TRAIN_CUT_SEQ = 2, 512   # 13b's gradient gate, 13c
TRAIN_ARCHS = ("qwen3-moe-30b-a3b", "kimi-k2-1t-a32b", "jamba-1.5-large-398b",
               "xlstm-350m", "gemma-7b", "mistral-nemo-12b", "internlm2-20b",
               "pixtral-12b")
BWD_FP32_GATE = 1e-5              # the backward's fp32 float64 gate
# 13a: (label, B, Sq, Skv, H, KV, D, dtype): the path's own shape first;
# "edge": Sq < Skv, neither a multiple of the bf16 kernels' 64-row tiles
# (a key tile across the diagonal at offset 70)
BWD_SHAPES = (("path", 4, 2048, 2048, 32, 4, 128, "bfloat16"),
              ("D64", 1, 2048, 2048, 16, 4, 64, "bfloat16"),
              ("D256", 1, 1024, 1024, 8, 2, 256, "bfloat16"),
              ("fp32", 1, 1024, 1024, 8, 2, 128, "float32"),
              ("ragged", 2, 1000, 1000, 8, 2, 128, "bfloat16"),
              ("edge", 2, 130, 200, 8, 2, 128, "bfloat16"))


def bwd_bound(q, k, causal: bool) -> tuple:
    """(bound ms, operations, basis) of one attention backward: q, k, v,
    the output and its gradient read once, the row log-sum-exp read once,
    dq, dk, dv written once, over the HBM rate; 2.5x the forward's
    operations (five products of its size against its two: S recomputed,
    dP, dV, dQ, dK) over the tensor-core bf16 or the CUDA-core fp32
    peak, counted over the (query, key) pairs the causal mask keeps."""
    import torch
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    es = q.element_size()
    nbytes = es * (3 * q.numel() + 2 * k.numel()) + 4 * B * H * Sq \
        + es * (q.numel() + 2 * k.numel())
    pairs = (sum(min(Skv, r + Skv - Sq + 1) for r in range(Sq)) if causal
             else Sq * Skv)
    ops = 2.5 * 4.0 * B * H * pairs * D
    peak = PEAK_BF16_PER_S if q.dtype == torch.bfloat16 else PEAK_FP32_PER_S
    tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, ops / peak * 1e3
    return (tb, ops, "bytes") if tb >= to else (to, ops, "operations")


def wgmma_check(card: str) -> None:
    """Phase 2b: the wgmma helpers that the bf16 backward is built on
    (``csrc/tensor_core.cuh``, ``csrc/tma.cuh``), on their own: a, b, v
    bf16 [64, D] loaded by the backward's TMA maps, x = a . b^T from shared
    memory (K-major, as S and dP) against ``torch.matmul`` in fp32, and
    y = bf16(x) . v with the A operand from registers and v MN-major (as
    dQ, dK, dV) against ``torch.matmul`` of the kernel's own x rounded to
    bf16; both within 1e-5 of max|ref| (fp32 sums of exact bf16 products
    in another order)."""
    import torch
    from repro_torch.kernels.flash_attention import (WGMMA_HEAD_DIMS,
                                                     wgmma_check as launch)
    g = torch.Generator(device=DEV).manual_seed(25)
    for D in WGMMA_HEAD_DIMS:
        a, b, v = (torch.randn((64, D), generator=g, device=DEV)
                   .to(torch.bfloat16) for _ in range(3))
        x, y = launch(a, b, v)
        torch.cuda.synchronize()
        xr = torch.matmul(a.float(), b.float().T)
        yr = torch.matmul(x.to(torch.bfloat16).float(), v.float())
        errs = []
        for name, got, ref in (("x", x, xr), ("y", y, yr)):
            d = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            if not (bool(torch.isfinite(got).all()) and d <= 1e-5 * scale):
                raise RuntimeError(f"2b wgmma D={D} {name}: max|diff| {d:.3e}"
                                   f" > 1e-5 x {scale:.3e}")
            errs.append(d / scale)
        log(f"[2b wgmma D={D}] x = a.b^T (both K-major in shared memory) "
            f"and y = bf16(x).v (A from registers, v MN-major) equal "
            f"torch.matmul within {errs[0]:.1e} / {errs[1]:.1e} of max|ref| "
            f"| {card}")


def bwd_f64(q, k, v, out, do, causal: bool):
    """The plain backward in float64 on the card, one batch element at a
    time (its [KV, G, Sq, Skv] scores in float64 stay near 1 GiB)."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_bwd_torch
    parts = [flash_attention_bwd_torch(*(t[b:b + 1].double() for t in
                                         (q, k, v, out, do)),
                                       causal=causal, scale=1.0)
             for b in range(q.shape[0])]
    return [torch.cat([p[i] for p in parts]) for i in range(3)]


def check_bwd_launch(a, kw, what: str) -> float:
    """One recorded backward launch against the float64 plain backward
    (bf16 within the forward's 2e-2 relative, fp32 within
    ``BWD_FP32_GATE`` relative) and against a second launch (bitwise);
    returns the worst max|diff| / max|ref|."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    q, k, v, out, do, lse = a
    got = flash_attention_bwd(q, k, v, out, do, lse, **kw)
    again = flash_attention_bwd(q, k, v, out, do, lse, **kw)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise RuntimeError(f"{what}: two backward launches differ")
    want = bwd_f64(q, k, v, out, do, kw["causal"])
    gate = 2e-2 if q.dtype == torch.bfloat16 else BWD_FP32_GATE
    worst = 0.0
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        d = float((x.double() - y).abs().max())
        scale = max(float(y.abs().max()), 1e-30)
        if not (bool(torch.isfinite(x).all()) and d <= gate * scale):
            raise RuntimeError(f"{what} {name}: max|diff| {d:.3e} > "
                               f"{gate} x {scale:.3e}")
        worst = max(worst, d / scale)
    return worst


def sdpa_bwd_call(q, k, v, do, causal: bool):
    """The backward of ``scaled_dot_product_attention`` (``enable_gqa``) on
    the same tensors: one forward recorded, the backward replayed (the
    library yardstick, timed here and never called by the port)."""
    import torch
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    with torch.enable_grad():
        o = sdpa_call(qs, ks, vs, causal, 1.0)()
    dot = do.transpose(1, 2)
    return lambda: torch.autograd.grad(o, (qs, ks, vs), dot,
                                       retain_graph=True)


def time_bwd(q, k, v, out, do, lse, causal: bool) -> dict:
    """Kernel, plain version and SDPA-backward ms of one backward, and its
    bound."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_bwd_torch)
    b, ops, by = bwd_bound(q, k, causal)
    kw = dict(causal=causal, scale=1.0)
    return dict(
        ms=cuda_ms(lambda: flash_attention_bwd(q, k, v, out, do, lse, **kw),
                   5),
        plain_ms=cuda_ms(lambda: flash_attention_bwd_torch(q, k, v, out, do,
                                                           **kw), 2),
        library_ms=cuda_ms(sdpa_bwd_call(q, k, v, do, causal), 5),
        bound_ms=b, bound_by=by, gflop=ops / 1e9)


def grads_of(params, cfg, batch, backend: str) -> dict:
    """One loss → gradient through the training step's per-layer leaves
    (``train.loop.step_leaves``), no update: {leaf path: gradient, a
    stacked leaf's layers stacked back}."""
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.train.loop import step_leaves
    tree, entries = step_leaves(params)
    flat = [x for _, leaf in entries
            for x in (leaf if isinstance(leaf, tuple) else (leaf,))]
    with torch.enable_grad():
        loss = tf.loss_fn(tree, cfg, batch, remat=True, backend=backend)
        g = torch.autograd.grad(loss, flat, allow_unused=True,
                                materialize_grads=True)
    out, at = {}, 0
    for path, leaf in entries:
        n = len(leaf) if isinstance(leaf, tuple) else 1
        out["/".join(path)] = (torch.stack(g[at:at + n])
                               if isinstance(leaf, tuple) else g[at])
        at += n
    return out


# the op behind a leaf whose gradient differs between two identical runs
NONDETERMINISTIC_OP = {
    "embed": "the embedding gather's backward (index_put_ with accumulate: "
             "atomic adds into the [vocab, d_model] gradient)"}


def lm_train_phases(results: dict, paths: dict, card: str, tick) -> None:
    """Phase 13 (module doc): the attention backward kernels against their
    plain version (13a), yi-9b training at full width with the depth cut
    to ``TRAIN_LM_LAYERS`` (13b), the rest of the loop on a 2-layer cut
    (13c), the launcher and one step of every token architecture (13d);
    fills the kernel table's ``flash_attention_bwd`` row and adds the
    training forward launches to the flash row."""
    import tempfile
    import torch
    from repro_torch import configs
    from repro_torch.data.tokens import DataConfig, batch_at, stream
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_torch)
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import SuperBlock
    from repro_torch.train import (AdamWConfig, TrainConfig, init_opt_state,
                                   make_train_step, train)

    # -- 13a. the backward kernels against the plain version ------------------
    free_card("13a", 30)
    row = dict(launches=0, max_abs_err=0.0)
    for label, B, S, Skv, H, KV, D, dt in BWD_SHAPES:
        dtype = getattr(torch, dt)
        g = torch.Generator(device=DEV).manual_seed(13)
        q = (torch.randn((B, S, H, D), generator=g, device=DEV)
             / D ** 0.5).to(dtype)
        k, v = (torch.randn((B, Skv, KV, D), generator=g, device=DEV)
                .to(dtype) for _ in range(2))
        do = torch.randn((B, S, H, D), generator=g, device=DEV).to(dtype)
        out, lse = flash_attention(q, k, v, causal=True, scale=1.0,
                                   return_lse=True)
        if not torch.equal(out, flash_attention(q, k, v, causal=True,
                                                scale=1.0)):
            raise RuntimeError(f"13a {label}: the forward's output changed "
                               "with the lse buffer")
        worst = check_bwd_launch((q, k, v, out, do, lse),
                                 dict(causal=True, scale=1.0),
                                 f"13a {label}")
        r = time_bwd(q, k, v, out, do, lse, True)
        log(f"[13a bwd {label}] B={B} Sq={S} Skv={Skv} H={H} KV={KV} D={D} "
            f"{dt} causal:"
            f" dq/dk/dv within "
            f"{'2e-2' if dtype == torch.bfloat16 else BWD_FP32_GATE} of "
            f"max|ref| against the float64 plain backward (worst "
            f"{worst:.3e} of max|ref|), two launches bitwise equal; kernel "
            f"{r['ms']:.3f} ms ({r['gflop'] / r['ms']:.1f} TFLOP/s of the "
            f"bound's {r['gflop']:.1f} GFLOP), bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']}), plain {r['plain_ms']:.3f} ms, SDPA backward "
            f"{r['library_ms']:.3f} ms | {card}")
        if label == "path":
            path_r = r
        row["max_abs_err"] = max(row["max_abs_err"], worst)
        del q, k, v, do, out, lse
    torch.cuda.empty_cache()
    tick("13a attention backward kernels")

    # -- 13b. yi-9b at full width, 16 of 48 layers -----------------------------
    full = configs.get_config("yi-9b")
    cfg = dataclasses.replace(
        full, name=f"yi-9b ({TRAIN_LM_LAYERS} of {full.n_layers} layers)",
        superblocks=(SuperBlock(blocks=(("attn", "dense"),),
                                repeat=TRAIN_LM_LAYERS),))
    free_card("13b", 60)
    t0 = time.perf_counter()
    params = tf.init_params(cfg, 0, device=DEV)[0]
    opt = init_opt_state(params, AdamWConfig())
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(params))
    log(f"[13b inputs] {cfg.name}: d_model {cfg.d_model}, {cfg.n_heads} "
        f"heads (kv {cfg.n_kv}, head dim {cfg.head_dim}), d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}, {cfg.dtype}; {n_par / 1e9:.3f} B random "
        f"parameters from seed 0 and fp32 AdamW moments on the card in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated; depth "
        f"cut from {full.n_layers} (all 48 layers' state, 106 GB, does not "
        f"fit one card)")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_LM_SEQ,
                      global_batch=TRAIN_LM_BATCH, seed=0)
    tcfg = TrainConfig(remat=True, log_every=1, ckpt_every=10**9)
    step = make_train_step(cfg, tcfg)
    batches = [batch_at(dcfg, i) for i in range(TRAIN_LM_STEPS + 2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    ms, losses = [], []
    for i in range(TRAIN_LM_STEPS):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batches[i])
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {k_: 0 for k_ in counts}
    want.update(flash_attention=2 * TRAIN_LM_LAYERS * TRAIN_LM_STEPS,
                flash_attention_bwd=TRAIN_LM_LAYERS * TRAIN_LM_STEPS)
    if counts != want:
        raise RuntimeError(f"13b: launches {counts}, expected {want}")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"13b: non-finite losses {losses}")
    steady = float(np.median(ms[1:]))
    tokens = TRAIN_LM_SEQ * TRAIN_LM_BATCH
    log(f"[13b train] {cfg.name}, seq {TRAIN_LM_SEQ} x batch "
        f"{TRAIN_LM_BATCH}, remat, AdamW defaults: {TRAIN_LM_STEPS} steps, "
        f"ms per step " + ", ".join(f"{x:.1f}" for x in ms)
        + f"; median of steps 2-{TRAIN_LM_STEPS} {steady:.1f} ms = "
        f"{tokens / steady * 1e3:.0f} tokens/s; loss per step "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f"; launches {counts} (per step {2 * TRAIN_LM_LAYERS} flash "
        f"forward = {TRAIN_LM_LAYERS} + {TRAIN_LM_LAYERS} recomputed, "
        f"{TRAIN_LM_LAYERS} backward) | peak mem {peak:.1f} GiB | {card}")
    dev_ms = profile_line("13b", lambda: step(params, opt,
                                              batches[TRAIN_LM_STEPS]),
                          steady, card, what="one training step")
    if dev_ms:
        kinds = {"GEMMs (cuBLAS)": ("nvjet", "gemm", "cutlass", "sm90"),
                 "flash backward": ("bwd_dq", "bwd_dkdv"),
                 "flash forward": ("flash_mma", "flash_attention_kernel")}
        by = {k_: sum(v_ for n_, v_ in dev_ms.items()
                      if any(t_ in n_ for t_ in kinds[k_])) for k_ in kinds}
        by["elementwise, copies, reductions"] = sum(dev_ms.values()) \
            - sum(by.values())
        log("[13b profile] device ms by kind: " + "; ".join(
            f"{k_} {v_:.1f} ({v_ / sum(dev_ms.values()):.1%})"
            for k_, v_ in by.items()))
    with Recorder(names=("flash_attention", "flash_attention_bwd")) as rec:
        step(params, opt, batches[TRAIN_LM_STEPS + 1])
        torch.cuda.synchronize()
    f_calls, b_calls = (rec.calls["flash_attention"],
                        rec.calls["flash_attention_bwd"])
    del rec
    if len(f_calls) != 2 * TRAIN_LM_LAYERS or len(b_calls) != \
            TRAIN_LM_LAYERS:
        raise RuntimeError(f"13b: recorded {len(f_calls)} forward and "
                           f"{len(b_calls)} backward launches in one step")
    f_err = 0.0
    for i, (a, kw) in enumerate(f_calls):
        q, k, v = a
        got, lse = flash_attention(q, k, v, **kw)
        ref = flash_attention_torch(q, k, v, causal=True, scale=1.0)
        f_err = max(f_err, attention_close(got, ref, f"13b forward {i}"))
        B, Sq, H, D = q.shape
        # the reference in float64: at random init yi-9b's scores are in
        # the thousands, where an fp32 logsumexp is itself a few ulp off
        s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()
                         .repeat_interleave(H // k.shape[2], 2))
        s = s.masked_fill(torch.ones((Sq, Sq), dtype=torch.bool, device=DEV)
                          .tril().logical_not(), float("-inf"))
        d = float((lse.double() - torch.logsumexp(s, -1)).abs().max())
        if not d <= 1e-3:
            raise RuntimeError(f"13b forward {i}: lse max|diff| {d}")
        del got, ref, s
    b_err = max(check_bwd_launch(a, kw, f"13b backward {i}")
                for i, (a, kw) in enumerate(b_calls))
    log(f"[13b flash] one step's {len(f_calls)} forward launches within 2e-2"
        f" relative of the plain version (max|diff| {f_err:.3e}, lse within"
        f" 1e-3) and its {len(b_calls)} backward launches within 2e-2 of "
        f"the float64 plain backward (worst {b_err:.3e} of max|ref|), each "
        f"run twice bitwise")
    fwd_ms = cuda_ms(lambda: flash_attention(*f_calls[0][0], **f_calls[0][1]),
                     5)
    fwd_r = time_attention(*f_calls[0][0], dict(causal=True, scale=1.0))
    del f_calls, b_calls
    row.update(launches=counts["flash_attention_bwd"],
               max_abs_err=max(row["max_abs_err"], b_err),
               **{k_: path_r[k_] * TRAIN_LM_LAYERS for k_ in
                  ("ms", "plain_ms", "library_ms", "bound_ms")},
               bound_by=path_r["bound_by"])
    results["flash_attention_bwd"] = row
    paths["flash_attention_bwd"] = {f"{cfg.name} train step": dict(
        launches=TRAIN_LM_LAYERS, **{k_: row[k_] for k_ in
                                     ("ms", "plain_ms", "library_ms",
                                      "bound_ms")})}
    flash = results["flash_attention"]
    flash["launches"] += counts["flash_attention"]
    flash["max_abs_err"] = max(flash["max_abs_err"], f_err)
    for k_ in ("ms", "plain_ms", "library_ms", "bound_ms"):
        flash[k_] += fwd_r[k_] * counts["flash_attention"]
    paths["flash_attention"][f"{cfg.name} train step"] = dict(
        launches=2 * TRAIN_LM_LAYERS, ms_with_lse=fwd_ms * 2 * TRAIN_LM_LAYERS,
        **{k_: fwd_r[k_] * 2 * TRAIN_LM_LAYERS for k_ in
           ("ms", "plain_ms", "library_ms", "bound_ms")})
    log(f"[13b flash] per step: backward {row['ms']:.2f} ms over "
        f"{TRAIN_LM_LAYERS} launches (bound {row['bound_ms']:.2f}, SDPA "
        f"backward {row['library_ms']:.2f}), {row['ms'] / steady:.1%} of "
        f"the step; forward with the lse "
        f"{fwd_ms * 2 * TRAIN_LM_LAYERS:.2f} ms over {2 * TRAIN_LM_LAYERS} "
        f"launches; of a {steady:.1f} ms step | {card}")
    del params, opt, step, batches
    tick("13b yi-9b training, 16 layers")

    # -- 13b/13c. a 2-layer, 512-token cut of the same width ------------------
    cut = dataclasses.replace(
        cfg, name=f"yi-9b ({TRAIN_CUT_LAYERS} layers)",
        superblocks=(SuperBlock(blocks=(("attn", "dense"),),
                                repeat=TRAIN_CUT_LAYERS),))
    free_card("13c", 30)
    p0 = tf.init_params(cut, 0, device=DEV)[0]
    cb = batch_at(DataConfig(vocab=cut.vocab, seq_len=TRAIN_CUT_SEQ,
                             global_batch=TRAIN_LM_BATCH, seed=1), 0)
    gk = grads_of(p0, cut, cb, "auto")
    reset_launch_counts()
    gp = grads_of(p0, cut, cb, "torch")
    if any(launch_counts().values()):
        raise RuntimeError(f"13b: the plain path launched {launch_counts()}")
    cut32 = dataclasses.replace(cut, dtype="float32")
    g32 = grads_of({k_: (v_.float() if torch.is_tensor(v_) else
                         {b_: {n_: t_.float() for n_, t_ in d_.items()}
                          for b_, d_ in v_.items()})
                    for k_, v_ in p0.items()}, cut32, cb, "torch")
    d_plain = rel_l2({k_: v_.float() for k_, v_ in gk.items()},
                     {k_: v_.float() for k_, v_ in gp.items()})
    d_own = rel_l2({k_: v_.float() for k_, v_ in gp.items()}, g32)
    d_k32 = rel_l2({k_: v_.float() for k_, v_ in gk.items()}, g32)
    k_w, worst = worst_tensor({k_: v_.float() for k_, v_ in gk.items()},
                              {k_: v_.float() for k_, v_ in gp.items()})
    if not (all(bool(torch.isfinite(x).all()) for x in gk.values())
            and d_plain <= d_own):
        raise RuntimeError(f"13b: kernel vs plain gradients {d_plain:.3e} "
                           f"relative L2 > the plain bf16 path's own "
                           f"distance from fp32 {d_own:.3e}")
    log(f"[13b grads] step-0 gradients of {cut.name}, seq {TRAIN_CUT_SEQ} x"
        f" {TRAIN_LM_BATCH}, kernel path vs plain path (backend=\"torch\", "
        f"bf16): relative L2 over all leaves {d_plain:.3e} <= {d_own:.3e} = "
        f"the plain bf16 path's own distance from the same weights in fp32;"
        f" the kernel path's distance from fp32 {d_k32:.3e}; worst leaf "
        f"{k_w} max|diff|/max|g| {worst:.2e} | {card}")
    del gp
    # fp32: the same weights through the fp32 kernels against the plain
    # path, gated by the plain path's own movement under a 1e-6 weight
    # perturbation (and 1e-4 at least)
    p32 = {k_: (v_.float() if torch.is_tensor(v_) else
                {b_: {n_: t_.float() for n_, t_ in d_.items()}
                 for b_, d_ in v_.items()}) for k_, v_ in p0.items()}
    gk32 = grads_of(p32, cut32, cb, "auto")
    gen = torch.Generator(device=DEV).manual_seed(5)
    moved = {k_: (v_ * (1 + 1e-6 * torch.randn(v_.shape, generator=gen,
                                                 device=DEV))
                  if torch.is_tensor(v_) else
                  {b_: {n_: t_ * (1 + 1e-6 * torch.randn(
                      t_.shape, generator=gen, device=DEV))
                      for n_, t_ in d_.items()} for b_, d_ in v_.items()})
             for k_, v_ in p32.items()}
    gm32 = grads_of(moved, cut32, cb, "torch")
    d32, d32_self = rel_l2(gk32, g32), rel_l2(gm32, g32)
    k32, w32 = worst_tensor(gk32, g32)
    if not d32 <= max(1e-4, d32_self):
        raise RuntimeError(f"13b: fp32 kernel vs plain gradients {d32:.3e} "
                           f"relative L2 > max(1e-4, {d32_self:.3e})")
    log(f"[13b grads fp32] the same weights in fp32 through the fp32 flash "
        f"kernels against the plain path: relative L2 {d32:.3e} <= "
        f"max(1e-4, {d32_self:.3e} = the plain path's own movement at "
        f"weights moved 1e-6); worst leaf {k32} max|diff|/max|g| {w32:.2e} "
        f"(bf16 gradients at random init are ill-conditioned: the plain "
        f"bf16 path is {d_own:.2f} from fp32 in relative L2, as the "
        f"reference's own bf16 gradients are on a small cut) | {card}")
    del g32, gk32, gm32, p32, moved

    # bitwise: the same 3 steps twice
    def three(p):
        o = init_opt_state(p, AdamWConfig())
        st = make_train_step(cut, TrainConfig(remat=True))
        for i in range(3):
            p, o, _ = st(p, o, batch_at(DataConfig(
                vocab=cut.vocab, seq_len=TRAIN_CUT_SEQ,
                global_batch=TRAIN_LM_BATCH, seed=2), i))
        return p
    ra = three(tf.init_params(cut, 0, device=DEV)[0])
    rb = three(tf.init_params(cut, 0, device=DEV)[0])
    la, lb = dict(_named(ra)), dict(_named(rb))
    diff = [k_ for k_ in la if not torch.equal(la[k_], lb[k_])]
    gk2 = grads_of(p0, cut, cb, "auto")
    gdiff = [k_ for k_ in gk if not torch.equal(gk[k_], gk2[k_])]
    if diff or gdiff:
        first = (gdiff or diff)[0]
        op = NONDETERMINISTIC_OP.get(first.split("/")[-1],
                                     "not identified (cuBLAS or elementwise)")
        log(f"[13b determinism] two runs of the same 3 steps are NOT bitwise"
            f" equal: {len(diff)} of {len(la)} leaves differ after them; "
            f"step-0 gradients differ in {gdiff[:4]}; first leaf {first}, "
            f"op: {op} (logged, not gated)")
    else:
        log(f"[13b determinism] two runs of the same 3 steps are bitwise "
            f"equal (all {len(la)} leaves), and so are two step-0 gradient "
            f"evaluations")
    deterministic = not (diff or gdiff)
    del ra, rb, la, lb, gk, gk2

    # -- 13c. grad_accum and compression on the cut ----------------------------
    res = {}
    for accum in (1, 2):
        p = tf.init_params(cut, 0, device=DEV)[0]
        p, _, m = make_train_step(cut, TrainConfig(remat=True,
                                                   grad_accum=accum))(
            p, init_opt_state(p, AdamWConfig()), cb)
        res[accum] = (float(m["grad_norm"]), dict(_named(p)))
    d_norm = abs(res[2][0] - res[1][0]) / res[1][0]
    d_upd = rel_l2({k_: (v_.float() - dict(_named(p0))[k_].float())
                    for k_, v_ in res[2][1].items()},
                   {k_: (v_.float() - dict(_named(p0))[k_].float())
                    for k_, v_ in res[1][1].items()})
    if not d_norm <= 2e-2:
        raise RuntimeError(f"13c: grad_accum=2 grad norm {res[2][0]} vs "
                           f"{res[1][0]}")
    log(f"[13c grad_accum] {cut.name}: grad_accum=2 (two micro-batches of 2,"
        f" gradients summed in fp32) against 1 on the same batch of "
        f"{TRAIN_LM_BATCH}: grad norm {res[2][0]:.5e} vs {res[1][0]:.5e} "
        f"(relative {d_norm:.2e}, gate 2e-2: bf16 gradients against fp32 "
        f"sums), parameter updates' relative L2 {d_upd:.2e} (not gated)")
    del res
    lines = []
    tcc = TrainConfig(remat=True, compress_grads=True, log_every=1,
                      ckpt_every=10**9)
    import repro_torch.train.loop as loop_mod
    seen = []
    real = loop_mod.compression.compress_tree

    depth = [0]

    def spy(g, r):                   # compress_tree recurses into subtrees
        if depth[0] == 0:
            seen.append(None if r is None else
                        float(sum(float(x.float().abs().sum())
                                  for x in _leaves(r))))
        depth[0] += 1
        try:
            return real(g, r)
        finally:
            depth[0] -= 1
    loop_mod.compression.compress_tree = spy
    try:
        pc, _, mc = train(cut, tcc, stream(DataConfig(
            vocab=cut.vocab, seq_len=TRAIN_CUT_SEQ,
            global_batch=TRAIN_LM_BATCH, seed=3)), 3, params=tf.init_params(
                cut, 0, device=DEV)[0], log=lines.append)
    finally:
        loop_mod.compression.compress_tree = real
    if not (seen[0] is None and all(s_ is not None and s_ > 0
                                    for s_ in seen[1:])
            and np.isfinite(float(mc["loss"]))):
        raise RuntimeError(f"13c: compression residuals {seen}")
    log(f"[13c compression] train(compress_grads=True) on {cut.name}, 3 "
        f"steps: the residual carried into steps 1 and 2 (sum|r| "
        f"{seen[1]:.4e}, {seen[2]:.4e}), none into step 0; "
        + "; ".join(lines))
    del pc, p0
    tick("13b-c yi-9b 2-layer cut")

    # -- 13d. the launcher and every token architecture ------------------------
    saved = configs.get_config

    def wide(arch, smoke=False):         # the kernels take heads of 64+
        c = saved(arch, smoke)
        return dataclasses.replace(c, head_dim=64) if smoke else c
    configs.get_config = wide
    try:
        (ROOT / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            import contextlib
            import io
            outs = []
            for d, extra in (("/b", ["--steps", "3"]),
                             ("/b", ["--steps", "5", "--resume"]),
                             ("/a", ["--steps", "5"])):
                buf = io.StringIO()
                d = tmp + d
                with contextlib.redirect_stdout(buf):
                    launch_train.main(["--arch", "yi-9b", "--smoke",
                                       "--seq-len", "64", "--global-batch",
                                       "2", "--ckpt-dir", d] + extra)
                outs.append(buf.getvalue())
            if "resumed from step 2" not in outs[1]:
                raise RuntimeError(f"13d: resume output {outs[1]!r}")
            with np.load(f"{tmp}/a/ckpt_00000004.npz") as za, \
                    np.load(f"{tmp}/b/ckpt_00000004.npz") as zb:
                same = all(za[k_].tobytes() == zb[k_].tobytes()
                           for k_ in za.files)
        note = ("bitwise equal to 5 straight steps" if same else
                "NOT bitwise equal to 5 straight steps" + (
                    " (expected: 13b found the step nondeterministic)"
                    if not deterministic else ""))
        if same != deterministic and not same:
            raise RuntimeError("13d: the resumed run differs though the "
                               "step is deterministic")
        log(f"[13d launcher] python -m repro_torch.launch.train --arch yi-9b"
            f" --smoke (heads widened to 64) --steps 3, then --steps 5 "
            f"--resume: {outs[1].strip().splitlines()[0]}; the step-4 "
            f"checkpoint {note}; output: "
            + " | ".join(o_.strip().replace("\n", "; ") for o_ in outs[:2]))
        arch_lines = []
        for arch in TRAIN_ARCHS:
            c = wide(arch, True)
            p = tf.init_params(c, 0, device=DEV)[0]
            before = {k_: v_.clone() for k_, v_ in _named(p)}
            n_pre = configs.embed_prefix_len(arch, 64)
            b = batch_at(DataConfig(vocab=c.vocab, seq_len=64,
                                    global_batch=2, seed=0,
                                    embed_dim=c.d_model if n_pre else 0,
                                    embed_prefix=n_pre), 0)
            reset_launch_counts()
            p, _, m = make_train_step(c, TrainConfig(remat=True))(
                p, init_opt_state(p, AdamWConfig()), b)
            n = launch_counts()
            same_ = [k_ for k_, v_ in _named(p)
                     if torch.equal(v_, before[k_])]
            if not np.isfinite(float(m["loss"])) or same_:
                raise RuntimeError(f"13d {arch}: loss {float(m['loss'])}, "
                                   f"unchanged leaves {same_}")
            n_attn = n_attn_layers(c)
            if (n["flash_attention"], n["flash_attention_bwd"]) != \
                    (2 * n_attn, n_attn):
                raise RuntimeError(f"13d {arch}: launches {n}")
            arch_lines.append(f"{arch} loss {float(m['loss']):.4f}, "
                              f"{len(before)} leaves all changed, flash "
                              f"{n['flash_attention']} + backward "
                              f"{n['flash_attention_bwd']}")
        log("[13d archs] one training step (fp32 smoke config, heads 64, "
            "seq 64 x 2, remat): " + "; ".join(arch_lines) + f" | {card}")
    finally:
        configs.get_config = saved
    torch.cuda.empty_cache()


# -- phase 14: the multi-card layer at world size 1, and the dry run ---------
SHARD_STEPS = 3                   # 14a: sharded against plain, bitwise
SHARD_TIMED_PAIRS = 4             # 14a: (plain, sharded) pairs timed in turns
DRYRUN_CELLS = (                  # 14c: (arch, shape, mesh, dryrun flags)
    ("yi-9b", "train_4k", "1x1", ()),
    ("yi-9b", "train_4k", "16x16", ()),
    ("yi-9b", "decode_32k", "1x1", ()),
    ("yi-9b", "decode_32k", "16x16", ()),
    ("qwen3-moe-30b-a3b", "train_4k", "16x16", ()))
DRYRUN_TIMEOUT = 600


def _bits_equal(a: dict, b: dict) -> list:
    """Paths whose tensors differ in any bit (DTensors by their local
    shard, which at world size 1 is the whole tensor)."""
    import torch
    from repro_torch.dist.sharding import is_dtensor

    def local(t):
        return t.to_local() if is_dtensor(t) else t
    return [k for k in a if not torch.equal(local(a[k]), local(b[k]))]


def _state_named(params, opt) -> dict:
    """Every leaf of the LM training state by path (params, moments)."""
    out = {f"params/{k}": v for k, v in _named(params)}
    out.update({f"mu/{k}": v for k, v in _named(opt.mu)})
    out.update({f"nu/{k}": v for k, v in _named(opt.nu)})
    return out


def start_dryrun(out: Path, extra_cells=()):
    """The 14c dry-run cells in one background process (CPU only: every
    cell is built on ``meta`` under a fake process group), results to
    ``out``."""
    calls = []
    for arch, shape, mesh, flags in DRYRUN_CELLS + tuple(extra_cells):
        calls.append(["--arch", arch, "--shape", shape, "--mesh", mesh,
                      "--out", str(out), "--force", *flags])
    code = ("import sys; from repro_torch.launch import dryrun\n"
            f"for a in {calls!r}:\n    dryrun.main(a)\n")
    env = dict(__import__("os").environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, cwd=str(ROOT))


def sharded_phases(results: dict, paths: dict, card: str, tick) -> None:
    """Phase 14 (module doc): the training step on DTensors over a one-rank
    NCCL ``(1, 1)`` mesh against the plain step, bitwise (14a),
    reshard-on-load both ways (14b), the dry run of production cells on
    ``meta`` (14c) and the whole step's roofline shares (14d)."""
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.data.tokens import DataConfig, batch_at
    from repro_torch.dist.sharding import (distribute_params,
                                           param_shardings, sharding_ctx)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import init_single, make_host_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import SuperBlock
    from repro_torch.train import (AdamWConfig, TrainConfig, init_opt_state,
                                   make_train_step)
    from repro_torch.train.loop import checkpoint_trees, restore
    from torch.distributed.tensor import DTensor

    init_single(DEV)
    mesh = make_host_mesh(device_type=DEV)
    full = configs.get_config("yi-9b")
    cfg = dataclasses.replace(
        full, name=f"yi-9b ({TRAIN_LM_LAYERS} of {full.n_layers} layers)",
        superblocks=(SuperBlock(blocks=(("attn", "dense"),),
                                repeat=TRAIN_LM_LAYERS),))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_LM_SEQ,
                      global_batch=TRAIN_LM_BATCH, seed=0)
    tcfg = TrainConfig(remat=True, log_every=1, ckpt_every=10**9)
    step = make_train_step(cfg, tcfg)
    batches = [batch_at(dcfg, i) for i in range(SHARD_STEPS
                                               + 2 * SHARD_TIMED_PAIRS)]

    # -- 14a. the sharded step against the plain one, bitwise ---------------
    free_card("14a", 50)
    base = torch.cuda.memory_allocated() / 2**30     # earlier phases' own
    params, axes = tf.init_params(cfg, 0, device=DEV)
    opt = init_opt_state(params, AdamWConfig())
    torch.cuda.reset_peak_memory_stats()
    plain_loss = []
    for i in range(SHARD_STEPS):
        params, opt, m = step(params, opt, batches[i])
        plain_loss.append(float(m["loss"]))
    torch.cuda.synchronize()
    plain_peak = torch.cuda.max_memory_allocated() / 2**30
    host = {k: v.to("cpu") for k, v in _state_named(params, opt).items()}
    state_bytes = sum(v.numel() * v.element_size() for v in host.values())
    param_bytes = sum(t.numel() * t.element_size()
                      for _, t in _named(params))
    del params, opt, m
    free_card("14a sharded", 50)
    with sharding_ctx(mesh, fsdp=True):
        sp, _ = tf.init_params(cfg, 0, device=DEV)
        sp = distribute_params(sp, axes)
        so = init_opt_state(sp, AdamWConfig())
        placed = {k: tuple(str(p) for p in v.placements)
                  for k, v in _named(sp)}
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        shard_loss = []
        for i in range(SHARD_STEPS):
            sp, so, m = step(sp, so, batches[i])
            shard_loss.append(float(m["loss"]))
        torch.cuda.synchronize()
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
    want = {k_: 0 for k_ in counts}
    want.update(flash_attention=2 * TRAIN_LM_LAYERS * SHARD_STEPS,
                flash_attention_bwd=TRAIN_LM_LAYERS * SHARD_STEPS)
    if counts != want:
        raise RuntimeError(f"14a: launches {counts}, expected {want}")
    if shard_loss != plain_loss:
        raise RuntimeError(f"14a: losses {shard_loss} against the plain "
                           f"step's {plain_loss}")
    got = _state_named(sp, so)
    diff = []
    for k, v in host.items():
        if not torch.equal(got[k].to_local(), v.to(DEV)):
            diff.append(k)
    if diff:
        raise RuntimeError(f"14a: {len(diff)} of {len(host)} leaves differ "
                           f"from the plain step's after {SHARD_STEPS} "
                           f"steps: {diff[:4]}")
    sharded_bytes = sum(t.to_local().numel() * t.to_local().element_size()
                        for t in got.values())
    n_leaves = len(host)
    del host, got
    n_par = sum(t.numel() for _, t in _named(sp))
    log(f"[14a sharded] {cfg.name} on a one-rank NCCL (1, 1) "
        f"(data, model) mesh, sharding_ctx(fsdp=True): parameters and fp32 "
        f"moments as DTensors ({n_par / 1e9:.3f} B parameters; e.g. wq "
        f"{placed['sb0/b0/wq']}, embed {placed['embed']}), seq "
        f"{TRAIN_LM_SEQ} x batch {TRAIN_LM_BATCH}, remat: {SHARD_STEPS} steps"
        f" from seed 0, losses {shard_loss} bitwise the plain step's and all"
        f" {n_leaves} parameter and moment leaves bitwise equal after them; "
        f"launches {counts} (the flash kernels through local_map on the "
        f"rank's heads); peak mem {peak:.1f} GiB (the plain steps' "
        f"{plain_peak:.1f}; {base:.1f} GiB held by earlier phases) | "
        f"{card}")

    # timed in turns on one state: the plain step on the DTensors' local
    # tensors (the same storage), the sharded step on the DTensors
    local_tree = _map_local(sp)
    local_opt = type(so)(_map_local(so.mu), _map_local(so.nu), so.step)
    ms = {"plain": [], "sharded": []}
    with sharding_ctx(mesh, fsdp=True):
        for i in range(SHARD_TIMED_PAIRS):
            for kind in (("plain", "sharded") if i % 2 == 0
                         else ("sharded", "plain")):
                b = batches[SHARD_STEPS + 2 * i + (kind == "sharded")]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if kind == "plain":
                    _, local_opt, m = step(local_tree, local_opt, b)
                    so = type(so)(so.mu, so.nu, local_opt.step)
                else:
                    _, so, m = step(sp, so, b)
                    local_opt = type(so)(local_opt.mu, local_opt.nu, so.step)
                float(m["loss"])
                torch.cuda.synchronize()
                ms[kind].append((time.perf_counter() - t0) * 1e3)
    med = {k: float(np.median(v)) for k, v in ms.items()}
    log(f"[14a timing] {SHARD_TIMED_PAIRS} pairs in alternating turns on one"
        f" state: plain "
        + ", ".join(f"{x:.1f}" for x in ms["plain"]) + " ms, sharded "
        + ", ".join(f"{x:.1f}" for x in ms["sharded"])
        + f" ms; medians plain {med['plain']:.1f} ms, sharded "
        f"{med['sharded']:.1f} ms (x{med['sharded'] / med['plain']:.3f}: "
        f"DTensor's per-operation dispatch on the host) | {card}")
    for name, n in (("flash_attention", counts["flash_attention"]),
                    ("flash_attention_bwd", counts["flash_attention_bwd"])):
        results[name]["launches"] += n
        paths.setdefault(name, {})["yi-16 sharded"] = dict(
            launches=n // SHARD_STEPS, step_ms=med["sharded"],
            plain_step_ms=med["plain"])
    del sp, so, local_tree, local_opt, m
    tick("14a sharded step at world size 1")

    # -- 14b. reshard-on-load, both ways ---------------------------------
    free_card("14b", 30)
    out_json = ROOT / "build" / "chip_smoke_dryrun.json"
    out_json.parent.mkdir(exist_ok=True)
    if out_json.exists():
        out_json.unlink()
    cut14 = ("yi-9b", "train_4k", "1x1",
             ("--layers", str(TRAIN_LM_LAYERS), "--batch",
              str(TRAIN_LM_BATCH), "--seq", str(TRAIN_LM_SEQ)))
    proc = start_dryrun(out_json, (cut14,))
    cut = dataclasses.replace(
        cfg, name=f"yi-9b ({TRAIN_CUT_LAYERS} layers)",
        superblocks=(SuperBlock(blocks=(("attn", "dense"),),
                                repeat=TRAIN_CUT_LAYERS),))
    cstep = make_train_step(cut, TrainConfig(remat=True))
    cb = [batch_at(DataConfig(vocab=cut.vocab, seq_len=TRAIN_CUT_SEQ,
                              global_batch=TRAIN_LM_BATCH, seed=4), i)
          for i in range(2)]
    lines = []
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp, \
            sharding_ctx(mesh, fsdp=True):
        for src_kind in ("sharded", "plain"):
            p, cax = tf.init_params(cut, 0, device=DEV)
            if src_kind == "sharded":
                p = distribute_params(p, cax)
            o = init_opt_state(p, AdamWConfig())
            p, o, _ = cstep(p, o, cb[0])
            mgr = CheckpointManager(f"{tmp}/{src_kind}", async_save=False)
            t0 = time.perf_counter()
            mgr.save(0, *checkpoint_trees(p, o))
            save_s = time.perf_counter() - t0
            p, o, _ = cstep(p, o, cb[1])           # the uninterrupted run
            ref = _state_named(p, o)
            q, _ = tf.init_params(cut, 1, device=DEV)
            if src_kind == "sharded":            # into plain tensors
                t0 = time.perf_counter()
                q, qo, _ = restore(mgr, q, init_opt_state(q, AdamWConfig()))
            else:                                 # into the (1, 1) mesh
                meta, _ = tf.abstract_params(cut)
                sh = param_shardings(cax, meta)
                qo = init_opt_state(q, AdamWConfig())
                t0 = time.perf_counter()
                q, o2, _ = mgr.restore(None, q, *checkpoint_trees(q, qo)[1:],
                                       shardings=sh,
                                       opt_shardings={".mu": sh, ".nu": sh})
                qo = type(qo)(o2[".mu"], o2[".nu"], int(o2[".step"]))
                if not all(isinstance(t, DTensor) for _, t in _named(q)):
                    raise RuntimeError("14b: the restore did not reshard "
                                       "onto the mesh")
            load_s = time.perf_counter() - t0
            q, qo, _ = cstep(q, qo, cb[1])
            bad = _bits_equal(_state_named(q, qo), ref)
            if bad:
                raise RuntimeError(f"14b: restored from the {src_kind} "
                                   f"checkpoint, one step differs from the "
                                   f"uninterrupted run in {bad[:4]}")
            into = ("plain tensors" if src_kind == "sharded" else
                    "DTensors on the (1, 1) mesh (shardings=)")
            lines.append(f"{src_kind} state saved ({save_s:.1f} s) and "
                         f"restored into {into} ({load_s:.1f} s): one step "
                         f"bitwise the uninterrupted run's, all {len(ref)} "
                         f"leaves")
            del p, o, q, qo, ref, mgr
    log(f"[14b reshard-on-load] {cut.name}, seq {TRAIN_CUT_SEQ} x batch "
        f"{TRAIN_LM_BATCH}, format-2 checkpoints: " + "; ".join(lines)
        + f" | {card}")
    torch.cuda.empty_cache()
    tick("14b reshard-on-load")

    # -- 14c. the dry run -------------------------------------------------
    try:
        text, _ = proc.communicate(timeout=DRYRUN_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise RuntimeError(f"14c: the dry run exited {proc.returncode}: "
                           f"{text[-2000:]}")
    res = json.loads(out_json.read_text())
    failed = {k: v["error"][:300] for k, v in res.items() if "error" in v}
    if failed:
        raise RuntimeError(f"14c: dry-run cells failed: {failed}")
    for key, r in sorted(res.items()):
        coll = sorted(r["collectives"].items())
        closed = sum(t.numel() for _, t in _named(tf.abstract_params(
            dryrun_cfg(r, configs))[0]))
        if r["n_params"] != closed:
            raise RuntimeError(f"14c {key}: n_params {r['n_params']} "
                               f"against the config's {closed}")
        log(f"[14c dry run] {key}: {r['devices']} device(s), n_params "
            f"{r['n_params']:,} (= the config's), per device: "
            f"{r['flops_per_device']:.4e} FLOPs, {r['bytes_per_device']:.4e}"
            f" bytes, collectives {r['collective_bytes_per_device']:.4e} "
            f"bytes ({', '.join(f'{k_} {v_:.3e}' for k_, v_ in coll)}), "
            f"arguments {r['arg_bytes_per_device'] / 2**30:.2f} GiB, peak "
            f"live {r['temp_bytes_per_device'] / 2**30:.2f} GiB; t_compute "
            f"{r['t_compute']:.4e} s, t_memory {r['t_memory']:.4e} s, "
            f"t_collective {r['t_collective']:.4e} s, bottleneck "
            f"{r['bottleneck']}, roofline fraction "
            f"{r['roofline_fraction']:.3f} (H100 constants; counted in "
            f"{r['count_s']} s)")
    cell = res[f"yi-9b|train_4k|1x1|layers{TRAIN_LM_LAYERS},batch"
               f"{TRAIN_LM_BATCH},seq{TRAIN_LM_SEQ}"]
    if (cell["param_bytes_per_device"] + cell["opt_bytes_per_device"]
            != sharded_bytes or cell["param_bytes_per_device"]
            != param_bytes):
        raise RuntimeError(
            f"14c: the dry run's parameter + optimizer bytes "
            f"{cell['param_bytes_per_device']} + "
            f"{cell['opt_bytes_per_device']} against the card's "
            f"{param_bytes} + {sharded_bytes - param_bytes}")
    est = cell["temp_bytes_per_device"] + cell["arg_bytes_per_device"]
    log(f"[14c bytes] {cfg.name} at {TRAIN_LM_SEQ} x {TRAIN_LM_BATCH} on "
        f"1x1: the dry run's parameter bytes "
        f"{cell['param_bytes_per_device']:,} and optimizer bytes "
        f"{cell['opt_bytes_per_device']:,} equal what the card held in 14a "
        f"({state_bytes:,} in all); its peak-live estimate "
        f"{cell['temp_bytes_per_device'] / 2**30:.2f} GiB beside the "
        f"arguments {cell['arg_bytes_per_device'] / 2**30:.2f} GiB (sum "
        f"{est / 2**30:.2f} GiB) against 14a's plain steps' "
        f"torch.cuda.max_memory_allocated {plain_peak:.2f} GiB less the "
        f"{base:.2f} GiB earlier phases held, {plain_peak - base:.2f} GiB "
        f"(not gated) | {card}")
    tick("14c dry run")

    # -- 14d. the whole step's roofline -------------------------------------
    n_active = sum(t.numel() for _, t in _named(tf.abstract_params(cfg)[0]))
    tokens = TRAIN_LM_SEQ * TRAIN_LM_BATCH
    step_s = med["plain"] / 1e3
    mf = roofline.model_flops_share(step_s, n_active, tokens, train=True)
    of = cell["flops_per_device"] / (step_s * roofline.PEAK_FLOPS)
    log(f"[14d roofline] {cfg.name}, the plain step's median "
        f"{med['plain']:.1f} ms (14a): model FLOPs 6·N·D = 6 x "
        f"{n_active / 1e9:.3f} B x {tokens} = {roofline.model_flops(n_active, tokens, True):.4e} -> "
        f"{mf:.1%} of {roofline.PEAK_FLOPS / 1e12:.0f} TFLOP/s; the op "
        f"counter's FLOPs for the cell (remat's recomputation included) "
        f"{cell['flops_per_device']:.4e} -> {of:.1%} | {card}")
    dist.destroy_process_group()
    tick("14d roofline shares")


# -- phase 15: the examples on the card ----------------------------------------

LM_CKPT_DIR = ROOT / "build" / "chip_smoke_train_lm_ckpt"
# (paths key, example, arguments beside --device cuda, kernels its run must
# launch, its headline from what its main returns)
EXAMPLES = (
    ("ex-quickstart", "torch_quickstart", (),
     ("spconv_gather_gemm", "ws_scatter_gemm"),
     lambda out: "the three dataflows agree"),
    ("ex-pc-infer", "torch_pointcloud_inference", (),
     ("zdelta_superwindow_search", "zdelta_repair", "spconv_gather_gemm",
      "relu_bn"),
     lambda out: f"{out['per_scene']:.1f} ms per scene in the batch "
                 f"({out['batch']:.1f} ms a batch, {out['single']:.1f} ms "
                 f"one scene)"),
    ("ex-train-pc", "torch_train_pointcloud", (),
     ("zdelta_superwindow_search", "zdelta_repair", "spconv_gather_gemm",
      "segment_sum", "dw_gather_gemm"),
     lambda out: f"{out['step_ms']:.1f} ms per step, loss "
                 f"{out['first']['loss']:.4f} -> {out['last']['loss']:.4f}"),
    ("ex-robust-train", "torch_robust_train", (),
     ("zdelta_superwindow_search", "zdelta_repair", "spconv_gather_gemm",
      "segment_sum", "dw_gather_gemm"),
     lambda out: f"{out['run_s'] / out['steps'] * 1e3:.1f} ms per guarded "
                 f"step over the poisoned run ({out['steps']} steps, a "
                 f"checkpoint every step)"),
    ("ex-serve-lm", "torch_serve_lm", (), ("flash_attention",),
     lambda out: f"{out['tokens_per_s']:.1f} tokens/s ({out['tokens']} "
                 f"tokens in {out['seconds']:.2f} s, graph capture "
                 f"included)"),
    ("ex-train-lm", "torch_train_lm", ("--ckpt-dir", str(LM_CKPT_DIR)),
     ("flash_attention", "flash_attention_bwd"),
     lambda out: f"final loss {float(out['metrics']['loss']):.4f}, "
                 f"checkpoints kept {out['ckpt_steps']}"),
)


class Sampler(Recorder):
    """Keeps the first and the latest launch of each kernel (a whole
    example's launches would hold every step's tensors: a
    :class:`Recorder` keeps them all), and on leaving hands the launches
    counted on a wrapper that replaced its own function (its module looks
    the counter up by name) back to the original, so ``launch_counts``
    after the block counts every launch of it."""

    def __enter__(self):
        self.first, self.last, self.saved = {}, {}, []
        for mod, attr, name in self.targets:
            orig = getattr(mod, attr)
            self.saved.append((mod, attr, orig))

            def sampled(*a, _orig=orig, _name=name, **kw):
                if _name in self.first:
                    self.last[_name] = (a, kw)
                else:
                    self.first[_name] = (a, kw)
                return _orig(*a, **kw)
            sampled.launches = 0
            setattr(mod, attr, sampled)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in self.saved:
            orig.launches += getattr(mod, attr).launches
            setattr(mod, attr, orig)
        self.calls = {name: [self.first[name]] + ([self.last[name]]
                                                  if name in self.last
                                                  else [])
                      for name in self.first}
        return False


def check_flash_samples(calls) -> dict:
    """Sampled forward launches, a training forward's (``return_lse``)
    too: outputs as :func:`check_flash` holds them, the row log-sum-exp
    within 1e-3 of a float64 one (13b's gate)."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    for i, (a, kw) in enumerate(calls):
        if not kw.get("return_lse"):
            continue
        q, k, v = a
        _, lse = flash_attention(q, k, v, **kw)
        B, Sq, H, D = q.shape
        s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()
                         .repeat_interleave(H // k.shape[2], 2))
        if kw["causal"]:
            s = s.masked_fill(torch.ones((Sq, k.shape[1]), dtype=torch.bool,
                                         device=q.device)
                              .tril(k.shape[1] - Sq).logical_not(),
                              float("-inf"))
        d = float((lse.double() - torch.logsumexp(s, -1)).abs().max())
        if not d <= 1e-3:
            raise RuntimeError(f"flash sample {i}: lse max|diff| {d}")
    r = check_flash([(a, {k_: v_ for k_, v_ in kw.items()
                          if k_ != "return_lse"}) for a, kw in calls])
    r.pop("by_len"), r.pop("gflop")
    return r


def check_bwd_samples(calls) -> dict:
    """Sampled backward launches of a training run: twice bitwise, and
    against the plain backward in float64 by the float64 gate of the
    other fp32 launches (OS, WS, dW): the kernel's max|error| within
    ``max(4 * the fp32 plain version's, BWD_FP32_GATE * max|ref|)`` per
    gradient (bf16: 2e-2 of max|ref|), one line per launch; each timed
    (``time_bwd``). A training step's gradients cancel more than 13a's
    random inputs', so the fixed fp32 gate alone can sit below what fp32
    itself reaches there."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_bwd_torch)
    err, tot = 0.0, dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    by = "bytes"
    for i, (a, kw) in enumerate(calls):
        q, k, v, out, do, lse = a
        got = flash_attention_bwd(q, k, v, out, do, lse, **kw)
        again = flash_attention_bwd(q, k, v, out, do, lse, **kw)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise RuntimeError(f"15 backward sample {i}: two launches "
                               "differ")
        want = bwd_f64(q, k, v, out, do, kw["causal"])
        plain = flash_attention_bwd_torch(q, k, v, out, do, **kw)
        parts = []
        for name, x, p, y in zip(("dq", "dk", "dv"), got, plain, want):
            e_k = float((x.double() - y).abs().max())
            e_p = float((p.double() - y).abs().max())
            scale = max(float(y.abs().max()), 1e-30)
            gate = (2e-2 * scale if q.dtype == torch.bfloat16
                    else max(4.0 * e_p, BWD_FP32_GATE * scale))
            if not (bool(torch.isfinite(x).all()) and e_k <= gate):
                raise RuntimeError(f"15 backward sample {i} {name}: kernel "
                                   f"max|err| {e_k:.3e} > gate {gate:.3e} "
                                   f"(plain {e_p:.3e}, max|ref| {scale:.3e})")
            err = max(err, e_k / scale)
            parts.append(f"{name} kernel {e_k:.3e}, plain {e_p:.3e}, max|ref|"
                         f" {scale:.3e}, gate {gate:.3e}")
        log(f"[15 bwd f64 {i}] {tuple(q.shape)} {q.dtype} vs float64: "
            + "; ".join(parts))
        t = time_bwd(q, k, v, out, do, lse, kw["causal"])
        for k_ in tot:
            tot[k_] += t[k_]
        by = "operations" if t["bound_by"] == "operations" else by
    return dict(max_abs_err=err, bound_by=by, **tot)


def check_samples(name: str, calls: dict, training: bool) -> dict:
    """The sampled launches of one kernel held against its plain version by
    the check of the phase that introduced it; the result of the check."""
    if name == "zdelta_superwindow_search":
        return check_search(calls[name], "superwindow")
    if name == "zdelta_repair":
        r = check_repair(calls["zdelta_superwindow_search"], calls[name],
                         "superwindow")
        r.pop("unflagged")
        return r
    if name == "spconv_gather_gemm":
        # a training run's sample may be a dF launch: phase 6's gate
        r = check_os(calls[name], rel=1e-4 if training else 0.0,
                     label="15 os")
        r.pop("groups")
        return r
    if name == "ws_scatter_gemm":
        r = check_ws(calls[name], [f"sample {i}" for i in
                                   range(len(calls[name]))], label="15 ws")
        for k_ in ("passes", "peak", "f64_worst"):
            r.pop(k_)
        return r
    if name == "segment_sum":
        r = check_segsum(calls[name], gradients=training)
        r.pop("passes")
        return r
    if name == "relu_bn":
        r = check_relu_bn(calls[name], "15 relu_bn")
        for k_ in ("passes", "gbytes"):
            r.pop(k_)
        return r
    if name == "dw_gather_gemm":
        r = check_dw(calls[name], label="15 dW")
        for k_ in ("passes", "rel_err", "packed_gflop", "f64_worst"):
            r.pop(k_)
        return r
    if name == "flash_attention":
        return check_flash_samples(calls[name])
    return check_bwd_samples(calls[name])


def examples_phase(results: dict, paths: dict, card: str, tick) -> None:
    """Phase 15 (module doc): each example in full mode on the card,
    in process, autograd on as in a user's process."""
    import runpy
    import shutil
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    for key, name, extra, kernels, headline in EXAMPLES:
        free_card(f"15 {key}", 8)
        shutil.rmtree(LM_CKPT_DIR, ignore_errors=True)
        main_fn = runpy.run_path(str(ROOT / "examples" / f"{name}.py"),
                                 run_name=name)["main"]
        reset_launch_counts()
        with Sampler() as rec, torch.enable_grad():
            t0 = time.perf_counter()
            out = main_fn(["--device", DEV, *extra])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = {k_: v_ for k_, v_ in launch_counts().items() if v_}
        missing = [k_ for k_ in kernels if not counts.get(k_)]
        if missing:
            raise RuntimeError(f"15 {key}: no launch of {missing} "
                               f"(launches {counts})")
        training = bool({"dw_gather_gemm", "flash_attention_bwd"}
                        & set(kernels))
        for k_ in kernels:
            r = check_samples(k_, rec.calls, training)
            paths[k_][key] = dict(launches=counts[k_],
                                  checked=len(rec.calls[k_]),
                                  **per_forward(r))
            row = results[k_]
            row["max_abs_err"] = max(row["max_abs_err"], r["max_abs_err"])
        log(f"[15x {key}] examples/{name}.py, full mode on the card: "
            f"{wall:.1f} s; launches {counts}; {headline(out)}; the "
            f"first and last launch of each kernel held against its plain "
            f"version | {card}")
        del rec, out, main_fn
        tick(f"15 {key}")
    shutil.rmtree(LM_CKPT_DIR, ignore_errors=True)


def dryrun_cfg(rec: dict, configs):
    """The config a dry-run record counted (its depth cut by ``layers``)."""
    from repro_torch.launch.dryrun import cut_config
    full = configs.get_config(rec["arch"])
    return cut_config(rec["arch"], rec["layers"]
                      if rec["layers"] != full.n_layers else 0)


def _map_local(tree):
    """A nested dict of DTensors as their local tensors (the same
    storage)."""
    return {k: _map_local(v) if isinstance(v, dict) else v.to_local()
            for k, v in tree.items()}


def _named(tree, prefix=""):
    """(path, tensor) of every leaf of a nested dict, sorted."""
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _named(v, path)
        else:
            yield path, v


def main() -> int:
    import torch
    tick = PhaseClock()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    torch.set_grad_enabled(False)    # inference only: no autograd graphs
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (sets TF32 off)
    from repro_torch.core.dataflow import ws_kept_map
    from repro_torch.core.kernel_map import l1_partition
    from repro_torch.core.sparse_tensor import SparseTensor
    from repro_torch.data import scenes
    from repro_torch.kernels import (_build, launch_counts,
                                     reset_launch_counts)
    from repro_torch.kernels.spconv_gather_gemm import (
        spconv_gather_gemm, spconv_gather_gemm_torch)
    from repro_torch.kernels.masked_group_gemm import masked_group_gemm
    from repro_torch.kernels.ws_scatter_gemm import (
        ws_pack_cuda, ws_scatter_gemm, ws_scatter_gemm_torch)
    from repro_torch.models import pointcloud as pc
    from repro_torch.serve import bucket_capacity, compile_network
    if "jax" in sys.modules or "repro" in sys.modules:
        raise RuntimeError("the port must not load jax or the JAX package")

    # -- 1. device ---------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 is on; the reference contract is IEEE fp32")
    log(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{kind} | nvidia-smi: {card} | devices {torch.cuda.device_count()} "
        f"| tf32 off")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log(f"[2 build] {len(_build.sources())} sources -> {lib.name} in "
        f"{time.perf_counter() - t0:.2f} s")
    ptxas = [ln.strip() for ln in (lib.parent / "build.log").read_text()
             .splitlines() if "registers" in ln or "Compiling entry" in ln]
    for ln in ptxas:
        log(f"    ptxas {ln}")
    wgmma_check(card)

    tick("1-2 device and build")
    # -- the main path's inputs -------------------------------------------
    t0 = time.perf_counter()
    batch = scenes.scene_batch(seed=0, batch=2, kind="outdoor",
                               extent=(1024, 1024, 40), overlap=0.5)
    rng = np.random.default_rng(1)
    clouds = [(sc.coords, rng.normal(size=(len(sc.coords), 4))
               .astype(np.float32)) for sc in batch]
    sizes = [len(c) for c, _ in clouds]
    net = pc.minkunet42(in_channels=4, n_classes=20)
    session = compile_network(net, batch[0].layout, batch=2, seed=0,
                              cuda_graphs=False)
    st1 = SparseTensor.from_point_clouds(clouds[:1], session.layout)
    st2 = SparseTensor.from_point_clouds(clouds, session.layout)
    log(f"[inputs] 2 outdoor scenes {sizes} voxels, layout {session.layout}, "
        f"buckets {bucket_capacity(sizes[0])}/{bucket_capacity(sum(sizes))}, "
        f"{len(net.specs)} layers, made in {time.perf_counter() - t0:.1f} s")

    tick("inputs")
    # -- 3. kernels vs plain, at the main path's shapes --------------------
    with Recorder() as rec:
        session(st2)
    torch.cuda.synchronize()
    results = {}
    paths = {}          # kernel -> {path: per-forward numbers}

    # superwindow search: maps and overflow counters equal
    z = rec.calls["zdelta_superwindow_search"]
    fine, coarse = z[0], z[[s.m_out for s in net.specs].index(4)]
    for label, (a, kw) in (("fine L0", fine), ("coarse L4", coarse)):
        r = check_search([(a, kw)], "superwindow")
        real = int((a[1] != torch.iinfo(a[1].dtype).max).sum())
        log(f"[3 superwindow {label}] M={a[1].numel()} ({real} real rows) "
            f"N={a[0].numel()} G={a[2].numel()} SW={kw['SW']} "
            f"{a[0].dtype}: maps+counters equal, device {r['ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms; "
            f"{search_rates(r)} | {card}")
    r = results["zdelta_superwindow_search"] = check_search(z, "superwindow")
    log(f"[3 superwindow] {len(z)} launches equal; per forward device "
        f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
        f"{r['bound_ms']:.4f} ms; {search_rates(r)} | {card}")
    r = check_repair(z, rec.calls["zdelta_repair"], "superwindow")
    r.pop("gbytes")
    results["zdelta_repair"] = r
    note = unflagged_note(r)
    log(f"[3 repair] {len(z)} launches equal to the plain version, "
        f"{r.pop('flagged')} flagged cells; per forward device "
        f"{r['ms']:.4f} ms, through the wrapper {r['wrapper_ms']:.4f} ms, "
        f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.5f} ms"
        f"{note} | {card}")

    # OS implicit GEMM: fp32 within 1e-5 * max(1, max|ref|)
    o = rec.calls["spconv_gather_gemm"]
    names = [s.name for s in net.specs]
    r = check_os(o, names=names, library=True)
    gflop = r.pop("gflop")
    log_os_groups("3 os", r, card)
    r.pop("groups"), r.pop("f64_worst")
    results["spconv_gather_gemm"] = r
    log(f"[3 os] {len(o)} launches within 1e-5*max(1,|ref|) and the "
        f"float64 gate (max|diff| "
        f"{r['max_abs_err']:.3e}); per forward kernel {r['ms']:.3f} ms, "
        f"plain {r['plain_ms']:.3f} ms, torch.einsum on the pre-masked "
        f"gathered tensor {r['library_ms']:.3f} ms, bound "
        f"{r['bound_ms']:.3f} ms ({gflop:.1f} GFLOP useful, "
        f"{gflop / r['ms']:.2f} TFLOP/s; at 3xTF32's 165 TFLOP/s "
        f"{gflop / 165:.3f} ms) | {card}")
    for name in ("stem0", "enc3_a", "dec0_up"):
        F, m, W = o[names.index(name)][0]
        for dt, tol_rel in ((torch.float32, None), (torch.bfloat16, 2e-2)):
            Fd, Wd = F.to(dt), W.to(dt)
            ok_ = spconv_gather_gemm(Fd, m, Wd).float()
            ref = spconv_gather_gemm_torch(Fd, m, Wd).float()
            d = float((ok_ - ref).abs().max())
            scale = float(ref.abs().max())
            tol = (1e-5 * max(1.0, scale) if tol_rel is None
                   else tol_rel * max(scale, 1e-30))
            if not d <= tol:
                raise RuntimeError(f"OS {name} {dt}: max|diff| {d} > {tol}")
            ms = cuda_ms(lambda: spconv_gather_gemm(Fd, m, Wd), 10)
            pms = cuda_ms(lambda: spconv_gather_gemm_torch(Fd, m, Wd), 3)
            log(f"[3 os {name} {str(dt)[6:]}] M={m.shape[0]} N={F.shape[0]} "
                f"{F.shape[1]}->{W.shape[2]} nnz={int((m >= 0).sum())}: "
                f"max|diff| {d:.3e} (tol {tol:.1e}), kernel {ms:.4f} ms, "
                f"plain {pms:.4f} ms")

    # the fused epilogue: bitwise the chain
    e_calls = rec.calls["relu_bn"]
    r = results["relu_bn"] = check_relu_bn(e_calls, "3 relu_bn")
    log_relu_bn("3 relu_bn", r, len(e_calls), card)
    # segment sums: bitwise, on the chain's inputs (an inference forward
    # launches none since the fused epilogue)
    s_calls = chain_segsum_calls(e_calls)
    r = check_segsum(s_calls)
    f64_rel, lib_rel = r.pop("f64_rel"), r.pop("lib_rel")
    log_segsum_passes("3 segsum", r, card)
    results["segment_sum"] = r
    log(f"[3 segsum] {len(s_calls)} chain launches bitwise equal (max rel diff "
        f"to an fp64 sum {f64_rel:.2e}); per forward "
        f"kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
        f"torch.segment_reduce {r['library_ms']:.3f} ms (max rel diff to "
        f"fp64 {lib_rel:.2e}), bound {r['bound_ms']:.4f} ms | {card}")
    del rec, z, o, s_calls, e_calls
    torch.cuda.empty_cache()

    tick("3 MinkUNet-42 kernels vs plain")
    # -- 4. main path --------------------------------------------------------
    expected = {k: 0 for k in launch_counts()}
    expected.update({"zdelta_superwindow_search": 42,
                     "zdelta_repair": 42,
                     "spconv_gather_gemm": 42, "relu_bn": 42})
    outb, hb, times, counts = drive(session, (("scene0", st1),
                                              ("batch2", st2)),
                                    expected, "4 main path", kind, card)
    for k in ("zdelta_superwindow_search", "spconv_gather_gemm",
              "segment_sum", "zdelta_repair", "relu_bn"):
        paths[k] = {"minkunet42": dict(launches=counts[k],
                                       **per_forward(results[k]))}
    results["zdelta_repair"]["launches"] = counts["zdelta_repair"]
    results["relu_bn"]["launches"] = counts["relu_bn"]
    profile_line("4", lambda: session(st2), times["batch2"][1], card)

    tick("4 MinkUNet-42 main path")
    # -- 5. plain path on the same card --------------------------------------
    plain_path(session, pc.minkunet42(in_channels=4, n_classes=20,
                                      backend="torch"),
               st2, outb, "5 plain path")
    del session, outb, hb, st1, st2
    torch.cuda.empty_cache()

    tick("5 MinkUNet-42 plain path")
    published_minkunet_phase(paths, kind, card)
    tick("5m published MinkUNet")
    # == CenterPoint-Large: hybrid (OS + WS), K = 5 ==========================
    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    clouds = [(sc.coords, rng.normal(size=(len(sc.coords), 5))
               .astype(np.float32)) for sc in batch]
    cp = pc.centerpoint_large()
    cps = compile_network(cp, batch[0].layout, batch=2, seed=0,
                          cuda_graphs=False)
    st1 = SparseTensor.from_point_clouds(clouds[:1], cps.layout)
    st2 = SparseTensor.from_point_clouds(clouds, cps.layout)
    log(f"[inputs cp] {cp.name}: {len(cp.specs)} layers, dataflow "
        f"{cp.specs[0].dataflow} t={cp.specs[0].t} K={cp.specs[0].K}, "
        f"{cp.in_channels} input channels, {cp.n_classes} classes, same "
        f"scenes, made in {time.perf_counter() - t0:.1f} s")

    # -- 3 (CenterPoint). kernels vs plain at its shapes ---------------------
    with Recorder() as rec:
        cps(st2)
    torch.cuda.synchronize()
    cp_names = [s.name for s in cp.specs]
    w_calls = rec.calls["ws_scatter_gemm"]
    if len(w_calls) != len(cp.specs):
        raise RuntimeError(f"cp: {len(w_calls)} WS launches in one forward, "
                           f"expected {len(cp.specs)}")
    r = check_ws(w_calls, cp_names)
    gflop, passes, peak = r.pop("gflop"), r.pop("passes"), r.pop("peak")
    f64_worst = r.pop("f64_worst")
    results["ws_scatter_gemm"] = r
    log(f"[3 cp ws] {len(w_calls)} launches within 1e-5*max(1,|ref|) "
        f"(max|diff| {r['max_abs_err']:.3e}) and the float64 gate (worst "
        f"{f64_worst:.3f} of it); per forward kernel "
        f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
        f"{r['bound_ms']:.3f} ms ({gflop:.1f} GFLOP useful, "
        f"{gflop / r['ms']:.2f} TFLOP/s) | {card}")
    log(f"[3 cp ws passes] device ms over one launch of each call: pack "
        f"{passes['ws_pack_kernel']:.3f}, rank "
        f"{passes['ws_rank_kernel']:.3f}, sweep "
        f"{passes['ws_sweep_kernel']:.3f} (total "
        f"{sum(passes.values()):.3f}) | {card}")
    log(f"[3 cp ws peak] largest launch (M={peak['M']}, Ks={peak['Ks']}): "
        f"peak {peak['bytes'] / 2**20:.1f} MiB above what was allocated "
        f"before it, of which the fp32 output {peak['out'] / 2**20:.1f} "
        f"MiB; the first port's pair-index table and partial rows alone "
        f"took {peak['old'] / 2**20:.1f} MiB there")
    for name, (a, kw) in zip(cp_names, w_calls):
        F, m, W = a
        msub = ws_map(m, kw.get("cols"))
        b, _, ops = ws_bound(F, msub, W, kw["capacity"])
        ms = cuda_ms(lambda: ws_scatter_gemm(F, m, W, **kw), 3)
        log(f"[3 cp ws {name}] M={m.shape[0]} N={F.shape[0]} "
            f"Ks={msub.shape[1]} {F.shape[1]}->{W.shape[2]} "
            f"pairs={int((msub >= 0).sum())} largest column "
            f"{int((msub >= 0).sum(0).max())}: kernel "
            f"{ms:.4f} ms, bound {b:.4f} ms, "
            f"{ops / (ms * 1e-3) / 1e12:.2f} TFLOP/s")
    # a capacity below s2_b0a's largest column: the same pairs drop
    (F, m, W), kw = w_calls[cp_names.index("s2_b0a")]
    cap, cols = LOSSY_CAPACITY, kw.get("cols")
    msub = ws_map(m, cols)
    kept_k = ws_pack_cuda(m, cap, cols=cols).kept_mask(m.shape[0])
    kept_p = ws_kept_map(msub, cap) >= 0
    if not torch.equal(kept_k, kept_p):
        raise RuntimeError("lossy WS: the kernel's kept pairs differ from "
                           "the kept map's")
    got = ws_scatter_gemm(F, m, W, capacity=cap, cols=cols)
    ref = ws_scatter_gemm_torch(F, m, W, capacity=cap, cols=cols)
    d = float((got - ref).abs().max())
    tol = 1e-5 * max(1.0, float(ref.abs().max()))
    if not d <= tol:
        raise RuntimeError(f"lossy WS s2_b0a: max|diff| {d} > {tol}")
    dropped = int((msub >= 0).sum()) - int(kept_k.sum())
    log(f"[3 cp ws s2_b0a lossy] capacity {cap}: {dropped} pairs dropped, "
        f"dropped set equal to the kept map's, max|diff| {d:.3e} "
        f"(tol {tol:.1e})")
    for name in ("stem", "s2_down", "s3_b0a"):
        (F, m, W), kw = w_calls[cp_names.index(name)]
        Fd, Wd = F.to(torch.bfloat16), W.to(torch.bfloat16)
        got = ws_scatter_gemm(Fd, m, Wd, **kw)
        ref = ws_scatter_gemm_torch(Fd, m, Wd, capacity=kw["capacity"],
                                    cols=kw.get("cols"))
        d = float((got - ref).abs().max())
        tol = 2e-2 * max(float(ref.abs().max()), 1e-30)
        if not d <= tol:
            raise RuntimeError(f"WS {name} bf16: max|diff| {d} > {tol}")
        ms = cuda_ms(lambda: ws_scatter_gemm(Fd, m, Wd, **kw), 10)
        log(f"[3 cp ws {name} bf16] max|diff| {d:.3e} (tol {tol:.1e}), "
            f"kernel {ms:.4f} ms")
    # the slice-1 kernels at CenterPoint's shapes
    e_calls = rec.calls["relu_bn"]
    r = check_relu_bn(e_calls, "3 cp relu_bn")
    log_relu_bn("3 cp relu_bn", r, len(e_calls), card)
    paths["relu_bn"]["centerpoint_large"] = dict(launches=len(e_calls),
                                                 **per_forward(r))
    # the segment sums on the chain's inputs, as in phase 3
    rec.calls["segment_sum"] = chain_segsum_calls(e_calls)
    for kname, fn in (("zdelta_superwindow_search",
                       lambda c: check_search(c, "superwindow")),
                      ("spconv_gather_gemm",
                       lambda c: check_os(c, label="3 cp os", library=True)),
                      ("segment_sum", check_segsum)):
        c = rec.calls[kname]
        r = fn(c)
        lib = ""
        if kname == "spconv_gather_gemm":
            log_os_groups("3 cp os", r, card)
            lib = (f", torch.einsum on the pre-masked gathered tensor "
                   f"{r['library_ms']:.3f} ms")
        if kname == "segment_sum":
            log_segsum_passes("3 cp segment_sum", r, card)
            lib = (f", torch.segment_reduce {r['library_ms']:.3f} ms (max "
                   f"rel diff to fp64 {r['lib_rel']:.2e})")
        if kname == "zdelta_superwindow_search":
            lib = f"; {search_rates(r)}"
        paths[kname]["centerpoint_large"] = per_forward(r)
        log(f"[3 cp {kname}] {len(c)} launches equal to the plain version "
            f"(max|diff| {r['max_abs_err']:.3e}); per forward kernel "
            f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms{lib}, bound "
            f"{r['bound_ms']:.4f} ms")
    r = check_repair(rec.calls["zdelta_superwindow_search"],
                     rec.calls["zdelta_repair"], "superwindow")
    flagged, gbytes = r.pop("flagged"), r.pop("gbytes")
    note = unflagged_note(r)
    paths["zdelta_repair"]["centerpoint_large"] = dict(
        launches=len(rec.calls["zdelta_repair"]), flagged=flagged,
        **per_forward(r))
    log(f"[3 cp repair] {len(rec.calls['zdelta_repair'])} launches equal to "
        f"the plain version, {flagged} flagged cells; per forward device "
        f"{r['ms']:.4f} ms, through the wrapper {r['wrapper_ms']:.4f} ms, "
        f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.5f} ms"
        f"{note} | {card}")
    del rec, w_calls, F, m, W, e_calls
    torch.cuda.empty_cache()

    tick("3 CenterPoint-Large kernels vs plain")
    # -- 4b. main path ------------------------------------------------------
    expected = {k: 0 for k in launch_counts()}
    n_os = sum(1 for s in cp.specs
               if l1_partition(s.K, s.offset_stride, s.t)[0].size)
    expected.update({"zdelta_superwindow_search": 20,
                     "zdelta_repair": 20, "relu_bn": 20,
                     "spconv_gather_gemm": n_os, "ws_scatter_gemm": 20})
    outb, hb, times, counts = drive(cps, (("scene0", st1), ("batch2", st2)),
                                    expected, "4b main path", kind, card)
    cp_untuned_ms = times["batch2"][1]
    for k in ("zdelta_superwindow_search", "spconv_gather_gemm",
              "segment_sum", "relu_bn"):
        paths[k]["centerpoint_large"]["launches"] = counts[k]
    results["ws_scatter_gemm"]["launches"] = counts["ws_scatter_gemm"]
    paths["ws_scatter_gemm"] = {"centerpoint_large": dict(
        launches=counts["ws_scatter_gemm"],
        **per_forward(results["ws_scatter_gemm"]))}
    profile_line("4b", lambda: cps(st2), times["batch2"][1], card)

    tick("4b CenterPoint-Large main path")
    # -- 4c. escalation -----------------------------------------------------
    lossy_net = dataclasses.replace(cp, specs=tuple(
        dataclasses.replace(s, ws_capacity=LOSSY_CAPACITY) for s in cp.specs))
    esc = compile_network(lossy_net, cps.layout, batch=2, params=cps.params,
                          cuda_graphs=False)
    _, h0 = esc.run_with_health(st2, max_replans=0)
    drops = {k: v for k, v in h0.ws_dropped_pairs.items() if v}
    if not drops:
        raise RuntimeError(f"4c: ws_capacity {LOSSY_CAPACITY} dropped no "
                           "pair")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    oute, he = esc.run_with_health(st2)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) * 1e3
    if not (he.replans == 1 and he.escalation == 1 and he.ok
            and he.bucket == 2 * hb.bucket):
        raise RuntimeError(f"4c: escalation health {he.summary()}")
    n = int(outb.count)
    if not (torch.equal(oute.packed[:n], outb.packed[:n])
            and torch.equal(oute.features[:n], outb.features[:n])):
        raise RuntimeError("4c: escalated logits not bitwise equal to the "
                           "lossless session's")
    log(f"[4c escalation] ws_capacity {LOSSY_CAPACITY} on every layer: "
        f"first plan drops "
        f"{drops}; session replanned {he.replans}x to bucket {he.bucket} "
        f"(escalation {he.escalation}, ok={he.ok}) in {dt:.1f} ms; logits "
        f"bitwise equal to the lossless session's ({n} rows)")
    del esc, oute
    torch.cuda.empty_cache()

    tick("4c escalation")
    # -- 4d. per-group window engine -----------------------------------------
    win = compile_network(cp, cps.layout, batch=2, params=cps.params,
                          engine="zdelta_cuda_window", cuda_graphs=False)
    reset_launch_counts()
    plan_w = win.plan(st2)
    torch.cuda.synchronize()
    wcount = launch_counts()["zdelta_window_search"]
    if wcount != len(cp.specs):
        raise RuntimeError(f"4d: {wcount} window launches, expected "
                           f"{len(cp.specs)}")
    plan_s = cps.plan(st2)
    for s in cp.specs:
        if not torch.equal(plan_w.kmaps[s.name].m, plan_s.kmaps[s.name].m):
            raise RuntimeError(f"4d: window-engine map of {s.name} differs "
                               "from the superwindow engine's")
    log(f"[4d window engine] {len(cp.specs)} kernel maps equal to the "
        f"superwindow engine's; window launches {wcount}; repaired cells "
        "per layer: " + " ".join(f"{k}={int(v)}"
                                 for k, v in plan_w.stats.items()))
    del plan_w, plan_s
    torch.cuda.empty_cache()
    with Recorder() as rec:             # the same plan, for the comparison
        win.plan(st2)
    v_calls = rec.calls["zdelta_window_search"]
    r = results["zdelta_window_search"] = check_search(v_calls, "window")
    paths["zdelta_window_search"] = {"centerpoint_large plan (4d)": dict(
        launches=wcount, **per_forward(r))}
    r["launches"] = wcount
    rr = check_repair(v_calls, rec.calls["zdelta_repair"], "window")
    flagged, gbytes = rr.pop("flagged"), rr.pop("gbytes")
    note = unflagged_note(rr)
    paths["zdelta_repair"]["centerpoint_large window plan (4d)"] = dict(
        launches=len(rec.calls["zdelta_repair"]), flagged=flagged,
        **per_forward(rr))
    log(f"[4d repair] {len(rec.calls['zdelta_repair'])} repair launches of "
        f"the window plan equal to the plain version, {flagged} flagged "
        f"cells re-searched; per plan device {rr['ms']:.4f} ms, through the "
        f"wrapper {rr['wrapper_ms']:.4f} ms, plain {rr['plain_ms']:.3f} ms, "
        f"bound {rr['bound_ms']:.5f} ms{note} | {card}")
    log(f"[3 cp window] {len(v_calls)} launches: maps+counters equal; per "
        f"plan device {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
        f"{r['bound_ms']:.4f} ms; {search_rates(r)} (superwindow at the "
        "same shapes: "
        f"{paths['zdelta_superwindow_search']['centerpoint_large']['ms']:.3f}"
        f" ms) | {card}")
    del rec, v_calls
    torch.cuda.empty_cache()

    tick("4d window engine")
    # -- 5b. plain path -------------------------------------------------------
    plain_path(cps, pc.centerpoint_large(backend="torch"), st2, outb,
               "5b plain path")
    del cps, outb, hb, st1, st2
    torch.cuda.empty_cache()

    tick("5b CenterPoint-Large plain path")
    # -- 4e. int64 packed words -----------------------------------------------
    int64_phase(paths, kind, card)

    tick("4e int64 words")
    # -- 8. the tuner and the paper's baselines --------------------------------
    tuned = tuner_phases(batch, kind, card, cp_untuned_ms)

    tick("8 tuner and baselines")
    # == MinkUNet-42 training ================================================
    from repro_torch.core.zdelta import reset_search_calls, search_call_count
    from repro_torch.train import labeled_batch
    t0 = time.perf_counter()
    lbatch = scenes.scene_batch(seed=0, batch=2, kind="outdoor",
                                extent=(1024, 1024, 40), overlap=0.5,
                                labels=True, n_classes=20)
    tnet = pc.minkunet42(in_channels=4, n_classes=20)
    plain_tnet = pc.minkunet42(in_channels=4, n_classes=20, backend="torch")
    s6 = compile_network(tnet, lbatch[0].layout, batch=2, seed=0,
                         cuda_graphs=False)
    tst, tlab = labeled_batch(lbatch, s6.layout)
    bucket = s6._bucket(tst.capacity)
    stp = tst.pad_to(bucket)
    labp = torch.cat([tlab, torch.full((bucket - tlab.shape[0],), -1,
                                       dtype=torch.int32, device=tlab.device)])
    log(f"[inputs train] the same 2 scenes with 20-class labels "
        f"({int((tlab >= 0).sum())} labeled rows), coordinate features, "
        f"bucket {bucket}, made in {time.perf_counter() - t0:.1f} s")

    # -- 6. training kernels at the main path's shapes ------------------------
    with Recorder(names=("spconv_gather_gemm", "dw_gather_gemm",
                         "segment_sum")) as rec:
        step_grads(tnet, s6.layout, "zdelta_cuda", "auto", s6.params,
                   stp.packed, stp.features, labp)
    torch.cuda.synchronize()
    o = rec.calls["spconv_gather_gemm"]
    n_l = len(tnet.specs)
    fwd, bwd = o[:n_l], o[n_l:]
    if len(bwd) != n_l - 1:
        raise RuntimeError(f"6: {len(bwd)} OS backward launches, expected "
                           f"{n_l - 1}")
    r = check_os(bwd, rel=1e-4, label="6 os dF")
    gflop = r.pop("gflop")
    log_os_groups("6 os dF", r, card)
    r.pop("groups"), r.pop("f64_worst")
    results["os_df"] = r
    log(f"[6 os dF] {len(bwd)} launches over the transposed maps within "
        f"1e-4*max|ref| of the plain version (max|diff| "
        f"{r['max_abs_err']:.3e}); per step kernel {r['ms']:.3f} ms, plain "
        f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms ({gflop:.1f} "
        f"GFLOP useful, {gflop / r['ms']:.2f} TFLOP/s; at 3xTF32's 165 "
        f"TFLOP/s {gflop / 165:.3f} ms) | {card}")
    dw_calls = rec.calls["dw_gather_gemm"]
    r = check_dw(dw_calls)
    gflop, rel = r.pop("gflop"), r.pop("rel_err")
    packed, worst = r.pop("packed_gflop"), r.pop("f64_worst")
    passes = r.pop("passes")
    log(f"[6 dW passes] device ms over one launch of each call: pack "
        f"{passes['dw_pack_kernel']:.3f}, mma {passes['dw_mma_kernel']:.3f}, "
        f"combine {passes['dw_combine_kernel']:.3f} | {card}")
    results["dw_gather_gemm"] = r
    log(f"[6 dW] {len(dw_calls)} launches (42 layers + head) within "
        f"1e-4*max|ref| of chunked_rowdot (max rel diff {rel:.2e}) and the "
        f"float64 gate (worst {worst:.3f} of its limit); per step kernel "
        f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, torch.matmul on "
        f"the pre-gathered [Kd, Cin, M] tensor {r['library_ms']:.3f} ms, "
        f"bound {r['bound_ms']:.3f} ms ({gflop:.1f} GFLOP useful, "
        f"{gflop / r['ms']:.2f} TFLOP/s; at 3xTF32's 165 TFLOP/s "
        f"{gflop / 165:.3f} ms); packed rows x tiles {packed:.1f} GFLOP "
        f"({packed / max(gflop, 1e-9):.2f}x useful, "
        f"{packed / r['ms']:.2f} TFLOP/s) | {card}")
    s_calls = rec.calls["segment_sum"]
    r = check_segsum(s_calls, gradients=True)
    r.pop("f64_rel"), r.pop("lib_rel")
    log_segsum_passes("6 segsum", r, card)
    results["segsum_train"] = r
    log(f"[6 segsum] {len(s_calls)} launches of one step (BN forward, BN "
        f"backward, bias gradients, loss) bitwise equal to the plain "
        f"version; per step kernel {r['ms']:.3f} ms, torch.segment_reduce "
        f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms (plain "
        f"version not timed) | {card}")
    del rec, o, bwd, dw_calls, s_calls
    torch.cuda.empty_cache()
    with Recorder(names=("spconv_gather_gemm",)) as rec:
        s6(tst)                      # the inference forward's OS operands
    fwd = rec.calls["spconv_gather_gemm"]
    del rec
    r = check_mgg(fwd, [s.name for s in tnet.specs])
    if r["launches"] != n_l:
        raise RuntimeError(f"6: output_stationary_fused launched the masked "
                           f"grouped GEMM {r['launches']} times for {n_l} "
                           "layers")
    gflop, dense = r.pop("gflop"), r.pop("dense_gflop")
    gbytes, f64_worst = r.pop("gbytes"), r.pop("f64_worst")
    results["masked_group_gemm"] = r
    log(f"[6 masked_group_gemm] ops.output_stationary_fused on all {n_l} "
        f"layers' forward operands: {r['launches']} launches, within "
        f"1e-5*max(1,|ref|) of the plain version and of the OS kernel "
        f"(max|diff| {r['max_abs_err']:.3e}) and the float64 gate (worst "
        f"{f64_worst:.3f} of it); per forward kernel "
        f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, torch.einsum on "
        f"the pre-masked tensor {r['library_ms']:.3f} ms, bound "
        f"{r['bound_ms']:.3f} ms (half of it {r['bound_ms'] * 2:.3f} ms); "
        f"{gflop:.1f} GFLOP useful, {gflop / r['ms']:.2f} TFLOP/s; "
        f"{dense:.1f} GFLOP dense, {dense / r['ms']:.2f} TFLOP/s; "
        f"{gbytes:.2f} GB of bound bytes, {gbytes / r['ms'] * 1e3:.0f} GB/s "
        f"| {card}")
    probe = torch.zeros((2, 2), dtype=torch.int32, device=DEV)
    probe[0, 1] = -1
    g_inf = torch.ones((2, 2, 16), device=DEV)
    g_inf[0, 1, 3] = float("inf")
    y = masked_group_gemm(probe, g_inf, torch.ones((2, 16, 8), device=DEV))
    if not (bool(torch.isnan(y[0]).all()) and bool(torch.isfinite(y[1])
                                                   .all())):
        raise RuntimeError("masked_group_gemm: an inf at a masked position "
                           "did not make its row NaN")
    log("[6 masked_group_gemm] an inf at a masked position makes its row "
        "NaN (the mask is a multiply)")
    del fwd, s6
    torch.cuda.empty_cache()

    tick("inputs train, 6 training kernels")
    # -- 6b. the training main path ------------------------------------------
    reset_search_calls()
    sess = compile_network(tnet, lbatch[0].layout, batch=2, seed=0,
                           cuda_graphs=False)
    sess.plan(tst)
    plan_searches = search_call_count()
    trainer = sess.compile_train()
    expected = {k: 0 for k in launch_counts()}
    expected.update({"zdelta_superwindow_search": n_l,
                     "zdelta_repair": n_l,
                     "spconv_gather_gemm": 2 * n_l - 1,
                     "segment_sum": 3 * n_l + 1,
                     "dw_gather_gemm": n_l + 1})
    if plan_searches != n_l:
        raise RuntimeError(f"6b: one inference plan ran {plan_searches} "
                           "searches")
    torch.cuda.reset_peak_memory_stats()
    times, metrics, counts = train_drive(trainer, tst, tlab, TRAIN_STEPS,
                                         expected, "6b train")
    per_step = {k: v for k, v in expected.items() if v}
    for i, (t, m) in enumerate(zip(times, metrics)):
        log(f"[6b train] step {i}: {t:.1f} ms, loss {m['loss']:.4f}, "
            f"accuracy {m['accuracy']:.4f}, grad norm {m['grad_norm']:.4e},"
            f" lr {m['lr']:.2e}")
    steady = float(np.median(times[1:]))
    log(f"[6b train] {tnet.name} full width, batch 2, bucket {bucket}: "
        f"{TRAIN_STEPS} steps, steady-state {steady:.1f} ms per step "
        f"(median of steps 1-{TRAIN_STEPS - 1}; first {times[0]:.1f}); "
        f"launches per step {per_step}, {n_l} kernel-map searches per step "
        f"= one inference plan's ({plan_searches}), none in the backward; "
        f"run total {counts} | peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB | {card}")
    if not metrics[-1]["loss"] < metrics[0]["loss"]:
        raise RuntimeError(f"6b: loss did not fall over {TRAIN_STEPS} steps")
    for k in ("zdelta_superwindow_search", "spconv_gather_gemm",
              "segment_sum"):
        paths[k]["minkunet42 train step"] = dict(launches=per_step[k])
    paths["spconv_gather_gemm"]["minkunet42 train step"].update(
        dF=per_forward(results.pop("os_df")))
    paths["segment_sum"]["minkunet42 train step"].update(
        per_forward(results.pop("segsum_train")))
    results["dw_gather_gemm"]["launches"] = counts["dw_gather_gemm"]
    paths["dw_gather_gemm"] = {"minkunet42 train step": dict(
        launches=per_step["dw_gather_gemm"],
        **per_forward(results["dw_gather_gemm"]))}
    train_expected = dict(expected)
    paths["masked_group_gemm"] = {"minkunet42 layers (6)": dict(
        launches=results["masked_group_gemm"]["launches"],
        **per_forward(results["masked_group_gemm"]))}
    profile_line("6b", lambda: trainer.step(tst, tlab), steady, card)
    out = sess(tst)
    n = int(out.count)
    if not (tuple(out.features.shape) == (bucket, tnet.n_classes)
            and bool(torch.isfinite(out.features[:n]).all())):
        raise RuntimeError("6b: the trained session's logits are not finite "
                           "or of the wrong shape")
    acc = float((out.features[:n].argmax(-1) == tlab[:n].long()).float()
                .mean())
    log(f"[6b serve] the session serves the trained weights: {n} finite "
        f"logits, accuracy {acc:.4f}")
    del trainer, out
    torch.cuda.empty_cache()

    tick("6b training main path")
    # -- 6c. gradients on the card -------------------------------------------
    gk = grads_vs_plain("6c grads", tnet, plain_tnet, sess.layout,
                        sess.params, stp.packed, stp.features, labp, card)
    st2 = tst.pad_to(2 * bucket)
    lab2 = torch.cat([labp, torch.full((bucket,), -1, dtype=torch.int32,
                                       device=tlab.device)])
    g2 = step_grads(tnet, sess.layout, "zdelta_cuda", "auto", sess.params,
                    st2.packed, st2.features, lab2)
    diff = [k for k in gk if not torch.equal(gk[k], g2[k])]
    if diff:
        raise RuntimeError(f"6c: gradients at bucket {2 * bucket} differ "
                           f"from bucket {bucket} in {diff[:3]}")
    log(f"[6c zero extension] all {len(gk)} parameter gradients at bucket "
        f"{2 * bucket} bitwise equal to bucket {bucket}")
    del gk, g2, st2, lab2, sess
    torch.cuda.empty_cache()

    tick("6c gradients")
    # -- 6d. WS backward at full width ---------------------------------------
    wnet = pc.minkunet42(in_channels=4, n_classes=20, dataflow="ws")
    wsess = compile_network(wnet, lbatch[0].layout, batch=2, seed=0,
                            cuda_graphs=False)
    wtrainer = wsess.compile_train()
    expected = {k: 0 for k in launch_counts()}
    expected.update({"zdelta_superwindow_search": n_l,
                     "zdelta_repair": n_l,
                     "ws_scatter_gemm": 2 * n_l - 1,
                     "segment_sum": 3 * n_l + 1,
                     "dw_gather_gemm": n_l + 1})
    times, metrics, counts = train_drive(wtrainer, tst, tlab, 2, expected,
                                         "6d ws train")
    log(f"[6d ws train] {wnet.name} dataflow ws, full width: 2 steps "
        f"{times[0]:.1f} / {times[1]:.1f} ms, loss {metrics[0]['loss']:.4f}"
        f" -> {metrics[1]['loss']:.4f}; ws_scatter_gemm launches per step "
        f"{expected['ws_scatter_gemm']} ({n_l} forward + {n_l - 1} dF over "
        f"the transposed kept maps, Cout 32-256), run total {counts} | "
        f"{card}")
    paths["ws_scatter_gemm"]["minkunet42 ws train step"] = dict(
        launches=expected["ws_scatter_gemm"], step_ms=times[1])
    grads_vs_plain("6d ws grads", wnet,
                   pc.minkunet42(in_channels=4, n_classes=20,
                                 dataflow="ws", backend="torch"),
                   wsess.layout, wsess.params, stp.packed, stp.features,
                   labp, card)
    del wtrainer, wsess
    torch.cuda.empty_cache()
    tick("6d WS backward")

    # -- 9. the self-healing trainer and its checkpoints ----------------------
    guard_phases(tnet, plain_tnet, lbatch, tst, tlab, train_expected, paths,
                 card)
    del lbatch, tst, tlab, stp, labp, tnet, plain_tnet
    torch.cuda.empty_cache()
    tick("9 guarded training and checkpoints")
    # -- 10. the point-cloud serving engine -----------------------------------
    serve_phases(batch, card, paths,
                 pc.minkunet42(in_channels=4, n_classes=20),
                 pc.centerpoint_large())
    tick("10 serving engine")
    # -- 11. one CUDA graph per key ---------------------------------------------
    graph_phases(batch, card, paths, tuned)
    tick("11a-c graphs")
    lm_phases(results, paths, card)
    tick("7 yi-9b serving, 11d decode graph")
    # -- 12. every LM architecture the reference configures ------------------
    arch_phases(results, paths, card, tick)
    tick("12d musicgen-medium")
    # -- 13. LM training ---------------------------------------------------------
    lm_train_phases(results, paths, card, tick)
    tick("13d launcher and every token architecture")
    # -- 14. the multi-card layer at world size 1, and the dry run ------------
    sharded_phases(results, paths, card, tick)
    # -- 15. the examples on the card ------------------------------------------
    examples_phase(results, paths, card, tick)

    # -- result ----------------------------------------------------------------
    table = []
    for name in REPLACES:
        r = dict(results[name])
        launches = r.pop("launches", None)
        if launches is None:            # slice 1's main path
            launches = paths[name]["minkunet42"]["launches"]
        src, rep = REPLACES[name]
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": rep, "launches": launches, **r,
                      "paths": paths.get(name, {})})
    for name, (src, rep) in PORT_ONLY.items():
        r = dict(results[name])
        launches = r.pop("launches")
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": rep, "port_only": True,
                      "launches": launches, **r,
                      "paths": paths.get(name, {})})
    log(json.dumps({"kernels": table}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
