#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed with its elapsed seconds; any failed check raises and
the script exits non-zero:
  1. device: the card's name and power limit (nvidia-smi); TF32 off.
  2. build: the CUDA kernels of csrc/ (one nvcc call) and their loading.
  3. K1, the fused linear-attention block, against its plain PyTorch
     version: all Darcy (N, C) shapes at B=4, ragged N, bf16, and the main
     path's shapes at B=64, where kernel and plain version are timed
     (device time: the calls are replayed from a CUDA graph), in fp32 and
     on bf16 x; then, untimed, fp32 and bf16 at the mechanics study's down
     path at B=6 (MECHANICS_DOWN_CALLS; phase 19b covers every call).
  4. K2, GroupNorm-FiLM-SiLU, the same way, with and without FiLM, after
     a line per distinct (N, C) with K2's launch plan (blocks a row, shared
     memory a block, resident or re-read); timed on bf16 x too, and checked
     untimed at MECHANICS_DOWN_CALLS, B=6, fp32 and bf16.
  5. one fp32 UNet forward (B=8) of the committed 300k Darcy checkpoint on
     the card (kernels) against the same forward on the CPU (plain
     versions).
  6. the sampling path: ``sample_eval`` at full width, 64 samples, 100
     steps, fp32, seed 0. The launch counts are zeroed just before and read
     just after; each kernel must have run once per UNet call (K1 8x, K2 38x
     per step), and the residual median must lie in [6.8e-3, 2.7e-2], 0.5x to
     2x the JAX package's fp32 evaluation of the same checkpoint (1.351e-2).
  7. K1's backward kernel against torch autograd through the plain version,
     every path shape and two ragged ones at B=4 and B=64 (each gradient
     within GRAD_TOL of the largest entry of its tensor), timed at B=64;
     then, untimed, fp32 and bf16 at MECHANICS_DOWN_CALLS at B=6 (bf16
     within BF16_DX_TOL and BF16_PARAM_TOL); and the backward's workspace
     at B=64, N=4096, C=32, at most K1_BWD_WORKSPACE_MAX.
  8. K2's backward kernels the same way, with and without FiLM, and
     untimed at MECHANICS_DOWN_CALLS, B=6, fp32 and bf16.
  9. the training path: (a) a Darcy set from the port's generator (256
     train, 64 valid; made by its CLI in the background from the end of
     phase 2, as are 19a's sets after it: ``DataJobs``); (b) one train step at B=8 from the 300k EMA weights,
     card (kernels) against CPU (plain versions); (c) the loss of the 300k
     EMA weights over 8 validation batches of 64, inside EMA_LOSS_BAND, its
     data part inside EMA_DATA_LOSS_BAND and its mean |residual| inside
     EMA_RESIDUAL_BAND; (d) TRAIN_STEPS (50) steps at B=64, full width, fp32, fresh
     Adam, with the launch counts zeroed just before and read just after
     (K1 and K2 forward and backward once per UNet call: 8 and 38 per step,
     none on bf16 x), finite losses and a mean of the last 50 below
     LAST50_MAX; (e) a checkpoint save and restore (EMA
     weights back bit for bit, and their forward under cuDNN's
     deterministic algorithms bit-equal to the saved weights'); (f) the
     training CLI for 3 steps, and ``sample_eval`` of its checkpoint.
 10. K3, the linear attention alone (a mode of K1's kernels): forward
     against its plain version at every path shape and two ragged ones, at
     B=4 and B=64, fp32 and bf16; its backward against torch autograd
     through the plain version the same way; both timed at B=64; K1(x)
     against x + b_out + K3(LN(x)) at every path shape at B=4; then the
     main path of K3: ``profile_attn``'s level-0 stage (two resnet blocks,
     then ``PreNormResidual(SpatialLinearAttention)``), one eager forward
     and one eager forward + backward, with K3's launch counts zeroed just
     before and read just after (2 forward, 1 backward), its output against
     the stage through the plain version and through K1; then the stage's
     times through K3 and through K1.
 11. corrected sampling: one ``residual_correction`` of phase 6's 64 final
     samples on the card and on the CPU (x and residual within 1e-5 of
     their largest entry); then ``sample_eval`` as in phase 6 with CoCoGen
     corrections in x0 and in xt mode (N=10, M=5, and M=0 for the in-loop
     corrections alone): residual median in the same range, launches K1
     800 and K2 3800 (the corrections call no model), samples that differ
     from phase 6's.
The phases run in this order: 1-8, then every other kernel timing (10,
12, 14, 15ab); then 20 and 21, which need none of 9a's data; then 9, 13,
15c-f, 16-19, 22, 11 and 24, sharing one temporary directory with phase
9's data. Work that times nothing is kept off the critical path:
  * the background: from phase 1 on, the data jobs make 9a's and 19a's
    sets, and a CPU-reference worker (this script with ``--cpu-refs``, the
    card hidden from it) computes the CPU halves of the card vs CPU checks
    9b, 13a, 15e, 16b, 17c, 19c, 22 and 24c (their inputs and the CPU's loss,
    gradients and outputs; CPU_REFS) as soon as their data is made. Each
    is a niced process group that ``Background.quiet`` stops (SIGSTOP)
    while any phase times, on the host clock or a graph replay, and lets go
    on after; the card halves read the worker's files;
  * the window: the checks that time nothing run after 19d's timing, the
    last of the main paths', in three kinds of process side by side: this
    one (19e, 22, 11, then 9b, 9e, 13a, 15c, 15e, 16b, 17a, 17c, 21a-b,
    21d, 24b, 24c, 19b, 19a's checks, 19c), the card lane (this script with
    ``--lane``: 18a, 9f, 13d, 20a, 5, 24a; LANE_CHECKS) and phase 23's two
    ranks with its torchrun
    CLI. The lane and the ranks start after the build and import meanwhile
    (stopped, as the background, while a phase times); 23's timed turns
    run last, on a quiet card.
The line before the kernel line gives the run's serial CPU work in
seconds: each CPU reference (as the worker timed it), the host-clock timed
work by phase, the rank processes' start-up, and how long each card half
waited for its CPU reference.
 12. the bf16 backward kernels of K1, K2 and K3 against torch autograd
     through their plain versions on the same bf16 input, at every path
     shape (and the ragged ones) at B=4 and B=64: dx within BF16_DX_TOL of
     its largest entry (one bf16 rounding of the output), the fp32
     parameter gradients within BF16_PARAM_TOL; timed at B=64.
 13. bf16 training, the study's recipe (bf16 compute, fp32 head): (a) one
     train step on the card and on the CPU from the 300k EMA weights, held
     to the two sides' own gap between their bf16 and fp32 step on the same
     inputs (the loss within twice the larger gap, the whole gradient
     within twice the card's, each parameter's gradient within 6x;
     STEP_BF16_*), with K1 and K2 launched on bf16 x but the fp32 head's
     two K2 (BF16_STEP_LAUNCHES);
     (b) the loss of the 300k EMA weights in bf16 (8 validation batches of
     64), loss and mean |residual| within 0.5x-2x of the JAX package's bf16
     + fp32-head reference (EMA_BF16_LOSS_BAND, EMA_BF16_RESIDUAL_BAND);
     (c) the main path: TRAIN_STEPS steps at B=64 from those weights, fresh Adam,
     with the launch counts zeroed just before and read just after (K1 8
     and K2 38 forward and backward per step, all on bf16 x but the fp32
     head's two K2 calls, forward and backward), finite losses, last-50
     mean below LAST50_MAX; (d) the training CLI with
     ``--compute-dtype bfloat16 --fp32-head`` for 3 steps, and
     ``sample_eval`` of its checkpoint in bf16, 64 samples.
 14. K5, the lane-packed bf16 GroupNorm-FiLM-SiLU, against its plain
     version and against K2's forward on the same bf16 input (within
     K5_TOL of the largest output) at [64, 4096, 32], [64, 1024, 64] and
     [64, 256, 128], each with its launch plan (one cluster a batch row:
     blocks a row, shared memory a block, clusters at once); then K5's
     path, ``profile_gn`` at the level-0 shape, with K5's launch count
     zeroed just before and read just after, and a CUDA graph of one call
     holding one node, a kernel; K5 and K2's bf16 forward timed at each
     shape.
 15. K4 and the channel-major UNet (``cm_conv_stages``): (a) K4's forward
     against its plain version at every (P, Ci, Co) of the cm UNet's calls
     and a ragged P=24, with and without FiLM, fp32 and bf16, B=4 and B=64
     (within TOL of the largest output); (b) its backward against autograd
     through the plain version on the same inputs (fp32 each gradient within
     GRAD_TOL of its max; bf16 dx and dW within BF16_DX_TOL, dW rounded to
     bf16, the fp32 parameter gradients within BF16_PARAM_TOL); both timed
     at B=64 beside their bounds, the plain version and the port's default
     Block (cuDNN conv + K2) at the same shape; (c) the 300k checkpoint's cm
     forward at B=8, card vs CPU; (d) cm sampling, 64 samples x 100 steps,
     fp32, seed 0, launch counts K1 800, K2 2000, K4 1800, the residual
     median in the phase 6 range and within 10% of phase 6's; (e) one cm
     train step card vs CPU (9b's rules), then TRAIN_STEPS cm steps at B=64 as 9d,
     K1 8/8, K2 20/20, K4 18/18 per step; (f) TRAIN_STEPS cm steps in bf16 with the
     fp32 head as 13c, K1 8/8, K2 22/22 (20 on bf16 x), K4 16/16 (all on
     bf16 x); steps/s beside 9d's and 13c's.
 16. DDIM x0 sample-estimation, on ``results/darcy_sample_100k`` (ddim_steps
     0: two UNet calls a loss): (a) its sampling, 64 fp32 samples, seed 0,
     launches K1 800 and K2 3800, the residual median in DDIM_MEDIAN_RANGE
     (0.5x-2x the run's fp32 CPU evaluation); (b) one DDIM train step at
     B=16, card vs CPU (9b's rules); (c) its training main path, DDIM_STEPS
     steps at B=16, fp32, K1 16/16 and K2 76/76 a step.
 17. residual-gradient guidance, on ``results/darcy_guided_100k``: (a) the
     conditioned forward (a mixed null mask) and the residual gradient,
     card vs CPU; (b) guided sampling at scales 1 and 3, 64 fp32 samples,
     launches K1 1600 and K2 7600 (two UNet calls a step), each median
     within 0.5x-2x the JAX package's fp32 CPU median of the same weights
     and scale; (c) one guided train step at B=64 with a mixed mask, card vs
     CPU; (d) its training main path in the run's bf16, GUIDED_STEPS steps,
     K1 8 and K2 38 a step, all on bf16 x.
 18. the training step as a CUDA graph (``trainer.GraphedTrainStep``): (a)
     GRAPH_STEPS replayed steps bit-equal to as many eager steps (weights,
     EMA, Adam state, counters, last loss) under cuDNN's deterministic
     algorithms, with ``ema_start`` inside the run (two captures), in fp32,
     bf16 + fp32 head and the guided recipe; launches counted only while
     capturing; (b) steps/s of 9d's and 13c's training eager and from the
     graph, in turns, beside 9d's and 13c's own.
 19. the mechanics study, ``UNet(dim=128, channels=10, out_dim=3,
     sigmoid_last_channel=True)`` (131.7M parameters, seeded weights): (a)
     MECH_SETS from the port's SIMP generator (``generate_mechanics_sets``,
     in the background);
     on the card, the fields' own FEM residual (mean |r| below
     MECH_DATA_RESIDUAL_MAX) and the batched PCG on their designs against
     the host's float64 sparse-LU solve (compliance within MECH_CE_TOL;
     iterations, relres and the host check's fallbacks printed); (b) the model's K1 and K2
     calls, recorded (N, C, FiLM, dtype) by hooks in one forward of the
     bf16 + fp32-head model, each distinct shape held against its plain
     version at B=6, forward and backward, fp32 and bf16, with K2's plans;
     (c) card vs CPU at B=MECH_STEP_BATCH: the fp32 forward (phase 5's
     tolerance), one fp32 train step of the mechanics loss (9b's rules) and
     one bf16 + fp32-head step (13a's rules); (d) the training CLI
     (``train --gov-eqs mechanics``), bf16 + fp32 head, B=6, MECH_CLI_STEPS
     steps with ``--chunk-steps`` MECH_CHUNK (step 0 eager, the rest graph
     replays), ending in a sampling pass with the topopt metrics and a
     checkpoint, launches counted, peak memory; then steps/s eager and from
     the graph in turns; (e)
     ``sample_eval``'s mechanics sweep of that checkpoint, one batch of 6 a
     test level: the five CSVs a level, every metric finite, launches
     counted, samples/s and PCG seconds a batch.
 20. the toy study at the JAX driver's full width (``ConditionalModel(2, 100,
     128)``, B=128): (a) the forward, then one fp32 loss and its gradients
     for each prediction mode (x0, eps, mu) and x0 estimate (mean, sample),
     card vs CPU (9b's rules); (b) the ``train_toy`` CLI on the card for
     TOY_EPOCHS epochs with its 1000-sample pass: steps/s, samples/s, the
     sample residual, every logged loss finite. The toy runs no kernel.
 21. the batched SIMP (``data/mechanics_generator_gpu.py``): (a) card vs CPU
     on the JAX generator tests' P=16 scenarios, 3 iterations (designs
     within SIMP_CARD_ATOL); (b) 12 iterations against the host SIMP at
     JAX's tolerances; (c) one full-width batch (SIMP_FULL: B=64, P=64, 30
     iterations), its fields from the host's exact solve: seconds a batch,
     CG iterations a SIMP iteration, the largest relres, the fields' mean
     |K u - f| below MECH_DATA_RESIDUAL_MAX; (d) one train set in two
     shards by the ``generate_mechanics_sets`` CLI, ``--start-index 0`` on
     the card and ``--start-index SHARD_N`` on the host (P=16, 3
     iterations): the file names, the shard CSVs, the merged scenarios.csv
     (every index once, in order, the families round-robin) and each
     field's residual. No kernel.
 22. the UNet's circular padding (``bcs='periodic'``), without and with
     self-conditioning: ``build_model`` at UNet(dim=32, channels=2), 64x64,
     B=OPTIONS_BATCH, seeded weights, 9a's fields; the forward (with an
     x_self_cond) and one fp32 step on the periodic Darcy residual, card vs
     CPU (phase 5's and 9b's rules); K1 and K2 launch counts zeroed before
     and read after each: 8 and 38 a UNet call, forward and backward. Then
     the frame axis: a [FRAMES_BATCH, FRAMES, 64, 64, 2] forward of
     UNet(dim=32, multi_frame=True), seeded, card vs CPU (phase 5's
     tolerance), the frames folded into the batch of each K1 and K2 call (8
     and 38 launches).
 23. the parallel layer (``parallel/``) on PAR_WORLD ranks sharing the card
     over gloo (NCCL refuses two ranks on one device): two processes of
     this script, started after the build, whose checks run in the window
     after 19d's timing: (a) data parallelism, UNet(dim=32) from the 300k
     EMA weights, one
     step at B=64 (32 a rank) against the one-process B=64 step on the card,
     fp32 (9b's rule; the updated weights by PAR_MOVED_TOL's) and bf16 +
     fp32 head (13a's rule), and fp32 again on a (slice, dp, tp) = (2, 1,
     1) mesh, K1 8 and K2 38 launches a forward and a backward on each
     rank; (b) sequence-parallel linear attention, the same UNet on a (dp,
     tp) = (1, 2) mesh: the forward at B=8 within phase 5's tolerance of
     the one-process forward, the input's and each parameter's gradient
     within STEP_GRAD_TOL (SP_LAUNCHES); (c) tensor parallelism, the
     mechanics UNet at full width, seeded, B=6, bf16 + fp32 head, tp=2 with
     ``tp_shard_activations``: one step against the one-process step (13a's
     rule; fp32 beside it by 9b's), K1 8 and K2 38 launches, K2 at each
     shape of a column-parallel Block (C/2 channels in 4 groups) against
     its plain version forward and backward, fp32 and bf16, each rank's
     bytes of parameters, Adam and EMA (at most PAR_STATE_SHARE_MAX of the
     whole model's) and its peak memory; at the end, on a quiet card, the
     steps/s of (a)'s fp32 step and (c)'s bf16 step eager in turns, one
     process and two ranks (the collectives' cost, not a scaling); (d) the
     training CLI under ``torchrun --standalone --nproc-per-node 1
     --mesh-dp 1`` (NCCL) for 3 steps on 9a's sets, bf16 + fp32 head,
     started with the ranks' checks (the ranks and it niced) and ended
     before their timed turns,
     and with ``--mesh-tp 2`` and no process group, which must exit
     non-zero naming torchrun. A rank that fails or hangs fails the phase.
 24. the last modules, timing nothing: (a) ``export_portable_checkpoint``
     of 9f's card-trained run: every leaf the run's EMA weight rounded to
     float16, no raw weights or optimizer state; ``sample_eval.load_run``
     of the portable directory, one fp32 forward at B=8 card vs CPU
     (phase 5's tolerance), K1 8 and K2 38 launches; (b) the committed
     300k EMA weights (phase 5's) without the frame attention, rewritten
     into the reference Unet3D's layout (REFERENCE_LAYOUT, the inverse of
     ``models/reference_port.py``'s transforms) with dead-module tensors,
     ``torch.save``d as ``{'model': sd}`` and imported by
     ``import_reference_checkpoint``: both checkpoint slots bit-equal to
     those weights, and the imported model's card forward bit-equal to
     phase 5's forward of the same weights in UNet(frame_attention=False),
     under cuDNN's deterministic algorithms, K1 8 and K2 38 launches; (c)
     UNet(dim=32, init_dim=48, use_sparse_linear_attn=False,
     cond_path=False), seeded: the forward (given a cond, which it ignores)
     and one fp32 step card vs CPU by phase 5's and 9b's rules, no K1 and
     38 K2 launches a UNet call, forward and backward.
The last three lines are a JSON object with each kernel's launches (counted
on the fp32 training path for K1 and K2, on the bf16 one for their
forward and backward on bf16 x (K2's: 36 of a step's 38), on the stage run
of phase 10 for K3, on ``profile_gn`` for K5, on 15e, and 15f for
``bf16_launches``, for K4; K1's and K2's ``mechanics_launches`` on 19d's
CLI run, their fp32 ``unet_options_launches`` on phase 22's steps, and
their ``parallel_launches`` on rank 0 of 23a's fp32 step and (the bf16
entries) of 23c's tensor-parallel step), error
and times (K4's also the default Block's and bf16 ones), the nvidia-smi
line, and ``{"ok": true, "device": {...}}``.
Exits 2 without a result where torch.cuda.is_available() is false.
"""

from __future__ import annotations

import atexit
import contextlib
import csv
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
RUN = ROOT / "results" / "darcy_300k_fp32head" / "portable"
# NVIDIA H100 SXM data sheet: HBM bandwidth, the fp32 (non-tensor-core)
# rate and the dense bf16 tensor-core rate. The fp32 path runs with TF32
# off, so fp32 is the rate that applies to it. On bf16 input the TPU
# kernels multiply in bf16 (``md = x_ref.dtype``, pallas_attention.py:543),
# so the same work on bf16 input is held to the bf16 rate, whatever
# precision the port's kernels compute in.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS, PEAK_BF16_FLOPS = 67e12, 989e12
# kernel vs plain version, fp32: the same arithmetic summed in another order
# (streamed token softmax, tiled reductions); bf16: the output's rounding
TOL = {"fp32": 1e-4, "bf16": 1e-2}
# K1 divides v by N and its k softmax averages v over the tokens, so with
# unit-scale weights LA(LN(x)) is 1e-5 to 1e-3, below TOL beside x. W_out is
# scaled by K1_GAIN * N to bring the attention term to the size of x, and
# every fp32 comparison requires max |LA| >= K1_MIN_TERM (1e4 x TOL), so a
# kernel that drops or breaks the attention fails.
K1_GAIN, K1_MIN_TERM = 100.0, 1.0
# one UNet(dim=32) forward at 64x64: the (N, C) of each K1 call, and of
# each K2 call with its FiLM flag
K1_CALLS = [(4096, 32), (1024, 64), (256, 128), (64, 256),
            (64, 128), (256, 64), (1024, 32), (4096, 32)]
# K1's backward keeps no per-token workspace: at the level-0 shape (B=64,
# N=4096, C=32) its workspace (partial sums a block) stays below this
K1_BWD_WORKSPACE_MAX = 64 * 2**20
# the mechanics UNet's down-path (N, C), at which phases 3, 4, 7 and 8 have
# checked K1 and K2 at B=6 since PRs 9-10 (the draws of every later phase
# follow from them); phase 19b checks every (N, C) of the UNet's calls,
# taken from the model itself
MECHANICS_DOWN_CALLS = [(4096, 128), (1024, 256), (256, 512), (64, 1024)]
K2_CALLS = ([(n, c, film) for n, c in K1_CALLS[:4] + [(64, 256)] + K1_CALLS[4:]
             for film in (True, False) for _ in range(2)]
            + [(4096, 32, False)] * 2)
RESIDUAL_RANGE = (6.8e-3, 2.7e-2)
SAMPLES, STEPS = 64, 100
# backward kernel vs torch autograd through the plain version, fp32: each
# gradient tensor within GRAD_TOL x its largest entry (the token and batch
# sums run in another order: split reductions, tiled products)
GRAD_TOL = 1e-4
# one train step, card vs CPU: the loss to STEP_LOSS_RTOL relative and each
# parameter's gradient to STEP_GRAD_TOL x its largest entry (fp32 on both;
# the card's kernels and cuDNN's backward sum in another order than the CPU)
STEP_LOSS_RTOL, STEP_GRAD_TOL = 1e-5, 1e-3
# the loss of the 300k EMA weights on this script's validation set: 0.5x-2x
# the JAX package's own fp32 loss of the same weights on the same set, 8
# batches of 64 on the CPU (`JAX_PLATFORMS=cpu python
# tests/test_torch_ema_loss.py`: loss 0.019174, mean |residual| 0.030962;
# PERF.md). The JAX run's logged loss_test (0.0475 over its last 20k
# iterations) is no yardstick for fp32: on the TPU its residual_mean_abs_test
# was 0.217, and that residual term made up half its loss. Its data part
# carries over: the data loss must lie within 0.5x-2x the run's mean
# loss_data_test over its last 20k iterations (0.0189,
# results/darcy_300k_fp32head/metrics.csv). The residual term is ~2% of the
# loss, so the mean |residual| has a band of its own, 0.5x-2x the JAX fp32
# reading.
EMA_LOSS_BAND, EMA_DATA_LOSS_BAND = (0.0096, 0.0383), (0.0094, 0.0378)
EMA_RESIDUAL_BAND = (0.0155, 0.0619)
# 50 steps from those weights (cut from 200 to 100 to make room for phases
# 16-18, and to 50 for phase 19): the mean of the last 50 losses below 3x
# the JAX run's mean training loss over its last 20k iterations (0.037)
TRAIN_STEPS, TRAIN_BATCH, LAST50_MAX = 50, 64, 0.11
# the launches of one train step: (forward, forward on bf16 x, backward,
# backward on bf16 x) of K1, then of K2, then of K4, one of each per UNet
# call; the default UNet calls no K4. In bf16 with the fp32 head every call
# takes bf16 x but the two K2 calls of the head's fp32 ResnetBlock.
FP32_STEP_LAUNCHES = ((8, 0, 8, 0), (38, 0, 38, 0), (0, 0, 0, 0))
BF16_STEP_LAUNCHES = ((8, 8, 8, 8), (38, 36, 38, 36), (0, 0, 0, 0))
N_TRAIN, N_VALID = 256, 64
# phase 11: CoCoGen corrections in the last N steps and M post-steps; one
# correction card vs CPU, x and residual each within CORRECTION_TOL of the
# largest entry (fp32; the FD sums run in another order)
N_CORRECTION, M_CORRECTION, CORRECTION_TOL = 10, 5, 1e-5
# phase 12: bf16 backward kernel vs autograd through the plain version on
# the same bf16 input: dx is written in bf16 (one rounding, and the inputs'
# own rounding carried through the fp32 sums in another order), the
# parameter gradients stay fp32
BF16_DX_TOL, BF16_PARAM_TOL = 2e-2, 1e-3
# phase 13a, bf16 train step card vs CPU, as tests/test_torch_bf16_train.py
# holds the port against JAX (the two sides round about as much as each
# other, independently, and a gradient that nearly cancels carries a
# rounding of several % of its norm): the loss within STEP_BF16_LOSS x the
# larger of the two sides' own bf16 rounding (a scalar's rounding is one
# draw a side; with the fp32 losses equal this bounds each bf16 loss by its
# own rounding, no more); (multiple of the card's own rounding, floor as a
# share of the CPU norm) for the whole gradient and each parameter's (L2)
STEP_BF16_LOSS, STEP_BF16_WHOLE, STEP_BF16_EACH = 2, (2, 1e-3), (6, 1e-3)
# phase 13b: 0.5x-2x the JAX package's bf16 + fp32-head loss and mean
# |residual| of the 300k EMA weights on this script's validation set (8
# batches of 64 on the CPU, tests/test_torch_ema_loss.py run as a script:
# 0.019340 and 0.036840; PERF.md). No bf16 data-loss reference is recorded;
# the data loss is printed.
EMA_BF16_LOSS_BAND, EMA_BF16_RESIDUAL_BAND = (0.00967, 0.03868), (0.01842, 0.07368)
# phase 14: K5 against its plain version and against K2's forward, bf16
# outputs: within K5_TOL of the largest output (a bf16 rounding; the
# one-pass variance against K2's shifted sums)
K5_TOL = 1e-2
K5_SHAPES = [(4096, 32), (1024, 64), (256, 128)]
# phase 15: one UNet(dim=32, cm_conv_stages=True) forward at 64x64, fp32:
# the (P, Ci, Co, FiLM) of each K4 call, down levels 0 and 1, up stages 2
# and 3, the final block; under the fp32 head the final block's two calls
# are natural (cuDNN + K2), so the bf16 + fp32-head forward makes the first
# 16
K4_CALLS = ([(64, 32, 32, True), (64, 32, 32, False)] * 2
            + [(32, 32, 64, True), (32, 64, 64, False), (32, 64, 64, True), (32, 64, 64, False)]
            + [(32, 128, 32, True), (32, 32, 32, False), (32, 32, 32, True), (32, 32, 32, False)]
            + [(64, 64, 32, True), (64, 32, 32, False), (64, 32, 32, True), (64, 32, 32, False)]
            + [(64, 64, 32, False), (64, 32, 32, False)])
K4_HEAD_CALLS = 16
# a shape whose P*P (576) is not a multiple of the kernels' 128-pixel tile
K4_RAGGED = (24, 64, 32)
# launches of one cm train step (rows as FP32_STEP_LAUNCHES): K4 replaces
# cuDNN + K2 in 18 Blocks (16 under the fp32 head); K1 runs 4 of its 8
# calls on transposed channel-major input
CM_FP32_STEP_LAUNCHES = ((8, 0, 8, 0), (20, 0, 20, 0), (18, 0, 18, 0))
CM_BF16_STEP_LAUNCHES = ((8, 8, 8, 8), (22, 20, 22, 20), (16, 16, 16, 16))
# cm sampling's residual median within CM_MEDIAN_RTOL of phase 6's
CM_MEDIAN_RTOL = 0.1
# phase 16: the DDIM x0 sample-estimation run (x0_estimation='sample',
# ddim_steps 0: two UNet calls a loss, batch 16). Its fp32 sampling median
# within 0.5x-2x the run's fp32 CPU evaluation, 7.819e-3
# (results/darcy_sample_100k/evaluation_2/validation/sample_statistics.csv);
# DDIM_STEPS steps of its training main path, K1 and K2 twice a step
SAMPLE_RUN = ROOT / "results" / "darcy_sample_100k" / "portable"
DDIM_MEDIAN_RANGE = (3.91e-3, 1.56e-2)
DDIM_STEPS, DDIM_BATCH = 25, 16  # 100 until phase 19, 50 until phase 23
DDIM_STEP_LAUNCHES = ((16, 0, 16, 0), (76, 0, 76, 0), (0, 0, 0, 0))
# phase 17: the residual-gradient guidance run (bf16 compute, no fp32 head).
# Guided fp32 sampling medians within 0.5x-2x the JAX package's own fp32 CPU
# medians of the same weights, 64 samples, seed 0 (`JAX_PLATFORMS=cpu python
# sample_eval.py --model-dir <copy of results/darcy_guided_100k/portable>
# --compute-dtype float32 --no-samples 64 --guidance-scale S`; PERF.md). The
# committed medians (4.40e-2, 1.20e-1) are bf16 on a TPU and set no target.
GUIDED_RUN = ROOT / "results" / "darcy_guided_100k" / "portable"
GUIDED_JAX_FP32_MEDIANS = {1.0: 1.0531e-2, 3.0: 1.0666e-2}
GUIDED_STEPS = 25  # 50 until phase 23
# its training step: one conditioned UNet call, all on bf16 x
GUIDED_STEP_LAUNCHES = ((8, 8, 8, 8), (38, 38, 38, 38), (0, 0, 0, 0))
# phase 18: graph-replayed steps against eager steps, bit for bit, with the
# EMA gate crossed inside the run; then steps/s both ways, in turns (40, 20
# and 50 until phase 19 came; 20 and 10 until phase 23)
GRAPH_STEPS, GRAPH_EMA_START, GRAPH_TIMED_STEPS = 12, 6, 20
# phase 19: the mechanics study at full width, seeded weights. The sets of
# the port's SIMP generator: 6 each (a batch), 3 SIMP iterations (the
# study's sets take 50; the final solve is exact either way)
MECH_SETS = dict(n_train=6, n_valid=6, n_test=6, n_iter=3, seed=0)
MECH_BATCH, MECH_SEED = 6, 0
# the fields' own FEM residual, mean |r| a sample (max |u| = 1): the solver's
# precision (float32 fields: ~5e-9 on the CPU)
MECH_DATA_RESIDUAL_MAX = 1e-6
# the PCG's compliance against the host's float64 sparse-LU solve of the
# same system, relative (3e-6 at most on the CPU); float32 PCG that has not
# stalled stays below PCG_RELRES_MAX. (The fields' own u, stored in float32,
# is no reference: its compliance is up to 4.5e-4 from the solve's.)
MECH_CE_TOL, PCG_RELRES_MAX = 1e-4, 1e-2
# card vs CPU at full width: B=2 (a B=6 fp32 + bf16 step pair on the CPU
# takes longer than the phase's share of the run)
MECH_STEP_BATCH = 2
# the training CLI: steps a run (eager, then resumed with graph chunks),
# its eval cadence, and the steps timed a turn for steps/s
MECH_CLI_STEPS, MECH_CHUNK, MECH_TIMED_STEPS = 20, 10, 5
# the CLI's sample pass: no_samples of the committed run's config
MECH_CLI_SAMPLES = 4
# phase 20: the toy study at the JAX driver's full width (ConditionalModel(2,
# 100, 128), B=128 of 10^4 points, a 1000-sample pass): 20a card vs CPU in
# each prediction mode and x0 estimate (9b's rules), 20b the CLI for
# TOY_EPOCHS epochs (epochs 0..TOY_EPOCHS, one sampling pass at epoch 0)
TOY_MODES = [(m, e) for m in ("x0", "eps", "mu") for e in ("mean", "sample")]
TOY_EPOCHS = 2
# phase 21: the batched SIMP. (a) and (b): the scenarios of the JAX
# package's own generator tests at P=16 (tests/test_mechanics_generator_tpu.py):
# card vs CPU at 3 SIMP iterations (the designs within SIMP_CARD_ATOL: the
# float32 CG sums in another order, 3.8e-5 between the port and JAX on the
# CPU), and 12 iterations against the host SIMP at JAX's tolerances (vf
# within 2e-3, mean |rho - rho_host| < 0.01, 97% of the binarised design
# equal); (c) one full-width batch, JAX generate_dataset_tpu's defaults
SIMP_FAMILIES, SIMP_VF = ("cantilever", "bridge", "double_clamp"), (0.4, 0.5, 0.35)
SIMP_CARD_ATOL = 2e-4
SIMP_FULL = dict(batch=64, P=64, n_iter=30)
# 21d: fields a shard (one train set: a card shard from 0, a host shard after it)
SHARD_N = 3
# phase 22: the UNet's circular padding, without and with self-conditioning,
# UNet(dim=32, channels=2) at 64x64, B=16, seeded weights; card vs CPU (the
# forward within phase 5's 5e-4, one fp32 step on a periodic Darcy residual
# by 9b's rules); K1 and K2 launched once a UNet call, forward and backward
OPTIONS_BATCH = 16
# phase 22's frame axis (JAX's test_video_frames_path: F=3): [B, F, 64, 64,
# 2] through UNet(dim=32, multi_frame=True), the frames folded into K1's
# and K2's batch, so still 8 and 38 launches a forward
FRAMES_BATCH, FRAMES = 2, 3
OPTIONS_FWD_LAUNCHES = ((8, 0, 0, 0), (38, 0, 0, 0), (0, 0, 0, 0))
# phase 24c: UNet(dim=32, init_dim=PLAIN_INIT_DIM, use_sparse_linear_attn=False,
# cond_path=False) at 64x64, B=PLAIN_BATCH, seeded weights; card vs CPU by
# phase 5's and 9b's rules; no K1 and 38 K2 a UNet call, forward and backward
PLAIN_INIT_DIM, PLAIN_BATCH = 48, 8
PLAIN_FWD_LAUNCHES = ((0, 0, 0, 0), (38, 0, 0, 0), (0, 0, 0, 0))
PLAIN_STEP_LAUNCHES = ((0, 0, 0, 0), (38, 0, 38, 0), (0, 0, 0, 0))
# phase 23: the parallel layer (parallel/) on PAR_WORLD ranks that share
# the one card over gloo (NCCL refuses two ranks on one device), each rank
# a process of this script (``--parallel-rank``), started after phase 1;
# their checks run after 19d's timing, beside 19e, 22, the deferred
# card vs CPU steps and 11, their
# timed turns at the end, on a quiet card. A collective waits at most
# PAR_COLLECTIVE_S, a rank for the main process or the main process for
# the ranks PAR_JOIN_S.
PAR_WORLD, PAR_COLLECTIVE_S, PAR_JOIN_S = 2, 240, 600
# the CPU-reference worker waits at most this long for a data part
DATA_WAIT_S = 900
PAR_DARCY_BATCH, PAR_SP_BATCH, PAR_MECH_BATCH = 64, 8, 6
# a forward and backward of the sequence-parallel UNet: no K1 (its attention
# is plain PyTorch on each rank's tokens, as in JAX), K2 38 and 38
SP_LAUNCHES = ((0, 0, 0, 0), (38, 0, 38, 0), (0, 0, 0, 0))
# Adam's first step moves every entry by about lr whatever the size of its
# gradient, so an entry whose gradient lies at the rounding of a sum taken
# in another order may move another way: after one fp32 step, all but
# PAR_MOVED_SHARE of the weights within PAR_MOVED_TOL x lr of the
# one-process step's
PAR_MOVED_TOL, PAR_MOVED_SHARE = 0.05, 1e-3
# each rank's parameters, Adam moments and EMA at tp=2 (16 B a parameter):
# at most this share of the whole model's (JAX's rule splits 99.94% of the
# mechanics UNet's 131.7M parameters)
PAR_STATE_SHARE_MAX = 0.55
# timed turns (one process, two ranks, two ranks, one process), steps a turn
PAR_TIMED = {"darcy": 3, "mechanics": 3}


# the serial CPU work of a run, seconds by kind and phase: the CPU references
# of the card-vs-CPU checks, the host-clock timed work (eager steps,
# sampling, CLIs) and the rank processes' start-up; printed as one line
SERIAL: dict = {"cpu_references": {}, "timed_host": {}, "rank_startup": {}}


@contextlib.contextmanager
def serial(kind: str, name: str):
    """Adds the seconds of the block to SERIAL[kind][name]."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        SERIAL[kind][name] = SERIAL[kind].get(name, 0.0) + time.perf_counter() - t0


class Background:
    """The script's background work that times nothing (the data jobs, the
    CPU-reference worker), each process in a session of its own: ``quiet()``
    stops every such process group (SIGSTOP) while the block inside it
    times, and lets them go on after (SIGCONT), so that no timed work
    shares the host's cores with them."""

    def __init__(self):
        import threading

        self.groups, self.depth, self.lock = set(), 0, threading.Lock()

    def add(self, pid: int) -> None:
        import signal

        with self.lock:
            self.groups.add(pid)
            if self.depth:
                self._signal(pid, signal.SIGSTOP)

    def discard(self, pid: int) -> None:
        with self.lock:
            self.groups.discard(pid)

    @staticmethod
    def _signal(group: int, sig) -> None:
        try:
            os.killpg(group, sig)
        except ProcessLookupError:  # it has ended
            pass

    @contextlib.contextmanager
    def quiet(self):
        import signal

        with self.lock:
            self.depth += 1
            if self.depth == 1:
                for g in self.groups:
                    self._signal(g, signal.SIGSTOP)
        try:
            yield
        finally:
            with self.lock:
                self.depth -= 1
                if self.depth == 0:
                    for g in self.groups:
                        self._signal(g, signal.SIGCONT)


BACKGROUND = Background()


@contextlib.contextmanager
def timed(name: str):
    """Host-clock timed work of phase ``name``: the background work waits
    meanwhile, and SERIAL records its seconds."""
    with BACKGROUND.quiet(), serial("timed_host", name):
        yield


def phase(name: str):
    print(f"[{name}] start", flush=True)
    return name, time.perf_counter()


def done(ph, **info) -> None:
    name, t0 = ph
    extra = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"[{name}] done in {time.perf_counter() - t0:.2f} s {extra}".rstrip(), flush=True)


def compare(got, ref, tol: float, what: str) -> float:
    import torch

    err = (got.float() - ref.float()).abs().max().item()
    if not torch.isfinite(got).all() or not torch.allclose(got.float(), ref.float(),
                                                           atol=tol, rtol=tol):
        raise AssertionError(f"{what}: kernel and plain version differ, max |diff| {err:.3e}")
    return err


def bound_ms(nbytes: float, flops: float, peak_flops: float = PEAK_FP32_FLOPS
             ) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def k1_work(b: int, n: int, c: int, h: int = 256, dh: int = 32,
            elt: int = 4) -> tuple[float, float]:
    """Bytes (x read and out written, ``elt`` bytes each; weights read once,
    fp32) and matmul flops of K1."""
    nbytes = elt * 2 * b * n * c + 4 * (3 * h * c + h * c + 2 * c)
    flops = 2 * b * (n * c * 3 * h + n * h * dh + h * dh * c + n * h * c)
    return nbytes, flops


def k2_work(b: int, n: int, c: int, film: bool, elt: int = 4) -> tuple[float, float]:
    """Bytes (x read and out written, ``elt`` bytes each; params read once,
    fp32) and ~10 flops an element (the two sums 3, normalise and FiLM 2,
    SiLU 5)."""
    nbytes = elt * 2 * b * n * c + 4 * (2 * c + (2 * b * c if film else 0))
    return nbytes, 10.0 * b * n * c


def k1_bwd_work(b: int, n: int, c: int, h: int = 256, dh: int = 32,
                elt: int = 4) -> tuple[float, float]:
    """Bytes (x and dy read, dx written, ``elt`` bytes each; weights read and
    their gradients written, the forward's M and stats read, fp32) and
    matmul flops of K1's VJP: the qkv projection again, dP = M dy, dM = P^T
    dy, dxln and dW_qkv, the k/v path within the heads, and dctx and dW_out
    per row."""
    nbytes = elt * 3 * b * n * c + 4 * (2 * (4 * h * c + 2 * c) + b * h * c
                                        + b * 8 * (dh * dh + 2 * dh))
    flops = (2 * b * n * (3 * h * c + h * c + h * c + 3 * h * c + 3 * h * c + 2 * h * dh)
             + 2 * b * 2 * h * dh * c)
    return nbytes, flops


def k2_bwd_work(b: int, n: int, c: int, film: bool, elt: int = 4) -> tuple[float, float]:
    """Bytes (x and dy read, dx written, ``elt`` bytes each; parameters read
    and their gradients written, fp32) and ~25 flops an element (x-hat, z,
    the SiLU derivative, the sums S0 and S1, and dx)."""
    nbytes = elt * 3 * b * n * c + 4 * (4 * c + (4 * b * c if film else 0))
    return nbytes, 25.0 * b * n * c


def k3_work(b: int, n: int, c: int, h: int = 256, dh: int = 32) -> tuple[float, float]:
    """K1's bytes without gamma and b_out, and K1's operation count (its
    matmul flops count no LN)."""
    nbytes, flops = k1_work(b, n, c, h, dh)
    return nbytes - 4 * 2 * c, flops


def k3_bwd_work(b: int, n: int, c: int, h: int = 256, dh: int = 32,
                elt: int = 4) -> tuple[float, float]:
    """K1 backward's bytes without gamma, b_out and their gradients, and its
    operation count (its matmul flops count no LayerNorm VJP)."""
    nbytes, flops = k1_bwd_work(b, n, c, h, dh, elt)
    return nbytes - 4 * 2 * 2 * c, flops


def k5_work(b: int, n: int, c: int) -> tuple[float, float]:
    """Bytes (bf16 x read and out written once, the folded fp32 scale and
    shift read) and ~10 flops an element (the two sums, the affine, SiLU)."""
    return 2 * 2 * b * n * c + 4 * 2 * b * c, 10.0 * b * n * c


def k4_work(b: int, p: int, ci: int, co: int, film: bool, elt: int = 4) -> tuple[float, float]:
    """Bytes (x read and out written, and the weight read, ``elt`` bytes each;
    bias, gamma, beta and with FiLM scale and shift read, fp32) and flops of
    K4: the conv's 2 B P^2 Co 9 Ci and ~10 an output element (GroupNorm,
    FiLM, SiLU)."""
    n = p * p
    nbytes = elt * (b * n * (ci + co) + 9 * ci * co) + 4 * (3 * co + (2 * b * co if film else 0))
    return nbytes, 2.0 * b * n * co * 9 * ci + 10.0 * b * n * co


def k4_bwd_work(b: int, p: int, ci: int, co: int, film: bool,
                elt: int = 4) -> tuple[float, float]:
    """Bytes (x and dy read and dx written, the weight read and dW written,
    ``elt`` bytes each; gamma and beta read, the three parameter gradients
    written, and with FiLM scale and shift read and their gradients written,
    fp32) and flops of K4's VJP: dW and dx, each the forward conv's flops,
    and ~25 an output element (the GroupNorm, FiLM and SiLU chain)."""
    n = p * p
    nbytes = (elt * (b * n * (2 * ci + co) + 2 * 9 * ci * co)
              + 4 * (5 * co + (4 * b * co if film else 0)))
    return nbytes, 2 * 2.0 * b * n * co * 9 * ci + 25.0 * b * n * co


def k3_term(args, ref) -> float:
    """max |LA(x)| of the plain output; fails when the term is too small for
    the comparison to see it."""
    term = ref.abs().max().item()
    if term < K1_MIN_TERM:
        raise AssertionError(f"K3 attention term {term:.3e} < {K1_MIN_TERM}")
    return term


def k1_term(args, ref) -> float:
    """max |LA(LN(x))| of the plain output ``ref`` = x + b_out + LA; fails
    when the term is too small for the comparison to see it."""
    term = (ref - args[0] - args[4]).abs().max().item()
    if term < K1_MIN_TERM:
        raise AssertionError(f"K1 attention term {term:.3e} < {K1_MIN_TERM}: "
                             "the comparison would not see it")
    return term


def check_kernel(name, kernel, plain, make_args, shapes_b4, path_calls, work, part=None):
    """Hold ``kernel`` against ``plain`` at B=4 (fp32 and bf16) and at the
    main path's B=64 calls; time both at B=64. ``part(args, ref)``, where
    given, checks that the kernel's own work is visible beside the tolerance
    in each fp32 comparison. Returns the kernel's entry."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch.utils.timing import graph_ms

    def held(args, what):
        ref = plain(*args)
        if part is not None:
            part(args, ref)
        return compare(kernel(*args), ref, TOL["fp32"], what)

    max_err = 0.0
    for shape in shapes_b4:
        max_err = max(max_err, held(make_args(4, *shape), f"{name} B=4 {shape}"))
    args = make_args(4, *shapes_b4[1])
    bf = [args[0].bfloat16(), *args[1:]]
    out = kernel(*bf)
    if out.dtype != torch.bfloat16:
        raise AssertionError(f"{name}: bf16 input gave {out.dtype}")
    compare(out, plain(*bf), TOL["bf16"], f"{name} bf16 B=4 {shapes_b4[1]}")

    per_call, totals = {}, {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for call in path_calls:
        if call not in per_call:
            args = make_args(64, *call)
            max_err = max(max_err, held(args, f"{name} B=64 {call}"))
            b_ms, b_by = bound_ms(*work(64, *call))
            per_call[call] = {
                "ms": graph_ms(lambda: kernel(*args)), "plain_ms": graph_ms(lambda: plain(*args)),
                "bound_ms": b_ms, "bound_by": b_by,
            }
            del args
            print(f"  {name} B=64 {call}: " + json.dumps(per_call[call]), flush=True)
        for k in totals:
            totals[k] += per_call[call][k]
    nbytes, flops = (sum(w) for w in zip(*(work(64, *call) for call in path_calls)))
    # the entry covers one UNet forward's calls: times and bounds summed
    return {"name": name, "max_abs_err": max_err, **totals,
            "bound_by": bound_ms(nbytes, flops)[1], "library_ms": None}


def grads_of(fn, args, dy):
    """The gradients of <fn(*args), dy> with respect to every tensor argument."""
    import torch

    leaves = [None if a is None else a.detach().requires_grad_(True) for a in args]
    return torch.autograd.grad(fn(*leaves), [a for a in leaves if a is not None], dy)


def check_backward(name, kernel, plain, save, bwd, make_args, shapes, path_calls, work,
                   bf16=False):
    """Hold the backward kernel, reached through autograd on ``kernel``,
    against torch autograd through ``plain`` at B=4 and B=64 for each shape
    (x and dy in bf16 when ``bf16``; then dx is held to BF16_DX_TOL and the
    parameter gradients to BF16_PARAM_TOL, else each to GRAD_TOL). At B=64
    time the backward kernel alone (``bwd(dy, *save(*args))``, the forward's
    saved tensors made once) beside the plain version's backward (its
    forward and backward, less its forward). Returns the entry."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch.utils.timing import graph_ms

    tols = (BF16_DX_TOL, BF16_PARAM_TOL) if bf16 else (GRAD_TOL, GRAD_TOL)
    elt, peak = (2, PEAK_BF16_FLOPS) if bf16 else (4, PEAK_FP32_FLOPS)
    max_err, per_call = 0.0, {}
    for b in (4, 64):
        for shape in shapes:
            args = make_args(b, *shape)
            if bf16:
                args[0] = args[0].bfloat16()
            dy = torch.randn(args[0].shape, device=args[0].device).to(args[0].dtype)
            worst = 0.0
            for i, (g, r) in enumerate(zip(grads_of(kernel, args, dy), grads_of(plain, args, dy))):
                if g.dtype != r.dtype:
                    raise AssertionError(f"{name} B={b} {shape} gradient {i}: {g.dtype}, "
                                         f"autograd gives {r.dtype}")
                tol = tols[min(i, 1)]
                scale, err = r.abs().max().item(), (g.float() - r.float()).abs().max().item()
                if not torch.isfinite(g).all() or err > tol * scale:
                    raise AssertionError(f"{name} B={b} {shape} gradient {i}: max |diff| "
                                         f"{err:.3e} > {tol} x max |g| {scale:.3e}")
                max_err, worst = max(max_err, err), max(worst, err / max(scale, 1e-30))
            print(f"  {name} B={b} {shape}: max |diff| / max |g| {worst:.2e}", flush=True)
            if b == 64 and shape in path_calls:
                saved = save(*args)
                plain_ms = (graph_ms(lambda: grads_of(plain, args, dy), reps=5)
                            - graph_ms(lambda: plain(*args), reps=5))
                b_ms, b_by = bound_ms(*work(b, *shape, elt=elt), peak)
                per_call[shape] = {"ms": graph_ms(lambda: bwd(dy, *saved), reps=5),
                                   "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
                print(f"  {name} B=64 {shape}: " + json.dumps(per_call[shape]), flush=True)
                del saved
            del args, dy
    # the entry covers one UNet backward's calls: times and bounds summed
    totals = {k: sum(per_call[call][k] for call in path_calls)
              for k in ("ms", "plain_ms", "bound_ms")}
    nbytes, flops = (sum(w) for w in zip(*(work(64, *call, elt=elt) for call in path_calls)))
    return {"name": name, "max_abs_err": max_err, **totals,
            "bound_by": bound_ms(nbytes, flops, peak)[1], "library_ms": None}


def check_bf16_forward(name, kernel, plain, make_args, path_calls, work) -> dict:
    """Hold ``kernel`` on bf16 x against ``plain`` on the same input at the
    main path's B=64 calls (TOL["bf16"], the output's rounding) and time both
    there, beside the bf16 bound. Returns the entry."""
    from physicsinformeddiffusionmodels_tpu_torch.utils.timing import graph_ms

    per_call, max_err = {}, 0.0
    for call in dict.fromkeys(path_calls):
        args = make_args(64, *call)
        args[0] = args[0].bfloat16()
        max_err = max(max_err, compare(kernel(*args), plain(*args), TOL["bf16"],
                                       f"{name} B=64 {call}"))
        b_ms, b_by = bound_ms(*work(64, *call, elt=2), PEAK_BF16_FLOPS)
        per_call[call] = {"ms": graph_ms(lambda: kernel(*args)),
                          "plain_ms": graph_ms(lambda: plain(*args)),
                          "bound_ms": b_ms, "bound_by": b_by}
        print(f"  {name} B=64 {call}: " + json.dumps(per_call[call]), flush=True)
        del args
    totals = {k: sum(per_call[call][k] for call in path_calls)
              for k in ("ms", "plain_ms", "bound_ms")}
    nbytes, flops = (sum(w) for w in zip(*(work(64, *call, elt=2) for call in path_calls)))
    return {"name": name, "max_abs_err": max_err, **totals,
            "bound_by": bound_ms(nbytes, flops, PEAK_BF16_FLOPS)[1], "library_ms": None}


def check_mechanics(name, kernel, plain, make_args, calls, backward: bool, part=None) -> None:
    """Hold K1 or K2 (its forward, or its backward through autograd) against
    its plain version at each of ``calls`` (``make_args(6, *call)``), B=6,
    fp32 and bf16, untimed, with the tolerances of the path's shapes;
    ``part`` as in check_kernel."""
    import torch

    for call in calls:
        for bf16 in (False, True):
            args = make_args(6, *call)
            if bf16:
                args[0] = args[0].bfloat16()
            what = f"{name} B=6 {call} {'bf16' if bf16 else 'fp32'}"
            if not backward:
                ref = plain(*args)
                if not bf16 and part is not None:
                    part(args, ref)
                err = compare(kernel(*args), ref, TOL["bf16" if bf16 else "fp32"], what)
                print(f"  {what}: max |diff| {err:.3e}", flush=True)
                continue
            dy = torch.randn(args[0].shape, device=args[0].device).to(args[0].dtype)
            tols = (BF16_DX_TOL, BF16_PARAM_TOL) if bf16 else (GRAD_TOL, GRAD_TOL)
            worst = 0.0
            for i, (g, r) in enumerate(zip(grads_of(kernel, args, dy), grads_of(plain, args, dy))):
                scale, err = r.float().abs().max().item(), (g.float() - r.float()).abs().max().item()
                if g.dtype != r.dtype or not torch.isfinite(g).all() or err > tols[min(i, 1)] * scale:
                    raise AssertionError(f"{what} gradient {i}: max |diff| {err:.3e} > "
                                         f"{tols[min(i, 1)]} x max |g| {scale:.3e} ({g.dtype})")
                worst = max(worst, err / max(scale, 1e-30))
            print(f"  {what}: max |diff| / max |g| {worst:.2e}", flush=True)
            del dy
        del args


def print_k2_plans(b: int, shapes) -> None:
    """K2's launch plan (ops/group_norm.py ``k2_plan``, as the card steps it
    down) at batch ``b`` and each distinct (N, C) of ``shapes``: blocks a
    row (k), bytes of shared memory a block, and whether a block's slice is
    resident or partly re-read."""
    from physicsinformeddiffusionmodels_tpu_torch.ops import group_norm as gn

    for n, c in dict.fromkeys(shapes):
        plans = {f"{'bwd' if backward else 'fwd'} {'bf16' if bf16 else 'fp32'}":
                 gn._plan(b, n, c, 8, bf16, True, backward)
                 for backward in (False, True) for bf16 in (False, True)}
        print(f"  K2 plan B={b} ({n}, {c}): " + json.dumps(
            {k: {"k": p.k, "tokens": p.tokens, "smem_bytes": p.smem,
                 "mode": "re-read" if p.reread else "resident"} for k, p in plans.items()}),
              flush=True)


def _counted() -> tuple:
    """K1's, K2's and K4's wrappers, which count their launches."""
    from physicsinformeddiffusionmodels_tpu_torch.ops.conv_block import conv_gn_film_silu_cm
    from physicsinformeddiffusionmodels_tpu_torch.ops.group_norm import group_norm_film_silu
    from physicsinformeddiffusionmodels_tpu_torch.ops.linear_attention import (
        linear_attention_block)

    return linear_attention_block, group_norm_film_silu, conv_gn_film_silu_cm


def launch_counts() -> tuple:
    """K1's, K2's and K4's launch counts: (forward, forward on bf16 x,
    backward, backward on bf16 x) of each."""
    return tuple((f.launches, f.bf16_launches, f.backward_launches, f.bf16_backward_launches)
                 for f in _counted())


def zero_launch_counts() -> None:
    for f in _counted():
        f.launches = f.bf16_launches = f.backward_launches = f.bf16_backward_launches = 0


def launches_of(steps: int, per_step: tuple) -> tuple:
    return tuple(tuple(steps * v for v in row) for row in per_step)


def ref_fp32_step(tmp: Path, run: Path = RUN, cm: bool = False, batch_size: int = 8) -> dict:
    """The CPU half of ``step_card_vs_cpu`` (computed by the CPU-reference
    worker): one fp32 train step at ``batch_size`` from the EMA weights of
    ``run`` (with ``cm_conv_stages`` when ``cm``), with the loss of the
    run's config, on a batch, t, noise and null mask (a mixed one, for a
    guided run) drawn from 9a's training set in ``tmp``. Returns those
    inputs, the loss and each parameter's gradient (None where unused)."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch import sample_eval, train
    from physicsinformeddiffusionmodels_tpu_torch.data.datasets import load_darcy_dataset
    from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import create_schedule

    cfg, model, _ = sample_eval.load_run(run, compute_dtype="float32", device="cpu")
    model.cm_conv_stages = cm
    loss_fn = train.build_darcy_loss_fn(create_schedule(cfg.diff_steps),
                                        train.make_physics(cfg, "cpu"), cfg)
    rng = np.random.default_rng(0)
    idx = rng.integers(0, N_TRAIN, batch_size)
    t = torch.from_numpy(rng.integers(0, cfg.diff_steps, batch_size))
    batch = torch.from_numpy(load_darcy_dataset(tmp / "train").stacked()[idx])
    noise = torch.from_numpy(rng.standard_normal(batch.shape).astype(np.float32))
    extra = ()
    if cfg.residual_grad_guidance:  # every fourth sample masked
        extra = (torch.arange(batch_size) % 4 == 0,)
    loss, _ = loss_fn(model, batch, t, noise, *extra)
    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    return {"inputs": (batch, t, noise, extra), "loss": loss.detach(), "grads": list(grads)}


def step_card_vs_cpu(what: str, dev, refs: "CpuRefs", cm: bool = False, run: Path = RUN) -> None:
    """One fp32 train step from the EMA weights of ``run`` (300k by
    default; with ``cm_conv_stages`` when ``cm``) on the card (kernels),
    on the inputs of ``ref_fp32_step``, held to its CPU step (plain
    versions): the loss within STEP_LOSS_RTOL relative, each parameter's
    gradient within STEP_GRAD_TOL of its largest entry. The CPU half is
    ``refs``' entry of the phase (the first word of ``what``)."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch import sample_eval, train
    from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import create_schedule

    ph = phase(what)
    ref = refs.get(what.split()[0])
    cfg, model, _ = sample_eval.load_run(run, compute_dtype="float32", device=dev)
    model.cm_conv_stages = cm
    loss_fn = train.build_darcy_loss_fn(create_schedule(cfg.diff_steps),
                                        train.make_physics(cfg, dev), cfg)
    batch, t, noise, extra = ref["inputs"]
    t_card = time.perf_counter()
    loss, _ = loss_fn(model, batch.to(dev), t.to(dev), noise.to(dev),
                      *(e.to(dev) for e in extra))
    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    torch.cuda.synchronize()
    done(ph, batch=batch.shape[0], **hold_fp32_step(model, loss, grads, ref["loss"],
                                                    ref["grads"]),
         card_s=f"{time.perf_counter() - t_card:.2f}", cpu_s=f"{ref['seconds']:.2f}")


def hold_fp32_step(model, loss, grads, loss_cpu, grads_cpu, sides=("card", "CPU")) -> dict:
    """An fp32 step's loss and gradients (``model``'s parameters in order;
    None for an unused one) on the card against the CPU's (or, ``sides``,
    one run against another): the loss within STEP_LOSS_RTOL relative, each
    gradient within STEP_GRAD_TOL of its largest entry. Returns what
    ``done`` prints."""
    import torch

    a, b = sides
    rel = abs(loss.item() - loss_cpu.item()) / abs(loss_cpu.item())
    if not np.isfinite(loss.item()) or rel > STEP_LOSS_RTOL:
        raise AssertionError(f"train step loss {a} {loss.item():.8e} vs {b} "
                             f"{loss_cpu.item():.8e}: relative {rel:.2e} > {STEP_LOSS_RTOL}")
    worst, compared = 0.0, 0
    for (name, _), g, gc in zip(model.named_parameters(), grads, grads_cpu):
        if (g is None) != (gc is None):
            raise AssertionError(f"{name}: gradient on one side only ({a}, {b})")
        if g is None:  # the guidance-conditioning modules, unused but in guided runs
            continue
        scale, err = gc.abs().max().item(), (g.cpu() - gc.cpu()).abs().max().item()
        if not torch.isfinite(g).all() or err > STEP_GRAD_TOL * scale:
            raise AssertionError(f"{name}: {a} vs {b} gradient max |diff| {err:.3e} > "
                                 f"{STEP_GRAD_TOL} x max |g| {scale:.3e}")
        worst, compared = max(worst, err / max(scale, 1e-30)), compared + 1
    return dict(loss_card=f"{loss.item():.8e}", loss_cpu=f"{loss_cpu.item():.8e}",
                loss_rel=f"{rel:.2e}", grads_compared=compared, worst_grad_rel=f"{worst:.2e}")


def train_main_path(what: str, model, cfg, loss_fn, data, per_step: tuple, smi: str,
                    steps: int = TRAIN_STEPS, batch: int = TRAIN_BATCH):
    """A training main path: ``steps`` steps at ``batch`` from ``model``'s
    weights with fresh Adam through ``trainer.resident_train_step`` on the
    device-resident ``data`` (with the null-conditioning mask of a guided
    ``cfg``), with the launch counts zeroed just before and read just after,
    held to ``per_step`` (``launch_counts()``'s rows) for each step; finite
    losses, the mean of the last 50 below LAST50_MAX. Returns (the train
    state, the launch counts, steps/s)."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch import train
    from physicsinformeddiffusionmodels_tpu_torch.training.trainer import (
        create_train_state, make_optimizer, resident_train_step)

    ph = phase(what)
    state = create_train_state(model, make_optimizer(model, cfg.lr, cfg.grad_clip))
    step_gen = torch.Generator(device=data.device)
    losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    with timed(what.split()[0]):
        t0 = time.perf_counter()
        for _ in range(steps):
            aux = resident_train_step(state, loss_fn, data, batch, cfg.diff_steps, cfg.seed,
                                      step_gen, ema_mu=cfg.ema_decay, ema_start=cfg.ema_start,
                                      null_cond_prob=train.null_cond_prob(cfg))
            losses.append(aux.loss.detach())
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    got, want = launch_counts(), launches_of(steps, per_step)
    if got != want:
        raise AssertionError(f"{what}: launches K1, K2, K4 (fwd, fwd bf16, bwd, bwd bf16) "
                             f"{got}, want {want}")
    losses = torch.stack(losses).float().cpu().numpy()
    last50 = float(losses[-50:].mean())
    if not np.isfinite(losses).all() or last50 >= LAST50_MAX:
        raise AssertionError(f"{what}: losses finite {np.isfinite(losses).all()}, "
                             f"mean of the last 50 {last50:.4e} (limit {LAST50_MAX})")
    steps_per_s = steps / seconds
    done(ph, steps=steps, batch=batch, seconds=f"{seconds:.2f}",
         steps_per_s=f"{steps_per_s:.3f}",
         samples_per_s=f"{steps * batch / seconds:.1f}",
         peak_memory_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
         first_loss=f"{losses[0]:.4e}", last50_mean=f"{last50:.4e}",
         **{f"{k}_fwd_bf16_bwd_bf16": "/".join(map(str, row))
            for k, row in zip(("k1", "k2", "k4"), got)})
    print(f"  {smi}", flush=True)
    return state, got, steps_per_s


class DataJobs:
    """The sets of phases 9a and 19a, made by the port's generator CLIs in
    one background thread, one niced process at a time (each in a session
    of its own, which BACKGROUND stops while a phase times), from the build
    on: CPU work that needs no card. A set made writes ``<set>.done`` (for
    the CPU-reference worker); ``wait(name)`` blocks until a part is
    made (raising with the log's end if a generator failed) and returns its
    seconds; ``stop()`` kills a generator still running."""

    def __init__(self, tmp: Path):
        import threading

        workers = str(min(8, os.cpu_count() or 1))
        port = "physicsinformeddiffusionmodels_tpu_torch"

        def darcy(n, out, seed):
            return [sys.executable, "-m", f"{port}.data.darcy_generator", "--n-samples", str(n),
                    "--out", str(tmp / out), "--seed", str(seed), "--workers", workers]

        # part -> (set name, its command) in order; a set made writes
        # <set>.done, which the CPU-reference worker waits for
        self.jobs = {"darcy": [("train", darcy(N_TRAIN, "train", 1)),
                               ("valid", darcy(N_VALID, "valid", 10_000))],
                     "mechanics": [("mechanics", [
                         sys.executable, "-m", f"{port}.generate_mechanics_sets",
                         "--root", str(tmp / "mechanics"),
                         *(f"--{k.replace('_', '-')}={v}" for k, v in MECH_SETS.items()),
                         "--device", "host", "--workers", workers])]}
        # niced, so that the phases that drive the card keep their CPU
        self.nice = ["nice", "-n", "10"] if shutil.which("nice") else []
        self.log, self.tmp = tmp / "data_jobs.log", tmp
        self.done = {name: threading.Event() for name in self.jobs}
        self.seconds, self.error, self.proc, self.stopped = {}, None, None, False
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        with open(self.log, "w") as log:
            for name, cmds in self.jobs.items():
                t0 = time.perf_counter()
                for out, cmd in cmds:
                    if self.stopped or self.error:
                        break
                    # a session of its own: BACKGROUND stops and resumes it whole
                    self.proc = subprocess.Popen(self.nice + cmd, cwd=ROOT, stdout=log,
                                                 stderr=subprocess.STDOUT,
                                                 start_new_session=True)
                    BACKGROUND.add(self.proc.pid)
                    if self.proc.wait() != 0:
                        self.error = f"{' '.join(cmd)} exited {self.proc.returncode}"
                    BACKGROUND.discard(self.proc.pid)
                    if not self.error:
                        (self.tmp / f"{out}.done").touch()
                self.seconds[name] = time.perf_counter() - t0
                self.done[name].set()

    def wait(self, name: str) -> float:
        self.done[name].wait()
        if self.error:
            raise RuntimeError(f"data generation failed: {self.error}\n"
                               + self.log.read_text()[-4000:])
        return self.seconds[name]

    def stop(self) -> None:
        import signal

        self.stopped = True
        if self.proc is not None and self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()
        self.thread.join(timeout=60)


def train_phase(tmp: Path, dev, smi: str, jobs: DataJobs, later: list, refs: "CpuRefs"
                ) -> tuple[tuple[int, int, int, int], float]:
    """Phase 9; its data stays in ``tmp`` for phases 13 and 15; 9b's card vs
    CPU step goes to ``later``. Returns the launch counts of the main-path
    run (K1 forward, K1 backward, K2 forward, K2 backward) and its
    steps/s."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch import sample_eval, train
    from physicsinformeddiffusionmodels_tpu_torch.data.datasets import load_darcy_dataset
    from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import create_schedule
    from physicsinformeddiffusionmodels_tpu_torch.training.checkpoint import (
        restore_train_state, save_checkpoint)
    from physicsinformeddiffusionmodels_tpu_torch.training.trainer import (
        create_train_state, make_optimizer)

    ph = phase("9a Darcy data (port generator)")
    gen_s = jobs.wait("darcy")
    ds, ds_valid = load_darcy_dataset(tmp / "train"), load_darcy_dataset(tmp / "valid")
    res = np.concatenate([np.loadtxt(tmp / split / "res_data.csv", delimiter=",", ndmin=1)
                          for split in ("train", "valid")])
    done(ph, train=len(ds), valid=len(ds_valid), generated_in_background_s=f"{gen_s:.2f}",
         lstsq_residual_mean=f"{res.mean():.3e}")

    cfg, model, _ = sample_eval.load_run(RUN, compute_dtype="float32", device=dev)
    cfg.compute_dtype = "float32"
    sched = create_schedule(cfg.diff_steps)
    loss_fn = train.build_darcy_loss_fn(sched, train.make_physics(cfg, dev), cfg)

    later.append(functools.partial(step_card_vs_cpu, "9b one train step, card vs CPU", dev,
                                   refs))

    ph = phase("9c loss of the 300k EMA weights")
    data_v = torch.as_tensor(ds_valid.stacked(), device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        auxes = [train.eval_loss(loss_fn, model, data_v, cfg.diff_steps, gen) for _ in range(8)]
    ema_loss = float(np.mean([a.loss.item() for a in auxes]))
    ema_data = float(np.mean([a.data_loss.item() for a in auxes]))
    ema_res = float(np.mean([a.residual_mean_abs.item() for a in auxes]))
    if not (EMA_LOSS_BAND[0] <= ema_loss <= EMA_LOSS_BAND[1]
            and EMA_DATA_LOSS_BAND[0] <= ema_data <= EMA_DATA_LOSS_BAND[1]
            and EMA_RESIDUAL_BAND[0] <= ema_res <= EMA_RESIDUAL_BAND[1]):
        raise AssertionError(f"EMA-weight loss {ema_loss:.4e} (band {EMA_LOSS_BAND}), data "
                             f"loss {ema_data:.4e} (band {EMA_DATA_LOSS_BAND}), mean |residual| "
                             f"{ema_res:.4e} (band {EMA_RESIDUAL_BAND})")
    done(ph, mean_loss=f"{ema_loss:.4e}", mean_data_loss=f"{ema_data:.4e}",
         mean_residual_mean_abs=f"{ema_res:.4e}")

    data = torch.as_tensor(ds.stacked(), device=dev)
    state, got, steps_per_s = train_main_path("9d training (main path)", model, cfg, loss_fn,
                                              data, FP32_STEP_LAUNCHES, smi)
    counts = (got[0][0], got[0][2], got[1][0], got[1][2])

    # 9e times nothing: it runs beside phase 23's ranks
    def checkpoint_round_trip():
        ph = phase("9e checkpoint save and restore")
        save_checkpoint(tmp / "ckpt", TRAIN_STEPS - 1, model=state.model, ema=state.ema,
                        optimizer=state.optimizer, config=cfg)
        fresh = train.build_model(cfg).to(dev)
        restored, start = restore_train_state(tmp / "ckpt",
                                              create_train_state(fresh, make_optimizer(fresh)))
        saved_sd, restored_sd = state.ema.state_dict(), restored.ema.state_dict()
        same_weights = all(torch.equal(saved_sd[k], restored_sd[k]) for k in saved_sd)
        x = data[:8]
        tt = torch.arange(8, device=dev) * 12
        # cuDNN's default algorithms may sum in another order from call to call
        # (two forwards of one model differ by up to ~3e-5, printed below); with
        # its deterministic algorithms, and K1/K2's fixed summation order, a
        # forward of the same weights repeats bit for bit, so the restored EMA's
        # forward must equal the saved one's exactly
        with torch.no_grad():
            default_repeat = (state.ema(x, tt) - state.ema(x, tt)).abs().max().item()
            with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                            allow_tf32=False):
                y = state.ema(x, tt)
                repeat = max((state.ema(x, tt) - y).abs().max().item() for _ in range(5))
                err = (restored.ema(x, tt) - y).abs().max().item()
        if start != TRAIN_STEPS or not same_weights or repeat != 0 or err != 0:
            raise AssertionError(f"restore: start {start}, EMA weights equal {same_weights}, "
                                 f"EMA forward max |diff| {err:.3e} (same weights, 5 repeats: "
                                 f"{repeat:.3e}); both must be 0 with deterministic cuDNN")
        del restored, fresh
        done(ph, start=start, ema_weights_bit_equal=same_weights,
             ema_forward_max_abs_diff=f"{err:.3e}",
             same_weights_5_repeats_max_abs_diff=f"{repeat:.3e}",
             default_cudnn_same_weights_twice_max_abs_diff=f"{default_repeat:.3e}")

    later.append(checkpoint_round_trip)
    return counts, steps_per_s


def training_cli_fp32(tmp: Path) -> None:
    """Phase 9f on 9a's sets in ``tmp`` (the card lane runs it): the
    training CLI for 3 steps, and ``sample_eval`` of its checkpoint."""
    from physicsinformeddiffusionmodels_tpu_torch import sample_eval, train

    ph = phase("9f training CLI and sample_eval of its checkpoint")
    out = tmp / "runs"
    train.main(["--iterations", "3", "--batch-size", "8", "--data-dir", str(tmp / "train"),
                "--valid-data-dir", str(tmp / "valid"), "--output-dir", str(out),
                "--sample-freq", "1000", "--test-eval-freq", "2", "--log-freq", "1",
                "--no-samples", "4", "--name", "smoke"])
    run = out / "smoke"
    stats = run / "training" / "step_3" / "sample_statistics.csv"
    if not (stats.exists() and (run / "model" / "checkpoint_3.msgpack").exists()):
        raise AssertionError(f"training CLI outputs missing under {run}")
    summary = sample_eval.evaluate(run, 2, "float32", "cuda", seed=0, out=tmp / "eval")
    if not np.isfinite(summary["res_b"]).all() or summary["checkpoint_step"] != 3:
        raise AssertionError(f"sample_eval of the CLI's checkpoint: {summary}")
    done(ph, residual_median_after_4_steps=f"{summary['residual_median']:.3e}")


def training_cli_bf16(tmp: Path) -> None:
    """Phase 13d on 9a's sets in ``tmp`` (the card lane runs it): the
    training CLI with ``--compute-dtype bfloat16 --fp32-head`` for 3 steps,
    and ``sample_eval`` of its checkpoint in bf16, 64 samples."""
    from physicsinformeddiffusionmodels_tpu_torch import sample_eval, train

    ph = phase("13d bf16 training CLI and bf16 sample_eval of its checkpoint")
    out = tmp / "runs_bf16"
    train.main(["--iterations", "3", "--batch-size", "8", "--data-dir", str(tmp / "train"),
                "--valid-data-dir", str(tmp / "valid"), "--output-dir", str(out),
                "--sample-freq", "1000", "--test-eval-freq", "2", "--log-freq", "1",
                "--no-samples", "4", "--name", "smoke_bf16", "--compute-dtype", "bfloat16",
                "--fp32-head"])
    run = out / "smoke_bf16"
    saved = json.loads((run / "config.json").read_text())
    if (saved["compute_dtype"], saved["fp32_head"]) != ("bfloat16", True) or not (
            run / "model" / "checkpoint_3.msgpack").exists():
        raise AssertionError(f"bf16 training CLI outputs under {run}: config {saved}")
    summary = sample_eval.evaluate(run, SAMPLES, "bfloat16", "cuda", seed=0,
                                   out=tmp / "eval_bf16")
    if not np.isfinite(summary["res_b"]).all() or summary["checkpoint_step"] != 3:
        raise AssertionError(f"bf16 sample_eval of the CLI's checkpoint: {summary}")
    done(ph, residual_median_64_samples_after_4_steps=f"{summary['residual_median']:.4e}",
         sampling_seconds=f"{summary['seconds']:.2f}")


def step_grads(loss_fn, model, batch, t, noise):
    """(loss, gradient of each parameter or None) of one training loss."""
    import torch

    loss, _ = loss_fn(model, batch, t, noise)
    return loss.item(), torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)


def ref_13a(tmp: Path) -> dict:
    """The CPU half of phase 13a (computed by the CPU-reference worker): a
    batch, t and noise at B=8 drawn from 9a's training set in ``tmp``, and
    one bf16 + fp32-head and one fp32 train step from the 300k EMA weights
    on them on the CPU: the bf16 loss and gradients, the fp32 loss."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch import sample_eval, train
    from physicsinformeddiffusionmodels_tpu_torch.data.datasets import load_darcy_dataset
    from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import create_schedule

    (cfg, model, _), (_, model32, _) = (
        sample_eval.load_run(RUN, compute_dtype=dtype, device="cpu")
        for dtype in ("bfloat16", "float32"))
    loss_fn = train.build_darcy_loss_fn(create_schedule(cfg.diff_steps),
                                        train.make_physics(cfg, "cpu"), cfg)
    ds = load_darcy_dataset(tmp / "train")
    rng = np.random.default_rng(13)
    idx, t = rng.integers(0, len(ds), 8), torch.from_numpy(rng.integers(0, cfg.diff_steps, 8))
    batch = torch.from_numpy(ds.stacked()[idx])
    noise = torch.from_numpy(rng.standard_normal(batch.shape).astype(np.float32))
    loss, grads = step_grads(loss_fn, model.train(), batch, t, noise)
    loss32 = step_grads(loss_fn, model32.train(), batch, t, noise)[0]
    return {"inputs": (batch, t, noise), "loss": loss, "grads": list(grads), "loss32": loss32}


def bf16_step_phase(dev, refs: "CpuRefs") -> None:
    """Phase 13a: one bf16 + fp32-head train step at B=8 from the 300k EMA
    weights on the card, on the inputs of ``ref_13a``, held to its CPU
    step (``refs``' entry), beside each side's fp32 step."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch import sample_eval, train
    from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import create_schedule

    ph = phase("13a one bf16 train step, card vs CPU")
    ref = refs.get("13a")
    (cfg, model, _), (_, model32, _) = (
        sample_eval.load_run(RUN, compute_dtype=dtype, device=dev)
        for dtype in ("bfloat16", "float32"))
    loss_fn = train.build_darcy_loss_fn(create_schedule(cfg.diff_steps),
                                        train.make_physics(cfg, dev), cfg)
    on = tuple(a.to(dev) for a in ref["inputs"])
    before = launch_counts()
    loss, grads = step_grads(loss_fn, model.train(), *on)
    torch.cuda.synchronize()
    # the activations reach K1 and K2 in bf16 (all but the fp32 head's K2)
    launched = tuple(tuple(a - b for a, b in zip(*rows)) for rows in zip(launch_counts(), before))
    if launched != BF16_STEP_LAUNCHES:
        raise AssertionError(f"bf16 step launches K1, K2, K4 (fwd, fwd bf16, bwd, bwd bf16) "
                             f"{launched}, want {BF16_STEP_LAUNCHES}")
    loss32, grads32 = step_grads(loss_fn, model32.train(), *on)
    done(ph, **hold_bf16_step(model, loss, grads, loss32, grads32, ref["loss"], ref["grads"],
                              ref["loss32"]), launches=launched, cpu_s=f"{ref['seconds']:.2f}")


def hold_bf16_step(model, loss, grads, loss32, grads32, loss_cpu, grads_cpu,
                   loss32_cpu, sides=("card", "CPU")) -> dict:
    """A bf16 step (loss and ``model``'s gradients) on the card against the
    CPU's (or, ``sides``, one run against another), beside each side's fp32
    step on the same inputs (13a's rule). Returns what ``done`` prints."""
    import torch

    a, b = sides

    # the fp32 losses agree to STEP_LOSS_RTOL; the bf16 loss lies within
    # STEP_BF16_LOSS x the larger of the two sides' own bf16 rounding (their
    # gap to their fp32 loss); the whole gradient (every parameter's as one
    # vector, L2) within STEP_BF16_WHOLE and each parameter's (L2) within
    # STEP_BF16_EACH of the card's own rounding. The CPU's rounding is no
    # steadier a yardstick: a tensor's rounding is one draw a side (it failed
    # a correct card on one LayerNorm scale at 13x its CPU draw). The card's
    # own widens with a fault of the card's bf16 backward alone, which is
    # phase 12's to catch: each bf16 backward kernel against its plain
    # version on the same inputs.
    rel32 = abs(loss32 - loss32_cpu) / abs(loss32_cpu)
    limit = STEP_BF16_LOSS * max(abs(loss - loss32), abs(loss_cpu - loss32_cpu))
    if not np.isfinite(loss) or rel32 > STEP_LOSS_RTOL or abs(loss - loss_cpu) > limit:
        raise AssertionError(f"bf16 train step loss {a} {loss:.8e} vs {b} {loss_cpu:.8e}: "
                             f"limit {limit:.3e}; fp32 {a} {loss32:.8e} vs {b} "
                             f"{loss32_cpu:.8e}: relative {rel32:.2e}")
    worst, kept = 0.0, []
    for (name, _), g, g32, gc in zip(model.named_parameters(), grads, grads32, grads_cpu):
        if (g is None) != (gc is None):
            raise AssertionError(f"{name}: gradient on one side only ({a}, {b})")
        if g is None:  # the guidance-conditioning modules, unused by this loss
            continue
        if g.dtype != torch.float32 or not torch.isfinite(g).all():
            raise AssertionError(f"{name}: a {g.dtype} gradient, finite "
                                 f"{bool(torch.isfinite(g).all())}")
        kept.append((g.cpu(), g32.cpu(), gc.cpu()))
        k, floor = STEP_BF16_EACH
        err = (g.cpu() - gc.cpu()).norm().item()
        lim = k * (g - g32).norm().item() + floor * gc.norm().item()
        if err > lim:
            raise AssertionError(f"{name}: bf16 {a} vs {b} gradient |diff| {err:.3e} > "
                                 f"{lim:.3e} (L2)")
        worst = max(worst, err / max(lim, 1e-30))
    compared = len(kept)
    g, g32, gc = (torch.cat([t[i].flatten() for t in kept]) for i in range(3))
    k, floor = STEP_BF16_WHOLE
    whole = (g - gc).norm().item()
    whole_lim = k * (g - g32).norm().item() + floor * gc.norm().item()
    if whole > whole_lim:
        raise AssertionError(f"bf16 {a} vs {b}, whole gradient |diff| {whole:.3e} > "
                             f"{whole_lim:.3e} (L2)")
    return dict(loss_card=f"{loss:.8e}", loss_cpu=f"{loss_cpu:.8e}",
                loss_fp32_card=f"{loss32:.8e}", loss_fp32_cpu=f"{loss32_cpu:.8e}",
                loss_share_of_limit=f"{abs(loss - loss_cpu) / limit:.2f}",
                grads_compared=compared, whole_gradient_share_of_limit=f"{whole / whole_lim:.2f}",
                worst_tensor_share_of_limit=f"{worst:.2f}")


def bf16_train_phase(tmp: Path, dev, smi: str, later: list, refs: "CpuRefs"
                     ) -> tuple[int, int, int, int, float]:
    """Phase 13 on phase 9's data in ``tmp``; 13a's card vs CPU step goes to
    ``later``. Returns the launch counts of the bf16 main-path run (K1's
    forward, K1's backward, K2's forward and K2's backward, each on bf16 x)
    and its steps/s."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch import sample_eval, train
    from physicsinformeddiffusionmodels_tpu_torch.data.datasets import load_darcy_dataset
    from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import create_schedule

    ds, ds_valid = load_darcy_dataset(tmp / "train"), load_darcy_dataset(tmp / "valid")
    # the run's own config: bf16 compute with the fp32 head
    cfg, model, _ = sample_eval.load_run(RUN, compute_dtype="bfloat16", device=dev)
    if (cfg.compute_dtype, cfg.fp32_head, model.fp32_head) != ("bfloat16", True, True):
        raise AssertionError(f"{RUN} is not a bf16 + fp32-head run: {cfg.compute_dtype}, "
                             f"fp32_head {cfg.fp32_head}")
    sched = create_schedule(cfg.diff_steps)
    loss_fn = train.build_darcy_loss_fn(sched, train.make_physics(cfg, dev), cfg)

    later.append(functools.partial(bf16_step_phase, dev, refs))

    ph = phase("13b loss of the 300k EMA weights, bf16 + fp32 head")
    data_v = torch.as_tensor(ds_valid.stacked(), device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    model.eval()
    with torch.no_grad():
        auxes = [train.eval_loss(loss_fn, model, data_v, cfg.diff_steps, gen) for _ in range(8)]
    ema_loss = float(np.mean([a.loss.item() for a in auxes]))
    ema_data = float(np.mean([a.data_loss.item() for a in auxes]))
    ema_res = float(np.mean([a.residual_mean_abs.item() for a in auxes]))
    if not (EMA_BF16_LOSS_BAND[0] <= ema_loss <= EMA_BF16_LOSS_BAND[1]
            and EMA_BF16_RESIDUAL_BAND[0] <= ema_res <= EMA_BF16_RESIDUAL_BAND[1]):
        raise AssertionError(f"bf16 EMA-weight loss {ema_loss:.4e} (band {EMA_BF16_LOSS_BAND}), "
                             f"mean |residual| {ema_res:.4e} (band {EMA_BF16_RESIDUAL_BAND})")
    done(ph, mean_loss=f"{ema_loss:.4e}", mean_data_loss=f"{ema_data:.4e}",
         mean_residual_mean_abs=f"{ema_res:.4e}")

    data = torch.as_tensor(ds.stacked(), device=dev)
    state, got, steps_per_s = train_main_path("13c bf16 training (main path)", model.train(),
                                              cfg, loss_fn, data, BF16_STEP_LAUNCHES, smi)
    del state, model

    return got[0][1], got[0][3], got[1][1], got[1][3], steps_per_s


def k5_phase(dev, randn) -> dict:
    """Phase 14. Returns K5's entry, with the launches of its path."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch import profile_gn
    from physicsinformeddiffusionmodels_tpu_torch.ops import group_norm as gn
    from physicsinformeddiffusionmodels_tpu_torch.utils.timing import graph_ms

    max_err, per_shape = 0.0, {}
    for n, c in K5_SHAPES:
        plan = gn.k5_plan(64, n, c)
        held = f"re-read past {plan.resident}" if plan.reread else "resident"
        print(f"  K5 plan [64, {n}, {c}]: {plan.k} blocks a row (one cluster), {plan.tokens} "
              f"tokens a block, {held}, {plan.smem} B of shared memory a block, "
              f"{gn.k5_max_clusters(plan)} clusters at once", flush=True)
        x = randn(64, n, c, scale=2.0, shift=0.5).bfloat16()
        args = [x, randn(c, scale=0.1, shift=1.0), randn(c, scale=0.1), randn(64, c, scale=0.1),
                randn(64, c, scale=0.1)]
        out = gn.group_norm_film_silu_packed(*args)
        if out.dtype != torch.bfloat16 or out.shape != x.shape:
            raise AssertionError(f"K5 gave {out.dtype} {tuple(out.shape)}")
        for ref_name, ref in (("plain version", gn.group_norm_film_silu_packed_plain(*args)),
                              ("K2 forward", gn.group_norm_film_silu(*args))):
            scale = ref.float().abs().max().item()
            err = (out.float() - ref.float()).abs().max().item()
            if not torch.isfinite(out).all() or err > K5_TOL * scale:
                raise AssertionError(f"K5 vs {ref_name} at [64, {n}, {c}]: max |diff| {err:.3e} "
                                     f"> {K5_TOL} x {scale:.3e}")
            print(f"  K5 vs {ref_name} [64, {n}, {c}]: max |diff| {err:.3e}, max |out| "
                  f"{scale:.3e}", flush=True)
            if ref_name == "plain version":
                max_err = max(max_err, err)
        k5_ms, k2_ms = (graph_ms(lambda: f(*args))
                        for f in (gn.group_norm_film_silu_packed, gn.group_norm_film_silu))
        b_ms, _ = bound_ms(*k5_work(64, n, c))
        per_shape[f"[64, {n}, {c}]"] = {"ms": k5_ms, "k2_fwd_ms": k2_ms, "bound_ms": b_ms}
        print(f"  K5 [64, {n}, {c}]: {k5_ms * 1e3:.2f} us, K2 bf16 forward {k2_ms * 1e3:.2f} us, "
              f"bound {b_ms * 1e3:.2f} us ({b_ms / k5_ms:.2f} of it)", flush=True)
        del x, args, out
    # K5's path: profile_gn at the level-0 shape
    gn.group_norm_film_silu_packed.launches = 0
    r = profile_gn.profile(dev, clusters=())  # the other cluster sizes: profile_gn alone
    launches = gn.group_norm_film_silu_packed.launches
    if launches == 0 or r["k5_vs_k2_max_abs_diff"] > K5_TOL * r["max_abs_out"] \
            or r["k5_graph_kernel_and_all_nodes"] != (1, 1):
        raise AssertionError(
            f"profile_gn: K5 launches {launches}, max |K5 - K2| "
            f"{r['k5_vs_k2_max_abs_diff']:.3e} (max |out| {r['max_abs_out']:.3e}), a graph of one "
            f"call: kernel and all nodes {r['k5_graph_kernel_and_all_nodes']} (want (1, 1))")
    print("  profile_gn: " + json.dumps(r), flush=True)
    b_ms, b_by = bound_ms(*k5_work(profile_gn.B, profile_gn.N, profile_gn.C))
    return {"name": "group_norm_film_silu_packed", "launches": launches, "max_abs_err": max_err,
            "ms": r["k5_ms"], "plain_ms": r["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "per_shape": per_shape}


def k3_phase(dev, randn, k1_args, distinct) -> tuple[dict, dict]:
    """Phase 10. Returns K3's forward and backward entries, with the launches
    of the stage run."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch import profile_attn
    from physicsinformeddiffusionmodels_tpu_torch.ops import linear_attention as la

    def k3_args(b, n, c):
        return [randn(b, n, c), randn(c, 768, scale=c**-0.5),
                randn(256, c, scale=K1_GAIN * n * 256**-0.5)]

    ragged = [(100, 32), (33, 64)]
    k3 = check_kernel("linear_attention", la.linear_attention, la.linear_attention_plain,
                      k3_args, distinct + ragged, K1_CALLS, k3_work, part=k3_term)
    # beyond check_kernel: bf16 at every shape and both batches, fp32 at the
    # ragged shapes at B=64
    for b in (4, 64):
        for shape in distinct + ragged:
            args = k3_args(b, *shape)
            if b == 64 and shape in ragged:
                ref = la.linear_attention_plain(*args)
                k3_term(args, ref)
                k3["max_abs_err"] = max(k3["max_abs_err"], compare(
                    la.linear_attention(*args), ref, TOL["fp32"], f"K3 B=64 {shape}"))
            bf = [args[0].bfloat16(), *args[1:]]
            compare(la.linear_attention(*bf), la.linear_attention_plain(*bf), TOL["bf16"],
                    f"K3 bf16 B={b} {shape}")
            del args, bf
    k3b = check_backward(
        "linear_attention_backward", la.linear_attention, la.linear_attention_plain,
        lambda *a: (*a, *la.launch_attention_forward(*a)[1:]), la.launch_attention_backward,
        k3_args, distinct + ragged, K1_CALLS, k3_bwd_work)
    # the two kernels against each other: K1(x) = x + b_out + K3(LN_gamma(x))
    worst = 0.0
    for shape in distinct + ragged:
        x, gamma, w_qkv, w_out, b_out = k1_args(4, *shape)
        k1 = la.linear_attention_block(x, gamma, w_qkv, w_out, b_out)
        mu, var = x.mean(dim=-1, keepdim=True), x.var(dim=-1, unbiased=False, keepdim=True)
        ln = ((x - mu) / torch.sqrt(var + 1e-5) * gamma).contiguous()
        composed = x + b_out + la.linear_attention(ln, w_qkv, w_out)
        scale = (k1 - x).abs().max().item()
        err = (k1 - composed).abs().max().item()
        if scale < K1_MIN_TERM or err > TOL["fp32"] * scale:
            raise AssertionError(f"K1 vs x + b_out + K3(LN(x)) at B=4 {shape}: max |diff| "
                                 f"{err:.3e}, max |K1 - x| {scale:.3e}")
        worst = max(worst, err / scale)
    print(f"  K1 = x + b_out + K3(LN(x)): worst max |diff| / max |K1 - x| {worst:.2e}",
          flush=True)
    # K3's main path: the level-0 stage, its attention through
    # PreNormResidual(SpatialLinearAttention), one eager forward and one eager
    # forward + backward (the stage through the plain version and through K1
    # beside it call no K3)
    la.linear_attention.launches = la.linear_attention.backward_launches = 0
    run = profile_attn.stage_run(dev)
    torch.cuda.synchronize()
    k3["launches"] = la.linear_attention.launches
    k3b["launches"] = la.linear_attention.backward_launches
    if (k3["launches"], k3b["launches"]) != (2, 1):
        raise AssertionError(f"the stage run launched K3 {k3['launches']} times forward and "
                             f"{k3b['launches']} times backward (want 2 and 1)")
    # the stage's output through K3 against the plain version and K1 (the
    # kernel itself is held above, at an O(1) attention term)
    out = run["stage_k3"]
    for name in ("stage_plain", "stage_k1"):
        err, scale = (out - run[name]).abs().max().item(), run[name].abs().max().item()
        if not torch.isfinite(out).all() or err > TOL["fp32"] * scale:
            raise AssertionError(f"level-0 stage through K3 vs {name}: max |diff| {err:.3e}, "
                                 f"max {scale:.3e}")
        print(f"  level-0 stage through K3 vs {name}: max |diff| {err:.3e}, max {scale:.3e}",
              flush=True)
    if not all(torch.isfinite(g).all() for g in run["grads_k3"]):
        raise AssertionError("level-0 stage through K3: a gradient is not finite")
    times = profile_attn.stage_times(dev)
    print("  level-0 stage (B=64, 64x64, C=32), device ms per call: " + json.dumps(times),
          flush=True)
    return k3, k3b


def k4_phase(dev, randn) -> tuple[dict, dict]:
    """Phases 15a-b: K4's forward and backward against the plain version on
    the same inputs, at every (P, Ci, Co) of K4_CALLS and K4_RAGGED, with and
    without FiLM, fp32 and bf16, at B=4 and B=64; at B=64 the path's calls
    are timed (CUDA-graph replay) beside the plain version and the port's
    default Block at the same shape (cuDNN's conv, then K2). Returns K4's
    forward and backward entries: one fp32 UNet pass's calls (K4_CALLS) and
    one bf16 + fp32-head pass's (the first K4_HEAD_CALLS), times and bounds
    summed; their launches come from phase 15e-f."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch.models.unet import Block
    from physicsinformeddiffusionmodels_tpu_torch.ops import conv_block as cb
    from physicsinformeddiffusionmodels_tpu_torch.utils.timing import graph_ms

    def k4_args(b, p, ci, co, film, dtype):
        return [randn(b, ci, p * p).to(dtype), randn(co, ci, 3, 3, scale=(9 * ci) ** -0.5),
                randn(co, scale=0.1), randn(co, scale=0.1, shift=1.0), randn(co, scale=0.1),
                randn(b, co, scale=0.1) if film else None,
                randn(b, co, scale=0.1) if film else None]

    def default_block(args, p):
        """The port's default Block with the same weights, and x as NHWC."""
        x, w, bias, gamma, beta, scale, shift = args
        b, ci, _ = x.shape
        block = Block(ci, w.shape[0], dtype=x.dtype if x.dtype != torch.float32 else None)
        block = block.to(dev)
        block.load_state_dict({"weight": w, "bias": bias, "gn_scale": gamma, "gn_bias": beta})
        x_nhwc = x.transpose(1, 2).reshape(b, p, p, ci).contiguous()
        film = None if scale is None else (scale, shift)
        return (lambda xn: block(xn, film)), list(block.parameters()), x_nhwc

    path = set(K4_CALLS)
    shapes = list(dict.fromkeys(c[:3] for c in K4_CALLS)) + [K4_RAGGED]
    times = {}  # (dtype, call) -> fwd and bwd: ms, plain_ms, default_block_ms, bound_ms
    max_err = {"fwd": 0.0, "bwd": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        elt, peak = (2, PEAK_BF16_FLOPS) if bf16 else (4, PEAK_FP32_FLOPS)
        for b in (4, 64):
            for p, ci, co in shapes:
                for film in (True, False):
                    call = (p, ci, co, film)
                    args = k4_args(b, p, ci, co, film, dtype)
                    kernel = lambda *a: cb.conv_gn_film_silu_cm(*a, p)  # noqa: E731
                    plain = lambda *a: cb.conv_gn_film_silu_cm_plain(*a, p)  # noqa: E731
                    # 15a: forward, within TOL of the largest output
                    out, ref = kernel(*args), plain(*args)
                    scale = ref.float().abs().max().item()
                    err = (out.float() - ref.float()).abs().max().item()
                    tol = TOL["bf16" if bf16 else "fp32"]
                    if out.dtype != dtype or not torch.isfinite(out).all() or err > tol * scale:
                        raise AssertionError(f"K4 {dtype} B={b} {call}: max |diff| {err:.3e} "
                                             f"> {tol} x max |out| {scale:.3e} ({out.dtype})")
                    if not bf16:
                        max_err["fwd"] = max(max_err["fwd"], err)
                    # 15b: backward through autograd, against autograd on plain
                    dy = torch.randn(out.shape, device=dev).to(dtype)
                    worst = 0.0
                    for name, g, r in zip(("dx", "dw", "dbias", "dgamma", "dbeta", "dscale",
                                           "dshift"), grads_of(kernel, args, dy),
                                          grads_of(plain, args, dy)):
                        rounded = bf16 and name in ("dx", "dw")
                        tol = (BF16_DX_TOL if rounded else BF16_PARAM_TOL) if bf16 else GRAD_TOL
                        scale = r.float().abs().max().item()
                        err = (g.float() - r.float()).abs().max().item()
                        if (g.dtype != r.dtype or not torch.isfinite(g).all()
                                or err > tol * scale):
                            raise AssertionError(f"K4 backward {dtype} B={b} {call} {name}: max "
                                                 f"|diff| {err:.3e} > {tol} x max |g| "
                                                 f"{scale:.3e} ({g.dtype}, autograd {r.dtype})")
                        if bf16 and name == "dw" and not torch.equal(g, g.bfloat16().float()):
                            raise AssertionError(f"K4 backward bf16 B={b} {call}: dW is not "
                                                 "rounded to bf16")
                        worst = max(worst, err / max(scale, 1e-30))
                        if not bf16:
                            max_err["bwd"] = max(max_err["bwd"], err)
                    if b == 64 and call in path:
                        fwd_default, block_params, x_nhwc = default_block(args, p)
                        x, w, bias, gamma, beta, sc, sh = args
                        if sc is None:
                            sc = sh = torch.zeros(b, co, device=dev)
                        wflat = cb.flatten_weight(w, dtype)
                        saved = cb.launch_forward(x, wflat, bias, gamma, beta, sc, sh, p,
                                                   for_backward=True)[1:]
                        b_ms, b_by = bound_ms(*k4_work(b, p, ci, co, film, elt), peak)
                        bb_ms, bb_by = bound_ms(*k4_bwd_work(b, p, ci, co, film, elt), peak)
                        with torch.no_grad():
                            f_ms = {"ms": graph_ms(lambda: kernel(*args)),
                                    "plain_ms": graph_ms(lambda: plain(*args)),
                                    "default_block_ms": graph_ms(lambda: fwd_default(x_nhwc)),
                                    "bound_ms": b_ms, "bound_by": b_by}
                        # a backward's time: its forward and backward, less the
                        # forward (the kernel's: the backward launch alone)
                        leaves = [x_nhwc.requires_grad_(True), *block_params]
                        dy_nhwc = dy.transpose(1, 2).reshape(x_nhwc.shape[:3] + (co,))
                        bwd_ms = {
                            "ms": graph_ms(lambda: cb.launch_backward(
                                dy, x, wflat, gamma, beta, sc, sh, *saved, p), reps=5),
                            "plain_ms": graph_ms(lambda: grads_of(plain, args, dy), reps=5)
                            - f_ms["plain_ms"],
                            "default_block_ms": graph_ms(lambda: torch.autograd.grad(
                                fwd_default(leaves[0]), leaves, dy_nhwc), reps=5)
                            - f_ms["default_block_ms"],
                            "bound_ms": bb_ms, "bound_by": bb_by}
                        times[dtype, call] = {"fwd": f_ms, "bwd": bwd_ms}
                        print(f"  K4 {'bf16' if bf16 else 'fp32'} B=64 {call}: forward "
                              f"{json.dumps(f_ms)}; backward {json.dumps(bwd_ms)}", flush=True)
                        del saved, leaves
                    del args, out, ref, dy
            print(f"  K4 {'bf16' if bf16 else 'fp32'} B={b}: every shape held", flush=True)

    entries = []
    for part, name, work in (("fwd", "conv_gn_film_silu_cm", k4_work),
                             ("bwd", "conv_gn_film_silu_cm_backward", k4_bwd_work)):
        entry = {"name": name, "max_abs_err": max_err[part], "library_ms": None}
        for dtype, calls, prefix in ((torch.float32, K4_CALLS, ""),
                                     (torch.bfloat16, K4_CALLS[:K4_HEAD_CALLS], "bf16_")):
            bf16 = dtype == torch.bfloat16
            for k in ("ms", "plain_ms", "default_block_ms", "bound_ms"):
                entry[prefix + k] = sum(times[dtype, call][part][k] for call in calls)
            nbytes, flops = (sum(v) for v in zip(*(work(64, *call, elt=2 if bf16 else 4)
                                                   for call in calls)))
            entry[prefix + "bound_by"] = bound_ms(
                nbytes, flops, PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS)[1]
        entries.append(entry)
    return entries[0], entries[1]


def cm_checkpoint_forward(tmp: Path) -> None:
    """Phase 15c (in the window after 19d): the 300k checkpoint's cm
    forward at B=8, card vs CPU (phase 5's tolerance), beside the card's
    default forward."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch import sample_eval

    dev = torch.device("cuda")
    ph = phase("15c cm checkpoint forward, card vs CPU")
    _, model, _ = sample_eval.load_run(RUN, compute_dtype="float32", device=dev)
    _, model_cpu, _ = sample_eval.load_run(RUN, compute_dtype="float32", device="cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 64, 64, 2)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 100, 8))
    with torch.no_grad():
        y_default = model(x.to(dev), t.to(dev)).cpu()
        model.cm_conv_stages = model_cpu.cm_conv_stages = True
        y = model(x.to(dev), t.to(dev)).cpu()
        with serial("cpu_references", "15c"):
            y_ref = model_cpu(x, t)
    err = (y - y_ref).abs().max().item()
    # the transplant tolerance, as phase 5
    if y.shape != (8, 64, 64, 2) or not torch.isfinite(y).all() or err > 5e-4:
        raise AssertionError(f"cm checkpoint forward: card vs CPU max |diff| {err:.3e}")
    del model_cpu
    done(ph, max_abs_err=f"{err:.3e}",
         cm_vs_default_max_abs_diff=f"{(y - y_default).abs().max().item():.3e}")


def cm_phase(tmp: Path, dev, smi: str, plain_summary: dict, steps_per_s: dict,
             later: list, refs: "CpuRefs") -> tuple:
    """Phases 15c-f on phase 9's data in ``tmp``: the cm UNet's checkpoint
    forward card vs CPU (``cm_checkpoint_forward``) and one cm train step
    card vs CPU (both to ``later``), cm sampling against phase 6's
    ``plain_summary``, then the cm training main
    paths, fp32 and bf16 + fp32 head, their steps/s beside 9d's and 13c's
    (``steps_per_s``). Returns K4's launch counts of the two runs
    (launch_counts()'s row)."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch import sample_eval, train
    from physicsinformeddiffusionmodels_tpu_torch.data.datasets import load_darcy_dataset
    from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import create_schedule

    cfg, model, _ = sample_eval.load_run(RUN, compute_dtype="float32", device=dev)
    model.cm_conv_stages = True
    ph = phase("15d cm sampling (main path)")
    zero_launch_counts()
    torch.cuda.synchronize()
    with timed("15d"):
        t0 = time.perf_counter()
        samples, residual, _ = sample_eval.sample_darcy(cfg, model, SAMPLES, 0, dev)
        res_b = residual.abs().mean(dim=(1, 2)).cpu().numpy()
        seconds = time.perf_counter() - t0
    launches = tuple(row[0] for row in launch_counts())
    want = (8 * STEPS, 20 * STEPS, 18 * STEPS)
    med, med_default = float(np.nanmedian(res_b)), plain_summary["residual_median"]
    if launches != want or not (
            np.isfinite(res_b).all() and RESIDUAL_RANGE[0] <= med <= RESIDUAL_RANGE[1]
            and abs(med / med_default - 1) <= CM_MEDIAN_RTOL):
        raise AssertionError(f"cm sampling: launches K1, K2, K4 {launches} (want {want}), "
                             f"median {med:.4e} (range {RESIDUAL_RANGE}, phase 6 "
                             f"{med_default:.4e} +- {CM_MEDIAN_RTOL:.0%})")
    moved = np.abs(samples.cpu().numpy() - plain_summary["samples"]).max()
    del model
    done(ph, residual_median=f"{med:.4e}", phase6_median=f"{med_default:.4e}",
         residual_mean=f"{np.nanmean(res_b):.4e}", sampling_seconds=f"{seconds:.2f}",
         samples_per_s=f"{SAMPLES / seconds:.2f}", k1_k2_k4_launches="/".join(map(str, launches)),
         max_abs_x0_cm_minus_default=f"{moved:.3e}")

    ds = load_darcy_dataset(tmp / "train")
    data = torch.as_tensor(ds.stacked(), device=dev)
    later += [functools.partial(cm_checkpoint_forward, tmp),
              functools.partial(step_card_vs_cpu, "15e one cm train step, card vs CPU", dev,
                                refs, cm=True)]
    counts = []
    for dtype, per_step, what, before in (
            ("float32", CM_FP32_STEP_LAUNCHES, "15e cm training, fp32", "9d"),
            ("bfloat16", CM_BF16_STEP_LAUNCHES, "15f cm training, bf16 + fp32 head", "13c")):
        cfg, model, _ = sample_eval.load_run(RUN, compute_dtype=dtype, device=dev)
        model.cm_conv_stages = True
        cfg.compute_dtype = dtype
        loss_fn = train.build_darcy_loss_fn(create_schedule(cfg.diff_steps),
                                            train.make_physics(cfg, dev), cfg)
        state, got, sps = train_main_path(what, model.train(), cfg, loss_fn, data, per_step, smi)
        print(f"  steps/s: cm {sps:.3f}, default ({before}) {steps_per_s[before]:.3f}",
              flush=True)
        counts.append(got[2])
        del state, model
    return tuple(counts)


def sampling_main_path(what: str, run: Path, out: Path, per_step: tuple, median_range: tuple,
                       **overrides) -> dict:
    """``sample_eval`` of ``run``'s EMA weights, 64 fp32 samples, seed 0,
    with the launch counts zeroed just before and read just after, held to
    ``per_step`` (K1's, K2's and K4's forward launches a sampling step); the
    residual median in ``median_range``. Returns the summary."""
    from physicsinformeddiffusionmodels_tpu_torch import sample_eval

    ph = phase(what)
    zero_launch_counts()
    with timed(what.split()[0]):
        summary = sample_eval.evaluate(run, SAMPLES, "float32", "cuda", seed=0, out=out,
                                       **overrides)
    launches = tuple(row[0] for row in launch_counts())
    want = tuple(STEPS * n for n in per_step)
    med = summary["residual_median"]
    if launches != want or not (np.isfinite(summary["res_b"]).all()
                                and median_range[0] <= med <= median_range[1]):
        raise AssertionError(f"{what}: launches K1, K2, K4 {launches} (want {want}), residual "
                             f"median {med:.4e} (range {median_range})")
    done(ph, residual_median=f"{med:.4e}", residual_mean=f"{summary['residual_mean']:.4e}",
         sampling_seconds=f"{summary['seconds']:.2f}",
         samples_per_s=f"{summary['samples_per_s']:.2f}",
         k1_k2_k4_launches="/".join(map(str, launches)))
    return summary


def ddim_phase(tmp: Path, dev, smi: str, later: list, refs: "CpuRefs") -> float:
    """Phase 16 on phase 9's data in ``tmp``: the DDIM run's sampling, one
    DDIM train step card vs CPU (to ``later``), then its training main
    path. Returns that path's steps/s."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch import sample_eval, train
    from physicsinformeddiffusionmodels_tpu_torch.data.datasets import load_darcy_dataset
    from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import create_schedule

    sampling_main_path("16a DDIM run: sampling (main path)", SAMPLE_RUN, tmp / "eval_ddim",
                       (8, 38, 0), DDIM_MEDIAN_RANGE)
    ds = load_darcy_dataset(tmp / "train")
    later.append(functools.partial(step_card_vs_cpu, "16b one DDIM train step, card vs CPU",
                                   dev, refs, run=SAMPLE_RUN))
    cfg, model, _ = sample_eval.load_run(SAMPLE_RUN, compute_dtype="float32", device=dev)
    cfg.compute_dtype = "float32"
    if not (cfg.use_ddim_x0 and cfg.ddim_steps == 0 and cfg.train_batch_size == DDIM_BATCH):
        raise AssertionError(f"{SAMPLE_RUN}: not a DDIM run at batch {DDIM_BATCH}")
    loss_fn = train.build_darcy_loss_fn(create_schedule(cfg.diff_steps),
                                        train.make_physics(cfg, dev), cfg)
    data = torch.as_tensor(ds.stacked(), device=dev)
    state, _, steps_per_s = train_main_path(
        "16c DDIM training (main path)", model.train(), cfg, loss_fn, data, DDIM_STEP_LAUNCHES,
        smi, steps=DDIM_STEPS, batch=DDIM_BATCH)
    del state, model
    return steps_per_s


def guided_forward(tmp: Path) -> None:
    """Phase 17a (in the window after 19d): the guided run's conditioned
    forward (a mixed null mask) and the residual gradient, card vs CPU."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch import sample_eval, train

    dev = torch.device("cuda")
    ph = phase("17a guided checkpoint forward with cond, card vs CPU")
    cfg, model, _ = sample_eval.load_run(GUIDED_RUN, compute_dtype="float32", device=dev)
    _, model_cpu, _ = sample_eval.load_run(GUIDED_RUN, compute_dtype="float32", device="cpu")
    if not cfg.residual_grad_guidance:
        raise AssertionError(f"{GUIDED_RUN} is not a guided run")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 64, 64, 2)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 100, 8))
    mask = torch.arange(8) % 3 == 0
    cond_cpu = train.make_physics(cfg, "cpu").residual_gradient(x)
    cond = train.make_physics(cfg, dev).residual_gradient(x.to(dev))
    cond_err = (cond.cpu() - cond_cpu).abs().max().item()
    with torch.no_grad():
        y = model(x.to(dev), t.to(dev), cond=cond_cpu.to(dev), null_mask=mask.to(dev)).cpu()
        with serial("cpu_references", "17a"):
            y_ref = model_cpu(x, t, cond=cond_cpu, null_mask=mask)
            y_plain = model_cpu(x, t)
    err = (y - y_ref).abs().max().item()
    # the transplant tolerance, as phase 5; the residual gradient as phase 11's
    if (not torch.isfinite(y).all() or err > 5e-4
            or cond_err > CORRECTION_TOL * cond_cpu.abs().max().item()):
        raise AssertionError(f"guided forward: card vs CPU max |diff| {err:.3e}; residual "
                             f"gradient max |diff| {cond_err:.3e}")
    del model, model_cpu
    done(ph, max_abs_err=f"{err:.3e}", residual_gradient_max_abs_err=f"{cond_err:.3e}",
         cond_vs_uncond_max_abs_diff=f"{(y_ref - y_plain).abs().max().item():.3e}")


def guidance_phase(tmp: Path, dev, smi: str, later: list, refs: "CpuRefs") -> float:
    """Phase 17 on phase 9's data in ``tmp``: the guided run's conditioned
    forward card vs CPU (``guided_forward``) and one guided train step card
    vs CPU at B=64 with a mixed null mask (both to ``later``), guided
    sampling at scales 1 and 3, then its
    training main path in the run's bf16. Returns that path's steps/s."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch import sample_eval, train
    from physicsinformeddiffusionmodels_tpu_torch.data.datasets import load_darcy_dataset
    from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import create_schedule

    later.append(functools.partial(guided_forward, tmp))
    medians = {}
    for scale, ref in GUIDED_JAX_FP32_MEDIANS.items():
        summary = sampling_main_path(
            f"17b guided sampling at scale {scale:g} (main path)", GUIDED_RUN,
            tmp / f"eval_guided_{scale:g}", (16, 76, 0), (0.5 * ref, 2.0 * ref),
            guidance_scale=scale)
        if summary["guidance_scale"] != scale:
            raise AssertionError(f"eval_settings.json records scale {summary['guidance_scale']}")
        medians[scale] = summary["residual_median"]
    print("  guided medians, port fp32 on the card against JAX fp32 on the CPU: " + json.dumps(
        {f"{k:g}": [f"{medians[k]:.4e}", f"{v:.4e}"] for k, v in
         GUIDED_JAX_FP32_MEDIANS.items()}), flush=True)

    ds = load_darcy_dataset(tmp / "train")
    later.append(functools.partial(step_card_vs_cpu, "17c one guided train step, card vs CPU",
                                   dev, refs, run=GUIDED_RUN))
    cfg, model, _ = sample_eval.load_run(GUIDED_RUN, device=dev)
    loss_fn = train.build_darcy_loss_fn(create_schedule(cfg.diff_steps),
                                        train.make_physics(cfg, dev), cfg)
    data = torch.as_tensor(ds.stacked(), device=dev)
    state, _, steps_per_s = train_main_path(
        f"17d guided training, {cfg.compute_dtype} (main path)", model.train(), cfg, loss_fn,
        data, GUIDED_STEP_LAUNCHES, smi, steps=GUIDED_STEPS)
    del state, model
    return steps_per_s


def _recipe(run: Path, dtype, dev, ema_start=None):
    """(cfg, model in train mode, loss_fn) of ``run``'s EMA weights in
    ``dtype`` (None: the run's)."""
    from physicsinformeddiffusionmodels_tpu_torch import sample_eval, train
    from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import create_schedule

    cfg, model, _ = sample_eval.load_run(run, compute_dtype=dtype, device=dev)
    cfg.compute_dtype = dtype or cfg.compute_dtype
    if ema_start is not None:
        cfg.ema_start = ema_start
    loss_fn = train.build_darcy_loss_fn(create_schedule(cfg.diff_steps),
                                        train.make_physics(cfg, dev), cfg)
    return cfg, model.train(), loss_fn


def _train_steps(data, state, cfg, loss_fn, gen, n, graphed=None):
    """``n`` resident train steps on ``data`` at TRAIN_BATCH (replays of
    ``graphed`` when given); returns the last step's aux."""
    from physicsinformeddiffusionmodels_tpu_torch import train
    from physicsinformeddiffusionmodels_tpu_torch.training.trainer import resident_train_step

    for _ in range(n):
        aux = resident_train_step(state, loss_fn, data, TRAIN_BATCH, cfg.diff_steps, cfg.seed,
                                  gen, ema_mu=cfg.ema_decay, ema_start=cfg.ema_start,
                                  null_cond_prob=train.null_cond_prob(cfg), graphed=graphed)
    return aux


def graph_bit_equality(tmp: Path) -> None:
    """Phase 18a on 9a's sets in ``tmp`` (the card lane runs it):
    GRAPH_STEPS steps replayed from ``trainer.GraphedTrainStep`` against as
    many eager steps from the same weights and draws, bit for bit (weights,
    EMA, Adam's moments and step, the optimizer's count, the last loss),
    under cuDNN's deterministic algorithms, in fp32, bf16 + fp32 head and
    the guided recipe, with ``ema_start`` inside the run (two captures)."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch.data.datasets import load_darcy_dataset
    from physicsinformeddiffusionmodels_tpu_torch.training.trainer import (
        GraphedTrainStep, create_train_state, make_optimizer)

    dev = torch.device("cuda")
    data = torch.as_tensor(load_darcy_dataset(tmp / "train").stacked(), device=dev)
    steps = functools.partial(_train_steps, data)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for name, run, dtype, per_step in (
                ("fp32", RUN, "float32", FP32_STEP_LAUNCHES),
                ("bf16 + fp32 head", RUN, "bfloat16", BF16_STEP_LAUNCHES),
                ("guided, bf16", GUIDED_RUN, None, GUIDED_STEP_LAUNCHES)):
            ph = phase(f"18a {GRAPH_STEPS} graph-replayed steps vs eager, {name}")
            runs = []
            for graph in (False, True):
                cfg, model, loss_fn = _recipe(run, dtype, dev, ema_start=GRAPH_EMA_START)
                state = create_train_state(model, make_optimizer(model, cfg.lr, cfg.grad_clip))
                graphed = GraphedTrainStep(state, loss_fn, cfg.ema_decay,
                                           cfg.ema_start) if graph else None
                zero_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                aux = steps(state, cfg, loss_fn, torch.Generator(device=dev), GRAPH_STEPS,
                            graphed)
                torch.cuda.synchronize()
                runs.append((state, aux.loss.detach().clone(), launch_counts(), graphed,
                             time.perf_counter() - t0))
            (eager, loss_e, counts_e, _, sec_e), (replay, loss_g, counts_g, graphed, sec_g) = runs
            # wrapper calls are made only while capturing (warm-up steps and
            # the capture itself); a replay makes none
            captured = graphed.captures * (GraphedTrainStep.WARMUP + 1)
            want_e, want_g = launches_of(GRAPH_STEPS, per_step), launches_of(captured, per_step)
            same = {
                "params": all(torch.equal(a, b) for a, b in zip(eager.model.parameters(),
                                                                replay.model.parameters())),
                "ema": all(torch.equal(a, b) for a, b in zip(eager.ema.parameters(),
                                                             replay.ema.parameters())),
                "adam": all(torch.equal(sa[k], sb[k])
                            for sa, sb in zip(eager.optimizer.adam.state.values(),
                                              replay.optimizer.adam.state.values())
                            for k in ("step", "exp_avg", "exp_avg_sq")),
                "counts": (eager.step, eager.optimizer.count) == (replay.step,
                                                                   replay.optimizer.count)
                == (GRAPH_STEPS, GRAPH_STEPS),
                "loss": torch.equal(loss_e, loss_g),
                "ema_moved": not all(torch.equal(a, b) for a, b in zip(
                    eager.ema.parameters(), eager.model.parameters())),
            }
            if (not all(same.values()) or graphed.captures != 2 or counts_e != want_e
                    or counts_g != want_g or len(eager.optimizer.adam.state) == 0):
                raise AssertionError(f"18a {name}: equal {same}, captures {graphed.captures}, "
                                     f"launches eager {counts_e} (want {want_e}), graph run "
                                     f"{counts_g} (want {want_g})")
            done(ph, bit_equal=all(same.values()), captures=graphed.captures,
                 adam_tensors=len(eager.optimizer.adam.state), last_loss=f"{loss_e.item():.6e}",
                 eager_s=f"{sec_e:.2f}", graph_s_with_captures=f"{sec_g:.2f}")
            del runs, eager, replay, graphed


def graph_phase(tmp: Path, dev, smi: str, steps_per_s: dict) -> None:
    """Phase 18b on phase 9's data in ``tmp`` (18a: ``graph_bit_equality``):
    steps/s of 9d's and 13c's training eager and from the graph,
    GRAPH_TIMED_STEPS each, in turns (eager, graph, graph, eager), beside
    9d's and 13c's own."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch.data.datasets import load_darcy_dataset
    from physicsinformeddiffusionmodels_tpu_torch.training.trainer import (
        GraphedTrainStep, create_train_state, make_optimizer)

    data = torch.as_tensor(load_darcy_dataset(tmp / "train").stacked(), device=dev)
    steps = functools.partial(_train_steps, data)

    for key, dtype in (("9d", "float32"), ("13c", "bfloat16")):
        ph = phase(f"18b steps/s of {key} eager and from the graph")
        cfg, model, loss_fn = _recipe(RUN, dtype, dev)
        state = create_train_state(model, make_optimizer(model, cfg.lr, cfg.grad_clip))
        graphed = GraphedTrainStep(state, loss_fn, cfg.ema_decay, cfg.ema_start)
        gen = torch.Generator(device=dev)
        steps(state, cfg, loss_fn, gen, 3)
        steps(state, cfg, loss_fn, gen, 1, graphed)  # the capture
        rates = {"eager": [], "graph": []}
        for mode in ("eager", "graph", "graph", "eager"):
            with timed("18b"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                steps(state, cfg, loss_fn, gen, GRAPH_TIMED_STEPS,
                      graphed if mode == "graph" else None)
                torch.cuda.synchronize()
                rates[mode].append(GRAPH_TIMED_STEPS / (time.perf_counter() - t0))
        eager_sps, graph_sps = float(np.mean(rates["eager"])), float(np.mean(rates["graph"]))
        steps_per_s[f"{key} graph"] = graph_sps
        done(ph, eager_steps_per_s="/".join(f"{r:.3f}" for r in rates["eager"]),
             graph_steps_per_s="/".join(f"{r:.3f}" for r in rates["graph"]),
             graph_over_eager=f"{graph_sps / eager_sps:.3f}",
             main_path_steps_per_s=f"{steps_per_s[key]:.3f}")
        print(f"  {smi}", flush=True)
        del state, graphed, model


# forward launches of one UNet call under bf16 + fp32 head (rows as
# FP32_STEP_LAUNCHES): every K1 and all K2 but the head's two on bf16 x
MECH_FWD_LAUNCHES = ((8, 8, 0, 0), (38, 36, 0, 0), (0, 0, 0, 0))


def kernel_calls(model, x, t) -> tuple[list, list]:
    """The K1 calls (N, C, dtype) and K2 calls (N, C, FiLM, dtype) of one
    forward of ``model`` on (x, t), in call order, recorded by hooks on its
    ``LinearAttentionBlock`` and ``Block`` modules (K2 normalises a Block's
    conv output, the Block's output shape)."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch.models.unet import Block, LinearAttentionBlock

    k1, k2 = [], []

    def on_attn(module, args, out):
        k1.append((out.shape[1] * out.shape[2], out.shape[3], str(out.dtype)[6:]))

    def on_block(module, args, kwargs, out):
        film = len(args) > 1 and args[1] is not None
        k2.append((out.shape[1] * out.shape[2], out.shape[3], film, str(out.dtype)[6:]))

    hooks = [m.register_forward_hook(on_attn) for m in model.modules()
             if isinstance(m, LinearAttentionBlock)]
    hooks += [m.register_forward_hook(on_block, with_kwargs=True) for m in model.modules()
              if isinstance(m, Block)]
    try:
        with torch.no_grad():
            model(x, t)
    finally:
        for h in hooks:
            h.remove()
    return k1, k2


def mech_sets(root: Path, jobs: DataJobs) -> tuple[dict, float]:
    """MECH_SETS under ``root`` (``jobs``' mechanics part): the sets (host
    arrays) by name, and the seconds they took."""
    from physicsinformeddiffusionmodels_tpu_torch.data.datasets import NpyFieldDataset

    gen_s = jobs.wait("mechanics")
    return {name: NpyFieldDataset(root / sub / "fields").stacked()
            for name, sub in (("train", "train"), ("valid", "test/valid"),
                              ("test_level_1", "test/test_level_1"),
                              ("test_level_2", "test/test_level_2"))}, gen_s


def mech_data_phase(dev, sets: dict, gen_s: float) -> None:
    """Phase 19a (in the window after 19d) on ``mech_sets``' sets: the
    fields' own residual and the card's PCG on their designs against the
    host's float64 sparse-LU solve."""
    import scipy.sparse.linalg as spla
    import torch

    from physicsinformeddiffusionmodels_tpu_torch.physics.mechanics import (
        MechanicsResidual, split_mechanics_batch)

    ph = phase("19a mechanics data (port generator), its residual and PCG on the card")
    fields = torch.as_tensor(np.concatenate(list(sets.values())), device=dev)
    n = fields.shape[0]
    mech = MechanicsResidual(64, device=dev)
    mb = split_mechanics_batch(fields)
    rho = mb.solution[:, :-1, :-1, 2].reshape(n, -1)
    res, u, f, _ = mech.residual_from_fields(mb.solution[..., :2], rho, mb.bcs)
    res_b = res.abs().mean(dim=1)
    if not torch.isfinite(res_b).all() or res_b.max().item() > MECH_DATA_RESIDUAL_MAX:
        raise AssertionError(f"19a: the generated fields' residual, mean |r| up to "
                             f"{res_b.max().item():.3e} > {MECH_DATA_RESIDUAL_MAX}")
    rho_h, bcs_h = rho.cpu().numpy(), mb.bcs.cpu().numpy()
    iters, seconds, relres_max, ce_max, fallbacks = [], [], 0.0, 0.0, 0
    for start in range(0, n, MECH_BATCH):
        sl = slice(start, start + MECH_BATCH)
        with timed("19a"):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            u_sol, relres, k = mech.solve(rho[sl], mb.bcs[sl])
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t1)
        iters.append(int(k))
        relres_max = max(relres_max, relres.max().item())
        if not torch.isfinite(u_sol).all() or relres.max().item() > PCG_RELRES_MAX:
            raise AssertionError(f"19a: PCG on designs {start}-{start + MECH_BATCH - 1}: "
                                 f"relres {relres.cpu().numpy()} (limit {PCG_RELRES_MAX})")
        u_h = u_sol.double().cpu().numpy()
        for i in range(u_h.shape[0]):
            j = start + i
            K, f64, _ = mech._assemble_sparse_host(rho_h[j], bcs_h[j])
            rr = np.linalg.norm(K @ u_h[i] - f64) / max(np.linalg.norm(f64), 1e-30)
            fallbacks += int(rr > 1e-4)  # those topopt_eval_checked would solve again
            exact = spla.spsolve(K.tocsc(), f64) @ f64
            err = abs(u_h[i] @ f64 - exact) / exact
            ce_max = max(ce_max, err)
            if err > MECH_CE_TOL:
                raise AssertionError(f"19a: design {j}: PCG compliance {err:.3e} from the "
                                     f"sparse-LU solve's (float64 relres {rr:.3e})")
    done(ph, samples=n, generated_in_background_s=f"{gen_s:.2f}", data_residual_max=f"{res_b.max().item():.3e}",
         pcg_iterations="/".join(map(str, iters)), pcg_s="/".join(f"{v:.2f}" for v in seconds),
         pcg_relres_max=f"{relres_max:.3e}", pcg_compliance_err_max=f"{ce_max:.3e}",
         host_check_fallbacks=f"{fallbacks}/{n}")


def mech_models(cfg, dtypes, dev) -> tuple[dict, dict]:
    """The mechanics UNet's seeded weights (MECH_SEED, initialised on the
    CPU) and a model of them in each of ``dtypes`` on ``dev``."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch.models.unet import build_model

    torch.manual_seed(MECH_SEED)
    weights = build_model(cfg, "float32").state_dict()
    models = {}
    for dtype in dtypes:
        with torch.device("meta"):  # no initialisation: the seeded weights go in
            models[dtype] = build_model(cfg, dtype)
        models[dtype].load_state_dict({k: v.to(dev, copy=True) for k, v in weights.items()},
                                      assign=True)
    return weights, models


def ref_19c(tmp: Path) -> dict:
    """The CPU half of phase 19c (computed by the CPU-reference worker): at
    B=MECH_STEP_BATCH, the seeded mechanics UNet's fp32 forward of x and t
    drawn from seed 19, then one fp32 and one bf16 + fp32-head train step
    of the mechanics loss on a batch of 19a's training set in ``tmp`` and
    noise drawn after them."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch.config import RunConfig
    from physicsinformeddiffusionmodels_tpu_torch.data.datasets import NpyFieldDataset
    from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import create_schedule
    from physicsinformeddiffusionmodels_tpu_torch.physics.mechanics import MechanicsResidual
    from physicsinformeddiffusionmodels_tpu_torch.train_mechanics import (
        MECHANICS_DEFAULTS, SOLUTION_CHANNELS, build_mechanics_loss_fn)

    cfg = RunConfig(gov_eqs="mechanics", **MECHANICS_DEFAULTS, compute_dtype="bfloat16",
                    fp32_head=True)
    _, models = mech_models(cfg, ("float32", "bfloat16"), "cpu")
    rng = np.random.default_rng(19)
    x = torch.from_numpy(rng.standard_normal((MECH_STEP_BATCH, 64, 64, 10)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, cfg.diff_steps, MECH_STEP_BATCH))
    train = NpyFieldDataset(tmp / "mechanics" / "train" / "fields").stacked()
    batch = torch.from_numpy(train[rng.integers(0, len(train), MECH_STEP_BATCH)])
    noise = torch.from_numpy(rng.standard_normal(
        (MECH_STEP_BATCH, 65, 65, SOLUTION_CHANNELS)).astype(np.float32))
    with torch.no_grad():
        y = models["float32"](x, t)
    loss_fn = build_mechanics_loss_fn(create_schedule(cfg.diff_steps),
                                      MechanicsResidual(64, device="cpu"), cfg)
    loss, _ = loss_fn(models["float32"], batch, t, noise)
    grads = torch.autograd.grad(loss, list(models["float32"].parameters()), allow_unused=True)
    loss16, grads16 = step_grads(loss_fn, models["bfloat16"], batch, t, noise)
    return {"inputs": (x, t, batch, noise), "y": y, "loss": loss.detach(), "grads": list(grads),
            "loss16": loss16, "grads16": list(grads16)}


def mech_steps_card_vs_cpu(dev, refs: "CpuRefs", models: dict, loss_fn) -> None:
    """Phase 19c on the card: the seeded mechanics UNet (``models`` by
    dtype), on the inputs of ``ref_19c``, held to its CPU half (``refs``'
    entry): the fp32 forward (the transplant tolerance, the density a
    sigmoid's), the fp32 step by 9b's rules, the bf16 + fp32-head step by
    13a's."""
    import torch

    ph = phase("19c full-width fp32 forward, card vs CPU")
    ref = refs.get("19c")
    x, t, batch, noise = (a.to(dev) for a in ref["inputs"])
    with torch.no_grad():
        y = models["float32"](x, t).cpu()
    y_ref = ref["y"]
    err = (y - y_ref).abs().max().item()
    if (y.shape != (MECH_STEP_BATCH, 64, 64, 3) or not torch.isfinite(y).all() or err > 5e-4
            or not 0.0 <= y[..., 2].min().item() <= y[..., 2].max().item() <= 1.0):
        raise AssertionError(f"19c forward: card vs CPU max |diff| {err:.3e}, shape "
                             f"{tuple(y.shape)}")
    done(ph, batch=MECH_STEP_BATCH, max_abs_err=f"{err:.3e}",
         max_abs_out=f"{y_ref.abs().max().item():.3e}")

    ph = phase("19c one fp32 mechanics train step, card vs CPU")
    loss, _ = loss_fn(models["float32"], batch, t, noise)
    grads = torch.autograd.grad(loss, list(models["float32"].parameters()), allow_unused=True)
    done(ph, batch=MECH_STEP_BATCH, **hold_fp32_step(models["float32"], loss, grads,
                                                     ref["loss"], ref["grads"]),
         cpu_s=f"{ref['seconds']:.2f}")
    ph = phase("19c one bf16 + fp32-head mechanics train step, card vs CPU")
    before = launch_counts()
    loss16, grads16 = step_grads(loss_fn, models["bfloat16"], batch, t, noise)
    torch.cuda.synchronize()
    launched = tuple(tuple(a - b for a, b in zip(*rows)) for rows in zip(launch_counts(), before))
    if launched != BF16_STEP_LAUNCHES:
        raise AssertionError(f"19c bf16 step launches K1, K2, K4 {launched}, "
                             f"want {BF16_STEP_LAUNCHES}")
    done(ph, **hold_bf16_step(models["bfloat16"], loss16, grads16, loss.item(), grads,
                              ref["loss16"], ref["grads16"], ref["loss"].item()),
         launches=launched)
    models.clear()


def mech_sweep(tmp: Path) -> None:
    """Phase 19e in ``tmp`` (in the window after 19d): ``sample_eval``'s
    mechanics sweep of 19d's CLI checkpoint, one batch of MECH_BATCH a test
    level: the five CSVs a level, every metric finite, launches counted."""
    from physicsinformeddiffusionmodels_tpu_torch import sample_eval

    ph = phase("19e sample_eval mechanics sweep of the CLI's checkpoint (beside phase 23's "
               "ranks: its samples/s are a shared card's)")
    zero_launch_counts()
    summary = sample_eval.evaluate(tmp / "mech_runs" / "mech", MECH_BATCH, device="cuda", seed=0,
                                   out=tmp / "mech_eval", test_batches=1,
                                   test_data_root=tmp / "mechanics")
    launches, want = launch_counts(), launches_of(2 * STEPS, MECH_FWD_LAUNCHES)
    if launches != want:
        raise AssertionError(f"19e: launches K1, K2, K4 {launches}, want {want}")
    info = {}
    for level, lv in summary["levels"].items():
        ldir = tmp / "mech_eval" / level
        missing = [n for n in ("residuals", "rel_CE_error", "rel_vf_error", "fm_error",
                               "sample_statistics") if not (ldir / f"{n}.csv").exists()]
        metrics = np.concatenate([lv[k] for k in ("res_b", "rel_CE", "rel_vf", "fm")])
        if missing or lv["n"] != MECH_BATCH or not np.isfinite(metrics).all():
            raise AssertionError(f"19e {level}: missing {missing}, n {lv['n']}, finite "
                                 f"{np.isfinite(metrics).all()}")
        info[level] = (f"rel_CE median {lv['rel_CE_median']:.4e}, residual median "
                       f"{lv['residual_median']:.4e}, fallbacks {lv['n_solve_fallback']}, "
                       f"{lv['samples_per_s']:.2f} samples/s ({MECH_BATCH} x {STEPS} steps), "
                       f"PCG {lv['solve_seconds']:.2f} s ({lv['solve_iterations']} iterations)")
        print(f"  {level}: {info[level]}", flush=True)
    done(ph, launches="/".join(str(row) for row in launches))


def mechanics_phase(tmp: Path, dev, smi: str, k1_args, k2_args, jobs: DataJobs,
                    after_timing, later: list, refs: "CpuRefs") -> tuple[tuple, tuple, dict]:
    """Phase 19 in ``tmp``, on ``jobs``' mechanics sets (19e:
    ``mech_sweep``); ``after_timing()`` is called when 19d's steps/s are
    taken; 19c's card vs CPU checks go to ``later``. Returns K1's and K2's
    launch counts of 19d's CLI run and the steps/s of 19d."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch import train
    from physicsinformeddiffusionmodels_tpu_torch.config import RunConfig
    from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import create_schedule
    from physicsinformeddiffusionmodels_tpu_torch.models.unet import build_model
    from physicsinformeddiffusionmodels_tpu_torch.ops.group_norm import (
        group_norm_film_silu, group_norm_film_silu_plain)
    from physicsinformeddiffusionmodels_tpu_torch.ops.linear_attention import (
        linear_attention_block, linear_attention_block_plain)
    from physicsinformeddiffusionmodels_tpu_torch.physics.mechanics import MechanicsResidual
    from physicsinformeddiffusionmodels_tpu_torch.train_mechanics import (
        MECHANICS_DEFAULTS, SOLUTION_CHANNELS, build_mechanics_loss_fn)
    from physicsinformeddiffusionmodels_tpu_torch.training.trainer import (
        GraphedTrainStep, create_train_state, make_optimizer, resident_train_step)

    root = tmp / "mechanics"
    sets, gen_s = mech_sets(root, jobs)
    cfg = RunConfig(gov_eqs="mechanics", **MECHANICS_DEFAULTS, compute_dtype="bfloat16",
                    fp32_head=True)
    weights, models = mech_models(cfg, ("float32", "bfloat16"), dev)
    n_params = sum(p.numel() for p in weights.values())
    del weights

    def mechanics_kernel_calls():
        """19b: K1 and K2 at every (N, C) of the UNet's calls."""
        ph = phase("19b K1 and K2 at the mechanics UNet's shapes")
        rng = np.random.default_rng(19)
        x = torch.from_numpy(rng.standard_normal((MECH_STEP_BATCH, 64, 64, 10))
                             .astype(np.float32))
        t = torch.from_numpy(rng.integers(0, cfg.diff_steps, MECH_STEP_BATCH))
        k1_calls, k2_calls = kernel_calls(models["bfloat16"], x[:1].to(dev), t[:1].to(dev))
        print(f"  K1 calls (N, C, dtype): {k1_calls}", flush=True)
        print(f"  K2 calls (N, C, FiLM, dtype): {k2_calls}", flush=True)
        if len(k1_calls) != 8 or len(k2_calls) != 38:
            raise AssertionError(f"19b: {len(k1_calls)} K1 and {len(k2_calls)} K2 calls a "
                                 "forward")
        k1_shapes = list(dict.fromkeys(c[:2] for c in k1_calls))
        k2_shapes = list(dict.fromkeys(c[:3] for c in k2_calls))
        print_k2_plans(MECH_BATCH, [c[:2] for c in k2_shapes])
        for backward in (False, True):
            suffix = "_backward" if backward else ""
            check_mechanics("linear_attention_block" + suffix, linear_attention_block,
                            linear_attention_block_plain, k1_args, k1_shapes, backward,
                            part=None if backward else k1_term)
            check_mechanics("group_norm_film_silu" + suffix, group_norm_film_silu,
                            group_norm_film_silu_plain, k2_args, k2_shapes, backward)
        done(ph, parameters=n_params, k1_shapes=len(k1_shapes), k2_shapes=len(k2_shapes))

    # 19a-c time nothing: they run in the window after 19d (19b's kernel
    # checks draw their inputs from the shared generator, as before: nothing
    # else draws from it after 15ab)
    loss_fn = build_mechanics_loss_fn(create_schedule(cfg.diff_steps),
                                      MechanicsResidual(64, device=dev), cfg)
    later += [mechanics_kernel_calls, functools.partial(mech_data_phase, dev, sets, gen_s),
              functools.partial(mech_steps_card_vs_cpu, dev, refs, models, loss_fn)]

    # 19d: the CLI; step 0 runs eager, the rest in chunks replayed from a graph
    ph = phase("19d mechanics training CLI, bf16 + fp32 head (main path)")
    out = tmp / "mech_runs"
    args = ["--gov-eqs", "mechanics", "--name", "mech", "--batch-size", str(MECH_BATCH),
            "--compute-dtype", "bfloat16", "--fp32-head",
            "--data-dir", str(root / "train" / "fields"),
            "--valid-data-dir", str(root / "test" / "valid" / "fields"),
            "--output-dir", str(out), "--iterations", str(MECH_CLI_STEPS),
            "--chunk-steps", str(MECH_CHUNK), "--sample-freq", str(MECH_CLI_STEPS),
            "--test-eval-freq", str(MECH_CHUNK), "--log-freq", str(MECH_CHUNK),
            "--no-samples", str(MECH_CLI_SAMPLES)]
    zero_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with timed("19d"):
        t1 = time.perf_counter()
        train.main(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
    # train-step wrapper calls: step 0, and the graph's two warm-up steps and
    # capture (a replay makes none); forward-only: the evaluations and sampling
    step_calls = 1 + GraphedTrainStep.WARMUP + 1
    fwd_calls = MECH_CLI_STEPS // MECH_CHUNK + 1 + STEPS
    got = launch_counts()
    want = tuple(tuple(step_calls * a + fwd_calls * b for a, b in zip(r, f))
                 for r, f in zip(BF16_STEP_LAUNCHES, MECH_FWD_LAUNCHES))
    if got != want:
        raise AssertionError(f"19d: launches K1, K2, K4 {got}, want {want}")
    with open(out / "mech" / "metrics.csv", newline="") as fh:
        rows = list(csv.DictReader(fh))
    last = [r for r in rows if r["rel_CE_error"]][-1]
    vals = {k: float(last[k]) for k in ("residual_mean_abs_samples", "rel_CE_error",
                                        "rel_vf_error", "fm_error", "n_solve_fallback")}
    ckpt = out / "mech" / "model" / f"checkpoint_{MECH_CLI_STEPS}.msgpack"
    steps_logged = [int(r["step"]) for r in rows if r["loss"]]
    if not (all(np.isfinite(list(vals.values()))) and ckpt.exists()
            and steps_logged == list(range(0, MECH_CLI_STEPS + 1, MECH_CHUNK))):
        raise AssertionError(f"19d: sample metrics {vals}, {ckpt} {ckpt.exists()}, "
                             f"steps logged {steps_logged}")
    done(ph, seconds=f"{seconds:.2f}",
         peak_memory_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
         checkpoint_mib=f"{ckpt.stat().st_size / 2**20:.0f}",
         **{k: f"{v:.4e}" for k, v in vals.items()},
         **{f"{k}_fwd_bf16_bwd_bf16": "/".join(map(str, row)) for k, row in zip(("k1", "k2"), got)})

    ph = phase("19d mechanics steps/s eager and from the graph")
    data = torch.as_tensor(sets["train"], device=dev)
    torch.manual_seed(MECH_SEED)
    model = build_model(cfg).to(dev)
    state = create_train_state(model, make_optimizer(model, cfg.lr, cfg.grad_clip))
    graphed = GraphedTrainStep(state, loss_fn, cfg.ema_decay, cfg.ema_start)
    gen = torch.Generator(device=dev)

    def run(n, graph=None):
        for _ in range(n):
            aux = resident_train_step(state, loss_fn, data, MECH_BATCH, cfg.diff_steps,
                                      cfg.seed, gen, ema_mu=cfg.ema_decay,
                                      ema_start=cfg.ema_start, graphed=graph,
                                      noise_channels=SOLUTION_CHANNELS)
        return aux

    run(2)
    run(1, graphed)  # the capture
    rates = {"eager": [], "graph": []}
    for mode in ("eager", "graph", "graph", "eager"):
        with timed("19d"):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            aux = run(MECH_TIMED_STEPS, graphed if mode == "graph" else None)
            torch.cuda.synchronize()
            rates[mode].append(MECH_TIMED_STEPS / (time.perf_counter() - t1))
    if not np.isfinite(aux.loss.item()):
        raise AssertionError(f"19d: loss {aux.loss.item()}")
    steps_per_s = {"19d": float(np.mean(rates["eager"])),
                   "19d graph": float(np.mean(rates["graph"]))}
    done(ph, batch=MECH_BATCH, eager_steps_per_s="/".join(f"{r:.3f}" for r in rates["eager"]),
         graph_steps_per_s="/".join(f"{r:.3f}" for r in rates["graph"]),
         graph_over_eager=f"{steps_per_s['19d graph'] / steps_per_s['19d']:.3f}")
    print(f"  {smi}", flush=True)
    del state, graphed, model, data
    after_timing()

    return got[0], got[1], steps_per_s


def toy_card_vs_cpu(tmp: Path) -> None:
    """Phase 20a (the card lane runs it): the toy model's forward, then one
    fp32 loss and its gradients at B=128 for each prediction mode and x0
    estimate, card vs CPU (9b's rules)."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch import train_toy
    from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import create_schedule
    from physicsinformeddiffusionmodels_tpu_torch.models.toy import ConditionalModel
    from physicsinformeddiffusionmodels_tpu_torch.physics.toy import sample_hypersphere

    dev = torch.device("cuda")
    ph = phase("20a toy model and loss, card vs CPU")
    rng = np.random.default_rng(20)
    x0 = torch.from_numpy(sample_hypersphere(rng, 128).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 100, 128))
    noise = torch.from_numpy(rng.standard_normal((128, 2)).astype(np.float32))
    models = {d: ConditionalModel(seed=20).to(d) for d in (dev, "cpu")}
    with torch.no_grad():
        y, y_cpu = models[dev](x0.to(dev), t.to(dev)).cpu(), models["cpu"](x0, t)
    fwd_err = (y - y_cpu).abs().max().item()
    if not torch.isfinite(y).all() or fwd_err > 1e-5 * y_cpu.abs().max().item():
        raise AssertionError(f"20a toy forward: card vs CPU max |diff| {fwd_err:.3e}")
    worst = {}
    for mode, estimation in TOY_MODES:
        cfg = {**train_toy.default_config(), "model_pred_mode": mode, "x0_estimation": estimation}
        loss_fn = train_toy.build_loss_fn(create_schedule(cfg["n_steps"]), cfg)
        out = {}
        for d, args in ((dev, (x0.to(dev), t.to(dev), noise.to(dev))), ("cpu", (x0, t, noise))):
            loss, _ = loss_fn(models[d], *args)
            out[d] = loss, torch.autograd.grad(loss, list(models[d].parameters()))
        held = hold_fp32_step(models[dev], *out[dev], *out["cpu"])
        worst[f"{mode}/{estimation}"] = f"{held['loss_rel']}, {held['worst_grad_rel']}"
    done(ph, forward_max_abs_err=f"{fwd_err:.3e}", loss_rel_and_worst_grad_rel=json.dumps(worst))


def toy_phase(tmp: Path, dev, smi: str) -> dict:
    """Phase 20b, the toy study (20a: ``toy_card_vs_cpu``): the
    ``train_toy`` CLI at full width on the card for TOY_EPOCHS epochs with
    its 1000-sample pass: steps/s, samples/s, the sample residual, every
    logged loss finite, and JAX's files. Returns the CLI's rates."""
    from physicsinformeddiffusionmodels_tpu_torch import train_toy

    ph = phase("20b train_toy CLI at full width (main path)")
    out_dir = tmp / "toy"
    with timed("20b"):
        res = train_toy.main(["--epochs", str(TOY_EPOCHS), "--name", "smoke",
                              "--output-dir", str(out_dir), "--device", dev.type])
    run = out_dir / "smoke"
    with open(run / "metrics.csv", newline="") as fh:
        rows = list(csv.DictReader(fh))
    losses = [float(r["loss"]) for r in rows if r["loss"]]
    sample = np.loadtxt(run / "csv" / "step_0_sample.csv", delimiter=",")
    if (len(losses) != TOY_EPOCHS + 1 or not np.isfinite(losses).all()
            or not np.isfinite(res.residual) or sample.shape != (1000, 2)
            or not (run / "model" / f"checkpoint_{TOY_EPOCHS}.msgpack").exists()):
        raise AssertionError(f"20b: losses {losses}, sample residual {res.residual}, "
                             f"sample {sample.shape}, files {sorted(os.listdir(run))}")
    rates = {"toy steps/s": res.steps / res.train_seconds,
             "toy samples/s": res.samples / res.sample_seconds}
    done(ph, steps=res.steps, train_s=f"{res.train_seconds:.2f}",
         steps_per_s=f"{rates['toy steps/s']:.2f}", samples=res.samples,
         sample_s=f"{res.sample_seconds:.3f}", samples_per_s=f"{rates['toy samples/s']:.1f}",
         sample_residual=f"{res.residual:.4f}", last_loss=f"{losses[-1]:.4f}")
    print(f"  {smi}", flush=True)
    return rates


def _simp_draw(fem, families, rng):
    """The fixed dofs and loads of one scenario of each of ``families``."""
    from physicsinformeddiffusionmodels_tpu_torch.data.mechanics_generator import (
        SCENARIO_FAMILIES)

    fixed, f = np.zeros((len(families), fem.neq), bool), np.zeros((len(families), fem.neq))
    for b, fam in enumerate(families):
        fixed[b], f[b] = SCENARIO_FAMILIES[fam](fem, rng)
    return fixed, f


def simp_checks(tmp: Path) -> None:
    """Phases 21a and 21b (the main process runs them in the window): the
    batched SIMP card vs CPU at P=16, 3 iterations, and 12 iterations
    against the host SIMP."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch.data.mechanics_generator import (
        MechanicsFEM, simp_topopt)
    from physicsinformeddiffusionmodels_tpu_torch.data.mechanics_generator_gpu import (
        GpuSimpGenerator)

    dev = torch.device("cuda")
    ph = phase("21a batched SIMP, card vs CPU (P=16, 3 iterations)")
    fem16 = MechanicsFEM(16)
    fixed, f = _simp_draw(fem16, SIMP_FAMILIES, np.random.default_rng(21))
    vf = np.array(SIMP_VF)
    out = {}
    for d in (dev, "cpu"):
        gen = GpuSimpGenerator(16, n_iter=3, device=d)
        rho, rel = gen.optimize(gen.scenarios_from_host(fixed, f, vf))
        out[d] = rho.cpu(), rel.cpu(), gen.cg_iterations
    (rho, rel, its), (rho_cpu, rel_cpu, its_cpu) = out[dev], out["cpu"]
    err = (rho - rho_cpu).abs().max().item()
    if (err > SIMP_CARD_ATOL or (rel > 1e-4).any() or (rel_cpu > 1e-4).any()
            or np.abs(rho.mean(dim=1).numpy() - vf).max() > 2e-3):
        raise AssertionError(f"21a: designs card vs CPU max |diff| {err:.3e}, relres "
                             f"{rel.numpy()} / {rel_cpu.numpy()}")
    done(ph, rho_max_abs_diff=f"{err:.3e}", cg_iterations_card="/".join(map(str, its)),
         cg_iterations_cpu="/".join(map(str, its_cpu)))

    ph = phase("21b batched SIMP on the card against the host SIMP (12 iterations)")
    gen = GpuSimpGenerator(16, n_iter=12, cg_tol=1e-8, cg_maxiter=3000, device=dev)
    rho, rel = gen.optimize(gen.scenarios_from_host(fixed, f, vf))
    rho = rho.cpu().numpy()
    stats = []
    for b in range(len(vf)):
        host = simp_topopt(fem16, float(vf[b]), f[b], fixed[b], n_iter=12)
        stats.append((abs(rho[b].mean() - vf[b]), np.abs(rho[b] - host).mean(),
                      np.mean((rho[b] > 0.5) == (host > 0.5))))
        if stats[-1][0] > 2e-3 or stats[-1][1] >= 0.01 or stats[-1][2] <= 0.97:
            raise AssertionError(f"21b: design {b}: |vf error| {stats[-1][0]:.2e}, mean "
                                 f"|rho - host| {stats[-1][1]:.3e}, binary agreement "
                                 f"{stats[-1][2]:.3f}")
    if (rel.cpu() >= 1e-3).any():
        raise AssertionError(f"21b: relres {rel.cpu().numpy()}")
    done(ph, vf_err_max=f"{max(s[0] for s in stats):.2e}",
         mean_abs_diff_max=f"{max(s[1] for s in stats):.3e}",
         binary_agreement_min=f"{min(s[2] for s in stats):.4f}")


def shard_check(tmp: Path, dev="cuda") -> None:
    """Phase 21d (the main process runs it in the window): one train set
    made of two shards in one root by the ``generate_mechanics_sets`` CLI,
    ``--start-index 0`` on the card and ``--start-index SHARD_N`` on the
    host (P=16, 3 iterations); the file names, both shard CSVs, the merged
    ``scenarios.csv`` (every index once, in order, the families
    round-robin, each row its shard's) and each field's mean |K u - f|
    below MECH_DATA_RESIDUAL_MAX."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch import generate_mechanics_sets as tsets
    from physicsinformeddiffusionmodels_tpu_torch.physics.mechanics import (
        MechanicsResidual, split_mechanics_batch)

    n = SHARD_N
    ph = phase(f"21d one train set in two shards: {n} fields on the card from index 0, "
               f"{n} on the host from {n} (P=16, 3 iterations)")
    root = tmp / "shards"
    common = ["--root", str(root), "--only", "train", "--n-train", str(n), "--n-iter", "3",
              "--pixels-per-dim", "16", "--seed", "7"]
    tsets.main([*common, "--start-index", "0", "--device", str(dev), "--batch", str(n)])
    tsets.main([*common, "--start-index", str(n), "--device", "host"])
    out = root / "train" / "fields"
    names = sorted(q.name for q in out.iterdir())
    want = sorted([f"{i}.npy" for i in range(2 * n)]
                  + ["scenarios.csv", "scenarios_0.csv", f"scenarios_{n}.csv"])
    if names != want:
        raise AssertionError(f"21d: the set holds {names}")

    def rows(name):
        lines = (out / name).read_text().splitlines()
        if lines[0] != "index,family,vf":
            raise AssertionError(f"21d: {name} starts {lines[0]!r}")
        return [line.split(",") for line in lines[1:]]

    card, host, merged = rows("scenarios_0.csv"), rows(f"scenarios_{n}.csv"), rows(
        "scenarios.csv")
    fams = tsets.IN_DIST_FAMILIES
    if (merged != card + host or [int(r[0]) for r in merged] != list(range(2 * n))
            or [r[1] for r in merged] != [fams[i % len(fams)] for i in range(2 * n)]):
        raise AssertionError(f"21d: shards {card} + {host}, merged {merged}")
    fields = np.stack([np.load(out / f"{i}.npy") for i in range(2 * n)])
    mb = split_mechanics_batch(torch.as_tensor(fields, device=dev))
    rho_e = mb.solution[:, :-1, :-1, 2].reshape(2 * n, -1)
    res = MechanicsResidual(16, device=dev).residual_from_fields(mb.solution[..., :2], rho_e,
                                                                 mb.bcs)[0]
    res_b = res.abs().mean(dim=1)
    if not torch.isfinite(res_b).all() or res_b.max().item() > MECH_DATA_RESIDUAL_MAX:
        raise AssertionError(f"21d: the fields' mean |r| up to {res_b.max().item():.3e}")
    done(ph, files=2 * n, families="/".join(r[1] for r in merged),
         fields_mean_abs_residual_max=f"{res_b.max().item():.3e}")


def simp_phase(tmp: Path, dev, smi: str) -> dict:
    """Phase 21c, the batched SIMP (``data/mechanics_generator_gpu.py``;
    21a-b: ``simp_checks``): one full-width batch (SIMP_FULL) through
    ``generate_mechanics_sets``' set writer on the card, the final exact
    solves in spawned workers, timed; the set's layout and its fields'
    residual. Returns its seconds a batch."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from physicsinformeddiffusionmodels_tpu_torch import generate_mechanics_sets as tsets
    from physicsinformeddiffusionmodels_tpu_torch.data.mechanics_generator import MechanicsFEM
    from physicsinformeddiffusionmodels_tpu_torch.data.mechanics_generator_gpu import (
        GpuSimpGenerator)
    from physicsinformeddiffusionmodels_tpu_torch.physics.mechanics import (
        MechanicsResidual, split_mechanics_batch)

    c = SIMP_FULL
    ph = phase(f"21c batched SIMP, one full-width batch (B={c['batch']}, P={c['P']}, "
               f"{c['n_iter']} iterations) through generate_mechanics_sets' set writer")
    out = tmp / "simp" / "train" / "fields"
    gen = GpuSimpGenerator(c["P"], n_iter=c["n_iter"], device=dev)
    workers = min(8, os.cpu_count() or 1)
    with ProcessPoolExecutor(max_workers=workers,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        pool.submit(int, 0).result()  # the workers are up before the clock starts
        with timed("21c"):
            t0 = time.perf_counter()
            tsets.generate_set(MechanicsFEM(c["P"]), out, c["batch"], tsets.IN_DIST_FAMILIES,
                               tsets.IN_DIST_VF, np.random.default_rng((0, 0)),
                               n_iter=c["n_iter"], pool=pool, gen=gen, batch=c["batch"])
            seconds = time.perf_counter() - t0
    files = sorted(out.glob("*.npy"), key=lambda q: int(q.stem))
    if [q.stem for q in files] != [str(i) for i in range(c["batch"])] or len(
            (out / "scenarios.csv").read_text().splitlines()) != c["batch"] + 1:
        raise AssertionError(f"21c: the set holds {[q.name for q in files]}")
    fields = np.stack([np.load(q) for q in files])
    mb = split_mechanics_batch(torch.as_tensor(fields, device=dev))
    rho_e = mb.solution[:, :-1, :-1, 2].reshape(c["batch"], -1)
    res = MechanicsResidual(c["P"], device=dev).residual_from_fields(mb.solution[..., :2], rho_e,
                                                                     mb.bcs)[0]
    res_b = res.abs().mean(dim=1)
    its = gen.cg_iterations
    vf_err = (mb.conditioning[:, 0, 0, 0] - rho_e.mean(dim=1)).abs().max().item()
    if not torch.isfinite(res_b).all() or res_b.max().item() > MECH_DATA_RESIDUAL_MAX:
        raise AssertionError(f"21c: the fields' mean |r| up to {res_b.max().item():.3e}")
    done(ph, seconds_a_batch=f"{seconds:.2f}", workers=workers,
         cg_iterations_a_simp_iteration=f"{np.mean(its[:-1]):.1f}", cg_iterations_max=max(its),
         relres_max=f"{gen.relres.max().item():.3e}",
         fields_mean_abs_residual_max=f"{res_b.max().item():.3e}", vf_channel_err=f"{vf_err:.1e}")
    print(f"  {smi}", flush=True)
    return {"simp s a batch": seconds}


def _options_cfg(sc: bool):
    from physicsinformeddiffusionmodels_tpu_torch.config import RunConfig

    return RunConfig(bcs="periodic", self_condition=sc, compute_dtype="float32")


def _options_model(sc: bool):
    """Phase 22's seeded UNet of a periodic run, on the CPU."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch.models.unet import build_model

    torch.manual_seed(22)
    return build_model(_options_cfg(sc)).train()


def _frames_model():
    """Phase 22's seeded UNet(dim=32, multi_frame=True), on the CPU."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch.models.unet import UNet

    torch.manual_seed(122)
    return UNet(dim=32, channels=2, multi_frame=True)


def ref_22(tmp: Path) -> dict:
    """The CPU half of phase 22 (computed by the CPU-reference worker): a
    batch of 9a's fields in ``tmp``, t, noise, x and x_self_cond drawn from
    seed 22; for the periodic UNet without and with self-conditioning its
    forward and one fp32 step on the periodic Darcy residual; then x and t
    of the frame axis drawn from seed 122 and the frame UNet's forward."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch import train
    from physicsinformeddiffusionmodels_tpu_torch.data.datasets import load_darcy_dataset
    from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import create_schedule

    data = load_darcy_dataset(tmp / "train").stacked()
    rng = np.random.default_rng(22)
    b = OPTIONS_BATCH
    batch = torch.from_numpy(data[rng.integers(0, len(data), b)])
    t = torch.from_numpy(rng.integers(0, 100, b))
    noise = torch.from_numpy(rng.standard_normal(batch.shape).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal(batch.shape).astype(np.float32))
    self_cond = torch.from_numpy(rng.standard_normal(batch.shape).astype(np.float32))
    out = {"inputs": (batch, t, noise, x, self_cond)}
    for sc in (False, True):
        cfg, model = _options_cfg(sc), _options_model(sc)
        with torch.no_grad():
            y = model(x, t, **({"x_self_cond": self_cond} if sc else {}))
        loss_fn = train.build_darcy_loss_fn(create_schedule(cfg.diff_steps),
                                            train.make_physics(cfg, "cpu"), cfg)
        loss, _ = loss_fn(model, batch, t, noise)
        grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
        out[sc] = {"y": y, "loss": loss.detach(), "grads": list(grads)}
    rng = np.random.default_rng(122)
    xf = torch.from_numpy(rng.standard_normal((FRAMES_BATCH, FRAMES, 64, 64, 2))
                          .astype(np.float32))
    tf = torch.from_numpy(rng.integers(0, 100, FRAMES_BATCH))
    with torch.no_grad():
        out["frames"] = {"inputs": (xf, tf), "y": _frames_model()(xf, tf)}
    return out


def unet_options_phase(dev, smi: str, refs: "CpuRefs") -> tuple:
    """Phase 22: ``build_model`` of a periodic run (circular padding), with
    and without self-conditioning, UNet(dim=32) at 64x64 and
    B=OPTIONS_BATCH, seeded weights, on 9a's fields: the forward (with an
    x_self_cond) card vs CPU, then one fp32 train step on the periodic Darcy
    residual card vs CPU (9b's rules), launch counts zeroed before and read
    after each; then the frame axis' forward card vs CPU. The inputs and the
    CPU half are ``ref_22``'s (``refs``). Returns the K1 and K2 launches of
    the step runs."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch import train
    from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import create_schedule

    ref = refs.get("22")
    batch, t, noise, x, self_cond = (a.to(dev) for a in ref["inputs"])
    step_launches = [[0] * 4, [0] * 4]
    for sc in (False, True):
        name = "circular" + (" + self-conditioning" if sc else "")
        ph = phase(f"22 UNet options: {name}, card vs CPU")
        cfg, model = _options_cfg(sc), _options_model(sc).to(dev)
        zero_launch_counts()
        with torch.no_grad():
            y = model(x, t, **({"x_self_cond": self_cond} if sc else {}))
            torch.cuda.synchronize()
            fwd_counts = launch_counts()
        err = (y.cpu() - ref[sc]["y"]).abs().max().item()
        if fwd_counts != OPTIONS_FWD_LAUNCHES or not torch.isfinite(y).all() or err > 5e-4:
            raise AssertionError(f"22 {name}: forward card vs CPU max |diff| {err:.3e}, "
                                 f"launches {fwd_counts} (want {OPTIONS_FWD_LAUNCHES})")
        zero_launch_counts()
        loss_fn = train.build_darcy_loss_fn(create_schedule(cfg.diff_steps),
                                            train.make_physics(cfg, dev), cfg)
        loss, _ = loss_fn(model, batch, t, noise)
        grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
        torch.cuda.synchronize()
        counts = launch_counts()
        want = ((8, 0, 8, 0), (38, 0, 38, 0), (0, 0, 0, 0))
        if counts != want:
            raise AssertionError(f"22 {name}: step launches {counts} (want {want})")
        for k in range(2):
            step_launches[k] = [a + c for a, c in zip(step_launches[k], counts[k])]
        done(ph, forward_max_abs_err=f"{err:.3e}",
             **hold_fp32_step(model, loss, grads, ref[sc]["loss"], ref[sc]["grads"]),
             launches=counts[:2])
        del model

    ph = phase(f"22 UNet frame axis: [{FRAMES_BATCH}, {FRAMES}, 64, 64, 2], card vs CPU")
    (xf, tf), y_cpu = ref["frames"]["inputs"], ref["frames"]["y"]
    model = _frames_model().to(dev)
    zero_launch_counts()
    with torch.no_grad():
        y = model(xf.to(dev), tf.to(dev))
        torch.cuda.synchronize()
        counts = launch_counts()
    err = (y.cpu() - y_cpu).abs().max().item()
    # the frames fold into the batch of each K1 and K2 call: one launch a call
    if (counts != OPTIONS_FWD_LAUNCHES or y.shape != xf.shape or not torch.isfinite(y).all()
            or err > 5e-4):
        raise AssertionError(f"22 frames: forward card vs CPU max |diff| {err:.3e}, shape "
                             f"{tuple(y.shape)}, launches {counts} (want {OPTIONS_FWD_LAUNCHES})")
    done(ph, forward_max_abs_err=f"{err:.3e}", max_abs_out=f"{y_cpu.abs().max().item():.3e}",
         k1_k2_launches=f"{counts[0][0]}/{counts[1][0]}", cpu_s=f"{ref['seconds']:.2f}")
    print(f"  {smi}", flush=True)
    return tuple(tuple(r) for r in step_launches)


def _plain_options_model():
    """Phase 24c's seeded UNet without linear attention or cond path, on
    the CPU."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch.models.unet import UNet

    torch.manual_seed(24)
    return UNet(dim=32, channels=2, init_dim=PLAIN_INIT_DIM, use_sparse_linear_attn=False,
                cond_path=False)


def _plain_options_loss_fn(dev):
    from physicsinformeddiffusionmodels_tpu_torch import train
    from physicsinformeddiffusionmodels_tpu_torch.config import RunConfig
    from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import create_schedule

    cfg = RunConfig(compute_dtype="float32")
    return train.build_darcy_loss_fn(create_schedule(cfg.diff_steps),
                                     train.make_physics(cfg, dev), cfg)


def ref_24c(tmp: Path) -> dict:
    """The CPU half of phase 24c (computed by the CPU-reference worker): a
    batch of 9a's fields in ``tmp``, t, noise and x drawn from seed 24; the
    forward of x (with a cond, which this UNet ignores) and one fp32 step on
    the Darcy loss."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch.data.datasets import load_darcy_dataset

    data = load_darcy_dataset(tmp / "train").stacked()
    rng = np.random.default_rng(24)
    b = PLAIN_BATCH
    batch = torch.from_numpy(data[rng.integers(0, len(data), b)])
    t = torch.from_numpy(rng.integers(0, 100, b))
    noise = torch.from_numpy(rng.standard_normal(batch.shape).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal(batch.shape).astype(np.float32))
    model = _plain_options_model()
    with torch.no_grad():
        y = model(x, t)
    loss, _ = _plain_options_loss_fn("cpu")(model, batch, t, noise)
    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    return {"inputs": (batch, t, noise, x), "y": y, "loss": loss.detach(), "grads": list(grads)}


def plain_options_phase(dev, refs: "CpuRefs") -> None:
    """Phase 24c: the UNet's ``init_dim``, ``use_sparse_linear_attn=False``
    and ``cond_path=False``, seeded, card vs CPU (``ref_24c``): the forward
    (given a cond, which it ignores) within phase 5's 5e-4 and one fp32
    step by 9b's rules, the launch counts zeroed before and read after each:
    no K1, 38 K2 a UNet call."""
    import torch

    ph = phase(f"24c UNet(dim=32, init_dim={PLAIN_INIT_DIM}) without linear attention or "
               "cond path, card vs CPU")
    ref = refs.get("24c")
    batch, t, noise, x = (a.to(dev) for a in ref["inputs"])
    model = _plain_options_model().to(dev)
    zero_launch_counts()
    with torch.no_grad():
        y = model(x, t, cond=noise)
        torch.cuda.synchronize()
        fwd_counts = launch_counts()
    err = (y.cpu() - ref["y"]).abs().max().item()
    if fwd_counts != PLAIN_FWD_LAUNCHES or not torch.isfinite(y).all() or err > 5e-4:
        raise AssertionError(f"24c: forward card vs CPU max |diff| {err:.3e}, launches "
                             f"{fwd_counts} (want {PLAIN_FWD_LAUNCHES})")
    zero_launch_counts()
    loss, _ = _plain_options_loss_fn(dev)(model, batch, t, noise)
    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts != PLAIN_STEP_LAUNCHES:
        raise AssertionError(f"24c: step launches {counts} (want {PLAIN_STEP_LAUNCHES})")
    done(ph, forward_max_abs_err=f"{err:.3e}",
         **hold_fp32_step(model, loss, grads, ref["loss"], ref["grads"]),
         k1_k2_launches=f"{counts[0][0]}/{counts[1][0]}", cpu_s=f"{ref['seconds']:.2f}")


def _par_darcy_inputs(b: int, dev) -> tuple:
    """A seeded batch for the Darcy UNet: fields, t and noise (an equivalence
    check between meshes; the fields need not be Darcy solutions)."""
    import torch

    rng = np.random.default_rng(23)
    x = (0.5 * rng.standard_normal((b, 64, 64, 2))).astype(np.float32)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    return (torch.from_numpy(x).to(dev), torch.from_numpy(rng.integers(0, 100, b)).to(dev),
            torch.from_numpy(noise).to(dev))


def _par_mech_inputs(b: int, dev) -> tuple:
    """B mechanics samples without SIMP: uniform designs at a drawn volume
    fraction, cantilever BCs and loads, the exact solve's fields
    (``fields_from_design``); t and noise."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch.data.mechanics_generator import (
        SCENARIO_FAMILIES, MechanicsFEM, fields_from_design)

    rng = np.random.default_rng(23)
    fem = MechanicsFEM(64)
    fields = []
    for _ in range(b):
        vf = float(rng.uniform(0.3, 0.6))
        fixed, f = SCENARIO_FAMILIES["cantilever"](fem, rng)
        fields.append(fields_from_design(fem, np.full(64 * 64, vf), fixed, f))
    x = np.stack(fields)
    noise = rng.standard_normal((*x.shape[:-1], 3)).astype(np.float32)
    return (torch.from_numpy(x).to(dev), torch.from_numpy(rng.integers(0, 100, b)).to(dev),
            torch.from_numpy(noise).to(dev))


def _par_step(model, cfg, loss_fn, args, mesh) -> dict:
    """One train step with fresh Adam on ``mesh`` (None: one process) on
    the rank's rows of ``args``: the state, the logged loss (the data ranks'
    mean), the clipped gradients and the updated weights (whole, in
    ``named_parameters``' order and by state-dict key), the launch counts."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch.parallel.mesh import (
        gather_state, shard_batch, sharded_dims)
    from physicsinformeddiffusionmodels_tpu_torch.training.trainer import (
        create_train_state, make_optimizer, train_step)

    state = create_train_state(model, make_optimizer(model, cfg.lr, cfg.grad_clip, mesh=mesh))
    rows = tuple(shard_batch(a, mesh) for a in args)
    torch.cuda.synchronize()
    zero_launch_counts()
    aux = train_step(state, loss_fn, *rows, ema_mu=cfg.ema_decay, ema_start=cfg.ema_start)
    torch.cuda.synchronize()
    launched = launch_counts()
    dims = sharded_dims(model)
    grads = gather_state({k: p.grad for k, p in model.named_parameters()
                          if p.grad is not None}, dims, mesh)
    return {"state": state, "loss": aux.loss.float(), "launches": launched,
            "grads": [grads.get(k) for k, _ in model.named_parameters()],
            "params": gather_state(model.state_dict(), dims, mesh)}


def _hold_moves(got: dict, ref: dict, lr: float) -> float:
    """PAR_MOVED_TOL's rule on two sets of weights after one step; returns
    the share of entries beyond it."""
    import torch

    diffs = torch.cat([(got[k].float() - v.float()).abs().flatten() for k, v in ref.items()])
    share = (diffs > PAR_MOVED_TOL * lr).float().mean().item()
    if not torch.isfinite(diffs).all() or share > PAR_MOVED_SHARE:
        raise AssertionError(f"{share:.2e} of the weights moved more than {PAR_MOVED_TOL} lr "
                             f"from the one-process step's (limit {PAR_MOVED_SHARE})")
    return share


def _hold_grads(names, grads, ref, tol: float = STEP_GRAD_TOL) -> float:
    """Each gradient within ``tol`` of its reference's largest entry;
    returns the worst share of that."""
    import torch

    worst = 0.0
    for name, g, r in zip(names, grads, ref):
        if (g is None) != (r is None):
            raise AssertionError(f"{name}: gradient on one side only")
        if g is None:
            continue
        scale, err = r.abs().max().item(), (g - r).abs().max().item()
        if not torch.isfinite(g).all() or err > tol * scale:
            raise AssertionError(f"{name}: gradient max |diff| {err:.3e} > {tol} x {scale:.3e}")
        worst = max(worst, err / max(scale, 1e-30))
    return worst


def parallel_darcy_phase(rank: int, dev) -> tuple[dict, dict]:
    """23a: UNet(dim=32) from the 300k EMA weights, one step at B=64 on two
    data ranks (32 rows each), fp32 and bf16 + fp32 head, and fp32 on a
    (slice, dp, tp) = (2, 1, 1) mesh, against the one-process B=64 step
    (rank 0, alone): 9b's rule in fp32 (and PAR_MOVED_TOL's on the weights),
    13a's in bf16; K1 8 and K2 38 launches a forward and a backward on each
    rank. Returns (what ``done`` prints, the states kept for the timed
    turns)."""
    import torch
    import torch.distributed as dist

    from physicsinformeddiffusionmodels_tpu_torch import sample_eval, train
    from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import create_schedule
    from physicsinformeddiffusionmodels_tpu_torch.parallel.mesh import make_mesh

    ph = phase(f"23a data parallel, Darcy, B={PAR_DARCY_BATCH} on {PAR_WORLD} ranks "
               f"(rank {rank})")
    cfg = sample_eval.load_run(RUN, compute_dtype="float32", device=dev)[0]
    loss_fn = train.build_darcy_loss_fn(create_schedule(cfg.diff_steps),
                                        train.make_physics(cfg, dev), cfg)
    args = _par_darcy_inputs(PAR_DARCY_BATCH, dev)
    ref = {}
    if rank == 0:
        for dtype in ("float32", "bfloat16"):
            ref[dtype] = _par_step(sample_eval.load_run(RUN, compute_dtype=dtype, device=dev)[1],
                                   cfg, loss_fn, args, None)
    dist.barrier()
    runs, info = {}, {}
    for name, dtype, slices in (("dp", "float32", 1), ("dp", "bfloat16", 1),
                                ("slice", "float32", 2)):
        mesh = make_mesh(1 if slices > 1 else None, 1, slices, "cuda")
        model = sample_eval.load_run(RUN, compute_dtype=dtype, device=dev)[1]
        runs[name, dtype] = run = _par_step(model, cfg, loss_fn, args, mesh)
        want = launches_of(1, FP32_STEP_LAUNCHES if dtype == "float32" else BF16_STEP_LAUNCHES)
        if run["launches"] != want:
            raise AssertionError(f"23a {name} {dtype}: launches K1, K2, K4 {run['launches']}, "
                                 f"want {want}")
        info[f"{name}_{dtype}_launches"] = run["launches"]
    if rank == 0:
        names = [k for k, _ in runs["dp", "float32"]["state"].model.named_parameters()]
        for name in ("dp", "slice"):
            got, want = runs[name, "float32"], ref["float32"]
            held = hold_fp32_step(got["state"].model, got["loss"], got["grads"], want["loss"],
                                  want["grads"], sides=(f"{name} 2 ranks", "one process"))
            info[f"{name}_fp32"] = {**held, "moved_share": _hold_moves(
                got["params"], want["params"], cfg.lr)}
        b16, b32 = runs["dp", "bfloat16"], runs["dp", "float32"]
        info["dp_bf16"] = hold_bf16_step(
            b16["state"].model, b16["loss"].item(), b16["grads"], b32["loss"].item(),
            b32["grads"], ref["bfloat16"]["loss"].item(), ref["bfloat16"]["grads"],
            ref["float32"]["loss"].item(), sides=("dp 2 ranks", "one process"))
        del names
    done(ph, **{k: json.dumps(v) for k, v in info.items()})
    keep = {"cfg": cfg, "loss_fn": loss_fn, "args": args,
            "two": runs["dp", "float32"]["state"], "one": ref.get("float32", {}).get("state")}
    return info, keep


def parallel_sp_phase(rank: int, dev) -> dict:
    """23b: the same UNet with ``seq_parallel_attn`` on a (dp, tp) = (1, 2)
    mesh (its parameters split by JAX's rule): the forward at B=8 within
    phase 5's tolerance of the one-process forward, the input's and every
    parameter's gradient (of sum(out * dy)) within STEP_GRAD_TOL; K2 38 and
    38 launches, K1 none."""
    import torch
    import torch.distributed as dist

    from physicsinformeddiffusionmodels_tpu_torch import sample_eval
    from physicsinformeddiffusionmodels_tpu_torch.parallel.mesh import (
        gather_state, make_mesh, sharded_dims)

    ph = phase(f"23b sequence-parallel linear attention, (dp, tp) = (1, 2) (rank {rank})")
    mesh = make_mesh(1, 2, 1, "cuda")
    model = sample_eval.load_run(RUN, compute_dtype="float32", device=dev, mesh=mesh,
                                 mesh_flags={"mesh_tp": 2, "seq_parallel_attn": True})[1]
    x, t, _ = _par_darcy_inputs(PAR_SP_BATCH, dev)
    dy = torch.randn(x.shape, generator=torch.Generator(device=dev).manual_seed(23), device=dev)

    def run(m):
        xx = x.clone().requires_grad_(True)
        y = m(xx, t)
        (y * dy).sum().backward()
        grads = gather_state({k: p.grad for k, p in m.named_parameters() if p.grad is not None},
                             sharded_dims(m), mesh if m is model else None)
        return y.detach(), xx.grad, [grads.get(k) for k, _ in m.named_parameters()]

    torch.cuda.synchronize()
    zero_launch_counts()
    y, dx, grads = run(model)
    torch.cuda.synchronize()
    launched = launch_counts()
    if launched != SP_LAUNCHES:
        raise AssertionError(f"23b: launches K1, K2, K4 {launched}, want {SP_LAUNCHES}")
    info = {"launches": launched}
    if rank == 0:
        ref = sample_eval.load_run(RUN, compute_dtype="float32", device=dev)[1]
        y1, dx1, grads1 = run(ref)
        err = (y - y1).abs().max().item()
        if not torch.isfinite(y).all() or err > 5e-4:
            raise AssertionError(f"23b: forward max |diff| {err:.3e} > 5e-4")
        names = [k for k, _ in model.named_parameters()]
        info.update(forward_max_abs_err=f"{err:.3e}",
                    dx_worst=f"{_hold_grads(['x'], [dx], [dx1]):.2e}",
                    grads_worst=f"{_hold_grads(names, grads, grads1):.2e}",
                    grads_compared=sum(g is not None for g in grads1))
    dist.barrier()
    done(ph, **{k: json.dumps(v) for k, v in info.items()})
    return info


def _mech_tp_model(cfg, dtype: str, dev, mesh=None):
    """The mechanics UNet of ``cfg`` in ``dtype``, seeded weights built on
    the card (the same on every rank), split over ``mesh``."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch.models.unet import build_model
    from physicsinformeddiffusionmodels_tpu_torch.parallel.mesh import shard_params

    with torch.device(dev):
        torch.manual_seed(0)
        weights = build_model(cfg, "float32").state_dict()
        model = build_model(cfg, dtype, mesh)
    model.load_state_dict(weights)
    return shard_params(model, mesh)


def _k2_calls(model) -> tuple[list, list]:
    """Hooks recording the (N, C, groups, FiLM, dtype) of each K2 call of
    ``model``'s Blocks (a column-parallel Block runs K2 on its groups // tp
    groups); returns (the record, the hooks)."""
    from physicsinformeddiffusionmodels_tpu_torch.models.unet import Block

    calls = []

    def on_block(module, args, kwargs, out):
        tp = kwargs.get("tp")
        groups = module.groups // (tp.tp if tp is not None else 1)
        film = len(args) > 1 and args[1] is not None
        calls.append((out.shape[1] * out.shape[2], out.shape[3], groups, film,
                      str(out.dtype)[6:]))

    return calls, [m.register_forward_hook(on_block, with_kwargs=True)
                   for m in model.modules() if isinstance(m, Block)]


def parallel_tp_phase(rank: int, dev) -> tuple[dict, dict]:
    """23c: UNet(dim=128, channels=10, out_dim=3, sigmoid_last_channel=True),
    seeded, bf16 + fp32 head, B=6, ``mesh_tp=2`` with
    ``tp_shard_activations``: one train step of the mechanics loss on each
    rank against the one-process step (13a's rule; the fp32 steps beside it
    by 9b's rule); K1 8 and K2 38 launches; each K2 shape of a
    column-parallel Block (C/2 channels, 4 groups) held against its plain
    version forward and backward, fp32 and bf16, at B=6; each rank's bytes
    of parameters, Adam state and EMA, and its peak memory. Returns (what
    ``done`` prints, the states kept for the timed turns)."""
    import torch
    import torch.distributed as dist

    from physicsinformeddiffusionmodels_tpu_torch.config import RunConfig
    from physicsinformeddiffusionmodels_tpu_torch.diffusion.schedule import create_schedule
    from physicsinformeddiffusionmodels_tpu_torch.ops.group_norm import (
        group_norm_film_silu, group_norm_film_silu_plain)
    from physicsinformeddiffusionmodels_tpu_torch.parallel.mesh import make_mesh
    from physicsinformeddiffusionmodels_tpu_torch.physics.mechanics import MechanicsResidual
    from physicsinformeddiffusionmodels_tpu_torch.train_mechanics import (
        MECHANICS_DEFAULTS, build_mechanics_loss_fn)

    ph = phase(f"23c tensor parallel, mechanics UNet at full width, tp=2 (rank {rank})")
    cfg = RunConfig(**MECHANICS_DEFAULTS, gov_eqs="mechanics", fp32_head=True,
                    mesh_tp=2, tp_shard_activations=True)
    mesh = make_mesh(1, 2, 1, "cuda")
    loss_fn = build_mechanics_loss_fn(create_schedule(cfg.diff_steps),
                                      MechanicsResidual(pixels_per_dim=64, device=dev), cfg)
    args = _par_mech_inputs(PAR_MECH_BATCH, dev)
    model = _mech_tp_model(cfg, "bfloat16", dev, mesh)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    calls, hooks = _k2_calls(model)
    runs = {"bfloat16": _par_step(model, cfg, loss_fn, args, mesh)}
    for h in hooks:
        h.remove()
    st = runs["bfloat16"]["state"]
    n_bytes = {"params": sum(p.numel() * p.element_size() for p in st.model.parameters()),
               "adam": sum(v.numel() * v.element_size() for s in st.optimizer.adam.state.values()
                           for v in s.values() if torch.is_tensor(v)),
               "ema": sum(p.numel() * p.element_size() for p in st.ema.parameters())}
    info = {"rank_state_bytes": n_bytes, "rank_state_gb": sum(n_bytes.values()) / 1e9,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
            "bf16_launches": runs["bfloat16"]["launches"]}
    whole = 16 * sum(p.numel() for p in runs["bfloat16"]["params"].values())
    if sum(n_bytes.values()) > PAR_STATE_SHARE_MAX * whole:
        raise AssertionError(f"23c: rank {rank} holds {sum(n_bytes.values())} bytes of state, "
                             f"more than {PAR_STATE_SHARE_MAX} of {whole}")
    if runs["bfloat16"]["launches"] != launches_of(1, BF16_STEP_LAUNCHES):
        raise AssertionError(f"23c: launches K1, K2, K4 {runs['bfloat16']['launches']}, "
                             f"want {launches_of(1, BF16_STEP_LAUNCHES)}")
    runs["float32"] = _par_step(_mech_tp_model(cfg, "float32", dev, mesh), cfg, loss_fn, args,
                                mesh)
    keep = {"cfg": cfg, "loss_fn": loss_fn, "args": args, "two": runs["bfloat16"]["state"]}
    if rank == 0:
        ref = {d: _par_step(_mech_tp_model(cfg, d, dev), cfg, loss_fn, args, None)
               for d in ("float32", "bfloat16")}
        b16, b32 = runs["bfloat16"], runs["float32"]
        info["fp32"] = hold_fp32_step(b32["state"].model, b32["loss"], b32["grads"],
                                      ref["float32"]["loss"], ref["float32"]["grads"],
                                      sides=("tp 2 ranks", "one process"))
        info["bf16"] = hold_bf16_step(
            b16["state"].model, b16["loss"].item(), b16["grads"], b32["loss"].item(),
            b32["grads"], ref["bfloat16"]["loss"].item(), ref["bfloat16"]["grads"],
            ref["float32"]["loss"].item(), sides=("tp 2 ranks", "one process"))
        keep["one"] = ref["bfloat16"]["state"]
        del ref["float32"]
        # K2 at the column-parallel Blocks' shapes, against its plain version
        tp_shapes = sorted({(n, c, g, f) for n, c, g, f, _ in calls if g != 8})
        if not tp_shapes or any(g != 4 for _, _, g, _ in tp_shapes):
            raise AssertionError(f"23c: K2 calls at 4 groups expected, got {sorted(set(calls))}")
        gen = torch.Generator(device=dev).manual_seed(23)

        def k2_args(b, n, c, film):
            def r(*shape, scale=1.0, shift=0.0):
                return torch.randn(*shape, generator=gen, device=dev) * scale + shift
            return [r(b, n, c, scale=2.0, shift=0.5), r(c, scale=0.1, shift=1.0),
                    r(c, scale=0.1), r(b, c, scale=0.1) if film else None,
                    r(b, c, scale=0.1) if film else None]

        for n, c, g, film in tp_shapes:
            for backward in (False, True):
                check_mechanics(
                    f"group_norm_film_silu{'_backward' if backward else ''} groups={g}",
                    lambda *a, g=g: group_norm_film_silu(*a, groups=g),
                    lambda *a, g=g: group_norm_film_silu_plain(*a, groups=g),
                    lambda b, n_, c_, film=film: k2_args(b, n_, c_, film), [(n, c)], backward)
        info["k2_tp_shapes"] = tp_shapes
    dist.barrier()
    done(ph, **{k: json.dumps(v) for k, v in info.items()})
    return info, keep


def _steps_per_s(fn, steps: int) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    return steps / (time.perf_counter() - t0)


def parallel_timing(rank: int, kept: dict) -> dict:
    """Steps/s of 23a's fp32 Darcy step and 23c's bf16 mechanics step, eager,
    in turns: one process (rank 0 alone, the whole batch), two ranks, two
    ranks, one process. The two ranks share the card, so the gap is the
    cost of the collectives a step, not a scaling."""
    import torch.distributed as dist

    from physicsinformeddiffusionmodels_tpu_torch.parallel.mesh import shard_batch
    from physicsinformeddiffusionmodels_tpu_torch.training.trainer import train_step

    out = {}
    for name, k in kept.items():
        cfg, loss_fn, args = k["cfg"], k["loss_fn"], k["args"]
        mesh = k["two"].optimizer.mesh
        rows = tuple(shard_batch(a, mesh) for a in args)
        rates = {"one": [], "two": []}
        for who in ("one", "two", "two", "one"):
            dist.barrier()
            if who == "two":
                rates["two"].append(_steps_per_s(
                    lambda: train_step(k["two"], loss_fn, *rows, ema_mu=cfg.ema_decay,
                                       ema_start=cfg.ema_start), PAR_TIMED[name]))
            elif rank == 0:
                rates["one"].append(_steps_per_s(
                    lambda: train_step(k["one"], loss_fn, *args, ema_mu=cfg.ema_decay,
                                       ema_start=cfg.ema_start), PAR_TIMED[name]))
            dist.barrier()
        if rank == 0:
            one, two = (float(np.mean(rates[w])) for w in ("one", "two"))
            out[name] = {"one_process_steps_per_s": one, "two_ranks_steps_per_s": two,
                         "overhead_ms_a_step": 1e3 * (1 / two - 1 / one),
                         "turns": rates}
    return out


def _wait_for(path: Path, limit: float = None) -> None:
    """Block until ``path`` is written (PAR_JOIN_S at most, or ``limit``)."""
    deadline = time.monotonic() + (PAR_JOIN_S if limit is None else limit)
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path.name} from the main process")
        time.sleep(0.2)


def parallel_worker(rank: int, work: Path) -> int:
    """A rank of phase 23: joins the gloo group of PAR_WORLD ranks on
    cuda:0, waits for the main process's ``checks``, runs 23a-c, writes
    ``checks_<rank>.json``, waits for its ``go`` and runs the timed turns
    (rank 0 writes ``timing.json``). Returns the exit code; a failure
    writes its traceback to ``error_<rank>.txt``."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist

    try:
        if not torch.cuda.is_available():
            raise RuntimeError("torch.cuda.is_available() is False")
        from physicsinformeddiffusionmodels_tpu_torch.ops import _build
        from physicsinformeddiffusionmodels_tpu_torch.utils.platform import set_fp32_exact

        # the ranks' checks run in the window after 19d's timing, where they
        # and the card lane set its length: no nice, one torch thread each
        torch.set_num_threads(1)
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        set_fp32_exact()
        dist.init_process_group("gloo", init_method=f"file://{work / 'store'}", rank=rank,
                                world_size=PAR_WORLD,
                                timeout=datetime.timedelta(seconds=PAR_COLLECTIVE_S))
        (work / f"joined_{rank}").write_text(repr(time.time()))
        # the main process builds the kernels meanwhile: load them after
        # its word, never build them here
        _wait_for(work / "checks")
        _build.library()
        checks, kept = {}, {}
        checks["23a"], kept["darcy"] = parallel_darcy_phase(rank, dev)
        checks["23b"] = parallel_sp_phase(rank, dev)
        checks["23c"], kept["mechanics"] = parallel_tp_phase(rank, dev)
        (work / f"checks_{rank}.json").write_text(json.dumps(checks, default=str))
        _wait_for(work / "go")
        timing = parallel_timing(rank, kept)
        if rank == 0:
            (work / "timing.json").write_text(json.dumps(timing))
        dist.barrier()
        dist.destroy_process_group()
        return 0
    except Exception:  # the main process reads the traceback and fails the phase
        (work / f"error_{rank}.txt").write_text(traceback.format_exc())
        return 1


class ParallelRanks:
    """Phase 23's PAR_WORLD rank processes (this script with
    ``--parallel-rank``), started in the background, where they join
    their group and wait: ``start_checks()`` lets them run 23a-c on the
    card, ``check()`` raises if one has failed, ``finish()`` lets them run
    their timed turns, joins them (PAR_JOIN_S at most) and returns their
    checks and timings; ``stop()`` kills any still running."""

    def __init__(self, tmp: Path):
        self.work = tmp / "parallel"
        self.work.mkdir(parents=True, exist_ok=True)
        self.procs, self.t0 = [], time.time()
        for r in range(PAR_WORLD):
            log = open(self.work / f"rank_{r}.log", "w")
            # a session of its own: until its checks, BACKGROUND stops it
            # while a phase times
            self.procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--parallel-rank", str(r),
                 "--parallel-dir", str(self.work)], cwd=ROOT, stdout=log,
                stderr=subprocess.STDOUT, start_new_session=True))
            BACKGROUND.add(self.procs[-1].pid)
            log.close()

    def start_checks(self) -> None:
        for p in self.procs:
            BACKGROUND.discard(p.pid)
        (self.work / "checks").touch()
        for r in range(PAR_WORLD):  # each rank's seconds from its start to its group joined
            joined = self.work / f"joined_{r}"
            SERIAL["rank_startup"][str(r)] = (float(joined.read_text()) - self.t0
                                              if joined.exists() else None)

    def _failed(self) -> str:
        errors = sorted(self.work.glob("error_*.txt"))
        logs = [(self.work / f"rank_{r}.log").read_text()[-3000:] for r in range(PAR_WORLD)]
        return "\n".join([e.read_text() for e in errors] + logs)

    def check(self) -> None:
        if any(p.poll() not in (None, 0) for p in self.procs):
            self.stop()
            raise RuntimeError("a phase 23 rank failed:\n" + self._failed())

    def finish(self) -> tuple[list, dict]:
        (self.work / "go").touch()
        deadline = time.monotonic() + PAR_JOIN_S
        for p in self.procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                self.stop()
                raise RuntimeError("a phase 23 rank hung:\n" + self._failed())
        self.check()
        for r in range(PAR_WORLD):
            for line in (self.work / f"rank_{r}.log").read_text().splitlines():
                if line.startswith("[23") or line.startswith("  group_norm"):
                    print(f"  rank {r} {line}", flush=True)
        checks = [json.loads((self.work / f"checks_{r}.json").read_text())
                  for r in range(PAR_WORLD)]
        return checks, json.loads((self.work / "timing.json").read_text())

    def stop(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def torchrun_cli_start(tmp: Path) -> dict:
    """23d, started in the background on 9a's sets in ``tmp``: the training
    CLI under ``torchrun --standalone --nproc-per-node 1 --mesh-dp 1`` (the
    launcher path: NCCL, the rank's own GPU) for 3 steps in the study's
    bf16 + fp32-head recipe, and the same CLI
    with ``--mesh-tp 2`` and no process group, which must raise."""
    out = tmp / "torchrun_cli"
    out.mkdir(parents=True, exist_ok=True)
    args = ["-m", "physicsinformeddiffusionmodels_tpu_torch.train", "--iterations", "3",
            "--batch-size", "16", "--compute-dtype", "bfloat16", "--fp32-head",
            "--data-dir", str(tmp / "train"), "--valid-data-dir", str(tmp / "valid"),
            "--output-dir", str(out), "--name", "torchrun", "--sample-freq", "1000",
            "--test-eval-freq", "3", "--log-freq", "1", "--no-samples", "4"]
    nice = ["nice", "-n", "10"] if shutil.which("nice") else []
    cmds = {"torchrun": [*nice, sys.executable, "-m", "torch.distributed.run", "--standalone",
                         "--nproc-per-node", "1", *args, "--mesh-dp", "1"],
            "no_group": [*nice, sys.executable, *args, "--mesh-tp", "2"]}
    jobs = {"out": out, "t0": time.time()}
    for name, cmd in cmds.items():
        log = open(out / f"{name}.log", "w")
        # a session of its own, so that stopping it stops torchrun's worker too
        jobs[name] = subprocess.Popen(cmd, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                                      start_new_session=True,
                                      env={**os.environ, "OMP_NUM_THREADS": "2"})
        log.close()
    atexit.register(torchrun_cli_stop, jobs)
    return jobs


def torchrun_cli_stop(jobs: dict) -> None:
    """Kill 23d's process groups that are still running."""
    import signal

    for name in ("torchrun", "no_group"):
        if jobs[name].poll() is None:
            os.killpg(jobs[name].pid, signal.SIGKILL)
            jobs[name].wait()


def torchrun_cli_finish(jobs: dict) -> dict:
    """23d's checks: the torchrun run exits 0 on its (dp, tp) = (1, 1) mesh
    with finite losses at steps 0-3 in metrics.csv and checkpoint_3 written;
    the run without a process group exits non-zero naming torchrun."""
    out = jobs["out"]
    for name in ("torchrun", "no_group"):
        try:
            jobs[name].wait(timeout=PAR_JOIN_S)
        except subprocess.TimeoutExpired:
            torchrun_cli_stop(jobs)
            raise RuntimeError(f"23d {name} hung:\n" + (out / f"{name}.log").read_text()[-3000:])
    log, refused = ((out / f"{n}.log").read_text() for n in ("torchrun", "no_group"))
    if jobs["torchrun"].returncode != 0 or "mesh: {'dp': 1, 'tp': 1}" not in log:
        raise RuntimeError(f"23d torchrun exited {jobs['torchrun'].returncode}:\n{log[-3000:]}")
    with open(out / "torchrun" / "metrics.csv", newline="") as f:
        rows = [r for r in csv.DictReader(f) if r["loss"]]
    losses = [float(r["loss"]) for r in rows]
    if [int(r["step"]) for r in rows] != [0, 1, 2, 3] or not np.isfinite(losses).all():
        raise RuntimeError(f"23d torchrun metrics: steps {[r['step'] for r in rows]}, "
                           f"losses {losses}")
    if not (out / "torchrun" / "model" / "checkpoint_3.msgpack").exists():
        raise RuntimeError("23d torchrun: no checkpoint_3")
    if jobs["no_group"].returncode == 0 or "torchrun" not in refused:
        raise RuntimeError(f"23d --mesh-tp 2 without a process group exited "
                           f"{jobs['no_group'].returncode}:\n{refused[-3000:]}")
    # the run's own seconds: until its log was last written
    return {"losses": losses, "seconds": (out / "torchrun.log").stat().st_mtime - jobs["t0"],
            "refused": refused.strip().splitlines()[-1]}


def corrected_sampling_phase(dev, plain_summary: dict) -> None:
    """Phase 11, against phase 6's ``sample_eval`` summary."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch import sample_eval, train
    from physicsinformeddiffusionmodels_tpu_torch.config import RunConfig
    from physicsinformeddiffusionmodels_tpu_torch.ops.group_norm import group_norm_film_silu
    from physicsinformeddiffusionmodels_tpu_torch.ops.linear_attention import (
        linear_attention_block)

    cfg = RunConfig.load(RUN / "config.json")
    x = torch.from_numpy(plain_summary["samples"])
    physics = train.make_physics(cfg, dev)
    xc, rc = physics.residual_correction(x.to(dev))
    xh, rh = train.make_physics(cfg, "cpu").residual_correction(x)
    for name, got, ref in (("x", xc, xh), ("residual", rc, rh)):
        err, scale = (got.cpu() - ref).abs().max().item(), ref.abs().max().item()
        if not torch.isfinite(got).all() or err > CORRECTION_TOL * scale:
            raise AssertionError(f"residual_correction card vs CPU: {name} max |diff| "
                                 f"{err:.3e} > {CORRECTION_TOL} x {scale:.3e}")
    before = physics.residual(x.to(dev)).square().sum().item()
    print(f"  one correction of phase 6's samples: sum r^2 {before:.6e} -> "
          f"{rc.square().sum().item():.6e} (card), {rh.square().sum().item():.6e} (CPU)",
          flush=True)
    medians = {}
    # M=0 runs the in-loop corrections alone: they too must move the samples
    for mode, m in (("x0", M_CORRECTION), ("xt", M_CORRECTION), ("x0", 0), ("xt", 0)):
        linear_attention_block.launches = group_norm_film_silu.launches = 0
        with tempfile.TemporaryDirectory() as tmp:
            s = sample_eval.evaluate(RUN, SAMPLES, "float32", "cuda", seed=0, out=tmp,
                                     correction_mode=mode, n_correction=N_CORRECTION,
                                     m_correction=m)
        launches = (linear_attention_block.launches, group_norm_film_silu.launches)
        med = s["residual_median"]
        moved = np.abs(s["samples"] - plain_summary["samples"]).max()
        if launches != (8 * STEPS, 38 * STEPS) or not (
                np.isfinite(s["res_b"]).all() and RESIDUAL_RANGE[0] <= med <= RESIDUAL_RANGE[1]
                and moved > 0):
            raise AssertionError(f"corrected sampling ({mode}, M={m}): launches K1/K2 "
                                 f"{launches}, median {med:.4e} (range {RESIDUAL_RANGE}), "
                                 f"max |samples - uncorrected| {moved:.3e}")
        medians[f"{mode} M={m}"] = f"{med:.4e}"
        print(f"  correction_mode={mode} N={N_CORRECTION} M={m}: residual median "
              f"{med:.4e}, mean {s['residual_mean']:.4e}, {s['seconds']:.2f} s, "
              f"{s['samples_per_s']:.2f} samples/s, K1/K2 launches {launches[0]}/{launches[1]}, "
              f"max |samples - uncorrected| {moved:.3e}", flush=True)
    print(f"  residual medians: uncorrected {plain_summary['residual_median']:.4e} (phase 6), "
          f"corrected {json.dumps(medians)}", flush=True)


# the CPU halves of the card vs CPU checks, in the order the window reads
# them, and the set (of DataJobs) each needs
CPU_REFS = {"22": ("train", ref_22), "9b": ("train", ref_fp32_step), "13a": ("train", ref_13a),
            "15e": ("train", functools.partial(ref_fp32_step, cm=True)),
            "16b": ("train", functools.partial(ref_fp32_step, run=SAMPLE_RUN,
                                               batch_size=DDIM_BATCH)),
            "17c": ("train", functools.partial(ref_fp32_step, run=GUIDED_RUN,
                                               batch_size=TRAIN_BATCH)),
            "24c": ("train", ref_24c), "19c": ("mechanics", ref_19c)}


def cpu_refs_worker(tmp: Path) -> int:
    """The CPU-reference worker (this script with ``--cpu-refs``; the card
    hidden from it): computes each of CPU_REFS when its set is made in
    ``tmp``, into ``tmp/refs/<name>.pt`` with the seconds it took.
    Returns the exit code; a failure writes its traceback to
    ``refs/error.txt``."""
    import traceback

    import torch

    work = tmp / "refs"
    try:
        for name, (data, fn) in CPU_REFS.items():
            _wait_for(tmp / f"{data}.done", DATA_WAIT_S)
            t0 = time.perf_counter()
            out = fn(tmp)
            out["seconds"] = time.perf_counter() - t0
            torch.save(out, work / f"{name}.tmp")
            os.replace(work / f"{name}.tmp", work / f"{name}.pt")
        return 0
    except Exception:  # the main process reads the traceback and fails the check
        (work / "error.txt").write_text(traceback.format_exc())
        return 1


class CpuRefs:
    """The CPU-reference worker, started beside the build in a session of
    its own (BACKGROUND stops it while a phase times), niced, with no card:
    ``get(name)`` waits for its entry of CPU_REFS (raising if the worker
    failed) and loads it; ``stop()`` kills it."""

    def __init__(self, tmp: Path):
        (tmp / "refs").mkdir(parents=True, exist_ok=True)
        self.tmp, self.waited = tmp, {}
        nice = ["nice", "-n", "10"] if shutil.which("nice") else []
        self.log = open(tmp / "refs" / "worker.log", "w")
        self.proc = subprocess.Popen(
            [*nice, sys.executable, str(Path(__file__).resolve()), "--cpu-refs", str(tmp)],
            cwd=ROOT, stdout=self.log, stderr=subprocess.STDOUT, start_new_session=True,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        BACKGROUND.add(self.proc.pid)

    def get(self, name: str) -> dict:
        import torch

        path, t0 = self.tmp / "refs" / f"{name}.pt", time.perf_counter()
        while not path.exists():
            if self.proc.poll() is not None and not path.exists():
                error = self.tmp / "refs" / "error.txt"
                raise RuntimeError(f"the CPU-reference worker exited {self.proc.returncode}:\n"
                                   + (error.read_text() if error.exists() else ""))
            time.sleep(0.1)
        self.waited[name] = time.perf_counter() - t0
        out = torch.load(path, weights_only=False)
        SERIAL["cpu_references"][name] = out["seconds"]
        return out

    def stop(self) -> None:
        import signal

        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()
        BACKGROUND.discard(self.proc.pid)
        self.log.close()


def checkpoint_forward(tmp: Path) -> None:
    """Phase 5 (the card lane runs it): one fp32 UNet forward (B=8) of the
    committed 300k Darcy checkpoint on the card (kernels) against the same
    forward on the CPU (plain versions)."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch import sample_eval

    dev = torch.device("cuda")
    ph = phase("5 checkpoint forward")
    _, model, step = sample_eval.load_run(RUN, compute_dtype="float32", device=dev)
    _, model_cpu, _ = sample_eval.load_run(RUN, compute_dtype="float32", device="cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 64, 64, 2)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 100, 8))
    with torch.no_grad():
        y = model(x.to(dev), t.to(dev)).cpu()
        y_ref = model_cpu(x, t)
    err = (y - y_ref).abs().max().item()
    # README "Parity": the Flax transplant tolerance; fp32 on both devices
    if y.shape != (8, 64, 64, 2) or not torch.isfinite(y).all() or err > 5e-4:
        raise AssertionError(f"checkpoint forward: card vs CPU max |diff| {err:.3e}")
    del model, model_cpu
    done(ph, step=step, max_abs_err=f"{err:.3e}")


def _x_t_b8(seed: int) -> tuple:
    """Phase 5's draw: x [8, 64, 64, 2] and t from ``seed``."""
    import torch

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((8, 64, 64, 2)).astype(np.float32))
    return x, torch.from_numpy(rng.integers(0, 100, 8))


def _tree_leaves(tree: dict, prefix: tuple = ()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _tree_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def portable_export_check(tmp: Path) -> None:
    """Phase 24a (the card lane runs it, after 9f): the port's export of 9f's
    card-trained run (``export_portable_checkpoint.main``): every leaf is
    the run's EMA weight rounded to float16, the export holds no raw
    weights and no optimizer state; ``sample_eval.load_run`` of the portable
    directory, one fp32 forward at B=8 card vs CPU (phase 5's tolerance),
    K1 8 and K2 38 launches."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch import export_portable_checkpoint, sample_eval
    from physicsinformeddiffusionmodels_tpu_torch.training.checkpoint import msgpack_restore

    ph = phase("24a portable export of 9f's run, card vs CPU")
    run, out = tmp / "runs" / "smoke", tmp / "portable"
    dst = export_portable_checkpoint.main(["--model-dir", str(run), "--out", str(out)])
    src = msgpack_restore((run / "model" / "checkpoint_3.msgpack").read_bytes())
    exp = msgpack_restore(dst.read_bytes())
    ema, got = list(_tree_leaves(src["ema_params"])), list(_tree_leaves(exp["ema_params"]))
    if ([k for k, _ in ema] != [k for k, _ in got] or exp["params"] or exp["opt_state"]
            or exp["step"] != 3 or not ema):
        raise AssertionError(f"24a: the export of {run} holds another tree than its EMA's")
    for (path, a), (_, b) in zip(ema, got):
        if b.dtype != np.float16 or not np.array_equal(b, a.astype(np.float16)):
            raise AssertionError(f"24a: {path} is not the EMA weight rounded to float16")
    _, model, step = sample_eval.load_run(out, compute_dtype="float32", device="cuda")
    _, model_cpu, _ = sample_eval.load_run(out, compute_dtype="float32", device="cpu")
    x, t = _x_t_b8(24)
    zero_launch_counts()
    with torch.no_grad():
        y = model(x.cuda(), t.cuda())
        torch.cuda.synchronize()
        counts = launch_counts()
        y_ref = model_cpu(x, t)
    err = (y.cpu() - y_ref).abs().max().item()
    if counts != OPTIONS_FWD_LAUNCHES or not torch.isfinite(y).all() or err > 5e-4 or step != 3:
        raise AssertionError(f"24a: portable forward card vs CPU max |diff| {err:.3e}, "
                             f"launches {counts} (want {OPTIONS_FWD_LAUNCHES}), step {step}")
    done(ph, leaves=len(got), bytes=dst.stat().st_size, max_abs_err=f"{err:.3e}",
         k1_k2_launches=f"{counts[0][0]}/{counts[1][0]}")


# the inverse of each layout transform of models/reference_port.py (by its
# name): a Flax leaf back in the reference Unet3D's layout
REFERENCE_LAYOUT = {
    "_linear": lambda a: a.T,
    "_conv3d": lambda a: a.transpose(3, 2, 0, 1)[:, :, None],
    "_conv2d": lambda a: a.transpose(3, 2, 0, 1),
    "_pointwise3d": lambda a: a.T[:, :, None, None, None],
    "_pointwise2d": lambda a: a.T[:, :, None, None],
    "_conv_transpose3d": lambda a: a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1][:, :, None],
    "_gamma": lambda a: a.reshape(1, -1, 1, 1, 1),
    "_copy": lambda a: a,
}
# tensors of modules the reference builds but never runs (shape by key)
REFERENCE_DEAD = {"init_temporal_attn.fn.to_qkv.weight": (768, 32),
                  "mid_temporal_attn.fn.to_out.weight": (256, 256),
                  "time_rel_pos_bias.relative_attention_bias.weight": (32, 8),
                  "sign_emb_CNN.0.weight": (32, 1, 3),
                  "downs.0.2.fn.fn.to_q.weight": (256, 32, 1, 1),
                  "rotary_emb.inv_freq": (16,)}


def reference_import_check(tmp: Path) -> None:
    """Phase 24b (the main process runs it, in the window): the committed 300k EMA
    weights that phase 5 loads, but for the frame attention (the reference
    has none live, so its import builds UNet(frame_attention=False)), in the
    reference layout (REFERENCE_LAYOUT) with REFERENCE_DEAD's tensors, saved
    as ``{'model': sd}`` and imported by the port's CLI: both slots of the
    written checkpoint bit-equal to those weights, and one fp32 forward on
    the card of ``sample_eval.load_run``'s model bit-equal to phase 5's
    forward on its inputs of the same weights in UNet(frame_attention=False),
    both under cuDNN's deterministic algorithms; K1 8 and K2 38 launches."""
    import torch

    from physicsinformeddiffusionmodels_tpu_torch import import_reference_checkpoint, sample_eval
    from physicsinformeddiffusionmodels_tpu_torch.models.convert import (
        torch_state_dict_from_flax)
    from physicsinformeddiffusionmodels_tpu_torch.models.reference_port import (
        reference_key_map)
    from physicsinformeddiffusionmodels_tpu_torch.models.unet import UNet
    from physicsinformeddiffusionmodels_tpu_torch.training.checkpoint import load_checkpoint

    ph = phase("24b reference-checkpoint import of the 300k EMA weights")
    raw = load_checkpoint(RUN / "model" / "checkpoint_300000.msgpack")
    weights = {k: v for k, v in raw["ema_params"]["params"].items()
               if not k.startswith("FrameAttention") and not k.endswith("frame_attn")}
    key_map = reference_key_map(32)
    sd = {}
    for path, a in _tree_leaves(weights):
        tkey, transform = key_map[path]
        sd[tkey] = torch.from_numpy(np.ascontiguousarray(
            REFERENCE_LAYOUT[transform.__name__](a)))
    rng = np.random.default_rng(24)
    for k, shape in REFERENCE_DEAD.items():
        sd[k] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    (tmp / "reference").mkdir(exist_ok=True)
    pt, out = tmp / "reference" / "checkpoint_300000.pt", tmp / "imported"
    torch.save({"model": sd}, pt)
    path = import_reference_checkpoint.main(["--checkpoint", str(pt), "--gov-eqs", "darcy",
                                             "--out", str(out)])
    imported, want = load_checkpoint(path), list(_tree_leaves(weights))
    for slot in ("params", "ema_params"):
        got = list(_tree_leaves(imported[slot]["params"]))
        if [k for k, _ in got] != [k for k, _ in want] or not all(
                np.array_equal(a, b) for (_, a), (_, b) in zip(got, want)):
            raise AssertionError(f"24b: the imported {slot} are not the 300k weights")
    if imported["opt_state"] or imported["step"] != 300000:
        raise AssertionError(f"24b: step {imported['step']}, opt_state {imported['opt_state']}")
    cfg, model, _ = sample_eval.load_run(out, compute_dtype="float32", device="cuda")
    direct = UNet(dim=32, channels=2, frame_attention=False)
    direct.load_state_dict(torch_state_dict_from_flax(weights))
    direct = direct.cuda().eval()
    x, t = (a.cuda() for a in _x_t_b8(0))
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                                     benchmark=False, allow_tf32=False):
        zero_launch_counts()
        y = model(x, t)
        torch.cuda.synchronize()
        counts = launch_counts()
        y_direct = direct(x, t)
    if (cfg.frame_attention or counts != OPTIONS_FWD_LAUNCHES or not torch.isfinite(y).all()
            or not torch.equal(y, y_direct)):
        raise AssertionError(f"24b: the imported forward is not phase 5's weights' bit for bit "
                             f"(max |diff| {(y - y_direct).abs().max().item():.3e}), launches "
                             f"{counts}, frame_attention {cfg.frame_attention}")
    done(ph, reference_tensors=len(sd), dead=len(REFERENCE_DEAD),
         max_abs_out=f"{y.abs().max().item():.3e}",
         k1_k2_launches=f"{counts[0][0]}/{counts[1][0]}")


# the checks that time nothing and need no state of the main process, run
# in order by the card lane beside the main process's own window
LANE_CHECKS = {"18a": graph_bit_equality, "9f": training_cli_fp32, "13d": training_cli_bf16,
               "20a": toy_card_vs_cpu, "5": checkpoint_forward, "24a": portable_export_check}


def lane_worker(tmp: Path) -> int:
    """The card lane (this script with ``--lane``): waits for the main
    process's ``lane/go`` (written after 19d's timing), then runs
    LANE_CHECKS on the sets and runs in ``tmp``. Returns the exit code; a
    failure writes its traceback to ``lane/error.txt``."""
    import traceback

    import torch

    work = tmp / "lane"
    try:
        if not torch.cuda.is_available():
            raise RuntimeError("torch.cuda.is_available() is False")
        from physicsinformeddiffusionmodels_tpu_torch.ops import _build
        from physicsinformeddiffusionmodels_tpu_torch.utils.platform import set_fp32_exact

        set_fp32_exact()
        _wait_for(work / "go")
        _build.library()  # built by the main process before its word
        for check in LANE_CHECKS.values():
            check(tmp)
        return 0
    except Exception:  # the main process reads the traceback and fails the run
        (work / "error.txt").write_text(traceback.format_exc())
        return 1


class CardLane:
    """The card lane's process (this script with ``--lane``), started
    after the build, where it imports and waits: ``start()`` lets it run
    LANE_CHECKS, ``finish()`` joins it (PAR_JOIN_S at most), prints its
    phase lines and raises if it failed; ``stop()`` kills it."""

    def __init__(self, tmp: Path):
        self.work = tmp / "lane"
        self.work.mkdir(parents=True, exist_ok=True)
        with open(self.work / "lane.log", "w") as log:
            # a session of its own: until its word, BACKGROUND stops it while
            # a phase times
            self.proc = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--lane", str(tmp)], cwd=ROOT,
                stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
        BACKGROUND.add(self.proc.pid)

    def start(self) -> None:
        BACKGROUND.discard(self.proc.pid)
        (self.work / "go").touch()

    def finish(self) -> None:
        try:
            self.proc.wait(timeout=PAR_JOIN_S)
        except subprocess.TimeoutExpired:
            self.stop()
        log = (self.work / "lane.log").read_text()
        for line in log.splitlines():
            if line.startswith(("[", "  ")):
                print(line, flush=True)
        if self.proc.returncode != 0:
            error = self.work / "error.txt"
            raise RuntimeError(f"the card lane exited {self.proc.returncode}:\n"
                               + (error.read_text() if error.exists() else log[-3000:]))

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def main() -> int:
    import torch

    if "--parallel-rank" in sys.argv:  # a rank of phase 23, started by ParallelRanks
        return parallel_worker(int(sys.argv[sys.argv.index("--parallel-rank") + 1]),
                               Path(sys.argv[sys.argv.index("--parallel-dir") + 1]))
    if "--cpu-refs" in sys.argv:  # the CPU-reference worker, started by CpuRefs
        return cpu_refs_worker(Path(sys.argv[sys.argv.index("--cpu-refs") + 1]))
    if "--lane" in sys.argv:  # the card lane, started by CardLane
        return lane_worker(Path(sys.argv[sys.argv.index("--lane") + 1]))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2

    from physicsinformeddiffusionmodels_tpu_torch import sample_eval
    from physicsinformeddiffusionmodels_tpu_torch.ops import _build
    from physicsinformeddiffusionmodels_tpu_torch.ops import group_norm as gn
    from physicsinformeddiffusionmodels_tpu_torch.ops import linear_attention as la
    from physicsinformeddiffusionmodels_tpu_torch.ops.group_norm import (
        group_norm_film_silu, group_norm_film_silu_plain)
    from physicsinformeddiffusionmodels_tpu_torch.ops.linear_attention import (
        linear_attention_block, linear_attention_block_plain)
    from physicsinformeddiffusionmodels_tpu_torch.utils import timing
    from physicsinformeddiffusionmodels_tpu_torch.utils.platform import set_fp32_exact

    timing.QUIET = BACKGROUND.quiet  # no timed replay shares the host with background work
    t_start = time.perf_counter()
    dev = torch.device("cuda")

    ph = phase("1 device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    set_fp32_exact()
    print(f"  {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    done(ph)

    data_tmp = tempfile.TemporaryDirectory(prefix="pidm_smoke_")
    # the sets of 9a and 19a, made in the background from now on (the build's
    # nvcc calls keep the CPU first: the jobs are niced), and the worker that
    # computes the CPU halves of the card vs CPU checks from them; both
    # stopped at exit either way, and stopped while a phase times
    jobs = DataJobs(Path(data_tmp.name))
    atexit.register(jobs.stop)
    refs = CpuRefs(Path(data_tmp.name))
    atexit.register(refs.stop)

    ph = phase("2 build")
    lib_path, log, build_s = _build.build()
    _build.library()
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip())
    done(ph, nvcc_seconds=f"{build_s:.2f}", library=lib_path.name)

    # phase 23's ranks and the card lane start now: they import and wait
    # (stopped while a phase times) until their word after 19d's timing
    par = ParallelRanks(Path(data_tmp.name))
    atexit.register(par.stop)
    lane = CardLane(Path(data_tmp.name))
    atexit.register(lane.stop)

    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(dev)

    def k1_args(b, n, c):
        return [randn(b, n, c), randn(c, scale=0.1, shift=1.0),
                randn(c, 768, scale=c**-0.5), randn(256, c, scale=K1_GAIN * n * 256**-0.5),
                randn(c, scale=0.1)]

    def k2_args(b, n, c, film=True):
        return [randn(b, n, c, scale=2.0, shift=0.5), randn(c, scale=0.1, shift=1.0),
                randn(c, scale=0.1), randn(b, c, scale=0.1) if film else None,
                randn(b, c, scale=0.1) if film else None]

    distinct = list(dict.fromkeys(K1_CALLS))
    k2_shapes = [(n, c, f) for n, c in distinct + [(100, 32)] for f in (True, False)]
    ph = phase("3 K1 linear-attention block")
    k1 = check_kernel("linear_attention_block", linear_attention_block,
                      linear_attention_block_plain, k1_args,
                      distinct + [(100, 32), (33, 64)], K1_CALLS, k1_work, part=k1_term)
    k1f16 = check_bf16_forward("linear_attention_block_bf16", linear_attention_block,
                               linear_attention_block_plain, k1_args, K1_CALLS, k1_work)
    check_mechanics("linear_attention_block", linear_attention_block,
                    linear_attention_block_plain, k1_args, MECHANICS_DOWN_CALLS,
                    backward=False, part=k1_term)
    done(ph, max_abs_err=f"{k1['max_abs_err']:.3e}",
         bf16_max_abs_err=f"{k1f16['max_abs_err']:.3e}")

    ph = phase("4 K2 GroupNorm-FiLM-SiLU")
    print_k2_plans(64, [(n, c) for n, c, _ in K2_CALLS])
    k2 = check_kernel("group_norm_film_silu", group_norm_film_silu,
                      group_norm_film_silu_plain, k2_args, k2_shapes, K2_CALLS, k2_work)
    k2f16 = check_bf16_forward("group_norm_film_silu_bf16", group_norm_film_silu,
                               group_norm_film_silu_plain, k2_args, K2_CALLS, k2_work)
    check_mechanics("group_norm_film_silu", group_norm_film_silu, group_norm_film_silu_plain,
                    k2_args, MECHANICS_DOWN_CALLS, backward=False)
    done(ph, max_abs_err=f"{k2['max_abs_err']:.3e}",
         bf16_max_abs_err=f"{k2f16['max_abs_err']:.3e}")

    ph = phase("6 sampling path")
    linear_attention_block.launches = 0
    group_norm_film_silu.launches = 0
    with tempfile.TemporaryDirectory() as tmp, timed("6"):
        summary = sample_eval.evaluate(RUN, SAMPLES, "float32", "cuda", seed=0, out=tmp)
    launches = (linear_attention_block.launches, group_norm_film_silu.launches)
    if launches != (8 * STEPS, 38 * STEPS):
        raise AssertionError(f"launches K1 {launches[0]} (want {8 * STEPS}), "
                             f"K2 {launches[1]} (want {38 * STEPS})")
    med = summary["residual_median"]
    if not (np.isfinite(summary["res_b"]).all() and RESIDUAL_RANGE[0] <= med <= RESIDUAL_RANGE[1]):
        raise AssertionError(f"residual median {med:.4e} outside {RESIDUAL_RANGE}")
    done(ph, residual_median=f"{med:.4e}", residual_mean=f"{summary['residual_mean']:.4e}",
         sampling_seconds=f"{summary['seconds']:.2f}",
         samples_per_s=f"{summary['samples_per_s']:.2f}",
         k1_launches=launches[0], k2_launches=launches[1])

    ph = phase("7 K1 backward")
    k1b = check_backward(
        "linear_attention_block_backward", linear_attention_block,
        linear_attention_block_plain,
        lambda *a: (*a[:4], *la.launch_forward(*a)[1:]), la.launch_backward,
        k1_args, distinct + [(100, 32), (33, 64)], K1_CALLS, k1_bwd_work)
    check_mechanics("linear_attention_block_backward", linear_attention_block,
                    linear_attention_block_plain, k1_args, MECHANICS_DOWN_CALLS, backward=True)
    work_bytes = 4 * _build.library().pidm_linear_attention_block_bwd_workspace(64, 4096, 32)
    print(f"  K1 backward workspace at B=64, N=4096, C=32: {work_bytes} bytes "
          f"({work_bytes / 2**20:.2f} MiB)", flush=True)
    if work_bytes > K1_BWD_WORKSPACE_MAX:
        raise AssertionError(f"K1 backward workspace {work_bytes} bytes > {K1_BWD_WORKSPACE_MAX}")
    done(ph, max_abs_err=f"{k1b['max_abs_err']:.3e}")

    ph = phase("8 K2 backward")
    k2b = check_backward(
        "group_norm_film_silu_backward", group_norm_film_silu, group_norm_film_silu_plain,
        lambda *a: (*a, gn.launch_forward(*a)[1]), gn.launch_backward, k2_args, k2_shapes,
        K2_CALLS, k2_bwd_work)
    check_mechanics("group_norm_film_silu_backward", group_norm_film_silu,
                    group_norm_film_silu_plain, k2_args, MECHANICS_DOWN_CALLS, backward=True)
    done(ph, max_abs_err=f"{k2b['max_abs_err']:.3e}")

    # every kernel timing (10, 12, 14, 15ab) runs here, on a quiet card;
    # they draw from ``gen`` in the order they did after 9 and 13, which
    # draw nothing from it
    ph = phase("10 K3 linear attention")
    k3, k3b = k3_phase(dev, randn, k1_args, distinct)
    done(ph, max_abs_err=f"{k3['max_abs_err']:.3e}",
         bwd_max_abs_err=f"{k3b['max_abs_err']:.3e}",
         launches=f"{k3['launches']}/{k3b['launches']}")

    ph = phase("12 bf16 backward kernels")
    ragged = [(100, 32), (33, 64)]
    k1b16 = check_backward(
        "linear_attention_block_backward_bf16", linear_attention_block,
        linear_attention_block_plain,
        lambda *a: (*a[:4], *la.launch_forward(*a)[1:]), la.launch_backward,
        k1_args, distinct + ragged, K1_CALLS, k1_bwd_work, bf16=True)
    k2b16 = check_backward(
        "group_norm_film_silu_backward_bf16", group_norm_film_silu,
        group_norm_film_silu_plain, lambda *a: (*a, gn.launch_forward(*a)[1]),
        gn.launch_backward, k2_args, k2_shapes, K2_CALLS, k2_bwd_work, bf16=True)
    k3b16 = check_backward(
        "linear_attention_backward_bf16", la.linear_attention, la.linear_attention_plain,
        lambda *a: (*a, *la.launch_attention_forward(*a)[1:]), la.launch_attention_backward,
        lambda b, n, c: [k1_args(b, n, c)[i] for i in (0, 2, 3)], distinct + ragged,
        K1_CALLS, k3_bwd_work, bf16=True)
    print("  K3 backward, bf16, one UNet backward's calls at B=64: " + json.dumps(
        {k: k3b16[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}), flush=True)
    done(ph, k1_max_abs_err=f"{k1b16['max_abs_err']:.3e}",
         k2_max_abs_err=f"{k2b16['max_abs_err']:.3e}",
         k3_max_abs_err=f"{k3b16['max_abs_err']:.3e}")

    ph = phase("14 K5 lane-packed GroupNorm-FiLM-SiLU")
    k5 = k5_phase(dev, randn)
    done(ph, max_abs_err=f"{k5['max_abs_err']:.3e}", launches=k5["launches"])

    ph = phase("15ab K4 against its plain version")
    k4, k4b = k4_phase(dev, randn)
    done(ph, max_abs_err=f"{k4['max_abs_err']:.3e}",
         bwd_max_abs_err=f"{k4b['max_abs_err']:.3e}")
    print("  K4 per UNet pass at B=64 (fp32: 18 calls; bf16 + fp32 head: 16), device ms: "
          + json.dumps({e["name"]: {k: v for k, v in e.items() if k.endswith("ms")}
                        for e in (k4, k4b)}), flush=True)

    # phases 20 and 21 need none of 9a's data: they run while the
    # background jobs make it
    steps_per_s = toy_phase(Path(data_tmp.name), dev, smi)
    steps_per_s.update(simp_phase(Path(data_tmp.name), dev, smi))

    # the card vs CPU train steps (9b, 15e, 16b, 17c), which time nothing,
    # run after 22, beside phase 23's ranks
    later = []
    with data_tmp as tmp:
        (k1["launches"], k1b["launches"], k2["launches"], k2b["launches"]), steps_per_s["9d"] = \
            train_phase(Path(tmp), dev, smi, jobs, later, refs)
        par.check()

        (k1f16["launches"], k1b16["launches"], k2f16["launches"], k2b16["launches"],
         steps_per_s["13c"]) = bf16_train_phase(Path(tmp), dev, smi, later, refs)
        par.check()

        fp32_counts, bf16_counts = cm_phase(Path(tmp), dev, smi, summary, steps_per_s,
                                             later, refs)
        k4["launches"], k4b["launches"] = fp32_counts[0], fp32_counts[2]
        k4["bf16_launches"], k4b["bf16_launches"] = bf16_counts[1], bf16_counts[3]

        steps_per_s["16c"] = ddim_phase(Path(tmp), dev, smi, later, refs)
        steps_per_s["17d"] = guidance_phase(Path(tmp), dev, smi, later, refs)
        graph_phase(Path(tmp), dev, smi, steps_per_s)

        cli23 = {}

        def card_shared():
            # after 19d's timing: phase 23's ranks run their checks, the card
            # lane LANE_CHECKS (18a, 9f, 13d, ...) and the torchrun CLI its steps
            # beside 19e, 22, 11 and the later checks, which time nothing but
            # 19e's and 11's samples/s (marked so)
            par.start_checks()
            lane.start()
            cli23.update(torchrun_cli_start(Path(tmp)))

        # 21a-b, 21d, 24b and 24c need nothing of the card lane: here they keep
        # the lane, which bounds the window, short
        later += [functools.partial(simp_checks, Path(tmp)),
                  functools.partial(shard_check, Path(tmp)),
                  functools.partial(reference_import_check, Path(tmp)),
                  functools.partial(plain_options_phase, dev, refs)]
        mech_k1, mech_k2, mech_sps = mechanics_phase(Path(tmp), dev, smi, k1_args, k2_args,
                                                     jobs, card_shared, later, refs)
        steps_per_s.update(mech_sps)
        mech_sweep(Path(tmp))
        par.check()
        for entry, counts in ((k1f16, mech_k1[1]), (k1b16, mech_k1[3]), (k2f16, mech_k2[1]),
                              (k2b16, mech_k2[3])):
            entry["mechanics_launches"] = counts
        opt_k1, opt_k2 = unet_options_phase(dev, smi, refs)
        for entry, counts in ((k1, opt_k1[0]), (k1b, opt_k1[2]), (k2, opt_k2[0]),
                              (k2b, opt_k2[2])):
            entry["unet_options_launches"] = counts
        print("  training steps/s (main paths; graph: 18b): " + json.dumps(
            {k: f"{v:.3f}" for k, v in steps_per_s.items()}), flush=True)

        ph = phase("11 corrected sampling (beside phase 23's ranks: its samples/s are a "
                   "shared card's)")
        corrected_sampling_phase(dev, summary)
        done(ph)
        for check in later:
            check()
        lane.finish()  # its phases' lines: LANE_CHECKS'

        ph = phase("23 the parallel layer: the ranks' checks and timed turns, the torchrun CLI")
        # the timed turns start when the CLI has ended: on a quiet card
        cli = torchrun_cli_finish(cli23)
        checks, timing = par.finish()
        for r, c in enumerate(checks):
            print(f"  rank {r} state at tp=2: {json.dumps(c['23c']['rank_state_bytes'])} bytes "
                  f"({c['23c']['rank_state_gb']:.4f} GB), peak memory "
                  f"{c['23c']['peak_memory_gib']:.2f} GiB", flush=True)
        print("  steps/s, eager, two ranks sharing the card (the collectives' cost, not a "
              "scaling): " + json.dumps(timing), flush=True)
        done(ph, torchrun_losses=json.dumps(cli["losses"]),
             torchrun_seconds=f"{cli['seconds']:.2f}", no_group=json.dumps(cli["refused"]))
        dp, tp = checks[0]["23a"]["dp_float32_launches"], checks[0]["23c"]["bf16_launches"]
        for entry, counts in ((k1, dp[0][0]), (k1b, dp[0][2]), (k2, dp[1][0]), (k2b, dp[1][2]),
                              (k1f16, tp[0][1]), (k1b16, tp[0][3]), (k2f16, tp[1][1]),
                              (k2b16, tp[1][3])):
            entry["parallel_launches"] = counts
    print(f"[total] {time.perf_counter() - t_start:.2f} s", flush=True)
    SERIAL["waited_for_cpu_references"] = refs.waited
    print("[serial CPU work, s] " + json.dumps(
        {kind: {k: round(v, 2) if v is not None else None for k, v in d.items()}
         for kind, d in SERIAL.items()}), flush=True)

    for entry, source, replaces in (
        (k1, "physicsinformeddiffusionmodels_tpu_torch/csrc/linear_attention.cu",
         "physicsinformeddiffusionmodels_tpu/ops/pallas_attention.py:468"),
        (k1f16, "physicsinformeddiffusionmodels_tpu_torch/csrc/linear_attention.cu",
         "physicsinformeddiffusionmodels_tpu/ops/pallas_attention.py:468"),
        (k2, "physicsinformeddiffusionmodels_tpu_torch/csrc/group_norm.cu",
         "physicsinformeddiffusionmodels_tpu/ops/pallas_kernels.py:78"),
        (k2f16, "physicsinformeddiffusionmodels_tpu_torch/csrc/group_norm.cu",
         "physicsinformeddiffusionmodels_tpu/ops/pallas_kernels.py:78"),
        (k1b, "physicsinformeddiffusionmodels_tpu_torch/csrc/linear_attention_bwd.cu",
         "physicsinformeddiffusionmodels_tpu/ops/pallas_attention.py:530"),
        (k2b, "physicsinformeddiffusionmodels_tpu_torch/csrc/group_norm_bwd.cu",
         "physicsinformeddiffusionmodels_tpu/ops/pallas_kernels.py:184"),
        (k3, "physicsinformeddiffusionmodels_tpu_torch/csrc/linear_attention.cu",
         "physicsinformeddiffusionmodels_tpu/ops/pallas_attention.py:122"),
        (k3b, "physicsinformeddiffusionmodels_tpu_torch/csrc/linear_attention_bwd.cu",
         "physicsinformeddiffusionmodels_tpu/ops/pallas_attention.py:180"),
        (k1b16, "physicsinformeddiffusionmodels_tpu_torch/csrc/linear_attention_bwd.cu",
         "physicsinformeddiffusionmodels_tpu/ops/pallas_attention.py:530"),
        (k2b16, "physicsinformeddiffusionmodels_tpu_torch/csrc/group_norm_bwd.cu",
         "physicsinformeddiffusionmodels_tpu/ops/pallas_kernels.py:184"),
        (k5, "physicsinformeddiffusionmodels_tpu_torch/csrc/group_norm_packed.cu",
         "scripts/profile_gn.py:53"),
        (k4, "physicsinformeddiffusionmodels_tpu_torch/csrc/conv_block.cu",
         "physicsinformeddiffusionmodels_tpu/ops/pallas_conv.py:126"),
        (k4b, "physicsinformeddiffusionmodels_tpu_torch/csrc/conv_block_bwd.cu",
         "physicsinformeddiffusionmodels_tpu/ops/pallas_conv.py:185"),
    ):
        entry.update(route="cuda", source=source, replaces=replaces)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    # K4's entries also carry the default Block's time (cuDNN conv + K2) and
    # their bf16 + fp32-head figures (bf16_*)
    print(json.dumps({"kernels": [{**{k: e[k] for k in keys},
                                   **{k: v for k, v in e.items() if k not in keys}}
                                  for e in (k1, k1f16, k2, k2f16, k1b, k2b, k3, k3b, k1b16,
                                            k2b16, k5, k4, k4b)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
