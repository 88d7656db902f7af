#!/usr/bin/env python3
"""Drive the PyTorch port (``tpujob_torch``) on one NVIDIA card and hold
every hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py            # from the repo root, one CUDA card
    python3 chip_smoke.py --decode-prompt 896 --decode-new 128
                                     # the decode phase at a longer buffer

Phases, one JSON line each on stdout:

1. ``device``: the card, its power limit, torch and CUDA versions.
2. ``build``: every kernel of ``tpujob_torch/csrc`` compiled with ``nvcc``
   for sm_90a (all sources at once), with ptxas' register/spill report and
   each warpgroup role's ``setmaxnreg`` budget; a spill fails the phase, and
   so does ptxas' C7518 ("wgmma serialized") or C7517 ("warpgroup.wait
   injected"): the tuned kernels and B2a/B3a are wgmma kernels, and either
   note means the products of one no longer overlap (the tuned kernels
   and B1a-B3a are all wgmma kernels).
3. ``kernel``: each flash kernel (B1 forward, B2 dQ, B3 dK/dV) at the
   GPT-2-medium shapes (b=8, s=1024, h=16, d=64, bf16, causal), at a ragged
   length (s=1000), with a sliding window (256), at the BERT-large
   shapes without the mask (case ``bert_s512``: b=8, s=512, h=16), at
   the decode buffer's shape (case ``decode_s64``: the full route's B1,
   causal, s = prompt + new tokens), and at head dim 32 (the kernels'
   second instantiation: ``quick_d32``, ``bench_models --quick``'s GPT
   shape b=4, s=128, h=8; ``gpt_d32`` and ``gpt_d32_noncausal``, b=8,
   s=1024, h=16, timed): every element within RTOL x |plain|
   + ATOL x rms_row(plain) + FLOOR x rms(plain) of the plain version,
   and at the GPT, BERT, decode and head-dim-32 GPT shapes the
   kernel's, the plain version's and the PyTorch library call's times
   (CUDA events, the launches queued behind a busy-wait kernel so that
   the device, not the host, is timed) beside the bound computed from the
   inputs, the rate over the visible pairs' FLOPs (``tflops``) and
   ``bound_share`` (bound / time); ``backward``: B2 and B3 launched back
   to back, timed together, beside SDPA's backward (one call for dQ, dK
   and dV).  Then the general kernels B1a-B3a (``flash_*_any``, fp32 or
   bf16 at any head dim; wgmma with split precision; fp32 at padded head
   dim 256 on a wgmma kernel of its own in each; bf16 at head dim 128
   on the ``bf16_128`` route's kernels, ``flash_*_bf16_128``):
   fp32 at GPT's shape (``any_gpt_f32``, timed), fp32 at the dryrun's
   head dim 16 without the mask, bf16 at head dim 128 (timed; and with a
   256 window) and 80 (timed), fp32 at head dim 256 (``any_d256_f32``,
   b=8, s=1024, h=8: the d=256 GPT's attention, timed; and at a ragged
   s=1000), each within ANY_TOL of its plain version; their bound takes
   the TF32 peak for fp32 (one pass, so the rows stay comparable) with
   the FFMA peak's beside it (``ffma_bound_ms``: a yardstick, the CUDA
   cores' fp32 rate, which no kernel runs on any more) and the split's reach
   (``split_reach_ms``: three tf32 passes of every product in fp32; in
   bf16 one pass of S and dP, two of the products with P and dS), and
   SDPA is timed in the case's dtype.
   Then ``adamw``: AdamW's update at GPT-2-medium's and BERT-large's
   parameter sets, the port's kernel (``csrc/adamw.cu``) against torch's
   capturable foreach route and ``fused=True``, all timed beside the byte
   bound; the kernel's parameters within ADAMW_ULPS of foreach's; each
   route's kernels by the op that launched them (``run_adamw``).
   Then B1a-B3a at the Mellum2 cell's attention (``mellum_s8192_w1024``
   and ``mellum_s8192``: b=2, s=8192, 32 query heads, d=128, bf16,
   causal, windowed at 1,024 and full), each plain version four heads at
   a time.
   Then ``moe_gemm``: the dropless expert layer's three grouped-GEMM
   kernels (``csrc/moe_gemm.cu``) at the Mellum2 cell's shapes on
   Zipf-uneven and even groups, timed beside their bound, their plain
   versions, a per-expert cuBLAS loop and ``torch._grouped_mm``, each held
   to fp32 products (``run_moe_gemm``).
4. ``model``: a 2-layer full-width GPT on the card with flash attention
   against the same weights with dense attention (logits, loss, and each
   parameter's gradient, by normwise relative error); ``model_bert``: the
   same for a 2-layer full-width BERT (seq 512, non-causal) on the MLM loss.
5. ``graph``: the compiled step.  Each trainer through its entry point
   once with ``capture=False`` (the eager step) and once captured (one
   eager step, then CUDA-graph replays), from one seed: GPT-2-medium 8
   steps, BERT-large MLM 8 mini-steps with ``--grad-accum 2`` (both graphs
   of a group), ResNet-50 2 steps, MNIST one epoch.  The losses, the
   parameter digests and the running statistics must be bit-equal (the
   same kernels in the same order), the launches equal (48 / 24 / 24 a
   transformer step: a replay counts the kernels the card ran); peak
   memory and host ms a step of both are reported.  Every later phase
   runs the captured step and requires ``step_mode`` ``graph`` (``ddp``'s
   ranks excepted: across processes the step is eager).
6. ``train``: the main path — ``gpt.run`` trains GPT-2-medium (24 layers,
   hidden 1024, 16 heads, vocab 50257, seq 1024, batch 8, bf16, remat,
   flash attention) for 16 steps from a seed; losses must be finite and
   fall.  Kernel launch counts are zeroed just before and read just after.
   The rate is all tokens over all the time of steps 3-12; ``profile``:
   steps 13-16 under torch.profiler, device time by kernel class and the
   device's busy share of those steps (the profiler's own host cost
   included: compare ``host_step_ms`` with the unprofiled steps); the
   unprofiled steps' host ms must be within HOST_OVER_BUSY_MAX of the
   profiled device busy ms: the host no longer sets the rate.
7. ``mlm``: the second path — ``bert.run`` trains BERT-large (24 layers,
   hidden 1024, 16 heads, intermediate 4096, vocab 30522, seq 512, batch 8,
   bf16, remat, flash attention) for 10 steps from a seed: losses finite
   and falling, every kernel launched, each launch without the causal
   mask; tokens/s and the per-step ms.
8. ``fp32``: the general kernels' path — ``gpt.run`` trains GPT-2-medium
   in fp32 (``--no-bf16 --attention flash``, full width and depth, batch
   8, remat, captured) for 2 + 6 steps, TF32 off: every step launches
   the ``_any`` kernels 48 / 24 / 24 times and no tuned one; losses finite
   and falling; its step-1 loss within FP32_LOSS_RTOL of one step of the
   same seed at ``--attention dense`` in fp32; tokens/s and ms a step over
   the last 6 steps, peak memory.  Then a 2-layer GPT at hidden 1024 and 8
   heads (head dim 128, bf16, flash), 4 steps through the bf16_128
   route's kernels (16 / 8 / 8 launches, none of the ``_any`` ones),
   losses falling; and a 2-layer GPT at
   hidden 2048, 8 heads of 256, intermediate 8192 in fp32 (flash, batch
   8, seq 1024, captured; Gemma-2B's head width as multi-head attention)
   for 2 + 4 steps: 4 / 2 / 2 ``_any`` launches a step, losses finite and
   falling, step 1's loss within FP32_LOSS_RTOL of one dense fp32 step,
   ms a step and peak memory.
9. ``decode``: the serving path — ``gpt.run --steps 1 --generate 32`` at
   GPT-2-medium, then on that model, from a batch-8 prompt of 16 synthetic
   tokens, 48 greedy new tokens by each route: ``generate_cached`` (dense
   attention on the KV cache) launches no kernel, ``generate`` (full
   re-forward, flash) exactly 48 x 24 forward kernels and no backward one.
   A forward of the same weights with dense attention (no kernel) is the
   reference: every chosen token's logit, teacher-forced over its
   sequence, lies within MODEL_TOL x rms(logits) of its row's maximum
   there, and each route's own logits (the cached route teacher-forced
   through its cache, the full route's flash forward) match it by normwise
   error; decode tokens/s and ms per new token for each route.

10. ``corpus``: the trainers on a real corpus, the ``.py`` and ``.md``
   files under ``tpujob/`` and ``docs/`` concatenated in sorted path order
   into a temporary directory outside the repo (about 1.38 MB).  A 512-id
   BPE tokenizer is trained on its first 256 KB and the corpus encoded
   into the token cache (both timed), then ``gpt.run`` trains
   GPT-2-medium (flash) on the BPE tokens and ``bert.run`` BERT-large
   (flash) on the raw bytes ([MASK] 256), 8 steps each, a new batch a
   step.  The batch each step copied to the card must equal the
   provider's for that step, losses must be finite, and each run must
   launch B1, B2 and B3 (GPT with the causal mask, BERT without).
11. ``moe``: the sparse MoE path (``--moe-experts 8 --moe-k 2
   --moe-capacity-factor 1.25``, one card), one line a part.  ``gpt``:
   GPT-2-medium at full width and depth with every FFN 8 experts of its
   width, through ``gpt.run`` (flash, bf16, remat, batch 8, captured) for
   2 + 8 + 2 steps as in ``train``: losses finite and falling, the load
   balance, z-loss and dropped assignments of every step finite and
   printed, exactly 48 / 24 / 24 launches a step; tokens/s, host ms a step
   against the profiled busy ms, peak memory.  ``decode``: on that model,
   batch 8, greedy: ``generate_cached`` returns ``generate``'s tokens (it
   falls back to the full route, 48 x 24 forward launches), ms a new
   token; a copy at capacity factor 0.5 (``MOE_DECODE_CF``) keeps the
   realized positions' logits under the validity mask whatever the suffix
   holds, and changes them without it.  ``graph``: 2 layers at full
   width, eager and captured, bit-equal losses, aux terms and digests.
   ``mlm``: ``bert.run`` at BERT-large width with the same experts, 8 of
   its 24 layers, every launch without the mask.  ``dispatch``: one layer's
   ``moe_ffn`` against its routing and dense one-hot dispatch/combine
   alone, device ms forward and forward + backward.
   ``mellum``: Mellum2-12B-A2.5B's block (one period at published widths,
   batch 2 x seq 8192) through ``gpt.run`` for 6 captured steps, the
   launches set to 0 just before: the bf16_128 flash kernels and the
   grouped GEMMs exactly as often as its layers and remat say, no tuned
   flash kernel, AdamW on the kernel (``run_mellum_steps``).
12. ``mnist``: ``mnist.run`` with its default flags (synthetic, 60,000 /
   10,000 images, batch 64, 1 epoch; cuDNN/cuBLAS, no hand-written
   kernel): accuracy above 0.9, samples/s over the run.
13. ``resnet``: ``resnet.run`` at ResNet-50 (width 64, 224x224, batch
    256, bf16, channels-last), 2 warm-up and 10 timed steps: losses finite
    and falling, samples/s over the timed steps, peak device memory;
    ``resnet_profile``: a second run traces 4 steps after its warm-up
    through ``--profile-dir``, and the trace gives the kernels' ms a step
    by class and the device's busy share of the kernels' span.
14. ``ddp``: the multi-process path, after the others and with the
    parent's models freed.  ``smoke_dist`` at world 1 over NCCL on
    ``cuda:0`` (the only NCCL group one card allows), then two ranks on
    the one card over gloo (NCCL refuses two ranks on one card; gloo
    runs its collectives on the CUDA tensors, and a collective it refuses
    fails the phase), spawned with the env the operator writes for a job
    with no ``tpu`` field: ``smoke_dist``; GPT-2-medium through
    ``gpt.run`` (full width and depth, flash, bf16, remat, global batch 8,
    4 steps; each rank launches B1/B2/B3 exactly 48/24/24 times a step);
    ResNet-50 through ``resnet.run`` (global batch 256, 2 + 4 steps; both
    ranks' running statistics equal); MNIST through ``mnist.run``
    (``DDP_MNIST_ARGV``: global accuracy above 0.9, every test row counted
    once).  Each is held to the parent's own one-process run of the same
    seed; per-rank ms a step are a record of this layout (gloo's host
    copies included), not a DDP speed.
15. ``sp``: sequence parallelism, two ranks on the one card over gloo
    (as ``ddp``; gloo's all-to-all takes the CUDA tensors, its send and
    receive do not, so the ring's shift stages through the host), one
    line a part, each against the parent's own one-process run of the
    same seed and global batch (8): ``ulysses``, GPT-2-medium (full width,
    12 of its 24 layers: ``CUT_LAYERS``) through ``gpt.run
    --sequence-parallel 2 --sp-mode ulysses --attention flash``, 3 steps:
    losses within SP_LOSS_RTOL, the first and last layers' and ``ln_f``'s
    params after step 1 within SP_UPDATE_RTOL (``update_err``), and each
    rank launching B1/B2/B3 as often as the one process (24 / 12 / 12 a
    step) on the re-sharded
    [8, 1024, 8, 64] heads; ``ring``, the same model with ``--sp-mode
    ring`` (dense per hop, zigzag layout) against one process on dense
    attention; ``mlm``, BERT-large MLM under Ulysses on the non-causal
    kernels at 8 of its 24 layers; ``local``, B1-B3 at Ulysses's local
    shape against their plain versions, timed.  Each part prints each
    rank's ms a step (steps 2-3) and the share of it in the exchanges
    (the card synced around each): a record of gloo on one card, not a
    speed of sequence parallelism.
16. ``shard``: FSDP and tensor parallelism, two ranks on the one card
   over gloo (as ``sp``; gloo takes the CUDA tensors in every collective
   FSDP2 and the Megatron exchanges make), one line a part, each against
   the parent's own one-process captured run of the same seed and global
   batch (8), GPT-2-medium at full width and 12 layers (``CUT_LAYERS``)
   through ``gpt.run``, 3 steps: ``fsdp``, ``--fsdp 2 --attention flash``
   (each rank 4 rows into B1-B3, 24 / 12 / 12 launches a rank-step, and
   half of every parameter
   and AdamW moment); ``tp``, ``--tensor-parallel 2`` with dense
   attention (the JAX package refuses flash with TP; each rank 8 heads,
   half the FFN and vocab, all 8 rows).  Losses within SHARD_LOSS_RTOL
   (or one bf16 ulp), ``update_err`` after step 1 within
   SHARD_UPDATE_RTOL, each rank's parameter and moment bytes against one
   process's, the parameters TP holds whole bit-equal on both ranks, peak
   memory, and the exchanges' calls, bytes and share of a rank-step
   (FSDP's all-gathers and reduce-scatters counted around
   ``torch.distributed``'s calls, ``counted_collectives``): a record of
   correctness and memory, not a speed of FSDP or TP.
17. ``ep``: expert parallelism and MoE under sequence parallelism, two
   ranks on the one card over gloo (as ``shard``), one line a part, each
   against the parent's own one-process captured run of the same seed
   and global batch (8), the ``moe`` phase's experts (8, top-2, capacity
   1.25), 3 steps; the one process's memory is freed before the ranks
   start.  ``ep``: GPT-2-medium at full width and 12 layers
   (``CUT_LAYERS``) through ``gpt.run --expert-parallel 2 --attention
   flash``, each rank 4 of the 8 experts of every layer and all 8 rows
   into B1-B3 (24 / 12 / 12 launches a rank-step); ``moe_sp``: the same model
   at 8 of its 24 layers under ``--sequence-parallel 2 --sp-mode ulysses
   --attention flash`` (each rank 512 of each row's positions, the slots
   of each whole sequence).  Losses within SHARD_LOSS_RTOL (or one bf16
   ulp), ``update_err`` after step 1 within SHARD_UPDATE_RTOL, every
   step's dropped assignments equal to one process's as integers under
   ``ep`` (a rank's arithmetic is one process's, sum for sum), step 1's
   under ``moe_sp`` (the two ranks' summed) and each later step's there
   within EP_DROPPED_RTOL, each rank's parameter, expert and moment
   bytes against one process's, the parameters the expert group holds
   whole bit-equal on both ranks, peak memory, and the exchanges' calls,
   bytes and share of a rank-step: a record of correctness and memory,
   not a speed of expert parallelism.
18. ``pipe``: pipeline parallelism, two ranks on the one card over gloo
   (as ``shard``; the stage exchanges stage through the host, as the
   ring's shift does), one line a part, GPT-2-medium at full width and
   depth through ``gpt.run --pipeline-parallel 2 --attention flash``,
   global batch 8: ``gpipe`` and ``1f1b`` (4 microbatches of 2 rows, 3
   steps), each against the parent's own one-process captured run of the
   same seed and batch (losses within one bf16 ulp, ``update_err`` after
   step 1 within SHARD_UPDATE_RTOL, the stages' leaves merged), each rank
   holding its 12 layers and every parameter outside them (203,718,656
   parameters, their bytes and twice them in AdamW's moments, exactly),
   96 / 48 / 48 launches a rank-step (B1 again in GPipe's remat replay or
   1F1B's recomputing backward tick), peak memory, and the exchanges'
   calls, bytes and share of a rank-step; ``1f1b`` also against
   ``gpipe`` (losses within one bf16 ulp, the leaves' gradients after
   the run within PIPE_GRAD_RTOL normwise); ``gpipe_m8``
   and ``1f1b_m8``, 8 microbatches for two steps: the peak memory against
   m 4 (1F1B's within PIPE_1F1B_PEAK_RATIO: its stash is bounded by the
   stages); ``mlm``, BERT-large MLM under 1F1B at 8 of its 24 layers (the
   non-causal kernels on the pipeline).  B1-B3 are held to their plain
   versions at a microbatch's shape first (kernel case ``pipe_b2``).
19. ``dryrun``: ``graft_entry.dryrun_multichip(8)``, the root entry's:
    the JAX package's multi-device matrix (data x tensor x sequence on
    the ring, Ulysses, EP, GPipe, 1F1B, FSDP x TP, TP x PP, FSDP x SP; a
    2-layer BERT, one step each) at 8 gloo ranks sharing the card, then
    at 8 ranks on the CPU: every case's loss finite, 1F1B's within 1e-3
    of GPipe's, each within DRYRUN_LOSS_RTOL of the CPU's; the phase's
    seconds; then ``graft_entry.entry()`` (BERT-large's bf16 forward on
    [4, 128] as a function of its parameters): logits [4, 128, 30522],
    finite, and its ms.
20. ``bench``: ``python -m tpujob_torch.bench``, ``python -m
    tpujob_torch.bench_models --models resnet50,bert-large,gpt`` and
    ``python -m tpujob_torch.bench_models --quick --models gpt`` (head dim
    32) and ``python -m tpujob_torch.bench_models --models scaling`` (the
    DP-scaling row: one eager step of a small BERT in one process and in 8
    gloo ranks sharing the card) as child processes on the card; their
    JSON lines are printed as they are, and held to their contract: one
    headline line with the JAX line's keys, accuracy above 0.8; one line a
    row with ``mfu_vs_spec`` at most 1; every flagship line on the
    captured step, on this card; the scaling row with the JAX row's keys,
    ``platform`` gpu, 8 ranks a card over gloo, and the 8 ranks' first
    loss within SCALING_LOSS_RTOL of one process's.

Then the ``kernels`` summary line, thirteen kernels (each flash kernel's
``main_path``: ``train`` for the tuned three, ``mellum`` for the
bf16_128 three, ``fp32`` for the ``_any`` three, whose run gives
``launches``; its ``paths``: the phases that
launched it; its ``cases``: every timed shape's numbers, the head-dim-32
and Ulysses-local ones included; then the three grouped GEMMs',
``moe_gemm_rows``: ``run_moe_gemm``'s times, ``torch._grouped_mm`` as
``library_ms``, launches on the ``mellum`` path; then AdamW's, ``adamw_row``: the
``adamw`` phase's times, and the parameter tensors it updated on each
path, spawned ranks and bench rows included, from ``optim.UPDATES``), the
card's ``name, power.limit`` as nvidia-smi prints them, and last ``{"ok":
true, "device": {...}}``.  Any failure (no card, no package, a build
error, a mismatch, a kernel a path never launched, torch's AdamW updating
a tensor on any path) exits non-zero before the last line.
"""
from __future__ import annotations

import argparse
import json
import logging
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from contextlib import contextmanager, nullcontext
from pathlib import Path

import torch


DEVICE = "cuda"
# AdamW's kernel against torch's foreach route after run_adamw's updates:
# ulps of max(|foreach's|, ADAMW_FLOOR), as tests/test_torch_adamw.py
ADAMW_ULPS = 8
ADAMW_FLOOR = 2.0 ** -9
MAIN = dict(b=8, s=1024, h=16, d=64)
# Kernel vs plain version, element by element:
#   |kernel - plain| <= RTOL * |plain| + ATOL * rms_row(plain)
#                       + FLOOR * rms(plain)
# where rms_row is the rms over the element's own row of head_dim values.
# The two compute one function on the same inputs; they differ by bf16
# rounding of the output (<= 2^-8 relative) and of P / dS for the tensor
# cores, an error that scales with the row's own terms.  The row rms covers
# values near 0 by cancellation without letting the large early causal rows
# set the limit for the small late ones.  A floor of FLOOR x rms(plain)
# over the whole tensor covers rows that are exactly 0 (dQ's first causal
# row sees one key, so dS = P (dP - D) = 0); it lies below one bf16 ulp at
# the tensor's rms.
RTOL = ATOL = 2e-2
FLOOR = 1e-3
LSE_TOL = 1e-3  # lse is fp32 in both; only exp/log approximations differ
# Flash vs dense attention in one model (two attention algorithms in
# bf16): the normwise relative error ||flash - dense|| / ||dense|| of the
# logits and of each parameter's gradient; in decode, the gap between a
# chosen token's logit and its row's maximum, over the row's rms.
MODEL_TOL = 5e-2
WARMUP_STEPS, TIMED_STEPS, PROFILED_STEPS = 2, 10, 4
MLM_STEPS = 10
# decode: a batch of 8; by default a prompt of 16 tokens and 48 new ones (a
# 64-position buffer, a smoke check of both routes and of B1 at one
# q-tile), longer with --decode-prompt / --decode-new
DECODE_BATCH, DECODE_PROMPT, DECODE_NEW = 8, 16, 48
ROOT = Path(__file__).resolve().parent
# corpus: the first 256 KB train a 512-id BPE; 8 steps of each trainer
CORPUS_TOKENIZER_BYTES, CORPUS_VOCAB, CORPUS_STEPS = 256 * 1024, 512, 8
CORPUS_GPT_ARGV = ["--attention", "flash", "--batch-size", "8"]
CORPUS_BERT_ARGV = ["--attention", "flash", "--batch-size", "8"]
MNIST_ARGV: list = []  # the entry point's defaults
RESNET_ARGV = ["--batch-size", "256", "--image-size", "224", "--width", "64",
               "--warmup-steps", "2", "--steps", "10"]
RESNET_PROFILED_STEPS = 4
# ddp: two ranks on the one card (gloo), each against a one-process run
DDP_WORLD = 2
DDP_GPT_ARGV = ["--attention", "flash", "--batch-size", "8", "--steps", "4",
                "--log-interval", "1", "--seed", "0"]
DDP_RESNET_ARGV = ["--batch-size", "256", "--image-size", "224", "--width",
                   "64", "--warmup-steps", "2", "--steps", "4"]
# a test set of two whole batches of 1,000: every row is tested
DDP_MNIST_ARGV = ["--train-size", "8192", "--test-size", "2000"]
# Two ranks' losses against one process's.  GPT's are bf16 scalars near
# 11, where one bf16 ulp is 0.0625 (5.7e-3 relative): the averaged
# gradient rounds otherwise, and a loss may land one ulp away.  ResNet's
# are fp32 from bf16 activations (observed 2.8e-5 relative after 6 steps,
# its running statistics 8.8e-5 normwise, on an H100 80GB HBM3 at 700 W).
DDP_GPT_LOSS_RTOL = 1e-2
# GPT's parameters after 4 steps: both ranks bit-equal, and rank 0's
# distance from one process's over one process's distance from the
# initial parameters (``update_err``) at most this.  AdamW's first steps
# move each weight by about lr * sign(g), so the rounding that tells a
# 4-row product from an 8-row one flips the few updates whose gradient is
# near 0: observed 0.1230 on an H100 80GB HBM3 at 700 W.  A rank that
# trains alone on its half (no gradient all-reduce) reads 0.84-0.88 (two
# gloo ranks on the CPU, a GPT of width 64 and 2 layers).
DDP_GPT_UPDATE_RTOL = 0.25
DDP_RESNET_RTOL = 1e-3  # ResNet's losses and running statistics
DDP_MNIST_ATOL = 0.01  # accuracy: 20 of the 2,000 test images
DDP_TIMEOUT_S = 600  # the whole spawn; the ranks' collectives get half
# sp: two ranks on the one card (gloo), data 1 x sequence 2, global batch 8,
# each part against one process on the same global batch from the seed
SP_WORLD = 2
SP_STEPS = 3
SP_BASE_ARGV = ["--batch-size", "8", "--steps", str(SP_STEPS),
                "--log-interval", "1", "--seed", "0"]
# GPT-2-medium's depth cut from 24 to 12 layers in the sp, shard and ep
# phases' GPT parts (full width): with the fp32, dryrun and scaling
# phases the script kept to about 700 s (the exchanges through the host
# take most of a rank-step, layer by layer)
CUT_LAYERS = ["--layers", "12"]
SP_PARTS = {
    # part: (module, the ranks' flags, the one process's flags)
    "ulysses": ("gpt", CUT_LAYERS + ["--sequence-parallel", "2", "--sp-mode",
                                     "ulysses", "--attention", "flash"],
                CUT_LAYERS + ["--attention", "flash"]),
    "ring": ("gpt", CUT_LAYERS + ["--sequence-parallel", "2", "--sp-mode",
                                  "ring"], CUT_LAYERS),
    # BERT-large's depth cut from 24 to 8 layers to keep the phase short
    "mlm": ("bert", ["--layers", "8", "--sequence-parallel", "2",
                     "--sp-mode", "ulysses", "--attention", "flash"],
            ["--layers", "8", "--attention", "flash"]),
}
# Losses against one process: bf16 scalars near 11 (one ulp 5.7e-3
# relative); the ranks' loss is an fp32 sum over their shards and the one
# process's a bf16 mean, and the projections run on half the rows (another
# GEMM tiling): DDP's tolerance and reason.
SP_LOSS_RTOL = 1e-2
# The params after step 1 against one process's (``update_err``): DDP's
# gate; AdamW's first update moves each weight by about lr * sign(g), and
# the rounding that tells two layouts apart flips the near-zero ones.
SP_UPDATE_RTOL = 0.25
# shard: FSDP and tensor parallelism, two ranks on the one card (gloo),
# GPT-2-medium at full width and 12 layers, global batch 8, 3 steps, each part
# against one process's captured step on the same batch from the seed
SHARD_WORLD = 2
SHARD_STEPS = 3
SHARD_BASE_ARGV = ["--batch-size", "8", "--steps", str(SHARD_STEPS),
                   "--log-interval", "1", "--seed", "0"]
SHARD_PARTS = {
    # part: (module, the ranks' flags, the one process's flags)
    "fsdp": ("gpt", CUT_LAYERS + ["--fsdp", "2", "--attention", "flash"],
             CUT_LAYERS + ["--attention", "flash"]),
    "tp": ("gpt", CUT_LAYERS + ["--tensor-parallel", "2"], CUT_LAYERS),
}
# Losses against one process: 5e-3 relative, or one bf16 ulp of the loss
# where that is more (a bf16 scalar near 11: 0.0625, 5.7e-3 relative).
# Under FSDP the reported loss averages two ranks' bf16 means of 4 rows
# each, which rounds differently from one mean of 8; under TP the logits
# come from partial products summed in bf16 (another rounding).
SHARD_LOSS_RTOL = 5e-3
# The params after step 1 against one process's (``update_err``): the
# gate of ``ddp`` and ``sp``, and their reason.
SHARD_UPDATE_RTOL = 0.25
# ep: expert parallelism and MoE under sequence parallelism, two ranks on
# the one card (gloo), the moe phase's experts (8, top-2, capacity 1.25),
# global batch 8, 3 steps, each part against one process's captured step
# on the same batch from the seed, held to the shard phase's tolerances
EP_WORLD = 2
EP_STEPS = 3
EP_BASE_ARGV = ["--batch-size", "8", "--steps", str(EP_STEPS),
                "--log-interval", "1", "--seed", "0", "--moe-experts", "8",
                "--moe-k", "2", "--moe-capacity-factor", "1.25"]
EP_PARTS = {
    # part: (module, the ranks' flags, the one process's flags)
    "ep": ("gpt", CUT_LAYERS + ["--expert-parallel", "2", "--attention",
                                "flash"], CUT_LAYERS + ["--attention",
                                                        "flash"]),
    # GPT-2-medium's depth cut from 24 to 8 layers to keep the phase short
    "moe_sp": ("gpt", ["--layers", "8", "--sequence-parallel", "2",
                       "--sp-mode", "ulysses", "--attention", "flash"],
               ["--layers", "8", "--attention", "flash"]),
}
# Dropped assignments against one process's.  Under EP a rank's
# arithmetic is one process's sum for sum (``parallel.moe_ffn``), and
# every step's count must be one process's as an integer.  Under SP step
# 1 routes the same batch with the same weights (the slots of each whole
# sequence, its capacity), and its count must be one process's; after it
# the weights differ by their ``update_err`` (Ulysses's projections on
# half the rows, DDP's mean of two gradients), the router's near ties
# fall otherwise, and each later step's count is held within
# EP_DROPPED_RTOL of one process's (observed 0.04-0.06% on an H100 80GB
# HBM3 at 700 W).
EP_DROPPED_RTOL = 0.01
# pipe: pipeline parallelism, two ranks on the one card (gloo), pipeline 2,
# GPT-2-medium at full width and depth on the flash kernels, global batch 8
# in 4 microbatches of 2 rows, 3 steps, under each schedule, each against
# one process's captured step on the same batch from the seed, held to the
# shard phase's update gate and to one bf16 ulp of each loss; then both
# schedules at 8 microbatches (peak memory against m 4; 2 steps: torch
# makes AdamW's moments at the first update, so a first step's backward
# peaks without them), and BERT-large MLM under 1F1B at 8 of its 24 layers
# (the non-causal kernels)
PIPE_WORLD = 2
PIPE_STEPS = 3
PIPE_BASE_ARGV = ["--batch-size", "8", "--steps", str(PIPE_STEPS),
                  "--log-interval", "1", "--seed", "0"]
PIPE_PP = ["--pipeline-parallel", "2", "--attention", "flash"]
PIPE_PARTS = {
    # part: (module, the ranks' flags, the one process's flags or None)
    "gpipe": ("gpt", PIPE_PP + ["--pipeline-microbatches", "4"],
              ["--attention", "flash"]),
    "1f1b": ("gpt", PIPE_PP + ["--pipeline-microbatches", "4",
                               "--pipeline-schedule", "1f1b"],
             ["--attention", "flash"]),
    "gpipe_m8": ("gpt", PIPE_PP + ["--pipeline-microbatches", "8",
                                   "--steps", "2"], None),
    "1f1b_m8": ("gpt", PIPE_PP + ["--pipeline-microbatches", "8",
                                  "--pipeline-schedule", "1f1b",
                                  "--steps", "2"], None),
    # BERT-large's depth cut from 24 to 8 layers to keep the phase short
    "mlm": ("bert", ["--layers", "8"] + PIPE_PP + [
        "--pipeline-microbatches", "4", "--pipeline-schedule", "1f1b"],
            ["--layers", "8", "--attention", "flash"]),
}
# a rank's parameters at GPT-2-medium and pipeline 2: 12 of the 24 layers
# (12,596,224 each) and every parameter outside them (the tied embedding
# padded to 50,304 rows, the positions, ln_embed, ln_f: 52,563,968)
PIPE_RANK_PARAMS = 12 * 12_596_224 + 52_563_968
# the two schedules against each other: their losses within one bf16 ulp
# (the JAX package's test allows 1e-3 between fp32 losses; GPipe's loss
# is a bf16 mean, 1F1B's an fp32 mean of four bf16 ones, and bf16's
# values near 11 are 0.0625 apart), their gradients after the run (the
# leaves update_err reads) normwise within PIPE_GRAD_RTOL: 1F1B runs its
# head a microbatch at a time, GPipe on the whole batch (other GEMM
# shapes, and the tied embedding's bf16 gradient rounded once a
# microbatch before the fp32 sum)
PIPE_GRAD_RTOL = 5e-2
# 1F1B's peak memory at 8 microbatches over its peak at 4: the stash is
# bounded by the stage count, not by m (the JAX test's 30% slack)
PIPE_1F1B_PEAK_RATIO = 1.3
# graph: each trainer once eager (capture=False) and once captured, from
# one seed; the two must agree bit for bit (the same kernels in the same
# order): GPT-2-medium 8 steps, BERT-large MLM 8 mini-steps in groups of 2
# (both graphs of the accumulation), ResNet-50 2 steps, MNIST one epoch
GRAPH_STEPS = 8
GRAPH_GPT_ARGV = ["--attention", "flash", "--batch-size", "8", "--steps",
                  str(GRAPH_STEPS), "--log-interval", "1", "--seed", "0"]
GRAPH_MLM_ARGV = GRAPH_GPT_ARGV + ["--grad-accum", "2"]
GRAPH_RESNET_ARGV = ["--batch-size", "256", "--image-size", "224", "--width",
                     "64", "--warmup-steps", "0", "--steps", "2"]
GRAPH_MNIST_ARGV = MNIST_ARGV
# ...and a resume on the card: BERT-large's width at 2 layers, 8
# mini-steps in groups of 2, straight against a run checkpointed at
# mini-step 3 (inside a group) and resumed; the resumed run restores
# before its first (eager) step and captures after it
GRAPH_RESUME_ARGV = ["--attention", "flash", "--batch-size", "8",
                     "--layers", "2", "--grad-accum", "2", "--log-interval",
                     "1", "--seed", "0"]
GRAPH_RESUME_STEPS, GRAPH_RESUME_AT = 8, 3
# moe: GPT-2-medium with every FFN 8 experts of its width, top-2 routing at
# capacity factor 1.25 (the JAX package's defaults: GShard's top-2 gating,
# the Switch Transformer's 1.25); 2 + 8 + 2 steps, as train's windows
MOE_ARGV = ["--attention", "flash", "--batch-size", "8", "--moe-experts",
            "8", "--moe-k", "2", "--moe-capacity-factor", "1.25",
            "--log-interval", "1", "--seed", "0"]
MOE_WARMUP, MOE_TIMED, MOE_PROFILED = 2, 8, 2
# ...eager against captured at full width and 2 layers, bit for bit
MOE_GRAPH_STEPS = 6
MOE_GRAPH_ARGV = MOE_ARGV + ["--layers", "2", "--steps", str(MOE_GRAPH_STEPS)]
# ...BERT-large MLM (seq 512, flash without the mask) with the same experts;
# the depth cut from 24 to 8 layers to keep the phase short
MOE_MLM_STEPS = 6
MOE_MLM_ARGV = MOE_ARGV + ["--layers", "8", "--steps", str(MOE_MLM_STEPS)]
# ...decode on the full route: the realized positions' logits under the
# validity mask are invariant to the suffix at a tight capacity (the JAX
# test's factor 0.5; exact here: the same kernels on the same rows) and
# change without the mask by more than MOE_SUFFIX_MIN x rms(logits)
MOE_DECODE_CF = 0.5
MOE_SUFFIX_MAX, MOE_SUFFIX_MIN = 1e-3, 1e-2
# the captured GPT step's host ms over its device busy ms (phases train and
# profile) may be at most this: the host no longer sets the rate
HOST_OVER_BUSY_MAX = 1.15
# bench: the port's two benches as child processes, each line's contract held
BENCH_TIMEOUT_S = 300
BENCH_MODELS = "resnet50,bert-large,gpt"
BENCH_ARGV = ["tpujob_torch.bench"]
BENCH_MODELS_ARGV = ["tpujob_torch.bench_models", "--models", BENCH_MODELS]
# the GPT row at --quick's shapes: hidden 256, 8 heads of 32
BENCH_QUICK_ARGV = ["tpujob_torch.bench_models", "--quick", "--models", "gpt"]
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "accuracy",
              "gate_dataset", "chips", "platform", "steps", "wall_s",
              "step_ms_mean", "step_ms_std", "step_ms_cv_pct"}
BENCH_MODELS_KEYS = {"metric", "value", "unit", "global_batch", "chips",
                     "steps", "step_ms", "step_ms_std", "platform",
                     "flops_per_step", "achieved_tflops_per_chip"}
# ...and the DP-scaling row: 8 gloo ranks sharing the card against one
# process, the same global batch; the JAX row's keys and the 8 ranks'
# first loss within SCALING_LOSS_RTOL of one process's (fp32, the masked
# sums taken per rank and summed by gloo)
BENCH_SCALING_ARGV = ["tpujob_torch.bench_models", "--models", "scaling"]
BENCH_SCALING_KEYS = {"metric", "value", "unit", "step_ms_1dev",
                      "step_ms_8dev", "global_batch", "platform"}
SCALING_LOSS_RTOL = 1e-5

# The _any kernels (fp32 or bf16 at any head dim, fp32 arithmetic like the
# plain versions, B1a-B3a's products on the tensor cores at 22 of fp32's 24
# bits: 3xTF32) against their plain versions, element by element as
# ``compare`` with (rtol, atol of the row rms, floor of the rms): in fp32
# the two differ in summation order, the exp/log approximations and the
# split; in bf16 by one ulp of the rounded output (at most 2^-7 relative)
# where the fp32 results straddle a rounding.  lse within ANY_LSE_TOL.
ANY_TOL = {torch.float32: (1e-5, 1e-5, 1e-6),
           torch.bfloat16: (1e-2, 1e-3, 1e-4)}
ANY_LSE_TOL = 1e-5
# fp32: GPT-2-medium (full width and depth) through gpt.run with
# --no-bf16 --attention flash, captured, 2 + 6 steps; its step-1 loss
# against one step of the same seed at --attention dense in fp32 (the two
# attentions differ in summation order only, TF32 off for both); then a
# 2-layer GPT at hidden 1024 and 8 heads (head dim 128, bf16, flash); and
# a 2-layer GPT at hidden 2048 and 8 heads (head dim 256, fp32, flash:
# B1a-B3a's fp32 head-dim-256 kernels) against one dense fp32 step, 2 + 4
# steps
FP32_ARGV = ["--no-bf16", "--attention", "flash", "--batch-size", "8",
             "--log-interval", "1", "--seed", "0"]
FP32_WARMUP, FP32_TIMED = 2, 6
FP32_LOSS_RTOL = 1e-5
FP32_D128_STEPS = 4
FP32_D128_ARGV = ["--layers", "2", "--heads", "8", "--attention", "flash",
                  "--batch-size", "8", "--log-interval", "1", "--seed", "0",
                  "--steps", str(FP32_D128_STEPS)]
FP32_D256_ARGV = ["--layers", "2", "--hidden", "2048", "--heads", "8",
                  "--intermediate", "8192", "--no-bf16", "--attention",
                  "flash", "--batch-size", "8", "--log-interval", "1",
                  "--seed", "0"]
FP32_D256_WARMUP, FP32_D256_TIMED = 2, 4
# dryrun: the JAX package's multi-device matrix at 8 gloo ranks sharing
# the card (graft_entry.dryrun_multichip), then at 8 ranks on the CPU; each
# case's loss on the card within DRYRUN_LOSS_RTOL of the CPU's (fp32 both,
# TF32 off: summation order only)
DRYRUN_N = 8
DRYRUN_LOSS_RTOL = 1e-4
H100_TF32_FLOPS = 494.7e12  # dense TF32 tensor-core peak: a redesign's reach
H100_FP32_FLOPS = 66.9e12   # fp32 FFMA peak (the CUDA cores): a yardstick
                            # beside the tensor cores' bound, no kernel's
# B1a-B3a's split precision: tensor-core passes over the one-pass FLOPs
# (fp32: 3xTF32; bf16: S and dP once, the products with P and dS twice)
SPLIT_PASSES = {torch.float32: {"flash_fwd": 3, "flash_dq": 3,
                                "flash_dkv": 3},
                torch.bfloat16: {"flash_fwd": 3 / 2, "flash_dq": 8 / 6,
                                 "flash_dkv": 12 / 8}}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


TUNED = ("flash_fwd", "flash_dq", "flash_dkv")
B128 = ("flash_fwd_bf16_128", "flash_dq_bf16_128", "flash_dkv_bf16_128")
ANY = ("flash_fwd_any", "flash_dq_any", "flash_dkv_any")
MOE_GEMM = ("moe_gemm_fwd", "moe_gemm_dx", "moe_gemm_dw")
# the kernels whose launches each path counts (``build.LAUNCHES``)
COUNTED = TUNED + B128 + ANY + MOE_GEMM


def reset_launches() -> None:
    from tpujob_torch.kernels import build

    build.reset_launches()


def kernel_launches() -> dict:
    """Each of ``COUNTED``'s launches since the last ``reset_launches()``."""
    from tpujob_torch.kernels import build

    return {k: build.LAUNCHES[k] for k in COUNTED}


def launched(want: dict) -> dict:
    """Every kernel's launches: ``want``'s, 0 for the others."""
    return {**dict.fromkeys(COUNTED, 0), **want}


def on_tuned(launches: dict) -> bool:
    """A bf16 path at head dim 64 or 32: each tuned kernel launched, no
    other flash kernel."""
    return (all(launches.get(k, 0) > 0 for k in TUNED)
            and not any(launches.get(k, 0) for k in B128 + ANY))


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device ms per call of ``fn``: CUDA events around ``iters`` calls
    queued behind a busy-wait kernel that outlasts their launches, so the
    events time the device, not the host (a 0.04 ms kernel is shorter
    than one launch from Python on a slow host)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    hold_ms = 2e3 * (time.perf_counter() - t0) + 1.0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    # the busy-wait's rate in cycles per ms, on this card now
    start.record()
    torch.cuda._sleep(10_000_000)
    stop.record()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(hold_ms * 10_000_000 / start.elapsed_time(stop)))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def compare(got, ref, tol=(RTOL, ATOL, FLOOR)) -> dict:
    """max |got - ref| and its worst ratio to rtol*|ref| + atol*rms_row(ref)
    + floor*rms(ref) (``tol``; ok when <= 1), with where it is and max|ref|
    for the record."""
    rtol, atol, floor = tol
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    rms_row = ref.square().mean(-1, keepdim=True).sqrt()
    rms = ref.square().mean().sqrt()
    ratio = diff / (rtol * ref.abs() + atol * rms_row + floor * rms)
    worst = ratio.argmax().item()
    at = list(torch.unravel_index(torch.tensor(worst), ratio.shape))
    r = ratio.flatten()[worst].item()
    return {"max_abs_err": diff.max().item(), "worst_ratio": r,
            "worst_at": [int(i) for i in at],
            "worst_ref": ref.flatten()[worst].item(),
            "worst_got": got.flatten()[worst].item(),
            "ref_absmax": ref.abs().max().item(),
            "ok": math.isfinite(r) and r <= 1.0}


def rel_err(got, ref) -> float:
    """||got - ref|| / ||ref|| over the whole tensor."""
    got, ref = got.float(), ref.float()
    return ((got - ref).norm() / ref.norm()).item()


def ptxas_report(build) -> list:
    """ptxas' register and spill lines for each source (and its C75xx notes
    of wgmma serialized or waits injected), beside the register budget
    that ``setmaxnreg`` gives each warpgroup role where the source sets one
    (ptxas reports the count at the kernel's entry only), read from the
    source and the headers it includes."""
    out = []
    for log in sorted(build.build_dir().glob("*.log")):
        text = log.read_text()
        src = (build.CSRC / f"{log.stem}.cu").read_text()
        src += "".join((build.CSRC / h).read_text() for h in
                       re.findall(r'#include "([^"]+)"', src))
        roles = {role.lower(): {"setmaxnreg": int(n)} for role, n in
                 re.findall(r"constexpr int k(Producer|Consumer)Regs = (\d+);",
                            src)}
        out.append({
            "source": f"{log.stem}.cu",
            "lines": [ln.strip() for ln in text.splitlines()
                      if "registers" in ln or "spill" in ln
                      or "setmaxnreg" in ln or "(C75" in ln],
            "roles": roles or None,
            "spill_bytes": sum(int(a) + int(b) for a, b in re.findall(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)),
            "wgmma_notes": sorted(set(re.findall(r"\(C751[78]\)", text)))})
    return out


def by_heads(fn, xs, kw: dict, head_chunk: int = 0):
    """``fn(*xs, **kw)`` on all heads, or ``head_chunk`` at a time (each
    head's attention is its own, so that [b, h, s, s] scores fit on the
    card at a long ``s``): [b, s, h, d] tensors cut and joined on dim 2,
    [b, h, s] ones on dim 1."""
    if not head_chunk:
        return fn(*xs, **kw)
    h = xs[0].shape[2]
    parts = [fn(*(x[:, :, h0:h0 + head_chunk] if x.dim() == 4
                  else x[:, h0:h0 + head_chunk] for x in xs), **kw)
             for h0 in range(0, h, head_chunk)]
    return tuple(torch.cat(p, dim=2 if p[0].dim() == 4 else 1)
                 for p in zip(*parts)) if isinstance(parts[0], tuple) \
        else torch.cat(parts, dim=2)


def head_chunk_for(b: int, s: int, h: int) -> int:
    """Heads a slice of the plain versions at this shape: their [b, heads,
    s, s] fp32 scores under 2 GiB (0: all heads at once)."""
    chunk = max(1, (2 << 30) // (b * s * s * 4))
    return 0 if chunk >= h else chunk


def check_kernels(*, s: int, window: int, timed: bool, causal: bool = True,
                  case: str = "", b: int = MAIN["b"], h: int = MAIN["h"],
                  d: int = MAIN["d"], dtype=torch.bfloat16,
                  head_chunk: int = 0) -> dict:
    """The flash kernels of the shape's route (``flash.route``): B1-B3, or
    the bf16_128 or ``_any`` ones with ``ANY_TOL``, the FFMA-peak bound
    and the split's reach beside, against their plain versions on one
    shape; timed, each kernel's ms beside its plain
    version's, SDPA's in the same dtype and its bound: bytes over the
    card's rate or FLOPs over the bf16 peak, or the TF32 peak for fp32 (a
    redesign's reach).  ``head_chunk`` runs the plain versions on that
    many heads at a time (each head's attention is its own), so that their
    [b, h, s, s] scores fit on the card at a long ``s``; untimed only."""
    from portbench.roofline import H100_BF16_FLOPS, bound, visible_pairs
    from tpujob_torch.workloads import flash

    fwd_k, dq_k_fn, dkv_k_fn = flash.launch_fwd, flash.launch_dq, \
        flash.launch_dkv
    route = flash.route(dtype, d)
    names = [flash.kernel_name(k, route) for k in flash.KINDS]
    tuned = route == "tuned"
    tol = (RTOL, ATOL, FLOOR) if tuned else ANY_TOL[dtype]
    lse_tol = LSE_TOL if tuned else ANY_LSE_TOL
    gen = torch.Generator(device=DEVICE).manual_seed(1234 + s + window)

    def rnd():
        return torch.randn(b, s, h, d, device=DEVICE, dtype=dtype,
                           generator=gen)

    q, k, v, do = rnd(), rnd(), rnd(), rnd()
    kw = dict(causal=causal, scale=d ** -0.5, window=window)
    case = case or f"s{s}" + (f"_w{window}" if window else "")

    def plain(fn, *xs):
        return by_heads(fn, xs, kw, head_chunk)

    o_k, lse_k = fwd_k(q, k, v, **kw)
    o_r, lse_r = plain(flash.flash_forward_ref, q, k, v)
    delta = flash.attention_delta(o_r, do)
    dq_k = dq_k_fn(q, k, v, do, lse_r, delta, **kw)
    dq_r = plain(flash.flash_dq_ref, q, k, v, do, lse_r, delta)
    dk_k, dv_k = dkv_k_fn(q, k, v, do, lse_r, delta, **kw)
    dk_r, dv_r = plain(flash.flash_dkv_ref, q, k, v, do, lse_r, delta)
    torch.cuda.synchronize()
    e_l = (lse_k - lse_r).abs().max().item()
    c_o, c_dq = compare(o_k, o_r, tol), compare(dq_k, dq_r, tol)
    c_dk, c_dv = compare(dk_k, dk_r, tol), compare(dv_k, dv_r, tol)
    out = {
        names[0]: dict(c_o, lse_err=e_l, lse_tol=lse_tol,
                       ok=c_o["ok"] and e_l <= lse_tol),
        names[1]: c_dq,
        names[2]: {"max_abs_err": max(c_dk["max_abs_err"],
                                      c_dv["max_abs_err"]),
                   "dk": c_dk, "dv": c_dv, "ok": c_dk["ok"] and c_dv["ok"]},
    }
    ok = all(r["ok"] for r in out.values())
    if timed:
        pairs = b * h * visible_pairs(s, s, causal, window)
        qkv = q.numel() * q.element_size()
        rows = b * h * s * 4  # one fp32 per row (lse or delta)
        shapes = dict(zip(names, [(4 * qkv + rows, 4 * d * pairs),
                                  (5 * qkv + 2 * rows, 6 * d * pairs),
                                  (6 * qkv + 2 * rows, 8 * d * pairs)]))
        ms = dict(zip(names, [
            time_ms(lambda: fwd_k(q, k, v, **kw)),
            time_ms(lambda: dq_k_fn(q, k, v, do, lse_r, delta, **kw)),
            time_ms(lambda: dkv_k_fn(q, k, v, do, lse_r, delta, **kw))]))
        # the plain versions by heads where their scores need it, timed
        # over fewer calls there (seconds each)
        its = dict(iters=1, warmup=1) if head_chunk else dict(iters=5)
        plain_ms = dict(zip(names, [
            time_ms(lambda: plain(flash.flash_forward_ref, q, k, v), **its),
            time_ms(lambda: plain(flash.flash_dq_ref, q, k, v, do, lse_r,
                                  delta), **its),
            time_ms(lambda: plain(flash.flash_dkv_ref, q, k, v, do, lse_r,
                                  delta), **its)]))
        bwd_ms = time_ms(lambda: (
            dq_k_fn(q, k, v, do, lse_r, delta, **kw),
            dkv_k_fn(q, k, v, do, lse_r, delta, **kw)))
        peak = H100_TF32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS
        lib = library_ms(q, k, v, do, causal, window)
        backward = {"kernels": names[1:], "ms": bwd_ms,
                    "library_ms": lib.get("flash_dq"),
                    "library_fn": lib.get("fn_flash_dq")}
        for name, base in zip(names, TUNED):
            nbytes, flops = shapes[name]
            bms, by = bound(nbytes, flops, peak)
            out[name].update(ms=ms[name], plain_ms=plain_ms[name],
                             bound_ms=bms, bound_by=by, bytes=nbytes,
                             flops=flops, tflops=flops / ms[name] / 1e9,
                             bound_share=bms / ms[name],
                             library_ms=lib.get(base),
                             library_fn=lib.get("fn_" + base))
            if not tuned:
                out[name]["ffma_bound_ms"] = flops / H100_FP32_FLOPS * 1e3
                out[name]["split_reach_ms"] = bound(
                    nbytes, flops * SPLIT_PASSES[dtype][base], peak)[0]
    emit({"phase": "kernel", "case": case, "shape": [b, s, h, d],
          "dtype": str(dtype).replace("torch.", ""), "causal": causal,
          "window": window, "tol": list(tol), "ok": ok, "kernels": out,
          **({"backward": backward} if timed else {})})
    if not ok:
        raise AssertionError(f"kernel mismatch in case {case}: {out}")
    return out


def library_ms(q, k, v, do, causal: bool, window: int = 0) -> dict:
    """One PyTorch call computing the same function, as a yardstick only:
    scaled_dot_product_attention and its autograd backward, which computes
    dQ, dK and dV in one call.  A sliding window goes in as a boolean
    [s, s] mask (SDPA has no window of its own), which takes another of
    its backends than ``is_causal``."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    kw = dict(is_causal=causal)
    if window:
        s = q.shape[1]
        pos = torch.arange(s, device=q.device)
        gap = pos[:, None] - pos[None, :]
        kw = dict(attn_mask=(gap >= 0) & (gap < window))
    fwd = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw))
    out = F.scaled_dot_product_attention(qt, kt, vt, **kw)
    bwd = time_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True))
    how = (f"is_causal={causal}" if not window else
           f"attn_mask=the causal band of {window} keys")
    return {"flash_fwd": fwd, "flash_dq": bwd, "flash_dkv": bwd,
            "fn_flash_fwd": f"F.scaled_dot_product_attention({how})",
            "fn_flash_dq": "its backward (dq, dk, dv in one call)",
            "fn_flash_dkv": "its backward (dq, dk, dv in one call)"}


def compare_models(phase: str, build, loss_of, argv: list,
                   logits_shape: tuple) -> None:
    """A 2-layer full-width model on the card: flash attention (kernels)
    against dense attention (torch) on the same weights (the same seed):
    logits, loss, and each parameter's gradient by normwise error."""
    out = {}
    for attn in ("dense", "flash"):
        model, batch = build(argv + ["--attention", attn])
        loss = loss_of(model)(batch)
        loss.backward()
        with torch.no_grad():
            logits = model(batch[0])
        out[attn] = (logits.float(), loss.item(),
                     {n: p.grad.float() for n, p in model.named_parameters()})
    (ld, lossd, gd), (lf, lossf, gf) = out["dense"], out["flash"]
    e_logits = rel_err(lf, ld)
    # The key bias's exact gradient is 0 (adding q.b to every score of a
    # row leaves its softmax unchanged), so both sides hold rounding noise
    # only: hold its norm to MODEL_TOL x the query bias's instead.
    zero = [n for n in gd if n.endswith("attn.key.bias")]
    grad_errs = {n: rel_err(gf[n], gd[n]) for n in gd if n not in zero}
    worst = max(grad_errs, key=grad_errs.get)
    key_bias = max(max(gf[n].norm().item(), gd[n].norm().item())
                   / gd[n.replace(".key.", ".query.")].norm().item()
                   for n in zero)
    finite = bool(torch.isfinite(lf).all()) and math.isfinite(lossf)
    ok = (finite and e_logits <= MODEL_TOL and abs(lossf - lossd) <= 2e-2
          and grad_errs[worst] <= MODEL_TOL and key_bias <= MODEL_TOL
          and tuple(lf.shape) == logits_shape)
    emit({"phase": phase, "ok": ok, "logits_shape": list(lf.shape),
          "logits_rel_err": e_logits, "rel_tol": MODEL_TOL,
          "loss_flash": lossf, "loss_dense": lossd, "loss_tol": 2e-2,
          "grad_rel_err_worst": grad_errs[worst], "grad_worst_param": worst,
          "grad_rel_err_median": sorted(grad_errs.values())[
              len(grad_errs) // 2],
          "key_bias_grad_norm_over_query_bias": key_bias})
    if not ok:
        raise AssertionError(f"{phase}: flash disagrees with dense on the card")


def kernels_by_op(prof) -> list:
    """Each device kernel of a profile under the ``aten::`` op that
    launched it (the nearest on the host's stack): ``[op, kernel,
    launches, device ms]``, the most time first."""
    rows = {}
    for evt in prof.events():
        for k in getattr(evt, "kernels", None) or ():
            op = evt
            while op is not None and not op.name.startswith("aten::"):
                op = op.cpu_parent
            key = (op.name if op is not None else evt.name, k.name[:90])
            n, us = rows.get(key, (0, 0.0))
            rows[key] = (n + 1, us + k.duration)
    return sorted(([op, name, n, us / 1e3] for (op, name), (n, us)
                   in rows.items()), key=lambda r: -r[3])


def run_adamw() -> dict:
    """Phase ``adamw``: AdamW's update at GPT-2-medium's and BERT-large's
    parameter sets (the trainers' own models, default flags), each
    parameter and gradient drawn once, in ``train_lib.adamw``'s two groups
    at lr 1e-4: the port's kernel (``optim.AdamW``, ``csrc/adamw.cu``)
    against torch's capturable foreach route (the port's update before it)
    and ``fused=True`` (``torch._fused_adamw_``), each from the same
    start.  Every route's ``step`` timed by ``time_ms`` beside the byte
    bound (28 bytes a parameter); after the same count of updates the
    kernel's parameters within ADAMW_ULPS of foreach's (in ulps of
    max(|foreach's|, ADAMW_FLOOR), as tests/test_torch_adamw.py); then the
    kernel's launches alone timed (the step counts' advance left out).
    One eager step of each route under torch.profiler: its kernels by the
    op that launched them, and its peak memory above the state's."""
    from torch.profiler import ProfilerActivity, profile

    from portbench.roofline import bound
    from tpujob_torch.workloads import bert as tbert
    from tpujob_torch.workloads import gpt as tgpt
    from tpujob_torch.workloads import optim, train_lib

    dev = torch.device(DEVICE)
    out = {}
    for name, module in (("gpt2-medium", tgpt), ("bert-large", tbert)):
        args = module.build_parser().parse_args(["--device", DEVICE])
        shapes = [p.shape for p in module.build_model(args, dev).parameters()]
        torch.cuda.empty_cache()
        n = sum(math.prod(s) for s in shapes)
        gen = torch.Generator(device=dev).manual_seed(0)
        init = [torch.randn(s, generator=gen, device=dev) for s in shapes]
        grads = [torch.randn(s, generator=gen, device=dev) for s in shapes]
        routes, row = {}, {"parameters": n, "tensors": len(shapes)}
        for route in ("kernel", "foreach", "fused"):
            params = [torch.nn.Parameter(t.clone()) for t in init]
            for p, g in zip(params, grads):
                p.grad = g
            opt = train_lib.adamw(params, 1e-4)
            if route != "kernel":
                opt = torch.optim.AdamW(
                    [{k: g[k] for k in ("params", "weight_decay", "lr")}
                     for g in opt.param_groups],
                    capturable=True, **({"foreach": True}
                                        if route == "foreach"
                                        else {"fused": True}))
            opt.step()  # the state; the kernel built
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                opt.step()
                torch.cuda.synchronize()
            row[route] = {
                "temp_peak_mib": (torch.cuda.max_memory_allocated() - base)
                / 2 ** 20,
                "kernels": kernels_by_op(prof)[:12],
                "ms": time_ms(opt.step)}
            routes[route] = (params, opt)
        params, opt = routes["kernel"]
        for route in ("foreach", "fused"):
            ref = routes[route][0]
            row[route]["kernel_ulps"] = max(
                float(((p.detach() - q.detach()).abs()
                      / _ulp(q.detach(), ADAMW_FLOOR)).max())
                for p, q in zip(params, ref))
        lists = []
        for group in opt.param_groups:
            p, g, m, v, steps = [], [], [], [], []
            opt._init_group(group, p, g, m, v, [], steps)
            lists.append((group, p, g, m, v, steps))
        row["kernel"]["launches_ms"] = time_ms(
            lambda: [optim.launch(*a) for a in lists])
        row["bound_ms"], _ = bound(28 * n, 0)
        for route in ("kernel", "foreach", "fused"):
            row[route]["bound_share"] = row["bound_ms"] / row[route]["ms"]
        row["kernel"]["launches_bound_share"] = (
            row["bound_ms"] / row["kernel"]["launches_ms"])
        out[name] = row
        del routes, params, opt, lists, init, grads
        torch.cuda.empty_cache()
    ok = all(r["foreach"]["kernel_ulps"] <= ADAMW_ULPS for r in out.values())
    emit({"phase": "adamw", "ok": ok, "ulps_max": ADAMW_ULPS,
          "floor": ADAMW_FLOOR, "device": smi_line(), **out})
    if not ok:
        raise AssertionError("the AdamW kernel left foreach's parameters")
    return out


# the dropless expert layer's grouped products at the Mellum2 cell's shapes:
# rows = batch 2 x seq 8192 x top-8, hidden 2304, expert width 896, 64 experts
MOE_GEMM_SHAPE = dict(rows=131072, hidden=2304, width=896, experts=64)
MOE_GEMM_ZIPF = 1.0  # expert e's share of the rows ~ 1 / (e + 1)
MOE_GEMM_RTOL = 1e-2  # normwise, bf16 outputs against fp32 products
# Mellum2-12B-A2.5B's block through gpt.run: one period at published widths
MELLUM_STEPS = 6
MELLUM_ARGV = ["--attention", "flash", "--block", "pre_rms", "--hidden",
               "2304", "--layers", "4", "--heads", "32", "--kv-heads", "4",
               "--head-dim", "128", "--vocab", "12288", "--seq-len", "8192",
               "--batch-size", "2", "--steps", str(MELLUM_STEPS),
               "--position", "rope", "--rope-theta", "500000",
               "--attention-pattern", "SSSF", "--attention-window", "1024",
               "--yarn-factor", "16", "--yarn-original-positions", "8192",
               "--untied-head", "--moe-experts", "64", "--moe-k", "8",
               "--moe-expert-width", "896"]


def zipf_counts(rows: int, experts: int, exponent: float) -> torch.Tensor:
    """Per-expert row counts summing to ``rows``, expert e's share
    proportional to (e + 1)^-exponent; the largest remainders rounded up."""
    w = [(e + 1) ** -exponent for e in range(experts)]
    exact = [rows * x / sum(w) for x in w]
    counts = [int(x) for x in exact]
    for e in sorted(range(experts), key=lambda e: counts[e] - exact[e])[
            : rows - sum(counts)]:
        counts[e] += 1
    return torch.tensor(counts)


def run_moe_gemm() -> dict:
    """Phase ``moe_gemm``: the three grouped-GEMM kernels
    (``workloads/moe_gemm.py``) at the Mellum2 cell's shapes, both products
    of a layer (``[R, h] x [E, h, 2f]``, ``[R, f] x [E, f, h]``), on rows
    split over the experts by a Zipf law (``MOE_GEMM_ZIPF``) and evenly.
    Each kernel timed by ``time_ms`` beside its roofline bound (each input
    read once, each output written once; 989 TFLOP/s bf16), its plain
    version (``moe_gemm.gemm_ref`` and friends: fp32 products one expert at
    a time; its offsets read on the host, so host time is in it), a loop
    of bf16 cuBLAS products one expert at a time, and ``torch._grouped_mm``
    where this torch has it (a yardstick only: the port never calls it);
    each kernel's normwise error against fp32 products of the same bf16
    inputs."""
    from portbench.roofline import bound
    from tpujob_torch.workloads import moe_gemm

    dev = torch.device(DEVICE)
    sh = MOE_GEMM_SHAPE
    rows, h, f, e_count = sh["rows"], sh["hidden"], sh["width"], sh["experts"]
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"shape": sh, "zipf": MOE_GEMM_ZIPF}
    ok = True
    for split, exponent in (("zipf", MOE_GEMM_ZIPF), ("even", 0.0)):
        counts = zipf_counts(rows, e_count, exponent)
        g = moe_gemm.groups(counts.to(dev))
        spans = [(e, int(lo), int(hi)) for e, (lo, hi) in enumerate(
            zip(g.offsets[:-1].tolist(), g.offsets[1:].tolist()))]
        row = {"largest_group": int(counts.max()),
               "smallest_group": int(counts.min())}
        for name, k_dim, n_dim in (("w1", h, 2 * f), ("w2", f, h)):
            a = torch.randn(rows, k_dim, device=dev, generator=gen).bfloat16()
            w = (torch.randn(e_count, k_dim, n_dim, device=dev, generator=gen)
                 / k_dim ** 0.5).bfloat16()
            grad = torch.randn(rows, n_dim, device=dev, generator=gen).bfloat16()
            flops = 2 * rows * k_dim * n_dim
            elem = 2
            io = {"fwd": (rows * k_dim + e_count * k_dim * n_dim + rows * n_dim) * elem,
                  "dx": (rows * n_dim + e_count * k_dim * n_dim + rows * k_dim) * elem,
                  "dw": (rows * k_dim + rows * n_dim) * elem + e_count * k_dim * n_dim * 4}
            kernels = {"fwd": lambda: moe_gemm.gemm(a, w, g),
                       "dx": lambda: moe_gemm.gemm_t(grad, w, g),
                       "dw": lambda: moe_gemm.gemm_dw(a, grad, g, e_count)}
            plains = {"fwd": lambda: moe_gemm.gemm_ref(a, w, g),
                      "dx": lambda: moe_gemm.gemm_t_ref(grad, w, g),
                      "dw": lambda: moe_gemm.gemm_dw_ref(a, grad, g, e_count)}
            loops = {
                "fwd": lambda: [a[lo:hi] @ w[e] for e, lo, hi in spans],
                "dx": lambda: [grad[lo:hi] @ w[e].T for e, lo, hi in spans],
                "dw": lambda: [a[lo:hi].T @ grad[lo:hi] for e, lo, hi in spans]}
            ends = g.offsets[1:].contiguous()
            library = {
                "fwd": lambda: torch._grouped_mm(a, w, offs=ends),
                "dx": lambda: torch._grouped_mm(grad, w.transpose(1, 2),
                                                offs=ends),
                "dw": lambda: torch._grouped_mm(a.T, grad, offs=ends)}
            for kind in ("fwd", "dx", "dw"):
                got = kernels[kind]()
                if kind == "fwd":
                    want = torch.cat([a[lo:hi].float() @ w[e].float()
                                      for e, lo, hi in spans])
                elif kind == "dx":
                    want = torch.cat([grad[lo:hi].float() @ w[e].float().T
                                      for e, lo, hi in spans])
                else:
                    want = torch.stack([a[lo:hi].float().T @ grad[lo:hi].float()
                                        for e, lo, hi in spans])
                err = rel_err(got, want)
                del got, want
                bound_ms, by = bound(io[kind], flops)
                ms = time_ms(kernels[kind], iters=10)
                cell = {"ms": ms, "bound_ms": bound_ms, "bound_by": by,
                        "bound_share": bound_ms / ms,
                        "tflops": flops / ms / 1e9,
                        "rel_err": err,
                        "plain_ms": time_ms(plains[kind], iters=3, warmup=1),
                        "cublas_loop_ms": time_ms(loops[kind], iters=5)}
                if hasattr(torch, "_grouped_mm"):
                    try:
                        cell["torch_grouped_mm_ms"] = time_ms(library[kind],
                                                              iters=10)
                    except Exception as exc:  # a yardstick only
                        cell["torch_grouped_mm_ms"] = f"{type(exc).__name__}: {exc}"[:200]
                ok = ok and err <= MOE_GEMM_RTOL
                row[f"{name}_{kind}"] = cell
            del a, w, grad
            torch.cuda.empty_cache()
        out[split] = row
    emit({"phase": "moe_gemm", "ok": ok, "rtol": MOE_GEMM_RTOL,
          "device": smi_line(), **out})
    if not ok:
        raise AssertionError("a grouped-GEMM kernel left the fp32 products")
    return out


def run_mellum_steps() -> dict:
    """Path ``mellum``: ``MELLUM_STEPS`` steps of Mellum2's block through
    ``gpt.run`` (``MELLUM_ARGV``), the launch counts set to 0 just before:
    the captured step, the bf16_128 route's flash kernels at head dim 128
    (2 forwards with remat, a dQ and a dK/dV a layer) and the grouped
    GEMMs (2 forwards of each product with remat, a dX and a dW), no other
    flash kernel, AdamW on the kernel.  Returns the launches by kernel."""
    from tpujob_torch.workloads import gpt, optim

    args = gpt.build_parser().parse_args(MELLUM_ARGV + [
        "--dir", tempfile.mkdtemp(prefix="mellum_"), "--device", DEVICE])
    reset_launches()
    t0 = time.perf_counter()
    result = gpt.run(args)
    seconds = time.perf_counter() - t0
    launches = kernel_launches()
    n, layers = args.steps, args.layers
    want = launched({"flash_fwd_bf16_128": 2 * layers * n,
                     "flash_dq_bf16_128": layers * n,
                     "flash_dkv_bf16_128": layers * n,
                     "moe_gemm_fwd": 4 * layers * n,
                     "moe_gemm_dx": 2 * layers * n,
                     "moe_gemm_dw": 2 * layers * n})
    ok = (result["step_mode"] == "graph" and launches == want
          and optim.UPDATES["torch"] == 0 and optim.UPDATES["kernel"] > 0
          and all(map(math.isfinite, result["losses"])))
    torch.cuda.empty_cache()
    emit({"phase": "mellum", "ok": ok, "argv": MELLUM_ARGV,
          "step_mode": result["step_mode"], "launches": launches,
          "want": want, "adamw_tensors": dict(optim.UPDATES),
          "losses": result["losses"], "moe_metrics": result["moe_metrics"],
          "tokens_per_s": result["tokens_per_sec"], "seconds": seconds})
    if not ok:
        raise AssertionError(f"the Mellum2 steps missed their kernels: "
                             f"{launches} against {want}, mode "
                             f"{result['step_mode']}, AdamW "
                             f"{optim.UPDATES}")
    return launches


def moe_gemm_rows(cases: dict, by_path: dict) -> list:
    """The grouped-GEMM kernels' rows of the ``kernels`` line: each
    kernel's times at the first product of a layer on Zipf groups (``ms``,
    ``plain_ms``, ``bound_ms``, ``library_ms``: ``torch._grouped_mm``),
    every case of ``run_moe_gemm`` under ``cases``, and its launches on
    each path (the main path: ``mellum``)."""
    rows = []
    for kind in ("fwd", "dx", "dw"):
        name = f"moe_gemm_{kind}"
        per = {f"{split}_{w}": cases[split][f"{w}_{kind}"]
               for split in ("zipf", "even") for w in ("w1", "w2")}
        m = per["zipf_w1"]
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "bound_share",
                "tflops", "rel_err", "cublas_loop_ms", "torch_grouped_mm_ms")
        rows.append({"name": f"tpujob_{name}", "route": "cuda",
                     "source": "tpujob_torch/csrc/moe_gemm.cu",
                     "replaces": "none: tpujob/workloads/parallel.py:moe_ffn "
                                 "dispatches by dense one-hot einsums",
                     "main_path": "mellum",
                     "launches": by_path["mellum"][name],
                     **{k: m[k] for k in keys if k != "torch_grouped_mm_ms"},
                     "library_ms": m.get("torch_grouped_mm_ms"),
                     "library_fn": "torch._grouped_mm",
                     "cases": {c: {k: r.get(k) for k in keys}
                               for c, r in per.items()},
                     "paths": [p for p, n in by_path.items()
                               if n.get(name, 0) > 0],
                     "launches_by_path": {p: n.get(name, 0)
                                          for p, n in by_path.items()}})
    return rows


def _ulp(x, floor: float = 0.0):
    """One unit in the last place of max(|x|, floor), elementwise."""
    scale = torch.clamp(x.abs(), min=floor)
    return torch.nextafter(scale, torch.full_like(scale, math.inf)) - scale


def check_model() -> None:
    """A 2-layer full-width GPT (causal flash)."""
    from tpujob_torch.workloads import bert as bertlib
    from tpujob_torch.workloads import distributed, gpt

    def build(argv):
        args = gpt.build_parser().parse_args(argv)
        ids, _, _ = bertlib.token_batches(args, distributed.process_env({}))
        return (gpt.build_model(args, torch.device(DEVICE)),
                (bertlib.batch_to_device(ids, DEVICE),))

    compare_models("model", build, gpt.lm_loss,
                   ["--layers", "2", "--seq-len", "256", "--batch-size", "2",
                    "--device", DEVICE], (2, 256, 50257))


def check_model_bert() -> None:
    """A 2-layer full-width BERT (non-causal flash) on the MLM loss, with
    the mask ``bert.run`` draws."""
    import numpy as np

    from tpujob_torch.workloads import bert as bertlib
    from tpujob_torch.workloads import distributed

    def build(argv):
        args = bertlib.build_parser().parse_args(argv)
        ids, _, _ = bertlib.token_batches(args, distributed.process_env({}))
        _, mask = bertlib.mask_batch(np.zeros_like(ids), args.seed)
        return (bertlib.build_model(args, torch.device(DEVICE)),
                (bertlib.batch_to_device(ids, DEVICE),
                 torch.from_numpy(mask).to(DEVICE)))

    compare_models("model_bert", build, bertlib.mlm_loss,
                   ["--layers", "2", "--seq-len", "512", "--batch-size", "2",
                    "--device", DEVICE], (2, 512, 30522))


def device_ms_by_class(prof, steps: int) -> tuple:
    """Kernel time per step from a profile, by class, and the twelve
    kernels with the most time (ms per step, launches per step)."""
    from portbench.kernels import kernel_class

    by_class, by_name = {}, {}
    for evt in prof.key_averages():
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue  # kernels only: an annotation range spans kernels
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        cls = kernel_class(evt.key)
        by_class[cls] = by_class.get(cls, 0.0) + us / 1e3 / steps
        by_name[evt.key[:90]] = (us / 1e3 / steps, evt.count / steps)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return by_class, top


def trace_kernels(path: str, steps: int) -> dict:
    """Device time a step from a Chrome trace of ``steps`` steps (the
    ``--profile-dir`` output): kernel ms by class, the busiest kernels, and
    the share of the kernels' span (first start to last end) in which the
    device ran one."""
    from portbench.kernels import kernel_class

    with open(path) as f:
        kernels = [e for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"]
    if not kernels:
        raise AssertionError(f"{path}: no kernel in the trace")
    by_class, by_name = {}, {}
    for e in kernels:
        ms = e["dur"] / 1e3 / steps
        cls = kernel_class(e["name"])
        by_class[cls] = by_class.get(cls, 0.0) + ms
        t, n = by_name.get(e["name"][:90], (0.0, 0.0))
        by_name[e["name"][:90]] = (t + ms, n + 1 / steps)
    busy = sum(by_class.values())
    span = (max(e["ts"] + e["dur"] for e in kernels)
            - min(e["ts"] for e in kernels)) / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"device_ms_per_step": by_class, "device_busy_ms_per_step": busy,
            "kernel_span_ms_per_step": span,
            "device_busy_share_of_span": busy / span,
            "top_kernels_ms_launches_per_step": top}


def profiled_run(module, argv: list, warmup: int, timed: int,
                 profiled: int) -> dict:
    """``module.run`` through its flag surface for ``warmup + timed +
    profiled`` steps, launches counted from 0.  A hook after each step
    waits for the card and stamps the host clock.  The ``timed`` steps
    after the warm-up, unprofiled, give the end-to-end rate (all tokens
    over all the window's time); the last ``profiled`` steps run under
    torch.profiler (CUDA activity) and give device time by kernel class
    and the device's busy share of those same steps."""
    steps = warmup + timed + profiled
    args = module.build_parser().parse_args(argv + ["--steps", str(steps)])
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    stamps, prof_t0 = [], []

    def on_step(i: int) -> None:
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        if i == warmup + timed - 1:
            prof.start()
            prof_t0.append(time.perf_counter())

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    try:
        res = module.run(args, on_step=on_step)  # ends with the card synced
    finally:
        if prof_t0:
            prof.stop()
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    tokens = args.batch_size * args.seq_len
    a0, a1 = stamps[warmup - 1], stamps[warmup + timed - 1]
    step_ms = [(y - x) * 1e3 for x, y in zip(stamps[warmup - 1:],
                                             stamps[warmup:])]
    timed_ms = step_ms[:timed]
    quart = statistics.quantiles(timed_ms, n=4)
    by_class, top = device_ms_by_class(prof, profiled)
    busy_ms = sum(by_class.values())
    host_ms = (a1 - a0) * 1e3 / timed
    return {
        "res": res, "args": args, "steps": steps, "launches": launches,
        "wall_s": wall, "window_steps": timed,
        "window_tokens_per_sec": timed * tokens / (a1 - a0),
        "window_step_ms_mean": host_ms,
        "window_step_ms_median": statistics.median(timed_ms),
        "window_step_ms_q1_q3": [quart[0], quart[2]],
        "step_ms_all": step_ms,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        "device_ms_per_step": by_class, "device_busy_ms_per_step": busy_ms,
        "host_over_device_busy": host_ms / busy_ms if busy_ms > 0
        else math.inf,
        "profiled_host_step_ms": (stamps[-1] - prof_t0[0]) * 1e3 / profiled,
        "top_kernels_ms_launches_per_step": top}


def run_train() -> dict:
    """The main path: GPT-2-medium through gpt.run, launches counted; the
    rate over TIMED_STEPS, the profile over PROFILED_STEPS
    (``profiled_run``)."""
    from tpujob_torch.workloads import gpt

    logdir = os.path.join("build", "chip_smoke", "train")
    shutil.rmtree(logdir, ignore_errors=True)
    argv = ["--attention", "flash", "--batch-size", "8", "--log-interval",
            "1", "--seed", "0", "--dir", logdir, "--device", DEVICE]
    r = profiled_run(gpt, argv, WARMUP_STEPS, TIMED_STEPS, PROFILED_STEPS)
    res, steps, launches = r["res"], r["steps"], r["launches"]
    losses = res["losses"]
    busy_ms, host_over_busy = (r["device_busy_ms_per_step"],
                               r["host_over_device_busy"])
    ok = (len(losses) == steps and all(math.isfinite(x) for x in losses)
          and losses[-1] < losses[0] and on_tuned(launches)
          and busy_ms > 0 and res["step_mode"] == "graph"
          and host_over_busy <= HOST_OVER_BUSY_MAX)
    n_params = sum(p.numel() for p in res["state"]["model"].parameters())
    emit({"phase": "train", "ok": ok, "argv": argv + ["--steps", str(steps)],
          "params": n_params, "step_mode": res["step_mode"],
          "losses": losses, "window_steps": TIMED_STEPS,
          "window_tokens_per_sec": r["window_tokens_per_sec"],
          "window_step_ms_mean": r["window_step_ms_mean"],
          "device_busy_ms_per_step": busy_ms,
          "host_over_device_busy": host_over_busy,
          "host_over_device_busy_max": HOST_OVER_BUSY_MAX,
          "window_step_ms_median": r["window_step_ms_median"],
          "window_step_ms_q1_q3": r["window_step_ms_q1_q3"],
          "step_ms_all": r["step_ms_all"],
          "trainer_tokens_per_sec_all_steps": res["tokens_per_sec"],
          "wall_s": r["wall_s"], "peak_mem_gb": r["peak_mem_gb"],
          "launches": launches,
          "launches_per_step": {k: n / steps for k, n in launches.items()}})
    emit({"phase": "profile", "steps": PROFILED_STEPS,
          "step_mode": res["step_mode"],
          "host_step_ms": r["profiled_host_step_ms"],
          "device_ms_per_step": r["device_ms_per_step"],
          "device_busy_ms_per_step": busy_ms,
          "device_busy_share": busy_ms / r["profiled_host_step_ms"],
          "top_kernels_ms_launches_per_step":
          r["top_kernels_ms_launches_per_step"]})
    if not ok:
        raise AssertionError(f"main path failed: losses {losses}, "
                             f"launches {launches}, busy {busy_ms} ms, "
                             f"mode {res['step_mode']}, host ms over busy "
                             f"{host_over_busy}")
    return launches


def step_stats(stamps: list, first: int) -> dict:
    """Per-step host ms from the stamps after step ``first - 1`` on."""
    ms = [(y - x) * 1e3 for x, y in zip(stamps[first - 1:], stamps[first:])]
    quart = statistics.quantiles(ms, n=4)
    return {"step_ms_median": statistics.median(ms),
            "step_ms_q1_q3": [quart[0], quart[2]], "step_ms_all": ms}


@contextmanager
def causal_flags():
    """Record the ``causal`` argument of every kernel launch, by kernel
    (the wrappers still launch and count as before); a kernel that did not
    launch has no entry."""
    from tpujob_torch.workloads import flash

    seen = {}
    originals = {kind: getattr(flash, f"launch_{kind}")
                 for kind in flash.KINDS}

    def recording(kind):
        def wrapper(q, *args, **kw):
            name = flash.kernel_name(kind, flash.route(q.dtype, q.shape[-1]))
            seen.setdefault(name, set()).add(kw["causal"])
            return originals[kind](q, *args, **kw)
        return wrapper

    for kind in originals:
        setattr(flash, f"launch_{kind}", recording(kind))
    try:
        yield seen
    finally:
        for kind, fn in originals.items():
            setattr(flash, f"launch_{kind}", fn)


def run_mlm() -> dict:
    """The second path: BERT-large masked LM through bert.run, launches
    counted and each launch's mask recorded."""
    from tpujob_torch.workloads import bert

    logdir = os.path.join("build", "chip_smoke", "mlm")
    shutil.rmtree(logdir, ignore_errors=True)
    argv = ["--attention", "flash", "--batch-size", "8", "--steps",
            str(MLM_STEPS), "--log-interval", "1", "--seed", "0", "--dir",
            logdir, "--device", DEVICE]
    args = bert.build_parser().parse_args(argv)
    stamps = []

    def on_step(i: int) -> None:
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with causal_flags() as seen:
        res = bert.run(args, on_step=on_step)
    launches = kernel_launches()
    losses = res["losses"]
    ok = (len(losses) == MLM_STEPS and all(math.isfinite(x) for x in losses)
          and losses[-1] < losses[0] and on_tuned(launches)
          and all(v == {False} for v in seen.values())
          and res["step_mode"] == "graph")
    n_params = sum(p.numel() for p in res["state"]["model"].parameters())
    emit({"phase": "mlm", "ok": ok, "argv": argv, "params": n_params,
          "step_mode": res["step_mode"], "losses": losses,
          "trainer_tokens_per_sec": res["tokens_per_sec"],
          "wall_s": res["wall_s"], **step_stats(stamps, WARMUP_STEPS),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
          "launches": launches,
          "launches_per_step": {k: n / MLM_STEPS for k, n in launches.items()},
          "causal_flags": {k: sorted(v) for k, v in seen.items()}})
    if not ok:
        raise AssertionError(f"mlm path failed: losses {losses}, launches "
                             f"{launches}, causal flags {seen}, mode "
                             f"{res['step_mode']}")
    return launches


def run_fp32() -> dict:
    """The _any kernels' path: GPT-2-medium in fp32 (``--no-bf16
    --attention flash``) through gpt.run, captured, launches counted from
    0; its step-1 loss against one step at ``--attention dense`` in fp32
    from the same seed (TF32 off for matrix products and convolutions);
    then a 2-layer GPT at head dim 128 in bf16, and a 2-layer GPT at head
    dim 256 in fp32 against one dense fp32 step.  Tokens/s and ms a step
    over the timed steps, peak memory."""
    import gc

    from tpujob_torch.workloads import gpt

    gc.collect()
    torch.cuda.empty_cache()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    logdir = os.path.join("build", "chip_smoke", "fp32")
    shutil.rmtree(logdir, ignore_errors=True)
    steps = FP32_WARMUP + FP32_TIMED
    stamps = []

    def on_step(i: int) -> None:
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    def parse(argv, n):
        return gpt.build_parser().parse_args(
            argv + ["--steps", str(n), "--device", DEVICE, "--dir", logdir])

    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        res = gpt.run(parse(FP32_ARGV, steps), on_step=on_step)
        launches = kernel_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        n_params = sum(p.numel() for p in res["state"]["model"].parameters())
        del res["state"]
        gc.collect()
        torch.cuda.empty_cache()
        dense_argv = [("dense" if a == "flash" else a) for a in FP32_ARGV]
        reset_launches()
        dense = gpt.run(parse(dense_argv, 1))
        dense_launches = kernel_launches()
        del dense["state"]
        gc.collect()
        torch.cuda.empty_cache()
        reset_launches()
        d128 = gpt.run(gpt.build_parser().parse_args(
            FP32_D128_ARGV + ["--device", DEVICE, "--dir", logdir]))
        d128_launches = kernel_launches()
        d128_head_dim = d128["state"]["model"].layer_0.attn.d
        del d128["state"]
        gc.collect()
        torch.cuda.empty_cache()
        d256 = fp32_d256(parse)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    losses = res["losses"]
    loss_rel = abs(losses[0] - dense["losses"][0]) / abs(dense["losses"][0])
    ms = [(y - x) * 1e3 for x, y in zip(stamps[FP32_WARMUP - 1:],
                                       stamps[FP32_WARMUP:])]
    tokens = flag(FP32_ARGV, "--batch-size") * 1024
    layers = 24

    def finite_falling(xs, n):
        return (len(xs) == n and all(math.isfinite(x) for x in xs)
                and xs[-1] < xs[0])

    checks = {
        "losses": finite_falling(losses, steps),
        "captured": res["step_mode"] == "graph",
        "launches": launches == launched({
            "flash_fwd_any": 2 * layers * steps,
            "flash_dq_any": layers * steps,
            "flash_dkv_any": layers * steps}),
        "dense_launches": dense_launches == launched({}),
        "step1_vs_dense": loss_rel <= FP32_LOSS_RTOL,
        "d128_losses": finite_falling(d128["losses"], FP32_D128_STEPS),
        "d128_head_dim": d128_head_dim == 128,
        "d128_launches": d128_launches == launched({
            "flash_fwd_bf16_128": 4 * FP32_D128_STEPS,
            "flash_dq_bf16_128": 2 * FP32_D128_STEPS,
            "flash_dkv_bf16_128": 2 * FP32_D128_STEPS}),
        # every one of them on the bf16 head-dim-128 kernels
        "d128_route": (all(d128_launches[k] for k in B128)
                       and not any(d128_launches[k] for k in ANY)),
        **{"d256_" + k: v for k, v in d256.pop("checks").items()},
    }
    ok = all(checks.values())
    emit({"phase": "fp32", "ok": ok, "checks": checks, "argv": FP32_ARGV,
          "params": n_params, "step_mode": res["step_mode"],
          "losses": losses, "dense_step1_loss": dense["losses"][0],
          "step1_rel_diff": loss_rel, "step1_rtol": FP32_LOSS_RTOL,
          "launches": launches,
          "window_tokens_per_sec": FP32_TIMED * tokens * 1e3 / sum(ms),
          "step_ms_median": statistics.median(ms), "step_ms_all": ms,
          "peak_mem_gb": peak_gb, "d128_argv": FP32_D128_ARGV,
          "d128_losses": d128["losses"], "d128_launches": d128_launches,
          "d128_step_mode": d128["step_mode"], "d256": d256})
    if not ok:
        raise AssertionError(f"fp32 phase failed: {checks}")
    return launches


def fp32_d256(parse) -> dict:
    """The fp32 head-dim-256 path: FP32_D256_ARGV through gpt.run (``parse``
    adds the steps, device and log dir), captured, launches counted from
    0, then one step of the same seed at ``--attention dense``; the caller
    has turned TF32 off."""
    import gc

    from tpujob_torch.workloads import gpt

    steps = FP32_D256_WARMUP + FP32_D256_TIMED
    stamps = []

    def on_step(i: int) -> None:
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = gpt.run(parse(FP32_D256_ARGV, steps), on_step=on_step)
    launches = kernel_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    model = res.pop("state")["model"]
    head_dim = model.layer_0.attn.d
    n_params = sum(p.numel() for p in model.parameters())
    del model
    gc.collect()
    torch.cuda.empty_cache()
    reset_launches()
    dense = gpt.run(parse([("dense" if a == "flash" else a)
                           for a in FP32_D256_ARGV], 1))
    dense_launches = kernel_launches()
    del dense["state"]
    gc.collect()
    torch.cuda.empty_cache()
    losses = res["losses"]
    loss_rel = abs(losses[0] - dense["losses"][0]) / abs(dense["losses"][0])
    ms = [(y - x) * 1e3 for x, y in zip(stamps[FP32_D256_WARMUP - 1:],
                                       stamps[FP32_D256_WARMUP:])]
    layers = flag(FP32_D256_ARGV, "--layers")
    return {
        "checks": {
            "losses": (len(losses) == steps
                       and all(math.isfinite(x) for x in losses)
                       and losses[-1] < losses[0]),
            "captured": res["step_mode"] == "graph",
            "head_dim": head_dim == 256,
            "launches": launches == launched({
                "flash_fwd_any": 2 * layers * steps,
                "flash_dq_any": layers * steps,
                "flash_dkv_any": layers * steps}),
            "dense_launches": dense_launches == launched({}),
            "step1_vs_dense": loss_rel <= FP32_LOSS_RTOL},
        "argv": FP32_D256_ARGV, "params": n_params, "losses": losses,
        "dense_step1_loss": dense["losses"][0], "step1_rel_diff": loss_rel,
        "launches": launches, "step_mode": res["step_mode"],
        "window_tokens_per_sec": (FP32_D256_TIMED
                                  * flag(FP32_D256_ARGV, "--batch-size")
                                  * 1024 * 1e3 / sum(ms)),
        "step_ms_median": statistics.median(ms), "step_ms_all": ms,
        "peak_mem_gb": peak_gb}


def chosen_within_tol(logits, out, first: int) -> float:
    """The worst (row max - chosen token's logit) / rms(row) over the
    generated positions of ``out``, token j chosen from row j - 1."""
    rows = logits[:, first - 1 : -1].float()
    chosen = torch.gather(rows, -1, out[:, first:, None])[..., 0]
    gap = rows.amax(-1) - chosen
    return (gap / rows.square().mean(-1).sqrt()).max().item()


def run_decode(p: int, new: int) -> dict:
    """The serving path: gpt.run --generate through the entry point, then
    both decode routes on the trained model from a prompt of ``p`` tokens,
    ``new`` tokens each, launches counted per route."""
    from tpujob_torch.workloads import bert as bertlib
    from tpujob_torch.workloads import distributed, gpt

    logdir = os.path.join("build", "chip_smoke", "decode")
    shutil.rmtree(logdir, ignore_errors=True)
    b = DECODE_BATCH
    argv = ["--attention", "flash", "--batch-size", str(b),
            "--steps", "1", "--generate", "32", "--seed", "0", "--dir",
            logdir, "--device", DEVICE]
    args = gpt.build_parser().parse_args(argv)
    reset_launches()
    res = gpt.run(args)
    entry = kernel_launches()  # one training step; the decode adds none
    gen = res["generated"]
    layers = args.layers
    entry_ok = (tuple(gen.shape) == (1, 8 + 32)
                and bool(((gen >= 0) & (gen < args.vocab)).all())
                and entry == launched({"flash_fwd": 2 * layers,
                                       "flash_dq": layers,
                                       "flash_dkv": layers}))

    model = res["state"]["model"]
    ids, _, _ = bertlib.token_batches(args, distributed.process_env({}))
    prompt = bertlib.batch_to_device(ids[:, :p], DEVICE)
    routes, launches = {}, {}
    for name, fn in (("cached", gpt.generate_cached), ("full", gpt.generate)):
        # warm-up (allocator, library heuristics) from a short prompt: the
        # cached route's prefill is one forward a prompt token
        fn(model, prompt[:, :16], 2)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = fn(model, prompt, new)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches[name] = kernel_launches()
        routes[name] = {"out": out, "tokens_per_sec": b * new / sec,
                        "ms_per_new_token": sec * 1e3 / new}

    # the check: one teacher-forced forward over each route's output by the
    # same weights with dense attention (plain torch, no kernel), so that
    # neither route is held to the attention that chose its tokens
    ref = gpt.build_model(argparse.Namespace(**{**vars(args),
                                                "attention": "dense"}),
                          torch.device(DEVICE))
    ref.load_state_dict(model.state_dict())
    checks = {}
    with torch.no_grad():
        for name, r in routes.items():
            logits = ref(r["out"])
            checks[name] = {"chosen_gap_over_rms": chosen_within_tol(
                logits, r["out"], p)}
            if name == "cached":
                # the cached route's own logits over the same sequence
                cache = model.new_cache(b, p + new)
                steps = []
                for i in range(p + new - 1):
                    lg, cache = model(r["out"][:, i : i + 1], cache=cache)
                    steps.append(lg[:, 0])
                checks[name]["vs_dense_rel_err"] = rel_err(
                    torch.stack(steps, 1), logits[:, :-1])
            else:
                # the full route's flash forward (B1 at the buffer's shape)
                checks[name]["vs_dense_rel_err"] = rel_err(
                    model(r["out"]), logits)
    del ref
    agree = (routes["cached"]["out"][:, p:]
             == routes["full"]["out"][:, p:]).float().mean().item()
    ok = (entry_ok
          and launches["cached"] == launched({})
          and launches["full"] == launched({"flash_fwd": new * layers})
          and all(torch.equal(r["out"][:, :p], prompt)
                  for r in routes.values())
          and all(c["chosen_gap_over_rms"] <= MODEL_TOL
                  and c["vs_dense_rel_err"] <= MODEL_TOL
                  for c in checks.values()))
    emit({"phase": "decode", "ok": ok, "argv": argv,
          "entry_generated": gen[0].tolist(), "entry_launches": entry,
          "batch": b, "prompt": p, "new_tokens": new,
          "routes": {name: {k: v for k, v in r.items() if k != "out"}
                     for name, r in routes.items()},
          "launches": launches, "checks": checks, "tol": MODEL_TOL,
          "token_agreement_share": agree})
    if not ok:
        raise AssertionError(f"decode path failed: entry {entry}, launches "
                             f"{launches}, checks {checks}")
    return launches["full"]


def moe_dispatch_cost(args) -> dict:
    """One MoE layer at the phase's shapes on the card (bf16 x and expert
    weights, fp32 router, random from a seed): ``moe_ffn`` forward, and
    forward + backward (against a random cotangent), beside the routing
    and the dense one-hot dispatch/combine tensors alone (``moe_route`` +
    ``dispatch_combine``, the backward through combine's gates); device ms
    from ``time_ms``, and the bytes of the fp32 [b, k*s, E, cap] one-hot
    product that the dense form materialises."""
    from tpujob_torch.workloads import parallel

    b, s, d, f = (args.batch_size, args.seq_len, args.hidden,
                  args.intermediate)
    e, k, cf = args.moe_experts, args.moe_k, args.moe_capacity_factor
    cap = parallel.moe_capacity(s, e, k, cf)
    gen = torch.Generator(device=DEVICE).manual_seed(11)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, device=DEVICE, generator=gen) * scale
                ).to(dtype).requires_grad_()

    x, router = rnd(b, s, d), rnd(d, e, scale=0.02, dtype=torch.float32)
    wi, wo = rnd(e, d, f, scale=d ** -0.5), rnd(e, f, d, scale=f ** -0.5)
    dy = torch.randn(b, s, d, device=DEVICE, generator=gen).to(x.dtype)
    dc = torch.randn(b, s, e, cap, device=DEVICE, generator=gen).to(x.dtype)

    def ffn():
        return parallel.moe_ffn(x, router, wi, wo, k=k, capacity_factor=cf)[0]

    def route():
        r = parallel.moe_route(x, router, k, cap)
        return parallel.dispatch_combine(r, cap, x.dtype)[1]

    with torch.no_grad():
        ffn_fwd, route_fwd = time_ms(ffn, iters=10), time_ms(route, iters=10)
    ffn_all = time_ms(lambda: torch.autograd.grad(
        ffn(), (x, router, wi, wo), dy), iters=10)
    route_all = time_ms(lambda: torch.autograd.grad(
        route(), (x, router), dc, allow_unused=True), iters=10)
    return {"shape": {"b": b, "s": s, "d": d, "f": f, "experts": e, "k": k,
                      "capacity": cap},
            "one_hot_product_bytes": b * k * s * e * cap * 4,
            "ffn_fwd_ms": ffn_fwd, "ffn_fwd_bwd_ms": ffn_all,
            "route_dispatch_fwd_ms": route_fwd,
            "route_dispatch_fwd_bwd_ms": route_all,
            "route_dispatch_share_fwd_bwd": route_all / ffn_all}


def run_moe(p: int, new: int) -> dict:
    """The sparse MoE path (``--moe-experts 8``, top-2, one card): (a)
    GPT-2-medium at full width and depth through ``gpt.run``, captured,
    with its rate, profile, aux terms and dropped assignments each step;
    (d) decode on that model; (b) eager against captured at 2 layers; (c)
    BERT-large MLM at 8 layers.  The flash launches of (a)."""
    import gc

    from tpujob_torch.workloads import bert as bertlib
    from tpujob_torch.workloads import distributed, gpt

    logdir = os.path.join("build", "chip_smoke", "moe")
    shutil.rmtree(logdir, ignore_errors=True)
    argv = MOE_ARGV + ["--dir", os.path.join(logdir, "gpt"),
                       "--device", DEVICE]
    r = profiled_run(gpt, argv, MOE_WARMUP, MOE_TIMED, MOE_PROFILED)
    res, args, steps = r["res"], r["args"], r["steps"]
    model = res["state"]["model"]
    layers, losses, aux = args.layers, res["losses"], res["moe_metrics"]
    want = launched({"flash_fwd": 2 * layers * steps,
                     "flash_dq": layers * steps,
                     "flash_dkv": layers * steps})
    assignments = layers * args.batch_size * args.seq_len * args.moe_k
    checks = {
        "mode": res["step_mode"] == "graph",
        "losses": len(losses) == steps
        and all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
        "aux": len(aux) == steps and all(
            math.isfinite(v) for m in aux for v in m.values()),
        "launches": r["launches"] == want,
        "busy": r["device_busy_ms_per_step"] > 0,
    }
    emit({"phase": "moe", "part": "gpt", "ok": all(checks.values()),
          "checks": checks, "argv": argv + ["--steps", str(steps)],
          "params": sum(q.numel() for q in model.parameters()),
          "step_mode": res["step_mode"], "losses": losses,
          "aux_by_step": aux,
          "dropped_share_by_step": [m["dropped"] / assignments for m in aux],
          "assignments_per_step": assignments,
          **{k: r[k] for k in (
              "window_steps", "window_tokens_per_sec", "window_step_ms_mean",
              "window_step_ms_median", "window_step_ms_q1_q3",
              "device_busy_ms_per_step", "host_over_device_busy",
              "device_ms_per_step", "profiled_host_step_ms",
              "top_kernels_ms_launches_per_step", "step_ms_all", "wall_s",
              "peak_mem_gb", "launches")},
          "launches_per_step": {k: n / steps
                                for k, n in r["launches"].items()}})
    if not all(checks.values()):
        raise AssertionError(f"moe gpt failed: {checks}")
    launches = r["launches"]
    res["state"].pop("opt")
    del r, res
    gc.collect()
    torch.cuda.empty_cache()

    # (d) decode on the trained model, the full route (the cached one falls
    # back to it); the mask's checks on a copy at a tight capacity
    b, total = DECODE_BATCH, p + new
    ids, _, _ = bertlib.token_batches(args, distributed.process_env({}))
    prompt = bertlib.batch_to_device(ids[:b, :p], DEVICE)
    gpt.generate(model, prompt[:, :16], 2)  # warm-up
    torch.cuda.synchronize()
    routes, route_launches = {}, {}
    for name, fn in (("full", gpt.generate), ("cached", gpt.generate_cached)):
        reset_launches()
        t0 = time.perf_counter()
        routes[name] = fn(model, prompt, new)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        route_launches[name] = kernel_launches()
        route_launches[name]["ms_per_new_token"] = sec * 1e3 / new
    tight_args = argparse.Namespace(**{
        **vars(args), "moe_capacity_factor": MOE_DECODE_CF})
    with torch.device("meta"):  # the weights come from the trained model
        tight = gpt.build_model(tight_args, "meta")
    tight.to_empty(device=DEVICE).load_state_dict(model.state_dict())
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    pads = [torch.zeros(b, new, dtype=torch.long, device=DEVICE),
            torch.randint(0, args.vocab, (b, new), device=DEVICE,
                          generator=gen)]
    bufs = [torch.cat([prompt, pad], 1) for pad in pads]
    valid = (torch.arange(total, device=DEVICE) < p).float().expand(b, total)
    with torch.no_grad():
        masked = [tight(x, valid=valid)[:, :p].float() for x in bufs]
        raw = [tight(x)[:, :p].float() for x in bufs]
    rms = masked[0].square().mean().sqrt().item()
    masked_diff = (masked[0] - masked[1]).abs().max().item()
    raw_diff = (raw[0] - raw[1]).abs().max().item()
    del tight, masked, raw
    dchecks = {
        # true by construction while generate_cached falls back to
        # generate for a MoE model: it holds the fallback in place
        "routes_equal": torch.equal(routes["full"], routes["cached"]),
        "prompt_kept": torch.equal(routes["full"][:, :p], prompt),
        "in_vocab": bool(((routes["full"] >= 0)
                          & (routes["full"] < args.vocab)).all()),
        "full_launches": {k: route_launches["full"][k] for k in want}
        == launched({"flash_fwd": new * layers}),
        "masked_suffix_invariant": masked_diff <= MOE_SUFFIX_MAX * rms,
        "unmasked_suffix_sensitive": raw_diff > MOE_SUFFIX_MIN * rms,
    }
    emit({"phase": "moe", "part": "decode", "ok": all(dchecks.values()),
          "checks": dchecks, "batch": b, "prompt": p, "new_tokens": new,
          "layers": layers, "capacity_factor_tight": MOE_DECODE_CF,
          "masked_max_abs_diff": masked_diff, "unmasked_max_abs_diff": raw_diff,
          "logits_rms": rms, "routes": route_launches,
          "generated_row0": routes["full"][0].tolist()})
    if not all(dchecks.values()):
        raise AssertionError(f"moe decode failed: {dchecks}")
    del model, routes
    gc.collect()
    torch.cuda.empty_cache()

    # (b) eager against captured, bit for bit
    eager = graph_run("moe", gpt, MOE_GRAPH_ARGV, False, gpt_leaves)
    graph = graph_run("moe", gpt, MOE_GRAPH_ARGV, True, gpt_leaves)
    two = launched({"flash_fwd": 4 * MOE_GRAPH_STEPS,
                    "flash_dq": 2 * MOE_GRAPH_STEPS,
                    "flash_dkv": 2 * MOE_GRAPH_STEPS})
    gchecks = {
        "modes": [eager["step_mode"], graph["step_mode"]] == ["eager", "graph"],
        "bit_equal": bit_equal(eager, graph),
        "launches": eager["launches"] == graph["launches"] == two,
    }
    emit({"phase": "moe", "part": "graph", "ok": all(gchecks.values()),
          "checks": gchecks, "argv": MOE_GRAPH_ARGV,
          "runs": {mode: {k: v for k, v in x.items()
                          if k not in ("digest", "stats")}
                   for mode, x in (("eager", eager), ("graph", graph))}})
    if not all(gchecks.values()):
        raise AssertionError(f"moe graph failed: {gchecks}")
    del eager, graph

    # (c) the MLM, every launch without the mask
    margv = MOE_MLM_ARGV + ["--dir", os.path.join(logdir, "mlm"),
                            "--device", DEVICE]
    stamps = []

    def on_step(i: int) -> None:
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with causal_flags() as seen:
        mres = bertlib.run(bertlib.build_parser().parse_args(margv),
                           on_step=on_step)
    mlaunches = kernel_launches()
    mlosses, maux = mres["losses"], mres["moe_metrics"]
    mlayers = flag(MOE_MLM_ARGV, "--layers")
    mchecks = {
        "mode": mres["step_mode"] == "graph",
        "losses": len(mlosses) == MOE_MLM_STEPS
        and all(math.isfinite(x) for x in mlosses)
        and mlosses[-1] < mlosses[0],
        "aux": all(math.isfinite(v) for m in maux for v in m.values()),
        "launches": mlaunches == launched({
            "flash_fwd": 2 * mlayers * MOE_MLM_STEPS,
            "flash_dq": mlayers * MOE_MLM_STEPS,
            "flash_dkv": mlayers * MOE_MLM_STEPS}),
        "non_causal": all(v == {False} for v in seen.values()),
    }
    emit({"phase": "moe", "part": "mlm", "ok": all(mchecks.values()),
          "checks": mchecks, "argv": margv, "layers": mlayers,
          "params": sum(q.numel() for q in
                        mres["state"]["model"].parameters()),
          "step_mode": mres["step_mode"], "losses": mlosses,
          "aux_by_step": maux,
          "trainer_tokens_per_sec": mres["tokens_per_sec"],
          "wall_s": mres["wall_s"], **step_stats(stamps, 2),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
          "launches": mlaunches})
    if not all(mchecks.values()):
        raise AssertionError(f"moe mlm failed: {mchecks}")
    del mres
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "moe", "part": "dispatch", **moe_dispatch_cost(args)})
    return launches


def write_corpus(directory: str) -> str:
    """The ``.py`` and ``.md`` files under ``tpujob/`` and ``docs/``, in
    sorted path order, as one file in ``directory``."""
    files = sorted((p for top in ("tpujob", "docs")
                    for p in (ROOT / top).rglob("*")
                    if p.suffix in (".py", ".md") and p.is_file()),
                   key=lambda p: p.relative_to(ROOT).as_posix())
    path = os.path.join(directory, "corpus.txt")
    with open(path, "wb") as out:
        for p in files:
            out.write(p.read_bytes())
    return path


@contextmanager
def copied_batches():
    """Record the host arrays of every batch ``train_lib.put_batch`` copies
    to the card (the copy still happens as before)."""
    from tpujob_torch.workloads import train_lib

    seen, put = [], train_lib.put_batch

    def recording(arrays, device):
        seen.append([a.copy() for a in arrays])
        return put(arrays, device)

    train_lib.put_batch = recording
    try:
        yield seen
    finally:
        train_lib.put_batch = put


def corpus_run(name: str, module, argv: list, expected_batch) -> dict:
    """One trainer on the corpus through its entry point: launches counted
    from zero, each launch's mask recorded, every step's copied batch
    held against ``expected_batch(args, step)``."""
    logdir = os.path.join("build", "chip_smoke", "corpus_" + name)
    shutil.rmtree(logdir, ignore_errors=True)
    argv = argv + ["--steps", str(CORPUS_STEPS), "--log-interval", "1",
                   "--seed", "0", "--dir", logdir, "--device", DEVICE]
    args = module.build_parser().parse_args(argv)
    stamps = []

    def on_step(i: int) -> None:
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with causal_flags() as seen, copied_batches() as copied:
        res = module.run(args, on_step=on_step)
    launches = kernel_launches()
    steps = copied[-CORPUS_STEPS:]
    stream_ok = len(steps) == CORPUS_STEPS and all(
        len(got) == len(want) and all(
            g.shape == w.shape and (g == w).all() for g, w in zip(got, want))
        for i, got in enumerate(steps)
        for want in [expected_batch(args, i)])
    losses = res["losses"]
    return {"argv": argv, "step_mode": res["step_mode"], "losses": losses,
            "trainer_tokens_per_sec": res["tokens_per_sec"],
            "wall_s": res["wall_s"], **step_stats(stamps, 2),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
            "stream_ok": stream_ok,
            "distinct_step_batches": len({bytes(b[0]) for b in steps}),
            "finite": len(losses) == CORPUS_STEPS
            and all(math.isfinite(x) for x in losses),
            "launches": launches,
            "causal_flags": {k: sorted(v) for k, v in seen.items()}}


def run_corpus() -> dict:
    """GPT-2-medium on BPE tokens and BERT-large on raw bytes, from one
    corpus, a new batch every step."""
    import numpy as np

    from tpujob_torch.workloads import bert, data, gpt
    from tpujob_torch.workloads import tokenizer as toklib

    tmp = tempfile.mkdtemp(prefix="chip_smoke_corpus_")
    try:
        corpus = write_corpus(tmp)
        with open(corpus, "rb") as f:
            head = f.read(CORPUS_TOKENIZER_BYTES)
        t0 = time.perf_counter()
        tok = toklib.BPETokenizer.train(head, CORPUS_VOCAB,
                                        max_bytes=CORPUS_TOKENIZER_BYTES)
        train_s = time.perf_counter() - t0
        tok_path = os.path.join(tmp, "tok.json")
        tok.save(tok_path)
        # encode once into the token cache; gpt.run then maps the cache
        t0 = time.perf_counter()
        chunks = data.bpe_token_dataset(corpus, 1024, tok)
        encode_s = time.perf_counter() - t0

        # what each step must copy, written out here rather than taken from
        # the trainers' own provider: global rows (arange(0, B) + i*B) % n of
        # the chunks and, for the MLM, a 15% mask drawn from seed + i
        def rows(table, args, step):
            b = args.batch_size
            idx = (np.arange(0, b) + step * b) % len(table)
            return np.asarray(table[idx], dtype=np.int32)

        def gpt_batch(args, step):
            table = data.bpe_token_dataset(corpus, args.seq_len, tok)
            return [rows(table, args, step)]

        def bert_batch(args, step):
            raw = np.fromfile(corpus, dtype=np.uint8)
            n = len(raw) // args.seq_len
            table = raw[: n * args.seq_len].reshape(n, args.seq_len)
            rng = np.random.RandomState(args.seed + step)
            mask = (rng.rand(args.batch_size, args.seq_len) < 0.15).astype(
                np.float32)
            return [rows(table, args, step), mask]

        runs = {
            "gpt_bpe": corpus_run("gpt", gpt, CORPUS_GPT_ARGV + [
                "--data-file", corpus, "--tokenizer", f"bpe:{tok_path}"],
                gpt_batch),
            "bert_bytes": corpus_run("bert", bert, CORPUS_BERT_ARGV + [
                "--data-file", corpus], bert_batch),
        }
        corpus_bytes = os.path.getsize(corpus)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want_causal = {"gpt_bpe": [True], "bert_bytes": [False]}
    ok = all(r["stream_ok"] and r["finite"] and r["step_mode"] == "graph"
             and r["distinct_step_batches"] == CORPUS_STEPS
             and on_tuned(r["launches"])
             and all(v == want_causal[name]
                     for v in r["causal_flags"].values())
             for name, r in runs.items())
    emit({"phase": "corpus", "ok": ok, "corpus_bytes": corpus_bytes,
          "tokenizer_vocab": tok.vocab_size,
          "tokenizer_train_bytes": len(head), "tokenizer_train_s": train_s,
          "encode_s": encode_s, "bpe_chunks_1024": len(chunks),
          "bpe_bytes_per_token": corpus_bytes / (len(chunks) * 1024),
          "runs": runs})
    if not ok:
        raise AssertionError(f"corpus path failed: {runs}")
    total = {}
    for r in runs.values():
        for k, n in r["launches"].items():
            total[k] = total.get(k, 0) + n
    return total


def run_mnist() -> None:
    """The MNIST example through its entry point, default flags."""
    from tpujob_torch.workloads import mnist

    logdir = os.path.join("build", "chip_smoke", "mnist")
    shutil.rmtree(logdir, ignore_errors=True)
    argv = MNIST_ARGV + ["--dir", logdir, "--device", DEVICE]
    args = mnist.build_parser().parse_args(argv)
    res = mnist.run(args)
    ok = (res["accuracy"] > 0.9 and math.isfinite(res["final_loss"])
          and res["step_mode"] == "graph")
    emit({"phase": "mnist", "ok": ok, "argv": argv,
          "step_mode": res["step_mode"],
          "dataset": res["dataset"], "accuracy": res["accuracy"],
          "final_loss": res["final_loss"], "samples": res["samples"],
          "wall_s": res["wall_s"],
          "samples_per_sec": res["samples"] / res["wall_s"],
          "steps": res["state"]["step"]})
    if not ok:
        raise AssertionError(f"mnist path failed: accuracy "
                             f"{res['accuracy']}, mode {res['step_mode']}")


def run_resnet() -> None:
    """ResNet-50 through its entry point: warm-up, then timed steps."""
    from tpujob_torch.workloads import resnet

    logdir = os.path.join("build", "chip_smoke", "resnet")
    shutil.rmtree(logdir, ignore_errors=True)
    argv = RESNET_ARGV + ["--dir", logdir, "--device", DEVICE]
    args = resnet.build_parser().parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    res = resnet.run(args)
    losses = res["losses"]
    model = res["state"]["model"]
    ok = (len(losses) == args.warmup_steps + args.steps
          and all(math.isfinite(x) for x in losses)
          and losses[-1] < losses[0] and res["step_mode"] == "graph")
    emit({"phase": "resnet", "ok": ok, "argv": argv,
          "step_mode": res["step_mode"],
          "params": sum(p.numel() for p in model.parameters()),
          "losses": losses, "samples_per_sec": res["samples_per_sec"],
          "timed_steps": args.steps, "wall_s": res["wall_s"],
          "step_ms_mean": res["wall_s"] * 1e3 / args.steps,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
          "channels_last": model.conv_init.weight.is_contiguous(
              memory_format=torch.channels_last)})
    if not ok:
        raise AssertionError(f"resnet path failed: losses {losses}, mode "
                             f"{res['step_mode']}")

    # a second run through the entry point's --profile-dir, traced from the
    # first step after the warm-up: the device's time a step against the
    # unprofiled step above says whether the card or the host sets the rate
    prof_dir = os.path.join(logdir, "profile")
    pargv = argv + ["--steps", str(RESNET_PROFILED_STEPS + 1),
                    "--profile-dir", prof_dir, "--profile-start-step", "0",
                    "--profile-steps", str(RESNET_PROFILED_STEPS)]
    pres = resnet.run(resnet.build_parser().parse_args(pargv))
    trace = trace_kernels(
        os.path.join(prof_dir, f"trace_steps0-{RESNET_PROFILED_STEPS - 1}"
                               ".pt.trace.json"), RESNET_PROFILED_STEPS)
    emit({"phase": "resnet_profile", "argv": pargv,
          "step_mode": pres["step_mode"], "steps": RESNET_PROFILED_STEPS,
          "unprofiled_step_ms": res["wall_s"] * 1e3 / args.steps,
          "profiled_run_losses": pres["losses"], **trace})


@contextmanager
def logged(name: str):
    """The messages logged to ``name`` inside the block."""
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logger = logging.getLogger(name)
    logger.addHandler(handler)
    try:
        yield records
    finally:
        logger.removeHandler(handler)


def smoke_results(messages) -> list:
    return [m for m in messages if m.startswith("Result from participant")]


def flag(argv: list, name: str) -> int:
    return int(argv[argv.index(name) + 1])


def entry(module, argv: list, device: str, logdir: str,
          on_step=None) -> dict:
    """``module.run`` through its flag surface (``on_step`` after each
    step, where given)."""
    args = module.build_parser().parse_args(
        argv + ["--device", device, "--dir", logdir])
    return module.run(args) if on_step is None else module.run(
        args, on_step=on_step)


def gpt_step_ms(argv: list, device: str, logdir: str) -> tuple:
    """``gpt.run`` with a hook that syncs the card and stamps the host
    clock after each step: the losses, the ms of each step after the
    first, and the trained model's ``param_digest`` (its first and last
    layer and its final LayerNorm whole)."""
    from tpujob_torch.workloads import gpt, train_lib

    stamps = []

    def on_step(i: int) -> None:
        train_lib.sync(device)
        stamps.append(time.perf_counter())

    res = gpt.run(gpt.build_parser().parse_args(
        argv + ["--device", device, "--dir", logdir]), on_step=on_step)
    model = res["state"]["model"]
    # from the end of step 1 on: step 1 holds gpt.run's set-up (the model
    # built on the host from the seed)
    return (res["losses"], [(y - x) * 1e3 for x, y in zip(stamps, stamps[1:])],
            param_digest(model, gpt_leaves(model)))


def gpt_leaves(model) -> tuple:
    """The name prefixes of the transformer's first and last layer and of
    its final LayerNorm."""
    last = max(int(n.split(".")[0][len("layer_"):])
               for n, _ in model.named_parameters() if n.startswith("layer_"))
    return ("layer_0.", f"layer_{last}.", "ln_f.")


def param_digest(model, whole: tuple = ()) -> dict:
    """Every parameter's fp32 sum of |p|, and the parameters whose names
    start with one of ``whole`` whole (fp32, on the host): what the ranks
    of one data-parallel run must agree on bit for bit."""
    sums, leaves = {}, {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            sums[name] = p.float().abs().sum().item()
            if name.startswith(whole):
                leaves[name] = p.detach().to("cpu", torch.float32, copy=True)
    return {"abs_sums": sums, "leaves": leaves}


def update_err(got: dict, ref: dict, init: dict) -> float:
    """How far ``got``'s leaves lie from ``ref``'s, over how far training
    moved ``ref``'s from ``init``: ||got - ref|| / ||ref - init||."""
    num = sum(float(((got[k] - ref[k]) ** 2).sum()) for k in ref)
    den = sum(float(((ref[k] - init[k]) ** 2).sum()) for k in ref)
    return math.sqrt(num / den)


def running_stats(model) -> dict:
    return {k: v.float().cpu() for k, v in model.state_dict().items()
            if "running" in k}


def spawn_counted(fn, world: int, out_dir: str, plan: dict,
                  timeout_s: float) -> list:
    """``distributed.spawn_local``, each rank's AdamW updates
    (``adamw_updates``) added to this process's ``optim.UPDATES``, so a
    path's count holds its ranks' too."""
    from tpujob_torch.workloads import distributed, optim

    ranks = distributed.spawn_local(fn, world, out_dir, plan,
                                    timeout_s=timeout_s)
    for r in ranks:
        for k, n in r["adamw_updates"].items():
            optim.UPDATES[k] += n
    return ranks


def ddp_plan() -> dict:
    """What each rank runs, passed to it whole: a spawned rank imports
    this file anew."""
    return {"device": f"{DEVICE}:0" if DEVICE == "cuda" else DEVICE,
            "gpt": DDP_GPT_ARGV, "resnet": DDP_RESNET_ARGV,
            "mnist": DDP_MNIST_ARGV}


def ddp_rank(rank: int, out_dir: str, plan: dict) -> dict:
    """One rank of the ``ddp`` phase (``distributed.spawn_local``): the
    group over gloo on the card, then the smoke, GPT-2-medium, ResNet-50
    and MNIST through their entry points, logging under ``out_dir``; what
    the parent checks."""
    import datetime

    import torch.distributed as tdist

    from tpujob_torch.workloads import distributed as dist
    from tpujob_torch.workloads import mnist, optim, resnet, smoke_dist

    device = plan["device"]
    pe = dist.initialize(device=torch.device(device), backend="gloo",
                         timeout=datetime.timedelta(seconds=DDP_TIMEOUT_S // 2))
    out = {"rank": rank, "pe": [pe.process_id, pe.num_processes],
           "backend": tdist.get_backend()}
    with logged("tpujob_torch.smoke_dist") as messages:
        out["smoke_rc"] = smoke_dist.main(["--device", device])
    out["smoke_results"] = smoke_results(messages)
    logdir = os.path.join(out_dir, f"rank{rank}")

    reset_launches()
    losses, ms, digest = gpt_step_ms(plan["gpt"], device, logdir + "/gpt")
    out["gpt"] = {"losses": losses, "step_ms": ms,
                  "launches": kernel_launches(), "digest": digest}

    res = entry(resnet, plan["resnet"], device, logdir + "/resnet")
    out["resnet"] = {"losses": res["losses"],
                     "step_ms": res["wall_s"] * 1e3
                     / flag(plan["resnet"], "--steps"),
                     "stats": running_stats(res["state"]["model"]),
                     "digest": param_digest(res["state"]["model"])}
    del res

    rows, em = [], mnist.eval_metrics

    def counting(model, batch):
        rows.append(len(batch[1]))
        return em(model, batch)

    mnist.eval_metrics = counting
    res = entry(mnist, plan["mnist"], device, logdir + "/mnist")
    counted = torch.tensor([float(sum(rows))], device=device)
    tdist.all_reduce(counted)
    out["mnist"] = {"accuracy": res["accuracy"],
                    "final_loss": res["final_loss"],
                    "rows_tested": int(counted.item()),
                    "steps": res["state"]["step"], "wall_s": res["wall_s"]}
    dist.shutdown()
    out["adamw_updates"] = dict(optim.UPDATES)
    return out


def run_ddp() -> dict:
    """NCCL at world 1, then two gloo ranks on the card against the
    parent's one-process runs of the same seeds."""
    import gc

    from tpujob_torch.workloads import gpt, mnist, resnet, smoke_dist

    out_dir = os.path.join("build", "chip_smoke", "ddp")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    device = ddp_plan()["device"]
    with logged("tpujob_torch.smoke_dist") as messages:
        nccl_rc = smoke_dist.main(["--device", device])
    nccl_backend = [m for m in messages if "backend" in m]
    one_smoke = smoke_results(messages)

    # the one-process runs of the same seeds, then nothing of them kept
    # but what the checks read; the GPT's initial leaves from its seed
    model = gpt.build_model(gpt.build_parser().parse_args(
        DDP_GPT_ARGV + ["--device", "cpu"]), "cpu")
    init = param_digest(model, gpt_leaves(model))["leaves"]
    del model
    one_gpt, one_gpt_ms, one_digest = gpt_step_ms(
        DDP_GPT_ARGV, device, os.path.join(out_dir, "one_gpt"))
    res = entry(resnet, DDP_RESNET_ARGV, device,
                os.path.join(out_dir, "one_resnet"))
    one_resnet = {"losses": res["losses"],
                  "stats": running_stats(res["state"]["model"])}
    res = entry(mnist, DDP_MNIST_ARGV, device,
                os.path.join(out_dir, "one_mnist"))
    one_mnist = res["accuracy"]
    del res
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = spawn_counted(ddp_rank, DDP_WORLD, out_dir, ddp_plan(),
                          timeout_s=DDP_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    r0 = ranks[0]
    steps = flag(DDP_GPT_ARGV, "--steps")
    want_launches = launched({"flash_fwd": 48 * steps,
                              "flash_dq": 24 * steps,
                              "flash_dkv": 24 * steps})

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    names = sorted(one_resnet["stats"])
    stats_err = max(
        rel_err(torch.cat([r["resnet"]["stats"][k] for k in names]),
                torch.cat([one_resnet["stats"][k] for k in names]))
        for r in ranks)

    def equal(digests):
        return all(d["abs_sums"] == digests[0]["abs_sums"]
                   and all(torch.equal(v, digests[0]["leaves"][k])
                           for k, v in d["leaves"].items())
                   for d in digests)

    digests = [r["gpt"]["digest"] for r in ranks]
    gpt_update_err = [update_err(d["leaves"], one_digest["leaves"], init)
                      for d in digests]
    stats_equal = all(torch.equal(r["resnet"]["stats"][k],
                                  r0["resnet"]["stats"][k])
                      for r in ranks for k in r0["resnet"]["stats"])
    test_size = flag(DDP_MNIST_ARGV, "--test-size")
    checks = {
        "nccl_smoke": nccl_rc == 0 and any("backend nccl" in m
                                           for m in nccl_backend),
        "gloo_groups": all(r["backend"] == "gloo"
                           and r["pe"] == [i, DDP_WORLD]
                           for i, r in enumerate(ranks)),
        "smoke": all(r["smoke_rc"] == 0 for r in ranks)
        and r0["smoke_results"][0].split(":", 1)[1]
        == one_smoke[0].split(":", 1)[1],
        "gpt_losses": len(r0["gpt"]["losses"]) == steps
        and all(math.isfinite(x) for x in r0["gpt"]["losses"])
        and rel(r0["gpt"]["losses"], one_gpt) <= DDP_GPT_LOSS_RTOL,
        "gpt_launches": all(r["gpt"]["launches"] == want_launches
                            for r in ranks),
        "gpt_params_equal_across_ranks": equal(digests),
        "gpt_params_vs_one_process": max(gpt_update_err)
        <= DDP_GPT_UPDATE_RTOL,
        "resnet_losses": all(math.isfinite(x)
                             for x in r0["resnet"]["losses"])
        and rel(r0["resnet"]["losses"], one_resnet["losses"])
        <= DDP_RESNET_RTOL,
        "resnet_params_equal_across_ranks": equal(
            [r["resnet"]["digest"] for r in ranks]),
        "resnet_stats_equal_across_ranks": stats_equal,
        "resnet_stats_vs_one_process": stats_err <= DDP_RESNET_RTOL,
        "mnist": all(r["mnist"]["accuracy"] > 0.9
                     and r["mnist"]["rows_tested"] == test_size
                     for r in ranks)
        and abs(r0["mnist"]["accuracy"] - one_mnist) <= DDP_MNIST_ATOL,
    }
    ok = all(checks.values())
    emit({"phase": "ddp", "ok": ok, "checks": checks, "world": DDP_WORLD,
          "backend_two_ranks": "gloo (two ranks on one card; NCCL refuses)",
          "nccl_world1": nccl_backend, "spawn_s": spawn_s,
          "gpt": {"argv": DDP_GPT_ARGV, "losses_rank0": r0["gpt"]["losses"],
                  "losses_one_process": one_gpt,
                  "loss_rtol": DDP_GPT_LOSS_RTOL,
                  "max_rel_diff": rel(r0["gpt"]["losses"], one_gpt),
                  "launches_by_rank": [r["gpt"]["launches"] for r in ranks],
                  "leaves_compared": sorted(init),
                  "update_err_by_rank": gpt_update_err,
                  "update_rtol": DDP_GPT_UPDATE_RTOL,
                  "step_ms_by_rank": [r["gpt"]["step_ms"] for r in ranks],
                  "step_ms_one_process": one_gpt_ms},
          "resnet": {"argv": DDP_RESNET_ARGV,
                     "losses_rank0": r0["resnet"]["losses"],
                     "losses_one_process": one_resnet["losses"],
                     "max_rel_diff": rel(r0["resnet"]["losses"],
                                         one_resnet["losses"]),
                     "stats_rel_err_vs_one_process": stats_err,
                     "rtol": DDP_RESNET_RTOL,
                     "step_ms_by_rank": [r["resnet"]["step_ms"]
                                         for r in ranks]},
          "mnist": {"argv": DDP_MNIST_ARGV,
                    "by_rank": [r["mnist"] for r in ranks],
                    "accuracy_one_process": one_mnist},
          "times_note": "per-rank ms a step (GPT: steps 2-4; ResNet: the "
                        "timed steps) of two ranks sharing one card over "
                        "gloo, host copies included: a record, not a DDP "
                        "speed"})
    if not ok:
        raise AssertionError(f"ddp path failed: {checks}")
    return r0["gpt"]["launches"]


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at ``x`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


@contextmanager
def counted_collectives():
    """Count each collective made through ``torch.distributed`` inside the
    block into ``parallel.EXCHANGES`` (the bytes of its input), and under
    ``parallel.EXCHANGE_TIMING`` time it to its end with the card synced
    around it: what FSDP2's all-gathers and reduce-scatters cost a
    rank-step, which its own code does not count.  A collective one of
    these makes inside itself counts once."""
    import torch.distributed as tdist

    from tpujob_torch.workloads import parallel

    names = [n for n in ("all_gather_into_tensor", "all_gather_single",
                         "reduce_scatter_tensor", "reduce_scatter_single",
                         "all_reduce") if hasattr(tdist, n)]
    saved = {n: getattr(tdist, n) for n in names}
    inside = []

    def wrap(fn):
        def call(*a, **kw):
            if inside:
                return fn(*a, **kw)
            tensors = [v for v in (*a, *kw.values()) if torch.is_tensor(v)]
            inside.append(True)
            try:
                with parallel.counted(tensors[-1]):
                    work = fn(*a, **kw)
                    if work is not None and parallel.EXCHANGE_TIMING:
                        work.wait()
            finally:
                inside.pop()
            return work
        return call

    for n in names:
        setattr(tdist, n, wrap(saved[n]))
    try:
        yield
    finally:
        for n in names:
            setattr(tdist, n, saved[n])


def whole_leaves(model, mesh) -> dict:
    """The leaves ``update_err`` reads (``gpt_leaves``), gathered whole
    from this rank's shards (fp32, on the host); every rank of the mesh
    calls it together."""
    from tpujob_torch.workloads import parallel

    shards = parallel.ParamShards(mesh.group("tensor"), mesh.group("expert"))
    prefixes = gpt_leaves(model)
    return {n: shards.full(n, p).float() for n, p in model.named_parameters()
            if n.startswith(prefixes)}


def local_bytes(tensors) -> int:
    """The bytes this rank holds of ``tensors`` (a DTensor's local
    shard)."""
    return sum((t.to_local() if hasattr(t, "to_local") else t).numel()
               * t.element_size() for t in tensors)


def mesh_run(module, argv: list, device: str, logdir: str) -> dict:
    """``module.run`` through its flag surface, with launches counted from
    0, the card synced and the host clock stamped after each step, the
    exchanges counted and timed from the end of step 1 on
    (``parallel.EXCHANGE_TIMING``; under ``--fsdp`` FSDP's collectives
    too, ``counted_collectives``), and the leaves ``update_err`` reads
    (``gpt_leaves``, gathered whole) at the build and after step 1; and
    the bytes this rank holds of the parameters (and of the experts among
    them) and of AdamW's moments, its peak memory, the parameters it
    holds whole that a tensor or expert group would split none of, as it
    holds them, and a MoE run's aux terms and dropped assignments a
    step."""
    from tpujob_torch.workloads import bert, parallel, train_lib

    build, built, leaves = bert.build_model, [], {}

    def keep(*a, **kw):
        model = build(*a, **kw)
        built.append((model, kw["mesh"]))
        leaves["init"] = whole_leaves(model, kw["mesh"])
        return model

    stamps = []

    def on_step(i: int) -> None:
        train_lib.sync(device)
        stamps.append(time.perf_counter())
        if i == 0:
            leaves["step1"] = whole_leaves(*built[0])
            parallel.reset_exchanges()

    bert.build_model = keep
    reset_launches()
    torch.zeros(1, device=device)  # the allocator's statistics exist now
    torch.cuda.reset_peak_memory_stats()
    parallel.EXCHANGE_TIMING = True
    try:
        with counted_collectives() if "--fsdp" in argv else nullcontext():
            res = entry(module, argv, device, logdir, on_step)
    finally:
        bert.build_model = build
        parallel.EXCHANGE_TIMING = False
    ms = [(y - x) * 1e3 for x, y in zip(stamps, stamps[1:])]
    model, opt = res["state"]["model"], res["state"]["opt"]
    # a pipeline stage's gradients of the leaves it holds, after the run
    grads = {n: q.grad.float().cpu() for n, q in model.named_parameters()
             if "--pipeline-parallel" in argv
             and n.startswith(gpt_leaves(model))}
    return {"losses": res["losses"], "step_ms": ms, "grads": grads,
            "launches": kernel_launches(), "leaves": leaves,
            "exchanges": dict(parallel.EXCHANGES),
            "exchange_share": (parallel.EXCHANGES["seconds"] * 1e3 / sum(ms)
                               if ms else None),
            "step_mode": res["step_mode"],
            "param_bytes": local_bytes(model.parameters()),
            "expert_bytes": local_bytes(
                q for n, q in model.named_parameters()
                if parallel.ep_dim(n) is not None),
            "moe_metrics": res.get("moe_metrics"),
            "moment_bytes": local_bytes(
                st[k] for st in opt.state.values()
                for k in ("exp_avg", "exp_avg_sq")),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
            "replicated": {n: p.detach().float().cpu()
                           for n, p in model.named_parameters()
                           if parallel.tp_dim(n) is None
                           and parallel.ep_dim(n) is None
                           and not hasattr(p, "to_local")}}


def mesh_plan(base: list, parts: dict) -> dict:
    """What each rank of the ``sp``, ``shard`` or ``ep`` phase runs,
    passed to it whole (a spawned rank imports this file anew)."""
    return {"device": f"{DEVICE}:0" if DEVICE == "cuda" else DEVICE,
            "base": base, "parts": parts}


def mesh_rank(rank: int, out_dir: str, plan: dict) -> dict:
    """One rank of the ``sp``, ``shard``, ``ep`` or ``pipe`` phase
    (``distributed.spawn_local``): the group over gloo on the card, then
    each part's run (``mesh_run``), logging under ``out_dir``; what the
    parent checks."""
    import datetime
    import faulthandler
    import importlib

    import torch.distributed as tdist

    from tpujob_torch.workloads import distributed as dist
    from tpujob_torch.workloads import optim

    faulthandler.enable()  # a crash inside a collective prints its stack
    device = plan["device"]
    pe = dist.initialize(device=torch.device(device), backend="gloo",
                         timeout=datetime.timedelta(seconds=DDP_TIMEOUT_S // 2))
    out = {"rank": rank, "pe": [pe.process_id, pe.num_processes],
           "backend": tdist.get_backend()}
    for part, (name, flags, _) in plan["parts"].items():
        module = importlib.import_module(f"tpujob_torch.workloads.{name}")
        out[part] = mesh_run(module, plan["base"] + flags, device,
                             os.path.join(out_dir, f"rank{rank}", part))
    dist.shutdown()
    out["adamw_updates"] = dict(optim.UPDATES)
    return out


def run_sp() -> dict:
    """``local`` in the parent, then each part's one-process run, then two
    gloo ranks on the card running every part; one line a part."""
    import gc
    import importlib

    # Ulysses's local attention: [b, S, h / 2, d] after the all-to-all
    local = check_kernels(s=MAIN["s"], window=0, timed=True,
                          h=MAIN["h"] // SP_WORLD, case="sp_local_h8")
    emit({"phase": "sp", "part": "local", "ok": True,
          "shape": [MAIN["b"], MAIN["s"], MAIN["h"] // SP_WORLD, MAIN["d"]],
          "kernels": {k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms",
                                           "library_ms", "max_abs_err")}
                      for k, v in local.items()}})
    out_dir = os.path.join("build", "chip_smoke", "sp")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    plan = mesh_plan(SP_BASE_ARGV, SP_PARTS)
    one = {}
    for part, (name, _, flags) in SP_PARTS.items():
        module = importlib.import_module(f"tpujob_torch.workloads.{name}")
        one[part] = mesh_run(module, SP_BASE_ARGV + flags, plan["device"],
                             os.path.join(out_dir, "one", part))
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_counted(mesh_rank, SP_WORLD, out_dir, plan,
                          timeout_s=DDP_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    launches = {}
    failed = []
    for part, (name, flags, one_flags) in SP_PARTS.items():
        ref = one[part]
        runs = [r[part] for r in ranks]
        rel = max(abs(x - y) / abs(y)
                  for x, y in zip(runs[0]["losses"], ref["losses"]))
        errs = [update_err(r["leaves"]["step1"], ref["leaves"]["step1"],
                           ref["leaves"]["init"]) for r in runs]
        # B1 twice a layer a step (the forward and its remat replay), B2
        # and B3 once; none on the ring (dense per hop)
        n = (flag(flags, "--layers") if "--layers" in flags else 24) \
            * SP_STEPS * ("flash" in flags)
        want = launched({"flash_fwd": 2 * n, "flash_dq": n, "flash_dkv": n})
        checks = {
            "gloo_groups": all(r["backend"] == "gloo"
                               and r["pe"] == [i, SP_WORLD]
                               for i, r in enumerate(ranks)),
            "losses": all(len(r["losses"]) == SP_STEPS
                          and all(math.isfinite(x) for x in r["losses"])
                          for r in runs)
            and runs[0]["losses"] == runs[1]["losses"]
            and rel <= SP_LOSS_RTOL,
            "params_after_step1": max(errs) <= SP_UPDATE_RTOL,
            "launches": all(r["launches"] == ref["launches"] == want
                            for r in runs),
            "exchanged": all(r["exchanges"]["calls"] > 0 for r in runs),
        }
        ok = all(checks.values())
        launches[part] = runs[0]["launches"]
        emit({"phase": "sp", "part": part, "ok": ok, "checks": checks,
              "argv": SP_BASE_ARGV + flags, "one_process_argv":
              SP_BASE_ARGV + one_flags, "world": SP_WORLD,
              "backend": "gloo (two ranks on one card; NCCL refuses)",
              "losses_rank0": runs[0]["losses"],
              "losses_one_process": ref["losses"], "max_rel_diff": rel,
              "loss_rtol": SP_LOSS_RTOL, "update_err_by_rank": errs,
              "update_rtol": SP_UPDATE_RTOL,
              "launches_by_rank": [r["launches"] for r in runs],
              "launches_one_process": ref["launches"],
              "step_ms_by_rank": [r["step_ms"] for r in runs],
              "step_ms_one_process": ref["step_ms"],
              "step_mode_one_process": ref["step_mode"],
              "exchanges_by_rank": [r["exchanges"] for r in runs],
              "exchange_share_by_rank": [r["exchange_share"] for r in runs],
              "spawn_s": spawn_s,
              "times_note": "per-rank ms a step (steps 2-3) of two ranks "
                            "sharing one card over gloo, the card synced "
                            "around each exchange: a record, not a speed "
                            "of sequence parallelism"})
        if not ok:
            failed.append((part, checks))
    if failed:
        raise AssertionError(f"sp path failed: {failed}")
    return ({k: launches["ulysses"][k] + launches["mlm"][k]
             for k in COUNTED}, local)


def run_shard() -> dict:
    """Each part's one-process run, then two gloo ranks on the card
    running every part; one line a part."""
    import gc
    import importlib

    out_dir = os.path.join("build", "chip_smoke", "shard")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    plan = mesh_plan(SHARD_BASE_ARGV, SHARD_PARTS)
    one = {}
    for part, (name, _, flags) in SHARD_PARTS.items():
        module = importlib.import_module(f"tpujob_torch.workloads.{name}")
        one[part] = mesh_run(module, SHARD_BASE_ARGV + flags, plan["device"],
                             os.path.join(out_dir, "one", part))
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_counted(mesh_rank, SHARD_WORLD, out_dir, plan,
                          timeout_s=DDP_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    launches = {}
    failed = []
    for part, (name, flags, one_flags) in SHARD_PARTS.items():
        ref = one[part]
        runs = [r[part] for r in ranks]
        rel = max(abs(x - y) / abs(y)
                  for x, y in zip(runs[0]["losses"], ref["losses"]))
        errs = [update_err(r["leaves"]["step1"], ref["leaves"]["step1"],
                           ref["leaves"]["init"]) for r in runs]
        # B1 twice a layer a step (the forward and its remat replay), B2
        # and B3 once; none under TP (dense attention)
        n = flag(flags, "--layers") * SHARD_STEPS * ("flash" in flags)
        want = launched({"flash_fwd": 2 * n, "flash_dq": n, "flash_dkv": n})
        checks = {
            "gloo_groups": all(r["backend"] == "gloo"
                               and r["pe"] == [i, SHARD_WORLD]
                               for i, r in enumerate(ranks)),
            "losses": all(len(r["losses"]) == SHARD_STEPS
                          and all(math.isfinite(x) for x in r["losses"])
                          for r in runs)
            and runs[0]["losses"] == runs[1]["losses"]
            and all(abs(x - y) <= max(SHARD_LOSS_RTOL * abs(y), bf16_ulp(y))
                    for x, y in zip(runs[0]["losses"], ref["losses"])),
            "params_after_step1": max(errs) <= SHARD_UPDATE_RTOL,
            "launches": all(r["launches"] == ref["launches"] == want
                            for r in runs),
            "exchanged": all(r["exchanges"]["calls"] > 0 for r in runs),
            # each rank holds half the parameters and moments under FSDP;
            # under TP half the split ones and the rest whole
            "state_sharded": all(
                (r["param_bytes"] * SHARD_WORLD == ref["param_bytes"]
                 if part == "fsdp" else
                 ref["param_bytes"] / SHARD_WORLD < r["param_bytes"]
                 < ref["param_bytes"])
                and r["moment_bytes"] == 2 * r["param_bytes"]
                for r in runs),
            "replicated_equal": all(
                torch.equal(v, runs[0]["replicated"][k])
                for r in runs for k, v in r["replicated"].items()),
        }
        ok = all(checks.values())
        launches[part] = runs[0]["launches"]
        emit({"phase": "shard", "part": part, "ok": ok, "checks": checks,
              "argv": SHARD_BASE_ARGV + flags, "one_process_argv":
              SHARD_BASE_ARGV + one_flags, "world": SHARD_WORLD,
              "backend": "gloo (two ranks on one card; NCCL refuses)",
              "losses_rank0": runs[0]["losses"],
              "losses_one_process": ref["losses"], "max_rel_diff": rel,
              "loss_rtol": SHARD_LOSS_RTOL, "update_err_by_rank": errs,
              "update_rtol": SHARD_UPDATE_RTOL,
              "launches_by_rank": [r["launches"] for r in runs],
              "launches_one_process": ref["launches"],
              "param_bytes_by_rank": [r["param_bytes"] for r in runs],
              "moment_bytes_by_rank": [r["moment_bytes"] for r in runs],
              "param_bytes_one_process": ref["param_bytes"],
              "moment_bytes_one_process": ref["moment_bytes"],
              "peak_mem_gb_by_rank": [r["peak_mem_gb"] for r in runs],
              "peak_mem_gb_one_process": ref["peak_mem_gb"],
              "step_ms_by_rank": [r["step_ms"] for r in runs],
              "step_ms_one_process": ref["step_ms"],
              "step_mode_one_process": ref["step_mode"],
              "exchanges_by_rank": [r["exchanges"] for r in runs],
              "exchange_share_by_rank": [r["exchange_share"] for r in runs],
              "spawn_s": spawn_s,
              "times_note": "per-rank ms a step (steps 2-3) of two ranks "
                            "sharing one card over gloo, the card synced "
                            "around each exchange: a record of correctness "
                            "and memory, not a speed of FSDP or TP"})
        if not ok:
            failed.append((part, checks))
    if failed:
        raise AssertionError(f"shard path failed: {failed}")
    return {k: launches["fsdp"][k] + launches["tp"][k] for k in COUNTED}


def run_ep() -> dict:
    """Each part's one-process run, its memory freed before the ranks
    start (one process peaks near 33 GB at full depth), then two gloo
    ranks on the card running every part; one line a part."""
    import gc
    import importlib

    out_dir = os.path.join("build", "chip_smoke", "ep")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    plan = mesh_plan(EP_BASE_ARGV, EP_PARTS)
    one = {}
    for part, (name, _, flags) in EP_PARTS.items():
        module = importlib.import_module(f"tpujob_torch.workloads.{name}")
        one[part] = mesh_run(module, EP_BASE_ARGV + flags, plan["device"],
                             os.path.join(out_dir, "one", part))
        gc.collect()
        torch.cuda.empty_cache()
    parent_gb = torch.cuda.memory_reserved() / 2**30
    t0 = time.perf_counter()
    ranks = spawn_counted(mesh_rank, EP_WORLD, out_dir, plan,
                          timeout_s=DDP_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    launches = {}
    failed = []
    for part, (name, flags, one_flags) in EP_PARTS.items():
        ref = one[part]
        runs = [r[part] for r in ranks]
        rel = max(abs(x - y) / abs(y)
                  for x, y in zip(runs[0]["losses"], ref["losses"]))
        errs = [update_err(r["leaves"]["step1"], ref["leaves"]["step1"],
                           ref["leaves"]["init"]) for r in runs]
        layers = flag(flags, "--layers") if "--layers" in flags else 24
        n = layers * EP_STEPS
        want = launched({"flash_fwd": 2 * n, "flash_dq": n, "flash_dkv": n})
        # an expert rank routes every row (its drops are one process's);
        # a sequence rank routes its half of each row
        dropped = [[m["dropped"] for m in r["moe_metrics"]] for r in runs]
        ref_dropped = [m["dropped"] for m in ref["moe_metrics"]]
        got_dropped = (dropped[0] if part == "ep"
                       else [sum(x) for x in zip(*dropped)])
        checks = {
            "gloo_groups": all(r["backend"] == "gloo"
                               and r["pe"] == [i, EP_WORLD]
                               for i, r in enumerate(ranks)),
            "losses": all(len(r["losses"]) == EP_STEPS
                          and all(math.isfinite(x) for x in r["losses"])
                          for r in runs)
            and runs[0]["losses"] == runs[1]["losses"]
            and all(abs(x - y) <= max(SHARD_LOSS_RTOL * abs(y), bf16_ulp(y))
                    for x, y in zip(runs[0]["losses"], ref["losses"])),
            "params_after_step1": max(errs) <= SHARD_UPDATE_RTOL,
            "dropped": len(ref_dropped) == EP_STEPS
            and got_dropped[0] == ref_dropped[0]
            and all(abs(x - y) <= EP_DROPPED_RTOL * y
                    for x, y in zip(got_dropped, ref_dropped))
            and (part != "ep"
                 or dropped[0] == dropped[1] == ref_dropped),
            "launches": all(r["launches"] == ref["launches"] == want
                            for r in runs),
            "exchanged": all(r["exchanges"]["calls"] > 0 for r in runs),
            # under EP each rank holds half the experts and every other
            # parameter whole; under SP the whole model
            "state_sharded": all(
                (r["expert_bytes"] * EP_WORLD == ref["expert_bytes"]
                 if part == "ep" else
                 r["expert_bytes"] == ref["expert_bytes"])
                and r["param_bytes"] - r["expert_bytes"]
                == ref["param_bytes"] - ref["expert_bytes"]
                and r["moment_bytes"] == 2 * r["param_bytes"]
                for r in runs),
            "replicated_equal": all(
                torch.equal(v, runs[0]["replicated"][k])
                for r in runs for k, v in r["replicated"].items()),
        }
        ok = all(checks.values())
        launches[part] = runs[0]["launches"]
        emit({"phase": "ep", "part": part, "ok": ok, "checks": checks,
              "argv": EP_BASE_ARGV + flags, "one_process_argv":
              EP_BASE_ARGV + one_flags, "world": EP_WORLD,
              "backend": "gloo (two ranks on one card; NCCL refuses)",
              "losses_rank0": runs[0]["losses"],
              "losses_one_process": ref["losses"], "max_rel_diff": rel,
              "loss_rtol": SHARD_LOSS_RTOL, "update_err_by_rank": errs,
              "update_rtol": SHARD_UPDATE_RTOL,
              "dropped_by_rank": dropped,
              "dropped_one_process": ref_dropped,
              "aux_rank0": runs[0]["moe_metrics"],
              "aux_one_process": ref["moe_metrics"],
              "launches_by_rank": [r["launches"] for r in runs],
              "launches_one_process": ref["launches"],
              "param_bytes_by_rank": [r["param_bytes"] for r in runs],
              "expert_bytes_by_rank": [r["expert_bytes"] for r in runs],
              "moment_bytes_by_rank": [r["moment_bytes"] for r in runs],
              "param_bytes_one_process": ref["param_bytes"],
              "expert_bytes_one_process": ref["expert_bytes"],
              "moment_bytes_one_process": ref["moment_bytes"],
              "peak_mem_gb_by_rank": [r["peak_mem_gb"] for r in runs],
              "peak_mem_gb_one_process": ref["peak_mem_gb"],
              "parent_reserved_gb_at_spawn": parent_gb,
              "step_ms_by_rank": [r["step_ms"] for r in runs],
              "step_ms_one_process": ref["step_ms"],
              "step_mode_one_process": ref["step_mode"],
              "exchanges_by_rank": [r["exchanges"] for r in runs],
              "exchange_share_by_rank": [r["exchange_share"] for r in runs],
              "spawn_s": spawn_s,
              "times_note": "per-rank ms a step (steps 2-3) of two ranks "
                            "sharing one card over gloo, the card synced "
                            "around each exchange: a record of correctness "
                            "and memory, not a speed of expert or sequence "
                            "parallelism"})
        if not ok:
            failed.append((part, checks))
    if failed:
        raise AssertionError(f"ep path failed: {failed}")
    return {k: launches["ep"][k] + launches["moe_sp"][k]
            for k in COUNTED}

def rank_params(name: str, argv: list) -> int:
    """The parameters a pipeline stage of ``<name>.run``'s model holds
    under ``argv`` (the trainer's defaults for the flags it does not
    name): its share of the layers and every parameter outside them (GPT
    has ``ln_f``, BERT not)."""
    import importlib

    module = importlib.import_module(f"tpujob_torch.workloads.{name}")
    a = module.build_parser().parse_args(argv)
    h, f = a.hidden, a.intermediate
    layer = 4 * (h * h + h) + (h * f + f) + (f * h + h) + 4 * h
    shared = (-(-a.vocab // 128) * 128 * h + a.seq_len * h
              + (4 if name == "gpt" else 2) * h)
    return a.layers // a.pipeline_parallel * layer + shared


def run_pipe() -> dict:
    """B1-B3 at a microbatch's shape (``pipe_b2``), each GPT part's and
    the MLM part's one-process run (one for both schedules), then two
    gloo ranks on the card running every part; one line a part."""
    import gc
    import importlib

    b_mb = (flag(PIPE_BASE_ARGV, "--batch-size")
            // flag(PIPE_PARTS["gpipe"][1], "--pipeline-microbatches"))
    check_kernels(s=MAIN["s"], window=0, timed=False, b=b_mb,
                  case=f"pipe_b{b_mb}")
    out_dir = os.path.join("build", "chip_smoke", "pipe")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    plan = mesh_plan(PIPE_BASE_ARGV, PIPE_PARTS)
    one = {}
    for part, (name, _, flags) in PIPE_PARTS.items():
        key = (name, tuple(flags or ()))
        if flags is None or key in one:
            continue
        module = importlib.import_module(f"tpujob_torch.workloads.{name}")
        one[key] = mesh_run(module, PIPE_BASE_ARGV + flags, plan["device"],
                            os.path.join(out_dir, "one", part))
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_counted(mesh_rank, PIPE_WORLD, out_dir, plan,
                          timeout_s=DDP_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    launches = dict.fromkeys(COUNTED, 0)
    peaks, failed = {}, []
    for part, (name, flags, one_flags) in PIPE_PARTS.items():
        argv = PIPE_BASE_ARGV + flags
        steps = flag(flags, "--steps") if "--steps" in flags else PIPE_STEPS
        micro = flag(flags, "--pipeline-microbatches")
        layers = flag(flags, "--layers") if "--layers" in flags else 24
        runs = [r[part] for r in ranks]
        # each stage's half of the layers, every microbatch: B1 twice a
        # layer (GPipe's remat replay, 1F1B's recomputing backward tick),
        # B2 and B3 once
        n = layers // PIPE_WORLD * micro
        want = launched({"flash_fwd": 2 * n, "flash_dq": n, "flash_dkv": n})
        params = rank_params(name, argv)
        exchanged = steps - 1  # counted from the end of step 1 on
        checks = {
            "gloo_groups": all(r["backend"] == "gloo"
                               and r["pe"] == [i, PIPE_WORLD]
                               for i, r in enumerate(ranks)),
            "losses": all(len(r["losses"]) == steps
                          and all(math.isfinite(x) for x in r["losses"])
                          for r in runs)
            and runs[0]["losses"] == runs[1]["losses"],
            "launches": all(r["launches"] == {k: v * steps
                                              for k, v in want.items()}
                            for r in runs),
            # a stage holds its layers and every parameter outside them
            "state_per_stage": all(r["param_bytes"] == 4 * params
                                   and r["moment_bytes"] == 2 * 4 * params
                                   for r in runs)
            and (name != "gpt" or params == PIPE_RANK_PARAMS),
            "exchanged": all(r["exchanges"]["calls"] > 0 for r in runs)
            if exchanged else True,
            "replicated_equal": all(
                torch.equal(v, runs[0]["replicated"][k])
                for r in runs for k, v in r["replicated"].items()
                if not k.startswith("layer_")),
        }
        line = {"phase": "pipe", "part": part, "argv": argv,
                "world": PIPE_WORLD, "microbatches": micro,
                "backend": "gloo (two ranks on one card; NCCL refuses)",
                "losses_rank0": runs[0]["losses"],
                "launches_by_rank": [r["launches"] for r in runs],
                "launches_per_rank_step": want,
                "param_bytes_by_rank": [r["param_bytes"] for r in runs],
                "moment_bytes_by_rank": [r["moment_bytes"] for r in runs],
                "rank_params": params,
                "peak_mem_gb_by_rank": [r["peak_mem_gb"] for r in runs],
                "step_ms_by_rank": [r["step_ms"] for r in runs],
                "step_mode_by_rank": [r["step_mode"] for r in runs],
                "spawn_s": spawn_s}
        if exchanged:
            line.update(
                exchanges_per_rank_step=[
                    {k: v / exchanged for k, v in r["exchanges"].items()}
                    for r in runs],
                exchange_share_by_rank=[r["exchange_share"] for r in runs])
        if one_flags is not None:
            ref = one[(name, tuple(one_flags))]
            got = {}
            for r in runs:  # the stages' leaves, one dict
                got.update(r["leaves"]["step1"])
            err = update_err(got, ref["leaves"]["step1"],
                             ref["leaves"]["init"])
            checks["losses_one_process"] = all(
                abs(x - y) <= bf16_ulp(y)
                for x, y in zip(runs[0]["losses"], ref["losses"]))
            checks["params_after_step1"] = err <= SHARD_UPDATE_RTOL
            line.update(one_process_argv=PIPE_BASE_ARGV + one_flags,
                        losses_one_process=ref["losses"],
                        update_err=err, update_rtol=SHARD_UPDATE_RTOL,
                        param_bytes_one_process=ref["param_bytes"],
                        peak_mem_gb_one_process=ref["peak_mem_gb"],
                        step_ms_one_process=ref["step_ms"],
                        step_mode_one_process=ref["step_mode"])
        peaks[part] = max(r["peak_mem_gb"] for r in runs)
        if part == "1f1b":
            # the two schedules compute one function
            other = [r["gpipe"] for r in ranks]
            g = {k: v for r in runs for k, v in r["grads"].items()}
            h = {k: v for r in other for k, v in r["grads"].items()}
            grad_err = math.sqrt(sum(float(((g[k] - h[k]) ** 2).sum())
                                     for k in h)
                                 / sum(float((h[k] ** 2).sum()) for k in h))
            checks["equals_gpipe"] = (
                all(abs(x - y) <= bf16_ulp(y) for x, y in
                    zip(runs[0]["losses"], other[0]["losses"]))
                and grad_err <= PIPE_GRAD_RTOL)
            line.update(losses_gpipe=other[0]["losses"],
                        grad_rel_err_vs_gpipe=grad_err,
                        grad_rtol=PIPE_GRAD_RTOL)
        if part.endswith("_m8"):
            at4 = peaks[part[: -len("_m8")]]
            line.update(peak_mem_gb_m4=at4, peak_ratio_m8_m4=peaks[part] / at4)
            if part == "1f1b_m8":
                checks["peak_bounded"] = (peaks[part]
                                          <= PIPE_1F1B_PEAK_RATIO * at4)
                line["peak_ratio_max"] = PIPE_1F1B_PEAK_RATIO
        ok = all(checks.values())
        for k in launches:
            launches[k] += runs[0]["launches"][k]
        emit({**line, "ok": ok, "checks": checks,
              "times_note": "per-rank ms a step of two ranks sharing one "
                            "card over gloo, the card synced around each "
                            "exchange: a record of correctness and memory, "
                            "not a speed of pipeline parallelism"})
        if not ok:
            failed.append((part, checks))
    if failed:
        raise AssertionError(f"pipe path failed: {failed}")
    return launches


def graph_run(key: str, module, argv: list, capture: bool, whole) -> dict:
    """``module.run`` once through its flag surface, eager
    (``capture=False``) or captured: what the graph phase compares (the
    losses, the parameter digest with the leaves ``whole(model)`` names
    whole, the running statistics) and what it reports (launches, peak
    memory, host ms a step where the entry point takes an ``on_step``
    hook)."""
    import gc

    logdir = os.path.join("build", "chip_smoke", "graph",
                          f"{key}_{'graph' if capture else 'eager'}")
    shutil.rmtree(logdir, ignore_errors=True)
    args = module.build_parser().parse_args(
        argv + ["--dir", logdir, "--device", DEVICE])
    stamps = []

    def on_step(i: int) -> None:
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    hook = {"on_step": on_step} if module.__name__.endswith(
        (".gpt", ".bert")) else {}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = module.run(args, capture=capture, **hook)
    torch.cuda.synchronize()
    model = res["state"]["model"]
    out = {"step_mode": res["step_mode"], "losses": res.get("losses"),
           "moe_metrics": res.get("moe_metrics"),
           "final_loss": res["final_loss"], "accuracy": res.get("accuracy"),
           "launches": kernel_launches(), "wall_s": res["wall_s"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
           "digest": param_digest(model, whole(model)),
           "stats": running_stats(model)}
    if len(stamps) > 2:
        out.update(step_stats(stamps, 2))
    return out


def bit_equal(a: dict, b: dict) -> bool:
    """Two runs' losses, final loss, accuracy, MoE aux terms, parameter
    digests and running statistics equal bit for bit."""
    return (a["losses"] == b["losses"] and a["final_loss"] == b["final_loss"]
            and a["moe_metrics"] == b["moe_metrics"]
            and a["accuracy"] == b["accuracy"]
            and a["digest"]["abs_sums"] == b["digest"]["abs_sums"]
            and sorted(a["digest"]["leaves"]) == sorted(b["digest"]["leaves"])
            and all(torch.equal(v, b["digest"]["leaves"][k])
                    for k, v in a["digest"]["leaves"].items())
            and sorted(a["stats"]) == sorted(b["stats"])
            and all(torch.equal(v, b["stats"][k])
                    for k, v in a["stats"].items()))


def run_graph() -> dict:
    """Each trainer eager and captured from one seed: bit-equal results,
    the same kernel launches (a replay counts the kernels the card ran),
    step mode ``graph`` only where it was asked for; launches a step,
    peak memory and host ms a step of both beside each other."""
    from tpujob_torch.workloads import bert, gpt, mnist, resnet

    cases = {
        "gpt": (gpt, GRAPH_GPT_ARGV, gpt_leaves, GRAPH_STEPS),
        "mlm_accum2": (bert, GRAPH_MLM_ARGV, gpt_leaves, GRAPH_STEPS),
        "resnet": (resnet, GRAPH_RESNET_ARGV, lambda m: ("head.",), None),
        "mnist": (mnist, GRAPH_MNIST_ARGV, lambda m: ("",), None),
    }
    want = launched({"flash_fwd": 48 * GRAPH_STEPS,
                     "flash_dq": 24 * GRAPH_STEPS,
                     "flash_dkv": 24 * GRAPH_STEPS})
    none = launched({})
    runs, checks = {}, {}
    for key, (module, argv, whole, steps) in cases.items():
        eager = graph_run(key, module, argv, False, whole)
        graph = graph_run(key, module, argv, True, whole)
        kernels = want if key in ("gpt", "mlm_accum2") else none
        checks[key] = {
            "modes": [eager["step_mode"], graph["step_mode"]]
            == ["eager", "graph"],
            "bit_equal": bit_equal(eager, graph),
            "launches": eager["launches"] == graph["launches"] == kernels,
            "finite": all(math.isfinite(x) for x in graph["losses"] or [])
            and math.isfinite(graph["final_loss"]),
        }
        runs[key] = {mode: {k: v for k, v in r.items()
                            if k not in ("digest", "stats")}
                     for mode, r in (("eager", eager), ("graph", graph))}
        if steps:
            for r in runs[key].values():
                r["launches_per_step"] = {k: n / steps
                                          for k, n in r["launches"].items()}
        del eager, graph
    checks["mlm_resume"], runs["mlm_resume"] = graph_resume()
    ok = all(all(c.values()) for c in checks.values())
    emit({"phase": "graph", "ok": ok, "checks": checks, "runs": runs})
    if not ok:
        raise AssertionError(f"graph phase failed: {checks}")
    return runs["gpt"]["graph"]["launches"]


def graph_resume() -> tuple:
    """Captured runs of ``bert.run`` (``GRAPH_RESUME_ARGV``): straight,
    and stopped with a checkpoint inside a group then resumed; the resumed
    losses and parameters must be the straight run's, bit for bit."""
    from tpujob_torch.workloads import bert

    base = os.path.join("build", "chip_smoke", "graph", "resume")
    shutil.rmtree(base, ignore_errors=True)

    def run(name, steps, interval):
        return bert.run(bert.build_parser().parse_args(
            GRAPH_RESUME_ARGV + ["--steps", str(steps),
                                 "--checkpoint-interval", str(interval),
                                 "--dir", os.path.join(base, name),
                                 "--device", DEVICE]))

    straight = run("straight", GRAPH_RESUME_STEPS, 0)
    run("resumed", GRAPH_RESUME_AT + 1, GRAPH_RESUME_AT)
    resumed = run("resumed", GRAPH_RESUME_STEPS, GRAPH_RESUME_AT)
    a = straight["state"]["model"].state_dict()
    b = resumed["state"]["model"].state_dict()
    lr_devices = sorted({str(getattr(g["lr"], "device", "a float"))
                         for g in resumed["state"]["opt"].param_groups})
    checks = {
        "modes": straight["step_mode"] == resumed["step_mode"] == "graph",
        "losses": resumed["losses"]
        == straight["losses"][GRAPH_RESUME_AT:],
        "params": all(torch.equal(a[k], b[k]) for k in a),
        "lr_on_card": lr_devices == [str(next(iter(b.values())).device)],
    }
    shutil.rmtree(base, ignore_errors=True)
    return checks, {"straight_losses": straight["losses"],
                    "resumed_losses": resumed["losses"],
                    "resumed_at": GRAPH_RESUME_AT, "lr_devices": lr_devices}


def run_dryrun() -> None:
    """``graft_entry`` on the card: ``graft_entry.dryrun_multichip`` at 8
    gloo ranks sharing the card (every case of the JAX package's matrix,
    one full step each), then at 8 ranks on the CPU, each case's loss on
    the card held to the CPU's; then ``graft_entry.entry`` (BERT-large's
    bf16 forward as a function of its parameters) on the card."""
    import gc

    from tpujob_torch import graft_entry

    gc.collect()
    torch.cuda.empty_cache()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    try:
        card = graft_entry.dryrun_multichip(DRYRUN_N, DEVICE)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = graft_entry.dryrun_multichip(DRYRUN_N, "cpu")
    cpu_s = time.perf_counter() - t0
    cases = [c.name for c in graft_entry.dryrun_cases(DRYRUN_N)]
    rel = {k: abs(card[k] - cpu[k]) / abs(cpu[k]) for k in cpu}
    fn, (params, ids) = graft_entry.entry(DEVICE)
    with torch.no_grad():
        logits = fn(params, ids)
        entry_ms = time_ms(lambda: fn(params, ids), iters=5)
    checks = {
        "cases": list(card) == list(cpu) == cases,
        "finite": all(math.isfinite(x) for x in card.values()),
        "1f1b_vs_gpipe": abs(card["1f1b"] - card["gpipe"])
        < graft_entry.F1B_ATOL,
        "card_vs_cpu": max(rel.values()) <= DRYRUN_LOSS_RTOL,
        "entry": tuple(logits.shape) == (4, 128, 30522)
        and logits.dtype == torch.bfloat16
        and bool(torch.isfinite(logits).all()),
    }
    ok = all(checks.values())
    emit({"phase": "dryrun", "ok": ok, "checks": checks, "n": DRYRUN_N,
          "losses": card, "cpu_losses": cpu, "rel_diff": rel,
          "rtol": DRYRUN_LOSS_RTOL, "seconds": card_s, "cpu_seconds": cpu_s,
          "entry_logits_shape": list(logits.shape),
          "entry_forward_ms": entry_ms,
          "entry_params": sum(p.numel() for p in params.values())})
    del fn, params, logits
    if not ok:
        raise AssertionError(f"dryrun phase failed: {checks}")


def bench_child(argv: list) -> list:
    """``python -m <argv>`` from the repo root: its JSON lines, each
    printed here on a line of its own.  A nonzero exit raises."""
    out = subprocess.run([sys.executable, "-m"] + argv, cwd=ROOT,
                         capture_output=True, text=True,
                         timeout=BENCH_TIMEOUT_S)
    if out.returncode != 0:
        raise AssertionError(f"{' '.join(argv)} exited {out.returncode}:\n"
                             f"{out.stderr[-4000:]}")
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
    for ln in lines:
        print(ln, flush=True)
    return [json.loads(ln) for ln in lines]


def run_bench() -> dict:
    """The port's benches on the card, as a user runs them: the
    MNIST headline (exactly one line, the JAX line's keys, accuracy above
    0.8) and the flagship rows (one line a row, MFU at most 1); every row
    on the captured step, the spread across windows reported.  The
    transformer rows' AdamW updates are added to ``optim.UPDATES``."""
    import gc

    from tpujob_torch.workloads import optim

    gc.collect()
    torch.cuda.empty_cache()
    card = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    headline = bench_child(BENCH_ARGV)
    models = bench_child(BENCH_MODELS_ARGV)
    quick = bench_child(BENCH_QUICK_ARGV)
    scaling = bench_child(BENCH_SCALING_ARGV)
    seconds = time.perf_counter() - t0
    line = headline[0] if len(headline) == 1 else {}
    names = BENCH_MODELS.split(",")
    rows_ok = len(models) == len(names) and all(
        BENCH_MODELS_KEYS <= set(r) and r["value"] > 0
        and r["platform"] == card and r["step_mode"] == "graph"
        and "spec_peak_exceeded_x" not in r
        and 0 < r.get("mfu_vs_spec", 0.5) <= 1.0
        and r["step_ms_std"] >= 0 for r in models)
    gpt_row = models[-1] if models else {}
    quick_row = quick[0] if len(quick) == 1 else {}
    srow = scaling[0] if len(scaling) == 1 else {}
    checks = {
        "headline_one_line": len(headline) == 1,
        "headline_keys": BENCH_KEYS <= set(line),
        "headline_accuracy": line.get("accuracy", 0) > 0.8,
        "headline_card": line.get("platform") == card
        and line.get("step_mode") == "graph" and line.get("value", 0) > 0,
        "rows": rows_ok,
        "gpt_row_kernels": on_tuned(gpt_row.get("kernel_launches", {})),
        "quick_gpt_row": len(quick) == 1 and quick_row.get("value", 0) > 0
        and quick_row.get("platform") == card
        and quick_row.get("step_mode") == "graph"
        and on_tuned(quick_row.get("kernel_launches", {})),
        "scaling_row": len(scaling) == 1 and BENCH_SCALING_KEYS <= set(srow)
        and srow["metric"] == "dp_sharding_overhead_8dev_vs_1dev"
        and srow["platform"] == "gpu" and srow["device_name"] == card
        and srow.get("ranks_per_card") == 8 and srow["backend"] == "gloo"
        and srow["value"] > 0 and srow["step_mode"] == "eager"
        and abs(srow["loss_8dev"] - srow["loss_1dev"])
        <= SCALING_LOSS_RTOL * abs(srow["loss_1dev"]),
    }
    ok = all(checks.values())
    emit({"phase": "bench", "ok": ok, "checks": checks, "seconds": seconds,
          "headline_metric": line.get("metric"),
          "rows": [r.get("metric") for r in models],
          "quick_gpt_row_argv": BENCH_QUICK_ARGV,
          "scaling_row_argv": BENCH_SCALING_ARGV})
    if not ok:
        raise AssertionError(f"bench phase failed: {checks}")
    for r in models + quick:
        for k, n in r.get("adamw_updates", {}).items():
            optim.UPDATES[k] += n
    return gpt_row["kernel_launches"], quick_row["kernel_launches"]


# each flash kernel's source, the Pallas kernel it replaces and its main
# path: GPT-2-medium in bf16 for the tuned kernels, Mellum2 for the
# bf16_128 ones, GPT-2-medium in fp32 for the _any ones
KERNELS = {
    f"flash_{kind}{suffix}": (
        f"tpujob_torch/csrc/flash_{kind}{'_any' if suffix else ''}.cu",
        f"tpujob/workloads/flash.py:{line}", path)
    for suffix, path in (("", "train"), ("_bf16_128", "mellum"),
                         ("_any", "fp32"))
    for kind, line in (("fwd", 74), ("dq", 163), ("dkv", 197))}


def adamw_row(adamw: dict, updates: dict) -> dict:
    """The AdamW kernel's row of the ``kernels`` line: its time alone
    (``ms``) and its optimizer's ``step`` (``step_ms``) at GPT-2-medium's
    parameter set against torch's foreach route (``plain_ms``, the port's
    update before it) and ``fused=True`` (``library_ms``) and the byte
    bound, each parameter set under ``cases``; then the parameter tensors
    it updated on each path (``updates_by_path``), and torch's route's
    (``torch_updates_by_path``, which must be 0 on the card)."""
    def timings(r):
        return {"ms": r["kernel"]["launches_ms"], "step_ms": r["kernel"]["ms"],
                "plain_ms": r["foreach"]["ms"], "library_ms": r["fused"]["ms"],
                "bound_ms": r["bound_ms"], "bound_by": "bytes",
                "max_ulps_vs_plain": r["foreach"]["kernel_ulps"]}

    main = adamw["gpt2-medium"]
    return {"name": "tpujob_adamw_kernel", "route": "cuda",
            "source": "tpujob_torch/csrc/adamw.cu",
            "replaces": "tpujob/workloads/train_lib.py:adamw",
            "main_path": "train", "updates": updates["train"]["kernel"],
            **timings(main),
            "bound_share": main["kernel"]["launches_bound_share"],
            "library_fn": "torch.optim.AdamW(fused=True)",
            "cases": {name: timings(r) for name, r in adamw.items()},
            "paths": [p for p, n in updates.items() if n["kernel"] > 0],
            "updates_by_path": {p: n["kernel"] for p, n in updates.items()},
            "torch_updates_by_path": {p: n["torch"]
                                      for p, n in updates.items()}}


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--decode-prompt", type=int, default=DECODE_PROMPT,
                   help="prompt tokens of the decode phase (at least 16)")
    p.add_argument("--decode-new", type=int, default=DECODE_NEW,
                   help="new tokens of each decode route")
    args = p.parse_args(argv)
    if args.decode_prompt < 16 or args.decode_new < 1:
        p.error("--decode-prompt must be >= 16 and --decode-new >= 1")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 1
    try:
        from tpujob_torch.kernels import build
        from tpujob_torch.workloads import optim
    except ImportError as e:
        print(f"chip_smoke: the tpujob_torch package is not importable: {e}",
              file=sys.stderr)
        return 1
    try:
        smi = smi_line()
        emit({"phase": "device", "nvidia_smi": smi,
              "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(), "torch": torch.__version__,
              "cuda": torch.version.cuda})
        t0 = time.perf_counter()
        build.load_all()
        ptxas = ptxas_report(build)
        spilled = [r["source"] for r in ptxas if r["spill_bytes"]]
        serialized = [r["source"] for r in ptxas if r["wgmma_notes"]]
        emit({"phase": "build", "ok": not spilled and not serialized,
              "seconds": time.perf_counter() - t0,
              "dir": str(build.build_dir()), "ptxas": ptxas})
        if spilled:
            raise AssertionError(f"ptxas spills registers in {spilled}")
        if serialized:
            raise AssertionError("ptxas serializes wgmma (C7518) or injects "
                                 f"warpgroup waits (C7517) in {serialized}")

        main_case = check_kernels(s=MAIN["s"], window=0, timed=True)
        timed = {"gpt_s1024": main_case}
        check_kernels(s=1000, window=0, timed=False)
        check_kernels(s=MAIN["s"], window=256, timed=False)
        # the shape each ddp rank gives them: its half of the global batch
        b_rank = flag(DDP_GPT_ARGV, "--batch-size") // DDP_WORLD
        check_kernels(s=MAIN["s"], window=0, timed=False, b=b_rank,
                      case=f"ddp_b{b_rank}")
        timed["bert_s512"] = check_kernels(s=512, window=0, timed=True,
                                           causal=False, case="bert_s512")
        # B1 at the decode buffer's shape, as the full route launches it
        s_dec = args.decode_prompt + args.decode_new
        timed[f"decode_s{s_dec}"] = check_kernels(
            s=s_dec, window=0, timed=True, case=f"decode_s{s_dec}")
        # head dim 32: bench_models --quick's GPT shape, then GPT's
        check_kernels(s=128, window=0, timed=False, b=4, h=8, d=32,
                      case="quick_d32")
        for causal in (True, False):
            case = "gpt_d32" + ("" if causal else "_noncausal")
            timed[case] = check_kernels(s=MAIN["s"], window=0, timed=True,
                                        causal=causal, d=32, case=case)
        # the _any kernels: GPT-2-medium's shape in fp32 (the fp32 path),
        # the dryrun's width, head dim 80 in bf16, and the largest head dim
        # at a ragged length; the bf16_128 ones at head dim 128 (the window
        # too)
        f32, bf16 = torch.float32, torch.bfloat16
        any_timed = {"any_gpt_f32": check_kernels(
            case="any_gpt_f32", dtype=f32, timed=True, window=0, **MAIN)}
        check_kernels(case="any_dryrun_d16", dtype=f32, b=4, s=64, h=4, d=16,
                      causal=False, timed=False, window=0)
        any_timed["any_d128_bf16"] = check_kernels(
            case="any_d128_bf16", dtype=bf16, b=8, s=1024, h=8, d=128,
            timed=True, window=0)
        check_kernels(case="any_d128_bf16_w256", dtype=bf16, b=8, s=1024, h=8,
                      d=128, window=256, timed=False)
        any_timed["any_d80_bf16"] = check_kernels(
            case="any_d80_bf16", dtype=bf16, b=8, s=1024, h=16, d=80,
            timed=True, window=0)
        # fp32 at head dim 256: the d=256 GPT's attention (b 8, s 1024,
        # 8 heads), timed, then a ragged length
        any_timed["any_d256_f32"] = check_kernels(
            case="any_d256_f32", dtype=f32, b=8, s=1024, h=8, d=256,
            timed=True, window=0)
        check_kernels(case="any_d256_f32_s1000", dtype=f32, b=2, s=1000, h=4,
                      d=256, timed=False, window=0)
        # Mellum2's attention as its cell runs it: batch 2, seq 8192, 32
        # query heads (the 4 K/V heads repeated up to them), head dim 128,
        # its sliding layers' window and its full layers (the bf16_128
        # route's kernels), timed
        for w in (1024, 0):
            case = "mellum_s8192" + (f"_w{w}" if w else "")
            any_timed[case] = check_kernels(
                case=case, dtype=bf16, b=2, s=8192, h=32, d=128, window=w,
                timed=True, head_chunk=head_chunk_for(2, 8192, 32))
        adamw = run_adamw()
        moe_gemm_cases = run_moe_gemm()
        check_model()
        check_model_bert()
        updates = {}  # path -> parameter tensors each AdamW route updated

        def counted(path, run, *a):
            optim.UPDATES.update(kernel=0, torch=0)
            out = run(*a)
            updates[path] = dict(optim.UPDATES)
            return out

        dp, dn = args.decode_prompt, args.decode_new
        by_path = {path: counted(path, *run) for path, run in (
            ("graph", (run_graph,)), ("train", (run_train,)),
            ("mlm", (run_mlm,)), ("fp32", (run_fp32,)),
            ("decode", (run_decode, dp, dn)), ("corpus", (run_corpus,)),
            ("moe", (run_moe, dp, dn)), ("mellum", (run_mellum_steps,)))}
        run_mnist()
        run_resnet()
        by_path["ddp"] = counted("ddp", run_ddp)
        by_path["sp"], timed["sp_local_h8"] = counted("sp", run_sp)
        by_path["shard"] = counted("shard", run_shard)
        by_path["ep"] = counted("ep", run_ep)
        by_path["pipe"] = counted("pipe", run_pipe)
        run_dryrun()
        by_path["bench"], by_path["bench_quick_d32"] = counted("bench",
                                                               run_bench)

        rows = []
        for name, (source, replaces, main_path) in KERNELS.items():
            # each kernel's timed cases, the first its row's main one
            cases = {case: c for case, c in {**timed, **any_timed}.items()
                     if name in c}
            m = cases[next(iter(cases))][name]
            rows.append({"name": name, "route": "cuda", "source": source,
                         "replaces": replaces, "main_path": main_path,
                         "launches": by_path[main_path][name],
                         "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                         "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                         "bound_by": m["bound_by"], "tflops": m["tflops"],
                         "bound_share": m["bound_share"],
                         "library_ms": m["library_ms"],
                         "ffma_bound_ms": m.get("ffma_bound_ms"),
                         "split_reach_ms": m.get("split_reach_ms"),
                         "cases": {case: {k: c[name].get(k) for k in (
                             "ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "max_abs_err", "ffma_bound_ms",
                             "split_reach_ms")}
                             for case, c in cases.items()},
                         "paths": [path for path, n in by_path.items()
                                   if n[name] > 0],
                         "launches_by_path": {path: n[name] for path, n
                                              in by_path.items()}})
        rows += moe_gemm_rows(moe_gemm_cases, by_path)
        rows.append(adamw_row(adamw, updates))
        emit({"kernels": rows})
        on_torch = {p: n["torch"] for p, n in updates.items() if n["torch"]}
        if on_torch:
            raise AssertionError("torch's AdamW updated tensors on the card "
                                 f"(path: tensors): {on_torch}")
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    except Exception:  # any failed phase: report, no result line
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
