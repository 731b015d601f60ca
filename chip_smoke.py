#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ccvpe_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions,
     whether PIL imports and libjpeg's and libpng's headers exist, where
     the toolkit's nvjpeg.h and libnvjpeg are (csrc/io.cu links them);
  2. build every hand-written kernel from csrc/ with nvcc (sm_90a), and
     lmu.cu and lmu_bf16.cu again with B3's per-phase timer, one nvcc per
     library, all started together, timed, with ptxas' report, and each LMU
     kernel's registers and spill bytes read from it; the tensor-core
     instructions (HMMA) and clock reads of each LMU kernel counted in
     cuobjdump -sass: the float32 B2 and B3 must hold TF32 ones, B3 at T =
     8 more than before its da, dh|dskip and dx took the tensor cores; the
     bf16 ones m16n8k16 bf16 ones and no TF32 one; the main path's
     libraries no clock read; the correlation kernel (B1) TF32 ones too;
     which nvJPEG backends the card's machine creates (csrc/io.cu);
  3. the correlation kernel against its plain PyTorch version at the main
     path's shapes (VIGOR batch 8), at Oxford, KITTI (s1 and s6) and
     ori-prior shapes, and at one shape with ragged N and D edges and the
     largest K, with and without r, each twice for the same bits; against
     a float64 product at VIGOR s1 and KITTI s1; its launch plans' blocks
     per SM against the occupancy API;
  4. its kernel / plain / two-matmul yardstick times (the kernels' own
     durations in a torch.profiler trace, the calls told apart by the L2
     flush before each, median; the kernel also from CUDA events around the
     call, which count the op's host time of a short call, and the op's
     host microseconds a call) beside the bound from bytes and float32
     operations, without r (serving) and with r (training), and each
     scale's plan;
  5. the correlation backward: grads of S and of the ground descriptor
     through the kernel's op and its registered backward against autograd through the
     plain version, at the six VIGOR scales;
  6. the LMU kernels' 3xTF32 mma.sync primitive alone (mma_probe) against
     a float64 matmul at ragged M x N x K, twice for the same bits, and
     its times; the bf16 kernels' ldmatrix and m16n8k16 primitive likewise,
     against its plain version a.float() @ b.float() too; the card's issue
     rates of the TF32 and the bf16 mma.sync (mma_rate);
     then the fused LMU stage kernels (forward B2, backward B3) against
     their plain versions at the four VIGOR calls of a step at
     lmu_fused_min_res=256, the four KITTI calls, a ragged no-skip Cout-1
     case, a large-bias case, a case with no channel count a multiple
     of 4, and two cases whose da, dh|dskip and dx all take the tensor
     cores with ragged k-steps and n-groups, one at T = 8 and one whose
     widths make B3's plan pick T = 4 (the plan and routes checked); B3
     twice, for the same bits; B2 at the four VIGOR calls at the tile T it
     picks and at T = 8 (B3's), for the same bits;
  7. their kernel / plain / cuDNN-chain times beside their bounds (float32
     on the CUDA cores, and 3xTF32 on the tensor cores), B2 also at T = 8,
     and the mma.sync each issues with its rate; then B3's
     per-phase split at the four VIGOR calls from the timed library (each
     phase's share of the block cycles, and that share of the untimed
     kernel's time), the timed kernel's time beside the untimed one, and
     its da, dh|dskip and dx beside their cycles on the FMAs;
  8. the serving path at full width: vigor() with seeded random weights,
     InferenceEngine(batch_size=8).predict on 20 requests (the last batch
     padded), kernel launches counted; one batch's CVM forward with
     corr_impl='auto' held against 'plain'; the scalar eval step once; the
     p50 batch latency over 10 batches; one batch under torch.profiler
     (device busy share, kernel time by name); the bare CVM forward's p50
     with TF32 on and off (the cost of float32);
  9. the training slice at full width: vigor() with lmu_fused_min_res=256,
     batch 8, create_train_state + make_train_step; the fused calls' shapes
     read from the autograd graph; launches of one step (corr 6, lmu
     forward 4, lmu backward 4); that step against the same step through
     cuDNN (lmu_fused_min_res=0) from the same state: losses, every
     gradient, BN running stats; p50 step time, pairs/s and peak memory
     over 8 steps; one step under torch.profiler;
 10. the evaluation path at full width, from in-memory splits of 20
     samples (uint8 images and the sample classes' fields from numpy seed
     17, no image files or PIL) through the port's ThreadedLoader:
     eval_over_loader at VIGOR 360, FoV 90 (a 160-column ground image),
     the orientation prior (45 degrees) and the fused stages from 256 px,
     and at KITTI; stream_eval at Oxford; seeded random weights; each loop
     with the eager step (cuda_graph=False) and the graphed one (the
     default: one CUDA graph a batch shape), each once to warm up (the
     graph captured), once counted, then EVAL_TIMED_LOOPS times each, in
     turns, timed. Per configuration: the graphed decodes, GT pixels and
     prob@GT (the stream's rows, cols and angles) equal the eager ones to
     the bit, and the eager ones InferenceEngine.predict's on the same
     inputs; one capture (stream_eval's step kept across its calls);
     each loop's launches (B1 6 a forward, 7 under the prior; B2 4 a
     fused forward) held to the torch.profiler trace of one graphed loop;
     the summary in range; the median pairs/s (Oxford: frames/s) of each
     step's timed loops with their spread; the reserved memory the graph's
     pool adds, given back when the model and its steps are dropped; one
     batch of the loop's own inputs (the FoV-sliced ground image, the
     prior's restricted bins) through the forward with the kernel against
     the plain correlation; the device's idle share over one VIGOR loop,
     eager and graphed;
 11. the driver at full width, in a child process (python3 chip_smoke.py
     --driver <json>) whose environment sets CUBLAS_WORKSPACE_CONFIG=:4096:8
     and which runs under core/debug.py::deterministic(), so neither
     touches phases 1-10; its non-zero exit fails the run: vigor() with
     lmu_fused_min_res=256, batch 8, an in-memory split from numpy seed 17
     (24 train samples, 12 validation samples), 2 epochs. A control
     Trainer.fit (its launches per train step and per validation forward
     counted); a run stopped by fake_fail_at_step=4 with a checkpoint every
     2 steps; a new Trainer resumed from it, whose parameters, BN buffers,
     Adam state, last validation summary and metric rows must equal the
     control run's to the bit (the Trainer's step is a CUDA graph: the
     control run captures once, the resumed Trainer anew on its restored
     state); the Trainer's validation step is a CUDA graph too, captured
     once a Trainer: after each epoch, and in the resumed run, its summary
     equals eval_over_loader with an eager step on the same weights to the
     bit (the graph reads the weights and BN stats the train step changed
     in place); Trainer.validate against eval_over_loader called directly
     on the same weights, BN buffers unchanged; the reserved memory with
     both graphs alive and its peak; the Trainer's pairs/s from its log
     rows beside phase 9's p50, checkpoint size, host copy, write and
     restore times, the child's wall time;
 12. bench.py's mixed-precision train configuration at full width, in a
     child process (python3 chip_smoke.py --bench-config <json>, the same
     environment as phase 11's): B1 on a bf16 S at the five decoder scales
     of a VIGOR forward (batch 8) and a ragged shape, with and without r,
     S^2 rounded and not, each twice for the same bits, against its plain
     version and, unrounded, against the float32 kernel on S.float() to the
     bit; its times (from the trace, the kernel also from events around
     the call) beside the float32 kernel's, the two-matmul yardstick on
     bf16 operands and the bound from 2-byte S;
     in deterministic mode, float32, batch 8: the ori_window=160 step
     against the full field (losses, every gradient) and three remat
     combinations against none (losses and BN buffers to the bit,
     gradients to the bit or within float32 roundoff), drop-connect on;
     vigor() with bench.py's options through create_train_state and
     make_train_step at batch 8 and 96: B1's launches a step (bf16 and
     float32 S apart), p50 step time, pairs/s, peak memory, one step of
     each under torch.profiler, beside the
     float32 unfused step at batch 8 on the same weights, whose loss the
     bf16 step's must be near; one InferenceEngine.predict batch under the
     bf16 configuration (launches, finite maps, the decode step's rows,
     heatmap peaks against the float32 model's);
 13. the rest of ModelConfig at full width, in a third child process
     (python3 chip_smoke.py --model-options <json>, phase 12's
     environment): B2 and B3 on bf16 activations (csrc/lmu_bf16.cu)
     against their bf16 plain versions (the emulations of their arithmetic)
     at the VIGOR and KITTI calls (batch 8) and phase 6's ragged,
     large-bias and tensor-core cases, each twice for the same bits; B2's
     y at every tile that fits to the same bits, B3's plan against the
     Python mirror; their times at the VIGOR calls (from the trace, the
     kernels also from events around the call) beside the float32
     kernel on the same values, the plain versions and the bf16 cuDNN
     chain, the bounds from 2-byte activations and the wrapper's channel
     pads; B3 on bf16 by phase (lmu_bf16.cu's timed build); bench.py's
     options with lmu_fused_min_res=256
     through create_train_state and make_train_step at batch 8 and 96
     (launches counted from zero over the first step: B1 1 + 5 bf16, B2 and
     B3 2 each on bf16; p50, pairs/s, peak memory, printed by the parent
     beside phase 12's unfused step, whose float32 first loss the bf16 one
     must be near; the trace of one replayed step at batch 8 must show
     those launches) and one InferenceEngine.predict batch (B2 4 on bf16);
     vigor(circular_impl='edgefix') and vigor(phase_space_min_res=256)
     against vigor(), float32, batch 8, deterministic mode: the forward's
     heatmap and one train step's losses and gradients, whether each is the
     same bits, and the forward's and step's p50 of both;
 14. the compiled executables at full width, in a fourth child process
     (python3 chip_smoke.py --graphs <json>, phase 12's environment):
     serve.py's export_program -> bytes -> load_program at vigor() batch 1
     and 8 and vigor(lmu_fused_min_res=256) batch 8: the graph's B1 (6) and
     B2 (0 or 4) nodes, one run's launches, its rows and cols equal to the
     eager forward's, the angle within EXPORT_ANGLE_ATOL, the heatmap's
     largest difference and whether it is the same bits, export seconds
     and MB; InferenceEngine(cuda_graph=True) against cuda_graph=False on
     phase 8's 20 requests: the same PoseResults, 18 B1 launches each, one
     capture (warmup's), each one's p50 batch latency and busy share
     (torch.profiler), whose trace of one batch must show 6 B1 kernels,
     and the process's counts (core/profiling.py::counters) over the
     requests: the graphed engine replays each of its 3 batches, the eager
     one none; in
     deterministic mode, the fused float32 step and bench.py's options at
     batch 8, 3 steps eager and 3 graphed from the same state and
     generator seeds: losses, gradients, parameters, buffers and Adam
     state the same bits, the same launches every step and in the trace of
     one profiled step, each one's p50,
     pairs/s, busy share and peak memory; bench.py's options at batch 96
     graphed, with the eager first step's peak and the graph's, its 3 timed
     steps counted as 3 train.steps and 3 graph.replays;
 16. scale-out, after phase 14, in a fifth child process (python3
     chip_smoke.py --scale-out <json>, phase 12's environment): in
     deterministic mode, the graphed fused float32 step at batch 8, 3 steps
     in a nccl process group of one process against no group from the same
     state and seeds: the same bits (losses, gradients, parameters,
     buffers, Adam state), and the trace of one replayed step holds the
     counters' 6/4/4 and the gradient mean's nccl kernel; then two rank
     processes (--scale-out-rank) under gloo on the one card (nccl refuses
     two ranks on one device), eager, drop-connect on, a global batch of 8
     as 2 x 4 against one process at 8, with and without 2 microbatches:
     losses within 1e-4, the first step's whole gradient within
     SCALE_GRAD_RTOL (each tensor's worst beside the one process's own
     floors: its step with BatchNorm's rounding changed, and with the
     batch's halves swapped, drop-connect off), BN running var
     within 2e-4, both ranks the same bits; eval_over_loader and
     stream_eval over 2 shards against one, their steps graphed in every
     process (the data axis puts no collective in an eval forward, so gloo
     ranks capture): the same per-sample errors, summaries within 1e-9,
     one capture each, aggregate_fps; each run's p50 step time, a
     reading;
 17. the model axis (ModelConfig.spatial_axis, ori_axis), after phase 16,
     in a sixth child process (python3 chip_smoke.py --model-axis <json>,
     phase 12's environment), vigor() at full width, float32: (a) in a
     nccl group of one under set_mesh(make_mesh(1, 1)), both axes 'model'
     against neither, 3 graphed unfused steps at batch 8 in deterministic
     mode: the same bits, 6 B1 launches in every step and in the trace of
     a replayed step; (b) two rank processes (--model-axis-rank) under gloo
     on the one card as the mesh (1, 2), eager, against one process at the
     global batch of 8: the forward with both axes (heatmap 1e-5, logits
     2e-3, scores 1e-4, ori 1e-4 where the raw head norm exceeds 1e-2;
     6 B1 launches a rank, held to its trace), 2 train steps with both
     axes and ori_window=160, drop-connect on, and 2 with ori_axis and
     the fused stages from 256 (6/4/4 B1/B2/B3 a rank a step): losses
     within 1e-4, the first step's whole gradient within SCALE_GRAD_RTOL,
     BN running var within 2e-4, every rank the same bits; (c) four rank
     processes as (2, 2): one forward and one step with both axes at a
     global batch of 4 against one process, the same checks; each rank's
     p50 and peak allocated memory beside one process's (readings);
 18. the image ingest, after phase 17, in a seventh child process
     (python3 chip_smoke.py --ingest <json>): PIL-written files in a
     temporary directory. The resize kernel (csrc/io.cu) against
     resize_plain on one input each: VIGOR panoramas as nvJPEG decoded them
     (a batch of 8, and one), noise at a non-integer downscale, an upscale,
     a row too wide for a 64-column tile, a row of no multiple of 4 bytes
     and a steep downscale streamed in several row chunks, uint8 and
     normalized, twice for the same bits; a size whose band fits no shared
     memory raises; each test file
     (VIGOR's panorama as JPEG 4:2:0, 4:4:4, progressive and gray, noise
     JPEGs, PNG RGB, RGBA and palette) decoded and resized on the card
     against the plain version (PIL's decode, resize_plain) within
     INGEST_GATE_*, with the backend that decoded it; INGEST_THREADS
     threads decoding at once against one, load_batch_native against
     load_image_native, for the same bits; the kernel's time from the trace
     at the eval path's call (one panorama, normalized) and at a batch of 8,
     beside resize_plain's, the bound and interpolate(bilinear, antialias);
     decode plus resize a panorama on the card alone and in
     batches of 8 and 32 against PIL on the host in one thread and in 8;
     eval_over_loader (graphed) over an on-disk VIGOR split of 20
     2048 x 1024 JPEGs with 640 x 640 PNG patches, decoded on the card
     beside PIL: the card step's capture held open until a loader thread
     has decoded a panorama on the card, one capture each, the launches of
     a counted loop (B1 18, the resize 20), pairs/s and the device's idle
     share, the resize kernel in a profiled loop's trace against the
     counter; details in chiprun_out/chip_smoke_ingest.json;
 15. a {"kernels": [...], "probes": [...]} line (probes: the primitive
     alone, launched on no path; B1's entry carries eval_launches, its
     launches in each graphed eval loop, and eval_traced_launches, those in
     that loop's trace; B2's those of the fused eval loop; each kernel's driver_launches are its
     launches in phase 11's control Trainer.fit; corr_fwd_bf16 is B1 on a
     bf16 S, its launches from phase 12's train step; lmu_fwd_bf16 and
     lmu_bwd_bf16 are B2 and B3 on bf16 activations, their launches from
     phase 13's train step, eval_launches from its predict batch;
     graph_step_launches are the launches in the torch.profiler trace of
     one replayed step in phase 14 (bf16 B2/B3: phase 13's at batch 8),
     graph_serve_launches those of one
     replayed serving batch, and
     export_nodes the exported fused program's nodes; nccl_step_launches
     those in the trace of one replayed step in phase 16's nccl group;
     model_axis_launches those of a step on rank 0 of phase 17's (1, 2)
     mesh with ori_axis and the fused stages; resize is the ingest's
     kernel, which replaces no TPU kernel, its launches from phase 18's
     counted on-disk eval loop, its times at its call and at a batch of 8),
     then
     the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Details go to chiprun_out/chip_smoke.json (phase 11's also to
chiprun_out/chip_smoke_driver.json, phase 12's to
chiprun_out/chip_smoke_bench.json, phase 13's to
chiprun_out/chip_smoke_options.json, phase 14's to
chiprun_out/chip_smoke_graphs.json, phase 16's to
chiprun_out/chip_smoke_scale.json, phase 17's to
chiprun_out/chip_smoke_model.json, phase 18's to
chiprun_out/chip_smoke_ingest.json). InferenceEngine, make_train_step and
the eval steps capture CUDA graphs by default, so phases 8-13 run graphed
after each shape's first, eager call. A replay runs none of the wrappers that count
launches (core/graphs.py adds the capture's count at each replay), so every
call profiled under torch.profiler (phases 8, 9, 10, 12, 13 and 14) holds the
counters' change to the kernels its trace shows, and fails on a
difference.

TF32 is off for matmuls and cuDNN throughout, so every comparison and time
is strict float32 (the entry points force it too, core/precision.py), but
for the one forward timed with TF32 on and phases 12-13's bf16 ones.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM data sheet, CUDA cores
TF32_FLOPS_PER_S = 495e12      # H100 SXM data sheet, dense TF32 tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM data sheet, dense BF16 tensor cores
# Tolerances of the kernel against its plain version and against float64:
# the kernel's 3xTF32 products are each within ~2^-22 of the exact product
# (float32-accurate), summed in float32 in another order (8 channels an mma,
# chunks of 40, slices of D, against cuBLAS' own tiling), so scores in
# [-1, 1] differ by a few ulps times sqrt(D).
CORR_ATOL, CORR_RTOL = 2e-5, 1e-5
# auto vs plain full forward: the score differences above pass through six
# decoder stages; the JAX suite's own torch tolerances.
FWD_SCORE_ATOL, FWD_LOGIT_ATOL, FWD_LOGIT_RTOL, FWD_HEATMAP_ATOL = 5e-4, 5e-4, 1e-3, 1e-6
FWD_ORI_ATOL, ORI_NORM_FLOOR = 1e-4, 1e-2
# B2 against its plain version: float32 sums of up to 9*56 terms in another
# order, relative to the output's max abs. B3 against its plain version on
# dyadic inputs: each gradient scaled by its max abs (the weight gradients
# sum ~500k pixels in another order).
LMU_FWD_RTOL, LMU_BWD_ATOL = 1e-5, 5e-5
# The fused train step against the unfused (cuDNN) step from the same
# state: losses in float32 reductions of another order; gradients scaled
# by their max abs as tests/test_lmu_fused_model.py:137-139; BN stats as
# tests/test_train_parity.py:82-85. The corr backward through the kernel
# against autograd of its plain version: scaled by the max abs, float32
# sums in another order.
STEP_LOSS_RTOL, STEP_GRAD_ATOL = 1e-4, 5e-4
BN_MEAN_ATOL, BN_VAR_RTOL, BN_VAR_ATOL = 1e-5, 2e-4, 1e-5
CORR_GRAD_ATOL = 1e-4
# The 3xTF32 primitive against a float64 matmul, relative to the output's
# max: 3xTF32 lands near 1e-6 there and one TF32 product near 1e-4, so the
# bound tells the two apart.
PROBE_RTOL = 1e-5
PROBE_SHAPES = ((81, 40, 64), (56, 1, 16), (40, 32, 64), (41, 16, 16), (5, 3, 4))  # M, N, K
OUT_DIR = "chiprun_out"
# Timed repetitions of each eval loop (phase 10), after the counted one.
EVAL_TIMED_LOOPS = 5
# B3's tensor-core convs off the VIGOR widths -> the tile T its plan must
# pick. At T = 8, da, dh|dskip and dx each with a ragged last k-step (K a
# tap 6, 37, 21) and a ragged last n-group (N 37, 35, 131: 5, 5, 17
# n-tiles in groups of 4, 2, 2); at T = 4 (T = 8's planes and one weight
# buffer pass the card's 227 KB a block), each with a ragged k-step and
# da's n-groups ragged (9 n-tiles in groups of 4), dx on a 2 x 2 box.
LMU_TC_CASES = {("tensor cores, ragged K and N", 2, 7, 9, 131, 14, 21, 37, 6): 8,
                ("tensor cores at T 4", 1, 6, 7, 29, 5, 53, 65, 21): 4}
# B2 and B3 off the VIGOR and KITTI widths: Hc and Wc not multiples of any
# tile, no skip and Cout 1; large biases (the border must be zero padding,
# not deconv(0) + bias); ragged channel counts
LMU_EXTRA_CASES = [("ragged, no skip, Cout 1", 2, 13, 21, 9, 0, 8, 12, 1),
                   ("large biases", 2, 10, 12, 12, 5, 8, 16, 3),
                   ("ragged channels", 2, 7, 11, 5, 3, 7, 9, 3)]
# The bf16 B3 off the VIGOR and KITTI widths at the T = 4 its plan must pick
# (T = 8's planes and one weight buffer pass a block's 227 KB; the Python
# mirror names the same T), every channel count ragged: skip after an odd Cd
# (loaded by loads and stores), x and dy padded by the wrapper
LMU_BF16_T4_CASE = ("bf16 B3 at T 4", 1, 5, 6, 13, 5, 69, 101, 21)

# HMMA opcodes in the SASS of each lmu_bwd_kernel instantiation, and k
# cycles a tile of B3's da, dh|dskip and dx phases at the four VIGOR calls,
# while those convs ran on the FMAs (this script on an NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md gives the run)
FMA_BWD_HMMA = {8: 804, 4: 336}
FMA_BWD_PHASES = {"loc stage 5": (46.4, 35.1, 13.4), "ori stage 5": (29.0, 23.8, 9.3),
                  "loc stage 6+head": (2.3, 7.0, 5.3), "ori stage 6+head": (2.8, 6.9, 4.7)}


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() with the L2 cache flushed before each call."""
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in times]))


# the L2 flush between timed calls: its kernel separates the calls in a trace
FLUSH_KERNEL = "FillFunctor<unsigned char>"


def trace_ms(fn, reps: int = 20, warmup: int = 3, parts=None):
    """Median device time of fn() from the torch.profiler trace: the sum of
    the durations of the kernels each call ran, the calls told apart by the
    L2 flush (a uint8 fill) before each. Unlike events around the call, the
    host's time between launches (dispatch, planning, the ctypes launch) is
    not counted: a call of a 20-us kernel is the kernel's time. With
    `parts` ({name: predicate of a kernel's name}), each part's median over
    the calls instead, by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # The trace of a child process's window can lose some flushes' records
    # (a few in 20, now and then all). Two calls then read as one, at about
    # twice a call's time: with at least 3/4 of the flushes seen, fewer than
    # a third of the calls merge and the median is still one call's time.
    # A window with fewer is profiled again, at most three times in all.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.fill_(1)
                fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA and not e.is_user_annotation),
                        key=lambda e: e.time_range.start)
        calls = []
        for e in events:
            if FLUSH_KERNEL in e.name:
                calls.append({})
            elif calls:
                key = next((k for k, match in (parts or {}).items() if match(e.name)), "")
                calls[-1][key] = calls[-1].get(key, 0.0) + e.time_range.elapsed_us() / 1e3
        if len(calls) >= reps * 3 // 4 and all(calls):
            if len(calls) < reps:
                log(f"trace_ms: {len(calls)} flushes for {reps} calls in the trace; the median "
                    f"of {len(calls)}")
            if parts is None:
                return float(np.median([sum(c.values()) for c in calls]))
            return {k: float(np.median([c.get(k, 0.0) for c in calls])) for k in parts}
        log(f"trace_ms: {len(calls)} flushes for {reps} calls in the trace; profiling again")
    raise RuntimeError(f"trace_ms: {len(calls)} flushes for {reps} calls; kernels "
                       f"{sorted({e.name[:80] for e in events})[:8]}")


def host_us(fn, n: int = 50) -> float:
    """Median host microseconds of one fn() call, which returns once its
    work is queued (the kernels it launches are shorter than the host's
    time, so the queue never fills)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e6


def corr_inputs(b, n, d, length, shift, bins, center, gen):
    from ccvpe_tpu_torch.ops.corr import build_roll_matrices
    s = torch.randn(b, n, d, device="cuda", generator=gen)
    grd = torch.randn(b, length, device="cuda", generator=gen)
    g_mat, m_mat = build_roll_matrices(grd, d, shift, bins, center)
    g_mat = (g_mat / torch.linalg.vector_norm(grd, dim=-1)[:, None, None]).contiguous()
    return s, g_mat, m_mat.contiguous()


def corr_products(s_bytes=4, round_sq=False):
    """TF32 products B1 issues for each of num's and den2's multiply-adds:
    a float32 S is split into hi and lo, so num takes three (S lo.G' hi,
    S hi.G' lo, S hi.G' hi); a bf16 S is its own hi, so num takes two. den2
    takes two (S^2 lo.M, S^2 hi.M; M is 0/1, exact in TF32), or one where
    S^2 is rounded to bf16 and so exact in TF32."""
    return (3 if s_bytes == 4 else 2), (1 if round_sq else 2)


def corr_bound(b, n, d, k, need_r=False, s_bytes=4, round_sq=False):
    """The least time of one corr_core call: each input read once and each
    output written once at HBM_BYTES_PER_S, or its operations, whichever
    is longer. The operations are the TF32 products the kernel issues
    (corr_products; den2 counted as the dense K x D product it issues) at
    TF32_FLOPS_PER_S and S^2 on the CUDA cores at FP32_FLOPS_PER_S.
    Returns (ms, bound_by, bytes, flops, ms of the operations)."""
    nbytes = s_bytes * b * n * d + 4 * (b * k * d + k * d + (2 if need_r else 1) * b * n * k)
    tc_flops = 2 * b * n * k * d * sum(corr_products(s_bytes, round_sq))
    flops = tc_flops + b * n * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (tc_flops / TF32_FLOPS_PER_S + b * n * d / FP32_FLOPS_PER_S) * 1e3
    return (max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops,
            t_ops)


def vigor_corr_shapes(cfg, batch):
    """(N, D, L, shift) of the six scales the VIGOR forward correlates."""
    g = cfg.sat_grid
    dims = (cfg.sat_desc_dim,) + tuple(cfg.loc_conv_out)
    return [((g * 2 ** s) ** 2, dims[s], cfg.grd_desc_lens[s], cfg.roll_shifts[s])
            for s in range(cfg.num_scales)]


# each launch counter's kernel, as torch.profiler names it (demangled:
# "(anonymous namespace)::corr_fwd_kernel<4, __nv_bfloat16, true>(...)");
# one wrapper call launches one of these, and at most a reduce beside it
TRACED_KERNELS = {
    "corr_fwd": lambda n: "corr_fwd_kernel<" in n and "__nv_bfloat16" not in n,
    "corr_fwd_bf16": lambda n: "corr_fwd_kernel<" in n and "__nv_bfloat16" in n,
    "lmu_fwd": lambda n: "lmu_fwd_kernel" in n,
    "lmu_bwd": lambda n: "lmu_bwd_kernel" in n,
    "lmu_fwd_bf16": lambda n: "lmu_fwd_bf16_kernel" in n,
    "lmu_bwd_bf16": lambda n: "lmu_bwd_bf16_kernel" in n,
}


def profile_call(fn, what, card, p50_ms, ours=("corr_fwd_kernel", "corr_reduce_kernel")):
    """Where one call of fn spends device time: torch.profiler kernel
    totals, the device busy share of the window, the top kernels, and the
    share of the kernels whose names contain one of `ours`. Also each
    kernel's launches as the trace shows them (launches_traced) beside what
    the wrappers' counters added over the call (launches_counted): a
    replayed CUDA graph runs no wrapper, so this is where a replay's
    counted launches (core/graphs.py) are held to the kernels it ran. A
    difference fails the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    before = launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counted = {k: v - before[k] for k, v in launch_counts().items()}
    # Kernels and copies only: CPU ops (aten::*) carry their kernels' time,
    # and the GPU-side user annotations span the same kernels again.
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation
               and e.self_device_time_total > 0]
    # the time at least one kernel or copy ran: the union of their spans
    # (a replayed graph runs some kernels side by side, so the sum of their
    # times can exceed the window)
    union_us, reach = 0.0, float("-inf")
    for start, end in sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                             if e.device_type == DeviceType.CUDA and not e.is_user_annotation):
        if end > reach:
            union_us += end - max(start, reach)
            reach = end
    union_ms = union_us / 1e3
    traced = {k: sum(c for name, _, c in kernels if match(name))
              for k, match in TRACED_KERNELS.items()}
    kernels.sort(key=lambda x: -x[1])
    busy_ms = sum(ms for _, ms, _ in kernels)
    own = {k: sum(ms for name, ms, _ in kernels if k in name) for k in ours}
    log(f"profile {what}: wall {wall_ms:.2f} ms (profiled), device busy {busy_ms:.2f} ms "
        f"({busy_ms / wall_ms:.1%} of the profiled wall, {busy_ms / p50_ms:.1%} of the "
        f"unprofiled p50), {union_ms:.2f} ms with a kernel or copy running [{card}]")
    for k, ms in own.items():
        log(f"  {k}: {ms:.3f} ms ({ms / max(busy_ms, 1e-9):.2%} of device time)")
    for name, ms, count in kernels[:15]:
        log(f"  {ms:9.3f} ms {count:4d}x  {name[:110]}")
    log(f"  launches in the trace {traced}, counted {counted} "
        f"{'ok' if traced == counted else 'FAIL'}")
    if traced != counted:
        raise RuntimeError(f"profile {what}: the trace shows launches {traced}, the wrappers' "
                           f"counters {counted}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, busy_union_ms=union_ms, ours_ms=own,
                launches_traced=traced,
                launches_counted=counted,
                kernels=[dict(name=n, ms=ms, count=c) for n, ms, c in kernels[:40]],
                names={n: c for n, _, c in kernels})


# --- the fused LMU stage (B2 forward, B3 backward) ---

def lmu_call_shapes(cfg, batch, prefix=""):
    """(name, B, Hc, Wc, Cin, Cs, Cd, C1, Cout) of the four fused calls of a
    train step at lmu_fused_min_res=256: stage 5 of both decoders (skip =
    sat block 0, 16 channels at 256^2; the loc decoder's input carries the
    score max as one more channel) and the final stage with its head."""
    hc = cfg.sat_size[0] // 4          # 128: the input of the 256^2 stage
    return [
        (prefix + "loc stage 5", batch, hc, hc, cfg.loc_conv_out[3] + 1, 16,
         cfg.loc_deconv_out[4], cfg.loc_conv_out[4], cfg.loc_conv_out[4]),
        (prefix + "ori stage 5", batch, hc, hc, cfg.ori_conv_out[3], 16,
         cfg.ori_deconv_out[4], cfg.ori_conv_out[4], cfg.ori_conv_out[4]),
        (prefix + "loc stage 6+head", batch, 2 * hc, 2 * hc, cfg.loc_conv_out[4] + 1, 0,
         cfg.loc_deconv_out[5], cfg.head_hidden, 1),
        (prefix + "ori stage 6+head", batch, 2 * hc, 2 * hc, cfg.ori_conv_out[4], 0,
         cfg.ori_deconv_out[5], cfg.head_hidden, 2),
    ]


def lmu_inputs(shape, gen, dyadic=False, bias_scale=0.3, device="cuda"):
    """x, skip, torch-layout weights and biases on `device` (gen's). dyadic: small
    multiples of 1/4 .. 1/16, so that the deconv and conv_a sums are exact
    in float32 in any order and the ReLU mask of the kernel and of the
    plain version agree everywhere (otherwise a pre-activation within
    roundoff of 0 flips a mask bit and moves a gradient by O(1) there)."""
    _, b, hc, wc, cin, cs, cd, c1, cout = shape

    def mk(*size, scale, den=8):
        if dyadic:
            lim = max(1, int(round(scale * den * 2)))
            return torch.randint(-lim, lim + 1, size, device=device, generator=gen).float() / den
        return torch.randn(*size, device=device, generator=gen) * scale

    x = mk(b, hc, wc, cin, scale=1.0, den=4)
    skip = mk(b, 2 * hc, 2 * wc, cs, scale=1.0, den=4) if cs else None
    ws = (mk(cin, cd, 2, 2, scale=cin ** -0.5), mk(cd, scale=bias_scale),
          mk(c1, cd + cs, 3, 3, scale=(9 * (cd + cs)) ** -0.5, den=16), mk(c1, scale=bias_scale),
          mk(cout, c1, 3, 3, scale=(9 * c1) ** -0.5), mk(cout, scale=bias_scale))
    return x, skip, ws


def lmu_convs(shape, backward):
    """{conv: (flops, on the tensor cores)} of the stage's work at one
    shape, each conv by the kernels' route (ops/lmu_cuda.py mirrors their
    rules): B2's deconv, conv_a and conv_b; B3's recompute of h and g, its
    two transposed convs and dx, and its three weight-gradient products
    (always on the tensor cores)."""
    from ccvpe_tpu_torch.ops import lmu_cuda
    _, b, hc, wc, cin, cs, cd, c1, cout = shape
    c, pix = cd + cs, b * 4 * hc * wc
    convs = {"deconv": (2 * pix * cin * cd, lmu_cuda.tensor_core_conv(cd)),
             "conv_a": (2 * pix * 9 * c * c1, lmu_cuda.tensor_core_conv(c1))}
    if not backward:
        convs["conv_b"] = (2 * pix * 9 * c1 * cout, lmu_cuda.tensor_core_conv(cout))
        return convs
    tc = lmu_cuda.bwd_tensor_core_conv
    convs.update({"da": (2 * pix * 9 * c1 * cout, tc(c1, cout)),
                  "dh|dskip": (2 * pix * 9 * c1 * c, tc(c, c1)),
                  "dx": (2 * pix * cd * cin, tc(cin, cd)),
                  "dw2": (2 * pix * 9 * c1 * cout, True), "dw1": (2 * pix * 9 * c * c1, True),
                  "dwd": (2 * pix * cin * cd, True)})
    return convs


def lmu_bound(shape, backward, act_bytes=4):
    """Least time for the stage's work: each input read once and each
    output written once at HBM_BYTES_PER_S (activations of `act_bytes`,
    weights, y and the weight gradients float32), or its operations,
    whichever is longer. Float32 activations: each conv at its route's rate
    (lmu_convs: three TF32 products at TF32_FLOPS_PER_S for each float32
    one on the tensor cores, FP32_FLOPS_PER_S on the FMAs); bf16: all at
    the card's BF16_FLOPS_PER_S, the route the bf16 kernels take for every
    conv (csrc/lmu_bf16.cu). Also the float32 kernels' route (route_ms),
    the operations on the CUDA cores alone and all in 3xTF32. Times in
    ms."""
    _, b, hc, wc, cin, cs, cd, c1, cout = shape
    c, pix = cd + cs, b * 4 * hc * wc
    wts = 4 * cin * cd + cd + 9 * c * c1 + c1 + 9 * c1 * cout + cout
    acts = b * hc * wc * cin + pix * cs
    if backward:
        nbytes = act_bytes * (2 * acts + pix * cout) + 4 * 2 * wts
    else:
        nbytes = act_bytes * acts + 4 * (pix * cout + wts)
    convs = lmu_convs(shape, backward)
    flops = sum(f for f, _ in convs.values())

    def route(products):
        return sum((products * f / TF32_FLOPS_PER_S if on_tc else f / FP32_FLOPS_PER_S)
                   for f, on_tc in convs.values()) * 1e3

    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3 if act_bytes == 2 else route(3)
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops, ops_ms=t_ops,
                route_ms=route(3),
                f32_bound_ms=max(t_bytes, flops / FP32_FLOPS_PER_S * 1e3),
                tc_bound_ms=max(t_bytes, 3 * flops / TF32_FLOPS_PER_S * 1e3))


def scaled_err(a, b):
    """max |a - b| / max |b| (1 where b is all zero and a is not)."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def check_lmu(shape, gen, bias_scale=0.3):
    """B2 and B3 against their plain versions on one shape: the forward on
    normal inputs (cuDNN, TF32 off), the backward on dyadic inputs with
    cuDNN off for the plain version (im2col + cuBLAS, exact sums there
    too). Runs B3 twice and requires the same bits."""
    from ccvpe_tpu_torch.ops.lmu import fused_stage_bwd_plain, fused_stage_plain
    from ccvpe_tpu_torch.ops.lmu_cuda import fused_stage, fused_stage_bwd
    x, skip, ws = lmu_inputs(shape, gen, bias_scale=bias_scale)
    y = fused_stage(x, skip, *ws)
    ref = fused_stage_plain(x, skip, *ws)
    torch.cuda.synchronize()
    fwd_err = float((y - ref).abs().max())
    fwd_ok = bool(torch.isfinite(y).all()) and fwd_err <= LMU_FWD_RTOL * max(1.0, float(ref.abs().max()))
    x, skip, ws = lmu_inputs(shape, gen, dyadic=True, bias_scale=bias_scale)
    dy = torch.randn(*y.shape, device="cuda", generator=gen)
    got = fused_stage_bwd(x, skip, dy, *ws)
    again = fused_stage_bwd(x, skip, dy, *ws)
    with torch.backends.cudnn.flags(enabled=False):
        want = fused_stage_bwd_plain(x, skip, dy, *ws)
    torch.cuda.synchronize()
    names = ("dx", "dskip", "dwd", "dbd", "dw1", "db1", "dw2", "db2")
    errs = {n: scaled_err(g, w) for n, g, w in zip(names, got, want) if w is not None}
    same = all(g is None or torch.equal(g, a) for g, a in zip(got, again))
    bwd_ok = same and all(e <= LMU_BWD_ATOL for e in errs.values())
    bwd_abs = max(float((g - w).abs().max()) for g, w in zip(got, want) if w is not None)
    return dict(name=shape[0], shape=list(shape[1:]), fwd_max_abs=fwd_err, bwd_scaled=errs,
                bwd_max_abs=bwd_abs, deterministic=same, ok=fwd_ok and bwd_ok)


def sass_scan(lib_path):
    """{kernel function: ([HMMA opcodes], clock reads)} in the library's
    SASS (cuobjdump from nvcc's toolkit), for the functions whose names
    hold 'kernel'; a clock read is clock64()'s CS2R of SR_CLOCKLO."""
    from ccvpe_tpu_torch.csrc.build import nvcc
    tool = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], check=True, capture_output=True,
                          text=True).stdout
    found, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            if "kernel" in fn:
                found[fn] = ([], 0)
        elif fn in found and "HMMA" in line:
            found[fn][0].append(line.split("*/")[1].split()[0])
        elif fn in found and "SR_CLOCKLO" in line:
            found[fn] = (found[fn][0], found[fn][1] + 1)
    return found


def ptxas_usage(log):
    """{kernel function: (registers, spill store bytes, spill load bytes)}
    from nvcc's -Xptxas -v report, for the functions whose names hold
    'kernel'."""
    import re
    found, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([\w.$]+)", line)
        if m:
            fn = m.group(1) if "kernel" in m.group(1) else None
            if fn:
                found.setdefault(fn, [0, 0, 0])
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            found[fn][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found[fn][0] = int(m.group(1))
    return {k: tuple(v) for k, v in found.items()}


def lmu_kernel_name(fn):
    """'lmu_fwd_kernel<512, float>', 'lmu_bwd_kernel<256, T=8, float>',
    'lmu_fwd_bf16_kernel<256>' or 'lmu_bwd_bf16_kernel<T=16>' for a mangled
    LMU kernel name, else the name cut to 90 characters."""
    import re
    act = "bf16" if "__nv_bfloat16" in fn else "float"
    m = re.search(r"lmu_fwd_kernelILi(\d+)E", fn)
    if m:
        return f"lmu_fwd_kernel<{m.group(1)}, {act}>"
    m = re.search(r"lmu_bwd_kernelILi(\d+)ELi(\d+)E", fn)
    if m:
        return f"lmu_bwd_kernel<{m.group(1)}, T={m.group(2)}, {act}>"
    m = re.search(r"lmu_fwd_bf16_kernelILi(\d+)E", fn)
    if m:
        return f"lmu_fwd_bf16_kernel<{m.group(1)}>"
    m = re.search(r"lmu_bwd_bf16_kernelILi(\d+)E", fn)
    if m:
        return f"lmu_bwd_bf16_kernel<T={m.group(1)}>"
    return fn[:90]


def lmu_bwd_tile(fn):
    """T of a mangled lmu_bwd_kernel instantiation, else None."""
    import re
    m = re.search(r"lmu_bwd_kernelILi\d+ELi(\d+)E", fn)
    return int(m.group(1)) if m else None


def check_probe(gen, bf16=False):
    """mma_probe (the 3xTF32 primitive alone) against a float64 matmul at
    PROBE_SHAPES, twice for the same bits; one TF32 product's error beside
    it shows what the bound tells apart. bf16: the bf16 primitive (ldmatrix
    and mma.sync.m16n8k16) on bf16 operands, against its plain version
    a.float() @ b.float() (exact products, float32 sums in another order)
    and against float64."""
    from ccvpe_tpu_torch.ops.lmu_cuda import mma_probe
    from ccvpe_tpu_torch.ops.tf32 import round_tf32
    rows = []
    for m, n, k in PROBE_SHAPES:
        a = torch.randn(m, k, device="cuda", generator=gen)
        b = torch.randn(k, n, device="cuda", generator=gen)
        if bf16:
            a, b = a.bfloat16(), b.bfloat16()
        got, again = mma_probe(a, b), mma_probe(a, b)
        want = a.double() @ b.double()
        one = a.float() @ b.float() if bf16 else round_tf32(a) @ round_tf32(b)
        torch.cuda.synchronize()
        err, err_1x = scaled_err(got.double(), want), scaled_err(one.double(), want)
        same = torch.equal(got, again)
        plain = scaled_err(got, one) if bf16 else None
        rows.append(dict(m=m, n=n, k=k, scaled_err=err, scaled_err_1xtf32=err_1x,
                         scaled_err_plain=plain,
                         max_abs=float((got.double() - want).abs().max()),
                         deterministic=same,
                         ok=same and err <= PROBE_RTOL and (plain is None or plain <= PROBE_RTOL)))
    return rows


def time_probe(gen, bf16=False):
    """Kernel / plain / torch.matmul times of mma_probe at PROBE_SHAPES[0],
    beside the bound of its 3xTF32 products at 495 TFLOP/s or its bytes
    (bf16: one bf16 product at 989 TFLOP/s, 2-byte operands)."""
    from ccvpe_tpu_torch.ops.lmu_cuda import mma_probe
    from ccvpe_tpu_torch.ops.tf32 import matmul_3xtf32_plain
    m, n, k = PROBE_SHAPES[0]
    a = torch.randn(m, k, device="cuda", generator=gen)
    b = torch.randn(k, n, device="cuda", generator=gen)
    if bf16:
        a, b = a.bfloat16(), b.bfloat16()
        t_bytes = (2 * (m * k + k * n) + 4 * m * n) / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * m * n * k / BF16_FLOPS_PER_S * 1e3
        plain = lambda: a.float() @ b.float()            # noqa: E731
    else:
        t_bytes = 4 * (m * k + k * n + m * n) / HBM_BYTES_PER_S * 1e3
        t_ops = 3 * 2 * m * n * k / TF32_FLOPS_PER_S * 1e3
        plain = lambda: matmul_3xtf32_plain(a, b)        # noqa: E731
    return dict(ms=time_ms(lambda: mma_probe(a, b)), plain_ms=time_ms(plain),
                library_ms=time_ms(lambda: torch.matmul(a, b)),
                bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def time_lmu(shape, gen):
    """Kernel, plain and cuDNN-chain times of B2 and B3 at one shape."""
    import torch.nn.functional as F
    from ccvpe_tpu_torch.ops import lmu_cuda
    from ccvpe_tpu_torch.ops.lmu import fused_stage_bwd_plain, fused_stage_plain
    from ccvpe_tpu_torch.ops.lmu_cuda import fused_stage, fused_stage_bwd
    x, skip, ws = lmu_inputs(shape, gen)
    wd, bd, w1, b1, w2, b2 = ws
    dy = torch.randn(shape[1], 2 * shape[2], 2 * shape[3], shape[8], device="cuda", generator=gen)
    # the unfused chain as the decoder runs it: NCHW in channels_last memory
    xc = x.permute(0, 3, 1, 2).requires_grad_()
    sc = None if skip is None else skip.permute(0, 3, 1, 2).requires_grad_()
    params = [w.detach().clone().requires_grad_() for w in ws]

    def chain():
        h = F.conv_transpose2d(xc, params[0], params[1], stride=2)
        if sc is not None:
            h = torch.cat([h, sc], dim=1)
        g = F.relu(F.conv2d(h, params[2], params[3], padding=1))
        return F.conv2d(g, params[4], params[5], padding=1)

    out = chain()
    dyc = dy.permute(0, 3, 1, 2)
    leaves = [xc] + ([sc] if sc is not None else []) + params
    row = dict(name=shape[0])
    row["fwd_ms"] = time_ms(lambda: fused_stage(x, skip, *ws))
    row["fwd_t8_ms"] = time_ms(lambda: fused_stage(x, skip, *ws, tile=8))
    row["fwd_plain_ms"] = time_ms(lambda: fused_stage_plain(x, skip, *ws))
    with torch.no_grad():
        row["fwd_chain_ms"] = time_ms(chain)
    row["bwd_ms"] = time_ms(lambda: fused_stage_bwd(x, skip, dy, *ws))
    row["bwd_plain_ms"] = time_ms(lambda: fused_stage_bwd_plain(x, skip, dy, *ws))
    row["bwd_chain_ms"] = time_ms(lambda: torch.autograd.grad(out, leaves, dyc, retain_graph=True))
    t = lmu_cuda.fwd_tile(*shape[4:], limit=torch.cuda.get_device_properties(0)
                          .shared_memory_per_block_optin)
    row["fwd_mma"] = lmu_cuda.fwd_mma_count(*shape[1:], t)
    row["bwd_mma"] = lmu_cuda.bwd_mma_count(*shape[1:], lmu_cuda.bwd_plan(x, skip, wd, w1, w2)["t"])
    for key, bwd in (("fwd", False), ("bwd", True)):
        row.update({f"{key}_{k}": v for k, v in lmu_bound(shape, bwd).items()})
    return row


def phase_split(shape, gen, kernel_ms, bf16=False):
    """B3's split by phase at one shape: the timed library's block cycles
    per phase (summed over blocks), each phase's share, and that share of
    the untimed kernel's time `kernel_ms` (the wrapper's, from time_lmu or
    time_lmu_bf16); the timed kernel's own time beside it, and whether its
    outputs are the untimed kernel's bits. bf16: x, skip and dy in bf16
    (the bf16 kernels)."""
    from ccvpe_tpu_torch.ops.lmu_cuda import (BWD_PHASES, bwd_phase_cycles, bwd_plan,
                                              fused_stage_bwd)
    _, b, hc, wc, *_, cout = shape
    x, skip, ws = lmu_inputs(shape, gen)
    dy = torch.randn(b, 2 * hc, 2 * wc, cout, device="cuda", generator=gen)
    if bf16:
        x, dy = x.to(torch.bfloat16), dy.to(torch.bfloat16)
        skip = None if skip is None else skip.to(torch.bfloat16)
    plan = bwd_plan(x, skip, ws[0], ws[2], ws[4])
    got, cycles = bwd_phase_cycles(x, skip, dy, *ws)
    want = fused_stage_bwd(x, skip, dy, *ws)
    torch.cuda.synchronize()
    same = all(g is None or torch.equal(g, w) for g, w in zip(got, want))
    timed_ms = time_ms(lambda: bwd_phase_cycles(x, skip, dy, *ws))
    per_phase = cycles.sum(0).tolist()
    total = sum(per_phase)
    phases = [dict(phase=name, share=c / total, ms=c / total * kernel_ms,
                   cycles_per_tile=c / plan["tiles"])
              for name, c in zip(BWD_PHASES, per_phase)]
    return dict(name=shape[0], kernel_ms=kernel_ms, timed_ms=timed_ms, same_bits=same,
                tiles_per_block=plan["tiles"] / plan["blocks"], phases=phases, **plan)


def log_phases(what, shape, r, card):
    """Two lines of phase_split's result r at one shape."""
    log(f"{what} {shape[0]:18s}: untimed {r['kernel_ms']:.3f} ms, timed "
        f"{r['timed_ms']:.3f} ms, T {r['t']}, weights {r['weights']}, planes ahead "
        f"{r['planes_ahead']}, {r['blocks']} blocks x "
        f"{r['tiles_per_block']:.1f} tiles, same bits as untimed {r['same_bits']} [{card}]")
    log("  " + "; ".join(f"{p['phase']} {p['share']:.1%} {p['ms']:.3f} ms "
                          f"{p['cycles_per_tile']:.0f} cyc/tile" for p in r["phases"]))


def tf32_cost(model, g, s, card, reps=10):
    """The bare CVM forward (no entry point, so the flags apply as set) at
    one batch with TF32 off and on in cuBLAS and cuDNN, in turns: p50 of
    each and the heatmap's largest difference. Leaves TF32 off."""
    times = {False: [], True: []}
    heat = {}
    with torch.inference_mode():
        for i in range(reps + 1):
            for tf32 in (False, True) if i % 2 else (True, False):
                torch.backends.cuda.matmul.allow_tf32 = tf32
                torch.backends.cudnn.allow_tf32 = tf32
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = model(g, s)
                torch.cuda.synchronize()
                if i:                                  # the first round warms up
                    times[tf32].append(time.perf_counter() - t0)
                heat[tf32] = out.heatmap
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p50 = {k: float(np.median(v)) * 1e3 for k, v in times.items()}
    diff = float((heat[True] - heat[False]).abs().max())
    log(f"CVM forward vigor batch {g.shape[0]}: p50 {p50[False]:.2f} ms in float32 (TF32 off), "
        f"{p50[True]:.2f} ms with TF32 on in cuBLAS and cuDNN; heatmap max abs difference "
        f"{diff:.3g} [{card}]")
    return dict(p50_f32_ms=p50[False], p50_tf32_ms=p50[True], heatmap_max_abs_diff=diff)


def grads_close(fused, unfused, atol):
    """Every gradient, scaled by the unfused tensor's max abs; under a floor
    of 1e-6 of the largest gradient a value is float32 roundoff of an exact
    zero (tests/test_torch_train_step.py) and both must stay under it."""
    floor = 1e-6 * max(float(g.abs().max()) for g in unfused.values())
    worst, bad = 0.0, []
    for name, w in unfused.items():
        g = fused[name]
        scale = float(w.abs().max())
        if scale < floor:
            if float(g.abs().max()) >= floor:
                bad.append(name)
            continue
        e = float((g - w).abs().max()) / scale
        worst = max(worst, e)
        if e > atol or not bool(torch.isfinite(g).all()):
            bad.append(name)
    return worst, bad


def corr_grads(sat, grd, shift, bins, center, core, wgt):
    """Grads of sat [B,N,D] and grd [B,L] for sum(core(S, G', M) * wgt)."""
    from ccvpe_tpu_torch.ops.corr import build_roll_matrices
    sat = sat.detach().requires_grad_()
    grd = grd.detach().requires_grad_()
    g_mat, m_mat = build_roll_matrices(grd, sat.shape[-1], shift, bins, center)
    g_mat = g_mat / torch.linalg.vector_norm(grd, dim=-1)[:, None, None]
    out = core(sat, g_mat.contiguous(), m_mat.contiguous())
    (out * wgt).sum().backward()
    return sat.grad, grd.grad


def fused_call_shapes(model, grd, sat):
    """(B, Hc, Wc, Cin, Cs, Cd, C1, Cout) of every fused stage (lmu_fwd) call of one
    train-mode forward, read from the autograd graph's saved inputs."""
    out = model(grd, sat, torch.Generator(device=grd.device).manual_seed(0))
    roots = [out.logits, out.ori] + list(out.matching_scores)
    seen, stack, shapes = set(), [r.grad_fn for r in roots], []
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if "lmu_fwd" in type(node).__name__:       # the op's registered backward
            x, skip, wd, _, w1, _, w2, _ = node.saved_tensors
            shapes.append((*x.shape, 0 if skip is None else skip.shape[-1],
                           wd.shape[1], w1.shape[0], w2.shape[0]))
        stack.extend(fn for fn, _ in node.next_functions)
    return sorted(shapes)


def forward_auto_vs_plain(model, g, s):
    """One batch's CVM forward with corr_impl 'auto' (the kernel) against
    'plain', the same weights and inputs: max abs differences, and whether
    they are finite, of the right shapes and within the forward tolerances
    (the orientation where the raw head output is not near zero)."""
    cfg = model.config
    raw = {}
    hook = model.conv1_ori.register_forward_hook(lambda m, i, o: raw.update(ori=o))
    outs = {}
    with torch.inference_mode():
        for impl in ("auto", "plain"):
            model.config = dataclasses.replace(cfg, corr_impl=impl)
            raw.pop("ori", None)
            outs[impl] = model(g, s)
            if "ori" not in raw:
                # a fused final stage runs its head inside B2: the raw head
                # output from the cuDNN stages, for the mask alone
                model.config = dataclasses.replace(cfg, corr_impl=impl, lmu_fused_min_res=0)
                model(g, s)
            raw[impl] = torch.linalg.vector_norm(raw["ori"], dim=1)[..., None]
    hook.remove()
    model.config = cfg
    a, p = outs["auto"], outs["plain"]
    fwd = {
        "logits": float((a.logits - p.logits).abs().max()),
        "heatmap": float((a.heatmap - p.heatmap).abs().max()),
        "scores": [float((x - y).abs().max()) for x, y in
                   zip(a.matching_scores, p.matching_scores)],
    }
    well = (raw["plain"] > ORI_NORM_FLOOR).expand_as(a.ori)
    fwd["ori_well_posed"] = float((a.ori - p.ori)[well].abs().max())
    hs, ws = s.shape[1:3]
    fwd_ok = (all(torch.isfinite(t).all() for t in (a.logits, a.heatmap, a.ori))
              and torch.allclose(a.logits, p.logits, atol=FWD_LOGIT_ATOL, rtol=FWD_LOGIT_RTOL)
              and fwd["heatmap"] <= FWD_HEATMAP_ATOL
              and fwd["ori_well_posed"] <= FWD_ORI_ATOL
              and all(e <= FWD_SCORE_ATOL for e in fwd["scores"])
              and len(a.matching_scores) == 6
              and tuple(a.heatmap.shape) == (g.shape[0], hs, ws, 1))
    return fwd, fwd_ok


def run_training(card, report, lmu_shapes):
    """The training slice at full width: vigor() with lmu_fused_min_res=256,
    batch 8, random weights from torch.Generator seed 17, uint8 images from
    numpy seed 17. Returns the launches of one step per kernel, or None on
    a failure (logged)."""
    from ccvpe_tpu_torch.core import config as cfg_lib
    from ccvpe_tpu_torch.models.cvm import CVM, random_init_
    from ccvpe_tpu_torch.ops import corr_cuda, lmu_cuda
    from ccvpe_tpu_torch.train.step import (Batch, create_train_state, device_normalize,
                                            make_train_step)
    fused_cfg = dataclasses.replace(cfg_lib.vigor(), lmu_fused_min_res=256)
    train_cfg = cfg_lib.TrainConfig()
    b = 8
    sd = random_init_(CVM(fused_cfg).to_empty(device="cpu"),
                      torch.Generator().manual_seed(17)).state_dict()
    rng = np.random.default_rng(17)
    hg, wg = fused_cfg.grd_size
    hs, ws = fused_cfg.sat_size
    batch = Batch(*(torch.from_numpy(a).cuda() for a in (
        rng.integers(0, 256, (b, hg, wg, 3), dtype=np.uint8),
        rng.integers(0, 256, (b, hs, ws, 3), dtype=np.uint8),
        rng.uniform(-100, 100, b).astype(np.float32),
        rng.uniform(-100, 100, b).astype(np.float32),
        rng.uniform(0, 360, b).astype(np.float32))))

    def first_step(cfg):
        state = create_train_state(cfg, train_cfg, state_dict=sd)
        step = make_train_step(cfg, train_cfg)
        gen = torch.Generator(device="cuda").manual_seed(17)
        state, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        grads = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}
        stats = {n: t.detach().clone() for n, t in state.model.named_buffers()
                 if "running" in n}
        return state, step, gen, {k: float(v) for k, v in metrics.items()}, grads, stats

    # the shapes the fused calls see on this path
    state = create_train_state(fused_cfg, train_cfg, state_dict=sd)
    shapes = fused_call_shapes(state.model, device_normalize(batch.grd[:b]),
                               device_normalize(batch.sat[:b]))
    want = sorted(tuple(s[1:]) for s in lmu_shapes)
    log(f"fused calls on the train path: {shapes}")
    del state
    if shapes != want:
        log(f"FAIL: fused call shapes {shapes}, expected {want}")
        return None

    # one step with the kernels, counted
    corr_cuda.corr_core.launches = 0
    lmu_cuda.fused_stage.launches = 0
    lmu_cuda.fused_stage_bwd.launches = 0
    state, step, gen, m_fused, g_fused, s_fused = first_step(fused_cfg)
    launches = {"corr_fwd": corr_cuda.corr_core.launches,
                "lmu_fwd": lmu_cuda.fused_stage.launches,
                "lmu_bwd": lmu_cuda.fused_stage_bwd.launches}
    log(f"train step 1 (fused): {json.dumps(m_fused)}; launches {launches}")
    if launches != {"corr_fwd": 6, "lmu_fwd": 4, "lmu_bwd": 4}:
        log("FAIL: expected launches corr 6, lmu_fwd 4, lmu_bwd 4 per step")
        return None
    if not all(np.isfinite(v) for v in m_fused.values()) or not all(
            bool(torch.isfinite(g).all()) for g in g_fused.values()):
        log("FAIL: non-finite loss or gradient")
        return None

    # the same step through cuDNN (lmu_fused_min_res=0), from the same state
    plain_state, _, _, m_plain, g_plain, s_plain = first_step(cfg_lib.vigor())
    del plain_state
    torch.cuda.empty_cache()
    loss_err = {k: abs(m_fused[k] - m_plain[k]) / abs(m_plain[k]) for k in m_plain}
    grad_worst, grad_bad = grads_close(g_fused, g_plain, STEP_GRAD_ATOL)
    stat_bad = []
    for k, w in s_plain.items():
        ok = (torch.allclose(s_fused[k], w, atol=BN_MEAN_ATOL, rtol=0) if k.endswith("mean")
              else torch.allclose(s_fused[k], w, rtol=BN_VAR_RTOL, atol=BN_VAR_ATOL))
        if not ok:
            stat_bad.append(k)
    cmp_ok = (all(e <= STEP_LOSS_RTOL for e in loss_err.values()) and not grad_bad
              and not stat_bad)
    log(f"fused vs unfused step: loss rel err {json.dumps(loss_err)}, worst scaled grad err "
        f"{grad_worst:.3g} over {len(g_plain)} tensors (atol {STEP_GRAD_ATOL}), BN stats "
        f"{len(s_plain) - len(stat_bad)}/{len(s_plain)} within tolerance "
        f"{'ok' if cmp_ok else 'FAIL'}")
    report["train_compare"] = dict(loss_rel_err=loss_err, grad_worst=grad_worst,
                                   grad_bad=grad_bad, stat_bad=stat_bad)
    if not cmp_ok:
        log(f"FAIL: gradients {grad_bad[:10]}, stats {stat_bad[:10]}")
        return None

    # p50 step time, pairs/s, peak memory (the second step captures the
    # step's CUDA graph, whose pool holds its activations: counted)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        step(state, batch, gen)
    torch.cuda.synchronize()
    times, losses = [], []
    for _ in range(8):
        t0 = time.perf_counter()
        _, m = step(state, batch, gen)
        losses.append(float(m["loss"]))           # synchronises
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    p50 = float(np.median(times))
    if not all(np.isfinite(losses)):
        log(f"FAIL: non-finite loss in {losses}")
        return None
    log(f"train vigor batch {b} (f32, TF32 off, lmu_fused_min_res=256): p50 step "
        f"{p50 * 1e3:.2f} ms, {b / p50:.2f} pairs/s, peak memory {peak / 2 ** 30:.2f} GiB, "
        f"losses {[round(x, 1) for x in losses]} [{card}]")
    report["train"] = dict(p50_step_ms=p50 * 1e3, pairs_per_s=b / p50, peak_bytes=peak,
                           step_ms=[t * 1e3 for t in times], losses=losses, first=m_fused)
    report["train_profile"] = profile_call(
        lambda: step(state, batch, gen), "one train step", card, p50 * 1e3,
        ours=("corr_fwd_kernel", "corr_reduce_kernel", "lmu_fwd_kernel", "lmu_bwd_kernel",
              "lmu_reduce_kernel"))
    return launches


class InMemorySplit:
    """An eval split held in memory, made from numpy seed 17: uint8 images
    and the real sample class's other fields (VIGOR's city, KITTI's
    heading), so the port's ThreadedLoader and default_collate see what the
    datasets give them, without image files or PIL."""

    def __init__(self, sample_cls, cfg, n, **extra):
        rng = np.random.default_rng(17)
        hg, wg = cfg.grd_size
        hs, ws = cfg.sat_size
        self.sample_cls, self.n = sample_cls, n
        self.grd = rng.integers(0, 256, (n, hg, wg, 3), dtype=np.uint8)
        self.sat = rng.integers(0, 256, (n, hs, ws, 3), dtype=np.uint8)
        self.fields = dict(row_offset=rng.uniform(-hs / 4, hs / 4, n).astype(np.float32),
                           col_offset=rng.uniform(-ws / 4, ws / 4, n).astype(np.float32),
                           angle_deg=rng.uniform(0, 360, n).astype(np.float32), **extra)

    def __len__(self):
        return self.n

    def __getitem__(self, i, rng=None):
        return self.sample_cls(grd=self.grd[i], sat=self.sat[i],
                               **{k: v[i] for k, v in self.fields.items()})


@contextlib.contextmanager
def recorded_outputs(store):
    """Inside the block, every pipelined eval loop (eval_over_loader's and
    stream_eval's) appends each batch's host outputs, cut to its own rows,
    to `store`: the loop's results as it brought them back, with the step
    unwrapped (so a graphed step gets the pinned buffers as it does in
    use)."""
    from unittest import mock

    from ccvpe_tpu_torch.train import evaluate, stream
    real = evaluate.pipelined

    def recording(*args, **kwargs):
        for outs, raw in real(*args, **kwargs):
            store.append(outs)
            yield outs, raw

    with mock.patch.object(evaluate, "pipelined", recording), \
            mock.patch.object(stream, "pipelined", recording):
        yield


def queued_device_ms(fn, reps: int = 5, spin_cycles: int = 10 ** 9) -> float:
    """Median device time of fn()'s work with the host out of the way: each
    call is queued behind a spin kernel (about half a second) that the host
    outlasts, between CUDA events recorded after the spin and after fn's
    work, so gaps the host's dispatch would leave do not count (for work of
    more launches than the launch queue holds, a part is queued while the
    first runs: then an upper bound)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def reserved_after_gc() -> int:
    """The allocator's reserved bytes once dead objects and cached blocks
    are given back (a live graph's pool stays reserved)."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def run_eval(card, report):
    """The evaluation path at full width on the card: eval_over_loader at
    VIGOR 360, FoV 90, the orientation prior and the fused stages from 256
    px, and at KITTI; stream_eval at Oxford; 20 samples each (batches of 8,
    the last of 4 padded), random weights from torch.Generator seed 17.
    For each: one batch's forward with the kernel against the plain
    correlation, on the loop's own inputs (the FoV-sliced ground image, the
    prior's restricted bins); then the loop with the eager step
    (cuda_graph=False) and with the graphed one (the default), each run
    once to warm up (the graphed step's first batch eager, its second
    captured), once counted, then EVAL_TIMED_LOOPS times each, in turns,
    timed. Per configuration: the graphed decodes, GT pixels and prob@GT
    (the stream's rows, cols and angles) equal the eager ones to the bit,
    the eager ones InferenceEngine.predict's; one capture per shape
    (stream_eval's step cached across its calls); the launches of each
    counted loop; a torch.profiler trace of one graphed loop, whose kernels
    must equal the counters' (profile_call); the summary's values in range;
    the median pairs (frames) per second of each step's timed loops and
    their spread, host decoding and copies included; the reserved memory
    the graph's pool adds, and that it is given back when the model and its
    steps are dropped. The device's idle share over one profiled VIGOR loop,
    eager beside graphed. The entry points take the card as they do by
    default. Returns each configuration's launches in its graphed loop and
    in that loop's trace, or None on a failure (logged)."""
    from ccvpe_tpu_torch.core import config as cfg_lib
    from ccvpe_tpu_torch.data import kitti as kitti_data
    from ccvpe_tpu_torch.data import oxford as oxford_data
    from ccvpe_tpu_torch.data import vigor as vigor_data
    from ccvpe_tpu_torch.data.loader import ThreadedLoader
    from ccvpe_tpu_torch.models.cvm import CVM, build_cvm, random_init_, resolve_device
    from ccvpe_tpu_torch.serve import InferenceEngine
    from ccvpe_tpu_torch.train import stream as stream_mod
    from ccvpe_tpu_torch.train.evaluate import eval_over_loader, slice_fov
    from ccvpe_tpu_torch.train.step import device_normalize, make_eval_decode_step
    from ccvpe_tpu_torch.train.stream import stream_eval

    dev = resolve_device(None)
    n, b = 20, 8
    n_batches = -(-n // b)
    cities = [("NewYork", "Seattle", "SanFrancisco", "Chicago")[i % 4] for i in range(n)]
    vigor, kitti, oxford = cfg_lib.vigor(), cfg_lib.kitti(), cfg_lib.oxford()
    splits = {
        "vigor": InMemorySplit(vigor_data.VigorSample, vigor, n, city=cities),
        "kitti": InMemorySplit(kitti_data.KittiSample, kitti, n,
                               heading_deg=np.random.default_rng(17).uniform(0, 360, n)
                               .astype(np.float32)),
        "oxford": InMemorySplit(oxford_data.OxfordSample, oxford, n),
    }
    vigor_mpp = lambda city: vigor_data.METER_PER_PIXEL[city] / vigor.sat_size[0] * 640.0
    # name -> (config, split, FoV, metres per pixel, launches a forward)
    runs = {
        "vigor": (vigor, "vigor", None, vigor_mpp, {"corr_fwd": 6}),
        "vigor FoV 90": (vigor, "vigor", 90, vigor_mpp, {"corr_fwd": 6}),
        # the bottleneck correlates twice under the prior: all K bins, and
        # the restricted ones that feed the max (models/cvm.py)
        "vigor ori prior 45": (cfg_lib.vigor(ori_noise=45.0), "vigor", None, vigor_mpp,
                               {"corr_fwd": 7}),
        # B2 at the four fused stages, forward only
        "vigor fused 256": (dataclasses.replace(vigor, lmu_fused_min_res=256), "vigor", None,
                            vigor_mpp, {"corr_fwd": 6, "lmu_fwd": 4}),
        "kitti": (kitti, "kitti", None, kitti_data.meter_per_pixel(), {"corr_fwd": 6}),
        "oxford stream": (oxford, "oxford", None,
                          oxford_data.METERS_PER_PIXEL / oxford_data.OUT * oxford_data.CROP,
                          {"corr_fwd": 6}),
    }
    weights = {}
    out = {}
    launches = {}
    modes = ("eager", "graphed")
    rates = ("fps", "aggregate_fps")
    for name, (cfg, split_name, fov, mpp, per_forward) in runs.items():
        split = splits[split_name]
        is_stream = name == "oxford stream"
        if cfg.name not in weights:
            weights[cfg.name] = random_init_(CVM(cfg).to_empty(device="cpu"),
                                             torch.Generator().manual_seed(17)).state_dict()
        mem = {"start": reserved_after_gc()}
        model = build_cvm(cfg, dev, state_dict=weights[cfg.name])
        grd = slice_fov(split.grd, fov) if fov else split.grd
        row = dict(n=n, batch=b, grd_width=int(grd.shape[2]))
        g, s = (device_normalize(torch.from_numpy(a[:b]).to(dev)) for a in (grd, split.sat))
        fwd, fwd_ok = forward_auto_vs_plain(model, g, s)
        log(f"eval {name}: forward auto vs plain: {json.dumps(fwd)} "
            f"{'ok' if fwd_ok else 'FAIL'}")
        row["forward_auto_vs_plain"] = fwd
        del g, s
        if not fwd_ok:
            return None
        if is_stream:
            def loop(mode):
                return stream_eval(model, cfg, split, range(n), batch_size=b,
                                   meters_per_pixel=mpp, num_workers=4,
                                   cuda_graph=mode == "graphed")
        else:
            steps = {mode: make_eval_decode_step(model, cuda_graph=mode == "graphed")
                     for mode in modes}

            def loop(mode):
                loader = ThreadedLoader(split, b, shuffle=False, num_workers=4, drop_last=False)
                return eval_over_loader(steps[mode], loader, mpp, fov=fov, with_prob_at_gt=True)
        want = {k: per_forward.get(k, 0) * n_batches for k in launch_counts()}
        summaries, decoded, counted = {}, {}, {}
        for mode in modes:
            if mode == "graphed":
                mem["before_graph"] = reserved_after_gc()
            else:
                torch.cuda.reset_peak_memory_stats()
                allocated = torch.cuda.memory_allocated()
            loop(mode)      # warm-up (pinned buffers, cuDNN's plans; the graph's capture)
            if mode == "eager":
                mem["eager_peak_above"] = torch.cuda.max_memory_allocated() - allocated
            if mode == "graphed":
                mem["with_graph"] = reserved_after_gc()
            recorded = []
            zero_launch_counts()
            with recorded_outputs(recorded):
                summaries[mode] = loop(mode)
            counted[mode] = launch_counts()
            decoded[mode] = [np.concatenate(col) for col in zip(*recorded)]
        captures = (stream_mod._DECODE_STEPS[model].captures if is_stream
                    else steps["graphed"].captures)
        same_bits = (len(decoded["eager"]) == len(decoded["graphed"])
                     and all(np.array_equal(x, y)
                             for x, y in zip(decoded["eager"], decoded["graphed"]))
                     and ({k: v for k, v in summaries["eager"].items() if k not in rates}
                          == {k: v for k, v in summaries["graphed"].items() if k not in rates}))
        # the same inputs through the serving engine
        engine = InferenceEngine(cfg, weights[cfg.name], batch_size=b)
        served = engine.predict(grd, split.sat)
        rows, cols, angle = decoded["eager"][:3]
        same = (rows.tolist() == [p.row for p in served]
                and cols.tolist() == [p.col for p in served]
                and angle.tolist() == [p.angle_deg for p in served])
        summary = summaries["graphed"]
        hs, ws = cfg.sat_size
        # no error is longer than the patch's diagonal
        longest = np.hypot(hs, ws) * (max(map(mpp, cities)) if callable(mpp) else mpp)
        in_range = (summary.get("frames", n) == n and len(rows) == n
                    and all(np.isfinite(v) for v in summary.values())
                    and bool(((rows >= 0) & (rows < hs) & (cols >= 0) & (cols < ws)).all())
                    and 0.0 <= summary["mean_ori_deg"] <= 180.0
                    and 0.0 <= summary["mean_distance_m"] <= longest)
        row.update(summary=summary, eager_summary=summaries["eager"], launches=counted,
                   want_launches=want, b1_launches=counted["graphed"]["corr_fwd"],
                   same_bits_graphed_eager=same_bits, same_as_predict=same, captures=captures)
        out[name] = row
        log(f"eval {name}: {n} samples in {n_batches} batches (grd width {row['grd_width']}); "
            f"launches a loop eager {counted['eager']}, graphed {counted['graphed']} (want "
            f"{want}); graphed decodes, GT pixels and prob@GT the same bits as eager "
            f"{same_bits}; {captures} capture(s); eager decodes equal "
            f"InferenceEngine.predict's {same}; summary {json.dumps(summary)}")
        if (any(c != want for c in counted.values()) or not same_bits or captures != 1
                or not same or not in_range):
            log(f"FAIL: eval {name}: launches, graphed against eager bits, captures, identity "
                "with predict or summary values")
            return None
        # the loops' rates, in turns (a smoke reading: 20 samples a loop,
        # the pipeline's fill and drain included)
        walls = {mode: [] for mode in modes}
        for i in range(EVAL_TIMED_LOOPS):
            for mode in (modes if i % 2 == 0 else modes[::-1]):
                t0 = time.perf_counter()
                loop(mode)
                walls[mode].append(time.perf_counter() - t0)
        unit = "frames/s" if is_stream else "pairs/s"
        for mode in modes:
            wall = float(np.median(walls[mode]))
            spread = sorted(n / w for w in walls[mode])
            row[mode] = dict(loop_s=walls[mode], pairs_per_s=n / wall)
            log(f"eval {name} batch {b} {mode} (f32, TF32 off; {n} samples a loop, fill and "
                f"drain included): median {n / wall:.2f} {unit} over {EVAL_TIMED_LOOPS} loops "
                f"(min {spread[0]:.2f}, max {spread[-1]:.2f}), median loop {wall * 1e3:.1f} ms "
                f"[{card}]")
        row["pairs_per_s"] = row["graphed"]["pairs_per_s"]
        # the graphed loop's launches held to its trace
        profiled = ("eager", "graphed") if name == "vigor" else ("graphed",)
        for mode in profiled:
            wall = float(np.median(walls[mode]))
            prof = profile_call(lambda: loop(mode), f"one {name} eval loop, {mode}", card,
                                wall * 1e3, ours=("corr_fwd_kernel", "lmu_fwd_kernel"))
            if prof["launches_traced"] != want:
                log(f"FAIL: eval {name} {mode}: the trace shows {prof['launches_traced']}, "
                    f"want {want}")
                return None
            idle = 1.0 - prof["busy_union_ms"] / prof["wall_ms"]
            row[mode].update(profile=prof, idle_share=idle, traced_launches=prof["launches_traced"])
            log(f"eval {name} {mode}: device idle {idle:.1%} of one profiled loop "
                f"({prof['busy_union_ms']:.2f} ms with a kernel or copy running of "
                f"{prof['wall_ms']:.2f} ms; kernel times sum to {prof['busy_ms']:.2f} ms) "
                f"[{card}]")
        if name == "vigor":
            # one batch's device time, eager and replayed, each queued behind
            # a spin: the profiler's kernel durations differ between eager
            # and replayed windows, events on either side of queued work do
            # not depend on them
            batch = [torch.from_numpy(a[:b]).pin_memory() for a in (
                grd, split.sat, split.fields["row_offset"], split.fields["col_offset"])]
            row["queued_device_ms"] = {mode: queued_device_ms(lambda: steps[mode](*batch))
                                       for mode in modes}
            log(f"eval {name}: one batch's device time, queued behind a spin: eager "
                f"{row['queued_device_ms']['eager']:.2f} ms, graphed "
                f"{row['queued_device_ms']['graphed']:.2f} ms [{card}]")
        # the graph's pool, then given back with the model and its steps
        del model, engine, loop
        if not is_stream:
            del steps
        mem["end"] = reserved_after_gc()
        pool = mem["with_graph"] - mem["before_graph"]
        freed = mem["end"] <= mem["before_graph"]
        row["reserved"] = dict(mem, graph_pool=pool, freed=freed)
        log(f"eval {name}: reserved memory {mem['start'] / 2 ** 20:.0f} MiB before the model, "
            f"{mem['before_graph'] / 2 ** 20:.0f} MiB before the graph, "
            f"{mem['with_graph'] / 2 ** 20:.0f} MiB with it (its pool +{pool / 2 ** 20:.0f} "
            f"MiB; an eager loop's peak allocated {mem['eager_peak_above'] / 2 ** 20:.0f} MiB "
            f"above the model), {mem['end'] / 2 ** 20:.0f} MiB once the model and its steps are "
            f"dropped {'ok' if freed else 'FAIL'} [{card}]")
        if not freed:
            return None
        launches[name] = dict(counted=counted["graphed"], traced=row["graphed"]["traced_launches"])
    report["eval"] = out
    return launches


# --- phase 11: the driver, in a child process ---

DRIVER_TIMEOUT_S = 300
# per call on the Trainer's path (vigor(), lmu_fused_min_res=256): a train
# step launches B1 with r at six scales, B2 and B3 at the four fused stages;
# a validation forward B1 at six scales and B2 at the same four stages (the
# fused stages are the model's, in eval as in training), B3 never
DRIVER_STEP_LAUNCHES = {"corr_fwd": 6, "corr_fwd_bf16": 0, "lmu_fwd": 4, "lmu_bwd": 4,
                        "lmu_fwd_bf16": 0, "lmu_bwd_bf16": 0}
DRIVER_VAL_LAUNCHES = {"corr_fwd": 6, "corr_fwd_bf16": 0, "lmu_fwd": 4, "lmu_bwd": 0,
                       "lmu_fwd_bf16": 0, "lmu_bwd_bf16": 0}


def launch_counts() -> dict:
    """Each kernel's launch count; B1's float32 and bf16 S apart."""
    from ccvpe_tpu_torch.ops import corr_cuda, lmu_cuda
    return {"corr_fwd": corr_cuda.corr_core.launches,
            "corr_fwd_bf16": corr_cuda.corr_core.bf16_launches,
            "lmu_fwd": lmu_cuda.fused_stage.launches, "lmu_bwd": lmu_cuda.fused_stage_bwd.launches,
            "lmu_fwd_bf16": lmu_cuda.fused_stage.bf16_launches,
            "lmu_bwd_bf16": lmu_cuda.fused_stage_bwd.bf16_launches}


def zero_launch_counts() -> None:
    from ccvpe_tpu_torch.ops import corr_cuda, lmu_cuda
    corr_cuda.corr_core.launches = 0
    corr_cuda.corr_core.bf16_launches = 0
    lmu_cuda.fused_stage.launches = 0
    lmu_cuda.fused_stage_bwd.launches = 0
    lmu_cuda.fused_stage.bf16_launches = 0
    lmu_cuda.fused_stage_bwd.bf16_launches = 0


def count_delta(before: dict, names) -> dict:
    """The change in core/profiling.py::counters() since `before`, of those
    of `names` that moved."""
    from ccvpe_tpu_torch.core.profiling import counters
    now = counters()
    return {k: now.get(k, 0) - before.get(k, 0) for k in names
            if now.get(k, 0) != before.get(k, 0)}


def count_calls(fn, calls):
    """fn, recording the kernel launches of each call into `calls` (the
    counters are bumped on the host where each kernel is launched)."""
    def counted(*args, **kwargs):
        before = launch_counts()
        out = fn(*args, **kwargs)
        after = launch_counts()
        calls.append({k: after[k] - before[k] for k in after})
        return out
    # an eval step that copies its inputs itself is handed them so still
    counted.takes_host_inputs = getattr(fn, "takes_host_inputs", False)
    return counted


def driver_rows(workdir: str, name: str) -> list:
    """The Trainer's JSONL metric rows without their wall-clock fields."""
    with open(os.path.join(workdir, f"{name}.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k not in ("time", "pairs_per_s")}
                for line in f]


def same_bits(a, b) -> list:
    """Names of the state_dict entries (model or optimizer) that differ."""
    bad = []
    for k in a:
        if torch.is_tensor(a[k]):
            if not torch.equal(a[k], b[k]):
                bad.append(k)
        elif isinstance(a[k], dict):
            bad += [f"{k}.{x}" for x in same_bits(a[k], b[k])]
        elif a[k] != b[k]:
            bad.append(k)
    return bad


def run_driver(card, report) -> bool:
    """The driver at full width, in deterministic mode: vigor() with
    lmu_fused_min_res=256, batch 8, weights from torch.Generator seed 17
    (TrainConfig.seed), an in-memory split from numpy seed 17 of 24 train
    samples (3 steps an epoch) and 12 validation samples (the last batch of
    4 padded), 2 epochs, a log row a step, 2 checkpoints kept, workdirs in a
    temporary directory. A control run of Trainer.fit; a run stopped by
    fake_fail_at_step=4 with a checkpoint every 2 steps; a new Trainer
    resumed from it, held to the control run to the bit; the Trainer's
    validation against eval_over_loader called directly; launches per train
    step and per validation forward; rates, checkpoint sizes and times."""
    import gc
    import tempfile

    from ccvpe_tpu_torch.core import config as cfg_lib
    from ccvpe_tpu_torch.data import vigor as vigor_data
    from ccvpe_tpu_torch.data.loader import ThreadedLoader
    from ccvpe_tpu_torch.train.evaluate import eval_over_loader
    from ccvpe_tpu_torch.train.step import make_eval_decode_step
    from ccvpe_tpu_torch.train.trainer import Trainer

    cfg = dataclasses.replace(cfg_lib.vigor(), lmu_fused_min_res=256)
    b, n_train, n_val = 8, 24, 12
    n = n_train + n_val
    cities = [("NewYork", "Seattle", "SanFrancisco", "Chicago")[i % 4] for i in range(n)]
    split = InMemorySplit(vigor_data.VigorSample, cfg, n, city=cities)
    mpp = lambda city: vigor_data.METER_PER_PIXEL[city] / cfg.sat_size[0] * 640.0  # noqa: E731

    def train_loaders(epoch):
        return ThreadedLoader(split, b, shuffle=True, seed=epoch, num_workers=4,
                              indices=range(n_train))

    def val_loaders(epoch):
        return ThreadedLoader(split, b, shuffle=False, num_workers=4, drop_last=False,
                              indices=range(n_train, n))

    base = dict(batch_size=b, epochs=2, log_every=1, keep_checkpoints=2)
    out = report["driver"] = {}
    fails = []

    def check(ok, what):
        if not ok:
            fails.append(what)
            log(f"FAIL: driver: {what}")
        return ok

    eager_checks, eager_launches = [], dict.fromkeys(launch_counts(), 0)

    def instrument(trainer):
        """Count the train and validation steps' launches, record each
        validation's summary, and hold it to eval_over_loader with an eager
        step on the same weights (its launches kept apart)."""
        steps, forwards, summaries = [], [], []
        trainer.train_step = count_calls(trainer.train_step, steps)
        trainer.eval_step = count_calls(trainer.eval_step, forwards)
        validate = trainer.validate

        def recorded(loaders, meters, epoch):
            summaries.append(validate(loaders, meters, epoch))
            before = launch_counts()
            eager = eval_over_loader(make_eval_decode_step(trainer.state.model, cuda_graph=False),
                                     val_loaders(epoch), mpp)
            for k, v in launch_counts().items():
                eager_launches[k] += v - before[k]
            eager_checks.append(dict(epoch=epoch, same=summaries[-1] == eager))
            return summaries[-1]
        trainer.validate = recorded
        return steps, forwards, summaries

    with tempfile.TemporaryDirectory(prefix="chip_smoke_driver_") as tmp:
        # the control run, counted
        control = Trainer(cfg, cfg_lib.TrainConfig(**base), workdir=f"{tmp}/control")
        control_step, control_eval = control.train_step, control.eval_step
        steps, forwards, summaries = instrument(control)
        zero_launch_counts()
        t0 = time.perf_counter()
        control.fit(train_loaders, val_loaders, mpp)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = {k: v - eager_launches[k] for k, v in launch_counts().items()}
        reserved = dict(now=torch.cuda.memory_reserved(), peak=torch.cuda.max_memory_reserved())
        out["reserved"] = reserved
        log(f"driver control: reserved memory with the train step's and the validation step's "
            f"graphs alive {reserved['now'] / 2 ** 30:.2f} GiB, peak over the run "
            f"{reserved['peak'] / 2 ** 30:.2f} GiB [{card}]")
        # the graphed validation after each epoch against an eager step on
        # the same weights: the graph reads the weights and BN stats the
        # train step changed in place
        out["validate_vs_eager"] = list(eager_checks)
        check(len(eager_checks) == 2 and all(c["same"] for c in eager_checks),
              f"graphed validation against an eager step {eager_checks}")
        log(f"driver control: Trainer.validate (graphed) equals eval_over_loader with an eager "
            f"step on the same weights to the bit after epochs "
            f"{[c['epoch'] + 1 for c in eager_checks if c['same']]} of 2")
        out.update(fit_s=fit_s, fit_launches=fit_launches, step_launches=steps,
                   val_forward_launches=forwards)
        log(f"driver control: Trainer.fit, {control.state.step} steps and {len(summaries)} "
            f"validations in {fit_s:.2f} s; launches {fit_launches}; per step {steps[0]}, "
            f"per validation forward {forwards[0]} [{card}]")
        check(control.state.step == 6 and len(summaries) == 2, "control: 6 steps, 2 validations")
        check(all(c == DRIVER_STEP_LAUNCHES for c in steps) and len(steps) == 6,
              f"launches per train step {steps}, want {DRIVER_STEP_LAUNCHES}")
        check(all(c == DRIVER_VAL_LAUNCHES for c in forwards) and len(forwards) == 4,
              f"launches per validation forward {forwards}, want {DRIVER_VAL_LAUNCHES}")
        rows = driver_rows(f"{tmp}/control", cfg.name)
        check(all(np.isfinite(v) for r in rows for v in r.values()), "finite metric rows")
        check(all(0.0 <= v <= 1.0 for k, v in summaries[-1].items() if "recall" in k)
              and np.isfinite(summaries[-1]["mean_distance_m"]), "validation summary in range")

        # the Trainer's pairs/s from its log rows (the first step of a run
        # pays for the allocator and cuDNN's plans)
        with open(f"{tmp}/control/{cfg.name}.jsonl") as f:
            rates = [r["pairs_per_s"] for r in map(json.loads, f) if "pairs_per_s" in r]
        steady = float(np.median(rates[1:]))
        out.update(pairs_per_s=rates, steady_pairs_per_s=steady)
        log(f"driver: Trainer pairs/s per log row {[round(r, 2) for r in rates]}; steady (median "
            f"of rows 2-6) {steady:.2f} pairs/s, {b / steady * 1e3:.2f} ms a step [{card}]")

        # the Trainer's validation against a direct call, on the same weights
        model = control.state.model
        buffers = {k: v.clone() for k, v in model.named_buffers()}
        via_trainer = control.validate(val_loaders(0), mpp, epoch=2)
        direct = eval_over_loader(make_eval_decode_step(model, cuda_graph=False), val_loaders(0),
                                  mpp)
        changed = [k for k, v in model.named_buffers() if not torch.equal(v, buffers[k])]
        check(via_trainer == direct, f"Trainer.validate {via_trainer} != eval_over_loader {direct}")
        check(not changed and model.training, f"validation moved buffers {changed[:5]} or the mode")
        log(f"driver: Trainer.validate equals eval_over_loader on the same weights: "
            f"{via_trainer == direct}; BN buffers unchanged: {not changed}; model.training "
            f"{model.training}")

        # a run stopped at step 4, then resumed by a new Trainer
        interrupted = Trainer(cfg, cfg_lib.TrainConfig(**base, checkpoint_every_steps=2,
                                                      fake_fail_at_step=4),
                              workdir=f"{tmp}/resumed")
        raised = ""
        try:
            interrupted.fit(train_loaders, val_loaders, mpp)
        except RuntimeError as e:
            if "fake failure" not in str(e):
                raise
            raised = str(e)
        check(raised and interrupted.state.step == 4, "fake failure at step 4")
        timings = control.ckpt.timings + interrupted.ckpt.timings
        del interrupted
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        resumed = Trainer(cfg, cfg_lib.TrainConfig(**base), workdir=f"{tmp}/resumed")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        check(resumed.restored and resumed.cursor == {"epoch": 1, "batch": 1}
              and resumed.state.step == 4, f"restored {resumed.restored}, cursor {resumed.cursor}")
        t0 = time.perf_counter()
        resumed.ckpt.restore_latest(resumed.state)       # the same file again, timed alone
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        resumed_step, resumed_eval = resumed.train_step, resumed.eval_step
        _, _, resumed_summaries = instrument(resumed)
        resumed.fit(train_loaders, val_loaders, mpp)
        torch.cuda.synchronize()
        timings += resumed.ckpt.timings
        check(resumed.state.step == 6, f"resumed run ends at step {resumed.state.step}")
        bad_model = same_bits(resumed.state.model.state_dict(), control.state.model.state_dict())
        bad_opt = same_bits(resumed.state.optimizer.opt.state_dict()["state"],
                            control.state.optimizer.opt.state_dict()["state"])
        want_rows = [r for r in rows if not (r["step"] == 4 and "loss" in r)]
        got_rows = driver_rows(f"{tmp}/resumed", cfg.name)
        check(not bad_model and not bad_opt, f"resumed != control: {(bad_model + bad_opt)[:10]}")
        check(resumed_summaries[-1] == summaries[-1], "last validation summaries differ")
        check(got_rows == want_rows, "metric rows differ")
        log(f"driver resume: {raised!r}; a new Trainer restored step 4 at cursor "
            f"{resumed.cursor} and ran to step {resumed.state.step}; its parameters and BN "
            f"buffers ({len(bad_model)} of {len(control.state.model.state_dict())} differ), Adam "
            f"state ({len(bad_opt)} differ), last validation summary "
            f"({resumed_summaries[-1] == summaries[-1]}) and {len(got_rows)} metric rows "
            f"({got_rows == want_rows}) equal the control run's to the bit")

        # the Trainer's step is a CUDA graph: the control run captured once,
        # and the resumed Trainer's restored state captured anew; each
        # Trainer's validation step captured once (its second batch) and
        # replayed that graph in every later validation
        captures = dict(control=control_step.captures, resumed=resumed_step.captures,
                        control_eval=control_eval.captures, resumed_eval=resumed_eval.captures)
        out["captures"] = captures
        check(captures == {"control": 1, "resumed": 1, "control_eval": 1, "resumed_eval": 1},
              f"graph captures {captures}")
        check(resumed.state.step == 6 and len(eager_checks) == 4 and eager_checks[-1]["same"],
              f"the resumed run's graphed validation against an eager step {eager_checks[-1:]}")
        log(f"driver graphs: the control Trainer's step captured {captures['control']} graph, "
            f"its validation step {captures['control_eval']}; the resumed Trainer's step "
            f"captured {captures['resumed']} anew, on its restored state, its validation step "
            f"{captures['resumed_eval']}; the resumed run's graphed validation equals an eager "
            f"step's {eager_checks[-1]['same']}")

        sizes = [t["bytes"] for t in timings]
        copy_s = [t["copy_s"] for t in timings]
        write_s = [t["write_s"] for t in timings]
        out.update(checkpoints=timings, restore_s=restore_s, resumed_init_s=init_s,
                   bitwise=dict(model=bad_model, optimizer=bad_opt))
        log(f"driver checkpoints: {len(timings)} saves of {np.median(sizes) / 1e6:.1f} MB; host "
            f"copy median {np.median(copy_s) * 1e3:.1f} ms (max {max(copy_s) * 1e3:.1f}), write "
            f"median {np.median(write_s) * 1e3:.1f} ms (max {max(write_s) * 1e3:.1f}) on a "
            f"background thread; restore {restore_s * 1e3:.1f} ms; a resumed Trainer's "
            f"construction {init_s:.2f} s [{card}]")
    return not fails


def driver_main(out_path: str) -> int:
    """Phase 11 in its own process: cuBLAS's fixed workspace (set by the
    parent in the environment) and deterministic mode stay out of phases
    1-10. The kernels were built by the parent; loading finds them."""
    if not torch.cuda.is_available():
        print("chip_smoke --driver: no CUDA device", file=sys.stderr)
        return 2
    from ccvpe_tpu_torch.core.debug import deterministic
    from ccvpe_tpu_torch.ops import corr_cuda, lmu_cuda
    corr_cuda.load_library()
    lmu_cuda.load_library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    report = {}
    with deterministic():
        ok = run_driver(card, report)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    return 0 if ok else 1


def run_driver_child(card, report, train_p50_ms):
    """Phase 11 in a child process; a non-zero exit fails the run. Returns
    the driver's report, or None."""
    res = run_child("--driver", "chip_smoke_driver.json", DRIVER_TIMEOUT_S)
    if res is None:
        return None
    wall, data = res
    driver = data["driver"]
    driver["child_wall_s"] = wall
    step_ms = 8 / driver["steady_pairs_per_s"] * 1e3
    log(f"driver: child process wall {wall:.2f} s; Trainer steady {step_ms:.2f} ms a step "
        f"(deterministic mode) against phase 9's bare train step p50 {train_p50_ms:.2f} ms "
        f"[{card}]")
    report["driver"] = driver
    return driver


# --- phase 12: bench.py's mixed-precision configuration, in a child process ---

BENCH_TIMEOUT_S = 400
BENCH_BATCHES = (8, 96)        # bench.py:45 trains VIGOR at 96
# bench.py:30-75's train configuration: vigor() with these options
# (phase_space_min_res and circular_impl='edgefix' stay at their defaults
# there, remat_policy 'none'; lmu_fused_min_res=0, bench.py:50)
BENCH_OPTIONS = dict(remat_backbone=True, remat_skip_blocks=2, remat_policy="none",
                     deconv_impl="conv", compute_dtype="bfloat16", ori_window=160,
                     lmu_fused_min_res=0, corr_bf16=True)
# the remat combinations held to no remat on the card
REMAT_CASES = {"backbone skip 2": dict(remat_backbone=True, remat_skip_blocks=2),
               "backbone save_dw skip 2": dict(remat_backbone=True, remat_skip_blocks=2,
                                               remat_policy="save_dw"),
               "decoder": dict(remat_decoder=True)}
# the windowed step against the full field (tests/test_ori_window.py:64-81):
# losses in float32 sums of another order, gradients as the JAX suite holds
# them (encoder-side sums of large terms in another reduction order)
WINDOW_LOSS_RTOL, WINDOW_GRAD_ATOL, WINDOW_GRAD_RTOL = 1e-5, 1e-2, 3e-4
# remat against no remat in deterministic mode: the recompute runs the same
# kernels on the same inputs, so the bits; a gradient that is not the same
# bits must be within float32 roundoff of sums in another order, scaled by
# its max abs
REMAT_GRAD_ATOL = 1e-6
# the bf16 step's loss against the float32 step's on the same weights, batch
# and masks: bf16 keeps 8 significant bits (~4e-3 relative a rounding); the
# loss, a mean of many terms, moved 8e-4 at tiny() on the CPU
BF16_LOSS_RTOL = 1e-2
BENCH_LAUNCHES = {"corr_fwd": 1, "corr_fwd_bf16": 5, "lmu_fwd": 0, "lmu_bwd": 0,
                  "lmu_fwd_bf16": 0, "lmu_bwd_bf16": 0}


def bench_batch(cfg, b):
    """uint8 images and GT scalars from numpy seed 17; the last two samples'
    GT near opposite corners, where the ori window clamps to the border."""
    from ccvpe_tpu_torch.train.step import Batch
    rng = np.random.default_rng(17)
    hg, wg = cfg.grd_size
    hs, ws = cfg.sat_size
    row = rng.uniform(-100, 100, b).astype(np.float32)
    col = rng.uniform(-100, 100, b).astype(np.float32)
    row[-2:], col[-2:] = (-(hs / 2 - 6), hs / 2 - 6), (ws / 2 - 6, -(ws / 2 - 6))
    return Batch(*(torch.from_numpy(a).cuda() for a in (
        rng.integers(0, 256, (b, hg, wg, 3), dtype=np.uint8),
        rng.integers(0, 256, (b, hs, ws, 3), dtype=np.uint8),
        row, col, rng.uniform(0, 360, b).astype(np.float32))))


def check_bf16_corr(card, out) -> bool:
    """B1 on a bf16 S at the five decoder scales of a VIGOR forward (batch 8)
    and at one ragged shape (N not a multiple of the tile, D not of 8, so S
    takes the element copies, K at the maximum, centre mode): against its
    plain version with and without r, with S^2 rounded and not, each twice
    for the same bits; against the float32 kernel on S.float() without the
    rounding, to the bit (a bf16 value is its own TF32 hi: the same
    products); the plans' blocks per SM against the occupancy API. Then
    timed at the five scales, on the rounding the bench configuration takes
    there (D < 128), beside the float32 kernel on S.float() and the bound."""
    from ccvpe_tpu_torch.core import config as cfg_lib
    from ccvpe_tpu_torch.ops import corr_cuda
    from ccvpe_tpu_torch.ops.corr import BF16_ROUND_MAX_D
    from ccvpe_tpu_torch.ops.corr_cuda import corr_core, corr_core_plain
    vigor, b = cfg_lib.vigor(), 8
    k20 = tuple(range(vigor.num_bins))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [(f"vigor s{s + 2}", b, n, d, length, shift, k20, False)
             for s, (n, d, length, shift) in enumerate(vigor_corr_shapes(vigor, b)[1:])]
    cases.append(("ragged K=32 D=70", 3, 1000, 70, 50, 3, tuple(range(corr_cuda.MAX_BINS)), True))
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows, max_err = [], 0.0
    for name, bb, n, d, length, shift, bins, center in cases:
        s32, g_mat, m_mat = corr_inputs(bb, n, d, length, shift, bins, center, gen)
        s = s32.bfloat16()
        k = len(bins)
        plan = corr_cuda.corr_plan(bb, n, d, k, sms, 2)
        for rnd in (False, True):
            occ = corr_cuda.kernel_occupancy(plan, k, corr_cuda.S_BF16_ROUND_SQ if rnd
                                             else corr_cuda.S_BF16)
            bare, bare2 = corr_core(s, g_mat, m_mat, round_sq=rnd), corr_core(s, g_mat, m_mat,
                                                                               round_sq=rnd)
            o, r = corr_core(s, g_mat, m_mat, need_r=True, round_sq=rnd)
            o2, r2 = corr_core(s, g_mat, m_mat, need_r=True, round_sq=rnd)
            ref, ref_r = corr_core_plain(s, g_mat, m_mat, need_r=True, round_sq=rnd)
            f32 = None if rnd else corr_core(s.float(), g_mat, m_mat)
            torch.cuda.synchronize()
            same = (torch.equal(bare, bare2) and torch.equal(o, o2) and torch.equal(r, r2)
                    and torch.equal(bare, o))
            err = float((o - ref).abs().max())
            r_rel = float(((r - ref_r).abs() / ref_r.abs()).max())
            as_f32 = None if rnd else float((bare - f32).abs().max())
            ok = (same and occ >= plan.blocks_per_sm
                  and torch.allclose(o, ref, atol=CORR_ATOL, rtol=CORR_RTOL)
                  and torch.allclose(bare, ref, atol=CORR_ATOL, rtol=CORR_RTOL)
                  and torch.allclose(r, ref_r, atol=0.0, rtol=CORR_RTOL)
                  and (rnd or torch.equal(bare, f32)))
            rows.append(dict(name=name, b=bb, n=n, d=d, k=k, round_sq=rnd, max_abs=err,
                             r_max_rel=r_rel, same_bits=same, vs_f32_max_abs=as_f32,
                             occupancy=occ, plan=dataclasses.asdict(plan), ok=ok))
            log(f"check bf16 {name:16s} B={bb} N={n} D={d} K={k} S^2 rounded {rnd!s:5}: out "
                f"max_abs={err:.3g} r max_rel={r_rel:.3g} (atol {CORR_ATOL} rtol {CORR_RTOL}), "
                f"without and with r, same bits twice {same}"
                + ("" if rnd else f"; against the float32 kernel on S.float() {as_f32:.3g} "
                   "(tolerance 0: the same products)")
                + f"; {plan.slices} slices of {plan.width}, {plan.blocks_per_sm} blocks per SM "
                f"assumed ({occ} fit) {'ok' if ok else 'FAIL'}")
            if not ok:
                return False
            max_err = max(max_err, err)
    out["bf16_checks"] = rows
    out["bf16_max_abs_err"] = max_err

    keys = ("ms", "r_ms", "plain_ms", "r_plain_ms", "f32_ms", "f32_r_ms", "matmul2_ms",
            "bound_ms", "r_bound_ms", "f32_bound_ms", "f32_r_bound_ms", "bytes", "f32_bytes",
            "ops_ms", "f32_ops_ms", "event_ms", "r_event_ms")
    tot, timing = dict.fromkeys(keys, 0.0), []
    for name, bb, n, d, length, shift, bins, center in cases[:5]:
        s32, g_mat, m_mat = corr_inputs(bb, n, d, length, shift, bins, center, gen)
        s, k, rnd = s32.bfloat16(), len(bins), d < BF16_ROUND_MAX_D
        row = dict(name=name, n=n, d=d, k=k, round_sq=rnd)
        # each from the trace's kernel durations (trace_ms), as phase 4 times
        # the float32 kernel: events around a call count the op's host time,
        # which at these sizes is as long as the kernel; the kernel also from
        # those events, beside them
        row["ms"] = trace_ms(lambda: corr_core(s, g_mat, m_mat, round_sq=rnd))
        row["f32_ms"] = trace_ms(lambda: corr_core(s32, g_mat, m_mat))
        # the two-matmul yardstick (phase 4's) on bf16 operands: num and den^2
        g16, m16, s16sq = g_mat.transpose(1, 2).bfloat16(), m_mat.t().bfloat16(), s * s
        row["matmul2_ms"] = trace_ms(lambda: (torch.bmm(s, g16), torch.matmul(s16sq, m16)))
        row["plain_ms"] = trace_ms(lambda: corr_core_plain(s, g_mat, m_mat, round_sq=rnd))
        row["r_ms"] = trace_ms(lambda: corr_core(s, g_mat, m_mat, need_r=True, round_sq=rnd))
        row["f32_r_ms"] = trace_ms(lambda: corr_core(s32, g_mat, m_mat, need_r=True))
        row["r_plain_ms"] = trace_ms(lambda: corr_core_plain(s, g_mat, m_mat, need_r=True,
                                                             round_sq=rnd))
        row["event_ms"] = time_ms(lambda: corr_core(s, g_mat, m_mat, round_sq=rnd))
        row["r_event_ms"] = time_ms(lambda: corr_core(s, g_mat, m_mat, need_r=True,
                                                      round_sq=rnd))
        (row["bound_ms"], row["bound_by"], row["bytes"], _,
         row["ops_ms"]) = corr_bound(bb, n, d, k, False, 2, rnd)
        row["r_bound_ms"] = corr_bound(bb, n, d, k, True, 2, rnd)[0]
        (row["f32_bound_ms"], _, row["f32_bytes"], _,
         row["f32_ops_ms"]) = corr_bound(bb, n, d, k)
        row["f32_r_bound_ms"] = corr_bound(bb, n, d, k, True)[0]
        log(f"time bf16 {name:8s} N={n:6d} D={d:4d} S^2 rounded {rnd!s:5}: kernel "
            f"{row['ms']:.4f} ms (float32 S {row['f32_ms']:.4f}), plain {row['plain_ms']:.4f}, "
            f"bf16 two-matmul yardstick {row['matmul2_ms']:.4f}, bound {row['bound_ms']:.4f} "
            f"({row['bound_by']}; {row['bytes'] / 1e6:.1f} MB, "
            f"TF32 products {row['ops_ms']:.4f}; float32 S {row['f32_bound_ms']:.4f} / "
            f"{row['f32_bytes'] / 1e6:.1f} MB / products {row['f32_ops_ms']:.4f}); with r: "
            f"kernel {row['r_ms']:.4f} (float32 S {row['f32_r_ms']:.4f}), plain "
            f"{row['r_plain_ms']:.4f}, bound {row['r_bound_ms']:.4f} (from the trace); events "
            f"around the call {row['event_ms']:.4f}, with r {row['r_event_ms']:.4f} [{card}]")
        timing.append(row)
        for key in keys:
            tot[key] += row[key]
    tot["bound_by"] = ("bytes" if tot["bytes"] / HBM_BYTES_PER_S * 1e3 >= tot["ops_ms"]
                       else "operations")
    log(f"time bf16 S, the five decoder scales (5 launches): kernel {tot['ms']:.4f} ms (float32 "
        f"S {tot['f32_ms']:.4f}), plain {tot['plain_ms']:.4f}, bf16 two-matmul yardstick "
        f"{tot['matmul2_ms']:.4f}, bound {tot['bound_ms']:.4f} "
        f"({tot['bound_by']}; {tot['bytes'] / 1e6:.1f} MB, TF32 products "
        f"{tot['ops_ms']:.4f}; float32 S {tot['f32_bound_ms']:.4f}, "
        f"{tot['f32_bytes'] / 1e6:.1f} MB); with r: kernel {tot['r_ms']:.4f} (float32 S "
        f"{tot['f32_r_ms']:.4f}), plain {tot['r_plain_ms']:.4f}, bound {tot['r_bound_ms']:.4f} "
        f"(from the trace); events around the calls {tot['event_ms']:.4f}, with r "
        f"{tot['r_event_ms']:.4f} [{card}]")
    out["bf16_timing"], out["bf16_timing_total"] = timing, tot
    return True


def one_step(cfg, sd, batch, grads=False):
    """A new train state from sd, one step with drop-connect from a CUDA
    generator of seed 17: (state, step, generator, metrics[, grads,
    buffers])."""
    from ccvpe_tpu_torch.core import config as cfg_lib
    from ccvpe_tpu_torch.train.step import create_train_state, make_train_step
    state = create_train_state(cfg, cfg_lib.TrainConfig(), state_dict=sd)
    step = make_train_step(cfg, cfg_lib.TrainConfig())
    gen = torch.Generator(device="cuda").manual_seed(17)
    state, metrics = step(state, batch, gen)
    torch.cuda.synchronize()
    metrics = {k: float(v) for k, v in metrics.items()}
    if not grads:
        return state, step, gen, metrics
    g = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}
    bufs = {n: t.detach().clone() for n, t in state.model.named_buffers()}
    return state, step, gen, metrics, g, bufs


def check_window_and_remat(card, out, sd) -> bool:
    """In deterministic mode, float32, vigor() at batch 8 on the same
    weights, batch and drop-connect seed: the ori-window step against the
    full field (losses, every gradient), and each remat combination against
    no remat (losses and BN buffers to the bit, gradients to the bit or
    within REMAT_GRAD_ATOL)."""
    from ccvpe_tpu_torch.core import config as cfg_lib
    from ccvpe_tpu_torch.core.debug import deterministic
    vigor = cfg_lib.vigor()
    batch = bench_batch(vigor, 8)
    res = out["deterministic"] = {}
    with deterministic():
        _, _, _, m0, g0, b0 = one_step(vigor, sd, batch, grads=True)
        _, _, _, mw, gw, _ = one_step(dataclasses.replace(vigor, ori_window=160), sd, batch,
                                      grads=True)
        loss_rel = {k: abs(mw[k] - m0[k]) / abs(m0[k]) for k in ("loss", "loss_ori")}
        bad = [n for n, g in g0.items()
               if not torch.allclose(gw[n], g, atol=WINDOW_GRAD_ATOL, rtol=WINDOW_GRAD_RTOL)]
        worst = max(float(((gw[n] - g).abs() / (WINDOW_GRAD_ATOL + WINDOW_GRAD_RTOL * g.abs()))
                          .max()) for n, g in g0.items())
        ok = all(e <= WINDOW_LOSS_RTOL for e in loss_rel.values()) and not bad
        res["ori_window"] = dict(loss_rel=loss_rel, grads_outside=bad, worst_share=worst,
                                 full=m0, windowed=mw, ok=ok)
        log(f"ori_window 160 vs full field (f32, batch 8, deterministic): loss rel {loss_rel['loss']:.3g}, "
            f"loss_ori rel {loss_rel['loss_ori']:.3g} (rtol {WINDOW_LOSS_RTOL}); {len(g0) - len(bad)}/"
            f"{len(g0)} gradients within atol {WINDOW_GRAD_ATOL} rtol {WINDOW_GRAD_RTOL} (worst "
            f"at {worst:.3g} of the bound) {'ok' if ok else 'FAIL'}")
        if not ok:
            log(f"FAIL: windowed gradients {bad[:10]}")
            return False
        del gw
        for name, over in REMAT_CASES.items():
            _, _, _, mr, gr, br = one_step(dataclasses.replace(vigor, **over), sd, batch,
                                           grads=True)
            bufs_bad = [n for n, t in b0.items() if not torch.equal(br[n], t)]
            not_bits = [n for n, g in g0.items() if not torch.equal(gr[n], g)]
            worst = max([scaled_err(gr[n], g0[n]) for n in not_bits], default=0.0)
            ok = mr == m0 and not bufs_bad and worst <= REMAT_GRAD_ATOL
            res[f"remat {name}"] = dict(metrics_equal=mr == m0, buffers_differ=bufs_bad,
                                        grads_not_bitwise=not_bits, worst_scaled=worst, ok=ok)
            log(f"remat {name} vs none (f32, batch 8, drop-connect on, deterministic): losses "
                f"equal {mr == m0}; BN buffers {len(b0) - len(bufs_bad)}/{len(b0)} to the bit; "
                f"gradients {len(g0) - len(not_bits)}/{len(g0)} to the bit, worst scaled "
                f"{worst:.3g} (atol {REMAT_GRAD_ATOL}) {'ok' if ok else 'FAIL'}")
            if not ok:
                return False
            del gr, br
    torch.cuda.empty_cache()
    return True


def time_steps(step, state, batch, gen, n):
    """p50 of n steps (each read back), peak memory since the caller reset
    it (before the step's first call: the capture of its CUDA graph, whose
    pool holds the activations, allocates then), losses."""
    torch.cuda.synchronize()
    times, losses = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        _, m = step(state, batch, gen)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), torch.cuda.max_memory_allocated(), times, losses


def run_bench_steps(card, out, sd) -> bool:
    """bench.py's configuration through create_train_state and
    make_train_step at batch 8 and 96: B1's launches in a step (bf16 and
    float32 S apart), p50 step time, pairs/s, peak memory, one step under
    torch.profiler; beside the
    float32, no-remat, unwindowed step at batch 8 on the same weights, whose
    loss the bf16 step's must be within BF16_LOSS_RTOL of."""
    from ccvpe_tpu_torch.core import config as cfg_lib
    vigor = cfg_lib.vigor()
    bench = dataclasses.replace(vigor, **BENCH_OPTIONS)
    res = out["steps"] = {}
    for b in BENCH_BATCHES:
        batch = bench_batch(bench, b)
        zero_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        state, step, gen, first = one_step(bench, sd, batch)
        launches = launch_counts()
        step(state, batch, gen)                              # warm-up
        p50, peak, times, losses = time_steps(step, state, batch, gen, 6 if b == 8 else 3)
        ok = (launches == BENCH_LAUNCHES and np.isfinite(list(first.values())).all()
              and np.isfinite(losses).all())
        res[f"bf16 batch {b}"] = dict(first=first, launches=launches, p50_step_ms=p50 * 1e3,
                                      pairs_per_s=b / p50, peak_bytes=peak,
                                      step_ms=[t * 1e3 for t in times], losses=losses)
        log(f"train bench.py config batch {b} (bf16, remat skip 2, ori_window 160, conv "
            f"deconv, corr_bf16): launches {launches} (want {BENCH_LAUNCHES}); p50 step "
            f"{p50 * 1e3:.2f} ms, {b / p50:.2f} pairs/s, peak memory {peak / 2 ** 30:.2f} GiB, "
            f"first loss {first['loss']:.6g}, losses {[round(x, 1) for x in losses]} "
            f"{'ok' if ok else 'FAIL'} [{card}]")
        if not ok:
            return False
        res[f"bf16 batch {b}"]["profile"] = profile_call(
            lambda: step(state, batch, gen), f"one bench.py config step at batch {b}", card,
            p50 * 1e3)
        del state, step, batch
        torch.cuda.empty_cache()
    batch = bench_batch(vigor, 8)
    torch.cuda.reset_peak_memory_stats()
    state, step, gen, first = one_step(vigor, sd, batch)
    step(state, batch, gen)
    p50, peak, times, losses = time_steps(step, state, batch, gen, 6)
    want = first["loss"]
    got = res["bf16 batch 8"]["first"]["loss"]
    rel = abs(got - want) / abs(want)
    res["f32 batch 8"] = dict(first=first, p50_step_ms=p50 * 1e3, pairs_per_s=8 / p50,
                              peak_bytes=peak, step_ms=[t * 1e3 for t in times], losses=losses)
    res["bf16_loss_rel"] = rel
    ok = rel <= BF16_LOSS_RTOL and np.isfinite(losses).all()
    log(f"train vigor batch 8 float32 (TF32 off, no remat, no window, unfused), the same weights "
        f"and batch: p50 step {p50 * 1e3:.2f} ms, {8 / p50:.2f} pairs/s, peak memory "
        f"{peak / 2 ** 30:.2f} GiB; the bf16 step's first loss {got:.6g} against its {want:.6g}: "
        f"rel {rel:.3g} (rtol {BF16_LOSS_RTOL}) {'ok' if ok else 'FAIL'} [{card}]")
    del state, step
    torch.cuda.empty_cache()
    return ok


def run_bench_predict(card, out, sd) -> bool:
    """One InferenceEngine.predict batch of 8 under bench.py's configuration
    (eval: no window, no remat): B1's launches, its decode step's rows equal
    predict's, finite maps, and the heatmap peaks against the float32
    model's on the same weights."""
    from ccvpe_tpu_torch.core import config as cfg_lib
    from ccvpe_tpu_torch.serve import InferenceEngine
    from ccvpe_tpu_torch.train.step import make_eval_decode_step, make_eval_step
    vigor = cfg_lib.vigor()
    bench = dataclasses.replace(vigor, **BENCH_OPTIONS)
    batch = bench_batch(vigor, 8)
    grd, sat = batch.grd.cpu().numpy(), batch.sat.cpu().numpy()
    engine = InferenceEngine(bench, sd, batch_size=8)
    zero_launch_counts()
    results = engine.predict(grd, sat)
    launches = launch_counts()
    maps = {}
    for name, model in (("bf16", engine.model), ("f32", InferenceEngine(vigor, sd).model)):
        maps[name] = make_eval_step(model)(batch.grd, batch.sat)
    decoded = make_eval_decode_step(engine.model)(batch.grd, batch.sat, batch.row_offset,
                                                  batch.col_offset)
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(t).all()) for t in maps["bf16"])

    def peaks(heatmap):
        flat = heatmap.reshape(heatmap.shape[0], -1).argmax(dim=1)
        return torch.stack([flat // heatmap.shape[2], flat % heatmap.shape[2]], 1).float()

    dist = (peaks(maps["bf16"][0]) - peaks(maps["f32"][0])).norm(dim=1).cpu()
    same_rows = decoded[0].tolist() == [p.row for p in results]
    want = BENCH_LAUNCHES
    ok = launches == want and finite and same_rows and len(results) == 8
    out["predict"] = dict(launches=launches, finite=finite, decode_equals_predict=same_rows,
                          peak_px_to_f32=dist.tolist(), same_peak=int((dist == 0).sum()),
                          heatmap_max_abs_to_f32=float((maps["bf16"][0] - maps["f32"][0])
                                                       .abs().max()), ok=ok)
    log(f"predict bench.py config batch 8 (bf16, eval): launches {launches} (want {want}); maps "
        f"finite {finite}; decode step rows equal predict's {same_rows}; heatmap peaks equal "
        f"the float32 model's in {int((dist == 0).sum())}/8 samples (pixels apart "
        f"{[round(x, 1) for x in dist.tolist()]}), heatmap max abs difference "
        f"{out['predict']['heatmap_max_abs_to_f32']:.3g} {'ok' if ok else 'FAIL'}")
    return ok


def bench_main(out_path: str) -> int:
    """Phase 12 in its own process (cuBLAS's fixed workspace for the
    deterministic checks, set by the parent in the environment). The
    kernels were built by the parent; loading finds them."""
    if not torch.cuda.is_available():
        print("chip_smoke --bench-config: no CUDA device", file=sys.stderr)
        return 2
    from ccvpe_tpu_torch.core import config as cfg_lib
    from ccvpe_tpu_torch.models.cvm import CVM, random_init_
    from ccvpe_tpu_torch.ops import corr_cuda
    corr_cuda.load_library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    out = {}
    sd = random_init_(CVM(cfg_lib.vigor()).to_empty(device="cpu"),
                      torch.Generator().manual_seed(17)).state_dict()
    t0 = time.perf_counter()
    ok = check_bf16_corr(card, out)
    ok = ok and check_window_and_remat(card, out, sd)
    ok = ok and run_bench_steps(card, out, sd)
    ok = ok and run_bench_predict(card, out, sd)
    out["seconds"] = time.perf_counter() - t0
    with open(out_path, "w") as f:
        json.dump({"bench_config": out}, f, indent=1)
    return 0 if ok else 1


# --- phase 13: the rest of ModelConfig (bf16 B2/B3, edgefix, phase space), in a child ---

OPTIONS_TIMEOUT_S = 400
# B2 and B3 on bf16 activations against their bf16 plain versions: y and
# the gradients scaled by their max abs. The kernel rounds h, g, da, dh,
# dx and dskip to bf16 after float32 sums in another order than the plain
# version's, so a sum within roundoff of a rounding tie flips one bf16 ulp
# (2^-8 relative) at a few elements; on dyadic inputs (the backward's) the
# sums are exact and the two agree to the bit on the CPU.
LMU_BF16_RTOL = 2.0 ** -8
# bench.py's options with the fused stages from 256 px: a train step's
# windowed ori stages (80 and 160 px) stay unfused, so B2 and B3 take the
# loc decoder's stage 5 and final stage + head; an eval forward never
# windows, so B2 takes both decoders' two finest stages
FUSED_BF16_OPTIONS = dict(BENCH_OPTIONS, lmu_fused_min_res=256)
FUSED_BF16_STEP_LAUNCHES = dict(BENCH_LAUNCHES, lmu_fwd_bf16=2, lmu_bwd_bf16=2)
FUSED_BF16_PREDICT_LAUNCHES = dict(BENCH_LAUNCHES, lmu_fwd_bf16=4)
# edgefix against wrap and phase space against the fine stages, float32,
# the same weights and batch: the forward as the JAX suite holds phase
# space to the fine stages (tests/test_phase_space.py:189-203), the train
# step's losses and gradients as phase 9 holds the fused step to the
# unfused one. Either option changes the sums' order in every layer the
# gradient passes on its way back (edgefix: the ground encoder's convs;
# phase space: the decoders', then both encoders'), so a gradient that is
# exactly 0 in exact arithmetic is roundoff on both sides (ROADMAP.md C:
# the logits' bias under the softmax, a ground block's _bn2.bias where
# drop-connect keeps the sample) and cannot be held relative to itself.
# As tests/test_torch_train_step.py:194-214 does, a gradient whose max
# falls under a floor of the model's largest is taken for that roundoff,
# and both sides must stay under it; the floor is OPT_ZERO_GRAD_RTOL, not
# grads_close's 1e-6 (whose two steps share their encoders' sums): float32's
# 2^-24 grown by the square root of the ~4e5 terms of a VIGOR batch-8 BN
# sum is ~4e-5 of a term. On the CPU at tiny() such gradients sit at
# 1e-8-2e-7 of the largest, the real ones at 1e-2.
OPT_HEATMAP_ATOL = 1e-5
OPT_ZERO_GRAD_RTOL = 1e-4


def check_lmu_bf16(shape, gen, bias_scale=0.3):
    """B2 and B3 on bf16 x, skip and dy (csrc/lmu_bf16.cu) against their
    bf16 plain versions (the emulations of their arithmetic,
    ops/lmu_cuda.py): the forward on normal inputs, the backward on dyadic
    ones, each kernel twice for the same bits."""
    from ccvpe_tpu_torch.ops.lmu_cuda import (fused_stage, fused_stage_bwd,
                                              fused_stage_bf16_split_plain,
                                              fused_stage_bwd_bf16_split_plain)

    def bf16(t):
        return None if t is None else t.to(torch.bfloat16)

    dev = gen.device
    x, skip, ws = lmu_inputs(shape, gen, bias_scale=bias_scale, device=dev)
    x, skip = bf16(x), bf16(skip)
    y, y2 = fused_stage(x, skip, *ws), fused_stage(x, skip, *ws)
    ref = fused_stage_bf16_split_plain(x, skip, *ws)
    x, skip, ws = lmu_inputs(shape, gen, dyadic=True, bias_scale=bias_scale, device=dev)
    x, skip = bf16(x), bf16(skip)
    dy = torch.randn(*y.shape, device=dev, generator=gen)
    got, again = fused_stage_bwd(x, skip, dy, *ws), fused_stage_bwd(x, skip, dy, *ws)
    want = fused_stage_bwd_bf16_split_plain(x, skip, dy, *ws)
    names = ("dx", "dskip", "dwd", "dbd", "dw1", "db1", "dw2", "db2")
    fwd_err = scaled_err(y, ref)
    errs = {n: scaled_err(g.float(), w.float()) for n, g, w in zip(names, got, want)
            if w is not None}
    same = torch.equal(y, y2) and all(g is None or torch.equal(g, a) for g, a in zip(got, again))
    dtypes = (y.dtype == torch.float32 and got[0].dtype == torch.bfloat16
              and (got[1] is None or got[1].dtype == torch.bfloat16)
              and all(g.dtype == torch.float32 for g in got[2:]))
    ok = (same and dtypes and bool(torch.isfinite(y).all()) and fwd_err <= LMU_BF16_RTOL
          and all(e <= LMU_BF16_RTOL for e in errs.values()))
    return dict(name=shape[0], shape=list(shape[1:]), fwd_scaled=fwd_err,
                fwd_max_abs=float((y - ref).abs().max()), bwd_scaled=errs,
                bwd_max_abs=max(float((g.float() - w.float()).abs().max())
                                for g, w in zip(got, want) if w is not None),
                deterministic=same, dtypes=dtypes, ok=ok)


def time_lmu_bf16(shape, gen):
    """B2 and B3 on bf16 activations at one shape: kernel, the float32
    kernel on the same values, the plain version (ops/lmu.py's bf16 policy
    on cuDNN float32 convs) and the bf16 cuDNN chain (the library's
    fused-free stage, forward and backward), beside the bounds."""
    import torch.nn.functional as F
    from ccvpe_tpu_torch.ops.lmu import fused_stage_bwd_plain, fused_stage_plain
    from ccvpe_tpu_torch.ops.lmu_cuda import fused_stage, fused_stage_bwd, pad_channels
    x, skip, ws = lmu_inputs(shape, gen)
    x16 = x.to(torch.bfloat16)
    s16 = None if skip is None else skip.to(torch.bfloat16)
    x32 = x16.float()
    s32 = None if s16 is None else s16.float()
    dy = torch.randn(shape[1], 2 * shape[2], 2 * shape[3], shape[8], device="cuda", generator=gen)
    dy16 = dy.to(torch.bfloat16)
    xc = x16.permute(0, 3, 1, 2).requires_grad_()
    sc = None if s16 is None else s16.permute(0, 3, 1, 2).requires_grad_()
    params = [w.detach().to(torch.bfloat16).requires_grad_() for w in ws]

    def chain():
        h = F.conv_transpose2d(xc, params[0], params[1], stride=2)
        if sc is not None:
            h = torch.cat([h, sc], dim=1)
        g = F.relu(F.conv2d(h, params[2], params[3], padding=1))
        return F.conv2d(g, params[4], params[5], padding=1)

    out = chain()
    leaves = [xc] + ([sc] if sc is not None else []) + params
    row = dict(name=shape[0])
    # each from the trace's kernel durations (trace_ms), the kernels also
    # from events around the call (event_ms), as phase 4 times B1
    row["fwd_ms"] = trace_ms(lambda: fused_stage(x16, s16, *ws))
    row["fwd_f32_ms"] = trace_ms(lambda: fused_stage(x32, s32, *ws))
    row["fwd_plain_ms"] = trace_ms(lambda: fused_stage_plain(x16, s16, *ws))
    with torch.no_grad():
        row["fwd_chain_ms"] = trace_ms(chain)
    row["bwd_ms"] = trace_ms(lambda: fused_stage_bwd(x16, s16, dy16, *ws))
    row["bwd_f32_ms"] = trace_ms(lambda: fused_stage_bwd(x32, s32, dy, *ws))
    row["bwd_plain_ms"] = trace_ms(lambda: fused_stage_bwd_plain(x16, s16, dy16, *ws))
    dyc = dy16.permute(0, 3, 1, 2)
    row["bwd_chain_ms"] = trace_ms(lambda: torch.autograd.grad(out, leaves, dyc,
                                                               retain_graph=True))
    row["fwd_event_ms"] = time_ms(lambda: fused_stage(x16, s16, *ws))
    row["bwd_event_ms"] = time_ms(lambda: fused_stage_bwd(x16, s16, dy16, *ws))
    # the wrapper's passes that pad x's channels to a multiple of 8 (in each
    # of the two kernels' times above) and an odd Cout of dy to even (B3's)
    row["x_pad_ms"] = trace_ms(lambda: pad_channels(x16)) if x16.shape[-1] % 8 else 0.0
    row["dy_pad_ms"] = trace_ms(lambda: pad_channels(dy16, 2)) if dy16.shape[-1] % 2 else 0.0
    for key, bwd in (("fwd", False), ("bwd", True)):
        row.update({f"{key}_{k}": v for k, v in lmu_bound(shape, bwd, act_bytes=2).items()})
    return row


def run_lmu_bf16(card, out) -> bool:
    """The bf16 kernels against their plain versions at the VIGOR and KITTI
    calls (batch 8) and phase 6's tensor-core cases, ragged and large-bias
    ones among them; B2's y at every tile against its own tile's bits and
    B3's plan (T, weights) against the Python mirror's tile; then their
    times at the VIGOR calls and B3's split by phase."""
    from ccvpe_tpu_torch.core import config as cfg_lib
    from ccvpe_tpu_torch.ops import lmu_cuda
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = (lmu_call_shapes(cfg_lib.vigor(), 8) + lmu_call_shapes(cfg_lib.kitti(), 8, "kitti ")
              + LMU_EXTRA_CASES + list(LMU_TC_CASES) + [LMU_BF16_T4_CASE])
    out["lmu_bf16_checks"] = rows = []
    for shape in shapes:
        r = check_lmu_bf16(shape, gen, bias_scale=5.0 if shape[0] == "large biases" else 0.3)
        rows.append(r)
        log(f"check lmu bf16 {shape[0]:24s} {shape[1:]}: fwd scaled {r['fwd_scaled']:.3g}, bwd "
            f"scaled {json.dumps({k: float(f'{v:.3g}') for k, v in r['bwd_scaled'].items()})} "
            f"(rtol {LMU_BF16_RTOL:.3g} of each max), dtypes {r['dtypes']}, same bits twice "
            f"{r['deterministic']} {'ok' if r['ok'] else 'FAIL'}")
        if not r["ok"]:
            return False
    # B2's y at its own tile and at every other that fits (B3's among them):
    # the same bits, so B3's recomputed g and ReLU mask are B2's
    smem_optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    out["lmu_bf16_tiles"] = []
    for shape in shapes:
        x, skip, ws = lmu_inputs(shape, gen)
        x, skip = x.bfloat16(), None if skip is None else skip.bfloat16()
        plan = lmu_cuda.bwd_plan(x, skip, ws[0], ws[2], ws[4])
        own = lmu_cuda.bf16_fwd_tile(*shape[4:], limit=smem_optin)
        y = lmu_cuda.fused_stage(x, skip, *ws)
        tiles = [t for t in lmu_cuda.BF16_TILES
                 if lmu_cuda.bf16_fwd_smem_bytes(*shape[4:], t) <= smem_optin]
        same = all(torch.equal(y, lmu_cuda.fused_stage(x, skip, *ws, tile=t)) for t in tiles)
        want_t = lmu_cuda.bf16_bwd_tile(*shape[4:], limit=smem_optin)
        ok = same and plan["t"] in tiles and plan["t"] == want_t
        out["lmu_bf16_tiles"].append(dict(name=shape[0], fwd_t=own, tiles=tiles, same_bits=same,
                                          bwd_plan=plan, ok=ok))
        nbytes = lmu_cuda.bf16_bwd_smem_bytes(*shape[4:], plan["t"], plan["weights"],
                                              plan["planes_ahead"])
        log(f"check lmu bf16 tiles {shape[0]:24s}: B2 T {own} and {tiles} the same bits {same}; "
            f"B3 T {plan['t']} (mirror {want_t}), weights {plan['weights']}, planes ahead "
            f"{plan['planes_ahead']}, {plan['blocks']} blocks, {nbytes} B of {smem_optin} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            return False
    out["lmu_bf16_fwd_max_abs"] = max(r["fwd_max_abs"] for r in rows[:4])
    out["lmu_bf16_bwd_max_abs"] = max(r["bwd_max_abs"] for r in rows[:4])
    out["lmu_bf16_timing"] = timing = []
    tot = {}
    for shape in lmu_call_shapes(cfg_lib.vigor(), 8):
        row = time_lmu_bf16(shape, gen)
        timing.append(row)
        for k, v in row.items():
            if k.endswith(("_ms", "_bytes", "_flops")):
                tot[k] = tot.get(k, 0) + v
        for key in ("fwd", "bwd"):
            log(f"time lmu bf16 {key} {shape[0]:18s}: kernel {row[f'{key}_ms']:.3f} ms, float32 "
                f"kernel {row[f'{key}_f32_ms']:.3f}, plain {row[f'{key}_plain_ms']:.3f}, bf16 "
                f"cuDNN chain {row[f'{key}_chain_ms']:.3f}, bound {row[f'{key}_bound_ms']:.3f} "
                f"({row[f'{key}_bound_by']}; {row[f'{key}_bytes'] / 1e6:.1f} MB, "
                f"{row[f'{key}_flops'] / 1e9:.1f} GFLOP at 989 TFLOP/s "
                f"{row[f'{key}_ops_ms']:.3f}); the wrapper's channel pads: x "
                f"{row['x_pad_ms']:.4f}" + (f", dy {row['dy_pad_ms']:.4f}" if key == "bwd" else "")
                + f" (from the trace); events around the kernel's call "
                f"{row[f'{key}_event_ms']:.3f} [{card}]")
    for key in ("fwd", "bwd"):
        t_b = tot[f"{key}_bytes"] / HBM_BYTES_PER_S * 1e3
        tot[f"{key}_bound_by"] = "bytes" if t_b >= tot[f"{key}_ops_ms"] else "operations"
        log(f"time lmu bf16 {key} per step (4 launches): kernel {tot[f'{key}_ms']:.3f} ms, "
            f"float32 kernel {tot[f'{key}_f32_ms']:.3f}, plain {tot[f'{key}_plain_ms']:.3f}, "
            f"bf16 cuDNN chain {tot[f'{key}_chain_ms']:.3f}, bound {tot[f'{key}_bound_ms']:.3f} "
            f"(from the trace); events around the kernel's calls {tot[f'{key}_event_ms']:.3f} "
            f"[{card}]")
    out["lmu_bf16_timing_total"] = tot
    # B3 on bf16 by phase, from the timed bf16 library
    out["lmu_bf16_bwd_phases"] = []
    for shape, row in zip(lmu_call_shapes(cfg_lib.vigor(), 8), timing):
        r = phase_split(shape, gen, row["bwd_ms"], bf16=True)
        out["lmu_bf16_bwd_phases"].append(r)
        log_phases("phases lmu bwd bf16", shape, r, card)
        if not r["same_bits"]:
            log("FAIL: the timed bf16 B3 computes other bits than the untimed one")
            return False
    return True


def run_fused_bf16_steps(card, out, sd) -> bool:
    """bench.py's options with lmu_fused_min_res=256 through
    create_train_state and make_train_step at batch 8 and 96 (launches
    counted from zero over the first step: the main path of this phase),
    p50, pairs/s and peak memory; then one InferenceEngine.predict batch."""
    from ccvpe_tpu_torch.core import config as cfg_lib
    from ccvpe_tpu_torch.serve import InferenceEngine
    vigor = cfg_lib.vigor()
    cfg = dataclasses.replace(vigor, **FUSED_BF16_OPTIONS)
    res = out["fused_bf16"] = {}
    for b in BENCH_BATCHES:
        batch = bench_batch(cfg, b)
        zero_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        state, step, gen, first = one_step(cfg, sd, batch)
        launches = launch_counts()
        step(state, batch, gen)                              # warm-up
        p50, peak, times, losses = time_steps(step, state, batch, gen, 6 if b == 8 else 3)
        # one replayed step at batch 8 under the profiler: its trace's launches
        traced = (profile_call(lambda: step(state, batch, gen), "one replayed bench.py config "
                               "+ lmu_fused_min_res=256 step at batch 8", card, p50 * 1e3,
                               ours=("lmu_fwd_bf16_kernel", "lmu_bwd_bf16_kernel"))
                  ["launches_traced"] if b == 8 else FUSED_BF16_STEP_LAUNCHES)
        ok = bool(launches == FUSED_BF16_STEP_LAUNCHES and traced == FUSED_BF16_STEP_LAUNCHES
                  and np.isfinite(list(first.values())).all() and np.isfinite(losses).all())
        res[f"batch {b}"] = dict(first=first, launches=launches, p50_step_ms=p50 * 1e3,
                                 pairs_per_s=b / p50, peak_bytes=peak, traced_launches=traced,
                                 step_ms=[t * 1e3 for t in times], losses=losses, ok=ok)
        log(f"train bench.py config + lmu_fused_min_res=256 batch {b} (bf16 B2/B3): launches "
            f"{launches} (want {FUSED_BF16_STEP_LAUNCHES}); p50 step {p50 * 1e3:.2f} ms, "
            f"{b / p50:.2f} pairs/s, peak memory {peak / 2 ** 30:.2f} GiB, first loss "
            f"{first['loss']:.6g} {'ok' if ok else 'FAIL'} [{card}]")
        del state, step, batch
        torch.cuda.empty_cache()
        if not ok:
            return False
    batch = bench_batch(vigor, 8)
    engine = InferenceEngine(cfg, sd, batch_size=8)
    zero_launch_counts()
    results = engine.predict(batch.grd.cpu().numpy(), batch.sat.cpu().numpy())
    launches = launch_counts()
    ok = bool(launches == FUSED_BF16_PREDICT_LAUNCHES and len(results) == 8
              and all(np.isfinite([p.angle_deg, p.probability]).all() for p in results))
    res["predict"] = dict(launches=launches, rows=[p.row for p in results], ok=ok)
    log(f"predict bench.py config + lmu_fused_min_res=256 batch 8 (bf16, eval): launches "
        f"{launches} (want {FUSED_BF16_PREDICT_LAUNCHES}) {'ok' if ok else 'FAIL'}")
    del engine
    torch.cuda.empty_cache()
    return ok


def compare_option(card, out, sd, name, over) -> bool:
    """vigor() with the option `over` against vigor() on the same weights,
    float32, batch 8: the eval forward's heatmap and one train step's
    losses and every gradient, in deterministic mode, and whether each is
    the same bits; then the p50 of each for both, outside deterministic
    mode (cuDNN's deterministic algorithms are far slower at the fine
    stages)."""
    from ccvpe_tpu_torch.core import config as cfg_lib
    from ccvpe_tpu_torch.core.debug import deterministic
    from ccvpe_tpu_torch.models.cvm import build_cvm
    from ccvpe_tpu_torch.train.step import device_normalize, make_eval_step
    base = cfg_lib.vigor()
    cfgs = {"default": base, name: dataclasses.replace(base, **over)}
    batch = bench_batch(base, 8)
    g, s = device_normalize(batch.grd), device_normalize(batch.sat)
    fwd, fwd_ms, steps, step_ms = {}, {}, {}, {}
    for key, cfg in cfgs.items():
        # eager, as this phase has timed the forward since it was added
        step = make_eval_step(build_cvm(cfg, "cuda", state_dict=sd), cuda_graph=False)
        with deterministic():
            fwd[key] = [t.float() for t in step(g, s)]
        times = []                  # timed as the entry points run, not deterministic
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(g, s)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        fwd_ms[key] = float(np.median(times[1:])) * 1e3
        del step
        with deterministic():
            state, tstep, gen, metrics, grads, _ = one_step(cfg, sd, batch, grads=True)
        steps[key] = (metrics, grads)
        tstep(state, batch, gen)                             # warm-up
        step_ms[key] = time_steps(tstep, state, batch, gen, 3)[0] * 1e3
        del state, tstep
        torch.cuda.empty_cache()
    a, b = fwd[name], fwd["default"]
    (ma, ga), (mb, gb) = steps[name], steps["default"]
    heat_err = float((a[0] - b[0]).abs().max())
    fwd_same = all(torch.equal(x, y) for x, y in zip(a, b))
    loss_rel = {k: abs(ma[k] - mb[k]) / max(abs(mb[k]), 1e-30) for k in mb}
    top = max(float(g.abs().max()) for g in gb.values())
    zeros = [k for k in gb if float(gb[k].abs().max()) < OPT_ZERO_GRAD_RTOL * top]
    zero_worst = max([max(float(ga[k].abs().max()), float(gb[k].abs().max())) / top
                      for k in zeros], default=0.0)
    rest_a, rest_b = ({k: g[k] for k in gb if k not in zeros} for g in (ga, gb))
    grad_worst, grad_bad = grads_close(rest_a, rest_b, STEP_GRAD_ATOL)
    worst_name = max(rest_b, key=lambda k: scaled_err(rest_a[k], rest_b[k]))
    worst_scale = float(rest_b[worst_name].abs().max()) / top
    grads_same = all(torch.equal(ga[k], gb[k]) for k in gb)
    ok = bool(heat_err <= OPT_HEATMAP_ATOL and torch.isfinite(a[0]).all()
              and all(e <= STEP_LOSS_RTOL for e in loss_rel.values()) and not grad_bad
              and zero_worst <= OPT_ZERO_GRAD_RTOL)
    out[name] = dict(heatmap_max_abs=heat_err, forward_same_bits=fwd_same, loss_rel=loss_rel,
                     grad_worst=grad_worst, grad_worst_name=worst_name,
                     grad_worst_scale=worst_scale, grad_bad=grad_bad,
                     zero_grads=len(zeros), zero_grad_worst=zero_worst,
                     grads_same_bits=grads_same, forward_ms=fwd_ms, step_ms=step_ms, ok=ok)
    log(f"{name} vs default (vigor f32, batch 8; values in deterministic mode): heatmap max abs "
        f"{heat_err:.3g} "
        f"(atol {OPT_HEATMAP_ATOL}), forward same bits {fwd_same}; step loss rel "
        f"{max(loss_rel.values()):.3g} (rtol {STEP_LOSS_RTOL}), worst scaled grad "
        f"{grad_worst:.3g} at {worst_name}, whose max is {worst_scale:.3g} of the largest "
        f"(atol {STEP_GRAD_ATOL}; {len(grad_bad)} over: "
        f"{grad_bad[:5]}), the {len(zeros)} grads under the roundoff floor at most "
        f"{zero_worst:.3g} of the largest (rtol {OPT_ZERO_GRAD_RTOL}), grads same bits "
        f"{grads_same}; forward p50 "
        f"{fwd_ms[name]:.2f} ms vs {fwd_ms['default']:.2f}, step p50 {step_ms[name]:.2f} ms vs "
        f"{step_ms['default']:.2f} {'ok' if ok else 'FAIL'} [{card}]")
    return ok


def options_main(out_path: str) -> int:
    """Phase 13 in its own process (the environment as phase 12's). The
    kernels were built by the parent; loading finds them."""
    if not torch.cuda.is_available():
        print("chip_smoke --model-options: no CUDA device", file=sys.stderr)
        return 2
    from ccvpe_tpu_torch.core import config as cfg_lib
    from ccvpe_tpu_torch.models.cvm import CVM, random_init_
    from ccvpe_tpu_torch.ops import corr_cuda, lmu_cuda
    corr_cuda.load_library()
    lmu_cuda.load_library()
    lmu_cuda.load_bf16_library()
    lmu_cuda.load_timed_bf16_library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    out = {}
    sd = random_init_(CVM(cfg_lib.vigor()).to_empty(device="cpu"),
                      torch.Generator().manual_seed(17)).state_dict()
    t0 = time.perf_counter()
    ok = run_lmu_bf16(card, out)
    ok = ok and run_fused_bf16_steps(card, out, sd)
    ok = ok and compare_option(card, out, sd, "edgefix", dict(circular_impl="edgefix"))
    ok = ok and compare_option(card, out, sd, "phase space", dict(phase_space_min_res=256))
    out["seconds"] = time.perf_counter() - t0
    with open(out_path, "w") as f:
        json.dump({"model_options": out}, f, indent=1)
    return 0 if ok else 1


# --- phase 14: the compiled executables (export, CUDA graphs), in a child ---

GRAPHS_TIMEOUT_S = 400
# the exported program against the eager forward on the same inputs: rows
# and cols equal, the decoded angle within EXPORT_ANGLE_ATOL degrees
EXPORT_ANGLE_ATOL = 1e-3
# (name, ModelConfig options, batch, B1 nodes, B2 nodes): a forward
# correlates at six scales; with the fused stages from 256 px, B2 takes
# both decoders' two finest stages
EXPORT_CASES = (("vigor batch 1", {}, 1, 6, 0), ("vigor batch 8", {}, 8, 6, 0),
                ("vigor fused batch 8", dict(lmu_fused_min_res=256), 8, 6, 4))
SERVE_REQUESTS, SERVE_TIMED = 20, 10
GRAPH_STEPS, GRAPH_TIMED_STEPS = 3, 8    # steps held bitwise, then timed
# (name, ModelConfig options, launches a step) of the train steps compared
# eager against graphed at batch 8, in deterministic mode
GRAPH_TRAIN_CASES = (("fused f32", dict(lmu_fused_min_res=256), DRIVER_STEP_LAUNCHES),
                     ("bench.py options", BENCH_OPTIONS, BENCH_LAUNCHES))


def op_nodes(blob: bytes) -> dict:
    """The registered ops' nodes in an exported program's graph."""
    import io
    ep = torch.export.load(io.BytesIO(blob))
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    return {op: sum(t.startswith(f"ccvpe_tpu_torch.{op}.") for t in targets)
            for op in ("corr_fwd", "lmu_fwd")}


def run_export(card, out, sd) -> bool:
    """export_program -> bytes -> load_program at EXPORT_CASES, on uint8
    images of numpy seed 17 normalized on the card: the ops' nodes, the
    program's launches, and its outputs against the eager forward and pose
    decode of the same weights on the same inputs."""
    from ccvpe_tpu_torch.core import config as cfg_lib
    from ccvpe_tpu_torch.core.precision import float32_matmuls
    from ccvpe_tpu_torch.models.cvm import build_cvm
    from ccvpe_tpu_torch.ops import pose
    from ccvpe_tpu_torch.serve import export_program, load_program
    from ccvpe_tpu_torch.train.step import device_normalize
    vigor = cfg_lib.vigor()
    rng = np.random.default_rng(17)
    g = device_normalize(torch.from_numpy(rng.integers(0, 256, (8, *vigor.grd_size, 3),
                                                       dtype=np.uint8)).cuda())
    s = device_normalize(torch.from_numpy(rng.integers(0, 256, (8, *vigor.sat_size, 3),
                                                       dtype=np.uint8)).cuda())
    res = out["export"] = {}
    for name, over, b, want_b1, want_b2 in EXPORT_CASES:
        cfg = dataclasses.replace(vigor, **over)
        t0 = time.perf_counter()
        blob = export_program(cfg, sd, batch_size=b)
        export_s = time.perf_counter() - t0
        nodes = op_nodes(blob)
        t0 = time.perf_counter()
        program = load_program(blob)
        load_s = time.perf_counter() - t0
        zero_launch_counts()
        got = program(g[:b], s[:b])
        torch.cuda.synchronize()
        launches = launch_counts()
        model = build_cvm(cfg, "cuda", state_dict=sd)
        with torch.inference_mode(), float32_matmuls():
            o = model(g[:b], s[:b])
            want = (*pose.decode_pose(o.heatmap, o.ori), o.heatmap)
        torch.cuda.synchronize()
        same_rc = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        d = (got[2] - want[2]).abs()
        angle_err = float(torch.minimum(d, 360.0 - d).max())
        heat_err = float((got[3] - want[3]).abs().max())
        same_heat = torch.equal(got[3], want[3])
        ok = (nodes == {"corr_fwd": want_b1, "lmu_fwd": want_b2} and same_rc
              and angle_err <= EXPORT_ANGLE_ATOL
              and launches["corr_fwd"] == want_b1 and launches["lmu_fwd"] == want_b2)
        res[name] = dict(batch=b, nodes=nodes, launches=launches, export_s=export_s,
                         load_s=load_s, blob_mb=len(blob) / 1e6, rows_cols_equal=same_rc,
                         angle_max_err_deg=angle_err, heatmap_max_abs=heat_err,
                         heatmap_same_bits=same_heat, ok=ok)
        log(f"export {name}: {len(blob) / 1e6:.1f} MB in {export_s:.2f} s, loaded in "
            f"{load_s:.2f} s; nodes {nodes} (want B1 {want_b1}, B2 {want_b2}); one run launches "
            f"B1 {launches['corr_fwd']}, B2 {launches['lmu_fwd']}; against the eager forward: "
            f"rows and cols equal {same_rc}, angle max err {angle_err:.3g} deg (atol "
            f"{EXPORT_ANGLE_ATOL}), heatmap max abs {heat_err:.3g}, same bits {same_heat} "
            f"{'ok' if ok else 'FAIL'} [{card}]")
        del program, model, got, want, o, blob
        torch.cuda.empty_cache()
        if not ok:
            return False
    return True


def run_graph_serving(card, out, sd) -> bool:
    """InferenceEngine with and without cuda_graph on phase 8's requests
    (vigor(), SERVE_REQUESTS uint8 requests of numpy seed 17, batch 8, the
    last batch padded): the same PoseResults and B1 launches, each one's p50
    batch latency over SERVE_TIMED batches (host copies included), and the
    device's busy share over one batch under torch.profiler. The process's
    counts (core/profiling.py::counters) over the requests: the graphed
    engine replays every batch (graph.replays = engine.batches, nothing
    eager or captured), the eager one replays none."""
    from ccvpe_tpu_torch.core import config as cfg_lib
    from ccvpe_tpu_torch.core.profiling import counters
    from ccvpe_tpu_torch.serve import InferenceEngine
    vigor = cfg_lib.vigor()
    rng = np.random.default_rng(17)
    grd = rng.integers(0, 256, (SERVE_REQUESTS, *vigor.grd_size, 3), dtype=np.uint8)
    sat = rng.integers(0, 256, (SERVE_REQUESTS, *vigor.sat_size, 3), dtype=np.uint8)
    res = out["serving"] = {}
    results = {}
    for name, flag in (("eager", False), ("graphed", True)):
        engine = InferenceEngine(vigor, sd, batch_size=8, cuda_graph=flag)
        engine.warmup()
        torch.cuda.synchronize()
        zero_launch_counts()
        before = counters()
        results[name] = engine.predict(grd, sat)
        launches = launch_counts()
        counts = count_delta(before, ("engine.batches", "graph.replays", "graph.eager",
                                      "graph.captures"))
        lat = []
        for _ in range(SERVE_TIMED):
            t0 = time.perf_counter()
            engine.predict(grd[:8], sat[:8])
            lat.append(time.perf_counter() - t0)
        p50 = float(np.median(lat))
        prof = profile_call(lambda: engine.predict(grd[:8], sat[:8]),
                            f"one {name} serving batch", card, p50 * 1e3)
        res[name] = dict(launches=launches, p50_batch_ms=p50 * 1e3, pairs_per_s=8 / p50,
                         batch_ms=[t * 1e3 for t in lat], busy_share=prof["busy_ms"] / prof["wall_ms"],
                         busy_ms=prof["busy_ms"], captures=engine.captures,
                         traced_launches=prof["launches_traced"], counts=counts)
        log(f"serving {name} vigor batch 8: {SERVE_REQUESTS} requests launch B1 "
            f"{launches['corr_fwd']}; p50 batch latency {p50 * 1e3:.2f} ms, {8 / p50:.2f} pairs/s, "
            f"device busy {prof['busy_ms']:.2f} ms of a profiled batch "
            f"({res[name]['busy_share']:.1%}); graphs captured {engine.captures}; counts over "
            f"the requests {counts} [{card}]")
        del engine
        torch.cuda.empty_cache()
    same = results["eager"] == results["graphed"]
    want = 6 * -(-SERVE_REQUESTS // 8)
    traced = [res[n]["traced_launches"]["corr_fwd"] for n in ("eager", "graphed")]
    batches = want // 6
    counts_ok = (res["eager"]["counts"] == {"engine.batches": batches}
                 and res["graphed"]["counts"] == {"engine.batches": batches,
                                                  "graph.replays": batches})
    ok = (same and res["eager"]["launches"]["corr_fwd"] == want
          and res["graphed"]["launches"]["corr_fwd"] == want and traced == [6, 6]
          and res["graphed"]["captures"] == 1 and counts_ok)
    res["same_results"] = same
    log(f"serving graphed vs eager: the same {SERVE_REQUESTS} PoseResults {same}; B1 launches "
        f"{want} each; in the trace of one batch (eager, replayed) {traced}, want 6; graphs "
        f"captured {res['graphed']['captures']}, want 1 (warmup's); counts over the requests: "
        f"{batches} batches, replayed {batches} graphed and 0 eager {counts_ok} "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def train_state_bits(state) -> dict:
    """Copies of what a step leaves: parameters, their gradients, buffers,
    the optimizer's state."""
    m = state.model
    return dict(params={n: p.detach().clone() for n, p in m.named_parameters()},
                grads={n: p.grad.detach().clone() for n, p in m.named_parameters()},
                buffers={n: t.detach().clone() for n, t in m.named_buffers()},
                adam={i: {k: v.detach().clone() for k, v in st.items()}
                      for i, st in state.optimizer.opt.state_dict()["state"].items()})


def binding_cost(state, gen, n=50):
    """Median host microseconds of state_binding, which runs before every
    replay, beside a walk over the data_ptr of every parameter, buffer and
    optimizer state tensor (what binding a graph to the tensors' addresses
    would cost)."""
    from ccvpe_tpu_torch.train.step import state_binding

    def walk():
        ptrs = [t.data_ptr() for t in state.model.parameters()]
        ptrs += [t.data_ptr() for t in state.model.buffers()]
        for per_param in state.optimizer.opt.state.values():
            ptrs += [v.data_ptr() for v in per_param.values() if torch.is_tensor(v)]
        return len(ptrs)

    out = []
    for fn in (lambda: state_binding(state, gen), walk):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        out.append(float(np.median(times)) * 1e6)
    return out[0], out[1], walk()


def run_graph_steps(card, out, sd) -> bool:
    """GRAPH_TRAIN_CASES at batch 8, in deterministic mode: GRAPH_STEPS
    steps with make_train_step(cuda_graph=False) and as many with the
    graphed step (the first eager, the second captured and replayed, the
    third replayed), each from the same state, its generator seeded before
    every step as the Trainer does: the same losses, gradients, parameters,
    buffers and Adam state to the bit, the same launches in every step; then
    each one's p50, pairs/s and peak memory over GRAPH_TIMED_STEPS steps and
    its busy share over one step under torch.profiler. At batch 96 the
    process's counts over the timed steps (core/profiling.py::counters):
    every step a replay (graph.replays = train.steps)."""
    from ccvpe_tpu_torch.core import config as cfg_lib
    from ccvpe_tpu_torch.core.debug import deterministic
    from ccvpe_tpu_torch.core.profiling import counters
    from ccvpe_tpu_torch.train.step import create_train_state, make_train_step
    vigor = cfg_lib.vigor()
    tc = cfg_lib.TrainConfig()
    res = out["train"] = {}
    for case, over, want in GRAPH_TRAIN_CASES:
        cfg = dataclasses.replace(vigor, **over)
        batch = bench_batch(cfg, 8)
        row, bits = {}, {}
        res[case] = row
        for name, flag in (("eager", False), ("graphed", True)):
            with deterministic():
                state = create_train_state(cfg, tc, state_dict=sd)
                step = make_train_step(cfg, tc, cuda_graph=flag)
                gen = torch.Generator(device="cuda")
                losses, per_step = [], []
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                for i in range(GRAPH_STEPS):
                    gen.manual_seed(17 + i)
                    zero_launch_counts()
                    _, m = step(state, batch, gen)
                    torch.cuda.synchronize()
                    per_step.append(launch_counts())
                    losses.append({k: float(v) for k, v in m.items()})
                bits[name] = train_state_bits(state)
                times = []
                for i in range(GRAPH_TIMED_STEPS):
                    gen.manual_seed(17 + GRAPH_STEPS + i)
                    t0 = time.perf_counter()
                    _, m = step(state, batch, gen)
                    float(m["loss"])
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
                p50 = float(np.median(times))
                prof = profile_call(lambda: step(state, batch, gen), f"one {name} {case} step",
                                    card, p50 * 1e3)
            row[name] = dict(losses=losses, launches=per_step, p50_step_ms=p50 * 1e3,
                             pairs_per_s=8 / p50, step_ms=[t * 1e3 for t in times],
                             peak_bytes=peak, reserved_bytes=reserved,
                             busy_ms=prof["busy_ms"], busy_share=prof["busy_ms"] / prof["wall_ms"],
                             captures=getattr(step, "captures", 0),
                             traced_launches=prof["launches_traced"])
            if flag:
                bind_us, walk_us, n_tensors = binding_cost(state, gen)
                row[name].update(binding_us=bind_us, tensor_walk_us=walk_us,
                                 state_tensors=n_tensors)
                log(f"train graphed {case}: state_binding {bind_us:.2f} us a step (host); a "
                    f"walk over the data_ptr of the state's {n_tensors} tensors {walk_us:.2f} "
                    f"us [{card}]")
            log(f"train {name} {case} batch 8 (deterministic mode): p50 step {p50 * 1e3:.2f} ms, "
                f"{8 / p50:.2f} pairs/s, device busy {prof['busy_ms']:.2f} ms of a profiled step "
                f"({row[name]['busy_share']:.1%}), peak memory {peak / 2 ** 30:.2f} GiB allocated, "
                f"{reserved / 2 ** 30:.2f} GiB reserved; launches a step {per_step[-1]}; graphs "
                f"captured {row[name]['captures']} [{card}]")
            del state, step
            torch.cuda.empty_cache()
        e, gr = bits["eager"], bits["graphed"]
        bad = {k: same_bits(e[k], gr[k]) for k in e}
        bad["adam"] = same_bits({str(i): v for i, v in e["adam"].items()},
                                {str(i): v for i, v in gr["adam"].items()})
        same_losses = row["eager"]["losses"] == row["graphed"]["losses"]
        launches_ok = (all(c == want for c in row["eager"]["launches"] + row["graphed"]["launches"])
                       and all(row[n]["traced_launches"] == want for n in ("eager", "graphed")))
        ok = same_losses and not any(bad.values()) and launches_ok
        row.update(differ={k: v[:10] for k, v in bad.items()}, same_losses=same_losses, ok=ok)
        log(f"train graphed vs eager, {case}, {GRAPH_STEPS} steps: losses the same bits "
            f"{same_losses}; differing tensors {json.dumps({k: len(v) for k, v in bad.items()})} "
            f"of {json.dumps({k: len(v) for k, v in e.items()})}; launches in every step "
            f"{want}, and in the trace of a profiled (eager, replayed) step, {launches_ok} "
            f"{'ok' if ok else 'FAIL'}")
        del bits, e, gr
        torch.cuda.empty_cache()
        if not ok:
            return False
    # bench.py's options at batch 96, graphed: the eager first step's peak,
    # then the peak with the graph's private pool on top
    cfg = dataclasses.replace(vigor, **BENCH_OPTIONS)
    batch = bench_batch(cfg, 96)
    state = create_train_state(cfg, tc, state_dict=sd)
    step = make_train_step(cfg, tc)
    gen = torch.Generator(device="cuda").manual_seed(17)
    torch.cuda.reset_peak_memory_stats()
    step(state, batch, gen)
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated()
    eager_reserved = torch.cuda.max_memory_reserved()
    step(state, batch, gen)                            # captured, then replayed
    times, losses = [], []
    before = counters()
    for _ in range(3):
        t0 = time.perf_counter()
        _, m = step(state, batch, gen)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    # the process's counts over the timed steps: every one a replay
    counts = count_delta(before, ("train.steps", "graph.replays", "graph.eager",
                                  "graph.captures"))
    peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
    p50 = float(np.median(times))
    ok = (step.captures == 1 and bool(np.isfinite(losses).all())
          and counts == {"train.steps": 3, "graph.replays": 3})
    res["bench.py options batch 96"] = dict(
        p50_step_ms=p50 * 1e3, pairs_per_s=96 / p50, step_ms=[t * 1e3 for t in times],
        eager_peak_bytes=eager_peak, eager_reserved_bytes=eager_reserved, peak_bytes=peak,
        reserved_bytes=reserved, losses=losses, counts=counts, ok=ok)
    log(f"train graphed bench.py options batch 96: p50 step {p50 * 1e3:.2f} ms, "
        f"{96 / p50:.2f} pairs/s; peak memory after the eager first step "
        f"{eager_peak / 2 ** 30:.2f} GiB allocated ({eager_reserved / 2 ** 30:.2f} reserved), "
        f"with the graph {peak / 2 ** 30:.2f} GiB allocated ({reserved / 2 ** 30:.2f} reserved); "
        f"counts over the 3 timed steps {counts}, want 3 steps, 3 replays "
        f"{'ok' if ok else 'FAIL'} [{card}]")
    return ok


def graphs_main(out_path: str) -> int:
    """Phase 14 in its own process (the environment as phase 12's). The
    kernels were built by the parent; loading finds them."""
    if not torch.cuda.is_available():
        print("chip_smoke --graphs: no CUDA device", file=sys.stderr)
        return 2
    from ccvpe_tpu_torch.core import config as cfg_lib
    from ccvpe_tpu_torch.models.cvm import CVM, random_init_
    from ccvpe_tpu_torch.ops import corr_cuda, lmu_cuda
    corr_cuda.load_library()
    lmu_cuda.load_library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    out = {}
    sd = random_init_(CVM(cfg_lib.vigor()).to_empty(device="cpu"),
                      torch.Generator().manual_seed(17)).state_dict()
    t0 = time.perf_counter()
    out["part_s"] = {}
    ok = True
    for part, run in (("export", run_export), ("serving", run_graph_serving),
                      ("train", run_graph_steps)):
        t1 = time.perf_counter()
        ok = ok and run(card, out, sd)
        out["part_s"][part] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    with open(out_path, "w") as f:
        json.dump({"graphs": out}, f, indent=1)
    return 0 if ok else 1


# --- phase 16: scale-out (the data axis across processes), in a child ---

SCALE_TIMEOUT_S = 480
# a rank process of 16b: its wall time, the card's first touch included
SCALE_RANK_TIMEOUT_S = 300
SCALE_STEPS, SCALE_TIMED_STEPS = 3, 2
# 16b's cases: (name, TrainConfig overrides); vigor(lmu_fused_min_res=256),
# float32, eager, drop-connect on, a global batch of 8 as 2 x 4
SCALE_CASES = (("fused f32", {}), ("fused f32, 2 microbatches", {"grad_accum_steps": 2}))
# the JAX package's own bound on a multi-process loss trajectory
# (tools/test_multiprocess.sh)
SCALE_LOSS_RTOL = 1e-4
# the first step's whole gradient (every tensor, float64 norms) against one
# process's: float32 sums of ~1e6 terms in another order, a few 1e-6; one
# element a tensor can move much more (a ReLU at 0 or a softmax's near
# cancellation flips under any rounding change: the one process's own step
# moves conv5/conv6 by ~1e-3 of their max abs with BatchNorm's moments taken
# by the distributed formula, which phase 16 measures), so tensors over
# STEP_GRAD_ATOL are listed beside that floor, and the gate is on the whole
SCALE_GRAD_RTOL = 1e-3
# 16c: samples of the pooled evaluation, one a batch, so that a sample's
# forward is the same computation in either split
SCALE_EVAL_N = 5
SUMMARY_RTOL = 1e-9


def grads_rel(got, want) -> float:
    """||got - want|| / ||want|| over every gradient tensor, in float64."""
    num = sum(float((got[k].double() - w.double()).square().sum()) for k, w in want.items())
    den = sum(float(w.double().square().sum()) for w in want.values())
    return (num / den) ** 0.5


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def scale_rank_batch(cfg, b_global):
    """This rank's block of bench_batch's global batch (all of it for one
    process)."""
    from ccvpe_tpu_torch.core import mesh
    from ccvpe_tpu_torch.train.step import Batch
    n, r = mesh.world_size(), mesh.rank()
    b = b_global // n
    return Batch(*(v[r * b:(r + 1) * b].contiguous() for v in bench_batch(cfg, b_global)))


def scale_steps(cfg, tc, sd, card, what) -> dict:
    """SCALE_STEPS eager steps of make_train_step(cuda_graph=False) on this
    rank's block of the global batch of 8, the generator seeded 17 + i
    before step i: per-step losses, the first step's gradients and the final
    BN buffers on the host, and a digest of the final state; then the p50
    of SCALE_TIMED_STEPS more steps."""
    import hashlib

    from ccvpe_tpu_torch.train.step import create_train_state, make_train_step
    state = create_train_state(cfg, tc, state_dict=sd)
    step = make_train_step(cfg, tc, cuda_graph=False)
    gen = torch.Generator(device="cuda")
    batch = scale_rank_batch(cfg, 8)
    losses, grads = [], None
    for i in range(SCALE_STEPS):
        gen.manual_seed(17 + i)
        _, m = step(state, batch, gen)
        losses.append({k: float(v) for k, v in m.items()})
        if grads is None:
            grads = {n: p.grad.detach().cpu() for n, p in state.model.named_parameters()}
    bits = train_state_bits(state)
    sha = hashlib.sha256()
    for part in ("params", "buffers"):
        for k, v in bits[part].items():
            sha.update(v.detach().cpu().contiguous().numpy().tobytes())
    for i, st in bits["adam"].items():
        for k, v in st.items():
            sha.update(v.detach().cpu().contiguous().numpy().tobytes())
    buffers = {k: v.cpu() for k, v in bits["buffers"].items()}
    times = []
    for i in range(SCALE_TIMED_STEPS):
        gen.manual_seed(17 + SCALE_STEPS + i)
        t0 = time.perf_counter()
        _, m = step(state, batch, gen)
        float(m["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    p50 = float(np.median(times)) * 1e3
    log(f"scale-out {what}: p50 step {p50:.2f} ms over {SCALE_TIMED_STEPS} eager steps, a "
        f"reading, not a target [{card}]")
    del state, step, bits
    torch.cuda.empty_cache()
    return dict(losses=losses, grads=grads, buffers=buffers, digest=sha.hexdigest(),
                p50_step_ms=p50, step_ms=[t * 1e3 for t in times])


def halves_swapped(cfg, sd) -> dict:
    """The one process's first-step gradients at 8 with drop-connect off,
    on bench_batch and on it with its halves swapped (the same loss in
    exact arithmetic): how far a row order alone moves each tensor."""
    from unittest import mock

    from ccvpe_tpu_torch.core import config as cfg_lib
    from ccvpe_tpu_torch.nn import efficientnet
    from ccvpe_tpu_torch.train.step import Batch, create_train_state, make_train_step
    batch = bench_batch(cfg, 8)
    perm = torch.tensor([4, 5, 6, 7, 0, 1, 2, 3], device="cuda")
    out = []
    for b in (batch, Batch(*(v[perm] for v in batch))):
        with mock.patch.object(efficientnet, "DROP_CONNECT_RATE", 0.0):
            state = create_train_state(cfg, cfg_lib.TrainConfig(), state_dict=sd)
        make_train_step(cfg, cfg_lib.TrainConfig(), cuda_graph=False)(state, b)
        out.append({n: p.grad.detach().cpu() for n, p in state.model.named_parameters()})
        del state
    torch.cuda.empty_cache()
    return out


def scale_eval(cfg, sd) -> dict:
    """eval_over_loader and stream_eval on this rank's shard of an in-memory
    VIGOR split of SCALE_EVAL_N samples, one a batch: each summary and the
    arrays mesh.all_hosts_concat pooled."""
    from unittest import mock

    from ccvpe_tpu_torch.core import mesh
    from ccvpe_tpu_torch.data import vigor as vigor_data
    from ccvpe_tpu_torch.data.loader import ThreadedLoader
    from ccvpe_tpu_torch.models.cvm import build_cvm
    from ccvpe_tpu_torch.train.evaluate import eval_over_loader
    from ccvpe_tpu_torch.train.step import make_eval_decode_step
    from ccvpe_tpu_torch.train.stream import decode_step as stream_decode_step
    from ccvpe_tpu_torch.train.stream import stream_eval
    model = build_cvm(cfg, "cuda", state_dict=sd)
    split = InMemorySplit(vigor_data.VigorSample, cfg, SCALE_EVAL_N,
                          city=["NewYork"] * SCALE_EVAL_N)
    r, n = mesh.rank(), mesh.world_size()
    pooled, concat = [], mesh.all_hosts_concat

    def record(x):
        out = concat(x)
        pooled.append(np.asarray(out, np.float64))
        return out

    # graphed, the default: the data axis puts no collective into an
    # eval-mode forward, so gloo ranks capture as one process does
    step = make_eval_decode_step(model)
    with mock.patch.object(mesh, "all_hosts_concat", record):
        loader = ThreadedLoader(split, 1, shuffle=False, num_workers=2, drop_last=False,
                                shard_id=r, num_shards=n)
        summary = eval_over_loader(step, loader, 0.1, with_prob_at_gt=True, device="cuda")
        eval_pooled = list(pooled)
        pooled.clear()
        stream = stream_eval(model, cfg, split, range(SCALE_EVAL_N), batch_size=1,
                             meters_per_pixel=0.1, num_workers=2, shard_id=r, num_shards=n,
                             device="cuda")
    return dict(summary=summary, pooled=eval_pooled, stream=stream, stream_pooled=list(pooled),
                captures=[step.captures, stream_decode_step(model).captures])


def scale_setup():
    """vigor(lmu_fused_min_res=256) and its state dict from torch.Generator
    seed 17, the kernels loaded, TF32 off."""
    from ccvpe_tpu_torch.core import config as cfg_lib
    from ccvpe_tpu_torch.models.cvm import CVM, random_init_
    from ccvpe_tpu_torch.ops import corr_cuda, lmu_cuda
    corr_cuda.load_library()
    lmu_cuda.load_library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(cfg_lib.vigor(), lmu_fused_min_res=256)
    sd = random_init_(CVM(cfg).to_empty(device="cpu"),
                      torch.Generator().manual_seed(17)).state_dict()
    return cfg, sd


def scale_rank_main(rank: int, world: int, url: str, out_path: str) -> int:
    """One rank of 16b: gloo on the card (nccl refuses two ranks on one
    device), SCALE_CASES' steps and the pooled evaluation; its results to
    out_path."""
    if not torch.cuda.is_available():
        print("chip_smoke --scale-out-rank: no CUDA device", file=sys.stderr)
        return 2
    from ccvpe_tpu_torch.core import config as cfg_lib
    from ccvpe_tpu_torch.core import mesh
    mesh.init_distributed(url, world, rank, device="cuda:0", backend="gloo")
    card = card_line()
    cfg, sd = scale_setup()
    out = {}
    for case, over in SCALE_CASES:
        out[case] = scale_steps(cfg, cfg_lib.TrainConfig(**over), sd, card,
                                f"{case}, rank {rank} of {world} (gloo on the card)")
        if rank:
            out[case].update(grads=None, buffers=None)
    out["eval"] = scale_eval(cfg, sd)
    torch.save(out, out_path)
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


def run_scale_ws1(card, out, cfg, sd) -> bool:
    """16a, in deterministic mode: the graphed fused float32 step at batch
    8, SCALE_STEPS steps without a process group, then as many in a nccl
    group of one process from the same state and generator seeds: losses,
    parameters, gradients, BN buffers and Adam state the same bits; the
    trace of one replayed step of each holds the counters' launches, and
    the nccl one shows the gradient mean's kernel."""
    import torch.distributed as dist

    from ccvpe_tpu_torch.core import config as cfg_lib
    from ccvpe_tpu_torch.core.debug import deterministic
    from ccvpe_tpu_torch.train.step import create_train_state, make_train_step
    tc = cfg_lib.TrainConfig()
    batch = bench_batch(cfg, 8)
    res = out["world_size_1"] = {}
    bits = {}
    for name in ("no process group", "nccl, world size 1"):
        nccl = name.startswith("nccl")
        if nccl:
            dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                                    world_size=1, rank=0)
        with deterministic():
            state = create_train_state(cfg, tc, state_dict=sd)
            step = make_train_step(cfg, tc)
            gen = torch.Generator(device="cuda")
            losses, per_step = [], []
            for i in range(SCALE_STEPS):
                gen.manual_seed(17 + i)
                zero_launch_counts()
                _, m = step(state, batch, gen)
                torch.cuda.synchronize()
                per_step.append(launch_counts())
                losses.append({k: float(v) for k, v in m.items()})
            bits[name] = train_state_bits(state)
            times = []
            for i in range(GRAPH_TIMED_STEPS):
                gen.manual_seed(17 + SCALE_STEPS + i)
                t0 = time.perf_counter()
                _, m = step(state, batch, gen)
                float(m["loss"])
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            p50 = float(np.median(times)) * 1e3
            prof = profile_call(lambda: step(state, batch, gen), f"one replayed step, {name}",
                                card, p50)
        nccl_kernels = {k: c for k, c in prof["names"].items()
                        if "nccl" in k.lower() or "onerank" in k.lower()}
        res[name] = dict(losses=losses, launches=per_step, p50_step_ms=p50,
                         step_ms=[t * 1e3 for t in times], captures=step.captures,
                         traced_launches=prof["launches_traced"], nccl_kernels=nccl_kernels,
                         busy_ms=prof["busy_ms"])
        log(f"scale-out world size 1, {name}: graphed fused f32 batch 8 (deterministic mode), "
            f"p50 step {p50:.2f} ms; launches a step {per_step[-1]}; captures {step.captures}; "
            f"nccl kernels in the trace of a replayed step {nccl_kernels} [{card}]")
        del state, step
        torch.cuda.empty_cache()
        if nccl:
            dist.destroy_process_group()
    a, b = bits["no process group"], bits["nccl, world size 1"]
    bad = {k: same_bits(a[k], b[k]) for k in a if k != "adam"}
    bad["adam"] = same_bits({str(i): v for i, v in a["adam"].items()},
                            {str(i): v for i, v in b["adam"].items()})
    rows = list(res.values())
    same_losses = rows[0]["losses"] == rows[1]["losses"]
    launches_ok = all(c == DRIVER_STEP_LAUNCHES for r in rows for c in r["launches"]) and all(
        r["traced_launches"] == DRIVER_STEP_LAUNCHES for r in rows)
    nccl_ok = sum(rows[1]["nccl_kernels"].values()) >= 1 and not rows[0]["nccl_kernels"]
    ok = same_losses and not any(bad.values()) and launches_ok and nccl_ok
    res.update(differ={k: v[:10] for k, v in bad.items()}, same_losses=same_losses, ok=ok)
    log(f"scale-out world size 1: nccl against no process group, {SCALE_STEPS} steps: losses "
        f"the same bits {same_losses}; differing tensors "
        f"{json.dumps({k: len(v) for k, v in bad.items()})} of "
        f"{json.dumps({k: len(v) for k, v in a.items()})}; launches {DRIVER_STEP_LAUNCHES} in "
        f"every step and trace {launches_ok}; the gradient mean's kernel in the nccl trace "
        f"{nccl_ok} {'ok' if ok else 'FAIL'}")
    return ok


def run_scale_gloo(card, out, cfg, sd) -> bool:
    """16b and 16c: one process (no group) at the global batch of 8, then
    two rank processes under gloo on the card at 4 each, SCALE_CASES; then
    the pooled evaluation of both. Losses within SCALE_LOSS_RTOL, the first
    step's gradients within STEP_GRAD_ATOL of their max abs, BN running var
    within BN_VAR_RTOL, both ranks the same bits; the pooled per-sample
    errors the one shard's multiset, summaries within SUMMARY_RTOL."""
    from ccvpe_tpu_torch.core import config as cfg_lib
    from ccvpe_tpu_torch.nn import efficientnet
    one = {case: scale_steps(cfg, cfg_lib.TrainConfig(**over), sd, card,
                             f"{case}, one process at 8")
           for case, over in SCALE_CASES}
    one["eval"] = scale_eval(cfg, sd)
    # the one process's own floor: its step with only BatchNorm's rounding
    # changed (the moments by the distributed formula, forced at world size 1)
    native = efficientnet.BatchNorm.forward
    efficientnet.BatchNorm.forward = (
        lambda self, x: self._global_batch(x) if self.training else native(self, x))
    try:
        bn_formula = scale_steps(cfg, cfg_lib.TrainConfig(), sd, card,
                                 f"{SCALE_CASES[0][0]}, one process at 8, BatchNorm's moments "
                                 f"by the distributed formula")
    finally:
        efficientnet.BatchNorm.forward = native
    floor_worst, floor_over = grads_close(bn_formula["grads"], one[SCALE_CASES[0][0]]["grads"],
                                          STEP_GRAD_ATOL)
    floor_rel = grads_rel(bn_formula["grads"], one[SCALE_CASES[0][0]]["grads"])
    log(f"scale-out one process at 8, its own floor: the step with BatchNorm's moments by the "
        f"distributed formula against the native one: first step's gradients worst "
        f"{floor_worst:.3g} of their max abs ({floor_over[:4]} over {STEP_GRAD_ATOL}), whole "
        f"gradient rel {floor_rel:.3g} [{card}]")
    native_order, swapped = halves_swapped(cfg, sd)
    swap_worst, swap_over = grads_close(swapped, native_order, STEP_GRAD_ATOL)
    swap_rel = grads_rel(swapped, native_order)
    log(f"scale-out one process at 8, drop-connect off, the batch's halves swapped against not "
        f"(the same loss in exact arithmetic): first step's gradients worst {swap_worst:.3g} of "
        f"their max abs ({swap_over[:4]} over {STEP_GRAD_ATOL}), whole gradient rel "
        f"{swap_rel:.3g} [{card}]")
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    url = f"tcp://localhost:{free_port()}"
    outs = [os.path.abspath(os.path.join(OUT_DIR, f"scale_rank{r}.pt")) for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--scale-out-rank",
                               str(r), "2", url, outs[r]]) for r in range(2)]
    try:
        codes = [p.wait(timeout=SCALE_RANK_TIMEOUT_S) for p in procs]
    except subprocess.TimeoutExpired:
        codes = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    if codes != [0, 0]:
        log(f"FAIL: scale-out rank processes exited {codes} (timeout {SCALE_RANK_TIMEOUT_S} s)")
        return False
    ranks = [torch.load(p, weights_only=False) for p in outs]
    for p in outs:
        os.remove(p)
    res = out["gloo_2_ranks"] = dict(rank_processes_wall_s=wall, floor_grad_worst=floor_worst,
                                     floor_grads_over=floor_over[:10], floor_grad_rel=floor_rel,
                                     swap_grad_worst=swap_worst, swap_grads_over=swap_over[:10],
                                     swap_grad_rel=swap_rel)
    ok = True
    for case, _ in SCALE_CASES:
        want, got = one[case], ranks[0][case]
        rel = max(abs(g[k] - w[k]) / abs(w[k]) for gs, ws in
                  ((r[case]["losses"], want["losses"]) for r in ranks)
                  for g, w in zip(gs, ws) for k in w)
        worst, over = grads_close(got["grads"], want["grads"], STEP_GRAD_ATOL)
        g_rel = grads_rel(got["grads"], want["grads"])
        var_rel = max(float(((got["buffers"][k] - v).abs() / v.abs()).max())
                      for k, v in want["buffers"].items() if k.endswith("running_var"))
        var_bad = [k for k, v in want["buffers"].items() if k.endswith("running_var")
                   and not torch.allclose(got["buffers"][k], v, rtol=BN_VAR_RTOL,
                                          atol=BN_VAR_ATOL)]
        same_ranks = ranks[0][case]["digest"] == ranks[1][case]["digest"] and (
            ranks[0][case]["losses"] == ranks[1][case]["losses"])
        case_ok = (rel <= SCALE_LOSS_RTOL and g_rel <= SCALE_GRAD_RTOL and not var_bad
                   and same_ranks)
        ok = ok and case_ok
        res[case] = dict(loss_rel=rel, grad_rel=g_rel, grad_worst=worst, grads_over=over[:10],
                         running_var_rel=var_rel, running_var_bad=var_bad[:10],
                         ranks_same_bits=same_ranks, ok=case_ok,
                         one_p50_step_ms=want["p50_step_ms"],
                         rank_p50_step_ms=[r[case]["p50_step_ms"] for r in ranks],
                         losses_one=want["losses"], losses_ranks=[r[case]["losses"] for r in ranks])
        log(f"scale-out gloo 2 ranks x 4 against one process at 8, {case}, {SCALE_STEPS} eager "
            f"steps, drop-connect on: losses rel {rel:.3g} (rtol {SCALE_LOSS_RTOL}); first "
            f"step's whole gradient rel {g_rel:.3g} (rtol {SCALE_GRAD_RTOL}), worst tensor "
            f"{worst:.3g} of its max abs ({over[:4]} over {STEP_GRAD_ATOL}; the one process's "
            f"floor above); running var rel {var_rel:.3g} (rtol {BN_VAR_RTOL}, "
            f"{len(var_bad)} over); ranks the same bits {same_ranks}; p50 step one process "
            f"{want['p50_step_ms']:.2f} ms, ranks {res[case]['rank_p50_step_ms'][0]:.2f} and "
            f"{res[case]['rank_p50_step_ms'][1]:.2f} ms (a reading: gloo all-reduces through "
            f"the host, which says nothing of nccl over NVLink) {'ok' if case_ok else 'FAIL'} "
            f"[{card}]")
    ev = res["eval"] = {}
    for what, key in (("eval_over_loader", "pooled"), ("stream_eval", "stream_pooled")):
        want = one["eval"][key]
        same = all(len(r["eval"][key]) == len(want) and all(
            np.array_equal(np.sort(g), np.sort(w)) for g, w in zip(r["eval"][key], want))
            for r in ranks)
        ev[what] = dict(same_multisets=same, lengths=[len(a) for a in want])
    rates = ("fps", "aggregate_fps", "frames")
    for what, key in (("eval_over_loader", "summary"), ("stream_eval", "stream")):
        want = {k: v for k, v in one["eval"][key].items() if k not in rates}
        worst = 0.0
        for r in ranks:
            got = r["eval"][key]
            for k, v in want.items():
                worst = max(worst, abs(got[k] - v) / max(abs(v), 1e-300))
        close = worst <= SUMMARY_RTOL and all(r["eval"][key].keys() == one["eval"][key].keys()
                                              for r in ranks)
        ev[what].update(summary_rel=worst, summary_ok=close)
    streams = [r["eval"]["stream"] for r in ranks]
    rates_ok = all(s["frames"] == SCALE_EVAL_N and s["aggregate_fps"] > s["fps"] > 0
                   for s in streams)
    ev["stream_eval"].update(fps=[s["fps"] for s in streams],
                             aggregate_fps=[s["aggregate_fps"] for s in streams],
                             rates_ok=rates_ok)
    # eval_over_loader's and stream_eval's steps graphed in every process:
    # captured once each where a process has more than one batch
    captures = [r["eval"]["captures"] for r in [one] + ranks]
    ev["captures"] = captures
    graphed = all(c == [1, 1] for c in captures)
    eval_ok = (rates_ok and graphed
               and all(ev[w]["same_multisets"] and ev[w]["summary_ok"]
                       for w in ("eval_over_loader", "stream_eval")))
    ok = ok and eval_ok
    log(f"scale-out pooled evaluation over 2 shards against one ({SCALE_EVAL_N} samples, one a "
        f"batch), the eval steps graphed in every process (cuda_graph=True under gloo: the data "
        f"axis puts no collective in an eval forward; captures [eval_over_loader, stream_eval] "
        f"one process {captures[0]}, ranks {captures[1:]}): per-sample errors the same "
        f"multisets {ev['eval_over_loader']['same_multisets']}"
        f" and {ev['stream_eval']['same_multisets']}; summaries rel "
        f"{ev['eval_over_loader']['summary_rel']:.3g} and {ev['stream_eval']['summary_rel']:.3g}"
        f" (rtol {SUMMARY_RTOL}); stream_eval frames {[s['frames'] for s in streams]}, fps "
        f"{[round(s['fps'], 2) for s in streams]}, aggregate_fps "
        f"{[round(s['aggregate_fps'], 2) for s in streams]} {'ok' if eval_ok else 'FAIL'} "
        f"[{card}]")
    res["ok"] = ok
    return ok


def scale_main(out_path: str) -> int:
    """Phase 16 in its own process (phase 12's environment); the kernels
    were built by the parent."""
    if not torch.cuda.is_available():
        print("chip_smoke --scale-out: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    cfg, sd = scale_setup()
    out = {"part_s": {}}
    t0 = time.perf_counter()
    ok = True
    for part, run in (("world size 1", run_scale_ws1), ("gloo 2 ranks", run_scale_gloo)):
        t1 = time.perf_counter()
        ok = ok and run(card, out, cfg, sd)
        out["part_s"][part] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    with open(out_path, "w") as f:
        json.dump({"scale_out": out}, f, indent=1, default=str)
    return 0 if ok else 1


# --- phase 17: the model axis, in a child ---

MODEL_TIMEOUT_S = 420
# a rank process of 17b and 17c: its wall time, the card's first touch included
MODEL_RANK_TIMEOUT_S = 240
# (name, ModelConfig overrides) on vigor(), float32; BOTH as __graft_entry__.py::
# dryrun_multichip sets them
MODEL_BOTH = {"spatial_axis": "model", "ori_axis": "model"}
MODEL_NO_AXES = {"spatial_axis": None, "ori_axis": None}
# 17b's train cases: both axes with the train-time ori window (spatial_axis
# refuses fused stages, as JAX does), and ori_axis with the fused stages
MODEL_TRAIN_CASES = (("both axes, ori_window 160", {**MODEL_BOTH, "ori_window": 160}),
                     ("ori_axis, fused from 256", {"ori_axis": "model",
                                                   "lmu_fused_min_res": 256}))
MODEL_STEPS, MODEL_TIMED_STEPS = 2, 2
# the forward against one process: tests/test_spatial_sharding.py's bounds;
# ori where the raw head vector's norm exceeds the floor (elsewhere the
# normalisation amplifies roundoff: tests/_helpers.py::assert_ori_close)
MODEL_HEATMAP_ATOL, MODEL_LOGITS_ATOL, MODEL_SCORES_ATOL = 1e-5, 2e-3, 1e-4
MODEL_ORI_ATOL, MODEL_ORI_FLOOR, MODEL_ORI_DEGENERATE_ATOL = 1e-4, 1e-2, 5e-2
# 17a: B1 at six scales, no fused stage; a forward's B1 launches on a rank
UNFUSED_STEP_LAUNCHES = dict(DRIVER_STEP_LAUNCHES, lmu_fwd=0, lmu_bwd=0)
MODEL_FWD_B1 = 6


def model_forward(cfg, sd, batch) -> dict:
    """The eval forward of `batch` (this rank's data block) on the card:
    its outputs and the raw ori head's norm on the host, the launches
    counted over it, its time, and a second call profiled (the launches in
    its trace held to the counters)."""
    from ccvpe_tpu_torch.models.cvm import build_cvm
    from ccvpe_tpu_torch.train.step import device_normalize
    model = build_cvm(cfg, "cuda", state_dict=sd)
    raw = {}
    hook = model.conv1_ori.register_forward_hook(lambda m, i, o: raw.update(ori=o))
    g, s = device_normalize(batch.grd), device_normalize(batch.sat)
    torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        out = model(g, s)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    hook.remove()
    res = dict(logits=out.logits.cpu(), heatmap=out.heatmap.cpu(), ori=out.ori.cpu(),
               scores=[t.cpu() for t in out.matching_scores], launches=launches, ms=ms)
    if "ori" in raw:        # the head ran on the whole map (on a row block it is gathered)
        res["raw_norm"] = torch.linalg.vector_norm(raw["ori"], dim=1)[..., None].cpu()

    def again():
        with torch.inference_mode():
            model(g, s)
    res["profile"] = profile_call(again, f"forward, {cfg.spatial_axis=}, {cfg.ori_axis=}",
                                  card_line(), ms)["launches_traced"]
    del model, out
    torch.cuda.empty_cache()
    return res


def model_steps(cfg, sd, b_global, what, steps=MODEL_STEPS, timed=MODEL_TIMED_STEPS) -> dict:
    """`steps` eager steps of make_train_step(cuda_graph=False) on this
    rank's data block of bench_batch's global batch, drop-connect on, the
    generator seeded 17 + i: per-step losses and launches, the first step's
    gradients and the final BN buffers on the host, a digest of the final
    state, the peak allocated memory; then the p50 of `timed` more steps."""
    import hashlib

    from ccvpe_tpu_torch.core import config as cfg_lib
    from ccvpe_tpu_torch.core import mesh
    from ccvpe_tpu_torch.train.step import Batch, create_train_state, make_train_step
    tc = cfg_lib.TrainConfig()
    b = b_global // mesh.data_size()
    d = mesh.data_index()
    batch = Batch(*(v[d * b:(d + 1) * b].contiguous() for v in bench_batch(cfg, b_global)))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = create_train_state(cfg, tc, state_dict=sd)
    step = make_train_step(cfg, tc, cuda_graph=False)
    gen = torch.Generator(device="cuda")
    losses, launches, grads = [], [], None
    for i in range(steps):
        gen.manual_seed(17 + i)
        zero_launch_counts()
        _, m = step(state, batch, gen)
        torch.cuda.synchronize()
        launches.append(launch_counts())
        losses.append({k: float(v) for k, v in m.items()})
        if grads is None:
            grads = {n: p.grad.detach().cpu() for n, p in state.model.named_parameters()}
    bits = train_state_bits(state)
    bits["adam"] = {f"{i}.{k}": v for i, st in bits["adam"].items() for k, v in st.items()}
    digest = {}
    for part in ("params", "buffers", "adam"):
        sha = hashlib.sha256()
        for v in bits[part].values():
            sha.update(v.detach().cpu().contiguous().numpy().tobytes())
        digest[part] = sha.hexdigest()
    buffers = {k: v.cpu() for k, v in bits["buffers"].items()}
    times = []
    for i in range(timed):
        gen.manual_seed(17 + steps + i)
        t0 = time.perf_counter()
        _, m = step(state, batch, gen)
        float(m["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    p50 = float(np.median(times)) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"model axis {what}: p50 step {p50:.2f} ms over {timed} eager steps, peak allocated "
        f"{peak:.2f} GiB, launches a step {launches[-1]} (readings, not targets) [{card_line()}]")
    del state, step, bits
    torch.cuda.empty_cache()
    return dict(losses=losses, launches=launches, grads=grads, buffers=buffers,
                digest=digest, p50_step_ms=p50, step_ms=[t * 1e3 for t in times],
                peak_gib=peak)


def model_rank_main(rank: int, world: int, url: str, out_path: str) -> int:
    """One rank of 17b (world 2: the mesh (1, 2), a global batch of 8) or
    17c (world 4: (2, 2), a global batch of 4): gloo on the card (nccl
    refuses two ranks on one device), the forward with both axes, then the
    train cases; its results to out_path."""
    if not torch.cuda.is_available():
        print("chip_smoke --model-axis-rank: no CUDA device", file=sys.stderr)
        return 2
    from ccvpe_tpu_torch.core import mesh
    mesh.init_distributed(url, world, rank, device="cuda:0", backend="gloo")
    cfg, sd = scale_setup()
    shape = (1, 2) if world == 2 else (2, 2)
    b_global = 8 if world == 2 else 4
    out = {}
    with mesh.set_mesh(mesh.make_mesh(*shape)):
        d, b = mesh.data_index(), b_global // shape[0]
        batch = bench_batch(cfg, b_global)
        block = type(batch)(*(v[d * b:(d + 1) * b] for v in batch))
        out["forward"] = model_forward(dataclasses.replace(cfg, lmu_fused_min_res=0,
                                                           **MODEL_BOTH), sd, block)
        cases = MODEL_TRAIN_CASES if world == 2 else MODEL_TRAIN_CASES[:1]
        for case, over in cases:
            c = dataclasses.replace(cfg, **{"lmu_fused_min_res": 0, **over})
            out[case] = model_steps(c, sd, b_global, f"{case}, rank {rank} of {shape} "
                                    f"(gloo on the card)", 1 if world == 4 else MODEL_STEPS)
            if rank:
                out[case].update(grads=None)
        if mesh.model_index():      # model index 0 keeps its data block's outputs
            out["forward"].update(scores=None, ori=None, logits=None)
    torch.save(out, out_path)
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


def run_model_ws1(card, out, cfg, sd) -> bool:
    """17a, in deterministic mode: the graphed unfused float32 step at
    batch 8 in a nccl group of one process under set_mesh(make_mesh(1,
    1)), MODEL_STEPS + 1 steps with neither axis, then with both
    'model', from the same state and seeds: the same bits, the same
    launches in every step and in the trace of one replayed step."""
    import torch.distributed as dist

    from ccvpe_tpu_torch.core import config as cfg_lib
    from ccvpe_tpu_torch.core import mesh
    from ccvpe_tpu_torch.core.debug import deterministic
    from ccvpe_tpu_torch.train.step import create_train_state, make_train_step
    tc = cfg_lib.TrainConfig()
    batch = bench_batch(cfg, 8)
    res = out["world_size_1"] = {}
    bits = {}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        for name, over in (("no axes", MODEL_NO_AXES), ("both axes 'model'", MODEL_BOTH)):
            c = dataclasses.replace(cfg, lmu_fused_min_res=0, **over)
            with deterministic(), mesh.set_mesh(mesh.make_mesh(1, 1)):
                state = create_train_state(c, tc, state_dict=sd)
                step = make_train_step(c, tc)
                gen = torch.Generator(device="cuda")
                losses, per_step, times = [], [], []
                for i in range(MODEL_STEPS + 1):
                    gen.manual_seed(17 + i)
                    zero_launch_counts()
                    t0 = time.perf_counter()
                    _, m = step(state, batch, gen)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    per_step.append(launch_counts())
                    losses.append({k: float(v) for k, v in m.items()})
                bits[name] = train_state_bits(state)
                prof = profile_call(lambda: step(state, batch, gen),
                                    f"one replayed step, nccl world size 1, {name}", card,
                                    times[-1] * 1e3)
            res[name] = dict(losses=losses, launches=per_step, captures=step.captures,
                             step_ms=[t * 1e3 for t in times],
                             traced_launches=prof["launches_traced"])
            log(f"model axis world size 1 (nccl), {name}: graphed unfused f32 batch 8 "
                f"(deterministic mode), the last step {times[-1] * 1e3:.2f} ms (a replay); "
                f"launches a step {per_step[-1]}; in the trace of a replayed step "
                f"{prof['launches_traced']}; captures {step.captures} [{card}]")
            del state, step
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    a, b = bits["no axes"], bits["both axes 'model'"]
    bad = {k: same_bits(a[k], b[k]) for k in a if k != "adam"}
    bad["adam"] = same_bits({str(i): v for i, v in a["adam"].items()},
                            {str(i): v for i, v in b["adam"].items()})
    rows = [res["no axes"], res["both axes 'model'"]]
    same_losses = rows[0]["losses"] == rows[1]["losses"]
    launches_ok = all(c == UNFUSED_STEP_LAUNCHES for r in rows for c in r["launches"]) and all(
        r["traced_launches"] == UNFUSED_STEP_LAUNCHES for r in rows)
    ok = same_losses and not any(bad.values()) and launches_ok and all(
        r["captures"] == 1 for r in rows)
    res.update(differ={k: v[:10] for k, v in bad.items()}, same_losses=same_losses, ok=ok)
    log(f"model axis world size 1: both axes against neither, {MODEL_STEPS + 1} graphed steps: "
        f"losses the same bits {same_losses}; differing tensors "
        f"{json.dumps({k: len(v) for k, v in bad.items()})}; launches "
        f"{UNFUSED_STEP_LAUNCHES} in every step and trace {launches_ok} "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def forward_close(got, want) -> dict:
    """A rank's forward against one process's rows: each output's max
    abs error and whether it is within its bound."""
    err = {k: float((got[k] - want[k]).abs().max()) for k in ("heatmap", "logits")}
    err["scores"] = max(float((a - w).abs().max()) for a, w in zip(got["scores"], want["scores"]))
    ori_err = (got["ori"] - want["ori"]).abs()
    well = (want["raw_norm"] > MODEL_ORI_FLOOR).expand_as(ori_err)
    err["ori"], err["ori_all"] = float(ori_err[well].max()), float(ori_err.max())
    shapes = [tuple(a.shape) == tuple(w.shape) for a, w in zip(got["scores"], want["scores"])]
    ok = (err["heatmap"] <= MODEL_HEATMAP_ATOL and err["logits"] <= MODEL_LOGITS_ATOL
          and err["scores"] <= MODEL_SCORES_ATOL and err["ori"] <= MODEL_ORI_ATOL
          and err["ori_all"] <= MODEL_ORI_DEGENERATE_ATOL and all(shapes)
          and len(shapes) == 6)
    return dict(err, ok=ok)


def rows_of(ref, rows) -> dict:
    return {k: ([t[rows] for t in v] if k == "scores" else v[rows])
            for k, v in ref.items() if k in ("heatmap", "logits", "ori", "scores", "raw_norm")}


def run_model_ranks(card, out, cfg, sd, world, refs) -> bool:
    """17b (world 2, the mesh (1, 2), a global batch of 8) or 17c (world 4,
    (2, 2), a global batch of 4): the rank processes under gloo on the card
    against the one-process references `refs`: the forward at the sharding
    tests' bounds with 6 B1 launches a rank, held to its trace; each train
    case's losses within SCALE_LOSS_RTOL, the first step's whole gradient
    within SCALE_GRAD_RTOL, BN running var within BN_VAR_RTOL, every rank
    the same bits and the expected launches a step."""
    shape = (1, 2) if world == 2 else (2, 2)
    url = f"tcp://localhost:{free_port()}"
    outs = [os.path.abspath(os.path.join(OUT_DIR, f"model_rank{r}.pt")) for r in range(world)]
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--model-axis-rank",
                               str(r), str(world), url, outs[r]]) for r in range(world)]
    try:
        codes = [p.wait(timeout=MODEL_RANK_TIMEOUT_S) for p in procs]
    except subprocess.TimeoutExpired:
        codes = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    if codes != [0] * world:
        log(f"FAIL: model axis rank processes {shape} exited {codes} "
            f"(timeout {MODEL_RANK_TIMEOUT_S} s)")
        return False
    ranks = [torch.load(p, weights_only=False) for p in outs]
    for p in outs:
        os.remove(p)
    res = out[f"gloo_{shape[0]}x{shape[1]}"] = dict(rank_processes_wall_s=wall)
    b = refs["b_global"] // shape[0]
    fwd_errs, fwd_ok = [], True
    for r, got in enumerate(ranks):
        f = got["forward"]
        launches_ok = (f["launches"]["corr_fwd"] == MODEL_FWD_B1
                       and f["profile"] == f["launches"])
        if f["logits"] is not None:
            d = r // shape[1]
            e = forward_close(f, rows_of(refs["forward"], slice(d * b, (d + 1) * b)))
            fwd_errs.append(e)
            fwd_ok = fwd_ok and e["ok"]
        fwd_ok = fwd_ok and launches_ok
    res["forward"] = dict(errors=fwd_errs, launches=[g["forward"]["launches"] for g in ranks],
                          traced=[g["forward"]["profile"] for g in ranks],
                          rank_ms=[g["forward"]["ms"] for g in ranks],
                          one_ms=refs["forward"]["ms"], ok=fwd_ok)
    log(f"model axis {shape} gloo ranks, forward with both axes at a global batch of "
        f"{refs['b_global']}: errors against one process {fwd_errs} (heatmap "
        f"{MODEL_HEATMAP_ATOL}, logits {MODEL_LOGITS_ATOL}, scores {MODEL_SCORES_ATOL}, ori "
        f"{MODEL_ORI_ATOL} where the raw norm > {MODEL_ORI_FLOOR}); B1 launches a rank "
        f"{[g['forward']['launches']['corr_fwd'] for g in ranks]}, in the traces "
        f"{[g['forward']['profile']['corr_fwd'] for g in ranks]}; forward ms one process "
        f"{refs['forward']['ms']:.2f}, ranks {[round(g['forward']['ms'], 2) for g in ranks]} "
        f"{'ok' if fwd_ok else 'FAIL'} [{card}]")
    ok = fwd_ok
    for case, over in (MODEL_TRAIN_CASES if world == 2 else MODEL_TRAIN_CASES[:1]):
        want, got = refs[case], ranks[0][case]
        rel = max(abs(g[k] - w[k]) / abs(w[k]) for r in ranks
                  for g, w in zip(r[case]["losses"], want["losses"]) for k in w)
        worst, over_atol = grads_close(got["grads"], want["grads"], STEP_GRAD_ATOL)
        g_rel = grads_rel(got["grads"], want["grads"])
        var_rel = max(float(((got["buffers"][k] - v).abs() / v.abs()).max())
                      for k, v in want["buffers"].items() if k.endswith("running_var"))
        var_bad = [k for k, v in want["buffers"].items() if k.endswith("running_var")
                   and not torch.allclose(got["buffers"][k], v, rtol=BN_VAR_RTOL,
                                          atol=BN_VAR_ATOL)]
        differ = sorted({part for r in ranks for part, h in r[case]["digest"].items()
                         if h != got["digest"][part]}
                        | ({"losses"} if any(r[case]["losses"] != got["losses"] for r in ranks)
                           else set()))
        same_ranks = not differ
        expect = dict(UNFUSED_STEP_LAUNCHES) if "fused" not in case else dict(
            DRIVER_STEP_LAUNCHES)
        launches_ok = all(c == expect for r in ranks for c in r[case]["launches"])
        case_ok = (rel <= SCALE_LOSS_RTOL and g_rel <= SCALE_GRAD_RTOL and not var_bad
                   and same_ranks and launches_ok)
        ok = ok and case_ok
        res[case] = dict(loss_rel=rel, grad_rel=g_rel, grad_worst=worst,
                         grads_over=over_atol[:10], running_var_rel=var_rel,
                         running_var_bad=var_bad[:10], ranks_same_bits=same_ranks,
                         ranks_differ_in=differ,
                         launches=[r[case]["launches"] for r in ranks], ok=case_ok,
                         one_p50_step_ms=want["p50_step_ms"], one_peak_gib=want["peak_gib"],
                         rank_p50_step_ms=[r[case]["p50_step_ms"] for r in ranks],
                         rank_peak_gib=[r[case]["peak_gib"] for r in ranks],
                         losses_one=want["losses"], losses_ranks=[r[case]["losses"] for r in ranks])
        log(f"model axis {shape} gloo ranks against one process at {refs['b_global']}, {case}, "
            f"{len(want['losses'])} eager steps, drop-connect on: losses rel {rel:.3g} (rtol "
            f"{SCALE_LOSS_RTOL}); first step's whole gradient rel {g_rel:.3g} (rtol "
            f"{SCALE_GRAD_RTOL}), worst tensor {worst:.3g} of its max abs ({over_atol[:4]} over "
            f"{STEP_GRAD_ATOL}); running var rel {var_rel:.3g} ({len(var_bad)} over "
            f"{BN_VAR_RTOL}); ranks the same bits {same_ranks} {differ}; launches a step "
            f"{ranks[0][case]['launches'][-1]} (expected {expect}) {launches_ok}; p50 step one "
            f"process {want['p50_step_ms']:.2f} ms, ranks "
            f"{[round(r[case]['p50_step_ms'], 2) for r in ranks]} ms; peak allocated one "
            f"process {want['peak_gib']:.2f} GiB, ranks "
            f"{[round(r[case]['peak_gib'], 2) for r in ranks]} GiB (readings: gloo goes "
            f"through the host) {'ok' if case_ok else 'FAIL'} [{card}]")
    res["ok"] = ok
    return ok


def model_main(out_path: str) -> int:
    """Phase 17 in its own process (phase 12's environment); the kernels
    were built by the parent. 17a in a nccl group of one; the one-process
    references with no group; then the 17b and 17c rank processes, one rig
    at a time, while this process holds no tensor on the card."""
    if not torch.cuda.is_available():
        print("chip_smoke --model-axis: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    cfg, sd = scale_setup()
    out = {"part_s": {}}
    t0 = time.perf_counter()
    t1 = time.perf_counter()
    ok = run_model_ws1(card, out, cfg, sd)
    out["part_s"]["world size 1"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    unfused = dataclasses.replace(cfg, lmu_fused_min_res=0)
    refs = {}
    for world, b_global in ((2, 8), (4, 4)):
        r = refs[world] = {"b_global": b_global}
        r["forward"] = model_forward(unfused, sd, bench_batch(cfg, b_global))
        for case, over in (MODEL_TRAIN_CASES if world == 2 else MODEL_TRAIN_CASES[:1]):
            c = dataclasses.replace(cfg, **{"lmu_fused_min_res": 0, **over, **MODEL_NO_AXES})
            r[case] = model_steps(c, sd, b_global, f"{case}, one process at {b_global}",
                                  MODEL_STEPS if world == 2 else 1)
    out["part_s"]["one-process references"] = time.perf_counter() - t1
    for world in (2, 4):
        t1 = time.perf_counter()
        ok = run_model_ranks(card, out, cfg, sd, world, refs[world]) and ok
        out["part_s"][f"gloo {world} ranks"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    out["ok"] = ok
    with open(out_path, "w") as f:
        json.dump({"model_axis": out}, f, indent=1, default=str)
    return 0 if ok else 1


# --- phase 18: the image ingest (nvJPEG and the resize kernel), in a child process ---

INGEST_TIMEOUT_S = 300
# the on-disk VIGOR split: panoramas (2048 x 1024 JPEG) and 640 x 640 PNG patches
INGEST_N, INGEST_PATCHES = 20, 8
INGEST_PANO_HW, INGEST_OUT_HW = (1024, 2048), (320, 640)
INGEST_BATCHES = (8, 32)           # load_batch_native's batches timed
INGEST_THREADS = 4                 # threads decoding at once, against one
INGEST_TIMED_LOOPS = 3             # each eval loop's timed repetitions, in turns
# a PNG decoded and resized on the card against the plain version (PIL's
# decode on both sides): the same arithmetic, each product and add
# rounded, so the bits agree; the bound allows one rounding step (the
# resize kernel itself must give resize_plain's bits)
INGEST_RESIZE_U8_ATOL, INGEST_RESIZE_F32_ATOL = 1, 1e-5
# decode plus resize on the card against the plain version (PIL's libjpeg
# decode, resize_plain): nvJPEG's IDCT, colour conversion and (even with
# interpolated upsampling) chroma are not libjpeg's. The largest and the
# mean difference in uint8 LSB after the resize, per JPEG, and the largest
# normalized one (that many LSB over 255 * the smallest std): twice the
# worst of this script's first run on an NVIDIA H100 80GB HBM3 at 700 W
# (max 4 LSB and mean 0.581, the noise upscale; PERF.md, PR 19). A PNG
# (PIL's decode on both sides) takes the resize's bounds above.
INGEST_GATE_MAX_LSB, INGEST_GATE_MEAN_LSB = 8, 1.2
INGEST_GATE_F32 = INGEST_GATE_MAX_LSB / (255 * 0.224)
INGEST_KERNELS = {"resize": lambda n: "resize_kernel" in n}
SMEM_DEFAULT = 48 * 1024   # a block's shared memory without opt-in (CUDA's)


def ingest_counts() -> dict:
    from ccvpe_tpu_torch.ops import resize_cuda
    return {"resize": resize_cuda.resize.launches}


def zero_ingest_counts() -> None:
    from ccvpe_tpu_torch.ops import resize_cuda
    resize_cuda.resize.launches = 0


def ingest_pixels(seed, h, w, noise=6.0):
    """uint8 [h, w, 3] of numpy seed `seed`: colour waves at a seeded phase
    under Gaussian noise of `noise` levels (noise=None: uniform noise)."""
    rng = np.random.default_rng(seed)
    if noise is None:
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, 3).astype(np.float32)
    img = np.stack([128 + 100 * np.sin(xx / 97 + yy / 211 + ph[0]),
                    128 + 90 * np.cos(xx / 53 + ph[1]) * np.sin(yy / 71),
                    128 + 80 * np.sin(yy / 37 + xx / 301 + ph[2])], -1)
    img += rng.normal(0, noise, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=1)
def ingest_panorama():
    """The split's panorama, 2048 x 1024 (numpy seed 0); each file rolls it."""
    return ingest_pixels(0, *INGEST_PANO_HW)


def write_vigor_split(root, n, patches):
    """A VIGOR samearea test split on disk: n panoramas (2048 x 1024 JPEG,
    quality 90, baseline 4:2:0, as VIGOR's are; the panorama rolled by 97
    columns a file) over the four cities,
    `patches` 640 x 640 PNG aerial patches of uniform noise, each panorama
    with 4 references at pixel deltas inside the patch. Returns the
    panoramas' paths in the dataset's order."""
    import PIL.Image
    cities = ("NewYork", "Seattle", "SanFrancisco", "Chicago")
    rng = np.random.default_rng(18)
    paths = []
    for c, city in enumerate(cities):
        split_dir = os.path.join(root, "splits_new", city)
        for sub in ("satellite", "panorama"):
            os.makedirs(os.path.join(root, city, sub), exist_ok=True)
        os.makedirs(split_dir, exist_ok=True)
        sats = [f"sat_{city}_{i}.png" for i in range(patches // len(cities))]
        for i, name in enumerate(sats):
            PIL.Image.fromarray(ingest_pixels(100 * c + i, 640, 640, None)).save(
                os.path.join(root, city, "satellite", name))
        with open(os.path.join(split_dir, "satellite_list.txt"), "w") as f:
            f.write("\n".join(sats) + "\n")
        lines = []
        for i in range(c, n, len(cities)):
            name = f"pano_{i:03d}.jpg"
            path = os.path.join(root, city, "panorama", name)
            PIL.Image.fromarray(np.roll(ingest_panorama(), 97 * i, axis=1)).save(path, quality=90)
            paths.append(path)
            fields = [name]
            for j in range(4):
                r, col = rng.uniform(-200, 200, 2)
                fields += [sats[(i + j) % len(sats)], f"{r:.3f}", f"{col:.3f}"]
            lines.append(" ".join(fields))
        with open(os.path.join(split_dir, "same_area_balanced_test.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return paths


def write_ingest_files(root, pano):
    """{name: (path, output (h, w))}: VIGOR's panorama as JPEG 4:2:0 (the
    split's own), 4:4:4, progressive and grayscale; uniform noise as JPEG
    4:2:0 (a non-integer downscale), 4:4:4 (to (37, 91)) and an upscale;
    PNG as RGB, RGBA and palette at the aerial size."""
    import PIL.Image
    img = PIL.Image.fromarray(ingest_panorama())
    noise = {hw: PIL.Image.fromarray(ingest_pixels(7 + hw[0], *hw, None))
             for hw in ((512, 1024), (96, 160), (40, 56), (640, 640))}
    alpha = PIL.Image.fromarray(ingest_pixels(3, 640, 640, None)[..., 0])
    out = {"pano 4:2:0": (pano, INGEST_OUT_HW)}
    for name, image, kw, hw, ext in (
            ("pano 4:4:4", img, dict(quality=90, subsampling=0), INGEST_OUT_HW, "jpg"),
            ("pano progressive", img, dict(quality=90, progressive=True), INGEST_OUT_HW, "jpg"),
            ("pano gray", img.convert("L"), dict(quality=90), INGEST_OUT_HW, "jpg"),
            ("noise 4:2:0", noise[512, 1024], dict(quality=90), INGEST_OUT_HW, "jpg"),
            ("noise 4:4:4", noise[96, 160], dict(quality=90, subsampling=0), (37, 91), "jpg"),
            ("noise upscale", noise[40, 56], dict(quality=90), (75, 130), "jpg"),
            ("png rgb", noise[640, 640], {}, (512, 512), "png"),
            ("png rgba", PIL.Image.merge("RGBA", (*noise[640, 640].split(), alpha)), {},
             (512, 512), "png"),
            ("png palette", noise[640, 640].quantize(64), {}, (512, 512), "png")):
        path = os.path.join(root, name.replace(" ", "_").replace(":", "") + "." + ext)
        image.save(path, **kw)
        out[name] = (path, hw)
    return out


def resize_bound(n, in_hw, out_hw, normalized):
    """The resize's least time, in ms (io.cc::resize_normalize's function):
    the bytes it must move (resize_cuda.resize_bytes: the uint8 input read
    once, the output written once) at HBM_BYTES_PER_S, or its float32
    operations (a multiply and an add a tap of both sums, the normalize's
    subtract and multiply) at FP32_FLOPS_PER_S, the larger; with what
    bounds it."""
    from ccvpe_tpu_torch.ops import resize_cuda
    (in_h, in_w), (out_h, out_w) = in_hw, out_hw
    nbytes = resize_cuda.resize_bytes(n, in_h, in_w, out_h, out_w, normalized)
    taps_v = int(resize_cuda.contributions(in_h, out_h)[1].sum())
    taps_h = int(resize_cuda.contributions(in_w, out_w)[1].sum())
    flops = (2 * n * in_w * 3 * taps_v + 2 * n * out_h * 3 * taps_h
             + 2 * n * out_h * out_w * 3)
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
    return dict(bound_ms=max(t_b, t_o), bound_by="bytes" if t_b >= t_o else "operations",
                bytes=nbytes, flops=flops)


def check_resize_kernels(card, out, decoded, gen) -> bool:
    """The kernel against resize_plain on the card, on one input each:
    VIGOR's panoramas as nvJPEG decoded them (a batch of 8, and one, the
    eval path's call), uniform noise at a non-integer downscale and an
    upscale, a row too wide for a 64-column tile's band in 48 KB, a row of
    a width that is no multiple of 4 bytes (its rows start at every offset
    from 16-byte alignment), a steep downscale whose band is staged in
    several row chunks, and a steep horizontal one whose band fits only the
    card's opt-in shared memory (its plan must ask for more than
    SMEM_DEFAULT, its chunks of band rows cycling through the ring); uint8
    and normalized, each twice for the same bits. Then a size whose one
    output's band fits no shared memory raises."""
    from ccvpe_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
    from ccvpe_tpu_torch.ops import resize_cuda

    def noise(*shape):
        return torch.randint(0, 256, shape, device="cuda", generator=gen, dtype=torch.uint8)

    x8 = torch.from_numpy(np.stack(decoded[:8])).cuda()
    cases = [("vigor batch 8", x8, INGEST_OUT_HW), ("vigor one", x8[:1], INGEST_OUT_HW),
             ("noise non-integer", noise(3, 96, 160, 3), (37, 91)),
             ("noise upscale", noise(2, 40, 56, 3), (75, 130)),
             ("wide row (narrower tiles)", noise(1, 24, 5000, 3), (10, 1250)),
             ("odd row (unaligned rows)", noise(2, 33, 77, 3), (10, 20)),
             ("steep downscale (row chunks)", noise(2, 400, 96, 3), (5, 24)),
             ("steep horizontal (opt-in)", noise(1, 30, 20000, 3), (4, 10))]
    rows = out["resize_checks"] = []
    for name, x, hw in cases:
        plan = resize_cuda.resize_plan(tuple(x.shape[1:3]), hw, x.device)
        # the opt-in case plans past the default; every other within it
        plan_ok = (plan["smem"] > SMEM_DEFAULT) == ("opt-in" in name)
        for mode, (mean, std) in (("uint8", (None, None)),
                                  ("normalized", (IMAGENET_MEAN, IMAGENET_STD))):
            a, b = resize_cuda.resize(x, hw, mean, std), resize_cuda.resize(x, hw, mean, std)
            want = resize_cuda.resize_plain(x, hw, mean, std)
            torch.cuda.synchronize()
            same = torch.equal(a, b)
            err = float((a.double() - want.double()).abs().max())
            plain_bits = torch.equal(a, want)
            ok = (same and plain_bits and plan_ok and a.shape == want.shape
                  and a.dtype == want.dtype)
            rows.append(dict(name=name, mode=mode, shape=list(x.shape), out=list(hw),
                             plan=plan, max_abs=err, plain_same_bits=plain_bits,
                             same_bits_twice=same, ok=ok))
            log(f"check resize {name:28s} {mode:10s} {tuple(x.shape)} -> {hw} (tile "
                f"{plan['tr']}x{plan['tc']}, chunk {plan['chunk']}, {plan['smem']} B, default "
                f"{SMEM_DEFAULT}: as the case wants {plan_ok}): max abs {err:.3g} against "
                f"resize_plain, plain's bits {plain_bits}, same bits twice {same} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                return False
    try:
        resize_cuda.resize(noise(1, 1, 100000, 3), (1, 1))
        raised = None
    except resize_cuda.IngestError as e:
        raised = str(e)
    out["resize_too_wide"] = raised
    log(f"check resize 1 x 100000 -> 1 x 1 (one output's band 300 KB): raises "
        f"{raised is not None} ({raised}) {'ok' if raised else 'FAIL'}")
    return raised is not None


def check_ingest_files(card, out, files, dev) -> bool:
    """Each test file decoded and resized on the card against the plain
    version (device "cpu": PIL's decode, resize_plain), uint8 and
    normalized, with the backend that decoded it: a JPEG within the gate, a
    PNG (PIL's decode on both sides) within the resize's bounds."""
    from ccvpe_tpu_torch.data import native_io
    from ccvpe_tpu_torch.ops import resize_cuda
    rows = out["decode_checks"] = []
    for name, (path, hw) in files.items():
        before = resize_cuda.backend_counts()
        card_u8 = native_io.load_image_raw_native(path, hw, dev)
        card_f32 = native_io.load_image_native(path, hw, dev)
        after = resize_cuda.backend_counts()
        plain_u8 = native_io.load_image_raw_native(path, hw, "cpu")
        plain_f32 = native_io.load_image_native(path, hw, "cpu")
        backend = [k for k in after if after[k] != before[k]]
        d = np.abs(card_u8.astype(np.int32) - plain_u8.astype(np.int32))
        f32_err = float(np.abs(card_f32.astype(np.float64) - plain_f32).max())
        png = path.endswith(".png")
        ok = (card_u8.shape == plain_u8.shape == (*hw, 3) and card_f32.dtype == np.float32
              and len(backend) == 1 and (backend == ["host"]) == png
              and (d.max() <= INGEST_RESIZE_U8_ATOL and f32_err <= INGEST_RESIZE_F32_ATOL
                   if png else d.max() <= INGEST_GATE_MAX_LSB
                   and d.mean() <= INGEST_GATE_MEAN_LSB and f32_err <= INGEST_GATE_F32))
        rows.append(dict(name=name, out=list(hw), backend=backend, max_lsb=int(d.max()),
                         mean_lsb=float(d.mean()), share_off=float((d > 0).mean()),
                         f32_max_abs=f32_err, ok=ok))
        gate = (f"atol {INGEST_RESIZE_U8_ATOL} LSB, {INGEST_RESIZE_F32_ATOL}" if png else
                f"gate max {INGEST_GATE_MAX_LSB} LSB, mean {INGEST_GATE_MEAN_LSB}, "
                f"{INGEST_GATE_F32:.3g}")
        log(f"check ingest {name:17s} -> {hw}: {backend}; card against plain uint8 max "
            f"{int(d.max())} LSB, mean {d.mean():.3f}, {(d > 0).mean():.1%} of values off; "
            f"normalized max {f32_err:.3g} ({gate}) {'ok' if ok else 'FAIL'}")
        if not ok:
            return False
    return True


def sof1_jpeg(data: bytes) -> bytes:
    """A baseline JPEG relabelled extended sequential (its SOF0 marker made
    SOF1): the same Huffman-coded 8-bit data, which libjpeg decodes alike."""
    i = 2
    while data[i] == 0xFF and data[i + 1] != 0xC0:
        i += 2 + int.from_bytes(data[i + 2:i + 4], "big")
    if data[i:i + 2] != b"\xff\xc0":
        raise ValueError("no SOF0 marker before the image data")
    return data[:i + 1] + b"\xc1" + data[i + 2:]


def check_ingest_broken(card, out, root, pano, dev) -> bool:
    """Files off the common path, on the card against the plain version:
    a file that is no image and a JPEG whose bytes after its SOI are noise
    give None on both, raising nothing; the panorama cut at half its bytes
    raises nothing on the card (libjpeg, io.cc's decoder, fills a cut
    file; PIL refuses it); the panorama relabelled SOF1 (extended
    sequential) holds the gate, decoded by nvJPEG or refused by it and
    decoded by PIL (backend "refused"), whichever happens."""
    from ccvpe_tpu_torch.data import native_io
    from ccvpe_tpu_torch.ops import resize_cuda
    with open(pano, "rb") as f:
        data = f.read()
    rng = np.random.default_rng(19)
    cases = {"not an image": b"plain text, no image\n" * 8,
             "noise after SOI": b"\xff\xd8" + rng.integers(0, 256, 4096, np.uint8).tobytes(),
             "cut at half": data[:len(data) // 2],
             "SOF1": sof1_jpeg(data)}
    rows = out["broken_checks"] = []
    for name, content in cases.items():
        path = os.path.join(root, name.replace(" ", "_") + ".jpg")
        with open(path, "wb") as f:
            f.write(content)
        before = resize_cuda.backend_counts()
        try:
            card_u8, error = native_io.load_image_raw_native(path, INGEST_OUT_HW, dev), None
        except Exception as e:  # noqa: BLE001 - any raise fails the check, reported
            card_u8, error = None, f"{type(e).__name__}: {e}"
        after = resize_cuda.backend_counts()
        plain_u8 = native_io.load_image_raw_native(path, INGEST_OUT_HW, "cpu")
        backend = [k for k in after if after[k] != before[k]]
        lsb = (None if card_u8 is None or plain_u8 is None else
               int(np.abs(card_u8.astype(np.int32) - plain_u8.astype(np.int32)).max()))
        if name in ("not an image", "noise after SOI"):
            ok = error is None and card_u8 is None and plain_u8 is None
        elif name == "cut at half":
            ok = error is None
        else:
            ok = error is None and lsb is not None and lsb <= INGEST_GATE_MAX_LSB
        rows.append(dict(name=name, card=None if card_u8 is None else list(card_u8.shape),
                         plain=None if plain_u8 is None else list(plain_u8.shape),
                         backend=backend, max_lsb=lsb, error=error, ok=ok))
        log(f"check ingest {name:17s}: card {'None' if card_u8 is None else card_u8.shape} "
            f"({backend}), plain {'None' if plain_u8 is None else plain_u8.shape}, max "
            f"{lsb} LSB{'; raised ' + error if error else ''} {'ok' if ok else 'FAIL'}")
        if not ok:
            return False
    return True


def check_ingest_threads(card, out, paths, dev) -> bool:
    """INGEST_THREADS threads decoding the split at once give one thread's
    bits; load_batch_native (INGEST_THREADS threads, one launch a pass)
    gives load_image_native's."""
    from ccvpe_tpu_torch.data import native_io
    one = [native_io.load_image_raw_native(p, INGEST_OUT_HW, dev) for p in paths]
    with concurrent.futures.ThreadPoolExecutor(INGEST_THREADS) as pool:
        many = list(pool.map(lambda p: native_io.load_image_raw_native(p, INGEST_OUT_HW, dev),
                             paths))
    same = all(np.array_equal(a, b) for a, b in zip(one, many))
    batch = native_io.load_batch_native(paths[:8], INGEST_OUT_HW, INGEST_THREADS, dev)
    singles = np.stack([native_io.load_image_native(p, INGEST_OUT_HW, dev) for p in paths[:8]])
    same_batch = batch is not None and np.array_equal(batch, singles)
    out["threads"] = dict(threads=INGEST_THREADS, files=len(paths), same_bits=same,
                          batch_same_bits=same_batch)
    log(f"check ingest threads: {INGEST_THREADS} threads decoding {len(paths)} panoramas at "
        f"once give one thread's bits {same}; load_batch_native of 8 ({INGEST_THREADS} "
        f"threads) gives load_image_native's {same_batch} "
        f"{'ok' if same and same_batch else 'FAIL'}")
    return same and same_batch


def time_resize_kernels(card, out, decoded):
    """The kernel at the eval path's call (one panorama, normalized) and at
    a batch of 8, from the trace (L2 flushed before each call), beside the
    function's bound, resize_plain and torch.nn.functional.interpolate(
    mode='bilinear', antialias=True) on the same values as float NCHW."""
    import torch.nn.functional as F

    from ccvpe_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
    from ccvpe_tpu_torch.ops import resize_cuda
    rows = out["resize_timing"] = {}
    x8 = torch.from_numpy(np.stack(decoded[:8])).cuda()
    for name, x in (("one panorama", x8[:1]), ("batch 8", x8)):
        xf = x.permute(0, 3, 1, 2).float().contiguous()
        r = rows[name] = dict(
            ms=trace_ms(lambda: resize_cuda.resize(x, INGEST_OUT_HW, IMAGENET_MEAN, IMAGENET_STD),
                        parts=INGEST_KERNELS)["resize"],
            plain_ms=trace_ms(lambda: resize_cuda.resize_plain(x, INGEST_OUT_HW, IMAGENET_MEAN,
                                                               IMAGENET_STD)),
            library_ms=trace_ms(lambda: F.interpolate(xf, size=INGEST_OUT_HW, mode="bilinear",
                                                      antialias=True)),
            plan=resize_cuda.resize_plan(tuple(x.shape[1:3]), INGEST_OUT_HW, x.device),
            **resize_bound(x.shape[0], x.shape[1:3], INGEST_OUT_HW, True))
        log(f"time resize {name} ({tuple(x.shape)} -> {INGEST_OUT_HW}, normalized): kernel "
            f"{r['ms'] * 1e3:.2f} us, plain {r['plain_ms'] * 1e3:.1f} us, interpolate (bilinear, "
            f"antialias) {r['library_ms'] * 1e3:.1f} us, bound {r['bound_ms'] * 1e3:.2f} us "
            f"({r['bound_by']}, {r['bytes'] / 1e6:.2f} MB at 3.35 TB/s: the input read once, "
            f"the output written once; {r['bound_ms'] / r['ms']:.1%} of it), from the trace "
            f"[{card}]")


def time_ingest(card, out, paths, dev):
    """Decode plus resize a panorama (2048 x 1024 JPEG -> 320 x 640,
    normalized float32), host wall clock, files in the page cache (warm):
    on the card alone (load_image_native; nvJPEG's decode alone too) and in
    batches (load_batch_native, 8 threads), against PIL on the host
    (transforms.load_image) in one thread and in 8."""
    from ccvpe_tpu_torch.data import native_io, transforms
    from ccvpe_tpu_torch.ops import resize_cuda
    res = out["ingest_timing"] = {}
    with open(paths[0], "rb") as f:
        data = f.read()

    def median_ms(fn, reps):
        fn()
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            walls.append(time.perf_counter() - t0)
        return float(np.median(walls)) * 1e3

    res["card decode only"] = median_ms(lambda: resize_cuda.decode(data, dev), 10)
    res["card one"] = median_ms(lambda: native_io.load_image_native(paths[0], INGEST_OUT_HW, dev),
                                10)
    cycled = [paths[i % len(paths)] for i in range(max(INGEST_BATCHES))]
    for b in INGEST_BATCHES:
        res[f"card batch {b}"] = median_ms(lambda: native_io.load_batch_native(
            cycled[:b], INGEST_OUT_HW, 8, dev), 3) / b
    n = len(cycled)
    res["pil 1 thread"] = median_ms(lambda: [transforms.load_image(p, INGEST_OUT_HW)
                                             for p in cycled], 1) / n
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        res["pil 8 threads"] = median_ms(lambda: list(pool.map(
            lambda p: transforms.load_image(p, INGEST_OUT_HW), cycled)), 2) / n
    log("time ingest per panorama (2048 x 1024 JPEG -> 320 x 640 float32, warm files): "
        + ", ".join(f"{k} {v:.2f} ms ({1e3 / v:.0f}/s)" for k, v in res.items()) + f" [{card}]")


def run_ingest_eval(card, out, root, dev) -> bool:
    """eval_over_loader over the on-disk split with the graphed decode step,
    the panoramas decoded on the card (VIGORDataset(decode_device=card))
    beside PIL (decode_device=None): the first loop of the card's step
    captures its graph while a loader thread decodes on the card (the
    capture waits, inside, for one panorama decoded after it began); then
    one counted loop (B1 18, the resize 20), INGEST_TIMED_LOOPS timed
    loops of each in turns (pairs/s) and one profiled loop of each (device
    idle share; the resize kernel in the trace against its counter)."""
    import threading

    from ccvpe_tpu_torch.core import config as cfg_lib
    from ccvpe_tpu_torch.core import graphs
    from ccvpe_tpu_torch.data.loader import ThreadedLoader
    from ccvpe_tpu_torch.data.vigor import VIGORDataset
    from ccvpe_tpu_torch.models.cvm import CVM, build_cvm, random_init_
    from ccvpe_tpu_torch.train.evaluate import eval_over_loader
    from ccvpe_tpu_torch.train.step import make_eval_decode_step
    vigor = cfg_lib.vigor()
    b = 8
    sd = random_init_(CVM(vigor).to_empty(device="cpu"),
                      torch.Generator().manual_seed(17)).state_dict()
    model = build_cvm(vigor, dev, state_dict=sd)
    orient = np.linspace(0.0, 359.0, INGEST_N)
    data = {k: VIGORDataset(root, split="samearea", train=False, random_orientation=orient,
                            decode_device=d) for k, d in (("card", dev), ("pil", None))}
    steps = {k: make_eval_decode_step(model) for k in data}

    def loop(k):
        loader = ThreadedLoader(data[k], b, shuffle=False, num_workers=4, drop_last=False)
        return eval_over_loader(steps[k], loader, data[k].meters_per_pixel, with_prob_at_gt=True,
                                device=dev)

    # the card's first loop: the capture (its second batch) waits inside for
    # a panorama of the third batch, which waits for the capture to begin
    capturing, decoded = threading.Event(), threading.Event()
    inside = []
    ds = data["card"]
    real_get, real_capture = ds.__getitem__, graphs.Graph.capture

    def gated(i, rng=None):
        if i >= 2 * b:
            capturing.wait(60)
        sample = real_get(i, rng=rng)
        if capturing.is_set():
            inside.append(i)
            decoded.set()
        return sample

    def capture(self, fn, generators=()):
        def held():
            capturing.set()
            decoded.wait(60)
            return fn()
        try:
            return real_capture(self, held, generators)
        finally:
            capturing.clear()

    ds.__getitem__ = gated
    graphs.Graph.capture = capture
    try:
        loop("card")
    finally:
        graphs.Graph.capture = real_capture
        del ds.__getitem__
    loop("pil")
    zero_launch_counts()
    zero_ingest_counts()
    summary = loop("card")
    counted = dict(launch_counts(), **ingest_counts())
    want = {"corr_fwd": 18, "resize": INGEST_N}
    captured = {k: s.captures for k, s in steps.items()}
    ok = (bool(inside) and captured == {"card": 1, "pil": 1}
          and all(counted[k] == v for k, v in want.items())
          and all(np.isfinite(v) for v in summary.values()))
    out["eval"] = dict(n=INGEST_N, batch=b, decoded_inside_capture=inside, captures=captured,
                       launches=counted, summary=summary, ok=ok)
    log(f"ingest eval: the card step's capture held while the loader decoded panoramas "
        f"{inside} on the card; captures {captured}; a counted loop launches {counted} (want "
        f"{want}); summary {json.dumps(summary)} {'ok' if ok else 'FAIL'}")
    if not ok:
        return False
    walls = {k: [] for k in data}
    for i in range(INGEST_TIMED_LOOPS):
        for k in (("card", "pil") if i % 2 == 0 else ("pil", "card")):
            t0 = time.perf_counter()
            loop(k)
            walls[k].append(time.perf_counter() - t0)
    for k in data:
        wall = float(np.median(walls[k]))
        before = ingest_counts()
        prof = profile_call(lambda: loop(k), f"one on-disk VIGOR eval loop, {k} decode", card,
                            wall * 1e3, ours=("corr_fwd_kernel", "resize_kernel"))
        launched = {n: v - before[n] for n, v in ingest_counts().items()}
        traced = {n: sum(c for name, c in prof["names"].items() if match(name))
                  for n, match in INGEST_KERNELS.items()}
        idle = 1.0 - prof["busy_union_ms"] / prof["wall_ms"]
        out["eval"][k] = dict(loop_s=walls[k], pairs_per_s=INGEST_N / wall, idle_share=idle,
                              resize_traced=traced, resize_counted=launched,
                              busy_union_ms=prof["busy_union_ms"], wall_ms=prof["wall_ms"])
        log(f"ingest eval {k} decode: median {INGEST_N / wall:.2f} pairs/s over "
            f"{INGEST_TIMED_LOOPS} loops (min {INGEST_N / max(walls[k]):.2f}, max "
            f"{INGEST_N / min(walls[k]):.2f}); device idle {idle:.1%} of one profiled loop; "
            f"resize kernel in the trace {traced}, counted {launched} "
            f"{'ok' if traced == launched else 'FAIL'} [{card}]")
        if traced != launched:
            return False
    out["eval"]["launches"] = counted
    return True


def ingest_main(out_path: str) -> int:
    """Phase 18 in its own process: the kernels were built by the parent;
    loading finds them. Files go to a temporary directory, removed after."""
    if not torch.cuda.is_available():
        print("chip_smoke --ingest: no CUDA device", file=sys.stderr)
        return 2
    import tempfile

    from ccvpe_tpu_torch.ops import corr_cuda, resize_cuda
    corr_cuda.load_library()
    resize_cuda.load_library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    out = {"part_s": {}, "backends_created": list(resize_cuda.init(0))}
    ok = False
    with tempfile.TemporaryDirectory(prefix="ccvpe_ingest_") as tmp:
        t = time.perf_counter()
        paths = write_vigor_split(os.path.join(tmp, "vigor"), INGEST_N, INGEST_PATCHES)
        files = write_ingest_files(tmp, paths[0])
        out["part_s"]["files"] = time.perf_counter() - t
        decoded = [resize_cuda.decode(open(p, "rb").read(), dev)[0] for p in paths[:8]]
        gen = torch.Generator(device="cuda").manual_seed(18)
        t = time.perf_counter()
        ok = (check_resize_kernels(card, out, decoded, gen)
              and check_ingest_files(card, out, files, dev)
              and check_ingest_broken(card, out, tmp, paths[0], dev)
              and check_ingest_threads(card, out, paths, dev))
        out["part_s"]["checks"] = time.perf_counter() - t
        if ok:
            t = time.perf_counter()
            time_resize_kernels(card, out, decoded)
            time_ingest(card, out, paths, dev)
            out["part_s"]["timing"] = time.perf_counter() - t
            t = time.perf_counter()
            ok = run_ingest_eval(card, out, os.path.join(tmp, "vigor"), dev)
            out["part_s"]["eval"] = time.perf_counter() - t
    out["backend_counts"] = resize_cuda.backend_counts()
    log(f"ingest: files decoded by each backend {json.dumps(out['backend_counts'])} "
        f"(backends created: {out['backends_created']})")
    out["max_abs_err"] = max((r["max_abs"] for r in out.get("resize_checks", [])), default=None)
    out["seconds"] = time.perf_counter() - t0
    out["ok"] = ok
    with open(out_path, "w") as f:
        json.dump({"ingest": out}, f, indent=1, default=str)
    return 0 if ok else 1


def run_child(flag: str, name: str, timeout_s: int):
    """`python3 chip_smoke.py <flag> chiprun_out/<name>` as a child process
    with CUBLAS_WORKSPACE_CONFIG=:4096:8; returns its wall time and JSON, or
    None where it fails (logged)."""
    os.makedirs(OUT_DIR, exist_ok=True)
    out_path = os.path.abspath(os.path.join(OUT_DIR, name))
    if os.path.exists(out_path):
        os.remove(out_path)
    import gc
    gc.collect()                    # the parent's dead graphs give their pools back
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), flag, out_path],
                              env=env, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        log(f"FAIL: the {flag} child process ran over {timeout_s} s")
        return None
    wall = time.perf_counter() - t0
    if proc.returncode != 0 or not os.path.exists(out_path):
        log(f"FAIL: the {flag} child process exited with {proc.returncode}")
        return None
    with open(out_path) as f:
        return wall, json.load(f)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import ccvpe_tpu_torch
    from ccvpe_tpu_torch.core import config as cfg_lib
    from ccvpe_tpu_torch.csrc.build import KERNELS, build
    from ccvpe_tpu_torch.models.cvm import CVM, random_init_
    from ccvpe_tpu_torch.ops import corr_cuda, lmu_cuda, resize_cuda
    from ccvpe_tpu_torch.ops.corr_cuda import corr_core, corr_core_plain
    from ccvpe_tpu_torch.serve import InferenceEngine
    from ccvpe_tpu_torch.train.step import device_normalize, make_eval_decode_step

    report = {"phase_s": {}}
    last = [time.perf_counter()]

    def phase_done(n):
        """Wall seconds of phase n, into the report, which goes to disk
        after every phase (a later failure keeps the earlier phases')."""
        now = time.perf_counter()
        report["phase_s"][n] = now - last[0]
        last[0] = now
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)

    # 1. the card
    card = card_line()
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"ccvpe_tpu_torch {ccvpe_tpu_torch.__version__} device {kind}")
    report["card"] = card
    # the ingest decodes JPEGs with the toolkit's nvJPEG (csrc/io.cu) and
    # PNGs with PIL; libjpeg's and libpng's headers, which native/io.cc
    # needs, are looked for too
    try:
        import PIL
        pil = f"PIL {PIL.__version__} importable"
    except ImportError:
        pil = "PIL not importable"
    from ccvpe_tpu_torch.ops.resize_cuda import nvjpeg_paths, toolkit_roots
    roots = [str(r) for r in toolkit_roots()]
    headers = {h: os.path.exists(os.path.join("/usr/include", h)) for h in ("jpeglib.h", "png.h")}
    nvjpeg_h = sorted({os.path.realpath(h) for r in roots
                       for h in glob.glob(os.path.join(r, "include", "nvjpeg.h"))
                       + glob.glob(os.path.join(r, "targets", "*", "include", "nvjpeg.h"))})
    nvjpeg_libs = [str(p) for p in nvjpeg_paths()]
    log(f"{pil}; headers in /usr/include: {json.dumps(headers)}; toolkit {roots}: nvjpeg.h "
        f"{nvjpeg_h}, libnvjpeg {nvjpeg_libs}")
    report["pil"], report["image_headers"] = pil, headers
    report["nvjpeg"] = dict(toolkit=roots, header=nvjpeg_h, libraries=nvjpeg_libs)

    phase_done(1)
    # 2. build every kernel, and lmu.cu and lmu_bf16.cu with B3's phase
    #    timer, one nvcc per library, all started together
    jobs = {name: (name, ()) for name in KERNELS}
    jobs["lmu+timer"] = ("lmu", (lmu_cuda.PHASE_TIMER,))
    jobs["lmu_bf16+timer"] = (lmu_cuda.BF16_SOURCE, (lmu_cuda.PHASE_TIMER,))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda job: build(*job), jobs.values())))
    build_s = time.perf_counter() - t0
    for name, b in built.items():
        log(f"build {name}: {b.seconds:.2f} s -> {b.path.name}\n{b.log.strip()}")
    log(f"build all: {build_s:.2f} s wall")
    corr_cuda.load_library()
    lmu_cuda.load_library()
    lmu_cuda.load_timed_library()
    lmu_cuda.load_bf16_library()
    lmu_cuda.load_timed_bf16_library()
    report["nvjpeg"]["created"] = list(resize_cuda.init(0))
    log(f"nvJPEG on the card: created {report['nvjpeg']['created']} (the hardware backend "
        f"{'created' if 'hardware' in report['nvjpeg']['created'] else 'refused'})")
    report["build_s"] = build_s
    report["build_seconds"] = {name: b.seconds for name, b in built.items()}
    scan = sass_scan(built["corr"].path)
    report["corr_sass"] = {fn: dict(hmma=len(ops), opcodes=sorted(set(ops)))
                           for fn, (ops, _) in scan.items()}
    for fn, (ops, _) in scan.items():
        log(f"sass corr {fn[:90]}: {len(ops)} HMMA {sorted(set(ops))}")
    fwd_fns = [fn for fn in scan if "corr_fwd_kernel" in fn]
    if not fwd_fns or not all(any("HMMA.1688.F32.TF32" in op for op in scan[fn][0])
                              for fn in fwd_fns):
        log("FAIL: corr_fwd_kernel holds no HMMA.1688.F32.TF32 instruction")
        return 1
    report["lmu_sass"] = {}
    report["lmu_ptxas"] = {}
    for lib in ("lmu", "lmu+timer", "lmu_bf16", "lmu_bf16+timer"):
        scan = sass_scan(built[lib].path)
        usage = ptxas_usage(built[lib].log)
        report["lmu_sass"][lib] = {fn: dict(hmma=len(ops), opcodes=sorted(set(ops)), clocks=clk)
                                   for fn, (ops, clk) in scan.items()}
        report["lmu_ptxas"][lib] = {lmu_kernel_name(fn): dict(registers=r, spill_stores=st,
                                                              spill_loads=ld)
                                    for fn, (r, st, ld) in usage.items()}
        bf16 = lib.startswith("lmu_bf16")
        for fn, (ops, clk) in scan.items():
            # float32: B2's count since its convs took the tensor cores
            # (432); B3's while da, dh|dskip and dx ran on the FMAs
            t_bwd = lmu_bwd_tile(fn)
            old = ("432" if "lmu_fwd_kernel" in fn
                   else str(FMA_BWD_HMMA[t_bwd]) if t_bwd else "-")
            log(f"sass {lib} {lmu_kernel_name(fn)}: {len(ops)} HMMA"
                + ("" if bf16 else f" (before B3's da, dh|dskip and dx took the tensor cores: "
                   f"{old})")
                + f" {sorted(set(ops))}, {clk} clock reads")
            if "lmu_bwd_kernel" in fn and t_bwd == 8 and len(ops) <= FMA_BWD_HMMA[8]:
                log(f"FAIL: {lib}: {lmu_kernel_name(fn)} holds {len(ops)} HMMA, no more than "
                    f"the {FMA_BWD_HMMA[8]} of its FMA da, dh|dskip and dx")
                return 1
        for fn, (regs, st, ld) in usage.items():
            log(f"ptxas {lib} {lmu_kernel_name(fn)}: {regs} registers, {st} bytes spill stores, "
                f"{ld} bytes spill loads")
        # the float32 kernels' products are m16n8k8 TF32; the bf16 ones'
        # m16n8k16 bf16, and no TF32 product among them
        want, banned = (("HMMA.16816.F32.BF16", "HMMA.1688.F32.TF32") if bf16
                        else ("HMMA.1688.F32.TF32", None))
        kernels_ = (("lmu_fwd_bf16_kernel", "lmu_bwd_bf16_kernel") if bf16
                    else ("lmu_fwd_kernel", "lmu_bwd_kernel"))
        for kernel in kernels_:
            fns = [fn for fn in scan if kernel in fn]
            if not fns or not all(any(want in op for op in scan[fn][0])
                                  and not any(banned and banned in op for op in scan[fn][0])
                                  for fn in fns):
                log(f"FAIL: {lib}: a {kernel} instantiation holds no {want}"
                    + (f" or holds {banned}" if banned else ""))
                return 1
        bwd_fns = [fn for fn in scan if kernels_[1] in fn]
        clocks = sum(scan[fn][1] for fn in bwd_fns)
        if (clocks > 0) != lib.endswith("+timer"):
            log(f"FAIL: {lib}: {kernels_[1]} holds {clocks} clock reads (the main path's "
                "library must hold none, the timed one some)")
            return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    phase_done(2)
    # 3. kernel against plain
    vigor = cfg_lib.vigor()
    batch = 8
    k20 = tuple(range(vigor.num_bins))
    cases = [(f"vigor s{s + 1}", batch, n, d, length, shift, k20, False)
             for s, (n, d, length, shift) in enumerate(vigor_corr_shapes(vigor, batch))]
    oxford = cfg_lib.oxford()
    cases.append(("oxford s1 centre", batch, 64, 1280, oxford.grd_desc_lens[0], 64,
                  tuple(range(oxford.num_bins)), True))
    kitti = cfg_lib.kitti()
    cases.append(("kitti s6 shift 8", batch, 256 * 256, kitti.loc_conv_out[-1],
                  kitti.grd_desc_lens[-1], kitti.roll_shifts[-1],
                  tuple(range(kitti.num_bins)), False))
    cases.append(("kitti s1", batch, 64, kitti.sat_desc_dim, kitti.grd_desc_lens[0],
                  kitti.roll_shifts[0], tuple(range(kitti.num_bins)), False))
    prior = cfg_lib.vigor(ori_noise=72.0).restricted_bins      # K = 9, bins -4..4
    cases.append(("vigor ori-prior s3", batch, 1024, 320, vigor.grd_desc_lens[2], 16,
                  prior, False))
    # ragged N (not a multiple of the 64-row tile), ragged D, K at the maximum
    cases.append(("edges K=32", 3, 1000, 70, 50, 3, tuple(range(corr_cuda.MAX_BINS)), True))
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0
    report["checks"] = []
    for name, b, n, d, length, shift, bins, center in cases:
        s, g_mat, m_mat = corr_inputs(b, n, d, length, shift, bins, center, gen)
        plan = corr_cuda.corr_plan(b, n, d, len(bins), torch.cuda.get_device_properties(0)
                                   .multi_processor_count)
        bare, bare2 = corr_core(s, g_mat, m_mat), corr_core(s, g_mat, m_mat)
        out, r = corr_core(s, g_mat, m_mat, need_r=True)
        out2, r2 = corr_core(s, g_mat, m_mat, need_r=True)
        ref, ref_r = corr_core_plain(s, g_mat, m_mat, need_r=True)
        torch.cuda.synchronize()
        same = (torch.equal(bare, bare2) and torch.equal(out, out2) and torch.equal(r, r2)
                and torch.equal(bare, out))
        err = float((out - ref).abs().max())
        rel = float(((out - ref).abs() / ref.abs().clamp_min(1e-30)).max())
        r_rel = float(((r - ref_r).abs() / ref_r.abs()).max())
        ok = (same and torch.allclose(out, ref, atol=CORR_ATOL, rtol=CORR_RTOL)
              and torch.allclose(bare, ref, atol=CORR_ATOL, rtol=CORR_RTOL)
              and torch.allclose(r, ref_r, atol=0.0, rtol=CORR_RTOL))
        row = dict(name=name, b=b, n=n, d=d, k=len(bins), max_abs=err, r_max_rel=r_rel,
                   same_bits=same, plan=dataclasses.asdict(plan))
        f64 = ""
        if name in ("vigor s1", "kitti s1"):
            want = corr_core_plain(s.double(), g_mat.double(), m_mat.double())
            row["f64_max_abs"] = float((out.double() - want).abs().max())
            row["plain_f64_max_abs"] = float((ref.double() - want).abs().max())
            ok = ok and torch.allclose(out.double(), want, atol=CORR_ATOL, rtol=CORR_RTOL)
            f64 = (f", vs float64 {row['f64_max_abs']:.3g} (plain's {row['plain_f64_max_abs']:.3g})")
        log(f"check {name:20s} B={b} N={n} D={d} K={len(bins)} out max_abs={err:.3g} "
            f"max_rel={rel:.3g} r max_rel={r_rel:.3g}{f64} "
            f"(atol {CORR_ATOL} rtol {CORR_RTOL}, sums in another order), without and with "
            f"r, same bits twice {same}; {plan.slices} slices of {plan.width}, {plan.blocks} "
            f"blocks {'ok' if ok else 'FAIL'}")
        row["ok"] = ok
        report["checks"].append(row)
        if not ok:
            return 1
        max_err = max(max_err, err)

    phase_done(3)
    # 4. timing at the VIGOR shapes, without r (serving) and with r (training)
    report["timing"] = []
    tot = dict.fromkeys(("ms", "plain_ms", "matmul2_ms", "bound_ms", "bytes", "flops", "r_ms",
                         "r_plain_ms", "r_bound_ms", "r_bytes", "r_flops", "ops_ms",
                         "r_ops_ms", "event_ms", "r_event_ms", "host_us", "plan_us"), 0)
    for name, b, n, d, length, shift, bins, center in cases[:6]:
        s, g_mat, m_mat = corr_inputs(b, n, d, length, shift, bins, center, gen)
        k = len(bins)
        plan = corr_cuda.corr_plan(b, n, d, k, torch.cuda.get_device_properties(0)
                                   .multi_processor_count)
        occ = corr_cuda.kernel_occupancy(plan, k)
        smem = corr_cuda.smem_bytes(plan.width, k, plan.kp)
        if occ < plan.blocks_per_sm:
            log(f"FAIL: {name}: the plan assumes {plan.blocks_per_sm} blocks per SM of {smem} B; "
                f"the card holds {occ}")
            return 1
        s2 = s * s
        g_t, m_t = g_mat.transpose(1, 2), m_mat.t()
        row = dict(name=name, n=n, d=d, k=k, plan=dataclasses.asdict(plan), occupancy=occ,
                   smem=smem)
        # kernel, yardstick, plain, one after the other; then with r; each
        # from the trace's kernel durations (trace_ms), and the kernel also
        # from events around the call, which since the op's dispatch counts
        # the host's time of a short call; the op's host time a call, and
        # corr_plan's alone
        row["ms"] = trace_ms(lambda: corr_core(s, g_mat, m_mat))
        row["matmul2_ms"] = trace_ms(lambda: (torch.bmm(s, g_t), torch.matmul(s2, m_t)))
        row["plain_ms"] = trace_ms(lambda: corr_core_plain(s, g_mat, m_mat))
        row["r_ms"] = trace_ms(lambda: corr_core(s, g_mat, m_mat, need_r=True))
        row["r_plain_ms"] = trace_ms(lambda: corr_core_plain(s, g_mat, m_mat, need_r=True))
        row["event_ms"] = time_ms(lambda: corr_core(s, g_mat, m_mat))
        row["r_event_ms"] = time_ms(lambda: corr_core(s, g_mat, m_mat, need_r=True))
        row["host_us"] = host_us(lambda: corr_core(s, g_mat, m_mat))
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        row["plan_us"] = host_us(lambda: corr_cuda.corr_plan(b, n, d, k, sms))
        for p, need_r in (("", False), ("r_", True)):
            bound, by, nbytes, flops, ops_ms = corr_bound(b, n, d, k, need_r)
            row.update({f"{p}bound_ms": bound, f"{p}bound_by": by, f"{p}bytes": nbytes,
                        f"{p}flops": flops, f"{p}ops_ms": ops_ms})
        log(f"plan {name:10s}: T {plan.rows}, {plan.slices} slices of {plan.width}, K padded "
            f"to {plan.kp}, grid {plan.grid_x} x {plan.slices} x {b} = {plan.blocks} blocks, "
            f"{plan.blocks_per_sm} per SM assumed ({occ} fit, {smem} B each)")
        log(f"time {name:10s} N={n:6d} D={d:5d}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, two-matmul yardstick {row['matmul2_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; {row['bytes'] / 1e6:.1f} MB at "
            f"3.35 TB/s, {row['flops'] / 1e9:.2f} GFLOP of TF32 products {row['ops_ms']:.4f} "
            f"ms); with r: kernel "
            f"{row['r_ms']:.4f} ms, plain {row['r_plain_ms']:.4f} ms, bound "
            f"{row['r_bound_ms']:.4f} ms ({row['r_bytes'] / 1e6:.1f} MB); kernel times from "
            f"the trace; events around the call {row['event_ms']:.4f} ms, with r "
            f"{row['r_event_ms']:.4f} ms; host {row['host_us']:.1f} us a call, corr_plan "
            f"{row['plan_us']:.1f} us of it [{card}]")
        report["timing"].append(row)
        for key in tot:
            tot[key] += row[key]
    t_bytes, t_ops = tot["bytes"] / HBM_BYTES_PER_S * 1e3, tot["ops_ms"]
    log(f"time per VIGOR forward (6 launches): kernel {tot['ms']:.4f} ms, plain "
        f"{tot['plain_ms']:.4f} ms, two-matmul {tot['matmul2_ms']:.4f} ms, bound "
        f"{tot['bound_ms']:.4f} ms; with r: kernel {tot['r_ms']:.4f} ms, plain "
        f"{tot['r_plain_ms']:.4f} ms, bound {tot['r_bound_ms']:.4f} ms (from the trace); "
        f"events around the calls {tot['event_ms']:.4f} ms, with r {tot['r_event_ms']:.4f} ms; "
        f"host {tot['host_us']:.1f} us a forward's six calls [{card}]")
    report["timing_total"] = tot

    phase_done(4)
    # 5. the corr backward on the card: grads through the kernel's op
    #    against autograd through its plain version, at the six VIGOR scales
    report["corr_bwd"] = []
    for name, b, n, d, length, shift, bins, center in cases[:6]:
        s_flat = torch.randn(b, n, d, device="cuda", generator=gen)
        grd_v = torch.randn(b, length, device="cuda", generator=gen)
        wgt = torch.randn(b, n, len(bins), device="cuda", generator=gen)
        got = corr_grads(s_flat, grd_v, shift, bins, center, corr_cuda.corr_core_diff, wgt)
        want = corr_grads(s_flat, grd_v, shift, bins, center, corr_core_plain, wgt)
        torch.cuda.synchronize()
        errs = [scaled_err(g, w) if g is not None else 1.0 for g, w in zip(got, want)]
        ok = all(e <= CORR_GRAD_ATOL for e in errs)
        log(f"corr backward {name:8s} N={n:6d} D={d:5d}: grad S {errs[0]:.3g}, grad grd "
            f"{errs[1]:.3g} (scaled, atol {CORR_GRAD_ATOL}) {'ok' if ok else 'FAIL'}")
        report["corr_bwd"].append(dict(name=name, grad_s=errs[0], grad_grd=errs[1], ok=ok))
        if not ok:
            return 1

    phase_done(5)
    # 6. B2 and B3 against their plain versions: the four VIGOR calls, a
    #    ragged no-skip Cout-1 case (Hc, Wc not multiples of any tile) and
    #    large biases (the border must be zero padding, not deconv(0)+bias)
    report["probe"] = check_probe(gen)
    for r in report["probe"]:
        log(f"check mma_probe {r['m']}x{r['n']}x{r['k']}: 3xTF32 scaled err {r['scaled_err']:.3g} "
            f"(rtol {PROBE_RTOL} of max, vs float64), one TF32 product {r['scaled_err_1xtf32']:.3g}, "
            f"same bits twice {r['deterministic']} {'ok' if r['ok'] else 'FAIL'}")
        if not r["ok"]:
            return 1
    report["probe_bf16"] = check_probe(gen, bf16=True)
    for r in report["probe_bf16"]:
        log(f"check mma_probe bf16 {r['m']}x{r['n']}x{r['k']}: m16n8k16 bf16 scaled err "
            f"{r['scaled_err']:.3g} vs float64, {r['scaled_err_plain']:.3g} vs its plain version "
            f"a.float() @ b.float() (rtol {PROBE_RTOL} of max), same bits twice "
            f"{r['deterministic']} {'ok' if r['ok'] else 'FAIL'}")
        if not r["ok"]:
            return 1
    report["mma_rate"] = lmu_cuda.mma_rate()
    report["mma_rate_bf16"] = lmu_cuda.mma_rate(bf16=True)
    for key, what in (("mma_rate", "m16n8k8 TF32"), ("mma_rate_bf16", "m16n8k16 bf16")):
        log(f"rate mma.sync {what} (16 warps an SM, 8 independent products each, no loads): "
            f"{report[key]['cycles_per_mma_per_smsp']:.2f} cycles per product per SM "
            f"sub-partition, {report[key]['tflops']:.1f} TFLOP/s ({card})")
    probe_time = time_probe(gen)
    probe_time_bf16 = time_probe(gen, bf16=True)
    for what, pt in (("", probe_time), (" bf16", probe_time_bf16)):
        log(f"time mma_probe{what} {'x'.join(map(str, PROBE_SHAPES[0]))}: kernel {pt['ms']:.4f} "
            f"ms, plain {pt['plain_ms']:.4f}, torch.matmul {pt['library_ms']:.4f}, "
            f"bound {pt['bound_ms']:.6f} ({pt['bound_by']})")
    lmu_shapes = lmu_call_shapes(vigor, batch)
    kitti_shapes = lmu_call_shapes(kitti, batch, "kitti ")
    report["lmu_checks"] = []
    for shape in lmu_shapes + kitti_shapes + LMU_EXTRA_CASES + list(LMU_TC_CASES):
        r = check_lmu(shape, gen, bias_scale=5.0 if shape[0] == "large biases" else 0.3)
        log(f"check lmu {shape[0]:24s} {shape[1:]}: fwd max_abs {r['fwd_max_abs']:.3g} "
            f"(rtol {LMU_FWD_RTOL} of max), bwd scaled "
            f"{json.dumps({k: float(f'{v:.3g}') for k, v in r['bwd_scaled'].items()})} "
            f"(atol {LMU_BWD_ATOL}), same bits twice {r['deterministic']} "
            f"{'ok' if r['ok'] else 'FAIL'}")
        report["lmu_checks"].append(r)
        if not r["ok"]:
            return 1
    # B3's plan and routes at those cases: the tile T each names, and da,
    # dh|dskip and dx all on the tensor cores
    report["lmu_tc_plans"] = []
    for shape, want_t in LMU_TC_CASES.items():
        x, skip, ws = lmu_inputs(shape, gen)
        plan = lmu_cuda.bwd_plan(x, skip, ws[0], ws[2], ws[4])
        convs = lmu_cuda.bwd_convs(*shape[4:], plan["t"])
        groups = {c: lmu_cuda.bwd_conv_tiles(n, side) for c, (side, _, n, _) in convs.items()}
        routed = all(lmu_cuda.bwd_tensor_core_conv(n, k) for _, k, n, _ in convs.values())
        ok = plan["t"] == want_t and routed
        log(f"check lmu bwd plan {shape[0]:24s}: T {plan['t']} (want {want_t}), weights "
            f"{plan['weights']}, da, dh|dskip and dx on the tensor cores {routed}, n-tiles an "
            f"item {json.dumps(groups)} {'ok' if ok else 'FAIL'}")
        report["lmu_tc_plans"].append(dict(name=shape[0], t=plan["t"], weights=plan["weights"],
                                           routed=routed, n_tiles=groups, ok=ok))
        if not ok:
            return 1
    # B2's y at the tile it picks and at B3's T = 8: the same bits, so the g
    # that B3 recomputes at T = 8 is the forward's (one ReLU mask)
    smem_optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    report["lmu_fwd_tiles"] = []
    for shape in lmu_shapes:
        x, skip, ws = lmu_inputs(shape, gen)
        t = lmu_cuda.fwd_tile(*shape[4:], limit=smem_optin)
        same = torch.equal(lmu_cuda.fused_stage(x, skip, *ws),
                           lmu_cuda.fused_stage(x, skip, *ws, tile=8))
        nbytes = lmu_cuda.fwd_smem_bytes(*shape[4:], t)
        log(f"check lmu fwd {shape[0]:18s}: T {t} ({nbytes} B of {smem_optin}) and T 8 give "
            f"the same bits {same} {'ok' if same else 'FAIL'}")
        report["lmu_fwd_tiles"].append(dict(name=shape[0], t=t, smem=nbytes, same_bits=same))
        if not same:
            return 1
    lmu_fwd_err = max(r["fwd_max_abs"] for r in report["lmu_checks"][:4])
    lmu_bwd_err = max(r["bwd_max_abs"] for r in report["lmu_checks"][:4])

    phase_done(6)
    # 7. B2 and B3 times at the VIGOR shapes
    report["lmu_timing"] = []
    lmu_tot = {}
    for shape in lmu_shapes:
        row = time_lmu(shape, gen)
        report["lmu_timing"].append(row)
        for k, v in row.items():
            if k.endswith(("_ms", "_bytes", "_flops", "_mma")):
                lmu_tot[k] = lmu_tot.get(k, 0) + v
        log(f"time lmu {shape[0]:18s}: fwd kernel {row['fwd_ms']:.3f} ms (at T 8: "
            f"{row['fwd_t8_ms']:.3f}), plain "
            f"{row['fwd_plain_ms']:.3f}, cuDNN chain {row['fwd_chain_ms']:.3f}, bound "
            f"{row['fwd_bound_ms']:.3f} ({row['fwd_bound_by']}, {row['fwd_flops'] / 1e9:.1f} GFLOP "
            f"by each conv's route), on the CUDA cores {row['fwd_f32_bound_ms']:.3f}, "
            f"3xTF32 bound {row['fwd_tc_bound_ms']:.3f}, {row['fwd_mma'] / 1e6:.1f} M mma.sync "
            f"({row['fwd_mma'] * 2048 / row['fwd_ms'] / 1e9:.1f} TF32 TFLOP/s issued); "
            f"bwd kernel {row['bwd_ms']:.3f} ms, plain {row['bwd_plain_ms']:.3f}, cuDNN chain "
            f"{row['bwd_chain_ms']:.3f}, bound {row['bwd_bound_ms']:.3f} ({row['bwd_bound_by']}, "
            f"{row['bwd_flops'] / 1e9:.1f} GFLOP by each conv's route), on the CUDA cores "
            f"{row['bwd_f32_bound_ms']:.3f}, 3xTF32 bound {row['bwd_tc_bound_ms']:.3f}, "
            f"{row['bwd_mma'] / 1e6:.1f} M mma.sync "
            f"({row['bwd_mma'] * 2048 / row['bwd_ms'] / 1e9:.1f} TF32 TFLOP/s issued)")
    log(f"time lmu per step (4 + 4 launches): fwd kernel {lmu_tot['fwd_ms']:.3f} ms (at T 8: "
        f"{lmu_tot['fwd_t8_ms']:.3f}), plain "
        f"{lmu_tot['fwd_plain_ms']:.3f}, chain {lmu_tot['fwd_chain_ms']:.3f}, bound "
        f"{lmu_tot['fwd_bound_ms']:.3f} (each conv's route), {lmu_tot['fwd_f32_bound_ms']:.3f} "
        f"(CUDA cores), {lmu_tot['fwd_tc_bound_ms']:.3f} (3xTF32), "
        f"{lmu_tot['fwd_mma'] * 2048 / lmu_tot['fwd_ms'] / 1e9:.1f} TF32 TFLOP/s issued; "
        f"bwd kernel {lmu_tot['bwd_ms']:.3f} ms, plain "
        f"{lmu_tot['bwd_plain_ms']:.3f}, chain {lmu_tot['bwd_chain_ms']:.3f}, bound "
        f"{lmu_tot['bwd_bound_ms']:.3f} (each conv's route), {lmu_tot['bwd_f32_bound_ms']:.3f} "
        f"(CUDA cores), {lmu_tot['bwd_tc_bound_ms']:.3f} (3xTF32), "
        f"{lmu_tot['bwd_mma'] * 2048 / lmu_tot['bwd_ms'] / 1e9:.1f} TF32 TFLOP/s issued [{card}]")
    # B3 by phase, from the timed library
    report["lmu_bwd_phases"] = []
    for shape, row in zip(lmu_shapes, report["lmu_timing"]):
        r = phase_split(shape, gen, row["bwd_ms"])
        report["lmu_bwd_phases"].append(r)
        log_phases("phases lmu bwd", shape, r, card)
        cyc = {p["phase"]: p["cycles_per_tile"] / 1e3 for p in r["phases"]}
        log("  " + ", ".join(f"{n} {cyc[n]:.1f} k cyc/tile (on the FMAs: {old})"
                             for n, old in zip(("da", "dh|dskip", "dx"),
                                               FMA_BWD_PHASES[shape[0]])))
        if not r["same_bits"]:
            log("FAIL: the timed B3 computes other bits than the untimed one")
            return 1
        loads = sum(p["cycles_per_tile"] for p in r["phases"] if p["phase"].endswith(" load"))
        if r["weights"] == "resident" and loads:
            log("FAIL: the weights are resident, yet tiles spent cycles loading them")
            return 1
    # the checks and timings above do not count
    zero_launch_counts()
    lmu_cuda.mma_probe.launches = 0

    phase_done(7)
    # 8. the serving path at full width
    gen_cpu = torch.Generator().manual_seed(17)
    state_dict = random_init_(CVM(vigor).to_empty(device="cpu"), gen_cpu).state_dict()
    engine = InferenceEngine(vigor, state_dict, batch_size=batch)
    assert engine.device.type == "cuda", engine.device
    engine.warmup()
    torch.cuda.synchronize()
    n_req = 20
    rng = np.random.default_rng(17)
    hg, wg = vigor.grd_size
    hs, ws = vigor.sat_size
    grd = rng.integers(0, 256, (n_req, hg, wg, 3), dtype=np.uint8)
    sat = rng.integers(0, 256, (n_req, hs, ws, 3), dtype=np.uint8)

    corr_core.launches = 0
    t0 = time.perf_counter()
    results = engine.predict(grd, sat)
    predict_s = time.perf_counter() - t0
    launches = corr_core.launches
    n_batches = -(-n_req // batch)
    log(f"main path: {n_req} requests in {n_batches} batches, {predict_s * 1e3:.1f} ms, "
        f"corr launches {launches}")
    if launches != 6 * n_batches:
        log(f"FAIL: expected {6 * n_batches} corr launches, got {launches}")
        return 1
    if len(results) != n_req:
        log(f"FAIL: {len(results)} results for {n_req} requests")
        return 1
    for p in results:
        if not (0 <= p.row < hs and 0 <= p.col < ws and 0.0 <= p.angle_deg < 360.0
                and 0.0 < p.probability <= 1.0 and np.isfinite(p.angle_deg)):
            log(f"FAIL: bad result {p}")
            return 1

    # one batch's forward: corr_impl 'auto' (kernel) vs 'plain', same weights
    model = engine.model
    g = device_normalize(torch.from_numpy(grd[:batch]).cuda())
    s = device_normalize(torch.from_numpy(sat[:batch]).cuda())
    fwd, fwd_ok = forward_auto_vs_plain(model, g, s)
    log(f"forward auto vs plain: {json.dumps(fwd)} {'ok' if fwd_ok else 'FAIL'}")
    report["forward_auto_vs_plain"] = fwd
    if not fwd_ok:
        return 1

    # the scalar eval step once
    step = make_eval_decode_step(model)
    row_off = torch.from_numpy(rng.uniform(-100, 100, batch).astype(np.float32)).cuda()
    col_off = torch.from_numpy(rng.uniform(-100, 100, batch).astype(np.float32)).cuda()
    vecs = step(torch.from_numpy(grd[:batch]).cuda(), torch.from_numpy(sat[:batch]).cuda(),
                row_off, col_off)
    torch.cuda.synchronize()
    rows = vecs[0].tolist()
    if (any(v.shape != (batch,) for v in vecs)
            or not all(bool(torch.isfinite(v.float()).all()) for v in vecs)
            or rows != [r.row for r in results[:batch]]):
        log("FAIL: eval decode step disagrees with predict or is not finite")
        return 1
    log(f"eval decode step: rows {rows}, prob@GT {[f'{x:.3g}' for x in vecs[5].tolist()]}")

    # serving latency: whole batches of 8 through predict, host copies included
    lat = []
    for _ in range(10):
        t0 = time.perf_counter()
        engine.predict(grd[:batch], sat[:batch])
        lat.append(time.perf_counter() - t0)
    p50 = float(np.median(lat))
    log(f"serving vigor batch {batch} (f32, TF32 off): p50 batch latency {p50 * 1e3:.2f} ms, "
        f"{batch / p50:.2f} pairs/s; 20 requests {n_req / predict_s:.2f} pairs/s [{card}]")
    report["serving"] = dict(p50_batch_ms=p50 * 1e3, pairs_per_s=batch / p50,
                             predict20_s=predict_s, batch_ms=[x * 1e3 for x in lat])
    report["profile"] = profile_call(lambda: engine.predict(grd[:batch], sat[:batch]),
                                     "one serving batch", card, p50 * 1e3)
    report["tf32_forward"] = tf32_cost(model, g, s, card)

    phase_done(8)
    # 9. the training slice at full width
    train_launches = run_training(card, report, lmu_shapes)
    if train_launches is None:
        return 1

    phase_done(9)
    # 10. the evaluation path at full width
    eval_launches = run_eval(card, report)
    if eval_launches is None:
        return 1

    phase_done(10)
    # 11. the driver at full width, in a child process
    driver = run_driver_child(card, report, report["train"]["p50_step_ms"])
    if driver is None:
        return 1

    phase_done(11)
    # 12. bench.py's mixed-precision configuration at full width, in a child
    res = run_child("--bench-config", "chip_smoke_bench.json", BENCH_TIMEOUT_S)
    if res is None:
        return 1
    bench = report["bench_config"] = res[1]["bench_config"]
    bench["child_wall_s"] = res[0]
    log(f"bench config: child process wall {res[0]:.2f} s, {bench['seconds']:.2f} s of checks "
        f"and runs [{card}]")
    bench8 = bench["steps"]["bf16 batch 8"]
    bt = bench["bf16_timing_total"]

    phase_done(12)
    # 13. the rest of ModelConfig at full width, in a child: the bf16 B2/B3,
    #     edgefix, phase space
    res = run_child("--model-options", "chip_smoke_options.json", OPTIONS_TIMEOUT_S)
    if res is None:
        return 1
    opts = report["model_options"] = res[1]["model_options"]
    opts["child_wall_s"] = res[0]
    log(f"model options: child process wall {res[0]:.2f} s, {opts['seconds']:.2f} s of checks "
        f"and runs [{card}]")
    fused8 = opts["fused_bf16"]["batch 8"]
    for b in BENCH_BATCHES:
        f, u = opts["fused_bf16"][f"batch {b}"], bench["steps"][f"bf16 batch {b}"]
        log(f"bench.py config batch {b}, bf16 B2/B3 from 256 px beside phase 12's unfused step: "
            f"p50 {f['p50_step_ms']:.2f} vs {u['p50_step_ms']:.2f} ms, {f['pairs_per_s']:.2f} vs "
            f"{u['pairs_per_s']:.2f} pairs/s, peak memory {f['peak_bytes'] / 2 ** 30:.2f} vs "
            f"{u['peak_bytes'] / 2 ** 30:.2f} GiB [{card}]")
    f32_loss = bench["steps"]["f32 batch 8"]["first"]["loss"]
    rel = abs(fused8["first"]["loss"] - f32_loss) / abs(f32_loss)
    opts["fused_bf16"]["loss_rel_to_f32"] = rel
    log(f"bench.py config + lmu_fused_min_res=256 batch 8: first loss {fused8['first']['loss']:.6g} "
        f"against phase 12's float32 step's {f32_loss:.6g}: rel {rel:.3g} (rtol {BF16_LOSS_RTOL}) "
        f"{'ok' if rel <= BF16_LOSS_RTOL else 'FAIL'}")
    if rel > BF16_LOSS_RTOL:
        return 1
    bft = opts["lmu_bf16_timing_total"]

    phase_done(13)
    # 14. the compiled executables: exported programs, graphed serving and
    #     graphed train steps against eager ones, in a child
    res = run_child("--graphs", "chip_smoke_graphs.json", GRAPHS_TIMEOUT_S)
    if res is None:
        return 1
    graphs = report["graphs"] = res[1]["graphs"]
    graphs["child_wall_s"] = res[0]
    log(f"graphs: child process wall {res[0]:.2f} s, {graphs['seconds']:.2f} s of checks and "
        f"runs ({', '.join(f'{k} {v:.1f} s' for k, v in graphs['part_s'].items())}) [{card}]")
    for case, _, _ in GRAPH_TRAIN_CASES:
        e, g = graphs["train"][case]["eager"], graphs["train"][case]["graphed"]
        log(f"graphs {case} batch 8 (deterministic mode): p50 step eager {e['p50_step_ms']:.2f} "
            f"ms, graphed {g['p50_step_ms']:.2f} ms; device busy {e['busy_ms']:.2f} and "
            f"{g['busy_ms']:.2f} ms [{card}]")
    serve_e, serve_g = graphs["serving"]["eager"], graphs["serving"]["graphed"]
    log(f"graphs serving batch 8: p50 eager {serve_e['p50_batch_ms']:.2f} ms, graphed "
        f"{serve_g['p50_batch_ms']:.2f} ms [{card}]")
    # launches in the trace of one replayed step and one replayed serving batch
    graph_f32 = graphs["train"]["fused f32"]["graphed"]["traced_launches"]
    graph_bench = graphs["train"]["bench.py options"]["graphed"]["traced_launches"]
    nodes = graphs["export"]["vigor fused batch 8"]["nodes"]

    def by(key):
        t_b = lmu_tot[f"{key}_bytes"] / HBM_BYTES_PER_S * 1e3
        return "bytes" if t_b >= lmu_tot[f"{key}_ops_ms"] else "operations"

    kernels = [{
        "name": "corr_fwd", "route": "cuda", "source": "ccvpe_tpu_torch/csrc/corr.cu",
        "replaces": "ccvpe_tpu/ops/corr_pallas.py:31",
        "launches": launches, "max_abs_err": max_err,
        "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
        "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None,
        "yardstick_ms": tot["matmul2_ms"], "r_ms": tot["r_ms"], "r_plain_ms": tot["r_plain_ms"],
        "event_ms": tot["event_ms"], "host_us": tot["host_us"],
        "r_bound_ms": tot["r_bound_ms"], "train_launches": train_launches["corr_fwd"],
        "eval_launches": {k: v["counted"]["corr_fwd"] for k, v in eval_launches.items()},
        "eval_traced_launches": {k: v["traced"]["corr_fwd"] for k, v in eval_launches.items()},
        "driver_launches": driver["fit_launches"]["corr_fwd"],
        "bench_launches": bench8["launches"]["corr_fwd"],
        "graph_step_launches": graph_f32["corr_fwd"],
        "graph_serve_launches": serve_g["traced_launches"]["corr_fwd"],
        "export_nodes": nodes["corr_fwd"],
    }, {
        # B1 on a bf16 S: the decoder's maps in bench.py's configuration;
        # launches from its train step at batch 8, times at those five scales
        "name": "corr_fwd_bf16", "route": "cuda", "source": "ccvpe_tpu_torch/csrc/corr.cu",
        "replaces": "ccvpe_tpu/ops/corr_pallas.py:31",
        "launches": bench8["launches"]["corr_fwd_bf16"], "max_abs_err": bench["bf16_max_abs_err"],
        "ms": bt["ms"], "plain_ms": bt["plain_ms"], "bound_ms": bt["bound_ms"],
        "bound_by": bt["bound_by"], "library_ms": None, "yardstick_ms": bt["matmul2_ms"],
        "r_ms": bt["r_ms"],
        "r_plain_ms": bt["r_plain_ms"], "r_bound_ms": bt["r_bound_ms"], "ops_ms": bt["ops_ms"],
        "f32_ms": bt["f32_ms"],
        "f32_r_ms": bt["f32_r_ms"], "f32_bound_ms": bt["f32_bound_ms"],
        "event_ms": bt["event_ms"],
        "eval_launches": bench["predict"]["launches"]["corr_fwd_bf16"],
        "graph_step_launches": graph_bench["corr_fwd_bf16"],
    }, {
        "name": "lmu_fwd", "route": "cuda", "source": "ccvpe_tpu_torch/csrc/lmu.cu",
        "replaces": "ccvpe_tpu/ops/lmu_pallas.py:264",
        "launches": train_launches["lmu_fwd"], "max_abs_err": lmu_fwd_err,
        "ms": lmu_tot["fwd_ms"], "plain_ms": lmu_tot["fwd_plain_ms"],
        "bound_ms": lmu_tot["fwd_bound_ms"], "bound_by": by("fwd"),
        "library_ms": lmu_tot["fwd_chain_ms"], "tc_bound_ms": lmu_tot["fwd_tc_bound_ms"],
        "fma_bound_ms": lmu_tot["fwd_f32_bound_ms"],
        "driver_launches": driver["fit_launches"]["lmu_fwd"],
        "eval_launches": {k: v["counted"]["lmu_fwd"] for k, v in eval_launches.items()
                          if v["counted"]["lmu_fwd"]},
        "eval_traced_launches": {k: v["traced"]["lmu_fwd"] for k, v in eval_launches.items()
                                 if v["traced"]["lmu_fwd"]},
        "graph_step_launches": graph_f32["lmu_fwd"], "export_nodes": nodes["lmu_fwd"],
    }, {
        "name": "lmu_bwd", "route": "cuda", "source": "ccvpe_tpu_torch/csrc/lmu.cu",
        "replaces": "ccvpe_tpu/ops/lmu_pallas.py:404",
        "launches": train_launches["lmu_bwd"], "max_abs_err": lmu_bwd_err,
        "ms": lmu_tot["bwd_ms"], "plain_ms": lmu_tot["bwd_plain_ms"],
        "bound_ms": lmu_tot["bwd_bound_ms"], "bound_by": by("bwd"),
        "library_ms": lmu_tot["bwd_chain_ms"], "tc_bound_ms": lmu_tot["bwd_tc_bound_ms"],
        "fma_bound_ms": lmu_tot["bwd_f32_bound_ms"],
        "driver_launches": driver["fit_launches"]["lmu_bwd"],
        "graph_step_launches": graph_f32["lmu_bwd"],
    }] + [{
        # B2 and B3 on bf16 activations (phase 13): launches from the bf16
        # fused train step at batch 8 (and a predict batch's), times at the
        # four VIGOR calls beside the float32 kernel and the bf16 cuDNN chain
        "name": f"lmu_{key}_bf16", "route": "cuda", "source": "ccvpe_tpu_torch/csrc/lmu_bf16.cu",
        "replaces": f"ccvpe_tpu/ops/lmu_pallas.py:{line}",
        "launches": fused8["launches"][f"lmu_{key}_bf16"],
        "max_abs_err": opts[f"lmu_bf16_{key}_max_abs"],
        "ms": bft[f"{key}_ms"], "plain_ms": bft[f"{key}_plain_ms"],
        "bound_ms": bft[f"{key}_bound_ms"], "bound_by": bft[f"{key}_bound_by"],
        "library_ms": bft[f"{key}_chain_ms"], "f32_ms": bft[f"{key}_f32_ms"],
        "event_ms": bft[f"{key}_event_ms"],
        "eval_launches": opts["fused_bf16"]["predict"]["launches"][f"lmu_{key}_bf16"],
        "graph_step_launches": fused8["traced_launches"][f"lmu_{key}_bf16"],
    } for key, line in (("fwd", 264), ("bwd", 404))]
    # the LMU kernels' tensor-core primitive alone (its entry "checks" names
    # the weight gradients it was first added for), on no path of the
    # model, so it stands beside the kernels and not among them
    probes = [{
        "name": "mma_probe", "route": "cuda", "source": "ccvpe_tpu_torch/csrc/lmu.cu",
        "checks": "lmu_bwd (ccvpe_tpu/ops/lmu_pallas.py:196, _conv3x3_wgrad)",
        "launches": lmu_cuda.mma_probe.launches,
        "max_abs_err": max(r["max_abs"] for r in report["probe"]),
        **probe_time,
    }, {
        "name": "mma_probe_bf16", "route": "cuda", "source": "ccvpe_tpu_torch/csrc/lmu_bf16.cu",
        "checks": "lmu_fwd_bf16, lmu_bwd_bf16 (their ldmatrix and mma.sync.m16n8k16 products)",
        "launches": lmu_cuda.mma_probe.launches,
        "max_abs_err": max(r["max_abs"] for r in report["probe_bf16"]),
        **probe_time_bf16,
    }]
    phase_done(14)
    # 16. scale-out: the data axis across processes, in a child
    res = run_child("--scale-out", "chip_smoke_scale.json", SCALE_TIMEOUT_S)
    if res is None:
        return 1
    scale = report["scale_out"] = res[1]["scale_out"]
    scale["child_wall_s"] = res[0]
    log(f"scale-out: child process wall {res[0]:.2f} s, {scale['seconds']:.2f} s of checks and "
        f"runs ({', '.join(f'{k} {v:.1f} s' for k, v in scale['part_s'].items())}) [{card}]")
    ws1 = scale["world_size_1"]["nccl, world size 1"]
    for k in kernels:
        if k["name"] in ("corr_fwd", "lmu_fwd", "lmu_bwd"):
            # launches in the trace of one replayed step in a nccl group
            k["nccl_step_launches"] = ws1["traced_launches"][k["name"]]
    phase_done(16)
    # 17. the model axis: a nccl group of one, then gloo ranks on the card
    #     at (1, 2) and (2, 2), in a child
    res = run_child("--model-axis", "chip_smoke_model.json", MODEL_TIMEOUT_S)
    if res is None:
        return 1
    model_axis = report["model_axis"] = res[1]["model_axis"]
    model_axis["child_wall_s"] = res[0]
    log(f"model axis: child process wall {res[0]:.2f} s, {model_axis['seconds']:.2f} s of "
        f"checks and runs ({', '.join(f'{k} {v:.1f} s' for k, v in model_axis['part_s'].items())})"
        f" [{card}]")
    fused_case = model_axis["gloo_1x2"][MODEL_TRAIN_CASES[1][0]]["launches"][0][-1]
    for k in kernels:
        if k["name"] in ("corr_fwd", "lmu_fwd", "lmu_bwd"):
            # launches a step on rank 0 of the (1, 2) mesh, ori_axis with the
            # fused stages: B1 on the rank's bin block, B2 and B3 whole
            k["model_axis_launches"] = fused_case[k["name"]]
    phase_done(17)
    # 18. the image ingest: nvJPEG's decode and the resize kernel, on an
    #     on-disk VIGOR split, in a child
    res = run_child("--ingest", "chip_smoke_ingest.json", INGEST_TIMEOUT_S)
    if res is None:
        return 1
    ingest = report["ingest"] = res[1]["ingest"]
    ingest["child_wall_s"] = res[0]
    log(f"ingest: child process wall {res[0]:.2f} s, {ingest['seconds']:.2f} s of checks and "
        f"runs ({', '.join(f'{k} {v:.1f} s' for k, v in ingest['part_s'].items())}); files "
        f"decoded by each backend {json.dumps(ingest['backend_counts'])} [{card}]")
    t, t8 = ingest["resize_timing"]["one panorama"], ingest["resize_timing"]["batch 8"]
    kernels.append({
        # no TPU kernel: the JAX package resizes on the host (native/io.cc);
        # launches from the on-disk eval loop decoding on the card
        "name": "resize", "route": "cuda", "source": "ccvpe_tpu_torch/csrc/io.cu",
        "replaces": "native/io.cc:179", "tpu_kernel": None,
        "launches": ingest["eval"]["launches"]["resize"], "max_abs_err": ingest["max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "batch8_ms": t8["ms"], "batch8_plain_ms": t8["plain_ms"],
        "batch8_bound_ms": t8["bound_ms"], "batch8_library_ms": t8["library_ms"],
    })
    report["kernels"] = kernels
    report["probes"] = probes
    phase_done(18)
    log("phase wall seconds: " + ", ".join(f"{n} {t:.1f}" for n, t in report["phase_s"].items()))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(card)
    log(json.dumps({"kernels": kernels, "probes": probes}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--driver":
        sys.exit(driver_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--bench-config":
        sys.exit(bench_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--model-options":
        sys.exit(options_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--graphs":
        sys.exit(graphs_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--scale-out":
        sys.exit(scale_main(sys.argv[2]))
    if len(sys.argv) == 6 and sys.argv[1] == "--scale-out-rank":
        sys.exit(scale_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
    if len(sys.argv) == 3 and sys.argv[1] == "--model-axis":
        sys.exit(model_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--ingest":
        sys.exit(ingest_main(sys.argv[2]))
    if len(sys.argv) == 6 and sys.argv[1] == "--model-axis-rank":
        sys.exit(model_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
    sys.exit(main())
