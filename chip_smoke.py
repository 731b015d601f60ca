#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ccvpe_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every hand-written kernel from csrc/ with nvcc (sm_90a), one nvcc
     per source, all started together, timed, with ptxas' report;
  3. the correlation kernel against its plain PyTorch version at the main
     path's shapes (VIGOR batch 8), at Oxford, KITTI and ori-prior shapes,
     and at one shape with ragged N and D edges and the largest K;
  4. its kernel / plain / library-matmul times (CUDA events, L2 flushed,
     median) beside the bound from bytes and float32 operations;
  5. the correlation backward: grads of S and of the ground descriptor
     through the kernel's autograd.Function against autograd through the
     plain version, at the six VIGOR scales;
  6. the fused LMU stage kernels (forward B2, backward B3) against their
     plain versions at the four VIGOR calls of a step at
     lmu_fused_min_res=256, a ragged no-skip Cout-1 case and a large-bias
     case; B3 twice, for the same bits;
  7. their kernel / plain / cuDNN-chain times beside their bounds;
  8. the serving path at full width: vigor() with seeded random weights,
     InferenceEngine(batch_size=8).predict on 20 requests (the last batch
     padded), kernel launches counted; one batch's CVM forward with
     corr_impl='auto' held against 'plain'; the scalar eval step once; the
     p50 batch latency over 10 batches; one batch under torch.profiler
     (device busy share, kernel time by name);
  9. the training slice at full width: vigor() with lmu_fused_min_res=256,
     batch 8, create_train_state + make_train_step; the fused calls' shapes
     read from the autograd graph; launches of one step (corr 6, lmu
     forward 4, lmu backward 4); that step against the same step through
     cuDNN (lmu_fused_min_res=0) from the same state: losses, every
     gradient, BN running stats; p50 step time, pairs/s and peak memory
     over 8 steps; one step under torch.profiler;
 10. a {"kernels": [...]} line, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Details go to chiprun_out/chip_smoke.json.

TF32 is off for matmuls and cuDNN throughout, so every comparison and time
is strict float32.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM data sheet, CUDA cores
# Tolerances of the kernel against its plain version: both sum in float32,
# in another order (the kernel over D in 32-wide chunks with fmaf, cuBLAS in
# its own tiling), so scores in [-1, 1] differ by a few ulps times sqrt(D).
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
OUT_DIR = "chiprun_out"


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


def corr_inputs(b, n, d, length, shift, bins, center, gen):
    from ccvpe_tpu_torch.ops.corr import build_roll_matrices
    s = torch.randn(b, n, d, device="cuda", generator=gen)
    grd = torch.randn(b, length, device="cuda", generator=gen)
    g_mat, m_mat = build_roll_matrices(grd, d, shift, bins, center)
    g_mat = (g_mat / torch.linalg.vector_norm(grd, dim=-1)[:, None, None]).contiguous()
    return s, g_mat, m_mat.contiguous()


def corr_bound(b, n, d, k):
    nbytes = 4 * (b * n * d + b * k * d + k * d + b * n * k)
    flops = 4 * b * n * k * d + b * n * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def vigor_corr_shapes(cfg, batch):
    """(N, D, L, shift) of the six scales the VIGOR forward correlates."""
    g = cfg.sat_grid
    dims = (cfg.sat_desc_dim,) + tuple(cfg.loc_conv_out)
    return [((g * 2 ** s) ** 2, dims[s], cfg.grd_desc_lens[s], cfg.roll_shifts[s])
            for s in range(cfg.num_scales)]


def profile_call(fn, what, card, p50_ms, ours=("corr_fwd_kernel",)):
    """Where one call of fn spends device time: torch.profiler kernel
    totals, the device busy share of the window, the top kernels, and the
    share of the kernels whose names contain one of `ours`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernels and copies only: CPU ops (aten::*) carry their kernels' time,
    # and the GPU-side user annotations span the same kernels again.
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda x: -x[1])
    busy_ms = sum(ms for _, ms, _ in kernels)
    own = {k: sum(ms for name, ms, _ in kernels if k in name) for k in ours}
    log(f"profile {what}: wall {wall_ms:.2f} ms (profiled), device busy {busy_ms:.2f} ms "
        f"({busy_ms / wall_ms:.1%} of the profiled wall, {busy_ms / p50_ms:.1%} of the "
        f"unprofiled p50) [{card}]")
    for k, ms in own.items():
        log(f"  {k}: {ms:.3f} ms ({ms / max(busy_ms, 1e-9):.2%} of device time)")
    for name, ms, count in kernels[:15]:
        log(f"  {ms:9.3f} ms {count:4d}x  {name[:110]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, ours_ms=own,
                kernels=[dict(name=n, ms=ms, count=c) for n, ms, c in kernels[:40]])


# --- the fused LMU stage (B2 forward, B3 backward) ---

def lmu_vigor_shapes(cfg, batch):
    """(name, B, Hc, Wc, Cin, Cs, Cd, C1, Cout) of the four fused calls of a
    VIGOR step at lmu_fused_min_res=256: stage 5 of both decoders (skip =
    sat block 0, 16 channels at 256^2) and the final stage with its head."""
    hc = cfg.sat_size[0] // 4          # 128: the input of the 256^2 stage
    return [
        ("loc stage 5", batch, hc, hc, cfg.loc_conv_out[3] + 1, 16,
         cfg.loc_deconv_out[4], cfg.loc_conv_out[4], cfg.loc_conv_out[4]),
        ("ori stage 5", batch, hc, hc, cfg.ori_conv_out[3], 16,
         cfg.ori_deconv_out[4], cfg.ori_conv_out[4], cfg.ori_conv_out[4]),
        ("loc stage 6+head", batch, 2 * hc, 2 * hc, cfg.loc_conv_out[4] + 1, 0,
         cfg.loc_deconv_out[5], cfg.head_hidden, 1),
        ("ori stage 6+head", batch, 2 * hc, 2 * hc, cfg.ori_conv_out[4], 0,
         cfg.ori_deconv_out[5], cfg.head_hidden, 2),
    ]


def lmu_inputs(shape, gen, dyadic=False, bias_scale=0.3):
    """x, skip, torch-layout weights and biases on the card. dyadic: small
    multiples of 1/4 .. 1/16, so that the deconv and conv_a sums are exact
    in float32 in any order and the ReLU mask of the kernel and of the
    plain version agree everywhere (otherwise a pre-activation within
    roundoff of 0 flips a mask bit and moves a gradient by O(1) there)."""
    _, b, hc, wc, cin, cs, cd, c1, cout = shape

    def mk(*size, scale, den=8):
        if dyadic:
            lim = max(1, int(round(scale * den * 2)))
            return torch.randint(-lim, lim + 1, size, device="cuda", generator=gen).float() / den
        return torch.randn(*size, device="cuda", generator=gen) * scale

    x = mk(b, hc, wc, cin, scale=1.0, den=4)
    skip = mk(b, 2 * hc, 2 * wc, cs, scale=1.0, den=4) if cs else None
    ws = (mk(cin, cd, 2, 2, scale=cin ** -0.5), mk(cd, scale=bias_scale),
          mk(c1, cd + cs, 3, 3, scale=(9 * (cd + cs)) ** -0.5, den=16), mk(c1, scale=bias_scale),
          mk(cout, c1, 3, 3, scale=(9 * c1) ** -0.5), mk(cout, scale=bias_scale))
    return x, skip, ws


def lmu_bound(shape, backward):
    """Least time for the stage's work: the float32 operations it must do
    on these inputs (the backward recomputes h and g, then the two
    transposed convs, the three weight-gradient products and dx), or each
    input read once and each output written once, whichever is longer."""
    _, b, hc, wc, cin, cs, cd, c1, cout = shape
    c = cd + cs
    pix = b * 4 * hc * wc
    wts = 4 * cin * cd + cd + 9 * c * c1 + c1 + 9 * c1 * cout + cout
    if backward:
        flops = 2 * pix * (3 * cin * cd + 3 * 9 * c * c1 + 2 * 9 * c1 * cout)
        nbytes = 4 * (2 * (b * hc * wc * cin + pix * cs) + pix * cout + 2 * wts)
    else:
        flops = 2 * pix * (cin * cd + 9 * c * c1 + 9 * c1 * cout)
        nbytes = 4 * (b * hc * wc * cin + pix * cs + pix * cout + wts)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


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


def time_lmu(shape, gen):
    """Kernel, plain and cuDNN-chain times of B2 and B3 at one shape."""
    import torch.nn.functional as F
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
    row["fwd_plain_ms"] = time_ms(lambda: fused_stage_plain(x, skip, *ws))
    with torch.no_grad():
        row["fwd_chain_ms"] = time_ms(chain)
    row["bwd_ms"] = time_ms(lambda: fused_stage_bwd(x, skip, dy, *ws))
    row["bwd_plain_ms"] = time_ms(lambda: fused_stage_bwd_plain(x, skip, dy, *ws))
    row["bwd_chain_ms"] = time_ms(lambda: torch.autograd.grad(out, leaves, dyc, retain_graph=True))
    for key, bwd in (("fwd", False), ("bwd", True)):
        bound, by, nbytes, flops = lmu_bound(shape, bwd)
        row.update({f"{key}_bound_ms": bound, f"{key}_bound_by": by, f"{key}_bytes": nbytes,
                    f"{key}_flops": flops})
    return row


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
    """(B, Hc, Wc, Cin, Cs, Cd, C1, Cout) of every FusedStage call of one
    train-mode forward, read from the autograd graph's saved inputs."""
    out = model(grd, sat, torch.Generator(device=grd.device).manual_seed(0))
    roots = [out.logits, out.ori] + list(out.matching_scores)
    seen, stack, shapes = set(), [r.grad_fn for r in roots], []
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if type(node).__name__ == "FusedStageBackward":
            x, skip, wd, _, w1, _, w2, _ = node.saved_tensors
            shapes.append((*x.shape, 0 if skip is None else skip.shape[-1],
                           wd.shape[1], w1.shape[0], w2.shape[0]))
        stack.extend(fn for fn, _ in node.next_functions)
    return sorted(shapes)


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

    # p50 step time, pairs/s, peak memory
    for _ in range(2):
        step(state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
        ours=("corr_fwd_kernel", "lmu_fwd_kernel", "lmu_bwd_kernel", "lmu_reduce_kernel"))
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import ccvpe_tpu_torch
    from ccvpe_tpu_torch.core import config as cfg_lib
    from ccvpe_tpu_torch.csrc.build import KERNELS, build
    from ccvpe_tpu_torch.models.cvm import CVM, random_init_
    from ccvpe_tpu_torch.ops import corr_cuda, lmu_cuda
    from ccvpe_tpu_torch.ops.corr_cuda import corr_core, corr_core_plain
    from ccvpe_tpu_torch.serve import InferenceEngine
    from ccvpe_tpu_torch.train.step import device_normalize, make_eval_decode_step

    report = {}
    # 1. the card
    card = card_line()
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"ccvpe_tpu_torch {ccvpe_tpu_torch.__version__} device {kind}")
    report["card"] = card

    # 2. build every kernel, one nvcc per source, all started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        built = dict(zip(KERNELS, pool.map(build, KERNELS)))
    build_s = time.perf_counter() - t0
    for name, b in built.items():
        log(f"build {name}: {b.seconds:.2f} s -> {b.path.name}\n{b.log.strip()}")
    log(f"build all: {build_s:.2f} s wall")
    corr_cuda.load_library()
    lmu_cuda.load_library()
    report["build_s"] = build_s

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

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
        out, r = corr_core(s, g_mat, m_mat, need_r=True)
        ref, ref_r = corr_core_plain(s, g_mat, m_mat, need_r=True)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        rel = float(((out - ref).abs() / ref.abs().clamp_min(1e-30)).max())
        r_rel = float(((r - ref_r).abs() / ref_r.abs()).max())
        ok = (torch.allclose(out, ref, atol=CORR_ATOL, rtol=CORR_RTOL)
              and torch.allclose(r, ref_r, atol=0.0, rtol=CORR_RTOL))
        log(f"check {name:20s} B={b} N={n} D={d} K={len(bins)} out max_abs={err:.3g} "
            f"max_rel={rel:.3g} r max_rel={r_rel:.3g} "
            f"(atol {CORR_ATOL} rtol {CORR_RTOL}, sums in another order) "
            f"{'ok' if ok else 'FAIL'}")
        report["checks"].append(dict(name=name, b=b, n=n, d=d, k=len(bins),
                                     max_abs=err, r_max_rel=r_rel, ok=ok))
        if not ok:
            return 1
        max_err = max(max_err, err)

    # 4. timing at the VIGOR shapes
    report["timing"] = []
    tot = dict(ms=0.0, plain_ms=0.0, matmul2_ms=0.0, bound_ms=0.0, bytes=0, flops=0)
    for name, b, n, d, length, shift, bins, center in cases[:6]:
        s, g_mat, m_mat = corr_inputs(b, n, d, length, shift, bins, center, gen)
        k = len(bins)
        s2 = s * s
        g_t, m_t = g_mat.transpose(1, 2), m_mat.t()
        row = dict(name=name, n=n, d=d, k=k,
                   ms=time_ms(lambda: corr_core(s, g_mat, m_mat)),
                   plain_ms=time_ms(lambda: corr_core_plain(s, g_mat, m_mat)),
                   matmul2_ms=time_ms(lambda: (torch.bmm(s, g_t), torch.matmul(s2, m_t))))
        bound, by, nbytes, flops = corr_bound(b, n, d, k)
        row.update(bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)
        log(f"time {name:10s} N={n:6d} D={d:5d}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, two-matmul yardstick {row['matmul2_ms']:.4f} ms, "
            f"bound {bound:.4f} ms ({by}; {nbytes / 1e6:.1f} MB at 3.35 TB/s, "
            f"{flops / 1e9:.2f} GFLOP at 67 TFLOP/s f32)")
        report["timing"].append(row)
        for key in tot:
            tot[key] += row[key]
    t_bytes = tot["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = tot["flops"] / FP32_FLOPS_PER_S * 1e3
    log(f"time per VIGOR forward (6 launches): kernel {tot['ms']:.4f} ms, plain "
        f"{tot['plain_ms']:.4f} ms, two-matmul {tot['matmul2_ms']:.4f} ms, bound "
        f"{tot['bound_ms']:.4f} ms [{card}]")

    # 5. the corr backward on the card: grads through the kernel's Function
    #    against autograd through its plain version, at the six VIGOR scales
    report["corr_bwd"] = []
    for name, b, n, d, length, shift, bins, center in cases[:6]:
        s_flat = torch.randn(b, n, d, device="cuda", generator=gen)
        grd_v = torch.randn(b, length, device="cuda", generator=gen)
        wgt = torch.randn(b, n, len(bins), device="cuda", generator=gen)
        got = corr_grads(s_flat, grd_v, shift, bins, center, corr_cuda.CorrCore.apply, wgt)
        want = corr_grads(s_flat, grd_v, shift, bins, center, corr_core_plain, wgt)
        torch.cuda.synchronize()
        errs = [scaled_err(g, w) if g is not None else 1.0 for g, w in zip(got, want)]
        ok = all(e <= CORR_GRAD_ATOL for e in errs)
        log(f"corr backward {name:8s} N={n:6d} D={d:5d}: grad S {errs[0]:.3g}, grad grd "
            f"{errs[1]:.3g} (scaled, atol {CORR_GRAD_ATOL}) {'ok' if ok else 'FAIL'}")
        report["corr_bwd"].append(dict(name=name, grad_s=errs[0], grad_grd=errs[1], ok=ok))
        if not ok:
            return 1

    # 6. B2 and B3 against their plain versions: the four VIGOR calls, a
    #    ragged no-skip Cout-1 case (Hc, Wc not multiples of any tile) and
    #    large biases (the border must be zero padding, not deconv(0)+bias)
    lmu_shapes = lmu_vigor_shapes(vigor, batch)
    extra = [("ragged, no skip, Cout 1", 2, 13, 21, 9, 0, 8, 12, 1),
             ("large biases", 2, 10, 12, 12, 5, 8, 16, 3)]
    report["lmu_checks"] = []
    for shape in lmu_shapes + extra:
        r = check_lmu(shape, gen, bias_scale=5.0 if shape[0] == "large biases" else 0.3)
        log(f"check lmu {shape[0]:24s} {shape[1:]}: fwd max_abs {r['fwd_max_abs']:.3g} "
            f"(rtol {LMU_FWD_RTOL} of max), bwd scaled "
            f"{json.dumps({k: float(f'{v:.3g}') for k, v in r['bwd_scaled'].items()})} "
            f"(atol {LMU_BWD_ATOL}), same bits twice {r['deterministic']} "
            f"{'ok' if r['ok'] else 'FAIL'}")
        report["lmu_checks"].append(r)
        if not r["ok"]:
            return 1
    lmu_fwd_err = max(r["fwd_max_abs"] for r in report["lmu_checks"][:4])
    lmu_bwd_err = max(r["bwd_max_abs"] for r in report["lmu_checks"][:4])

    # 7. B2 and B3 times at the VIGOR shapes
    report["lmu_timing"] = []
    lmu_tot = {}
    for shape in lmu_shapes:
        row = time_lmu(shape, gen)
        report["lmu_timing"].append(row)
        for k, v in row.items():
            if k.endswith(("_ms", "_bytes", "_flops")):
                lmu_tot[k] = lmu_tot.get(k, 0) + v
        log(f"time lmu {shape[0]:18s}: fwd kernel {row['fwd_ms']:.3f} ms, plain "
            f"{row['fwd_plain_ms']:.3f}, cuDNN chain {row['fwd_chain_ms']:.3f}, bound "
            f"{row['fwd_bound_ms']:.3f} ({row['fwd_bound_by']}, {row['fwd_flops'] / 1e9:.1f} GFLOP); "
            f"bwd kernel {row['bwd_ms']:.3f} ms, plain {row['bwd_plain_ms']:.3f}, cuDNN chain "
            f"{row['bwd_chain_ms']:.3f}, bound {row['bwd_bound_ms']:.3f} ({row['bwd_bound_by']}, "
            f"{row['bwd_flops'] / 1e9:.1f} GFLOP)")
    log(f"time lmu per step (4 + 4 launches): fwd kernel {lmu_tot['fwd_ms']:.3f} ms, plain "
        f"{lmu_tot['fwd_plain_ms']:.3f}, chain {lmu_tot['fwd_chain_ms']:.3f}, bound "
        f"{lmu_tot['fwd_bound_ms']:.3f}; bwd kernel {lmu_tot['bwd_ms']:.3f} ms, plain "
        f"{lmu_tot['bwd_plain_ms']:.3f}, chain {lmu_tot['bwd_chain_ms']:.3f}, bound "
        f"{lmu_tot['bwd_bound_ms']:.3f} [{card}]")
    # the checks and timings above do not count
    corr_core.launches = 0
    lmu_cuda.fused_stage.launches = 0
    lmu_cuda.fused_stage_bwd.launches = 0

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
    raw = {}
    hook = model.conv1_ori.register_forward_hook(lambda m, i, o: raw.update(ori=o))
    outs = {}
    with torch.inference_mode():
        for impl in ("auto", "plain"):
            model.config = dataclasses.replace(vigor, corr_impl=impl)
            outs[impl] = model(g, s)
            raw[impl] = torch.linalg.vector_norm(raw["ori"], dim=1)[..., None]
    hook.remove()
    model.config = vigor
    a, p = outs["auto"], outs["plain"]
    fwd = {
        "logits": float((a.logits - p.logits).abs().max()),
        "heatmap": float((a.heatmap - p.heatmap).abs().max()),
        "scores": [float((x - y).abs().max()) for x, y in
                   zip(a.matching_scores, p.matching_scores)],
    }
    well = (raw["plain"] > ORI_NORM_FLOOR).expand_as(a.ori)
    fwd["ori_well_posed"] = float((a.ori - p.ori)[well].abs().max())
    fwd_ok = (all(torch.isfinite(t).all() for t in (a.logits, a.heatmap, a.ori))
              and torch.allclose(a.logits, p.logits, atol=FWD_LOGIT_ATOL, rtol=FWD_LOGIT_RTOL)
              and fwd["heatmap"] <= FWD_HEATMAP_ATOL
              and fwd["ori_well_posed"] <= FWD_ORI_ATOL
              and all(e <= FWD_SCORE_ATOL for e in fwd["scores"])
              and len(a.matching_scores) == 6
              and tuple(a.heatmap.shape) == (batch, hs, ws, 1))
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

    # 9. the training slice at full width
    train_launches = run_training(card, report, lmu_shapes)
    if train_launches is None:
        return 1

    def by(key):
        t_b = lmu_tot[f"{key}_bytes"] / HBM_BYTES_PER_S
        t_o = lmu_tot[f"{key}_flops"] / FP32_FLOPS_PER_S
        return "bytes" if t_b >= t_o else "operations"

    kernels = [{
        "name": "corr_fwd", "route": "cuda", "source": "ccvpe_tpu_torch/csrc/corr.cu",
        "replaces": "ccvpe_tpu/ops/corr_pallas.py:31",
        "launches": launches, "max_abs_err": max_err,
        "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
        "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None,
        "train_launches": train_launches["corr_fwd"],
    }, {
        "name": "lmu_fwd", "route": "cuda", "source": "ccvpe_tpu_torch/csrc/lmu.cu",
        "replaces": "ccvpe_tpu/ops/lmu_pallas.py:264",
        "launches": train_launches["lmu_fwd"], "max_abs_err": lmu_fwd_err,
        "ms": lmu_tot["fwd_ms"], "plain_ms": lmu_tot["fwd_plain_ms"],
        "bound_ms": lmu_tot["fwd_bound_ms"], "bound_by": by("fwd"),
        "library_ms": lmu_tot["fwd_chain_ms"],
    }, {
        "name": "lmu_bwd", "route": "cuda", "source": "ccvpe_tpu_torch/csrc/lmu.cu",
        "replaces": "ccvpe_tpu/ops/lmu_pallas.py:404",
        "launches": train_launches["lmu_bwd"], "max_abs_err": lmu_bwd_err,
        "ms": lmu_tot["bwd_ms"], "plain_ms": lmu_tot["bwd_plain_ms"],
        "bound_ms": lmu_tot["bwd_bound_ms"], "bound_by": by("bwd"),
        "library_ms": lmu_tot["bwd_chain_ms"],
    }]
    report["kernels"] = kernels
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
