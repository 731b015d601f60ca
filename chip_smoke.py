#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ccvpe_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every hand-written kernel from csrc/ with nvcc (sm_90a), timed;
  3. each kernel against its plain PyTorch version at the main path's shapes
     (VIGOR batch 8), at Oxford, KITTI and ori-prior shapes, and at one
     shape with ragged N and D edges and the largest K;
  4. kernel / plain / library-matmul times (CUDA events, L2 flushed, median)
     beside the bound from bytes and float32 operations;
  5. the main path at full width: vigor() with seeded random weights,
     InferenceEngine(batch_size=8).predict on 20 requests (the last batch
     padded), kernel launches counted; one batch's CVM forward with
     corr_impl='auto' held against 'plain'; the scalar eval step once; the
     p50 batch latency over 10 batches; one batch under torch.profiler
     (device busy share, kernel time by name);
  6. a {"kernels": [...]} line, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Details go to chiprun_out/chip_smoke.json.

TF32 is off for matmuls and cuDNN throughout, so every comparison and time
is strict float32.
"""

from __future__ import annotations

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


def profile_batch(engine, grd, sat, card, p50_ms):
    """Where one serving batch spends device time: torch.profiler kernel
    totals, the device busy share of the window, the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.predict(grd, sat)
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
    corr_ms = sum(ms for name, ms, _ in kernels if "corr_fwd_kernel" in name)
    log(f"profile one batch: wall {wall_ms:.2f} ms (profiled), device busy {busy_ms:.2f} ms "
        f"({busy_ms / wall_ms:.1%} of the profiled wall, {busy_ms / p50_ms:.1%} of the "
        f"unprofiled p50), corr kernel {corr_ms:.3f} ms "
        f"({corr_ms / max(busy_ms, 1e-9):.2%} of device time) [{card}]")
    for name, ms, count in kernels[:12]:
        log(f"  {ms:9.3f} ms {count:4d}x  {name[:110]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, corr_ms=corr_ms,
                kernels=[dict(name=n, ms=ms, count=c) for n, ms, c in kernels[:40]])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import ccvpe_tpu_torch
    from ccvpe_tpu_torch.core import config as cfg_lib
    from ccvpe_tpu_torch.csrc.build import build
    from ccvpe_tpu_torch.models.cvm import CVM, random_init_
    from ccvpe_tpu_torch.ops import corr_cuda
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

    # 2. build
    t0 = time.perf_counter()
    built = build("corr")
    build_s = time.perf_counter() - t0
    log(f"build corr: {build_s:.2f} s -> {built.path.name}\n{built.log.strip()}")
    corr_cuda.load_library()
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
    corr_core.launches = 0    # the checks and timings above do not count

    # 5. the main path at full width
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
    report["profile"] = profile_batch(engine, grd[:batch], sat[:batch], card, p50 * 1e3)

    kernels = [{
        "name": "corr_fwd", "route": "cuda", "source": "ccvpe_tpu_torch/csrc/corr.cu",
        "replaces": "ccvpe_tpu/ops/corr_pallas.py:31",
        "launches": launches, "max_abs_err": max_err,
        "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
        "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None,
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
