#!/usr/bin/env python3
"""Time copies of the fused LMU stage's backward (B3, ccvpe_tpu_torch/csrc/
lmu.cu::lmu_bwd_kernel) against each other on one NVIDIA card, by phase.

    python3 tools/lmu_bwd_variants.py NAME=FILE.cu [NAME=FILE.cu ...]
        [--out chiprun_out/lmu_bwd_variants.json]

Each FILE.cu is a whole copy of csrc/lmu.cu: an older commit's (`git show
<commit>:ccvpe_tpu_torch/csrc/lmu.cu > FILE.cu`), an edited one, or the
checkout's own. For each copy the tool

  - puts the checkout's per-phase timer (the block from `#ifdef
    CCVPE_LMU_PHASE_TIMER` to its `#else`) in place of the copy's, so that
    every copy's phases are read by one timer;
  - builds it twice, plain and with -DCCVPE_LMU_PHASE_TIMER, all builds
    started together, beside the checkout's csrc/*.cuh, under results/
    lmu_variants/, and prints ptxas' registers and spill bytes and the
    HMMA count of each lmu_bwd_kernel instantiation;
  - checks B2 and B3 against their plain versions (chip_smoke.check_lmu)
    at the VIGOR and KITTI calls and chip_smoke's tensor-core cases, every
    copy on the same inputs;

then times B3 at the four VIGOR calls (batch 8), each copy in the order
given and again in reverse, keeping each copy's better time, and prints
each copy's cycles a tile in every phase from its timed build, with the
card's name and power limit. Exits non-zero if a build or a check fails
(a failed check still lets the timings run).
Compare copies only within one run: times move between runs.
"""

import argparse
import concurrent.futures
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ccvpe_tpu_torch.core import config as cfg_lib  # noqa: E402
from ccvpe_tpu_torch.csrc import build as csrc_build  # noqa: E402
from ccvpe_tpu_torch.ops import lmu_cuda  # noqa: E402

TIMER_START, TIMER_END = "#ifdef CCVPE_LMU_PHASE_TIMER\n", "#else\nstruct PhaseTimer {"
BUILD_ROOT = ROOT / "results" / "lmu_variants"


def timer_block(src: str) -> str:
    start = src.index(TIMER_START)
    return src[start:src.index(TIMER_END, start)]


def with_timer(src: str, timer: str) -> str:
    """src with its per-phase timer block replaced by `timer`."""
    return src.replace(timer_block(src), timer, 1)


def build_all(copies: dict) -> dict:
    """{name: (plain library, timed library)}, every nvcc started at once."""
    timer = timer_block((csrc_build.CSRC / "lmu.cu").read_text())
    jobs = []
    for name, path in copies.items():
        d = BUILD_ROOT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "lmu.cu").write_text(with_timer(Path(path).read_text(), timer))
        for h in csrc_build.headers():
            shutil.copy(h, d)
        jobs += [(name, d / "lmu.cu", d / "liblmu.so", ()),
                 (name, d / "lmu.cu", d / "liblmu_timed.so", (lmu_cuda.PHASE_TIMER,))]

    def run(job):
        name, src, out, defines = job
        t0 = time.perf_counter()
        p = subprocess.run(csrc_build.nvcc_command([src], out, defines), capture_output=True,
                           text=True)
        return job, p.returncode, p.stdout + p.stderr, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        results = list(pool.map(run, jobs))
    libs = {}
    for (name, _, out, defines), rc, log, sec in results:
        tag = name + (" timed" if defines else "")
        if rc:
            print(f"build {tag} FAILED\n{log[-5000:]}", flush=True)
            raise SystemExit(1)
        usage = cs.ptxas_usage(log)
        hmma = {cs.lmu_kernel_name(fn): len(ops) for fn, (ops, _) in cs.sass_scan(out).items()
                if "lmu_bwd_kernel" in fn}
        regs = {cs.lmu_kernel_name(fn): f"{r} registers, spills {st}/{ld} B"
                for fn, (r, st, ld) in usage.items() if "lmu_bwd_kernel" in fn}
        print(f"build {tag}: {sec:.0f} s; ptxas {regs}; HMMA {hmma}", flush=True)
        lib = (lmu_cuda._bind_timed if defines else lmu_cuda._bind)(out)
        libs.setdefault(name, [None, None])[1 if defines else 0] = lib
    return libs


def check_all(libs: dict, seed: int) -> bool:
    """chip_smoke.check_lmu through each copy's plain library, every copy on
    the same inputs."""
    shapes = (cs.lmu_call_shapes(cfg_lib.vigor(), 8)
              + cs.lmu_call_shapes(cfg_lib.kitti(), 8, "kitti ") + list(cs.LMU_TC_CASES))
    load = lmu_cuda.load_library
    ok = True
    try:
        for name, (lib, _) in libs.items():
            lmu_cuda.load_library = lambda lib=lib: lib
            gen = torch.Generator(device="cuda").manual_seed(seed)
            worst = 0.0
            for shape in shapes:
                r = cs.check_lmu(shape, gen)
                worst = max(worst, max(r["bwd_scaled"].values()))
                if not r["ok"]:
                    print(f"check {name} {shape[0]} FAIL {json.dumps(r)}", flush=True)
                    ok = False
            print(f"check {name}: {len(shapes)} shapes, worst B3 scaled error {worst:.3g} "
                  f"(atol {cs.LMU_BWD_ATOL})", flush=True)
    finally:
        lmu_cuda.load_library = load
    return ok


def time_all(libs: dict, gen) -> list:
    names = list(libs)
    rows = []
    for shape in cs.lmu_call_shapes(cfg_lib.vigor(), 8):
        _, b, hc, wc, *_, cout = shape
        x, skip, ws = cs.lmu_inputs(shape, gen)
        dy = torch.randn(b, 2 * hc, 2 * wc, cout, device="cuda", generator=gen)
        ms = {n: [] for n in names}
        for order in (names, names[::-1]):
            for n in order:
                lib = libs[n][0]
                ms[n].append(cs.time_ms(lambda: lmu_cuda._launch_bwd(lib, x, skip, dy, *ws)))
        row = dict(name=shape[0], ms={n: min(v) for n, v in ms.items()}, cycles_per_tile={})
        print(f"time bwd {shape[0]:18s}: "
              + ", ".join(f"{n} {row['ms'][n]:.3f} ms" for n in names), flush=True)
        for n in names:
            plan = lmu_cuda._plan(libs[n][1], b, hc, wc, *shape[4:])
            _, cycles = lmu_cuda._launch_bwd(libs[n][1], x, skip, dy, *ws, timed=True)
            torch.cuda.synchronize()
            per = (cycles.sum(0).double() / (b * -(-2 * hc // plan[0]) * -(-2 * wc // plan[0]))
                   / 1e3).tolist()
            row["cycles_per_tile"][n] = dict(zip(lmu_cuda.BWD_PHASES, per))
            print(f"  {n:10s} T {plan[0]} k cycles a tile: "
                  + "; ".join(f"{p} {c:.1f}" for p, c in zip(lmu_cuda.BWD_PHASES, per))
                  + f"; tile {sum(per):.1f}", flush=True)
        rows.append(row)
    total = {n: sum(r["ms"][n] for r in rows) for n in names}
    print("per step (4 calls): " + ", ".join(f"{n} {t:.3f} ms" for n, t in total.items()))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("copies", nargs="+", metavar="NAME=FILE.cu")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "lmu_bwd_variants.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    copies = dict(c.split("=", 1) for c in args.copies)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libs = build_all(copies)
    checked = check_all(libs, seed=0)
    rows = time_all(libs, torch.Generator(device="cuda").manual_seed(1))
    card = cs.card_line()
    print(card)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=card, copies=copies, checked=checked, calls=rows), f, indent=1)
    return 0 if checked else 1


if __name__ == "__main__":
    sys.exit(main())
