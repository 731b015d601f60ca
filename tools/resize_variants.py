#!/usr/bin/env python3
"""Time copies of the ingest's resize kernel (ccvpe_tpu_torch/csrc/io.cu::
resize_kernel) against each other on one NVIDIA card.

    python3 tools/resize_variants.py NAME=FILE.cu [NAME=FILE.cu ...]
        [--out chiprun_out/resize_variants.json]

Each FILE.cu is a whole copy of csrc/io.cu: an older commit's (`git show
<commit>:ccvpe_tpu_torch/csrc/io.cu > FILE.cu`), an edited one, or the
checkout's own. The tool

  - builds every copy beside the checkout's csrc/*.cuh, linked with nvJPEG,
    all builds started together, under results/resize_variants/;
  - checks each copy's kernel against resize_plain, bit for bit, twice,
    uint8 and normalized, on a batch of 8 VIGOR-sized panoramas
    (chip_smoke.ingest_panorama rolled), a row of no multiple of 4 bytes,
    a steep vertical and a steep horizontal downscale, every copy on the
    same inputs, and prints each copy's plan of each case;
  - times each copy, normalized, at the eval path's call (one 2048 x 1024
    panorama to 320 x 640) and at a batch of 8, from the trace with the
    L2 flushed before each call (chip_smoke.trace_ms), the copies in the
    order given and again in reverse, keeping each copy's better time,

with the card's name and power limit. Exits non-zero if a build or a check
fails (a failed check still lets the timings run). Compare copies only
within one run: times move between runs.
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

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ccvpe_tpu_torch.csrc import build as csrc_build  # noqa: E402
from ccvpe_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD  # noqa: E402
from ccvpe_tpu_torch.ops import resize_cuda  # noqa: E402

BUILD_ROOT = ROOT / "results" / "resize_variants"


def build_all(copies: dict) -> dict:
    """{name: bound library}, every nvcc started at once."""
    jobs = []
    for name, path in copies.items():
        d = BUILD_ROOT / name
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy(path, d / "io.cu")
        for h in csrc_build.headers():
            shutil.copy(h, d)
        jobs.append((name, d / "io.cu", d / "libio.so"))

    def run(job):
        _, src, out = job
        t0 = time.perf_counter()
        p = subprocess.run(csrc_build.nvcc_command([src], out, (), csrc_build.LINK_FLAGS["io"]),
                           capture_output=True, text=True)
        return job, p.returncode, p.stdout + p.stderr, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        results = list(pool.map(run, jobs))
    resize_cuda.load_library()        # the checkout's build, and nvJPEG loaded for every copy
    libs = {}
    for (name, _, out), rc, log, sec in results:
        if rc:
            print(f"build {name} FAILED\n{log[-5000:]}", flush=True)
            raise SystemExit(1)
        usage = {fn: f"{r} registers, spills {st}/{ld} B"
                 for fn, (r, st, ld) in cs.ptxas_usage(log).items() if "resize_kernel" in fn}
        print(f"build {name}: {sec:.0f} s; ptxas {usage}", flush=True)
        libs[name] = resize_cuda.bind(out)
    return libs


def through(lib):
    """resize_cuda's entries bound to `lib` for the scope."""
    class Scope:
        def __enter__(self):
            self.load = resize_cuda.load_library
            resize_cuda.load_library = lambda: lib

        def __exit__(self, *exc):
            resize_cuda.load_library = self.load
    return Scope()


def panoramas(n: int) -> torch.Tensor:
    pano = cs.ingest_panorama()
    return torch.from_numpy(np.stack([np.roll(pano, 97 * i, axis=1) for i in range(n)])).cuda()


def check_all(libs: dict, seed: int) -> bool:
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def noise(*shape):
        return torch.randint(0, 256, shape, device="cuda", generator=gen, dtype=torch.uint8)

    cases = [("vigor batch 8", panoramas(8), cs.INGEST_OUT_HW),
             ("odd row", noise(2, 33, 77, 3), (10, 20)),
             ("steep downscale", noise(2, 400, 96, 3), (5, 24)),
             ("steep horizontal", noise(1, 30, 20000, 3), (4, 10))]
    ok = True
    for name, lib in libs.items():
        with through(lib):
            for case, x, hw in cases:
                plan = resize_cuda.resize_plan(tuple(x.shape[1:3]), hw, x.device)
                for mean, std in ((None, None), (IMAGENET_MEAN, IMAGENET_STD)):
                    a = resize_cuda.resize(x, hw, mean, std)
                    b = resize_cuda.resize(x, hw, mean, std)
                    want = resize_cuda.resize_plain(x, hw, mean, std)
                    same = torch.equal(a, b) and torch.equal(a, want)
                    ok &= same
                    print(f"check {name} {case} {'uint8' if mean is None else 'normalized'} "
                          f"(plan {plan}): resize_plain's bits twice {same}", flush=True)
    return ok


def time_all(libs: dict) -> dict:
    names = list(libs)
    x8 = panoramas(8)
    rows = {}
    for call, x in (("one panorama", x8[:1]), ("batch 8", x8)):
        ms = {n: [] for n in names}
        for order in (names, names[::-1]):
            for n in order:
                with through(libs[n]):
                    ms[n].append(cs.trace_ms(
                        lambda: resize_cuda.resize(x, cs.INGEST_OUT_HW, IMAGENET_MEAN,
                                                   IMAGENET_STD),
                        parts=cs.INGEST_KERNELS)["resize"])
        rows[call] = {n: min(v) for n, v in ms.items()}
        print(f"time {call}: " + ", ".join(f"{n} {t * 1e3:.3f} us (runs "
                                           f"{', '.join(f'{u * 1e3:.3f}' for u in ms[n])})"
                                           for n, t in rows[call].items()), flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("copies", nargs="+", metavar="NAME=FILE.cu")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "resize_variants.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    copies = dict(c.split("=", 1) for c in args.copies)
    libs = build_all(copies)
    checked = check_all(libs, seed=20)
    rows = time_all(libs)
    card = cs.card_line()
    print(card)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=card, copies=copies, checked=checked, ms=rows), f, indent=1)
    return 0 if checked else 1


if __name__ == "__main__":
    sys.exit(main())
