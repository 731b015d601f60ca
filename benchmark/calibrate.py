"""The readings that a cell's limits (benchmark/limits/<cell>.json) are set
from, in one process on the card: the program's numbers on each of
`--seeds` (its set-up, which drives the train step's first steps, and for
a serving cell a window of `--seconds`), and on each of `--control-seeds`
the numbers of the reference put in the program's place in TF32 (the
control) and, for a training cell, with half of each batch left out (a
planted fault). A step that returns its state unchanged reads 1 on the
change by its definition and needs no run.

    python3 benchmark/calibrate.py --workload vigor-train-b8 --seeds 1,2,3 \
        --control-seeds 4,5,6 --out chiprun_out/calib.jsonl

One JSON line a reading on --out and on standard output."""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import torch  # noqa: E402

from harness import drivers, main as harness_main, spec  # noqa: E402

STAND_INS = {"train": {"control_tf32": {"tf32": True}, "fault_half_batch": {"half_batch": True}},
             "serve": {"control_tf32": {"tf32": True}}}


def readings(cell, seeds, control_seeds, seconds, device="cuda"):
    """Yield one dict a reading."""
    for seed in seeds:
        d = drivers.DRIVERS[cell.kind](cell, seed, device)
        t = time.perf_counter()
        d.setup()
        if cell.kind == "serve":
            d.window(seconds)
        d.free()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        c = d.check()
        yield {"what": "program", "seed": seed, **c["numbers"], "detail": c.get("detail"),
               "seconds": time.perf_counter() - t}
        del d
    for seed in control_seeds:
        d = drivers.DRIVERS[cell.kind](cell, seed, device)
        d.make_pool()
        for what, stand_in in STAND_INS[cell.kind].items():
            c = d.check(stand_in)
            yield {"what": what, "seed": seed, **c["numbers"], "detail": c.get("detail")}
        del d


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", required=True)
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("calibrate.py reads the card", file=sys.stderr)
        return 2
    cell = spec.cell(a.workload)
    harness_main.cache_dirs()
    harness_main.build_kernels()
    seeds = [int(s) for s in a.seeds.split(",") if s]
    controls = [int(s) for s in a.control_seeds.split(",") if s]
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    with open(a.out, "a") as f:
        for r in readings(cell, seeds, controls, a.seconds):
            line = json.dumps({"cell": cell.name, **r})
            print(line, flush=True)
            f.write(line + "\n")
            f.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
