"""One run of one cell: set-up, the measured window (traced with --trace 1),
the peak memory, the program freed, the check against the reference, the
metrics, and the result as the last line of standard output.

    python3 benchmark/run.py --workload vigor-train-b8 --seed 7 --seconds 20 --trace 0

A run needs as many CUDA cards as the cell asks for, and exits 2 without
a result where they are not there; 3 where JAX, Flax, optax or the JAX
package were loaded into the process."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Optional

import torch

from harness import check, drivers, spec
from harness import trace as trace_lib

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ccvpe_tpu"}
GIB = 2 ** 30


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs() -> None:
    """Any kernel cache a library keeps, inside the checkout at fixed paths
    (the program's own builds go to ccvpe_tpu_torch/csrc/_build/)."""
    base = spec.ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")


def build_kernels() -> None:
    """The program's two libraries on the timed path (B1; B2 and B3), built
    side by side where this checkout has not built them yet."""
    from concurrent.futures import ThreadPoolExecutor

    from ccvpe_tpu_torch.csrc.build import build
    with ThreadPoolExecutor(2) as pool:
        for built in pool.map(build, ("corr", "lmu")):
            if built.seconds:
                print(f"built {built.path.name} in {built.seconds:.1f} s", file=sys.stderr)


def power_limit() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device="cuda",
        started: Optional[float] = None) -> dict:
    """The run's result (without `device`) and its numbers, on `device`."""
    started = time.perf_counter() if started is None else started
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        cache_dirs()
        build_kernels()
    driver = drivers.DRIVERS[cell.kind](cell, seed, device)
    driver.setup()
    setup_s = time.perf_counter() - started
    with drivers.window_range(trace) as prof:
        measured = driver.window(seconds)
    peak = torch.cuda.max_memory_reserved(device) if cuda else 0
    driver.free()
    if cuda:
        torch.cuda.empty_cache()
    checked = driver.check()
    numbers, limits = checked["numbers"], cell.limits
    correct = check.verdict(numbers, limits)
    values = dict(measured, setup_s=setup_s, peak_mem_gib=peak / GIB)
    result = {"correct": correct, "attempted": measured["steps"], "failed": checked["failed"],
              "metrics": {}}
    if trace:
        w = trace_lib.read(prof, measured["steps"], cell)
        for m in cell.per_layer:
            reader = spec.metric_reader(m["name"])
            v = reader.read(w) if reader.KIND == cell.kind else None
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        result["breakdown"] = trace_lib.breakdown(w)
        result["_busy"] = (w.busy_s, w.window_s)
    else:
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result["_peak"] = peak
    result["compared"] = check.compared(numbers, limits)
    return result


def main(argv=None, started: Optional[float] = None) -> int:
    args = parse(argv)
    cell = spec.cell(args.workload)
    chips = {w["name"]: w for w in spec.benchmark()["workloads"]}[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    # one host thread: the engine's copy of each request into pinned
    # staging spread 2-5 ms a request from run to run on four (PERF.md)
    torch.set_num_threads(1)
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", started)
    bad = forbidden_modules()
    if bad:
        print(f"the process loaded {bad}: the benchmark runs without JAX", file=sys.stderr)
        return 3
    line = result_line(result, {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": chips, "power_limit_w": power_limit()})
    for k, v in line["compared"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def result_line(result: dict, device: dict) -> dict:
    """The last line: correct, attempted, failed, metrics, [breakdown],
    device (with the peak, and the traced window's busy and window
    seconds), and the numbers compared, each with its limit, last."""
    result = dict(result)
    device = dict(device, memory_peak_bytes=result.pop("_peak"))
    busy = result.pop("_busy", None)
    if busy is not None:
        device["busy_s"], device["window_s"] = busy
    compared = result.pop("compared")
    return dict(result, device=device, compared=compared)
