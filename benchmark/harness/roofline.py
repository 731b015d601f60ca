"""A kernel's share of its roofline: the least time its function's own work
needs at the cell's shapes, over the summed trace time of the kernels that
compute it. The work comes from benchmark/work/<function>.py, counted from
the function (each input read once, each output written once, its FLOPs),
not from the route a kernel takes, so it stays when a kernel changes."""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from harness import peaks, spec


def least_seconds(calls, model: dict) -> float:
    """Sum over one step's calls of max(bytes at HBM rate, FLOPs at peak)."""
    rate = peaks.flops_per_s(model)
    return sum(max(b / peaks.HBM_BYTES_PER_S, f / rate) for f, b in calls)


def kernel_share(w, function: str, kernels: Sequence[str]) -> Optional[float]:
    """Percent of the roofline that `kernels` reach in window `w`: the
    function's least time for every step of the window over the kernels'
    summed time. None where the cell has no such work, or where the first
    of `kernels` did not launch once a call of the function a step (the
    route changed: the attribution by name no longer holds)."""
    calls = spec.work_counter(function).calls(w.cell.model, w.cell.traffic)
    if not calls or not w.steps:
        return None
    seconds, launches = w.kernel_seconds(kernels)
    if launches[kernels[0]] != len(calls) * w.steps or seconds <= 0:
        print(f"{function}: {launches} launches in {w.steps} steps, {len(calls)} a step "
              "expected; no roofline read", file=sys.stderr)
        return None
    return 100.0 * least_seconds(calls, w.cell.model) * w.steps / seconds
