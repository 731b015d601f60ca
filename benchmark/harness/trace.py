"""The traced window: torch.profiler over the whole measured window (CPU
and CUDA activity; events kept in memory, nothing written to disk), read
once the window has closed into what the per-layer readers take (`Window`)
and into the result's `breakdown`.

Busy time is the union of the spans of every kernel, copy and set on the
device inside the window's own span (a `record_function` range the
drivers open around the window): graph replays run some kernels side by
side, so a sum of their times can pass the window. An idle gap is a
stretch of the window with nothing on the device; a gap of GAP_US or more
is put down to the innermost host event that covers its middle (an
operator, a CUDA runtime call or one of the drivers' ranges: what the host
was doing), shorter ones to the launches between kernels."""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

WINDOW_RANGE = "bench.window"
GAP_US = 20.0          # shorter idle gaps are the launch gaps between kernels
LAUNCH_GAPS = "launch gaps under 20 us"
TOP = 10


@dataclasses.dataclass
class Window:
    """What a per-layer reader reads: the device's kernel events of the
    window (name, start ns, duration ns), its busy and window seconds, the
    steps (train) or requests (serve) completed in it, and the cell."""
    kernels: List[Tuple[str, int, int]]
    busy_s: float
    window_s: float
    steps: int
    cell: object                 # harness.spec.Cell
    gaps: Dict[str, float] = dataclasses.field(default_factory=dict)

    def kernel_seconds(self, names) -> Tuple[float, Dict[str, int]]:
        """Summed seconds of the kernels whose name holds one of `names`,
        and each name's launches."""
        total, launches = 0, {n: 0 for n in names}
        for name, _, dur in self.kernels:
            for n in names:
                if n in name:
                    total += dur
                    launches[n] += 1
                    break
        return total / 1e9, launches


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _events(prof):
    """(device, host) events as (name, start ns, end ns) lists, and the
    window range's (start, end)."""
    from torch.autograd import DeviceType
    device, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.name(), start, end))
        else:
            if e.name() == WINDOW_RANGE:
                window = (start, end)
            host.append((e.name(), start, end))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_RANGE} range")
    return device, host, window


def read(prof, steps: int, cell) -> Window:
    return window(*_events(prof), steps, cell)


def window(device, host, span, steps: int, cell) -> Window:
    """The Window of device and host events (name, start ns, end ns) within
    the window's span (start ns, end ns)."""
    w0, w1 = span
    device = [(n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1]
    device.sort(key=lambda x: x[1])
    busy, reach, gaps = 0, w0, []
    for _, s, e in device:
        if s > reach:
            gaps.append((reach, s))
        if e > reach:
            busy += e - max(s, reach)
            reach = e
    if w1 > reach:
        gaps.append((reach, w1))
    kernels = [(n, s, e - s) for n, s, e in device]
    return Window(kernels, busy / 1e9, (w1 - w0) / 1e9, steps, cell, _attribute(gaps, host))


def _attribute(gaps, host) -> Dict[str, float]:
    """Idle seconds by what the host was doing."""
    out: Dict[str, float] = defaultdict(float)
    big = [(s, e) for s, e in gaps if e - s >= GAP_US * 1e3]
    out[LAUNCH_GAPS] = sum(e - s for s, e in gaps if e - s < GAP_US * 1e3) / 1e9
    if big and host:
        names = [h[0] for h in host]
        hs = np.array([h[1] for h in host], dtype=np.int64)
        he = np.array([h[2] for h in host], dtype=np.int64)
        dur = he - hs
        for s, e in big:
            mid = (s + e) // 2
            cover = np.nonzero((hs <= mid) & (he >= mid))[0]
            name = names[cover[np.argmin(dur[cover])]] if len(cover) else "python, no op"
            out[name] += (e - s) / 1e9
    elif big:
        out["python, no op"] += sum(e - s for s, e in big) / 1e9
    return dict(out)


def breakdown(w: Window) -> dict:
    by_name: Dict[str, float] = defaultdict(float)
    for name, _, dur in w.kernels:
        by_name[name] += dur / 1e9
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:TOP]
    gaps = sorted(((n, s) for n, s in w.gaps.items() if s > 0), key=lambda x: -x[1])[:TOP]
    return {"device_ops": [[_short(n), s] for n, s in ops],
            "idle_gaps": [[_short(n), s] for n, s in gaps]}


def _short(name: str, n: int = 160) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."
