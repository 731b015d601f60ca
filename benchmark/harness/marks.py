"""The program's device layer marks in a traced window: empty kernels named
ccvpe_mark_<layer>_begin and ccvpe_mark_<layer>_end that ccvpe_tpu_torch
launches at a layer's bounds on the step's stream, inside its CUDA graphs
(its core/profiling.py::mark). A layer's time, once a step, is the device's
time from the end of its begin mark to the start of the end mark that
follows. A program without marks (an older one) gives none: its readers
then give None and the run prints no value."""

from __future__ import annotations

import statistics
from typing import List, Optional

PREFIX = "ccvpe_mark_"


def spans(w, layer: str) -> List[float]:
    """Seconds between each `layer` begin mark and the end mark after it,
    in order; a begin with no end in the window is left out."""
    begin, end = f"{PREFIX}{layer}_begin", f"{PREFIX}{layer}_end"
    out, opened = [], None
    for name, start, dur in sorted(w.kernels, key=lambda k: k[1]):
        if begin in name:
            opened = start + dur
        elif end in name and opened is not None:
            out.append((start - opened) / 1e9)
            opened = None
    return out


def median_ms(w, layer: str) -> Optional[float]:
    """The median of spans(w, layer) in ms, or None where it is empty."""
    s = spans(w, layer)
    return 1e3 * statistics.median(s) if s else None
