"""The port's tracing: host spans, process-wide counts and device layer
marks, and trace(), which writes them beside the card's kernels (the port
of ccvpe_tpu/core/profiling.py; SURVEY.md 5: the reference has none, it
prints running losses only, train_VIGOR.py:155-157).

- span(name): a host range `ccvpe.<layer>.<stage>` in the torch.profiler
  trace, on the clock of the card's kernels and copies, so each idle
  stretch of the card can be put down to the span the host was in; a span
  belongs to the root span that holds it on its thread. With no profiler
  recording, span returns one shared no-op context: a flag read, no range
  object. The profiler keeps the ranges in memory; trace() writes them.
- count(name, n=1) and counters(): one table of counts for the process.
  counters() also reports the kernels' launch counters under
  `launches.<kernel>`, as each kernel wrapper registers them
  (register_launches), read where they are kept.
- mark(name) and marked(layer): device layer marks. A replayed CUDA graph
  runs its captured kernels and none of the Python that captured them, so
  a layer's bounds inside a replay can show only as kernels: each mark is
  an empty kernel of its own name (`ccvpe_mark_<name>`, csrc/marks.cu, one
  block of one thread, no memory) launched on the current stream, so a
  capture records it with the step and every replay runs it. Marks launch
  only inside marking(device), which the graphed entry points enter
  (serve.py::InferenceEngine._forward, train/step.py::TrainStep._run and
  the EvalStep bodies), and only on a card; elsewhere, and in the program
  export_program traces, mark does nothing.
- trace(logdir): a torch.profiler capture of the block, every thread of
  the host and the card, written as a Chrome trace (chrome://tracing,
  Perfetto).

The JAX module's enable_compile_cache (XLA's persistent compilation cache)
and start_server (XProf's capture server) have no counterpart in PyTorch
and are not ported: nothing is compiled ahead of a call here but the CUDA
kernels, which csrc/build.py caches by source hash, and torch.profiler has
no server to attach to.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import threading
import time
from typing import Dict, Tuple

import torch
import torch.autograd.profiler as _profiler

# the marks of csrc/marks.cu, in the order of its ids: a begin and an end
# for each layer
MARK_LAYERS = ("encoders", "decode", "backward", "optimizer")
MARKS = tuple(f"{layer}_{edge}" for layer in MARK_LAYERS for edge in ("begin", "end"))
_MARK_IDS = {name: i for i, name in enumerate(MARKS)}

_OFF = contextlib.nullcontext()
_counts: Dict[str, int] = {}
_counts_lock = threading.Lock()
_launches: Dict[str, Tuple[object, str]] = {}    # counters() name -> (wrapper, attribute)
_local = threading.local()      # .device: marking()'s device; .recorded: recording_marks()'s list


def span(name: str):
    """The host range `ccvpe.<name>` while a profiler records; one shared
    no-op context otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast("ccvpe." + name)


def count(name: str, n: int = 1) -> None:
    """Add n to the process's count `name` (threads may count at once)."""
    with _counts_lock:
        _counts[name] = _counts.get(name, 0) + n


def register_launches(name: str, fn: object, attr: str = "launches") -> None:
    """Report the launch counter `fn.<attr>` in counters() as
    `launches.<name>` (a kernel wrapper registers its counters where it
    defines them)."""
    _launches["launches." + name] = (fn, attr)


def counters() -> Dict[str, int]:
    """Every count of the process, and every registered launch counter."""
    with _counts_lock:
        out = dict(_counts)
    for name, (fn, attr) in _launches.items():
        out[name] = getattr(fn, attr)
    return out


@contextlib.contextmanager
def marking(device):
    """Marks launch in the block on `device`'s current stream, where it is
    a card (and are recorded under recording_marks on any device)."""
    before = getattr(_local, "device", None)
    _local.device = torch.device(device)
    try:
        yield
    finally:
        _local.device = before


@contextlib.contextmanager
def recording_marks():
    """The list of the names of the marks the block makes on this thread,
    in order, recorded in place of their launches (the CPU tests' stand-in
    for the card's trace)."""
    before = getattr(_local, "recorded", None)
    _local.recorded = recorded = []
    try:
        yield recorded
    finally:
        _local.recorded = before


@functools.cache
def _mark_library() -> ctypes.CDLL:
    """csrc/marks.cu, built at first use, its marks checked against MARKS."""
    from ccvpe_tpu_torch.csrc.build import build
    lib = ctypes.CDLL(str(build("marks").path))
    lib.ccvpe_mark.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.ccvpe_mark.restype = ctypes.c_int
    lib.ccvpe_mark_count.argtypes = []
    lib.ccvpe_mark_count.restype = ctypes.c_int
    lib.ccvpe_mark_name.argtypes = [ctypes.c_int]
    lib.ccvpe_mark_name.restype = ctypes.c_char_p
    built = tuple(lib.ccvpe_mark_name(i).decode() for i in range(lib.ccvpe_mark_count()))
    if built != MARKS:
        raise RuntimeError(f"csrc/marks.cu's marks {built} are not {MARKS}")
    return lib


def mark(name: str) -> None:
    """The mark `name` (one of MARKS) on the current stream of marking()'s
    card; nothing outside marking() or on another device."""
    mark_id = _MARK_IDS[name]
    device = getattr(_local, "device", None)
    if device is None:
        return
    recorded = getattr(_local, "recorded", None)
    if recorded is not None:
        recorded.append(name)
        return
    if device.type != "cuda":
        return
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _mark_library().ccvpe_mark(mark_id, stream)
    if rc != 0:
        raise RuntimeError(f"ccvpe_mark {name} launch failed: CUDA error {rc}")


class marked:
    """`layer`'s begin mark on entry and its end mark on a normal exit."""

    __slots__ = ("layer",)

    def __init__(self, layer: str):
        self.layer = layer

    def __enter__(self) -> None:
        mark(self.layer + "_begin")

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            mark(self.layer + "_end")


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with torch.profiler (every thread of the host, and
    the card when there is one) and write a Chrome trace (chrome://tracing,
    Perfetto) into `logdir` on exit."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=activities, experimental_config=config) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
