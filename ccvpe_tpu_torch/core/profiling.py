"""Tracing and profiling helpers (the port of ccvpe_tpu/core/profiling.py;
SURVEY.md 5: the reference has none, it prints running losses only,
train_VIGOR.py:155-157).

- sync / sync_element: completion barriers by value fetch;
- StepTimer: wall-clock step timing with a barrier, items/s;
- trace(): a torch.profiler capture written as a Chrome trace;
- flop_cost(): the operations of a call, counted by
  torch.utils.flop_counter (in place of JAX's hlo_cost).

The JAX module's enable_compile_cache (XLA's persistent compilation cache)
and start_server (XProf's capture server) have no counterpart in PyTorch
and are not ported: nothing is compiled ahead of a call here but the CUDA
kernels, which csrc/build.py caches by source hash, and torch.profiler has
no server to attach to.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, List, Optional

import torch


def _leaves(tree: Any) -> List[torch.Tensor]:
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return []


def sync(tree: Any) -> Any:
    """Synchronize by VALUE: a host copy of every tensor of `tree` (nested
    dicts, lists and tuples), returned in the same structure. The bytes
    exist on the host only once the work that made them has run, so this is
    a completion barrier on any device. It copies every tensor: for large
    outputs use sync_element."""
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: sync(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(sync(v) for v in tree)
    return tree


def sync_element(tree: Any) -> float:
    """A value fetch of ONE element of the first tensor of `tree`: the read
    waits for the stream's work up to that tensor, moving 4 bytes, the
    barrier for timing loops whose outputs are large."""
    leaf = _leaves(tree)[0]
    return float(leaf.detach().reshape(-1)[0].item())


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with torch.profiler (the host, and the card when
    there is one) and write a Chrome trace (chrome://tracing, Perfetto)
    into `logdir` on exit."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    """Rolling step timer. Call .tick(batch_size, outputs) once per step."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: List[float] = []
        self._items: List[int] = []

    def tick(self, items: int, block_on: Optional[Any] = None) -> None:
        if block_on is not None:
            sync_element(block_on)   # the step's work is done before the clock is read
        self._times.append(time.perf_counter())
        self._items.append(items)
        if len(self._times) > self.window + 1:
            self._times.pop(0)
            self._items.pop(0)

    @property
    def items_per_s(self) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        return sum(self._items[1:]) / dt if dt > 0 else 0.0


def flop_cost(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """{"flops": n}: the floating-point operations of fn(*args, **kwargs)
    as torch.utils.flop_counter.FlopCounterMode counts them (matmuls,
    convolutions, attention, and their backward where fn runs one). The call
    runs once. The port's hand-written kernels (B1 corr.cu, B2 and B3
    lmu.cu) are launched through ctypes, outside PyTorch's dispatcher, so
    their operations are NOT counted: chip_smoke.py computes their bounds
    from their shapes."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops())}
