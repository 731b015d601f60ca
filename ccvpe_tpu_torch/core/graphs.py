"""CUDA-graph capture and replay, the port's counterpart of the JAX
package's one compiled executable per shape (ccvpe_tpu/serve.py:55,
ccvpe_tpu/train/step.py:249).

`InferenceEngine` (serve.py) and the step of `make_train_step`
(train/step.py) capture their fixed-shape work on the card once and replay
it. A replay runs the captured kernels and nothing of the Python that
launched them, so the launch counters that the kernels' wrappers bump on
the host (corr_core.launches and the like) would count only the capture,
which runs no kernel. `Graph` records each counter's change over the
capture, takes it back, and adds it at every replay: a replayed step counts
the launches an eager one counts. These counts are bookkeeping, not
observations of a replay: chip_smoke.py holds them to the kernels that a
torch.profiler trace of a replayed step and serving batch shows.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Tuple

import torch


def launch_counters() -> List[Tuple[object, str]]:
    """(wrapper, attribute) of every launch counter of the kernels on the
    entry points' paths: B1 (float32 and bf16 S), B2 and B3 (float32 and
    bf16 activations)."""
    from ccvpe_tpu_torch.ops import corr_cuda, lmu_cuda
    return [(fn, attr) for fn in (corr_cuda.corr_core, lmu_cuda.fused_stage,
                                  lmu_cuda.fused_stage_bwd)
            for attr in ("launches", "bf16_launches")]


def read_counts() -> Tuple[int, ...]:
    return tuple(getattr(fn, attr) for fn, attr in launch_counters())


def add_counts(delta: Iterable[int]) -> None:
    for (fn, attr), d in zip(launch_counters(), delta):
        setattr(fn, attr, getattr(fn, attr) + d)


class Graph:
    """One captured CUDA graph and the kernel launches each replay makes.

    `capture(fn)` records fn's work on the card (its return value holds the
    graph's output tensors, which each replay rewrites); `replay()` runs it
    again and adds the recorded launches to the counters. `context` makes
    the capture context from the graph (torch.cuda.graph by default; the
    CPU tests pass a stand-in). A capture that fails raises: nothing here
    falls back to eager execution."""

    def __init__(self, cuda_graph=None,
                 context: Optional[Callable[..., object]] = None):
        self.cuda_graph = cuda_graph if cuda_graph is not None else torch.cuda.CUDAGraph()
        self._context = context if context is not None else torch.cuda.graph
        self.launches: Optional[Tuple[int, ...]] = None

    def capture(self, fn: Callable[[], object],
                generators: Iterable[torch.Generator] = ()) -> object:
        """Capture fn(); `generators` (CUDA generators fn draws from) are
        registered first, so each replay draws from the state the generator
        holds when it starts (a seed set just before replays the draws an
        eager call after that seed makes) and advances it as an eager call
        does."""
        for gen in generators:
            self.cuda_graph.register_generator_state(gen)
        before = read_counts()
        try:
            with self._context(self.cuda_graph):
                out = fn()
        finally:
            after = read_counts()
            add_counts(b - a for a, b in zip(after, before))
        self.launches = tuple(a - b for a, b in zip(after, before))
        return out

    def replay(self) -> None:
        if self.launches is None:
            raise RuntimeError("replay before capture")
        self.cuda_graph.replay()
        add_counts(self.launches)
