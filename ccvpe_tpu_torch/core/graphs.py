"""CUDA-graph capture and replay, the port's counterpart of the JAX
package's one compiled executable per shape (ccvpe_tpu/serve.py:55,
ccvpe_tpu/train/step.py:249).

`InferenceEngine` (serve.py), the step of `make_train_step` and the eval
steps (train/step.py, through `GraphCache`) capture their fixed-shape work
on the card once and replay it. A replay runs the captured kernels and
nothing of the Python that launched them, so the launch counters that the
kernels' wrappers bump on the host (corr_core.launches and the like)
would count only the capture, which runs no kernel. `Graph` records each
counter's change over the capture, takes it back, and adds it at every
replay: a replayed step counts the launches an eager one counts. These
counts are bookkeeping, not observations of a replay: chip_smoke.py holds
them to the kernels that a torch.profiler trace of a replayed step,
serving batch and eval loop shows. core/profiling.py::counters() reports
them (`launches.corr` .. `launches.lmu_bwd.bf16`, as the wrappers register
them), beside the process's counts of captures (`graph.captures`),
replays (`graph.replays`) and calls that ran eagerly on a graphed path
(`graph.eager`: a shape's first call, or a stale binding's, counted by the
callers: here GraphCache, serve.py and train/step.py); chip_smoke.py holds
the replays to the batches and steps served.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from ccvpe_tpu_torch.core.profiling import count, span


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
            with span("graph.capture"), self._context(self.cuda_graph):
                out = fn()
        finally:
            after = read_counts()
            add_counts(b - a for a, b in zip(after, before))
        self.launches = tuple(a - b for a, b in zip(after, before))
        count("graph.captures")
        return out

    def replay(self) -> None:
        if self.launches is None:
            raise RuntimeError("replay before capture")
        self.cuda_graph.replay()
        add_counts(self.launches)
        count("graph.replays")


class _Entry:
    """One key's graph: its binding, static inputs and static outputs."""

    def __init__(self, binding, inputs, graph: Graph, outputs):
        self.binding, self.inputs, self.graph, self.outputs = binding, inputs, graph, outputs


class GraphCache:
    """A fixed-shape call as one CUDA graph per (input shapes, dtypes) and
    binding: the eval steps' counterpart of jax.jit (train/step.py).

    `cache(fn, binding, *inputs)` returns fn's tensors for `inputs` (host
    tensors, pinned for a copy that does not block, or tensors on the
    device). The first call for a key runs fn eagerly (it builds the
    kernels, cuDNN's plans and the workspaces); the second captures fn into
    static device inputs and replays the graph once; every later call copies
    its inputs into those static inputs (one copy each, no allocation) and
    replays. `binding` names what the graph reads besides its inputs (the
    eval steps pass the model's identity and the mesh's shape): another
    binding drops the key's graph, and its pool, then runs eagerly and
    captures anew, as make_train_step does for another state. In-place
    changes of what the graph reads keep it valid: the optimizer's update,
    BatchNorm's lerp_ of its running stats, load_state_dict's copy of a
    restored checkpoint. Tensors replaced behind the binding's back (a
    parameter's .data assigned, the model moved) are not seen.

    Outputs are clones of the graph's static outputs, so the next call
    overwrites none of them. fn is not kept: a cache that held it would keep
    what it closes over (the model) alive. A capture that fails raises
    (Graph.capture leaves the launch counters as they were); nothing falls
    back to eager execution. `make_graph` makes each Graph (the CPU tests
    pass a stand-in)."""

    def __init__(self, device, make_graph: Callable[[], Graph] = Graph):
        self.device = torch.device(device)
        self._make_graph = make_graph
        self._graphs: Dict[Tuple, _Entry] = {}
        self._warmed: Dict[Tuple, object] = {}    # key -> binding of its eager call
        self.captures = 0

    def __call__(self, fn: Callable[..., Sequence[torch.Tensor]], binding,
                 *inputs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        key = tuple((tuple(t.shape), t.dtype) for t in inputs)
        entry = self._graphs.get(key)
        if entry is not None and entry.binding != binding:
            # a stale graph: its pool goes before the eager call allocates
            del self._graphs[key]
            entry = None
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
        if entry is None:
            if key not in self._warmed or self._warmed[key] != binding:
                count("graph.eager")
                out = tuple(fn(*(t.to(self.device, non_blocking=True) for t in inputs)))
                self._warmed[key] = binding
                return out
            static = [torch.empty(t.shape, dtype=t.dtype, device=self.device) for t in inputs]
            for dst, src in zip(static, inputs):
                dst.copy_(src)
            graph = self._make_graph()
            outputs = graph.capture(lambda: tuple(fn(*static)))
            entry = self._graphs[key] = _Entry(binding, static, graph, outputs)
            self.captures += 1
        else:
            for dst, src in zip(entry.inputs, inputs):
                dst.copy_(src, non_blocking=True)
        entry.graph.replay()
        return tuple(o.clone() for o in entry.outputs)
