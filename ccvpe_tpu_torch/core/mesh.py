"""Processes and the data axis (the port of ccvpe_tpu/core/mesh.py).

The JAX package shards each global batch on the 'data' axis of a device
mesh: under jit the batch is one logical array, so BatchNorm's moments, the
losses and the gradient are those of the global batch, and XLA inserts the
collectives. The port runs one process a card under torch.distributed (the
default process group is the data axis) and makes the same collectives
explicit:

- `global_sum`, a differentiable all-reduce sum, gives BatchNorm its
  global-batch count, sum and sum of squares (nn/efficientnet.py) and the
  losses their global sums (train/losses.py);
- `mean_grads` averages the gradients over the processes in one flat
  float32 all-reduce before clipping and the optimizer's update
  (train/step.py);
- `gather_rows` hands every rank the global batch where gradient
  accumulation slices it into global microbatches (train/step.py);
- `all_hosts_concat` pools per-sample evaluation errors (train/evaluate.py,
  train/stream.py).

Where the 1/N lives: in the gradient mean. Every rank holds the global
batch's loss L and backpropagates it; the backward of `global_sum`
all-reduces its cotangent (the adjoint of a sum every rank holds), so what
the ranks differentiate together is N * L, each rank's gradients are its
share of N times L's, and their mean over the ranks is L's gradient, as is
every cotangent in between up to that factor (BatchNorm's moments
included). For N a power of 2 the factor and the mean are exact.

One process (no process group, or a group of one) runs the single-card code
with the same bits: every collective here is skipped at world size 1, but
the gradient mean, which a group of one runs as x * 1 (under nccl a
one-rank reduce kernel, which a CUDA graph captures with the step).

The model axis (ModelConfig.spatial_axis, ori_axis; the JAX package's
rolled_corr_bin_sharded) is not ported: `make_mesh` raises for a model size
other than 1 (ROADMAP.md, queue item A8, model axis).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def initialized() -> bool:
    """Whether a default process group exists (of any size, one included)."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def is_main() -> bool:
    """Process 0, which writes the files and prints (the JAX Trainer's
    is_main)."""
    return rank() == 0


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=None, backend: Optional[str] = None) -> None:
    """Join `num_processes` processes into the default process group
    (a no-op for one process). `coordinator` is process 0's host:port, or an
    init URL (tcp://..., file://...). The backend is nccl for the card
    (device None, the default, or a CUDA device; the process's card is then
    cuda:(process_id % device_count), made current), gloo where the caller
    asks for the CPU; `backend` names another (gloo on the card: its
    collectives cannot be captured in a CUDA graph)."""
    if not num_processes or num_processes <= 1:
        return
    if not coordinator:
        raise ValueError("more than one process needs a coordinator (host:port of process 0)")
    device = process_device(device, process_id)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id)


def process_device(device=None, process_id: Optional[int] = None) -> torch.device:
    """This process's device: `device` where given, else the card
    cuda:(process_id % device_count) (process_id defaults to this process's
    rank); raises without a card, as every entry point does."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():   # models/cvm.py::resolve_device's refusal
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    pid = rank() if process_id is None else process_id
    return torch.device("cuda", pid % torch.cuda.device_count())


def add_distributed_flags(parser) -> None:
    """Multi-process launch flags for the train scripts: one command per
    process, `--coordinator host:port --num_processes N --process_id i`,
    or env vars CCVPE_{COORDINATOR,NUM_PROCESSES,PROCESS_ID}."""
    g = parser.add_argument_group("distributed")
    g.add_argument("--coordinator",
                   default=os.environ.get("CCVPE_COORDINATOR"),
                   help="host:port of process 0 for torch.distributed")
    g.add_argument("--num_processes", type=int,
                   default=int(os.environ.get("CCVPE_NUM_PROCESSES", "1")))
    g.add_argument("--process_id", type=int,
                   default=int(os.environ.get("CCVPE_PROCESS_ID", "0")))


def setup_distributed(args, device=None) -> Tuple[int, int]:
    """Initialize the process group from parsed flags. Returns (shard_id,
    num_shards) for the loaders' striding; each process then loads
    batch_size / num_shards samples a step."""
    init_distributed(getattr(args, "coordinator", None), getattr(args, "num_processes", None),
                     getattr(args, "process_id", None), device=device)
    return rank(), world_size()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ('data', 'model') mesh: `data` processes, one card each, and a
    model axis of size 1."""
    data: int
    model: int = 1
    axis_names: Tuple[str, str] = ("data", "model")


def make_mesh(data: Optional[int] = None, model: int = 1,
              axis_names: Tuple[str, str] = ("data", "model")) -> Mesh:
    """The mesh of this run: every process on the data axis (TrainConfig's
    data_axis and model_axis name the two axes)."""
    if model != 1:
        raise NotImplementedError(
            f"a model axis '{axis_names[1]}' of size {model} is not ported yet "
            "(ROADMAP.md, queue item A8, model axis)")
    n = world_size()
    data = n if data is None else data
    if data != n:
        raise ValueError(f"a data axis '{axis_names[0]}' of {data} needs {data} processes, "
                         f"this run has {n}")
    return Mesh(data, model, tuple(axis_names))


def backend() -> Optional[str]:
    """The default process group's backend, None without one."""
    return dist.get_backend() if initialized() else None


def capturable() -> bool:
    """Whether the collectives can run inside a CUDA graph: none (no
    process group) or nccl's."""
    return backend() in (None, "nccl")


def _collective_device() -> torch.device:
    """Where a host array goes for a collective: the current card under
    nccl, the host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast `module`'s parameters and buffers from process 0 (no-op
    for one process)."""
    if world_size() > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0)
    return module


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


class _GlobalSum(torch.autograd.Function):
    """All-reduce sum; its backward all-reduces the cotangent (the adjoint
    of a sum whose result every rank holds)."""

    @staticmethod
    def forward(ctx, x):
        y = x.contiguous().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the processes, on every process, differentiable
    (see the module's note on where the 1/N lives); x itself at world
    size 1."""
    if world_size() == 1:
        return x
    return _GlobalSum.apply(x)


def global_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of x over the processes, detached; x at world
    size 1."""
    if world_size() == 1:
        return x.detach()
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX)
    return y


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The processes' x (equal shapes) concatenated on dim 0 in rank order:
    the global batch from each process's block of it; x at world size 1."""
    n = world_size()
    if n == 1:
        return x
    device = x.device
    # gloo gathers host tensors only
    x = (x if backend() == "nccl" else x.cpu()).contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x)
    return torch.cat(parts).to(device)


def mean_grads(params: Sequence[torch.Tensor]) -> None:
    """Average the parameters' gradients over the processes in one flat
    float32 all-reduce, in place: nccl's AVG (a sum of each rank's x / N),
    gloo's SUM then / N (gloo has no AVG). Runs under any process group,
    one of size 1 too, where it leaves the bits."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads or not initialized():
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    if backend() == "nccl":
        dist.all_reduce(flat, op=dist.ReduceOp.AVG)
    else:
        dist.all_reduce(flat)
        if world_size() > 1:
            flat.div_(world_size())
    parts = flat.split([g.numel() for g in grads])
    torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(parts, grads)])


def all_hosts_gather(x) -> np.ndarray:
    """A per-process numpy array (the same shape on every process) stacked
    across processes [P, ...] in rank order; the array itself for one
    process."""
    if world_size() == 1:
        return np.asarray(x)
    t = torch.as_tensor(np.ascontiguousarray(x)).to(_collective_device())
    parts: List[torch.Tensor] = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts).cpu().numpy()


def all_hosts_concat(x) -> np.ndarray:
    """Variable-length per-process 1-D arrays concatenated in rank order
    (per-sample eval errors from sharded loaders, where processes may hold
    unequal counts), as float64; the array itself for one process."""
    if world_size() == 1:
        return np.asarray(x)
    x = np.asarray(x, np.float64)
    lens = all_hosts_gather(np.array([x.shape[0]], np.int64)).ravel()
    width = int(lens.max())
    if width == 0:
        return x
    padded = np.zeros((width,), np.float64)
    padded[: x.shape[0]] = x
    stacked = all_hosts_gather(padded)
    return np.concatenate([stacked[p, : lens[p]] for p in range(len(lens))])
