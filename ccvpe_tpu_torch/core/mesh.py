"""Processes and the ('data', 'model') mesh (the port of
ccvpe_tpu/core/mesh.py and of jax.set_mesh).

The JAX package shards each global batch on the 'data' axis of a device
mesh and, optionally, the decoder's rows (ModelConfig.spatial_axis) or the
correlation's orientation bins (ModelConfig.ori_axis) on its 'model' axis:
under jit each array is one logical array, so BatchNorm's moments, the
losses and the gradient are those of the global batch, and XLA inserts the
collectives. The port runs one process a card under torch.distributed and
makes the same collectives explicit.

The mesh. `make_mesh(data, model)` lays the data * model processes out as
JAX's reshape(data, model): rank r has data index r // model and model
index r % model, so a model group is `model` consecutive ranks. The batch
is sharded on 'data' and replicated along 'model': the model ranks of one
data index hold the same rows. `set_mesh(mesh)` makes a mesh the one the
collectives read; without one the mesh is (world size, 1), every process
on the data axis.

Data-axis collectives (over this process's data group, in data-index
order):
- `global_sum`, a differentiable all-reduce sum, gives BatchNorm its
  global-batch count, sum and sum of squares (nn/efficientnet.py) and the
  losses their global sums (train/losses.py);
- `mean_grads` averages the gradients in one flat float32 all-reduce
  before clipping and the optimizer's update (train/step.py; over every
  process, which is the data axis's mean, see below);
- `gather_rows` hands every rank the global batch where gradient
  accumulation slices it into global microbatches (train/step.py);
- `all_hosts_concat` pools per-sample evaluation errors (train/evaluate.py,
  train/stream.py).

Model-axis collectives (over this process's model group, in model-index
order), each differentiable: `to_model` copies a replicated tensor into
the sharded region (identity; its backward all-reduces the cotangent over
the model group), `take_rows` is `to_model` and this rank's block of rows,
`gather_model` all-gathers the blocks of a sharded tensor (unequal blocks
allowed; its backward takes this rank's block) and `halo_rows` gives a row
block a one-row halo from each neighbour for a 3x3 conv (its backward adds
the halo rows' cotangents into the neighbours' edge rows). Blocks are
JAX's: ceil(n / model) items, the last ones short or empty (`blocks`).

Where the factors live, one rule. Every rank holds the global batch's loss
L and backpropagates it. The backward of `global_sum` all-reduces its
cotangent over the data group (the adjoint of a sum every rank holds), so
what the ranks of a model index differentiate together is D * L, D the
data size. A parameter upstream of every `to_model` (the encoders, the
descriptor heads, a decoder stage that runs whole) gets on each model rank
the whole gradient of its data shard's share: `to_model`'s all-reduce has
already added the other model ranks' parts into the cotangent, so it is
not summed again. A parameter used only inside the sharded region (a
decoder stage or head that runs on a row block: CVM.row_block_params)
gets a partial gradient, its block's part, which `mean_grads` weights by
M. Then one mean over all D * M processes gives L's gradient: a whole
gradient counts M times over D * M, a partial one M times its M parts,
and every cotangent in between is L's up to the factor D (BatchNorm's
moments included). For D and M powers of 2 the factors are exact. The
mean over every process, not over the data group, also keeps the model
ranks' replicated parameters the same bits: their M gradients agree in
exact arithmetic, but the card's backward kernels may sum in another
order in each process.

One process (no process group, or a group of one), and a mesh whose model
axis has size 1, run the single-card code with the same bits: a
collective over a group of one is skipped, but the gradient mean, which a
group of one runs as x * 1 (under nccl a one-rank reduce kernel, which a
CUDA graph captures with the step).
"""

from __future__ import annotations

import contextlib
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
    """The ('data', 'model') mesh: data * model processes, one card each,
    laid out as JAX's reshape(data, model). `groups` (not compared) holds
    this process's data group and model group: None for the default group
    (a model axis of size 1: the data axis is every process) or where the
    axis has size 1."""
    data: int
    model: int = 1
    axis_names: Tuple[str, str] = ("data", "model")
    groups: Tuple = dataclasses.field(default=(None, None), compare=False, repr=False)


def make_mesh(data: Optional[int] = None, model: int = 1,
              axis_names: Tuple[str, str] = ("data", "model")) -> Mesh:
    """The mesh of data * model processes (data defaults to the world size
    over `model`; TrainConfig's data_axis and model_axis name the two
    axes). With a model axis of size > 1 it builds one model group per data
    index and one data group per model index, which every process must
    call together, as torch.distributed.new_group asks."""
    n = world_size()
    if model < 1 or (data is None and n % model):
        raise ValueError(f"a model axis '{axis_names[1]}' of {model} does not divide the "
                         f"{n} processes of this run")
    data = n // model if data is None else data
    if data * model != n:
        raise ValueError(f"a ('{axis_names[0]}' {data}, '{axis_names[1]}' {model}) mesh needs "
                         f"{data * model} processes, this run has {n}")
    if model == 1:
        return Mesh(data, model, tuple(axis_names))
    r = rank()
    data_group = model_group = None
    for d in range(data):
        g = dist.new_group(list(range(d * model, (d + 1) * model)))
        if r // model == d:
            model_group = g
    if data > 1:
        for m in range(model):
            g = dist.new_group(list(range(m, n, model)))
            if r % model == m:
                data_group = g
    return Mesh(data, model, tuple(axis_names), (data_group, model_group))


# the meshes set_mesh entered, innermost last (jax.set_mesh's context)
_MESHES: List[Mesh] = []


@contextlib.contextmanager
def set_mesh(mesh: Mesh):
    """The mesh the collectives and ModelConfig's axes read inside the
    block (jax.set_mesh)."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def current_mesh() -> Mesh:
    """The innermost set_mesh's mesh, else (world size, 1)."""
    return _MESHES[-1] if _MESHES else Mesh(world_size(), 1)


def data_size() -> int:
    return current_mesh().data


def model_size() -> int:
    return current_mesh().model


def data_index() -> int:
    """This process's index on the data axis: its block of the global batch."""
    return rank() // current_mesh().model


def model_index() -> int:
    return rank() % current_mesh().model


def shard_size(axis: Optional[str]) -> int:
    """The number of blocks a ModelConfig axis (spatial_axis, ori_axis)
    splits into under the current mesh: 1 for None, the model axis's size
    for its name; another name raises (a name the mesh lacks, or the data
    axis, which holds the batch)."""
    if axis is None:
        return 1
    mesh = current_mesh()
    if axis == mesh.axis_names[1]:
        return mesh.model
    if axis == mesh.axis_names[0]:
        raise ValueError(f"axis '{axis}' is the mesh's data axis, which shards the batch: name "
                         f"its model axis '{mesh.axis_names[1]}'")
    raise ValueError(f"the mesh has no axis '{axis}' (its axes are {mesh.axis_names})")


def blocks(n: int, parts: int) -> List[int]:
    """The sizes of `parts` contiguous blocks of n items, as GSPMD shards
    them: ceil(n / parts) each, the last ones short or empty."""
    c = -(-n // parts)
    return [max(0, min(c, n - i * c)) for i in range(parts)]


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


def _all_gather(t: torch.Tensor, group, n: int) -> List[torch.Tensor]:
    """The n ranks' t (equal shapes) of `group` in group-rank order, on t's
    device; gloo gathers host tensors only."""
    device = t.device
    t = (t if backend() == "nccl" else t.cpu()).contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return [p.to(device) for p in parts]


def _summed(t: torch.Tensor, group) -> torch.Tensor:
    """A copy of t all-reduced (summed) over `group`."""
    t = t.contiguous().clone()
    dist.all_reduce(t, group=group)
    return t


class _GlobalSum(torch.autograd.Function):
    """All-reduce sum over `group`; its backward all-reduces the cotangent
    (the adjoint of a sum whose result every rank holds)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the data group, on every process of it,
    differentiable (see the module's note on where the 1/D lives); x itself
    on a data axis of size 1."""
    if data_size() == 1:
        return x
    return _GlobalSum.apply(x, current_mesh().groups[0])


def global_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of x over the data group, detached; x on a data
    axis of size 1."""
    if data_size() == 1:
        return x.detach()
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=current_mesh().groups[0])
    return y


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The data group's x (equal shapes) concatenated on dim 0 in
    data-index order: the global batch from each process's block of it; x
    on a data axis of size 1."""
    n = data_size()
    if n == 1:
        return x
    return torch.cat(_all_gather(x, current_mesh().groups[0], n))


def mean_grads(params: Sequence[torch.Tensor],
               row_block: Sequence[torch.Tensor] = ()) -> None:
    """Average the parameters' gradients over every process in one flat
    float32 all-reduce, in place: nccl's AVG (a sum of each rank's x / P),
    gloo's SUM then / P (gloo has no AVG). The gradients of `row_block`
    (CVM.row_block_params: each process holds its model block's part) are
    weighted by the model size first, so the mean adds the blocks; over a
    model axis the result is the data axis's mean (the module's note), the
    same bits on every process. Runs under any process group, one of size
    1 too, where it leaves the bits."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads or not initialized():
        return
    if row_block:
        torch._foreach_mul_([p.grad for p in row_block], float(model_size()))
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    if backend() == "nccl":
        dist.all_reduce(flat, op=dist.ReduceOp.AVG)
    else:
        dist.all_reduce(flat)
        if world_size() > 1:
            flat.div_(world_size())
    parts = flat.split([g.numel() for g in grads])
    torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(parts, grads)])


class _ToModel(torch.autograd.Function):
    """Identity; the backward all-reduces the cotangent over `group`."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


def to_model(x: torch.Tensor) -> torch.Tensor:
    """A replicated tensor copied into the model axis's sharded region: x
    itself, whose cotangent the backward sums over the model group (the
    blocks' parts of it); x on a model axis of size 1."""
    if model_size() == 1:
        return x
    return _ToModel.apply(x, current_mesh().groups[1])


def take_rows(x: torch.Tensor, sizes: Sequence[int], dim: int = 2) -> torch.Tensor:
    """This rank's block of the replicated x along `dim` (row blocks of
    `sizes`, in model-index order), through to_model."""
    m = model_index()
    return to_model(x).narrow(dim, sum(sizes[:m]), sizes[m])


class _GatherModel(torch.autograd.Function):
    """The model group's blocks along `dim` concatenated in model-index
    order; the backward takes this rank's block of the cotangent."""

    @staticmethod
    def forward(ctx, x, dim, sizes, index, group):
        ctx.dim, ctx.start, ctx.size = dim, sum(sizes[:index]), sizes[index]
        width = max(sizes)
        if x.shape[dim] < width:
            pad = list(x.shape)
            pad[dim] = width - x.shape[dim]
            x = torch.cat([x, x.new_zeros(pad)], dim)
        parts = _all_gather(x, group, len(sizes))
        return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)], dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.size), None, None, None, None


def gather_model(x: torch.Tensor, dim: int, sizes: Sequence[int]) -> torch.Tensor:
    """The whole tensor from this rank's block x along `dim` (blocks of
    `sizes` in model-index order, unequal or empty ones too), on every
    model rank; x on a model axis of size 1."""
    if model_size() == 1:
        return x
    dim = dim % x.dim()
    return _GatherModel.apply(x, dim, tuple(sizes), model_index(), current_mesh().groups[1])


class _HaloRows(torch.autograd.Function):
    """x [B, C, n, W], n >= 1, with the row above it and the row below it
    from the neighbouring model ranks (zeros at the image's top and
    bottom): [B, C, n + 2, W]. The backward adds the halo rows' cotangents
    into the neighbours' edge rows."""

    @staticmethod
    def forward(ctx, x, index, count, group):
        ctx.index, ctx.count, ctx.group = index, count, group
        parts = _all_gather(torch.stack([x[:, :, 0], x[:, :, -1]]), group, count)
        zero = x.new_zeros(x[:, :, :1].shape)
        top = parts[index - 1][1].unsqueeze(2) if index > 0 else zero
        bottom = parts[index + 1][0].unsqueeze(2) if index < count - 1 else zero
        return torch.cat([top, x, bottom], dim=2)

    @staticmethod
    def backward(ctx, g):
        m, n = ctx.index, ctx.count
        sent = g.new_zeros((n, 2) + g[:, :, 0].shape)
        if m > 0:
            sent[m - 1, 1] = g[:, :, 0]
        if m < n - 1:
            sent[m + 1, 0] = g[:, :, -1]
        dist.all_reduce(sent, group=ctx.group)
        gx = g[:, :, 1:-1].clone()
        gx[:, :, 0] += sent[m, 0]
        gx[:, :, -1] += sent[m, 1]
        return gx, None, None, None


def halo_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's row block x [B, C, n, W] (every block non-empty) with a
    one-row halo from each neighbour, zero rows at the image's edges:
    [B, C, n + 2, W], the input of a 3x3 conv padded on the columns only."""
    if model_size() == 1:
        return torch.nn.functional.pad(x, (0, 0, 1, 1))
    return _HaloRows.apply(x, model_index(), model_size(), current_mesh().groups[1])


def all_hosts_gather(x) -> np.ndarray:
    """A per-process numpy array (the same shape on every process) stacked
    across the data group [D, ...] in data-index order; the array itself
    on a data axis of size 1."""
    n = data_size()
    if n == 1:
        return np.asarray(x)
    t = torch.as_tensor(np.ascontiguousarray(x)).to(_collective_device())
    parts: List[torch.Tensor] = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=current_mesh().groups[0])
    return torch.stack(parts).cpu().numpy()


def all_hosts_concat(x) -> np.ndarray:
    """Variable-length per-process 1-D arrays concatenated across the data
    group in data-index order (per-sample eval errors from sharded loaders,
    where processes may hold unequal counts), as float64; the array itself
    on a data axis of size 1."""
    if data_size() == 1:
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
